"""The port's rANS Nx16 O0 32-way encode (htslib_tpu_torch/ops/
rans_enc.py, kernel B9's plain version on the CPU) against the JAX
package's Pallas encode in interpret mode and both host codecs; the round
trip through the port's decode; the frequencies carried from the JAX
encoder's tables (htslib_tpu_torch/carry.py); and the kernel's per-state
step (csrc/rans_nx16_enc_step.cuh) compiled for the CPU.  Outputs are
bytes and integers: equality is exact."""
import ctypes
import os
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from htslib_tpu.codecs.rans4x16 import compress
from htslib_tpu.ops import rans_enc_pallas as jenc
from htslib_tpu_torch import carry
from htslib_tpu_torch.codecs import rans4x16 as trans
from htslib_tpu_torch.ops import rans_enc as te
from htslib_tpu_torch.ops import rans_nx16 as tr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "htslib_tpu_torch", "csrc")


@pytest.fixture(autouse=True, scope="module")
def _jax_32bit():
    """The JAX reference runs in its default 32-bit mode; another test
    module in the same worker process may have switched JAX to 64-bit."""
    jax.config.update("jax_enable_x64", False)


def _cases():
    """At most 32 streams, each under 65,536 symbols: one JAX group of
    one 2,048-round segment.  The interpret-mode kernel's cost grows with
    the widest alphabet of the group, so the full 256-symbol alphabet has
    its own JAX call (test_torch_rans_enc_alphabet.py)."""
    rng = np.random.RandomState(11)
    cases = {f"len{n}": rng.randint(0, 40, n).astype(np.uint8).tobytes()
             for n in (1, 13, 31, 32, 33, 64, 100, 1007, 4097)}
    cases["one_symbol"] = bytes([37]) * 2000
    cases["two_symbols"] = rng.choice([3, 250], 777).astype(
        np.uint8).tobytes()
    cases["skewed"] = np.minimum(rng.geometric(0.3, 5003), 255).astype(
        np.uint8).tobytes()
    return cases


CASES = _cases()
NAMES = list(CASES)
FULL_ALPHABET = np.random.RandomState(12).randint(0, 256, 3000).astype(
    np.uint8).tobytes()


@pytest.fixture(scope="module")
def encoded():
    datas = [CASES[k] for k in NAMES]
    port = te.encode_nx16_o0_batch(datas, device="cpu")
    jax_out = jenc.encode_nx16_o0_batch(datas, interpret=True)
    return dict(zip(NAMES, zip(port, jax_out)))


@pytest.mark.parametrize("name", NAMES)
def test_encode_matches_jax_and_host(encoded, name):
    port, jax_out = encoded[name]
    d = CASES[name]
    assert port == jax_out == compress(d, 0x04) == trans.compress(d, 0x04)


def test_encode_round_trip(encoded):
    port = [encoded[k][0] for k in NAMES]
    assert tr.decode_nx16_o0_batch(port, device="cpu") == \
        [CASES[k] for k in NAMES]


def test_empty_stream_raises_as_jax():
    datas = [CASES["len13"], b""]
    with pytest.raises(ValueError) as port_err:
        te.encode_nx16_o0_batch(datas, device="cpu")
    with pytest.raises(ValueError) as jax_err:
        jenc.encode_nx16_o0_batch(datas, interpret=True)
    assert str(port_err.value) == str(jax_err.value) == "empty stream"
    assert te.encode_nx16_o0_batch([], device="cpu") == []


def test_encode_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.encode_nx16_o0_batch([CASES["len13"]])


def test_timing_keys():
    timing = {}
    te.encode_nx16_o0_batch([CASES["len100"]], device="cpu", timing=timing)
    assert set(timing) == {"enc_s", "enc_resident_s", "bytes"}
    assert timing["bytes"] == 100


def test_carried_enc_tables_give_port_freqs():
    """The frequencies recovered from the JAX encoder's telescoped tables
    are those the port framed, f = 1 and f = 4096 and a full alphabet
    included."""
    datas = [CASES[k] for k in NAMES] + [FULL_ALPHABET]
    freqs = te.frame_enc(datas, "cpu").freqs.numpy()
    padded = np.zeros((jenc.BLOCKS_E, 256), np.int64)
    padded[:len(datas)] = freqs
    padded[len(datas):, 0] = tr.TOTFREQ
    assert (freqs == 1).any() and (freqs == tr.TOTFREQ).any()
    lo, d1, d2 = jenc._enc_tables(padded, 256)
    assert np.array_equal(carry.from_jax_enc_tables(lo, d1, d2), padded)


def test_plain_stops_after_max_rounds():
    """A stop after r rounds leaves the states and words of the first r
    rounds: a longer run continues from the same emitted prefix."""
    b = te.frame_enc([CASES[k] for k in NAMES], "cpu")
    w_all, x_all, n_all = te.rans_enc(b)
    w10, x10, n10 = te.rans_enc(b, max_rounds=10)
    assert (n10 <= n_all).all()
    ends = (b.off + b.ulen.long()).tolist()
    for i, e in enumerate(ends):
        k = int(n10[i])
        assert torch.equal(w10[e - k:e], w_all[e - k:e])
    short = b.ulen <= 10 * tr.NWAY
    assert torch.equal(x10[short], x_all[short])


_HARNESS = r"""
#include "rans_nx16_enc_step.cuh"

// One stream through the kernel's step code and its table of reciprocal
// entries, the 32 lanes of a warp run in order: a round's emitters are
// ranked in the round's rotation and emission e lands at word n - 1 - e.
// Returns the words emitted.
extern "C" int64_t encode_stream(const uint8_t* d, int64_t n,
                                 const int32_t* freq, uint16_t* words,
                                 uint32_t* x_out) {
  RansEncSym tab[256];
  uint32_t c = 0;
  for (int s = 0; s < 256; ++s) {
    tab[s] = rans_enc_sym((uint32_t)freq[s], c);
    c += (uint32_t)freq[s];
  }
  uint32_t x[RANS_ENC_NWAY];
  for (int j = 0; j < RANS_ENC_NWAY; ++j) x[j] = RANS_ENC_L;
  const int r0 = (int)((n - 1) % RANS_ENC_NWAY);
  int64_t emitted = 0;
  for (uint32_t t = 0; (int64_t)t * RANS_ENC_NWAY < n; ++t) {
    uint32_t mask = 0, word[RANS_ENC_NWAY];
    for (int j = 0; j < RANS_ENC_NWAY; ++j) {
      const uint32_t cnt = rans_enc_count((uint32_t)n, j);
      if (t < cnt &&
          rans_enc_put(&x[j], tab[d[rans_enc_pos(cnt, j, t)]], &word[j]))
        mask |= 1u << j;
    }
    for (int j = 0; j < RANS_ENC_NWAY; ++j)
      if (mask >> j & 1u)
        words[n - 1 -
              (emitted + __builtin_popcount(mask & rans_enc_before(j, r0)))] =
            (uint16_t)word[j];
    emitted += __builtin_popcount(mask);
  }
  for (int j = 0; j < RANS_ENC_NWAY; ++j) x_out[j] = x[j];
  return emitted;
}

// The reciprocal step (rans_enc_put on rans_enc_sym(f, cum)) against the
// division step on each of the n states xs: the index of the first state
// on which the new state, the emit flag or the word differ, or -1.
extern "C" int64_t step_mismatch(uint32_t f, uint32_t cum,
                                 const uint32_t* xs, int64_t n) {
  const RansEncSym e = rans_enc_sym(f, cum);
  for (int64_t i = 0; i < n; ++i) {
    uint32_t a = xs[i], b = xs[i], wa, wb;
    const int ea = rans_enc_put(&a, e, &wa);
    const int eb = rans_enc_put_div(&b, f, cum, &wb);
    if (a != b || ea != eb || (ea && (uint16_t)wa != (uint16_t)wb)) return i;
  }
  return -1;
}
"""


@pytest.fixture(scope="module")
def step_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the step harness needs a C++ compiler")
    d = tmp_path_factory.mktemp("enc_step")
    src = d / "harness.cpp"
    src.write_text(_HARNESS)
    lib = d / "libencstep.so"
    subprocess.run([gxx, "-x", "c++", "-shared", "-fPIC", "-O2", "-I", CSRC,
                    "-o", str(lib), str(src)], check=True)
    h = ctypes.CDLL(str(lib))
    h.encode_stream.restype = ctypes.c_int64
    h.encode_stream.argtypes = [ctypes.c_void_p, ctypes.c_int64] \
        + [ctypes.c_void_p] * 3
    h.step_mismatch.restype = ctypes.c_int64
    h.step_mismatch.argtypes = [ctypes.c_uint32] * 2 + [ctypes.c_void_p,
                                                        ctypes.c_int64]
    return h


@pytest.mark.parametrize("name", ["len1", "len13", "len33", "len1007",
                                  "len4097", "one_symbol", "skewed",
                                  "full_alphabet"])
def test_step_header_on_cpu(step_lib, name):
    """The CUDA step code and its reciprocal table, compiled for the host
    with the ballot ranking run in order, emit the host codec's words and
    final states."""
    d = FULL_ALPHABET if name == "full_alphabet" else CASES[name]
    n = len(d)
    freq = trans._norm_freqs(np.bincount(np.frombuffer(d, np.uint8),
                                         minlength=256)).astype(np.int32)
    words = np.zeros(n, np.uint16)
    x_out = np.zeros(32, np.uint32)
    data = np.frombuffer(d, np.uint8).copy()
    k = step_lib.encode_stream(data.ctypes.data, n, freq.ctypes.data,
                               words.ctypes.data, x_out.ctypes.data)
    cum = np.zeros(256, np.int64)
    cum[1:] = np.cumsum(freq)[:-1]
    core = trans._enc_core(data, freq.astype(np.int64), cum, 32)
    assert x_out.astype("<u4").tobytes() == core[:128]
    assert words[n - k:].astype("<u2").tobytes() == core[128:]


def _step_states(f: int, rng) -> np.ndarray:
    """The states the step divides for frequency f (all below f << 19,
    the largest f * 2^19 - 1 <= 2^31 - 1): 0 and 1, f - 1 and f, the
    multiples of f near 0, near the middle and at the top, each +- 1, and
    seeded random states.  For f = 1 the reciprocal gives x - 1 for x >= 1
    only (the bias makes up the 1), so 0 is left out there: a state is
    never below 8 when it is divided (2^15 without an emit, f << 3 after
    one)."""
    top = f << 19
    mid = (top // f) // 2 + np.arange(-32, 32)
    ks = np.concatenate([np.arange(1, 64), mid, top // f - np.arange(1, 64)])
    xs = np.concatenate([[0, 1, f - 1, f, top - 1], ks * f - 1, ks * f,
                         ks * f + 1, rng.integers(0, top, 256)])
    xs = xs[(xs >= (1 if f == 1 else 0)) & (xs < top)]
    return np.unique(xs).astype(np.uint32)


@pytest.mark.parametrize("lo", range(1, 4097, 512))
def test_reciprocal_step_is_exact_division(step_lib, lo):
    """The reciprocal step equals division and remainder for every f in
    1..4096 (in eight cases of 512 frequencies), on the states of
    _step_states, with the cumulative frequency at its extremes."""
    rng = np.random.default_rng(lo)
    for f in range(lo, lo + 512):
        xs = _step_states(f, rng)
        for cum in (0, 4096 - f):
            at = step_lib.step_mismatch(f, cum, xs.ctypes.data, xs.size)
            assert at == -1, (f, cum, int(xs[at]))


def test_reciprocal_step_emits_as_division(step_lib):
    """States at and above f << 19 emit first, as the division step does,
    f = 4096 (a one-symbol stream, f << 19 = 2^31) included."""
    rng = np.random.default_rng(7)
    for f in (1, 2, 3, 5, 7, 255, 1000, 2047, 2048, 2049, 4095, 4096):
        top = min(f << 19, 1 << 31)
        xs = np.unique(np.concatenate([
            [top, top + 1, (1 << 31) - 1],
            rng.integers(top, 1 << 31, 64) if top < 1 << 31 else []]))
        xs = xs[xs < 1 << 31].astype(np.uint32)
        assert step_lib.step_mismatch(f, 0, xs.ctypes.data, xs.size) == -1
