"""The port's rANS 4x8 codec copy (htslib_tpu_torch/codecs/rans4x8.py)
against the reference codec, and its order-0 decode (htslib_tpu_torch/
ops/rans4x8.py, kernel B7's plain version on the CPU) against the host
codec and the JAX package's Pallas decode in interpret mode; the state
carried across after one JAX segment (htslib_tpu_torch/carry.py); and the
kernels' per-state step (csrc/rans4x8_step.cuh) compiled for the CPU.
Bytes and states: equality is exact."""
import ctypes
import os
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from htslib_tpu.codecs import rans4x8 as ref8
from htslib_tpu.cram.io import CramBlock
from htslib_tpu.cram.structs import CT_EXTERNAL
from htslib_tpu.ops import rans4x8_pallas as j48
from htslib_tpu_torch import carry
from htslib_tpu_torch.codecs import rans4x8 as r8
from htslib_tpu_torch.cram.io import CramBlock as TBlock
from htslib_tpu_torch.cram.structs import RANS
from htslib_tpu_torch.ops import rans4x8 as t8
from test_torch_device_stats import read_walks as _walk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "htslib_tpu_torch", "csrc")


@pytest.fixture(autouse=True, scope="module")
def _jax_32bit():
    """The JAX reference runs in its default 32-bit mode; another test
    module in the same worker process may have switched JAX to 64-bit."""
    jax.config.update("jax_enable_x64", False)


def _short_table_compress(data: bytes, short: int = 96) -> bytes:
    """A valid order-0 4x8 stream whose frequencies sum to 4096 - short:
    the port's encoder with its largest frequency cut."""
    norm = r8._normalize

    def cut(h, total=r8.TOTFREQ):
        f = norm(h, total)
        f[int(np.argmax(f))] -= short
        return f

    r8._normalize = cut
    try:
        return r8.compress(data, 0)
    finally:
        r8._normalize = norm


def _cases():
    rng = np.random.default_rng(21)
    return {
        "two_segments": _walk(rng, 9001),       # 2251 rounds of 1024
        "uniform_tail1": rng.integers(20, 41, 5001, dtype=np.uint8)
        .tobytes(),
        "tail2": _walk(rng, 1006),
        "tail3": _walk(rng, 4099),
        "short_table": rng.integers(0, 45, 3003, dtype=np.uint8).tobytes(),
        "full_alphabet": rng.integers(0, 256, 2002, dtype=np.uint8)
        .tobytes(),
        "constant": bytes([9]) * 999,
        "under_4": bytes([3, 7, 3]),
    }


CASES = _cases()
NAMES = list(CASES)


def _enc(name):
    if name == "short_table":
        return _short_table_compress(CASES[name])
    return r8.compress(CASES[name], 0)


@pytest.fixture(scope="module")
def decoded():
    encs = [_enc(k) for k in NAMES]
    port = t8.decode_4x8_o0_batch(encs, device="cpu")
    jaxd = j48.decode_4x8_o0_batch(encs, interpret=True)
    return encs, dict(zip(NAMES, zip(encs, port, jaxd)))


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_host_and_jax(decoded, name):
    enc, port, jaxd = decoded[1][name]
    assert port == CASES[name]
    assert port == r8.uncompress(enc) == ref8.uncompress(enc)
    assert port == jaxd


def test_short_table_sums_below_4096():
    f, _ = r8._read_freqs(_enc("short_table"), 9)
    assert 0 < f.sum() < 4096


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("name", ["two_segments", "tail3", "full_alphabet",
                                  "constant", "under_4"])
def test_port_codec_matches_reference_codec(name, order):
    """The port's pure-Python copy writes the bytes the reference
    compress writes (its native path where built) and reads them back."""
    d = CASES[name]
    enc = ref8.compress(d, order)
    assert r8.compress(d, order) == enc
    assert r8.uncompress(enc) == d


def test_cram_block_rans_uses_port_codec():
    d = CASES["tail2"]
    for order in (0, 1):
        enc = r8.compress(d, order)
        ref = CramBlock(RANS, CT_EXTERNAL, 19, len(enc), len(d), enc)
        port = TBlock(RANS, CT_EXTERNAL, 19, len(enc), len(d), enc)
        assert port.uncompress() == ref.uncompress() == d


def test_order1_stream_raises_as_jax():
    enc = r8.compress(CASES["tail2"], 1)
    with pytest.raises(ValueError) as port_err:
        t8.decode_4x8_o0_batch([enc], device="cpu")
    with pytest.raises(ValueError) as jax_err:
        j48.decode_4x8_o0_batch([enc], interpret=True)
    assert str(port_err.value) == str(jax_err.value)


def test_decode_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t8.decode_4x8_o0_batch([_enc("tail2")])


def test_carry_segment_state_equals_jax(decoded):
    """From the JAX front end's arrays, the port's state after SEG4 =
    1024 rounds equals the state one JAX segment call leaves, and the
    symbols of those rounds are the JAX segment's."""
    encs = decoded[0]
    data_w, lo, dfc, x, out_szs, a_pad, W = j48._prepare_group4(encs)
    run = j48._compiled_seg4(W, a_pad, True)
    L = j48.BLOCKS4 * j48.NWAY4
    cnt = np.zeros(L, np.int32)
    for b in range(j48.BLOCKS4):
        cnt[b::j48.BLOCKS4] = out_szs[b] // j48.NWAY4
    cnt8 = np.broadcast_to(np.minimum(cnt, j48.SEG4)[None, :], (8, L))
    syms, x_out, cur_out = run(data_w, lo, dfc, x,
                               np.zeros((1, j48.BLOCKS4), np.int32),
                               np.ascontiguousarray(cnt8))
    want_x, want_cur = carry.from_jax_segment(x_out, cur_out, nway=4)

    b = carry.from_jax_group4(data_w, lo, dfc, x, out_szs)
    assert b.ulen[:len(encs)].tolist() == [len(CASES[k]) for k in NAMES]
    out, got_x, got_cur, _ = t8.rans4x8(b, max_rounds=j48.SEG4)
    long = [i for i, k in enumerate(NAMES) if len(CASES[k]) >= 4 * j48.SEG4]
    assert len(long) >= 2
    for i in long:
        assert np.array_equal(got_x[i].numpy().view(np.uint32), want_x[i])
        assert int(got_cur[i]) == want_cur[i]
        seg = 4 * j48.SEG4
        jax_i = np.asarray(syms)[:, i::j48.BLOCKS4].reshape(-1)
        o = int(b.out_off[i])
        assert out[o:o + seg].numpy().tobytes() \
            == jax_i.astype(np.uint8).tobytes() == CASES[NAMES[i]][:seg]


_HARNESS = r"""
#include "rans4x8_step.cuh"

// One 4x8 stream through the kernels' step code, the 4 states of a round
// run in order: m1/m2 are the masks of states taking >= 1 and 2 bytes,
// and state j's first byte is cursor + popc(m1 & below) + popc(m2 & below).
// Order 0 uses the slot table; order 1 the row/bucket table.
extern "C" int64_t decode_stream(int o1, const int32_t* freq,
                                 const uint32_t* rows, const int32_t* cs,
                                 const uint32_t* x0, const uint8_t* bytes,
                                 int64_t n_bytes, int64_t ulen, uint8_t* out,
                                 uint32_t* x_out) {
  uint16_t f[256];
  static uint32_t slot[RANS_TOTFREQ];
  static uint8_t bucket[256 * RANS_O1_BUCKETS];
  uint16_t ctx_start[257];
  for (int s = 0; s < 256; ++s) f[s] = (uint16_t)freq[s];
  for (int c = 0; c < 257; ++c) ctx_start[c] = (uint16_t)cs[c];
  for (int lane = 0; lane < 32; ++lane) {
    if (o1)
      rans_o1_build_buckets(rows, ctx_start, bucket, lane, 32);
    else
      rans_o0_build_slots(f, slot, lane, 32);
  }
  uint32_t x[RANS8_NWAY], ctx[RANS8_NWAY] = {0, 0, 0, 0};
  for (int j = 0; j < RANS8_NWAY; ++j) x[j] = x0[j];
  int64_t cur = 0;
  const int64_t rounds = rans8_rounds(o1, ulen);
  for (int64_t r = 0; r < rounds; ++r) {
    int need[RANS8_NWAY];
    uint32_t m1 = 0, m2 = 0;
    for (int j = 0; j < RANS8_NWAY; ++j) {
      int64_t pos;
      need[j] = 0;
      if (!rans8_live(o1, ulen, j, r, &pos)) continue;
      const uint32_t s =
          o1 ? rans_o1_decode(&x[j], ctx[j], rows, ctx_start, bucket)
             : rans_o0_decode(&x[j], slot);
      ctx[j] = o1 ? s : 0;
      out[pos] = (uint8_t)s;
      need[j] = rans8_refill_count(x[j]);
      if (need[j] >= 1) m1 |= 1u << j;
      if (need[j] == 2) m2 |= 1u << j;
    }
    for (int j = 0; j < RANS8_NWAY; ++j) {
      const uint32_t below = (1u << j) - 1u;
      const int64_t k = cur + __builtin_popcount(m1 & below) +
                        __builtin_popcount(m2 & below);
      x[j] = rans8_refill(x[j], need[j], rans8_byte(bytes, k, n_bytes),
                          rans8_byte(bytes, k + 1, n_bytes));
    }
    cur = rans_advance(cur, __builtin_popcount(m1) + __builtin_popcount(m2),
                       n_bytes);
  }
  for (int j = 0; j < RANS8_NWAY; ++j) x_out[j] = x[j];
  return cur;
}
"""


@pytest.fixture(scope="module")
def step_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the step harness needs a C++ compiler")
    d = tmp_path_factory.mktemp("step4x8")
    src = d / "harness.cpp"
    src.write_text(_HARNESS)
    lib = d / "libstep.so"
    subprocess.run([gxx, "-x", "c++", "-shared", "-fPIC", "-O2", "-I", CSRC,
                    "-o", str(lib), str(src)], check=True)
    h = ctypes.CDLL(str(lib))
    h.decode_stream.restype = ctypes.c_int64
    h.decode_stream.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 \
        + [ctypes.c_int64] * 2 + [ctypes.c_void_p] * 2
    return h


@pytest.mark.parametrize("name,order", [
    ("two_segments", 0), ("tail3", 0), ("short_table", 0),
    ("full_alphabet", 0), ("constant", 0), ("under_4", 0),
    ("two_segments", 1), ("tail3", 1), ("full_alphabet", 1),
    ("constant", 1)])
def test_step_header_on_cpu(step_lib, name, order):
    """The CUDA step code, compiled for the host with the two-ballot
    refill run in order, decodes byte for byte and leaves the plain
    version's final states and cursor."""
    enc = _enc(name) if order == 0 else r8.compress(CASES[name], 1)
    b = t8.frame_4x8([enc], bool(order), "cpu")
    data = b.payload.numpy()
    freq = b.freqs.numpy()[0].copy()
    if order:
        rows = b.tables.rows.numpy().view(np.uint32).copy()
        cs = b.tables.ctx_start.numpy()[0].copy()
    else:
        rows = np.zeros(1, np.uint32)
        cs = np.zeros(257, np.int32)
    x0 = b.x0.numpy()[0].view(np.uint32).copy()
    ulen = int(b.ulen[0])
    out = np.zeros(max(ulen, 1), np.uint8)
    x_out = np.zeros(4, np.uint32)
    cur = step_lib.decode_stream(order, freq.ctypes.data, rows.ctypes.data,
                                 cs.ctypes.data, x0.ctypes.data,
                                 data.ctypes.data, int(b.n_bytes[0]), ulen,
                                 out.ctypes.data, x_out.ctypes.data)
    assert out[:ulen].tobytes() == CASES[name] == r8.uncompress(enc)
    _, px, pcur, _ = t8.rans4x8(b, qbins=64)
    assert np.array_equal(x_out, px.numpy()[0].view(np.uint32))
    assert cur == int(pcur[0])
