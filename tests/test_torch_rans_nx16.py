"""The port's rANS Nx16 O0 32-way decode (htslib_tpu_torch/ops/
rans_nx16.py, kernel B2's plain version on the CPU) against the host
codec and the JAX package's Pallas decode in interpret mode; the state
carried across (htslib_tpu_torch/carry.py); and the kernels' per-state
step (csrc/rans_nx16_step.cuh) compiled for the CPU.  Bytes and states:
equality is exact."""
import ctypes
import os
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from htslib_tpu.codecs.rans4x16 import compress, uncompress
from htslib_tpu.ops import rans_pallas
from htslib_tpu.ops.device_stats import _prepare_group
from htslib_tpu_torch import carry
from htslib_tpu_torch.codecs import rans4x16 as trans
from htslib_tpu_torch.ops import rans_nx16 as tr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "htslib_tpu_torch", "csrc")


@pytest.fixture(autouse=True, scope="module")
def _jax_32bit():
    """The JAX reference runs in its default 32-bit mode; another test
    module in the same worker process may have switched JAX to 64-bit."""
    jax.config.update("jax_enable_x64", False)


def _cases():
    rng = np.random.RandomState(3)
    cases = {
        "quality": rng.randint(0, 40, 5000).astype(np.uint8).tobytes(),
        "four_base": rng.randint(0, 4, 3000).astype(np.uint8).tobytes(),
        "full_alphabet": rng.randint(0, 256, 2000).astype(np.uint8)
        .tobytes(),
        "tiny": rng.randint(0, 40, 100).astype(np.uint8).tobytes(),
        "constant": bytes(500),
        "sub_round": rng.randint(0, 40, 64).astype(np.uint8).tobytes(),
        "ulen_mod32": rng.randint(0, 40, 1007).astype(np.uint8).tobytes(),
        "ulen_lt32": rng.randint(0, 40, 13).astype(np.uint8).tobytes(),
        "one_symbol": bytes([37]) * 2000,
    }
    # more than 32 streams: the JAX decode takes two groups
    for i in range(26):
        cases[f"filler{i}"] = rng.randint(
            10, 50, 40 + 37 * i).astype(np.uint8).tobytes()
    return cases


CASES = _cases()
NAMES = list(CASES)


@pytest.fixture(scope="module")
def decoded():
    encs = [compress(CASES[k], 0x04) for k in NAMES]
    port = tr.decode_nx16_o0_batch(encs, device="cpu")
    jax = rans_pallas.decode_nx16_o0_batch(encs, interpret=True)
    return dict(zip(NAMES, zip(encs, port, jax)))


@pytest.mark.parametrize("name", NAMES[:9] + ["filler25"])
def test_decode_matches_host_and_jax(decoded, name):
    enc, port, jax = decoded[name]
    assert len(NAMES) > 32
    assert port == CASES[name]
    assert port == uncompress(enc)
    assert port == jax


def test_port_codec_matches_reference_codec():
    """The port's own rans4x16 copy writes and reads the same wire."""
    for name in ("quality", "ulen_mod32", "one_symbol"):
        d = CASES[name]
        for flags in (0x04, 0x00, 0x05, 0x0C, 0x84, 0x44):
            enc = compress(d, flags)
            assert trans.compress(d, flags) == enc
            assert trans.uncompress(enc) == d


@pytest.mark.parametrize("flags", [0x00, 0x05])
def test_flags_raise_as_jax(flags):
    enc = compress(CASES["quality"], flags)
    with pytest.raises(ValueError) as port_err:
        tr.decode_nx16_o0_batch([enc], device="cpu")
    with pytest.raises(ValueError) as jax_err:
        rans_pallas.decode_nx16_o0_batch([enc], interpret=True)
    assert str(port_err.value) == str(jax_err.value)


def test_decode_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.decode_nx16_o0_batch([compress(CASES["tiny"], 0x04)])


def test_carry_segment_state_equals_jax():
    """From the JAX front end's arrays, the port's state after 2048
    rounds equals the state one JAX segment call leaves."""
    rng = np.random.default_rng(8)
    datas = [rng.integers(20, 41, 70000 + 5 * i, dtype=np.uint8).tobytes()
             for i in range(2)]
    datas.append(np.clip(np.cumsum(rng.integers(-2, 3, 66000)) + 20, 0,
                         44).astype(np.uint8).tobytes())
    encs = [compress(d, 0x04) for d in datas]
    data_w, lo, dfc, x, out_szs, a_pad, W = _prepare_group(encs)
    run = rans_pallas._compiled_seg(W, a_pad, True)
    syms, x_out, cur_out = run(data_w, lo, dfc, x,
                               np.zeros((1, carry.BLOCKS), np.int32))
    want_x, want_cur = carry.from_jax_segment(x_out, cur_out)

    b = carry.from_jax_group(data_w, lo, dfc, x, out_szs)
    assert b.ulen[:3].tolist() == [len(d) for d in datas]
    out, got_x, got_cur = tr.rans_o0(b, max_rounds=rans_pallas.SEG)
    assert np.array_equal(got_x.numpy().view(np.uint32), want_x)
    assert np.array_equal(got_cur.numpy(), want_cur)
    # the symbols of those rounds are the JAX segment's and the data's
    seg = rans_pallas.SEG * tr.NWAY
    allsym = np.asarray(syms)
    offs = b.out_off.numpy()
    for i, d in enumerate(datas):
        jax_i = allsym[:, i::carry.BLOCKS].reshape(-1).astype(np.uint8)
        assert out[offs[i]:offs[i] + seg].numpy().tobytes() \
            == jax_i.tobytes() == d[:seg]


def test_hist_plain_counts_decoded_symbols():
    encs = [compress(CASES[k], 0x04) for k in NAMES[:9]]
    b = tr.frame_streams(encs, "cpu")
    offs = torch.tensor([0, 1, 2, 3, 4, 5, 6, 7, 200], dtype=torch.int32)
    hist, x_h, cur_h = tr.rans_o0(b, offs=offs, qbins=256)
    syms, x_d, cur_d = tr.rans_o0(b)
    assert torch.equal(x_h, x_d) and torch.equal(cur_h, cur_d)
    for i, o in enumerate(offs.tolist()):
        s = syms[b.out_off[i]:b.out_off[i] + b.ulen[i]].long()
        want = torch.bincount((s - o).clamp(0, 255), minlength=256)
        assert torch.equal(hist[i].long(), want)


_HARNESS = r"""
#include "rans_nx16_step.cuh"

// One stream through the kernels' step code, the 32 lanes of a warp run
// in order: the ballot is the mask of states that need a word, and a
// state's word is cursor + popc(mask & lanes below it).
extern "C" int64_t decode_stream(const int32_t* freq, const uint32_t* x0,
                                 const uint16_t* words, int64_t n_words,
                                 int64_t ulen, uint8_t* out,
                                 uint32_t* x_out) {
  uint16_t f[256];
  uint32_t slot[RANS_TOTFREQ];
  for (int s = 0; s < 256; ++s) f[s] = (uint16_t)freq[s];
  for (int lane = 0; lane < RANS_NWAY; ++lane)
    rans_o0_build_slots(f, slot, lane, RANS_NWAY);
  uint32_t x[RANS_NWAY];
  for (int j = 0; j < RANS_NWAY; ++j) x[j] = x0[j];
  int64_t cur = 0;
  for (int64_t r = 0; r * RANS_NWAY < ulen; ++r) {
    uint32_t mask = 0;
    for (int j = 0; j < RANS_NWAY; ++j) {
      const int64_t pos = r * RANS_NWAY + j;
      if (pos < ulen) {
        out[pos] = (uint8_t)rans_o0_decode(&x[j], slot);
        if (rans_needs_refill(x[j])) mask |= 1u << j;
      }
    }
    for (int j = 0; j < RANS_NWAY; ++j) {
      const uint32_t below = (1u << j) - 1u;
      if (mask >> j & 1u)
        x[j] = rans_refill(
            x[j], rans_word(words, cur + __builtin_popcount(mask & below),
                            n_words));
    }
    cur = rans_advance(cur, __builtin_popcount(mask), n_words);
  }
  for (int j = 0; j < RANS_NWAY; ++j) x_out[j] = x[j];
  return cur;
}
"""


@pytest.fixture(scope="module")
def step_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the step harness needs a C++ compiler")
    d = tmp_path_factory.mktemp("step")
    src = d / "harness.cpp"
    src.write_text(_HARNESS)
    lib = d / "libstep.so"
    subprocess.run([gxx, "-x", "c++", "-shared", "-fPIC", "-O2", "-I", CSRC,
                    "-o", str(lib), str(src)], check=True)
    h = ctypes.CDLL(str(lib))
    h.decode_stream.restype = ctypes.c_int64
    h.decode_stream.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 \
        + [ctypes.c_void_p] * 2
    return h


@pytest.mark.parametrize("name", ["quality", "full_alphabet", "ulen_mod32",
                                  "one_symbol", "ulen_lt32"])
def test_step_header_on_cpu(step_lib, name):
    """The CUDA step code, compiled for the host with the ballot/popc
    refill run in order, decodes byte for byte and leaves the plain
    version's final states and cursor."""
    enc = compress(CASES[name], 0x04)
    b = tr.frame_streams([enc], "cpu")
    words = b.payload.numpy()
    freq = b.freqs.numpy()[0].copy()
    x0 = b.x0.numpy()[0].view(np.uint32).copy()
    ulen = int(b.ulen[0])
    out = np.zeros(max(ulen, 1), np.uint8)
    x_out = np.zeros(32, np.uint32)
    cur = step_lib.decode_stream(freq.ctypes.data, x0.ctypes.data,
                                 words.ctypes.data, int(b.n_words[0]), ulen,
                                 out.ctypes.data, x_out.ctypes.data)
    assert out[:ulen].tobytes() == CASES[name] == uncompress(enc)
    _, px, pcur = tr.rans_o0(b)
    assert np.array_equal(x_out, px.numpy()[0].view(np.uint32))
    assert cur == int(pcur[0])

