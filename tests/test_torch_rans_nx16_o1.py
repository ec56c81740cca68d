"""The port's rANS Nx16 order-1 32-way decode (htslib_tpu_torch/ops/
rans_nx16_o1.py, kernel B5's plain version on the CPU) against the host
codec and the JAX package's Pallas decode in interpret mode; the state
carried across after one JAX segment (htslib_tpu_torch/carry.py); and the
kernels' per-state step (csrc/rans_nx16_o1_step.cuh) compiled for the
CPU.  Bytes, states and contexts: equality is exact."""
import ctypes
import os
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from htslib_tpu.codecs.rans4x16 import compress, uncompress
from htslib_tpu.ops import rans_o1_pallas as jo1
from htslib_tpu_torch import carry
from htslib_tpu_torch.ops import rans_nx16_o1 as to1
from test_torch_device_stats import read_walks as _walk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "htslib_tpu_torch", "csrc")


@pytest.fixture(autouse=True, scope="module")
def _jax_32bit():
    """The JAX reference runs in its default 32-bit mode; another test
    module in the same worker process may have switched JAX to 64-bit."""
    jax.config.update("jax_enable_x64", False)


def _ctx256(rng, n):
    """Bytes whose order-1 table has all 256 contexts and at most 512
    rows: each symbol s is mostly followed by s + 1 and, for s < 200,
    sometimes by a seeded partner (the 32 segment heads add rows to
    context 0)."""
    partner = rng.integers(0, 256, 256)
    jump = rng.random(n) < 0.2
    out = np.zeros(n, np.uint8)
    for i in range(1, n):
        p = int(out[i - 1])
        out[i] = partner[p] if jump[i] and p < 200 else (p + 1) % 256
    return out.tobytes()


def _cases():
    rng = np.random.default_rng(31)
    cases = {
        # 1024 rounds (one JAX segment) and a 31-symbol tail
        "full_segment": _walk(rng, 32 * 1024 + 31),
        "ulen_mod32": _walk(rng, 1007),
        "ulen_lt32": _walk(rng, 13),
        "sub_round": _walk(rng, 64),
        "constant": bytes([9]) * 999,
        "uniform": rng.integers(20, 41, 3001, dtype=np.uint8).tobytes(),
    }
    # more than 32 streams: the JAX decode takes two groups
    for i in range(27):
        cases[f"filler{i}"] = _walk(rng, 40 + 37 * i)
    return cases


CASES = _cases()
NAMES = list(CASES)
# a 256-context table decodes through a costlier JAX configuration (a
# 256-symbol alphabet select), so it is held against JAX on its own
CTX256 = _ctx256(np.random.default_rng(32), 6000)


@pytest.fixture(scope="module")
def decoded():
    encs = [compress(CASES[k], 0x05) for k in NAMES]
    port = to1.decode_nx16_o1_batch(encs, device="cpu")
    jaxd = jo1.decode_nx16_o1_batch(encs, interpret=True)
    return encs, dict(zip(NAMES, zip(encs, port, jaxd)))


def test_cases_cover_the_edges():
    parsed = [to1._parse_o1_header(compress(CASES[k], 0x05)) for k in NAMES]
    a2_pad, _ = to1.o1_pads(parsed)
    assert jo1.pick_width(a2_pad) < len(NAMES)       # two JAX groups
    F = to1._parse_o1_header(compress(CTX256, 0x05))[1]
    assert (F.sum(axis=1) > 0).sum() == 256          # every context used
    assert (F > 0).sum() <= to1.A2_MAX


@pytest.mark.parametrize("name", NAMES[:6] + ["filler26"])
def test_decode_matches_host_and_jax(decoded, name):
    enc, port, jaxd = decoded[1][name]
    assert port == CASES[name]
    assert port == uncompress(enc)
    assert port == jaxd


@pytest.mark.parametrize("flags", [0x04, 0x01, 0x45])
def test_flags_raise_as_jax(flags):
    enc = compress(CASES["ulen_mod32"], flags)
    with pytest.raises(ValueError) as port_err:
        to1.decode_nx16_o1_batch([enc], device="cpu")
    with pytest.raises(ValueError) as jax_err:
        jo1.decode_nx16_o1_batch([enc], interpret=True)
    assert str(port_err.value) == str(jax_err.value)


def test_dense_table_raises_as_jax():
    """A table past the A2_MAX gate is refused by both packages before any
    decode (the JAX lane leaves such blocks to the host)."""
    rng = np.random.default_rng(2)
    enc = compress(rng.integers(0, 256, 20000, dtype=np.uint8).tobytes(),
                   0x05)
    assert (to1._parse_o1_header(enc)[1] > 0).sum() > to1.A2_MAX
    with pytest.raises(ValueError) as port_err:
        to1.decode_nx16_o1_batch([enc], device="cpu")
    with pytest.raises(ValueError) as jax_err:
        jo1.decode_nx16_o1_batch([enc], interpret=True)
    assert str(port_err.value) == str(jax_err.value)


def test_decode_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        to1.decode_nx16_o1_batch([compress(CASES["ulen_mod32"], 0x05)])


def test_carry_segment_state_equals_jax(decoded):
    """From the JAX front end's arrays, the port's states, word cursors
    and contexts after SEG1 = 1024 rounds equal what one JAX segment call
    leaves, and the symbols of those rounds are the JAX segment's."""
    encs = decoded[0]
    parsed = [jo1._parse_o1_header(e) for e in encs]
    a2_pad, a_pad = jo1.o1_pads(parsed)
    B1 = jo1.pick_width(a2_pad)
    (data_w, lo2, d2, ad, x, out_szs, W, _maps,
     _p) = jo1._prepare_group_o1(encs[:B1], B1, a2_pad, a_pad, parsed[:B1])
    L = B1 * jo1.NWAY
    cnt = np.zeros(L, np.int32)
    for b in range(B1):
        cnt[b::B1] = out_szs[b] // jo1.NWAY
    run = jo1._compiled_seg1(a2_pad, a_pad, B1, True)
    syms, x_out, cur_out, ctx_out = run(
        data_w, lo2, d2, ad, x, np.zeros((1, B1), np.int32),
        np.zeros((8, L), np.int32),
        np.ascontiguousarray(np.broadcast_to(cnt[None, :], (8, L))))
    want_x, want_cur, want_ctx = carry.from_jax_segment(x_out, cur_out,
                                                        ctx_out, ad)

    b = carry.from_jax_group_o1(data_w, lo2, d2, ad, x, out_szs)
    assert b.ulen[:B1].tolist() == [len(CASES[k]) for k in NAMES[:B1]]
    out, got_x, got_cur, got_ctx = to1.rans_o1(b, max_rounds=jo1.SEG1)
    i = NAMES.index("full_segment")
    assert len(CASES["full_segment"]) // jo1.NWAY == jo1.SEG1
    assert np.array_equal(got_x[i].numpy().view(np.uint32), want_x[i])
    assert int(got_cur[i]) == want_cur[i]
    assert np.array_equal(got_ctx[i].numpy(), want_ctx[i])
    # state j's first SEG1 symbols sit at j*seg in both
    seg = len(CASES["full_segment"]) // jo1.NWAY
    jax_i = np.asarray(syms)[:, i::B1].astype(np.uint8)       # [SEG1, 32]
    o = int(b.out_off[i])
    for j in (0, 17, 31):
        want = CASES["full_segment"][j * seg:j * seg + jo1.SEG1]
        assert out[o + j * seg:o + j * seg + jo1.SEG1].numpy().tobytes() \
            == jax_i[:, j].tobytes() == want


_HARNESS = r"""
#include "rans_nx16_o1_step.cuh"

// One order-1 stream through the kernels' step code, the 32 lanes of a
// warp run in order: the ballot is the mask of states that need a word,
// and a state's word is cursor + popc(mask & lanes below it).
extern "C" int64_t decode_stream(const uint32_t* rows, const int32_t* cs,
                                 const uint32_t* x0, const uint16_t* words,
                                 int64_t n_words, int64_t ulen, uint8_t* out,
                                 uint32_t* x_out, uint32_t* ctx_out) {
  static uint8_t bucket[256 * RANS_O1_BUCKETS];
  uint16_t ctx_start[257];
  for (int c = 0; c < 257; ++c) ctx_start[c] = (uint16_t)cs[c];
  for (int lane = 0; lane < RANS_NWAY; ++lane)
    rans_o1_build_buckets(rows, ctx_start, bucket, lane, RANS_NWAY);
  uint32_t x[RANS_NWAY], ctx[RANS_NWAY];
  for (int j = 0; j < RANS_NWAY; ++j) x[j] = x0[j], ctx[j] = 0;
  const int64_t seg = ulen / RANS_NWAY;
  const int64_t rounds = rans_o1_state_len(ulen, RANS_NWAY - 1, RANS_NWAY);
  int64_t cur = 0;
  for (int64_t r = 0; r < rounds; ++r) {
    uint32_t mask = 0;
    for (int j = 0; j < RANS_NWAY; ++j) {
      if (r >= rans_o1_state_len(ulen, j, RANS_NWAY)) continue;
      ctx[j] = rans_o1_decode(&x[j], ctx[j], rows, ctx_start, bucket);
      out[j * seg + r] = (uint8_t)ctx[j];
      if (rans_needs_refill(x[j])) mask |= 1u << j;
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
  for (int j = 0; j < RANS_NWAY; ++j) x_out[j] = x[j], ctx_out[j] = ctx[j];
  return cur;
}
"""


@pytest.fixture(scope="module")
def step_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the step harness needs a C++ compiler")
    d = tmp_path_factory.mktemp("step_o1")
    src = d / "harness.cpp"
    src.write_text(_HARNESS)
    lib = d / "libstep.so"
    subprocess.run([gxx, "-x", "c++", "-shared", "-fPIC", "-O2", "-I", CSRC,
                    "-o", str(lib), str(src)], check=True)
    h = ctypes.CDLL(str(lib))
    h.decode_stream.restype = ctypes.c_int64
    h.decode_stream.argtypes = [ctypes.c_void_p] * 4 \
        + [ctypes.c_int64] * 2 + [ctypes.c_void_p] * 3
    return h


@pytest.mark.parametrize("name", ["full_segment", "ulen_mod32", "ulen_lt32",
                                  "constant", "ctx256", "uniform"])
def test_step_header_on_cpu(step_lib, name):
    """The CUDA step code, compiled for the host with the ballot/popc
    refill run in order, decodes byte for byte and leaves the plain
    version's final states, cursor and contexts."""
    data = CTX256 if name == "ctx256" else CASES[name]
    enc = compress(data, 0x05)
    b = to1.frame_o1_streams([to1._parse_o1_header(enc)], "cpu")
    rows = b.tables.rows.numpy().view(np.uint32).copy()
    cs = b.tables.ctx_start.numpy()[0].copy()
    words = b.payload.numpy()
    x0 = b.x0.numpy()[0].view(np.uint32).copy()
    ulen = int(b.ulen[0])
    out = np.zeros(max(ulen, 1), np.uint8)
    x_out = np.zeros(32, np.uint32)
    ctx_out = np.zeros(32, np.uint32)
    cur = step_lib.decode_stream(rows.ctypes.data, cs.ctypes.data,
                                 x0.ctypes.data, words.ctypes.data,
                                 int(b.n_words[0]), ulen, out.ctypes.data,
                                 x_out.ctypes.data, ctx_out.ctypes.data)
    assert out[:ulen].tobytes() == data == uncompress(enc)
    _, px, pcur, pctx = to1.rans_o1(b)
    assert np.array_equal(x_out, px.numpy()[0].view(np.uint32))
    assert np.array_equal(ctx_out, pctx.numpy()[0])
    assert cur == int(pcur[0])


def test_hist_plain_counts_decoded_symbols():
    encs = [compress(CASES[k], 0x05) for k in NAMES[:6]] \
        + [compress(CTX256, 0x05)]
    b = to1.frame_o1_streams([to1._parse_o1_header(e) for e in encs], "cpu")
    offs = torch.tensor([0, 1, 2, 3, 4, 5, 200], dtype=torch.int32)
    hist, x_h, cur_h, ctx_h = to1.rans_o1(b, offs=offs, qbins=256)
    syms, x_d, cur_d, ctx_d = to1.rans_o1(b)
    assert torch.equal(x_h, x_d) and torch.equal(cur_h, cur_d)
    assert torch.equal(ctx_h, ctx_d)
    for i, o in enumerate(offs.tolist()):
        s = syms[b.out_off[i]:b.out_off[i] + b.ulen[i]].long()
        want = torch.bincount((s - o).clamp(0, 255), minlength=256)
        assert torch.equal(hist[i].long(), want)
