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
from htslib_tpu.ops import device_stats as jds
from htslib_tpu.ops import rans_o1_pallas as jo1
from htslib_tpu_torch import carry
from htslib_tpu_torch.ops import device_stats as tds
from htslib_tpu_torch.ops import rans_nx16_o1 as to1
from chip_smoke import fallback_buckets, wide_stream
from test_torch_device_stats import read_walks as _walk
from test_torch_gpu import spread_stream

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
    parsed = [to1._parse_nx16_header(compress(CASES[k], 0x05)) for k in NAMES]
    a2_pad, _ = to1.o1_pads(parsed)
    assert jo1.pick_width(a2_pad) < len(NAMES)       # two JAX groups
    F = to1._parse_nx16_header(compress(CTX256, 0x05))[1]
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
    assert (to1._parse_nx16_header(enc)[1] > 0).sum() > to1.A2_MAX
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
#include <vector>

#include "rans_nx16_o1_step.cuh"

// The kernels' tables of one stream, built by 32 lanes in turn: the dense
// alphabet, the records and buckets and, with `maps` given, the slow
// buckets' maps (numbered lane by lane, as the kernels' scan numbers
// them).  Returns the alphabet's size; *n_slow gets the slow buckets.
static int tables(const uint32_t* rows, const int32_t* cs,
                  uint16_t* ctx_start, std::vector<uint32_t>* rec,
                  std::vector<uint16_t>* bucket, uint8_t* ctx_of,
                  std::vector<uint8_t>* maps, int64_t* n_slow) {
  uint8_t present[256] = {0}, index_of[256];
  for (int c = 0; c < 257; ++c) ctx_start[c] = (uint16_t)cs[c];
  for (int lane = 0; lane < 32; ++lane)
    rans_o1_mark(rows, ctx_start, present, lane, 32);
  int n_ctx = 0;
  for (int lane = 0; lane < 32; ++lane)
    n_ctx = rans_o1_index(present, index_of, ctx_of, lane, 32);
  rec->assign(ctx_start[256] + 1 + 2 * n_ctx, 0u);
  bucket->assign(n_ctx * RANS_O1_BUCKETS, 0);
  for (int lane = 0; lane < 32; ++lane)
    rans_o1_build(rows, ctx_start, rec->data(), bucket->data(), lane, 32,
                  n_ctx, ctx_of, index_of);
  int first[33] = {0};
  for (int lane = 0; lane < 32; ++lane)
    first[lane + 1] =
        first[lane] + rans_o1_count_slow(bucket->data(), n_ctx, lane, 32);
  *n_slow = first[32];
  if (maps) {
    maps->assign(first[32] * RANS_O1_MAP_BYTES, 0);
    for (int lane = 0; lane < 32; ++lane)
      rans_o1_maps(rec->data(), bucket->data(), maps->data(), n_ctx,
                   first[lane], lane, 32);
  }
  return n_ctx;
}

// One order-1 stream through the kernels' round, the 32 lanes of a warp run
// in order: every lane picks, the lanes whose bucket is slow look their
// slot up in its map, the live ones advance; the ballot is the mask of
// states that need a word, and a state's word is cursor + popc(mask &
// lanes below it).  Returns the cursor; *slow_rounds counts the rounds in
// which some lane's bucket was slow (the kernels' vote), *n_ctx and
// *n_slow the alphabet and the slow buckets.
extern "C" int64_t decode_stream(const uint32_t* rows, const int32_t* cs,
                                 const uint32_t* x0, const uint16_t* words,
                                 int64_t n_words, int64_t ulen, uint8_t* out,
                                 uint32_t* x_out, uint32_t* ctx_out,
                                 int64_t* slow_rounds, int64_t* n_ctx,
                                 int64_t* n_slow) {
  uint16_t ctx_start[257];
  std::vector<uint32_t> rec;
  std::vector<uint16_t> bucket;
  std::vector<uint8_t> maps;
  uint8_t ctx_of[256];
  *n_ctx = tables(rows, cs, ctx_start, &rec, &bucket, ctx_of, &maps, n_slow);
  uint32_t x[RANS_NWAY], ctx7[RANS_NWAY];
  for (int j = 0; j < RANS_NWAY; ++j) x[j] = x0[j], ctx7[j] = 0;
  const int64_t seg = ulen / RANS_NWAY;
  const int64_t rounds = rans_o1_state_len(ulen, RANS_NWAY - 1, RANS_NWAY);
  int64_t cur = 0;
  *slow_rounds = 0;
  for (int64_t r = 0; r < rounds; ++r) {
    uint32_t e[RANS_NWAY];
    bool any = false;
    for (int j = 0; j < RANS_NWAY; ++j) {
      bool slow;
      uint32_t v;
      e[j] = rans_o1_pick(rec.data(), bucket.data(), ctx7[j], x[j], &slow,
                          &v);
      if (slow) e[j] = rans_o1_mapped(rec.data(), maps.data(), v, x[j]);
      any |= slow;
    }
    *slow_rounds += any;
    uint32_t mask = 0;
    for (int j = 0; j < RANS_NWAY; ++j) {
      if (r >= rans_o1_state_len(ulen, j, RANS_NWAY)) continue;
      x[j] = rans_o1_advance(x[j], e[j]);
      ctx7[j] = rans_o1_ctx7(e[j]);
      out[j * seg + r] = ctx_of[e[j] >> 24];
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
  for (int j = 0; j < RANS_NWAY; ++j)
    x_out[j] = x[j], ctx_out[j] = ctx_of[ctx7[j] >> 7];
  return cur;
}

// Over every context of the alphabet and every slot, lookups whose row
// differs from a brute-force scan of the rows (the last row of the context
// whose cum is <= the slot, so slots past the sum go to the last row; an
// empty context: the row at its start, or the zero row past the last),
// through the pick and, where its bucket is slow, the walk (use_maps 0,
// as the 4x8 kernel) or the bucket's map (1, as the Nx16 kernels), and
// buckets whose value is not a multiple of 4.  A record's dense index is
// mapped back to its symbol.
extern "C" int64_t lookup_mismatches(const uint32_t* rows, const int32_t* cs,
                                     int use_maps) {
  uint16_t ctx_start[257];
  std::vector<uint32_t> rec;
  std::vector<uint16_t> bucket;
  std::vector<uint8_t> maps;
  uint8_t ctx_of[256];
  int64_t n_slow;
  const int n_ctx = tables(rows, cs, ctx_start, &rec, &bucket, ctx_of,
                           use_maps ? &maps : nullptr, &n_slow);
  const int n = ctx_start[256];
  int64_t bad = 0;
  for (int k = 0; k < n_ctx; ++k) {
    const int lo = ctx_start[ctx_of[k]], hi = ctx_start[ctx_of[k] + 1];
    for (uint32_t m = 0; m < RANS_TOTFREQ; ++m) {
      uint32_t want = lo < n ? rows[lo] : 0u;
      for (int r = lo; r < hi; ++r)
        if (rans_row_cum(rows[r]) <= m) want = rows[r];
      bool slow;
      uint32_t v;
      uint32_t got = rans_o1_pick(rec.data(), bucket.data(), k << 7, m,
                                  &slow, &v);
      if (slow)
        got = use_maps ? rans_o1_mapped(rec.data(), maps.data(), v, m)
                       : rans_o1_walk(rec.data(), bucket.data(), k << 7, m);
      // every bucket holds a multiple of 4: the pick's loads stay aligned
      bad += (got & 0xFFFFFFu) != (want & 0xFFFFFFu) ||
             ctx_of[got >> 24] != (want >> 24) || (v & 3u) != 0;
    }
  }
  return bad;
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
        + [ctypes.c_int64] * 2 + [ctypes.c_void_p] * 6
    h.lookup_mismatches.restype = ctypes.c_int64
    h.lookup_mismatches.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int]
    return h


# order-1 streams whose lookups meet slow buckets: one wide context (as
# chip_smoke.py's whole-stream check), and slow buckets in every context
STEP_EXTRA = {"wide": wide_stream(np.random.default_rng(33), 6000),
              "spread": spread_stream(np.random.default_rng(40), 20000)}


def _step_data(name):
    if name == "ctx256":
        return CTX256
    return STEP_EXTRA[name] if name in STEP_EXTRA else CASES[name]


def _slow_contexts(t):
    """Contexts of stream 0 of tables t with a bucket in which two or more
    rows start after its first slot."""
    rows = t.rows.numpy().view(np.uint32)[:int(t.n_rows[0])]
    cs = t.ctx_start.numpy()[0]
    ctx = np.repeat(np.arange(256), np.diff(cs))
    cum = (rows.astype(np.int64) >> 12) & 0xFFF
    inside = cum % 64 != 0
    k, cnt = np.unique(ctx[inside] * 64 + cum[inside] // 64,
                       return_counts=True)
    return set((k[cnt >= 2] // 64).tolist())


@pytest.mark.parametrize("name", ["full_segment", "ulen_mod32", "ulen_lt32",
                                  "constant", "ctx256", "uniform", "wide",
                                  "spread"])
def test_step_header_on_cpu(step_lib, name):
    """The CUDA step code, compiled for the host with the ballot/popc
    refill run in order, decodes byte for byte and leaves the plain
    version's final states, cursor and contexts; its alphabet is the one
    the wrapper sizes shared memory for, and the streams built to walk
    do."""
    data = _step_data(name)
    enc = compress(data, 0x05)
    b = to1.frame_o1_streams([to1._parse_nx16_header(enc)], "cpu")
    rows = b.tables.rows.numpy().view(np.uint32).copy()
    cs = b.tables.ctx_start.numpy()[0].copy()
    words = b.payload.numpy()
    x0 = b.x0.numpy()[0].view(np.uint32).copy()
    ulen = int(b.ulen[0])
    out = np.zeros(max(ulen, 1), np.uint8)
    x_out = np.zeros(32, np.uint32)
    ctx_out = np.zeros(32, np.uint32)
    slow_rounds = np.zeros(1, np.int64)
    n_ctx = np.zeros(1, np.int64)
    n_slow = np.zeros(1, np.int64)
    cur = step_lib.decode_stream(rows.ctypes.data, cs.ctypes.data,
                                 x0.ctypes.data, words.ctypes.data,
                                 int(b.n_words[0]), ulen, out.ctypes.data,
                                 x_out.ctypes.data, ctx_out.ctypes.data,
                                 slow_rounds.ctypes.data, n_ctx.ctypes.data,
                                 n_slow.ctypes.data)
    assert out[:ulen].tobytes() == data == uncompress(enc)
    _, px, pcur, pctx = to1.rans_o1(b)
    assert np.array_equal(x_out, px.numpy()[0].view(np.uint32))
    assert np.array_equal(ctx_out, pctx.numpy()[0])
    assert cur == int(pcur[0])
    sizes = to1.o1_table_sizes(b.tables)
    assert (int(n_ctx[0]), int(n_slow[0])) == (int(sizes[0][0]),
                                               int(sizes[1][0]))
    if name in STEP_EXTRA:
        assert slow_rounds[0] > 0
    if name == "spread":
        n_ctx_rows = int((np.diff(b.tables.ctx_start.numpy()[0]) > 0).sum())
        assert len(_slow_contexts(b.tables)) == n_ctx_rows == 64


@pytest.mark.parametrize("path", ["walk", "map"])
@pytest.mark.parametrize("name", ["full_segment", "constant", "ctx256",
                                  "uniform", "wide", "spread"])
def test_o1_lookup_matches_brute_force(step_lib, name, path):
    """Over every context of the stream's alphabet and every slot, the
    pick (and, where the bucket is slow, the walk or the bucket's map)
    finds the row a scan of the context's rows finds, unreachable slots
    included."""
    b = to1.frame_o1_streams(
        [to1._parse_nx16_header(compress(_step_data(name), 0x05))], "cpu")
    rows = b.tables.rows.numpy().view(np.uint32).copy()
    cs = b.tables.ctx_start.numpy()[0].copy()
    assert step_lib.lookup_mismatches(rows.ctypes.data, cs.ctypes.data,
                                      int(path == "map")) == 0


def test_table_sizes_of_a_batch():
    """The wrapper's sizes of each stream's table in a batch: the alphabet
    (context 0, the contexts with rows and the rows' symbols) and the slow
    buckets, with the streams' rows at offsets that are not back to back;
    tables whose cums do not rise within a context are refused."""
    datas = (CASES["constant"], CTX256, STEP_EXTRA["spread"], bytes([200]))
    b = to1.frame_o1_streams(
        [to1._parse_nx16_header(compress(d, 0x05)) for d in datas], "cpu")
    want = [len(set(np.frombuffer(d, np.uint8).tolist()) | {0})
            for d in datas]
    t = b.tables
    gap = to1.O1Tables(torch.cat([t.rows, t.rows]), t.row_off + t.rows.numel(),
                       t.n_rows, t.ctx_start)
    for tab in (t, gap):
        n_ctx, n_slow = to1.o1_table_sizes(tab)
        assert n_ctx.tolist() == want
        assert n_slow[2] >= 64 and n_slow[3] == 0
    for i in range(4):
        one = to1.frame_o1_streams(
            [to1._parse_nx16_header(compress(datas[i], 0x05))], "cpu").tables
        assert int(n_slow[i]) == fallback_buckets(one)
    rows = t.rows.clone()
    lo = int(t.row_off[2]) + int(t.ctx_start[2, 1])   # context 1's rows
    rows[lo + 1] = rows[lo]                            # a repeated cum
    with pytest.raises(ValueError, match="cums do not rise"):
        to1.o1_table_sizes(to1.O1Tables(rows, t.row_off, t.n_rows,
                                        t.ctx_start))


def test_replicate_copies_every_o1_stream():
    """The batch sweep's replicated Nx16 order-1 batch decodes, copy by
    copy, as the batch it was made from (plain version)."""
    from htslib_tpu_torch.bench_rans import replicate
    datas = [CASES["ulen_mod32"], CASES["sub_round"], CASES["constant"]]
    b = to1.frame_o1_streams(
        [to1._parse_nx16_header(compress(d, 0x05)) for d in datas], "cpu")
    copies = replicate(b, 3)
    assert copies.n_streams == 9
    assert to1.rans_o1(copies)[0].numpy().tobytes() == b"".join(datas) * 3
    for g, w in zip(to1.rans_o1(copies, qbins=64), to1.rans_o1(b, qbins=64)):
        assert torch.equal(g, w.repeat(3, *([1] * (w.dim() - 1))))


def test_hist_plain_counts_decoded_symbols():
    encs = [compress(CASES[k], 0x05) for k in NAMES[:6]] \
        + [compress(CTX256, 0x05)]
    b = to1.frame_o1_streams([to1._parse_nx16_header(e) for e in encs], "cpu")
    offs = torch.tensor([0, 1, 2, 3, 4, 5, 200], dtype=torch.int32)
    hist, x_h, cur_h, ctx_h = to1.rans_o1(b, offs=offs, qbins=256)
    syms, x_d, cur_d, ctx_d = to1.rans_o1(b)
    assert torch.equal(x_h, x_d) and torch.equal(cur_h, cur_d)
    assert torch.equal(ctx_h, ctx_d)
    for i, o in enumerate(offs.tolist()):
        s = syms[b.out_off[i]:b.out_off[i] + b.ulen[i]].long()
        want = torch.bincount((s - o).clamp(0, 255), minlength=256)
        assert torch.equal(hist[i].long(), want)


# -- a 256-context table under the A2_MAX gate ----------------------------
# (the whole of tests/test_torch_o1_ctx256.py, merged here: the
# table needs a 256-symbol JAX alphabet select, the costliest JAX
# configuration of the lane, minutes in interpret mode, and
# pytest-xdist's loadfile scheduling starts a file of many tests first)

def test_table_has_256_contexts_under_the_gate():
    F = to1._parse_nx16_header(compress(CTX256, 0x05))[1]
    assert (F.sum(axis=1) > 0).sum() == 256
    assert (F > 0).sum() <= to1.A2_MAX


def test_ctx256_matches_jax_and_host():
    datas = [CTX256, CTX256[:1007], CTX256[:4000]]
    encs = [compress(d, 0x05) for d in datas]
    assert to1.decode_nx16_o1_batch(encs, device="cpu") \
        == [uncompress(e) for e in encs] == datas
    got, _ = tds.qualstats_device_o1(encs, device="cpu")
    ref, _ = jds.qualstats_device_o1(encs, interpret=True)
    truth = tds.qualstats_host(datas)
    assert np.array_equal(got, truth)
    assert np.array_equal(got, ref)
