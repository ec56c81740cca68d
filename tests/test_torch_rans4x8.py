"""The port's rANS 4x8 codec copy (htslib_tpu_torch/codecs/rans4x8.py)
against the reference codec, and its order-0 decode (htslib_tpu_torch/
ops/rans4x8.py, kernel B7's plain version on the CPU) against the host
codec and the JAX package's Pallas decode in interpret mode; the state
carried across after one JAX segment (htslib_tpu_torch/carry.py); and the
kernels' round step (csrc/rans4x8_step.cuh) compiled for the CPU.
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
from chip_smoke import wide_stream
from test_torch_device_stats import read_walks as _walk
from test_torch_gpu import odd_payload_stream, short_table_compress

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "htslib_tpu_torch", "csrc")


@pytest.fixture(autouse=True, scope="module")
def _jax_32bit():
    """The JAX reference runs in its default 32-bit mode; another test
    module in the same worker process may have switched JAX to 64-bit."""
    jax.config.update("jax_enable_x64", False)


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
        return short_table_compress(CASES[name])
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
#include <vector>

#include "rans4x8_step.cuh"

// the refill of the wire the harness decodes: 4x8 unless built with
// -DRANS_W16=true (the 4-way Nx16 wire)
#ifndef RANS_W16
#define RANS_W16 false
#endif

static uint32_t tab[RANS_TOTFREQ];
static uint32_t rec[RANS_O1_RECORDS];
static uint16_t bucket[256 * RANS_O1_BUCKETS];
static uint16_t ctx_start[257];
// the wide order-1 table (set_wide(1): order 1 decodes through it)
static Rans8Rec wrec[RANS8_WIDE_RECORDS];
static uint32_t wbucket[256 * RANS_O1_BUCKETS];
static uint16_t wmaps[2048 * RANS8_WIDE_MAP];
static int wide_mode = 0, n_slow = 0;
extern "C" void set_wide(int on) { wide_mode = on; }
extern "C" int wide_slow() { return n_slow; }

// The wide table as a warp of 32 lanes builds it, lanes in turn: records
// and buckets, each lane's slow buckets counted, numbered from the count
// of the lanes before it, and mapped.
static void wide_tables(const uint32_t* rows) {
  for (int lane = 0; lane < 32; ++lane)
    rans8_wide_build(rows, ctx_start, wrec, wbucket, lane, 32);
  int first[33] = {0};
  for (int lane = 0; lane < 32; ++lane)
    first[lane + 1] = first[lane] + rans8_wide_count_slow(wbucket, lane, 32);
  n_slow = first[32];
  for (int lane = 0; lane < 32; ++lane)
    rans8_wide_maps(rows, ctx_start, wbucket, wmaps, first[lane], lane, 32);
}

// The kernels' tables, built by 32 lanes in turn: order 0 the slot
// table, order 1 the row records and buckets (and the wide table).
static void tables(int o1, const int32_t* freq, const uint32_t* rows,
                   const int32_t* cs) {
  if (o1) {
    for (int c = 0; c < 257; ++c) ctx_start[c] = (uint16_t)cs[c];
    for (int lane = 0; lane < 32; ++lane)
      rans_o1_build(rows, ctx_start, rec, bucket, lane, 32);
    if (wide_mode) wide_tables(rows);
  } else {
    uint16_t f[256];
    for (int s = 0; s < 256; ++s) f[s] = (uint16_t)freq[s];
    for (int lane = 0; lane < 32; ++lane)
      rans_o0_build_slots(f, tab, lane, 32);
  }
}

// One 4x8 stream through the kernels' round: rans8_round on the window at
// the cursor, rans8_advance over the whole payload staged as the kernels
// stage it (rans8_stage_word; they read it from a ring of chunks).  `tail`
// is the payload's last word as it lies in memory, bytes past the end
// included.  Returns the wire's cursor; *pos is the kernels' cursor
// (capped here after every round, in the kernels between blocks), *loops
// the lookups that fell through to the order-1 loop, or -1
// when a round before the tail was not full.
extern "C" int64_t decode_stream(int o1, const int32_t* freq,
                                 const uint32_t* rows, const int32_t* cs,
                                 const uint32_t* x0, const uint8_t* bytes,
                                 int64_t n_bytes, uint32_t tail, int64_t ulen,
                                 uint8_t* out, uint32_t* x_out, int64_t* pos,
                                 int64_t* loops) {
  tables(o1, freq, rows, cs);
  const uint32_t nb = (uint32_t)n_bytes, nw = (nb + 3u) / 4u;
  const uint32_t cap = 4u * nw + 32u;
  std::vector<uint32_t> words(nw + 16, 0u);
  for (uint32_t i = 0; i < nw; ++i) {
    uint32_t v = tail;
    if (i + 1 < nw)
      v = bytes[4 * i] | (bytes[4 * i + 1] << 8) | (bytes[4 * i + 2] << 16) |
          ((uint32_t)bytes[4 * i + 3] << 24);
    words[i] = rans8_stage_word(v, i, nb);
  }
  uint32_t x[RANS8_NWAY], ctx7[RANS8_NWAY] = {0, 0, 0, 0}, syms;
  for (int j = 0; j < RANS8_NWAY; ++j) x[j] = x0[j];
  Rans8Window w = {words[0], words[1], words[2], 0u};
  const int64_t rounds = rans8_rounds(o1, ulen);
  *loops = 0;
  for (int64_t r = 0; r < rounds; ++r) {
    unsigned live = 0;
    int64_t at[RANS8_NWAY];
    for (int j = 0; j < RANS8_NWAY; ++j)
      if (rans8_live(o1, ulen, j, r, &at[j])) live |= 1u << j;
    if (r < ulen / RANS8_NWAY && live != 0xFu) return *loops = -1;
    for (int j = 0; j < RANS8_NWAY && o1; ++j) {
      bool slow;
      if (wide_mode)
        slow = wbucket[(ctx7[j] >> 2) | ((x[j] >> 6) & 63u)] &
               RANS8_WIDE_SLOW;
      else
        rans_o1_pick(rec, bucket, ctx7[j], x[j], &slow);
      if (((live >> j) & 1u) && slow) ++*loops;
    }
    uint32_t hi, lo;
    rans8_window(w.w0, w.w1, w.w2, w.pos, &hi, &lo);
    const uint32_t k =
        o1 && wide_mode
        ? rans8_round_wide<RANS_W16>(x, ctx7, &syms, live, hi, lo, wrec,
                                     wbucket, wmaps) :
        o1 ? rans8_round<true, RANS_W16>(x, ctx7, &syms, live, hi, lo, rec,
                                         bucket)
           : rans8_round<false, RANS_W16>(x, ctx7, &syms, live, hi, lo, tab,
                                          nullptr);
    for (int j = 0; j < RANS8_NWAY; ++j)
      if ((live >> j) & 1u) out[at[j]] = (uint8_t)(syms >> (8 * j));
    rans8_advance(&w, k, words.data(), 0xFFFFFFFFu);
    rans8_cap(&w, cap, words.data(), 0xFFFFFFFFu);
  }
  for (int j = 0; j < RANS8_NWAY; ++j) x_out[j] = x[j];
  *pos = w.pos;
  return w.pos < nb ? w.pos : nb;
}

// (ctx, slot) pairs over all 256 x 4096 where the 4x8 lookup's row and
// a brute-force scan of the rows differ: the last row of the context whose
// cum is <= the slot (so slots past the sum go to the last row), and for
// an empty context the row at its start (the zero row past the last).
extern "C" int64_t lookup_mismatches(const uint32_t* rows,
                                     const int32_t* cs) {
  tables(1, nullptr, rows, cs);
  const int n = cs[256];
  int64_t bad = 0;
  for (uint32_t c = 0; c < 256; ++c)
    for (uint32_t m = 0; m < RANS_TOTFREQ; ++m) {
      uint32_t want = cs[c] < n ? rows[cs[c]] : 0u;
      for (int r = cs[c]; r < cs[c + 1]; ++r)
        if (rans_row_cum(rows[r]) <= m) want = rows[r];
      bool slow;
      uint32_t got = rans_o1_pick(rec, bucket, c << 7, m, &slow);
      if (slow) got = rans_o1_walk(rec, bucket, c << 7, m);
      bad += got != want;
      if (wide_mode) {
        const Rans8Rec g = *rans8_wide_lookup(wrec, wbucket, wmaps, c << 8, m);
        const Rans8Rec t = rans8_wide_record(want);
        bad += g.f != t.f || g.neg_cum != t.neg_cum || g.ctx != t.ctx ||
               g.sym != t.sym;
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
    d = tmp_path_factory.mktemp("step4x8")
    src = d / "harness.cpp"
    src.write_text(_HARNESS)
    lib = d / "libstep.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-shared", "-fPIC", "-O2",
                    "-I", CSRC, "-o", str(lib), str(src)], check=True)
    h = ctypes.CDLL(str(lib))
    h.decode_stream.restype = ctypes.c_int64
    h.decode_stream.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 \
        + [ctypes.c_int64, ctypes.c_uint32, ctypes.c_int64] \
        + [ctypes.c_void_p] * 4
    h.lookup_mismatches.restype = ctypes.c_int64
    h.lookup_mismatches.argtypes = [ctypes.c_void_p] * 2
    h.set_wide.restype = None
    h.set_wide.argtypes = [ctypes.c_int]
    h.wide_slow.restype = ctypes.c_int
    h.wide_slow.argtypes = []
    return h


def _step_cases():
    rng = np.random.default_rng(8)
    # context 0 with ~256 successors of frequency ~16: a 64-slot bucket
    # holds several row starts
    wide = wide_stream(rng, 6000)
    short = _walk(rng, 3007)
    odd, odd_enc = odd_payload_stream(np.random.default_rng(5))
    trunc = r8.compress(_walk(rng, 2003), 0)
    return {
        ("wide_o1", 1): (wide, r8.compress(wide, 1)),
        ("short_table_o1", 1): (short, short_table_compress(short, order=1)),
        ("odd_payload", 0): (odd, odd_enc),
        # the last 5 payload bytes cut: the cursor runs past the end
        ("truncated", 0): (None, trunc[:-5]),
    }


STEP_CASES = _step_cases()


def _step_stream(name, order):
    if (name, order) in STEP_CASES:
        return STEP_CASES[name, order]
    if name in WIDE_CASES:
        return WIDE_CASES[name], r8.compress(WIDE_CASES[name], order)
    d = CASES[name]
    return d, (_enc(name) if order == 0 else r8.compress(d, 1))


def _run_step(step_lib, b):
    """Stream 0 of batch b through the harness: (symbols, final states,
    wire cursor, kernel cursor, fallback lookups)."""
    data = b.payload.numpy()
    freq = b.freqs.numpy()[0].copy()
    if b.o1:
        rows = b.tables.rows.numpy().view(np.uint32).copy()
        cs = b.tables.ctx_start.numpy()[0].copy()
    else:
        rows = np.zeros(1, np.uint32)
        cs = np.zeros(257, np.int32)
    x0 = b.x0.numpy()[0].view(np.uint32).copy()
    ulen = int(b.ulen[0])
    nb = int(b.n_bytes[0])
    out = np.zeros(max(ulen, 1), np.uint8)
    x_out = np.zeros(4, np.uint32)
    pos = np.zeros(1, np.int64)
    loops = np.zeros(1, np.int64)
    # the last word's bytes past the payload hold garbage, as a buffer
    # packed without padding would
    last = bytearray(data[4 * ((nb - 1) // 4):][:4].tobytes()
                     if nb else b"\0" * 4)
    for i in range(nb % 4 or 4, 4):
        last[i] = 0xA5
    cur = step_lib.decode_stream(
        int(b.o1), freq.ctypes.data, rows.ctypes.data, cs.ctypes.data,
        x0.ctypes.data, data.ctypes.data, nb,
        int.from_bytes(bytes(last), "little"), ulen, out.ctypes.data,
        x_out.ctypes.data, pos.ctypes.data, loops.ctypes.data)
    assert int(loops[0]) >= 0, "a round before the tail was not full"
    return out[:ulen].tobytes(), x_out, cur, int(pos[0]), int(loops[0])


@pytest.mark.parametrize("name,order", [
    ("two_segments", 0), ("tail3", 0), ("short_table", 0),
    ("full_alphabet", 0), ("constant", 0), ("under_4", 0),
    ("two_segments", 1), ("tail3", 1), ("full_alphabet", 1),
    ("constant", 1), ("wide_o1", 1), ("short_table_o1", 1),
    ("odd_payload", 0), ("truncated", 0), ("leg3_walk", 1),
    ("every_slow", 1)])
def test_step_header_on_cpu(step_lib, name, order):
    """The CUDA round code, compiled for the host with the kernels' word
    window, decodes byte for byte and leaves the plain version's final
    states and cursor."""
    raw, enc = _step_stream(name, order)
    b = t8.frame_4x8([enc], bool(order), "cpu")
    out, x_out, cur, pos, loops = _run_step(step_lib, b)
    nb = int(b.n_bytes[0])
    if raw is None:
        # no host truth for a cut stream: the plain version's symbols,
        # and the cursor held at the payload's end
        assert out == t8.rans4x8(b)[0].numpy().tobytes()
        assert pos > nb and cur == nb
    else:
        assert out == raw == r8.uncompress(enc)
    _, px, pcur, _ = t8.rans4x8(b, qbins=64)
    assert np.array_equal(x_out, px.numpy()[0].view(np.uint32))
    assert cur == int(pcur[0])
    if name in ("wide_o1", "leg3_walk", "every_slow"):
        assert loops > 0
    if name == "odd_payload":
        assert nb % 4 and cur == nb
    if name == "short_table_o1":
        F = b.tables
        rows = F.rows.numpy().view(np.uint32)[:int(F.n_rows[0])]
        cs = F.ctx_start.numpy()[0]
        sums = np.add.reduceat((rows & 0xFFF).astype(np.int64) + 1,
                               cs[:-1][cs[:-1] < cs[1:]])
        assert (sums < 4096).all()


@pytest.mark.parametrize("name", ["two_segments", "full_alphabet",
                                  "constant", "wide_o1", "short_table_o1",
                                  "leg3_walk", "every_slow"])
def test_o1_lookup_matches_nx16_lookup(step_lib, name):
    """Over every (context, slot), the 4x8 order-1 lookup (the shared
    order-1 table over all 256 contexts) finds the row a scan of the
    context's rows finds, unreachable slots included (past a context's
    sum: its last row; an empty context: the row at its start)."""
    _, enc = _step_stream(name, 1)
    t = t8.frame_4x8([enc], True, "cpu").tables
    rows = t.rows.numpy().view(np.uint32).copy()
    cs = t.ctx_start.numpy()[0].copy()
    assert step_lib.lookup_mismatches(rows.ctypes.data, cs.ctypes.data) == 0


def _every_slow(k=3):
    """Context 0 followed by each of the 256 symbols k times (every other
    context by 0): a context of 256 rows, 255 of f = 15 and one of 271 (the
    encoder's rounding), so two or more rows start inside each of its 64
    buckets but the four the large row covers."""
    rng = np.random.default_rng(41)
    out = bytearray()
    for v in rng.permutation(np.repeat(np.arange(256), k)):
        out += bytes([0, v])
    return bytes(out)


WIDE_CASES = {
    "leg3_walk": _walk(np.random.default_rng(43), 1 << 16),
    "every_slow": _every_slow(),
}


class _Wide:
    """The harness's order-1 rounds through the wide table inside a with
    block."""

    def __init__(self, lib):
        self.lib = lib

    def __enter__(self):
        self.lib.set_wide(1)
        return self.lib

    def __exit__(self, *exc):
        self.lib.set_wide(0)


WIDE_NAMES = ["two_segments", "tail3", "full_alphabet", "constant",
              "wide_o1", "short_table_o1", "leg3_walk", "every_slow"]


@pytest.fixture(scope="module")
def jax_o1():
    """The JAX package's 4x8 order-1 decode (ops/rans.py
    `_dec4x8_o1_impl`, XLA on the CPU) of every wide case, in one call."""
    from htslib_tpu.ops import rans as jrans
    encs = [_step_stream(k, 1)[1] for k in WIDE_NAMES]
    return dict(zip(WIDE_NAMES, jrans.uncompress_batch(encs)))


@pytest.mark.parametrize("name", WIDE_NAMES)
def test_wide_step_on_cpu(step_lib, jax_o1, name):
    """The kernels' order-1 round through the wide table (ready records,
    u32 buckets, the slow buckets' maps; no loop and no branch), compiled
    for the host, decodes byte for byte as the host codec and the JAX
    function do, and leaves the plain version's final states, cursor and
    contexts; the wide stream's and the 256-row context's lookups meet
    slow buckets."""
    raw, enc = _step_stream(name, 1)
    b = t8.frame_4x8([enc], True, "cpu")
    with _Wide(step_lib):
        out, x_out, cur, _pos, loops = _run_step(step_lib, b)
        n_slow = step_lib.wide_slow()
    assert out == raw == r8.uncompress(enc) == jax_o1[name]
    _, px, pcur, _ = t8.rans4x8(b, qbins=64)
    assert np.array_equal(x_out, px.numpy()[0].view(np.uint32))
    assert cur == int(pcur[0])
    # the slow buckets the kernel's shared memory is sized by
    from htslib_tpu_torch.ops.rans_nx16_o1 import o1_table_sizes
    assert n_slow == int(o1_table_sizes(b.tables)[1][0])
    if name in ("wide_o1", "every_slow", "leg3_walk"):
        assert loops > 0 and n_slow > 0
    if name == "every_slow":
        assert n_slow == 60
    if name == "constant":
        assert n_slow == 0


@pytest.mark.parametrize("name", WIDE_NAMES)
def test_wide_lookup_matches_scan(step_lib, name):
    """Over every (context, slot), the wide lookup's record is the row a
    scan of the context's rows finds (unreachable slots included), as the
    compact lookup's is."""
    _, enc = _step_stream(name, 1)
    t = t8.frame_4x8([enc], True, "cpu").tables
    rows = t.rows.numpy().view(np.uint32).copy()
    cs = t.ctx_start.numpy()[0].copy()
    with _Wide(step_lib):
        assert step_lib.lookup_mismatches(rows.ctypes.data,
                                          cs.ctypes.data) == 0


@pytest.mark.parametrize("mutation", ["boundary", "map"])
def test_wide_mutation_fails(tmp_path, mutation):
    """A wide lookup that moves to the next record one slot early, or maps
    that take a row one slot late, must disagree with the host codec."""
    mut = tmp_path / "csrc"
    mut.mkdir()
    for f in os.listdir(CSRC):
        if f.endswith(".cuh"):
            shutil.copy(os.path.join(CSRC, f), mut / f)
    hdr = mut / "rans4x8_step.cuh"
    text = hdr.read_text()
    old, new = {
        "boundary": ("uint32_t idx = (v + t) >> 6;",
                     "uint32_t idx = (v + t + 1) >> 6;"),
        "map": ("<= slot) ++r;\n        maps[",
                "< slot) ++r;\n        maps["),
    }[mutation]
    assert text.count(old) == 1
    hdr.write_text(text.replace(old, new))
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the step harness needs a C++ compiler")
    src = tmp_path / "harness.cpp"
    src.write_text(_HARNESS)
    lib = tmp_path / "libmut.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-shared", "-fPIC", "-O2",
                    "-I", str(mut), "-o", str(lib), str(src)], check=True)
    h = ctypes.CDLL(str(lib))
    h.decode_stream.restype = ctypes.c_int64
    h.decode_stream.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 \
        + [ctypes.c_int64, ctypes.c_uint32, ctypes.c_int64] \
        + [ctypes.c_void_p] * 4
    h.set_wide.argtypes = [ctypes.c_int]
    h.set_wide(1)
    bad = 0
    for name in ("wide_o1", "every_slow", "leg3_walk"):
        raw, enc = _step_stream(name, 1)
        bad += _run_step(h, t8.frame_4x8([enc], True, "cpu"))[0] != raw
    assert bad > 0


def test_bench_batches_copy_every_stream():
    """The 4x8 batch sweep's replicated batch decodes, copy by copy, as
    the batch it was made from (plain version, both orders)."""
    from htslib_tpu_torch.bench_rans import replicate
    rng = np.random.default_rng(14)
    for order in (0, 1):
        datas = [_walk(rng, n) for n in (301, 1002, 77)]
        b = t8.frame_4x8([r8.compress(d, order) for d in datas],
                         bool(order), "cpu")
        copies = replicate(b, 3)
        assert copies.n_streams == 9
        got = t8.rans4x8(copies, qbins=64)
        for g, w in zip(got, t8.rans4x8(b, qbins=64)):
            assert torch.equal(g, w.repeat(3, *([1] * (w.dim() - 1))))
        if order == 0:
            assert t8.rans4x8(copies)[0].numpy().tobytes() \
                == b"".join(datas) * 3


def test_streams_per_sm_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        t8.blocks_per_sm(True, True)
