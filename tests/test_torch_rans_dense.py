"""The dense order-1 repair of the port's whole-stream rANS decode
(htslib_tpu_torch/ops/rans.py: order-1 streams past A2_MAX (context,
symbol) rows go to the dense-table variants of X1, X3 and B5, whose plain
versions run with device="cpu") against the JAX functions
(htslib_tpu/ops/rans.py, XLA on the CPU) and the host codecs on all three
order-1 wires; the dense lookup of the step headers (rans_o1_dense in
rans8_round) compiled with g++, with a mutated copy that must fail; and
the unnormalised order-0 table on which the two references disagree.
Bytes and states: equality is exact."""
import ctypes
import os
import shutil
import subprocess

import jax
import numpy as np
import pytest

from htslib_tpu.codecs import rans4x16 as host16
from htslib_tpu.codecs.rans4x16 import compress
from htslib_tpu.ops import device_stats as jds
from htslib_tpu.ops import rans as jrans
from htslib_tpu_torch.codecs import rans4x8 as r8
from htslib_tpu_torch.codecs import rans4x16 as r16
from htslib_tpu_torch.ops import device_stats as tds
from htslib_tpu_torch.ops import rans as trans
from htslib_tpu_torch.ops import rans4x8 as t8
from htslib_tpu_torch.ops import rans_nx16_o1 as to1
from test_torch_device_stats import check_committed_fixture, write_o1_cram
from test_torch_device_stats import read_walks as _walk
from test_torch_gpu import short_table_compress, unnormalised_stream
from test_torch_rans4x8 import CSRC, _HARNESS
from tests.test_torch_timing_contract import (check_timing_contract,
                                              quality_streams)


@pytest.fixture(autouse=True, scope="module")
def _jax_32bit():
    """The JAX reference runs in its default 32-bit mode; another test
    module in the same worker process may have switched JAX to 64-bit."""
    jax.config.update("jax_enable_x64", False)


def _dense_raws(seed=31):
    """name -> raw bytes: uniform random bytes over 256 symbols (~20,000
    to ~60,000 rows) at lengths n % 4 and n % 32 in several residues, and
    a walk whose table stays within A2_MAX (decoded in the same call by
    the record kernels)."""
    rng = np.random.default_rng(seed)
    out = {f"rand_{n}": rng.integers(0, 256, n, dtype=np.uint8).tobytes()
           for n in (20000, 20001, 20002, 20003, 20031)}
    out["walk"] = _walk(rng, 3001)
    return out


RAWS = _dense_raws()
WIRES = {"4x8": lambda d: r8.compress(d, 1),
         "nx16_4way": lambda d: r16.compress(d, 0x01),
         "nx16_32way": lambda d: r16.compress(d, 0x05)}
ENCS = {(w, k): enc(d) for w, enc in WIRES.items() for k, d in RAWS.items()}


def _rows(wire, enc):
    if wire == "4x8":
        return to1.o1_row_count(t8._parse_4x8_o1(enc)[1])
    nway = 32 if wire == "nx16_32way" else 4
    return to1.o1_row_count(to1._parse_nx16_header(enc, nway)[1])


@pytest.fixture(scope="module")
def decoded():
    """Each wire's streams in one call through the port (CPU) and the JAX
    function: {(wire, name): (port bytes, JAX bytes)}."""
    out = {}
    for wire in WIRES:
        keys = [k for k in ENCS if k[0] == wire]
        encs = [ENCS[k] for k in keys]
        if wire == "4x8":
            port = trans.uncompress_batch(encs, device="cpu")
            jaxd = jrans.uncompress_batch(encs)
        else:
            port = trans.uncompress_nx16_batch(encs, device="cpu")
            jaxd = jrans.uncompress_nx16_batch(encs)
        out.update(zip(keys, zip(port, jaxd)))
    return out


@pytest.mark.parametrize("wire,name", list(ENCS), ids=[f"{w}-{k}" for w, k
                                                      in ENCS])
def test_dense_streams_match_jax_and_host(decoded, wire, name):
    enc = ENCS[wire, name]
    assert (_rows(wire, enc) > to1.A2_MAX) == name.startswith("rand")
    port, jaxd = decoded[wire, name]
    host = r8.uncompress(enc) if wire == "4x8" else r16.uncompress(enc)
    assert port == jaxd == RAWS[name] == host


def test_dense_batches_carry_the_jax_tables():
    """The framings' dense tables are the JAX function's packed entries
    (its _pack_table over every context with rows), and a dense batch
    holds no rows."""
    enc = ENCS["4x8", "rand_20000"]
    b = t8.frame_4x8([enc], True, "cpu", dense=True)
    assert b.tables is None and b.o1
    F = t8._parse_4x8_o1(enc)[1]
    cum = np.zeros((256, 257), np.int64)
    np.cumsum(F, axis=1, out=cum[:, 1:])
    want = np.zeros(256 * 4096, np.uint32)
    for c in np.nonzero(F.sum(axis=1))[0]:
        want[c * 4096:(c + 1) * 4096] = jrans._pack_table(F[c], cum[c])
    assert np.array_equal(b.dense.numpy()[0].view(np.uint32), want)
    b = to1.frame_o1_streams([to1._parse_nx16_header(
        ENCS["nx16_32way", "rand_20001"])], "cpu", dense=True)
    assert b.tables is None and b.dense.shape == (1, 256 * 4096)


def test_dense_tables_built_as_jax_packs(monkeypatch):
    """dense_tables, built in passes of streams on the batch's device,
    against the JAX function's _pack_table on every context: sums of
    4,096 and below, empty contexts, zero-frequency symbols between used
    ones, a single symbol of frequency 4,096 (f - 1 = 4,095 once
    packed) and cums up to 4,095 (entries past 2^31), over three streams
    in passes of two."""
    rng = np.random.default_rng(5)
    Fs = []
    for _ in range(3):
        F = np.zeros((256, 256), np.int64)
        for ctx in range(256):
            kind = ctx % 4
            if kind == 1:
                F[ctx] = rng.multinomial(4096, np.full(256, 1 / 256))
            elif kind == 2:
                used = rng.choice(256, 7, replace=False)
                F[ctx, used] = rng.integers(1, 500, 7)
            elif kind == 3:
                F[ctx, 255 - ctx % 200] = 4096
        Fs.append(F)
    monkeypatch.setattr(to1, "DENSE_CHUNK", 2)
    got = to1.dense_tables(Fs, "cpu").numpy().view(np.uint32)
    for i, F in enumerate(Fs):
        cum = np.cumsum(F, axis=1) - F
        want = np.concatenate([jrans._pack_table(F[c], cum[c])
                               for c in range(256)])
        assert np.array_equal(got[i], want)
    with pytest.raises(ValueError, match="exceed 4096"):
        F = np.zeros((256, 256), np.int64)
        F[9, :2] = 2049
        to1.dense_tables([F], "cpu")


def test_timing_names_each_launch_group(monkeypatch):
    """The entry points' `timing` dicts: one entry a launch group, with
    its streams and parts, the dense table build inside the framing of a
    dense group (a large group builds none), and the routing parse; the
    bytes are those of a call without it.  On the CPU no wave bounds the
    large group; with the large variant refused (`large_fits` false) the
    same streams go to the dense group."""
    encs = [ENCS["4x8", "rand_20000"], ENCS["4x8", "walk"]]
    for route, fits in (("_large", True), ("_dense", False)):
        monkeypatch.setattr(t8, "large_fits", lambda Fs, w16, dev,
                            fits=fits: fits)
        timing = {}
        assert trans.uncompress_batch(encs, device="cpu",
                                      timing=timing) == [
            RAWS["rand_20000"], RAWS["walk"]]
        assert set(timing) == {"4x8_o1", "4x8_o1" + route, "route_s"}
        assert timing.pop("route_s") > 0
        past = timing["4x8_o1" + route]
        assert past["streams"] == 1
        if route == "_dense":
            assert 0 < past["dense_table_s"] <= past["frame_s"]
        else:
            assert "dense_table_s" not in past
        assert "dense_table_s" not in timing["4x8_o1"]
    monkeypatch.undo()
    encs = [ENCS[w, n] for w in ("nx16_4way", "nx16_32way")
            for n in ("rand_20001", "walk")]
    for route, fits in (("_large", True), ("_dense", False)):
        monkeypatch.setattr(t8, "large_fits", lambda Fs, w16, dev,
                            fits=fits: fits)
        monkeypatch.setattr(to1, "large_fits", lambda Fs, dev,
                            fits=fits: fits)
        timing = {}
        assert trans.uncompress_nx16_batch(encs, device="cpu",
                                           timing=timing) \
            == [RAWS["rand_20001"], RAWS["walk"]] * 2
        assert set(timing) == {f"nx16_{w}way_o1{d}" for w in (4, 32)
                               for d in ("", route)} | {"route_s"}
        assert timing.pop("route_s") > 0
        assert all(t["streams"] == 1 and t["frame_s"] > 0
                   and t["decode_s"] > 0 for t in timing.values())


def test_routing_parses_each_stream_once(monkeypatch):
    """ops/rans.py parses an order-1 stream's table once: the row count
    that routes it and the framing share the parse."""
    calls = []

    def counted(fn):
        def wrap(data, *a):
            calls.append(data)
            return fn(data, *a)
        return wrap

    p48 = counted(t8._parse_4x8_o1)
    monkeypatch.setattr(trans, "_parse_4x8_o1", p48)
    monkeypatch.setattr(t8, "_parse_4x8_o1", p48)
    encs = [ENCS["4x8", n] for n in ("rand_20000", "walk")]
    assert trans.uncompress_batch(encs, device="cpu") == [
        RAWS["rand_20000"], RAWS["walk"]]
    assert calls == encs
    calls.clear()
    p16 = counted(to1._parse_nx16_header)
    for mod in (trans, t8, to1):
        monkeypatch.setattr(mod, "_parse_nx16_header", p16)
    encs = [ENCS[w, n] for w in ("nx16_4way", "nx16_32way")
            for n in ("rand_20001", "walk")]
    assert trans.uncompress_nx16_batch(encs, device="cpu") == [
        RAWS["rand_20001"], RAWS["walk"]] * 2
    assert sorted(calls) == sorted(encs)


@pytest.mark.parametrize("wire", ["4x8", "nx16_4way", "nx16_32way"])
def test_bench_batches_copy_dense_tables(wire):
    """The batch sweep's replicated dense batch (bench_rans.py) decodes,
    copy by copy, as the streams it was made from (plain versions)."""
    from htslib_tpu_torch.bench_rans import replicate
    names = ["rand_20002", "walk"]
    encs = [ENCS[wire, n] for n in names]
    if wire == "nx16_32way":
        b = to1.frame_o1_streams([to1._parse_nx16_header(e) for e in encs],
                                 "cpu", True)
        decode = to1.decode_o1_streams
    else:
        frame = t8.frame_4x8 if wire == "4x8" else t8.frame_nx16_4way
        b = frame(encs, True, "cpu", True)
        decode = t8.decode_streams
    copies = replicate(b, 3)
    assert copies.n_streams == 6 and copies.dense.shape == (6, 256 * 4096)
    assert decode(copies) == [RAWS[n] for n in names] * 3


def test_lane_functions_still_refuse():
    """decode_nx16_o1_batch and the 4x8 gate keep refusing tables past
    A2_MAX, as their JAX twins do; only ops/rans.py routes them."""
    with pytest.raises(ValueError, match="alphabet too large"):
        to1.decode_nx16_o1_batch([ENCS["nx16_32way", "rand_20000"]],
                                 device="cpu")
    with pytest.raises(ValueError, match="alphabet too large"):
        t8.frame_4x8([ENCS["4x8", "rand_20000"]], True, "cpu")
    with pytest.raises(ValueError, match="alphabet too large"):
        t8.frame_nx16_4way([ENCS["nx16_4way", "rand_20000"]], True, "cpu")


def test_dense_frequencies_past_4096_raise_as_jax():
    """A dense 4x8 stream whose context frequencies sum past 4096: the
    JAX function and the port's dense framing refuse it."""
    enc = short_table_compress(RAWS["rand_20000"], 1, short=-96)
    assert _rows("4x8", enc) > to1.A2_MAX
    with pytest.raises(ValueError):
        trans.uncompress_batch([enc], device="cpu")
    with pytest.raises(ValueError):
        jrans.uncompress_batch([enc])


# ---------------------------------------------------------------------------
# The dense lookup in the kernels' round, on the CPU
# ---------------------------------------------------------------------------

_OLD_ROUND = ("o1 ? rans8_round<true, RANS_W16>(x, ctx7, &syms, live, hi, "
              "lo, rec,\n                                         bucket)")
_DENSE_HARNESS = _HARNESS.replace(
    "static uint16_t ctx_start[257];",
    "static uint16_t ctx_start[257];\n"
    "static const uint32_t* dense_tab;\n"
    'extern "C" void set_dense(const uint32_t* d) { dense_tab = d; }').replace(
    _OLD_ROUND, "o1 ? rans8_round<true, RANS_W16, true>(x, ctx7, &syms, "
    "live, hi, lo, dense_tab, nullptr)")


def _compile(tmp_path, csrc, w16):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the step harness needs a C++ compiler")
    assert _OLD_ROUND in _HARNESS
    src = tmp_path / "harness.cpp"
    src.write_text(_DENSE_HARNESS)
    lib = tmp_path / f"libdense{int(w16)}.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-shared", "-fPIC", "-O2",
                    f"-DRANS_W16={'true' if w16 else 'false'}", "-I",
                    str(csrc), "-o", str(lib), str(src)], check=True)
    h = ctypes.CDLL(str(lib))
    h.set_dense.restype = None
    h.set_dense.argtypes = [ctypes.c_void_p]
    h.decode_stream.restype = ctypes.c_int64
    h.decode_stream.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 \
        + [ctypes.c_int64, ctypes.c_uint32, ctypes.c_int64] \
        + [ctypes.c_void_p] * 4
    return h


def _run_dense(h, b):
    """Stream 0 of dense batch b through the harness's round: (symbols,
    final states)."""
    dense = np.ascontiguousarray(b.dense.numpy()[0].view(np.uint32))
    h.set_dense(dense.ctypes.data)
    data = b.payload.numpy()
    nb, ulen = int(b.n_bytes[0]), int(b.ulen[0])
    rows = np.zeros(1, np.uint32)
    cs = np.zeros(257, np.int32)
    freq = np.zeros(256, np.int32)
    x0 = b.x0.numpy()[0].view(np.uint32).copy()
    out = np.zeros(max(ulen, 1), np.uint8)
    x_out = np.zeros(4, np.uint32)
    pos = np.zeros(1, np.int64)
    loops = np.zeros(1, np.int64)
    last = data[4 * ((nb - 1) // 4):][:4].tobytes()
    h.decode_stream(1, freq.ctypes.data, rows.ctypes.data, cs.ctypes.data,
                    x0.ctypes.data, data.ctypes.data, nb,
                    int.from_bytes(last.ljust(4, b"\0"), "little"), ulen,
                    out.ctypes.data, x_out.ctypes.data, pos.ctypes.data,
                    loops.ctypes.data)
    return out[:ulen].tobytes(), x_out


@pytest.mark.parametrize("wire", ["4x8", "nx16_4way"])
def test_dense_round_on_cpu(tmp_path, wire):
    """rans8_round with the dense lookup, on the 4x8 and the 4-way Nx16
    refill, against the raw bytes and the plain version's states."""
    h = _compile(tmp_path, CSRC, wire == "nx16_4way")
    frame = t8.frame_4x8 if wire == "4x8" else t8.frame_nx16_4way
    for name in ("rand_20003", "walk"):
        b = frame([ENCS[wire, name]], True, "cpu", True)
        got, x = _run_dense(h, b)
        assert got == RAWS[name]
        want = t8.rans4x8_plain(b)[1].numpy()[0].view(np.uint32)
        assert np.array_equal(x, want)


def test_mutated_dense_lookup_fails(tmp_path):
    """A copy whose dense record drops the cum's top bit must fail."""
    mut = tmp_path / "csrc"
    mut.mkdir()
    for f in os.listdir(CSRC):
        if f.endswith(".cuh"):
            shutil.copy(os.path.join(CSRC, f), mut / f)
    src = (mut / "rans_nx16_o1_step.cuh").read_text()
    old = "((d >> 20) << 12)"
    assert src.count(old) == 1
    (mut / "rans_nx16_o1_step.cuh").write_text(
        src.replace(old, "(((d >> 20) & 0x7FFu) << 12)"))
    h = _compile(tmp_path, mut, False)
    b = t8.frame_4x8([ENCS["4x8", "rand_20000"]], True, "cpu", True)
    assert _run_dense(h, b)[0] != RAWS["rand_20000"]


# ---------------------------------------------------------------------------
# ROADMAP queue C's unnormalised order-0 table: the references disagree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nway", [32, 4])
def test_unnormalised_table_references_disagree(nway):
    """On a slot past a table's sum the JAX function reads packed entry
    0 (symbol 0, f = 1, cum 0: x = (x >> 12) + slot) and the host codec
    symbol 0 with its own f[0] = 0 and cum[0] = 0 (x = slot, then a
    refill): both emit symbol 0 there, and their states part.  The port's
    `uncompress_nx16_batch` follows its JAX twin on both widths: its slot
    tables (rans_o0_build_fslots for B2, rans_o0_build_slots for X2, and
    the plain versions') hold that entry past the sum.  ROADMAP queue C
    files the disagreement of the references under the reference-side
    conditions."""
    enc = unnormalised_stream(nway)
    jaxd = jrans.uncompress_nx16_batch([enc])[0]
    host = host16.uncompress(enc)
    assert host == r16.uncompress(enc)       # the port's copy agrees
    assert len(jaxd) == len(host) == 12 * nway
    assert jaxd != host
    port = trans.uncompress_nx16_batch([enc], device="cpu")[0]
    assert port == jaxd


def test_unnormalised_table_lane_functions_refuse():
    """The lane functions keep their JAX twins' refusal: the JAX
    `qualstats_device` and Pallas `decode_nx16_o0_batch` front ends
    raise on a 32-way table that sums below 4096, and so do the port's."""
    from htslib_tpu.ops import device_stats as jds
    from htslib_tpu.ops import rans_pallas as jrp
    from htslib_tpu_torch.ops import device_stats as tds
    from htslib_tpu_torch.ops import rans_nx16 as tr
    enc = unnormalised_stream(32)
    for run in (lambda: jds.qualstats_device([enc], interpret=True),
                lambda: jrp.decode_nx16_o0_batch([enc], interpret=True),
                lambda: tds.qualstats_device([enc], device="cpu"),
                lambda: tr.decode_nx16_o0_batch([enc], device="cpu")):
        with pytest.raises(ValueError, match="unnormalised frequency table"):
            run()


# ---------------------------------------------------------------------------
# The large order-1 table (csrc/rans_nx16_o1_step.cuh rans_o1_large_*,
# csrc/rans4x8_step.cuh rans8_round_large): X1, X3 and B5 on tables past
# A2_MAX rows in shared memory, built and read on the CPU with g++
# ---------------------------------------------------------------------------

_LARGE_HARNESS = r"""
#include <cstring>
#include <vector>

#include "rans4x8_step.cuh"

// the refill of the 4-way wire decode4 reads: 4x8 unless built with
// -DRANS_W16=true (the 4-way Nx16 wire)
#ifndef RANS_W16
#define RANS_W16 false
#endif

static uint8_t planes[8 * RANS_O1_LARGE_MAX_ROWS];  // past any layout
static uint8_t present[256], index_of[256], ctx_of[256];
static RansO1Large view;
static int n_ctx = 256;

// One stream's large table as a warp of 32 lanes builds it, lanes in turn
// over planes holding garbage: the row planes, marking the rows' symbols;
// with `alphabet` (B5) the dense alphabet; then the context words and
// buckets of 1 << shift slots.  Returns the table's bytes.
extern "C" int build(const uint32_t* rows, const int32_t* cs, int alphabet,
                     int shift) {
  const int n = cs[256];
  std::memset(present, 0, sizeof present);
  std::memset(planes, 0xA5, sizeof planes);
  RansO1LargeOut o =
      rans_o1_large_planes(planes, rans_o1_large_layout(n, 0, shift), shift);
  for (int lane = 0; lane < 32; ++lane)
    rans_o1_large_rows(rows, n, o, lane, 32, present);
  n_ctx = 256;
  if (alphabet) {
    for (int c = 0; c < 256; ++c)
      if (c == 0 || cs[c] < cs[c + 1]) present[c] = 1;
    for (int lane = 0; lane < 32; ++lane)
      n_ctx = rans_o1_index(present, index_of, ctx_of, lane, 32);
  }
  const RansO1LargeLayout l = rans_o1_large_layout(n, n_ctx, shift);
  o = rans_o1_large_planes(planes, l, shift);
  for (int lane = 0; lane < 32; ++lane)
    rans_o1_large_contexts(rows, cs, o, lane, 32, n_ctx,
                           alphabet ? ctx_of : nullptr,
                           alphabet ? index_of : nullptr);
  view = rans_o1_large_view(o);
  return l.end;
}

static bool differ(const RansO1Hit& a, const RansO1Hit& b) {
  return a.f != b.f || a.cum != b.cum || a.sym != b.sym;
}

// Lookups over every slot of every context of the table (its dense
// alphabet with `alphabet`, else all 256) where the pick (B5's of five
// rows with `alphabet`, else the 4x8 round's of three; walked where it is
// slow) or the walk alone differs from the JAX dense table's entry: the
// row whose [cum, cum + f) holds the slot, else entry 0 (f = 1, cum 0,
// symbol 0).  *slow gets the picks that needed the walk.
extern "C" int64_t lookup_mismatches(const uint32_t* rows, const int32_t* cs,
                                     int alphabet, int shift, int64_t* slow) {
  build(rows, cs, alphabet, shift);
  int64_t bad = 0;
  *slow = 0;
  std::vector<RansO1Hit> want(RANS_TOTFREQ);
  for (int k = 0; k < n_ctx; ++k) {
    const int c = alphabet ? ctx_of[k] : k;
    for (auto& w : want) w = {1u, 0u, 0u};
    for (int r = cs[c]; r < cs[c + 1]; ++r) {
      const uint32_t cum = rans_row_cum(rows[r]), f = (rows[r] & 0xFFFu) + 1u;
      const uint32_t sym = alphabet ? index_of[rows[r] >> 24] : rows[r] >> 24;
      for (uint32_t m = cum; m < cum + f && m < RANS_TOTFREQ; ++m)
        want[m] = {f, cum, sym};
    }
    for (uint32_t m = 0; m < RANS_TOTFREQ; ++m) {
      // a state's high bits, which the lookup must not read
      const uint32_t x = m | (0x5A5u + (uint32_t)k) << 12;
      bool s;
      RansO1Hit got =
          alphabet ? rans_o1_large_pick<5>(view, (uint32_t)k << 7, x, &s)
                   : rans_o1_large_pick<3>(view, (uint32_t)k << 7, x, &s);
      if (s) {
        ++*slow;
        got = rans_o1_large_walk(view, (uint32_t)k << 7, x);
      }
      bad += differ(got, want[m]);
      bad += differ(rans_o1_large_walk(view, (uint32_t)k << 7, x), want[m]);
    }
  }
  return bad;
}

// One 4-way stream (4x8, or with RANS_W16 the 4-way Nx16 wire) through
// rans8_round_large over the whole payload staged as the kernels stage it
// (rans8_stage_word); `tail` is the payload's last word as it lies in
// memory.  Returns the wire's cursor; *slow gets the rounds in which some
// live state's pick was slow.
extern "C" int64_t decode4(const uint32_t* rows, const int32_t* cs,
                           const uint32_t* x0, const uint8_t* bytes,
                           int64_t n_bytes, uint32_t tail, int64_t ulen,
                           uint8_t* out, uint32_t* x_out, int64_t* slow,
                           int shift) {
  build(rows, cs, 0, shift);
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
  *slow = 0;
  for (int64_t r = 0; r < rans8_rounds(true, ulen); ++r) {
    unsigned live = 0;
    int64_t at[RANS8_NWAY];
    bool any = false;
    for (int j = 0; j < RANS8_NWAY; ++j)
      if (rans8_live(true, ulen, j, r, &at[j])) {
        live |= 1u << j;
        bool s;
        rans_o1_large_pick<3>(view, ctx7[j], x[j], &s);
        any |= s;
      }
    *slow += any;
    uint32_t hi, lo;
    rans8_window(w.w0, w.w1, w.w2, w.pos, &hi, &lo);
    const uint32_t k =
        rans8_round_large<RANS_W16>(x, ctx7, &syms, live, hi, lo, view);
    for (int j = 0; j < RANS8_NWAY; ++j)
      if ((live >> j) & 1u) out[at[j]] = (uint8_t)(syms >> (8 * j));
    rans8_advance(&w, k, words.data(), 0xFFFFFFFFu);
    rans8_cap(&w, cap, words.data(), 0xFFFFFFFFu);
  }
  for (int j = 0; j < RANS8_NWAY; ++j) x_out[j] = x[j];
  return w.pos < nb ? w.pos : nb;
}

// One 32-way Nx16 order-1 stream as B5's large variant reads it: state j
// on lane j, the table over the stream's alphabet, the symbols mapped back
// through ctx_of, the refills in state order.  Returns the word cursor.
extern "C" int64_t decode32(const uint32_t* rows, const int32_t* cs,
                            const uint32_t* x0, const uint16_t* words,
                            int64_t nw, int64_t n, uint8_t* out,
                            uint32_t* x_out, int shift) {
  build(rows, cs, 1, shift);
  uint32_t x[RANS_NWAY], ctx7[RANS_NWAY];
  for (int j = 0; j < RANS_NWAY; ++j) {
    x[j] = x0[j];
    ctx7[j] = 0;
  }
  const int64_t seg = n / RANS_NWAY;
  int64_t cur = 0;
  for (int64_t r = 0; r < rans_o1_state_len(n, RANS_NWAY - 1, RANS_NWAY);
       ++r) {
    for (int j = 0; j < RANS_NWAY; ++j) {
      if (r >= rans_o1_state_len(n, j, RANS_NWAY)) continue;
      bool s;
      RansO1Hit h = rans_o1_large_pick<5>(view, ctx7[j], x[j], &s);
      if (s) h = rans_o1_large_walk(view, ctx7[j], x[j]);
      out[j * seg + r] = ctx_of[h.sym];
      x[j] = h.f * (x[j] >> RANS_TF_SHIFT) + (x[j] & (RANS_TOTFREQ - 1)) -
             h.cum;
      ctx7[j] = h.sym << 7;
      if (rans_needs_refill(x[j])) {
        x[j] = rans_refill(x[j], rans_word(words, cur, nw));
        cur = rans_advance(cur, 1, nw);
      }
    }
  }
  for (int j = 0; j < RANS_NWAY; ++j) x_out[j] = x[j];
  return cur;
}
"""


def _compile_large(d, csrc, w16):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the step harness needs a C++ compiler")
    src = d / "large.cpp"
    src.write_text(_LARGE_HARNESS)
    lib = d / f"liblarge{int(w16)}.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-shared", "-fPIC", "-O2",
                    f"-DRANS_W16={'true' if w16 else 'false'}", "-I",
                    str(csrc), "-o", str(lib), str(src)], check=True)
    h = ctypes.CDLL(str(lib))
    h.build.restype = ctypes.c_int
    h.build.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
    h.lookup_mismatches.restype = ctypes.c_int64
    h.lookup_mismatches.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p]
    h.decode4.restype = ctypes.c_int64
    h.decode4.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int64, ctypes.c_uint32, ctypes.c_int64] \
        + [ctypes.c_void_p] * 3 + [ctypes.c_int]
    h.decode32.restype = ctypes.c_int64
    h.decode32.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2 \
        + [ctypes.c_void_p] * 2 + [ctypes.c_int]
    return h


@pytest.fixture(scope="module")
def large_libs(tmp_path_factory):
    """The harness built with the 4x8 refill and with the 4-way Nx16
    one."""
    d = tmp_path_factory.mktemp("large")
    return {w16: _compile_large(d, CSRC, w16) for w16 in (False, True)}


def _table_F(kind, seed=41):
    """Per-context frequencies [256, 256] of the large table's edge
    cases."""
    rng = np.random.default_rng(seed)
    F = np.zeros((256, 256), np.int64)
    if kind == "rows_4097":
        # 64 x 64 contexts and symbols, and one more row: a one-symbol
        # context of f = 4096; contexts 65-199 and 201-255 empty
        for c in range(64):
            F[c, :64] = 1 + rng.multinomial(4096 - 64, np.full(64, 1 / 64))
        F[200, 7] = 4096
    elif kind == "rows_65536":
        # every pair: f >= 1, varied, each context summing to 4096
        for c in range(256):
            F[c] = 1 + rng.multinomial(4096 - 256, np.full(256, 1 / 256))
    elif kind == "short_sums":
        # contexts summing below 4096 (slots past the sum: entry 0), runs
        # of f = 1 (buckets where the pick walks up to 31 rows), a
        # one-symbol context below 4096, and empty ones
        for c in range(0, 256, 3):
            used = rng.choice(256, 60, replace=False)
            F[c, used] = rng.integers(1, 60, 60)
        F[1, :200] = 1
        F[2, 17] = 100
        F[4, 255] = 4096
        F[5, ::2] = 8
    else:  # one_symbol: sparse contexts, several of one symbol
        for c in range(0, 256, 2):
            F[c, rng.choice(256, 70, replace=False)] = 58
        for c in (1, 3, 255):
            F[c, c ^ 0x55] = 4096
    return F


@pytest.mark.parametrize("shift", [3, 4, 5])
@pytest.mark.parametrize("alphabet", [0, 1], ids=["values", "alphabet"])
@pytest.mark.parametrize("kind", ["rows_4097", "rows_65536", "short_sums",
                                  "one_symbol"])
def test_large_lookup_matches_jax_table(large_libs, kind, alphabet, shift):
    """Every slot of every context through the large table's pick and walk,
    built by 32 lanes in turn with contexts indexed by value (X1, X3) or
    over the stream's alphabet (B5), with buckets of 8, 16 and 32 slots,
    against the JAX dense table's entry; at 32 slots the table fits a
    block beside the kernels' fixed parts."""
    F = _table_F(kind)
    rows, cs = to1.o1_rows(F, to1.LARGE_MAX_ROWS)
    assert len(rows) > to1.A2_MAX
    if kind == "rows_4097":
        assert len(rows) == 4097
    if kind == "rows_65536":
        assert len(rows) == 65536
    h = large_libs[False]
    slow = np.zeros(1, np.int64)
    assert h.lookup_mismatches(rows.ctypes.data, cs.ctypes.data, alphabet,
                               shift, slow.ctypes.data) == 0
    if kind == "short_sums":
        assert slow[0] > 0
    size = h.build(rows.ctypes.data, cs.ctypes.data, alphabet, shift)
    if shift == 5:
        assert size + 1792 <= 232448


def _hifi(n=300_000):
    """A HiFi-style quality stream of about 8,400 rows (chip_smoke's model,
    its tail widened)."""
    from chip_smoke import hifi_qualities
    return hifi_qualities(n, floor=1.0, top=0.3)


def _rows_4097():
    """Random symbols 0-63 (every pair of them present) and a 64 last:
    4,097 rows."""
    rng = np.random.default_rng(42)
    return rng.integers(0, 64, 60000, dtype=np.uint8).tobytes() + b"\x40"


def _one_symbol():
    """Random symbols 0-99, each 50 followed by a 51: a one-symbol context
    of f = 4096, contexts 100-255 empty."""
    d = np.random.default_rng(43).integers(0, 100, 60000, dtype=np.uint8)
    d[1:][d[:-1] == 50] = 51
    return d.tobytes()


LARGE_STREAMS = {
    "rows_4097": _rows_4097,
    "hifi": _hifi,
    "random_1m": lambda: np.random.default_rng(44).integers(
        0, 256, 1 << 20, dtype=np.uint8).tobytes(),
    "one_symbol": _one_symbol,
}


@pytest.fixture(scope="module")
def large_encs():
    """name -> (raw, {wire: encoded}), made on first use (1 MiB encodes
    take seconds)."""
    cache = {}

    def get(name):
        if name not in cache:
            raw = LARGE_STREAMS[name]()
            cache[name] = (raw, {w: enc(raw) for w, enc in WIRES.items()})
        return cache[name]
    return get


def _large_batch(wire, enc):
    if wire == "4x8":
        return t8.frame_4x8([enc], True, "cpu", large=True)
    if wire == "nx16_4way":
        return t8.frame_nx16_4way([enc], True, "cpu", large=True)
    return to1.frame_o1_streams([to1._parse_nx16_header(enc)], "cpu",
                                large=True)


def _run_large(h, b, wire, shift=5):
    """Stream 0 of large batch b through the harness, buckets of 1 << shift
    slots: (symbols, final states, cursor)."""
    rows = np.ascontiguousarray(b.tables.rows.numpy().view(np.uint32))
    cs = np.ascontiguousarray(b.tables.ctx_start.numpy()[0])
    ulen = int(b.ulen[0])
    out = np.zeros(max(ulen, 1), np.uint8)
    x0 = np.ascontiguousarray(b.x0.numpy()[0].view(np.uint32))
    data = b.payload.numpy()
    if wire == "nx16_32way":
        x_out = np.zeros(32, np.uint32)
        words = np.ascontiguousarray(data.view(np.uint16))
        cur = h.decode32(rows.ctypes.data, cs.ctypes.data, x0.ctypes.data,
                         words.ctypes.data, int(b.n_words[0]), ulen,
                         out.ctypes.data, x_out.ctypes.data, shift)
        return out[:ulen].tobytes(), x_out, cur
    x_out = np.zeros(4, np.uint32)
    nb = int(b.n_bytes[0])
    last = data[4 * ((nb - 1) // 4):][:4].tobytes().ljust(4, b"\0")
    slow = np.zeros(1, np.int64)
    cur = h.decode4(rows.ctypes.data, cs.ctypes.data, x0.ctypes.data,
                    data.ctypes.data, nb, int.from_bytes(last, "little"),
                    ulen, out.ctypes.data, x_out.ctypes.data,
                    slow.ctypes.data, shift)
    return out[:ulen].tobytes(), x_out, cur


@pytest.mark.parametrize("wire", list(WIRES))
@pytest.mark.parametrize("name,shift", [
    (n, k) for n in LARGE_STREAMS for k in (3, 5)
    # 65,536 rows fit a block only with 32-slot buckets
    if (n, k) != ("random_1m", 3)])
def test_large_decode_matches_host_codec(large_libs, large_encs, wire, name,
                                         shift):
    """Whole streams past A2_MAX rows (4,097; a HiFi-style alphabet of
    about 8,400; uniform random bytes of 1 MiB, all 65,536; a one-symbol
    context and empty ones) through the large table's rounds on each
    order-1 wire (rans8_round_large on the 4x8 and the 4-way Nx16 refill,
    and B5's lane order over the dense alphabet), with buckets of 8 (where
    a block could hold them) and 32 slots, against the raw bytes and the
    port's host codec."""
    raw, encs = large_encs(name)
    enc = encs[wire]
    rows = _rows(wire, enc)
    assert rows > to1.A2_MAX
    if name == "rows_4097":
        assert rows == 4097
    if name == "random_1m":
        assert rows == 65536
    b = _large_batch(wire, enc)
    assert b.large and b.tables is not None and b.dense is None
    got, _, cur = _run_large(large_libs[wire == "nx16_4way"], b, wire,
                             shift)
    host = r8.uncompress(enc) if wire == "4x8" else r16.uncompress(enc)
    assert got == raw == host
    assert cur <= (int(b.n_words[0]) if wire == "nx16_32way"
                   else int(b.n_bytes[0]))


@pytest.mark.parametrize("wire", list(WIRES))
def test_large_round_states_match_plain(large_libs, wire):
    """The large table's rounds leave the plain version's final states and
    cursor (the JAX dense table's gather over the same rows), on a stream
    of about 16,000 rows and (4x8) on a HiFi-style one whose contexts sum
    to 4076, every output also the raw bytes and the host codec's."""
    from chip_smoke import hifi_qualities
    raws = [RAWS["rand_20003"]]
    encs = [ENCS[wire, "rand_20003"]]
    if wire == "4x8":
        raws.append(hifi_qualities(40_000, floor=1.0, top=0.2))
        encs.append(short_table_compress(raws[-1], 1, short=20))
        F = t8._parse_4x8_o1(encs[-1])[1]
        sums = F.sum(axis=1)
        assert set(sums[sums > 0]) == {4076}
    h = large_libs[wire == "nx16_4way"]
    for raw, enc in zip(raws, encs):
        assert _rows(wire, enc) > to1.A2_MAX
        b = _large_batch(wire, enc)
        got, x, cur = _run_large(h, b, wire)
        plain = (to1.rans_o1_plain if wire == "nx16_32way"
                 else t8.rans4x8_plain)(b)
        host = r8.uncompress(enc) if wire == "4x8" else r16.uncompress(enc)
        assert got == plain[0].numpy().tobytes() == raw == host
        assert np.array_equal(x, plain[1].numpy()[0].view(np.uint32))
        assert cur == int(plain[2][0])


@pytest.mark.parametrize("mutation", ["next_context", "past_sum"])
def test_mutated_large_lookup_fails(tmp_path, large_encs, mutation):
    """Copies of the large lookup that must fail: one that takes the next
    context's first row (cum 0) for a row of the slot's own, one that
    drops the JAX entry 0 past a context's sum."""
    mut = tmp_path / "csrc"
    mut.mkdir()
    for f in os.listdir(CSRC):
        if f.endswith(".cuh"):
            shutil.copy(os.path.join(CSRC, f), mut / f)
    src = (mut / "rans_nx16_o1_step.cuh").read_text()
    old, new = {
        "next_context": ("return c - 1u < s;", "return c <= s;"),
        "past_sum": ("if (s >= end) h = {1u, 0u, 0u};", ""),
    }[mutation]
    assert src.count(old) == 1
    (mut / "rans_nx16_o1_step.cuh").write_text(src.replace(old, new))
    h = _compile_large(tmp_path, mut, False)
    rows, cs = to1.o1_rows(_table_F("short_sums"), to1.LARGE_MAX_ROWS)
    slow = np.zeros(1, np.int64)
    assert h.lookup_mismatches(rows.ctypes.data, cs.ctypes.data, 0, 5,
                               slow.ctypes.data) > 0
    if mutation == "next_context":
        raw, encs = large_encs("rows_4097")
        got = _run_large(h, _large_batch("4x8", encs["4x8"]), "4x8")[0]
        assert got != raw


@pytest.mark.parametrize("wire", list(WIRES))
def test_routing_by_waves(monkeypatch, wire):
    """Past A2_MAX, a group of at most LARGE_WAVES waves of the large
    variant takes the large route (`_large` group, a `large` batch, no
    dense table), a larger one the dense variant (`_dense`, dense tables);
    a wave here is made one stream, and the bytes are the same."""
    per_wave = {}
    mod = to1 if wire == "nx16_32way" else t8
    monkeypatch.setattr(mod, "large_per_wave",
                        lambda *a: per_wave.setdefault("n", 1))
    framed = []
    for fn_mod, fn in ((t8, "_batch"), (to1, "frame_o1_streams")):
        orig = getattr(fn_mod, fn)

        def spy(*a, _orig=orig, **k):
            b = _orig(*a, **k)
            framed.append(b)
            return b
        monkeypatch.setattr(fn_mod, fn, spy)
    if wire == "nx16_32way":
        monkeypatch.setattr(trans, "frame_o1_streams", to1.frame_o1_streams)
    names = ["rand_20000", "rand_20001", "rand_20002"]
    waves = mod.LARGE_WAVES
    for n, route in ((waves, "_large"), (waves + 1, "_dense")):
        encs = [ENCS[wire, names[i % 3]] for i in range(n)]
        timing = {}
        call = (trans.uncompress_batch if wire == "4x8"
                else trans.uncompress_nx16_batch)
        framed.clear()
        assert call(encs, device="cpu", timing=timing) == [
            RAWS[names[i % 3]] for i in range(n)]
        key = ("4x8" if wire == "4x8" else
               f"nx16_{4 if wire == 'nx16_4way' else 32}way") + "_o1"
        assert set(timing) == {key + route, "route_s"}
        assert timing[key + route]["streams"] == n
        b, = framed
        assert b.large == (route == "_large")
        assert (b.dense is None) == (route == "_large")


@pytest.mark.parametrize("wire", list(WIRES))
def test_hifi_stream_matches_jax(wire):
    """A small HiFi-style quality stream past A2_MAX rows (40,000 QVs, the
    tail widened) through the JAX function (XLA on the CPU) and the
    port's plain path: the same bytes."""
    from chip_smoke import hifi_qualities
    raw = hifi_qualities(40_000, floor=1.0, top=0.2)
    enc = WIRES[wire](raw)
    assert _rows(wire, enc) > to1.A2_MAX
    if wire == "4x8":
        port = trans.uncompress_batch([enc], device="cpu")
        jaxd = jrans.uncompress_batch([enc])
    else:
        port = trans.uncompress_nx16_batch([enc], device="cpu")
        jaxd = jrans.uncompress_nx16_batch([enc])
    assert port == jaxd == [raw]


# -- the order-1 quality lane against the JAX lane ------------------------
# (the whole of tests/test_torch_o1_stats.py, merged here: its
# interpret-mode JAX runs take minutes and share their compiled lanes,
# and pytest-xdist's loadfile scheduling starts a file of many tests
# first, where a file of two to five tests started last and ended the
# tier-1 run alone)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
O1_FIXTURE = os.path.join(REPO, "htslib_tpu_torch", "testdata",
                          "qual_o1.cram")


def _datas():
    rng = np.random.default_rng(41)
    return [_walk(rng, 30000), _walk(rng, 1007), _walk(rng, 13),
            bytes([30]) * 999, _walk(rng, 64),
            rng.integers(20, 41, 3001, dtype=np.uint8).tobytes()]


DATAS = _datas()
# with these, more than 32 streams: the JAX lane takes two groups
FILLERS = [_walk(np.random.default_rng(42), 40 + 37 * i) for i in range(27)]


@pytest.mark.parametrize("qbins", [64, 256])
def test_qualstats_device_o1_matches_jax(qbins):
    datas = DATAS + (FILLERS if qbins == 64 else [])
    encs = [compress(d, 0x05) for d in datas]
    got, timing = tds.qualstats_device_o1(encs, device="cpu", qbins=qbins)
    ref, _ = jds.qualstats_device_o1(encs, interpret=True, qbins=qbins)
    truth = np.stack([np.bincount(np.minimum(np.frombuffer(d, np.uint8),
                                             qbins - 1), minlength=qbins)
                      for d in datas])
    assert got.dtype == np.int64 and got.shape == (len(datas), qbins)
    assert np.array_equal(got, truth)
    assert np.array_equal(got, ref)
    assert timing["uncompressed_bytes"] == sum(len(d) for d in datas)


def test_qualstats_device_o1_rejects_other_wires():
    for flags in (0x04, 0x01):
        enc = compress(DATAS[1], flags)
        with pytest.raises(ValueError) as port_err:
            tds.qualstats_device_o1([enc], device="cpu")
        with pytest.raises(ValueError) as jax_err:
            jds.qualstats_device_o1([enc], interpret=True)
        assert str(port_err.value) == str(jax_err.value)


def test_committed_o1_fixture(tmp_path):
    check_committed_fixture(tmp_path, O1_FIXTURE, write_o1_cram,
                            ["nx16_o1", None])


# -- the order-1 lane's timing keys ---------------------------------------
# (the whole of tests/test_torch_timing_contract_o1.py, merged here: it
# compiles the same JAX lane as the cases above)

@pytest.mark.parametrize("reps", [1, 2])
def test_o1_timing_keys_match_jax(reps):
    encs = [compress(d, 0x05) for d in quality_streams()]
    check_timing_contract(tds.qualstats_device_o1(encs, device="cpu",
                                                  reps=reps),
                          jds.qualstats_device_o1(encs, interpret=True,
                                                  reps=reps))
