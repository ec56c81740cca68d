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
from htslib_tpu.ops import rans as jrans
from htslib_tpu_torch.codecs import rans4x8 as r8
from htslib_tpu_torch.codecs import rans4x16 as r16
from htslib_tpu_torch.ops import rans as trans
from htslib_tpu_torch.ops import rans4x8 as t8
from htslib_tpu_torch.ops import rans_nx16_o1 as to1
from test_torch_device_stats import read_walks as _walk
from test_torch_gpu import short_table_compress, unnormalised_stream
from test_torch_rans4x8 import CSRC, _HARNESS


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


def test_timing_names_each_launch_group():
    """The entry points' `timing` dicts: one entry a launch group, with
    its streams and parts, the dense table build inside the framing, and
    the routing parse; the bytes are those of a call without it."""
    encs = [ENCS["4x8", "rand_20000"], ENCS["4x8", "walk"]]
    timing = {}
    assert trans.uncompress_batch(encs, device="cpu", timing=timing) == [
        RAWS["rand_20000"], RAWS["walk"]]
    assert set(timing) == {"4x8_o1", "4x8_o1_dense", "route_s"}
    assert timing.pop("route_s") > 0
    dense = timing["4x8_o1_dense"]
    assert dense["streams"] == 1
    assert 0 < dense["dense_table_s"] <= dense["frame_s"]
    assert "dense_table_s" not in timing["4x8_o1"]
    encs = [ENCS[w, n] for w in ("nx16_4way", "nx16_32way")
            for n in ("rand_20001", "walk")]
    timing = {}
    assert trans.uncompress_nx16_batch(encs, device="cpu", timing=timing) \
        == [RAWS["rand_20001"], RAWS["walk"]] * 2
    assert set(timing) == {f"nx16_{w}way_o1{d}" for w in (4, 32)
                           for d in ("", "_dense")} | {"route_s"}
    assert timing.pop("route_s") > 0
    assert all(t["streams"] == 1 and t["frame_s"] > 0 and t["decode_s"] > 0
               for t in timing.values())


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
