"""The port's whole-stream rANS batch decode (htslib_tpu_torch/ops/rans.py:
uncompress_batch, uncompress_nx16_batch, with device="cpu": the plain
versions of kernels B7, X1, B2, B5, X2 and X3) against the JAX package's
functions of the same names (htslib_tpu/ops/rans.py, XLA on the CPU) and
the port's host codecs; and the 4-way Nx16 refill of the kernels' round
(csrc/rans4x8_step.cuh, rans8_round with the Nx16 refill) compiled for the
CPU and driven against codecs/rans4x16.py.  Bytes and states: equality is
exact."""
import ctypes
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from htslib_tpu.codecs import rans4x8 as ref8
from htslib_tpu.ops import device_stats as jds
from htslib_tpu.ops import rans as jrans
from htslib_tpu.ops import rans4x8_pallas as j48
from htslib_tpu_torch import carry
from htslib_tpu_torch.codecs import rans4x8 as r8
from htslib_tpu_torch.codecs import rans4x16 as r16
from htslib_tpu_torch.ops import device_stats as tds
from htslib_tpu_torch.ops import rans as trans
from htslib_tpu_torch.ops import rans4x8 as t8
from chip_smoke import wide_stream
from test_torch_device_stats import check_committed_fixture, write_v30_cram
from test_torch_device_stats import read_walks as _walk
from test_torch_gpu import short_table_compress
from test_torch_rans4x8 import CSRC, _HARNESS, _run_step


@pytest.fixture(autouse=True, scope="module")
def _jax_32bit():
    """The JAX reference runs in its default 32-bit mode; another test
    module in the same worker process may have switched JAX to 64-bit."""
    jax.config.update("jax_enable_x64", False)


def _cases_4x8():
    """name -> (raw, encoded): both orders at n % 4 in 0..3, n of 1, 2
    and 3, a constant run and the wide-alphabet order-1 stream."""
    rng = np.random.default_rng(41)
    out = {}
    for order in (0, 1):
        for n in (1000, 1001, 1002, 1003, 1, 2, 3):
            out[f"o{order}_n{n}"] = (_walk(rng, n), order)
        out[f"o{order}_const"] = (bytes([17]) * 777, order)
    out["o1_wide"] = (wide_stream(rng, 4000), 1)
    return {k: (d, r8.compress(d, o)) for k, (d, o) in out.items()}


def _cases_nx16():
    """name -> (raw, encoded): every plain flag (0x00, 0x01, 0x04, 0x05)
    at lengths about its interleave, n of 1, 2 and 3, zero-length
    streams, and the wide-alphabet stream on both order-1 widths."""
    rng = np.random.default_rng(42)
    out = {}
    for flags in (0x00, 0x01, 0x04, 0x05):
        for n in (1, 2, 3, 97, 1001, 1664, 2050):
            out[f"f{flags}_n{n}"] = (_walk(rng, n), flags)
    out["f0_n0"] = (b"", 0x00)
    out["f5_n0"] = (b"", 0x05)
    out["f1_wide"] = (wide_stream(rng, 3000), 0x01)
    out["f5_wide"] = (wide_stream(rng, 3000), 0x05)
    return {k: (d, r16.compress(d, f)) for k, (d, f) in out.items()}


CASES_4X8 = _cases_4x8()
CASES_NX16 = _cases_nx16()


@pytest.fixture(scope="module")
def decoded():
    """Each wire's cases in one mixed batch through the port (CPU) and
    through the JAX function: {name: (port bytes, JAX bytes)}."""
    out = {}
    for cases, port, jfn in (
            (CASES_4X8, trans.uncompress_batch, jrans.uncompress_batch),
            (CASES_NX16, trans.uncompress_nx16_batch,
             jrans.uncompress_nx16_batch)):
        encs = [e for _, e in cases.values()]
        out.update(zip(cases, zip(port(encs, device="cpu"), jfn(encs))))
    return out


@pytest.mark.parametrize("name", list(CASES_4X8))
def test_4x8_batch_matches_jax_and_host(decoded, name):
    raw, enc = CASES_4X8[name]
    port, jaxd = decoded[name]
    assert port == jaxd == raw == r8.uncompress(enc)


@pytest.mark.parametrize("name", list(CASES_NX16))
def test_nx16_batch_matches_jax_and_host(decoded, name):
    raw, enc = CASES_NX16[name]
    port, jaxd = decoded[name]
    assert port == jaxd == raw == r16.uncompress(enc)


def test_wide_streams_meet_slow_buckets():
    """The wide-alphabet order-1 streams' tables have 64-slot buckets with
    two or more row starts after their first slot (the lookup's walk)."""
    from chip_smoke import fallback_buckets
    b = t8.frame_4x8([CASES_4X8["o1_wide"][1]], True, "cpu")
    assert fallback_buckets(b.tables) > 0
    b = t8.frame_nx16_4way([CASES_NX16["f1_wide"][1]], True, "cpu")
    assert fallback_buckets(b.tables) > 0


@pytest.mark.parametrize("flag", [0x08, 0x10, 0x20, 0x40, 0x80])
def test_transform_flags_raise_as_jax(flag):
    enc = r16.compress(_walk(np.random.default_rng(flag), 300), 0x04)
    bad = bytes([enc[0] | flag]) + enc[1:]
    blocks = [r16.compress(b"abc", 0x01), bad]
    with pytest.raises(ValueError) as port_err:
        trans.uncompress_nx16_batch(blocks, device="cpu")
    with pytest.raises(ValueError) as jax_err:
        jrans.uncompress_nx16_batch(blocks)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("order", [0, 1])
def test_4x8_frequencies_past_4096_raise_as_jax(order):
    enc = short_table_compress(_walk(np.random.default_rng(3), 500), order,
                               short=-96)
    with pytest.raises(ValueError):
        trans.uncompress_batch([enc], device="cpu")
    with pytest.raises(ValueError):
        jrans.uncompress_batch([enc])


@pytest.mark.parametrize("flags", [0x00, 0x04])
def test_nx16_frequencies_past_4096_raise_as_jax(flags):
    """An order-0 table summing past 4096: JAX's table pack refuses it
    (ValueError), and so do the port's framings."""
    norm = r16._norm_freqs

    def over(counts, total=r16.TOTFREQ):
        f = norm(counts, total)
        f[int(np.argmax(f))] += 64
        return f

    r16._norm_freqs = over
    try:
        enc = r16.compress(_walk(np.random.default_rng(4), 400), flags)
    finally:
        r16._norm_freqs = norm
    with pytest.raises(ValueError):
        trans.uncompress_nx16_batch([enc], device="cpu")
    with pytest.raises(ValueError):
        jrans.uncompress_nx16_batch([enc])


def test_empty_4x8_stream_raises_as_jax():
    """A zero-length 4x8 stream: the encoder writes a one-byte empty table
    that the JAX function's parse, the port's and the pure-Python host
    codec's all read past, and all three raise ValueError."""
    enc = r8.compress(b"", 0)
    with pytest.raises(ValueError):
        trans.uncompress_batch([r8.compress(b"abc", 1), enc], device="cpu")
    with pytest.raises(ValueError):
        r8.uncompress(enc)
    with pytest.raises(ValueError):
        jrans.uncompress_batch([enc])


def test_unknown_4x8_order_gives_empty_as_jax():
    enc = bytearray(r8.compress(b"hello", 0))
    enc[0] = 2
    assert trans.uncompress_batch([bytes(enc)], device="cpu") == [b""] \
        == jrans.uncompress_batch([bytes(enc)])


def test_empty_batches():
    assert trans.uncompress_batch([], device="cpu") == []
    assert trans.uncompress_nx16_batch([], device="cpu") == []


def test_4way_framing_takes_only_its_wire():
    enc = r16.compress(b"abcd" * 10, 0x04)
    with pytest.raises(ValueError, match="plain 4-way O0 only"):
        t8.frame_nx16_4way([enc], False, "cpu")
    with pytest.raises(ValueError, match="plain 4-way O1 only"):
        t8.frame_nx16_4way([r16.compress(b"abcd" * 10, 0x00)], True, "cpu")


def test_batch_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trans.uncompress_batch([r8.compress(b"abc", 0)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trans.uncompress_nx16_batch([r16.compress(b"abc", 0)])


def _compile(tmp_path, csrc):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the step harness needs a C++ compiler")
    src = tmp_path / "harness.cpp"
    src.write_text(_HARNESS)
    lib = tmp_path / "libstep16.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-shared", "-fPIC", "-O2",
                    "-DRANS_W16=true", "-I", str(csrc), "-o", str(lib),
                    str(src)], check=True)
    h = ctypes.CDLL(str(lib))
    h.decode_stream.restype = ctypes.c_int64
    h.decode_stream.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 \
        + [ctypes.c_int64, ctypes.c_uint32, ctypes.c_int64] \
        + [ctypes.c_void_p] * 4
    h.set_wide.restype = None
    h.set_wide.argtypes = [ctypes.c_int]
    return h


@pytest.fixture(scope="module")
def step16(tmp_path_factory):
    return _compile(tmp_path_factory.mktemp("step16"), CSRC)


STEP_NAMES = ["f0_n1001", "f0_n2050", "f0_n3", "f1_n1001", "f1_n2050",
              "f1_n3", "f1_wide"]


@pytest.mark.parametrize("name", STEP_NAMES)
def test_nx16_refill_step_on_cpu(step16, name):
    """The kernels' round with the Nx16 refill, compiled for the host with
    their word window, decodes the 4-way wire byte for byte and leaves
    the plain version's final states and cursor."""
    raw, enc = CASES_NX16[name]
    b = t8.frame_nx16_4way([enc], bool(enc[0] & 1), "cpu")
    out, x_out, cur, _pos, loops = _run_step(step16, b)
    assert out == raw == r16.uncompress(enc)
    _, px, pcur, _ = t8.rans4x8(b)
    assert np.array_equal(x_out, px.numpy()[0].view(np.uint32))
    assert cur == int(pcur[0]) == int(b.n_bytes[0])
    if name == "f1_wide":
        assert loops > 0


@pytest.mark.parametrize("name", [n for n in STEP_NAMES
                                  if n.startswith("f1")])
def test_nx16_wide_step_on_cpu(step16, name):
    """X3's round through the wide order-1 table (csrc/rans4x8_step.cuh
    `rans8_round_wide` with the Nx16 refill), compiled for the host,
    decodes the 4-way order-1 wire byte for byte and leaves the plain
    version's final states and cursor."""
    raw, enc = CASES_NX16[name]
    b = t8.frame_nx16_4way([enc], True, "cpu")
    step16.set_wide(1)
    try:
        out, x_out, cur, _pos, loops = _run_step(step16, b)
    finally:
        step16.set_wide(0)
    assert out == raw == r16.uncompress(enc)
    _, px, pcur, _ = t8.rans4x8(b)
    assert np.array_equal(x_out, px.numpy()[0].view(np.uint32))
    assert cur == int(pcur[0]) == int(b.n_bytes[0])
    if name == "f1_wide":
        assert loops > 0


def test_unswapped_refill_word_fails(tmp_path):
    """A copy of the step headers whose refill word keeps the window's
    big-endian byte order decodes the 4-way wire wrongly: the harness
    sees the swap."""
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    hdr = csrc / "rans4x8_step.cuh"
    text = hdr.read_text()
    swap = ("  return ((v << 8) & 0xFF000000u) | ((v >> 8) & 0x00FF0000u) |\n"
            "         (v & 0xFFFFu);")
    assert swap in text
    hdr.write_text(text.replace(swap, "  return v;"))
    h = _compile(tmp_path, csrc)
    raw, enc = CASES_NX16["f0_n2050"]
    out = _run_step(h, t8.frame_nx16_4way([enc], False, "cpu"))[0]
    assert out != raw


# -- the rANS 4x8 quality lane against the JAX lane -----------------------
# (the whole of tests/test_torch_rans4x8_stats.py, merged here: its
# interpret-mode JAX runs take minutes and share their compiled lanes,
# and pytest-xdist's loadfile scheduling starts a file of many tests
# first, where a file of two to five tests started last and ended the
# tier-1 run alone)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V30_FIXTURE = os.path.join(REPO, "htslib_tpu_torch", "testdata",
                           "qual_v30.cram")


def _cases(order):
    """Streams with odd tails, at least two 1024-round segments, and (order
    0) a frequency table summing below 4096; alphabets as in the
    fixture's blocks."""
    rng = np.random.default_rng(43 + order)
    if order == 0:
        u = [rng.integers(20, 41, n, dtype=np.uint8).tobytes()
             for n in (9001, 4099, 1006, 3, 3003)]
        encs = [ref8.compress(d, 0) for d in u[:4]]
        encs.append(short_table_compress(u[4]))
        return u, encs
    w = [_walk(rng, n) for n in (9001, 4099, 1006, 7)]
    return w, [ref8.compress(d, 1) for d in w]


@pytest.mark.parametrize("order", [0, 1])
def test_qualstats_device_4x8_matches_jax(order):
    datas, encs = _cases(order)
    assert max(len(d) for d in datas) > 2 * 4 * j48.SEG4
    got, timing = tds.qualstats_device_4x8(encs, device="cpu",
                                           o1=bool(order))
    ref, _ = jds.qualstats_device_4x8(encs, interpret=True, o1=bool(order))
    assert got.dtype == np.int64 and got.shape == (len(datas), tds.QBINS)
    assert np.array_equal(got, tds.qualstats_host(datas))
    assert np.array_equal(got, ref)
    assert timing["uncompressed_bytes"] == sum(len(d) for d in datas)


def test_qualstats_device_4x8_rejects_the_other_order():
    datas, _ = _cases(1)
    for o1, order in ((False, 1), (True, 0)):
        enc = ref8.compress(datas[2], order)
        with pytest.raises(ValueError) as port_err:
            tds.qualstats_device_4x8([enc], device="cpu", o1=o1)
        with pytest.raises(ValueError) as jax_err:
            jds.qualstats_device_4x8([enc], interpret=True, o1=o1)
        assert str(port_err.value) == str(jax_err.value)


def _jax_o1_group(blocks):
    """The order-1 arrays `jds.qualstats_device_4x8(o1=True)` builds for
    one group (device_stats.py:314-405), and its compiled run."""
    parsed = [jds._parse_4x8_o1(d) for d in blocks]
    a2_pad = a_pad = 8
    for _n, F, _s, _p in parsed:
        A = len(np.union1d(np.nonzero(F.sum(axis=1))[0],
                           np.nonzero(F.sum(axis=0))[0]))
        while a_pad < A:
            a_pad <<= 1
        while a2_pad < int((F > 0).sum()):
            a2_pad <<= 1
    B, L = j48.BLOCKS4, j48.BLOCKS4 * j48.NWAY4
    lo = np.zeros((a2_pad, B), np.int32)
    dfc = np.zeros((a2_pad, B), np.int32)
    ad = np.zeros((a_pad, B), np.int32)
    states = np.zeros((B, 4), np.int64)
    out_szs = [0] * B
    payloads = []
    for gi in range(B):
        if gi < len(parsed):
            out_szs[gi], F, states[gi], poff = parsed[gi]
            lo[:, gi], dfc[:, gi], ad[:, gi], _dm, _al = \
                j48.build_o1_tables_4x8(F, a2_pad, a_pad)
            payloads.append(np.frombuffer(blocks[gi], np.uint8,
                                          len(blocks[gi]) - poff, poff))
        else:
            lo[0, gi], dfc[0, gi], lo[1:, gi] = 0, 4095, 1 << 30
            states[gi] = j48.RANS8_L
            payloads.append(np.zeros(0, np.uint8))
    x0 = np.broadcast_to(states.T.reshape(1, L), (8, L)) \
        .astype(np.uint32).view(np.int32).copy()
    W = max((len(p) + 3) // 4 for p in payloads) + 2 * j48._WINR4
    data_w = np.zeros((W, B), np.int32)
    for gi, p in enumerate(payloads):
        pad = np.zeros(((len(p) + 3) // 4) * 4, np.uint8)
        pad[:len(p)] = p
        data_w[:len(pad) // 4, gi] = pad.view("<u4").view(np.int32)
    tile = (1, j48.NWAY4)
    return (data_w, np.tile(lo, tile), np.tile(dfc, tile), np.tile(ad, tile),
            x0, out_szs, jds._stats_run4(a2_pad, a_pad, True, True,
                                         tds.QBINS))


def test_carry_o1_segment_state_equals_jax():
    """From the JAX order-1 front end's arrays, the port's states, byte
    cursors and contexts after SEG4 = 1024 rounds equal what one JAX
    segment leaves, and so do the counts of those rounds."""
    datas, encs = _cases(1)
    data_w, lo, dfc, ad, x0, out_szs, run = _jax_o1_group(encs)
    B, L = j48.BLOCKS4, j48.BLOCKS4 * j48.NWAY4
    S = j48.SEG4 * j48.NWAY4 * 2 // 4 + 2 * j48._WINR4
    H = ((data_w.shape[0] + S) // 16384 + 1) * 16384
    cnt = np.zeros(L, np.int32)
    for b in range(B):
        cnt[b::B] = out_szs[b] // j48.NWAY4
    hist, x, cur, ctx = run(
        jnp.pad(jnp.asarray(data_w), ((0, H - data_w.shape[0]), (0, 0))),
        lo, dfc, ad, x0, np.zeros((1, B), np.int32),
        np.zeros((8, L), np.int32), cnt, jnp.int32(1))
    want_x, want_cur, want_ctx = carry.from_jax_segment(x, cur, ctx, ad,
                                                        nway=4)

    b = carry.from_jax_group4(data_w, lo, dfc, x0, out_szs, ad=ad)
    assert b.o1 and b.ulen[:len(datas)].tolist() == [len(d) for d in datas]
    got_h, got_x, got_cur, got_ctx = t8.rans4x8(b, max_rounds=j48.SEG4,
                                                qbins=tds.QBINS)
    long = [i for i, d in enumerate(datas) if len(d) // 4 >= j48.SEG4]
    assert len(long) >= 2
    jh = np.asarray(hist)
    for i in long:
        assert np.array_equal(got_x[i].numpy().view(np.uint32), want_x[i])
        assert int(got_cur[i]) == want_cur[i]
        assert np.array_equal(got_ctx[i].numpy(), want_ctx[i])
        assert np.array_equal(got_h[i].numpy(), jh[:, i::B].sum(axis=1))


def test_committed_v30_fixture(tmp_path):
    check_committed_fixture(tmp_path, V30_FIXTURE, write_v30_cram,
                            ["4x8_o0", "4x8_o1", None])
