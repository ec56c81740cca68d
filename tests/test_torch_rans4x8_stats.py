"""The port's rANS 4x8 quality lane (htslib_tpu_torch/ops/device_stats.py
`qualstats_device_4x8`, kernel B8's plain version on the CPU, order 0
and order 1) against the JAX package's in Pallas interpret mode and the
host histogram; the order-1 state carried across after one JAX segment
(htslib_tpu_torch/carry.py); and the committed CRAM 3.0 fixture through
`cram_qual_hist`.  Counts, states and contexts are integers: equality is
exact.  The cases share the fixture's JAX table shapes, so each order
compiles its JAX run once."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from htslib_tpu.codecs import rans4x8 as ref8
from htslib_tpu.ops import device_stats as jds
from htslib_tpu.ops import rans4x8_pallas as j48
from htslib_tpu_torch import carry
from htslib_tpu_torch.ops import device_stats as tds
from htslib_tpu_torch.ops import rans4x8 as t8
from test_torch_device_stats import check_committed_fixture, write_v30_cram
from test_torch_device_stats import read_walks as _walk
from test_torch_gpu import short_table_compress

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V30_FIXTURE = os.path.join(REPO, "htslib_tpu_torch", "testdata",
                           "qual_v30.cram")


@pytest.fixture(autouse=True, scope="module")
def _jax_32bit():
    """The JAX reference runs in its default 32-bit mode; another test
    module in the same worker process may have switched JAX to 64-bit."""
    jax.config.update("jax_enable_x64", False)


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
