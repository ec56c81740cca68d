"""The port's kernels on the card against their plain PyTorch versions
(and host truths), at small shapes.  Every test here needs a CUDA device:
it carries the `gpu` marker and skips without one.  This file imports
neither JAX nor the JAX package, so it runs on a machine with torch alone:

    python -m pytest -m gpu tests/test_torch_gpu.py -q
"""
import os

import numpy as np
import pytest
import torch

from chip_smoke import (bam_record_stream, deflate_raw, enc_edge_streams,
                        inflate_members, leg1_batch, ring_edge_members,
                        wide_stream)
from htslib_tpu_torch import _build
from chip_smoke import (baq_case, hmm_reads, scan_streams, seg_edge_streams,
                        varied_bam_stream)
from htslib_tpu_torch import realn as trl
from htslib_tpu_torch.codecs import rans4x8 as r8
from htslib_tpu_torch.codecs import rans4x16 as r16
from htslib_tpu_torch.codecs.rans4x16 import compress
from htslib_tpu_torch.entry import entry
from htslib_tpu_torch.ops import device_stats as tds
from htslib_tpu_torch.ops import bam2sam as tbs
from htslib_tpu_torch.ops import bgzf_device as tb
from htslib_tpu_torch.ops import huffman as th
from htslib_tpu_torch.ops import inflate as ti
from htslib_tpu_torch.ops import probaln as tpb
from htslib_tpu_torch.ops import rans as trans
from htslib_tpu_torch.ops import rans4x8 as t8
from htslib_tpu_torch.ops import rans_enc as te
from htslib_tpu_torch.ops import rans_nx16 as tr
from htslib_tpu_torch.ops import rans_nx16_o1 as o1
from htslib_tpu_torch.ops import seqfmt as tsf
from htslib_tpu_torch.ops.pileup_kernel import coverage_tile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "htslib_tpu_torch", "testdata", "qual_o0.cram")

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _streams(seed=2):
    rng = np.random.default_rng(seed)
    datas = [rng.integers(20, 41, 70000 + 13 * i, dtype=np.uint8).tobytes()
             for i in range(5)]
    datas += [rng.integers(0, 256, 3001, dtype=np.uint8).tobytes(),
              bytes([9]) * 999, rng.integers(0, 40, 13, dtype=np.uint8)
              .tobytes(), rng.integers(0, 4, 4096, dtype=np.uint8).tobytes()]
    return datas


@pytest.mark.parametrize("shape", [(1, 1), (3, 7), (1000, 64), (4097, 33)])
def test_nibble_kernel_matches_plain(card, shape):
    rng = np.random.default_rng(4)
    packed = torch.from_numpy(rng.integers(0, 256, shape,
                                           dtype=np.uint8)).to(card)
    assert torch.equal(tsf.nibble_to_base(packed),
                       tsf.nibble_to_base_plain(packed))


def test_nibble_kernel_unaligned_view(card):
    packed = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, 4099, dtype=np.uint8)).to(card)
    view = packed[3:].reshape(1, -1)
    assert torch.equal(tsf.nibble_to_base(view),
                       tsf.nibble_to_base_plain(view))


@pytest.mark.parametrize("qbins", [None, 64, 256])
def test_rans_kernels_match_plain(card, qbins):
    encs = [compress(d, 0x04) for d in _streams()]
    b = tr.frame_streams(encs, card)
    offs = torch.arange(b.n_streams, dtype=torch.int32, device=card)
    got = tr.rans_o0(b, offs=offs, qbins=qbins)
    want = tr.rans_o0_plain(b, offs=offs, qbins=qbins)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_rans_kernel_stops_after_max_rounds(card):
    encs = [compress(d, 0x04) for d in _streams()]
    b = tr.frame_streams(encs, card)
    got = tr.rans_o0(b, max_rounds=100)
    want = tr.rans_o0_plain(b, max_rounds=100)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


@pytest.mark.parametrize("field", ["n_words", "out_off", "freqs"])
def test_rans_kernel_rejects_inconsistent_batch(card, field):
    b = tr.frame_streams([compress(d, 0x04) for d in _streams()], card)
    getattr(b, field)[0] += 1 << 20
    with pytest.raises(ValueError, match="outside its buffers"):
        tr.rans_o0(b)


def _o0_edge_streams(rng):
    """Streams of every length edge of the order-0 kernels' loop: one
    symbol (twice: the test cuts the first to none), 31, 32, 33 (a lone
    tail round), 32 * k + 17 (blocks of 32 rounds, then 17 single rounds
    with the tail); a 64 KiB stream the payload ring wraps around many
    times."""
    lens = [1, 1, 31, 32, 33, 32 * 32 * 5 + 17, 32 * 7 + 17, 1 << 16]
    return [rng.integers(20, 41, n, dtype=np.uint8).tobytes() for n in lens]


@pytest.mark.parametrize("qbins", [None, 64, 256])
def test_o0_kernels_match_plain_edge_lengths(card, qbins):
    encs = [compress(d, 0x04) for d in _o0_edge_streams(
        np.random.default_rng(21))]
    b = tr.frame_streams(encs, card)
    b.ulen[0] = 0   # a stream of no symbol: states and cursor stay
    b.out_off = torch.cumsum(b.ulen.long(), 0) - b.ulen.long()
    offs = torch.arange(b.n_streams, dtype=torch.int32, device=card)
    got = tr.rans_o0(b, offs=offs, qbins=qbins)
    want = tr.rans_o0_plain(b, offs=offs, qbins=qbins)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("rounds", [45, 64, 65, 0])
def test_o0_kernels_stop_inside_and_on_block_edges(card, rounds):
    """A max_rounds stop inside a block of 32 rounds (45), on its edge
    (64), one past it (65) or before any round leaves the plain
    version's states, cursors and symbols (zero past the stop) in B2,
    and its states, cursors and counts in B3."""
    encs = [compress(d, 0x04) for d in _streams()]
    b = tr.frame_streams(encs, card)
    for qbins in (None, 64):
        got = tr.rans_o0(b, max_rounds=rounds, qbins=qbins)
        want = tr.rans_o0_plain(b, max_rounds=rounds, qbins=qbins)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("qbins,off", [(64, 0), (256, 0), (64, 9),
                                       (256, 40)])
def test_o0_hist_constant_runs(card, qbins, off):
    """Every lane in one bin for thousands of rounds (constant runs, a
    one-symbol stream, walks clipped at 0 and 44), with and without an
    offset: B3's counts equal the plain version's."""
    rng = np.random.default_rng(22)
    walk = np.clip(np.cumsum(rng.integers(-2, 3, 200000)) + 20, 0, 44)
    datas = [walk.astype(np.uint8).tobytes(), bytes([44]) * 70000,
             bytes(50000) + bytes([7]) * 30001]
    b = tr.frame_streams([compress(d, 0x04) for d in datas], card)
    offs = torch.full((b.n_streams,), off, dtype=torch.int32, device=card)
    got = tr.rans_o0(b, offs=offs, qbins=qbins)
    want = tr.rans_o0_plain(b, offs=offs, qbins=qbins)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("qbins", [None, 64])
def test_o0_kernels_match_plain_many_streams(card, qbins):
    """B2/B3 over a batch of twice the streams the card holds at once
    (blocks_per_sm): every SM full, then a second wave.  The copies are
    the base batch's streams, so the plain version runs on the base batch
    and is repeated."""
    from htslib_tpu_torch.bench_rans import replicate
    rng = np.random.default_rng(23)
    base = tr.frame_streams([compress(rng.integers(
        20, 41, 3000 + 7 * i, dtype=np.uint8).tobytes(), 0x04)
        for i in range(4)], card)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    k = -(-2 * sms * tr.blocks_per_sm(qbins) // 4)
    b = replicate(base, k)
    offs = torch.zeros(b.n_streams, dtype=torch.int32, device=card)
    got = tr.rans_o0(b, offs=offs, qbins=qbins)
    want = tr.rans_o0_plain(base, offs=offs[:4], qbins=qbins)
    assert torch.equal(got[0], want[0].repeat(k) if qbins is None
                       else want[0].repeat(k, 1))
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w.repeat(k, *([1] * (w.dim() - 1))))


def test_o0_streams_per_sm(card):
    """A leg-2 batch (64 bins) runs 8 or more B2 and B3 streams on an SM,
    so 1,056 streams fit the 132 SMs in one wave."""
    assert tr.blocks_per_sm(None) >= 8
    assert tr.blocks_per_sm(64) >= 8
    assert tr.blocks_per_sm(256) >= 1


def test_o0_kernels_clamp_a_frame_that_refills_every_round(card):
    """A frame whose states and words are all 0 refills every state in
    every round (32 words a round, faster than the ring is staged ahead)
    until the cursor clamps at the payload's end; the stream starts off a
    4-byte boundary."""
    n_words, ulen = 5001, 32 * 32 * 7 + 9
    f = np.random.default_rng(24).multinomial(
        4096 - 256, np.ones(256) / 256).astype(np.int32) + 1
    payload = torch.zeros(2 * n_words + 2, dtype=torch.uint8, device=card)
    b = tr.Nx16Batch(
        payload, torch.ones(1, dtype=torch.int64, device=card),
        torch.tensor([n_words], dtype=torch.int32, device=card),
        torch.from_numpy(f[None].copy()).to(card),
        torch.zeros((1, 32), dtype=torch.int32, device=card),
        torch.tensor([ulen], dtype=torch.int32, device=card),
        torch.zeros(1, dtype=torch.int64, device=card))
    for qbins in (None, 64):
        got = tr.rans_o0(b, qbins=qbins)
        want = tr.rans_o0_plain(b, qbins=qbins)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert int(got[2][0]) == n_words


def test_decode_and_hist_match_host_truth(card):
    datas = _streams()
    encs = [compress(d, 0x04) for d in datas]
    assert tr.decode_nx16_o0_batch(encs, device=card) == datas
    hist, _ = tds.qualstats_device(encs, device=card)
    assert np.array_equal(hist, tds.qualstats_host(datas))


def test_cram_qual_hist_on_card_matches_cpu(card):
    sc, sg = {}, {}
    assert np.array_equal(tds.cram_qual_hist(FIXTURE, device=card, stats=sg),
                          tds.cram_qual_hist(FIXTURE, device="cpu", stats=sc))
    assert sg == sc and sg["device_blocks"] > 0


def _walk(rng, n, read=100):
    """Quality-like bytes: bounded random walks over 2..41, one per
    read of `read` symbols."""
    k = -(-n // read)
    q = np.clip(rng.integers(25, 38, (k, 1))
                + np.cumsum(rng.integers(-2, 3, (k, read)), axis=1), 2, 41)
    return q.reshape(-1)[:n].astype(np.uint8).tobytes()


def _markov(rng, n, succ=15):
    """Bytes from a chain over all 256 symbols, each with `succ` seeded
    successors: 256 order-1 contexts and 256 * succ table rows."""
    nxt = rng.integers(0, 256, (256, succ))
    out = np.zeros(n, np.uint8)
    for i in range(1, n):
        out[i] = nxt[out[i - 1], rng.integers(0, succ)]
    return out.tobytes()


def _o1_streams(seed=3):
    rng = np.random.default_rng(seed)
    return [_walk(rng, 70000 + 13 * i) for i in range(3)] + [
        _walk(rng, 1007), _walk(rng, 13), bytes([9]) * 999, _walk(rng, 64),
        _markov(rng, 20000), rng.integers(0, 256, 3000, dtype=np.uint8)
        .tobytes()]


def _4x8_streams(seed=4):
    rng = np.random.default_rng(seed)
    return [_walk(rng, 30000 + 13 * i) for i in range(3)] + [
        rng.integers(20, 41, 5001, dtype=np.uint8).tobytes(),
        _walk(rng, 1006), _walk(rng, 7), bytes([9]) * 999,
        _markov(rng, 9000), rng.integers(0, 256, 3003, dtype=np.uint8)
        .tobytes()]


@pytest.mark.parametrize("qbins", [None, 64, 256])
def test_o1_kernels_match_plain(card, qbins):
    encs = [compress(d, 0x05) for d in _o1_streams()]
    b = o1.frame_o1_streams([o1._parse_nx16_header(e) for e in encs], card)
    offs = torch.arange(b.n_streams, dtype=torch.int32, device=card)
    for mr in (-1, 700):
        got = o1.rans_o1(b, max_rounds=mr, offs=offs, qbins=qbins)
        want = o1.rans_o1_plain(b, max_rounds=mr, offs=offs, qbins=qbins)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def _o1_batch(datas, dev):
    return o1.frame_o1_streams(
        [o1._parse_nx16_header(compress(d, 0x05)) for d in datas], dev)


@pytest.mark.parametrize("qbins", [None, 64])
def test_o1_kernels_match_plain_many_streams(card, qbins):
    """B5/B6 over a batch of twice the streams the card holds at once:
    every SM full, then a second wave.  The copies are the base batch's
    streams, so the plain version runs on the base batch and is
    repeated."""
    from htslib_tpu_torch.bench_rans import replicate
    rng = np.random.default_rng(13)
    base = _o1_batch([_walk(rng, 5000 + 7 * i) for i in range(4)], card)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    k = -(-2 * sms * o1.blocks_per_sm(base.tables, qbins is not None) // 4)
    b = replicate(base, k)
    offs = torch.zeros(b.n_streams, dtype=torch.int32, device=card)
    got = o1.rans_o1(b, offs=offs, qbins=qbins)
    want = o1.rans_o1_plain(base, offs=offs[:4], qbins=qbins)
    assert torch.equal(got[0], want[0].repeat(k) if qbins is None
                       else want[0].repeat(k, 1))
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w.repeat(k, *([1] * (w.dim() - 1))))


def spread_stream(rng, n, width=64, sd=8.0):
    """A clipped random walk over 0..width-1 with normal steps: each
    context has ~35 successors, the rare ones of frequency 1-10 packed at
    the ends of its slot range, so every context has slow buckets (two or
    more rows start inside a 64-slot bucket after its first slot)."""
    steps = np.rint(rng.normal(0, sd, n)).astype(np.int64)
    out = np.zeros(n, np.uint8)
    for i in range(1, n):
        out[i] = min(max(int(out[i - 1]) + int(steps[i]), 0), width - 1)
    return out.tobytes()


@pytest.mark.parametrize("qbins", [None, 64])
def test_o1_kernels_map_slow_buckets(card, qbins):
    """B5/B6 on streams whose lookups meet slow buckets (a wide context,
    slow buckets in every context) equal the plain version, and count the
    rounds in which they did."""
    rng = np.random.default_rng(11)
    b = _o1_batch([wide_stream(rng, 1 << 16), spread_stream(rng, 20000),
                   _walk(rng, 3001)], card)
    offs = torch.zeros(b.n_streams, dtype=torch.int32, device=card)
    slow = torch.zeros(b.n_streams, dtype=torch.int32, device=card)
    got = o1.rans_o1_cuda(b, offs=offs, qbins=qbins, slow_rounds=slow)
    want = o1.rans_o1_plain(b, offs=offs, qbins=qbins)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (slow[:2] > 0).all()
    assert (slow <= (b.ulen - 31 * (b.ulen // 32))).all()


def test_o1_streams_per_sm(card):
    """A quality stream's table (a few dozen contexts) leaves room for 12
    or more B5/B6 streams on an SM; the largest table the kernels take
    (4,096 rows over 256 contexts, most buckets slow) still fits."""
    rng = np.random.default_rng(14)
    t = _o1_batch([_walk(rng, 1 << 16)], card).tables
    F = np.zeros((256, 256), np.int64)
    for c in range(256):
        F[c, :15] = 1       # 15 one-slot rows: every bucket 0 slow
        F[c, 15] = 4096 - 15
    big = o1.frame_o1_tables([F], card)
    assert int(big.n_rows[0]) == o1.A2_MAX
    for hist in (False, True):
        assert o1.blocks_per_sm(t, hist) >= 12
        assert o1.blocks_per_sm(big, hist) >= 1
    assert int(o1.o1_table_sizes(big)[1][0]) == 256
    assert o1.o1_smem_bytes(big, True) > 48 * 1024


def short_table_compress(data: bytes, order: int = 0,
                         short: int = 96) -> bytes:
    """A valid 4x8 stream whose frequencies (order 1: those of every
    context) sum to 4096 - short: the port's encoder with its largest
    frequency cut."""
    norm = r8._normalize

    def cut(h, total=r8.TOTFREQ):
        f = norm(h, total)
        f[int(np.argmax(f))] -= short
        return f

    r8._normalize = cut
    try:
        return r8.compress(data, order)
    finally:
        r8._normalize = norm


def odd_payload_stream(rng, order: int = 0):
    """(raw, encoded): the first random walk of rng's series whose 4x8
    payload is not a whole number of 4-byte words."""
    while True:
        d = _walk(rng, 4001)
        enc = r8.compress(d, order)
        if int(t8.frame_4x8([enc], order == 1, "cpu").n_bytes[0]) % 4:
            return d, enc


def _4x8_edge_streams(order, seed=9):
    """Three streams of one order at the kernels' edges: a wide alphabet
    (context 0 with ~256 successors of frequency ~16, so order-1 lookups
    fall through to the loop), a payload of n_bytes % 4 != 0, and tables
    summing to 4096 - 96 (the largest frequency cut)."""
    rng = np.random.default_rng(seed)
    return [r8.compress(wide_stream(rng, 6000), order),
            odd_payload_stream(rng, order)[1],
            short_table_compress(_walk(rng, 3007), order)]


@pytest.mark.parametrize("order,qbins", [(0, None), (0, 64), (0, 256),
                                         (1, 64), (1, 256)])
def test_4x8_kernels_match_plain(card, order, qbins):
    datas = [d for d in _4x8_streams() if order == 0 or len(d) >= 4]
    b = t8.frame_4x8([r8.compress(d, order) for d in datas]
                     + _4x8_edge_streams(order), order == 1, card)
    offs = torch.arange(b.n_streams, dtype=torch.int32, device=card)
    for mr in (-1, 1500):
        got = t8.rans4x8(b, max_rounds=mr, offs=offs, qbins=qbins)
        want = t8.rans4x8_plain(b, max_rounds=mr, offs=offs, qbins=qbins)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_4x8_streams_per_sm(card):
    """The tables leave room for 12 (B7), 10 (B8 order 0) and 4 (B8 order
    1) streams on an SM, so a batch of more streams than SMs overlaps
    them."""
    assert t8.blocks_per_sm(False) >= 12
    assert t8.blocks_per_sm(True, False) >= 10
    assert t8.blocks_per_sm(True, True) >= 4


@pytest.mark.parametrize("order,qbins", [(0, None), (0, 64), (1, 64)])
def test_4x8_kernels_match_plain_many_streams(card, order, qbins):
    """A batch of twice the streams the card holds at once: every SM full,
    then a second wave."""
    from htslib_tpu_torch.bench_rans import replicate
    rng = np.random.default_rng(12)
    b = t8.frame_4x8([r8.compress(_walk(rng, 1000 + 7 * i), order)
                      for i in range(4)], order == 1, card)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    b = replicate(b, -(-2 * sms * t8.blocks_per_sm(qbins is not None,
                                                   order == 1) // 4))
    offs = torch.arange(b.n_streams, dtype=torch.int32, device=card) % 7
    got = t8.rans4x8(b, offs=offs, qbins=qbins)
    want = t8.rans4x8_plain(b, offs=offs, qbins=qbins)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_4x8_o1_decode_has_no_kernel(card):
    """The order-1 symbol decode that had no kernel now launches X1
    (before, the wrapper raised): equal to its plain version, its launch
    counted; an Nx16 4-way histogram still has none."""
    data = _walk(np.random.default_rng(1), 99)
    b = t8.frame_4x8([r8.compress(data, 1)], True, card)
    before = _build.LAUNCHES["rans4x8_o1_decode"]
    got = t8.rans4x8(b)
    assert _build.LAUNCHES["rans4x8_o1_decode"] == before + 1
    assert got[0].cpu().numpy().tobytes() == data
    for g, w in zip(got, t8.rans4x8_plain(b)):
        assert torch.equal(g, w)
    b = t8.frame_nx16_4way([compress(data, 0x01)], True, card)
    with pytest.raises(ValueError, match="no kernel"):
        t8.rans4x8(b, qbins=64)


def _x_streams(wire, dev, seed=15):
    """Streams at the X kernels' edges on `wire` (4x8_o1, nx16_4way_o0 or
    nx16_4way_o1): lengths 1-3 (not on 4x8 order 1, which the encoder
    writes as order 0), 4k + 0..3 about a 32-round block, a long
    walk, a constant run, and the wide-alphabet stream (order 1: its
    lookups walk)."""
    rng = np.random.default_rng(seed)
    datas = [_walk(rng, n) for n in (1, 2, 3, 127, 128, 129, 130, 131,
                                     4 * 32 * 40 + 3, 20001)]
    datas += [bytes([33]) * 5000, wide_stream(rng, 6000)]
    if wire == "4x8_o1":
        # the encoder writes streams under 4 symbols as order 0
        datas = [d for d in datas if len(d) >= 4]
        return datas, t8.frame_4x8([r8.compress(d, 1) for d in datas], True,
                                   dev)
    o1 = wire.endswith("o1")
    return datas, t8.frame_nx16_4way([compress(d, int(o1)) for d in datas],
                                     o1, dev)


X_KEYS = {"4x8_o1": "rans4x8_o1_decode",
          "nx16_4way_o0": "rans_nx16_4way_o0_decode",
          "nx16_4way_o1": "rans_nx16_4way_o1_decode"}


@pytest.mark.parametrize("wire", list(X_KEYS))
def test_x_kernels_match_plain(card, wire):
    """X1-X3 against their plain versions, whole and stopped inside, on
    and after a 32-round block's edges, and against the raw bytes."""
    datas, b = _x_streams(wire, card)
    before = _build.LAUNCHES[X_KEYS[wire]]
    for mr in (-1, 1, 31, 32, 33, 1500):
        got = t8.rans4x8(b, max_rounds=mr)
        want = t8.rans4x8_plain(b, max_rounds=mr)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        if mr < 0:
            assert got[0].cpu().numpy().tobytes() == b"".join(datas)
    assert _build.LAUNCHES[X_KEYS[wire]] == before + 6


@pytest.mark.parametrize("wire", list(X_KEYS))
def test_x_kernels_match_plain_many_streams(card, wire):
    """A batch of twice the streams the card holds at once."""
    from htslib_tpu_torch.bench_rans import replicate
    datas, base = _x_streams(wire, card)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    k = -(-2 * sms * t8.blocks_per_sm(False, base.o1, base.w16)
          // base.n_streams)
    got = t8.rans4x8(replicate(base, k))
    want = t8.rans4x8_plain(base)
    assert got[0].cpu().numpy().tobytes() == b"".join(datas) * k
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w.repeat(k, *([1] * (w.dim() - 1))))


def test_x_streams_per_sm(card):
    """X2 takes B7's 17 KB and X1/X3 B8 order 1's order-1 table: 12 and 4
    streams an SM."""
    assert t8.blocks_per_sm(False, True) >= 4
    assert t8.blocks_per_sm(False, False, True) >= 12
    assert t8.blocks_per_sm(False, True, True) >= 4
    assert t8.smem_bytes(False, False) < 18 * 1024
    assert t8.smem_bytes(False, True) < 54 * 1024


O1_LAYOUT_CASES = {"4x8_o1": None, "nx16_4way_o1": None, "b8_o1": 64}


@pytest.mark.parametrize("layout", ["wide", "compact"])
@pytest.mark.parametrize("case", list(O1_LAYOUT_CASES))
def test_o1_layouts_match_plain(card, case, layout):
    """X1, X3 and B8 order 1 through either order-1 table (the wide
    records with the slow buckets' maps, or the compact records with the
    walk), whole and stopped inside, equal to their plain versions and
    the raw bytes; each launch counted under its layout."""
    wire = "4x8_o1" if case == "b8_o1" else case
    qbins = O1_LAYOUT_CASES[case]
    datas, b = _x_streams(wire, card)
    offs = torch.arange(b.n_streams, dtype=torch.int32, device=card) % 5
    before = t8.LAYOUT_LAUNCHES[layout]
    for mr in (-1, 33, 1500):
        got = t8.rans4x8_cuda(b, mr, offs, qbins, layout=layout)
        want = t8.rans4x8_plain(b, mr, offs, qbins)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        if mr < 0 and qbins is None:
            assert got[0].cpu().numpy().tobytes() == b"".join(datas)
    assert t8.LAYOUT_LAUNCHES[layout] == before + 3


@pytest.mark.parametrize("hist,w16", [(False, False), (False, True),
                                      (True, False)])
def test_o1_layout_follows_the_wave(card, hist, w16):
    """The wide table holds one stream an SM; a batch of one wave of it
    takes the wide table, one stream more the compact one, and both
    decode as the plain version."""
    from htslib_tpu_torch.bench_rans import replicate
    wire = "nx16_4way_o1" if w16 else "4x8_o1"
    _, base = _x_streams(wire, card)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    per_sm = t8.wide_blocks_per_sm(hist, w16, t8.max_slow(base.tables))
    assert per_sm == 1
    qbins = 64 if hist else None
    for n, layout in ((sms * per_sm, "wide"), (sms * per_sm + 1, "compact")):
        b = _first(replicate(base, -(-n // base.n_streams)), n)
        assert t8.wide_fits(b, hist) == (layout == "wide")
        before = dict(t8.LAYOUT_LAUNCHES)
        got = t8.rans4x8(b, qbins=qbins)
        assert t8.LAYOUT_LAUNCHES[layout] == before[layout] + 1
        want = t8.rans4x8_plain(b, qbins=qbins)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def _first(b, n):
    """The batch of b's first n streams (their payloads and outputs keep
    their offsets)."""
    from dataclasses import replace
    from htslib_tpu_torch.ops.rans_nx16_o1 import O1Tables
    t = b.tables
    return replace(
        b, byte_off=b.byte_off[:n].contiguous(),
        n_bytes=b.n_bytes[:n].contiguous(), freqs=b.freqs[:n].contiguous(),
        tables=O1Tables(t.rows, t.row_off[:n].contiguous(),
                        t.n_rows[:n].contiguous(),
                        t.ctx_start[:n].contiguous()),
        x0=b.x0[:n].contiguous(), ulen=b.ulen[:n].contiguous(),
        out_off=b.out_off[:n].contiguous())


def test_wide_smem_and_streams_per_sm(card):
    """The wide table: records and buckets of about 132 KB (136 KB with
    B8's histogram rows), one stream an SM, maps of 128 bytes a slow
    bucket until a block's shared memory is full."""
    assert 128 * 1024 < t8.wide_smem_bytes(False, 0) < 134 * 1024
    assert t8.wide_smem_bytes(True, 10) - t8.wide_smem_bytes(True, 0) \
        == 1280
    assert t8.wide_blocks_per_sm(False, False, 0) == 1
    assert t8.wide_blocks_per_sm(True, False, 700) == 1
    assert t8.wide_blocks_per_sm(False, False, 2000) == 0


def test_uncompress_on_card_matches_cpu(card, monkeypatch):
    """Both batch entry points on the card: the CPU's bytes (the plain
    versions'), the raw bytes, and every group through its kernel (the
    launch counters rise; the plain versions are made to raise)."""
    from htslib_tpu_torch.ops import rans as trans
    rng = np.random.default_rng(16)
    datas = [_walk(rng, n) for n in (1, 2, 3, 4001, 4002, 70003)]
    b48 = [r8.compress(d, i % 2) for i, d in enumerate(datas)]
    b16 = [compress(d, fl) for d in datas for fl in (0x00, 0x01, 0x04, 0x05)]
    b16 += [compress(b"", 0x01), compress(b"", 0x04)]
    want48 = trans.uncompress_batch(b48, device="cpu")
    want16 = trans.uncompress_nx16_batch(b16, device="cpu")
    assert want48 == datas
    assert want16 == [d for d in datas for _ in range(4)] + [b"", b""]

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the card's path")

    for mod, fn in ((t8, "rans4x8_plain"), (tr, "rans_o0_plain"),
                    (o1, "rans_o1_plain")):
        monkeypatch.setattr(mod, fn, refuse)
    keys = ["rans4x8_o0_decode", "rans4x8_o1_decode", "rans_nx16_o0_decode",
            "rans_nx16_o1_decode", "rans_nx16_4way_o0_decode",
            "rans_nx16_4way_o1_decode"]
    before = {k: _build.LAUNCHES[k] for k in keys}
    assert trans.uncompress_batch(b48, device=card) == want48
    assert trans.uncompress_nx16_batch(b16, device=card) == want16
    assert all(_build.LAUNCHES[k] == before[k] + 1 for k in keys)


def test_resolve_kernel_matches_plain_on_edge_states(card):
    """B4 from the starts its doubled form leaves to the canonical step
    (0, below 2^15, 2^31 and above, a one-symbol table), every step count
    about its unroll."""
    from test_torch_resolve_step import _edge_tables
    freqs, x0 = _edge_tables()
    f = torch.from_numpy(freqs.astype(np.int32)).to(card)
    x = torch.from_numpy(x0.astype(np.uint32).view(np.int32)).to(card)
    for rounds in (0, 1, 3, 8, 9, 333, 4099):
        assert torch.equal(tr.rans_resolve_cuda(f, x, rounds).cpu(),
                           tr.rans_resolve_plain(f.cpu(), x.cpu(), rounds))


def test_resolve_kernel_many_chains(card):
    """B4 at 1,056 chains (8 an SM, one wave) against the numpy chain."""
    fn, args, ref_chain = tr.make_resolve_bench(G=1056, rounds=2048,
                                                device=card)
    assert np.array_equal(fn(*args).cpu().numpy(),
                          ref_chain().view(np.int32))


def test_resolve_smem_and_chains_per_sm(card):
    assert tr.resolve_smem_bytes() == 16896
    assert tr.resolve_chains_per_sm() >= 8


def test_new_lanes_match_host_truth(card):
    datas = _o1_streams()
    encs = [compress(d, 0x05) for d in datas]
    assert o1.decode_nx16_o1_batch(encs, device=card) == datas
    hist, _ = tds.qualstats_device_o1(encs, device=card)
    assert np.array_equal(hist, tds.qualstats_host(datas))
    datas = _4x8_streams()
    assert t8.decode_4x8_o0_batch([r8.compress(d, 0) for d in datas],
                                  device=card) == datas
    for order in (0, 1):
        hist, _ = tds.qualstats_device_4x8(
            [r8.compress(d, order) for d in datas], device=card,
            o1=bool(order))
        assert np.array_equal(hist, tds.qualstats_host(datas))


@pytest.mark.parametrize("name", ["qual_o1.cram", "qual_v30.cram",
                                  "qual_stripe_pack.cram"])
def test_new_fixtures_on_card_match_cpu(card, name):
    path = os.path.join(REPO, "htslib_tpu_torch", "testdata", name)
    sc, sg = {}, {}
    assert np.array_equal(tds.cram_qual_hist(path, device=card, stats=sg),
                          tds.cram_qual_hist(path, device="cpu", stats=sc))
    assert sg == sc and sg["device_blocks"] > 0


def test_entry_on_card_matches_cpu(card):
    fn, args = entry(device=card)
    cfn, cargs = entry(device="cpu")
    assert int(fn(*args)) == int(cfn(*cargs))
    cov = coverage_tile(args[2], args[3], args[4], 0, 1 << 14)
    ccov = coverage_tile(cargs[2], cargs[3], cargs[4], 0, 1 << 14)
    assert torch.equal(cov.cpu(), ccov)


def _enc_streams(seed=6):
    """Streams for the encode kernel: long ones, a full alphabet, a
    single symbol (f = 4096, never emits), one symbol alone, lengths
    under 32 and with n % 32 != 0."""
    rng = np.random.default_rng(seed)
    return [rng.integers(20, 41, 70000 + 13 * i, dtype=np.uint8).tobytes()
            for i in range(3)] + [
        rng.integers(0, 256, 3001, dtype=np.uint8).tobytes(),
        bytes([9]) * 999, bytes([5]),
        rng.integers(0, 40, 13, dtype=np.uint8).tobytes(),
        rng.integers(0, 40, 31, dtype=np.uint8).tobytes(),
        rng.integers(0, 4, 4097, dtype=np.uint8).tobytes(),
        _walk(rng, 1007)]


def test_enc_kernel_matches_plain(card):
    b = te.frame_enc(_enc_streams(), card)
    for mr in (-1, 50):
        got = te.rans_enc(b, max_rounds=mr)
        want = te.rans_enc_plain(b, max_rounds=mr)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_enc_on_card_matches_host_and_round_trips(card):
    datas = _enc_streams()
    encs = te.encode_nx16_o0_batch(datas, device=card)
    assert encs == [compress(d, 0x04) for d in datas]
    assert tr.decode_nx16_o0_batch(encs, device=card) == datas


@pytest.mark.parametrize("field", ["off", "ulen", "freqs", "cum"])
def test_enc_kernel_rejects_inconsistent_batch(card, field):
    b = te.frame_enc(_enc_streams(), card)
    getattr(b, field)[0] += 1 << 20
    with pytest.raises(ValueError, match="outside its buffers"):
        te.rans_enc(b)


def test_resolve_chain_kernels_match_plain_and_numpy(card):
    """Both resolve chains with an unroll that does not divide the
    rounds (203 // 4 * 4 = 200 steps), and 100 Huffman chains, so a
    block of 32 is partly empty."""
    fn, args, ref_chain = tr.make_resolve_bench(G=128, rounds=203, unroll=4,
                                                device=card)
    got = fn(*args)
    assert torch.equal(got[0], tr.rans_resolve_plain(*args, 200))
    assert np.array_equal(got.cpu().numpy(), ref_chain().view(np.int32))
    fn, args, ref_step, v0 = th.make_huffman_resolve_bench(
        L=100, rounds=203, unroll=4, device=card)
    got = fn(*args)
    assert torch.equal(got[0], th.huffman_resolve_plain(*args, 200))
    v = v0[0]
    for _ in range(200):
        v, _sym = ref_step(v)
    assert np.array_equal(got[0].cpu().numpy(), v)


@pytest.mark.parametrize("max_rounds", [-1, 1, 31, 32, 33, 64, 65, 100])
def test_enc_kernel_matches_plain_many_streams(card, max_rounds):
    """B9 over 1,056 streams (the edge streams copied, every copy its own
    symbols and region), whole and stopped before, on and after the
    window's edges, against its plain version on the base batch."""
    from htslib_tpu_torch.bench_rans import replicate_enc
    base = te.frame_enc(enc_edge_streams(), card)
    k = -(-1056 // base.n_streams)
    got = te.rans_enc(replicate_enc(base, k), max_rounds=max_rounds)
    want = te.rans_enc_plain(base, max_rounds=max_rounds)
    assert torch.equal(got[0][:-1], want[0][:-1].repeat(k))
    assert torch.equal(got[1], want[1].repeat(k, 1))
    assert torch.equal(got[2], want[2].repeat(k))


def test_enc_edge_streams_match_host_codec(card):
    datas = enc_edge_streams()
    f = te.frame_enc(datas, "cpu").freqs
    assert (f == 1).sum() >= 29 and (f == tr.TOTFREQ).sum() == 3
    encs = te.encode_nx16_o0_batch(datas, device=card)
    assert encs == [compress(d, 0x04) for d in datas]
    assert tr.decode_nx16_o0_batch(encs, device=card) == datas


def test_enc_smem_and_streams_per_sm(card):
    """B9 takes 4 KiB of entries a block and runs 1,056 streams in one
    wave (8 or more an SM)."""
    assert te.smem_bytes() == 4096
    assert te.blocks_per_sm() >= 8


def _huff_args(lens, card, seed=0, order_add=0):
    """The chain's kernel arguments for code lengths lens [L, 288]: the
    port's tables, every order value moved by order_add, and seeded start
    windows."""
    limits, firsts, bases, dord = th.build_tables(lens)
    order = th.order_of(dord).astype(np.int64) + order_add
    order = ((order + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)
    v0 = np.random.default_rng(seed).integers(
        0, 1 << 15, lens.shape[0]).astype(np.int32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(card)
                 for a in (limits, firsts, bases, order, v0))


@pytest.mark.parametrize("L", [1056, 1000, 33])
def test_huffman_kernel_many_chains(card, L):
    """B10 at 1,056 chains, and at L that leave a ragged last block of 32,
    against its plain version and the numpy chain, over 1,100 steps (two
    whole check blocks of 512 and a ragged one)."""
    from htslib_tpu_torch.bench_rans import huff_truth
    args = th.make_huffman_resolve_bench(L=L, rounds=1100, unroll=1,
                                         device=card)[1]
    got = th.huffman_resolve(*args, 1100)
    assert torch.equal(got, th.huffman_resolve_plain(*args, 1100))
    assert np.array_equal(got.cpu().numpy(), huff_truth(args, 1100))


@pytest.mark.parametrize("rounds", [0, 1, 2, 513, 1500])
def test_huffman_kernel_long_codes(card, rounds):
    """Codes of every length to 15 bits, whose windows under codes longer
    than the 9-bit prefix table meet its sentinel and are run again
    canonically, against the plain version; 0 steps give the start
    windows back."""
    rng = np.random.default_rng(9)
    lens = np.zeros((40, 288), np.int64)
    for s in range(40):
        lens[s, rng.choice(288, 16, replace=False)] = list(range(1, 16)) + [15]
    lens[:8, :144] = 8        # and some codes with 10-bit ones
    lens[:8, 144:] = 10
    args = _huff_args(lens, card, seed=rounds)
    got = th.huffman_resolve(*args, rounds)
    assert torch.equal(got, th.huffman_resolve_plain(*args, rounds))


@pytest.mark.parametrize("order_add", [70000, -1, -(1 << 20)])
def test_huffman_kernel_takes_any_order_value(card, order_add):
    """Order values a u16 table could not hold, and -1 (the prefix
    table's sentinel, 0xFFFFFFFF), resolve exactly: the kernel refuses no
    table."""
    lens = np.zeros((64, 288), np.int64)
    lens[:, :144] = 8
    lens[:, 144:256] = 9
    lens[:, 256:280] = 7
    lens[:, 280:] = 8
    args = _huff_args(lens, card, order_add=order_add)
    got = th.huffman_resolve(*args, 700)
    assert torch.equal(got, th.huffman_resolve_plain(*args, 700))


def test_huffman_smem_and_chains_per_sm(card):
    """B10 takes 108,544 bytes a block of 32 chains and runs 64 chains an
    SM, so 1,056 chains run in one wave."""
    assert th.smem_bytes() == 108544
    assert th.chains_per_sm() >= 64


# ---------------------------------------------------------------------------
# X4 (inflate), the dense order-1 variants and the BGZF write side
# ---------------------------------------------------------------------------

def _members_out(b, out):
    """A framed batch's flat output cut into its members' bytes."""
    flat = out.cpu().numpy()
    return [flat[o:o + c].tobytes() for o, c in
            zip(b.out_off.cpu().numpy(), b.out_cap.cpu().numpy())]


def test_inflate_kernel_matches_plain(card):
    """X4 against its plain version on chip_smoke's small members: the
    same refusals, and where both accept the same bytes, bytes produced
    and tokens; the accepted members' bytes are the expected ones."""
    members = inflate_members()
    b = ti.frame_members([m[1] for m in members], [m[2] for m in members],
                         card)
    before = _build.LAUNCHES["inflate"]
    got, gst = ti.inflate(b)
    assert _build.LAUNCHES["inflate"] == before + 1
    ref, rst = ti.inflate_plain(b)
    gerr = ti.corrupt(b, gst)
    assert torch.equal(gerr, ti.corrupt(b, rst))
    assert gerr.tolist() == [m[3] is None for m in members]
    ok = ~gerr
    assert torch.equal(gst[ok, 1:3], rst[ok, 1:3])
    for m, g, r, bad in zip(members, _members_out(b, got),
                            _members_out(b, ref), gerr.tolist()):
        if not bad:
            assert g == r == m[3], m[0]


def _full_size_datas():
    """64 KiB members: BAM records, bytes(range(256)) * 256, random, one
    byte repeated, text-like and 2-bit symbols."""
    rng = np.random.default_rng(9)
    bam = bam_record_stream(leg1_batch(n=700))[:ti.OUT_MAX]
    return [bam, bytes(range(256)) * 256,
            rng.integers(0, 256, ti.OUT_MAX, dtype=np.uint8).tobytes(),
            b"A" * ti.OUT_MAX,
            rng.integers(65, 91, ti.OUT_MAX, dtype=np.uint8).tobytes(),
            rng.integers(0, 4, ti.OUT_MAX, dtype=np.uint8).tobytes()]


@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_inflate_kernel_full_size_members_match_zlib(card, level):
    """Full-size members under every zlib strategy, many more members
    than the card holds at once."""
    import zlib
    datas = _full_size_datas()
    payloads = [deflate_raw(d, level, s) for d in datas
                for s in (zlib.Z_DEFAULT_STRATEGY, zlib.Z_FIXED,
                          zlib.Z_HUFFMAN_ONLY, zlib.Z_RLE)]
    want = [d for d in datas for _ in range(4)]
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    k = -(-(sms * ti.blocks_per_sm() + 1) // len(payloads))
    got = ti.inflate_batch(payloads * k, [len(d) for d in want] * k,
                           device=card)
    assert got == want * k


def test_inflate_kernel_token_cap(card):
    """70,000 Huffman-coded literals reach the JAX function's 65,552-token
    refusal; 65,536 of them do not."""
    import zlib
    rng = np.random.default_rng(13)
    lits = rng.integers(0, 16, 70000, dtype=np.uint8).tobytes()
    datas = [lits, lits[:ti.OUT_MAX]]
    b = ti.frame_members([deflate_raw(d, 6, zlib.Z_HUFFMAN_ONLY)
                          for d in datas], [len(d) for d in datas], card)
    out, st = ti.inflate(b)
    assert ti.corrupt(b, st).tolist() == [True, False]
    assert st[0, 0].item() == 7 and st[0, 2].item() == ti.MAX_TOK
    assert _members_out(b, out)[1] == datas[1]


def test_inflate_batch_on_card_matches_cpu(card, monkeypatch):
    """inflate_batch on the card: the CPU's bytes, the same ValueError,
    and never the plain version."""
    members = [m for m in inflate_members() if m[3] is not None]
    payloads = [m[1] for m in members]
    sizes = [m[2] for m in members]
    want = ti.inflate_batch(payloads, sizes, device="cpu")

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the card's path")

    monkeypatch.setattr(ti, "inflate_plain", refuse)
    assert ti.inflate_batch(payloads, sizes, device=card) == want
    bad = [m for m in inflate_members() if m[0] == "corrupt"][0]
    with pytest.raises(ValueError, match="corrupt stream 2"):
        ti.inflate_batch(payloads[:2] + [bad[1]], sizes[:2] + [bad[2]],
                         device=card)


def test_inflate_smem_and_blocks_per_sm(card):
    """X4's ring variant keeps a member's 32 KiB output ring, payload ring
    and tables in shared memory, under 38 KB a member: 6 members an SM.
    The slot variant keeps the payload ring and tables, under 6 KB, and
    is held to 64 registers: 32 members an SM.  ring_fits gives the ring a batch that
    fits one wave of it, the slot variant a larger one."""
    assert 32 * 1024 < ti.smem_bytes(ring=True) < 38 * 1024
    assert ti.blocks_per_sm(ring=True) == 6
    assert ti.smem_bytes(ring=False) < 6 * 1024
    assert ti.blocks_per_sm(ring=False) == 32
    wave = 6 * torch.cuda.get_device_properties(card).multi_processor_count
    assert ti.ring_fits(wave, card) and not ti.ring_fits(wave + 1, card)


def test_inflate_kernel_ring_edge_members(card):
    """X4 at its output ring's edges (distance 32,768, matches over the
    ring's wraps, stored blocks past it, a match before the output's
    start across position 32,768, a capacity inside a match): the plain
    version's bytes, tokens and steps' refusals, and the expected
    bytes."""
    members = ring_edge_members()
    b = ti.frame_members([m[1] for m in members], [m[2] for m in members],
                         card)
    ref, rst = ti.inflate_plain(b)
    assert not ti.corrupt(b, rst).any()
    for ring in (True, False):
        got, gst = ti.inflate_cuda(b, ring=ring)
        assert not ti.corrupt(b, gst).any()
        assert torch.equal(gst[:, 1:3], rst[:, 1:3])
        for m, g, r in zip(members, _members_out(b, got),
                           _members_out(b, ref)):
            assert g == r == m[3], m[0]


DENSE_KEYS = {"4x8_o1": "rans4x8_o1_dense_decode",
              "nx16_4way_o1": "rans_nx16_4way_o1_dense_decode",
              "nx16_o1": "rans_nx16_o1_dense_decode"}


def _dense_datas(seed=21):
    """Uniform random bytes of lengths about the rounds' blocks (order-1
    tables past A2_MAX rows), and one walk (few rows)."""
    rng = np.random.default_rng(seed)
    datas = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
             for n in (20000, 20003, 4 * 32 * 40 + 1, 33333)]
    return datas + [_walk(rng, 5001)]


def _dense_batch(wire, dev, seed=21):
    """Order-1 streams past A2_MAX rows on `wire` (`_dense_datas`), with
    dense tables (the walk through the dense table all the same)."""
    datas = _dense_datas(seed)
    if wire == "4x8_o1":
        return datas, t8.frame_4x8([r8.compress(d, 1) for d in datas], True,
                                   dev, True)
    if wire == "nx16_4way_o1":
        return datas, t8.frame_nx16_4way([compress(d, 0x01) for d in datas],
                                         True, dev, True)
    return datas, o1.frame_o1_streams(
        [o1._parse_nx16_header(compress(d, 0x05)) for d in datas], dev, True)


@pytest.mark.parametrize("wire", list(DENSE_KEYS))
def test_dense_kernels_match_plain(card, wire):
    """The dense variants against their plain versions (a gather from the
    same table), whole and stopped inside and on a block's edges, and
    against the raw bytes; each launch counted under its own name."""
    datas, b = _dense_batch(wire, card)
    kern, plain = ((t8.rans4x8, t8.rans4x8_plain) if wire != "nx16_o1"
                   else (o1.rans_o1, o1.rans_o1_plain))
    before = _build.LAUNCHES[DENSE_KEYS[wire]]
    for mr in (-1, 1, 31, 32, 33, 1500):
        got = kern(b, max_rounds=mr)
        want = plain(b, max_rounds=mr)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        if mr < 0:
            assert got[0].cpu().numpy().tobytes() == b"".join(datas)
    assert _build.LAUNCHES[DENSE_KEYS[wire]] == before + 6


def test_dense_kernels_refuse_a_histogram(card):
    _, b = _dense_batch("4x8_o1", card)
    with pytest.raises(ValueError, match="symbols only"):
        t8.rans4x8(b, qbins=64)
    _, b = _dense_batch("nx16_o1", card)
    with pytest.raises(ValueError, match="symbols only"):
        o1.rans_o1(b, qbins=64)


def test_dense_smem_and_streams_per_sm(card):
    """The dense variants build no table: the 4x8 and 4-way ones keep the
    ring and the symbol buffer, B5's its fixed part, under 2 KB a block;
    an SM holds 16 or more streams."""
    assert t8.smem_bytes(False, True, True) < 2 * 1024
    assert o1.dense_smem_bytes() < 2 * 1024
    assert t8.blocks_per_sm(False, True, False, True) >= 16
    assert t8.blocks_per_sm(False, True, True, True) >= 16


def test_uncompress_dense_on_card_matches_cpu(card, monkeypatch):
    """Order-1 streams past A2_MAX beside ones within it, on every order-1
    wire: the CPU's bytes, each group through its kernel (past A2_MAX the
    large variant: two streams fit its waves), never a plain version."""
    from htslib_tpu_torch.ops import rans as trans
    rng = np.random.default_rng(22)
    wide = [rng.integers(0, 256, 20000, dtype=np.uint8).tobytes()
            for _ in range(2)]
    walks = [_walk(rng, 7001), _walk(rng, 3)]
    b48 = [r8.compress(d, 1) for d in wide + walks[:1]]
    b16 = [compress(d, fl) for d in wide + walks for fl in (0x01, 0x05)]
    want48 = trans.uncompress_batch(b48, device="cpu")
    want16 = trans.uncompress_nx16_batch(b16, device="cpu")
    assert want48 == wide + walks[:1]
    assert want16 == [d for d in wide + walks for _ in range(2)]

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the card's path")

    for mod, fn in ((t8, "rans4x8_plain"), (o1, "rans_o1_plain")):
        monkeypatch.setattr(mod, fn, refuse)
    keys = ["rans4x8_o1_decode", "rans_nx16_o1_decode",
            "rans_nx16_4way_o1_decode"] + list(LARGE_KEYS.values())
    before = {k: _build.LAUNCHES[k] for k in keys}
    assert trans.uncompress_batch(b48, device=card) == want48
    assert trans.uncompress_nx16_batch(b16, device=card) == want16
    assert all(_build.LAUNCHES[k] == before[k] + 1 for k in keys)


LARGE_KEYS = {w: k.replace("_dense", "_large") for w, k in DENSE_KEYS.items()}


def _large_batch(wire, dev, datas):
    if wire == "4x8_o1":
        return t8.frame_4x8([r8.compress(d, 1) for d in datas], True, dev,
                            large=True)
    if wire == "nx16_4way_o1":
        return t8.frame_nx16_4way([compress(d, 0x01) for d in datas], True,
                                  dev, large=True)
    return o1.frame_o1_streams(
        [o1._parse_nx16_header(compress(d, 0x05)) for d in datas], dev,
        large=True)


@pytest.mark.parametrize("wire", list(LARGE_KEYS))
def test_large_kernels_match_plain(card, wire):
    """The large-table variants against their plain versions (a gather
    from the JAX dense table of the same rows), whole and stopped inside
    and on a block's edges, and against the raw bytes, on uniform random
    streams (past A2_MAX, 1 MiB of them all 65,536 rows), a HiFi-style
    block and a walk (few rows, through the large table all the same);
    each launch counted under its own name."""
    from chip_smoke import hifi_qualities
    datas = _dense_datas()
    datas.append(hifi_qualities(60_000, floor=1.0, top=0.2))
    datas.append(np.random.default_rng(25).integers(
        0, 256, 1 << 20, dtype=np.uint8).tobytes())
    b = _large_batch(wire, card, datas)
    assert b.large and int(b.tables.n_rows.max()) == 65536
    kern, plain = ((t8.rans4x8, t8.rans4x8_plain) if wire != "nx16_o1"
                   else (o1.rans_o1, o1.rans_o1_plain))
    before = _build.LAUNCHES[LARGE_KEYS[wire]]
    for mr in (-1, 1, 31, 32, 33, 700):
        got = kern(b, max_rounds=mr)
        want = plain(b, max_rounds=mr) if mr >= 0 else None
        if want is not None:
            for g, w in zip(got, want):
                assert torch.equal(g, w)
        else:
            assert got[0].cpu().numpy().tobytes() == b"".join(datas)
    assert _build.LAUNCHES[LARGE_KEYS[wire]] == before + 6


def test_large_smem_and_streams_per_sm(card):
    """The large table's blocks: at the wire's 65,536 rows under a block's
    232,448 bytes, one stream an SM; fewer rows share an SM."""
    assert t8.large_smem_bytes(65536) <= 232448
    assert o1.large_smem_bytes(65536, 256) <= 232448
    for w16 in (False, True):
        assert t8.large_blocks_per_sm(w16, 65536) == 1
        assert t8.large_blocks_per_sm(w16, 8000) >= 3
    assert o1.large_blocks_per_sm(o1.large_smem_bytes(65536, 256)) == 1
    assert o1.large_blocks_per_sm(o1.large_smem_bytes(8000, 94)) >= 4


@pytest.mark.parametrize("wire", list(LARGE_KEYS))
def test_routing_past_the_waves_takes_dense(card, monkeypatch, wire):
    """Past A2_MAX a group within LARGE_WAVES waves launches the large
    variant, and with no wave allowed the dense one; the same bytes."""
    from htslib_tpu_torch.ops import rans as trans
    rng = np.random.default_rng(26)
    datas = [rng.integers(0, 256, 20000, dtype=np.uint8).tobytes()
             for _ in range(3)]
    if wire == "4x8_o1":
        encs, call = [r8.compress(d, 1) for d in datas], \
            trans.uncompress_batch
    else:
        encs = [compress(d, 0x05 if wire == "nx16_o1" else 0x01)
                for d in datas]
        call = trans.uncompress_nx16_batch
    mod = o1 if wire == "nx16_o1" else t8
    for waves, key in ((mod.LARGE_WAVES, LARGE_KEYS[wire]),
                       (0, DENSE_KEYS[wire])):
        monkeypatch.setattr(mod, "LARGE_WAVES", waves)
        before = dict(_build.LAUNCHES)
        assert call(encs, device=card) == datas
        grew = {k for k, v in _build.LAUNCHES.items() if v != before[k]}
        assert grew == {key}


def test_refused_launches_raise_and_the_context_survives(card):
    """Launches sized too small for their streams: B5 and B6 under their
    tables' shared memory, the wide table with no maps for its slow
    buckets, and the large tables (4-way and B5) under their rows.  Each
    block sets the error word and returns, the wrapper raises, and a
    correctly sized launch after it in the same process gives the plain
    version's bytes."""
    rng = np.random.default_rng(27)
    walk = [_walk(rng, 20000) for _ in range(2)]
    wide = wide_stream(rng, 6000)
    rand = rng.integers(0, 256, 30000, dtype=np.uint8).tobytes()
    b5 = o1.frame_o1_streams([o1._parse_nx16_header(compress(d, 0x05))
                              for d in walk], card)
    for qb in (None, 64):
        with pytest.raises(RuntimeError, match="refused"):
            o1.rans_o1_cuda(b5, qbins=qb, smem_bytes=2048)
        torch.cuda.synchronize()
        for g, w in zip(o1.rans_o1_cuda(b5, qbins=qb),
                        o1.rans_o1_plain(b5, qbins=qb)):
            assert torch.equal(g, w)
    bw = t8.frame_4x8([r8.compress(wide, 1)], True, card)
    assert t8.max_slow(bw.tables) > 0
    with pytest.raises(RuntimeError, match="slow buckets outnumbered"):
        t8.rans4x8_cuda(bw, layout="wide", sized_for=0)
    assert t8.rans4x8_cuda(bw, layout="wide")[0].cpu().numpy().tobytes() \
        == wide
    for wire in ("4x8_o1", "nx16_4way_o1", "nx16_o1"):
        b = _large_batch(wire, card, [rand])
        with pytest.raises(RuntimeError, match="outgrew"):
            if wire == "nx16_o1":
                o1.rans_o1_cuda(b, smem_bytes=o1.large_smem_bytes(100, 256))
            else:
                t8.rans4x8_cuda(b, sized_for=100)
        got = (o1.rans_o1_cuda if wire == "nx16_o1" else t8.rans4x8_cuda)(b)
        assert got[0].cpu().numpy().tobytes() == rand


def test_dense_tables_built_on_card_equal_cpu(card):
    """dense_tables on the card, over more streams than one pass of its
    build takes: the CPU's entries, timed into `timing`."""
    rng = np.random.default_rng(24)
    Fs = []
    for _ in range(o1.DENSE_CHUNK + 1):
        F = np.zeros((256, 256), np.int64)
        used = rng.random(256) < 0.8
        F[used] = rng.multinomial(4096, np.full(256, 1 / 256), used.sum())
        Fs.append(F)
    timing = {}
    got = o1.dense_tables(Fs, card, timing)
    assert got.is_cuda and timing["dense_table_s"] > 0
    assert torch.equal(got.cpu(), o1.dense_tables(Fs, "cpu"))


def test_inflate_batch_timing_on_card(card):
    """inflate_batch's `timing` parts on the card, beside its bytes."""
    members = [m for m in inflate_members() if m[3] is not None]
    timing = {}
    got = ti.inflate_batch([m[1] for m in members], [m[2] for m in members],
                           device=card, timing=timing)
    assert got == [m[3] for m in members]
    assert set(timing) == {"frame_s", "transfer_s", "decode_s",
                           "check_download_s", "slice_s"}
    assert timing["decode_s"] > 0


def test_bgzf_write_side_on_card(card):
    """bgzf_stored_device: every full block's CRC (on the card) is
    zlib's, and the file gzip-decodes to its input; deflate_uniform_device
    gives the CPU's bytes and stats; crc_device_rate is exact."""
    import gzip
    import zlib
    from chip_smoke import bgzf_blocks
    rng = np.random.default_rng(23)
    data = rng.integers(20, 41, 5 * tb.CHUNK + 999, dtype=np.uint8).tobytes()
    timing = {}
    blob = tb.bgzf_stored_device(data, device=card, timing=timing)
    assert timing["crc_blocks"] == 5
    blocks = list(bgzf_blocks(blob))
    assert len(blocks) == 7
    assert all(crc == zlib.crc32(pl) for crc, _, pl in blocks)
    assert gzip.decompress(blob) == data
    assert blob == tb.bgzf_stored_device(data, device="cpu")
    for d in (data, bytes(range(200)) * 500, b"", b"Q"):
        st, st_cpu = {}, {}
        out = tb.deflate_uniform_device(d, device=card, stats=st)
        assert out == tb.deflate_uniform_device(d, device="cpu",
                                                stats=st_cpu)
        assert st == st_cpu and gzip.decompress(out) == d
    assert tb.crc_device_rate(n_blocks=70, reps=1, device=card)["exact"]


# ---------------------------------------------------------------------------
# the unnormalised Nx16 order-0 table (ROADMAP queue C, repaired)
# ---------------------------------------------------------------------------

def unnormalised_stream(nway: int, seed: int = 3) -> bytes:
    """A plain Nx16 order-0 stream (32-way: flags 0x04; 4-way: 0x00)
    whose table sums to 3,000 with f[0] = 0 (f[1] = 2000, f[2] = 1000),
    12 symbols a state, states with random slots (some past the sum) and
    a payload of random words long enough that no refill reads past it.
    No encoder writes such a table; it is the smallest input on which a
    slot past the sum is decoded."""
    rng = np.random.default_rng(seed)
    f = np.zeros(256, np.int64)
    f[1], f[2] = 2000, 1000
    ulen = 12 * nway
    head = bytearray([0x04 if nway == 32 else 0x00])
    r16.u7_put(head, ulen)
    r16._write_freq_table(head, f)
    x = (rng.integers(1 << 7, 1 << 19, nway) << 12) | rng.integers(0, 4096,
                                                                    nway)
    for v in x:
        head += int(v).to_bytes(4, "little")
    return bytes(head) + rng.integers(0, 256, 4 * ulen + 64,
                                      dtype=np.uint8).tobytes()


@pytest.mark.parametrize("nway", [32, 4])
def test_unnormalised_nx16_o0_on_card_matches_cpu(card, nway):
    """B2 (32-way) and X2 (4-way) read a slot past the table's sum as the
    plain versions do, which tests/test_torch_rans_dense.py holds to the
    JAX function."""
    enc = unnormalised_stream(nway)
    _build.reset_launches()
    got = trans.uncompress_nx16_batch([enc], device=card)
    key = "rans_nx16_o0_decode" if nway == 32 else "rans_nx16_4way_o0_decode"
    assert _build.LAUNCHES[key] == 1
    assert got == trans.uncompress_nx16_batch([enc], device="cpu")


# ---------------------------------------------------------------------------
# X5 (record scan) and the BAM -> SAM chain
# ---------------------------------------------------------------------------

def scan_payloads():
    """name -> (payload bytes, max_records): streams at X5's edges."""
    return scan_streams(varied_bam_stream(300, 4), 300,
                        bam_record_stream(leg1_batch(6000, seed=3)), 6000)


@pytest.mark.parametrize("name", list(scan_payloads()))
def test_record_scan_kernel_matches_plain(card, name):
    payload, n = scan_payloads()[name]
    t = torch.from_numpy(np.frombuffer(payload, np.uint8).copy())
    want = tbs.record_scan_plain(t, n)
    got = tbs.record_scan_cuda(t.to(card), n)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def seg_payloads():
    """name -> (payload, max_records): the segmented walk's edges at the
    kernel's 64 KiB segments, made from a 1.2 MB stream of leg 1's
    records (19 segments)."""
    big = bam_record_stream(leg1_batch(6000, seed=3))
    return seg_edge_streams(big, 6000, 1 << 16)


@pytest.mark.parametrize("name", list(seg_payloads()))
def test_record_scan_seg_kernel_matches_plain(card, name):
    """X5's segmented kernels at 64 KiB segments on the segmented walk's
    edges equal the plain version; so does the serial kernel."""
    payload, n = seg_payloads()[name]
    t = torch.from_numpy(np.frombuffer(payload + b"\0", np.uint8)
                         [:len(payload)].copy())
    want = tbs.record_scan_plain(t, n)
    for seg in (True, False):
        got = tbs.record_scan_cuda(t.to(card), n, segmented=seg)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), (name, seg)


@pytest.mark.parametrize("shift", [8, 12])
def test_record_scan_seg_small_segments(card, shift):
    """Segments of 256 bytes and 4 KiB (a payload spans hundreds of
    them) on the edges made for them and on X5's older edges: equal to
    the plain version; at 4 KiB the false entries are walked again and the
    stopped walks take the serial tail."""
    good = varied_bam_stream(300, 4)
    cases = dict(seg_edge_streams(good, 300, 1 << shift))
    cases.update(scan_payloads())
    for name, (payload, n) in cases.items():
        t = torch.from_numpy(np.frombuffer(payload + b"\0", np.uint8)
                             [:len(payload)].copy())
        stats = torch.zeros(4, dtype=torch.int32, device=card)
        got = tbs.record_scan_cuda(t.to(card), n, segmented=True,
                                   shift=shift, stats=stats)
        for g, w in zip(got, tbs.record_scan_plain(t, n)):
            assert torch.equal(g.cpu(), w), name
        st = stats.tolist()
        if shift == 12 and name == "false_few":
            assert st[1] == 3 and st[2] == 0
        if shift == 12 and name in ("neg_mid", "minus4_mid", "wrap_mid"):
            assert st[2] > 0


def test_record_scan_seg_tiles_of_summaries(card):
    """2,356 segments of 1 KiB, more than pass 2 loads at once (a tile of
    2,048 summaries): every segment verified across the tile's edge, the
    plain version's result."""
    payload = bam_record_stream(leg1_batch(12000, seed=5))
    t = torch.from_numpy(np.frombuffer(payload, np.uint8).copy())
    stats = torch.zeros(4, dtype=torch.int32, device=card)
    got = tbs.record_scan_cuda(t.to(card), 12000, segmented=True, shift=10,
                               stats=stats)
    for g, w in zip(got, tbs.record_scan_plain(t, 12000)):
        assert torch.equal(g.cpu(), w)
    assert stats.tolist() == [2356, 0, 0, 2356]


def test_record_scan_takes_the_segmented_path(card):
    """A payload of SEG_MIN_BYTES or more launches the segmented kernels,
    a smaller one the serial kernel; a well-framed stream needs no
    segment walked again and no serial tail."""
    big = bam_record_stream(leg1_batch(6000, seed=3))
    t = torch.from_numpy(np.frombuffer(big, np.uint8).copy()).to(card)
    _build.reset_launches()
    stats = torch.zeros(4, dtype=torch.int32, device=card)
    got = tbs.record_scan_cuda(t, 6000, stats=stats)
    assert _build.LAUNCHES["record_scan_seg"] == 1
    assert int(got[2]) == 6000
    assert stats.tolist() == [19, 0, 0, 19]
    tbs.record_scan_cuda(t[:tbs.SEG_MIN_BYTES - 1], 6000)
    assert _build.LAUNCHES["record_scan"] == 1


def test_record_scan_unaligned_payload(card):
    payload, n = scan_payloads()["varied"]
    t = torch.from_numpy(np.frombuffer(b"\x00" + payload, np.uint8).copy())
    got = tbs.record_scan_cuda(t.to(card)[1:], n)
    for g, w in zip(got, tbs.record_scan_plain(t[1:], n)):
        assert torch.equal(g.cpu(), w)


def test_bam2sam_on_card_matches_cpu(card):
    payload = varied_bam_stream(500, 6)
    hdr = type("H", (), {"ref_names": ["chr1", "chrUn_KI270302v1"]})()
    _build.reset_launches()
    timing = {}
    got = tbs.bam_payload_to_sam_device(payload, hdr, device=card,
                                        timing=timing)
    # X5 in either design (500 varied records: 135 KB, segmented)
    assert _build.LAUNCHES["record_scan"] \
        + _build.LAUNCHES["record_scan_seg"] == 1
    assert _build.LAUNCHES["nibble_to_base"] == 1
    assert got == tbs.bam_payload_to_sam_device(payload, hdr, device="cpu")
    assert timing["records"] == 500


# ---------------------------------------------------------------------------
# X6 (probaln) and BAQ
# ---------------------------------------------------------------------------

def probaln_batch_args(n=300, seed=5, dtype=np.float64, long_every=0):
    """A padded batch of random reads with mixed bands and lengths."""
    rng = np.random.default_rng(seed)
    refs, qs, quals, bws = [], [], [], []
    for i in range(n):
        lq = int(rng.integers(1, 90))
        if long_every and i % long_every == 0:
            lq = int(rng.integers(300, 600))
        lr = max(1, lq + int(rng.integers(-20, 30)))
        refs.append(rng.integers(0, 5, lr).astype(np.uint8).tobytes())
        qs.append(rng.integers(0, 5, lq).astype(np.uint8).tobytes())
        quals.append(rng.integers(0, 45, lq).astype(np.uint8).tobytes())
        bws.append(int(rng.integers(0, 16)))
    arrays, J = tpb.pad_batch(refs, qs, quals, dtype=dtype, bws=bws)
    return arrays, J + int(rng.integers(0, 7))


@pytest.mark.parametrize("dtype,long_every", [(np.float64, 0),
                                              (np.float32, 0),
                                              (np.float64, 37)])
def test_probaln_kernel_matches_plain(card, dtype, long_every):
    arrays, J = probaln_batch_args(dtype=dtype, long_every=long_every)
    cpu = [torch.from_numpy(a) for a in arrays]
    want = tpb.probaln_plain(*[a.to(card) for a in cpu], J)
    got = tpb.probaln_cuda(*[a.to(card) for a in cpu], J)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype,long_every", [(np.float64, 0),
                                              (np.float32, 0),
                                              (np.float64, 37)])
def test_probaln_thread_kernel_matches_plain(card, dtype, long_every):
    """Every read a thread (the split that a batch of THREAD_MIN_READS
    short reads gets): the plain version's results."""
    arrays, J = probaln_batch_args(dtype=dtype, long_every=long_every)
    a = [torch.from_numpy(x).to(card) for x in arrays]
    want = tpb.probaln_plain(*a, J)
    _build.reset_launches()
    got = tpb.launch(*a, 0.001, 0.1, torch.zeros(len(arrays[3]),
                                                 dtype=torch.bool,
                                                 device=card))
    assert _build.LAUNCHES["probaln"] == 1
    assert _build.LAUNCHES["probaln_warp"] == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_probaln_warp_kernel_matches_plain(card, dtype, monkeypatch):
    """Leg-9-like long reads (1,000-2,000 bp) with short ones in the same
    batch: with fewer short reads than THREAD_MIN_READS every read runs a
    warp; with the threshold at 60 the long ones run a warp each and the
    short a thread each.  Either way the results are the plain
    version's."""
    long_r = hmm_reads(24, 1500, 3)
    short_r = hmm_reads(60, 100, 4)
    refs, qs, quals, bws = [x + y for x, y in zip(long_r, short_r)]
    arrays, J = tpb.pad_batch(refs, qs, quals, dtype=dtype, bws=bws)
    a = [torch.from_numpy(x).to(card) for x in arrays]
    want = tpb.probaln_plain(*a, J, d=1e-7)
    for min_reads, warps, threads in ((tpb.THREAD_MIN_READS, 84, 0),
                                      (60, 24, 60)):
        monkeypatch.setattr(tpb, "THREAD_MIN_READS", min_reads)
        _build.reset_launches()
        layout = {}
        got = tpb.probaln_cuda(*a, J, d=1e-7, layout=layout)
        assert layout == {"warp_reads": warps, "thread_reads": threads}
        assert _build.LAUNCHES["probaln_warp"] == 1
        assert _build.LAUNCHES["probaln"] == int(threads > 0)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_probaln_warp_kernel_wide_bands(card):
    """Long reads with bands past 64 cells (each lane takes three) run a
    warp each and give the plain version's results."""
    rng = np.random.default_rng(12)
    refs, qs, quals, bws = [], [], [], []
    for k in range(8):
        lq = int(rng.integers(600, 900))
        ref = rng.integers(0, 4, lq + 80).astype(np.uint8)
        refs.append(ref.tobytes())
        q = ref[30:30 + lq].copy()
        q[rng.random(lq) < 0.02] = 1
        qs.append(q.tobytes())
        quals.append(rng.integers(5, 41, lq).astype(np.uint8).tobytes())
        bws.append(int(rng.integers(30, 45)))
    arrays, J = tpb.pad_batch(refs, qs, quals, bws=bws)
    assert J > 64
    a = [torch.from_numpy(x).to(card) for x in arrays]
    layout = {}
    got = tpb.probaln_cuda(*a, J + 3, d=1e-7, layout=layout)
    assert layout["warp_reads"] == 8
    want = tpb.probaln_plain(*a, J + 3, d=1e-7)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("flag", [0, 1, 2, 3, 5])
def test_realn_on_card_matches_cpu(card, flag):
    ref, recs = baq_case(120, seed=11, ref_len=30_000, n_long=3)
    a = [r.copy() for r in recs]
    b = [r.copy() for r in recs]
    _build.reset_launches()
    got = trl.sam_prob_realn_batch(a, ref, flag, device=card)
    assert _build.LAUNCHES["probaln"] + _build.LAUNCHES["probaln_warp"] >= 1
    assert got == trl.sam_prob_realn_batch(b, ref, flag, device="cpu")
    assert [r.to_bam_buffer() for r in a] == [r.to_bam_buffer() for r in b]


def test_mesh_steps_nccl_world_of_one(card):
    """The mesh steps (parallel/mesh.py, B1 inside the decode step) on
    cuda:0 as a world of one under NCCL, and as two gloo ranks whose
    compute runs on the card: the outputs of a gloo world of one on the
    CPU."""
    import torch_ranks
    from htslib_tpu_torch.parallel.launch import run_ranks
    x = torch_ranks.mesh_inputs(1)
    (want,) = run_ranks(torch_ranks.mesh_steps, 1, (x, "cpu"), timeout=240)
    (got,) = run_ranks(torch_ranks.mesh_steps, 1, (x, "cuda"),
                       backend="nccl", timeout=240)
    assert got["backend"] == "nccl" and got["device"].startswith("cuda")
    for key in ("cov", "bases", "flags", "counts", "halo"):
        assert np.array_equal(got[key], want[key]), key
    x2 = torch_ranks.mesh_inputs(2)
    cpu = run_ranks(torch_ranks.mesh_steps, 2, (x2, "cpu"), timeout=240)
    gpu = run_ranks(torch_ranks.mesh_steps, 2, (x2, "cuda"), timeout=240)
    for c, g in zip(cpu, gpu):
        assert g["device"].startswith("cuda") and g["timing"]["staging_s"] > 0
        for key in ("cov", "bases", "flags", "counts", "halo"):
            assert np.array_equal(g[key], c[key]), key


@pytest.mark.parametrize("version", [(3, 0), (3, 1)], ids=["3.0", "3.1"])
def test_cram_file_to_sam_on_card_matches_cpu(card, tmp_path, version):
    """CRAM -> SAM (cram/batch.py) with the rANS blocks decoded and the
    SAM formatted on the card: the CPU's text, each of the file's rANS
    wires launching its kernel."""
    from htslib_tpu_torch.cram import batch as tcb
    from htslib_tpu_torch.entry import dryrun_records
    from htslib_tpu_torch.sam.bam import BamWriter
    hdr, recs = dryrun_records(600, seed=8)
    bam, cram = str(tmp_path / "in.bam"), str(tmp_path / "x.cram")
    with BamWriter(bam, hdr, level=1) as w:
        for r in recs:
            w.write(r)
    tcb.bam_to_cram_file(bam, cram, version=version, seqs_per_slice=200)
    _build.reset_launches()
    timing = {}
    _, got = tcb.cram_file_to_sam(cram, device=card, timing=timing)
    wires = [w for w in timing["wires"] if w != "host"]
    assert wires
    for w in wires:
        k = tcb.WIRE_KERNELS[w]
        assert sum(_build.LAUNCHES.get(k.replace("_decode", r + "_decode"), 0)
                   for r in ("", "_large", "_dense")) >= 1, w
    assert _build.LAUNCHES["record_scan"] >= 1
    assert _build.LAUNCHES["nibble_to_base"] >= 1
    _, want = tcb.cram_file_to_sam(cram, device="cpu")
    assert got.tobytes() == want.tobytes()


def test_cram_decode_blocks_on_card_every_wire(card):
    """decode_blocks on the card over a block of every rANS wire (32-way
    Nx16 too, which the port's encoder does not write) and a PACK block
    that stays on the host: the host codec's bytes."""
    from htslib_tpu_torch.cram import batch as tcb
    from htslib_tpu_torch.cram.io import CramBlock
    from htslib_tpu_torch.cram.structs import CT_EXTERNAL, RANS, RANSPR
    rng = np.random.default_rng(13)
    qual = rng.integers(2, 42, 20000, dtype=np.uint8).tobytes()
    few = rng.integers(0, 4, 5000, dtype=np.uint8).tobytes()
    datas = [(RANS, qual, r8.compress(qual, 0)),
             (RANS, qual, r8.compress(qual, 1))]
    datas += [(RANSPR, qual, compress(qual, f)) for f in (0, 1, 4, 5)]
    datas.append((RANSPR, few, compress(few, 0x80)))
    blocks = [CramBlock(m, CT_EXTERNAL, i, len(d), len(raw), d)
              for i, (m, raw, d) in enumerate(datas)]
    counts = tcb.decode_blocks(blocks, device=card)
    assert counts["host"] == 1 and sum(counts.values()) == len(blocks)
    for b, (_, raw, _) in zip(blocks, datas):
        assert b._uncompressed == raw


def _leg12_bcf(tmp_path, n, samples, level, name):
    """chip_smoke.leg12_vcf(n, samples) as a BCF: written by the port's
    BcfWriter at `level`, or, at level None, without BGZF (the magic, the
    header and the record frames as they are)."""
    import struct

    from chip_smoke import leg12_vcf
    from htslib_tpu_torch.vcf import io as tio
    vcf = str(tmp_path / f"{name}.vcf")
    with open(vcf, "wb") as fp:
        fp.write(leg12_vcf(n, samples, seed=n))
    path = str(tmp_path / f"{name}.bcf")
    with tio.VcfReader(vcf) as r:
        recs = list(r)
        header = r.header
    if level is not None:
        with tio.BcfWriter(path, header, level=level) as w:
            for rec in recs:
                w.write(rec)
        return path
    head = header.text(with_idx=True).encode() + b"\0"
    with open(path, "wb") as fp:
        fp.write(tio.BCF_MAGIC + struct.pack("<I", len(head)) + head)
        for rec in recs:
            shared, indiv = rec.to_bcf()
            fp.write(struct.pack("<II", len(shared), len(indiv)) + shared
                     + indiv)
    return path


@pytest.mark.parametrize("level", [6, 0])
def test_bcf_file_to_vcf_on_card_matches_cpu(card, tmp_path, level):
    """BCF -> VCF with the members inflated on the card (X4): the CPU's
    header and text.  Level 6 has deflated members (small, for the CPU's
    plain inflate), level 0 stored ones over several members."""
    from htslib_tpu_torch.vcf.io import bcf_file_to_vcf
    path = _leg12_bcf(tmp_path, 60 if level else 600, 8, level, "f")
    _build.reset_launches()
    timing = {}
    header, got = bcf_file_to_vcf(path, device=card, timing=timing)
    assert _build.LAUNCHES["inflate"] == 1
    assert set(timing) == {"read_s", "inflate_s", "frame_s", "format_s"}
    want_h, want = bcf_file_to_vcf(path, device="cpu")
    assert got == want and got.count(b"\n") == (60 if level else 600)
    assert header.text(with_idx=True) == want_h.text(with_idx=True)


def test_bcf_shards_on_card_match_cpu(card, tmp_path):
    """plan_bcf_shards and each shard's decode on the card: the CPU's
    plan and text, and the shards in order the whole file's."""
    from htslib_tpu_torch.parallel import distributed as td
    from htslib_tpu_torch.vcf.io import bcf_file_to_vcf
    path = _leg12_bcf(tmp_path, 600, 8, 0, "s")
    plan = td.plan_bcf_shards(path, 3, device=card)
    cpu = td.plan_bcf_shards(path, 3, device="cpu")
    assert plan.shards == cpu.shards and len(plan.coffsets) > 2
    assert np.array_equal(plan.offs, cpu.offs)
    _build.reset_launches()
    parts = [td.decode_bcf_shard_to_vcf(plan, sh, device=card)
             for sh in plan.shards]
    assert _build.LAUNCHES["inflate"] == 3
    assert parts == [td.decode_bcf_shard_to_vcf(cpu, sh, device="cpu")
                     for sh in cpu.shards]
    assert b"".join(parts) == bcf_file_to_vcf(path, device="cpu")[1]


def test_uncompressed_bcf_on_card_launches_nothing(card, tmp_path):
    """A BCF without BGZF: the card's text is the CPU's, and neither the
    whole-file decode nor the plan and its shards launch X4."""
    from htslib_tpu_torch.parallel import distributed as td
    from htslib_tpu_torch.vcf.io import bcf_file_to_vcf
    path = _leg12_bcf(tmp_path, 300, 8, None, "u")
    _build.reset_launches()
    got = bcf_file_to_vcf(path, device=card)[1]
    plan = td.plan_bcf_shards(path, 2, device=card)
    parts = [td.decode_bcf_shard_to_vcf(plan, sh, device=card)
             for sh in plan.shards]
    assert _build.LAUNCHES["inflate"] == 0
    assert got == bcf_file_to_vcf(path, device="cpu")[1] == b"".join(parts)


@pytest.mark.parametrize("level", [6, 0])
def test_bam_file_to_sam_on_card_matches_cpu(card, tmp_path, level):
    """bam_file_to_sam on the card (X4, X5, B1), from a path and from a
    URL served on 127.0.0.1, equals device="cpu" (the plain versions) on
    leg 8's varied records and a CG long-CIGAR record; a stored file
    still launches X4 (its members are inflated as stored blocks)."""
    import struct

    from chip_smoke import LEG8_REFS, RangeServer, varied_bam_stream
    from htslib_tpu_torch.bgzf import BgzfWriter
    from htslib_tpu_torch.sam import batch as sb
    from htslib_tpu_torch.sam.bam import write_bam_header
    from htslib_tpu_torch.sam.header import SamHeader
    from htslib_tpu_torch.sam.record import BamRecord, encode_aux
    cg = BamRecord()
    cg.qname, cg.tid, cg.pos, cg.flag = b"cg", 0, 99, 0
    cg.set_seq("ACGTACGTAC", bytes(range(10, 20)))
    cg.cigar = np.array([(10 << 4) | 4, (500 << 4) | 3], np.uint32)
    cg.aux = encode_aux(b"CG", "B", ("I", np.array(
        [(4 << 4) | 0, (70000 << 4) | 3, (6 << 4) | 0], np.uint32)))
    body = cg.to_bam_buffer()
    payload = (varied_bam_stream(3000, seed=5)
               + struct.pack("<I", len(body)) + body)
    path = str(tmp_path / "v.bam")
    with BgzfWriter(path, level=level) as w:
        write_bam_header(w, SamHeader("".join(
            f"@SQ\tSN:{r}\tLN:300000000\n" for r in LEG8_REFS)))
        w.write(payload)
    want = sb.bam_file_to_sam(path, device="cpu")[1].tobytes()
    assert b"\t4M70000N6M\t" in want
    with RangeServer(str(tmp_path)) as srv:
        for src in (path, srv.url("v.bam")):
            _build.reset_launches()
            timing = {}
            _, got = sb.bam_file_to_sam(src, device=card, timing=timing)
            assert got.tobytes() == want
            assert _build.LAUNCHES["nibble_to_base"] >= 1
            assert (_build.LAUNCHES["inflate"]
                    + _build.LAUNCHES["inflate_slot"]) == 1
            assert (_build.LAUNCHES["record_scan"]
                    + _build.LAUNCHES["record_scan_seg"]) == 1
            assert {"read_s", "inflate_s", "format_s"} <= set(timing)


@pytest.fixture(scope="module")
def pileup_case(tmp_path_factory):
    """chip_smoke's leg 16 files over 8 kb and 2 kb (about 3,000 reads),
    the BAM deflated at zlib level 6 and stored (level 0), with the
    first 800 records as a BAM and a SAM of their own; and each file's
    mpileup_text on the CPU, once for the module (the CPU's plain
    inflate takes a second or more a deflated member)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from chip_smoke import write_leg16_files
    from htslib_tpu_torch import pileup
    out = {}
    for level in (0, 6):
        d = tmp_path_factory.mktemp(f"plp{level}")
        paths = write_leg16_files(str(d), [("chr1", 8_000),
                                           ("chr2", 2_000)], level, 800)
        out[level] = {k: (paths[k], pileup.mpileup_text(
            paths[k], device="cpu")[1])
            for k in ("bam", "small_bam", "small_sam")}
    return out


def _x4(launches):
    return launches["inflate"] + launches["inflate_slot"]


@pytest.mark.parametrize("level", [0, 6])
def test_pileup_mpileup_text_on_card_matches_cpu(card, pileup_case, level):
    """mpileup_text on the card (X4, X5, B1) equals device="cpu" on a
    BAM and on SAM text, and each launches its kernels once."""
    from htslib_tpu_torch import pileup
    for key, (path, want) in pileup_case[level].items():
        _build.reset_launches()
        timing = {}
        got = pileup.mpileup_text(path, device=card, timing=timing)[1]
        assert got == want and got.count(b"\n") > 1000
        assert _x4(_build.LAUNCHES) == (0 if key == "small_sam" else 1)
        assert (_build.LAUNCHES["record_scan"]
                + _build.LAUNCHES["record_scan_seg"]) == 1
        assert _build.LAUNCHES["nibble_to_base"] == 1
        assert timing["entries"] > 0 and timing["bases_s"] > 0


@pytest.mark.parametrize("nthreads", [1, 3, 8])
def test_pileup_parallel_on_card_matches_cpu(card, pileup_case, nthreads):
    """mpileup_text_parallel with the read and decode on the card and the
    tiles in spawned processes equals the serial text on the CPU; its
    plan is plan_tiles over the CPU's decode."""
    from htslib_tpu_torch import pileup
    from htslib_tpu_torch.sam.batch import read_bam_stream
    path, want = pileup_case[6]["bam"]
    st = {}
    _build.reset_launches()
    got = pileup.mpileup_text_parallel(path, nthreads, device=card,
                                       stages=st)[1]
    pileup.shutdown_pool()
    assert got == want
    rs = pileup.decode_records(read_bam_stream(
        pileup_case[0]["bam"][0], "cpu")[1], "cpu")
    assert st["tiles"] == pileup.plan_tiles(rs, nthreads,
                                            pileup.DEFAULT_SKIP)[0]
    assert 1 <= len(st["tiles"]) <= nthreads
    assert _x4(_build.LAUNCHES) == 1
    assert _build.LAUNCHES["nibble_to_base"] == 1


def test_pileup_decode_records_on_card_matches_cpu(card, pileup_case):
    from htslib_tpu_torch import pileup
    from htslib_tpu_torch.sam.batch import read_bam_stream
    _, stream = read_bam_stream(pileup_case[6]["bam"][0], device=card)
    got = pileup.decode_records(stream, card)
    want = pileup.decode_records(stream, "cpu")
    assert set(got) == set(want)
    for k in got:
        if isinstance(got[k], bytes):
            assert got[k] == want[k], k
        else:
            assert np.array_equal(got[k], want[k]), k
    with pytest.raises(IOError, match="truncated"):
        pileup.decode_records(stream[:-3], card)


def test_pileup_device_counts_on_card_match_cpu(card, pileup_case):
    """device_pileup_counts on the card equals its CPU run for each whole
    reference of leg 16's reads."""
    from htslib_tpu_torch.ops.pileup_kernel import device_pileup_counts
    from htslib_tpu_torch.pileup import DEFAULT_SKIP, read_records
    _, recs = read_records(pileup_case[6]["bam"][0], False, card,
                           DEFAULT_SKIP)
    for tid, ln in ((0, 8_000), (1, 2_000)):
        mine = [b for b in recs if b.tid == tid]
        d_dev, c_dev = device_pileup_counts(mine, 0, ln, device=card)
        d_cpu, c_cpu = device_pileup_counts(mine, 0, ln, device="cpu")
        assert np.array_equal(d_dev, d_cpu) and np.array_equal(c_dev, c_cpu)
        assert d_dev.max() > 20


# -- the last slice: P1, P2 and the functions over X4, B7, X1, X5, B1, X6 --

@pytest.mark.parametrize("seed,rounds", [(7, 512), (3, 1), (5, 0)])
def test_resolve_cmp_kernel_matches_plain(card, seed, rounds):
    from htslib_tpu_torch import probe_pallas_gather as pg
    cum, freqs, _packed, x0 = (torch.from_numpy(a).to(card)
                               for a in pg.make_inputs(seed))
    before = _build.LAUNCHES["resolve_cmp"]
    got = pg.resolve_cmp(cum, freqs, x0, rounds, device=card)
    assert _build.LAUNCHES["resolve_cmp"] == before + 1
    assert torch.equal(got, pg.resolve_cmp_plain(cum, freqs, x0, rounds))
    bad = freqs.clone()
    bad[0, 0] += 1
    with pytest.raises(ValueError, match="normalised"):
        pg.resolve_cmp_cuda(cum, bad, x0, rounds)


@pytest.fixture(scope="module")
def ablate_case():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from htslib_tpu_torch import probe_rans_ablate as pa
    raws = pa.quality_streams(n=5, size=96 * pa.NWAY, seed=9)
    return raws, pa.make_batch(raws, "cuda")


@pytest.mark.parametrize("mode", ["full", "no_select", "no_resolve",
                                  "no_scan", "only_loop", "slice_cost"])
def test_rans_ablate_kernel_matches_plain(card, ablate_case, mode):
    from htslib_tpu_torch import probe_rans_ablate as pa
    raws, b = ablate_case
    before = _build.LAUNCHES[pa.launch_key(mode)]
    got = pa.ablate(b, mode, 96)
    assert _build.LAUNCHES[pa.launch_key(mode)] == before + 1
    for g, w in zip(got, pa.ablate_plain(b, mode, 96)):
        assert torch.equal(g, w)
    if mode == "full":
        assert np.array_equal(got[0].cpu().numpy(), pa.raw_symbols(raws, 96))


def test_rans_ablate_refuses_a_mono_table(card):
    from htslib_tpu_torch import probe_rans_ablate as pa
    b = pa.make_batch([bytes([5]) * (8 * pa.NWAY)], card)
    with pytest.raises(ValueError, match="one symbol"):
        pa.ablate(b, "full", 8)
    got = pa.ablate(b, "only_loop", 8)
    assert torch.equal(got[0], pa.ablate_plain(b, "only_loop", 8)[0])


@pytest.mark.parametrize("mode", ["full", "no_select", "no_resolve",
                                  "no_scan", "only_loop", "slice_cost"])
def test_rans_ablate_kernel_matches_plain_where_cursors_spread(card, mode):
    """A table of one slot's symbol beside one of 4,095 slots: the lanes
    that start on the small symbol refill almost every round, the others
    never, so no_scan's cursors spread past the ring's reach (its rounds
    then read device memory); stream 0 starts at an odd word, stream 1
    runs past its end."""
    from htslib_tpu_torch import probe_rans_ablate as pa
    from htslib_tpu_torch.ops.rans_nx16 import Nx16Batch
    rng = np.random.default_rng(5)
    n = [8192, 100, 3000]
    words = np.zeros(1 + sum(n) + 1, np.uint16)
    off = np.array([1, 1 + n[0], 1 + n[0] + n[1]], np.int64)
    words[off[0]:off[0] + n[0]] = 0xFFFF
    words[off[2]:off[2] + n[2]] = rng.integers(0, 1 << 16, n[2])
    freqs = np.zeros((3, 256), np.int32)
    freqs[:, 2], freqs[:, 3] = 4095, 1
    x0 = np.where(np.arange(32) % 2, (1 << 16) + 4095, 1 << 30)
    arrays = (words.view(np.uint8), off, np.array(n, np.int32), freqs,
              np.tile(x0, (3, 1)).astype(np.int32), np.zeros(3, np.int32),
              np.zeros(3, np.int64))
    b = Nx16Batch(*(torch.from_numpy(a).to(card) for a in arrays))
    want = pa.ablate_plain(b, mode, 4096)
    if mode == "no_scan":
        cur = want[2].view(3, 32)[0]
        assert int(cur.max() - cur.min()) > 2048
    for g, w in zip(pa.ablate(b, mode, 4096), want):
        assert torch.equal(g, w)


def _bgzf_file(path, seed=12, level=6):
    from htslib_tpu_torch import bgzf as tbgzf
    rng = np.random.default_rng(seed)
    text = b"".join(b"chr1\t%d\t%s\n" % (i, bytes(rng.integers(
        65, 70, int(rng.integers(1, 40)), dtype=np.uint8)))
        for i in range(20000))
    chunks = [text[i:i + tbgzf.BGZF_BLOCK_SIZE]
              for i in range(0, len(text), tbgzf.BGZF_BLOCK_SIZE)]
    with open(path, "wb") as fp:
        fp.write(b"".join(tbgzf.deflate_blocks(chunks, level))
                 + tbgzf.BGZF_EOF)
    return text


def test_inflate_blocks_on_card(card, tmp_path):
    from htslib_tpu_torch import bgzf as tbgzf
    text = _bgzf_file(str(tmp_path / "t.gz"))
    raw = np.fromfile(str(tmp_path / "t.gz"), np.uint8)
    before = _build.LAUNCHES["inflate"] + _build.LAUNCHES["inflate_slot"]
    out, table = tbgzf.inflate_blocks(raw, device=card)
    assert out.tobytes() == text and table.n > 5
    assert (_build.LAUNCHES["inflate"] + _build.LAUNCHES["inflate_slot"]
            == before + 1)
    bad = raw.copy()
    bad[int(table.csizes[0]) - 8] ^= 1
    with pytest.raises(IOError, match="CRC32"):
        tbgzf.inflate_blocks(bad, device=card)


def test_bgzip_cli_on_card(card, tmp_path, monkeypatch):
    from htslib_tpu_torch.cli import bgzip
    text = _bgzf_file(str(tmp_path / "t.txt.gz"))
    monkeypatch.setattr(bgzip, "BATCH", 3)      # members a device call
    before = _build.LAUNCHES["inflate"] + _build.LAUNCHES["inflate_slot"]
    assert bgzip.main(["-t", str(tmp_path / "t.txt.gz")], device=card) == 0
    assert bgzip.main(["-d", "-k", str(tmp_path / "t.txt.gz")],
                      device=card) == 0
    assert (tmp_path / "t.txt").read_bytes() == text
    from htslib_tpu_torch.bgzf import read_file, scan_blocks
    n = -(-scan_blocks(read_file(str(tmp_path / "t.txt.gz"))).n // 3)
    assert (_build.LAUNCHES["inflate"] + _build.LAUNCHES["inflate_slot"]
            - before) == 2 * n


def test_cram_file_to_bam_stream_on_card(card, tmp_path, monkeypatch):
    """11a-style CRAM 3.0 at 300 records: the stream decoded on the card
    equals the host decode's (the port's host codecs)."""
    import chip_smoke
    from htslib_tpu_torch.cram.batch import (bam_to_cram_file,
                                             cram_file_to_bam_stream,
                                             iter_slice_blobs)
    from htslib_tpu_torch.cram import CramReader
    monkeypatch.setattr(chip_smoke, "N_CRAM", 300)
    monkeypatch.setattr(chip_smoke, "N_CRAM31", 10)
    fasta, bam, _ = chip_smoke.leg11_inputs(str(tmp_path))
    path = str(tmp_path / "a.cram")
    bam_to_cram_file(bam, path, ref=fasta, seqs_per_slice=100)
    _, blob = cram_file_to_bam_stream(path, ref=fasta, device=card)
    host = b"".join(chip_smoke._host_cram_truth(path, fasta, off, True)[2]
                    for off, _ in chip_smoke.cram_containers(path))
    assert blob == host and len(blob) > 10000
    with CramReader(path, ref=fasta) as r:
        assert b"".join(iter_slice_blobs(r, window=2, device=card)) == blob


def test_probaln_flags_on_card_match_plain(card, monkeypatch):
    """Kernel X6's MAP flags, from both launches, equal the plain
    version's on a batch that holds flagged bases; probaln_glocal on the
    card raises on a read exactly where it raises on the CPU."""
    monkeypatch.setattr(tpb, "THREAD_MIN_READS", 16)
    long_r = hmm_reads(8, 1500, 3)
    short_r = hmm_reads(60, 100, 4)
    refs, qs, quals, bws = [x + y for x, y in zip(long_r, short_r)]
    arrays, J = tpb.pad_batch(refs, qs, quals, bws=bws)
    a = [torch.from_numpy(x).to(card) for x in arrays]
    want = torch.zeros(a[2].shape, dtype=torch.uint8, device=card)
    got = torch.zeros_like(want)
    tpb.probaln_plain(*a, J, d=1e-7, flag=want)
    layout = {}
    tpb.probaln_cuda(*a, J, d=1e-7, layout=layout, flag=got)
    assert layout == {"warp_reads": 8, "thread_reads": 60}
    assert torch.equal(got, want) and bool(want.any())
    raised = 0
    for r, q, iq, bw in zip(refs[8:20], qs[8:20], quals[8:20], bws[8:20]):
        c = trl.ProbalnParams(1e-7, 0.1, bw)
        try:
            trl.probaln_glocal(r, q, iq, c, device="cpu")
        except (ValueError, ZeroDivisionError) as err:
            raised += 1
            with pytest.raises(type(err)):
                trl.probaln_glocal(r, q, iq, c, device=card)
            continue
        trl.probaln_glocal(r, q, iq, c, device=card)
    assert raised > 0


def test_probaln_glocal_on_card_matches_cpu(card):
    rng = np.random.default_rng(21)
    for _ in range(20):
        lq = int(rng.integers(5, 120))
        ref = rng.integers(0, 4, lq + 12).astype(np.uint8).tobytes()
        q = ref[4:4 + lq]
        qual = rng.integers(5, 40, lq).astype(np.uint8).tobytes()
        c = trl.ProbalnParams(0.001, 0.1, int(rng.integers(3, 12)))
        assert trl.probaln_glocal(ref, q, qual, c, device=card) == \
            trl.probaln_glocal(ref, q, qual, c, device="cpu")
