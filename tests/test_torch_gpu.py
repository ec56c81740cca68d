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

from chip_smoke import enc_edge_streams, wide_stream
from htslib_tpu_torch.codecs import rans4x8 as r8
from htslib_tpu_torch.codecs.rans4x16 import compress
from htslib_tpu_torch.entry import entry
from htslib_tpu_torch.ops import device_stats as tds
from htslib_tpu_torch.ops import huffman as th
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
    b = o1.frame_o1_streams([o1._parse_o1_header(e) for e in encs], card)
    offs = torch.arange(b.n_streams, dtype=torch.int32, device=card)
    for mr in (-1, 700):
        got = o1.rans_o1(b, max_rounds=mr, offs=offs, qbins=qbins)
        want = o1.rans_o1_plain(b, max_rounds=mr, offs=offs, qbins=qbins)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def _o1_batch(datas, dev):
    return o1.frame_o1_streams(
        [o1._parse_o1_header(compress(d, 0x05)) for d in datas], dev)


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
    b = t8.frame_4x8([r8.compress(_walk(np.random.default_rng(1), 99), 1)],
                     True, card)
    with pytest.raises(ValueError, match="no kernel"):
        t8.rans4x8(b)


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
