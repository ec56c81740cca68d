"""The port's quality decode->histogram lane (htslib_tpu_torch/ops/
device_stats.py, kernel B3's plain version on the CPU) against the JAX
package's device_stats in Pallas interpret mode, the host histogram and a
per-record bincount.  Counts are integers: equality is exact."""
import json
import os

import jax
import numpy as np
import pytest

from htslib_tpu.codecs import rans4x8
from htslib_tpu.codecs.rans4x16 import compress, uncompress
from htslib_tpu.cram import CramReader, CramWriter
from htslib_tpu.ops import device_stats as jds
from htslib_tpu.ops import rans_o1_pallas as jo1
from htslib_tpu.sam import SamHeader
from htslib_tpu.sam.cigar import parse_cigar
from htslib_tpu.sam.record import BamRecord
from htslib_tpu_torch.cram import CRAM_EOF_START
from htslib_tpu_torch.cram.io import CramBlock as TBlock
from htslib_tpu_torch.cram.io import CramIO, read_file_definition
from htslib_tpu_torch.cram.structs import ARITH, RANS, RANSPR
from htslib_tpu_torch.cram.structs import CT_EXTERNAL as CT_EXT
from htslib_tpu_torch.ops import device_stats as tds

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "htslib_tpu_torch", "testdata", "qual_o0.cram")


@pytest.fixture(autouse=True, scope="module")
def _jax_32bit():
    """The JAX reference runs in its default 32-bit mode; another test
    module in the same worker process may have switched JAX to 64-bit."""
    jax.config.update("jax_enable_x64", False)


def write_qual_cram(path, n=3000, read_len=100, tail_len=30, seed=7,
                    seqs_per_slice=1000, version=(3, 1),
                    device_profile=True, qual=None):
    """A CRAM of n seeded records of read_len with qualities uniform over
    20..40 (so the device profile pins QS to the Nx16 O0 32-way wire),
    plus one record of tail_len alone in the last slice (its QS block is
    too short to pin and is stored for the host).  `qual(rng, i, ln)`,
    where given, makes record i's qualities instead.  The committed
    fixture is write_qual_cram(FIXTURE)."""
    rng = np.random.default_rng(seed)
    hdr = SamHeader("@HD\tVN:1.6\tSO:coordinate\n"
                    "@SQ\tSN:chr1\tLN:1000000\n")
    starts = np.sort(rng.integers(0, 900_000, n + 1))
    with CramWriter(path, hdr, version=version,
                    seqs_per_slice=seqs_per_slice,
                    device_profile=device_profile) as w:
        for i in range(n + 1):
            ln = read_len if i < n else tail_len
            r = BamRecord()
            r.qname = f"q{i:06d}".encode()
            r.tid = 0
            r.pos = int(starts[i])
            r.flag = 0
            r.mapq = 60
            r.cigar = parse_cigar(f"{ln}M")
            seq = "".join(rng.choice(list("ACGT"), ln))
            r.set_seq(seq, qual(rng, i, ln) if qual else
                      bytes(rng.integers(20, 41, ln, dtype=np.uint8)))
            w.write(r)


def read_walks(rng, n, read=100):
    """Quality-like bytes: bounded random walks over 2..41, one per
    read of `read` symbols."""
    k = -(-n // read)
    q = np.clip(rng.integers(25, 38, (k, 1))
                + np.cumsum(rng.integers(-2, 3, (k, read)), axis=1), 2, 41)
    return q.reshape(-1)[:n].astype(np.uint8).tobytes()


def walk_quals(rng, i, ln):
    """Correlated qualities: a bounded random walk over 2..41."""
    steps = np.concatenate([[rng.integers(25, 38)],
                            rng.integers(-2, 3, ln - 1)])
    return bytes(np.clip(np.cumsum(steps), 2, 41).astype(np.uint8))


def binned_quals(rng, i, ln, sticky=False):
    """Qualities binned to 4 levels (as on 4-level instruments): drawn
    apart, or `sticky`, each repeating the last with probability 0.9."""
    levels = np.array([2, 12, 23, 37], np.uint8)
    draw = rng.choice(4, ln, p=[0.05, 0.1, 0.25, 0.6])
    if sticky:
        keep = rng.random(ln) < 0.9
        for k in range(1, ln):
            if keep[k]:
                draw[k] = draw[k - 1]
    return bytes(levels[draw])


def _by_slice(gens, per_slice):
    """Quality generator choosing gens[slice % len(gens)] by the record's
    slice."""
    def qual(rng, i, ln):
        return gens[(i // per_slice) % len(gens)](rng, i, ln)
    return qual


FIXTURE_SLICE = 300   # records per slice of the order-1/4x8/STRIPE fixtures


def write_o1_cram(path):
    """CRAM 3.1 with the device profile whose QS blocks are Nx16 O1
    (0x05): correlated qualities make order 1 the smaller wire."""
    write_qual_cram(path, seed=17, seqs_per_slice=FIXTURE_SLICE,
                    qual=walk_quals)


def write_v30_cram(path):
    """Vanilla CRAM 3.0 (no write profile) whose QS blocks are rANS 4x8:
    slices alternate uniform qualities (order 0 wins) and correlated
    ones (order 1 wins); the writer trials its codecs on every container
    so that each slice gets its own winner."""
    from htslib_tpu.cram.encode import CodecMetrics
    every = CodecMetrics.TRIAL_EVERY
    CodecMetrics.TRIAL_EVERY = 1
    try:
        write_qual_cram(path, seed=23, seqs_per_slice=FIXTURE_SLICE,
                        version=(3, 0), device_profile=False,
                        qual=_by_slice([uniform_quals, walk_quals],
                                       FIXTURE_SLICE))
    finally:
        CodecMetrics.TRIAL_EVERY = every


def uniform_quals(rng, i, ln):
    return bytes(rng.integers(20, 41, ln, dtype=np.uint8))


def write_stripe_pack_cram(path):
    """CRAM 3.1 with the device profile, its 32-way QS wires turned into
    STRIPE (0x0C/0x0D) where the slice has more than 16 quality values
    and into PACK (0x84/0x85) where it has at most 16: slices cycle
    uniform, correlated, 4-level and sticky 4-level qualities."""
    from htslib_tpu.cram import encode
    real = encode._rans4x16_compress

    def stripe_or_pack(data, flags):
        if flags in (0x04, 0x05):
            flags |= 0x80 if len(set(data)) <= 16 else 0x08
        return real(data, flags)

    encode._rans4x16_compress = stripe_or_pack
    try:
        write_qual_cram(path, seed=29, seqs_per_slice=FIXTURE_SLICE,
                        qual=_by_slice([
                            uniform_quals, walk_quals, binned_quals,
                            lambda rng, i, ln: binned_quals(rng, i, ln,
                                                            True)],
                            FIXTURE_SLICE))
    finally:
        encode._rans4x16_compress = real


def per_record_hist(path):
    want = np.zeros(tds.QBINS, np.int64)
    with CramReader(path) as r:
        for rec in r:
            q = np.minimum(np.frombuffer(bytes(rec.qual), np.uint8),
                           tds.QBINS - 1)
            want += np.bincount(q, minlength=tds.QBINS)
    return want


def _walk(rng, n):
    return np.clip(np.cumsum(rng.integers(-2, 3, n)) + 20, 0,
                   44).astype(np.uint8).tobytes()


@pytest.mark.parametrize("case", ["offsets", "qbins256"])
def test_qualstats_device_matches_jax(case):
    rng = np.random.default_rng(11)
    datas = [rng.integers(0, 45, 3000 + 777 * i, dtype=np.uint8).tobytes()
             for i in range(3)]
    datas += [_walk(rng, 2500), bytes([23]) * 700 + bytes(range(64)),
              rng.integers(30, 90, 45, dtype=np.uint8).tobytes()]
    encs = [compress(d, 0x04) for d in datas]
    if case == "offsets":
        offsets, qbins = [0, 5, 33, 0, 10, 40], tds.QBINS
    else:
        offsets, qbins = None, 256
    got, timing = tds.qualstats_device(encs, device="cpu", offsets=offsets,
                                       qbins=qbins)
    ref, _ = jds.qualstats_device(encs, interpret=True, offsets=offsets,
                                  qbins=qbins)
    offs = offsets or [0] * len(datas)
    truth = np.stack([np.bincount(np.clip(np.frombuffer(d, np.uint8)
                                          .astype(np.int64) - o, 0,
                                          qbins - 1), minlength=qbins)
                      for d, o in zip(datas, offs)])
    assert got.dtype == np.int64 and got.shape == (len(datas), qbins)
    assert np.array_equal(got, truth)
    assert np.array_equal(got, ref)
    assert timing["uncompressed_bytes"] == sum(len(d) for d in datas)
    assert np.array_equal(tds.qualstats_host(datas),
                          jds.qualstats_host(datas))


def test_qualstats_device_rejects_other_wires():
    enc = compress(bytes(range(40)) * 10, 0x05)
    for fn in (lambda: tds.qualstats_device([enc], device="cpu"),
               lambda: jds.qualstats_device([enc], interpret=True)):
        with pytest.raises(ValueError, match="plain 32-way O0 only"):
            fn()


def test_cram_qual_hist_matches_jax(tmp_path):
    path = str(tmp_path / "dev.cram")
    write_qual_cram(path, n=400, seqs_per_slice=200, seed=3)
    stats, jstats = {}, {}
    got = tds.cram_qual_hist(path, device="cpu", stats=stats)
    ref = jds.cram_qual_hist(path, interpret=True, stats=jstats)
    assert stats == jstats
    assert stats["device_blocks"] > 0 and stats["host_blocks"] > 0
    assert np.array_equal(got, ref)
    assert np.array_equal(got, per_record_hist(path))


def test_committed_fixture(tmp_path):
    """The fixture is what write_qual_cram writes, and its committed
    histogram and block counts are what both packages and a per-record
    bincount give."""
    fresh = str(tmp_path / "fresh.cram")
    write_qual_cram(fresh)
    with open(fresh, "rb") as a, open(FIXTURE, "rb") as b:
        assert a.read() == b.read()
    with open(FIXTURE + ".hist.json") as fp:
        want = json.load(fp)
    stats, jstats = {}, {}
    got = tds.cram_qual_hist(FIXTURE, device="cpu", stats=stats)
    ref = jds.cram_qual_hist(FIXTURE, interpret=True, stats=jstats)
    assert got.tolist() == want["hist"]
    assert np.array_equal(ref, got)
    assert np.array_equal(per_record_hist(FIXTURE), got)
    assert stats == jstats == {"device_blocks": want["device_blocks"],
                               "host_blocks": want["host_blocks"]}
    assert stats["device_blocks"] > 0


def test_cram_qual_hist_4x8_raises(tmp_path):
    """CRAM 3.0 QS blocks (rANS 4x8) no longer raise: they count on the
    device lane (kernel B8), and a QS block under ARITH, which the lane
    leaves on the host, decodes with the port's codec to the JAX codec's
    bytes (no host codec raises any more)."""
    from htslib_tpu.codecs import arith as jarith
    from htslib_tpu.cram.io import CramBlock
    path = str(tmp_path / "v30.cram")
    write_qual_cram(path, n=300, seqs_per_slice=200, version=(3, 0),
                    device_profile=False)
    stats = {}
    got = tds.cram_qual_hist(path, device="cpu", stats=stats)
    assert np.array_equal(got, per_record_hist(path))
    assert stats["device_blocks"] > 0
    d = read_walks(np.random.default_rng(4), 3000)
    comp = jarith.compress(d, 0)
    args = (ARITH, CT_EXT, tds.QS_CONTENT_ID, len(comp), len(d), comp)
    assert tds.qs_route(ARITH, comp) == (None, None)
    assert TBlock(*args).uncompress() == CramBlock(*args).uncompress() == d


def jax_route(method, raw):
    """The JAX cram_qual_hist's routing of one QS block
    (htslib_tpu/ops/device_stats.py:773-832), through the JAX package's
    own helpers: the lane name the port uses, or None for the host."""
    def o1_ok(stream):
        jo1.o1_pads([jo1._parse_o1_header(stream)])

    try:
        if method == RANSPR and len(raw) > 1:
            f = raw[0]
            if f == 0x04:
                return "nx16_o0"
            if f == 0x05:
                o1_ok(raw)
                return "nx16_o1"
            if f & 0x08 and not f & 0xF0:
                for sub, is_o1 in jds._stripe_rewrap(raw):
                    if is_o1:
                        o1_ok(sub)
                return "stripe"
            if f in (0x84, 0x85):
                core = jds._pack_rewrap(raw)[4]
                if f == 0x85:
                    o1_ok(core)
                return "pack"
        elif method == RANS and len(raw) > 9 and raw[0] == 0:
            return "4x8_o0"
        elif method == RANS and len(raw) > 9 and raw[0] == 1:
            nrows = int((jds._parse_4x8_o1(raw)[1] > 0).sum())
            a2 = 8
            while a2 < nrows:
                a2 <<= 1
            if a2 > jo1.A2_MAX:
                raise ValueError("too dense")
            return "4x8_o1"
    except ValueError:
        pass
    return None


# the kernel each device lane of the port runs
LANE_KERNEL = {"nx16_o0": "B3", "nx16_o1": "B6", "stripe": "STRIPE over B3/B6",
               "pack": "PACK over B3/B6", "4x8_o0": "B8", "4x8_o1": "B8"}


def _wire(name, rng):
    d = _walk(rng, 4000)
    four = bytes(rng.integers(0, 4, 4000, dtype=np.uint8))
    dense = bytes(rng.integers(0, 256, 20000, dtype=np.uint8))
    return {
        "o0": lambda: (RANSPR, compress(d, 0x04)),
        "o1": lambda: (RANSPR, compress(d, 0x05)),
        "o1_dense": lambda: (RANSPR, compress(dense, 0x05)),
        "stripe": lambda: (RANSPR, compress(d, 0x0C)),
        "stripe_o1": lambda: (RANSPR, compress(d, 0x0D)),
        "stripe_4way": lambda: (RANSPR, compress(d, 0x08)),
        "stripe_o1_dense": lambda: (RANSPR, compress(dense, 0x0D)),
        "pack": lambda: (RANSPR, compress(four, 0x84)),
        "pack_o1": lambda: (RANSPR, compress(four, 0x85)),
        "pack_const": lambda: (RANSPR, compress(bytes(4000), 0x84)),
        "pack_rle": lambda: (RANSPR, compress(four, 0xC4)),
        "4x8_o0": lambda: (RANS, rans4x8.compress(d, 0)),
        "4x8_o1": lambda: (RANS, rans4x8.compress(d, 1)),
        "4x8_o1_dense": lambda: (RANS, rans4x8.compress(dense, 1)),
        "4x8_tiny": lambda: (RANS, rans4x8.compress(b"ab", 0)[:9]),
        "o0_4way": lambda: (RANSPR, compress(d, 0x00)),
        "o1_4way": lambda: (RANSPR, compress(d, 0x01)),
        "rle": lambda: (RANSPR, compress(d, 0x44)),
        "cat": lambda: (RANSPR, compress(d, 0x24)),
        "gzip": lambda: (1, d),
    }[name]()


@pytest.mark.parametrize("wire,method,kernel", [
    ("o1", RANSPR, "B6"),
    ("stripe", RANSPR, "STRIPE"),
    ("pack", RANSPR, "PACK"),
    ("4x8_o0", RANS, "B8"),
    ("4x8_o1", RANS, "B8"),
    ("o0_4way", RANSPR, None),
    ("o1_4way", RANSPR, None),
])
def test_routing_names_unported_kernel(wire, method, kernel):
    """Each QS wire routes as the JAX function routes it: to the device
    lane whose kernel is named (all ported now), or, for None, to the
    host."""
    m, raw = _wire(wire, np.random.default_rng(5))
    assert m == method
    lane, _ = tds.qs_route(method, raw)
    assert lane == jax_route(method, raw)
    if kernel is None:
        assert lane is None
    else:
        assert kernel in LANE_KERNEL[lane]


@pytest.mark.parametrize("wire", ["o0", "o1_dense", "stripe_o1",
                                  "stripe_4way", "stripe_o1_dense",
                                  "pack_o1", "pack_const", "pack_rle",
                                  "4x8_o1_dense", "4x8_tiny", "rle", "cat",
                                  "gzip"])
def test_routing_matches_jax(wire):
    """The port's block routing (device lane or host) equals the JAX
    function's on the wires at the edges of its gates."""
    method, raw = _wire(wire, np.random.default_rng(6))
    lane, item = tds.qs_route(method, raw)
    assert lane == jax_route(method, raw)
    assert (lane is None) == (item is None)


def _rewrap_inputs():
    rng = np.random.default_rng(12)
    d = _walk(rng, 3001)
    four = bytes(rng.integers(0, 4, 2999, dtype=np.uint8))
    two = bytes(rng.choice([7, 40], 1001).astype(np.uint8))
    sixteen = bytes(rng.integers(0, 16, 777, dtype=np.uint8))
    return {"stripe": [compress(d, 0x0C), compress(d, 0x0D),
                       compress(four, 0x0C)],
            "pack": [compress(four, 0x84), compress(four, 0x85),
                     compress(two, 0x84), compress(sixteen, 0x85)]}


def test_stripe_and_pack_front_ends_match_jax():
    """_stripe_rewrap, _pack_rewrap and _pack_hist_remap give the JAX
    functions' bytes and counts."""
    inp = _rewrap_inputs()
    for raw in inp["stripe"]:
        assert tds._stripe_rewrap(raw) == jds._stripe_rewrap(raw)
    rng = np.random.default_rng(13)
    for raw in inp["pack"]:
        got = tds._pack_rewrap(raw)
        assert got == jds._pack_rewrap(raw)
        syms, w, ulen, plen, _core = got
        core_hist = rng.integers(0, 50, 256)
        for qbins in (64, 256):
            assert np.array_equal(
                tds._pack_hist_remap(core_hist, syms, w, ulen, plen, qbins),
                jds._pack_hist_remap(core_hist, syms, w, ulen, plen, qbins))
    for bad in (compress(_walk(rng, 500), 0x05), compress(bytes(99), 0x84)):
        for fn in ("_stripe_rewrap", "_pack_rewrap"):
            with pytest.raises(ValueError) as port_err:
                getattr(tds, fn)(bad)
            with pytest.raises(ValueError) as jax_err:
                getattr(jds, fn)(bad)
            assert str(port_err.value) == str(jax_err.value)


def test_pack_remap_counts_unpacked_symbols():
    """A PACK stream's core histogram (256 bins, on the plain version of
    B3/B6), remapped, is the histogram of the unpacked symbols."""
    for raw in _rewrap_inputs()["pack"]:
        syms, w, ulen, plen, core = tds._pack_rewrap(raw)
        runner = (tds.qualstats_device_o1 if core[0] & 1
                  else tds.qualstats_device)
        ch, _ = runner([core], device="cpu", qbins=256)
        got = tds._pack_hist_remap(ch[0], syms, w, ulen, plen, tds.QBINS)
        assert np.array_equal(got, tds.qualstats_host([uncompress(raw)])[0])


def check_committed_fixture(tmp_path, path, writer, lanes):
    """The fixture is what `writer` writes, its QS blocks take every lane
    in `lanes`, and its committed histogram and block counts are what both
    packages and a per-record bincount give."""
    fresh = str(tmp_path / "fresh.cram")
    writer(fresh)
    with open(fresh, "rb") as a, open(path, "rb") as b:
        assert a.read() == b.read()
    with open(path + ".hist.json") as fp:
        want = json.load(fp)
    seen = set()
    with open(path, "rb") as fp:
        version, _ = read_file_definition(fp)
        io = CramIO(fp, version)
        c = io.read_container_header()
        fp.seek(c.data_offset + c.length)
        while True:
            c = io.read_container_header()
            if c is None or c.ref_seq_start == CRAM_EOF_START:
                break
            while fp.tell() < c.data_offset + c.length:
                blk = io.read_block()
                if blk.content_id == tds.QS_CONTENT_ID \
                        and blk.content_type == CT_EXT:
                    seen.add(tds.qs_route(blk.method, bytes(blk.data))[0])
    assert set(lanes) <= seen
    stats, jstats = {}, {}
    got = tds.cram_qual_hist(path, device="cpu", stats=stats)
    ref = jds.cram_qual_hist(path, interpret=True, stats=jstats)
    assert got.tolist() == want["hist"]
    assert np.array_equal(ref, got)
    assert np.array_equal(per_record_hist(path), got)
    assert stats == jstats == {"device_blocks": want["device_blocks"],
                               "host_blocks": want["host_blocks"]}


def test_host_decoded_block_uses_port_codec():
    """A RANSPR QS block the JAX lane leaves on the host (4-way O0)
    routes to the host and decodes with the port's own codec as the JAX
    package's block does."""
    from htslib_tpu.cram.io import CramBlock
    d = bytes(np.random.default_rng(9).integers(0, 50, 3000,
                                                dtype=np.uint8))
    blk = CramBlock(RANSPR, CT_EXT, tds.QS_CONTENT_ID, 0, len(d),
                    compress(d, 0x00))
    assert tds.qs_route(blk.method, blk.data) == (None, None)
    assert jax_route(blk.method, blk.data) is None
    tb = TBlock(RANSPR, CT_EXT, tds.QS_CONTENT_ID, 0, len(d),
                compress(d, 0x00))
    assert tb.uncompress() == d == blk.uncompress()


# -- the STRIPE and PACK fixture ------------------------------------------
# (the whole of tests/test_torch_stripe_pack.py, merged here: its
# interpret-mode JAX runs take minutes and share their compiled lanes,
# and pytest-xdist's loadfile scheduling starts a file of many tests
# first, where a file of two to five tests started last and ended the
# tier-1 run alone)

STRIPE_PACK = os.path.join(REPO, "htslib_tpu_torch", "testdata",
                           "qual_stripe_pack.cram")


def test_committed_stripe_pack_fixture(tmp_path):
    check_committed_fixture(tmp_path, STRIPE_PACK, write_stripe_pack_cram,
                            ["stripe", "pack", None])


def test_stripe_pack_fixture_wires():
    """The fixture holds STRIPE blocks of both orders and PACK blocks of
    both orders."""
    flags = set()
    with open(STRIPE_PACK, "rb") as fp:
        version, _ = read_file_definition(fp)
        io = CramIO(fp, version)
        c = io.read_container_header()
        fp.seek(c.data_offset + c.length)
        while True:
            c = io.read_container_header()
            if c is None or c.ref_seq_start == CRAM_EOF_START:
                break
            while fp.tell() < c.data_offset + c.length:
                blk = io.read_block()
                if blk.content_id == tds.QS_CONTENT_ID \
                        and blk.method == RANSPR:
                    flags.add(blk.data[0])
    assert {0x0C, 0x0D, 0x84, 0x85} <= flags
