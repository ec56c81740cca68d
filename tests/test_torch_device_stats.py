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
from htslib_tpu.codecs.rans4x16 import compress
from htslib_tpu.cram import CramReader, CramWriter
from htslib_tpu.ops import device_stats as jds
from htslib_tpu.sam import SamHeader
from htslib_tpu.sam.cigar import parse_cigar
from htslib_tpu.sam.record import BamRecord
from htslib_tpu_torch.cram.structs import RANS, RANSPR
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
                    device_profile=True):
    """A CRAM of n seeded records of read_len with qualities uniform over
    20..40 (so the device profile pins QS to the Nx16 O0 32-way wire),
    plus one record of tail_len alone in the last slice (its QS block is
    too short to pin and is stored for the host).  The committed fixture
    is write_qual_cram(FIXTURE)."""
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
            r.set_seq("".join(rng.choice(list("ACGT"), ln)),
                      bytes(rng.integers(20, 41, ln, dtype=np.uint8)))
            w.write(r)


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
    path = str(tmp_path / "v30.cram")
    write_qual_cram(path, n=300, seqs_per_slice=200, version=(3, 0),
                    device_profile=False)
    with pytest.raises(NotImplementedError, match="B8"):
        tds.cram_qual_hist(path, device="cpu")


def _stripe(d):
    return compress(d, 0x0C)


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
    """QS wires the JAX lane decodes on its device name the kernel the
    port still lacks; wires it decodes on the host route to None."""
    rng = np.random.default_rng(5)
    d = _walk(rng, 4000)
    raw = {"o1": lambda: compress(d, 0x05),
           "stripe": lambda: _stripe(d),
           "pack": lambda: compress(bytes(rng.integers(0, 4, 4000,
                                                       dtype=np.uint8)),
                                    0x84),
           "4x8_o0": lambda: rans4x8.compress(d, 0),
           "4x8_o1": lambda: rans4x8.compress(d, 1),
           "o0_4way": lambda: compress(d, 0x00),
           "o1_4way": lambda: compress(d, 0x01)}[wire]()
    got = tds._unported_kernel(method, raw)
    if kernel is None:
        assert got is None
    else:
        assert kernel in got


def test_host_decoded_block_uses_port_codec():
    """A RANSPR QS block the JAX lane leaves on the host (4-way O0)
    routes to the host and decodes with the port's own codec as the JAX
    package's block does."""
    from htslib_tpu.cram.io import CramBlock
    from htslib_tpu.cram.structs import CT_EXTERNAL
    d = bytes(np.random.default_rng(9).integers(0, 50, 3000,
                                                dtype=np.uint8))
    blk = CramBlock(RANSPR, CT_EXTERNAL, tds.QS_CONTENT_ID, 0, len(d),
                    compress(d, 0x00))
    assert tds._unported_kernel(blk.method, blk.data) is None
    from htslib_tpu_torch.cram.io import CramBlock as TBlock
    tb = TBlock(RANSPR, CT_EXTERNAL, tds.QS_CONTENT_ID, 0, len(d),
                compress(d, 0x00))
    assert tb.uncompress() == d == blk.uncompress()

