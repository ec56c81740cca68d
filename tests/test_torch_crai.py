"""The port's CRAI index (htslib_tpu_torch/cram/index.py, the encoder's
`write_index`, `CramReader.load_index` / `fetch`) and region decode on
the device (cram/batch.py `cram_range_to_sam` at the index's container
offsets) against the JAX package's.

Files: tests/test_torch_cram.py's records (300 over two references and
unmapped reads, sorted) written at 100 records a slice, so that the
last slice holds both references and the unmapped reads; the same records
less some mapped ones, so that the unmapped reads fill a slice of their
own; and records written one by one through `CramWriter.write` (the
encoder's record path).  The JAX encoder runs its pure-Python path (its
native library off), whose bytes the port's encoder writes.  The index
is compared as its gunzipped text, records as BAM bytes, SAM as bytes;
the device stages run their plain versions on the CPU."""
import gzip

import jax
import numpy as np
import pytest

from htslib_tpu.cram import CramReader as JReader
from htslib_tpu.cram import CramWriter as JWriter
from htslib_tpu.cram import batch as jbatch
from htslib_tpu.cram import index as jindex
from htslib_tpu.sam.header import SamHeader as JHeader
from htslib_tpu.sam.record import BamRecord as JRecord
from htslib_tpu_torch.cram import CramReader, CramWriter
from htslib_tpu_torch.cram import batch as tbatch
from htslib_tpu_torch.cram import index as tindex
from chip_smoke import region_runs, sam_overlaps
from test_torch_cram import cram_records, jax_cram, write_bam, write_fasta

# case: (writer, records, version, with the FASTA, slices a container)
CASES = {"bam_3.0_ref": ("bam", "all", (3, 0), True, 1),
         "bam_3.1_noref_spc2": ("bam", "all", (3, 1), False, 2),
         "bam_unmapped_slice": ("bam", "unmapped_slice", (3, 0), True, 1),
         "writer_3.0_ref": ("writer", "all", (3, 0), True, 1),
         "writer_3.1_noref": ("writer", "all", (3, 1), False, 1)}


@pytest.fixture(autouse=True, scope="module")
def _jax_32bit():
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", before)


def _write_records(path, hdr, recs, cls, **opts):
    with cls(path, hdr, **opts) as w:
        for r in recs:
            w.write(r)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Each case written by the port's encoder and by the JAX Python
    encoder, both with write_index: {case: (port path, JAX path, ref)}."""
    d = tmp_path_factory.mktemp("crai")
    fa = str(d / "ref.fa")
    seqs = write_fasta(fa, 41)
    hdr, recs = cram_records(300, 31, seqs)
    mapped = [r for r in recs if r.tid >= 0]
    unmapped = [r for r in recs if r.tid < 0]
    assert len(unmapped) <= 100
    bams = {"all": write_bam(str(d / "all.bam"), hdr, recs),
            "unmapped_slice": write_bam(str(d / "u.bam"), hdr,
                                        mapped[:200] + unmapped)}
    mp = pytest.MonkeyPatch()
    files = {}
    for case, (kind, which, ver, with_ref, spc) in CASES.items():
        ref = fa if with_ref else None
        opts = dict(ref=ref, version=ver, seqs_per_slice=100,
                    slices_per_container=spc, write_index=True)
        ours, theirs = str(d / f"p_{case}.cram"), str(d / f"j_{case}.cram")
        if kind == "bam":
            tbatch.bam_to_cram_file(bams[which], ours, **opts)
            jax_cram(bams[which], theirs, False, mp, **opts)
        else:
            _write_records(ours, hdr, recs, CramWriter, **opts)
            mp.setattr("htslib_tpu.native.native", None)
            try:
                _write_records(theirs, JHeader(hdr.text),
                               [JRecord.from_bam_buffer(r.to_bam_buffer())
                                for r in recs], JWriter, nthreads=1, **opts)
            finally:
                mp.undo()
        files[case] = (ours, theirs, ref)
    return {"fasta": fa, "files": files, "dir": d}


def _crai_text(path):
    with gzip.open(path) as fp:
        return fp.read().decode()


@pytest.mark.parametrize("case", CASES)
def test_encoder_index_matches_jax(corpus, case):
    ours, theirs, _ = corpus["files"][case]
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    text = _crai_text(ours + ".crai")
    assert text == _crai_text(theirs + ".crai")
    rows = [ln.split("\t") for ln in text.splitlines()]
    assert rows and all(len(r) == 6 for r in rows)
    if case == "bam_unmapped_slice":
        assert rows[-1][:3] == ["-1", "0", "0"]
        assert len({r[3] for r in rows if r[0] == "-1"}) == 1
    if case in ("bam_3.0_ref", "writer_3.0_ref"):
        # the last slice holds both references and the unmapped reads
        last = [r for r in rows if r[3:5] == rows[-1][3:5]]
        assert sorted(r[0] for r in last) == ["-1", "0", "1"]


@pytest.mark.parametrize("case", CASES)
def test_build_crai_matches_jax_and_the_encoder(corpus, case, tmp_path):
    path, _, ref = corpus["files"][case]
    ours = tindex.build_crai(path, str(tmp_path / "p.crai"), ref=ref)
    theirs = jindex.build_crai(path, str(tmp_path / "j.crai"), ref=ref)
    assert [vars(e) for e in ours.entries] == [vars(e) for e in
                                               theirs.entries]
    assert _crai_text(str(tmp_path / "p.crai")) == _crai_text(
        str(tmp_path / "j.crai"))
    written = tindex.CramIndex.load(path + ".crai")
    assert [vars(e) for e in ours.entries] == [vars(e) for e in
                                               written.entries]


def _regions(seed=7, n=12):
    """Seeded regions on both references (0-based [beg, end)), the
    whole of each, one past the reference's end, and the unmapped."""
    rng = np.random.default_rng(seed)
    out = [(0, 0, 20_000), (1, 0, 15_000), (0, 30_000, 31_000),
           (-1, 0, 1 << 20)]
    for _ in range(n):
        tid = int(rng.integers(0, 2))
        beg = int(rng.integers(0, 7000))
        out.append((tid, beg, beg + int(rng.integers(1, 3000))))
    return out


def test_load_query_and_offsets_match_jax(corpus):
    for case, (path, _, _) in corpus["files"].items():
        ours = tindex.CramIndex.load(path + ".crai")
        theirs = jindex.CramIndex.load(path + ".crai")
        assert [vars(e) for e in ours.entries] == [vars(e) for e in
                                                   theirs.entries]
        for tid, beg, end in _regions():
            assert [vars(e) for e in ours.query(tid, beg + 1, end)] == [
                vars(e) for e in theirs.query(tid, beg + 1, end)]
            assert ours.container_offsets(tid, beg + 1, end) == \
                theirs.container_offsets(tid, beg + 1, end)


@pytest.mark.parametrize("case", ["bam_3.0_ref", "bam_3.1_noref_spc2",
                                  "bam_unmapped_slice"])
def test_fetch_matches_jax(corpus, case):
    path, _, ref = corpus["files"][case]
    hits = 0
    with CramReader(path, ref=ref) as r, JReader(path, ref=ref) as j:
        for tid, beg, end in _regions():
            ours = [x.to_bam_buffer() for x in r.fetch(tid, beg, end)]
            theirs = [x.to_bam_buffer() for x in j.fetch(tid, beg, end)]
            assert ours == theirs, (tid, beg, end)
            hits += len(ours)
    assert hits > 0


@pytest.mark.parametrize("case", ["bam_3.0_ref", "bam_3.1_noref_spc2"])
def test_range_to_sam_at_index_offsets_matches_jax(corpus, case,
                                                   monkeypatch):
    """A region query on the device: the index's containers in runs
    through cram_range_to_sam (device="cpu"), equal to the JAX
    function's bytes over the same runs; the lines that overlap the
    region equal fetch's records formatted by to_sam."""
    path, _, ref = corpus["files"][case]
    idx = tindex.CramIndex.load(path + ".crai")
    every = sorted({e.offset for e in idx.entries})
    monkeypatch.setattr("htslib_tpu.native.native", None)
    runs_seen = 0
    for tid, beg, end in _regions(n=4)[:6]:
        runs = region_runs(idx.container_offsets(tid, beg + 1, end), every)
        text = b""
        for off, stop in runs:
            hdr, ours = tbatch.cram_range_to_sam(path, off, stop, ref=ref,
                                                 device="cpu")
            _, theirs = jbatch.cram_range_to_sam(path, off, stop, ref=ref)
            assert ours.tobytes() == theirs.tobytes()
            text += ours.tobytes()
            runs_seen += 1
        if tid < 0:
            continue
        lines = [ln for ln in text.decode().splitlines()
                 if sam_overlaps(ln, hdr.tid2name(tid), beg, end)]
        with CramReader(path, ref=ref) as r:
            assert lines == [x.to_sam(r.header)
                             for x in r.fetch(tid, beg, end)]
    assert runs_seen > 0
