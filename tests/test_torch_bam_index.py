"""The port's BAM indexing and region queries (htslib_tpu_torch/sam/
indexing.py, `BamReader`'s streaming API and `BamWriter(build_index=True)`
in sam/bam.py, sam/samtext.py) against the JAX package's.

The input is a seeded, sorted BAM of about 5,000 records on three
references (CIGARs with I, D, N and S; paired and single reads; every
23rd read unmapped but placed at its mate's position; 60 unplaced reads
at the end), made from SAM text by each side's `BamRecord.from_sam`.
Both sides write it with the index on, and build BAI and CSI indexes of
it; region queries (`bam_fetch`, the three special `tid`s,
`MultiRegionIterator`) give records compared as `to_sam` lines, and the
same records bgzipped as SAM text are indexed and fetched by
`build_sam_gz_index` / `sam_gz_fetch`.  The JAX side deflates on its
pure-Python path (`htslib_tpu.native.native` None), so compressed bytes
are compared byte for byte.  Equality is exact."""
import numpy as np
import pytest

from htslib_tpu import index as jidx
from htslib_tpu.sam import bam as jbam
from htslib_tpu.sam import indexing as jind
from htslib_tpu.sam import samtext as jtext
from htslib_tpu.sam.header import SamHeader as JHeader
from htslib_tpu.sam.record import BamRecord as JRecord
from htslib_tpu_torch import index as tidx
from htslib_tpu_torch.sam import bam as tbam
from htslib_tpu_torch.sam import indexing as tind
from htslib_tpu_torch.sam import samtext as ttext
from htslib_tpu_torch.sam.header import SamHeader as THeader
from htslib_tpu_torch.sam.record import BamRecord as TRecord

REFS = [("c1", 400_000), ("c2", 150_000), ("c3", 9_000)]
HEADER = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
    f"@SQ\tSN:{n}\tLN:{ln}\n" for n, ln in REFS) + \
    "@RG\tID:g1\tSM:s1\n@PG\tID:p\tPN:gen\n"
CIGARS = ["100M", "20S80M", "40M2I58M", "30M5D70M", "50M300N50M",
          "10S85M5S", "60M1D20M3I17M"]


def sam_lines(n=5000, unplaced=60, seed=3):
    """Seeded SAM lines, sorted by reference and position."""
    rng = np.random.default_rng(seed)
    per = rng.multinomial(n, [0.6, 0.3, 0.1])
    lines = []
    k = 0
    for tid, (cnt, (name, ln)) in enumerate(zip(per, REFS)):
        for pos in np.sort(rng.integers(1, ln - 500, cnt)).tolist():
            k += 1
            cig = CIGARS[int(rng.integers(0, len(CIGARS)))]
            flag = int(rng.choice([0, 16, 1 | 2 | 32 | 64, 1 | 2 | 16 | 128,
                                   1 | 8 | 64, 256, 1024]))
            if k % 23 == 0:
                flag, cig = 1 | 4 | 64, "*"          # placed unmapped
            qlen = 100
            mapq = int(rng.integers(0, 61)) if not flag & 4 else 0
            mate = (("=", pos + int(rng.integers(0, 300)),
                     int(rng.integers(-500, 500))) if flag & 1
                    else ("*", 0, 0))
            seq = "".join(rng.choice(list("ACGTN"), qlen,
                                     p=[.24, .25, .25, .25, .01]))
            qual = "".join(chr(33 + int(q)) for q in
                           rng.integers(2, 41, qlen))
            lines.append("\t".join(map(str, [
                f"r{k:05d}", flag, name, pos, mapq, cig, *mate, seq, qual,
                f"NM:i:{int(rng.integers(0, 5))}", "RG:Z:g1"])))
    for i in range(unplaced):
        lines.append(f"u{i:03d}\t4\t*\t0\t0\t*\t*\t0\t0\tACGTACGTAC\t"
                     f"IIIIIIIIII\tRG:Z:g1")
    return lines


LINES = sam_lines()
REGIONS = ["c1", "c2", "c3", "c1:1-1,000", "c1:200,000-260,000",
           "c2:100000-100500", "c3:8000-9000", "c1:399,000-400,000",
           "c2:149990-150000", "c3:1-1", "{c1}:50000-", "c2:-20000"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Both writers' BAMs (with their .bai), made from LINES."""
    d = tmp_path_factory.mktemp("bam")
    mp = pytest.MonkeyPatch()
    mp.setattr("htslib_tpu.native.native", None)
    try:
        out = {}
        for side, hdr_cls, rec_cls, mod in (
                ("t", THeader, TRecord, tbam), ("j", JHeader, JRecord, jbam)):
            hdr = hdr_cls(HEADER)
            path = str(d / f"{side}.bam")
            with mod.BamWriter(path, hdr, level=1, build_index=True) as w:
                for ln in LINES:
                    w.write(rec_cls.from_sam(ln, hdr))
            out[side] = path
    finally:
        mp.undo()
    rng = np.random.default_rng(4)
    regions = list(REGIONS)
    for _ in range(28):
        name, ln = REFS[int(rng.integers(0, 3))]
        beg = int(rng.integers(1, ln))
        regions.append(f"{name}:{beg}-{beg + int(rng.integers(0, 40_000))}")
    out["regions"] = regions
    out["dir"] = d
    return out


def _read(path):
    with open(path, "rb") as fp:
        return fp.read()


def test_bam_writer_index_matches_jax(files):
    assert _read(files["t"]) == _read(files["j"])
    assert _read(files["t"] + ".bai") == _read(files["j"] + ".bai")


@pytest.mark.parametrize("min_shift", [0, 14, 12])
def test_build_bam_index_matches_jax(files, min_shift, monkeypatch):
    d = files["dir"]
    ext = ".bai" if min_shift == 0 else f".{min_shift}.csi"
    t = tind.build_bam_index(files["t"], str(d / f"t{ext}"), min_shift)
    monkeypatch.setattr("htslib_tpu.native.native", None)
    j = jind.build_bam_index(files["t"], str(d / f"j{ext}"), min_shift)
    assert _read(d / f"t{ext}") == _read(d / f"j{ext}")
    if min_shift == 0:
        # the writer's on-the-fly BAI is the one built from the file
        assert _read(d / "t.bai") == _read(files["t"] + ".bai")
    assert t.n_no_coor == j.n_no_coor == 60
    for tid in range(len(REFS)):
        assert t.get_stat(tid) == j.get_stat(tid)
    assert tind.load_bam_index(files["t"]).fmt == tidx.HTS_FMT_BAI


def _fetch(mod, path, idx_path, region):
    with mod["reader"](path) as r:
        idx = mod["load"](path, idx_path)
        return [rec.to_sam(r.header) for rec in mod["fetch"](r, idx, region)]


T = {"reader": tbam.BamReader, "load": tind.load_bam_index,
     "fetch": tind.bam_fetch, "query": tind.bam_itr_query,
     "multi": tind.MultiRegionIterator}
J = {"reader": jbam.BamReader, "load": jind.load_bam_index,
     "fetch": jind.bam_fetch, "query": jind.bam_itr_query,
     "multi": jind.MultiRegionIterator}


@pytest.mark.parametrize("kind", ["bai", "csi"])
def test_bam_fetch_matches_jax(files, kind, monkeypatch):
    path = files["t"]
    idx_path = None
    if kind == "csi":
        idx_path = str(files["dir"] / "q.csi")
        tind.build_bam_index(path, idx_path, 14)
    hits = 0
    for region in files["regions"] + ["*"]:
        got = _fetch(T, path, idx_path, region)
        assert got == _fetch(J, path, idx_path, region), region
        hits += bool(got)
    assert hits > 30
    for mod in (tind, jind):
        with pytest.raises(ValueError, match="could not parse"):
            with tbam.BamReader(path) as r:
                list(mod.bam_fetch(r, tind.load_bam_index(path), "c9:1-5"))


@pytest.mark.parametrize("tid", [tidx.HTS_IDX_NOCOOR, tidx.HTS_IDX_START,
                                 tidx.HTS_IDX_REST])
def test_special_tids_match_jax(files, tid):
    out = []
    for mod in (T, J):
        with mod["reader"](files["t"]) as r:
            idx = mod["load"](files["t"], None)
            if tid == tidx.HTS_IDX_REST:
                for _ in range(1000):
                    r.read1()
            out.append([rec.to_sam(r.header) for rec in
                        mod["query"](r, idx, tid, 0, 0)])
    assert out[0] == out[1]
    want = {tidx.HTS_IDX_NOCOOR: 60, tidx.HTS_IDX_START: len(LINES),
            tidx.HTS_IDX_REST: len(LINES) - 1000}[tid]
    assert len(out[0]) == want


def test_multi_region_iterator_matches_jax(files):
    rng = np.random.default_rng(6)
    regions = []
    for _ in range(25):
        tid = int(rng.integers(0, 3))
        beg = int(rng.integers(0, REFS[tid][1]))
        regions.append((tid, beg, beg + int(rng.integers(1, 30_000))))
    regions.append((-1, 0, 0))
    out = []
    for mod in (T, J):
        with mod["reader"](files["t"]) as r:
            idx = mod["load"](files["t"], None)
            out.append([rec.to_sam(r.header)
                        for rec in mod["multi"](r, idx, regions)])
    assert out[0] == out[1] and len(out[0]) > 100


def test_streaming_reader_matches_jax(files):
    with tbam.BamReader(files["t"]) as t, jbam.BamReader(files["t"]) as j:
        assert t.header.text == j.header.text
        offs = []
        while True:
            offs.append(t.tell())
            assert offs[-1] == j.tell()
            a, b = t.read1(), j.read1()
            if a is None:
                assert b is None
                break
            assert a.to_bam_buffer() == b.to_bam_buffer()
        assert len(offs) == len(LINES) + 1
        rng = np.random.default_rng(7)
        for k in rng.integers(0, len(LINES), 40).tolist():
            t.seek(offs[k])
            j.seek(offs[k])
            assert t.read1().to_sam(t.header) == j.read1().to_sam(
                j.header) == LINES[k]
    expr = "mapq >= 30 && flag.paired"
    out = []
    for cls in (tbam.BamReader, jbam.BamReader):
        with cls(files["t"]) as r:
            r.set_filter(expr)
            out.append([rec.to_sam(r.header) for rec in r])
    assert out[0] == out[1] and 0 < len(out[0]) < len(LINES)
    with tbam.BamReader(files["t"]) as t, jbam.BamReader(files["t"]) as j:
        t.read1()
        j.read1()
        a, b = t.raw_records(), j.raw_records()
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_sam_text_reader_writer_match_jax(files, tmp_path, monkeypatch):
    monkeypatch.setattr("htslib_tpu.native.native", None)
    outs = []
    for side, hdr_cls, rec_cls, mod in (
            ("t", THeader, TRecord, ttext), ("j", JHeader, JRecord, jtext)):
        hdr = hdr_cls(HEADER)
        for compress in (False, True):
            path = str(tmp_path / f"{side}{compress:d}.sam")
            with mod.SamWriter(path, hdr, compress=compress) as w:
                for ln in LINES[:300]:
                    w.write(rec_cls.from_sam(ln, hdr))
            outs.append(_read(path))
            with mod.SamReader(path) as r:
                assert [rec.to_sam(r.header) for rec in r] == LINES[:300]
                assert r.header.text == HEADER
    assert outs[:2] == outs[2:]


def test_sam_gz_index_and_fetch_match_jax(files, tmp_path, monkeypatch):
    monkeypatch.setattr("htslib_tpu.native.native", None)
    gz = str(tmp_path / "r.sam.gz")
    hdr = THeader(HEADER)
    with ttext.SamWriter(gz, hdr, compress=True, level=1) as w:
        for ln in LINES:
            w.write(TRecord.from_sam(ln, hdr))
    t = tind.build_sam_gz_index(gz, out_path=gz + ".t.csi")
    j = jind.build_sam_gz_index(gz, out_path=gz + ".j.csi")
    assert _read(gz + ".t.csi") == _read(gz + ".j.csi")
    th, jh = THeader(HEADER), JHeader(HEADER)
    hits = 0
    for region in files["regions"]:
        tid, beg, end, _ = tidx.parse_region(region, th.name2tid)
        a = [r.to_sam(th) for r in tind.sam_gz_fetch(gz, t, th, tid, beg,
                                                      end)]
        b = [r.to_sam(jh) for r in jind.sam_gz_fetch(gz, j, jh, tid, beg,
                                                      end)]
        assert a == b, region
        assert a == _fetch(T, files["t"], None, region)
        hits += bool(a)
    assert hits > 30
