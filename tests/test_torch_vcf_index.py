"""The port's BCF index and header merge (htslib_tpu_torch/vcf/io.py
`bcf_index_build`, `BcfReader.fetch`, `BcfWriter(build_index=True)`;
vcf/merge.py `bcf_hdr_merge`, `bcf_translate`) against the JAX package's.

The BCF holds about 3,000 seeded lines of the type matrix of
tests/test_torch_vcf.py, sorted by contig and position, some with END=,
so records span and chunks cross BGZF members.  Both sides write it with
the index on and build its CSI from the file; the JAX side deflates on
its pure-Python path (`htslib_tpu.native.native` None), so the files and
indexes are compared byte for byte, and `fetch` gives the same records
as VCF text.  The merge takes headers whose INFO and FORMAT ids clash
in Number or Type, contigs in another order and new FILTER, ALT and
generic lines; `bcf_translate` then maps records of the source header
to the merged one.  Equality is exact."""
import numpy as np
import pytest

from htslib_tpu.vcf import io as jio
from htslib_tpu.vcf import merge as jmerge
from htslib_tpu.vcf.header import BcfHeader as JHeader
from htslib_tpu.vcf.record import BcfRecord as JRecord
from htslib_tpu_torch import vcf as tvcf
from htslib_tpu_torch.index import HtsIndex
from htslib_tpu_torch.vcf import io as tio
from htslib_tpu_torch.vcf.header import BcfHeader as THeader
from htslib_tpu_torch.vcf.record import BcfRecord as TRecord
from test_torch_vcf import HEADERS, matrix_line

ORDER = {"1": 0, "2": 1, "X": 2}


def index_lines(n=3000, seed=5):
    rng = np.random.default_rng(seed)
    lines = [matrix_line(rng, int(p)) for p in
             rng.integers(1, 3_000_000, n)]
    lines.sort(key=lambda ln: (ORDER[ln.split("\t")[0]],
                               int(ln.split("\t")[1])))
    return lines


LINES = index_lines()


@pytest.fixture(scope="module")
def bcfs(tmp_path_factory):
    d = tmp_path_factory.mktemp("bcf")
    mp = pytest.MonkeyPatch()
    mp.setattr("htslib_tpu.native.native", None)
    out = {"dir": d}
    try:
        for side, hdr_cls, rec_cls, mod in (
                ("t", THeader, TRecord, tio), ("j", JHeader, JRecord, jio)):
            h = hdr_cls(HEADERS["matrix"])
            path = str(d / f"{side}.bcf")
            with mod.BcfWriter(path, h, level=1, build_index=True) as w:
                for ln in LINES:
                    w.write(rec_cls.from_vcf(ln, h))
            out[side] = path
            out[side + "_index"] = w.index
    finally:
        mp.undo()
    return out


def _read(path):
    with open(path, "rb") as fp:
        return fp.read()


def test_bcf_writer_index_matches_jax(bcfs):
    assert _read(bcfs["t"]) == _read(bcfs["j"])
    assert _read(bcfs["t"] + ".csi") == _read(bcfs["j"] + ".csi")
    assert bcfs["t_index"].n == bcfs["j_index"].n == 3


@pytest.mark.parametrize("min_shift", [14, 12])
def test_bcf_index_build_matches_jax(bcfs, min_shift, monkeypatch):
    d = bcfs["dir"]
    t = tio.bcf_index_build(bcfs["t"], min_shift, str(d / f"t{min_shift}"))
    monkeypatch.setattr("htslib_tpu.native.native", None)
    jio.bcf_index_build(bcfs["t"], min_shift, str(d / f"j{min_shift}"))
    assert _read(d / f"t{min_shift}") == _read(d / f"j{min_shift}")
    if min_shift == 14:
        # the writer's on-the-fly index is the one built from the file
        assert _read(d / "t14") == _read(bcfs["t"] + ".csi")
    assert isinstance(t, HtsIndex) and t.min_shift == min_shift


def test_bcf_fetch_matches_jax(bcfs):
    rng = np.random.default_rng(6)
    regions = [(0, 0, 1 << 40), (2, 0, 100), (1, 2_999_000, 3_100_000),
               (3, 0, 10), (-1, 0, 10)]
    for _ in range(40):
        beg = int(rng.integers(0, 3_000_000))
        regions.append((int(rng.integers(0, 3)), beg,
                        beg + int(rng.integers(1, 200_000))))
    hits = 0
    with tio.BcfReader(bcfs["t"]) as t, jio.BcfReader(bcfs["t"]) as j:
        for rid, beg, end in regions:
            got = [r.to_vcf(t.header) for r in t.fetch(rid, beg, end)]
            assert got == [r.to_vcf(j.header)
                           for r in j.fetch(rid, beg, end)], (rid, beg, end)
            hits += bool(got)
    assert hits > 30
    # an index given explicitly
    idx = HtsIndex.load(bcfs["t"] + ".csi")
    with tio.BcfReader(bcfs["t"]) as t:
        assert len(list(t.fetch(0, 0, 1 << 40, index=idx))) == sum(
            ln.startswith("1\t") for ln in LINES)


DST = "\n".join([
    "##fileformat=VCFv4.2",
    "##source=a",
    '##FILTER=<ID=q10,Description="q">',
    '##INFO=<ID=DP,Number=1,Type=Integer,Description="depth">',
    '##INFO=<ID=AF,Number=A,Type=Float,Description="af">',
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="gt">',
    '##FORMAT=<ID=AD,Number=R,Type=Integer,Description="ad">',
    "##contig=<ID=1,length=1000>",
    "##contig=<ID=2,length=2000>",
    "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1"]) + "\n"
SRC = "\n".join([
    "##fileformat=VCFv4.3",
    "##source=b",
    "##phasing=none",
    '##FILTER=<ID=lowq,Description="l">',
    '##FILTER=<ID=q10,Description="q again">',
    '##INFO=<ID=AF,Number=1,Type=String,Description="clash">',
    '##INFO=<ID=MQ,Number=1,Type=Integer,Description="mq">',
    '##INFO=<ID=DP,Number=1,Type=Float,Description="clash type">',
    '##FORMAT=<ID=AD,Number=.,Type=Integer,Description="clash number">',
    '##FORMAT=<ID=PL,Number=G,Type=Integer,Description="pl">',
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="gt">',
    '##ALT=<ID=DEL,Description="deletion">',
    "##contig=<ID=3,length=3000>",
    "##contig=<ID=2,length=2000>",
    "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1"]) + "\n"
SRC_LINES = [
    "3\t10\t.\tA\tC\t5\tlowq\tMQ=30;DP=4.5\tGT:PL:AD\t0/1:1,2,3:4,5",
    "2\t20\trs1\tG\tT,A\t.\tq10;lowq\tAF=x;MQ=1\tGT:AD\t1/2:1,2,3",
    "3\t30\t.\tT\t<DEL>\t9\tPASS\t.\tGT\t./.",
]


def test_hdr_merge_matches_jax(capsys):
    t = tvcf.bcf_hdr_merge(THeader(DST), THeader(SRC))
    t_err = capsys.readouterr().err
    j = jmerge.bcf_hdr_merge(JHeader(DST), JHeader(SRC))
    assert capsys.readouterr().err == t_err
    assert "different lengths" in t_err and "different types" in t_err
    assert t.text() == j.text()
    assert t.text(with_idx=True) == j.text(with_idx=True)
    assert t.ctg_names == j.ctg_names and t.id_names == j.id_names
    # a merge into nothing is a copy of the source
    c = tvcf.bcf_hdr_merge(None, THeader(SRC))
    assert c.text() == jmerge.bcf_hdr_merge(None, JHeader(SRC)).text()


def test_translate_matches_jax():
    out = []
    for hdr_cls, rec_cls, merge in ((THeader, TRecord, tvcf),
                                    (JHeader, JRecord, jmerge)):
        dst, src = hdr_cls(DST), hdr_cls(SRC)
        merged = merge.bcf_hdr_merge(dst, src)
        lines = []
        for ln in SRC_LINES:
            rec = rec_cls.from_vcf(ln, src)
            assert merge.bcf_translate(merged, src, rec) == 0
            lines.append((rec.rid, list(rec.filters), rec.to_vcf(merged),
                          rec.to_bcf()))
        # a header translated to itself is left alone
        rec = rec_cls.from_vcf(SRC_LINES[0], src)
        before = rec.to_bcf()
        merge.bcf_translate(src, src, rec)
        assert rec.to_bcf() == before
        out.append(lines)
    assert out[0] == out[1]
    assert [r[0] for r in out[0]] == [2, 1, 2]
