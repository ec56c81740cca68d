"""The port's filter expressions (htslib_tpu_torch/hts_expr.py) and
`CramReader.set_filter` against the JAX package's (htslib_tpu/hts_expr.py).

Every expression of tests/test_expr.py (its references renamed to this
header's), its arithmetic basics, and expressions over every record field
and aux tag that bam_sym_lookup binds, evaluated on seeded records
(tests/test_torch_cram.py's, with XF:f, XD:d and ZB:B values, and read
groups with and without a library) through both `HtsFilter`s: each
record's verdict, or the error an expression raises, must be the same."""
import jax
import pytest

from htslib_tpu import hts_expr as jexpr
from htslib_tpu.cram import CramReader as JReader
from htslib_tpu.sam.header import SamHeader as JHeader
from htslib_tpu.sam.record import BamRecord as JRecord
from htslib_tpu_torch import hts_expr as texpr
from htslib_tpu_torch.cram import CramReader
from htslib_tpu_torch.cram import batch as tbatch
from htslib_tpu_torch.sam.header import SamHeader
from test_torch_cram import cram_records, write_bam, write_fasta

RG = "@RG\tID:grp0\tLB:x\n@RG\tID:grp1\tLB:libB\n"
EXPRS = [
    # tests/test_expr.py's goldens
    'qname =~ "\\.1" && cigar =~ "D"', 'rname=="chrB"', 'rname=~"chrA"',
    'cigar=~"D"', 'seq =~ "(AT){2}"', 'library=="x"', 'library!="x"',
    'pos % 23 == 11', 'qlen/(flag*mapq+pos)>5',
    '[NM]>=10 || [MD]=~"A.*A.*A"', 'length(seq) != qlen', 'min(qual) >= 20',
    'max(qual) <= 20', 'avg(qual) >= 20 && avg(qual) <= 30', 'sclen>=20',
    'rlen<50', 'qlen>100', 'hclen>=4',
    # its basics
    "1 + 2 * 3 == 7", "(1+2)*3 == 9", '"abc" =~ "b"', '"abc" !~ "b"',
    "16 & 0x10", "16 & 0x20", "sqrt(16) == 4", "pow(2,10) == 1024", "!0",
    # record fields and flags
    "mapq >= 30 && flag.paired", "flag.read1 || flag.secondary",
    "flag.proper_pair && !flag.mreverse", "flag.dup | flag.supplementary",
    "flag.qcfail", "flag.unmap", "flag.munmap", "flag.reverse",
    "flag.read2", "flag & 0x10", "~flag & 4", "flag ^ 1", "flag | 2",
    "tlen < 0", "mpos > pos", "pnext == mpos", "mrname == rname",
    'rnext != "*"', "mrefid == -1", "refid == 1 && tid == 1",
    "ncigar > 3", "endpos - pos > 50", 'qname =~ "dry00[0-4]"',
    "!flag.unmap && sqrt(mapq) > 5", "log(mapq) > 3", "exp(1) > 2",
    "-mapq < -10", "+mapq", "mapq * 2 / 4 % 5", 'seq =~ "N"',
    'qual =~ "#"', 'cigar == "*"', "length(qual) == 0",
    # aux tags
    '[RG] == "grp1"', "exists([XF])", "[XF] > 0", "[XD] >= 1e5",
    "default([NM], -1) == 0", "[ZB]", "exists([ZB])", '[RG] =~ "grp[02]"',
    "[NM] * 2 > mapq / 10", "!exists([XD]) || [XD] < 1e4",
    # strings, undefined values and errors
    '"ab" + "cd" == "abcd"', '"b" > "a"', '"a" < 1', "1 / 0", "[YY] == 1",
    "[YY] != 1 || 1", '"a" * 2', "unknown_sym", "(1 + 2", "1 2",
    "length(3)", 'sqrt("x")', '"a" =~ 1', "flag.nosuchbit",
    'min("")', "0x1F == 31", ".5 == 0.5", "2e3 == 2000",
]


@pytest.fixture(autouse=True, scope="module")
def _jax_32bit():
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", before)


@pytest.fixture(scope="module")
def recs(tmp_path_factory):
    """(port header, port records, JAX header, JAX records), the same
    BAM bytes on both sides; and a port-written CRAM 3.0 of them."""
    d = tmp_path_factory.mktemp("expr")
    fa = str(d / "ref.fa")
    seqs = write_fasta(fa, 51)
    hdr, recs = cram_records(160, 53, seqs)
    hdr = SamHeader(hdr.text + RG)
    bam = write_bam(str(d / "in.bam"), hdr, recs)
    cram = str(d / "r.cram")
    tbatch.bam_to_cram_file(bam, cram, ref=fa, seqs_per_slice=60)
    jrecs = [JRecord.from_bam_buffer(r.to_bam_buffer()) for r in recs]
    return {"hdr": hdr, "recs": recs, "jhdr": JHeader(hdr.text),
            "jrecs": jrecs, "cram": cram, "fasta": fa}


def _verdicts(mod, filt_expr, hdr, records):
    """Each record's verdict, or the error the expression raised."""
    try:
        f = mod.HtsFilter(filt_expr)
        return [mod.sam_passes_filter(r, hdr, f) for r in records]
    except Exception as e:              # compared across the two
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("expr", EXPRS)
def test_filter_verdicts_match_jax(recs, expr):
    ours = _verdicts(texpr, expr, recs["hdr"], recs["recs"])
    theirs = _verdicts(jexpr, expr, recs["jhdr"], recs["jrecs"])
    assert ours == theirs


def test_expressions_cover_both_verdicts(recs):
    """The record expressions split the records: not all pass, not all
    fail (so the comparison above sees both verdicts)."""
    split = 0
    for expr in EXPRS:
        v = _verdicts(texpr, expr, recs["hdr"], recs["recs"])
        if isinstance(v, list) and 0 < sum(v) < len(v):
            split += 1
    assert split >= 30


def test_values_and_lookup_match_jax(recs):
    """The symbol lookup's consumed length and value for every bound
    name, on every record."""
    names = ["cigar", "endpos", "flag", "hclen", "library", "mapq", "mpos",
             "mrname", "mrefid", "ncigar", "pnext", "pos", "qlen", "qname",
             "qual", "refid", "rlen", "rname", "rnext", "sclen", "seq",
             "tlen", "tid", "flag.paired", "flag.read2", "[RG]", "[XF]",
             "[XD]", "[NM]", "[ZB]", "[QQ]", "[RG] rest"]
    for r, j in zip(recs["recs"], recs["jrecs"]):
        look = texpr.bam_symbol_lookup(r, recs["hdr"])
        jlook = jexpr.bam_symbol_lookup(j, recs["jhdr"])
        for name in names:
            a, b = look(name), jlook(name)
            if a is None or b is None:
                assert a is b is None
                continue
            assert a[0] == b[0]
            assert (a[1].is_str, a[1].d, a[1].s, a[1].defined) == (
                b[1].is_str, b[1].d, b[1].s, b[1].defined), name


@pytest.mark.parametrize("expr", [
    "mapq >= 30 && flag.paired", '[RG] == "grp0" || [XF] < 0',
    "rlen > 60 && !flag.reverse", None])
def test_cram_reader_set_filter_matches_jax(recs, expr, monkeypatch):
    monkeypatch.setattr("htslib_tpu.native.native", None)
    monkeypatch.setattr("htslib_tpu_torch.native.native", None)
    out = []
    for cls in (CramReader, JReader):
        with cls(recs["cram"], ref=recs["fasta"]) as r:
            r.set_filter("flag.read1")
            r.set_filter(expr)
            out.append([x.to_bam_buffer() for x in r])
    assert out[0] == out[1]
    assert 0 < len(out[0]) <= len(recs["recs"])
    assert (len(out[0]) == len(recs["recs"])) == (expr is None)
