"""The port's VCF/BCF host stack (htslib_tpu_torch/vcf/, bgzf.py
`BgzfReader`, util/log.py, format.py) against the JAX package's
(htslib_tpu/vcf/, bgzf.py, format.py).  Headers of every line kind parse
and print as JAX's; about 300 seeded VCF lines over the type matrix
(Integer, Float, String, Flag and Character; Number 1, 2, A, R, G and
"."; int8, int16 and int32 ranges; missing values and end-of-vector;
haploid, phased and missing GTs; symbolic and multi-allelic ALTs,
several FILTERs and IDs) encode to JAX's BCF bytes and decode to JAX's
text; the record-edit API gives JAX's records; files written by each
side read to the same text on the other, and `bcf_file_to_vcf`
(device="cpu": the plain inflate) and `vcf_file_to_bcf` give JAX's text.
Compressed bytes are compared where both sides deflate alike: with both
native libraries on (libdeflate), or both set to None (zlib).  Outputs
are bytes and text: equality is exact."""
import gzip
import io
import struct
import zlib

import numpy as np
import pytest

from htslib_tpu import bgzf as jbgzf
from htslib_tpu import format as jformat
from htslib_tpu.vcf import io as jio
from htslib_tpu.vcf.header import BcfHeader as JHeader
from htslib_tpu.vcf.record import BcfRecord as JRecord
from htslib_tpu_torch import bgzf as tbgzf
from htslib_tpu_torch import format as tformat
from htslib_tpu_torch.vcf import io as tio
from htslib_tpu_torch.vcf.header import BcfHeader as THeader
from htslib_tpu_torch.vcf.record import BcfRecord as TRecord

# ---------------------------------------------------------------------------
# headers
# ---------------------------------------------------------------------------

SAMPLES = ["NA1", "NA2", "NA3"]

MATRIX_LINES = [
    '##FILTER=<ID=q10,Description="Quality below 10">',
    '##FILTER=<ID=LowQual,Description="Low quality">',
    '##INFO=<ID=END,Number=1,Type=Integer,Description="End">',
    '##INFO=<ID=I1,Number=1,Type=Integer,Description="i">',
    '##INFO=<ID=I2,Number=2,Type=Integer,Description="i">',
    '##INFO=<ID=IA,Number=A,Type=Integer,Description="i">',
    '##INFO=<ID=IR,Number=R,Type=Integer,Description="i">',
    '##INFO=<ID=IG,Number=G,Type=Integer,Description="i">',
    '##INFO=<ID=ID,Number=.,Type=Integer,Description="i">',
    '##INFO=<ID=F1,Number=1,Type=Float,Description="f">',
    '##INFO=<ID=F2,Number=2,Type=Float,Description="f">',
    '##INFO=<ID=FA,Number=A,Type=Float,Description="f">',
    '##INFO=<ID=FR,Number=R,Type=Float,Description="f">',
    '##INFO=<ID=FG,Number=G,Type=Float,Description="f">',
    '##INFO=<ID=FD,Number=.,Type=Float,Description="f">',
    '##INFO=<ID=S1,Number=1,Type=String,Description="s">',
    '##INFO=<ID=SD,Number=.,Type=String,Description="s">',
    '##INFO=<ID=C1,Number=1,Type=Character,Description="c">',
    '##INFO=<ID=FL,Number=0,Type=Flag,Description="flag">',
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
    '##FORMAT=<ID=XI1,Number=1,Type=Integer,Description="i">',
    '##FORMAT=<ID=XI2,Number=2,Type=Integer,Description="i">',
    '##FORMAT=<ID=XIA,Number=A,Type=Integer,Description="i">',
    '##FORMAT=<ID=XIR,Number=R,Type=Integer,Description="i">',
    '##FORMAT=<ID=XIG,Number=G,Type=Integer,Description="i">',
    '##FORMAT=<ID=XID,Number=.,Type=Integer,Description="i">',
    '##FORMAT=<ID=XF1,Number=1,Type=Float,Description="f">',
    '##FORMAT=<ID=XFA,Number=A,Type=Float,Description="f">',
    '##FORMAT=<ID=XFD,Number=.,Type=Float,Description="f">',
    '##FORMAT=<ID=XS,Number=1,Type=String,Description="s">',
    '##FORMAT=<ID=XC,Number=1,Type=Character,Description="c">',
    '##ALT=<ID=DEL,Description="Deletion">',
    "##contig=<ID=1,length=249250621>",
    "##contig=<ID=2,length=243199373>",
    "##contig=<ID=X,length=155270560>",
]


def matrix_header(version="VCFv4.2"):
    return "\n".join([f"##fileformat={version}"] + MATRIX_LINES + [
        "\t".join(["#CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER",
                   "INFO", "FORMAT"] + SAMPLES)]) + "\n"


HEADERS = {
    "matrix": matrix_header(),
    "v44": matrix_header("VCFv4.4"),
    "every_kind": "\n".join([
        "##fileformat=VCFv4.3",
        "##fileDate=20260101",
        "##source=seeded",
        "##reference=file:///ref.fa",
        '##FILTER=<ID=PASS,Description="All filters passed">',
        '##FILTER=<ID=s50,Description="Less than 50% of samples">',
        '##INFO=<ID=NS,Number=1,Type=Integer,Description="Samples",'
        'Source="x",Version="1">',
        '##INFO=<ID=AA,Number=1,Type=String,Description="Ancestral">',
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
        '##FORMAT=<ID=HQ,Number=2,Type=Integer,Description="Haplotype">',
        '##ALT=<ID=INS:ME,Description="Insertion">',
        '##SAMPLE=<ID=S1,Assay=WGS,Description="a sample">',
        "##PEDIGREE=<ID=S1,Father=S2,Mother=S3>",
        '##META=<ID=Assay,Type=String,Number=.,Values=[WGS, Exome]>',
        "##contig=<ID=20,length=62435964,assembly=B36,md5=f126cdf8a6e0c7f3"
        "79d618ff66beb2da,species=\"Homo sapiens\",taxonomy=x>",
        "##contig=<ID=chrM>",
        "##phasing=partial",
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\tS2",
    ]) + "\n",
    "with_idx": "\n".join([
        "##fileformat=VCFv4.2",
        '##FILTER=<ID=PASS,Description="All filters passed",IDX=0>',
        '##INFO=<ID=DP,Number=1,Type=Integer,Description="d",IDX=3>',
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="g",IDX=1>',
        '##INFO=<ID=AF,Number=A,Type=Float,Description="a",IDX=2>',
        "##contig=<ID=1,length=1000,IDX=0>",
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tA"]) + "\n",
    "duplicates": "\n".join([
        "##fileformat=VCFv4.2",
        '##INFO=<ID=DP,Number=1,Type=Integer,Description="d">',
        '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="d">',
        '##INFO=<ID=DP,Number=1,Type=Integer,Description="again">',
        "##contig=<ID=1>",
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"]) + "\n",
    "no_samples": "##fileformat=VCFv4.1\n"
                  "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n",
}


def _same_header(t, j):
    for idx in (False, True):
        assert t.text(with_idx=idx) == j.text(with_idx=idx)
    assert t.id_names == j.id_names
    assert t.ctg_names == j.ctg_names and t.ctg_lens == j.ctg_lens
    assert t.samples == j.samples and t.n_samples == j.n_samples
    assert t.v44 == j.v44 and t.version == j.version
    for name in t.id_names:
        assert t.id2int(name) == j.id2int(name)
        for hl in range(3):
            assert t.coltype(hl, t.id2int(name)) == j.coltype(hl,
                                                              j.id2int(name))


@pytest.mark.parametrize("name", sorted(HEADERS))
def test_header_matches_jax(name):
    _same_header(THeader(HEADERS[name]), JHeader(HEADERS[name]))


@pytest.mark.parametrize("name", sorted(HEADERS))
def test_header_round_trips_through_bcf_text(name):
    """A header read back from its BCF text (with IDX=) is JAX's."""
    text = JHeader(HEADERS[name]).text(with_idx=True)
    _same_header(THeader(text), JHeader(text))


def test_header_edits_match_jax():
    t, j = THeader(HEADERS["matrix"]), JHeader(HEADERS["matrix"])
    for h in (t, j):
        h.append_line('##INFO=<ID=NEW,Number=1,Type=Integer,Description="n">')
        h.remove_hrec("INFO", "I2")
        h.add_missing_contig("chrUn")
    _same_header(t, j)
    assert t.check_sanity() == j.check_sanity()
    _same_header(t.copy(), j.copy())


# ---------------------------------------------------------------------------
# records over the type matrix
# ---------------------------------------------------------------------------

INT_RANGES = {"int8": (-120, 127), "int16": (-32760, 32767),
              "int32": (-2147483640, 2147483647)}


def _int(rng, kind):
    lo, hi = INT_RANGES[kind]
    return str(int(rng.integers(lo, hi + 1)))


def _float(rng):
    pick = rng.integers(8)
    if pick == 0:
        return "."
    if pick == 1:
        return f"{rng.normal() * 1e6:.1f}"
    if pick == 2:
        return f"{rng.random() * 1e-5:.3e}"
    if pick == 3:
        return ["inf", "-inf", "0", "-0", "1e38"][int(rng.integers(5))]
    return f"{rng.normal() * 10:.{int(rng.integers(0, 7))}f}"


def _word(rng, n=None):
    n = int(rng.integers(1, 9)) if n is None else n
    return "".join(chr(c) for c in rng.integers(97, 123, n))


def _count(number, n_alt, rng):
    return {"1": 1, "2": 2, "A": n_alt, "R": n_alt + 1,
            "G": (n_alt + 1) * (n_alt + 2) // 2}.get(
                number, int(rng.integers(1, 5)))


def _ints(rng, k, kind):
    return ",".join("." if rng.random() < 0.1 else _int(rng, kind)
                    for _ in range(max(k, 1)))


def _gt(rng, n_alt, v44):
    pick = rng.integers(10)
    if pick == 0:
        return ["./.", ".", ".|.", "./1"][int(rng.integers(4))]
    if pick == 1:                       # haploid
        return str(int(rng.integers(0, n_alt + 1)))
    if pick == 2:                       # triploid
        return "/".join(str(int(a)) for a in rng.integers(0, n_alt + 1, 3))
    sep = "|" if rng.random() < 0.4 else "/"
    gt = f"{rng.integers(0, n_alt + 1)}{sep}{rng.integers(0, n_alt + 1)}"
    if v44 and rng.random() < 0.3:
        gt = ("|" if rng.random() < 0.5 else "/") + gt
    return gt


INFO_KEYS = [("I1", "1", "i"), ("I2", "2", "i"), ("IA", "A", "i"),
             ("IR", "R", "i"), ("IG", "G", "i"), ("ID", ".", "i"),
             ("F1", "1", "f"), ("F2", "2", "f"), ("FA", "A", "f"),
             ("FR", "R", "f"), ("FG", "G", "f"), ("FD", ".", "f"),
             ("S1", "1", "s"), ("SD", ".", "s"), ("C1", "1", "c"),
             ("FL", "0", "flag")]
FMT_KEYS = [("XI1", "1", "i"), ("XI2", "2", "i"), ("XIA", "A", "i"),
            ("XIR", "R", "i"), ("XIG", "G", "i"), ("XID", ".", "i"),
            ("XF1", "1", "f"), ("XFA", "A", "f"), ("XFD", ".", "f"),
            ("XS", "1", "s"), ("XC", "1", "c")]


def matrix_line(rng, pos, v44=False):
    """One seeded VCF line over the type matrix."""
    kind = ["int8", "int16", "int32"][int(rng.integers(3))]
    ref = "".join("ACGT"[i] for i in rng.integers(
        0, 4, 1 if rng.random() < 0.8 else int(rng.integers(2, 9))))
    pick = rng.integers(6)
    if pick == 0:
        alts = []
    elif pick == 1:
        alts = [["<DEL>", "<*>", "<NON_REF>", "<INS:ME>"][
            int(rng.integers(4))]]
    else:
        alts = [a for a in "ACGT" if a != ref[0]][:int(rng.integers(1, 4))]
        if rng.random() < 0.2:
            alts.append("<*>")
    n_alt = len(alts)
    chrom = ["1", "2", "X"][int(rng.integers(3))]
    rid = ";".join(f"rs{rng.integers(1, 10**8)}" for _ in range(
        int(rng.integers(1, 3)))) if rng.random() < 0.5 else "."
    qual = "." if rng.random() < 0.2 else [
        f"{rng.random() * 100:.1f}", str(int(rng.integers(0, 10**4))),
        f"{rng.random() * 1e4:.3e}"][int(rng.integers(3))]
    flt = ["PASS", ".", "q10", "q10;LowQual", "LowQual;q10"][
        int(rng.integers(5))]
    info = []
    for key, number, typ in INFO_KEYS:
        if rng.random() < 0.45:
            continue
        k = _count(number, n_alt, rng)
        if typ == "i":
            info.append(f"{key}={_ints(rng, k, kind)}")
        elif typ == "f":
            info.append(f"{key}=" + ",".join(_float(rng)
                                             for _ in range(max(k, 1))))
        elif typ == "s":
            info.append(f"{key}=" + ",".join(_word(rng)
                                             for _ in range(max(k, 1))))
        elif typ == "c":
            info.append(f"{key}={_word(rng, 1)}")
        else:
            info.append(key)
    if rng.random() < 0.15:
        info.append(f"END={pos + int(rng.integers(1, 500))}")
    order = rng.permutation(len(info))
    info_s = ";".join(info[i] for i in order) if info else "."
    fmt = [k for k in FMT_KEYS if rng.random() < 0.5]
    keys = (["GT"] if rng.random() < 0.85 else []) + [k[0] for k in fmt]
    cols = []
    for s in range(len(SAMPLES)):
        if rng.random() < 0.05:
            cols.append(".")
            continue
        vals = []
        for key in keys:
            if key == "GT":
                vals.append(_gt(rng, n_alt, v44))
                continue
            _, number, typ = next(k for k in FMT_KEYS if k[0] == key)
            k = _count(number, n_alt, rng)
            if s == 1 and k > 1 and rng.random() < 0.5:
                k -= 1                  # a shorter vector: end-of-vector pad
            if rng.random() < 0.08:
                vals.append(".")
            elif typ == "i":
                vals.append(_ints(rng, k, kind))
            elif typ == "f":
                vals.append(",".join(_float(rng) for _ in range(max(k, 1))))
            elif typ == "s":
                vals.append(_word(rng))
            else:
                vals.append(_word(rng, 1))
        if vals and rng.random() < 0.1:
            vals = vals[:int(rng.integers(1, len(vals) + 1))]
        cols.append(":".join(vals) if vals else ".")
    row = [chrom, str(pos), rid, ref, ",".join(alts) or ".", qual, flt,
           info_s]
    if keys:
        row += [":".join(keys)] + cols
    return "\t".join(row)


GROUPS = 20
PER_GROUP = 15


def matrix_lines(group):
    v44 = group >= 16
    rng = np.random.default_rng(1000 + group)
    pos = np.cumsum(rng.integers(1, 5000, PER_GROUP)) + 100
    return v44, [matrix_line(rng, int(p), v44) for p in pos]


@pytest.mark.parametrize("group", range(GROUPS))
def test_records_match_jax(group):
    """Each line: from_vcf -> to_bcf bytes are JAX's, and from_bcf of
    them -> to_vcf text is JAX's (and the text printed from the parse)."""
    v44, lines = matrix_lines(group)
    text = HEADERS["v44" if v44 else "matrix"]
    th, jh = THeader(text), JHeader(text)
    for line in lines:
        tr, jr = TRecord.from_vcf(line, th), JRecord.from_vcf(line, jh)
        assert tr.to_vcf(th) == jr.to_vcf(jh), line
        shared, indiv = tr.to_bcf()
        assert (shared, indiv) == jr.to_bcf(), line
        tb = TRecord.from_bcf(shared, indiv, th)
        jb = JRecord.from_bcf(shared, indiv, jh)
        assert tb.to_vcf(th) == jb.to_vcf(jh), line
        assert tb.rlen == jb.rlen and tb.to_bcf() == jb.to_bcf()
    _same_header(th, jh)


def test_records_cover_the_matrix():
    """The seeded lines reach each width of integer, each Number, the
    missing and end-of-vector sentinels, and each GT kind."""
    widths, gts, seen = set(), set(), set()
    for group in range(GROUPS):
        for line in matrix_lines(group)[1]:
            r = TRecord.from_vcf(line, THeader(HEADERS["matrix"]))
            for e in r.fmt:
                if e.is_gt:
                    for row in e.value.tolist():
                        n = sum(v != -2147483647 for v in row)
                        gts.add("missing" if row[0] == 0 else
                                "haploid" if n == 1 else
                                "phased" if any(v & 1 for v in row[1:n])
                                else "diploid")
                elif e.type == 1 and (e.value == -2147483647).any():
                    seen.add("vector_end")
            for e in r.info:
                if e.type == 1 and e.value is not None:
                    a = e.value[e.value != -2147483648]
                    if (e.value == -2147483648).any():
                        seen.add("missing")
                    if len(a):
                        lo, hi = int(a.min()), int(a.max())
                        widths.add("int8" if -120 <= lo and hi <= 127 else
                                   "int16" if -32760 <= lo and hi <= 32767
                                   else "int32")
            seen.add(len(r.alleles) - 1)
            if r.alleles[-1].startswith("<"):
                seen.add("symbolic")
            if len(r.filters) > 1:
                seen.add("filters")
            if ";" in r.id:
                seen.add("ids")
    assert widths == {"int8", "int16", "int32"}
    assert gts == {"missing", "haploid", "phased", "diploid"}
    assert {"missing", "vector_end", "symbolic", "filters", "ids", 0, 1, 2,
            3} <= seen


# ---------------------------------------------------------------------------
# the record-edit API
# ---------------------------------------------------------------------------

EDIT_LINE = ("1\t100\trs1\tA\tC,G\t50\tq10\tI1=5;FA=0.5,0.25;S1=x;FL\t"
             "GT:XI1:XFA:XS\t0/1:3:0.1,0.2:ab\t1|2:.:.:c\t./.:7:1,2:.")

EDITS = {
    "update_info": lambda r, h: r.update_info(h, "IA", [1, 200]),
    "update_info_remove": lambda r, h: r.update_info(h, "S1", None),
    "update_info_flag": lambda r, h: r.update_info(h, "FL", None),
    "update_info_float": lambda r, h: r.update_info(h, "F2", [1.5, None]),
    "update_info_string": lambda r, h: r.update_info(h, "S1", "new"),
    "update_format": lambda r, h: r.update_format(
        h, "XI2", [[1, 2], [300, None], [5]]),
    "update_format_float": lambda r, h: r.update_format(
        h, "XF1", [[0.5], [None], [2.0]]),
    "update_format_string": lambda r, h: r.update_format_string(
        h, "XS", ["long", "", "z"]),
    "update_genotypes": lambda r, h: r.update_genotypes(
        h, [[2, 5], [3], [0, 0]]),
    "update_alleles": lambda r, h: r.update_alleles(h, ["AT", "A"]),
    "update_alleles_str": lambda r, h: r.update_alleles_str(h, "G,<DEL>"),
    "update_filter": lambda r, h: r.update_filter(
        h, [h.id2int("LowQual"), h.id2int("q10")]),
    "add_filter": lambda r, h: r.add_filter(h, h.id2int("LowQual")),
    "add_filter_pass": lambda r, h: r.add_filter(h, 0),
    "remove_filter": lambda r, h: r.remove_filter(h, h.id2int("q10")),
    "has_filter": lambda r, h: r.has_filter(h, "q10"),
    "update_id": lambda r, h: r.update_id("rs9"),
    "add_id": lambda r, h: r.add_id("rs2"),
    "add_id_present": lambda r, h: r.add_id("rs1"),
}


@pytest.mark.parametrize("name", sorted(EDITS))
def test_record_edit_matches_jax(name):
    """One edit on a parsed record and on one decoded from BCF: the same
    return value, VCF text and BCF bytes as JAX's."""
    th, jh = THeader(HEADERS["matrix"]), JHeader(HEADERS["matrix"])
    t0, j0 = TRecord.from_vcf(EDIT_LINE, th), JRecord.from_vcf(EDIT_LINE, jh)
    tb = TRecord.from_bcf(*t0.to_bcf(), th)
    jb = JRecord.from_bcf(*j0.to_bcf(), jh)
    for tr, jr in ((t0, j0), (tb, jb)):
        assert EDITS[name](tr, th) == EDITS[name](jr, jh)
        assert tr.to_vcf(th) == jr.to_vcf(jh)
        assert tr.to_bcf() == jr.to_bcf()
        assert tr.rlen == jr.rlen


def test_get_rlen_and_formatters_match_jax():
    from htslib_tpu.vcf import record as jrec
    from htslib_tpu_torch.vcf import record as trec
    th, jh = THeader(HEADERS["matrix"]), JHeader(HEADERS["matrix"])
    for group in range(4):
        for line in matrix_lines(group)[1]:
            assert trec.get_rlen(th, TRecord.from_vcf(line, th)) == \
                jrec.get_rlen(jh, JRecord.from_vcf(line, jh))
    rng = np.random.default_rng(3)
    bits = np.concatenate([
        rng.integers(0, 1 << 32, 2000, dtype=np.uint64).astype(np.uint32),
        np.array([0x7F800001, 0x7F800002, 0x7F800000, 0, 0x80000000],
                 np.uint32)])
    assert trec._fmt_float_arr(bits) == jrec._fmt_float_arr(bits)
    for x in rng.normal(size=200) * 10.0 ** rng.integers(-8, 9, 200):
        assert trec._fmt_g(float(x)) == jrec._fmt_g(float(x))
    ints = np.array([1, -2147483648, 5, -2147483647], np.int32)
    assert trec._fmt_int_arr(ints) == jrec._fmt_int_arr(ints)
    for gt in ([2, 5], [3, -2147483647], [0, 0], [4], [1, 3, 5]):
        for v44 in (False, True):
            g = np.array(gt, np.int32)
            assert trec._fmt_gt(g, v44) == jrec._fmt_gt(g, v44)


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------

def matrix_vcf(groups=range(4)):
    """Header and body text of the matrix lines of `groups`, sorted by
    contig and position (v4.2 groups only)."""
    lines = [ln for g in groups for ln in matrix_lines(g)[1]]
    order = {"1": 0, "2": 1, "X": 2}
    lines.sort(key=lambda ln: (order[ln.split("\t")[0]],
                               int(ln.split("\t")[1])))
    return HEADERS["matrix"], "\n".join(lines) + "\n"


def write_port_bcf(path, level=-1, groups=range(4), repeat=1):
    text, body = matrix_vcf(groups)
    h = THeader(text)
    with tio.BcfWriter(path, h, level=level) as w:
        for line in body.splitlines():
            for _ in range(repeat):
                w.write(TRecord.from_vcf(line, h))
    return path


def write_jax_bcf(path, monkeypatch=None, level=-1, groups=range(4)):
    """The JAX BcfWriter's file; with `monkeypatch`, its pure-Python
    path (zlib)."""
    if monkeypatch is not None:
        monkeypatch.setattr("htslib_tpu.native.native", None)
    text, body = matrix_vcf(groups)
    h = JHeader(text)
    with jio.BcfWriter(path, h, level=level) as w:
        for line in body.splitlines():
            w.write(JRecord.from_vcf(line, h))
    if monkeypatch is not None:
        monkeypatch.undo()
    return path


def _zlib_stream(path):
    raw = open(path, "rb").read()
    return tbgzf.inflate_host(np.frombuffer(raw, np.uint8),
                              tbgzf.scan_blocks(raw))


def _read_text(reader_cls, path):
    with reader_cls(path) as r:
        return [rec.to_vcf(r.header) for rec in r], r.header.text()


def test_bcf_writer_stream_matches_jax(tmp_path):
    """The port's BcfWriter: its file is the JAX writer's byte for byte,
    with both deflating by libdeflate (both native libraries on) and
    with both deflating by zlib (both off)."""
    port = write_port_bcf(str(tmp_path / "p.bcf"))
    jax_native = write_jax_bcf(str(tmp_path / "j.bcf"))
    assert _zlib_stream(port) == _zlib_stream(jax_native)
    assert open(port, "rb").read() == open(jax_native, "rb").read()
    mp = pytest.MonkeyPatch()
    mp.setattr("htslib_tpu_torch.native.native", None)
    try:
        port_py = write_port_bcf(str(tmp_path / "pp.bcf"))
    finally:
        mp.undo()
    jax_py = write_jax_bcf(str(tmp_path / "jp.bcf"), mp)
    assert open(port_py, "rb").read() == open(jax_py, "rb").read()


def test_each_side_reads_the_others_bcf(tmp_path):
    port = write_port_bcf(str(tmp_path / "p.bcf"))
    jax = write_jax_bcf(str(tmp_path / "j.bcf"))
    want = _read_text(jio.BcfReader, jax)
    for path in (port, jax):
        assert _read_text(tio.BcfReader, path) == want
        assert _read_text(jio.BcfReader, path) == want


def test_bcf_reader_tell_seek_match_jax(tmp_path):
    """Virtual offsets of BcfReader and BgzfReader over a file of several
    members, and seeks back to them."""
    path = write_port_bcf(str(tmp_path / "p.bcf"), groups=range(16),
                          repeat=3)
    assert len(tbgzf.scan_blocks(open(path, "rb").read()).coffsets) > 2
    offs = []
    with tio.BcfReader(path) as t, jio.BcfReader(path) as j:
        while True:
            assert t.tell() == j.tell()
            offs.append(t.tell())
            tr, jr = t.read1(), j.read1()
            assert (tr is None) == (jr is None)
            if tr is None:
                break
            assert tr.to_vcf(t.header) == jr.to_vcf(j.header)
        for k in (len(offs) - 2, 0, len(offs) // 2):
            t.seek(offs[k])
            j.seek(offs[k])
            assert t.read1().to_vcf(t.header) == j.read1().to_vcf(j.header)
    with tbgzf.BgzfReader(path) as t, jbgzf.BGZFReader(path) as j:
        assert t.peek(40) == j.peek(40)
        for n in (5, 70_000, 3, 100_000):
            assert t.read(n) == j.read(n) and t.tell() == j.tell()
        assert t.readline() == j.readline()
        assert np.array_equal(t.read_all(), j.read_all())


@pytest.mark.parametrize("kind", ["plain", "gzip", "bgzf"])
def test_vcf_reader_matches_jax(tmp_path, kind):
    text, body = matrix_vcf()
    blob = (text + body).encode()
    path = str(tmp_path / f"t.{kind}.vcf")
    if kind == "gzip":
        blob = gzip.compress(blob)
    elif kind == "bgzf":
        with tbgzf.BgzfWriter(path) as w:
            w.write(blob)
    if kind != "bgzf":
        open(path, "wb").write(blob)
    want = _read_text(jio.VcfReader, path)
    assert _read_text(tio.VcfReader, path) == want
    with open(path, "rb") as fp:        # a binary file object
        assert _read_text(tio.VcfReader, fp) == want
    assert len(want[0]) == len(body.splitlines())


def test_vcf_writer_matches_jax(tmp_path):
    text, body = matrix_vcf()
    for compress in (False, True):
        out = []
        for hdr_cls, rec_cls, w_cls, name in (
                (THeader, TRecord, tio.VcfWriter, "t"),
                (JHeader, JRecord, jio.VcfWriter, "j")):
            h = hdr_cls(text)
            path = str(tmp_path / f"{name}{compress}.vcf")
            with w_cls(path, h, compress=compress) as w:
                for line in body.splitlines():
                    w.write(rec_cls.from_vcf(line, h))
            raw = open(path, "rb").read()
            out.append(gzip.decompress(raw) if compress else raw)
        assert out[0] == out[1]


def uncompressed_bcf(path, groups=range(4)):
    """A BCF with no BGZF: the magic, the header and the record frames
    as they are."""
    text, body = matrix_vcf(groups)
    h = JHeader(text)
    head = h.text(with_idx=True).encode() + b"\0"
    frames = bytearray()
    for line in body.splitlines():
        shared, indiv = JRecord.from_vcf(line, h).to_bcf()
        frames += struct.pack("<II", len(shared), len(indiv)) + shared + indiv
    with open(path, "wb") as fp:
        fp.write(tio.BCF_MAGIC + struct.pack("<I", len(head)) + head + frames)
    return path


def test_uncompressed_bcf_is_read(tmp_path, monkeypatch):
    """Both readers read it; bcf_file_to_vcf gives the JAX Python path's
    text and inflates nothing (a spy in place of inflate_batch must not
    run).  The JAX native path refuses the file (queue C)."""
    path = uncompressed_bcf(str(tmp_path / "u.bcf"))
    want = _read_text(jio.BcfReader, path)
    assert _read_text(tio.BcfReader, path) == want
    with pytest.raises(IOError, match="BGZF scan failed"):
        jio.bcf_file_to_vcf(path)
    monkeypatch.setattr("htslib_tpu.native.native", None)

    def spy(*a, **k):
        raise AssertionError("inflate_batch called on an uncompressed BCF")
    monkeypatch.setattr(tbgzf, "inflate_batch", spy)
    timing = {}
    header, body = tio.bcf_file_to_vcf(path, device="cpu", timing=timing)
    assert body == bytes(jio.bcf_file_to_vcf(path)[1])
    assert header.text() == want[1]
    assert set(timing) == {"read_s", "frame_s", "format_s"}


@pytest.mark.parametrize("writer", ["port_level0", "port_level6", "jax"])
def test_bcf_file_to_vcf_matches_jax(tmp_path, writer, monkeypatch):
    """device="cpu": the members through the plain inflate; the text is
    JAX's under both of its paths (native bcf_to_vcf and the Python
    formatter), and the header is JAX's."""
    path = str(tmp_path / "f.bcf")
    if writer == "jax":
        write_jax_bcf(path, level=0)
    else:
        write_port_bcf(path, level=int(writer[-1]),
                       groups=range(4) if writer.endswith("0") else [0])
    want_h, want = jio.bcf_file_to_vcf(path)
    timing = {}
    header, body = tio.bcf_file_to_vcf(path, device="cpu", timing=timing)
    assert body == bytes(want)
    assert header.text(with_idx=True) == want_h.text(with_idx=True)
    assert set(timing) == {"read_s", "inflate_s", "frame_s", "format_s"}
    monkeypatch.setattr("htslib_tpu.native.native", None)
    assert body == bytes(jio.bcf_file_to_vcf(path)[1])
    with open(path, "rb") as fp:         # a binary file object
        assert tio.bcf_file_to_vcf(fp, device="cpu")[1] == body


def test_jax_bcf_to_vcf_paths_agree(tmp_path, monkeypatch):
    """Queue C record: the JAX package's two BCF -> VCF paths (native
    bcf_to_vcf and the Python formatter) give the same text on these
    fixtures (16 groups of the matrix, and the 4 v4.4 groups), and so
    does the port on its native route (native bcf_to_vcf after the
    device inflate)."""
    files = [write_jax_bcf(str(tmp_path / "a.bcf"), level=0,
                           groups=range(16))]
    h = JHeader(HEADERS["v44"])
    files.append(str(tmp_path / "v44.bcf"))
    with jio.BcfWriter(files[-1], h, level=0) as w:
        for g in range(16, GROUPS):
            for line in matrix_lines(g)[1]:
                w.write(JRecord.from_vcf(line, h))
    native = [bytes(jio.bcf_file_to_vcf(p)[1]) for p in files]
    monkeypatch.setattr("htslib_tpu.native.native", None)
    py = [bytes(jio.bcf_file_to_vcf(p)[1]) for p in files]
    assert native == py
    assert [tio.bcf_file_to_vcf(p, device="cpu")[1] for p in files] == py


def test_vcf_file_to_bcf_matches_jax(tmp_path, monkeypatch):
    """The port's vcf_file_to_bcf (plain and gzip input): its file
    decodes to the text of the JAX function's file, record counts equal,
    and the files are equal byte for byte with both native libraries on
    (libdeflate) and with both off (zlib)."""
    text, body = matrix_vcf(range(16))
    src = str(tmp_path / "in.vcf")
    open(src, "w").write(text + body)
    gz = str(tmp_path / "in.vcf.gz")
    open(gz, "wb").write(gzip.compress((text + body).encode()))
    jdst = str(tmp_path / "j.bcf")
    n = jio.vcf_file_to_bcf(src, jdst)
    want = bytes(jio.bcf_file_to_vcf(jdst)[1])
    for s in (src, gz):
        tdst = str(tmp_path / "t.bcf")
        assert tio.vcf_file_to_bcf(s, tdst) == n
        assert bytes(jio.bcf_file_to_vcf(tdst)[1]) == want
        assert _zlib_stream(tdst) == _zlib_stream(jdst)
        assert open(tdst, "rb").read() == open(jdst, "rb").read()
    monkeypatch.setattr("htslib_tpu.native.native", None)
    monkeypatch.setattr("htslib_tpu_torch.native.native", None)
    jpy = str(tmp_path / "jp.bcf")
    assert jio.vcf_file_to_bcf(src, jpy) == n
    assert tio.vcf_file_to_bcf(src, tdst) == n
    assert open(jpy, "rb").read() == open(tdst, "rb").read()
    assert tio.vcf_body_to_bcf_frames(b"", THeader(text)) == b""


def test_open_vcf_matches_jax(tmp_path):
    text, body = matrix_vcf()
    vcf = str(tmp_path / "a.vcf")
    open(vcf, "w").write(text + body)
    bcf = write_port_bcf(str(tmp_path / "a.bcf"))
    gz = str(tmp_path / "a.vcf.gz")
    with tbgzf.BgzfWriter(gz) as w:
        w.write((text + body).encode())
    for path, cls in ((vcf, tio.VcfReader), (bcf, tio.BcfReader),
                      (gz, tio.VcfReader)):
        r = tio.open_vcf(path)
        assert isinstance(r, cls)
        got = [rec.to_vcf(r.header) for rec in r]
        r.close()
        j = jio.open_vcf(path)
        assert got == [rec.to_vcf(j.header) for rec in j]
        j.close()
    sam = str(tmp_path / "a.sam")
    open(sam, "w").write("@HD\tVN:1.6\n@SQ\tSN:1\tLN:10\n")
    with pytest.raises(IOError) as te:
        tio.open_vcf(sam)
    with pytest.raises(IOError) as je:
        jio.open_vcf(sam)
    assert str(te.value) == str(je.value)
    h = THeader(text)
    for mode, cls in (("w", tio.VcfWriter), ("wz", tio.VcfWriter),
                      ("wb", tio.BcfWriter), ("wbu", tio.VcfWriter)):
        w = tio.open_vcf(str(tmp_path / f"o.{mode}"), mode, h)
        assert type(w) is cls
        w.close()
    with pytest.raises(ValueError):
        tio.open_vcf(str(tmp_path / "o"), "w")


def test_detect_format_matches_jax():
    rng = np.random.default_rng(5)
    text, body = matrix_vcf()
    blobs = [b"", (text + body).encode(), gzip.compress(b"BCF\x02\x02abc"),
             b"BCF\x02\x01xyz", b"BAM\x01", b"CRAM\x03\x00",
             b"@HD\tVN:1.6\n", b">chr1\nACGT\n", b"@r\nACGT\n+\nIIII\n",
             b"chr1\t10\t20\n", b"{\"htsget\": 1}", b"plain words\n",
             zlib.compress(b"x"), rng.integers(0, 256, 600, np.uint8)
             .tobytes()]
    blobs.append(tbgzf.compress_block(b"##fileformat=VCFv4.3\n"))
    for blob in blobs:
        t, j = tformat.detect_format(blob), jformat.detect_format(blob)
        assert (t.format.name, t.category.name, t.compression.name,
                t.version_major, t.version_minor, t.description()) == (
            j.format.name, j.category.name, j.compression.name,
            j.version_major, j.version_minor, j.description())


def test_bcf_writer_refuses_an_index(tmp_path, monkeypatch):
    """BcfWriter(build_index=True) refuses, at close, to index records
    out of position order, as the JAX writer does (hts_idx_push,
    hts.c:2558); in order it writes the file's .csi."""
    text, body = matrix_vcf()
    lines = body.splitlines()
    for mod, header, record, name in (
            (tio, THeader, TRecord, "t"), (jio, JHeader, JRecord, "j")):
        h = header(text)
        w = mod.BcfWriter(str(tmp_path / f"{name}.bcf"), h,
                          build_index=True)
        for line in lines[1::-1]:
            w.write(record.from_vcf(line, h))
        with pytest.raises(ValueError, match="Unsorted positions"):
            w.close()
    h = THeader(text)
    with tio.BcfWriter(str(tmp_path / "s.bcf"), h, build_index=True) as w:
        for line in lines:
            w.write(TRecord.from_vcf(line, h))
    with tio.BcfReader(str(tmp_path / "s.bcf")) as r:
        assert len(list(r.fetch(0, 0, 1 << 30))) == sum(
            ln.split("\t")[0] == "1" for ln in lines)


def test_bgzf_writer_tell_matches_jax(tmp_path):
    """Virtual offsets of the port's BgzfWriter are the JAX writer's at
    member boundaries and within a member."""
    rng = np.random.default_rng(7)
    chunks = [rng.integers(0, 4, int(n), np.uint8).tobytes()
              for n in rng.integers(1, 40_000, 12)]
    t = tbgzf.BgzfWriter(io.BytesIO())
    mp = pytest.MonkeyPatch()
    mp.setattr("htslib_tpu.native.native", None)
    mp.setattr("htslib_tpu_torch.native.native", None)
    j = jbgzf.BGZFWriter(io.BytesIO())
    for c in chunks:
        t.write(c)
        j.write(c)
        j._drain()                      # the JAX writer holds up to 64
        assert t.tell() == j.tell()
    t.flush()
    j.flush()
    assert t.tell() == j.tell()
    mp.undo()


def test_log_warning_matches_jax(capsys):
    from htslib_tpu.util import log as jlog
    from htslib_tpu_torch.util import log as tlog
    tlog.log_warning("Duplicate FORMAT tag %s at %d", "DP", 5)
    got = capsys.readouterr().err
    jlog.log_warning("Duplicate FORMAT tag %s at %d", "DP", 5)
    assert got == capsys.readouterr().err
    assert got.startswith("[W::")
