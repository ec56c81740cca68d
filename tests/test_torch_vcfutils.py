"""The port's vcfutils.py against the JAX package's on seeded VCF and BCF
files: `calc_ac` (INFO and FORMAT), `gt_type` of every sample,
`trim_alleles` and `remove_alleles` over Number=A/R/G INFO and FORMAT
fields, strings among them, and VCFv4.5 local alleles (LAA with
Number=LA/LR/LG fields), records compared as VCF text; and the genotype
index helpers.  Each package reads the files with its own readers."""
import numpy as np
import pytest

from htslib_tpu import vcfutils as jv
from htslib_tpu.vcf import open_vcf as j_open
from htslib_tpu_torch import vcfutils as tv
from htslib_tpu_torch.vcf import open_vcf as t_open
from htslib_tpu_torch.vcf.io import BcfWriter, VcfWriter

SAMPLES = ["S1", "S2", "S3", "S4"]

HEADER = """##fileformat=VCFv4.5
##INFO=<ID=AF,Number=A,Type=Float,Description="d">
##INFO=<ID=IR,Number=R,Type=Integer,Description="d">
##INFO=<ID=IG,Number=G,Type=Integer,Description="d">
##INFO=<ID=SA,Number=A,Type=String,Description="d">
##INFO=<ID=SG,Number=G,Type=String,Description="d">
##INFO=<ID=AN,Number=1,Type=Integer,Description="d">
##INFO=<ID=AC,Number=A,Type=Integer,Description="d">
##INFO=<ID=DP,Number=1,Type=Integer,Description="d">
##INFO=<ID=END,Number=1,Type=Integer,Description="d">
##INFO=<ID=FL,Number=0,Type=Flag,Description="d">
##FORMAT=<ID=GT,Number=1,Type=String,Description="d">
##FORMAT=<ID=AD,Number=R,Type=Integer,Description="d">
##FORMAT=<ID=PL,Number=G,Type=Integer,Description="d">
##FORMAT=<ID=GL,Number=G,Type=Float,Description="d">
##FORMAT=<ID=FA,Number=A,Type=Float,Description="d">
##FORMAT=<ID=RS,Number=R,Type=String,Description="d">
##FORMAT=<ID=LAA,Number=.,Type=Integer,Description="d">
##FORMAT=<ID=LAD,Number=LR,Type=Integer,Description="d">
##FORMAT=<ID=LPL,Number=LG,Type=Integer,Description="d">
##FORMAT=<ID=LAF,Number=LA,Type=Float,Description="d">
##contig=<ID=1,length=1000000>
##contig=<ID=2,length=1000000>
##contig=<ID=3,length=1000000>
#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t""" + "\t".join(
    SAMPLES) + "\n"


def _alleles(rng):
    """REF and 1-4 distinct ALTs: SNPs, insertions, deletions, a
    symbolic <DEL> (with END) or the * allele."""
    ref = "".join(rng.choice(list("ACGT"), int(rng.integers(1, 4))))
    alts = []
    while len(alts) < int(rng.integers(1, 5)):
        k = rng.random()
        if k < 0.5:
            a = str(rng.choice([c for c in "ACGT" if c != ref[0]]))
        elif k < 0.7:
            a = ref + "".join(rng.choice(list("ACGT"), int(rng.integers(1, 4))))
        elif k < 0.85:
            a = ref[0]
        elif k < 0.93:
            a = "<DEL>"
        else:
            a = "*"
        if a != ref and a not in alts:
            alts.append(a)
    return ref, alts


def _vec(rng, n, fmt, miss=0.1):
    if rng.random() < miss:
        return "."
    return ",".join(fmt(rng) for _ in range(n))


def _record(rng, chrom, pos):
    ref, alts = _alleles(rng)
    nr = len(alts) + 1
    ng = nr * (nr + 1) // 2
    fi = lambda r: str(int(r.integers(0, 200)))            # noqa: E731
    ff = lambda r: "%g" % round(float(r.random()), 3)       # noqa: E731
    fs = lambda r: "".join(r.choice(list("xyzw"), 2))       # noqa: E731
    info = []
    if rng.random() < 0.7:
        info.append("AF=" + _vec(rng, nr - 1, ff, 0))
    if rng.random() < 0.5:
        info.append("IR=" + _vec(rng, nr, fi, 0))
    if rng.random() < 0.5:
        info.append("IG=" + _vec(rng, ng, fi, 0))
    if rng.random() < 0.3:
        info.append("SA=" + _vec(rng, nr - 1, fs, 0))
    if rng.random() < 0.3:
        info.append("SG=" + _vec(rng, ng, fs, 0))
    if rng.random() < 0.4:
        acs = [int(rng.integers(0, 3)) for _ in alts]
        info.append(f"AN={sum(acs) + int(rng.integers(0, 4))}")
        info.append("AC=" + ",".join(map(str, acs)))
    if "<DEL>" in alts:
        info.append(f"END={pos + int(rng.integers(10, 500))}")
    if rng.random() < 0.2:
        info.append("FL")
    keys = ["GT", "AD", "PL", "GL", "FA", "RS"]
    local = rng.random() < 0.4
    if local:
        keys += ["LAA", "LAD", "LPL", "LAF"]
    cells = []
    for _ in SAMPLES:
        ploidy = int(rng.choice([1, 2, 2, 2]))
        gt = [str(int(rng.integers(0, nr))) if rng.random() > 0.08 else "."
              for _ in range(ploidy)]
        vals = [("|" if rng.random() < 0.3 else "/").join(gt),
                _vec(rng, nr, fi), _vec(rng, ng, fi), _vec(rng, ng, ff),
                _vec(rng, nr - 1, ff), _vec(rng, nr, fs)]
        if local:
            k = int(rng.integers(0, min(2, nr - 1) + 1))
            laa = sorted(rng.choice(np.arange(1, nr), k, replace=False)
                         .tolist()) if k else []
            vals += [",".join(map(str, laa)) if laa else ".",
                     _vec(rng, k + 1, fi, 0.05),
                     _vec(rng, (k + 1) * (k + 2) // 2, fi, 0.05),
                     _vec(rng, k, ff, 0.05) if k else "."]
        cells.append(":".join(vals))
    return "\t".join([chrom, str(pos), ".", ref, ",".join(alts),
                      str(int(rng.integers(1, 99))), "PASS",
                      ";".join(info) or ".", ":".join(keys)] + cells)


def seeded_vcf(path, seed, n=60, chroms=("1", "2", "3")):
    """A seeded multi-allelic VCF over `chroms` (positions sorted)."""
    rng = np.random.default_rng(seed)
    lines = []
    for chrom in chroms:
        for pos in np.sort(rng.choice(np.arange(1, 5000), n // len(chroms),
                                      replace=False)):
            lines.append(_record(rng, chrom, int(pos)))
    with open(path, "w") as f:
        f.write(HEADER + "".join(ln + "\n" for ln in lines))


def to_bcf(vcf, bcf, index=False):
    """The VCF rewritten as BCF by the port's writer (stored BGZF)."""
    with t_open(vcf) as r, BcfWriter(bcf, r.header, level=0,
                                     build_index=index) as w:
        for rec in iter(r.read1, None):
            w.write(rec)


def to_vcf_gz(vcf, gz, index=None):
    """The VCF bgzipped (stored members) by the port's writer, with a
    tabix index where `index` is "tbi" or "csi"."""
    from htslib_tpu_torch.tbx import Tabix
    with t_open(vcf) as r, VcfWriter(gz, r.header, compress=True,
                                     level=0) as w:
        for rec in iter(r.read1, None):
            w.write(rec)
    if index:
        Tabix.build(gz, min_shift=14 if index == "csi" else 0)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("vcfutils")
    out = {}
    for seed in (1, 2, 3):
        vcf = str(d / f"s{seed}.vcf")
        seeded_vcf(vcf, seed)
        out[("vcf", seed)] = vcf
        to_bcf(vcf, str(d / f"s{seed}.bcf"))
        out[("bcf", seed)] = str(d / f"s{seed}.bcf")
    return out


def _records(path, opener):
    with opener(path) as r:
        return r.header, list(iter(r.read1, None))


def _outcome(fn):
    """fn()'s value, or its exception's type and text."""
    try:
        return fn()
    except Exception as e:          # noqa: BLE001 - compared across packages
        return (type(e).__name__, str(e))


KINDS = [(k, s) for k in ("vcf", "bcf") for s in (1, 2, 3)]


@pytest.mark.parametrize("kind", KINDS, ids=lambda k: f"{k[0]}{k[1]}")
def test_calc_ac_and_gt_type_match_jax(files, kind):
    th, trs = _records(files[kind], t_open)
    jh, jrs = _records(files[kind], j_open)
    assert len(trs) == len(jrs) > 0
    for a, b in zip(trs, jrs):
        for which in (tv.BCF_UN_INFO, tv.BCF_UN_FMT,
                      tv.BCF_UN_INFO | tv.BCF_UN_FMT):
            assert _outcome(lambda: tv.calc_ac(th, a, which)) == _outcome(
                lambda: jv.calc_ac(jh, b, which))
        ga, gb = a.get_fmt(th, "GT"), b.get_fmt(jh, "GT")
        for s in range(len(SAMPLES)):
            assert tv.gt_type(ga, s) == jv.gt_type(gb, s)


@pytest.mark.parametrize("kind", KINDS, ids=lambda k: f"{k[0]}{k[1]}")
def test_trim_alleles_matches_jax(files, kind):
    th, trs = _records(files[kind], t_open)
    jh, jrs = _records(files[kind], j_open)
    trimmed = 0
    for a, b in zip(trs, jrs):
        na = _outcome(lambda: tv.trim_alleles(th, a))
        assert na == _outcome(lambda: jv.trim_alleles(jh, b))
        assert a.to_vcf(th) == b.to_vcf(jh)
        trimmed += isinstance(na, int) and na > 0
    assert trimmed > 0


@pytest.mark.parametrize("kind", KINDS, ids=lambda k: f"{k[0]}{k[1]}")
def test_remove_alleles_matches_jax(files, kind):
    rng = np.random.default_rng(kind[1] * 7 + (kind[0] == "bcf"))
    th, trs = _records(files[kind], t_open)
    jh, jrs = _records(files[kind], j_open)
    local = done = 0
    for a, b in zip(trs, jrs):
        mask = rng.random(a.n_allele) < 0.4
        got = _outcome(lambda: tv.remove_alleles(th, a, mask.copy()))
        assert got == _outcome(lambda: jv.remove_alleles(jh, b, mask.copy()))
        assert a.to_vcf(th) == b.to_vcf(jh)
        local += "LAA" in a.to_vcf(th)
        done += got is None
    assert local > 0 and done > len(trs) // 2


def test_each_alt_removed_in_turn(files):
    """Every ALT removed in turn from each record, parsed afresh from its
    VCF line: Number=A fields emptied and dropped, G pairs and the
    local-allele maps rebuilt."""
    from htslib_tpu.vcf import BcfRecord as JRecord
    from htslib_tpu_torch.vcf import BcfRecord as TRecord
    th, _ = _records(files[("vcf", 2)], t_open)
    jh, _ = _records(files[("vcf", 2)], j_open)
    lines = [ln.rstrip("\n") for ln in open(files[("vcf", 2)])
             if not ln.startswith("#")]
    done = 0
    for line in lines[:30]:
        for i in range(1, line.split("\t")[4].count(",") + 2):
            a, b = TRecord.from_vcf(line, th), JRecord.from_vcf(line, jh)
            mask = np.zeros(a.n_allele, bool)
            mask[i] = True
            got = _outcome(lambda: tv.remove_alleles(th, a, mask))
            assert got == _outcome(lambda: jv.remove_alleles(jh, b, mask))
            assert a.to_vcf(th) == b.to_vcf(jh)
            done += got is None
    assert done > 30


def test_gt_index_helpers_match_jax():
    for g in range(200):
        assert tv.gt2alleles(g) == jv.gt2alleles(g)
    for j in range(12):
        for k in range(12):
            assert tv.alleles2gt(j, k) == jv.alleles2gt(j, k)
            assert tv.ij2G(j, k) == jv.ij2G(j, k)
    for c in "ACGTNacgtn*-":
        assert tv.acgt2int(c) == jv.acgt2int(c)
    for i in range(-1, 6):
        assert _outcome(lambda: tv.int2acgt(i)) == _outcome(
            lambda: jv.int2acgt(i))
