"""The port's synced_reader.py against the JAX package's on seeded VCF
and BCF files: every pairing mode over test/test-bcf-sr.pl's random
allele battery and over multi-file sets with several records a
position, regions and targets (each overlap mode) indexed (.csi for
BCF, .tbi and .csi for bgzipped VCF) and streaming (plain VCF, no
index), and the pieces beneath (variant_type, the pairing scores, the
region parser).  Rows are compared as each reader's record in VCF text."""
import os
import random

import numpy as np
import pytest

from htslib_tpu import synced_reader as js
from htslib_tpu_torch import synced_reader as ts
from tests.test_torch_vcfutils import to_bcf, to_vcf_gz

LOGICS = {
    "snps": ts.BCF_SR_PAIR_SNPS, "indels": ts.BCF_SR_PAIR_INDELS,
    "both": ts.BCF_SR_PAIR_BOTH,
    "snps+ref": ts.BCF_SR_PAIR_SNPS | ts.BCF_SR_PAIR_SNP_REF,
    "indels+ref": ts.BCF_SR_PAIR_INDELS | ts.BCF_SR_PAIR_INDEL_REF,
    "both+ref": ts.BCF_SR_PAIR_BOTH_REF, "exact": ts.BCF_SR_PAIR_EXACT,
    "some": ts.BCF_SR_PAIR_SOME, "all": ts.BCF_SR_PAIR_ANY,
    "id": ts.BCF_SR_PAIR_ID | ts.BCF_SR_PAIR_BOTH, "every": ts.BCF_SR_PAIR_ALL,
}

HDR = ("##fileformat=VCFv4.3\n"
       '##FILTER=<ID=PASS,Description="All filters passed">\n'
       '##INFO=<ID=END,Number=1,Type=Integer,Description="d">\n'
       "##contig=<ID=1,length=100000>\n##contig=<ID=2,length=100000>\n"
       "##contig=<ID=3,length=100000>\n"
       "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")


def rows(sr, n):
    """Every row of the reader: each reader's record as VCF text, or
    None; the pairing and the records both."""
    out = []
    while sr.next_line() > 0:
        out.append(tuple(sr.get_line(i).to_vcf(sr.get_header(i))
                         if sr.has_line(i) else None for i in range(n)))
    sr.close()
    return out


def both(paths, **kw):
    """The port's and the JAX reader's rows over `paths`."""
    got = []
    for mod in (ts, js):
        sr = mod.SyncedReader(**kw)
        for p in paths:
            sr.add_reader(p)
        got.append(rows(sr, len(paths)))
    return got


def battery(rng, d):
    """test-bcf-sr.pl's random VCF battery (tests/test_bcf_sr_parity.py
    gen_inputs): 1-10 variant sets of 1-6 REF>ALT records, each at 1:100,
    1:300 and 2:100, the files bgzipped with a .tbi by the port."""
    ref = rng.choice("ACGT")

    def alt_of(snp):
        a = rng.choice("ACGT")
        return "." if a == ref else (a if snp else ref + a)

    sets = []
    for _ in range(1 + rng.randrange(10)):
        vs = {}
        for _ in range(1 + rng.randrange(6)):
            snp = rng.randrange(2)
            alt = alt_of(snp)
            var = f"{ref}>{alt}"
            if alt != "." and not rng.randrange(5):
                alt2 = alt_of(snp)
                if alt2 != "." and alt != alt2:
                    var += f",{ref}>{alt2}"
            vs[var] = 1
        for _ in range(1 + rng.randrange(4)):
            k = list(vs)
            rng.shuffle(k)
            sets.append(k)
    rng.shuffle(sets)
    paths = []
    for i, vars_ in enumerate(sets):
        raw = os.path.join(d, f"{i}.vcf")
        with open(raw, "w") as f:
            f.write(HDR)
            for chrom, pos in (("1", 100), ("1", 300), ("2", 100)):
                for var in vars_:
                    als = var.split(",")
                    f.write("\t".join([chrom, str(pos), ".",
                                       als[0].split(">")[0],
                                       ",".join(a.split(">")[1]
                                                for a in als),
                                       ".", ".", "."]) + "\n")
        to_vcf_gz(raw, raw + ".gz", "tbi")
        paths.append(raw + ".gz")
    return paths


@pytest.mark.parametrize("seed", [101, 202, 303, 404])
@pytest.mark.parametrize("logic", sorted(LOGICS))
def test_random_battery_every_pairing(tmp_path, seed, logic):
    paths = battery(random.Random(seed), str(tmp_path))
    got, want = both(paths, pair=LOGICS[logic])
    assert got == want and got


def mixed_sets(d, seed, n_files=3):
    """n_files VCFs over shared positions of three contigs: each position
    a file holds gets 1-3 records (SNPs, MNPs, indels, a <DEL> with END,
    REF-only, the same allele twice), with IDs; the files as plain VCF,
    bgzipped VCF (.tbi and .csi) and BCF with its .csi."""
    rng = np.random.default_rng(seed)
    pool = [(c, int(p)) for c in ("1", "2", "3")
            for p in np.sort(rng.choice(np.arange(10, 3000), 25, False))]
    alts = ["C", "G", "T", "CA", "C,G", "<DEL>", ".", "G,CT", "T"]
    out = []
    for f in range(n_files):
        lines = []
        for chrom, pos in pool:
            if rng.random() < 0.35:
                continue
            for _ in range(int(rng.integers(1, 4))):
                alt = str(rng.choice(alts))
                ref = "A" if not alt.startswith("A") else "G"
                info = f"END={pos + 40}" if alt == "<DEL>" else "."
                rid = f"rs{int(rng.integers(1, 6))}" if rng.random() < 0.5 \
                    else "."
                lines.append("\t".join([chrom, str(pos), rid, ref, alt,
                                        "30", "PASS", info]))
        raw = os.path.join(d, f"m{seed}_{f}.vcf")
        with open(raw, "w") as fp:
            fp.write(HDR + "".join(ln + "\n" for ln in lines))
        to_vcf_gz(raw, raw + ".gz", "tbi")
        to_vcf_gz(raw, raw[:-4] + "_c.vcf.gz", "csi")
        to_bcf(raw, raw[:-4] + ".bcf", index=True)
        out.append({"vcf": raw, "tbi": raw + ".gz",
                    "csi": raw[:-4] + "_c.vcf.gz", "bcf": raw[:-4] + ".bcf"})
    return out


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sr"))
    return {seed: mixed_sets(d, seed) for seed in (5, 6)}


@pytest.mark.parametrize("kind", ["vcf", "tbi", "csi", "bcf"])
@pytest.mark.parametrize("logic", sorted(LOGICS))
def test_mixed_sets_every_pairing(mixed, kind, logic):
    for seed, files in mixed.items():
        got, want = both([f[kind] for f in files], pair=LOGICS[logic])
        assert got == want and len(got) > 20, (seed, kind)


REGIONS = [["1:200-1500", "3"], ["2:1-700,1:2500-"], ["{1}:100-2000"],
           ["1:1000", "2:400-400"], ["3:50-2900", "1:50-60", "1:55-900"]]


@pytest.mark.parametrize("overlap", [0, 1, 2])
@pytest.mark.parametrize("kind", ["vcf", "tbi", "csi", "bcf"])
@pytest.mark.parametrize("ri", range(len(REGIONS)))
def test_regions_indexed_and_streaming(mixed, kind, ri, overlap):
    files = mixed[5]
    got, want = both([f[kind] for f in files], pair=ts.BCF_SR_PAIR_BOTH,
                     regions=REGIONS[ri], regions_overlap=overlap)
    assert got == want


@pytest.mark.parametrize("overlap", [0, 1, 2])
@pytest.mark.parametrize("kind", ["vcf", "tbi", "bcf"])
def test_targets(mixed, kind, overlap):
    files = mixed[6]
    for targets in (["1:300-2000", "2"], ["3:1-1000,1:2000-2999"]):
        got, want = both([f[kind] for f in files],
                         pair=ts.BCF_SR_PAIR_EXACT, targets=targets,
                         targets_overlap=overlap)
        assert got == want


def test_regions_with_targets_and_mixed_kinds(mixed):
    """A BCF, an indexed VCF and a plain VCF in one reader."""
    f = mixed[5]
    paths = [f[0]["bcf"], f[1]["tbi"], f[2]["bcf"]]
    got, want = both(paths, pair=ts.BCF_SR_PAIR_ANY,
                     regions=["1:100-2500", "2"], targets=["1", "2:1-2000"])
    assert got == want and got


def test_variant_type_and_scores_match_jax():
    pairs = [("A", "C"), ("A", "."), ("A", "A"), ("A", "X"), ("A", "*"),
             ("A", "<DEL>"), ("A", "<*>"), ("A", "<NON_REF>"), ("A", "AT"),
             ("AT", "A"), ("ACG", "ATG"), ("ACG", "TCA"), ("AC", "GT"),
             ("A", "A]1:100]"), ("A", "]1:5]A"), ("ACGT", "AT"),
             ("CAT", "CT"), ("a", "ac"), ("ACT", "ACGT"), ("GAC", "GAT")]
    for ref, alt in pairs:
        assert ts.variant_type(ref, alt) == js.variant_type(ref, alt)
    for pair in list(LOGICS.values()) + [0, ts.BCF_SR_PAIR_ALL]:
        assert ts._init_scores(pair) == js._init_scores(pair)
    for a, b in [("A>C", "A>C"), ("A>C,A>G", "A>G,A>C"), ("A>C", "A>G"),
                 ("A>C,A>T", "A>T"), ("a>c", "A>C")]:
        assert ts._multi_is_exact(a, b) == js._multi_is_exact(a, b)
        assert ts._multi_is_subset(a, b) == js._multi_is_subset(a, b)


@pytest.mark.parametrize("spec", [
    "1", "1:100", "1:100-200", "1:100-", "{weird:name}:5-10,2",
    "chr1:1-5,chr2,chr3:7", "1:x-5", "{1:2", "1:5-6x", ""])
def test_region_parser_matches_jax(spec):
    def outcome(mod):
        try:
            return mod._parse_region_list(spec)
        except ValueError as e:
            return ("ValueError", str(e))
    assert outcome(ts) == outcome(js)
