"""The port's region index (htslib_tpu_torch/regidx.py) against the JAX
package's (htslib_tpu/regidx.py): the BED, TAB, region-string and VCF
parsers over edge lines, `RegIdx` built from seeded intervals with
payloads and queried by `overlap` / `has_overlap` at 300 seeded points
and ranges, and `regidx_from_file` over plain and bgzipped files.
Equality is exact."""
import numpy as np
import pytest

from htslib_tpu import regidx as jreg
from htslib_tpu_torch import bgzf as tbgzf
from htslib_tpu_torch import regidx as treg

LINES = {
    "parse_bed": ["c1\t0\t10", "c1\t5\t6\tx", "#c", "", "c1\t1", "c1\tx\t2",
                  "c2\t100\t100\n"],
    "parse_tab": ["c1\t5", "c1\t5\t9", "c1 5 9", "c1\t9\t5", "#c", "c1",
                  "c1\ty", "c1\t5\t9\textra\n"],
    "parse_reg": ["c1", "c1:5", "c1:5-9", "c1:1,000-2,000", "c1:-10",
                  "c1:10-", " c2:3k-4k ", "{x}:1-2", ""],
    "parse_vcf": ["c1\t100\t.\tACG\tT", "c1\t100\t.\tA", "#c", "c1\tx\t.\tA",
                  "c1\t5\t.\tA\tC\t.\t.\tEND=9"],
}


@pytest.mark.parametrize("parser", sorted(LINES))
def test_parsers_match_jax(parser):
    for line in LINES[parser]:
        assert getattr(treg, parser)(line) == getattr(jreg, parser)(line), \
            line


def fill(mod, seed, n=2000):
    rng = np.random.default_rng(seed)
    idx = mod.RegIdx()
    for i in range(n):
        chrom = ("c1", "c2", "c3")[int(rng.integers(0, 3))]
        beg = int(rng.integers(0, 1_000_000))
        idx.push(chrom, beg, beg + int(rng.integers(0, 5000)), {"i": i})
    return idx


def test_overlap_queries_match_jax():
    t, j = fill(treg, 1), fill(jreg, 1)
    assert t.seq_names == j.seq_names and t.nregs() == j.nregs() == 2000
    rng = np.random.default_rng(2)
    hits = 0
    for k in range(300):
        chrom = ("c1", "c2", "c3", "cX")[int(rng.integers(0, 4))]
        beg = int(rng.integers(-10, 1_010_000))
        end = None if k % 3 == 0 else beg + int(rng.integers(0, 20_000))
        got = list(t.overlap(chrom, beg, end))
        assert got == list(j.overlap(chrom, beg, end))
        assert t.has_overlap(chrom, beg, end) == j.has_overlap(
            chrom, beg, end) == bool(got)
        hits += bool(got)
    assert hits > 100
    # pushing after a query sorts again
    t.push("c1", 5, 6, "late")
    j.push("c1", 5, 6, "late")
    assert list(t.overlap("c1", 0, 10)) == list(j.overlap("c1", 0, 10))


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("parser", ["parse_bed", "parse_tab", "parse_reg"])
def test_regidx_from_file_matches_jax(tmp_path, compressed, parser):
    rng = np.random.default_rng(3)
    rows = []
    for _ in range(500):
        beg = int(rng.integers(1, 100_000))
        end = beg + int(rng.integers(0, 300))
        chrom = ("c1", "c2")[int(rng.integers(0, 2))]
        rows.append({"parse_bed": f"{chrom}\t{beg}\t{end}",
                     "parse_tab": f"{chrom}\t{beg}\t{end}",
                     "parse_reg": f"{chrom}:{beg}-{end}"}[parser])
    text = ("#header\n" if parser != "parse_reg" else "") + "\n".join(rows) \
        + "\n"
    path = str(tmp_path / ("r.txt.gz" if compressed else "r.txt"))
    if compressed:
        with tbgzf.BgzfWriter(path) as w:
            w.write(text.encode())
    else:
        with open(path, "w") as fp:
            fp.write(text)
    t = treg.regidx_from_file(path, getattr(treg, parser))
    j = jreg.regidx_from_file(path, getattr(jreg, parser))
    assert t.nregs() == j.nregs() == 500
    for beg in range(0, 100_000, 997):
        for chrom in ("c1", "c2"):
            assert list(t.overlap(chrom, beg, beg + 50)) == list(
                j.overlap(chrom, beg, beg + 50))
