"""The port's tabix (htslib_tpu_torch/tbx.py) against the JAX package's
(htslib_tpu/tbx.py): `TbxConf` and its presets packed and unpacked,
`tbx_parse1` over VCF, BED, GFF, SAM, PSLTBL and GAF lines with the END
and SVLEN cases of tests/test_faidx_tbx.py, and `Tabix.build` as TBI and
as CSI over seeded bgzipped files of each preset: equal index files,
equal loaded indexes and equal `query_region` lines.

The files are written by the port's `BgzfWriter`; the index files are
BGZF, so the JAX side saves them on its pure-Python path
(`htslib_tpu.native.native` None).  Equality is exact."""
import numpy as np
import pytest

from htslib_tpu import bgzf as jbgzf
from htslib_tpu import tbx as jtbx
from htslib_tpu_torch import bgzf as tbgzf
from htslib_tpu_torch import tbx as ttbx

PRESETS = sorted(ttbx.PRESETS)


@pytest.mark.parametrize("name", PRESETS)
def test_conf_pack_unpack_matches_jax(name):
    t, j = ttbx.PRESETS[name], jtbx.PRESETS[name]
    assert t.pack() == j.pack()
    u = ttbx.TbxConf.unpack(t.pack() + b"tail")
    assert vars(u) == vars(jtbx.TbxConf.unpack(j.pack())) == vars(t)


PARSE_LINES = {
    "vcf": ["chr1\t100\t.\tACGT\tA\t.\t.\t.",
            "chr1\t100\t.\tA\t<DEL>\t.\t.\tEND=200;X=1",
            "chr1\t100\t.\tA\t<DEL>\t.\t.\tSVLEN=-50",
            "chr1\t100\t.\tA\t<DUP:TANDEM>,C\t.\t.\tSVLEN=300,1",
            "chr1\t100\t.\tA\tC,<INV>\t.\t.\tSVLEN=5,-70;END=120",
            "chr1\t100\t.\tA\t<INS>\t.\t.\tSVLEN=900",
            "chr1\t100\t.\tAC\tA\t.\t.\tEND=50",
            "chr1\t100\t.\tAC\tA\t.\t.\tEND=.",
            "chr1\t100\t.\tAC\tA\t.\t.\tEND=x;SVLEN=3",
            "chr1\t100\t.\tA\t<CNV>\t.\t.\tSVLEN=x,-4",
            "chr1\t0\t.\tA\tC\t.\t.\t.",
            "chr1\tx\t.\tA\tC", "chr1", "chr1\t5"],
    "bed": ["c1\t0\t10", "c1\t5\t6\tname", "c1\t7\tx", "c1\t-1\t3",
            "c1\t9\t9"],
    "gff": ["c1\tsrc\tgene\t100\t200\t.\t+\t.\tID=g", "c1\ts\tx\t0\t5",
            "c1\ts\tx\t3\ty", "c1\ts\tx\t7"],
    "sam": ["r\t0\tc1\t100\t30\t10M5D3N2S7I4=1X\t*\t0\t0\tA\tI",
            "r\t4\tc1\t100\t0\t*\t*\t0\t0\tA\tI", "r\t0\tc1\t50\t30\t5H"],
    "psltbl": ["\t".join(str(i) for i in range(20))],
    "gaf": ["q\t10\t0\t10\t+\t>12<7>40\t100\t0\t10\t10\t10\t60",
            "q\t10\t0\t10\t+\t*\t100"],
}


@pytest.mark.parametrize("name", sorted(PARSE_LINES))
def test_tbx_parse1_matches_jax(name, capsys):
    for line in PARSE_LINES[name]:
        got = ttbx.tbx_parse1(ttbx.PRESETS[name], line + "\n")
        t_err = capsys.readouterr().err
        assert got == jtbx.tbx_parse1(jtbx.PRESETS[name], line + "\n"), line
        assert t_err == capsys.readouterr().err


def test_tbx_parse1_vcf_end_svlen():
    conf = ttbx.CONF_VCF
    assert ttbx.tbx_parse1(conf, "chr1\t100\t.\tACGT\tA\t.\t.\t.\n") == (
        "chr1", 99, 103)
    assert ttbx.tbx_parse1(
        conf, "chr1\t100\t.\tA\t<DEL>\t.\t.\tEND=200;X=1\n")[1:] == (99, 200)
    assert ttbx.tbx_parse1(
        conf, "chr1\t100\t.\tA\t<DEL>\t.\t.\tSVLEN=-50\n")[1:] == (99, 149)


CONTIGS = [("chr1", 3_000_000), ("chr2", 800_000), ("chrM", 16_000)]


def make_lines(preset, seed, n=3000):
    """Seeded lines of a preset, sorted by contig and start, after the
    preset's meta lines."""
    rng = np.random.default_rng(seed)
    recs = []
    for ci, (name, ln) in enumerate(CONTIGS):
        k = n * (3 - ci) // 6
        for pos in np.sort(rng.integers(1, ln * 9 // 10, k)).tolist():
            span = int(rng.integers(1, min(12_000, ln // 20)))
            if preset == "vcf":
                alt = str(rng.choice(["C", "<DEL>", "<DUP>", "T,<INV>"]))
                info = str(rng.choice([f"END={pos + span}",
                                       f"SVLEN=-{span}", "DP=4",
                                       f"SVLEN={span},-3"]))
                recs.append(f"{name}\t{pos}\t.\t{'A' * int(rng.integers(1, 40))}"
                            f"\t{alt}\t50\tPASS\t{info}")
            elif preset == "bed":
                recs.append(f"{name}\t{pos - 1}\t{pos - 1 + span}\tf{pos}")
            elif preset == "gff":
                recs.append(f"{name}\tsrc\tgene\t{pos}\t{pos + span}\t.\t+"
                            f"\t.\tID=g{pos}")
            else:
                recs.append(f"{name}\t0\t{name}\t{pos}\t30\t{span % 300 + 1}M"
                            f"\t*\t0\t0\t*\t*")
    # SAM's name column is the read's; the reference is column 3
    if preset == "sam":
        recs = [f"q{i}\t" + r.split("\t", 1)[1] for i, r in enumerate(recs)]
    meta = {"vcf": ["##fileformat=VCFv4.2", "#CHROM\tPOS\tID\tREF\tALT\t"
                    "QUAL\tFILTER\tINFO"],
            "bed": ["#track"], "gff": ["##gff-version 3"],
            "sam": ["@HD\tVN:1.6"] + [f"@SQ\tSN:{n}\tLN:{ln}"
                                      for n, ln in CONTIGS]}[preset]
    return meta + recs


def bgzip_lines(path, lines):
    with tbgzf.BgzfWriter(path, level=1) as w:
        for ln in lines:
            w.write(ln.encode() + b"\n")


@pytest.mark.parametrize("preset", ["vcf", "bed", "gff", "sam"])
@pytest.mark.parametrize("min_shift", [0, 14])
def test_tabix_build_and_query_match_jax(tmp_path, monkeypatch, preset,
                                         min_shift):
    path = str(tmp_path / f"r.{preset}.gz")
    lines = make_lines(preset, len(preset) + min_shift)
    bgzip_lines(path, lines)
    conf_t, conf_j = ttbx.PRESETS[preset], jtbx.PRESETS[preset]
    monkeypatch.setattr("htslib_tpu_torch.native.native", None)
    t = ttbx.Tabix.build(path, conf_t, min_shift, out_path=path + ".t")
    monkeypatch.setattr("htslib_tpu.native.native", None)
    j = jtbx.Tabix.build(path, conf_j, min_shift, out_path=path + ".j")
    with open(path + ".t", "rb") as a, open(path + ".j", "rb") as b:
        assert a.read() == b.read()
    assert t.names == j.names == [n for n, _ in CONTIGS]
    t2 = ttbx.Tabix.load(path + ".j")
    assert (t2.names, vars(t2.conf)) == (t.names, vars(t.conf))
    rng = np.random.default_rng(9)
    regions = ["chr1", "chrM", "chr2:1-1000", "chr1:2,990,000-3,000,000"]
    for _ in range(40):
        name, ln = CONTIGS[int(rng.integers(0, 3))]
        beg = int(rng.integers(1, ln))
        regions.append(f"{name}:{beg}-{beg + int(rng.integers(0, 60_000))}")
    hits = 0
    # the JAX reader without its block cache, which raises KeyError on
    # such query sequences (tests/test_torch_bgzf_index.py
    # test_reader_cache_repair)
    with tbgzf.BgzfReader(path) as tf, \
            jbgzf.BGZFReader(path, cache_blocks=0) as jf:
        for reg in regions:
            got = list(t2.query_region(tf, reg))
            assert got == list(j.query_region(jf, reg)), reg
            hits += bool(got)
        with pytest.raises(ValueError):
            list(t2.query_region(tf, "chrZ:1-5"))
    assert hits > 20


def test_load_for_matches_jax(tmp_path):
    path = str(tmp_path / "r.bed.gz")
    bgzip_lines(path, make_lines("bed", 2, n=200))
    for mod in (ttbx, jtbx):
        with pytest.raises(FileNotFoundError):
            mod.Tabix.load_for(path)
    ttbx.Tabix.build(path, ttbx.CONF_BED, 14)
    t, j = ttbx.Tabix.load_for(path), jtbx.Tabix.load_for(path)
    assert t.names == j.names and t.idx.fmt == j.idx.fmt == 0
    plain = str(tmp_path / "plain.bed")
    with open(plain, "w") as fp:
        fp.write("c1\t0\t5\n")
    msgs = []
    for mod, conf in ((ttbx, ttbx.CONF_BED), (jtbx, jtbx.CONF_BED)):
        with pytest.raises(IOError) as e:
            mod.Tabix.build(plain, conf)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
