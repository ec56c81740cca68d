"""The port's FASTA/FASTQ index (htslib_tpu_torch/faidx.py) against the
JAX package's (htslib_tpu/faidx.py): `.fai` of plain and BGZF FASTA (with
its `.gzi`, and with the block map built in memory where there is none),
`.fqi` of FASTQ with `fetch_qual`, `fetch_seq` over seeded intervals,
`fetch(region)`, `adjust_region` and the accessors, a gzip file that is
not BGZF refused, and a CRAM decoded against a `.fa.gz` reference
(cram/refs.py loads it through `Faidx.load`).

The FASTA has sequences of seeded lengths at 60, 50 and 7 bases a line;
the BGZF copies are written by the port's `BgzfWriter` with its `.gzi`
(the JAX writer's pure-Python path gives the same bytes).  Equality is
exact."""
import gzip
import os
import shutil

import numpy as np
import pytest

from htslib_tpu import bgzf as jbgzf
from htslib_tpu.cram import CramReader as JCram
from htslib_tpu.faidx import Faidx as JFaidx
from htslib_tpu_torch import bgzf as tbgzf
from htslib_tpu_torch.cram import CramReader as TCram
from htslib_tpu_torch.cram import batch as tbatch
from htslib_tpu_torch.faidx import Faidx
from test_torch_cram import cram_records, write_bam, write_fasta

SEQS = [("s1", 70_001, 60), ("s2", 150, 50), ("s3", 7, 7), ("s4", 129_000,
                                                              60)]


def fasta_text(seed=1):
    rng = np.random.default_rng(seed)
    seqs, out = {}, []
    for name, ln, width in SEQS:
        seqs[name] = "".join(rng.choice(list("ACGTNacgt"), ln))
        out.append(f">{name} description\n")
        out += [seqs[name][i:i + width] + "\n" for i in range(0, ln, width)]
    return "".join(out).encode(), seqs


def bgzip(src, dst, level=-1):
    with open(src, "rb") as fp:
        data = fp.read()
    w = tbgzf.BgzfWriter(dst, level=level)
    for i in range(0, len(data), 10_000):
        w.write(data[i:i + 10_000])
    w.close()
    w.save_index()


@pytest.fixture(scope="module")
def fa(tmp_path_factory):
    d = tmp_path_factory.mktemp("fa")
    text, seqs = fasta_text()
    plain = str(d / "r.fa")
    with open(plain, "wb") as fp:
        fp.write(text)
    gz = str(d / "r.fa.gz")
    bgzip(plain, gz)
    return {"dir": d, "plain": plain, "gz": gz, "seqs": seqs}


def intervals(seed, n=64):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        name, ln, _ = SEQS[int(rng.integers(0, len(SEQS)))]
        beg = int(rng.integers(-5, ln + 5))
        out.append((name, beg, beg + int(rng.integers(0, 3000))))
    return out


def test_bgzf_copy_and_gzi_match_jax(fa, tmp_path, monkeypatch):
    monkeypatch.setattr("htslib_tpu.native.native", None)
    with open(fa["plain"], "rb") as fp:
        data = fp.read()
    j = str(tmp_path / "j.fa.gz")
    w = jbgzf.BGZFWriter(j)
    for i in range(0, len(data), 10_000):
        w.write(data[i:i + 10_000])
    w.close()
    w.save_index()
    for suffix in ("", ".gzi"):
        with open(fa["gz"] + suffix, "rb") as a, open(j + suffix, "rb") as b:
            assert a.read() == b.read()


@pytest.mark.parametrize("kind", ["plain", "gz", "gz_no_gzi"])
def test_fai_and_fetch_seq_match_jax(fa, tmp_path, kind):
    src = fa["plain"] if kind == "plain" else fa["gz"]
    path = str(tmp_path / os.path.basename(src))
    shutil.copy(src, path)
    if kind == "gz":
        shutil.copy(src + ".gzi", path + ".gzi")
    t = Faidx.load(path)
    with open(path + ".fai") as fp:
        ours = fp.read()
    os.remove(path + ".fai")
    j = JFaidx.load(path)
    with open(path + ".fai") as fp:
        assert fp.read() == ours
    for name, beg, end in intervals(2):
        want = fa["seqs"][name][max(beg, 0):max(end, 0)]
        assert t.fetch_seq(name, beg, end) == want == j.fetch_seq(
            name, beg, end)
    assert t.fetch_seq("s4") == fa["seqs"]["s4"]
    assert (t.nseq, t.seq_names(), [t.seq_len(n) for n in ("s2", "x")]) \
        == (j.nseq, j.seq_names(), [j.seq_len(n) for n in ("s2", "x")])
    # a loaded index, the .fai given apart, and one not built
    t2 = Faidx.load(path, fai_path=path + ".fai")
    assert t2.entries == t.entries
    os.remove(path + ".fai")
    for mod in (Faidx, JFaidx):
        with pytest.raises(FileNotFoundError):
            mod.load(path, build_missing=False)
    t.close()
    j.close()


def test_fetch_region_and_adjust_match_jax(fa):
    t, j = Faidx.load(fa["gz"]), JFaidx.load(fa["gz"])
    for reg in ("s1", "s1:100-200", "s2:5", "s3:1-100", "s4:1,000-1,010",
                "s1:70,000-", "s4:-40"):
        assert t.fetch(reg) == j.fetch(reg)
    for mod in (t, j):
        with pytest.raises(ValueError):
            mod.fetch("nope:1-5")
    for args in (("s1", -5, 10), ("s2", 100, 1000), ("s2", 200, -1),
                 ("x", 0, 5), ("s3", 3, 4)):
        assert t.adjust_region(*args) == j.adjust_region(*args)


def fastq_text(seed=3, n=40):
    rng = np.random.default_rng(seed)
    out, want = [], {}
    for i in range(n):
        ln = int(rng.integers(1, 300))
        seq = "".join(rng.choice(list("ACGT"), ln))
        qual = "".join(chr(33 + int(q)) for q in rng.integers(0, 41, ln))
        want[f"q{i}"] = (seq, qual)
        out.append(f"@q{i} x\n{seq}\n+\n{qual}\n")
    return "".join(out).encode(), want


@pytest.mark.parametrize("kind", ["plain", "gz"])
def test_fqi_and_fetch_qual_match_jax(tmp_path, kind):
    text, want = fastq_text()
    path = str(tmp_path / "r.fq")
    with open(path, "wb") as fp:
        fp.write(text)
    if kind == "gz":
        bgzip(path, path + ".gz", level=1)
        path += ".gz"
    t = Faidx.load(path)
    with open(path + ".fqi") as fp:
        ours = fp.read()
    os.remove(path + ".fqi")
    j = JFaidx.load(path)
    with open(path + ".fqi") as fp:
        assert fp.read() == ours
    assert t.fmt == j.fmt == 1
    rng = np.random.default_rng(4)
    for name, (seq, qual) in want.items():
        beg = int(rng.integers(0, len(seq)))
        end = beg + int(rng.integers(1, 100))
        assert t.fetch_seq(name, beg, end) == seq[beg:end] == j.fetch_seq(
            name, beg, end)
        assert t.fetch_qual(name, beg, end) == qual[beg:end] == \
            j.fetch_qual(name, beg, end)
    # a loaded .fqi is FASTQ by its qualities column
    assert Faidx.load(path).fmt == 1
    with pytest.raises(KeyError):
        t.fetch_qual("nope")


def test_gzip_not_bgzf_is_refused_as_jax(fa, tmp_path):
    path = str(tmp_path / "r.fa.gz")
    with open(fa["plain"], "rb") as src, gzip.open(path, "wb") as dst:
        dst.write(src.read())
    msgs = []
    for mod in (Faidx, JFaidx):
        fai = mod.load(path)
        with pytest.raises(IOError) as e:
            fai.fetch_seq("s1", 0, 10)
        msgs.append(str(e.value))
        os.remove(path + ".fai")
    assert msgs[0] == msgs[1] and "not bgzip" in msgs[0]


def test_ragged_fasta_is_refused_as_jax(tmp_path):
    path = str(tmp_path / "bad.fa")
    with open(path, "w") as fp:
        fp.write(">a\nACGT\nAC\nACGT\n")
    msgs = []
    for mod in (Faidx, JFaidx):
        with pytest.raises(IOError) as e:
            mod.build(path)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_cram_decodes_against_a_bgzf_reference(tmp_path, monkeypatch):
    """A reference-based CRAM 3.0 written against a plain FASTA decodes
    against its bgzipped copy (with and without .gzi) as against the
    plain file, in the port's reader and cram_file_to_sam (device="cpu")
    and in the JAX reader."""
    fa = str(tmp_path / "ref.fa")
    seqs = write_fasta(fa, 31)
    hdr, recs = cram_records(300, 32, seqs)
    bam = write_bam(str(tmp_path / "in.bam"), hdr, recs)
    path = str(tmp_path / "r.cram")
    tbatch.bam_to_cram_file(bam, path, ref=fa, seqs_per_slice=100)
    with TCram(path, ref=fa) as r:
        want = [rec.to_sam(r.header) for rec in r]
    assert len(want) == 300
    _, text = tbatch.cram_file_to_sam(path, ref=fa, device="cpu")
    gz = str(tmp_path / "ref.fa.gz")
    bgzip(fa, gz)
    monkeypatch.setattr("htslib_tpu.native.native", None)
    for gzi in (True, False):
        if not gzi:
            os.remove(gz + ".gzi")
            os.remove(gz + ".fai")
        with TCram(path, ref=gz) as r:
            assert [rec.to_sam(r.header) for rec in r] == want
        with JCram(path, ref=gz) as r:
            assert [rec.to_sam(r.header) for rec in r] == want
        _, got = tbatch.cram_file_to_sam(path, ref=gz, device="cpu")
        assert got.tobytes() == text.tobytes()
