"""The port's command-line tools (htslib_tpu_torch/cli/) against the JAX
package's (htslib_tpu/cli/): each case runs the JAX `main(argv)` and the
port's over identical copies of seeded input files, and compares the exit
code, standard output, standard error and every file in the directory
afterwards, over each option the JAX tools parse.  The port's bgzip runs
with `device="cpu"` (the plain inflate: the BGZF inputs it decompresses
are stored or small); the JAX side runs its pure-Python path
(`htslib_tpu.native.native` None), whose bytes the port writes.  With the
JAX native library on, its deflate writes other bytes: those files are
compared by their members' sizes and inflated content."""
import gzip
import io
import os
import shutil
import sys

import numpy as np
import pytest

from htslib_tpu.cli import annot_tsv as jannot
from htslib_tpu.cli import bgzip as jbgzip
from htslib_tpu.cli import htsfile as jhtsfile
from htslib_tpu.cli import tabix as jtabix
from htslib_tpu_torch import bgzf as tbgzf
from htslib_tpu_torch.cli import annot_tsv as tannot
from htslib_tpu_torch.cli import bgzip as tbgzip
from htslib_tpu_torch.cli import htsfile as thtsfile
from htslib_tpu_torch.cli import tabix as ttabix
from htslib_tpu_torch.cram import batch as tbatch
from test_torch_cram import cram_records, write_bam, write_fasta
from test_torch_vcf import matrix_vcf, write_port_bcf

TOOLS = {"bgzip": (jbgzip.main, tbgzip.main),
         "tabix": (jtabix.main, ttabix.main),
         "htsfile": (jhtsfile.main, thtsfile.main),
         "annot_tsv": (jannot.main, tannot.main)}


class _Sink(io.BytesIO):
    def close(self):     # a writer given standard output may close it
        pass


class _Std:
    """A text stream over bytes, with the `buffer` the tools write to."""

    def __init__(self, data=b""):
        self.buffer = _Sink(data)

    def write(self, s):
        self.buffer.write(s.encode())
        return len(s)

    def read(self, n=-1):
        return self.buffer.read(n).decode()

    def flush(self):
        pass


def _bgzf(data, level=0, eof=True):
    chunks = [data[i:i + tbgzf.BGZF_BLOCK_SIZE]
              for i in range(0, len(data), tbgzf.BGZF_BLOCK_SIZE)]
    members = tbgzf.deflate_blocks(chunks, level)
    return b"".join(members) + (tbgzf.BGZF_EOF if eof else b""), chunks, \
        members


def _text(rng, n):
    return "".join(f"chr{1 + i % 3}\t{i * 7}\t{rng.integers(0, 10 ** 6)}\t"
                   f"{'ACGT'[i % 4] * int(rng.integers(1, 30))}\n"
                   for i in range(n)).encode()


def _tsv(rng, n, delim="\t", names=("chr", "beg", "end", "name", "score")):
    rows = [f"#{delim.join(names)}"]
    for _ in range(n):
        c = f"chr{rng.integers(1, 3)}"
        b = int(rng.integers(1, 20000))
        rows.append(delim.join([c, str(b), str(b + int(rng.integers(0, 400))),
                                f"n{rng.integers(0, 40)}",
                                str(rng.integers(0, 9))]))
    return ("\n".join(rows) + "\n").encode()


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    """Every input of the cases, in one directory that each run copies."""
    d = tmp_path_factory.mktemp("cli_src")
    rng = np.random.default_rng(17)
    w = lambda name, data: (d / name).write_bytes(data)   # noqa: E731
    text = _text(rng, 4000)
    w("a.txt", text)
    stored, chunks, members = _bgzf(text)
    w("s.txt.gz", stored)
    co = np.cumsum([0] + [len(m) for m in members])[:-1].astype(np.uint64)
    uo = np.cumsum([0] + [len(c) for c in chunks])[:-1].astype(np.uint64)
    tbgzf.GziIndex(co, uo).save(str(d / "s.txt.gz.gzi"))
    tbgzf.GziIndex(co, uo).save(str(d / "custom.gzi"))
    w("s.txt", b"in the way\n")
    w("x.bin", stored)
    w("noeof.gz", stored[:-len(tbgzf.BGZF_EOF)])
    bad = bytearray(stored)
    bad[len(members[0]) - 8] ^= 1             # the first member's CRC32
    w("bad.gz", bytes(bad))
    w("small.gz", _bgzf(text[:3000], level=6)[0])
    w("plain.gz", gzip.compress(text[:5000], mtime=0))
    # a .gzi for bgzip -g: members cut at other offsets
    tbgzf.GziIndex(np.array([0, 1000, 2000], np.uint64),
                   np.array([0, 5000, 70000], np.uint64)).save(
                       str(d / "a.txt.gz.gzi"))
    # VCF, BCF, BED and a custom TSV for tabix and htsfile
    vhdr, vbody = matrix_vcf()
    vcf = (vhdr + vbody).encode()
    w("v.vcf", vcf)
    w("v.vcf.gz", _bgzf(vcf, level=6)[0])
    w("w.vcf.gz", _bgzf(vcf, level=6)[0])
    w("newhdr.txt", b"##fileformat=VCFv4.2\n##source=cli\n"
      + vhdr.encode().splitlines(True)[-1])
    bed = "".join(f"chr{1 + i // 250}\t{i * 50}\t{i * 50 + 120}\tf{i}\n"
                  for i in range(500)).encode()
    w("b.bed", bed)
    w("b.bed.gz", _bgzf(bed, level=6)[0])
    w("t.tsv.gz", _bgzf(b"@skip me\n" + b"".join(
        f"x\tc{i // 150}\t{i * 10 + 1}\n".encode() for i in range(300)),
        level=6)[0])
    w("regions.txt", b"1:1-100000\n\nX\n")
    w("targets.txt", b"2:100-5000000\n")
    write_port_bcf(str(d / "v.bcf"))
    fa = str(d / "ref.fa")
    seqs = write_fasta(fa, 3)
    hdr, recs = cram_records(60, 5, seqs)
    bam = write_bam(str(d / "r.bam"), hdr, recs)
    tbatch.bam_to_cram_file(bam, str(d / "r.cram"), ref=fa,
                            seqs_per_slice=30)
    w("r.sam", (hdr.text + "".join(r.to_sam(hdr) + "\n" for r in recs))
      .encode())
    w("r.fq", b"".join(f"@q{i}\nACGTAC\n+\nIIIIII\n".encode()
                       for i in range(5)))
    w("empty.dat", b"")
    w("rand.bin", rng.integers(0, 256, 300, dtype=np.uint8).tobytes())
    w("src.tsv", _tsv(rng, 300))
    w("tgt.tsv", _tsv(rng, 200))
    w("src.csv", _tsv(rng, 100, ","))
    w("tgt.csv", _tsv(rng, 80, ","))
    w("src.tsv.gz", _bgzf(_tsv(rng, 120), level=6)[0])
    w("nohdr.tsv", b"\n".join(_tsv(rng, 50).splitlines()[1:]) + b"\n")
    return d


def _files(d):
    return {os.path.relpath(os.path.join(r, f), d):
            open(os.path.join(r, f), "rb").read()
            for r, _, fs in os.walk(d) for f in fs}


def _run(main, argv, cwd, stdin=b"", **kw):
    """(exit code or the exception's type, stdout, stderr, files) of one
    run of a tool in `cwd`."""
    saved = sys.stdin, sys.stdout, sys.stderr, os.getcwd()
    sys.stdin, sys.stdout, sys.stderr = _Std(stdin), _Std(), _Std()
    out, err = sys.stdout, sys.stderr
    os.chdir(cwd)
    try:
        try:
            rc = main(list(argv), **kw)
        except SystemExit as e:
            rc = ("exit", e.code)
        except Exception as e:             # compared across the two
            rc = ("raised", type(e).__name__)
    finally:
        sys.stdin, sys.stdout, sys.stderr = saved[:3]
        os.chdir(saved[3])
    return rc, out.buffer.getvalue(), err.buffer.getvalue(), _files(cwd)


def _both(tool, argv, src, tmp_path, stdin=b"", setup=()):
    """The JAX tool's run and the port's, each over a copy of `src` in
    which the `setup` argvs of the same tool ran first."""
    res = []
    for name, main in zip(("jax", "port"), TOOLS[tool]):
        d = tmp_path / name
        shutil.copytree(src, d)
        kw = {"device": "cpu"} if name == "port" and tool == "bgzip" else {}
        for pre in setup:
            assert _run(main, pre, d, **kw)[0] == 0
        res.append(_run(main, argv, d, stdin, **kw))
    return res


@pytest.fixture(autouse=True)
def _jax_pure(monkeypatch):
    monkeypatch.setattr("htslib_tpu.native.native", None)


BGZIP = [
    (["a.txt"], None), (["-i", "a.txt"], None),
    (["-l", "0", "-k", "a.txt"], None), (["-l", "9", "-c", "a.txt"], None),
    (["--stdout", "--compress-level", "1", "a.txt"], None),
    (["-f", "-k", "-I", "idx.gzi", "-i", "a.txt"], None),
    (["-g", "-k", "a.txt"], None), (["-g", "-I", "custom.gzi", "a.txt"], None),
    (["-@", "4", "--keep", "a.txt"], None), (["-c"], "a.txt"),
    (["-i", "-I", "in.gzi"], "a.txt"),
    (["-d", "-c", "s.txt.gz"], None), (["-d", "-f", "s.txt.gz"], None),
    (["-d", "s.txt.gz"], None), (["-d", "-f", "-k", "s.txt.gz"], None),
    (["--decompress", "--force", "small.gz"], None), (["-d", "x.bin"], None),
    (["-d", "-c", "plain.gz"], None), (["-d", "-c", "noeof.gz"], None),
    (["-d"], "s.txt.gz"), (["-d", "-c"], "small.gz"),
    (["-t", "s.txt.gz"], None), (["--test", "small.gz"], None),
    (["-t", "plain.gz"], None), (["-t", "noeof.gz"], None),
    (["-t", "x.bin"], None), (["-t"], "s.txt.gz"), (["-t", "bad.gz"], None),
    (["-d", "-c", "bad.gz"], None),
    (["-b", "1000", "-s", "5000", "s.txt.gz"], None),
    (["-b", "70000", "s.txt.gz"], None),
    (["--offset", "70005", "--size", "100", "-I", "custom.gzi",
      "s.txt.gz"], None),
    (["-b", "999999", "s.txt.gz"], None),
    (["-b", "0", "-s", "0", "s.txt.gz"], None),
    (["-a.txt"], None), (["--help"], None)]


@pytest.mark.parametrize("argv,stdin", BGZIP,
                         ids=[" ".join(a) for a, _ in BGZIP])
def test_bgzip_matches_jax(src, tmp_path, argv, stdin):
    data = (src / stdin).read_bytes() if stdin else b""
    jax_res, ours = _both("bgzip", argv, src, tmp_path, data)
    assert ours == jax_res


def test_bgzip_native_bytes_inflate_alike(src, tmp_path, monkeypatch):
    """The JAX tool with its native deflate: other bytes, the same
    members (sizes) and the same data inflated, and a .gzi alike."""
    monkeypatch.undo()
    import htslib_tpu.native as jn
    if jn.native is None:
        pytest.skip("the JAX native library does not load here")
    (jrc, jout, _, jfiles), (rc, out, _, files) = _both(
        "bgzip", ["-i", "a.txt"], src, tmp_path)
    assert jrc == rc == 0 and jout == out == b""
    assert set(jfiles) == set(files)
    for name in ("a.txt.gz",):
        jt = tbgzf.scan_blocks(jfiles[name])
        tt = tbgzf.scan_blocks(files[name])
        assert np.array_equal(jt.usizes, tt.usizes)
        raw = np.frombuffer(jfiles[name], np.uint8)
        assert tbgzf.inflate_host(raw, jt) == (src / "a.txt").read_bytes()
    jidx = tbgzf.GziIndex.load(str(tmp_path / "jax" / "a.txt.gz.gzi"))
    tidx = tbgzf.GziIndex.load(str(tmp_path / "port" / "a.txt.gz.gzi"))
    assert np.array_equal(jidx.uoffsets, tidx.uoffsets)


TABIX = [
    (["-p", "vcf", "v.vcf.gz"], ()),
    (["-p", "vcf", "-C", "v.vcf.gz"], ()),
    (["-p", "vcf", "--csi", "-m", "12", "v.vcf.gz"], ()),
    (["-p", "bed", "b.bed.gz"], ()),
    (["-s", "1", "-b", "2", "-e", "3", "-0", "b.bed.gz"], ()),
    (["-s", "2", "-b", "3", "-e", "3", "-S", "1", "-c", "@", "t.tsv.gz"], ()),
    (["-f", "-p", "vcf", "v.vcf.gz"], (["-p", "vcf", "v.vcf.gz"],)),
    (["v.vcf.gz", "1:1000-200000", "2", "X:1-1"], (["-p", "vcf",
                                                   "v.vcf.gz"],)),
    (["-h", "v.vcf.gz", "1:100-90000"], (["-p", "vcf", "v.vcf.gz"],)),
    (["--print-header", "-C", "v.vcf.gz", "2"], (["-C", "-p", "vcf",
                                                 "v.vcf.gz"],)),
    (["-H", "v.vcf.gz"], ()),
    (["--only-header", "v.vcf.gz"], (["-p", "vcf", "v.vcf.gz"],)),
    (["-l", "v.vcf.gz"], (["-p", "vcf", "v.vcf.gz"],)),
    (["--list-chroms", "b.bed.gz"], (["-p", "bed", "b.bed.gz"],)),
    (["-R", "regions.txt", "v.vcf.gz"], (["-p", "vcf", "v.vcf.gz"],)),
    (["-T", "targets.txt", "v.vcf.gz", "1:1-50"], (["-p", "vcf",
                                                    "v.vcf.gz"],)),
    (["--separate-regions", "v.vcf.gz", "1:1-500000", "X"],
     (["-p", "vcf", "v.vcf.gz"],)),
    (["-D", "--cache", "5", "--verbosity", "2", "-@", "2", "b.bed.gz",
      "chr1:100-900", "chr2:20000-21000"], (["-p", "bed", "b.bed.gz"],)),
    (["-r", "newhdr.txt", "w.vcf.gz"], ()),
    (["--reheader", "newhdr.txt", "-p", "vcf", "w.vcf.gz"], ()),
    (["v.vcf.gz", "1"], ()),
    (["-p", "nosuch", "v.vcf.gz"], ()),
    (["--help"], ()),
]


@pytest.mark.parametrize("argv,setup", TABIX,
                         ids=[" ".join(a) for a, _ in TABIX])
def test_tabix_matches_jax(src, tmp_path, argv, setup):
    jax_res, ours = _both("tabix", argv, src, tmp_path, setup=setup)
    assert ours == jax_res


def test_tabix_reheader_native_inflates_alike(src, tmp_path, monkeypatch):
    monkeypatch.undo()
    import htslib_tpu.native as jn
    if jn.native is None:
        pytest.skip("the JAX native library does not load here")
    (jrc, jout, _, _), (rc, out, _, _) = _both(
        "tabix", ["-r", "newhdr.txt", "w.vcf.gz"], src, tmp_path)
    assert jrc == rc == 0
    jt, tt = tbgzf.scan_blocks(jout), tbgzf.scan_blocks(out)
    assert np.array_equal(jt.usizes, tt.usizes)
    assert (tbgzf.inflate_host(np.frombuffer(jout, np.uint8), jt)
            == tbgzf.inflate_host(np.frombuffer(out, np.uint8), tt))


HTSFILE_ALL = ["a.txt", "s.txt.gz", "plain.gz", "v.vcf", "v.vcf.gz",
               "v.bcf", "b.bed", "r.bam", "r.sam", "r.cram", "ref.fa",
               "ref.fa.fai", "r.fq", "empty.dat", "rand.bin", "s.txt.gz.gzi",
               "missing.bam"]
HTSFILE = [
    HTSFILE_ALL, ["-c", "r.sam"], ["--view", "r.bam"], ["-c", "-h", "r.bam"],
    ["-c", "-H", "r.cram"], ["-c", "--no-header", "v.vcf"],
    ["-c", "--header-only", "v.bcf"], ["-c", "v.vcf.gz"], ["-c", "ref.fa"],
    ["-c", "r.bam", "missing.sam"], ["--help"], []]


@pytest.mark.parametrize("argv", HTSFILE, ids=[" ".join(a)[:40]
                                               for a in HTSFILE])
def test_htsfile_matches_jax(src, tmp_path, argv):
    jax_res, ours = _both("htsfile", argv, src, tmp_path)
    assert ours == jax_res


ANNOT = [
    ["-f", "name"], ["-f", "4:5"], ["-f", "name,score:tag,score"],
    ["-a", "cnt,nbp,frac"], ["-x"], [], ["-m", "name", "-f", "score"],
    ["-m", "4:4", "-a", "cnt"], ["-O", "0.5", "-a", "cnt"],
    ["-O", "0.5", "-r", "-f", "name"], ["-O", "0.2,0.3", "-a", "nbp"],
    ["-C", "00", "-a", "cnt"], ["-C", "01", "-f", "name"],
    ["-h", "0:0", "-c", "1,2,3", "-a", "cnt"],
    ["-H", "-c", "1,2,3", "-f", "4"], ["-I", "-f", "name"],
    ["-II", "-a", "cnt"], ["--allow-dups", "-f", "name"],
    ["--max-annots", "1", "-f", "name"], ["-o", "out.tsv", "-f", "name"],
    ["-a", "bogus"], ["-c", "nochr,beg,end"], ["-m", "nosuch"],
    ["-f", "lit:newcol"], ["-c", "1,2,3:chr,beg,end", "-a", "cnt"]]


@pytest.mark.parametrize("argv", ANNOT, ids=[" ".join(a) or "grep"
                                             for a in ANNOT])
def test_annot_tsv_matches_jax(src, tmp_path, argv):
    files = ["-s", "src.tsv", "-t", "tgt.tsv"]
    if argv[:1] == ["-H"] or argv[:1] == ["-h"]:
        files = ["-s", "nohdr.tsv", "-t", "tgt.tsv"]
    jax_res, ours = _both("annot_tsv", files + argv, src, tmp_path)
    assert ours == jax_res


@pytest.mark.parametrize("argv", [
    ["-s", "src.csv", "-t", "tgt.csv", "-d", ",", "-f", "name"],
    ["-s", "src.csv", "-t", "tgt.tsv", "-d", ",:\t", "-a", "cnt"],
    ["-s", "src.tsv.gz", "-t", "tgt.tsv", "-f", "name"],
    ["-t", "tgt.tsv", "-a", "cnt"], ["--help"]],
    ids=["csv", "delims", "bgzf source", "stdin source", "help"])
def test_annot_tsv_inputs_match_jax(src, tmp_path, argv):
    stdin = (src / "src.tsv").read_bytes() if "-s" not in argv else b""
    jax_res, ours = _both("annot_tsv", argv, src, tmp_path, stdin)
    assert ours == jax_res
