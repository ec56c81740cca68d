"""The port's hfile layer (htslib_tpu_torch/hfile.py) against the JAX
package's (htslib_tpu/hfile.py): scheme parsing, the `data:`,
`preload:`, `mem:` and `file:` back ends, local files and their verbs,
HTS_PATH plugins, unknown schemes, format detection over a stream
(format.py `detect_format_file` / `detect_format_hfile`), and the port's
readers and writers over names that `hopen` opens.  Inputs are seeded
bytes; outputs are compared byte for byte."""
import base64
import gzip
import os
import urllib.parse

import numpy as np
import pytest

import htslib_tpu.hfile as jhf
from htslib_tpu.format import detect_format_file as jdetect_file
from htslib_tpu.format import detect_format_hfile as jdetect_hfile
from htslib_tpu_torch import hfile as thf
from htslib_tpu_torch.bgzf import BgzfReader, BgzfWriter
from htslib_tpu_torch.format import detect_format_file, detect_format_hfile

SCHEME_NAMES = ["data:,x", "DATA:,x", "http://h/p", "s3+https://b/k",
                "gs+http://b/o", "htsget+http://h/t", "c:\\dir\\file",
                "C:/x", "file:///tmp/x", "preload:mem:/x", "./a:b",
                "plain.bam", "a1.b-c+d:rest", "1ab:rest", "-", "", ":x",
                "ab", "x.y:"]


def _bytes(seed, n):
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


@pytest.mark.parametrize("name", SCHEME_NAMES)
def test_hfile_scheme_matches_jax(name):
    assert thf.hfile_scheme(name) == jhf.hfile_scheme(name)


@pytest.mark.parametrize("how", ["base64", "percent", "meta"])
def test_data_uri(how):
    data = _bytes(1, 700) + b"tail,with;commas%"
    if how == "base64":
        url = "data:;base64," + base64.b64encode(data).decode()
    elif how == "percent":
        url = "data:," + urllib.parse.quote_from_bytes(data)
    else:
        url = ("data:application/octet-stream;base64,"
               + base64.b64encode(data).decode())
    with thf.hopen(url) as f, jhf.hopen(url) as g:
        assert f.peek(10) == g.peek(10) == data[:10]
        assert f.read(5) == g.read(5)
        assert f.read(-1) == g.read(-1) == data[5:]
        assert f.at_eof is False and f.read(3) == b""


def test_malformed_data_uri_raises_as_jax():
    for mod in (thf, jhf):
        with pytest.raises(FileNotFoundError):
            mod.hopen("data:no-comma-here")


def test_local_file_verbs(tmp_path):
    data = _bytes(2, 100_000)
    p = str(tmp_path / "f.bin")
    with open(p, "wb") as fp:
        fp.write(data)
    for name in (p, "file://" + p, "file:" + p):
        with thf.hopen(name, "rb") as f, jhf.hopen(name, "rb") as g:
            assert f.size() == g.size() == len(data)
            assert f.peek(100) == g.peek(100) == data[:100]
            assert f.tell() == 0
            assert f.read(1000) == g.read(1000)
            assert f.seek(-10, os.SEEK_END) == g.seek(-10, os.SEEK_END)
            assert f.read(100) == g.read(100) == data[-10:]
            assert f.at_eof and g.at_eof
            f.seek(50_000)
            g.seek(50_000)
            assert f.readline() == g.readline()
            buf, jbuf = bytearray(64), bytearray(64)
            assert f.readinto(buf) == g.readinto(jbuf) == 64
            assert buf == jbuf and not f.has_multiple_parts()


def test_local_write_and_mem(tmp_path):
    data = _bytes(3, 5000)
    p = str(tmp_path / "w.bin")
    with thf.hopen(p, "wb") as f:
        f.write(data[:100])
        f.flush()
        f.write(data[100:])
    with open(p, "rb") as fp:
        assert fp.read() == data
    with thf.hopen("mem:" + p) as f, jhf.hopen("mem:" + p) as g:
        assert isinstance(f, thf.MemFile)
        assert f.getvalue() == g.getvalue() == data
        assert f.read(-1) == data
    w = thf.hopen("mem:" + str(tmp_path / "new"), "w")
    w.write(b"abc")
    assert w.getvalue() == b"abc"


def test_preload(tmp_path):
    data = _bytes(4, 3000)
    p = str(tmp_path / "p.bin")
    with open(p, "wb") as fp:
        fp.write(data)
    for inner in (p, "data:;base64," + base64.b64encode(data).decode()):
        with thf.hopen("preload:" + inner) as f, \
                jhf.hopen("preload:" + inner) as g:
            assert isinstance(f, thf.MemFile)
            assert f.name == g.name == "preload:" + inner
            assert f.read(-1) == g.read(-1) == data


def test_unknown_scheme_raises_as_jax():
    for mod in (thf, jhf):
        with pytest.raises(FileNotFoundError, match="unsupported URL"):
            mod.hopen("nosuchscheme://x/y")


def test_hts_path_plugins(tmp_path, monkeypatch):
    """HTS_PATH plugins (load_hfile_plugins, hfile.c:1111): each
    hfile_*.py of each directory registers its schemes through
    hfile_plugin_init(add); a plugin without it, or one that fails, is
    skipped with a warning; an empty element adds nothing."""
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    (tmp_path / "a" / "hfile_shout.py").write_text(
        "from htslib_tpu_torch.hfile import MemFile\n"
        "def _open(url, mode):\n"
        "    return MemFile(url[len('shout:'):].upper().encode(), 'r',\n"
        "                   name=url)\n"
        "def hfile_plugin_init(add):\n"
        "    add('shout', _open)\n")
    (tmp_path / "b" / "hfile_rev.py").write_text(
        "from htslib_tpu_torch.hfile import MemFile\n"
        "def hfile_plugin_init(add):\n"
        "    add('rev', lambda u, m: MemFile(u[4:][::-1].encode()))\n")
    (tmp_path / "b" / "hfile_none.py").write_text("x = 1\n")
    (tmp_path / "b" / "hfile_bad.py").write_text("raise ValueError('no')\n")
    (tmp_path / "b" / "other.py").write_text("raise SystemExit\n")
    monkeypatch.setenv("HTS_PATH", ":".join(
        ["", str(tmp_path / "a"), str(tmp_path / "b")]))
    monkeypatch.setattr(thf, "_remote_loaded", False)
    for s in ("shout", "rev"):
        monkeypatch.delitem(thf._scheme_handlers, s, raising=False)
    with thf.hopen("shout:hello world") as f:
        assert f.read(-1) == b"HELLO WORLD"
    with thf.hopen("rev:abc") as f:
        assert f.read(-1) == b"cba"
    # the remote schemes came with the same lazy load
    assert {"http", "https", "ftp", "s3", "gs", "htsget",
            "htsget+http"} <= set(thf._scheme_handlers)
    monkeypatch.delitem(thf._scheme_handlers, "shout")
    monkeypatch.delitem(thf._scheme_handlers, "rev")


def _format_files(d):
    """Seeded files of several formats: (name, path)."""
    from htslib_tpu_torch.sam.bam import write_bam_header
    from htslib_tpu_torch.sam.header import SamHeader
    sam = (b"@HD\tVN:1.6\n@SQ\tSN:c1\tLN:1000\n"
           b"r1\t0\tc1\t5\t60\t4M\t*\t0\t0\tACGT\tFFFF\n")
    vcf = (b"##fileformat=VCFv4.2\n##contig=<ID=c1,length=1000>\n"
           b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
           b"c1\t5\t.\tA\tC\t50\tPASS\t.\n")
    out = {}
    for name, data in (("x.sam", sam), ("x.vcf", vcf),
                       ("x.fq", b"@r1\nACGT\n+\nFFFF\n"),
                       ("x.fa", b">c1\nACGTACGT\n"),
                       ("x.bin", _bytes(5, 300)), ("x.empty", b"")):
        out[name] = str(d / name)
        with open(out[name], "wb") as fp:
            fp.write(data)
    out["x.sam.gz"] = str(d / "x.sam.gz")
    with BgzfWriter(out["x.sam.gz"]) as w:
        w.write(sam)
    out["x.fq.gz"] = str(d / "x.fq.gz")
    with open(out["x.fq.gz"], "wb") as fp:
        fp.write(gzip.compress(b"@r1\nACGT\n+\nFFFF\n"))
    out["x.bam"] = str(d / "x.bam")
    with BgzfWriter(out["x.bam"]) as w:
        write_bam_header(w, SamHeader(sam.split(b"r1")[0].decode()))
    return out


def test_detect_format_over_streams(tmp_path):
    files = _format_files(tmp_path)
    for name, path in files.items():
        got = detect_format_file(path)
        want = jdetect_file(path)
        assert got.description() == want.description(), name
        with thf.hopen(path) as f, jhf.hopen(path) as g:
            assert (detect_format_hfile(f).description()
                    == jdetect_hfile(g).description())
            # the peek consumed nothing
            with open(path, "rb") as fp:
                assert f.read(-1) == fp.read()


def test_readers_and_writers_over_hopen_names(tmp_path):
    """The port's BgzfReader and BgzfWriter open a name through hopen: a
    `mem:` URL, a `data:` URL and a `file:` URL read the bytes a local
    path gives."""
    data = b"".join(b"line %d\n" % i for i in range(20_000))
    p = str(tmp_path / "t.gz")
    with BgzfWriter("file:" + p, level=1) as w:
        w.write(data)
    with open(p, "rb") as fp:
        raw = fp.read()
    for name in (p, "mem:" + p, "file://" + p,
                 "data:;base64," + base64.b64encode(raw).decode()):
        r = BgzfReader(name)
        assert r.is_bgzf and r.read(-1) == data
        r.close()
