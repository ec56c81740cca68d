"""The port's CRAM reference lookup (htslib_tpu_torch/cram/refs.py
`RefRegistry`) against the JAX package's (htslib_tpu/cram/refs.py): the
REF_PATH tokeniser, REF_CACHE and REF_PATH lookups by the M5 checksum of
an @SQ line, their order, the MD5 check and `ignore_md5`.

The files are the port's reference-based CRAM 3.0 over a seeded FASTA,
whose @SQ lines carry M5 and UR tags, read after the FASTA is gone (as
on another machine), with no `ref=`.  The cache directories are built
here from the FASTA.  A REF_PATH URL element is fetched through each
package's hfile layer from a server on 127.0.0.1
(chip_smoke.RangeServer) that answers each sequence by its M5; an
element no server answers fails and the lookup goes on, as it does
without a network.  Records and text are compared byte for byte."""
import hashlib
import os

import jax
import pytest

from htslib_tpu.cram import CramReader as JReader
from htslib_tpu.cram import batch as jbatch
from htslib_tpu.cram.refs import RefRegistry as JRegistry
from htslib_tpu_torch.cram import CramReader
from htslib_tpu_torch.cram import batch as tbatch
from htslib_tpu_torch.cram.refs import RefRegistry
from chip_smoke import RangeServer
from test_torch_cram import cram_records, write_bam, write_fasta


@pytest.fixture(autouse=True, scope="module")
def _jax_32bit():
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", before)


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    monkeypatch.delenv("REF_PATH", raising=False)
    monkeypatch.delenv("REF_CACHE", raising=False)


@pytest.fixture(scope="module")
def gone(tmp_path_factory):
    """A CRAM 3.0 written against a FASTA that is then removed: its path,
    the bases by reference name, their M5s, and the records' BAM
    bytes decoded with the FASTA (the truth)."""
    d = tmp_path_factory.mktemp("refs")
    fa = str(d / "moved.fa")
    seqs = write_fasta(fa, 21)
    hdr, recs = cram_records(200, 23, seqs)
    bam = write_bam(str(d / "in.bam"), hdr, recs)
    path = str(d / "r.cram")
    tbatch.bam_to_cram_file(bam, path, ref=fa, seqs_per_slice=100)
    with CramReader(path, ref=fa) as r:
        truth = [rec.to_bam_buffer() for rec in r]
    os.remove(fa)
    os.remove(fa + ".fai")
    m5 = {n: hashlib.md5(s.encode()).hexdigest() for n, s in seqs.items()}
    return {"dir": d, "path": path, "seqs": seqs, "m5": m5,
            "truth": truth}


def _cache(root, gone, layout="flat", seqs=None):
    """Each sequence stored under its M5 as the cache keeps it (bases
    only, no newline): flat (root/md5) or htslib's split layout
    (root/ab/cd/rest)."""
    for name, s in (seqs or gone["seqs"]).items():
        m5 = gone["m5"][name]
        p = (os.path.join(root, m5) if layout == "flat"
             else os.path.join(root, m5[:2], m5[2:4], m5[4:]))
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "w") as fp:
            fp.write(s)
    return root


def _records(path, cls, **kw):
    with cls(path, **kw) as r:
        return [rec.to_bam_buffer() for rec in r]


def _both_read(gone, **kw):
    """The records by the port's reader and the JAX one's, or the
    exception each raised."""
    out = []
    for cls in (CramReader, JReader):
        try:
            out.append(_records(gone["path"], cls, **kw))
        except Exception as e:          # compared across the two
            out.append((type(e).__name__, str(e)))
    return out


@pytest.mark.parametrize("text", [
    "", "/a/b", "/a/b:/c/%s", "x::y:z", "::lead:trail::", ":::",
    "http://host:8080/refs/%s:/local", "https://h/p::q:ftp://f.org/x/",
    "ftp://f.org:21/a:b", "/c::/d:http:", "rel:%s/cache:http://h:80"])
def test_tokenise_ref_path_matches_jax(text):
    assert (RefRegistry._tokenise_ref_path(text)
            == JRegistry._tokenise_ref_path(text))


def test_m5_and_ur_tags_written(gone):
    with CramReader(gone["path"]) as r:
        for name, m5 in gone["m5"].items():
            sq = r.header.find_line_id("SQ", "SN", name)
            assert sq.get("M5") == m5
            assert sq.get("UR").endswith("moved.fa")


def test_gone_ur_without_cache_raises_as_jax(gone):
    (ours, theirs) = _both_read(gone)
    assert ours == theirs and ours[0] == "OSError"
    assert "unable to load reference" in ours[1]


@pytest.mark.parametrize("layout", ["dir", "template"])
def test_ref_cache_decodes_a_file_whose_ur_is_gone(gone, layout,
                                                   tmp_path, monkeypatch):
    """The repair: the port raised IOError here before it looked up M5."""
    root = _cache(str(tmp_path / "cache"), gone)
    monkeypatch.setenv("REF_CACHE", root if layout == "dir"
                       else root + "/%s")
    ours, theirs = _both_read(gone)
    assert ours == theirs == gone["truth"]
    _, text = tbatch.cram_file_to_sam(gone["path"], device="cpu")
    monkeypatch.setattr("htslib_tpu.native.native", None)
    monkeypatch.setattr("htslib_tpu_torch.native.native", None)
    _, jtext = jbatch.cram_file_to_sam(gone["path"])
    assert text.tobytes() == jtext.tobytes()


def test_ref_cache_split_template_raises_as_jax(gone, tmp_path,
                                                monkeypatch):
    """htslib's %2s/%2s/%s layout: the JAX registry formats REF_CACHE
    with Python's %, which needs one argument for each %s, so both
    registries raise the same TypeError (ROADMAP queue C)."""
    root = _cache(str(tmp_path / "cache"), gone, layout="split")
    monkeypatch.setenv("REF_CACHE", root + "/%2s/%2s/%s")
    ours, theirs = _both_read(gone)
    assert ours == theirs and ours[0] == "TypeError"


def test_ref_path_elements_and_escape(gone, tmp_path, monkeypatch):
    """REF_PATH of a missing directory, a URL, a `::`-escaped name, then
    a %s template: the last finds the sequences."""
    odd = tmp_path / "with:colon"
    _cache(str(odd), gone)
    calls = []
    monkeypatch.setattr(JRegistry, "_fetch_url",
                        lambda self, url: calls.append(url))
    monkeypatch.setenv("REF_PATH", ":".join([
        str(tmp_path / "missing"), "http://localhost:1/refs/%s",
        str(odd).replace(":", "::") + "/%s"]))
    ours, theirs = _both_read(gone)
    assert ours == theirs == gone["truth"]
    assert calls and all(u.startswith("http://localhost:1/refs/")
                         for u in calls)
    reg, jreg = RefRegistry(None), JRegistry(None)
    for m5 in gone["m5"].values():
        assert reg._md5_lookup(m5) == jreg._md5_lookup(m5) \
            == (str(odd / m5), None)
    assert reg._md5_lookup("0" * 32) == jreg._md5_lookup("0" * 32) \
        == (None, None)


@pytest.mark.parametrize("cache", [False, True])
def test_ref_path_url_served_locally(gone, tmp_path, monkeypatch, cache):
    """REF_PATH of a URL no server answers, then a URL template served on
    127.0.0.1 (each sequence by its M5): both registries fetch the
    sequences through their hfile layers and decode the file; with
    REF_CACHE set, the fetched sequences are written into it, and a
    second read asks the server for nothing."""
    extra = {f"/m5/{gone['m5'][n]}": s.encode()
             for n, s in gone["seqs"].items()}
    if cache:
        monkeypatch.setenv("REF_CACHE", str(tmp_path / "cache" / "%s"))
    with RangeServer(str(tmp_path), extra) as srv:
        monkeypatch.setenv("REF_PATH", "http://127.0.0.1:1/none/%s:"
                           + srv.url("m5/%s"))
        ours, theirs = _both_read(gone)
        assert ours == theirs == gone["truth"]
        asked = [p for p, *_ in srv.requests]
        assert sorted(set(asked)) == sorted(extra)
        _, text = tbatch.cram_file_to_sam(gone["path"], device="cpu")
        monkeypatch.setattr("htslib_tpu.native.native", None)
        monkeypatch.setattr("htslib_tpu_torch.native.native", None)
        _, jtext = jbatch.cram_file_to_sam(gone["path"])
        assert text.tobytes() == jtext.tobytes()
        if cache:
            for m5 in gone["m5"].values():
                assert os.path.isfile(str(tmp_path / "cache" / m5))
            n = len(srv.requests)
            assert _records(gone["path"], CramReader) == gone["truth"]
            assert len(srv.requests) == n


def test_ref_cache_comes_before_ref_path(gone, tmp_path, monkeypatch,
                                         capfd):
    """A wrong sequence in REF_CACHE wins over the right one in REF_PATH:
    both registries warn of its MD5 and the slices' MD5 check raises."""
    wrong = {n: s[::-1] for n, s in gone["seqs"].items()}
    monkeypatch.setenv("REF_CACHE", _cache(str(tmp_path / "c"), gone,
                                           seqs=wrong))
    monkeypatch.setenv("REF_PATH", _cache(str(tmp_path / "p"), gone))
    capfd.readouterr()
    ours, theirs = _both_read(gone)
    err = capfd.readouterr().err.splitlines()
    assert ours == theirs and ours[0] == "OSError"
    assert "MD5 checksum reference mismatch" in ours[1]
    warn = [ln for ln in err if "reference MD5 mismatch" in ln]
    assert len(warn) == 2 and warn[0] == warn[1]
    monkeypatch.delenv("REF_CACHE")
    assert _both_read(gone) == [gone["truth"]] * 2


@pytest.mark.parametrize("ignore_md5", [False, True])
def test_wrong_cached_sequence_warns_unless_ignored(gone, tmp_path,
                                                    monkeypatch, capfd,
                                                    ignore_md5):
    """A cached sequence whose last base differs (no read reaches it):
    its MD5 is not the M5 tag's, so each registry warns unless
    ignore_md5, and the slices' own MD5s still pass."""
    flip = {"A": "C", "C": "G", "G": "T", "T": "A"}
    wrong = {n: s[:-1] + flip[s[-1]] for n, s in gone["seqs"].items()}
    monkeypatch.setenv("REF_CACHE", _cache(str(tmp_path / "c"), gone,
                                           seqs=wrong))
    capfd.readouterr()
    ours, theirs = _both_read(gone, ignore_md5=ignore_md5)
    err = capfd.readouterr().err.splitlines()
    assert ours == theirs == gone["truth"]
    warn = [ln for ln in err if "reference MD5 mismatch" in ln]
    if ignore_md5:
        assert warn == []
    else:
        names = sorted(gone["seqs"])
        assert len(warn) == 2 * len(names)
        assert warn[:len(names)] == warn[len(names):]
        assert all("[W::_load_full]" in ln for ln in warn)


def test_supplied_fasta_comes_first(gone, tmp_path, monkeypatch):
    """ref= wins over a wrong REF_CACHE entry, with no warning from M5."""
    fa = str(tmp_path / "again.fa")
    with open(fa, "w") as fp:
        for name, s in gone["seqs"].items():
            fp.write(f">{name}\n{s}\n")
    wrong = {n: s[::-1] for n, s in gone["seqs"].items()}
    monkeypatch.setenv("REF_CACHE", _cache(str(tmp_path / "c"), gone,
                                           seqs=wrong))
    ours, theirs = _both_read(gone, ref=fa)
    assert ours == theirs == gone["truth"]
