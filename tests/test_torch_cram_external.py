"""The port's CRAM accessor layer (htslib_tpu_torch/cram/external.py)
against the JAX package's (htslib_tpu/cram/external.py), function by
function, on the same files: the port's reference-based CRAM 3.0 and its
CRAM 3.1 without a reference (rANS 4x8, Nx16 and the name tokeniser's
blocks), and a CRAM 3.1 of the JAX native encoder (its own methods and
block layout), each of 300 records in three containers.  The JAX
encoder behind `transcode_rg` runs its pure-Python path, whose bytes the
port's encoder writes."""
import jax
import pytest

from htslib_tpu.cram import external as jext
from htslib_tpu_torch.cram import CramReader
from htslib_tpu_torch.cram import batch as tbatch
from htslib_tpu_torch.cram import external as text
from htslib_tpu_torch.sam.header import SamHeader
from test_torch_cram import cram_records, jax_cram, write_bam, write_fasta

FILES = ["port_3.0_ref", "port_3.1_noref", "jax_native_3.1_ref"]


@pytest.fixture(autouse=True, scope="module")
def _jax_32bit():
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", before)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("external")
    fa = str(d / "ref.fa")
    seqs = write_fasta(fa, 71)
    hdr, recs = cram_records(300, 73, seqs)
    hdr = SamHeader(hdr.text + "@RG\tID:grp0\tSM:a\n@RG\tID:grp1\tSM:b\n")
    bam = write_bam(str(d / "in.bam"), hdr, recs)
    files = {}
    for name in FILES:
        ver = (3, 1) if "3.1" in name else (3, 0)
        ref = fa if name.endswith("_ref") else None
        p = str(d / f"{name}.cram")
        if name.startswith("port"):
            tbatch.bam_to_cram_file(bam, p, ref=ref, version=ver,
                                    seqs_per_slice=100)
        else:
            jax_cram(bam, p, True, pytest.MonkeyPatch(), ref=ref,
                     version=ver, seqs_per_slice=100)
        files[name] = (p, ref)
    return files


@pytest.mark.parametrize("name", FILES)
def test_containers_and_stats_match_jax(corpus, name):
    path, _ = corpus[name]
    ours = [(off, vars(c)) for off, c in text.containers(path)]
    theirs = [(off, vars(c)) for off, c in jext.containers(path)]
    assert ours == theirs and len(ours) == 3
    assert text.num_containers(path) == jext.num_containers(path) == 3
    assert text.container_stats(path) == jext.container_stats(path)


@pytest.mark.parametrize("name", FILES)
def test_cid2ds_and_describe_encodings_match_jax(corpus, name):
    path, _ = corpus[name]
    ours = text.cid2ds(path)
    assert ours == jext.cid2ds(path) and ours
    desc = text.describe_encodings(path)
    assert desc == jext.describe_encodings(path)
    assert {d["method"] for d in desc} - {"raw"}


@pytest.mark.parametrize("data,method", [
    (b"", 0), (b"\x00abc", 4), (b"\x01abc", 4), (b"\x05xyz", 5),
    (b"\xc1", 5), (b"\x2c\x00", 6), (b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x02",
                                      1),
    (b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x04\xff", 1),
    (b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00\xff", 1), (b"q", 7), (b"t", 8),
    (b"?", 9), (b"\x00", 2), (b"\x00", 3)])
def test_expand_method_matches_jax(data, method):
    assert text.expand_method(data, method) == jext.expand_method(data,
                                                                  method)


@pytest.mark.parametrize("name", FILES[:2])
def test_transcode_rg_writes_the_jax_bytes(corpus, name, tmp_path,
                                           monkeypatch):
    path, ref = corpus[name]
    rg_map = {"grp0": "renamed0", "grp2": "renamed2"}
    ours, theirs = str(tmp_path / "p.cram"), str(tmp_path / "j.cram")
    n = text.transcode_rg(path, ours, rg_map, ref=ref)
    monkeypatch.setattr("htslib_tpu.native.native", None)
    assert jext.transcode_rg(path, theirs, rg_map, ref=ref) == n == 300
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    with CramReader(ours, ref=ref) as r:
        assert "ID:renamed0" in r.header.text
        rgs = {rec.get_aux("RG") for rec in r}
    assert {"renamed0", "grp1", "renamed2"} <= rgs and "grp0" not in rgs


@pytest.mark.parametrize("name", FILES)
@pytest.mark.parametrize("keep", ["even", "none", "ref1"])
def test_filter_containers_matches_jax(corpus, name, keep, tmp_path):
    path, _ = corpus[name]
    fn = {"even": lambda i, c: i % 2 == 0, "none": lambda i, c: False,
          "ref1": lambda i, c: c.ref_seq_id in (1, -2)}[keep]
    ours, theirs = str(tmp_path / "p.cram"), str(tmp_path / "j.cram")
    n = text.filter_containers(path, ours, fn)
    assert jext.filter_containers(path, theirs, fn) == n
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert text.num_containers(ours) == n
