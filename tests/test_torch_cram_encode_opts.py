"""The port's CRAM encoder options (htslib_tpu_torch/cram/encode.py
`device_profile`, `nthreads`) against the JAX package's encoder: its
pure-Python path with both native libraries off, as in
tests/test_torch_cram.py, and for `device_profile` its native path with
both on too.

`device_profile` pins a CRAM 3.1 file's quality blocks of 64 bytes or
more to 32-way rANS Nx16, order 1 where that is at least 3% smaller: the
records carry qualities drawn independently (order 0 wins) or as a
bounded walk (order 1 wins).  The files must be the JAX encoder's bytes,
their QS blocks on the expected wire, and the port's quality lane over
them (`cram_qual_hist`, plain versions on the CPU) the histogram of the
JAX reader's qualities.  The port builds containers in order, so it
writes the same bytes at any `nthreads`."""
import jax
import numpy as np
import pytest

from htslib_tpu.cram import CramReader as JReader
from htslib_tpu_torch.cram import CRAM_EOF_START
from htslib_tpu_torch.cram import batch as tbatch
from htslib_tpu_torch.cram.encode import SERIES
from htslib_tpu_torch.cram.io import CramIO, read_file_definition
from htslib_tpu_torch.cram.structs import CT_EXTERNAL, RANSPR
from htslib_tpu_torch.ops.device_stats import QBINS, cram_qual_hist
from test_torch_cram import cram_records, jax_cram, write_bam, write_fasta
from test_torch_device_stats import read_walks


@pytest.fixture(autouse=True, scope="module")
def _jax_32bit():
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", before)


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    """{quality kind: BAM path} over 240 records, and the FASTA."""
    d = tmp_path_factory.mktemp("opts")
    fa = str(d / "ref.fa")
    seqs = write_fasta(fa, 61)
    hdr, recs = cram_records(240, 63, seqs)
    rng = np.random.default_rng(65)
    out = {"fasta": fa}
    for kind in ("iid", "walk"):
        for r in recs:
            if not r.qual or r.qual[0] == 0xff:
                continue
            n = len(r.qual)
            r.qual = (rng.integers(2, 42, n, dtype=np.uint8).tobytes()
                      if kind == "iid" else read_walks(rng, n))
        out[kind] = write_bam(str(d / f"{kind}.bam"), hdr, recs)
    return out


def _qs_wires(path):
    """(method, first byte of the stream) of every QS block."""
    out = []
    with open(path, "rb") as fp:
        ver, _ = read_file_definition(fp)
        io = CramIO(fp, ver)
        c = io.read_container_header()
        fp.seek(c.data_offset + c.length)
        while True:
            c = io.read_container_header()
            if c is None or (c.ref_seq_id == -1
                             and c.ref_seq_start == CRAM_EOF_START):
                return out
            end = c.data_offset + c.length
            while fp.tell() < end:
                b = io.read_block()
                if (b.content_type == CT_EXTERNAL
                        and b.content_id == SERIES["QS"]):
                    out.append((b.method, b.data[0], b.raw_size))


def _same_bytes(a, b):
    with open(a, "rb") as x, open(b, "rb") as y:
        return x.read() == y.read()


@pytest.mark.parametrize("kind,order", [("iid", 0), ("walk", 1)])
@pytest.mark.parametrize("ver", [(3, 0), (3, 1)], ids=["3.0", "3.1"])
def test_device_profile_writes_the_jax_bytes(bams, kind, order, ver,
                                             tmp_path, monkeypatch):
    opts = dict(ref=bams["fasta"], version=ver, seqs_per_slice=80,
                device_profile=True)
    for on in (False, True):
        ours = str(tmp_path / f"p{on:d}.cram")
        if not on:
            monkeypatch.setattr("htslib_tpu_torch.native.native", None)
        tbatch.bam_to_cram_file(bams[kind], ours, **opts)
        monkeypatch.undo()
        theirs = jax_cram(bams[kind], str(tmp_path / f"j{on:d}.cram"), on,
                          monkeypatch, **opts)
        assert _same_bytes(ours, theirs), on
    plain = str(tmp_path / "plain.cram")
    tbatch.bam_to_cram_file(bams[kind], plain,
                            **dict(opts, device_profile=False))
    wires = _qs_wires(ours)
    assert len(wires) == 3 and all(n >= 64 for *_, n in wires)
    if ver == (3, 0):
        # no effect below CRAM 3.1
        assert _same_bytes(ours, plain)
    else:
        assert wires == [(RANSPR, 0x04 | order, n) for *_, n in wires]
        assert not _same_bytes(ours, plain)


def test_device_profile_qual_hist_matches_the_jax_reader(bams, tmp_path,
                                                         monkeypatch):
    """cram_qual_hist on device-profile files (both orders) equals the
    histogram of the JAX reader's qualities, every block decoded by the
    quality lane."""
    monkeypatch.setattr("htslib_tpu.native.native", None)
    monkeypatch.setattr("htslib_tpu_torch.native.native", None)
    for kind in ("iid", "walk"):
        path = str(tmp_path / f"{kind}.cram")
        tbatch.bam_to_cram_file(bams[kind], path, version=(3, 1),
                                seqs_per_slice=80, device_profile=True)
        stats = {}
        got = cram_qual_hist(path, device="cpu", stats=stats)
        want = np.zeros(QBINS, np.int64)
        with JReader(path) as r:
            for rec in r:
                q = np.minimum(np.frombuffer(rec.qual, np.uint8), QBINS - 1)
                want += np.bincount(q, minlength=QBINS)
        assert np.array_equal(got, want)
        assert stats == {"device_blocks": 3, "host_blocks": 0}


@pytest.mark.parametrize("ver,profile", [((3, 0), None), ((3, 1), None),
                                         ((3, 1), "small")],
                         ids=["3.0", "3.1", "3.1-small"])
def test_nthreads_writes_the_same_bytes(bams, ver, profile, tmp_path,
                                        monkeypatch):
    """The port at nthreads 1 and 4 and the JAX encoder at nthreads 1
    write the same bytes (three containers of one slice, and of two),
    both on their pure-Python paths."""
    port = pytest.MonkeyPatch()
    port.setattr("htslib_tpu_torch.native.native", None)
    try:
        _nthreads_same_bytes(bams, ver, profile, tmp_path, monkeypatch)
    finally:
        port.undo()


def _nthreads_same_bytes(bams, ver, profile, tmp_path, monkeypatch):
    for spc in (1, 2):
        opts = dict(ref=bams["fasta"], version=ver, seqs_per_slice=80,
                    slices_per_container=spc, profile=profile)
        paths = []
        for n in (1, 4):
            paths.append(str(tmp_path / f"p{n}_{spc}.cram"))
            tbatch.bam_to_cram_file(bams["walk"], paths[-1], nthreads=n,
                                    **opts)
        theirs = jax_cram(bams["walk"], str(tmp_path / f"j_{spc}.cram"),
                          False, monkeypatch, nthreads=1, **opts)
        assert _same_bytes(paths[0], paths[1])
        assert _same_bytes(paths[0], theirs)
