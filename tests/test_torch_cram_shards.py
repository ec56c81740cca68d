"""The port's CRAM shard plans (htslib_tpu_torch/parallel/distributed.py
`plan_cram_shards`, `decode_cram_shard_to_sam`) against the JAX
package's, and the CRAM gate of the port's `dryrun_multichip`.  Plans
are compared field by field through `carry.from_jax_cram_shard_plan`;
each shard's SAM text byte for byte, on the files of the port's encoder
and of both JAX encoders (native and pure Python), at n = 1, 3, 4 and at
more shards than containers.  On the CPU the device stages run their
plain versions."""
import jax
import numpy as np
import pytest

from htslib_tpu.cram.batch import cram_file_to_sam as jcram_file_to_sam
from htslib_tpu.parallel import distributed as jd
from htslib_tpu_torch import carry
from htslib_tpu_torch.cram import batch as tbatch
from htslib_tpu_torch.entry import dryrun_multichip
from htslib_tpu_torch.parallel import distributed as td
from test_torch_cram import cram_records, jax_cram, write_bam, write_fasta


@pytest.fixture(autouse=True, scope="module")
def _jax_32bit():
    """The JAX package runs in its default 32-bit mode; another test
    module in the same worker process may have switched JAX to 64-bit."""
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", before)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """400 records at 100 a slice (4 containers): the port's CRAM 3.0
    with a reference, and the JAX encoders' CRAM 3.1 without one:
    {name: (path, ref)}."""
    d = tmp_path_factory.mktemp("shards")
    fa = str(d / "ref.fa")
    hdr, recs = cram_records(400, 41, write_fasta(fa, 7))
    bam = write_bam(str(d / "in.bam"), hdr, recs)
    out = {"port": (str(d / "port.cram"), fa)}
    tbatch.bam_to_cram_file(bam, out["port"][0], ref=fa, seqs_per_slice=100)
    mp = pytest.MonkeyPatch()
    for name, on in (("jax_py", False), ("jax_native", True)):
        out[name] = (jax_cram(bam, str(d / f"{name}.cram"), on, mp,
                              version=(3, 1), seqs_per_slice=100), None)
    return out


def _same_plan(got, want):
    assert (got.path, got.ref) == (want.path, want.ref)
    for key in ("offsets", "ends", "nrecs"):
        g, w = getattr(got, key), getattr(want, key)
        assert g.dtype == np.int64 and np.array_equal(g, w), key
    assert got.shards == want.shards


@pytest.mark.parametrize("name", ["port", "jax_py", "jax_native"])
@pytest.mark.parametrize("n", [1, 3, 4, 7])
def test_plans_match_jax(files, name, n):
    path, ref = files[name]
    plan = td.plan_cram_shards(path, n, ref=ref)
    _same_plan(plan, carry.from_jax_cram_shard_plan(
        jd.plan_cram_shards(path, n, ref=ref)))
    assert len(plan.offsets) == 4
    assert len(plan.shards) == min(n, 4)
    assert sum(s.n_records for s in plan.shards) == 400


@pytest.mark.parametrize("name", ["port", "jax_native"])
@pytest.mark.parametrize("n", [1, 3, 4, 7])
def test_shard_decode_matches_jax(files, name, n):
    """Each shard's text is the JAX shard's, and the shards in order are
    the whole file's."""
    path, ref = files[name]
    plan = td.plan_cram_shards(path, n, ref=ref)
    jplan = jd.plan_cram_shards(path, n, ref=ref)
    parts = [td.decode_cram_shard_to_sam(plan, sh, window=8, device="cpu")
             for sh in plan.shards]
    assert parts == [jd.decode_cram_shard_to_sam(jplan, sh)
                     for sh in jplan.shards]
    _, whole = jcram_file_to_sam(path, ref=ref)
    assert b"".join(parts) == whole.tobytes()


def test_empty_range_decodes_to_nothing(files):
    path, ref = files["port"]
    plan = td.plan_cram_shards(path, 2, ref=ref)
    empty = td.CramShard(9, plan.shards[1].end, plan.shards[1].end, 0)
    assert td.decode_cram_shard_to_sam(plan, empty, device="cpu") == b""


def _one_container(monkeypatch):
    real = tbatch.bam_to_cram_file
    monkeypatch.setattr(tbatch, "bam_to_cram_file",
                        lambda b, c, **k: real(b, c, **dict(
                            k, seqs_per_slice=10_000)))


def _drop_a_byte(monkeypatch):
    real = td.decode_cram_shard_to_sam
    monkeypatch.setattr(td, "decode_cram_shard_to_sam",
                        lambda *a, **k: real(*a, **k)[:-1])


@pytest.mark.parametrize("brk,message", [
    (_one_container, "CRAM plan produced a single shard"),
    (_drop_a_byte, "sharded CRAM decode != single-host output")],
    ids=["single_shard", "sharded_decode"])
def test_dryrun_cram_gate_raises(monkeypatch, brk, message):
    """The CRAM gate's input broken: the whole BAM in one container, so
    the plan has one shard; or a shard's text short of a byte."""
    brk(monkeypatch)
    with pytest.raises(AssertionError, match=message):
        dryrun_multichip(1, device="cpu")
