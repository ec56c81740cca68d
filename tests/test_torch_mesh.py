"""The port's device mesh (htslib_tpu_torch/parallel/mesh.py) against the
JAX package's (htslib_tpu/parallel/mesh.py) on the same seeded inputs.

The JAX steps run in this process on 1, 2 and 4 of the 8 virtual CPU
devices tests/conftest.py gives it.  The port's run as a world of one in
this process (make_mesh sets it up) and as 2 and 4 gloo ranks, one
spawned process each (parallel/launch.py `run_ranks`; the rank function
is tests/torch_ranks.py `mesh_steps`).  A `P()` output must be the JAX
array on every rank; the ranks' `P("data")` slices, concatenated in rank
order, the JAX global array.  Outputs are integers: equality is exact.
tests/test_torch_gpu.py runs the same steps on the card as a world of
one under NCCL."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from htslib_tpu.parallel import mesh as jm
from htslib_tpu_torch.parallel.launch import run_ranks

NS = (1, 2, 4)


@pytest.fixture(autouse=True, scope="module")
def _jax_32bit():
    """The JAX reference runs in its default 32-bit mode; another test
    module in the same worker process may have switched JAX to 64-bit."""
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", before)


INPUTS = {n: torch_ranks.mesh_inputs(n) for n in NS}


@pytest.fixture(scope="module")
def jax_out():
    out = {}
    for n, x in INPUTS.items():
        mesh = jm.make_mesh(n=n)
        step = jm.make_decode_pileup_step(mesh, tile_len=x["tile_len"])
        cov, bases, flags = step(*jm.shard_batch(
            mesh, x["cores"], x["seq4"], x["starts"], x["ends"],
            x["valid"]), jnp.asarray(x["tile_start"]))
        counts = jm.make_flagstat_step(mesh)(*jm.shard_batch(
            mesh, x["flags"], x["flag_valid"]))
        halo = jm.make_coord_sharded_pileup(
            mesh, tile_len=x["tile"], halo=x["halo"])(*jm.shard_batch(
                mesh, x["h_starts"], x["h_ends"], x["h_valid"]))
        out[n] = {k: np.asarray(v) for k, v in (
            ("cov", cov), ("bases", bases), ("flags", flags),
            ("counts", counts), ("halo", halo))}
    return out


@pytest.fixture(scope="module")
def port_out():
    """Each rank's outputs: a world of one in this process, then 2 and 4
    gloo ranks."""
    threads = torch.get_num_threads()
    try:
        out = {1: [torch_ranks.mesh_steps(0, 1, INPUTS[1])]}
    finally:
        torch.set_num_threads(threads)
    for n in (2, 4):
        out[n] = run_ranks(torch_ranks.mesh_steps, n, (INPUTS[n],),
                           timeout=240)
    return out


@pytest.mark.parametrize("n", NS)
def test_decode_pileup_step_matches_jax(n, jax_out, port_out):
    want = jax_out[n]
    for r in port_out[n]:
        assert r["cov"].dtype == np.int32 and r["backend"] == "gloo"
        assert np.array_equal(r["cov"], want["cov"])
    for key in ("bases", "flags"):
        got = np.concatenate([r[key] for r in port_out[n]])
        assert got.dtype == want[key].dtype
        assert np.array_equal(got, want[key])


@pytest.mark.parametrize("n", NS)
def test_flagstat_step_matches_jax(n, jax_out, port_out):
    want = jax_out[n]["counts"]
    assert want.dtype == np.int32 and want[0] == 40
    for r in port_out[n]:
        assert r["counts"].dtype == np.int32
        assert np.array_equal(r["counts"], want)
    # the counting loop of tests/test_distributed.py over the valid flags
    loop = np.zeros(11, np.int64)
    for f in INPUTS[n]["flags"][:40].tolist():
        loop += [1, bool(f & 0x100), bool(f & 0x800), bool(f & 0x400),
                 not f & 4, bool(f & 1), bool(f & 0x40), bool(f & 0x80),
                 bool(f & 2), bool(f & 1) and not f & 4 and not f & 8,
                 bool(f & 1) and not f & 4 and bool(f & 8)]
    assert np.array_equal(want, loop)


@pytest.mark.parametrize("n", NS)
def test_halo_ring_matches_jax_and_brute_force(n, jax_out, port_out):
    x = INPUTS[n]
    got = np.concatenate([r["halo"] for r in port_out[n]])
    assert np.array_equal(got, jax_out[n]["halo"])
    # the brute force of tests/test_ops.py's halo exchange
    brute = np.zeros(n * x["tile"], np.int32)
    for s, e, v in zip(x["h_starts"], x["h_ends"], x["h_valid"]):
        if v:
            brute[s:min(e, n * x["tile"])] += 1
    assert np.array_equal(got, brute)
    ring = [r["timing"]["ring_steps"] for r in port_out[n]]
    assert ring == [0 if n == 1 else 1] * n


@pytest.mark.parametrize("n", (2, 4))
def test_shard_batch_refuses_uneven_like_jax(n, port_out):
    mesh = jm.make_mesh(n=n)
    with pytest.raises(ValueError):
        jm.shard_batch(mesh, np.zeros(3 * n + 1, np.int32))
    assert [r["uneven"] for r in port_out[n]] == ["ValueError"] * n


def test_make_mesh_refuses_a_world_too_small():
    from htslib_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(n=1, device="cpu")
    assert (mesh.rank, mesh.size, mesh.backend) == (0, 1, "gloo")
    with pytest.raises((ValueError, RuntimeError)):
        make_mesh(n=2, device="cpu")
