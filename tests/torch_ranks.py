"""Rank functions for the port's multi-process tests
(tests/test_torch_mesh.py, tests/test_torch_distributed.py,
tests/test_torch_bcf_shards.py, tests/test_torch_pileup_shard.py), run by
htslib_tpu_torch/parallel/launch.py `run_ranks` in spawned processes.
This module imports neither JAX nor the JAX package, so a rank process
loads torch alone."""
import numpy as np
import torch
import torch.distributed as dist

from htslib_tpu_torch.entry import dryrun_multichip
from htslib_tpu_torch.parallel.mesh import (make_coord_sharded_pileup,
                                            make_decode_pileup_step,
                                            make_flagstat_step, make_mesh,
                                            shard_batch)


def mesh_inputs(n, seed=5):
    """Global arrays of every step for a mesh of n: 48 records (cores,
    packed sequences, spans over 3 kbp, a validity mask with holes), 40
    flags padded to 48 with invalid rows, and 8 reads a rank for the halo
    ring, each starting in its rank's tile and spanning less than the
    halo."""
    rng = np.random.default_rng(seed + n)
    N, tile, halo, per = 48, 256, 64, 8
    starts = np.sort(rng.integers(0, 3000, N)).astype(np.int32)
    flags = np.zeros(N, np.int32)
    flags[:40] = rng.integers(0, 1 << 12, 40)
    flags[40:] = 0x4 | 0x1
    h_starts = (np.repeat(np.arange(n), per) * tile
                + rng.integers(0, tile, n * per)).astype(np.int32)
    return {
        "cores": rng.integers(0, 256, (N, 32), dtype=np.uint8),
        "seq4": rng.integers(0, 256, (N, 16), dtype=np.uint8),
        "starts": starts,
        "ends": (starts + rng.integers(50, 151, N)).astype(np.int32),
        "valid": rng.random(N) > 0.1,
        "tile_len": 1 << 12, "tile_start": np.array([100], np.int32),
        "flags": flags, "flag_valid": np.arange(N) < 40,
        "tile": tile, "halo": halo, "h_starts": h_starts,
        "h_ends": (h_starts + rng.integers(1, halo, n * per)).astype(
            np.int32),
        "h_valid": rng.random(n * per) > 0.1,
    }


def mesh_steps(rank, n, inputs, device="cpu"):
    """Every mesh step on this rank's shards of the global `inputs`;
    returns each output as numpy, and the refusal of an uneven leading
    dimension by shard_batch (its exception type name, or None)."""
    torch.set_num_threads(1)
    mesh = make_mesh(n=n, device=device)
    step = make_decode_pileup_step(mesh, tile_len=inputs["tile_len"])
    cov, bases, flags = step(*shard_batch(
        mesh, inputs["cores"], inputs["seq4"], inputs["starts"],
        inputs["ends"], inputs["valid"]), inputs["tile_start"])
    counts = make_flagstat_step(mesh)(*shard_batch(
        mesh, inputs["flags"], inputs["flag_valid"]))
    hstep = make_coord_sharded_pileup(mesh, tile_len=inputs["tile"],
                                      halo=inputs["halo"])
    halo = hstep(*shard_batch(mesh, inputs["h_starts"], inputs["h_ends"],
                              inputs["h_valid"]))
    try:
        shard_batch(mesh, np.zeros(3 * n + 1, np.int32))
        uneven = None
    except ValueError:
        uneven = "ValueError"
    out = {"cov": cov, "bases": bases, "flags": flags, "counts": counts,
           "halo": halo}
    out = {k: v.cpu().numpy() for k, v in out.items()}
    out.update(uneven=uneven, backend=mesh.backend,
               device=str(cov.device), timing=dict(mesh.timing))
    return out


def world_sum(rank, n):
    """This rank's view of a world: (rank, size, the all-reduced sum of
    rank + 1)."""
    t = torch.tensor([rank + 1], dtype=torch.int64)
    dist.all_reduce(t)
    return dist.get_rank(), dist.get_world_size(), int(t[0])


def dryrun(rank, n):
    torch.set_num_threads(1)
    dryrun_multichip(n, device="cpu")
    return rank


def compile_once(rank, n, build_dir):
    """_build's compile of csrc/nibble.cu into `build_dir`, with nvcc
    whatever CUDA_HOME names; returns the library path."""
    from htslib_tpu_torch import _build
    _build.BUILD = build_dir
    dist.barrier()          # every rank starts its compile together
    return _build._compile("nibble")


def fail_on_rank_one(rank, n):
    if rank == 1:
        raise ValueError("rank one fails")
    dist.barrier()          # rank 0 waits here until it is killed
    return rank


def bcf_shard(rank, n, path):
    """This rank's shard of a BCF file as VCF text: the plan made on
    every rank, its own shard decoded on the CPU."""
    from htslib_tpu_torch.parallel.distributed import (
        decode_bcf_shard_to_vcf, plan_bcf_shards)
    torch.set_num_threads(1)
    plan = plan_bcf_shards(path, n, device="cpu")
    return decode_bcf_shard_to_vcf(plan, plan.shards[rank], device="cpu")


def pileup_tile(rank, n, path):
    """This rank's tile of a pileup: the tile plan made on every rank
    from its own read of `path`, its own tile's columns (pileup text
    lines) on the CPU, and the world's column count all-reduced."""
    from htslib_tpu_torch.parallel.pileup_shard import (_load_records,
                                                        mpileup_one_tile,
                                                        plan_pileup_tiles)
    from htslib_tpu_torch.pileup import _format_plp_column
    torch.set_num_threads(1)
    _, records = _load_records(path, device="cpu")
    tiles = plan_pileup_tiles(records, n)
    cols = mpileup_one_tile(path, tiles[rank], _format_plp_column, "cpu")
    total = torch.tensor([len(cols)], dtype=torch.int64)
    dist.all_reduce(total)
    return cols, int(total[0])
