"""The device mesh on torch.distributed: port of htslib_tpu/parallel/mesh.py.

The JAX mesh is single-controller: one process runs `shard_map` over n
devices, and a step's arguments and results are global arrays laid out
by PartitionSpecs.  torch.distributed runs one process a rank, so here
each rank holds its own slice: `shard_batch` cuts this rank's rows of
each global array, and a step returns what the JAX step's `out_specs`
say, a `P()` output whole on every rank and a `P("data")` output as this
rank's slice.  The JAX `psum` is `all_reduce(SUM)` and the one-hop
`ppermute` ring a paired send and receive (`batch_isend_irecv`).

Sharding layout (as in the JAX package):
  * "data" axis: record batches are embarrassingly parallel, so the batch
    dimension is split over the ranks;
  * genomic-coordinate sharding: rank d owns the tile [d * tile_len,
    (d + 1) * tile_len), and the tiles' partial counts merge over the
    mesh (the only communication, with the halo at a tile's right edge).

Collectives run on the world's backend: NCCL on CUDA tensors, or gloo.
gloo has no path for a CUDA tensor here, so a step on the card under
gloo copies what it sends through the host; `Mesh.timing` keeps the
seconds of the all-reduces, the ring and that staging apart.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from htslib_tpu_torch import _build
from htslib_tpu_torch.ops.pileup_kernel import coverage_tile
from htslib_tpu_torch.ops.seqfmt import nibble_to_base, unpack_core_fields


class Mesh:
    """One rank's view of a one-axis mesh: the process group of its n
    ranks (ranks 0..n-1 of the world), this rank's index on it (-1 for a
    rank of the world outside it), the axis name and the device the
    rank's work runs on.  `timing` sums the seconds of its collectives,
    each ended by a synchronise: all_reduce_s, ring_s and staging_s (the
    host copies gloo needs for a CUDA tensor)."""

    def __init__(self, group, rank: int, size: int, axis: str,
                 device: torch.device):
        self.group, self.rank, self.size = group, rank, size
        self.axis, self.device = axis, device
        self.backend = dist.get_backend(group) if rank >= 0 else None
        self.timing = {"all_reduce_s": 0.0, "ring_s": 0.0,
                       "staging_s": 0.0, "all_reduces": 0, "ring_steps": 0}

    def _member(self) -> None:
        if self.rank < 0:
            raise RuntimeError("this rank is not on the mesh")

    def _to_wire(self, t: torch.Tensor) -> torch.Tensor:
        """t as the backend takes it: a host copy of a CUDA tensor under
        gloo, else t itself."""
        if not t.is_cuda or self.backend == "nccl":
            return t
        t0 = _build.clock(t.device)
        h = t.cpu()
        self.timing["staging_s"] += _build.clock(t.device) - t0
        return h

    def _from_wire(self, w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if w.device == like.device:
            return w
        t0 = _build.clock(like.device)
        out = w.to(like.device)
        self.timing["staging_s"] += _build.clock(like.device) - t0
        return out

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of t over the mesh's ranks (the JAX psum), in t's
        dtype, on t's device."""
        self._member()
        w = self._to_wire(t.contiguous())
        t0 = _build.clock(w.device)
        dist.all_reduce(w, op=dist.ReduceOp.SUM, group=self.group)
        self.timing["all_reduce_s"] += _build.clock(w.device) - t0
        self.timing["all_reduces"] += 1
        return self._from_wire(w, t)

    def ring_shift(self, t: torch.Tensor) -> torch.Tensor:
        """What rank (d - 1) mod n holds of t, received while t goes to
        rank (d + 1) mod n: the JAX one-hop ppermute.  A mesh of one
        sends nothing and returns zeros: the JAX ring's self-edge, whose
        value rank 0 drops."""
        self._member()
        if self.size == 1:
            return torch.zeros_like(t)
        w = self._to_wire(t.contiguous())
        buf = torch.empty_like(w)
        t0 = _build.clock(w.device)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, w, (self.rank + 1) % self.size,
                       self.group),
            dist.P2POp(dist.irecv, buf, (self.rank - 1) % self.size,
                       self.group)])
        for req in reqs:
            req.wait()
        self.timing["ring_s"] += _build.clock(w.device) - t0
        self.timing["ring_steps"] += 1
        return self._from_wire(buf, t)


def make_mesh(n: Optional[int] = None, device="cuda",
              axis: str = "data") -> Mesh:
    """A mesh over the first n ranks of the world (all of them for n
    None).  On a process with no world yet, n None or 1 sets up a world
    of one (NCCL for the card, gloo for the CPU), so single-rank code runs
    as it does on a JAX mesh of one device; any other n raises: call
    parallel.distributed.initialize first.  Every rank of the world must
    call it, since making a group of fewer ranks is collective."""
    dev = _build.resolve_device(device)
    if not dist.is_initialized():
        if n not in (None, 1):
            raise RuntimeError(f"make_mesh(n={n}): no world of {n} ranks; "
                               "call parallel.distributed.initialize first")
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    world = dist.get_world_size()
    n = world if n is None else n
    if not 1 <= n <= world:
        raise ValueError(f"make_mesh(n={n}): the world has {world} ranks")
    group = (dist.group.WORLD if n == world
             else dist.new_group(list(range(n))))
    rank = dist.get_rank()
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(group, rank if rank < n else -1, n, axis, dev)


def shard_batch(mesh: Mesh, *arrays):
    """This rank's slice of each global array (numpy or tensor): the
    leading dimension split evenly over the mesh, as NamedSharding lays a
    P("data") array out, on the mesh's device; a 0-d array is
    replicated.  Raises ValueError where n does not divide the leading
    dimension, as NamedSharding does."""
    mesh._member()
    out = []
    for a in arrays:
        t = a if torch.is_tensor(a) else torch.from_numpy(
            np.ascontiguousarray(a))
        if t.dim() == 0:
            out.append(t.to(mesh.device))
            continue
        if t.shape[0] % mesh.size:
            raise ValueError(f"shard_batch: leading dimension {t.shape[0]} "
                             f"is not a multiple of the mesh's {mesh.size} "
                             "ranks")
        per = t.shape[0] // mesh.size
        out.append(t[mesh.rank * per:(mesh.rank + 1) * per].contiguous()
                   .to(mesh.device))
    return tuple(out)


def make_decode_pileup_step(mesh: Mesh, tile_len: int = 1 << 14):
    """The distributed step: each rank decodes its shard of the record
    batch (core unpack, nibble expand: kernel B1 on the card) and
    accumulates pileup coverage of the shared tile [tile_start,
    tile_start + tile_len); the tiles merge by an all-reduce.

    step(cores, seq4, starts, ends, valid, tile_start) takes this rank's
    shards (`shard_batch`) and tile_start (an int or a one-element array,
    the same on every rank) and returns (coverage int32 [tile_len], whole
    on every rank; bases uint8, this rank's rows; flags int32, this
    rank's rows)."""

    def step(cores, seq4, starts, ends, valid, tile_start):
        fields = unpack_core_fields(cores)
        bases = nibble_to_base(seq4)
        start = int(torch.as_tensor(tile_start).reshape(-1)[0])
        cov = coverage_tile(starts, ends, valid, start, tile_len)
        return (mesh.all_reduce_sum(cov), bases,
                fields["flag"].to(torch.int32))

    return step


def make_coord_sharded_pileup(mesh: Mesh, tile_len: int = 1 << 14,
                              halo: int = 1 << 10):
    """Genomic-coordinate sharding: rank d owns the tile [d * tile_len,
    (d + 1) * tile_len) and holds the reads starting in it.  Reads extend
    right by up to `halo` bases (at least the longest read span), so each
    rank accumulates the tile and its halo and ships the spill past the
    tile to rank d + 1; rank 0 drops what wraps round from the last tile
    (beyond the genome's end, as hts_pos clamps).

    step(starts, ends, valid) takes this rank's reads (global genome
    coordinates) and returns its tile's coverage, int32 [tile_len]: the
    rank's slice of the JAX step's P("data") output."""

    def step(starts, ends, valid):
        mesh._member()
        cov_ext = coverage_tile(starts, ends, valid, mesh.rank * tile_len,
                                tile_len + halo)
        own = cov_ext[:tile_len].clone()
        recv = mesh.ring_shift(cov_ext[tile_len:])
        if mesh.rank == 0:
            recv = torch.zeros_like(recv)
        own[:halo] += recv
        return own

    return step


def flag_counts(flags: torch.Tensor, valid: torch.Tensor,
                dtype=torch.int32) -> torch.Tensor:
    """The samtools flagstat counters of the valid records, [11] in
    `dtype`: total, secondary, supplementary, duplicates, mapped, paired,
    read1, read2, proper pair, both mapped, singleton."""
    f = flags.to(torch.int32)
    v = valid.to(torch.bool)
    paired_mapped = ((f & 1) != 0) & ((f & 4) == 0)
    masks = [torch.ones_like(v), (f & 0x100) != 0, (f & 0x800) != 0,
             (f & 0x400) != 0, (f & 4) == 0, (f & 1) != 0,
             (f & 0x40) != 0, (f & 0x80) != 0, (f & 2) != 0,
             paired_mapped & ((f & 8) == 0), paired_mapped & ((f & 8) != 0)]
    return torch.stack([(v & m).sum(dtype=dtype) for m in masks])


def make_flagstat_step(mesh: Mesh):
    """samtools flagstat as a mesh reduction: each rank counts the flag
    categories of its record shard, and the [11] int32 counters (in the
    JAX step's order, `flag_counts`) merge with one all-reduce.

    step(flags, valid) takes this rank's shards and returns the counters,
    whole on every rank."""

    def step(flags, valid):
        return mesh.all_reduce_sum(flag_counts(flags, valid))

    return step
