"""Multi-process scale-out: port of the BAM and CRAM parts of
htslib_tpu/parallel/distributed.py.

The file-level unit of distribution is a shard plan, computed once on the
host and handed to every rank; the shards' outputs concatenated in shard
order are the single-process output.  A BAM plan holds record-aligned
ranges of the file's uncompressed stream and the BGZF members that cover
them: each rank inflates only its covering members on the device
(ops/inflate.py, kernel X4) and formats or counts only its records
(ops/bam2sam.py, kernel X5 and B1).  A CRAM plan holds ranges of whole
containers balanced by their bytes: each rank decodes only its
containers (cram/batch.py `cram_range_to_sam`: rANS blocks on the
device, records on the host, SAM formatting on the device).

`initialize` joins this process to a torch.distributed world (the JAX
package's wraps jax.distributed.initialize).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from htslib_tpu_torch import _build
from htslib_tpu_torch.bgzf import check_member, member_payload, scan_blocks
from htslib_tpu_torch.cram import CRAM_EOF_START, CramReader
from htslib_tpu_torch.cram.batch import cram_range_to_sam
from htslib_tpu_torch.ops.bam2sam import (bam_payload_to_sam_device,
                                          device_record_scan)
from htslib_tpu_torch.ops.inflate import inflate_batch
from htslib_tpu_torch.ops.seqfmt import unpack_core_fields
from htslib_tpu_torch.parallel.mesh import flag_counts
from htslib_tpu_torch.sam.bam import BamReader, read_header


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """torch.distributed.init_process_group for this process as rank
    `process_id` of `num_processes`, meeting at `coordinator` ("host:port",
    a TCP store that rank 0 opens, or a full init URL such as
    "file:///path").  Without a coordinator it reads PyTorch's own
    environment convention, MASTER_ADDR and MASTER_PORT (with WORLD_SIZE
    and RANK for the counts), and is a no-op when MASTER_ADDR is unset:
    single-process code paths stay identical.  The backend defaults to
    NCCL where a CUDA device is present and gloo where none is; a failed
    init raises and is never retried on another backend."""
    env = os.environ
    if coordinator is None:
        if "MASTER_ADDR" not in env:
            return
        coordinator = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        if num_processes is None:
            num_processes = int(env["WORLD_SIZE"])
        if process_id is None:
            process_id = int(env["RANK"])
    if num_processes is None or process_id is None:
        raise ValueError("initialize: a coordinator needs num_processes and "
                         "process_id")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)


@dataclass
class BamShard:
    index: int
    ustart: int          # absolute uncompressed offset of first record
    uend: int            # absolute offset past this shard's last record
    n_records: int


@dataclass
class BamShardPlan:
    path: str
    coffsets: np.ndarray  # uint64 per BGZF member
    csizes: np.ndarray    # uint32
    ustarts: np.ndarray   # uint64 absolute uncompressed start per member
    usizes: np.ndarray    # uint32
    shards: List[BamShard] = field(default_factory=list)


def plan_bam_shards(path: str, n_shards: int) -> BamShardPlan:
    """Split a BAM into at most n_shards record-aligned shards balanced
    by uncompressed record bytes (block-range sharding by file offset).
    Records begin after the header, which may end inside a member: the
    first shard then starts within it."""
    bt = scan_blocks(np.fromfile(path, np.uint8))
    co, cs, us = bt.coffsets, bt.csizes, bt.usizes
    ustarts = np.zeros(len(us), np.uint64)
    np.cumsum(us[:-1].astype(np.uint64), out=ustarts[1:])
    total_u = int(ustarts[-1]) + int(us[-1]) if len(us) else 0

    with BamReader(path) as r:
        data, offs, sizes = r.raw_records()
    rec_base = total_u - int(data.nbytes)
    n = len(offs)
    rec_ends = offs.astype(np.int64) + sizes.astype(np.int64)

    plan = BamShardPlan(path, co, cs, ustarts, us)
    per = (int(data.nbytes) + max(n_shards, 1) - 1) // max(n_shards, 1)
    lo_rec = 0
    for si in range(n_shards):
        if lo_rec >= n:
            break
        hi_rec = int(np.searchsorted(rec_ends, (si + 1) * per,
                                     side="right"))
        hi_rec = max(hi_rec, lo_rec + 1)
        if si == n_shards - 1:
            hi_rec = n
        plan.shards.append(BamShard(
            si, rec_base + int(offs[lo_rec]),
            rec_base + int(rec_ends[hi_rec - 1]), hi_rec - lo_rec))
        lo_rec = hi_rec
    return plan


def _shard_stream(plan: BamShardPlan, shard: BamShard, dev) -> bytes:
    """The shard's record bytes: its covering members read from the file
    and inflated on `dev` (X4 on the card), each CRC32 and ISIZE checked
    on the host, sliced to [ustart, uend)."""
    b_lo = max(int(np.searchsorted(plan.ustarts, shard.ustart,
                                   side="right")) - 1, 0)
    b_hi = max(int(np.searchsorted(plan.ustarts, shard.uend, side="left")),
               b_lo + 1)
    first = int(plan.coffsets[b_lo])
    co = plan.coffsets[b_lo:b_hi].astype(np.int64) - first
    cs = plan.csizes[b_lo:b_hi].astype(np.int64)
    raw = np.fromfile(plan.path, np.uint8, count=int(co[-1] + cs[-1]),
                      offset=first)
    pieces = inflate_batch([member_payload(raw, o, s) for o, s in zip(co, cs)],
                           [int(u) for u in plan.usizes[b_lo:b_hi]],
                           device=dev)
    for o, s, piece in zip(co, cs, pieces):
        check_member(raw, int(o), int(s), piece)
    base = int(plan.ustarts[b_lo])
    return b"".join(pieces)[shard.ustart - base:shard.uend - base]


def decode_shard_to_sam(plan: BamShardPlan, shard: BamShard, header=None,
                        device="cuda") -> bytes:
    """One rank's work: inflate only the members covering this shard,
    then frame and format its records on the device (ops/bam2sam.py).
    Concatenating the results in shard order gives the single-process
    SAM text."""
    dev = _build.resolve_device(device)
    if header is None:
        header = read_header(plan.path)
    return bam_payload_to_sam_device(_shard_stream(plan, shard, dev), header,
                                     device=dev)


def flagstat_shard(plan: BamShardPlan, shard: BamShard,
                   device="cuda") -> np.ndarray:
    """The samtools flagstat counters of one shard, int64 [11] (the order
    of parallel/mesh.py `flag_counts`): its members inflated (X4), its
    records framed (X5), their flags read and counted on the device."""
    dev = _build.resolve_device(device)
    chunk = torch.from_numpy(np.frombuffer(
        _shard_stream(plan, shard, dev), np.uint8).copy()).to(dev)
    offs, _sizes, n = device_record_scan(chunk, shard.n_records)
    if int(n) != shard.n_records:
        raise IOError(f"shard {shard.index}: {int(n)} records framed, the "
                      f"plan has {shard.n_records}")
    at = (offs.long() + 4)[:, None] + torch.arange(32, device=dev)
    flags = unpack_core_fields(chunk[at])["flag"]
    return flag_counts(flags, torch.ones_like(flags, dtype=torch.bool),
                       torch.int64).cpu().numpy()


def distributed_flagstat(path: str, n_shards: int,
                         device="cuda") -> np.ndarray:
    """Shard-parallel flagstat in one process: each shard's counters
    (`flagstat_shard`) summed, the host-level mirror of the mesh's
    all-reduce (parallel/mesh.py `make_flagstat_step`)."""
    plan = plan_bam_shards(path, n_shards)
    total = np.zeros(11, np.int64)
    for sh in plan.shards:
        total += flagstat_shard(plan, sh, device=device)
    return total


# ---------------------------------------------------------------------------
# CRAM container shard plans: the container walk of cram_index.c:851-1021
# ---------------------------------------------------------------------------

@dataclass
class CramShard:
    index: int
    offset: int          # absolute byte offset of the first container
    end: int             # past-end byte offset of the last container
    n_records: int


@dataclass
class CramShardPlan:
    path: str
    ref: Optional[str]
    offsets: np.ndarray  # int64 per data container: its byte offset
    ends: np.ndarray     # int64 per data container: its past-end offset
    nrecs: np.ndarray    # int64 per data container: its records
    shards: List[CramShard] = field(default_factory=list)


def plan_cram_shards(path: str, n_shards: int,
                     ref: Optional[str] = None) -> CramShardPlan:
    """Split a CRAM into at most n_shards container-aligned shards
    balanced by container bytes: one walk over the container headers
    (the EOF container ends it, containers without records are skipped),
    then shard k ends after the first container whose cumulative bytes
    reach (k + 1) x ceil(total / n_shards)."""
    offsets: List[int] = []
    ends: List[int] = []
    nrecs: List[int] = []
    with CramReader(path, ref=ref) as r:
        while True:
            pos = r.fp.tell()
            c = r.io.read_container_header()
            if c is None:
                break
            if c.ref_seq_id == -1 and c.ref_seq_start == CRAM_EOF_START:
                break
            r.io.skip_container_data(c)
            if c.length == 0 or c.num_records == 0:
                continue
            offsets.append(pos)
            ends.append(c.data_offset + c.length)
            nrecs.append(c.num_records)

    plan = CramShardPlan(path, ref, np.asarray(offsets, np.int64),
                         np.asarray(ends, np.int64),
                         np.asarray(nrecs, np.int64))
    nc = len(offsets)
    if nc == 0:
        return plan
    csum = np.cumsum(plan.ends - plan.offsets)
    per = (int(csum[-1]) + max(n_shards, 1) - 1) // max(n_shards, 1)
    lo = 0
    for si in range(n_shards):
        if lo >= nc:
            break
        hi = int(np.searchsorted(csum, (si + 1) * per, side="left")) + 1
        hi = max(hi, lo + 1)
        if si == n_shards - 1:
            hi = nc
        hi = min(hi, nc)
        plan.shards.append(CramShard(
            si, int(plan.offsets[lo]), int(plan.ends[hi - 1]),
            int(plan.nrecs[lo:hi].sum())))
        lo = hi
    return plan


def decode_cram_shard_to_sam(plan: CramShardPlan, shard: CramShard,
                             window: int = 4, device="cuda",
                             timing: Optional[dict] = None) -> bytes:
    """One rank's work: decode only this shard's containers
    (cram/batch.py `cram_range_to_sam`, `window` slices a device call).
    Concatenating the results in shard order gives the single-process
    `cram_file_to_sam` text.  `timing` is cram_range_to_sam's."""
    _, sam = cram_range_to_sam(plan.path, shard.offset, shard.end,
                               ref=plan.ref, window=window, device=device,
                               timing=timing)
    return sam.tobytes()
