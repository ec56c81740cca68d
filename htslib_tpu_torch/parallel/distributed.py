"""Multi-process scale-out: port of htslib_tpu/parallel/distributed.py.

The file-level unit of distribution is a shard plan, computed once on the
host and handed to every rank; the shards' outputs concatenated in shard
order are the single-process output.  A BAM plan holds record-aligned
ranges of the file's uncompressed stream and the BGZF members that cover
them: each rank inflates only its covering members on the device
(ops/inflate.py, kernel X4) and formats or counts only its records
(ops/bam2sam.py, kernel X5 and B1).  A CRAM plan holds ranges of whole
containers balanced by their bytes: each rank decodes only its
containers (cram/batch.py `cram_range_to_sam`: rANS blocks on the
device, records on the host, SAM formatting on the device).  A BCF plan
holds record-aligned ranges of the body, balanced by record bytes, and
the BGZF members of the file: each rank inflates only the members that
cover its range on the device (X4) and frames and formats its records on
the host (vcf/record.py).

`initialize` joins this process to a torch.distributed world (the JAX
package's wraps jax.distributed.initialize).
"""
from __future__ import annotations

import os
import struct
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from htslib_tpu_torch import _build
from htslib_tpu_torch.bgzf import BgzfReader, inflate_range, scan_blocks
from htslib_tpu_torch.cram import CRAM_EOF_START, CramReader
from htslib_tpu_torch.cram.batch import cram_range_to_sam
from htslib_tpu_torch.ops.bam2sam import (bam_payload_to_sam_device,
                                          device_record_scan)
from htslib_tpu_torch.ops.seqfmt import unpack_core_fields
from htslib_tpu_torch.parallel.mesh import flag_counts
from htslib_tpu_torch.sam.bam import BamReader, read_header
from htslib_tpu_torch.vcf.io import (BcfReader, bcf_members, format_frames,
                                     split_frames)


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
    """The shard's record bytes: its covering members inflated on `dev`
    (bgzf.py `inflate_range`: X4 on the card, each CRC32 and ISIZE
    checked on the host)."""
    return inflate_range(plan.path, plan.coffsets, plan.csizes,
                         plan.ustarts, plan.usizes, shard.ustart, shard.uend,
                         dev)


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


# ---------------------------------------------------------------------------
# BCF record shard plans
# ---------------------------------------------------------------------------

@dataclass
class BcfShard:
    index: int
    rec_lo: int          # first record ordinal
    rec_hi: int          # past-end ordinal
    ustart: int          # body-relative uncompressed byte offset
    uend: int


@dataclass
class BcfShardPlan:
    path: str
    offs: np.ndarray     # int64 per record: body-relative byte offset
    sizes: np.ndarray    # int64 per record: 8 + l_shared + l_indiv
    coffsets: np.ndarray  # uint64 per BGZF member (none: uncompressed)
    csizes: np.ndarray    # uint32
    ustarts: np.ndarray   # uint64 uncompressed start per member
    usizes: np.ndarray    # uint32
    body: int             # uncompressed offset of the body (past the header)
    shards: List[BcfShard] = field(default_factory=list)


def bcf_layout(path: str):
    """A BCF file's members (vcf/io.py `bcf_members`) and its body's
    uncompressed start, 9 + l_text, from the header's length word read on
    the host.  Returns (coffsets, csizes, ustarts, usizes, total, body)."""
    co, cs, ustarts, us, total = bcf_members(np.fromfile(path, np.uint8))
    with BgzfReader(path) as r:
        head = r.read(9)
    if len(head) < 9 or head[:3] != b"BCF" or head[3] != 2:
        raise IOError("invalid BCF2 magic")
    l_text = struct.unpack_from("<I", head, 5)[0]
    return co, cs, ustarts, us, total, 9 + l_text


def plan_bcf_shards(path: str, n_shards: int, device="cuda") -> BcfShardPlan:
    """Split a BCF into at most n_shards record-aligned shards balanced by
    uncompressed record bytes: the body inflated on `device` (X4 on the
    card) and one frame walk over it on the host; shard k ends after the
    last record that ends by (k + 1) x ceil(body / n_shards).  Raises
    IOError on bytes after the last record."""
    dev = _build.resolve_device(device)
    co, cs, ustarts, us, total, body = bcf_layout(path)
    buf = inflate_range(path, co, cs, ustarts, us, body, total, dev)
    offs: List[int] = []
    sizes: List[int] = []
    p = 0
    n = len(buf)
    while p + 8 <= n:
        l_shared, l_indiv = struct.unpack_from("<II", buf, p)
        offs.append(p)
        sizes.append(8 + l_shared + l_indiv)
        p += 8 + l_shared + l_indiv
    if p != n:
        raise IOError("BCF body: trailing bytes after the last record")
    plan = BcfShardPlan(path, np.asarray(offs, np.int64),
                        np.asarray(sizes, np.int64), co, cs, ustarts, us,
                        body)
    nr = len(offs)
    if nr == 0:
        return plan
    ends = plan.offs + plan.sizes
    per = (int(ends[-1]) + max(n_shards, 1) - 1) // max(n_shards, 1)
    lo = 0
    for si in range(n_shards):
        if lo >= nr:
            break
        hi = int(np.searchsorted(ends, (si + 1) * per, side="right"))
        hi = max(hi, lo + 1)
        if si == n_shards - 1:
            hi = nr
        hi = min(hi, nr)
        plan.shards.append(BcfShard(si, lo, hi, int(plan.offs[lo]),
                                    int(ends[hi - 1])))
        lo = hi
    return plan


def decode_bcf_shard_to_vcf(plan: BcfShardPlan, shard: BcfShard,
                            header=None, device="cuda",
                            timing: Optional[dict] = None) -> bytes:
    """One rank's work: inflate only the members that cover this shard's
    body range on `device` (X4 on the card), frame its records and format
    them as VCF text on the host.  Concatenating the results in shard
    order gives the single-process `bcf_file_to_vcf` body.  `timing`,
    where given, gets read_s (the header, where none is given, and the
    members' bytes), inflate_s, frame_s and format_s."""
    dev = _build.resolve_device(device)
    timing = {} if timing is None else timing
    timing.update(read_s=0.0, inflate_s=0.0)
    if header is None:
        t0 = time.perf_counter()
        with BcfReader(plan.path) as r:
            header = r.header
        timing["read_s"] = time.perf_counter() - t0
    buf = inflate_range(plan.path, plan.coffsets, plan.csizes, plan.ustarts,
                        plan.usizes, plan.body + shard.ustart,
                        plan.body + shard.uend, dev, timing)
    t0 = time.perf_counter()
    shared, indiv = split_frames(buf)
    t1 = time.perf_counter()
    text = format_frames(shared, indiv, header)
    timing["frame_s"] = t1 - t0
    timing["format_s"] = time.perf_counter() - t1
    return text
