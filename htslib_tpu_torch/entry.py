"""The entry points of the port, its counterparts of the JAX package's
(__graft_entry__.py):

entry():             the BAM record-batch step: core-field unpack ->
                     nibble sequence expansion (kernel B1) -> pileup
                     coverage tile.
dryrun_multichip(n): an n-rank dryrun on torch.distributed: BAM and
                     CRAM shard plans, per-rank decode and flagstat, the
                     mesh's decode-pileup, flagstat and halo-ring steps,
                     each against its single-process truth.

    forward, args = entry()          # on the card
    total = forward(*args)           # int32 scalar tensor
"""
from __future__ import annotations

import os

import numpy as np
import torch

from htslib_tpu_torch._build import resolve_device
from htslib_tpu_torch.ops.pileup_kernel import coverage_tile
from htslib_tpu_torch.ops.seqfmt import nibble_to_base, unpack_core_fields


def _example_batch(n=256, max_len=128, seed=0):
    """A seeded record batch: cores uint8 [n, 32], seq4 uint8
    [n, max_len // 2], sorted int32 starts over 8 kbp, spans of 50-150 bp
    and an all-true valid mask (the same arrays as the JAX entry's)."""
    rng = np.random.default_rng(seed)
    cores = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    seq4 = rng.integers(0, 256, (n, max_len // 2), dtype=np.uint8)
    starts = np.sort(rng.integers(0, 8000, n)).astype(np.int32)
    ends = (starts + rng.integers(50, 150, n)).astype(np.int32)
    valid = np.ones(n, bool)
    return cores, seq4, starts, ends, valid


def _wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """An int64 sum taken modulo 2^32 as int32, as the JAX step's int32
    sums wrap."""
    return (((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def entry(device="cuda", n=256, max_len=128, tile_len=1 << 14, batch=None):
    """Returns (forward, args): the record-batch step and its inputs as
    tensors on `device`.  `batch` replaces the seeded example batch of `n`
    records (the arrays `_example_batch` returns).  forward returns the
    int32 sum of the flags, the ASCII base bytes and the coverage depths
    of the tile [0, tile_len)."""
    dev = resolve_device(device)

    def forward(cores, seq4, starts, ends, valid):
        fields = unpack_core_fields(cores)
        bases = nibble_to_base(seq4)
        cov = coverage_tile(starts, ends, valid, 0, tile_len)
        return _wrap_i32(fields["flag"].sum() + bases.sum(dtype=torch.int64)
                         + cov.sum(dtype=torch.int64))

    arrays = batch if batch is not None else _example_batch(n, max_len)
    args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in arrays)
    return forward, args


DRYRUN_REFS = [("chrA", 20_000), ("chrB", 15_000)]


def dryrun_records(n: int = 1000, seed: int = 11):
    """The dryrun's BAM content, made from a seed: a header of two
    references and n records sorted by reference and position, paired
    (mates on the same reference, the other or none; negative TLENs), 1-8
    CIGAR ops of M/I/D/N/S/=/X, 3% unmapped, qualities, a few without
    quality, and NM/RG aux tags.  Returns (header, records)."""
    from htslib_tpu_torch.sam.header import SamHeader
    from htslib_tpu_torch.sam.record import BamRecord, encode_aux
    rng = np.random.default_rng(seed)
    hdr = SamHeader("@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{name}\tLN:{ln}\n" for name, ln in DRYRUN_REFS))
    recs = []
    for i in range(n):
        b = BamRecord()
        b.qname = b"dry%04d" % (i // 2)
        unmapped = rng.random() < 0.03
        ops = []
        if not unmapped:
            k = int(rng.integers(1, 9))
            codes = rng.choice([0, 0, 0, 1, 2, 3, 4, 7, 8], k)
            codes[0] = rng.choice([0, 4, 7])
            codes[-1] = rng.choice([0, 4, 8])
            ops = [(int(rng.integers(1, 40)) << 4) | int(c) for c in codes]
        b.cigar = np.array(ops, np.uint32)
        qlen = sum(c >> 4 for c in ops if (c & 15) in (0, 1, 4, 7, 8))
        b.set_seq("".join(rng.choice(list("ACGTN"), qlen or int(
            rng.integers(30, 90)))))
        if rng.random() > 0.02:
            b.qual = rng.integers(2, 42, b.l_qseq, dtype=np.uint8).tobytes()
        paired = rng.random() < 0.8
        b.flag = ((4 if unmapped else 0) | (1 if paired else 0)
                  | int(rng.choice([0, 16, 256, 1024, 2048])))
        if paired:
            b.flag |= int(rng.choice([0x40, 0x80])) | int(rng.choice([0, 2]))
        b.tid = -1 if unmapped else int(rng.random() < 0.3)
        b.pos = -1 if unmapped else int(rng.integers(
            0, DRYRUN_REFS[b.tid][1] // 3))
        b.mapq = 0 if unmapped else int(rng.integers(0, 61))
        if paired:
            b.mtid = int(rng.choice([b.tid, 0, 1, -1]))
            if b.mtid < 0:
                b.flag |= 8
            b.mpos = -1 if b.mtid < 0 else int(rng.integers(0, 5000))
            b.isize = int(rng.integers(-600, 600))
        b.aux = b""
        if not unmapped:
            b.aux += encode_aux(b"NM", "i", int(rng.integers(0, 9)))
        b.aux += encode_aux(b"RG", "Z", "grp%d" % rng.integers(0, 3))
        recs.append(b)
    recs.sort(key=lambda r: (r.tid < 0, r.tid, r.pos))
    return hdr, recs


def _same_concat(mesh, part: bytes, whole: bytes) -> bool:
    """Whether the ranks' parts, concatenated in rank order, are `whole`:
    each rank compares its part with its span of `whole` byte for byte,
    the spans' offsets and the verdicts summed over the mesh."""
    lens = torch.zeros(mesh.size, dtype=torch.int64, device=mesh.device)
    lens[mesh.rank] = len(part)
    lens = mesh.all_reduce_sum(lens).cpu().numpy()
    at = int(lens[:mesh.rank].sum())
    bad = int(lens.sum()) != len(whole) or whole[at:at + len(part)] != part
    bad_ranks = torch.tensor([int(bad)], dtype=torch.int64,
                             device=mesh.device)
    return int(mesh.all_reduce_sum(bad_ranks)[0]) == 0


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """An n-rank dryrun over a BAM file made in-process (`dryrun_records`,
    written by the port's BamWriter to a temporary directory), the port
    of the JAX package's `dryrun_multichip` (__graft_entry__.py).  The
    file's members are stored DEFLATE blocks (level 0, as `bgzip -l 0`
    writes), which the CPU's plain inflate, about a millisecond a DEFLATE
    item, decodes in a few steps.  Each rank runs as one rank of an
    initialised world of at least n ranks (parallel/distributed.py
    `initialize`), or alone as a world of one when n is 1.  Its gates,
    each an AssertionError with the JAX message:

      1. the shard plan's decode (rank d formats shard d: X4, X5, B1) is
         the single-process SAM text, byte for byte;
      2. the CRAM gate: the BAM written as a CRAM (100 records a slice, a
         slice a container, no reference) and planned into container
         shards, which must be more than one; each rank's shards decoded
         (rANS blocks on the device, records on the host, X5 and B1) are
         the single-process `cram_file_to_sam` text, byte for byte.  The
         plan has max(n, 2) shards, rank d taking those whose index i has
         i * n // max(n, 2) == d: at n = 1 the JAX function plans one
         shard and fails its own check, here rank 0 decodes both;
      3. `distributed_flagstat` equals the mesh flagstat step;
      4. the mesh decode-pileup step's coverage equals the brute force;
      5. the coordinate-sharded halo ring equals the brute force over the
         file's read spans (each rank's reads in its own slots).

    Every range's blocks go to the device in one call (window 16)."""
    import shutil
    import tempfile

    from htslib_tpu_torch.cram.batch import bam_to_cram_file, cram_file_to_sam
    from htslib_tpu_torch.ops.bam2sam import bam_payload_to_sam_device
    from htslib_tpu_torch.parallel.distributed import (
        decode_cram_shard_to_sam, decode_shard_to_sam, distributed_flagstat,
        plan_bam_shards, plan_cram_shards)
    from htslib_tpu_torch.parallel.mesh import (make_coord_sharded_pileup,
                                                make_decode_pileup_step,
                                                make_flagstat_step,
                                                make_mesh, shard_batch)
    from htslib_tpu_torch.sam.bam import BamReader, BamWriter

    dev = resolve_device(device)
    mesh = make_mesh(n=n_devices, device=dev)
    rank = mesh.rank
    tmp = tempfile.mkdtemp(prefix="htstorch_dryrun_")
    try:
        # 1. a BAM file from seeded records
        hdr, recs = dryrun_records()
        bam = os.path.join(tmp, "dry.bam")
        with BamWriter(bam, hdr, level=0) as w:
            for r in recs:
                w.write(r)

        # 2. shard-per-rank file decode == single-process output
        plan = plan_bam_shards(bam, n_devices)
        part = (decode_shard_to_sam(plan, plan.shards[rank], hdr,
                                    device=dev)
                if rank < len(plan.shards) else b"")
        with BamReader(bam) as r:
            stream = r.raw_records()[0].tobytes()
        single = bam_payload_to_sam_device(stream, hdr, device=dev)
        if not _same_concat(mesh, part, single):
            raise AssertionError("sharded decode != single-host output")

        # 2b. CRAM container shards: sharded CRAM -> SAM == single-process
        cram = os.path.join(tmp, "dry.cram")
        bam_to_cram_file(bam, cram, seqs_per_slice=100,
                         slices_per_container=1)
        n_planned = max(n_devices, 2)
        cplan = plan_cram_shards(cram, n_planned)
        if len(cplan.shards) <= 1:
            raise AssertionError("CRAM plan produced a single shard")
        cpart = b"".join(
            decode_cram_shard_to_sam(cplan, sh, window=16, device=dev)
            for sh in cplan.shards if sh.index * n_devices // n_planned
            == rank)
        _, csingle = cram_file_to_sam(cram, window=16, device=dev)
        if not _same_concat(mesh, cpart, csingle.tobytes()):
            raise AssertionError("sharded CRAM decode != single-host output")

        # 2c. shard-merged flagstat == the mesh all-reduce step
        fs = distributed_flagstat(bam, n_devices, device=dev)
        flags = np.array([r.flag for r in recs], np.int32)
        padn = -(-len(flags) // n_devices) * n_devices
        fl = np.zeros(padn, np.int32)
        fl[:len(flags)] = flags
        va = np.zeros(padn, bool)
        va[:len(flags)] = True
        counts = make_flagstat_step(mesh)(*shard_batch(mesh, fl, va))
        if not (counts.cpu().numpy() == fs).all():
            raise AssertionError("mesh flagstat != shard flagstat")

        # 3. mesh decode+pileup on the file's records (all-reduce merge)
        tile_len = 1 << 12
        mapped = [r for r in recs if not (r.flag & 4) and r.tid == 0]
        per = max(1, len(mapped) // n_devices)
        n = per * n_devices
        mapped = mapped[:n]
        max_half = max(len(r.seq4) for r in mapped)
        cores = np.zeros((n, 32), np.uint8)
        seq4 = np.zeros((n, max_half), np.uint8)
        starts = np.zeros(n, np.int32)
        ends = np.zeros(n, np.int32)
        for i, r in enumerate(mapped):
            cores[i] = np.frombuffer(r.to_bam_buffer()[:32], np.uint8)
            seq4[i, :len(r.seq4)] = np.frombuffer(r.seq4, np.uint8)
            starts[i] = r.pos
            ends[i] = max(r.endpos(), r.pos + 1)
        step = make_decode_pileup_step(mesh, tile_len=tile_len)
        cov, _bases, _flags = step(
            *shard_batch(mesh, cores, seq4, starts, ends, np.ones(n, bool)),
            0)
        brute = np.zeros(tile_len, np.int64)
        for s0, e0 in zip(starts, ends):
            brute[min(s0, tile_len):min(e0, tile_len)] += 1
        if not np.array_equal(cov.cpu().numpy().astype(np.int64), brute):
            raise AssertionError("mesh pileup != brute force")

        # 4. coordinate-sharded pileup with the halo ring over the spans
        tile, halo = 256, 128
        genome = n_devices * tile
        spans = [(int(r.pos), max(int(min(r.endpos(), r.pos + halo - 1)),
                                  int(r.pos) + 1)) for r in mapped]
        per_dev = max(1, len(spans) // n_devices)
        s_arr = np.zeros(per_dev * n_devices, np.int32)
        e_arr = np.zeros(per_dev * n_devices, np.int32)
        v_arr = np.zeros(per_dev * n_devices, bool)
        for d in range(n_devices):
            owned = [(s0 % genome, e0) for s0, e0 in spans
                     if d * tile <= s0 % genome < (d + 1) * tile][:per_dev]
            for j, (s0, e0) in enumerate(owned):
                k = d * per_dev + j
                e0 = min(s0 + (e0 - spans[0][0]) % halo + 1, genome)
                s_arr[k], e_arr[k], v_arr[k] = s0, max(e0, s0 + 1), True
        hstep = make_coord_sharded_pileup(mesh, tile_len=tile, halo=halo)
        own = hstep(*shard_batch(mesh, s_arr, e_arr, v_arr))
        brute2 = np.zeros(genome, np.int32)
        for s0, e0, v0 in zip(s_arr, e_arr, v_arr):
            if v0:
                brute2[s0:e0] += 1
        bad = torch.tensor([int(not np.array_equal(
            own.cpu().numpy(), brute2[rank * tile:(rank + 1) * tile]))],
            device=dev)
        if int(mesh.all_reduce_sum(bad)[0]):
            raise AssertionError("halo-exchange pileup != brute force")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
