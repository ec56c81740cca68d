"""Batch pileup accumulation on the card.

Port of htslib_tpu/ops/pileup_kernel.py: the reference's per-column state
machine (resolve_cigar2, sam.c:5409) as CIGAR expansion -> event tensors
-> sums over a genome tile.  Each read adds +1 at its start and -1 after
its end on a coverage difference array, and depth is its prefix sum; base
counts are scatter adds of one per aligned base.  Neither step has a
Pallas kernel in the JAX package, so both are plain PyTorch here.
"""
from __future__ import annotations

import numpy as np
import torch

from htslib_tpu_torch import _build


def coverage_tile(starts: torch.Tensor, ends: torch.Tensor,
                  valid: torch.Tensor, tile_start: int,
                  tile_len: int) -> torch.Tensor:
    """Depth per position (int32 [tile_len]) for the genome tile
    [tile_start, tile_start + tile_len).  starts/ends: int32 [N] read
    spans (end exclusive); valid masks padding lanes."""
    s = (starts.long() - tile_start).clamp(0, tile_len)
    e = (ends.long() - tile_start).clamp(0, tile_len)
    w = valid.to(torch.int32)
    diff = torch.zeros(tile_len + 1, dtype=torch.int32, device=starts.device)
    diff.index_add_(0, s, w)
    diff.index_add_(0, e, -w)
    return torch.cumsum(diff[:-1], 0, dtype=torch.int32)


def basecount_tile(ref_positions: torch.Tensor, base_codes: torch.Tensor,
                   valid: torch.Tensor, tile_start: int,
                   tile_len: int) -> torch.Tensor:
    """Per-position base counts int32 [tile_len, 16] from flattened
    (ref_pos, nt16 code) events; events outside the tile are dropped."""
    idx = ref_positions.long() - tile_start
    ok = valid & (idx >= 0) & (idx < tile_len)
    flat = idx.clamp(0, tile_len - 1) * 16 + base_codes.long()
    out = torch.zeros(tile_len * 16, dtype=torch.int32,
                      device=ref_positions.device)
    out.index_add_(0, flat, ok.to(torch.int32))
    return out.reshape(tile_len, 16)


def expand_cigar_events(cigar: np.ndarray, pos: int):
    """Host helper: packed CIGAR -> (ref_pos, qpos) int64 event arrays for
    the M/=/X bases of one record (the feature stream the accumulation
    consumes); I/S advance the query, D/N the reference, H/P/B neither."""
    ref_pos, qpos = [], []
    r, q = pos, 0
    for c in np.asarray(cigar).tolist():
        op, ln = c & 0xF, c >> 4
        if op in (0, 7, 8):
            ref_pos.append(np.arange(r, r + ln))
            qpos.append(np.arange(q, q + ln))
            r += ln
            q += ln
        elif op in (1, 4):
            q += ln
        elif op in (2, 3):
            r += ln
    if not ref_pos:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    return (np.concatenate(ref_pos).astype(np.int64),
            np.concatenate(qpos).astype(np.int64))


def _batch_cigar_events(cigars, n_ops, poss):
    """Vectorised CIGAR -> (ref_pos, global_qpos) expansion for M/=/X
    bases across a whole record batch (the resolve_cigar2 reformulation,
    sam.c:5409, with no per-record or per-base Python loop).

    cigars: concatenated packed u32 ops [K]; n_ops: per-record op counts
    [N]; poss: per-record 0-based positions [N].  Returns (ref_pos [E],
    qpos_global [E], rec_of_event [E], qlen_offsets [N + 1]) where
    qpos_global indexes into the concatenation of per-record query
    sequences."""
    K = len(cigars)
    N = len(n_ops)
    if K == 0:
        z = np.empty(0, np.int64)
        return z, z, z, np.zeros(N + 1, np.int64)
    ops = (cigars & 0xF).astype(np.int64)
    lens = (cigars >> 4).astype(np.int64)
    rec_of_op = np.repeat(np.arange(N), n_ops)
    op_starts = np.zeros(N + 1, np.int64)
    np.cumsum(n_ops, out=op_starts[1:])

    consumes_ref = np.isin(ops, (0, 2, 3, 7, 8))
    consumes_q = np.isin(ops, (0, 1, 4, 7, 8))
    ref_adv = np.where(consumes_ref, lens, 0)
    q_adv = np.where(consumes_q, lens, 0)
    # segmented exclusive cumsum: global cumsum minus the record's base
    ref_excl = np.cumsum(ref_adv) - ref_adv
    q_excl = np.cumsum(q_adv) - q_adv
    starts = op_starts[:-1]
    ref_base = ref_excl[starts][rec_of_op]
    q_base = q_excl[starts][rec_of_op]
    r0 = poss[rec_of_op] + (ref_excl - ref_base)
    q0 = q_excl - q_base
    qlens = np.zeros(N, np.int64)
    np.add.at(qlens, rec_of_op, q_adv)
    qlen_off = np.zeros(N + 1, np.int64)
    np.cumsum(qlens, out=qlen_off[1:])

    m = np.isin(ops, (0, 7, 8)) & (lens > 0)
    mlens = lens[m]
    E = int(mlens.sum())
    if E == 0:
        z = np.empty(0, np.int64)
        return z, z, z, qlen_off
    within = np.arange(E) - np.repeat(np.cumsum(mlens) - mlens, mlens)
    ref_pos = np.repeat(r0[m], mlens) + within
    qpos = np.repeat(q0[m] + qlen_off[:-1][rec_of_op[m]], mlens) + within
    rec_of_event = np.repeat(rec_of_op[m], mlens)
    return ref_pos, qpos, rec_of_event, qlen_off


def device_pileup_counts(recs, tile_start: int, tile_len: int,
                         min_qual: int = 0, device="cuda"):
    """Pileup of one genome tile: the batch reformulation of bam_plp
    (sam.c:6011 bam_plp64_next + resolve_cigar2, sam.c:5409).  CIGAR
    expansion into (ref_pos, base) events is vectorised numpy on the host;
    the per-position accumulation runs on `device`.

    recs: records of one reference, in any order, read through `flag`,
    `tid`, `pos`, `cigar`, `endpos()`, `seq4`, `qual` and `l_qseq`.
    Returns numpy (depth int32 [tile_len], basecounts int32
    [tile_len, 16]): depth counts every read whose alignment covers the
    position (a bam_plp column's n, deletions and ref skips included);
    basecounts count aligned query bases by nt16 code."""
    dev = _build.resolve_device(device)
    use = [b for b in recs if not (b.flag & 4) and b.tid >= 0]
    if not use:
        return (np.zeros(tile_len, np.int32),
                np.zeros((tile_len, 16), np.int32))
    poss = np.fromiter((b.pos for b in use), np.int64, len(use))
    n_ops = np.fromiter((len(b.cigar) for b in use), np.int64, len(use))
    cigars = (np.concatenate([np.asarray(b.cigar, np.uint32) for b in use])
              if n_ops.sum() else np.empty(0, np.uint32))
    ends = np.fromiter((b.endpos() for b in use), np.int64, len(use))
    ends = np.maximum(ends, poss + 1)

    ref_pos, qpos, rec_of_event, qlen_off = _batch_cigar_events(
        cigars, n_ops, poss)

    seq4_all = np.concatenate([np.frombuffer(b.seq4, np.uint8) for b in use])
    seq_off = np.zeros(len(use) + 1, np.int64)
    np.cumsum([len(b.seq4) for b in use], out=seq_off[1:])
    if len(ref_pos):
        # local qpos within the record, then nibble address in seq4_all
        local_q = qpos - qlen_off[rec_of_event]
        gaddr = seq_off[rec_of_event] * 2 + local_q
        nib = (seq4_all[gaddr >> 1] >> ((1 - (gaddr & 1)) * 4)) & 0xF
        if min_qual:
            qual_all = np.concatenate(
                [np.frombuffer(b.qual, np.uint8) if b.qual
                 else np.zeros(b.l_qseq, np.uint8) for b in use])
            qual_off = np.zeros(len(use) + 1, np.int64)
            np.cumsum([b.l_qseq for b in use], out=qual_off[1:])
            keep = qual_all[qual_off[rec_of_event] + local_q] >= min_qual
            ref_pos = ref_pos[keep]
            nib = nib[keep]
    else:
        nib = np.empty(0, np.uint8)

    def t(a, dtype=torch.int32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    depth = coverage_tile(t(poss), t(ends),
                          torch.ones(len(use), dtype=torch.bool, device=dev),
                          tile_start, tile_len)
    counts = basecount_tile(t(ref_pos), t(nib),
                            torch.ones(len(ref_pos), dtype=torch.bool,
                                       device=dev),
                            tile_start, tile_len)
    return depth.cpu().numpy(), counts.cpu().numpy()
