"""State carried between the JAX package and the port.

The system has no weights; what crosses between the two packages is the
rANS group state and the tables of the device benchmarks.  The JAX front ends lay a group of streams out for
their Pallas kernels as packed [W, B] payload columns (each int32 row two
little-endian 16-bit words, or four stream bytes for the 4x8 wire),
state-major [8, nway * B] states (state j of stream b at lane j * B + b)
and tables tiled over the lanes: telescoped [A, L] order-0 tables
(ops/device_stats.py `_prepare_group`, ops/rans4x8_pallas.py
`_prepare_group4`) or the stacked order-1 tables keyed by dense context
index (ops/rans_o1_pallas.py `_prepare_group_o1`).  The `from_jax_group*`
functions turn those arrays into the port's per-stream batches, and the
`from_jax_segment*` functions turn the state a JAX segment call returns
into the port's per-stream states, cursors and (order 1) contexts, so
both can be held equal.  `from_jax_enc_tables` recovers the frequencies
from the encoder's telescoped tables, and `from_jax_resolve_bench` and
`from_jax_huffman_bench` turn the resolve benchmarks' arguments into the
port's; `from_jax_names_table` and `from_jax_probaln` carry the BAM -> SAM
chain's names table and the BAQ HMM's outputs,
`from_jax_bam_shard_plan` a BAM shard plan (its member arrays and
shards), `from_jax_cram_shard_plan` a CRAM shard plan (its container
arrays and shards), `from_jax_bcf_plan` a BCF shard plan (its record
arrays and shards, with the file's members read from the file) and
`from_jax_pileup_tiles` a pileup tile plan, so the two packages' plans
can be compared field by field and one plan decoded by both.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from htslib_tpu_torch.ops.huffman import order_of
from htslib_tpu_torch.ops.rans4x8 import NWAY4, Rans4x8Batch
from htslib_tpu_torch.ops.rans_nx16 import (NWAY, TOTFREQ, Nx16Batch,
                                            exclusive_cumsum)
from htslib_tpu_torch.ops.rans_nx16_o1 import Nx16O1Batch, frame_o1_tables
from htslib_tpu_torch.parallel.distributed import (BamShard, BamShardPlan,
                                                   BcfShard, BcfShardPlan,
                                                   CramShard, CramShardPlan,
                                                   bcf_layout)
from htslib_tpu_torch.parallel.pileup_shard import PileupTile

BLOCKS = 32  # streams per JAX order-0 Nx16 group


def _dev(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _lanes_to_streams(x8: np.ndarray, blocks: int = BLOCKS,
                      nway: int = NWAY) -> np.ndarray:
    """State-major lanes [8, nway * blocks] -> uint32 [blocks, nway]."""
    row = np.asarray(x8)[0].astype(np.int64) & 0xFFFFFFFF
    return row.reshape(nway, blocks).T.astype(np.uint32)


def _freqs_from_tables(lo: np.ndarray, dfc: np.ndarray,
                       blocks: int = BLOCKS) -> np.ndarray:
    """Telescoped tables [A, lanes] -> frequencies [blocks, 256].
    Stream b's table sits in lane b; the running sum of its deltas (mod
    2^32) is (f-1) | cum<<12 | sym<<24 at each present symbol's row, and
    padding rows carry the boundary TOTFREQ."""
    lo = np.asarray(lo)
    packed = np.cumsum(np.asarray(dfc).astype(np.int64), axis=0) & 0xFFFFFFFF
    freqs = np.zeros((blocks, 256), np.int32)
    for b in range(blocks):
        rows = lo[:, b] < TOTFREQ
        fc = packed[rows, b]
        freqs[b, fc >> 24] = (fc & 0xFFF) + 1
    return freqs


def _alphabets(ad: np.ndarray, blocks: int) -> np.ndarray:
    """Telescoped union alphabets [a_pad, lanes] -> symbol value of each
    dense index, int64 [blocks, a_pad] (sum_{i <= idx} ad[i])."""
    return np.cumsum(np.asarray(ad)[:, :blocks].astype(np.int64), axis=0).T


def _o1_freqs(lo2: np.ndarray, d2: np.ndarray, ad: np.ndarray,
              blocks: int) -> List[np.ndarray]:
    """Stacked order-1 tables (rans_o1_pallas.build_o1_tables, tiled over
    the lanes) -> per-context frequencies [256, 256] of each stream.  Row
    r of stream b is present while lo2 < 2^30; the running sum of d2 is
    (f-1) | cum<<12 | dense_sym<<24 there, and lo2 = dense_ctx*4096 +
    cum."""
    lo2 = np.asarray(lo2)
    packed = np.cumsum(np.asarray(d2).astype(np.int64), axis=0) & 0xFFFFFFFF
    alpha = _alphabets(ad, blocks)
    out = []
    for b in range(blocks):
        rows = lo2[:, b] < (1 << 30)
        fc = packed[rows, b]
        F = np.zeros((256, 256), np.int64)
        F[alpha[b, lo2[rows, b] // TOTFREQ], alpha[b, fc >> 24]] = \
            (fc & 0xFFF) + 1
        out.append(F)
    return out


def _payload_columns(data_w, unit: int):
    """Packed [W, B] int32 columns -> (u8 payload of the columns back to
    back, first `unit` of each column, units per column)."""
    cols = np.ascontiguousarray(np.asarray(data_w, np.int32).T)  # [B, W]
    per = 4 * cols.shape[1] // unit
    B = cols.shape[0]
    return (cols.view(np.uint8).reshape(-1),
            np.arange(B, dtype=np.int64) * per, np.full(B, per, np.int32))


def from_jax_group(data_w, lo, dfc, x, out_szs: List[int],
                   device="cpu") -> Nx16Batch:
    """The arrays of `device_stats._prepare_group` -> an `Nx16Batch` of
    its 32 streams (streams the group pads have ulen 0).  Each stream's
    payload is its whole zero-padded column."""
    payload, word_off, n_words = _payload_columns(data_w, 2)
    ulen = np.asarray(out_szs, np.int64)
    return Nx16Batch(
        payload=_dev(payload, device), word_off=_dev(word_off, device),
        n_words=_dev(n_words, device),
        freqs=_dev(_freqs_from_tables(lo, dfc), device),
        x0=_dev(_lanes_to_streams(x).view(np.int32), device),
        ulen=_dev(ulen.astype(np.int32), device),
        out_off=_dev(exclusive_cumsum(ulen), device))


def from_jax_group_o1(data_w, lo2, d2, ad, x, out_szs: List[int],
                      device="cpu") -> Nx16O1Batch:
    """The arrays of `rans_o1_pallas._prepare_group_o1` -> an
    `Nx16O1Batch` of its B1 streams (B1 = data_w's width)."""
    blocks = np.asarray(data_w).shape[1]
    payload, word_off, n_words = _payload_columns(data_w, 2)
    ulen = np.asarray(out_szs, np.int64)
    return Nx16O1Batch(
        payload=_dev(payload, device), word_off=_dev(word_off, device),
        n_words=_dev(n_words, device),
        tables=frame_o1_tables(_o1_freqs(lo2, d2, ad, blocks), device),
        x0=_dev(_lanes_to_streams(x, blocks).view(np.int32), device),
        ulen=_dev(ulen.astype(np.int32), device),
        out_off=_dev(exclusive_cumsum(ulen), device))


def from_jax_group4(data_w, lo, dfc, x, out_szs: List[int], device="cpu",
                    ad=None) -> Rans4x8Batch:
    """The arrays of `rans4x8_pallas._prepare_group4` (order 0: `lo`,
    `dfc` telescoped as pack_tables) or of the order-1 front end of
    `device_stats.qualstats_device_4x8` (`lo`, `dfc` stacked as
    build_o1_tables_4x8, with its alphabet table `ad`) -> a
    `Rans4x8Batch` of the group's 64 streams."""
    blocks = np.asarray(data_w).shape[1]
    payload, word_off, n_bytes = _payload_columns(data_w, 4)
    ulen = np.asarray(out_szs, np.int64)
    o1 = ad is not None
    return Rans4x8Batch(
        payload=_dev(payload, device), byte_off=_dev(4 * word_off, device),
        n_bytes=_dev(4 * n_bytes, device),
        freqs=_dev(np.zeros((blocks, 256), np.int32) if o1
                   else _freqs_from_tables(lo, dfc, blocks), device),
        tables=(frame_o1_tables(_o1_freqs(lo, dfc, ad, blocks), device)
                if o1 else None),
        x0=_dev(_lanes_to_streams(x, blocks, NWAY4).view(np.int32), device),
        ulen=_dev(ulen.astype(np.int32), device),
        out_off=_dev(exclusive_cumsum(ulen), device))


def from_jax_segment(x_out, cur_out, ctx_out=None, ad=None,
                     nway: int = NWAY) -> Tuple[np.ndarray, ...]:
    """A JAX segment's (x [8, nway * B], cursor [1, B]) -> (uint32 states
    [B, nway], cursors int64 [B]) in the port's per-stream order; with
    the order-1 kernels' dense contexts `ctx_out` [8, nway * B] and their
    alphabet table `ad`, also the contexts as symbol values, int64
    [B, nway]."""
    cur = np.asarray(cur_out).reshape(-1).astype(np.int64)
    blocks = len(cur)
    x = _lanes_to_streams(x_out, blocks, nway)
    if ctx_out is None:
        return x, cur
    dense = np.asarray(ctx_out)[0].astype(np.int64).reshape(nway, blocks).T
    alpha = _alphabets(ad, blocks)
    return x, cur, np.take_along_axis(alpha, dense, axis=1)


def from_jax_enc_tables(lo, d1, d2) -> np.ndarray:
    """`rans_enc_pallas._enc_tables`' symbol-keyed telescoped tables
    [A, B] -> the frequencies int64 [B, 256].  Stream b's present symbols
    are lo's rows below 256; the running sum of d2 (mod 2^32) is
    shift | (4096 - f) << 4 | bias << 17 there.  d1 (the reciprocals)
    follows from f and is not read."""
    lo = np.asarray(lo)
    pk2 = np.cumsum(np.asarray(d2).astype(np.int64), axis=0) & 0xFFFFFFFF
    freqs = np.zeros((lo.shape[1], 256), np.int64)
    for b in range(lo.shape[1]):
        rows = lo[:, b] < 256
        freqs[b, lo[rows, b]] = TOTFREQ - ((pk2[rows, b] >> 4) & 0x1FFF)
    return freqs


def from_jax_resolve_bench(lo_T, dfc_T, x0, device="cpu"):
    """The JAX resolve bench's args (`pack_tables` output [256, G] and
    the states [8, G]) -> the port's (freqs int32 [G, 256], x0 int32
    [G])."""
    G = np.asarray(lo_T).shape[1]
    x = np.asarray(x0)[0].astype(np.int64) & 0xFFFFFFFF
    return (_dev(_freqs_from_tables(lo_T, dfc_T, G), device),
            _dev(x.astype(np.uint32).view(np.int32), device))


def from_jax_names_table(tbl, device="cpu") -> torch.Tensor:
    """The names table of the JAX `device_format_records` (uint8
    [n_ref + 1, name_w], names NUL-padded, row n_ref "*") -> the port's
    tensor."""
    return _dev(np.array(tbl, np.uint8), device)


def from_jax_probaln(pr, states, qs, device="cpu"):
    """The JAX `probaln_batch` outputs (Pr [B], states [B, Q], q [B, Q])
    -> the port's (int32, int32, uint8) tensors."""
    return (_dev(np.array(pr, np.int32), device),
            _dev(np.array(states, np.int32), device),
            _dev(np.array(qs, np.uint8), device))


def from_jax_huffman_bench(limits, firsts, bases, dord, v0, device="cpu"):
    """The JAX Huffman bench's args -> the port's (limits, firsts,
    bases int32 [16, L], order int32 [320, L] (the prefix sum of dord),
    v0 int32 [L])."""
    return tuple(_dev(np.array(a, np.int32), device) for a in (
        limits, firsts, bases, order_of(dord), np.asarray(v0)[0]))


def from_jax_bam_shard_plan(plan):
    """A JAX `BamShardPlan` (htslib_tpu/parallel/distributed.py) as the
    port's (parallel/distributed.py): the member arrays in the port's
    dtypes (uint64 offsets and starts, uint32 sizes) and each shard's
    fields as Python ints."""
    return BamShardPlan(
        plan.path, np.asarray(plan.coffsets, np.uint64),
        np.asarray(plan.csizes, np.uint32),
        np.asarray(plan.ustarts, np.uint64),
        np.asarray(plan.usizes, np.uint32),
        [BamShard(int(s.index), int(s.ustart), int(s.uend),
                  int(s.n_records)) for s in plan.shards])


def from_jax_cram_shard_plan(plan):
    """A JAX `CramShardPlan` (htslib_tpu/parallel/distributed.py) as the
    port's: its path and reference, the container arrays as int64 and
    each shard's fields as Python ints."""
    return CramShardPlan(
        plan.path, plan.ref, np.asarray(plan.offsets, np.int64),
        np.asarray(plan.ends, np.int64), np.asarray(plan.nrecs, np.int64),
        [CramShard(int(s.index), int(s.offset), int(s.end),
                   int(s.n_records)) for s in plan.shards])


def from_jax_bcf_plan(plan):
    """A JAX `BcfShardPlan` (htslib_tpu/parallel/distributed.py) as the
    port's: its record offsets and sizes as int64, each shard's fields as
    Python ints, and the member table and body start that the port's plan
    also holds, read from the file at plan.path (`bcf_layout`)."""
    co, cs, ustarts, us, _total, body = bcf_layout(plan.path)
    return BcfShardPlan(
        plan.path, np.asarray(plan.offs, np.int64),
        np.asarray(plan.sizes, np.int64), co, cs, ustarts, us, body,
        [BcfShard(int(s.index), int(s.rec_lo), int(s.rec_hi),
                  int(s.ustart), int(s.uend)) for s in plan.shards])


def from_jax_pileup_tiles(tiles):
    """JAX `PileupTile`s (htslib_tpu/parallel/pileup_shard.py) as the
    port's: the index and the (tid, pos) keys as Python ints.  The tile
    plan is the only state a pileup carries across packages."""
    return [PileupTile(int(t.index), (int(t.lo[0]), int(t.lo[1])),
                       (int(t.hi[0]), int(t.hi[1]))) for t in tiles]
