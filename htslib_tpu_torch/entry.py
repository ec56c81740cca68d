"""The BAM record-batch step, the port's counterpart of the JAX package's
entry point (`entry()` in __graft_entry__.py): core-field unpack ->
nibble sequence expansion (kernel B1) -> pileup coverage tile.

    forward, args = entry()          # on the card
    total = forward(*args)           # int32 scalar tensor
"""
from __future__ import annotations

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
