"""State carried between the JAX package and the port.

The system has no weights; what crosses between the two packages is the
rANS Nx16 group state.  The JAX front end (htslib_tpu/ops/device_stats.py
`_prepare_group`) lays up to 32 streams out for its Pallas kernels as
packed [W, 32] payload columns (two little-endian 16-bit words per int32
row), state-major [8, 1024] states (state j of stream b at lane
j * 32 + b) and telescoped [A, 1024] tables.  `from_jax_group` turns those
arrays into the port's per-stream `Nx16Batch`, and `from_jax_segment`
turns the state a JAX segment call returns into the port's per-stream
states and word cursors, so both can be held equal.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from htslib_tpu_torch.ops.rans_nx16 import NWAY, TOTFREQ, Nx16Batch

BLOCKS = 32  # streams per JAX group


def _lanes_to_streams(x8: np.ndarray) -> np.ndarray:
    """State-major lanes [8, 32 * BLOCKS] -> uint32 states [BLOCKS, 32]."""
    row = np.asarray(x8)[0].astype(np.int64) & 0xFFFFFFFF
    return row.reshape(NWAY, BLOCKS).T.astype(np.uint32)


def _freqs_from_tables(lo: np.ndarray, dfc: np.ndarray) -> np.ndarray:
    """Telescoped tables [A, lanes] -> frequencies [BLOCKS, 256].  Stream
    b's table sits in lane b; the running sum of its deltas (mod 2^32) is
    (f-1) | cum<<12 | sym<<24 at each present symbol's row, and padding
    rows carry the boundary TOTFREQ."""
    lo = np.asarray(lo)
    packed = np.cumsum(np.asarray(dfc).astype(np.int64), axis=0) & 0xFFFFFFFF
    freqs = np.zeros((BLOCKS, 256), np.int32)
    for b in range(BLOCKS):
        rows = lo[:, b] < TOTFREQ
        fc = packed[rows, b]
        freqs[b, fc >> 24] = (fc & 0xFFF) + 1
    return freqs


def from_jax_group(data_w, lo, dfc, x, out_szs: List[int],
                   device="cpu") -> Nx16Batch:
    """The arrays of `device_stats._prepare_group` -> an `Nx16Batch` of
    its 32 streams (streams the group pads have ulen 0).  Each stream's
    payload is its whole zero-padded column."""
    cols = np.ascontiguousarray(np.asarray(data_w, np.int32).T)  # [B, W]
    words_per = 2 * cols.shape[1]
    ulen = np.asarray(out_szs, np.int64)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return Nx16Batch(
        payload=dev(cols.view(np.uint8).reshape(-1)),
        word_off=dev(np.arange(BLOCKS, dtype=np.int64) * words_per),
        n_words=dev(np.full(BLOCKS, words_per, np.int32)),
        freqs=dev(_freqs_from_tables(lo, dfc)),
        x0=dev(_lanes_to_streams(x).view(np.int32)),
        ulen=dev(ulen.astype(np.int32)),
        out_off=dev(np.concatenate([[0], np.cumsum(ulen)[:-1]])
                    .astype(np.int64)))


def from_jax_segment(x_out, cur_out) -> Tuple[np.ndarray, np.ndarray]:
    """A JAX segment's (x [8, 1024], cursor [1, 32]) -> (uint32 states
    [32, 32], word cursors int64 [32]) in the port's per-stream order."""
    return (_lanes_to_streams(x_out),
            np.asarray(cur_out).reshape(-1).astype(np.int64))
