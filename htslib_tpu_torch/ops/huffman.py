"""Canonical-Huffman symbol resolution on the card (kernel B10).

Port of htslib_tpu/ops/huffman_pallas.py: `build_tables`, `resolve_ref`
and `make_huffman_resolve_bench` (its `make_huffman_resolve_bench.kernel`,
csrc/huffman_resolve.cu).  Canonical decode over a 15-bit window v (the
MSB-justified code prefix):

    l*  = 1 + #{r : v >= limits[r]}
    idx = bases[l*-1] + (v >> (15 - l*)) - firsts[l*-1]
    sym = order[idx]

The Pallas kernel resolves without gathers (one-hot selects and a
telescoping sum over the order table's deltas `dord`, because the TPU
has no fast gather); the port keeps the tables' values and looks them up:
its tables hold `order` itself, the prefix sum of `dord`, and the kernel
reads every table from shared memory.  `huffman_resolve` launches the
kernel for tensors on the card and takes the plain PyTorch version for
tensors on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from htslib_tpu_torch import _build

MAXBITS = 15
NSYM_PAD = 320     # >= 288 litlen symbols, multiple of 8
ROWS = 16          # table rows per code length (limits[15] = 2^15)
_U32 = 0xFFFFFFFF


def build_tables(code_lens: np.ndarray):
    """code_lens [L_streams, nsym] -> per-stream canonical tables, the
    JAX package's arrays: limits [16, L] int32 (monotone, limits[15] =
    2^15), firsts and bases [16, L] (first code and first symbol index of
    length r + 1 in row r) and the order permutation's delta table dord
    [NSYM_PAD, L] (its prefix sum mod 2^32 is the order, zero past the
    alphabet)."""
    Ls, nsym = code_lens.shape
    limits = np.full((ROWS, Ls), 1 << MAXBITS, np.int64)
    firsts = np.zeros((ROWS, Ls), np.int64)
    bases = np.zeros((ROWS, Ls), np.int64)
    dord = np.zeros((NSYM_PAD, Ls), np.int64)
    for s in range(Ls):
        lens = code_lens[s]
        cnt = np.bincount(lens, minlength=MAXBITS + 1)
        cnt[0] = 0
        first = np.zeros(MAXBITS + 1, np.int64)
        code = 0
        for ln in range(1, MAXBITS + 1):
            code = (code + cnt[ln - 1]) << 1
            first[ln] = code
        sym_base = np.cumsum(cnt) - cnt
        order = np.argsort(np.where(lens > 0, lens * 1024 + np.arange(nsym),
                                    1 << 30), kind="stable")
        for ln in range(1, MAXBITS + 1):
            limits[ln - 1, s] = min((first[ln] + cnt[ln]) << (MAXBITS - ln),
                                    1 << MAXBITS)
            firsts[ln - 1, s] = first[ln]
            bases[ln - 1, s] = sym_base[ln]
        ordv = np.zeros(NSYM_PAD, np.int64)
        ordv[:nsym] = order
        dord[:, s] = np.diff(ordv, prepend=0)
    dord = (dord + (1 << 31)) % (1 << 32) - (1 << 31)
    return (limits.astype(np.int32), firsts.astype(np.int32),
            bases.astype(np.int32), dord.astype(np.int32))


def order_of(dord: np.ndarray) -> np.ndarray:
    """The order table [NSYM_PAD, L] int32 from its delta table."""
    return (np.cumsum(np.asarray(dord, np.int64), axis=0) & _U32).astype(
        np.uint32).view(np.int32)


def resolve_ref(v: np.ndarray, limits, firsts, bases, dord) -> np.ndarray:
    """Numpy model of the kernel's resolve, one window per stream: v
    [L] in [0, 2^15) -> symbols int64 [L].  An idx outside the order
    table gives 0 and l* = 16 (a window past an incomplete code's last
    code) gives code 0, as the kernel's telescoping sum and shift do."""
    v = np.asarray(v, np.int64)
    cols = np.arange(v.shape[0])
    order = np.cumsum(np.asarray(dord, np.int64), axis=0) & _U32
    lstar = 1 + (v[None, :] >= np.asarray(limits, np.int64)).sum(0)
    code = np.where(lstar <= MAXBITS,
                    v >> np.clip(MAXBITS - lstar, 0, None), 0)
    idx = (np.asarray(bases, np.int64)[lstar - 1, cols] + code
           - np.asarray(firsts, np.int64)[lstar - 1, cols])
    inside = (idx >= 0) & (idx < order.shape[0])
    return np.where(inside, order[np.where(inside, idx, 0), cols], 0)


def next_window(v, sym):
    """The chain's next window: the symbol mixed back into the window
    (numpy or torch, int64)."""
    return ((v * 5 + sym * 40503) >> 7) & ((1 << MAXBITS) - 1)


def huffman_resolve_plain(limits: torch.Tensor, firsts: torch.Tensor,
                          bases: torch.Tensor, order: torch.Tensor,
                          v0: torch.Tensor, rounds: int) -> torch.Tensor:
    """Plain PyTorch version of kernel B10: `rounds` resolves of L
    chains, each window the last one mixed with its symbol.  Tables int32
    [16, L] and order int32 [NSYM_PAD, L], v0 int32 [L]; returns the
    windows int32 [L]."""
    lim = limits.long()
    first = firsts.long()
    base = bases.long()
    order = order.long()
    v = v0.long()[None, :]
    for _ in range(rounds):
        lstar = 1 + (v >= lim).sum(0, keepdim=True)
        code = torch.where(lstar <= MAXBITS,
                           v >> (MAXBITS - lstar).clamp(min=0), 0)
        idx = (torch.gather(base, 0, lstar - 1) + code
               - torch.gather(first, 0, lstar - 1))
        inside = (idx >= 0) & (idx < NSYM_PAD)
        sym = torch.where(inside, torch.gather(
            order, 0, torch.where(inside, idx, 0)), 0)
        v = next_window(v, sym & _U32) & _U32
    return v[0].to(torch.int32)


def huffman_resolve_cuda(limits: torch.Tensor, firsts: torch.Tensor,
                         bases: torch.Tensor, order: torch.Tensor,
                         v0: torch.Tensor, rounds: int) -> torch.Tensor:
    """Kernel B10, one launch for every chain; same result as
    `huffman_resolve_plain`."""
    L = int(v0.shape[0])
    req = _build.require_cuda
    req(limits, torch.int32, "limits", (ROWS, L))
    req(firsts, torch.int32, "firsts", (ROWS, L))
    req(bases, torch.int32, "bases", (ROWS, L))
    req(order, torch.int32, "order", (NSYM_PAD, L))
    req(v0, torch.int32, "v0", (L,))
    v_out = torch.empty(L, dtype=torch.int32, device=v0.device)
    lib = _build.load("huffman_resolve")
    rc = lib.huffman_resolve_launch(
        limits.data_ptr(), firsts.data_ptr(), bases.data_ptr(),
        order.data_ptr(), v0.data_ptr(), v_out.data_ptr(), L, rounds,
        _build.stream_handle(v0))
    _build.check(lib, rc, "huffman_resolve_bench")
    _build.LAUNCHES["huffman_resolve_bench"] += 1
    return v_out


def huffman_resolve(limits, firsts, bases, order, v0,
                    rounds: int) -> torch.Tensor:
    """The resolve chain: the kernel for tensors on the card, the plain
    version for tensors on the CPU."""
    if v0.is_cuda:
        return huffman_resolve_cuda(limits, firsts, bases, order, v0, rounds)
    if v0.device.type != "cpu":
        raise ValueError(f"unsupported device {v0.device}")
    return huffman_resolve_plain(limits, firsts, bases, order, v0, rounds)


def make_huffman_resolve_bench(L: int = 128, rounds: int = 4096,
                               unroll: int = 4, seed: int = 3,
                               device="cuda"):
    """(fn, args, ref_step, v0), as the JAX package's function returns
    them: fn(*args) runs rounds // unroll * unroll dependent resolves
    (the JAX loop's count) over L streams with seeded per-stream tables
    and gives int32 [8, L], every row the windows; args are the port's
    tables (limits, firsts, bases [16, L], order [NSYM_PAD, L]) and the
    start windows int32 [L] on `device`; ref_step(v [L]) is one numpy
    round, (next windows int32, symbols); v0 is the start windows as the
    JAX function gives them, int32 [8, L]."""
    dev = _build.resolve_device(device)
    rng = np.random.RandomState(seed)
    # random complete-ish code length sets (fixed-Huffman-like mix)
    lens = np.zeros((L, 288), np.int64)
    lens[:, :144] = 8
    lens[:, 144:256] = 9
    lens[:, 256:280] = 7
    lens[:, 280:288] = 8
    for s in range(L):
        lens[s] = lens[s][rng.permutation(288)]
    limits, firsts, bases, dord = build_tables(lens)
    v0 = rng.randint(0, 1 << MAXBITS, (1, L)).astype(np.int32)
    v0 = np.broadcast_to(v0, (8, L)).copy()
    steps = rounds // unroll * unroll

    def fn(*tables):
        return huffman_resolve(*tables, steps)[None, :].expand(8, -1)

    def ref_step(v):
        sym = resolve_ref(v.astype(np.int64), limits, firsts, bases, dord)
        return next_window(v.astype(np.int64), sym).astype(np.int32), sym

    args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (limits, firsts, bases, order_of(dord), v0[0]))
    return fn, args, ref_step, v0
