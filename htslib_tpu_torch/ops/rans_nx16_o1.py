"""rANS Nx16 order-1 32-way decode on the card (kernels B5 and B6).

Port of htslib_tpu/ops/rans_o1_pallas.py: `decode_nx16_o1_batch` (its
`_make_seg1_kernel`) here, and the histogram variant (its
`_make_seg1_hist_kernel`) through `rans_o1(..., qbins=...)`, which
ops/device_stats.py drives.

Layout.  The Pallas kernels stack every context's table into one
telescoped [a2_pad, L] compare-sum keyed by ctx_idx*4096 + slot, with a
union-alphabet select back to symbol values, 1024 rounds per call, and
finish the <= 31-symbol tail on the host.  The port keeps the wire and
the outputs, not that layout: a batch (`Nx16O1Batch`) holds each
stream's payload words back to back, its present (ctx, sym) rows packed
(f-1) | cum<<12 | sym<<24 and sorted by (ctx, cum) with the first row of
each context (`O1Tables`), and its 32 initial states; one launch decodes
every stream of the batch to its end, tail included
(csrc/rans_nx16_o1.cu, one warp per stream).  The kernels index each
stream's contexts densely over its own alphabet and map its slow buckets
(`o1_table_sizes`), building their tables in shared memory sized per
launch to the batch's largest (`o1_smem_bytes`).

`rans_o1` launches the kernel for tensors on the card and takes the plain
PyTorch version (`rans_o1_plain`, the same rounds as tensor ops over all
streams and states at once, through a dense [ctx, slot] table) for
tensors on the CPU.

Dense tables.  The kernels' records hold at most A2_MAX (context, symbol)
rows a stream, the JAX kernels' budget, and `decode_nx16_o1_batch` and the
histogram lane refuse a stream with more, as their JAX twins do.  For the
whole-stream decode of ops/rans.py, whose JAX function decodes such a
stream through a dense [256 x 4096] table, a batch may carry that table
instead (`Nx16O1Batch.dense`, `frame_o1_streams(..., dense=True)`): the
JAX function's own packed entries (`dense_tables`), 4 MiB a stream, built
on the batch's device from the 256 KiB of frequencies a stream, which
the dense variant of B5 reads in device memory and the plain version
gathers (`dense_step`).

Large tables.  Such a stream may instead keep its rows, up to the wire's
LARGE_MAX_ROWS (`frame_o1_streams(..., large=True)`, `Nx16O1Batch.large`):
B5's large variant builds them in shared memory (csrc/rans_nx16_o1.cu,
the large table of csrc/rans_nx16_o1_step.cuh), answering as the JAX
dense table does, a slot past its context's sum included.  Its blocks
take up to one SM each, so ops/rans.py gives it a past-A2_MAX group of at
most LARGE_WAVES waves (`large_fits`) and the dense variant a larger one.
The large variant's plain version gathers from the dense tables of the
same rows (`rows_dense_tables`, `dense_step`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from htslib_tpu_torch import _build
from htslib_tpu_torch.codecs.rans4x16 import (_read_alphabet,
                                              _read_freq_table, u7_get)
from htslib_tpu_torch.ops.rans_nx16 import (NWAY, RANS16_L, TF_SHIFT,
                                            TOTFREQ, _U32, exclusive_cumsum,
                                            pack_payloads, refill16)

A2_MAX = 4096  # stacked (ctx, sym) rows the device O1 kernels take
LARGE_MAX_ROWS = 256 * 256  # rows the large table takes: every pair
# waves of B5's large-table blocks up to which a past-A2_MAX group takes
# it rather than the dense variant (`large_fits`; set by probe_dense.py)
LARGE_WAVES = 2


@dataclass
class O1Tables:
    """Order-1 tables of S streams, as the kernels read them."""
    rows: torch.Tensor       # int32 (u32 bits): every stream's rows
    row_off: torch.Tensor    # int64 [S]: each stream's first row
    n_rows: torch.Tensor     # int32 [S]: rows of each stream (<= A2_MAX)
    ctx_start: torch.Tensor  # int32 [S, 257]: first row of each context


@dataclass
class Nx16O1Batch:
    """Order-1 streams framed for decode, all tensors on one device."""
    payload: torch.Tensor   # u8: payloads back to back, each padded to even
    word_off: torch.Tensor  # int64 [S]: first 16-bit word of each stream
    n_words: torch.Tensor   # int32 [S]: words in each (padded) payload
    tables: Optional[O1Tables]  # the rows (None with `dense`)
    x0: torch.Tensor        # int32 [S, 32]: initial states (u32 bits)
    ulen: torch.Tensor      # int32 [S]: symbols in each stream
    out_off: torch.Tensor   # int64 [S]: each stream's first output byte
    dense: Optional[torch.Tensor] = None  # int32 [S, 256 * 4096]: the
    #                         dense tables (`dense_tables`) in place of rows
    large: bool = False     # rows past A2_MAX, for the large table
    alphabet: int = 0       # large: the streams' largest dense alphabet
    #                         (`o1_alphabet`, counted at framing)

    @property
    def n_streams(self) -> int:
        return int(self.ulen.shape[0])

    @property
    def total_out(self) -> int:
        return int(self.ulen.sum())


def _parse_nx16_header(data: bytes, nway: int = NWAY, o1: bool = True):
    """Parse a plain Nx16 stream of `nway` (32 or 4) states, order 1 or,
    with `o1` false, order 0: returns (n_out, F [256,256] (order 0: f
    [256]), states [nway], payload ndarray).  Raises ValueError unless
    the flags are exactly that wire's."""
    flags = data[0]
    if flags != (0x04 if nway == NWAY else 0) | int(o1):
        if nway == NWAY and o1:
            raise ValueError("device O1 kernel: plain 32-way O1 only")
        raise ValueError(f"device Nx16 kernel: plain {nway}-way "
                         f"O{int(o1)} only")
    p = 1
    ulen, p = u7_get(data, p)
    if o1:
        tlen, p = u7_get(data, p)
        tab = data[p:p + tlen]
        p += tlen
        tp = 0
        ctxs, tp = _read_alphabet(tab, tp)
        F = np.zeros((256, 256), np.int64)
        for ctx in ctxs:
            F[ctx], tp = _read_freq_table(tab, tp)
    else:
        F, p = _read_freq_table(data, p)
    states = np.zeros(nway, np.int64)
    for j in range(nway):
        states[j] = int.from_bytes(data[p:p + 4], "little")
        p += 4
    payload = np.frombuffer(data, np.uint8, len(data) - p, p)
    return ulen, F, states, payload


def o1_row_count(F: np.ndarray) -> int:
    """(context, symbol) rows of a table: past A2_MAX, only a dense table
    holds it."""
    return int((np.asarray(F) > 0).sum())


def o1_pads(parsed) -> Tuple[int, int]:
    """(a2_pad, a_pad) covering a list of parsed O1 streams: the JAX
    kernels' table heights, whose A2_MAX gate is the routing rule."""
    a2_pad = 8
    a_pad = 8
    for _ulen, F, _states, _payload in parsed:
        used_ctx = np.nonzero(F.sum(axis=1))[0]
        syms = np.nonzero(F.sum(axis=0))[0]
        A = len(np.union1d(used_ctx, syms))
        while a_pad < A:
            a_pad <<= 1
        nrows = o1_row_count(F)
        while a2_pad < nrows:
            a2_pad <<= 1
    if a2_pad > A2_MAX:
        raise ValueError("alphabet too large for the device O1 kernel")
    return a2_pad, a_pad


def o1_alphabet(F: np.ndarray) -> int:
    """Size of a table's dense alphabet as the kernels index it
    (`rans_o1_mark`): context 0, the contexts with rows and the rows'
    symbols."""
    F = np.asarray(F)
    present = (F.sum(axis=1) > 0) | (F.sum(axis=0) > 0)
    present[0] = True
    return int(present.sum())


def o1_rows(F: np.ndarray, max_rows: int = A2_MAX
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-context frequencies [256, 256] -> (rows uint32 [n], packed
    (f-1) | cum<<12 | sym<<24 in (ctx, sym) order; ctx_start int32
    [257]).  Raises ValueError when a context's frequencies exceed 4096
    or the rows exceed max_rows."""
    F = np.asarray(F, np.int64)
    if (F.sum(axis=1) > TOTFREQ).any():
        raise ValueError("order-1 context frequencies exceed 4096")
    ctx, sym = np.nonzero(F)
    if len(ctx) > max_rows:
        raise ValueError("alphabet too large for the device O1 kernel")
    cum = np.cumsum(F, axis=1) - F
    rows = ((F[ctx, sym] - 1) | (cum[ctx, sym] << 12) | (sym << 24))
    ctx_start = np.zeros(257, np.int32)
    np.cumsum((F > 0).sum(axis=1), out=ctx_start[1:])
    return rows.astype(np.uint32), ctx_start


def frame_o1_tables(Fs: List[np.ndarray], device,
                    max_rows: int = A2_MAX) -> O1Tables:
    """O1Tables of streams with per-context frequencies Fs, of at most
    max_rows rows each."""
    built = [o1_rows(F, max_rows) for F in Fs]
    n_rows = np.array([len(r) for r, _ in built], np.int64)
    rows = np.concatenate([r for r, _ in built] + [np.zeros(1, np.uint32)])
    ctx_start = np.stack([c for _, c in built]) if built \
        else np.zeros((0, 257), np.int32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return O1Tables(dev(rows.view(np.int32)), dev(exclusive_cumsum(n_rows)),
                    dev(n_rows.astype(np.int32)), dev(ctx_start))


DENSE_CHUNK = 16   # streams a pass of the dense table build takes


def dense_tables(Fs: List[np.ndarray], device,
                 timing: Optional[dict] = None) -> torch.Tensor:
    """Per-context frequencies of S streams -> their dense tables, int32
    (u32 bits) [S, 256 * 4096] on `device`, built there from the [S, 256,
    256] frequencies: slot m of context ctx holds sym | (f-1)<<8 | c<<20
    for the symbol whose range [c, c + f) holds m, and 0 past the
    context's sum, as the JAX package's ops/rans.py _pack_table packs it.
    Raises ValueError when a context's frequencies exceed 4096.  `timing`,
    where given, gains the build's seconds (upload included) under
    dense_table_s."""
    t0 = _build.clock(device) if timing is not None else 0.0
    S = len(Fs)
    F = np.stack([np.asarray(f, np.int32) for f in Fs]) if S \
        else np.zeros((0, 256, 256), np.int32)
    if (F.sum(axis=2, dtype=np.int64) > TOTFREQ).any():
        raise ValueError("order-1 context frequencies exceed 4096")
    F = torch.from_numpy(F).to(device)
    out = torch.empty((S, 256 * TOTFREQ), dtype=torch.int32,
                      device=F.device)
    slots = torch.arange(TOTFREQ, device=F.device)
    for lo in range(0, S, DENSE_CHUNK):
        f = F[lo:lo + DENSE_CHUNK].reshape(-1, 256).long()
        inc = torch.cumsum(f, 1)
        sym = torch.searchsorted(inc, slots.expand(len(f), TOTFREQ)
                                 .contiguous(), right=True)
        sc = sym.clamp(max=255)
        fs = torch.gather(f, 1, sc)
        e = sc | ((fs - 1) << 8) | ((torch.gather(inc, 1, sc) - fs) << 20)
        e = torch.where(sym < 256, e, 0)
        out[lo:lo + DENSE_CHUNK] = torch.where(
            e >= 1 << 31, e - (1 << 32), e).reshape(-1, 256 * TOTFREQ)
    if timing is not None:
        timing["dense_table_s"] = (timing.get("dense_table_s", 0.0)
                                   + _build.clock(device) - t0)
    return out


def frame_o1_streams(parsed, device, dense: bool = False,
                     timing: Optional[dict] = None,
                     large: bool = False) -> Nx16O1Batch:
    """Parsed O1 streams (`_parse_nx16_header`) -> an `Nx16O1Batch`, with
    `dense` carrying dense tables in place of rows (any row count; their
    build timed into `timing` as `dense_tables` times it), with `large`
    rows up to LARGE_MAX_ROWS for the large table."""
    ulen = np.array([p[0] for p in parsed], np.int64)
    if (ulen >= 1 << 31).any():
        raise ValueError("stream too long for the Nx16 kernel")
    payload, word_off, n_words = pack_payloads([p[3] for p in parsed], 2)
    states = np.array([p[2] for p in parsed], np.int64).reshape(-1, NWAY)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    Fs = [p[1] for p in parsed]
    return Nx16O1Batch(
        dev(payload), dev(word_off), dev(n_words.astype(np.int32)),
        None if dense else frame_o1_tables(
            Fs, device, LARGE_MAX_ROWS if large else A2_MAX),
        dev(states.astype(np.uint32).view(np.int32)),
        dev(ulen.astype(np.int32)), dev(exclusive_cumsum(ulen)),
        dense_tables(Fs, device, timing) if dense else None, large,
        max(map(o1_alphabet, Fs), default=0) if large else 0)


def o1_slot_table(t: O1Tables) -> torch.Tensor:
    """Dense slot table int64 [S, 256 * 4096] of the plain versions:
    entry ctx*4096 + m packs, for the row of context ctx owning slot m,
    (f-1) | (m - cum)<<12 | sym<<24 (the order-0 slot packing), and 0
    where no row owns the slot."""
    S = int(t.n_rows.shape[0])
    dev = t.rows.device
    table = torch.zeros((S, 256 * TOTFREQ), dtype=torch.long, device=dev)
    rows = t.rows.long() & _U32
    for i in range(S):
        lo = int(t.row_off[i])
        e = rows[lo:lo + int(t.n_rows[i])]
        if not len(e):
            continue
        ctx = torch.searchsorted(t.ctx_start[i, 1:].long(),
                                 torch.arange(len(e), device=dev), right=True)
        f = (e & 0xFFF) + 1
        # offset of each slot within its row
        within = torch.arange(int(f.sum()), device=dev) \
            - torch.repeat_interleave(torch.cumsum(f, 0) - f, f)
        slot = torch.repeat_interleave(ctx * TOTFREQ + ((e >> 12) & 0xFFF),
                                       f) + within
        table[i, slot] = torch.repeat_interleave(e & ~(0xFFF << 12), f) \
            | (within << 12)
    return table


def slot_step(x, idx, table):
    """One decode step of states x [S, k] through a packed slot table
    [S, T] at entries idx: returns (symbols, advanced states)."""
    e = torch.gather(table, 1, idx)
    step = (((e & 0xFFF) + 1) * (x >> TF_SHIFT) + ((e >> 12) & 0xFFF)) \
        & _U32
    return e >> 24, step


def dense_step(x, idx, dense):
    """One decode step of states x [S, k] through dense tables [S, 256 *
    4096] of JAX entries sym | (f-1)<<8 | c<<20 (int64) at entries idx:
    x = f * (x >> 12) + (x & 4095) - c, as the JAX decode computes it.
    Returns (symbols, advanced states)."""
    e = torch.gather(dense, 1, idx)
    step = ((((e >> 8) & 0xFFF) + 1) * (x >> TF_SHIFT)
            + (x & (TOTFREQ - 1)) - (e >> 20)) & _U32
    return e & 0xFF, step


def rows_dense_tables(t: O1Tables) -> torch.Tensor:
    """The dense tables (`dense_tables`, on the rows' device) of the
    streams whose rows `t` holds: the large table's answers."""
    rows = t.rows.cpu().numpy().view(np.uint32)
    cs = t.ctx_start.cpu().numpy()
    Fs = []
    for i, lo in enumerate(t.row_off.tolist()):
        e = rows[lo:lo + int(t.n_rows[i])].astype(np.int64)
        F = np.zeros((256, 256), np.int64)
        F[np.repeat(np.arange(256), np.diff(cs[i])), e >> 24] = \
            (e & 0xFFF) + 1
        Fs.append(F)
    return dense_tables(Fs, t.rows.device)


def o1_lookup(b):
    """(step function, table) of an order-1 batch's plain version: the
    dense tables where it carries them or where its rows are for the
    large table (built from them), else the slot table of its rows."""
    if b.dense is not None:
        return dense_step, b.dense.long() & _U32
    if b.large:
        return dense_step, rows_dense_tables(b.tables).long() & _U32
    return slot_step, o1_slot_table(b.tables)


def rans_o1_plain(b: Nx16O1Batch, max_rounds: int = -1,
                  offs: Optional[torch.Tensor] = None,
                  qbins: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """Plain PyTorch version of kernels B5/B6: the same rounds as tensor
    ops over [streams, 32 states].  Returns (symbols u8 [total_out], or
    with `qbins` the histogram int32 [S, qbins] of clip(sym - offs, 0,
    qbins - 1); final states int32 [S, 32]; final word cursors int32 [S];
    final contexts int32 [S, 32])."""
    dev = b.payload.device
    S = b.n_streams
    step_fn, table = o1_lookup(b)
    words = b.payload.view(torch.int16).long() & 0xFFFF
    nw = b.n_words.long()[:, None]
    wo = b.word_off[:, None]
    n = b.ulen.long()[:, None]
    lanes = torch.arange(NWAY, device=dev)[None, :]
    seg = n // NWAY
    lens = torch.where(lanes < NWAY - 1, seg, n - (NWAY - 1) * seg)
    rounds = lens[:, -1]
    if max_rounds >= 0:
        rounds = rounds.clamp(max=max_rounds)
    x = b.x0.long() & _U32
    ctx = torch.zeros((S, NWAY), dtype=torch.long, device=dev)
    cur = torch.zeros((S, 1), dtype=torch.long, device=dev)
    total = b.total_out
    if qbins is None:
        out = torch.zeros(total + 1, dtype=torch.uint8, device=dev)
    else:
        out = torch.zeros((S, qbins), dtype=torch.long, device=dev)
        off = (offs.long() if offs is not None
               else torch.zeros(S, dtype=torch.long, device=dev))[:, None]
    for r in range(int(rounds.max()) if S else 0):
        act = (r < lens) & (r < rounds)[:, None]
        s, step = step_fn(x, ctx * TOTFREQ + (x & (TOTFREQ - 1)), table)
        x = torch.where(act, step, x)
        ctx = torch.where(act, s, ctx)
        if qbins is None:
            at = torch.where(act, b.out_off[:, None] + lanes * seg + r, total)
            out[at.reshape(-1)] = s.reshape(-1).to(torch.uint8)
        else:
            out.scatter_add_(1, (s - off).clamp(0, qbins - 1), act.long())
        x, cur = refill16(x, act & (x < RANS16_L), cur, words, wo, nw)
    res = out[:total] if qbins is None else out.to(torch.int32)
    return (res, x.to(torch.int32), cur[:, 0].to(torch.int32),
            ctx.to(torch.int32))


def check_dense(dense: torch.Tensor, S: int) -> None:
    """Validate dense tables the kernels trust: on the card, int32 [S, 256 *
    4096]."""
    _build.require_cuda(dense, torch.int32, "dense", (S, 256 * TOTFREQ))


def check_o1_tables(t: O1Tables, S: int, max_rows: int = A2_MAX) -> None:
    """Validate tables the kernels trust: on the card, of the right
    types and shapes, every stream's rows (at most max_rows) inside the
    buffer and its context starts rising from 0 to its row count."""
    req = _build.require_cuda
    req(t.rows, torch.int32, "rows")
    req(t.row_off, torch.int64, "row_off", (S,))
    req(t.n_rows, torch.int32, "n_rows", (S,))
    req(t.ctx_start, torch.int32, "ctx_start", (S, 257))
    cs = t.ctx_start
    bad = ((t.row_off < 0) | (t.n_rows < 0) | (t.n_rows > max_rows)
           | (t.row_off + t.n_rows > t.rows.numel())
           | (cs[:, 0] != 0) | (cs[:, -1] != t.n_rows)).any() \
        | (cs[:, 1:] < cs[:, :-1]).any()
    if bool(bad):
        raise ValueError("order-1 tables: a stream's rows lie outside "
                         "their buffer or its context starts are invalid")


def o1_table_sizes(t: O1Tables) -> Tuple[torch.Tensor, torch.Tensor]:
    """(contexts, slow buckets), int64 [S] each, of every stream's table as
    the kernels build it (csrc/rans_nx16_o1_step.cuh): the dense alphabet
    (`rans_o1_mark`: context 0, the contexts with rows and the rows'
    symbols), and the 64-slot buckets in which two or more of a context's
    rows start after the bucket's first slot (`rans_o1_build`'s
    RANS_O1_SLOW).  Raises unless every context's cums rise, as an
    encoder's table's do (each row has a slot at least): the maps of the
    slow buckets rest on it."""
    S = int(t.n_rows.shape[0])
    dev = t.rows.device
    n = t.n_rows.long()
    total = int(n.sum())
    stream = torch.repeat_interleave(torch.arange(S, device=dev), n,
                                     output_size=total)
    e = t.rows[torch.arange(total, device=dev) - (torch.cumsum(n, 0) - n)
               [stream] + t.row_off[stream]].long()
    ctx = torch.repeat_interleave(
        torch.arange(256, device=dev).repeat(S),
        (t.ctx_start[:, 1:] - t.ctx_start[:, :-1]).reshape(-1).long(),
        output_size=total)
    cum = (e >> 12) & 0xFFF
    same = (stream[1:] == stream[:-1]) & (ctx[1:] == ctx[:-1])
    if bool((same & (cum[1:] <= cum[:-1])).any()):
        raise ValueError("order-1 tables: a context's cums do not rise")
    present = torch.zeros((S, 256), dtype=torch.bool, device=dev)
    present[:, 0] = True
    present |= t.ctx_start[:, 1:] > t.ctx_start[:, :-1]
    present.view(-1)[stream * 256 + ((e >> 24) & 0xFF)] = True
    inside = cum % 64 != 0
    key, count = torch.unique((stream * 256 + ctx)[inside] * 64
                              + cum[inside] // 64, return_counts=True)
    slow = torch.bincount(key[count >= 2] // (256 * 64), minlength=S)
    return present.sum(1), slow


def o1_smem_bytes(t: O1Tables, hist: bool) -> int:
    """Bytes of shared memory a block of kernel B5 (or, with `hist`, B6)
    takes for the largest table of the batch."""
    if not int(t.n_rows.shape[0]):
        return 0
    n_ctx, n_slow = o1_table_sizes(t)
    rows, ctxs, slow = torch.stack([t.n_rows.max().long(), n_ctx.max(),
                                    n_slow.max()]).tolist()
    lib = _build.load("rans_nx16_o1")
    return lib.rans_nx16_o1_smem_bytes(rows, ctxs, slow, int(hist))


def dense_smem_bytes() -> int:
    """Bytes of shared memory a block of B5's dense variant takes: the
    fixed part only, as it builds no table."""
    return _build.load("rans_nx16_o1").rans_nx16_o1_smem_bytes(0, 0, 0, 0)


LARGE_SHIFTS = (3, 4, 5)   # the large table's buckets: 8, 16 or 32 slots


def finest_shift(per_sm, n_streams: int, sms: int) -> int:
    """The large table's finest bucket shift whose blocks (per_sm(shift)
    of them an SM) decode n_streams streams in as few waves as the
    coarsest's: finer buckets walk less, and cost shared memory."""
    def waves(shift):
        n = per_sm(shift)
        return -(-n_streams // (n * sms)) if n > 0 else None
    coarsest = waves(LARGE_SHIFTS[-1])
    return next(k for k in LARGE_SHIFTS if waves(k) == coarsest)


def large_smem_bytes(n_rows: int, n_ctx: int, shift: int = 5) -> int:
    """Bytes of shared memory a block of B5's large variant takes for
    tables of up to n_rows rows and n_ctx contexts, with buckets of
    1 << shift slots."""
    return _build.load("rans_nx16_o1").rans_nx16_o1_large_smem_bytes(
        n_rows, n_ctx, shift)


def large_shift(t: O1Tables, device, alphabet: int) -> Tuple[int, int]:
    """(bucket shift, shared memory a block) of a launch of B5's large
    variant over a batch's rows (`finest_shift`), whose largest dense
    alphabet the framing counted (`Nx16O1Batch.alphabet`; a stream with a
    larger one is refused)."""
    if not int(t.n_rows.shape[0]):
        return 5, 0
    rows, ctxs = int(t.n_rows.max()), alphabet
    shift = finest_shift(
        lambda k: large_blocks_per_sm(large_smem_bytes(rows, ctxs, k)),
        int(t.n_rows.shape[0]),
        torch.cuda.get_device_properties(device).multi_processor_count)
    return shift, large_smem_bytes(rows, ctxs, shift)


def large_blocks_per_sm(smem: int) -> int:
    """Streams one SM holds in B5's large variant with `smem` bytes a
    block; 0 past a block's shared memory."""
    n = _build.load("rans_nx16_o1").rans_nx16_o1_large_blocks_per_sm(smem)
    return max(n, 0)


def large_per_wave(n_rows: int, n_ctx: int, device) -> Optional[int]:
    """Streams of up to n_rows rows and n_ctx contexts that one wave of
    B5's large variant decodes on `device` (its blocks an SM times the
    SMs); None on the CPU, where both routes run the same plain version
    and no wave bounds a batch."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    per_sm = large_blocks_per_sm(large_smem_bytes(n_rows, n_ctx))
    return per_sm * torch.cuda.get_device_properties(
        dev).multi_processor_count


def large_fits(Fs: List[np.ndarray], device) -> bool:
    """Whether order-1 streams with per-context frequencies Fs, past
    A2_MAX rows, take B5's large variant (at most LARGE_WAVES waves of
    it) rather than the dense one; decided on the host before any
    launch."""
    per = large_per_wave(max(o1_row_count(F) for F in Fs),
                         max(o1_alphabet(F) for F in Fs), device)
    return per is None or 0 < len(Fs) <= LARGE_WAVES * per


def blocks_per_sm(t: O1Tables, hist: bool) -> int:
    """Streams with tables `t` that one SM of the card decodes at once in
    kernel B5 (or, with `hist`, B6): the blocks its shared memory holds."""
    lib = _build.load("rans_nx16_o1")
    n = lib.rans_nx16_o1_blocks_per_sm(int(hist), o1_smem_bytes(t, hist))
    _build.check(lib, max(-n, 0), "rans_nx16_o1 occupancy")
    return n


def rans_o1_cuda(b: Nx16O1Batch, max_rounds: int = -1,
                 offs: Optional[torch.Tensor] = None,
                 qbins: Optional[int] = None,
                 slow_rounds: Optional[torch.Tensor] = None,
                 smem_bytes: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """Kernel B5 (symbols) or, with `qbins`, kernel B6 (histogram) over
    the whole batch in one launch, or B5's dense variant for a batch with
    dense tables, or its large variant for a `large` batch (both symbols
    only); same results as `rans_o1_plain`.  `slow_rounds` (int32 [S] on
    the card), where given, gets each stream's rounds in which some
    state's bucket was slow (its lookup took the bucket's map, or the
    large table's walk; 0 with dense tables).  `smem_bytes` sizes a
    block's shared memory where the caller does (None: for the batch's
    largest table); a stream whose tables outgrow it is refused, and this
    raises."""
    S = b.n_streams
    req = _build.require_cuda
    req(b.payload, torch.uint8, "payload")
    req(b.word_off, torch.int64, "word_off", (S,))
    req(b.n_words, torch.int32, "n_words", (S,))
    req(b.x0, torch.int32, "x0", (S, NWAY))
    req(b.ulen, torch.int32, "ulen", (S,))
    req(b.out_off, torch.int64, "out_off", (S,))
    dense = b.dense is not None
    if dense or b.large:
        if qbins is not None:
            raise ValueError("dense order-1 tables: symbols only (the "
                             "histogram lane refuses such streams)")
    if dense:
        check_dense(b.dense, S)
    else:
        check_o1_tables(b.tables, S, LARGE_MAX_ROWS if b.large else A2_MAX)
    if b.payload.numel() % 2 or b.payload.data_ptr() % 2:
        raise ValueError("payload: expected whole, aligned 16-bit words")
    bad = (((b.word_off + b.n_words) * 2 > b.payload.numel())
           | (b.word_off < 0) | (b.n_words < 0) | (b.ulen < 0)
           | (b.out_off < 0) | (b.out_off + b.ulen > b.total_out)).any()
    if bool(bad):
        raise ValueError("batch: a stream lies outside its buffers")
    dev = b.payload.device
    x_out = torch.empty((S, NWAY), dtype=torch.int32, device=dev)
    ctx_out = torch.empty((S, NWAY), dtype=torch.int32, device=dev)
    cur_out = torch.empty(S, dtype=torch.int32, device=dev)
    if qbins is None:
        # positions a max_rounds stop leaves undecoded hold 0, as in
        # the plain version
        res = (torch.empty if max_rounds < 0 else torch.zeros)(
            b.total_out, dtype=torch.uint8, device=dev)
        out_ptr, hist_ptr, offs_ptr, key = res.data_ptr(), None, None, \
            "rans_nx16_o1_%sdecode" % ("dense_" if dense else "large_"
                                       if b.large else "")
    else:
        if not 1 <= qbins <= 256:
            raise ValueError("qbins must be in 1..256")
        if offs is None:
            offs = torch.zeros(S, dtype=torch.int32, device=dev)
        req(offs, torch.int32, "offs", (S,))
        res = torch.empty((S, qbins), dtype=torch.int32, device=dev)
        out_ptr, hist_ptr, offs_ptr, key = None, res.data_ptr(), \
            offs.data_ptr(), "rans_nx16_o1_hist"
    if slow_rounds is not None:
        req(slow_rounds, torch.int32, "slow_rounds", (S,))
    lib = _build.load("rans_nx16_o1")
    t = b.tables
    large = 0
    if dense:
        smem = dense_smem_bytes()
        t_ptrs = [None] * 4
    else:
        if b.large:
            large, smem = large_shift(t, dev, b.alphabet)
        else:
            smem = o1_smem_bytes(t, qbins is not None)
        t_ptrs = [t.rows.data_ptr(), t.row_off.data_ptr(),
                  t.n_rows.data_ptr(), t.ctx_start.data_ptr()]
    if smem_bytes is not None:
        smem = smem_bytes
    err = _build.error_word(dev)
    rc = lib.rans_nx16_o1_launch(
        b.payload.data_ptr(), b.word_off.data_ptr(), b.n_words.data_ptr(),
        *t_ptrs, b.dense.data_ptr() if dense else None,
        b.x0.data_ptr(), b.ulen.data_ptr(),
        b.out_off.data_ptr(), out_ptr, offs_ptr, hist_ptr, x_out.data_ptr(),
        cur_out.data_ptr(), ctx_out.data_ptr(),
        None if slow_rounds is None else slow_rounds.data_ptr(),
        err.data_ptr(), S, qbins or 0, max_rounds, smem, large,
        _build.stream_handle(b.payload))
    _build.check(lib, rc, key)
    _build.LAUNCHES[key] += 1
    _build.check_word(err, key)
    return res, x_out, cur_out, ctx_out


def rans_o1(b: Nx16O1Batch, max_rounds: int = -1,
            offs: Optional[torch.Tensor] = None, qbins: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor]:
    """Decode a batch: the kernel for a batch on the card, the plain
    version for one on the CPU.  `max_rounds` >= 0 stops every stream
    after that many rounds (the state a JAX segment call leaves)."""
    if b.payload.is_cuda:
        return rans_o1_cuda(b, max_rounds, offs, qbins)
    if b.payload.device.type != "cpu":
        raise ValueError(f"unsupported device {b.payload.device}")
    return rans_o1_plain(b, max_rounds, offs, qbins)


def decode_nx16_o1_batch(blocks: List[bytes],
                         device="cuda") -> List[bytes]:
    """Wire-exact rANS Nx16 ORDER-1 32-way decode of whole streams (host
    model: codecs/rans4x16._dec_core_o1), every stream of the list in
    one kernel launch, the <= 31-symbol tail included."""
    dev = _build.resolve_device(device)
    parsed = [_parse_nx16_header(d) for d in blocks]
    o1_pads(parsed)
    if not blocks:
        return []
    return decode_o1_streams(frame_o1_streams(parsed, dev))


def decode_o1_streams(b: Nx16O1Batch) -> List[bytes]:
    """The symbols of every stream of a batch, one launch on the card."""
    syms = rans_o1(b)[0].cpu().numpy()
    offs = b.out_off.cpu().numpy()
    lens = b.ulen.cpu().numpy()
    return [syms[o:o + n].tobytes() for o, n in zip(offs, lens)]
