"""rANS 4x8 decode on the card (kernels B7 and B8), the CRAM 3.0 wire,
and the symbols of the wires that share its round (X1-X3).

Port of htslib_tpu/ops/rans4x8_pallas.py: `decode_4x8_o0_batch` (its
`_seg4_kernel`) here, and the order-0 or order-1 histogram variant (its
`_seg4_hist_kernel`) through `rans4x8(..., qbins=...)`, which
ops/device_stats.py drives.  The same kernel source decodes 4x8 order-1
symbols (X1) and the 4-way rANS Nx16 wire of both orders (X2, X3: a
batch framed by `frame_nx16_4way`, whose states refill 16-bit
little-endian words against 2^15), the cases of htslib_tpu/ops/rans.py
that ops/rans.py sends here.

Layout.  The Pallas kernels decode 64 streams per call in state-major
[8, 256] lanes over byte-packed [W, 64] windows, 1024 rounds per call,
and finish the odd tail on the host.  The port keeps the wire and the
outputs: a batch (`Rans4x8Batch`) holds each stream's payload bytes back
to back, each starting on a 4-byte boundary, its order-0 frequencies or
its order-1 rows (`O1Tables`, as for the Nx16 order-1 kernels), and its 4
initial states; one launch decodes every stream of the batch to its end,
tail included (csrc/rans4x8.cu, one warp per stream).

`rans4x8` launches the kernel for tensors on the card and takes the plain
PyTorch version (`rans4x8_plain`, the same rounds as tensor ops over all
streams and states at once) for tensors on the CPU.

An order-1 batch with row tables decodes through one of two tables of
the same round (csrc/rans4x8_step.cuh): the wide table (16-byte ready
records, u32 buckets, per-slot maps of the slow buckets: no loop or
branch in the round, one stream an SM) for a batch of at most WIDE_WAVES
waves of it, else the compact table (packed u32 records, u16 buckets, a
walk of the slow buckets: four streams an SM); `wide_fits` decides from
the batch and the device, `rans4x8_cuda(..., layout=...)` forces one.

An order-1 batch may carry dense [256 x 4096] tables in place of rows
(`Rans4x8Batch.dense`, `frame_4x8` / `frame_nx16_4way` with `dense`): the
streams whose tables pass the rows' A2_MAX, which ops/rans.py decodes as
its JAX twin does, through the dense variants of X1 and X3.  Or it keeps
their rows, up to LARGE_MAX_ROWS (`Rans4x8Batch.large`, `frame_4x8` /
`frame_nx16_4way` with `large`), for the large table of the same round
(csrc/rans4x8_step.cuh `rans8_round_large`, built in shared memory, the
JAX dense table's answers), one stream an SM at the wire's 65,536 rows:
ops/rans.py gives it a past-A2_MAX group of at most LARGE_WAVES waves
(`large_fits`), the dense variants a larger one.

Past a payload's end the kernels and the plain version read zero bytes,
where the host codecs stop refilling; a valid stream never refills there,
so the symbols are the same, and the cursor each returns is clamped at
the payload's end.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from htslib_tpu_torch import _build
from htslib_tpu_torch.codecs.rans4x8 import _read_freqs, _read_freqs_o1
from htslib_tpu_torch.ops.rans_nx16 import (TOTFREQ, _U32, exclusive_cumsum,
                                            pack_payloads)
from htslib_tpu_torch.ops.rans_nx16_o1 import (A2_MAX, LARGE_MAX_ROWS,
                                               O1Tables, _parse_nx16_header,
                                               check_dense, check_o1_tables,
                                               dense_tables, frame_o1_tables,
                                               finest_shift, o1_lookup,
                                               o1_pads,
                                               o1_row_count, o1_table_sizes,
                                               slot_step)

RANS8_L = 1 << 23
RANS16_L = 1 << 15
NWAY4 = 4
# waves of the wide order-1 table's blocks up to which an order-1 batch
# takes it (`wide_fits`; set by probe_x1_x5.py's sweep)
WIDE_WAVES = 1
# waves of the large table's blocks (X1, X3 past A2_MAX rows) up to which
# a past-A2_MAX group takes it rather than the dense variants (`large_fits`;
# set by probe_dense.py's sweep)
LARGE_WAVES = 1
# launches of the order-1 kernels (X1, X3, B8 order 1) by table layout
LAYOUT_LAUNCHES = {"wide": 0, "compact": 0, "large": 0}


@dataclass
class Rans4x8Batch:
    """4x8 streams (with `w16`, 4-way Nx16 streams) of one order framed
    for decode, on one device."""
    payload: torch.Tensor   # u8: payloads back to back, 4-byte aligned
    byte_off: torch.Tensor  # int64 [S]: first byte of each payload
    n_bytes: torch.Tensor   # int32 [S]: bytes in each payload
    freqs: torch.Tensor     # int32 [S, 256]: order-0 frequencies (sum
    #                         <= 4096); zeros for order 1
    tables: Optional[O1Tables]  # order-1 rows; None for order 0
    x0: torch.Tensor        # int32 [S, 4]: initial states (u32 bits)
    ulen: torch.Tensor      # int32 [S]: symbols in each stream
    out_off: torch.Tensor   # int64 [S]: each stream's first output byte
    w16: bool = False       # the 4-way Nx16 wire's refill (16-bit words
    #                         against 2^15) in place of 4x8's bytes
    dense: Optional[torch.Tensor] = None  # int32 [S, 256 * 4096]: order-1
    #                         dense tables (`dense_tables`) in place of rows
    large: bool = False     # order-1 rows past A2_MAX, for the large table

    @property
    def o1(self) -> bool:
        return self.tables is not None or self.dense is not None

    @property
    def n_streams(self) -> int:
        return int(self.ulen.shape[0])

    @property
    def total_out(self) -> int:
        return int(self.ulen.sum())


def _parse_4x8_o0(data: bytes):
    """Parse a 4x8 ORDER-0 stream: returns (out_sz, f [256], states [4],
    payload ndarray); the checks of rans4x8_pallas._prepare_group4."""
    if data[0] != 0:
        raise ValueError("device rans4x8: order-0 only")
    _comp_sz, out_sz = struct.unpack_from("<II", data, 1)
    f, p = _read_freqs(data, 9)
    if f.sum() > TOTFREQ:
        raise ValueError("rans4x8: frequencies exceed 4096")
    states = np.frombuffer(data, "<u4", NWAY4, p).astype(np.int64)
    p += 16
    return out_sz, f, states, np.frombuffer(data, np.uint8, len(data) - p, p)


def _parse_4x8_o1(data: bytes):
    """Parse a 4x8 ORDER-1 stream: returns (out_sz, F [256,256],
    states [4], payload_offset)."""
    if data[0] != 1:
        raise ValueError("not a 4x8 order-1 stream")
    _comp_sz, out_sz = struct.unpack_from("<II", data, 1)
    F, p = _read_freqs_o1(data, 9)
    states = np.zeros(4, np.int64)
    for j in range(4):
        states[j] = int.from_bytes(data[p + 4 * j:p + 4 * j + 4], "little")
    return out_sz, F, states, p + 16


def o1_gate_4x8(F: np.ndarray) -> None:
    """The JAX routing gate of 4x8 order-1 streams: raise ValueError when
    the stacked rows pad past A2_MAX."""
    nrows = o1_row_count(F)
    a2 = 8
    while a2 < nrows:
        a2 <<= 1
    if a2 > A2_MAX:
        raise ValueError("alphabet too large for the device O1 kernel")


def frame_4x8(blocks: List[bytes], o1: bool, device, dense: bool = False,
              timing: Optional[dict] = None,
              parsed: Optional[list] = None,
              large: bool = False) -> Rans4x8Batch:
    """Parse 4x8 streams of one order (flag byte included) into a
    `Rans4x8Batch`; raises as the JAX front ends do.  `dense` (order 1):
    dense tables in place of rows, for any row count, their build timed
    into `timing` as `dense_tables` times it; `large` (order 1): rows up
    to LARGE_MAX_ROWS for the large table.  `parsed` (order 1): the
    streams' `_parse_4x8_o1` results, where the caller has them."""
    S = len(blocks)
    freqs = np.zeros((S, 256), np.int32)
    states = np.zeros((S, NWAY4), np.int64)
    ulen = np.zeros(S, np.int64)
    payloads, Fs = [], []
    for i, data in enumerate(blocks):
        if o1:
            ulen[i], F, states[i], poff = (parsed[i] if parsed
                                           else _parse_4x8_o1(data))
            Fs.append(F)
            payloads.append(np.frombuffer(data, np.uint8, len(data) - poff,
                                          poff))
        else:
            ulen[i], freqs[i], states[i], pl = _parse_4x8_o0(data)
            payloads.append(pl)
    if o1 and not dense and not large:
        for F in Fs:
            o1_gate_4x8(F)
    return _batch(payloads, freqs, Fs if o1 else None, states, ulen, False,
                  device, dense, timing, large)


def frame_nx16_4way(blocks: List[bytes], o1: bool, device,
                    dense: bool = False, timing: Optional[dict] = None,
                    parsed: Optional[list] = None,
                    large: bool = False) -> Rans4x8Batch:
    """Parse plain 4-way rANS Nx16 streams of one order (flags 0x00 or
    0x01; none of zero length: such a stream has no table) into a
    `Rans4x8Batch` with the Nx16 refill (`w16`).  Raises ValueError on
    other flags, frequencies past 4096 or (order 1, without `dense`)
    tables past the kernels' A2_MAX rows, as the 32-way framings do;
    `dense`, `large` and `timing` as in `frame_4x8`; `parsed`: the
    streams' `_parse_nx16_header` results, where the caller has them."""
    if parsed is None:
        parsed = [_parse_nx16_header(d, NWAY4, o1) for d in blocks]
    ulen = np.array([p[0] for p in parsed], np.int64)
    if (ulen == 0).any():
        raise ValueError("a zero-length Nx16 stream has no table to frame")
    freqs = np.zeros((len(blocks), 256), np.int32)
    if o1:
        if not dense and not large:
            o1_pads(parsed)
    else:
        for i, p in enumerate(parsed):
            if p[1].sum() > TOTFREQ:
                raise ValueError("rANS Nx16: frequencies exceed 4096")
            freqs[i] = p[1]
    states = np.array([p[2] for p in parsed], np.int64).reshape(-1, NWAY4)
    return _batch([p[3] for p in parsed], freqs,
                  [p[1] for p in parsed] if o1 else None, states, ulen, True,
                  device, dense, timing, large)


def _batch(payloads, freqs, Fs, states, ulen, w16, device,
           dense=False, timing=None, large=False) -> Rans4x8Batch:
    """A `Rans4x8Batch` of parsed streams on `device`: order 1 where the
    per-context frequencies Fs are given, through dense tables with
    `dense`, with rows for the large table with `large`."""
    if (ulen >= 1 << 31).any():
        raise ValueError("stream too long for the 4x8 kernel")
    payload, word_off, _ = pack_payloads(payloads, 4)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return Rans4x8Batch(
        dev(payload), dev(4 * word_off),
        dev(np.array([len(p) for p in payloads], np.int32)), dev(freqs),
        frame_o1_tables(Fs, device, LARGE_MAX_ROWS if large else A2_MAX)
        if Fs is not None and not dense else None,
        dev(states.astype(np.uint32).view(np.int32)),
        dev(ulen.astype(np.int32)), dev(exclusive_cumsum(ulen)), w16,
        dense_tables(Fs, device, timing) if dense else None,
        large and Fs is not None)


def o0_slot_table(freqs: torch.Tensor) -> torch.Tensor:
    """Packed order-0 slot tables int64 [S, 4096] (rans_o0_build_slots):
    (f-1) | (m - cum)<<12 | sym<<24 per slot m; past the sum symbol 0
    with f = 1 and offset m (the JAX package's packed entry 0)."""
    f = freqs.long()
    cum_incl = torch.cumsum(f, 1)
    slots = torch.arange(TOTFREQ, device=f.device).expand(
        f.shape[0], TOTFREQ).contiguous()
    s = torch.searchsorted(cum_incl, slots, right=True)
    sc = s.clamp(max=255)
    fs = torch.gather(f, 1, sc)
    cs = torch.gather(cum_incl, 1, sc) - fs
    return torch.where(s < 256, (fs - 1) | ((slots - cs) << 12) | (sc << 24),
                       slots << 12)


def rans4x8_plain(b: Rans4x8Batch, max_rounds: int = -1,
                  offs: Optional[torch.Tensor] = None,
                  qbins: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """Plain PyTorch version of kernels B7/B8 and X1-X3 (with `b.dense`,
    of X1/X3's dense variants): the same rounds as tensor ops over
    [streams, 4 states], refilling as `b.w16` says.
    Returns (symbols u8 [total_out], or with `qbins` the histogram int32
    [S, qbins] of clip(sym - offs, 0, qbins - 1); final states int32
    [S, 4]; final byte cursors int32 [S]; final contexts int32 [S, 4], 0
    for order 0)."""
    dev = b.payload.device
    S = b.n_streams
    step_fn, table = o1_lookup(b) if b.o1 else (slot_step,
                                                o0_slot_table(b.freqs))
    data = b.payload.long()
    nb = b.n_bytes.long()[:, None]
    bo = b.byte_off[:, None]
    n = b.ulen.long()[:, None]
    lanes = torch.arange(NWAY4, device=dev)[None, :]
    isz4 = n // NWAY4
    if b.o1:
        lens = torch.where(lanes < NWAY4 - 1, isz4, n - (NWAY4 - 1) * isz4)
        rounds = lens[:, -1]
    else:
        rounds = (n[:, 0] + NWAY4 - 1) // NWAY4
    if max_rounds >= 0:
        rounds = rounds.clamp(max=max_rounds)
    x = b.x0.long() & _U32
    ctx = torch.zeros((S, NWAY4), dtype=torch.long, device=dev)
    cur = torch.zeros((S, 1), dtype=torch.long, device=dev)
    total = b.total_out
    if qbins is None:
        out = torch.zeros(total + 1, dtype=torch.uint8, device=dev)
    else:
        out = torch.zeros((S, qbins), dtype=torch.long, device=dev)
        off = (offs.long() if offs is not None
               else torch.zeros(S, dtype=torch.long, device=dev))[:, None]

    def byte(idx):
        inb = idx < nb
        return torch.where(inb, data[torch.where(inb, bo + idx, 0)], 0)

    for r in range(int(rounds.max()) if S else 0):
        if b.o1:
            pos = lanes * isz4 + r
            act = r < lens
        else:
            pos = r * NWAY4 + lanes
            act = pos < n
        act = act & (r < rounds)[:, None]
        s, step = step_fn(x, ctx * TOTFREQ + (x & (TOTFREQ - 1)), table)
        x = torch.where(act, step, x)
        if b.o1:
            ctx = torch.where(act, s, ctx)
        if qbins is None:
            at = torch.where(act, b.out_off[:, None] + pos, total)
            out[at.reshape(-1)] = s.reshape(-1).to(torch.uint8)
        else:
            out.scatter_add_(1, (s - off).clamp(0, qbins - 1), act.long())
        if b.w16:
            # one little-endian word below 2^15
            need = 2 * (act & (x < RANS16_L)).long()
            first = cur + torch.cumsum(need, 1) - need
            word = byte(first) | (byte(first + 1) << 8)
            x = torch.where(need == 2, ((x << 16) | word) & _U32, x)
        else:
            need = act.long() * ((x < RANS8_L).long()
                                 + (x < RANS16_L).long())
            first = cur + torch.cumsum(need, 1) - need
            x = torch.where(need >= 1, ((x << 8) | byte(first)) & _U32, x)
            x = torch.where(need == 2, ((x << 8) | byte(first + 1)) & _U32,
                            x)
        cur = torch.minimum(cur + need.sum(1, keepdim=True), nb)
    res = out[:total] if qbins is None else out.to(torch.int32)
    return (res, x.to(torch.int32), cur[:, 0].to(torch.int32),
            ctx.to(torch.int32))


def max_slow(t: O1Tables) -> int:
    """The most slow buckets (two or more rows starting inside a 64-slot
    bucket) of any stream's order-1 table: what the wide table's maps
    must hold."""
    return int(o1_table_sizes(t)[1].max()) if int(t.n_rows.shape[0]) else 0


def wide_blocks_per_sm(hist: bool, w16: bool, slow: int) -> int:
    """Streams one SM holds in the wide-table variant of X1 (X3 with w16,
    B8 order 1 with hist) with maps for `slow` slow buckets; 0 where its
    shared memory exceeds a block's."""
    n = _build.load("rans4x8").rans4x8_wide_blocks_per_sm(int(hist),
                                                          int(w16), slow)
    return max(n, 0)


def wide_smem_bytes(hist: bool, slow: int) -> int:
    """Bytes of shared memory a block of the wide-table variants takes."""
    return _build.load("rans4x8").rans4x8_wide_smem_bytes(int(hist), slow)


def large_smem_bytes(n_rows: int, shift: int = 5) -> int:
    """Bytes of shared memory a block of the large-table variants of X1
    and X3 takes for tables of up to n_rows rows, with buckets of
    1 << shift slots."""
    return _build.load("rans4x8").rans4x8_large_smem_bytes(n_rows, shift)


def large_blocks_per_sm(w16: bool, n_rows: int, shift: int = 5) -> int:
    """Streams of up to n_rows rows one SM holds in the large-table
    variant of X1 (X3 with w16), with buckets of 1 << shift slots; 0 past
    a block's shared memory."""
    n = _build.load("rans4x8").rans4x8_large_blocks_per_sm(int(w16), n_rows,
                                                           shift)
    return max(n, 0)


def large_per_wave(n_rows: int, w16: bool, device) -> Optional[int]:
    """Streams of up to n_rows rows that one wave of the large-table
    variant of X1 (X3 with w16) decodes on `device`: its blocks an SM
    times the SMs; None on the CPU, where both routes run the same plain
    version and no wave bounds a batch."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return large_blocks_per_sm(w16, n_rows) * torch.cuda.\
        get_device_properties(dev).multi_processor_count


def large_fits(Fs: List[np.ndarray], w16: bool, device) -> bool:
    """Whether order-1 streams with per-context frequencies Fs, past
    A2_MAX rows, take the large table (at most LARGE_WAVES waves of it)
    rather than the dense variants; decided on the host before any
    launch."""
    per = large_per_wave(max(o1_row_count(F) for F in Fs), w16, device)
    return per is None or len(Fs) <= LARGE_WAVES * per


def wide_fits(b: Rans4x8Batch, hist: bool = False) -> bool:
    """Whether an order-1 batch with row tables decodes through the wide
    table (ready records, no loop in the round) rather than the compact
    one: its maps fit a block's shared memory and its streams fit
    WIDE_WAVES waves of the wide blocks (one an SM)."""
    if not b.o1 or b.dense is not None or b.large:
        return False
    per_sm = wide_blocks_per_sm(hist, b.w16, max_slow(b.tables))
    sms = torch.cuda.get_device_properties(
        b.payload.device).multi_processor_count
    return per_sm > 0 and b.n_streams <= WIDE_WAVES * per_sm * sms


def rans4x8_cuda(b: Rans4x8Batch, max_rounds: int = -1,
                 offs: Optional[torch.Tensor] = None,
                 qbins: Optional[int] = None,
                 layout: Optional[str] = None,
                 sized_for: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """Kernel B7 (order-0 symbols), X1 (order-1 symbols), X2/X3 (the
    4-way Nx16 wire's symbols, `b.w16`), X1/X3's dense variants (a batch
    with `b.dense`), their large-table variants (a `b.large` batch) or,
    with `qbins`, kernel B8 (order-0 or order-1 4x8 histogram) over the
    whole batch in one launch; same results as `rans4x8_plain`.  An
    order-1 batch with row tables within A2_MAX decodes through the wide
    table or the compact one (`layout` "wide" or "compact"; None takes
    `wide_fits`).  `sized_for`: the slow buckets (wide) or rows (large) a
    block's shared memory is sized for, where the caller sizes it (None:
    the batch's most); a stream past it is refused, and this raises.  The
    large table's buckets are the finest that keep the batch's waves
    (`finest_shift`)."""
    S = b.n_streams
    req = _build.require_cuda
    req(b.payload, torch.uint8, "payload")
    req(b.byte_off, torch.int64, "byte_off", (S,))
    req(b.n_bytes, torch.int32, "n_bytes", (S,))
    req(b.freqs, torch.int32, "freqs", (S, 256))
    req(b.x0, torch.int32, "x0", (S, NWAY4))
    req(b.ulen, torch.int32, "ulen", (S,))
    req(b.out_off, torch.int64, "out_off", (S,))
    if b.payload.data_ptr() % 4:
        raise ValueError("payload: expected a 4-byte aligned buffer")
    # the kernel reads each payload as whole 32-bit words
    words_end = (b.byte_off + 4 * ((b.n_bytes.long() + 3) // 4))
    bad = ((words_end > b.payload.numel()) | (b.byte_off % 4 != 0)
           | (b.byte_off < 0) | (b.n_bytes < 0) | (b.ulen < 0)
           | (b.out_off < 0) | (b.out_off + b.ulen > b.total_out)).any() \
        | (b.freqs < 0).any() | (b.freqs.sum(1) > TOTFREQ).any()
    if bool(bad):
        raise ValueError("batch: a stream lies outside its buffers or has "
                         "a frequency table past 4096")
    dense = b.dense is not None
    if dense:
        check_dense(b.dense, S)
    elif b.o1:
        check_o1_tables(b.tables, S, LARGE_MAX_ROWS if b.large else A2_MAX)
    # the order-0 and dense kernels read no order-1 rows: null pointers
    t_ptrs = ([x.data_ptr() for x in (b.tables.rows, b.tables.row_off,
                                      b.tables.n_rows, b.tables.ctx_start)]
              if b.tables is not None else [None] * 4)
    dev = b.payload.device
    x_out = torch.empty((S, NWAY4), dtype=torch.int32, device=dev)
    ctx_out = torch.empty((S, NWAY4), dtype=torch.int32, device=dev)
    cur_out = torch.empty(S, dtype=torch.int32, device=dev)
    if qbins is None:
        # positions a max_rounds stop leaves undecoded hold 0, as in
        # the plain version
        res = (torch.empty if max_rounds < 0 else torch.zeros)(
            b.total_out, dtype=torch.uint8, device=dev)
        out_ptr, hist_ptr, offs_ptr = res.data_ptr(), None, None
        key = ("rans_nx16_4way_o%d%s_decode" if b.w16
               else "rans4x8_o%d%s_decode") % (
                   int(b.o1), "_dense" if dense else "_large" if b.large
                   else "")
    else:
        if b.w16:
            raise ValueError("4-way rANS Nx16 histogram: no kernel (the "
                             "wire is decoded to symbols only)")
        if dense or b.large:
            raise ValueError("dense order-1 tables: symbols only (the "
                             "histogram lane refuses such streams)")
        if not 1 <= qbins <= 256:
            raise ValueError("qbins must be in 1..256")
        if offs is None:
            offs = torch.zeros(S, dtype=torch.int32, device=dev)
        req(offs, torch.int32, "offs", (S,))
        res = torch.empty((S, qbins), dtype=torch.int32, device=dev)
        out_ptr, hist_ptr, offs_ptr = None, res.data_ptr(), offs.data_ptr()
        key = "rans4x8_o1_hist" if b.o1 else "rans4x8_o0_hist"
    lib = _build.load("rans4x8")
    if b.tables is None:
        if layout is not None:
            raise ValueError("layout: only order-1 row tables have one")
    elif b.large:
        if layout not in (None, "large"):
            raise ValueError("layout: a large batch takes the large table")
        layout = "large"
    elif layout is None:
        layout = "wide" if wide_fits(b, qbins is not None) else "compact"
    elif layout not in ("wide", "compact"):
        raise ValueError(f"layout: expected 'wide' or 'compact', got "
                         f"{layout!r}")
    err = _build.error_word(dev)
    if layout == "wide":
        slow = max_slow(b.tables) if sized_for is None else sized_for
        if wide_blocks_per_sm(qbins is not None, b.w16, slow) <= 0:
            raise ValueError(f"wide order-1 table: the maps of {slow} slow "
                             "buckets exceed a block's shared memory")
        rc = lib.rans4x8_wide_launch(
            b.payload.data_ptr(), b.byte_off.data_ptr(),
            b.n_bytes.data_ptr(), b.freqs.data_ptr(), *t_ptrs,
            b.x0.data_ptr(), b.ulen.data_ptr(), b.out_off.data_ptr(),
            out_ptr, offs_ptr, hist_ptr, x_out.data_ptr(),
            cur_out.data_ptr(), ctx_out.data_ptr(), err.data_ptr(), S,
            qbins or 0, max_rounds, int(b.w16), slow,
            _build.stream_handle(b.payload))
    elif layout == "large":
        rows = (int(b.tables.n_rows.max()) if S else 0) \
            if sized_for is None else sized_for
        shift = finest_shift(
            lambda k: large_blocks_per_sm(b.w16, rows, k), S,
            torch.cuda.get_device_properties(dev).multi_processor_count)
        if large_blocks_per_sm(b.w16, rows, shift) <= 0:
            raise ValueError(f"large order-1 table: {rows} rows exceed a "
                             "block's shared memory")
        rc = lib.rans4x8_large_launch(
            b.payload.data_ptr(), b.byte_off.data_ptr(),
            b.n_bytes.data_ptr(), b.freqs.data_ptr(), *t_ptrs,
            b.x0.data_ptr(), b.ulen.data_ptr(), b.out_off.data_ptr(),
            out_ptr, x_out.data_ptr(), cur_out.data_ptr(),
            ctx_out.data_ptr(), err.data_ptr(), S, max_rounds, int(b.w16),
            rows, shift, _build.stream_handle(b.payload))
    else:
        rc = lib.rans4x8_launch(
            b.payload.data_ptr(), b.byte_off.data_ptr(),
            b.n_bytes.data_ptr(), b.freqs.data_ptr(), *t_ptrs,
            b.dense.data_ptr() if dense else None, b.x0.data_ptr(),
            b.ulen.data_ptr(), b.out_off.data_ptr(), out_ptr, offs_ptr,
            hist_ptr, x_out.data_ptr(), cur_out.data_ptr(),
            ctx_out.data_ptr(), S, qbins or 0, max_rounds, int(b.o1),
            int(b.w16), _build.stream_handle(b.payload))
    _build.check(lib, rc, key)
    _build.LAUNCHES[key] += 1
    if layout is not None:
        LAYOUT_LAUNCHES[layout] += 1
    _build.check_word(err, key)
    if _build.SHAPES is not None:
        # (key, order-1 layout, streams, rounds of the longest stream)
        n = int(b.ulen.max())
        _build.SHAPES.append((key, layout, S, n - 3 * (n // NWAY4) if b.o1
                              else -(-n // NWAY4)))
    return res, x_out, cur_out, ctx_out


def smem_bytes(hist: bool, o1: bool = False, dense: bool = False) -> int:
    """Bytes of shared memory a block (a stream) of kernel B7, X1-X3
    (`hist` false), their dense variants (`dense`) or B8 of order `o1`
    takes."""
    return _build.load("rans4x8").rans4x8_smem_bytes(int(hist), int(o1),
                                                     int(dense))


def blocks_per_sm(hist: bool, o1: bool = False, w16: bool = False,
                  dense: bool = False) -> int:
    """Streams one SM of the card decodes at once in kernel B7 or X1
    (`hist` false, order `o1`), X2/X3 (`w16`), the dense variants of X1
    and X3 (`dense`) or B8 of order `o1`: the blocks its shared memory
    holds."""
    lib = _build.load("rans4x8")
    n = lib.rans4x8_blocks_per_sm(int(hist), int(o1), int(w16), int(dense))
    _build.check(lib, max(-n, 0), "rans4x8 occupancy")
    return n


def rans4x8(b: Rans4x8Batch, max_rounds: int = -1,
            offs: Optional[torch.Tensor] = None, qbins: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor]:
    """Decode a batch: the kernel for a batch on the card, the plain
    version for one on the CPU.  `max_rounds` >= 0 stops every stream
    after that many rounds (the state a JAX segment call leaves)."""
    if b.payload.is_cuda:
        return rans4x8_cuda(b, max_rounds, offs, qbins)
    if b.payload.device.type != "cpu":
        raise ValueError(f"unsupported device {b.payload.device}")
    return rans4x8_plain(b, max_rounds, offs, qbins)


def decode_4x8_o0_batch(blocks: List[bytes], device="cuda") -> List[bytes]:
    """Wire-exact rANS 4x8 order-0 decode of whole streams (the CRAM 3.0
    wire; codecs/rans4x8.py is the host model), every stream of the list
    in one kernel launch, the odd tail included."""
    dev = _build.resolve_device(device)
    if not blocks:
        return []
    return decode_streams(frame_4x8(blocks, False, dev))


def decode_streams(b: Rans4x8Batch) -> List[bytes]:
    """The symbols of every stream of a batch, one launch on the card."""
    syms = rans4x8(b)[0].cpu().numpy()
    offs = b.out_off.cpu().numpy()
    lens = b.ulen.cpu().numpy()
    return [syms[o:o + n].tobytes() for o, n in zip(offs, lens)]
