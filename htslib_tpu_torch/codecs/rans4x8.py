"""rANS 4x8, the CRAM 3.0 static rANS codec (htscodecs rANS_static.c,
used via cram/cram_io.c:1668/1838), as host Python.

The port's own copy of the JAX package's host codec, kept byte for byte
in its arithmetic so that both packages write and read the same wire.
As in the JAX package, `uncompress` and `compress` go to the native
library (htstpu_rans4x8_uncompress / _compress) unless
`htslib_tpu_torch.native.native` is None.  It decodes the QS blocks that
stay on the host, frames the streams the card decodes, and synthesises
test streams.

Stream layout (CRAM 3.0 spec section 13):
  byte   order (0 or 1)
  u32le  compressed size (bytes after this 9-byte prefix)
  u32le  uncompressed size
  freq table (ITF8 frequencies, RLE'd ascending symbol list)
  rANS-coded data: 4 interleaved states, 12-bit frequencies,
  renormalisation bound L = 1<<23, one byte at a time.
"""
from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

from htslib_tpu_torch.cram.itf8 import itf8_decode, itf8_encode

TF_SHIFT = 12
TOTFREQ = 1 << TF_SHIFT
RANS_L = 1 << 23


# -- frequency tables --------------------------------------------------------

def _read_freqs(buf: bytes, p: int) -> Tuple[np.ndarray, int]:
    """Read one symbol->freq table.  Symbol list is ascending with an RLE
    escape (sym, sym+1, runlen); frequencies are ITF8 (identical to
    htscodecs' 1-2 byte scheme for values < 16384); terminated by symbol
    0."""
    freqs = np.zeros(256, np.int64)
    sym = buf[p]
    p += 1
    rle = 0
    while True:
        f, p = itf8_decode(buf, p)
        freqs[sym] = f
        if rle == 0 and buf[p] == sym + 1:
            sym = buf[p]
            p += 1
            rle = buf[p]
            p += 1
        elif rle > 0:
            rle -= 1
            sym += 1
        else:
            sym = buf[p]
            p += 1
        if sym == 0:
            break
    return freqs, p


def _write_freqs(freqs: np.ndarray) -> bytes:
    """Inverse of _read_freqs."""
    syms = np.nonzero(freqs)[0]
    out = bytearray()
    i = 0
    n = len(syms)
    while i < n:
        run = 0
        while (i + run + 1 < n and syms[i + run + 1] == syms[i + run] + 1):
            run += 1
        out.append(syms[i])
        out += itf8_encode(int(freqs[syms[i]]))
        if run >= 1:
            out.append(syms[i] + 1)
            out.append(run - 1)
            for j in range(1, run + 1):
                out += itf8_encode(int(freqs[syms[i + j]]))
            i += run + 1
        else:
            i += 1
    out.append(0)
    return bytes(out)


def _normalize(freqs: np.ndarray, total: int = TOTFREQ) -> np.ndarray:
    """Scale frequencies to sum to `total`, keeping nonzero symbols
    nonzero (the format stores the table actually used)."""
    s = freqs.sum()
    if s == 0:
        return freqs
    out = np.maximum((freqs * total) // max(s, 1), np.where(freqs > 0, 1, 0))
    # fix rounding drift: adjust the largest symbol
    diff = total - out.sum()
    out[out.argmax()] += diff
    if out[out.argmax()] <= 0:
        raise ValueError("cannot normalize frequencies")
    return out


def _read_freqs_o1(buf: bytes, p: int) -> Tuple[np.ndarray, int]:
    """256x256 context table."""
    freqs = np.zeros((256, 256), np.int64)
    sym = buf[p]
    p += 1
    rle = 0
    while True:
        inner, p = _read_freqs(buf, p)
        freqs[sym] = inner
        if rle == 0 and buf[p] == sym + 1:
            sym = buf[p]
            p += 1
            rle = buf[p]
            p += 1
        elif rle > 0:
            rle -= 1
            sym += 1
        else:
            sym = buf[p]
            p += 1
        if sym == 0:
            break
    return freqs, p


# -- decode ------------------------------------------------------------------

def uncompress(data: bytes) -> bytes:
    order = data[0]
    _comp_sz, out_sz = struct.unpack_from("<II", data, 1)
    from htslib_tpu_torch.native import native
    if native is not None:
        return native.rans4x8_uncompress(data, out_sz)
    if order == 0:
        return _uncompress_o0(data, 9, out_sz)
    return _uncompress_o1(data, 9, out_sz)


def _uncompress_o0(buf: bytes, p: int, out_sz: int) -> bytes:
    freqs, p = _read_freqs(buf, p)
    cum = np.zeros(257, np.int64)
    np.cumsum(freqs, out=cum[1:])
    if cum[256] > TOTFREQ:
        raise ValueError("rANS0: frequencies exceed 4096")
    # slot -> symbol lookup (tail slots unused when sum < 4096, as in
    # htscodecs' rounding-tolerant tables)
    D = np.repeat(np.arange(256, dtype=np.uint8), freqs)
    if len(D) < TOTFREQ:
        D = np.concatenate([D, np.zeros(TOTFREQ - len(D), np.uint8)])
    fr = freqs[D.astype(np.int64)]
    cm = cum[D.astype(np.int64)]

    arr = np.frombuffer(buf, np.uint8)
    x = np.frombuffer(buf[p:p + 16], "<u4").astype(np.int64).copy()
    p += 16
    out = np.empty((out_sz + 3) // 4 * 4, np.uint8)
    nmain = out_sz // 4
    ptr = p
    # vectorised across the 4 states, serial over rounds
    for i in range(nmain):
        m = x & (TOTFREQ - 1)
        sym = D[m]
        out[i * 4:i * 4 + 4] = sym
        x = fr[m] * (x >> TF_SHIFT) + m - cm[m]
        for j in range(4):
            while x[j] < RANS_L and ptr < len(arr):
                x[j] = (x[j] << 8) | arr[ptr]
                ptr += 1
    # remainder bytes decoded one state at a time (states 0..2)
    for k in range(out_sz - nmain * 4):
        j = k
        m = int(x[j]) & (TOTFREQ - 1)
        sym = D[m]
        out[nmain * 4 + k] = sym
        x[j] = int(fr[m]) * (int(x[j]) >> TF_SHIFT) + m - int(cm[m])
        while x[j] < RANS_L and ptr < len(arr):
            x[j] = (int(x[j]) << 8) | int(arr[ptr])
            ptr += 1
    return out[:out_sz].tobytes()


def _uncompress_o1(buf: bytes, p: int, out_sz: int) -> bytes:
    freqs, p = _read_freqs_o1(buf, p)
    cum = np.zeros((256, 257), np.int64)
    np.cumsum(freqs, axis=1, out=cum[:, 1:])
    # per-context slot->symbol tables (only for used contexts)
    used = np.nonzero(freqs.sum(axis=1))[0]
    D = np.zeros((256, TOTFREQ), np.uint8)
    for c in used:
        if cum[c, 256] > TOTFREQ:
            raise ValueError("rANS1: context frequencies exceed 4096")
        d = np.repeat(np.arange(256, dtype=np.uint8), freqs[c])
        D[c, :len(d)] = d

    arr = np.frombuffer(buf, np.uint8)
    x = np.frombuffer(buf[p:p + 16], "<u4").astype(np.int64).copy()
    ptr = p + 16
    isz4 = out_sz >> 2
    out = np.empty(out_sz, np.uint8)
    l = np.zeros(4, np.int64)  # context (previous symbol) per state
    pos = np.array([0, isz4, 2 * isz4, 3 * isz4], np.int64)
    for i in range(isz4):
        m = x & (TOTFREQ - 1)
        sym = D[l, m]
        out[pos] = sym
        x = freqs[l, sym] * (x >> TF_SHIFT) + m - cum[l, sym]
        for j in range(4):
            while x[j] < RANS_L and ptr < len(arr):
                x[j] = (x[j] << 8) | arr[ptr]
                ptr += 1
        l = sym.astype(np.int64)
        pos += 1
    # tail: state 3 continues
    for k in range(4 * isz4, out_sz):
        m = int(x[3]) & (TOTFREQ - 1)
        sym = int(D[int(l[3]), m])
        out[k] = sym
        x[3] = (int(freqs[int(l[3]), sym]) * (int(x[3]) >> TF_SHIFT) + m
                - int(cum[int(l[3]), sym]))
        while x[3] < RANS_L and ptr < len(arr):
            x[3] = (int(x[3]) << 8) | int(arr[ptr])
            ptr += 1
        l[3] = sym
    return out.tobytes()


# -- encode ------------------------------------------------------------------

def compress(data: bytes, order: int = 0) -> bytes:
    from htslib_tpu_torch.native import native
    if native is not None:
        return native.rans4x8_compress(data, order)
    if order == 0 or len(data) < 4:
        body = _compress_o0(data)
        order = 0
    else:
        body = _compress_o1(data)
    head = bytes([order]) + struct.pack("<II", len(body), len(data))
    return head + body


def _compress_o0(data: bytes) -> bytes:
    arr = np.frombuffer(data, np.uint8)
    hist = np.bincount(arr, minlength=256).astype(np.int64)
    if len(arr) == 0:
        return _write_freqs(np.zeros(256, np.int64)) + struct.pack(
            "<4I", RANS_L, RANS_L, RANS_L, RANS_L)
    freqs = _normalize(hist)
    cum = np.zeros(257, np.int64)
    np.cumsum(freqs, out=cum[1:])
    table = _write_freqs(freqs)
    # encode backwards, 4 states
    x = [RANS_L] * 4
    out_rev = bytearray()
    n = len(arr)
    for i in range(n - 1, -1, -1):
        j = i & 3
        s = int(arr[i])
        f = int(freqs[s])
        c = int(cum[s])
        x_max = ((RANS_L >> TF_SHIFT) << 8) * f
        while x[j] >= x_max:
            out_rev.append(x[j] & 0xFF)
            x[j] >>= 8
        x[j] = ((x[j] // f) << TF_SHIFT) + (x[j] % f) + c
    states = b"".join(struct.pack("<I", x[j]) for j in range(4))
    return table + states + bytes(reversed(out_rev))


def _compress_o1(data: bytes) -> bytes:
    arr = np.frombuffer(data, np.uint8)
    n = len(arr)
    isz4 = n >> 2
    # context histogram: ctx -> sym counts; first byte of each quarter
    # has ctx 0
    hist = np.zeros((256, 256), np.int64)
    ctx = np.empty(n, np.uint8)
    ctx[0] = 0
    ctx[1:] = arr[:-1]
    for j in range(4):
        ctx[j * isz4] = 0
    np.add.at(hist, (ctx.astype(np.int64), arr.astype(np.int64)), 1)
    freqs = np.zeros((256, 256), np.int64)
    for c in np.nonzero(hist.sum(axis=1))[0]:
        freqs[c] = _normalize(hist[c])
    cum = np.zeros((256, 257), np.int64)
    np.cumsum(freqs, axis=1, out=cum[:, 1:])
    # table: outer RLE of contexts
    out = bytearray()
    used = np.nonzero(hist.sum(axis=1))[0]
    i = 0
    while i < len(used):
        run = 0
        while (i + run + 1 < len(used)
               and used[i + run + 1] == used[i + run] + 1):
            run += 1
        out.append(used[i])
        out += _write_freqs(freqs[used[i]])
        if run >= 1:
            out.append(used[i] + 1)
            out.append(run - 1)
            for j in range(1, run + 1):
                out += _write_freqs(freqs[used[i + j]])
            i += run + 1
        else:
            i += 1
    out.append(0)
    # the decoder consumes renormalisation bytes in (round, state) order
    # plus a state-3 tail; encode in exact reverse of that order
    x = [RANS_L] * 4
    out_rev = bytearray()
    starts = [0, isz4, 2 * isz4, 3 * isz4]
    seq: List[Tuple[int, int]] = []  # (state, pos)
    for i in range(isz4):
        for j in range(4):
            seq.append((j, starts[j] + i))
    for k in range(4 * isz4, n):
        seq.append((3, k))
    for j, pos in reversed(seq):
        s = int(arr[pos])
        c = 0 if pos == starts[j] else int(arr[pos - 1])
        f = int(freqs[c, s])
        cm = int(cum[c, s])
        x_max = ((RANS_L >> TF_SHIFT) << 8) * f
        while x[j] >= x_max:
            out_rev.append(x[j] & 0xFF)
            x[j] >>= 8
        x[j] = ((x[j] // f) << TF_SHIFT) + (x[j] % f) + cm
    states = b"".join(struct.pack("<I", x[j]) for j in range(4))
    return bytes(out) + states + bytes(reversed(out_rev))
