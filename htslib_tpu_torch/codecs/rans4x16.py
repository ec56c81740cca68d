"""rANS Nx16 codec, the CRAM 3.1 entropy coder (htscodecs
rans_compress_4x16 / rans_uncompress_4x16), as host Python.

The port's own copy of the JAX package's host codec, kept byte for byte
in its arithmetic so that both packages frame and decode the same wire:
a flags byte (ORDER1 0x01, N32 0x04, STRIPE 0x08, NOSZ 0x10, CAT 0x20,
RLE 0x40, PACK 0x80), an optional uint7 uncompressed length, transform
metadata, and a 4- or 32-way interleaved 16-bit-renormalising static
rANS core with 12-bit frequencies.  It decodes the QS blocks that stay
on the host and synthesises the streams the card decodes.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

TF_SHIFT = 12
TOTFREQ = 1 << TF_SHIFT
RANS_L = 1 << 15          # 16-bit renormalisation lower bound

O_ORDER1 = 0x01
O_N32 = 0x04
O_STRIPE = 0x08
O_NOSZ = 0x10
O_CAT = 0x20
O_RLE = 0x40
O_PACK = 0x80


# -- uint7 varints (htscodecs varint.h) --------------------------------------
def u7_put(out: bytearray, v: int) -> None:
    s = 0
    t = v
    while t >= 0x80:
        t >>= 7
        s += 7
    while s > 0:
        out.append(((v >> s) & 0x7F) | 0x80)
        s -= 7
    out.append(v & 0x7F)


def u7_get(buf, p: int) -> Tuple[int, int]:
    v = 0
    while True:
        c = buf[p]
        p += 1
        v = (v << 7) | (c & 0x7F)
        if not (c & 0x80):
            return v, p


# -- frequency tables --------------------------------------------------------
def _norm_freqs(counts: np.ndarray, total: int = TOTFREQ) -> np.ndarray:
    """Normalise symbol counts to sum to `total`, every present symbol
    keeping freq >= 1."""
    n = counts.sum()
    if n == 0:
        return counts.astype(np.int64)
    f = (counts.astype(np.float64) * total / n).astype(np.int64)
    f[(counts > 0) & (f == 0)] = 1
    # fix rounding drift on the most frequent symbol
    drift = total - int(f.sum())
    f[int(np.argmax(f))] += drift
    if f[int(np.argmax(counts))] <= 0:
        raise ValueError("cannot normalise frequencies")
    return f


def _write_alphabet(out: bytearray, syms: List[int]) -> None:
    """Symbol list with run encoding: after two consecutive symbols a
    run byte counts how many more follow consecutively."""
    i = 0
    n = len(syms)
    while i < n:
        out.append(syms[i])
        if i > 0 and syms[i] == syms[i - 1] + 1:
            run = 0
            while (i + run + 1 < n
                   and syms[i + run + 1] == syms[i + run] + 1
                   and run < 255):
                run += 1
            out.append(run)
            i += run + 1
        else:
            i += 1


def _read_alphabet(buf, p: int) -> Tuple[List[int], int]:
    syms: List[int] = []
    last = -2
    while True:
        if not syms:
            if p >= len(buf):
                raise ValueError("truncated alphabet")
            s = buf[p]
            p += 1
            syms.append(s)
            last = s
            continue
        if p >= len(buf):
            raise ValueError("truncated alphabet")
        s = buf[p]
        p += 1
        if s == 0 and last != -1:
            # terminator (0 can only appear first in ascending lists)
            break
        syms.append(s)
        if s == last + 1:
            run = buf[p]
            p += 1
            for _ in range(run):
                syms.append(syms[-1] + 1)
        last = syms[-1]
    return syms, p


def _write_freq_table(out: bytearray, f: np.ndarray) -> None:
    syms = [int(s) for s in np.nonzero(f)[0]]
    _write_alphabet(out, syms)
    out.append(0)  # terminator
    for s in syms:
        u7_put(out, int(f[s]))


def _read_freq_table(buf, p: int) -> Tuple[np.ndarray, int]:
    syms, p = _read_alphabet(buf, p)
    f = np.zeros(256, np.int64)
    for s in syms:
        v, p = u7_get(buf, p)
        f[s] = v
    return f, p


# -- rANS core (order-0) -----------------------------------------------------
def _enc_core(data: np.ndarray, f: np.ndarray, cum: np.ndarray,
              nway: int) -> bytes:
    out = bytearray()
    states = [RANS_L] * nway
    n = len(data)
    # encode in reverse; symbol i belongs to state i % nway
    for i in range(n - 1, -1, -1):
        j = i % nway
        s = int(data[i])
        x = states[j]
        freq = int(f[s])
        x_max = ((RANS_L >> TF_SHIFT) << 16) * freq
        while x >= x_max:
            # hi then lo: the final bytewise reversal turns each pair
            # little-endian and reverses pair order
            out.append((x >> 8) & 0xFF)
            out.append(x & 0xFF)
            x >>= 16
        states[j] = ((x // freq) << TF_SHIFT) + (x % freq) + int(cum[s])
    head = bytearray()
    for j in range(nway):
        x = states[j]
        head += bytes([x & 0xFF, (x >> 8) & 0xFF,
                       (x >> 16) & 0xFF, (x >> 24) & 0xFF])
    return bytes(head) + bytes(reversed(out))


def _dec_core(buf, p: int, n_out: int, f: np.ndarray, cum: np.ndarray,
              nway: int) -> Tuple[np.ndarray, int]:
    sym_of = np.zeros(TOTFREQ, np.uint8)
    for s in np.nonzero(f)[0]:
        sym_of[int(cum[s]):int(cum[s]) + int(f[s])] = s
    states = []
    for j in range(nway):
        x = (buf[p] | (buf[p + 1] << 8) | (buf[p + 2] << 16)
             | (buf[p + 3] << 24))
        p += 4
        states.append(x)
    out = np.empty(n_out, np.uint8)
    mask = TOTFREQ - 1
    blen = len(buf)
    for i in range(n_out):
        j = i % nway
        x = states[j]
        m = x & mask
        s = int(sym_of[m])
        out[i] = s
        x = int(f[s]) * (x >> TF_SHIFT) + m - int(cum[s])
        while x < RANS_L and p + 1 < blen + 1:
            if p + 2 > blen:
                break
            x = (x << 16) | buf[p] | (buf[p + 1] << 8)
            p += 2
        states[j] = x
    return out, p


def _enc_core_o1(data: np.ndarray, F: np.ndarray, C: np.ndarray,
                 nway: int) -> bytes:
    """Order-1 Nx16 core: the stream splits into nway floor-sized
    contiguous segments, one state per segment with context = previous
    byte (0 at segment heads); renormalisation is interleaved round-robin
    across states per round (the htscodecs layout), and the remainder
    beyond nway*seg is carried by the last state after the main rounds."""
    n = len(data)
    out = bytearray()
    states = [RANS_L] * nway
    seg = n // nway
    # decode consumption order: (round-robin over states) then the tail
    order = [j * seg + r for r in range(seg) for j in range(nway)]
    order.extend(range(nway * seg, n))
    for i in reversed(order):
        j = min(i // seg, nway - 1) if seg else nway - 1
        head = (seg and i % seg == 0 and i < nway * seg) \
            or (not seg and i == 0)
        ctx = 0 if head else int(data[i - 1])
        s = int(data[i])
        freq = int(F[ctx, s])
        x = states[j]
        x_max = ((RANS_L >> TF_SHIFT) << 16) * freq
        while x >= x_max:
            out.append((x >> 8) & 0xFF)
            out.append(x & 0xFF)
            x >>= 16
        states[j] = ((x // freq) << TF_SHIFT) + (x % freq) + int(C[ctx, s])
    head_b = bytearray()
    for j in range(nway):
        x = states[j]
        head_b += bytes([x & 0xFF, (x >> 8) & 0xFF,
                         (x >> 16) & 0xFF, (x >> 24) & 0xFF])
    return bytes(head_b) + bytes(reversed(out))


def _dec_core_o1(buf, p: int, n_out: int, F: np.ndarray, C: np.ndarray,
                 nway: int) -> Tuple[np.ndarray, int]:
    sym_of = np.zeros((256, TOTFREQ), np.uint8)
    for ctx in range(256):
        if F[ctx].sum() == 0:
            continue
        for s in np.nonzero(F[ctx])[0]:
            sym_of[ctx, int(C[ctx, s]):int(C[ctx, s]) + int(F[ctx, s])] = s
    states = []
    for j in range(nway):
        x = (buf[p] | (buf[p + 1] << 8) | (buf[p + 2] << 16)
             | (buf[p + 3] << 24))
        p += 4
        states.append(x)
    out = np.empty(n_out, np.uint8)
    mask = TOTFREQ - 1
    seg = n_out // nway
    blen = len(buf)
    ptrs = p
    ctxs = [0] * nway
    # main rounds: all states advance together, renormalising interleaved
    for r in range(seg):
        for j in range(nway):
            i = j * seg + r
            ctx = ctxs[j]
            x = states[j]
            m = x & mask
            s = int(sym_of[ctx, m])
            out[i] = s
            x = int(F[ctx, s]) * (x >> TF_SHIFT) + m - int(C[ctx, s])
            while x < RANS_L:
                if ptrs + 2 > blen:
                    break
                x = (x << 16) | buf[ptrs] | (buf[ptrs + 1] << 8)
                ptrs += 2
            states[j] = x
            ctxs[j] = s
    # tail: the last state continues
    for i in range(nway * seg, n_out):
        j = nway - 1
        ctx = ctxs[j]
        x = states[j]
        m = x & mask
        s = int(sym_of[ctx, m])
        out[i] = s
        x = int(F[ctx, s]) * (x >> TF_SHIFT) + m - int(C[ctx, s])
        while x < RANS_L:
            if ptrs + 2 > blen:
                break
            x = (x << 16) | buf[ptrs] | (buf[ptrs + 1] << 8)
            ptrs += 2
        states[j] = x
        ctxs[j] = s
    return out, ptrs


# -- transforms --------------------------------------------------------------
def _pack(data: bytes) -> Tuple[bytes, bytes]:
    """Bit-pack data over its symbol set; returns (meta, packed)."""
    syms = sorted(set(data))
    P = len(syms)
    meta = bytearray([P])
    meta += bytes(syms)
    if P <= 1:
        return bytes(meta), b""
    idx = {s: i for i, s in enumerate(syms)}
    vals = np.frombuffer(data, np.uint8)
    lut = np.zeros(256, np.uint8)
    for s, i in idx.items():
        lut[s] = i
    v = lut[vals]
    if P <= 2:
        w = 1
    elif P <= 4:
        w = 2
    elif P <= 16:
        w = 4
    else:
        return bytes(meta), data  # no packing possible
    per = 8 // w
    pad = (-len(v)) % per
    if pad:
        v = np.concatenate([v, np.zeros(pad, np.uint8)])
    v = v.reshape(-1, per)
    packed = np.zeros(len(v), np.uint8)
    for slot in range(per):
        packed |= v[:, slot] << (slot * w)
    return bytes(meta), packed.tobytes()


def _unpack(meta, p: int, packed: bytes, n_out: int) -> Tuple[bytes, int]:
    P = meta[p]
    p += 1
    syms = bytes(meta[p:p + P])
    p += P
    if P <= 1:
        return syms[:1] * n_out if P else b"", p
    if P <= 2:
        w = 1
    elif P <= 4:
        w = 2
    elif P <= 16:
        w = 4
    else:
        return packed[:n_out], p
    per = 8 // w
    arr = np.frombuffer(packed, np.uint8)
    mask = (1 << w) - 1
    out = np.empty(len(arr) * per, np.uint8)
    for slot in range(per):
        out[slot::per] = (arr >> (slot * w)) & mask
    lut = np.frombuffer(syms, np.uint8)
    return lut[out[:n_out]].tobytes(), p


def _rle_encode(data: bytes) -> Tuple[bytes, bytes]:
    """Run-length transform: returns (meta, literals).  meta = symbol
    set subject to RLE + per-run lengths (uint7); literals = data with
    runs collapsed to one occurrence."""
    arr = np.frombuffer(data, np.uint8)
    # choose symbols whose RLE saves space: any symbol with avg run > 1
    saved = np.zeros(256, np.int64)
    i = 0
    n = len(arr)
    runs = []
    while i < n:
        j = i
        while j < n and arr[j] == arr[i]:
            j += 1
        runs.append((int(arr[i]), j - i))
        saved[arr[i]] += (j - i) - 2   # keep 1 literal + ~1 len byte
        i = j
    rle_syms = sorted(int(s) for s in np.nonzero(saved > 0)[0])
    if not rle_syms:
        # L=0 means "all 256 symbols" on the wire; pick one harmless
        # symbol instead so the stream stays unambiguous
        rle_syms = [int(arr[0])] if n else []
    if len(rle_syms) == 256:
        meta = bytearray([0])
    else:
        meta = bytearray([len(rle_syms)])
    if len(rle_syms) != 256:
        meta += bytes(rle_syms)
    rset = set(rle_syms)
    lits = bytearray()
    for s, ln in runs:
        if s in rset:
            lits.append(s)
            u7_put(meta, ln - 1)
        else:
            lits += bytes([s]) * ln
    return bytes(meta), bytes(lits)


def _rle_decode(meta, p: int, lits: bytes, n_out: int) -> bytes:
    L = meta[p]
    p += 1
    if L == 0:
        rset = set(range(256))
    else:
        rset = set(meta[p:p + L])
        p += L
    out = bytearray()
    for b in lits:
        if b in rset:
            run, p = u7_get(meta, p)
            out += bytes([b]) * (run + 1)
        else:
            out.append(b)
        if len(out) >= n_out:
            break
    return bytes(out[:n_out])


# -- public API --------------------------------------------------------------
def compress(data: bytes, flags: int = 0) -> bytes:
    """Compress with the given flag set.  ORDER1/N32/PACK/RLE/STRIPE/CAT
    honoured; callers typically try a few flag combinations and keep the
    smallest (cram_compress_block3 trial model)."""
    if flags & O_PACK and len(set(data)) > 16:
        flags &= ~O_PACK   # alphabet too large to bit-pack
    if flags & O_RLE and not data:
        flags &= ~O_RLE
    out = bytearray()
    out.append(flags)
    if not flags & O_NOSZ:
        u7_put(out, len(data))
    if flags & O_CAT:
        out += data
        return bytes(out)
    if flags & O_STRIPE:
        N = 4
        out.append(N)
        subs = []
        for j in range(N):
            sub = data[j::N]
            subs.append(compress(sub, (flags & (O_ORDER1 | O_N32))
                                | O_NOSZ))
        for s in subs:
            u7_put(out, len(s))
        for s in subs:
            out += s
        return bytes(out)
    payload = data
    if flags & O_PACK:
        meta, payload = _pack(payload)
        out += meta
        u7_put(out, len(payload))
    if flags & O_RLE:
        meta, payload = _rle_encode(payload)
        u7_put(out, len(meta))
        out += meta
        u7_put(out, len(payload))
    nway = 32 if flags & O_N32 else 4
    arr = np.frombuffer(payload, np.uint8)
    if len(arr) == 0:
        return bytes(out)
    if flags & O_ORDER1:
        seg = len(arr) // nway
        F = np.zeros((256, 256), np.int64)
        for i in range(len(arr)):
            head = (seg and i % seg == 0 and i < nway * seg) \
                or (not seg and i == 0)
            ctx = 0 if head else int(arr[i - 1])
            F[ctx, int(arr[i])] += 1
        Fn = np.zeros_like(F)
        C = np.zeros((256, 257), np.int64)
        for ctx in range(256):
            if F[ctx].sum():
                Fn[ctx] = _norm_freqs(F[ctx])
                C[ctx, 1:] = np.cumsum(Fn[ctx])
        # table: contexts alphabet, then per-context freq table
        ctxs = [int(c) for c in np.nonzero(F.sum(axis=1))[0]]
        tab = bytearray()
        _write_alphabet(tab, ctxs)
        tab.append(0)
        for ctx in ctxs:
            _write_freq_table(tab, Fn[ctx])
        u7_put(out, len(tab))
        out += tab
        out += _enc_core_o1(arr, Fn, C[:, :256], nway)
    else:
        counts = np.bincount(arr, minlength=256).astype(np.int64)
        f = _norm_freqs(counts)
        cum = np.zeros(257, np.int64)
        cum[1:] = np.cumsum(f)
        tab = bytearray()
        _write_freq_table(tab, f)
        out += tab
        out += _enc_core(arr, f, cum[:256], nway)
    return bytes(out)


def uncompress(buf: bytes, expected_len: int = -1) -> bytes:
    data, _ = _uncompress_at(memoryview(buf), 0, expected_len)
    return data


def _uncompress_at(buf, p: int, expected_len: int = -1) -> Tuple[bytes, int]:
    flags = buf[p]
    p += 1
    if flags & O_NOSZ:
        ulen = expected_len
        if ulen < 0:
            raise ValueError("NOSZ stream needs an expected length")
    else:
        ulen, p = u7_get(buf, p)
    if flags & O_CAT:
        return bytes(buf[p:p + ulen]), p + ulen
    if flags & O_STRIPE:
        N = buf[p]
        p += 1
        lens = []
        for _ in range(N):
            v, p = u7_get(buf, p)
            lens.append(v)
        parts = []
        for j in range(N):
            want = (ulen - j + N - 1) // N
            part, _ = _uncompress_at(buf[p:p + lens[j]], 0, want)
            parts.append(np.frombuffer(part, np.uint8))
            p += lens[j]
        out = np.empty(ulen, np.uint8)
        for j in range(N):
            out[j::N] = parts[j]
        return out.tobytes(), p
    pack_meta_at = -1
    if flags & O_PACK:
        pack_meta_at = p
        P = buf[p]
        p += 1 + P
        plen, p = u7_get(buf, p)
        n_core = plen
    rle_meta = None
    if flags & O_RLE:
        mlen, p = u7_get(buf, p)
        rle_meta = bytes(buf[p:p + mlen])
        p += mlen
        llen, p = u7_get(buf, p)
        n_core = llen
    if not (flags & (O_PACK | O_RLE)):
        n_core = ulen
    nway = 32 if flags & O_N32 else 4
    if n_core == 0:
        payload = b""
    elif flags & O_ORDER1:
        tlen, p = u7_get(buf, p)
        tab = buf[p:p + tlen]
        p += tlen
        tp = 0
        ctxs, tp = _read_alphabet(tab, tp)
        F = np.zeros((256, 256), np.int64)
        for ctx in ctxs:
            F[ctx], tp = _read_freq_table(tab, tp)
        C = np.zeros((256, 256), np.int64)
        for ctx in range(256):
            C[ctx, 1:] = np.cumsum(F[ctx][:-1])
        arr, p = _dec_core_o1(buf, p, n_core, F, C, nway)
        payload = arr.tobytes()
    else:
        f, p = _read_freq_table(buf, p)
        cum = np.zeros(256, np.int64)
        cum[1:] = np.cumsum(f[:-1])
        arr, p = _dec_core(buf, p, n_core, f, cum, nway)
        payload = arr.tobytes()
    if flags & O_RLE:
        n_after_rle = ulen
        if flags & O_PACK:
            # RLE output feeds unpack: its length is the packed length
            n_after_rle = -1  # determined by meta run content
        payload = _rle_decode(memoryview(rle_meta), 0, payload,
                              plen if flags & O_PACK else ulen)
    if flags & O_PACK:
        payload, _ = _unpack(buf, pack_meta_at, payload, ulen)
    return payload, p
