"""FQZComp quality codec, the CRAM 3.1 FQZ block method (reference call
sites cram/cram_io.c:1686,1821 fqz_compress/fqz_decompress), as host
Python.

The port's own copy of the JAX package's host codec, kept byte for byte
in its arithmetic so that both packages decode the same wire.
Context-modelled adaptive range coding of quality strings per the CRAM
3.1 specification's fqzcomp section: each quality is coded under a
16-bit context mixing recent quality history, position-in-read bucket
and mismatch-run ("delta") bucket; headers carry versioned global and
per-parameter-set flags, optional quality maps and the bucket tables
(run-coded store_array form).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from htslib_tpu_torch.codecs.rangecoder import RangeDecoder, RangeEncoder, \
    SimpleModel
from htslib_tpu_torch.codecs.rans4x16 import u7_get, u7_put

GF_MULTI = 1
GF_STAB = 2
GF_REV = 4

PF_DEDUP = 2
PF_LEN = 4
PF_SEL = 8
PF_QMAP = 16
PF_PTAB = 32
PF_DTAB = 64
PF_QTAB = 128


def _store_array(out: bytearray, arr: List[int], size: int) -> None:
    i = 0
    v = 0
    while i < size:
        r = 0
        while i < size and arr[i] == v:
            r += 1
            i += 1
        while True:
            b = min(r, 255)
            out.append(b)
            if b < 255:
                break
            r -= 255
        v += 1


def _read_array(buf, p: int, size: int) -> Tuple[List[int], int]:
    arr: List[int] = []
    v = 0
    while len(arr) < size:
        r = 0
        while True:
            b = buf[p]
            p += 1
            r += b
            if b != 255:
                break
        if len(arr) + r > size:
            raise ValueError("fqz: bad run array")
        arr.extend([v] * r)
        v += 1
        if v > 65535:
            raise ValueError("fqz: bad run array")
    return arr, p


def _bitlen(v: int) -> int:
    return v.bit_length()


class _Param:
    __slots__ = ("context", "pflags", "max_sym", "qbits", "qshift", "qloc",
                 "sloc", "ploc", "dloc", "qmap", "qtab", "ptab", "dtab")


def _read_param(buf, p: int) -> Tuple[_Param, int]:
    pm = _Param()
    pm.context = buf[p] | (buf[p + 1] << 8)
    pm.pflags = buf[p + 2]
    pm.max_sym = buf[p + 3]
    b = buf[p + 4]
    pm.qbits, pm.qshift = b >> 4, b & 15
    b = buf[p + 5]
    pm.qloc, pm.sloc = b >> 4, b & 15
    b = buf[p + 6]
    pm.ploc, pm.dloc = b >> 4, b & 15
    p += 7
    pm.qmap = list(range(256))
    pm.qtab = list(range(256))
    pm.ptab = [0] * 1024
    pm.dtab = [0] * 256
    if pm.pflags & PF_QMAP:
        n = pm.max_sym or 256
        pm.qmap = list(buf[p:p + n]) + list(range(n, 256))
        p += n
    if pm.pflags & PF_QTAB:
        pm.qtab, p = _read_array(buf, p, 256)
    if pm.pflags & PF_PTAB:
        pm.ptab, p = _read_array(buf, p, 1024)
    if pm.pflags & PF_DTAB:
        pm.dtab, p = _read_array(buf, p, 256)
    return pm, p


def compress(data: bytes, lens: Optional[List[int]] = None) -> bytes:
    """Compress concatenated quality strings.  `lens` gives per-record
    lengths (one record covering everything when omitted)."""
    if lens is None:
        lens = [len(data)] if data else []
    out = bytearray()
    u7_put(out, len(data))
    out.append(5)       # vers
    out.append(0)       # gflags

    seen = sorted(set(data))
    use_qmap = 0 < len(seen) <= 16
    if use_qmap:
        code_of = {q: i for i, q in enumerate(seen)}
        max_sym = len(seen)
        n_codes = len(seen)
    else:
        code_of = {q: q for q in range(256)}
        maxq = seen[-1] if seen else 0
        max_sym = (maxq + 1) & 0xFF
        n_codes = maxq + 1 if data else 1
    pflags = PF_LEN | PF_PTAB | PF_DTAB | (PF_QMAP if use_qmap else 0)
    qbits, qshift, qloc = 13, 6, 0
    sloc, ploc, dloc = 15, 12, 13
    ptab = [min(15, _bitlen(i)) for i in range(1024)]
    dtab = [min(7, _bitlen(i)) for i in range(256)]

    out += bytes([0, 0])            # context u16le
    out.append(pflags)
    out.append(max_sym)
    out.append((qbits << 4) | qshift)
    out.append((qloc << 4) | sloc)
    out.append((ploc << 4) | dloc)
    if use_qmap:
        out += bytes(seen)
    _store_array(out, ptab, 1024)
    _store_array(out, dtab, 256)

    nsym_model = min(n_codes + 1, 256)
    rc = RangeEncoder()
    len_m = [SimpleModel(256) for _ in range(4)]
    quals = {}
    qmask = (1 << qbits) - 1
    pos = 0
    for rlen in lens:
        rlen = min(rlen, len(data) - pos)
        len_m[0].encode(rc, rlen & 0xFF)
        len_m[1].encode(rc, (rlen >> 8) & 0xFF)
        len_m[2].encode(rc, (rlen >> 16) & 0xFF)
        len_m[3].encode(rc, (rlen >> 24) & 0xFF)
        qhist = 0
        delta = 0
        last = 0
        prevq = 0
        for j in range(rlen):
            Q = code_of[data[pos + j]]
            m = quals.get(last)
            if m is None:
                m = quals[last] = SimpleModel(nsym_model)
            m.encode(rc, Q)
            qhist = (qhist << qshift) + Q      # qtab identity
            last = (qhist & qmask) << qloc
            last |= ptab[min(j + 1, 1023)] << ploc
            last |= dtab[min(delta, 255)] << dloc
            last &= 0xFFFF
            delta = min(255, delta + (1 if prevq != Q else 0))
            prevq = Q
        pos += rlen
        if pos >= len(data):
            break
    out += rc.finish()
    return bytes(out)


def decompress(buf: bytes) -> bytes:
    total, p = u7_get(buf, 0)
    if buf[p] != 5:
        raise ValueError("fqz: bad version")
    p += 1
    gflags = buf[p]
    p += 1
    nparam = 1
    if gflags & GF_MULTI:
        nparam = buf[p]
        p += 1
    stab = [0] * 256
    max_sel = 0
    if gflags & GF_STAB:
        max_sel = buf[p]
        p += 1
        stab, p = _read_array(buf, p, 256)
    pms = []
    for _ in range(nparam):
        pm, p = _read_param(buf, p)
        pms.append(pm)

    nsym_model = min(256, max((pm.max_sym or 256) + 1 for pm in pms))
    rc = RangeDecoder(buf, p)
    len_m = [SimpleModel(256) for _ in range(4)]
    rev_m = SimpleModel(2)
    dup_m = SimpleModel(2)
    sel_m = SimpleModel(max_sel + 1)
    quals = {}
    out = bytearray()
    prev_start = 0
    prev_len = 0
    first = True
    while len(out) < total:
        sel = 0
        if gflags & GF_STAB:
            sel = sel_m.decode(rc)
            pm = pms[stab[sel]] if stab[sel] < nparam else pms[0]
        else:
            pm = pms[0]
        if (pm.pflags & PF_LEN) or first:
            rlen = len_m[0].decode(rc)
            rlen |= len_m[1].decode(rc) << 8
            rlen |= len_m[2].decode(rc) << 16
            rlen |= len_m[3].decode(rc) << 24
        else:
            rlen = prev_len
        first = False
        if rlen > total - len(out):
            raise ValueError("fqz: record overruns stream")
        if gflags & GF_REV:
            rev_m.decode(rc)
        if pm.pflags & PF_DEDUP:
            if dup_m.decode(rc):
                if rlen != prev_len:
                    raise ValueError("fqz: bad dup")
                start = len(out)
                out += out[prev_start:prev_start + rlen]
                prev_start = start
                continue
        qmask = (1 << pm.qbits) - 1
        qhist = 0
        delta = 0
        last = pm.context
        prevq = 0
        start = len(out)
        for j in range(rlen):
            m = quals.get(last)
            if m is None:
                m = quals[last] = SimpleModel(nsym_model)
            Q = m.decode(rc)
            out.append(pm.qmap[Q] if pm.pflags & PF_QMAP else Q)
            qhist = (qhist << pm.qshift) + pm.qtab[Q]
            last = (qhist & qmask) << pm.qloc
            last |= pm.ptab[min(j + 1, 1023)] << pm.ploc
            last |= pm.dtab[min(delta, 255)] << pm.dloc
            if pm.pflags & PF_SEL:
                last |= sel << pm.sloc
            last &= 0xFFFF
            delta = min(255, delta + (1 if prevq != Q else 0))
            prevq = Q
        prev_start = start
        prev_len = rlen
    return bytes(out)
