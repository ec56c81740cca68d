"""Adaptive arithmetic (range) coder, the CRAM 3.1 "arith" block method
(reference call sites cram/cram_io.c:1718,1879 arith_compress_to /
arith_uncompress_to), as host Python.

The port's own copy of the JAX package's host codec, kept byte for byte
in its arithmetic so that both packages decode the same wire.  Layout:
order byte (0x01 ORDER1, 0x08 STRIPE, 0x10 NOSZ, 0x20 CAT, 0x40 RLE,
0x80 PACK — the rANS Nx16 vocabulary), optional uint7 length, the shared
PACK/RLE/STRIPE transforms, then a byte giving the adaptive-model symbol
count and the range-coded payload (order-0: one model; order-1: a model
per preceding byte).
"""
from __future__ import annotations

from typing import Tuple

from htslib_tpu_torch.codecs.rangecoder import RangeDecoder, RangeEncoder, \
    SimpleModel
from htslib_tpu_torch.codecs.rans4x16 import (O_CAT, O_NOSZ, O_ORDER1,
                                              O_PACK, O_RLE, O_STRIPE, _pack,
                                              _rle_decode, _rle_encode,
                                              _unpack, u7_get, u7_put)


def _enc_core(data: bytes, order1: bool) -> bytes:
    nsym = (max(data) + 1) if data else 1
    out = bytearray([nsym & 0xFF])          # 0 => 256
    rc = RangeEncoder()
    if order1:
        models = {}
        ctx = 0
        for b in data:
            m = models.get(ctx)
            if m is None:
                m = models[ctx] = SimpleModel(nsym)
            m.encode(rc, b)
            ctx = b
    else:
        m = SimpleModel(nsym)
        for b in data:
            m.encode(rc, b)
    out += rc.finish()
    return bytes(out)


def _dec_core(buf, p: int, order1: bool, n_out: int) -> Tuple[bytes, int]:
    nsym = buf[p]
    p += 1
    if nsym == 0:
        nsym = 256
    rc = RangeDecoder(buf, p)
    out = bytearray()
    if order1:
        models = {}
        ctx = 0
        for _ in range(n_out):
            m = models.get(ctx)
            if m is None:
                m = models[ctx] = SimpleModel(nsym)
            s = m.decode(rc)
            out.append(s)
            ctx = s
    else:
        m = SimpleModel(nsym)
        for _ in range(n_out):
            out.append(m.decode(rc))
    return bytes(out), rc.p


def compress(data: bytes, order: int = 0) -> bytes:
    if order & O_PACK and len(set(data)) > 16:
        order &= ~O_PACK
    if order & O_RLE and not data:
        order &= ~O_RLE
    out = bytearray([order & 0xFF])
    if not order & O_NOSZ:
        u7_put(out, len(data))
    if order & O_CAT:
        out += data
        return bytes(out)
    if order & O_STRIPE:
        N = 4
        out.append(N)
        subs = [compress(data[j::N], (order & O_ORDER1) | O_NOSZ)
                for j in range(N)]
        for s in subs:
            u7_put(out, len(s))
        for s in subs:
            out += s
        return bytes(out)
    payload = data
    if order & O_PACK:
        meta, payload = _pack(payload)
        out += meta
        u7_put(out, len(payload))
    if order & O_RLE:
        meta, payload = _rle_encode(payload)
        u7_put(out, len(meta))
        out += meta
        u7_put(out, len(payload))
    if payload:
        out += _enc_core(payload, bool(order & O_ORDER1))
    return bytes(out)


def uncompress(buf: bytes, expected_len: int = -1) -> bytes:
    data, _ = _uncompress_at(memoryview(buf), 0, expected_len)
    return data


def _uncompress_at(buf, p: int, expected_len: int = -1) -> Tuple[bytes, int]:
    order = buf[p]
    p += 1
    if order & O_NOSZ:
        ulen = expected_len
        if ulen < 0:
            raise ValueError("NOSZ stream needs an expected length")
    else:
        ulen, p = u7_get(buf, p)
    if order & O_CAT:
        return bytes(buf[p:p + ulen]), p + ulen
    if order & O_STRIPE:
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
            parts.append(part)
            p += lens[j]
        out = bytearray(ulen)
        for j in range(N):
            out[j::N] = parts[j]
        return bytes(out), p
    pack_meta_at = -1
    n_core = ulen
    plen = 0
    if order & O_PACK:
        pack_meta_at = p
        P = buf[p]
        p += 1 + P
        plen, p = u7_get(buf, p)
        n_core = plen
    rle_meta = None
    if order & O_RLE:
        mlen, p = u7_get(buf, p)
        rle_meta = bytes(buf[p:p + mlen])
        p += mlen
        llen, p = u7_get(buf, p)
        n_core = llen
    if n_core == 0:
        payload = b""
    else:
        payload, p = _dec_core(buf, p, bool(order & O_ORDER1), n_core)
    if order & O_RLE:
        payload = _rle_decode(memoryview(rle_meta), 0, payload,
                              plen if order & O_PACK else ulen)
    if order & O_PACK:
        payload, _ = _unpack(buf, pack_meta_at, payload, ulen)
    return payload, p
