"""CRAM 4.0 varints and the version-dispatched varint vtable.

CRAM 4.0 replaces ITF8/LTF8 with size-agnostic base-128 varints
(htscodecs varint.h uint7, used via the vtable cram_fd.vv — reference
cram/cram_structs.h:753-781 varint_vec, cram/cram_io.c:768-1004 uint7_*
wrappers, vtable selection cram_init_varint cram_io.c:5127).

Wire format (var_put_u64): most-significant 7-bit groups first, the top
bit of every byte except the last is set.  Signed values use the zigzag
transform ((v << 1) ^ (v >> 63)) before the unsigned encoding.
"""
from __future__ import annotations

from typing import Tuple

from htslib_tpu_torch.cram.itf8 import (itf8_decode, itf8_encode,
                                        ltf8_decode, ltf8_encode)

__all__ = ["u7_decode", "u7_encode", "s7_decode", "s7_encode", "VarintVec",
           "varint_vec"]


def u7_decode(buf, p: int) -> Tuple[int, int]:
    """var_get_u64: returns (value, new_offset)."""
    v = 0
    n = len(buf)
    while p < n:
        c = buf[p]
        p += 1
        v = (v << 7) | (c & 0x7F)
        if not (c & 0x80):
            return v, p
    raise IOError("truncated uint7 varint")


def u7_encode(v: int) -> bytes:
    """var_put_u64."""
    if v < 0:
        v &= (1 << 64) - 1
    out = bytearray()
    s = 0
    x = v >> 7
    while x:
        s += 7
        x >>= 7
    while s:
        out.append(((v >> s) & 0x7F) | 0x80)
        s -= 7
    out.append(v & 0x7F)
    return bytes(out)


def s7_decode(buf, p: int) -> Tuple[int, int]:
    """var_get_s64: zigzag-decoded signed varint."""
    u, p = u7_decode(buf, p)
    return (u >> 1) ^ -(u & 1), p


def s7_encode(v: int) -> bytes:
    """var_put_s64: zigzag then unsigned."""
    return u7_encode(((v << 1) ^ (v >> 63)) & ((1 << 64) - 1))


class VarintVec:
    """Version-dispatched varint codec (the cram_fd.vv equivalent).

    For CRAM <4 the 32-bit routines are ITF8 (inherently wrapping
    negatives through 32 bits) and the 64-bit ones LTF8; for CRAM >=4
    all are uint7/sint7.
    """

    __slots__ = ("v4",)

    def __init__(self, vmajor: int):
        self.v4 = vmajor >= 4

    # decode: (value, new_offset)
    def get32(self, buf, p):
        return u7_decode(buf, p) if self.v4 else itf8_decode(buf, p)

    def get32s(self, buf, p):
        return s7_decode(buf, p) if self.v4 else itf8_decode(buf, p)

    def get64(self, buf, p):
        return u7_decode(buf, p) if self.v4 else ltf8_decode(buf, p)

    def get64s(self, buf, p):
        return s7_decode(buf, p) if self.v4 else ltf8_decode(buf, p)

    # encode
    def put32(self, v) -> bytes:
        return u7_encode(v) if self.v4 else itf8_encode(v)

    def put32s(self, v) -> bytes:
        return s7_encode(v) if self.v4 else itf8_encode(v)

    def put64(self, v) -> bytes:
        return u7_encode(v) if self.v4 else ltf8_encode(v)

    def put64s(self, v) -> bytes:
        return s7_encode(v) if self.v4 else ltf8_encode(v)


_VV_CACHE = {}


def varint_vec(vmajor: int) -> VarintVec:
    vv = _VV_CACHE.get(vmajor >= 4)
    if vv is None:
        vv = _VV_CACHE[vmajor >= 4] = VarintVec(vmajor)
    return vv
