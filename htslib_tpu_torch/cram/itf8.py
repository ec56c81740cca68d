"""CRAM variable-length integers (reference cram/cram_io.c:138-1004).

ITF8: up to 5 bytes, leading-ones prefix in the first byte gives the byte
count; LTF8: 64-bit variant up to 9 bytes.  (CRAM v4's uint7 is in
htslib_tpu_torch.cram.v4.)
"""
from __future__ import annotations

from typing import Tuple


def itf8_decode(buf, p: int) -> Tuple[int, int]:
    """Return (value, new_offset)."""
    b0 = buf[p]
    if b0 < 0x80:
        return b0, p + 1
    if b0 < 0xC0:
        return ((b0 & 0x3F) << 8) | buf[p + 1], p + 2
    if b0 < 0xE0:
        return ((b0 & 0x1F) << 16) | (buf[p + 1] << 8) | buf[p + 2], p + 3
    if b0 < 0xF0:
        return (((b0 & 0x0F) << 24) | (buf[p + 1] << 16)
                | (buf[p + 2] << 8) | buf[p + 3]), p + 4
    val = (((b0 & 0x0F) << 28) | (buf[p + 1] << 20) | (buf[p + 2] << 12)
           | (buf[p + 3] << 4) | (buf[p + 4] & 0x0F))
    # sign: ITF8 is a 32-bit signed int
    if val >= 1 << 31:
        val -= 1 << 32
    return val, p + 5


def itf8_encode(val: int) -> bytes:
    v = val & 0xFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF, (v >> 8) & 0xFF,
                      v & 0xFF])
    return bytes([0xF0 | ((v >> 28) & 0x0F), (v >> 20) & 0xFF,
                  (v >> 12) & 0xFF, (v >> 4) & 0xFF, v & 0x0F])


def ltf8_decode(buf, p: int) -> Tuple[int, int]:
    b0 = buf[p]
    if b0 < 0x80:
        return b0, p + 1
    if b0 < 0xC0:
        return ((b0 & 0x7F) << 8) | buf[p + 1], p + 2
    if b0 < 0xE0:
        return ((b0 & 0x3F) << 16) | (buf[p + 1] << 8) | buf[p + 2], p + 3
    if b0 < 0xF0:
        return (((b0 & 0x1F) << 24) | (buf[p + 1] << 16) | (buf[p + 2] << 8)
                | buf[p + 3]), p + 4
    if b0 < 0xF8:
        v = ((b0 & 0x0F) << 32) | int.from_bytes(bytes(buf[p + 1:p + 5]), "big")
        return v, p + 5
    if b0 < 0xFC:
        v = ((b0 & 0x07) << 40) | int.from_bytes(bytes(buf[p + 1:p + 6]), "big")
        return v, p + 6
    if b0 < 0xFE:
        v = ((b0 & 0x03) << 48) | int.from_bytes(bytes(buf[p + 1:p + 7]), "big")
        return v, p + 7
    if b0 < 0xFF:
        v = int.from_bytes(bytes(buf[p + 1:p + 8]), "big")
        return v, p + 8
    v = int.from_bytes(bytes(buf[p + 1:p + 9]), "big")
    if v >= 1 << 63:
        v -= 1 << 64
    return v, p + 9


def ltf8_encode(val: int) -> bytes:
    v = val & 0xFFFFFFFFFFFFFFFF
    if v < (1 << 7):
        return bytes([v])
    if v < (1 << 14):
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < (1 << 21):
        return bytes([0xC0 | (v >> 16)]) + v.to_bytes(3, "big")[1:]
    if v < (1 << 28):
        return bytes([0xE0 | (v >> 24)]) + v.to_bytes(4, "big")[1:]
    if v < (1 << 35):
        return bytes([0xF0 | (v >> 32)]) + v.to_bytes(5, "big")[1:]
    if v < (1 << 42):
        return bytes([0xF8 | (v >> 40)]) + v.to_bytes(6, "big")[1:]
    if v < (1 << 49):
        return bytes([0xFC | (v >> 48)]) + v.to_bytes(7, "big")[1:]
    if v < 0x100000000000000:
        return bytes([0xFE]) + v.to_bytes(8, "big")[1:]
    return bytes([0xFF]) + v.to_bytes(8, "big")
