"""BGZF on the host: the port's copy of what it needs of
htslib_tpu/bgzf.py (reference bgzf.c, htslib/bgzf.h).

A BGZF file is a run of gzip members, each one raw DEFLATE stream of at
most 64 KiB of data with its compressed size in a "BC" extra subfield
(bgzf.c:70-90), and an empty member at the end (BGZF_EOF).  This module
writes members (`compress_block`, `bgzf_member`, `BgzfWriter`) and walks
their sizes (`scan_blocks`); the port inflates their payloads on the
device (ops/inflate.py).  It holds no seekable reader.
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import BinaryIO, List, Union

import numpy as np

BGZF_BLOCK_SIZE = 0xFF00        # htslib/bgzf.h:50
BGZF_MAX_BLOCK_SIZE = 0x10000   # htslib/bgzf.h:51
BLOCK_HEADER_LENGTH = 18
BLOCK_FOOTER_LENGTH = 8

# the 28-byte empty member that ends a file (bgzf.c:1542 checks for it)
BGZF_EOF = bytes([
    0x1F, 0x8B, 0x08, 0x04, 0x00, 0x00, 0x00, 0x00, 0x00, 0xFF, 0x06, 0x00,
    0x42, 0x43, 0x02, 0x00, 0x1B, 0x00, 0x03, 0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00,
])

_HEADER_STRUCT = struct.Struct("<BBBBIBBHBBHH")  # magic..bsize


def bgzf_member(deflated: bytes, data: bytes) -> bytes:
    """A whole BGZF member around `deflated`, the raw DEFLATE stream of
    `data`: the 18-byte header with its BC subfield, then the CRC32 and
    ISIZE of `data`."""
    total = len(deflated) + BLOCK_HEADER_LENGTH + BLOCK_FOOTER_LENGTH
    if total > BGZF_MAX_BLOCK_SIZE:
        raise ValueError("BGZF block does not fit after compression")
    head = _HEADER_STRUCT.pack(0x1F, 0x8B, 0x08, 0x04, 0, 0, 0xFF, 6, 0x42,
                               0x43, 2, total - 1)
    return (head + deflated
            + struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF,
                          len(data) & 0xFFFFFFFF))


def compress_block(data: bytes, level: int = -1) -> bytes:
    """One <= 64 KiB chunk as a whole BGZF member (bgzf_compress,
    bgzf.c:561-720); level -1 is zlib's 6, level 0 stored blocks."""
    co = zlib.compressobj(6 if level == -1 else level, zlib.DEFLATED, -15)
    return bgzf_member(co.compress(data) + co.flush(), data)


def parse_block_header(hdr: bytes) -> int:
    """The whole size (BSIZE + 1) of the member starting at hdr; raises
    ValueError on a header that is not BGZF's (bgzf.c:949-1002)."""
    if len(hdr) < BLOCK_HEADER_LENGTH:
        raise ValueError("truncated BGZF header")
    if hdr[0] != 0x1F or hdr[1] != 0x8B or not (hdr[3] & 4):
        raise ValueError("invalid BGZF magic")
    xlen = hdr[10] | (hdr[11] << 8)
    pos, end = 12, 12 + xlen
    while pos + 4 <= min(end, len(hdr)):
        si1, si2 = hdr[pos], hdr[pos + 1]
        slen = hdr[pos + 2] | (hdr[pos + 3] << 8)
        if si1 == 0x42 and si2 == 0x43 and slen == 2:
            if pos + 6 > len(hdr):
                raise ValueError("truncated BC subfield")
            return (hdr[pos + 4] | (hdr[pos + 5] << 8)) + 1
        pos += 4 + slen
    raise ValueError("no BC subfield: not BGZF")


@dataclass
class BlockTable:
    """Each member of a BGZF byte range: compressed offset (uint64),
    whole size (uint32) and ISIZE (uint32)."""
    coffsets: np.ndarray
    csizes: np.ndarray
    usizes: np.ndarray

    @property
    def n(self) -> int:
        return len(self.coffsets)


def scan_blocks(data: Union[bytes, memoryview, np.ndarray],
                base_offset: int = 0) -> BlockTable:
    """Walk the BSIZE hops over an in-memory BGZF byte range; raises
    IOError on a truncated member or bytes after the last one."""
    buf = memoryview(np.ascontiguousarray(
        np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray)
        else data, np.uint8))
    coffs: List[int] = []
    csz: List[int] = []
    usz: List[int] = []
    pos, n = 0, len(buf)
    while pos + BLOCK_HEADER_LENGTH <= n:
        total = parse_block_header(bytes(buf[pos:pos + BLOCK_HEADER_LENGTH]))
        if pos + total > n:
            raise IOError("truncated BGZF block")
        coffs.append(base_offset + pos)
        csz.append(total)
        usz.append(int.from_bytes(buf[pos + total - 4:pos + total],
                                  "little"))
        pos += total
    if pos != n:
        raise IOError("trailing garbage after BGZF blocks")
    return BlockTable(np.array(coffs, np.uint64), np.array(csz, np.uint32),
                      np.array(usz, np.uint32))


def member_payload(raw: np.ndarray, coffset: int, csize: int) -> bytes:
    """The raw DEFLATE stream of the member at `coffset` of file bytes
    `raw` (what the device inflate takes): the member less its header,
    extra field and footer."""
    at = int(coffset)
    xlen = int(raw[at + 10]) | (int(raw[at + 11]) << 8)
    return raw[at + 12 + xlen:at + int(csize) - BLOCK_FOOTER_LENGTH].tobytes()


def inflate_host(raw: np.ndarray, table: BlockTable) -> bytes:
    """The members of `table` inflated on the host by zlib, each CRC32 and
    ISIZE checked (bgzf_uncompress, bgzf.c:730-806), concatenated."""
    out = []
    for co, cs, us in zip(table.coffsets, table.csizes, table.usizes):
        data = zlib.decompress(member_payload(raw, co, cs), -15,
                               BGZF_MAX_BLOCK_SIZE)
        check_member(raw, int(co), int(cs), data)
        out.append(data)
    return b"".join(out)


def check_member(raw: np.ndarray, coffset: int, csize: int,
                 data: bytes) -> None:
    """Raise IOError unless `data` has the CRC32 and ISIZE that the
    footer of the member at `coffset` states."""
    crc, isize = struct.unpack_from(
        "<II", raw[coffset + csize - BLOCK_FOOTER_LENGTH:coffset + csize]
        .tobytes())
    if len(data) != isize:
        raise IOError("BGZF ISIZE mismatch")
    if zlib.crc32(data) & 0xFFFFFFFF != crc:
        raise IOError("BGZF CRC32 mismatch")


class BgzfWriter:
    """Buffers what is written and emits one member for each
    BGZF_BLOCK_SIZE bytes, as bgzf_write does; `flush` ends the current
    member early, `close` flushes and appends BGZF_EOF."""

    def __init__(self, dst: Union[str, BinaryIO], level: int = -1):
        self._own = isinstance(dst, str)
        self._fp = open(dst, "wb") if self._own else dst
        self._level = level
        self._buf = bytearray()

    def write(self, data: bytes) -> int:
        self._buf += data
        while len(self._buf) >= BGZF_BLOCK_SIZE:
            self._fp.write(compress_block(bytes(self._buf[:BGZF_BLOCK_SIZE]),
                                          self._level))
            del self._buf[:BGZF_BLOCK_SIZE]
        return len(data)

    def flush(self) -> None:
        if self._buf:
            self._fp.write(compress_block(bytes(self._buf), self._level))
            self._buf.clear()

    def close(self) -> None:
        self.flush()
        self._fp.write(BGZF_EOF)
        if self._own:
            self._fp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
