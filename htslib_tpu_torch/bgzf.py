"""BGZF on the host: the port's copy of what it needs of
htslib_tpu/bgzf.py (reference bgzf.c, htslib/bgzf.h).

A BGZF file is a run of gzip members, each one raw DEFLATE stream of at
most 64 KiB of data with its compressed size in a "BC" extra subfield
(bgzf.c:70-90), and an empty member at the end (BGZF_EOF).  This module
writes members (`compress_block`, `bgzf_member`, `deflate_blocks`,
`BgzfWriter`), walks their sizes (`scan_blocks`), reads BGZF, plain gzip
or uncompressed input as a stream with virtual offsets (`BgzfReader`,
on the host), maps uncompressed offsets to members through a `.gzi`
index (`GziIndex`, `BgzfReader.useek`, `BgzfWriter.save_index`), and
inflates members on the device (ops/inflate.py, kernel X4 on the card):
those that cover a range of a file's uncompressed stream
(`inflate_range`), or every member of a byte range (`inflate_blocks`).
`BGZFReader` and `BGZFWriter` are the JAX package's names for the reader
and writer.  A file is a name that hfile.py `hopen` opens (a local path,
`-`, or a URL such as http://, s3:// or an htsget ticket) or a binary
file object.

As in the JAX package, the host's member deflate (`compress_block`,
`deflate_blocks`), member walk (`scan_blocks`) and inflate (`inflate_host`,
`BgzfReader.read_all`) go to the native library (libdeflate) unless
`htslib_tpu_torch.native.native` is None, where zlib and a Python walk
do them.  libdeflate writes other bytes than zlib for the same members'
data; the device inflate (`inflate_blocks`, `inflate_range`) stays on the
device.
"""
from __future__ import annotations

import bisect
import io
import os
import struct
import zlib
from dataclasses import dataclass
from typing import BinaryIO, List, Optional, Tuple, Union

import numpy as np

from htslib_tpu_torch import _build
from htslib_tpu_torch.hfile import hfile_scheme, hopen
from htslib_tpu_torch.ops.inflate import inflate_batch

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
    bgzf.c:561-720): the native deflate, or `_compress_block_py`."""
    from htslib_tpu_torch.native import native
    if native is not None:
        return native.deflate_blocks([data], level)[0]
    return _compress_block_py(data, level)


def _compress_block_py(data: bytes, level: int = -1) -> bytes:
    """A member deflated by zlib (the JAX package's pure path): level -1
    is zlib's 6, level 0 stored blocks."""
    co = zlib.compressobj(6 if level == -1 else level, zlib.DEFLATED, -15)
    return bgzf_member(co.compress(data) + co.flush(), data)


def deflate_blocks(chunks: List[bytes], level: int = -1) -> List[bytes]:
    """N independent chunks as N BGZF members (the batch form of the MT
    write queue, bgzf.c:1852): one native call over the batch, or zlib a
    member at a time."""
    from htslib_tpu_torch.native import native
    if native is not None:
        return native.deflate_blocks(chunks, level)
    return [_compress_block_py(c, level) for c in chunks]


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

    @property
    def uoffsets(self) -> np.ndarray:
        """Each member's uncompressed start offset (uint64)."""
        out = np.zeros(self.n, dtype=np.uint64)
        np.cumsum(self.usizes[:-1], dtype=np.uint64, out=out[1:])
        return out

    @property
    def total_usize(self) -> int:
        return int(self.usizes.sum(dtype=np.uint64))


def scan_blocks(data: Union[bytes, memoryview, np.ndarray],
                base_offset: int = 0) -> BlockTable:
    """Walk the BSIZE hops over an in-memory BGZF byte range (the native
    scan where the library is on); raises IOError on a truncated member
    or bytes after the last one."""
    from htslib_tpu_torch.native import native
    arr = (np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray)
           else data)
    if native is not None:
        co, cs, us = native.bgzf_scan(arr)
        return BlockTable(co + np.uint64(base_offset), cs, us)
    buf = memoryview(np.ascontiguousarray(arr, np.uint8))
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
    """The members of `table` inflated on the host, each CRC32 and ISIZE
    checked (bgzf_uncompress, bgzf.c:730-806), concatenated: in one
    native call (libdeflate, threads), or by zlib a member at a time."""
    from htslib_tpu_torch.native import native
    if native is not None:
        return native.inflate_batch(raw, table.coffsets, table.csizes,
                                    table.usizes).tobytes()
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


def inflate_blocks(data: Union[bytes, memoryview, np.ndarray],
                   table: Optional[BlockTable] = None, base_offset: int = 0,
                   verify_crc: bool = True, device="cuda"
                   ) -> Tuple[np.ndarray, BlockTable]:
    """A whole BGZF byte range inflated to one contiguous uint8 array
    (the batch form of looping bgzf_read_block, bgzf.c:1004).  `table`
    (from `scan_blocks`, offsets counted from `base_offset`) is scanned
    when not given.  Every member is inflated in one `inflate_batch` call
    on `device` (kernel X4 on the card, its plain version on the CPU);
    each ISIZE is checked, and with `verify_crc` each CRC32 too, on the
    host.  Returns (uncompressed bytes, block table)."""
    dev = _build.resolve_device(device)
    buf = (data if isinstance(data, np.ndarray)
           else np.frombuffer(data, np.uint8))
    if table is None:
        table = scan_blocks(buf, base_offset)
    co = table.coffsets.astype(np.int64) - base_offset
    pieces = inflate_batch([member_payload(buf, o, s)
                            for o, s in zip(co, table.csizes)],
                           [int(u) for u in table.usizes], device=dev)
    for o, s, u, piece in zip(co, table.csizes, table.usizes, pieces):
        if verify_crc:
            check_member(buf, int(o), int(s), piece)
        elif len(piece) != int(u):
            raise IOError("BGZF ISIZE mismatch")
    out = np.frombuffer(b"".join(pieces), np.uint8)
    return out, table


def inflate_range(src: Union[str, np.ndarray], coffsets: np.ndarray,
                  csizes: np.ndarray, ustarts: np.ndarray,
                  usizes: np.ndarray, u0: int, u1: int, device="cuda",
                  timing: Optional[dict] = None) -> bytes:
    """Bytes [u0, u1) of a BGZF file's uncompressed stream.  `src` is the
    file's path or its bytes (uint8); the members (compressed offset,
    whole size, uncompressed start and ISIZE of each) are those of
    `scan_blocks`.  Only the members that cover the range are read, and
    they are inflated in one `inflate_batch` call on `device` (kernel X4
    on the card, its plain version on the CPU), each CRC32 and ISIZE
    checked on the host.  A file with no members (an uncompressed one) is
    its own stream: its bytes [u0, u1) are read and nothing is launched.
    `timing`, where given, gets read_s (the file's bytes) and inflate_s
    (the call and the checks) added."""
    dev = _build.resolve_device(device)
    if u1 <= u0:
        return b""
    t0 = _build.clock(dev)
    if len(coffsets) == 0:
        out = _file_bytes(src, u0, u1 - u0).tobytes()
        _add(timing, "read_s", _build.clock(dev) - t0)
        return out
    b_lo = max(int(np.searchsorted(ustarts, u0, side="right")) - 1, 0)
    b_hi = max(int(np.searchsorted(ustarts, u1, side="left")), b_lo + 1)
    first = int(coffsets[b_lo])
    co = coffsets[b_lo:b_hi].astype(np.int64) - first
    cs = csizes[b_lo:b_hi].astype(np.int64)
    raw = _file_bytes(src, first, int(co[-1] + cs[-1]))
    t1 = _build.clock(dev)
    pieces = inflate_batch([member_payload(raw, o, s) for o, s in zip(co, cs)],
                           [int(u) for u in usizes[b_lo:b_hi]], device=dev)
    for o, s, piece in zip(co, cs, pieces):
        check_member(raw, int(o), int(s), piece)
    base = int(ustarts[b_lo])
    out = b"".join(pieces)[u0 - base:u1 - base]
    _add(timing, "read_s", t1 - t0)
    _add(timing, "inflate_s", _build.clock(dev) - t1)
    return out


def _file_bytes(src: Union[str, np.ndarray], offset: int,
                count: int) -> np.ndarray:
    if isinstance(src, np.ndarray):
        return src[offset:offset + count]
    if hfile_scheme(src):
        with hopen(src, "rb") as fp:
            fp.seek(offset)
            return np.frombuffer(fp.read(count), np.uint8)
    return np.fromfile(src, np.uint8, count=count, offset=offset)


def read_file(src: Union[str, os.PathLike, BinaryIO]) -> np.ndarray:
    """The whole of a file as uint8: a local path read at once, a URL
    through one `hopen` stream (one request for http), a binary file
    object from its position to its end."""
    if isinstance(src, (str, os.PathLike)):
        return _file_bytes(os.fspath(src), 0, -1)
    return np.frombuffer(src.read(-1), np.uint8)


def _add(timing: Optional[dict], key: str, seconds: float) -> None:
    if timing is not None:
        timing[key] = timing.get(key, 0.0) + seconds


# ---------------------------------------------------------------------------
# .gzi index (bgzidx_t, bgzf.c:162-270)
# ---------------------------------------------------------------------------

class GziIndex:
    """Maps uncompressed offsets to the members that hold them.

    On disk: a u64 count, then count x (u64 compressed offset, u64
    uncompressed offset), the first member's (0, 0) entry left implicit
    (bgzf_index_dump, bgzf.c:2394-2440)."""

    def __init__(self, coffsets: Optional[np.ndarray] = None,
                 uoffsets: Optional[np.ndarray] = None):
        self.coffsets = (coffsets if coffsets is not None
                         else np.zeros(1, np.uint64))
        self.uoffsets = (uoffsets if uoffsets is not None
                         else np.zeros(1, np.uint64))

    @classmethod
    def from_table(cls, table: BlockTable) -> "GziIndex":
        """An entry at each member's start, the first one's included."""
        return cls(table.coffsets.astype(np.uint64),
                   table.uoffsets.astype(np.uint64))

    @classmethod
    def load(cls, fname: str) -> "GziIndex":
        with hopen(fname, "rb") as fp:
            raw = fp.read(-1)
        (n,) = struct.unpack_from("<Q", raw, 0)
        if len(raw) < 8 + 16 * n:
            raise IOError(f"truncated .gzi index {fname}")
        arr = np.frombuffer(raw, dtype="<u8", offset=8,
                            count=2 * n).reshape(n, 2)
        co = np.concatenate([[0], arr[:, 0]]).astype(np.uint64)
        uo = np.concatenate([[0], arr[:, 1]]).astype(np.uint64)
        return cls(co, uo)

    def save(self, fname: str) -> None:
        co, uo = self.coffsets, self.uoffsets
        if len(co) and co[0] == 0 and uo[0] == 0:
            co, uo = co[1:], uo[1:]
        arr = np.empty((len(co), 2), dtype="<u8")
        arr[:, 0] = co
        arr[:, 1] = uo
        with open(fname, "wb") as f:
            f.write(struct.pack("<Q", len(co)))
            f.write(arr.tobytes())

    def query(self, uoffset: int) -> Tuple[int, int]:
        """(compressed offset, uncompressed start) of the member that
        holds uncompressed offset `uoffset` (bgzf_useek, bgzf.c:2288)."""
        i = max(int(np.searchsorted(self.uoffsets, uoffset,
                                    side="right")) - 1, 0)
        return int(self.coffsets[i]), int(self.uoffsets[i])


# ---------------------------------------------------------------------------
# Streaming reader and writer
# ---------------------------------------------------------------------------

def make_virtual_offset(coffset: int, uoffset: int) -> int:
    return (coffset << 16) | uoffset


def split_virtual_offset(voffset: int) -> Tuple[int, int]:
    return voffset >> 16, voffset & 0xFFFF


def decompress_block(comp: bytes) -> bytes:
    """Inflate one whole BGZF member on the host, its CRC32 and ISIZE
    checked (bgzf_uncompress, bgzf.c:730-806)."""
    total = parse_block_header(comp)
    raw = np.frombuffer(comp, np.uint8)
    data = zlib.decompress(member_payload(raw, 0, total), -15,
                           BGZF_MAX_BLOCK_SIZE)
    check_member(raw, 0, total, data)
    return data


class BgzfReader:
    """Streaming BGZF (or plain gzip, or uncompressed) reader with
    virtual-offset seek/tell (bgzf_seek/bgzf_tell, bgzf.c:2175-2258), over
    a name that `hopen` opens, an `HFile` or a binary file object; the
    JAX package's `BGZFReader`, its members inflated on the host: by
    zlib a member at a time, and the rest of a stream at once by
    `inflate_host` (`read_all`).  It reads a stream in order and seeks only where asked, so a stream
    that cannot seek back (standard input, a multipart ticket) reads
    through."""

    def __init__(self, src: Union[str, os.PathLike, BinaryIO],
                 cache_blocks: int = 8):
        if isinstance(src, (str, os.PathLike)):
            self.name = os.fspath(src)
            self._fp = hopen(self.name, "rb")
        else:
            self._fp = src if hasattr(src, "peek") else io.BufferedReader(src)
            self.name = getattr(src, "name", "?")
        head = self._fp.peek(BLOCK_HEADER_LENGTH)
        self.is_gzip = len(head) >= 2 and head[0] == 0x1F and head[1] == 0x8B
        self.is_bgzf = False
        if self.is_gzip:
            try:
                parse_block_header(head)
                self.is_bgzf = True
            except ValueError:
                self.is_bgzf = False
        self.is_compressed = self.is_gzip
        self._block: bytes = b""
        self._block_offset = 0          # within-block read position
        self._block_address = 0         # compressed offset of current block
        self._next_address = 0          # compressed offset after current block
        self._gz = None                 # plain-gzip streaming decompressor
        self._uncompressed_pos = 0
        self.idx: Optional[GziIndex] = None
        self._cache: dict = {}
        self._cache_order: List[int] = []
        self._cache_blocks = cache_blocks

    def _read_block_at(self, caddr: int) -> bool:
        """Load the block at compressed offset caddr; False at EOF."""
        if self.is_bgzf and caddr in self._cache:
            self._block, self._next_address = self._cache[caddr]
            self._block_address = caddr
            self._block_offset = 0
            # keep the file cursor in sync so a sequential read that
            # exhausts the cached block continues at the right offset
            self._fp.seek(self._next_address)
            return True
        self._fp.seek(caddr)
        return self._read_next_block()

    def _read_next_block(self) -> bool:
        caddr = self._fp.tell()
        if self.is_bgzf:
            hdr = self._fp.read(BLOCK_HEADER_LENGTH)
            if len(hdr) == 0:
                self._block = b""
                self._block_offset = 0
                self._block_address = caddr
                return False
            total = parse_block_header(hdr)
            rest = self._fp.read(total - BLOCK_HEADER_LENGTH)
            if len(rest) != total - BLOCK_HEADER_LENGTH:
                raise IOError("truncated BGZF block")
            self._block = decompress_block(hdr + rest)
            self._block_offset = 0
            self._block_address = caddr
            self._next_address = caddr + total
            # a member read again in sequence is cached once: the JAX
            # reader queues its address twice and raises KeyError when
            # it evicts the second (ROADMAP queue C)
            if self._cache_blocks and caddr not in self._cache:
                self._cache[caddr] = (self._block, self._next_address)
                self._cache_order.append(caddr)
                if len(self._cache_order) > self._cache_blocks:
                    del self._cache[self._cache_order.pop(0)]
            return True
        elif self.is_gzip:
            if self._gz is None:
                self._gz = zlib.decompressobj(wbits=31)
            chunks = []
            while True:
                raw = self._gz.unconsumed_tail or self._fp.read(1 << 16)
                if not raw:
                    if self._gz.eof and self._gz.unused_data:
                        # concatenated gzip members
                        tail = self._gz.unused_data
                        self._gz = zlib.decompressobj(wbits=31)
                        raw = tail
                    else:
                        break
                chunk = self._gz.decompress(raw, BGZF_MAX_BLOCK_SIZE)
                if chunk:
                    chunks.append(chunk)
                    break
                if self._gz.eof and not self._gz.unused_data:
                    nxt = self._fp.read(1 << 16)
                    if not nxt:
                        break
                    self._gz = zlib.decompressobj(wbits=31)
                    chunk = self._gz.decompress(nxt, BGZF_MAX_BLOCK_SIZE)
                    if chunk:
                        chunks.append(chunk)
                        break
            self._block = b"".join(chunks)
            self._block_offset = 0
            self._block_address = caddr
            return len(self._block) > 0
        else:
            self._block = self._fp.read(BGZF_MAX_BLOCK_SIZE)
            self._block_offset = 0
            self._block_address = caddr
            return len(self._block) > 0

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            chunks = []
            while True:
                c = self.read(1 << 20)
                if not c:
                    break
                chunks.append(c)
            return b"".join(chunks)
        out = bytearray()
        while n > 0:
            avail = len(self._block) - self._block_offset
            if avail == 0:
                if not self._read_next_block():
                    break
                continue
            take = min(avail, n)
            out += self._block[self._block_offset:self._block_offset + take]
            self._block_offset += take
            self._uncompressed_pos += take
            n -= take
        return bytes(out)

    def peek(self, n: int) -> bytes:
        """Up to n upcoming bytes, not consumed."""
        if len(self._block) - self._block_offset == 0:
            if not self._read_next_block():
                return b""
        return self._block[self._block_offset:self._block_offset + n]

    def readline(self, delim: bytes = b"\n") -> bytes:
        out = bytearray()
        while True:
            idx = self._block.find(delim, self._block_offset)
            if idx >= 0:
                out += self._block[self._block_offset:idx + 1]
                self._block_offset = idx + 1
                self._uncompressed_pos += len(out)
                return bytes(out)
            out += self._block[self._block_offset:]
            self._block_offset = len(self._block)
            if not self._read_next_block():
                self._uncompressed_pos += len(out)
                return bytes(out)

    def tell(self) -> int:
        """Virtual offset of the next read (bgzf_tell, htslib/bgzf.h:222);
        the uncompressed offset of a file that is not BGZF."""
        if not self.is_bgzf:
            return self._uncompressed_pos
        if self._block_offset == len(self._block) and self._block:
            return make_virtual_offset(self._next_address, 0)
        return make_virtual_offset(self._block_address, self._block_offset)

    def seek(self, voffset: int) -> None:
        """Seek to a virtual offset (bgzf_seek, bgzf.c:2175)."""
        if not self.is_bgzf:
            if self.is_gzip:
                raise IOError("cannot seek in plain gzip stream")
            self._fp.seek(voffset)
            self._block = b""
            self._block_offset = 0
            self._uncompressed_pos = voffset
            return
        caddr, uoff = split_virtual_offset(voffset)
        if not self._read_block_at(caddr):
            if uoff != 0:
                raise IOError("seek beyond EOF")
            return
        if uoff > len(self._block):
            raise IOError("invalid virtual offset (uoffset beyond block)")
        self._block_offset = uoff

    def useek(self, uoffset: int) -> None:
        """Seek to an uncompressed offset through the `.gzi` index
        (bgzf_useek, bgzf.c:2288); a file that is not compressed seeks
        directly."""
        if not self.is_compressed:
            self.seek(uoffset)
            return
        if self.idx is None:
            raise IOError("bgzf_useek needs a loaded .gzi index")
        caddr, ustart = self.idx.query(uoffset)
        if not self._read_block_at(caddr):
            raise IOError("useek beyond EOF")
        skip = uoffset - ustart
        while skip > len(self._block):
            skip -= len(self._block)
            if not self._read_next_block():
                raise IOError("useek beyond EOF")
        self._block_offset = skip
        self._uncompressed_pos = uoffset

    def utell(self) -> int:
        """The uncompressed offset of the next read."""
        return self._uncompressed_pos

    def load_index(self, fname: Optional[str] = None) -> None:
        """Load the `.gzi` index (by default the file's name + ".gzi")."""
        self.idx = GziIndex.load(fname or self.name + ".gzi")

    def check_eof(self) -> int:
        """1 if the 28-byte EOF member ends the file, 0 if it does not,
        2 if the file cannot seek, 3 if it is not BGZF (bgzf_check_EOF,
        bgzf.c:2132)."""
        if not self.is_bgzf:
            return 3
        if not self._fp.seekable():
            return 2
        pos = self._fp.tell()
        try:
            size = self._fp.seek(0, io.SEEK_END)
            if size < 28:
                return 0
            self._fp.seek(size - 28)
            return 1 if self._fp.read(28) == BGZF_EOF else 0
        finally:
            self._fp.seek(pos)

    def read_all(self) -> np.ndarray:
        """The rest of the stream as uint8: the unread tail of the current
        block, then the remaining members inflated on the host; `idx`
        becomes those members' block map."""
        if self.is_bgzf:
            tail = self._block[self._block_offset:]
            self._block_offset = len(self._block)
            start = self._fp.tell()
            raw = np.frombuffer(self._fp.read(-1), np.uint8)
            table = scan_blocks(raw)
            out = np.frombuffer(inflate_host(raw, table), np.uint8)
            self.idx = GziIndex.from_table(BlockTable(
                table.coffsets + np.uint64(start), table.csizes,
                table.usizes))
            if tail:
                out = np.concatenate([np.frombuffer(tail, np.uint8), out])
            return out
        return np.frombuffer(self.read(-1), dtype=np.uint8)

    def close(self) -> None:
        self._fp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BgzfWriter:
    """Buffers what is written and emits one member for each
    BGZF_BLOCK_SIZE bytes, as bgzf_write does (the JAX package's
    `BGZFWriter`; it deflates a member as soon as it is full, where the
    JAX writer queues up to 64 of them); `flush` ends the current member
    early, `close` flushes and appends BGZF_EOF.  `compress=False` writes
    the bytes as they come (bgzf_open's "u" mode).  `_idx_co`/`_idx_uo`
    hold each member's compressed and uncompressed end offsets after a
    (0, 0) entry, the block map that `save_index` writes as a `.gzi`."""

    def __init__(self, dst: Union[str, os.PathLike, BinaryIO],
                 level: int = -1, build_index: bool = False,
                 compress: bool = True):
        self._own = isinstance(dst, (str, os.PathLike))
        self.name = (os.fspath(dst) if self._own
                     else getattr(dst, "name", "?"))
        self._fp = hopen(self.name, "wb") if self._own else dst
        self.level = level
        self.compress = compress
        self.build_index = build_index
        self._buf = bytearray()
        self._block_address = 0         # compressed bytes written
        self._uncompressed = 0          # uncompressed bytes in them
        self._idx_co: List[int] = [0]
        self._idx_uo: List[int] = [0]
        self._closed = False

    def _emit(self, data: bytes) -> None:
        member = compress_block(data, self.level)
        self._fp.write(member)
        self._block_address += len(member)
        self._uncompressed += len(data)
        self._idx_co.append(self._block_address)
        self._idx_uo.append(self._uncompressed)

    def write(self, data: bytes) -> int:
        if not self.compress:
            self._fp.write(data)
            self._uncompressed += len(data)
            return len(data)
        self._buf += data
        while len(self._buf) >= BGZF_BLOCK_SIZE:
            self._emit(bytes(self._buf[:BGZF_BLOCK_SIZE]))
            del self._buf[:BGZF_BLOCK_SIZE]
        return len(data)

    def tell(self) -> int:
        """Virtual offset of the next write (bgzf_tell); the byte count
        when not compressing."""
        if not self.compress:
            return self._uncompressed
        return make_virtual_offset(self._block_address, len(self._buf))

    def utell(self) -> int:
        """Uncompressed bytes written so far, those still buffered too."""
        return self._uncompressed + len(self._buf)

    def virtual_offset(self, uoffset: int) -> int:
        """The virtual offset of uncompressed offset `uoffset` among the
        members emitted so far: at a member's end, (next member, 0), as a
        reader's `tell` gives it (what hts_idx_amend_last keeps,
        hts.c:2708)."""
        i = bisect.bisect_right(self._idx_uo, uoffset) - 1
        return make_virtual_offset(self._idx_co[i],
                                   uoffset - self._idx_uo[i])

    def flush(self) -> None:
        """End the current member (bgzf_flush)."""
        if self._buf:
            self._emit(bytes(self._buf))
            self._buf.clear()
        self._fp.flush()

    def flush_try(self, size: int) -> None:
        """Flush if `size` more bytes would overflow the member
        (bgzf_flush_try, bgzf.c:1745), so that a record is not split."""
        if len(self._buf) + size > BGZF_BLOCK_SIZE:
            self.flush()

    def save_index(self, fname: Optional[str] = None) -> None:
        """Write the `.gzi` of the members emitted so far (by default the
        file's name + ".gzi")."""
        idx = GziIndex(np.array(self._idx_co[:-1] or [0], np.uint64),
                       np.array(self._idx_uo[:-1] or [0], np.uint64))
        idx.save(fname or self.name + ".gzi")

    def close(self, write_eof: bool = True) -> None:
        if self._closed:
            return
        self.flush()
        if self.compress and write_eof:
            self._fp.write(BGZF_EOF)
        self._fp.flush()
        if self._own:
            self._fp.close()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def bgzf_open(fname: str, mode: str = "r") -> Union[BgzfReader, BgzfWriter]:
    """Open as bgzf_open does (htslib/bgzf.h:111): mode "r", or "w" with
    an optional level digit and "u" for uncompressed."""
    if "r" in mode:
        return BgzfReader(fname)
    level = -1
    compress = True
    for ch in mode:
        if ch.isdigit():
            level = int(ch)
        if ch == "u":
            compress = False
    return BgzfWriter(fname, level=level, compress=compress)


# the JAX package's names for the streaming reader and writer
BGZFReader = BgzfReader
BGZFWriter = BgzfWriter
