"""CRAM container/block I/O (reference cram/cram_io.c).

Host-side framing: file definition, container headers, blocks, and block
decompression for every method of CRAM 3.1 (cram_uncompress_block,
cram_io.c:1576-1750): RAW, GZIP, BZIP2, LZMA; RANS, the rANS 4x8 coder;
RANSPR, the rANS Nx16 coder; ARITH, the adaptive arithmetic coder; FQZ,
fqzcomp; TOK3, the name tokeniser.  As in the JAX package, the last
five go to the native library (RANS through codecs/rans4x8.py) and to
the port's own pure-Python codecs where `htslib_tpu_torch.native.native`
is None.
"""
from __future__ import annotations

import bz2
import lzma
import struct
import zlib
from dataclasses import dataclass
from typing import List, Optional, Tuple

from htslib_tpu_torch.cram.structs import (ARITH, BZIP2, FQZ, GZIP, LZMA,
                                           RANS, RANSPR, RAW, TOK3)
from htslib_tpu_torch.cram.v4 import varint_vec


@dataclass
class CramBlock:
    method: int
    content_type: int
    content_id: int
    comp_size: int
    raw_size: int
    data: bytes          # compressed payload as stored
    _uncompressed: Optional[bytes] = None

    def uncompress(self) -> bytes:
        if self._uncompressed is not None:
            return self._uncompressed
        if len(self.data) == 0 and self.raw_size == 0:
            self._uncompressed = b""
            return b""
        m = self.method
        if m == RAW:
            out = self.data
        elif m == GZIP:
            out = zlib.decompress(self.data, 31)
        elif m == BZIP2:
            out = bz2.decompress(self.data)
        elif m == LZMA:
            out = lzma.decompress(self.data)
        elif m == RANS:
            from htslib_tpu_torch.codecs import rans4x8
            out = rans4x8.uncompress(self.data)
        elif m == RANSPR:
            from htslib_tpu_torch.native import native
            if native is not None:
                out = native.rans4x16_uncompress(self.data)
            else:
                from htslib_tpu_torch.codecs import rans4x16
                out = rans4x16.uncompress(self.data)
        elif m == ARITH:
            from htslib_tpu_torch.native import native
            if native is not None:
                out = native.arith_uncompress(self.data)
            else:
                from htslib_tpu_torch.codecs import arith
                out = arith.uncompress(self.data)
        elif m == FQZ:
            from htslib_tpu_torch.native import native
            if native is not None:
                out = native.fqz_decompress(self.data)
            else:
                from htslib_tpu_torch.codecs import fqzcomp
                out = fqzcomp.decompress(self.data)
        elif m == TOK3:
            from htslib_tpu_torch.native import native
            if native is not None:
                out = native.tok3_decode(self.data)
            else:
                from htslib_tpu_torch.codecs import tok3
                out = tok3.decode_names(self.data)
        else:
            raise IOError(f"unknown CRAM compression method {m}")
        if m != TOK3 and len(out) != self.raw_size:
            raise IOError(f"CRAM block inflated to {len(out)}, expected "
                          f"{self.raw_size}")
        self._uncompressed = out
        return out


@dataclass
class CramContainer:
    length: int
    ref_seq_id: int
    ref_seq_start: int
    ref_seq_span: int
    num_records: int
    record_counter: int
    num_bases: int
    num_blocks: int
    landmarks: List[int]
    crc32: int
    offset: int          # file offset of container start
    data_offset: int     # file offset just after the header


class CramIO:
    """Byte-level CRAM reader over an open binary stream."""

    def __init__(self, fp, version: Tuple[int, int]):
        self.fp = fp
        self.version = version
        self.vv = varint_vec(version[0])

    @property
    def vmajor(self) -> int:
        return self.version[0]

    def read_container_header(self) -> Optional[CramContainer]:
        """cram_read_container (cram_io.c:3786).  CRAM <4 frames the
        length as a 4-byte LE int and the rest as ITF8/LTF8; CRAM 4 is
        all uint7/sint7 varints (cram_io.c:3803-3825), with the CRC32
        covering every header byte in both cases."""
        vv = self.vv
        offset = self.fp.tell()
        if self.vmajor >= 4:
            buf = self.fp.read(256)
            if len(buf) == 0:
                return None
            p = 0
            length, p = vv.get32(buf, p)
            hdr_from = 0
        else:
            head = self.fp.read(4)
            if len(head) < 4:
                return None
            (length,) = struct.unpack("<i", head)
            buf = self.fp.read(192)
            if len(buf) == 0:
                return None
            p = 0
            hdr_from = None  # crc seeded with the 4-byte length below
        ref_seq_id, p = vv.get32s(buf, p)
        if self.vmajor >= 4:
            ref_seq_start, p = vv.get64(buf, p)
            ref_seq_span, p = vv.get64(buf, p)
        else:
            ref_seq_start, p = vv.get32(buf, p)
            ref_seq_span, p = vv.get32(buf, p)
        num_records, p = vv.get32(buf, p)
        if self.vmajor >= 3:
            record_counter, p = vv.get64(buf, p)
        elif self.vmajor == 2:
            record_counter, p = vv.get32(buf, p)
        else:
            record_counter = 0
        if self.vmajor > 1:
            num_bases, p = vv.get64(buf, p)
        else:
            num_bases = 0
        num_blocks, p = vv.get32(buf, p)
        nland, p = vv.get32(buf, p)
        landmarks = []
        # ensure buffer is large enough for landmarks + crc
        need = p + nland * 10 + 4
        while len(buf) < need:
            more = self.fp.read(need - len(buf))
            if not more:
                break
            buf += more
        for _ in range(nland):
            v, p = vv.get32(buf, p)
            landmarks.append(v)
        crc = 0
        if self.vmajor >= 3:
            crc = struct.unpack_from("<I", buf, p)[0]
            got = zlib.crc32(buf[:p] if hdr_from == 0
                             else head + buf[:p]) & 0xFFFFFFFF
            if got != crc:
                raise IOError("CRAM container header CRC32 mismatch")
            p += 4
        data_offset = offset + (0 if hdr_from == 0 else 4) + p
        self.fp.seek(data_offset)
        return CramContainer(length, ref_seq_id, ref_seq_start, ref_seq_span,
                             num_records, record_counter, num_bases,
                             num_blocks, landmarks, crc, offset, data_offset)

    def read_block(self) -> CramBlock:
        """cram_read_block (cram_io.c framing)."""
        vv = self.vv
        hdr = self.fp.read(2)
        if len(hdr) < 2:
            raise IOError("truncated CRAM block")
        method, content_type = hdr[0], hdr[1]
        buf = self.fp.read(30 if self.vmajor >= 4 else 15)
        p = 0
        content_id, p = vv.get32(buf, p)
        comp_size, p = vv.get32(buf, p)
        raw_size, p = vv.get32(buf, p)
        data = buf[p:]
        if len(data) >= comp_size:
            extra = data[comp_size:]
            data = data[:comp_size]
            self.fp.seek(self.fp.tell() - len(extra))
        else:
            data += self.fp.read(comp_size - len(data))
        if len(data) != comp_size:
            raise IOError("truncated CRAM block data")
        if self.vmajor >= 3:
            crc = self.fp.read(4)
            (want,) = struct.unpack("<I", crc)
            got = zlib.crc32(hdr + buf[:p] + data) & 0xFFFFFFFF
            if got != want:
                raise IOError("CRAM block CRC32 mismatch")
        return CramBlock(method, content_type, content_id, comp_size,
                         raw_size, bytes(data))

    def skip_container_data(self, c: CramContainer) -> None:
        self.fp.seek(c.data_offset + c.length)


def read_file_definition(fp) -> Tuple[Tuple[int, int], bytes]:
    magic = fp.read(4)
    if magic != b"CRAM":
        raise IOError("not a CRAM file")
    major, minor = fp.read(1)[0], fp.read(1)[0]
    file_id = fp.read(20)
    return (major, minor), file_id
