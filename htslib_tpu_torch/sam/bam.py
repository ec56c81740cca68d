"""BAM container on the host: the port's copy of what it needs of
htslib_tpu/sam/bam.py (reference sam.c:703-900 bam_hdr_read,
bam_hdr_write, bam_read1, bam_write1).

A BAM file is BGZF (bgzf.py) around one uncompressed stream: the magic
"BAM\\1", the header text and the references, then the records, each a
u32 length and its payload (sam/record.py `BamRecord.to_bam_buffer`).
`BamReader.raw_records` returns the record stream as the device chains
take it (ops/bam2sam.py, parallel/distributed.py).
"""
from __future__ import annotations

import io
import struct
from typing import BinaryIO, List, Tuple, Union

import numpy as np

from htslib_tpu_torch.bgzf import (BgzfWriter, BlockTable, inflate_host,
                                  scan_blocks)
from htslib_tpu_torch.sam.header import SamHeader
from htslib_tpu_torch.sam.record import BamRecord

BAM_MAGIC = b"BAM\x01"


def _take(fp: BinaryIO, n: int) -> bytes:
    b = fp.read(n)
    if len(b) != n:
        raise EOFError("truncated BAM header")
    return b


def read_bam_header(fp: BinaryIO) -> SamHeader:
    """bam_hdr_read (sam.c:703): magic, l_text, text, n_ref, then each
    reference's l_name, name and l_ref, from a file-like `fp` over the
    uncompressed stream."""
    if _take(fp, 4) != BAM_MAGIC:
        raise IOError("invalid BAM binary header (wrong magic)")
    (l_text,) = struct.unpack("<i", _take(fp, 4))
    text = _take(fp, l_text).rstrip(b"\0").decode("utf-8", "replace")
    (n_ref,) = struct.unpack("<i", _take(fp, 4))
    names: List[str] = []
    lens: List[int] = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack("<i", _take(fp, 4))
        names.append(_take(fp, l_name).rstrip(b"\0").decode("utf-8"))
        lens.append(struct.unpack("<i", _take(fp, 4))[0])
    return SamHeader(text, ref_names=names, ref_lens=lens)


def write_bam_header(fp, hdr) -> None:
    """bam_hdr_write (sam.c:918): the text verbatim, then the binary
    reference list, onto any object with `write` (a BgzfWriter, a
    BytesIO); `hdr` needs `text`, `ref_names` and `ref_lens`."""
    text = hdr.text.encode("utf-8")
    fp.write(BAM_MAGIC)
    fp.write(struct.pack("<i", len(text)))
    fp.write(text)
    fp.write(struct.pack("<i", len(hdr.ref_names)))
    for name, length in zip(hdr.ref_names, hdr.ref_lens):
        nb = name.encode("utf-8") + b"\0"
        fp.write(struct.pack("<i", len(nb)))
        fp.write(nb)
        fp.write(struct.pack("<i", length))


def read_header(path: str) -> SamHeader:
    """The header of a BAM file, its first members inflated on the host
    until it is whole."""
    raw = np.fromfile(path, np.uint8)
    table = scan_blocks(raw)
    buf = b""
    for i in range(table.n):
        buf += inflate_host(raw, BlockTable(*(a[i:i + 1] for a in (
            table.coffsets, table.csizes, table.usizes))))
        try:
            return read_bam_header(io.BytesIO(buf))
        except EOFError:
            continue
    return read_bam_header(io.BytesIO(buf))


class BamReader:
    """A whole BAM file read at once: its members inflated on the host
    (zlib, each CRC32 checked), `header` parsed, and the record stream
    after it kept for `raw_records`."""

    def __init__(self, path: str):
        raw = np.fromfile(path, np.uint8)
        stream = io.BytesIO(inflate_host(raw, scan_blocks(raw)))
        self.header = read_bam_header(stream)
        self._data = np.frombuffer(stream.read(), np.uint8)

    def raw_records(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(data, offsets, sizes): the uint8 record stream after the
        header, each record's offset in it (at its u32 length) as uint64,
        and its whole size with that length as uint32.  Raises IOError on
        a truncated stream."""
        data = self._data
        offs: List[int] = []
        sizes: List[int] = []
        mv = memoryview(data)
        pos, n = 0, len(data)
        while pos + 4 <= n:
            bsz = int.from_bytes(mv[pos:pos + 4], "little")
            offs.append(pos)
            sizes.append(bsz + 4)
            pos += 4 + bsz
        if pos != n:
            raise IOError("truncated BAM record stream")
        return data, np.array(offs, np.uint64), np.array(sizes, np.uint32)

    def close(self) -> None:
        self._data = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BamWriter:
    """Writes the header, then each record as its u32 length and payload
    (bam_write1, sam.c:862), through a BgzfWriter that ends the file
    with the EOF member on close."""

    def __init__(self, dst: Union[str, BinaryIO], header, level: int = -1):
        self.fp = BgzfWriter(dst, level=level)
        self.header = header
        write_bam_header(self.fp, header)

    def write(self, rec: BamRecord) -> None:
        payload = rec.to_bam_buffer()
        self.fp.write(struct.pack("<I", len(payload)) + payload)

    def close(self) -> None:
        self.fp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
