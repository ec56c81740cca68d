"""BAM container on the host: the port's copy of htslib_tpu/sam/bam.py
(reference sam.c:703-900 bam_hdr_read, bam_hdr_write, bam_read1,
bam_write1).

A BAM file is BGZF (bgzf.py) around one uncompressed stream: the magic
"BAM\\1", the header text and the references, then the records, each a
u32 length and its payload (sam/record.py `BamRecord.to_bam_buffer`).
`BamReader` reads it a record at a time with virtual offsets (`read1`,
`tell`, `seek`, what the region iterators of sam/indexing.py walk), or
all at once: `raw_records` returns the rest of the record stream as the
device chains take it (ops/bam2sam.py, parallel/distributed.py).
`BamWriter(build_index=True)` writes the `.bai` beside the file.
"""
from __future__ import annotations

import io
import os
import struct
from typing import BinaryIO, Iterator, List, Optional, Tuple, Union

import numpy as np

from htslib_tpu_torch.bgzf import (BgzfReader, BgzfWriter, BlockTable,
                                   inflate_host, scan_blocks)
from htslib_tpu_torch.hts_expr import HtsFilter, sam_passes_filter
from htslib_tpu_torch.index import HTS_FMT_BAI, HtsIndex
from htslib_tpu_torch.sam.header import SamHeader
from htslib_tpu_torch.sam.record import FUNMAP, BamRecord

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
    """Reads a BAM file (a path, a binary file object or a BgzfReader):
    `header` parsed on opening, then the records a time (`read1`,
    iteration, `set_filter`) or the rest of the stream at once
    (`raw_records`)."""

    def __init__(self, src: Union[str, os.PathLike, BinaryIO, BgzfReader]):
        self.fp = src if isinstance(src, BgzfReader) else BgzfReader(src)
        self.header = read_bam_header(self.fp)
        self._filter = None

    def __iter__(self) -> Iterator[BamRecord]:
        return self

    def set_filter(self, expr: Optional[str]) -> None:
        """hts_set_filter_expression (hts.c:1967): iteration skips the
        records that fail the expression (sam_passes_filter,
        sam.c:1535); `read1` does not."""
        self._filter = HtsFilter(expr) if expr else None

    def __next__(self) -> BamRecord:
        while True:
            rec = self.read1()
            if rec is None:
                raise StopIteration
            if self._filter is None or sam_passes_filter(
                    rec, self.header, self._filter):
                return rec

    def read1(self) -> Optional[BamRecord]:
        """bam_read1 (sam.c:784): the next record, or None at the end."""
        szb = self.fp.read(4)
        if len(szb) == 0:
            return None
        if len(szb) < 4:
            raise IOError("truncated BAM record")
        (block_size,) = struct.unpack("<I", szb)
        if block_size < 32:
            raise IOError("invalid BAM record size")
        payload = self.fp.read(block_size)
        if len(payload) != block_size:
            raise IOError("truncated BAM record")
        rec = BamRecord.from_bam_buffer(payload)
        # reference-name bounds checks (sam.c:824-833)
        nref = self.header.nref
        if rec.tid >= nref or rec.mtid >= nref:
            raise IOError("BAM record refers to nonexistent reference")
        return rec

    def tell(self) -> int:
        return self.fp.tell()

    def seek(self, voffset: int) -> None:
        self.fp.seek(voffset)

    def raw_records(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(data, offsets, sizes): the rest of the uncompressed stream as
        uint8 (its members inflated on the host at once), each record's
        offset in it (at its u32 length) as uint64, and its whole size
        with that length as uint32.  Raises IOError on a truncated
        stream."""
        data = self.fp.read_all()
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
        self.fp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BamWriter:
    """Writes the header, then each record as its u32 length and payload
    (bam_write1, sam.c:862), through a BgzfWriter that ends the file
    with the EOF member on close.  With `build_index`, each record's
    uncompressed end is kept and mapped to a virtual offset through the
    writer's block map at close, which reproduces the reader's offsets
    (the (next member, 0) form at a member's end too, hts.c:2708), and
    the BAI is saved beside the file (`idx`)."""

    def __init__(self, dst: Union[str, BinaryIO, BgzfWriter], header,
                 level: int = -1, build_index: bool = False):
        self.fp = (dst if isinstance(dst, BgzfWriter)
                   else BgzfWriter(dst, level=level))
        self.header = header
        self._index_recs = None
        if build_index:
            if max(header.ref_lens, default=0) + 256 > (1 << (14 + 3 * 5)):
                raise ValueError("reference too long for BAI; use CSI")
            self._index_recs = []
        write_bam_header(self.fp, header)
        self._uheader_end = None

    def write(self, rec: BamRecord) -> None:
        payload = rec.to_bam_buffer()
        if self._index_recs is not None and self._uheader_end is None:
            self._uheader_end = self.fp.utell()
        self.fp.write(struct.pack("<I", len(payload)))
        self.fp.write(payload)
        if self._index_recs is not None:
            self._index_recs.append((rec.tid, rec.pos, rec.endpos(),
                                     self.fp.utell(),
                                     not (rec.flag & FUNMAP)))

    def tell(self) -> int:
        return self.fp.tell()

    def close(self) -> None:
        if self._index_recs is None:
            self.fp.close()
            return
        self.fp.flush()
        u2v = self.fp.virtual_offset
        idx = HtsIndex(len(self.header.ref_names), HTS_FMT_BAI, 14, 5)
        off0 = u2v(self._uheader_end or 0)
        idx._last_off = idx._save_off = off0
        idx._off_beg = idx._off_end = off0
        for tid, beg, end, uend, mapped in self._index_recs:
            idx.push(tid, beg, end, u2v(uend), mapped)
        idx.finish(u2v(self.fp._uncompressed))
        name = self.fp.name
        self.fp.close()
        if name and name != "?":
            idx.save(name + ".bai")
        self.idx = idx

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
