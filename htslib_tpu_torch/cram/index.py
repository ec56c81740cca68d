""".crai index (the port's copy of htslib_tpu/cram/index.py; reference
cram/cram_index.c).

Gzipped text lines: ref_id, start, span, container_offset, slice_offset
(within container, i.e. landmark), slice_size.  Queries return container
offsets to seek to (cram_index_query, cram_index.c:404).
"""
from __future__ import annotations

import gzip
import zlib
from dataclasses import dataclass
from typing import List, Optional, Tuple


@dataclass
class CraiEntry:
    refid: int
    start: int
    span: int
    offset: int       # container file offset
    slice_off: int    # landmark (offset of slice within container data)
    slice_len: int


class CramIndex:
    def __init__(self, entries: List[CraiEntry]):
        self.entries = entries

    @classmethod
    def load(cls, path: str) -> "CramIndex":
        with open(path, "rb") as f:
            raw = f.read()
        if raw[:2] == b"\x1f\x8b":
            raw = zlib.decompress(raw, 31)
        entries = []
        for line in raw.decode().splitlines():
            if not line:
                continue
            f = line.split("\t")
            entries.append(CraiEntry(int(f[0]), int(f[1]), int(f[2]),
                                     int(f[3]), int(f[4]), int(f[5])))
        return cls(entries)

    def save(self, path: str) -> None:
        out = "".join(f"{e.refid}\t{e.start}\t{e.span}\t{e.offset}\t"
                      f"{e.slice_off}\t{e.slice_len}\n" for e in self.entries)
        with gzip.open(path, "wb") as f:
            f.write(out.encode())

    def query(self, refid: int, beg: int, end: int) -> List[CraiEntry]:
        """All slices overlapping [beg, end] (1-based inclusive like the
        reference's usage)."""
        hits = []
        for e in self.entries:
            if e.refid != refid:
                continue
            if e.refid >= 0:
                e_start, e_end = e.start, e.start + e.span - 1
                if e_start <= end and e_end >= beg:
                    hits.append(e)
            else:
                hits.append(e)
        return hits

    def container_offsets(self, refid: int, beg: int, end: int) -> List[int]:
        seen = []
        for e in self.query(refid, beg, end):
            if e.offset not in seen:
                seen.append(e.offset)
        return seen


def build_crai(cram_path: str, out_path: Optional[str] = None,
               ref: Optional[str] = None) -> "CramIndex":
    """Index an existing CRAM (cram_index_build, cram_index.c:779): one
    line per slice, or one line per reference id for multi-ref slices
    (cram_index_build_multiref).  Writes `<cram>.crai` unless out_path
    is given."""
    from htslib_tpu_torch.cram import CramReader
    from htslib_tpu_torch.cram.decode import (decode_compression_header,
                                              decode_slice,
                                              decode_slice_header)

    entries: List[CraiEntry] = []
    with CramReader(cram_path, ref=ref, decode_md=False) as r:
        io = r.io
        fp = r.fp
        while True:
            c = io.read_container_header()
            if c is None:
                break
            if c.ref_seq_id == -1 and c.ref_seq_start == 0x454F46:
                break  # EOF container
            if c.num_records == 0 or c.length == 0:
                io.skip_container_data(c)
                continue
            # landmarks are slice offsets within the container data
            lands = list(c.landmarks) + [c.length]
            # cram_index_container (cram_index.c:728): per-slice entries
            comp_block = io.read_block()  # compression header
            chdr = decode_compression_header(comp_block, r.version[0])
            for j in range(len(c.landmarks)):
                spos = lands[j]
                sz = lands[j + 1] - spos
                fp.seek(c.data_offset + spos)
                hdr_block = io.read_block()
                sh = decode_slice_header(hdr_block, r.version[0])
                if sh.ref_seq_id == -2:
                    # multiref: per-refid extents from the decoded records
                    blocks = [io.read_block() for _ in range(sh.num_blocks)]
                    recs = decode_slice(chdr, sh, blocks, r.header,
                                        r.refs.get, r.version[0],
                                        decode_md=False)
                    by_ref = {}
                    for rec in recs:
                        lo, hi = by_ref.get(rec.tid, (1 << 62, -1))
                        by_ref[rec.tid] = (min(lo, rec.pos + 1),
                                           max(hi, rec.endpos()))
                    for tid, (lo, hi) in by_ref.items():
                        if tid < 0:
                            entries.append(CraiEntry(-1, 0, 0, c.offset,
                                                     spos, sz))
                        else:
                            entries.append(CraiEntry(tid, lo, hi - lo + 1,
                                                     c.offset, spos, sz))
                else:
                    entries.append(CraiEntry(
                        sh.ref_seq_id, sh.ref_seq_start, sh.ref_seq_span,
                        c.offset, spos, sz))
            fp.seek(c.data_offset + c.length)
    idx = CramIndex(entries)
    idx.save(out_path or cram_path + ".crai")
    return idx
