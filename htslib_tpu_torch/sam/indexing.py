"""BAM/SAM indexing and region queries: the port's copy of
htslib_tpu/sam/indexing.py (reference sam.c:1672-1816 sam_index_* and
hts.c iterator machinery).
"""
from __future__ import annotations

import bisect
import os
from collections import defaultdict
from typing import Iterator, List, Optional, Sequence, Tuple

from htslib_tpu_torch.bgzf import BgzfReader
from htslib_tpu_torch.index import (
    HTS_FMT_BAI, HTS_FMT_CSI, HTS_IDX_NOCOOR, HTS_IDX_REST, HTS_IDX_START,
    HtsIndex, HtsIterator, parse_region,
)
from htslib_tpu_torch.sam.bam import BamReader
from htslib_tpu_torch.sam.record import FUNMAP, BamRecord
from htslib_tpu_torch.sam.samtext import SamReader


def build_bam_index(bam_path: str, out_path: Optional[str] = None,
                    min_shift: int = 0) -> HtsIndex:
    """sam_index_build (sam.c:1638): walk records pushing (tid, beg, end,
    voffset-after-record)."""
    fmt = HTS_FMT_CSI if min_shift > 0 else HTS_FMT_BAI
    if min_shift == 0:
        min_shift, n_lvls = 14, 5
    else:
        n_lvls = 5  # adjusted below if refs longer
    with BamReader(bam_path) as r:
        max_len = max(r.header.ref_lens, default=0)
        if fmt == HTS_FMT_CSI:
            # hts_adjust_csi_settings (hts.c:2372)
            maxpos = 1 << (min_shift + 3 * n_lvls)
            while max_len + 256 > maxpos:
                n_lvls += 1
                maxpos <<= 3
        elif max_len + 256 > (1 << (14 + 3 * 5)):
            raise ValueError("reference too long for BAI; use CSI")
        idx = HtsIndex(r.header.nref, fmt, min_shift, n_lvls)
        # seed last_off with the end-of-header offset (hts_idx_init's
        # offset0 parameter, sam.c:1641 passes bgzf_tell after the header)
        last = r.tell()
        idx._last_off = idx._save_off = last
        idx._off_beg = idx._off_end = last
        while True:
            rec = r.read1()
            if rec is None:
                break
            last = r.tell()
            idx.push(rec.tid, rec.pos, rec.endpos(), last,
                     not (rec.flag & FUNMAP))
        idx.finish(last)
    if out_path is None:
        out_path = bam_path + (".csi" if fmt == HTS_FMT_CSI else ".bai")
    idx.save(out_path)
    return idx


def load_bam_index(bam_path: str, idx_path: Optional[str] = None) -> HtsIndex:
    """sam_index_load (sam.c:1672): look for .bai/.csi next to the file."""
    if idx_path:
        return HtsIndex.load(idx_path)
    for ext in (".bai", ".csi"):
        p = bam_path + ext
        if os.path.exists(p):
            return HtsIndex.load(p)
    root, _ = os.path.splitext(bam_path)
    for ext in (".bai", ".csi"):
        p = root + ext
        if os.path.exists(p):
            return HtsIndex.load(p)
    raise FileNotFoundError(f"no index found for {bam_path}")


def _bam_readrec(fp_reader: BamReader):
    def readrec(fp):
        rec = fp_reader.read1()
        if rec is None:
            return None
        return rec, rec.tid, rec.pos, rec.endpos()
    return readrec


def bam_itr_query(reader: BamReader, idx: Optional[HtsIndex], tid: int,
                  beg: int, end: int) -> HtsIterator:
    """sam_itr_queryi equivalent."""
    readrec = _bam_readrec(reader)
    if tid == HTS_IDX_START or tid == HTS_IDX_REST:
        # REST: from current position; START: re-open semantics are handled
        # by the caller positioning the stream (we use current pos)
        return HtsIterator([], tid, 0, 0, readrec, reader.fp, read_rest=True,
                           curr_off=None)
    if tid == HTS_IDX_NOCOOR:
        off = idx.nocoor_offset() if idx else None
        it = HtsIterator([], tid, 0, 0, readrec, reader.fp, read_rest=True,
                         curr_off=off)
        # filter: only unmapped (tid < 0) records

        def nocoor_readrec(fp):
            while True:
                r = readrec(fp)
                if r is None:
                    return None
                if r[0].tid < 0:
                    return r
        it.readrec = nocoor_readrec
        return it
    chunks = idx.query_chunks(tid, beg, end) if idx else []
    return HtsIterator(chunks, tid, beg, end, readrec, reader.fp)


def bam_fetch(reader: BamReader, idx: HtsIndex, region: str,
              ) -> Iterator[BamRecord]:
    """sam_itr_querys: parse a region string and iterate its records."""
    res = parse_region(region, reader.header.name2tid)
    if res is None:
        raise ValueError(f"could not parse region {region!r}")
    tid, beg, end, _ = res
    return bam_itr_query(reader, idx, tid, beg, end)


class MultiRegionIterator:
    """hts_itr_multi_bam (hts.c:3602): merge chunk lists of many regions,
    read each chunk once, emit records overlapping any region.  Records are
    emitted in file order (which is position order for sorted BAMs)."""

    def __init__(self, reader: BamReader, idx: HtsIndex,
                 regions: Sequence[Tuple[int, int, int]]):
        self.reader = reader
        # per-tid interval lists
        self.intervals = defaultdict(list)
        chunks: List[Tuple[int, int]] = []
        for tid, beg, end in regions:
            if tid < 0:
                continue
            self.intervals[tid].append((beg, end))
            chunks.extend(idx.query_chunks(tid, beg, end))
        for tid in self.intervals:
            ivs = sorted(self.intervals[tid])
            merged = []
            for b, e in ivs:
                if merged and b <= merged[-1][1]:
                    merged[-1] = (merged[-1][0], max(merged[-1][1], e))
                else:
                    merged.append((b, e))
            self.intervals[tid] = merged
        chunks.sort()
        merged_chunks: List[Tuple[int, int]] = []
        for u, v in chunks:
            if merged_chunks and u <= merged_chunks[-1][1]:
                if v > merged_chunks[-1][1]:
                    merged_chunks[-1] = (merged_chunks[-1][0], v)
            else:
                merged_chunks.append((u, v))
        self.chunks = merged_chunks
        self.ci = -1
        self.finished = not self.chunks

    def __iter__(self):
        return self

    def __next__(self) -> BamRecord:
        while not self.finished:
            if self.ci < 0 or self.reader.tell() >= self.chunks[self.ci][1]:
                self.ci += 1
                if self.ci >= len(self.chunks):
                    self.finished = True
                    break
                self.reader.seek(self.chunks[self.ci][0])
            rec = self.reader.read1()
            if rec is None:
                self.finished = True
                break
            ivs = self.intervals.get(rec.tid)
            if not ivs:
                continue
            end = rec.endpos()
            # overlap any interval?
            i = bisect.bisect_right([b for b, _ in ivs], end - 1)
            for b, e in ivs[max(0, i - 1):i + 1]:
                if rec.pos < e and end > b:
                    return rec
        raise StopIteration


def build_sam_gz_index(path: str, min_shift: int = 14,
                       out_path: Optional[str] = None) -> HtsIndex:
    """CSI index over bgzipped SAM text (sam_index_build3 on SAM,
    sam.c:1638; depth adjusted for long references via
    hts_adjust_csi_settings, hts.c:2372)."""
    with SamReader(path) as sr:
        header = sr.header
    n_lvls = 5
    max_len = max(header.ref_lens, default=0)
    maxpos = 1 << (min_shift + 3 * n_lvls)
    while max_len + 256 > maxpos:
        n_lvls += 1
        maxpos <<= 3
    idx = HtsIndex(header.nref, HTS_FMT_CSI, min_shift, n_lvls)
    fp = BgzfReader(path)
    try:
        # skip header lines, seed the index offsets at the first record
        while True:
            off = fp.tell()
            line = fp.readline()
            if not line:
                break
            if line.startswith(b"@"):
                continue
            fp.seek(off)
            break
        last = fp.tell()
        idx._last_off = idx._save_off = last
        idx._off_beg = idx._off_end = last
        while True:
            line = fp.readline()
            if not line:
                break
            last = fp.tell()
            rec = BamRecord.from_sam(line.decode("utf-8"), header)
            idx.push(rec.tid, rec.pos, rec.endpos(), last,
                     not (rec.flag & FUNMAP))
        idx.finish(last)
    finally:
        fp.close()
    idx.save(out_path or path + ".csi")
    return idx


def sam_gz_fetch(path: str, idx: HtsIndex, header, tid: int, beg: int,
                 end: int):
    """Region query over an indexed bgzipped SAM (the sam_itr_queryi
    readrec path for SAM text)."""
    fp = BgzfReader(path)
    try:
        for u, v in idx.query_chunks(tid, beg, end):
            fp.seek(u)
            while True:
                if v and fp.tell() >= v:
                    break
                line = fp.readline()
                if not line or line.startswith(b"@"):
                    break
                rec = BamRecord.from_sam(line.decode("utf-8"), header)
                if rec.tid != tid or rec.pos >= end:
                    break
                if rec.endpos() > beg:
                    yield rec
    finally:
        fp.close()
