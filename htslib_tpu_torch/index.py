"""Binning indexes (CSI/BAI/TBI) and indexed iterators: the port's copy
of htslib_tpu/index.py.

Equivalent of the reference's hts_idx_t machinery (hts.c:2236-3136 build/
save/load; hts.c:3147-3360 reg2bins; hts.c:3426 hts_itr_query).  The
R-tree-like structure: per reference, a bin->chunk-list map (bins are the
CSI hierarchy over (beg,end) intervals) plus a linear index of 2^min_shift
windows -> minimum virtual offset, used to prune chunk lists.

Queries here return *chunk batches* — arrays of (voffset_start,
voffset_end) — which the batch pipeline turns into one gather of BGZF
blocks and a single data-parallel inflate, instead of the reference's
seek-read-seek loop.
"""
from __future__ import annotations

import struct
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from htslib_tpu_torch.bgzf import BgzfReader, BgzfWriter
from htslib_tpu_torch.sam.cigar import reg2bin
from htslib_tpu_torch.util.log import log_warning

HTS_FMT_CSI = 0
HTS_FMT_BAI = 1
HTS_FMT_TBI = 2
HTS_FMT_CRAI = 3
HTS_FMT_FAI = 4

HTS_IDX_NOCOOR = -2
HTS_IDX_START = -3
HTS_IDX_REST = -4
HTS_IDX_NONE = -5

HTS_POS_MAX = (1 << 63) - 1
HTS_MIN_MARKER_DIST = 0x10000  # hts.c:2230

# parse flags (htslib/hts.h:850)
HTS_PARSE_THOUSANDS_SEP = 1
HTS_PARSE_ONE_COORD = 2
HTS_PARSE_LIST = 4


# ---------------------------------------------------------------------------
# bin arithmetic (htslib/hts.h:1516-1556)
# ---------------------------------------------------------------------------

def bin_first(level: int) -> int:
    return ((1 << (3 * level)) - 1) // 7


def bin_parent(bin_: int) -> int:
    return (bin_ - 1) >> 3


def bin_level(bin_: int) -> int:
    l = 0
    while bin_first(l + 1) <= bin_:
        l += 1
    return l


def bin_bot(bin_: int, n_lvls: int) -> int:
    """Index of the first bottom-level window covered by bin (hts.c:
    hts_bin_bot)."""
    l = bin_level(bin_)
    return (bin_ - bin_first(l)) << ((n_lvls - l) * 3)


def bin_maxpos(min_shift: int, n_lvls: int) -> int:
    return 1 << (min_shift + 3 * n_lvls)


def adjust_csi_settings(max_len: int, min_shift: int,
                        n_lvls: int) -> "Tuple[int, int]":
    """hts_adjust_csi_settings (hts.c:2372): grow the CSI depth (or,
    past 9 levels, min_shift) until the longest reference fits.
    Returns (min_shift, n_lvls)."""
    max_n_lvls = 9
    need = max_len + 256
    if need <= bin_maxpos(min_shift, max_n_lvls):
        maxpos = bin_maxpos(min_shift, n_lvls)
        while need > maxpos:
            n_lvls += 1
            maxpos *= 8
    else:
        old = min_shift
        n_lvls = max_n_lvls
        maxpos = bin_maxpos(min_shift, n_lvls)
        while need > maxpos:
            min_shift += 1
            maxpos *= 2
        log_warning("Adjusted min_shift from %d to %d due to longest "
                    "reference of %d bases.", old, min_shift, max_len)
    return min_shift, n_lvls


def reg2bins(beg: int, end: int, min_shift: int = 14, n_lvls: int = 5,
             ) -> List[int]:
    """All bins overlapping [beg, end) (hts.c:3147 reg2bins; end clamped
    to the index's max position as in hts.c:3155)."""
    bins = []
    maxpos = 1 << (min_shift + 3 * n_lvls)
    if beg >= maxpos:
        return bins
    if end > maxpos:
        end = maxpos
    end -= 1
    l, t, s = 0, 0, min_shift + n_lvls * 3
    while l <= n_lvls:
        b = t + (beg >> s)
        e = t + (end >> s)
        bins.extend(range(b, e + 1))
        s -= 3
        t += 1 << (l * 3)
        l += 1
    return bins


# ---------------------------------------------------------------------------
# index data structure
# ---------------------------------------------------------------------------

class BinEntry:
    __slots__ = ("loff", "chunks")

    def __init__(self):
        self.loff = 0
        self.chunks: List[Tuple[int, int]] = []


class HtsIndex:
    """hts_idx_t: per-ref bin map + linear index + meta/statistics."""

    def __init__(self, n: int = 0, fmt: int = HTS_FMT_BAI,
                 min_shift: int = 14, n_lvls: int = 5):
        self.fmt = fmt
        self.min_shift = min_shift
        self.n_lvls = n_lvls
        self.n = n
        self.bidx: List[Optional[Dict[int, BinEntry]]] = [None] * n
        self.lidx: List[List[int]] = [[] for _ in range(n)]
        self.meta: bytes = b""
        self.n_no_coor = 0
        # construction state (hts_idx_t.z, hts.c:2270)
        self._last_tid = -1
        self._last_bin = 0xFFFFFFFF
        self._save_tid = -1
        self._save_bin = 0xFFFFFFFF
        self._last_off = 0
        self._save_off = 0
        self._last_coor = 0
        self._off_beg = 0
        self._off_end = 0
        self._n_mapped = 0
        self._n_unmapped = 0
        self._finished = False
        # TBI name bookkeeping (hts_idx_tbi_name, hts.c:2657)
        self._last_tbi_tid = -1
        self._tbi_n = 0

    @property
    def n_bins(self) -> int:
        return bin_first(self.n_lvls + 1)

    @property
    def meta_bin(self) -> int:
        return self.n_bins + 1

    def maxpos(self) -> int:
        return bin_maxpos(self.min_shift, self.n_lvls)

    # -- construction (hts_idx_push, hts.c:2558) ------------------------
    def _grow(self, tid: int) -> None:
        while len(self.bidx) <= tid:
            self.bidx.append(None)
            self.lidx.append([])
        if self.n < tid + 1:
            self.n = tid + 1

    def _insert_to_l(self, tid: int, beg: int, end: int, offset: int) -> None:
        l = self.lidx[tid]
        b = beg >> self.min_shift
        e = (end - 1) >> self.min_shift
        if len(l) < e + 1:
            l.extend([-1] * (e + 1 - len(l)))
        for i in range(b, e + 1):
            if l[i] == -1:
                l[i] = offset

    def _insert_to_b(self, tid: int, bin_: int, u: int, v: int) -> None:
        bx = self.bidx[tid]
        ent = bx.get(bin_)
        if ent is None:
            ent = bx[bin_] = BinEntry()
        ent.chunks.append((u, v))

    def push(self, tid: int, beg: int, end: int, offset: int,
             is_mapped: bool) -> None:
        """Add one record; offset = virtual offset *after* the record."""
        if tid < 0:
            beg, end = -1, 0
        if tid >= 0 and not (beg <= self.maxpos() and end <= self.maxpos()):
            raise ValueError("region cannot be stored in this index; use CSI "
                             "with larger min_shift/depth")
        self._grow(tid)
        if self._finished:
            return
        if self._last_tid != tid or (self._last_tid >= 0 and tid < 0):
            if tid >= 0 and self.n_no_coor:
                raise ValueError("NO_COOR reads not in a single block at the end")
            if tid >= 0 and self.bidx[tid] is not None:
                raise ValueError("Chromosome blocks not continuous")
            self._last_tid = tid
            self._last_bin = 0xFFFFFFFF
        elif tid >= 0 and self._last_coor > beg:
            raise ValueError(f"Unsorted positions on sequence #{tid + 1}")
        if end < beg:
            raise ValueError("Invalid record: end < begin")
        if tid >= 0:
            if self.bidx[tid] is None:
                self.bidx[tid] = {}
            if beg < 0:
                beg = 0
            if end <= 0:
                end = 1
            self._insert_to_l(tid, beg, end, self._last_off)
        else:
            self.n_no_coor += 1
        bin_ = reg2bin(beg, end, self.min_shift, self.n_lvls)
        if self._last_bin != bin_:
            if self._save_bin != 0xFFFFFFFF:
                self._insert_to_b(self._save_tid, self._save_bin,
                                  self._save_off, self._last_off)
            if self._last_bin == 0xFFFFFFFF and self._save_bin != 0xFFFFFFFF:
                self._off_end = self._last_off
                self._insert_to_b(self._save_tid, self.meta_bin,
                                  self._off_beg, self._off_end)
                self._insert_to_b(self._save_tid, self.meta_bin,
                                  self._n_mapped, self._n_unmapped)
                self._n_mapped = self._n_unmapped = 0
                self._off_beg = self._off_end
            self._save_off = self._last_off
            self._save_bin = self._last_bin = bin_
            self._save_tid = tid
        if is_mapped:
            self._n_mapped += 1
        else:
            self._n_unmapped += 1
        self._last_off = offset
        self._last_coor = beg

    def amend_last(self, offset: int) -> None:
        self._last_off = offset

    def finish(self, final_offset: int) -> None:
        """hts_idx_finish (hts.c:2515)."""
        if self._finished:
            return
        if self._save_tid >= 0:
            self._insert_to_b(self._save_tid, self._save_bin,
                              self._save_off, final_offset)
            self._insert_to_b(self._save_tid, self.meta_bin,
                              self._off_beg, final_offset)
            self._insert_to_b(self._save_tid, self.meta_bin,
                              self._n_mapped, self._n_unmapped)
        for i in range(self.n):
            self._update_loff(i)
            self._compress_binning(i)
        self._finished = True

    def _update_loff(self, i: int) -> None:
        """hts.c update_loff: backfill linear index, set per-bin loff."""
        lidx = self.lidx[i]
        for l in range(len(lidx) - 2, -1, -1):
            if lidx[l] == -1:
                lidx[l] = lidx[l + 1]
        bx = self.bidx[i]
        if bx is None:
            return
        for bin_, ent in bx.items():
            if bin_ < self.n_bins:
                bot = bin_bot(bin_, self.n_lvls)
                ent.loff = lidx[bot] if bot < len(lidx) else 0
            else:
                ent.loff = 0
        if self.fmt == HTS_FMT_CSI:
            self.lidx[i] = []

    def _compress_binning(self, i: int) -> None:
        """hts.c compress_binning: merge small bins into parents, merge
        same-block adjacent chunks."""
        bx = self.bidx[i]
        if bx is None:
            return
        for l in range(self.n_lvls, 0, -1):
            start = bin_first(l)
            for bin_ in sorted(b for b in bx
                               if start <= b < self.n_bins and bin_level(b) == l):
                p = bx[bin_]
                if l < self.n_lvls and len(p.chunks) > 1:
                    p.chunks.sort()
                if ((p.chunks[-1][1] >> 16) - (p.chunks[0][0] >> 16)
                        < HTS_MIN_MARKER_DIST):
                    parent = bin_parent(bin_)
                    q = bx.get(parent)
                    if q is None:
                        continue
                    q.chunks.extend(p.chunks)
                    del bx[bin_]
        if 0 in bx:
            bx[0].chunks.sort()
        for bin_, p in bx.items():
            if bin_ >= self.n_bins:
                continue
            merged: List[Tuple[int, int]] = []
            for u, v in p.chunks:
                if merged and (merged[-1][1] >> 16) >= (u >> 16):
                    if merged[-1][1] < v:
                        merged[-1] = (merged[-1][0], v)
                else:
                    merged.append((u, v))
            p.chunks = merged

    # -- statistics ------------------------------------------------------
    def get_n_no_coor(self) -> int:
        return self.n_no_coor

    def get_stat(self, tid: int) -> Tuple[int, int]:
        """(mapped, unmapped) record counts for one reference from the
        meta pseudo-bin (hts_idx_get_stat, hts.c:3115).  Raises KeyError
        when the reference has no entries."""
        h = self.bidx[tid] if 0 <= tid < self.n else None
        if not h or self.meta_bin not in h:
            raise KeyError(f"no index statistics for tid {tid}")
        chunks = h[self.meta_bin].chunks
        return chunks[1][0], chunks[1][1]

    # -- save (idx_save_core, hts.c:2759) --------------------------------
    def save(self, fnidx: str) -> None:
        if self.fmt == HTS_FMT_BAI:
            fp = BgzfWriter(fnidx, compress=False)
            fp.write(b"BAI\x01")
        elif self.fmt == HTS_FMT_CSI:
            fp = BgzfWriter(fnidx)
            fp.write(b"CSI\x01")
            fp.write(struct.pack("<iiI", self.min_shift, self.n_lvls,
                                 len(self.meta)))
            fp.write(self.meta)
        elif self.fmt == HTS_FMT_TBI:
            fp = BgzfWriter(fnidx)
            fp.write(b"TBI\x01")
        else:
            raise ValueError("unsupported index format")
        # VCF TBI/CSI counts only covered refs (hts.c:2700)
        nids = self.n
        if self.meta[:4] == struct.pack("<i", 2):  # TBX_VCF
            nids = sum(1 for b in self.bidx[:self.n] if b is not None)
        fp.write(struct.pack("<i", nids))
        if self.fmt == HTS_FMT_TBI and self.meta:
            fp.write(self.meta)
        for i in range(self.n):
            bx = self.bidx[i]
            if nids == self.n or bx is not None:
                fp.write(struct.pack("<i", len(bx) if bx else 0))
            if bx:
                for bin_ in bx:  # insertion order; readers don't care
                    ent = bx[bin_]
                    fp.write(struct.pack("<I", bin_))
                    if self.fmt == HTS_FMT_CSI:
                        fp.write(struct.pack("<Q", ent.loff))
                    fp.write(struct.pack("<i", len(ent.chunks)))
                    for u, v in ent.chunks:
                        fp.write(struct.pack("<QQ", u, v))
            if self.fmt != HTS_FMT_CSI:
                lidx = self.lidx[i]
                fp.write(struct.pack("<i", len(lidx)))
                for off in lidx:
                    fp.write(struct.pack("<Q", off if off != -1 else 0))
        fp.write(struct.pack("<Q", self.n_no_coor))
        fp.close(write_eof=self.fmt != HTS_FMT_BAI)

    # -- load (idx_read, hts.c:2925) -------------------------------------
    @classmethod
    def load(cls, fnidx: str) -> "HtsIndex":
        fp = BgzfReader(fnidx)
        magic = fp.read(4)
        if magic == b"BAI\x01":
            idx = cls(0, HTS_FMT_BAI, 14, 5)
        elif magic == b"CSI\x01":
            min_shift, n_lvls, l_meta = struct.unpack("<iiI", fp.read(12))
            idx = cls(0, HTS_FMT_CSI, min_shift, n_lvls)
            idx.meta = fp.read(l_meta)
        elif magic == b"TBI\x01":
            idx = cls(0, HTS_FMT_TBI, 14, 5)
        else:
            fp.close()
            raise IOError(f"{fnidx}: not a BAI/CSI/TBI index")
        (n,) = struct.unpack("<i", fp.read(4))
        if idx.fmt == HTS_FMT_TBI:
            meta_head = fp.read(28)
            (l_nm,) = struct.unpack("<I", meta_head[24:28])
            idx.meta = meta_head + fp.read(l_nm)
        idx.n = n
        idx.bidx = [None] * n
        idx.lidx = [[] for _ in range(n)]
        for i in range(n):
            (n_bin,) = struct.unpack("<i", fp.read(4))
            if n_bin > 0:
                idx.bidx[i] = {}
            for _ in range(n_bin):
                (bin_,) = struct.unpack("<I", fp.read(4))
                ent = BinEntry()
                if idx.fmt == HTS_FMT_CSI:
                    (ent.loff,) = struct.unpack("<Q", fp.read(8))
                (n_chunk,) = struct.unpack("<i", fp.read(4))
                raw = fp.read(16 * n_chunk)
                arr = np.frombuffer(raw, "<u8").reshape(n_chunk, 2)
                ent.chunks = [(int(u), int(v)) for u, v in arr]
                if idx.bidx[i] is None:
                    idx.bidx[i] = {}
                idx.bidx[i][bin_] = ent
            if idx.fmt != HTS_FMT_CSI:
                (n_intv,) = struct.unpack("<i", fp.read(4))
                raw = fp.read(8 * n_intv)
                idx.lidx[i] = [int(x) for x in np.frombuffer(raw, "<u8")]
        tail = fp.read(8)
        if len(tail) == 8:
            (idx.n_no_coor,) = struct.unpack("<Q", tail)
        fp.close()
        idx._finished = True
        return idx

    # -- query (hts_itr_query, hts.c:3426) -------------------------------
    def query_chunks(self, tid: int, beg: int, end: int,
                     ) -> List[Tuple[int, int]]:
        """Merged chunk list overlapping [beg, end); [] if none."""
        if tid < 0 or tid >= self.n or self.bidx[tid] is None:
            return []
        bidx = self.bidx[tid]
        if beg < 0:
            beg = 0
        if end < beg or not bidx:
            return []
        if beg >= self.maxpos():
            return []
        ent = bidx.get(self.meta_bin)
        unmapped = ent.chunks[1][1] if ent and len(ent.chunks) >= 2 else 1

        rel_off = beg >> self.min_shift
        # min_off from first extant bin at/left of beg (walk up/left)
        bin_ = bin_first(self.n_lvls) + rel_off
        hit = None
        while bin_:
            if bin_ in bidx:
                hit = bidx[bin_]
                break
            first = (bin_parent(bin_) << 3) + 1
            if bin_ > first:
                bin_ -= 1
            else:
                bin_ = bin_parent(bin_)
        if bin_ == 0 and hit is None:
            hit = bidx.get(0)
        min_off = hit.loff if hit is not None else 0
        lidx = self.lidx[tid]
        if lidx and rel_off < len(lidx):
            lv = lidx[rel_off] if lidx[rel_off] != -1 else 0
            if min_off < lv:
                min_off = lv
            if unmapped:
                tmp_off = rel_off - 1
                while tmp_off >= 0:
                    if lidx[tmp_off] < min_off:
                        min_off = lidx[tmp_off]
                        break
                    tmp_off -= 1
                if hit is not None and (min_off < hit.loff or tmp_off < 0):
                    min_off = hit.loff
        elif unmapped and hit is not None:  # CSI
            min_off = hit.loff

        # max_off: first chunk start of the first extant bin right of end
        if end <= self.maxpos():
            bin_ = bin_first(self.n_lvls) + ((end - 1) >> self.min_shift) + 1
            if bin_ >= self.n_bins:
                bin_ = 0
            max_off = None
            while True:
                while bin_ % 8 == 1:
                    bin_ = bin_parent(bin_)
                if bin_ == 0:
                    max_off = (1 << 64) - 1
                    break
                e2 = bidx.get(bin_)
                if e2 is not None and e2.chunks:
                    max_off = e2.chunks[0][0]
                    break
                bin_ += 1
        else:
            max_off = (1 << 64) - 1

        off: List[Tuple[int, int]] = []
        for b in reg2bins(beg, end, self.min_shift, self.n_lvls):
            e2 = bidx.get(b)
            if e2 is None:
                continue
            for u, v in e2.chunks:
                if v > min_off and u < max_off:
                    off.append((max(u, min_off), min(v, max_off)))
        if not off:
            return []
        off.sort()
        # drop contained, clip overlaps, merge same-block neighbours
        res = [off[0]]
        for u, v in off[1:]:
            if res[-1][1] >= v:
                continue
            res.append((u, v))
        for i in range(1, len(res)):
            if res[i - 1][1] >= res[i][0]:
                res[i - 1] = (res[i - 1][0], res[i][0])
        merged = [res[0]]
        for u, v in res[1:]:
            if merged[-1][1] >> 16 == u >> 16:
                merged[-1] = (merged[-1][0], v)
            else:
                merged.append((u, v))
        return merged

    def nocoor_offset(self) -> Optional[int]:
        """Virtual offset where NOCOOR records start (hts_itr_off for
        HTS_IDX_NOCOOR): end of the last reference's data."""
        off = None
        for i in range(self.n):
            bx = self.bidx[i]
            if bx is None:
                continue
            ent = bx.get(self.meta_bin)
            if ent and ent.chunks:
                off = ent.chunks[0][1]
        return off


# ---------------------------------------------------------------------------
# iterators (hts_itr_t, hts.c:4271 hts_itr_next)
# ---------------------------------------------------------------------------

class HtsIterator:
    """Single-region iterator over an indexed BGZF-backed file.

    readrec(fp) must read one record at the current position and return
    (record, tid, beg, end) or None at EOF."""

    def __init__(self, chunks: Sequence[Tuple[int, int]], tid: int,
                 beg: int, end: int, readrec: Callable, fp,
                 read_rest: bool = False, curr_off: Optional[int] = None):
        self.chunks = list(chunks)
        self.tid, self.beg, self.end = tid, beg, end
        self.readrec = readrec
        self.fp = fp
        self.read_rest = read_rest
        self.finished = not (read_rest or self.chunks)
        self.i = -1
        self.curr_off = curr_off
        self._seeked = False

    def __iter__(self):
        return self

    def __next__(self):
        rec = self.next_rec()
        if rec is None:
            raise StopIteration
        return rec

    def next_rec(self):
        if self.finished:
            return None
        if self.read_rest:
            if not self._seeked and self.curr_off is not None:
                self.fp.seek(self.curr_off)
                self._seeked = True
            r = self.readrec(self.fp)
            if r is None:
                self.finished = True
                return None
            return r[0]
        while True:
            need_seek = False
            if self.i < 0:
                need_seek = True
            else:
                cur = self.fp.tell()
                if cur >= self.chunks[self.i][1]:
                    need_seek = True
            if need_seek:
                self.i += 1
                # skip chunks fully before current position when possible
                if self.i >= len(self.chunks):
                    self.finished = True
                    return None
                self.fp.seek(self.chunks[self.i][0])
            r = self.readrec(self.fp)
            if r is None:
                self.finished = True
                return None
            rec, tid, beg, end = r
            if tid != self.tid or beg >= self.end:
                self.finished = True
                return None
            if end > self.beg:
                return rec


# ---------------------------------------------------------------------------
# region parsing (hts_parse_region, hts.c:4000; hts_parse_decimal :3889)
# ---------------------------------------------------------------------------

def parse_decimal(s: str, flags: int = 0) -> Tuple[int, int]:
    """Returns (value, chars_consumed)."""
    i, n = 0, len(s)
    while i < n and s[i].isspace():
        i += 1
    start = i
    sign = 1
    if i < n and s[i] in "+-":
        sign = -1 if s[i] == "-" else 1
        i += 1
    digits = 0
    val = 0
    while i < n:
        c = s[i]
        if c.isdigit():
            val = val * 10 + int(c)
            digits += 1
            i += 1
        elif c == "," and (flags & HTS_PARSE_THOUSANDS_SEP):
            i += 1
        else:
            break
    decimals = 0
    if i < n and s[i] == ".":
        i += 1
        while i < n and s[i].isdigit():
            val = val * 10 + int(s[i])
            decimals += 1
            digits += 1
            i += 1
    e = 0
    if i < n and s[i] in "eE":
        i += 1
        esign = 1
        if i < n and s[i] in "+-":
            esign = -1 if s[i] == "-" else 1
            i += 1
        ev = 0
        while i < n and s[i].isdigit():
            ev = ev * 10 + int(s[i])
            i += 1
        e = esign * ev
    elif i < n and s[i] in "kK":
        e, i = 3, i + 1
    elif i < n and s[i] in "mM":
        e, i = 6, i + 1
    elif i < n and s[i] in "gG":
        e, i = 9, i + 1
    e -= decimals
    while e > 0:
        val *= 10
        e -= 1
    while e < 0:
        val //= 10
        e += 1
    if digits == 0:
        return 0, 0
    return sign * val, i


def parse_region(s: str, name2id: Callable[[str], int],
                 flags: int = 0) -> Optional[Tuple[int, int, int, int]]:
    """Parse 'chr:beg-end' etc.  Returns (tid, beg, end, consumed) with
    0-based half-open coordinates, or None on failure.

    Handles {} quoting, special names '*' (NOCOOR) and '.' (REST), commas
    as thousands separators (unless HTS_PARSE_LIST), and the samtools vs
    bcftools single-coordinate conventions (HTS_PARSE_ONE_COORD).
    """
    if flags & HTS_PARSE_LIST:
        flags &= ~HTS_PARSE_THOUSANDS_SEP
    else:
        flags |= HTS_PARSE_THOUSANDS_SEP
    # find end of this region spec
    if flags & HTS_PARSE_LIST:
        depth = 0
        endp = len(s)
        for i, c in enumerate(s):
            if c == "{":
                depth += 1
            elif c == "}":
                depth -= 1
            elif c == "," and depth == 0:
                endp = i
                break
        spec = s[:endp]
        consumed = endp + (1 if endp < len(s) else 0)
    else:
        spec = s
        consumed = len(s)

    if spec == "*":
        return HTS_IDX_NOCOOR, 0, 0, consumed
    if spec == ".":
        return HTS_IDX_REST, 0, 0, consumed

    name: Optional[str] = None
    rest = ""
    if spec.startswith("{"):
        close = spec.rfind("}")
        if close < 0:
            return None
        name = spec[1:close]
        rest = spec[close + 1:]
    else:
        # try the longest name first: whole spec as a name, then up to the
        # last colon (hts.c:4079 hts_memrchr colon logic)
        tid = name2id(spec)
        if tid >= 0:
            # whole name matches, but error if the pre-colon prefix is
            # ALSO a contig — the range would be ambiguous and needs {}
            # quoting (hts.c:4081-4098)
            colon = spec.rfind(":")
            if colon >= 0 and name2id(spec[:colon]) >= 0:
                return None
            return tid, 0, HTS_POS_MAX, consumed
        colon = spec.rfind(":")
        if colon < 0:
            name = spec
            rest = ""
        else:
            name = spec[:colon]
            rest = spec[colon:]
    tid = name2id(name)
    if tid < 0:
        return None
    if not rest or rest == ":":
        return tid, 0, HTS_POS_MAX, consumed
    if not rest.startswith(":"):
        return None
    # post-colon coordinates, exactly hts.c:4118-4155
    coord = rest[1:]
    val, used = parse_decimal(coord, flags)
    beg0 = val - 1
    after = coord[used:]
    if beg0 < 0:
        if beg0 != -1 and after.startswith("-") and coord != "":
            return None              # "chr:0-100": coordinates must be > 0
        if after == "" or after[0].isdigit() or after[0] == ",":
            # interpret chr:-100 as chr:1-100
            end = HTS_POS_MAX if beg0 == -1 else -(beg0 + 1)
            return tid, 0, end, consumed
        if beg0 < -1:
            return None              # junk after a negative coordinate
    if after == "":
        end = beg0 + 1 if flags & HTS_PARSE_ONE_COORD else HTS_POS_MAX
    elif after.startswith("-"):
        end, used2 = parse_decimal(after[1:], flags)
        if used2 != len(after) - 1:
            return None              # junk after the end coordinate
    else:
        return None
    if end == 0:
        end = HTS_POS_MAX            # interpret chr:100- as chr:100-<end>
    if beg0 >= end:
        return None
    return tid, beg0, end, consumed
