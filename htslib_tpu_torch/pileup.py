"""Pileup engine — bam_plp/bam_mplp equivalents: the port's copy of
htslib_tpu/pileup.py (reference sam.c:5352-6330), with mpileup's record
read on the card.

Streaming per-position column builder over position-sorted reads: per-read
CIGAR cursor state machine (resolve_cigar2, sam.c:5409), insertion
extraction (bam_plp_insertion_mod, sam.c:5517), overlapping mate-pair
quality tweaking (tweak_overlap_quality, sam.c:5803) and the multi-sample
lock-step merge (bam_mplp_*, sam.c:6211).  The engine is the JAX module's
pure-Python one, whole; the batch formulation (CIGAR expansion into
events, sums per position tile) is ops/pileup_kernel.py.

`mpileup_text` and `mpileup_text_parallel` (`samtools mpileup`'s text)
read their input as one record stream, its work on `device`: a BAM's
members inflated in one `bgzf.inflate_range` call (X4 on the card), a
SAM's text parsed by `sam/batch.py` `sam_text_to_bam`; the records framed
by `ops/bam2sam.py` `device_record_scan` (X5), their planner fields
(tid, pos, end, flag) read from the stream, and every record's bases
decoded once by `ops/seqfmt.py` `nibble_to_base` (B1), which each
`BamRecord` handed to the engine carries (`BamRecord.seq_text`).  The
parallel form plans coordinate tiles balanced by mapped reads, one
contiguous record range a tile (the JAX function's plan), and runs the
tiles in spawned processes that get the tile's record bytes and bases
and never touch the card; a tile emits only the columns inside it.  This
module imports torch only inside the entry points, so a tile's process
loads the engine alone.

As in the JAX package, both entry points go to the native engine
(`native.mpileup`, the resolve_cigar2 and overlap-tweak port in C++)
unless `htslib_tpu_torch.native.native` is None: the stream is read as
above (X4 for a BAM; a SAM's body parsed by `native.sam_to_bam`), and
`mpileup_text` hands it whole to the engine.  Where the parser or the
engine refuses a SAM (IOError, or BlockingIOError on a record the engine
does not handle, such as a CIGAR in a CG tag), the Python engine runs;
where the engine refuses a BAM the text is empty, as the JAX function's
is (its fallback reads a spent reader; ROADMAP queue C).
`mpileup_text_parallel` frames it and reads the planner fields on
the device (X5; B1 is not launched, since the engine reads the packed
bases itself), plans the same tiles and runs the engine over each tile's
record range with an emission window on pipeline.py's host threads.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from htslib_tpu_torch.sam.cigar import (BAM_CDEL, BAM_CDIFF, BAM_CEQUAL,
                                        BAM_CHARD_CLIP, BAM_CINS,
                                        BAM_CMATCH, BAM_CPAD,
                                        BAM_CREF_SKIP, BAM_CSOFT_CLIP,
                                        cigar2rlen)
from htslib_tpu_torch.sam.header import SamHeader
from htslib_tpu_torch.sam.record import (FDUP, FMUNMAP, FPAIRED,
                                         FPROPER_PAIR, FQCFAIL, FSECONDARY,
                                         FUNMAP, BamRecord)

_M_OPS = (BAM_CMATCH, BAM_CEQUAL, BAM_CDIFF)


class PileupRead:
    """bam_pileup1_t."""

    __slots__ = ("b", "qpos", "is_del", "is_refskip", "is_head", "is_tail",
                 "indel", "cigar_ind")

    def __init__(self, b: BamRecord):
        self.b = b
        self.qpos = 0
        self.is_del = 0
        self.is_refskip = 0
        self.is_head = 0
        self.is_tail = 0
        self.indel = 0
        self.cigar_ind = 0


class _Node:
    __slots__ = ("b", "beg", "end", "k", "x", "y", "s_end", "qual")

    def __init__(self, b: BamRecord):
        self.b = b
        self.beg = b.pos
        self.end = b.pos + cigar2rlen(b.cigar)
        self.k = -1        # cstate_t
        self.x = 0
        self.y = 0
        self.s_end = self.end - 1
        self.qual = bytearray(b.qual)  # mutable copy for overlap tweaking


def _resolve_cigar2(p: PileupRead, pos: int, s: _Node) -> None:
    """resolve_cigar2 (sam.c:5409), operating on the node's cursor."""
    b = s.b
    cigar = b.cigar
    n_cigar = len(cigar)
    if s.k == -1:
        p.qpos = 0
        if n_cigar == 1:
            if (cigar[0] & 0xF) in _M_OPS:
                s.k, s.x, s.y = 0, b.pos, 0
        else:
            s.x, s.y = b.pos, 0
            for k in range(n_cigar):
                op = int(cigar[k]) & 0xF
                l = int(cigar[k]) >> 4
                if op in (BAM_CMATCH, BAM_CDEL, BAM_CREF_SKIP, BAM_CEQUAL,
                          BAM_CDIFF):
                    break
                if op in (BAM_CINS, BAM_CSOFT_CLIP):
                    s.y += l
            s.k = k
    else:
        l = int(cigar[s.k]) >> 4
        if pos - s.x >= l:
            op_cur = int(cigar[s.k]) & 0xF
            if op_cur in _M_OPS:
                s.y += l
            s.x += l
            k = s.k + 1
            while k < n_cigar:
                op = int(cigar[k]) & 0xF
                l2 = int(cigar[k]) >> 4
                if op in (BAM_CMATCH, BAM_CDEL, BAM_CREF_SKIP, BAM_CEQUAL,
                          BAM_CDIFF):
                    break
                if op in (BAM_CINS, BAM_CSOFT_CLIP):
                    s.y += l2
                k += 1
            s.k = k
    # collect pileup info
    op = int(cigar[s.k]) & 0xF
    l = int(cigar[s.k]) >> 4
    p.is_del = p.indel = p.is_refskip = 0
    if s.x + l - 1 == pos and s.k + 1 < n_cigar:
        op2 = int(cigar[s.k + 1]) & 0xF
        l2 = int(cigar[s.k + 1]) >> 4
        if op2 == BAM_CDEL and op != BAM_CDEL:
            p.indel = -l2
            for k in range(s.k + 2, n_cigar):
                op2 = int(cigar[k]) & 0xF
                l2 = int(cigar[k]) >> 4
                if op2 == BAM_CDEL:
                    p.indel -= l2
                else:
                    break
        elif op2 == BAM_CINS:
            p.indel = l2
            for k in range(s.k + 2, n_cigar):
                op2 = int(cigar[k]) & 0xF
                l2 = int(cigar[k]) >> 4
                if op2 == BAM_CINS:
                    p.indel += l2
                elif op2 != BAM_CPAD:
                    break
        elif op2 == BAM_CPAD and s.k + 2 < n_cigar:
            l3 = 0
            for k in range(s.k + 2, n_cigar):
                op2 = int(cigar[k]) & 0xF
                l2 = int(cigar[k]) >> 4
                if op2 == BAM_CINS:
                    l3 += l2
                elif op2 in (BAM_CDEL, BAM_CMATCH, BAM_CREF_SKIP, BAM_CEQUAL,
                             BAM_CDIFF):
                    break
            if l3 > 0:
                p.indel = l3
    if op in _M_OPS:
        p.qpos = s.y + (pos - s.x)
    elif op in (BAM_CDEL, BAM_CREF_SKIP):
        p.is_del = 1
        p.qpos = s.y
        p.is_refskip = 1 if op == BAM_CREF_SKIP else 0
    p.is_head = 1 if pos == b.pos else 0
    p.is_tail = 1 if pos == s.s_end else 0
    p.cigar_ind = s.k


def plp_insertion(p: PileupRead, with_mods=None) -> Tuple[str, int]:
    """bam_plp_insertion_mod (sam.c:5517): returns (padded insertion
    string, del_len following the insertion).  `with_mods` (a
    sam/mods.py `BaseModState`) is accepted and, as in the JAX function,
    its modifications are not written into the string."""
    if p.indel <= 0:
        return "", 0
    cigar = p.b.cigar
    n_cigar = len(cigar)
    del_len = 0
    out: List[str] = []
    seq = p.b.seq  # ASCII string
    k = p.cigar_ind + 1
    j = 1
    while k < n_cigar:
        op = int(cigar[k]) & 0xF
        ln = int(cigar[k]) >> 4
        if op == BAM_CPAD:
            out.append("*" * ln)
        elif op == BAM_CINS:
            for _ in range(ln):
                qp = p.qpos + j - p.is_del
                out.append(seq[qp] if qp < p.b.l_qseq else "N")
                j += 1
        else:
            if op == BAM_CDEL:
                del_len = ln
            break
        k += 1
    return "".join(out), del_len


# ---------------------------------------------------------------------------
# overlap quality tweaking (sam.c:5700-5940)
# ---------------------------------------------------------------------------

def _x31_hash(s: bytes) -> int:
    h = 0
    for c in s:
        h = ((h << 5) - h + c) & 0xFFFFFFFF
    return h


def _wang_hash(key: int) -> int:
    key = (key + (~(key << 15) & 0xFFFFFFFF)) & 0xFFFFFFFF
    key ^= key >> 10
    key = (key + ((key << 3) & 0xFFFFFFFF)) & 0xFFFFFFFF
    key ^= key >> 6
    key = (key + (~(key << 11) & 0xFFFFFFFF)) & 0xFFFFFFFF
    key ^= key >> 16
    return key


class _CigCursor:
    """cigar_iref2iseq_set/next state over one read."""

    __slots__ = ("cigar", "ci", "icig", "iseq", "iref")

    def __init__(self, b: BamRecord):
        self.cigar = b.cigar
        self.ci = 0
        self.icig = 0
        self.iseq = 0
        self.iref = 0

    def set(self, pos: int) -> int:
        if pos < 0:
            return -1
        self.icig = self.iseq = self.iref = 0
        while self.ci < len(self.cigar):
            c = int(self.cigar[self.ci])
            op, ln = c & 0xF, c >> 4
            if op == BAM_CSOFT_CLIP:
                self.ci += 1
                self.iseq += ln
                self.icig = 0
                continue
            if op in (BAM_CHARD_CLIP, BAM_CPAD):
                self.ci += 1
                self.icig = 0
                continue
            if op in _M_OPS:
                pos -= ln
                if pos < 0:
                    self.icig = ln + pos
                    self.iseq += self.icig
                    self.iref += self.icig
                    return BAM_CMATCH
                self.ci += 1
                self.iseq += ln
                self.icig = 0
                self.iref += ln
                continue
            if op == BAM_CINS:
                self.ci += 1
                self.iseq += ln
                self.icig = 0
                continue
            if op in (BAM_CDEL, BAM_CREF_SKIP):
                pos -= ln
                if pos < 0:
                    pos = 0
                self.ci += 1
                self.icig = 0
                self.iref += ln
                continue
            return -2
        self.iseq = -1
        return -1

    def next(self) -> int:
        while self.ci < len(self.cigar):
            c = int(self.cigar[self.ci])
            op, ln = c & 0xF, c >> 4
            if op in _M_OPS:
                if self.icig >= ln - 1:
                    self.icig = -1
                    self.ci += 1
                    continue
                self.iseq += 1
                self.icig += 1
                self.iref += 1
                return BAM_CMATCH
            if op in (BAM_CDEL, BAM_CREF_SKIP):
                self.ci += 1
                self.iref += ln
                self.icig = -1
                continue
            if op == BAM_CINS or op == BAM_CSOFT_CLIP:
                self.ci += 1
                self.iseq += ln
                self.icig = -1
                continue
            if op in (BAM_CHARD_CLIP, BAM_CPAD):
                self.ci += 1
                self.icig = -1
                continue
            return -2
        self.iseq = -1
        self.iref = -1
        return -1

    def prev_op_is_del(self) -> bool:
        return self.ci > 0 and (int(self.cigar[self.ci - 1]) & 0xF) == BAM_CDEL


def tweak_overlap_quality(na: _Node, nb: _Node) -> int:
    """tweak_overlap_quality (sam.c:5803) on the nodes' mutable quals."""
    a, b = na.b, nb.b
    ca, cb = _CigCursor(a), _CigCursor(b)
    a_seq4 = np.frombuffer(a.seq4, np.uint8)
    b_seq4 = np.frombuffer(b.seq4, np.uint8)

    def seqi(s4, i):
        byte = s4[i >> 1]
        return (byte >> 4) if (i & 1) == 0 else (byte & 0xF)

    iref = b.pos
    a_ret = ca.set(iref - a.pos)
    if a_ret < 0:
        return -1 if a_ret < -1 else 0
    b_ret = cb.set(iref - b.pos)
    if b_ret < 0:
        return -1 if b_ret < -1 else 0
    if _wang_hash(_x31_hash(a.qname)) & 1:
        amul, bmul = 1, 0
    else:
        amul, bmul = 0, 1
    while True:
        while a_ret >= 0 and ca.iref >= 0 and ca.iref < iref - a.pos:
            a_ret = ca.next()
        if a_ret < 0:
            return -1 if a_ret < -1 else 0
        while b_ret >= 0 and cb.iref >= 0 and cb.iref < iref - b.pos:
            b_ret = cb.next()
        if b_ret < 0:
            return -1 if b_ret < -1 else 0
        if iref < ca.iref + a.pos:
            iref = ca.iref + a.pos
        if iref < cb.iref + b.pos:
            iref = cb.iref + b.pos
        iref += 1
        if ca.iref + a.pos != cb.iref + b.pos:
            if (ca.iref + a.pos < cb.iref + b.pos and cb.prev_op_is_del()):
                while True:
                    na.qual[ca.iseq] = int(na.qual[ca.iseq] * 0.8) if amul else 0
                    a_ret = ca.next()
                    if a_ret < 0:
                        return -1 if a_ret < -1 else 0
                    if not (ca.iref + a.pos < cb.iref + b.pos):
                        break
            elif (cb.iref + b.pos < ca.iref + a.pos and ca.prev_op_is_del()):
                while True:
                    nb.qual[cb.iseq] = int(nb.qual[cb.iseq] * 0.8) if bmul else 0
                    b_ret = cb.next()
                    if b_ret < 0:
                        return -1 if b_ret < -1 else 0
                    if not (cb.iref + b.pos < ca.iref + a.pos):
                        break
            else:
                continue
        if ca.iseq > a.l_qseq or cb.iseq > b.l_qseq:
            return -1
        if seqi(a_seq4, ca.iseq) == seqi(b_seq4, cb.iseq):
            q = na.qual[ca.iseq] + nb.qual[cb.iseq]
            q = 200 if q > 200 else q
            na.qual[ca.iseq] = amul * q
            nb.qual[cb.iseq] = bmul * q
        else:
            if na.qual[ca.iseq] > nb.qual[cb.iseq]:
                na.qual[ca.iseq] = int(0.8 * na.qual[ca.iseq])
                nb.qual[cb.iseq] = 0
            elif na.qual[ca.iseq] < nb.qual[cb.iseq]:
                nb.qual[cb.iseq] = int(0.8 * nb.qual[cb.iseq])
                na.qual[ca.iseq] = 0
            else:
                na.qual[ca.iseq] = amul * int(0.8 * na.qual[ca.iseq])
                nb.qual[cb.iseq] = bmul * int(0.8 * nb.qual[cb.iseq])


# ---------------------------------------------------------------------------
# the iterator
# ---------------------------------------------------------------------------

class Pileup:
    """bam_plp_t: push sorted records, pull columns."""

    def __init__(self, read_func: Optional[Callable[[], Optional[BamRecord]]] = None,
                 overlaps: bool = False, maxcnt: int = 8000):
        self.func = read_func
        self.nodes: List[_Node] = []
        self.tid = -1
        self.pos = 0
        self.max_tid = -1
        self.max_pos = -1
        self.is_eof = False
        self.error = False
        self.overlaps: Optional[Dict[bytes, _Node]] = {} if overlaps else None
        self.maxcnt = maxcnt

    # -- push side ------------------------------------------------------
    def push(self, b: Optional[BamRecord]) -> int:
        if self.error:
            return -1
        if b is None:
            self.is_eof = True
            return 0
        if b.tid < 0 or (b.flag & FUNMAP):
            self._overlap_remove(b)
            return 0
        node = _Node(b.copy())
        node.b.qual = bytes(node.qual)  # decouple; qual accessed via node
        if b.tid < self.max_tid:
            self.error = True
            raise ValueError("The input is not sorted (chromosomes out of order)")
        if b.tid == self.max_tid and node.beg < self.max_pos:
            self.error = True
            raise ValueError("The input is not sorted (reads out of order)")
        self.max_tid, self.max_pos = b.tid, node.beg
        if node.end > self.pos or b.tid > self.tid:
            if self._overlap_push(node) < 0:
                self.error = True
                return -1
            self.nodes.append(node)
        return 0

    def _overlap_push(self, node: _Node) -> int:
        if self.overlaps is None:
            return 0
        b = node.b
        if (b.flag & FMUNMAP) or not (b.flag & FPROPER_PAIR):
            return 0
        if (b.mtid >= 0 and b.tid != b.mtid) or \
                (abs(b.isize) >= 2 * b.l_qseq and b.mpos >= node.end):
            return 0
        key = b.qname
        mate = self.overlaps.get(key)
        if mate is None:
            if b.mpos >= b.pos or ((b.flag & FPAIRED) and b.mpos == -1):
                self.overlaps[key] = node
            return 0
        err = tweak_overlap_quality(mate, node)
        del self.overlaps[key]
        return err or 0

    def _overlap_remove(self, b: Optional[BamRecord]) -> None:
        if self.overlaps is None:
            return
        if b is None:
            self.overlaps.clear()
        elif not ((b.flag & FUNMAP) or not (b.flag & FPROPER_PAIR)):
            self.overlaps.pop(b.qname, None)

    # -- pull side ------------------------------------------------------
    def next_column(self) -> Optional[Tuple[int, int, List[PileupRead]]]:
        """bam_plp64_next (sam.c:6011)."""
        if self.error:
            return None
        if self.is_eof and not self.nodes:
            return None
        while (self.is_eof or self.max_tid > self.tid
               or (self.max_tid == self.tid and self.max_pos > self.pos)):
            plp: List[PileupRead] = []
            keep: List[_Node] = []
            for node in self.nodes:
                if node.b.tid < self.tid or (node.b.tid == self.tid
                                             and node.end <= self.pos):
                    self._overlap_remove(node.b)
                    continue
                if node.b.tid == self.tid and node.beg <= self.pos:
                    p = PileupRead(node.b)
                    # expose tweaked quals
                    node.b.qual = bytes(node.qual)
                    _resolve_cigar2(p, self.pos, node)
                    plp.append(p)
                keep.append(node)
            self.nodes = keep
            tid, pos = self.tid, self.pos
            if self.nodes:
                head = self.nodes[0]
                if self.tid > head.b.tid:
                    self.error = True
                    raise ValueError("Unsorted input. Pileup aborts")
                if self.tid < head.b.tid:
                    self.tid = head.b.tid
                    self.pos = head.beg
                elif self.pos < head.beg:
                    self.pos = head.beg
                else:
                    self.pos += 1
            else:
                self.pos += 1
            if plp:
                return tid, pos, plp
            if self.is_eof and not self.nodes:
                break
        return None

    def auto(self) -> Optional[Tuple[int, int, List[PileupRead]]]:
        """bam_plp_auto: pull, reading more input as needed."""
        while True:
            col = self.next_column()
            if col is not None:
                return col
            if self.is_eof:
                return None
            b = self.func() if self.func else None
            self.push(b)

    def __iter__(self) -> Iterator[Tuple[int, int, List[PileupRead]]]:
        while True:
            col = self.auto()
            if col is None:
                return
            yield col


def _format_plp_column(header, tid: int, pos: int, plp) -> str:
    """test/pileup.c:76-133 column format (the JAX package's native
    engine writes the same)."""
    out = [header.tid2name(tid), str(pos + 1), str(len(plp))]
    seq_parts = []
    for p in plp:
        is_rev = bool(p.b.flag & 0x10)
        if p.is_head:
            seq_parts.append("^" + chr(ord("!") + min(p.b.mapq, 93)))
        if p.is_del:
            seq_parts.append(("<" if is_rev else ">") if p.is_refskip
                             else "*")
        else:
            c = p.b.seq[p.qpos]
            seq_parts.append(c.lower() if is_rev else c.upper())
        ins, del_len = plp_insertion(p)
        if p.indel > 0:
            seq_parts.append(f"+{len(ins)}(" +
                             (ins.lower() if is_rev else ins.upper()) + ")")
        else:
            del_len = -p.indel
        if del_len > 0:
            seq_parts.append(f"-{del_len}()")
        if p.is_tail:
            seq_parts.append("$")
    quals = []
    for p in plp:
        q = "~"
        if p.qpos < p.b.l_qseq and p.b.qual[p.qpos] + 33 < ord("~"):
            q = chr(p.b.qual[p.qpos] + 33)
        quals.append(q)
    return "\t".join(["\t".join(out[:3]), "".join(seq_parts),
                      "".join(quals)])


class MultiPileup:
    """bam_mplp_t (sam.c:6211): n samples iterated in locus lock-step."""

    def __init__(self, read_funcs: List[Callable[[], Optional[BamRecord]]],
                 overlaps: bool = False, maxcnt: int = 8000):
        self.iters = [Pileup(f, overlaps=overlaps, maxcnt=maxcnt)
                      for f in read_funcs]
        self._cur: List[Optional[Tuple[int, int, List[PileupRead]]]] = [
            None] * len(read_funcs)
        self._started = False

    def auto(self) -> Optional[Tuple[int, int, List[Optional[List[PileupRead]]]]]:
        n = len(self.iters)
        if not self._started:
            for i in range(n):
                self._cur[i] = self.iters[i].auto()
            self._started = True
        live = [(c[0], c[1]) for c in self._cur if c is not None]
        if not live:
            return None
        min_key = min(live)
        tid, pos = min_key
        out: List[Optional[List[PileupRead]]] = []
        any_data = False
        for i in range(n):
            c = self._cur[i]
            if c is not None and (c[0], c[1]) == min_key:
                out.append(c[2])
                any_data = True
                self._cur[i] = self.iters[i].auto()
            else:
                out.append(None)
        if not any_data:
            return None
        return tid, pos, out


DEFAULT_SKIP = FUNMAP | FSECONDARY | FQCFAIL | FDUP
_KEY_LO = (-(1 << 30), 0)
_KEY_HI = ((1 << 30), 1 << 62)
_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1


def _sam_stream(path, dev, timing: dict):
    """A SAM file's header and its records as a u32-framed BAM record
    stream (`sam_text_to_bam`, the counterpart of the JAX package's
    native sam_to_bam); plain, gzip or BGZF text."""
    import io

    from htslib_tpu_torch import _build
    from htslib_tpu_torch.bgzf import BgzfReader, read_file
    from htslib_tpu_torch.sam.batch import sam_text_to_bam
    from htslib_tpu_torch.sam.samtext import SamReader

    t0 = _build.clock(dev)
    text = read_file(path).tobytes()
    if text[:2] == b"\x1f\x8b":
        text = BgzfReader(io.BytesIO(text)).read(-1)
    header = SamReader(io.BytesIO(text)).header
    t1 = _build.clock(dev)
    stream = sam_text_to_bam(text, header).tobytes()
    timing["read_s"] = t1 - t0
    timing["parse_s"] = _build.clock(dev) - t1
    return header, stream


def decode_records(payload: bytes, device="cuda",
                   timing: Optional[dict] = None, bases: bool = True
                   ) -> dict:
    """Frame a u32-length-prefixed BAM record stream and decode what the
    pileup needs, on `device`: the record offsets and sizes by
    `device_record_scan` (X5), each record's tid, pos, end (bam_endpos:
    pos + the reference span of its CIGAR ops M/D/N/=/X, at least 1; pos
    + 1 where unmapped, as the JAX package's native bam_fields has it)
    and flag, and every record's bases by `nibble_to_base` (B1) in one
    launch over the records' packed sequences laid end to end.  Returns
    numpy int64 columns "offs", "sizes", "tid", "pos", "end", "flag",
    "l_qseq", the bases as bytes ("bases": each record's
    2 * ceil(l_qseq / 2) characters at "base_offs").  Raises IOError on
    a truncated stream and ValueError on a record shorter than its core.
    With `bases` False, B1 is not launched and "bases" and "base_offs"
    are left out.  `timing`, where given, gets scan_s (X5, the checks and
    the fields) and bases_s (the gather, B1 and the download)."""
    import torch

    from htslib_tpu_torch import _build
    from htslib_tpu_torch.ops.bam2sam import _gather_rows, device_record_scan
    from htslib_tpu_torch.ops.seqfmt import nibble_to_base, unpack_core_fields

    dev = _build.resolve_device(device)
    timing = {} if timing is None else timing
    t0 = _build.clock(dev)
    u = len(payload)
    pl_t = torch.from_numpy(np.frombuffer(payload, np.uint8).copy()).to(dev)
    offs, sizes, n = device_record_scan(pl_t, u // 36 + 1)
    n = int(n)
    offs, sizes = offs[:n].long(), sizes[:n].long()
    end_at = int(offs[-1] + 4 + sizes[-1]) if n else 0
    if end_at != u:
        raise IOError("truncated BAM record stream")
    if n and bool((sizes < 32).any()):
        raise ValueError("BAM record too short")
    base = offs + 4
    f = unpack_core_fields(_gather_rows(pl_t, base, 32))
    n_cig = f["n_cigar"].long()
    cig_at = base + 32 + f["l_qname"].long()
    ar = torch.arange(n, device=dev)
    rec_of_op = torch.repeat_interleave(ar, n_cig)
    k = torch.arange(len(rec_of_op), device=dev) - (
        torch.cumsum(n_cig, 0) - n_cig)[rec_of_op]
    word = _gather_rows(pl_t, cig_at[rec_of_op] + 4 * k, 4).long()
    word = word[:, 0] | (word[:, 1] << 8) | (word[:, 2] << 16) | (
        word[:, 3] << 24)
    op = word & 0xF
    ref_op = (op == 0) | (op == 2) | (op == 3) | (op == 7) | (op == 8)
    span = torch.zeros(n, dtype=torch.long, device=dev).index_add_(
        0, rec_of_op, torch.where(ref_op, word >> 4, 0))
    flag = f["flag"].long()
    span = torch.where((flag & FUNMAP) == 0, span, 0)
    pos = f["pos"].long()
    cols = {"offs": offs, "sizes": sizes, "tid": f["tid"].long(), "pos": pos,
            "end": pos + torch.where(span > 0, span, 1), "flag": flag,
            "l_qseq": f["l_qseq"].long()}
    out = {key: v.cpu().numpy() for key, v in cols.items()}
    t1 = _build.clock(dev)
    timing["scan_s"] = t1 - t0
    if not bases:
        return out
    plen = (cols["l_qseq"].clamp(min=0) + 1) // 2
    t = int(plen.sum())
    if t:
        rec_of_b = torch.repeat_interleave(ar, plen)
        within = torch.arange(t, device=dev) - (
            torch.cumsum(plen, 0) - plen)[rec_of_b]
        seq_at = cig_at + 4 * n_cig
        packed = pl_t[(seq_at[rec_of_b] + within).clamp(0, u - 1)]
        out["bases"] = nibble_to_base(packed.view(1, t)).cpu().numpy(
            ).tobytes()
    else:
        out["bases"] = b""
    out["base_offs"] = np.concatenate(
        [[0], np.cumsum(2 * plen.cpu().numpy())]).astype(np.int64)
    timing["bases_s"] = _build.clock(dev) - t1
    return out


def _read_stream(path: str, is_sam: bool, device, timing: dict):
    """(header, the uncompressed record stream, `decode_records`' columns)
    of a BAM or SAM file, read as mpileup's entry points read it."""
    from htslib_tpu_torch import _build
    from htslib_tpu_torch.sam.batch import read_bam_stream

    dev = _build.resolve_device(device)
    if is_sam:
        header, stream = _sam_stream(path, dev, timing)
    else:
        header, stream = read_bam_stream(path, dev, timing)
    return header, stream, decode_records(stream, dev, timing)


def _native_stream(path: str, is_sam: bool, dev, timing: dict):
    """(header, the uncompressed record stream) as the native route reads
    them: a BAM by `read_bam_stream` (X4 on the card), a SAM's text on
    the host and its body (past the @ lines) parsed by `native.sam_to_bam`,
    which raises IOError on a line it refuses."""
    import io

    from htslib_tpu_torch import _build
    from htslib_tpu_torch.bgzf import BgzfReader, read_file
    from htslib_tpu_torch.native import native
    from htslib_tpu_torch.sam.batch import read_bam_stream
    from htslib_tpu_torch.sam.samtext import SamReader

    if not is_sam:
        return read_bam_stream(path, dev, timing)
    t0 = _build.clock(dev)
    text = read_file(path).tobytes()
    if text[:2] == b"\x1f\x8b":
        text = BgzfReader(io.BytesIO(text)).read(-1)
    header = SamReader(io.BytesIO(text)).header
    # skip the @-header block with one scan, no split
    p = 0
    while p < len(text) and text[p:p + 1] == b"@":
        nl = text.find(b"\n", p)
        if nl < 0:
            p = len(text)
            break
        p = nl + 1
    t1 = _build.clock(dev)
    stream = native.sam_to_bam(np.frombuffer(text, np.uint8, len(text) - p,
                                             p), header.ref_names).tobytes()
    timing["read_s"] = t1 - t0
    timing["parse_s"] = _build.clock(dev) - t1
    return header, stream


def _native_text(path: str, is_sam: bool, device, skip_mask: int,
                 overlaps: bool, timing: dict, stages: Optional[dict]):
    """`mpileup_text` by the native engine: (header, text), or None where
    the caller runs the Python engine, as the JAX function falls back:
    where a SAM's parser or engine refuses the input (IOError, the
    engine's BlockingIOError included).  A BAM's engine refusal gives no
    column, as the JAX function gives none there: its fallback engine
    reads the reader whose stream it has already read whole (ROADMAP
    queue C, a CIGAR in a CG tag)."""
    from htslib_tpu_torch import _build
    from htslib_tpu_torch.native import native

    dev = _build.resolve_device(device)
    try:
        header, stream = _native_stream(path, is_sam, dev, timing)
    except IOError:
        if is_sam:
            return None
        raise
    t0 = time.perf_counter()
    try:
        text = native.mpileup(np.frombuffer(stream, np.uint8),
                              header.ref_names, skip_mask, overlaps)
    except IOError:         # BlockingIOError (the engine's bail) included
        if is_sam:
            return None
        text = b""
    timing.update(plan_s=0.0, engine_s=time.perf_counter() - t0,
                  format_s=0.0)
    if stages is not None:
        stages.update(payload=stream)
    return header, text


def records_with_bases(payload: bytes, offs: np.ndarray, sizes: np.ndarray,
                       flags: np.ndarray, l_qseq: np.ndarray, bases: bytes,
                       base_offs: np.ndarray, skip_mask: int
                       ) -> List[BamRecord]:
    """The records at `offs` of `payload` whose flags miss `skip_mask`,
    parsed on the host (bam_tag2cigar included), each carrying its bases
    from `bases` at `base_offs` (`decode_records`' B1 output)."""
    mv = memoryview(payload)
    recs: List[BamRecord] = []
    for k in np.flatnonzero((flags & skip_mask) == 0).tolist():
        rec = BamRecord.from_bam_buffer(mv, int(offs[k]) + 4, int(sizes[k]))
        if l_qseq[k] > 0:
            at = int(base_offs[k])
            rec.seq_text = bases[at:at + int(l_qseq[k])].decode("ascii")
        recs.append(rec)
    return recs


def read_records(path: str, is_sam: bool, device="cuda",
                 skip_mask: int = DEFAULT_SKIP,
                 timing: Optional[dict] = None):
    """(header, the records whose flags miss `skip_mask`) of a BAM or
    SAM file, read and decoded on `device` as mpileup's entry points read
    it, each record carrying its bases (B1)."""
    timing = {} if timing is None else timing
    header, stream, rs = _read_stream(path, is_sam, device, timing)
    return header, records_with_bases(stream, rs["offs"], rs["sizes"],
                                      rs["flag"], rs["l_qseq"], rs["bases"],
                                      rs["base_offs"], skip_mask)


def _tile_text(names: List[str], payload: bytes, offs: np.ndarray,
               sizes: np.ndarray, flags: np.ndarray, l_qseq: np.ndarray,
               bases: bytes, base_offs: np.ndarray, skip_mask: int,
               overlaps: bool, window=None) -> Tuple[bytes, dict]:
    """The engine over the records at `offs` of `payload` (their bases
    at `base_offs` of `bases`), those with a flag in `skip_mask` left
    out (readaln, test/pileup.c:62); only columns with lo <= (tid, pos)
    < hi are written where `window` = (lo, hi) is given (halo reads are
    still pushed, so the overlap tweak stays exact).  Returns (text, its
    counts: engine_s, format_s, columns, entries)."""
    t0 = time.perf_counter()
    recs = records_with_bases(payload, offs, sizes, flags, l_qseq, bases,
                              base_offs, skip_mask)
    header = SamHeader(ref_names=names)
    lo, hi = window if window is not None else (_KEY_LO, _KEY_HI)
    lines: List[str] = []
    fmt_s = 0.0
    entries = 0
    it = iter(recs + [None])
    for tid, pos, col in Pileup(lambda: next(it), overlaps=overlaps):
        if tid < 0:
            break
        if (tid, pos) < lo:
            continue
        if (tid, pos) >= hi:
            break
        t1 = time.perf_counter()
        lines.append(_format_plp_column(header, tid, pos, col))
        fmt_s += time.perf_counter() - t1
        entries += len(col)
    blob = ("\n".join(lines) + ("\n" if lines else "")).encode()
    return blob, {"engine_s": time.perf_counter() - t0 - fmt_s,
                  "format_s": fmt_s, "columns": len(lines),
                  "entries": entries}


def _whole_text(header, stream: bytes, rs: dict, skip_mask: int,
                overlaps: bool, timing: dict) -> bytes:
    blob, counts = _tile_text(list(header.ref_names), stream, rs["offs"],
                              rs["sizes"], rs["flag"], rs["l_qseq"],
                              rs["bases"], rs["base_offs"], skip_mask,
                              overlaps)
    timing.update(counts)
    return blob


def mpileup_text(path: str, overlaps: bool = True,
                 skip_mask: int = DEFAULT_SKIP, device="cuda",
                 timing: Optional[dict] = None,
                 stages: Optional[dict] = None) -> Tuple[object, bytes]:
    """Whole-file pileup text in the test/pileup.c column format:
    (header, text), byte for byte the JAX function's.  A name ending in
    ".bam" is read as BAM, anything else as SAM; the record stream is
    read and decoded on `device` (module docstring: X4 for a BAM, X5, B1)
    and the engine runs in this process: the native engine where the
    library is on (module docstring), else the Python engine.  A build or
    launch that fails raises; nothing falls back to the CPU.  `timing`,
    where given, gets read_s, inflate_s (BAM) or parse_s (SAM), plan_s
    (0 here), engine_s and format_s (0 on the native route, whose engine
    writes the text), and on the Python route scan_s, bases_s, columns
    and entries; `stages`, where given, gets the stream ("payload") and,
    on the Python route, `decode_records`' columns."""
    timing = {} if timing is None else timing
    is_sam = not path.endswith(".bam")
    from htslib_tpu_torch.native import native
    if native is not None:
        out = _native_text(path, is_sam, device, skip_mask, overlaps, timing,
                           stages)
        if out is not None:
            return out
    header, stream, rs = _read_stream(path, is_sam, device, timing)
    if stages is not None:
        stages.update(rs, payload=stream)
    timing["plan_s"] = 0.0
    return header, _whole_text(header, stream, rs, skip_mask, overlaps,
                               timing)


def plan_tiles(rs: dict, nthreads: int, skip_mask: int):
    """The JAX function's tile plan over `decode_records`' columns:
    bounds at every `per`-th mapped read's (tid, pos), kept where they
    rise, and for each tile (lo, hi) the contiguous record range [i0, i1]
    from the first mapped read whose span reaches past lo to the last
    that starts before hi (None where no read overlaps it).  Returns
    (tiles as ((lo, hi), (i0, i1) or None), the mapped reads' count)."""
    tids, poss, ends, flags = rs["tid"], rs["pos"], rs["end"], rs["flag"]
    mapped = ((flags & skip_mask) == 0) & (tids >= 0) & ((flags & 4) == 0)
    n_mapped = int(mapped.sum())
    m_idx = np.nonzero(mapped)[0]
    per = (n_mapped + nthreads - 1) // nthreads
    bounds = [_KEY_LO]
    for si in range(1, nthreads):
        i = si * per
        if i >= n_mapped:
            break
        k = (int(tids[m_idx[i]]), int(poss[m_idx[i]]))
        if k > bounds[-1]:
            bounds.append(k)
    bounds.append(_KEY_HI)
    pos_key = tids * (1 << 40) + poss
    end_key = tids * (1 << 40) + ends
    tiles = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        lo_k = max(lo[0] * (1 << 40) + lo[1], _I64_MIN)
        hi_k = min(hi[0] * (1 << 40) + hi[1], _I64_MAX)
        idx = np.nonzero(mapped & (end_key > lo_k) & (pos_key < hi_k))[0]
        tiles.append(((lo, hi), (int(idx[0]), int(idx[-1]))
                      if idx.size else None))
    return tiles, n_mapped


_POOL = None
_POOL_N = 0


def tile_pool(n: int):
    """The spawned process pool the tiles run in, kept between calls and
    grown to `n` processes where it has fewer."""
    global _POOL, _POOL_N
    if _POOL is None or _POOL_N < n:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        shutdown_pool()
        _POOL = ProcessPoolExecutor(
            max_workers=n, mp_context=multiprocessing.get_context("spawn"))
        _POOL_N = n
    return _POOL


def shutdown_pool() -> None:
    """Stop the tiles' processes (they also stop at the interpreter's
    exit)."""
    global _POOL, _POOL_N
    if _POOL is not None:
        _POOL.shutdown()
    _POOL, _POOL_N = None, 0


def mpileup_text_parallel(path: str, nthreads: int = 0,
                          overlaps: bool = True,
                          skip_mask: int = DEFAULT_SKIP, device="cuda",
                          timing: Optional[dict] = None,
                          stages: Optional[dict] = None
                          ) -> Tuple[object, bytes]:
    """Coordinate-sharded parallel mpileup: the genome splits into
    read-count-balanced tiles (`plan_tiles`, the JAX function's plan),
    each tile's process runs the engine over every read in its
    contiguous record range (halo replication keeps overlap-pair quality
    tweaking exact: the tweak only touches positions covered by both
    mates, so any pair affecting a tile column has both mates in the
    tile's read set) and writes only its own columns.  The concatenated
    text is byte-identical to `mpileup_text`'s.  The read and decode run
    on `device` in this process (as `mpileup_text`); the tiles run in
    `tile_pool(nthreads)`, spawned processes that get each tile's record
    bytes and bases and never touch the card.  `nthreads` 0 takes the
    CPU count; `nthreads` <= 1, or no mapped read, gives the serial text
    in this process.  `timing`, where given, gets `mpileup_text`'s keys
    (engine_s and format_s summed over the tiles), pool_s (the tiles'
    wall time), processes and tiles; `stages`, where given, gets
    `mpileup_text`'s and the plan ("tiles").  With the native library on,
    the JAX function's native route (`_native_parallel`) runs instead."""
    import os

    nthreads = nthreads or (os.cpu_count() or 2)
    timing = {} if timing is None else timing
    from htslib_tpu_torch.native import native
    if native is not None:
        return _native_parallel(path, nthreads, overlaps, skip_mask, device,
                                timing, stages)
    header, stream, rs = _read_stream(path, not path.endswith(".bam"),
                                      device, timing)
    t0 = time.perf_counter()
    tiles, n_mapped = plan_tiles(rs, nthreads, skip_mask)
    timing["plan_s"] = time.perf_counter() - t0
    if stages is not None:
        stages.update(rs, payload=stream, tiles=tiles)
    if n_mapped == 0 or nthreads <= 1:
        return header, _whole_text(header, stream, rs, skip_mask, overlaps,
                                   timing)
    t0 = time.perf_counter()
    names = list(header.ref_names)
    tasks = []
    for window, rng in tiles:
        if rng is None:
            continue
        i0, i1 = rng
        a, b = int(rs["offs"][i0]), int(rs["offs"][i1] + 4 + rs["sizes"][i1])
        ba, bb = int(rs["base_offs"][i0]), int(rs["base_offs"][i1 + 1])
        tasks.append((names, stream[a:b], rs["offs"][i0:i1 + 1] - a,
                      rs["sizes"][i0:i1 + 1], rs["flag"][i0:i1 + 1],
                      rs["l_qseq"][i0:i1 + 1], rs["bases"][ba:bb],
                      rs["base_offs"][i0:i1 + 1] - ba, skip_mask, overlaps,
                      window))
    timing["plan_s"] += time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = list(tile_pool(nthreads).map(_tile_text, *zip(*tasks)))
    timing["pool_s"] = time.perf_counter() - t0
    for key in ("engine_s", "format_s", "columns", "entries"):
        timing[key] = sum(c[key] for _, c in outs)
    timing["processes"] = nthreads
    timing["tiles"] = len(tiles)
    return header, b"".join(blob for blob, _ in outs)


def _native_parallel(path: str, nthreads: int, overlaps: bool,
                     skip_mask: int, device, timing: dict,
                     stages: Optional[dict]) -> Tuple[object, bytes]:
    """`mpileup_text_parallel` by the native engine, as the JAX function
    runs it: the stream read (`_native_stream`), framed with its planner
    fields on `device` (`decode_records` without B1), the tiles of
    `plan_tiles`, and `native.mpileup` over each tile's record range with
    the tile as its emission window, on pipeline.py's shared threads (the
    engine drops the GIL).  No mapped read, or `nthreads` <= 1, runs the
    engine once over the whole stream.  A refusal of the parser or the
    engine raises, as in the JAX function.  `timing` gets read_s,
    inflate_s or parse_s, scan_s, plan_s, engine_s (the tiles' wall
    time), format_s (0), threads and tiles."""
    from htslib_tpu_torch import _build
    from htslib_tpu_torch.native import native
    from htslib_tpu_torch.pipeline import shared_pool

    dev = _build.resolve_device(device)
    header, stream = _native_stream(path, not path.endswith(".bam"), dev,
                                    timing)
    rs = decode_records(stream, dev, timing, bases=False)
    t0 = time.perf_counter()
    tiles, n_mapped = plan_tiles(rs, nthreads, skip_mask)
    timing["plan_s"] = time.perf_counter() - t0
    if stages is not None:
        stages.update(rs, payload=stream, tiles=tiles)
    names = list(header.ref_names)
    arr = np.frombuffer(stream, np.uint8)
    t0 = time.perf_counter()
    if n_mapped == 0 or nthreads <= 1:
        outs = [native.mpileup(arr, names, skip_mask, overlaps)]
    else:
        def run_tile(tile):
            window, rng = tile
            if rng is None:
                return b""
            i0, i1 = rng
            a = int(rs["offs"][i0])
            b = int(rs["offs"][i1] + 4 + rs["sizes"][i1])
            return native.mpileup(arr[a:b], names, skip_mask, overlaps,
                                  window=window)

        outs = list(shared_pool().map(run_tile, tiles))
    timing.update(engine_s=time.perf_counter() - t0, format_s=0.0,
                  threads=nthreads, tiles=len(tiles))
    return header, b"".join(outs)
