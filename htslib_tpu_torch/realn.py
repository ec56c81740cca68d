"""BAQ: probabilistic banded glocal HMM realignment of BAM records
(realn.c:106 sam_prob_realn; API htslib/sam.h:2140-2208), its HMM on the
card.

Port of htslib_tpu/realn.py: `ProbalnParams`, the BAQ_* flags, the
record bookkeeping around the HMM (`_realn_setup` :216, `_realn_apply`
:363) and `sam_prob_realn_batch` (:325), whose HMM runs for the whole
batch through ops/probaln.probaln_batch (kernel X6 on the card).  The
setup and apply stay per record on the host, as in the JAX design.
`sam_prob_realn` is a batch of one through the same op; the port keeps
no scalar HMM to fall back to.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from htslib_tpu_torch import _build
from htslib_tpu_torch.ops.probaln import probaln_arrays
from htslib_tpu_torch.sam.cigar import (BAM_CDEL, BAM_CDIFF, BAM_CEQUAL,
                                        BAM_CINS, BAM_CMATCH, BAM_CREF_SKIP,
                                        BAM_CSOFT_CLIP)
from htslib_tpu_torch.sam.record import FUNMAP, BamRecord, _NT16_TABLE

BAQ_APPLY = 1
BAQ_EXTEND = 2
BAQ_REDO = 4

# nt16 -> 0..4 (seq_nt16_int)
_NT16_INT = np.full(16, 4, np.uint8)
_NT16_INT[[1, 2, 4, 8]] = [0, 1, 2, 3]
_MATCH = (BAM_CMATCH, BAM_CEQUAL, BAM_CDIFF)


class ProbalnParams:
    def __init__(self, d=0.001, e=0.1, bw=10):
        self.d = d
        self.e = e
        self.bw = bw


def ref_codes(ref: str) -> np.ndarray:
    """A reference's 0..4 codes (seq_nt16_int of seq_nt16_table), once
    for every read of a batch."""
    return _NT16_INT[_NT16_TABLE[np.frombuffer(ref.encode("latin-1"),
                                               np.uint8)]]


def _realn_setup(b: BamRecord, ref: str, flag: int, codes: np.ndarray):
    """Front half of sam_prob_realn (realn.c:106): tag fixes, early
    exits, band/window computation, sequence translation.  Returns
    ('done', code) or ('run', (qual, conf, xb, tref, tseq)).  `codes` is
    ref_codes(ref)."""
    apply_baq = flag & BAQ_APPLY
    redo_baq = flag & BAQ_REDO
    conf = ProbalnParams(0.001, 0.1, 10)
    if b.l_qseq > 1000:
        conf.d, conf.e = 1e-7, 1e-1
    ref_len = len(ref)
    qual = bytearray(b.qual)
    if (b.flag & FUNMAP) or b.l_qseq == 0 or (qual and qual[0] == 0xFF):
        return "done", -1
    fix_bq = False
    bq = b.get_aux("BQ")
    zq = b.get_aux("ZQ")
    if bq is not None and not redo_baq:
        if len(bq) != b.l_qseq:
            fix_bq = True
    if zq is not None and len(zq) != b.l_qseq:
        return "done", -4
    if bq is not None and redo_baq:
        b.del_aux("BQ")
        bq = None
    if bq is not None and zq is not None:
        b.del_aux("ZQ")
        zq = None
    if zq is None and fix_bq:
        b.del_aux("BQ")
        bq = None
    if bq is not None or zq is not None:
        if ((apply_baq and zq is not None)
                or (not apply_baq and bq is not None)):
            return "done", -3
        if bq is not None and apply_baq:
            bqb = bq.encode("latin-1")
            for i in range(b.l_qseq):
                qual[i] = (0 if qual[i] + 64 < bqb[i]
                           else qual[i] - (bqb[i] - 64))
            b.qual = bytes(qual)
            b.del_aux("BQ")
            b.set_aux("ZQ", "Z", bq)
        elif zq is not None and not apply_baq:
            zqb = zq.encode("latin-1")
            for i in range(b.l_qseq):
                qual[i] = (qual[i] + zqb[i] - 64) & 0xFF
            b.qual = bytes(qual)
            b.del_aux("ZQ")
            b.set_aux("BQ", "Z", zq)
        return "done", 0

    # alignment extent
    x, y = b.pos, 0
    yb = ye = xb = xe = -1
    for op_l in b.cigar.tolist():
        op, ln = op_l & 0xF, op_l >> 4
        if op in _MATCH:
            if yb < 0:
                yb = y
            if xb < 0:
                xb = x
            ye = y + ln
            xe = x + ln
            x += ln
            y += ln
        elif op in (BAM_CSOFT_CLIP, BAM_CINS):
            y += ln
        elif op == BAM_CDEL:
            x += ln
        elif op == BAM_CREF_SKIP:
            return "done", -1
    if xb == -1:
        return "done", -1
    bw = 7
    if abs((xe - xb) - (ye - yb)) > bw:
        bw = abs((xe - xb) - (ye - yb)) + 3
    conf.bw = bw
    xb -= yb + bw // 2
    if xb < 0:
        xb = 0
    xe += b.l_qseq - ye + bw // 2
    if xe - xb - b.l_qseq > bw:
        adj = (xe - xb - b.l_qseq - bw) // 2
        xb += adj
        xe -= adj
    # translated sequences
    packed = np.frombuffer(b.seq4, np.uint8)
    nib = np.empty(b.l_qseq, np.uint8)
    nib[0::2] = packed[:(b.l_qseq + 1) // 2] >> 4
    nib[1::2] = packed[:b.l_qseq // 2] & 0xF
    tseq = _NT16_INT[nib].tobytes()
    if xe > ref_len:
        xe = ref_len
    tref = codes[xb:xe].tobytes()
    return "run", (qual, conf, xb, tref, tseq)


def sam_prob_realn(b: BamRecord, ref: str, flag: int = 0,
                   device="cuda") -> int:
    """sam_prob_realn (realn.c:106) of one record: a batch of one."""
    return sam_prob_realn_batch([b], ref, flag, device=device)[0]


def sam_prob_realn_batch(recs, ref: str, flag: int = 0, device="cuda",
                         timing: Optional[dict] = None) -> List[int]:
    """Batched sam_prob_realn: the banded-HMM MAP runs for the whole
    batch at once through ops/probaln (kernel X6 on the card), one call
    per (d, e) group (reads over 1,000 bp use d = 1e-7); tag bookkeeping
    and BAQ application stay per record.  Returns one sam_prob_realn code
    per input record.  `timing`, where given, gets seconds by part:
    setup_s (the host setup), the HMM calls' pad_s, upload_s, kernel_s
    and download_s, and apply_s (the host apply)."""
    dev = _build.resolve_device(device)
    t0 = _build.clock(dev)
    codes_ref = ref_codes(ref)
    codes: List[Optional[int]] = [None] * len(recs)
    groups: dict = {}   # (d, e) -> [(index, qual, conf, xb, tref, tseq)]
    for i, b in enumerate(recs):
        kind, payload = _realn_setup(b, ref, flag, codes_ref)
        if kind == "done":
            codes[i] = payload
        else:
            conf = payload[1]
            groups.setdefault((conf.d, conf.e), []).append((i,) + payload)
    t1 = _build.clock(dev)
    part = timing if timing is not None else {}
    results = {}
    for (d, e), grp in groups.items():
        results[d, e] = probaln_arrays(
            [r[4] for r in grp], [r[5] for r in grp],
            [bytes(r[1]) for r in grp], bws=[r[2].bw for r in grp], d=d,
            e=e, device=dev, timing=part)
    t2 = _build.clock(dev)
    for key, grp in groups.items():
        pr, st, qq, qlen = results[key]
        for k, (i, qual, _conf, xb, _tref, _tseq) in enumerate(grp):
            n = int(qlen[k])
            codes[i] = (-4 if pr[k] == -(1 << 31) else _realn_apply(
                recs[i], qual, xb, st[k, :n], qq[k, :n], flag))
    if timing is not None:
        timing.update(setup_s=t1 - t0, hmm_s=t2 - t1,
                      apply_s=_build.clock(dev) - t2,
                      runs=sum(len(g) for g in groups.values()),
                      groups={f"{d:g},{e:g}": len(g)
                              for (d, e), g in groups.items()})
    return codes


def _match_ok(state: np.ndarray, x: int, xb: int, y: int, ln: int):
    """Bases y..y+ln of a match op whose MAP state is a match at the
    reference position the CIGAR puts them."""
    st = state[y:y + ln]
    return ((st & 3) == 0) & ((st >> 2) == x - xb + np.arange(ln))


def _realn_apply(b: BamRecord, qual, xb: int, state, q, flag: int) -> int:
    """Back half of sam_prob_realn (realn.c): convert MAP states into
    BQ/ZQ offsets, optionally extend across match runs, apply."""
    apply_baq = flag & BAQ_APPLY
    extend_baq = flag & BAQ_EXTEND
    n = b.l_qseq
    qa = np.frombuffer(bytes(qual), np.uint8).astype(np.int64)
    st = np.asarray(state, np.int64)
    qq = np.asarray(q, np.uint8).astype(np.int64)
    bq = qa.copy()
    cig = [(c & 0xF, c >> 4) for c in b.cigar.tolist()]
    x, y = b.pos, 0
    if not extend_baq:
        for op, ln in cig:
            if ln == 0:
                continue
            if op in _MATCH:
                ln = min(ln, n - y)
                ok = _match_ok(st, x, xb, y, ln)
                bq[y:y + ln] = np.where(ok, np.minimum(bq[y:y + ln],
                                                       qq[y:y + ln]), 0)
                x += ln
                y += ln
            elif op in (BAM_CSOFT_CLIP, BAM_CINS):
                y += min(ln, n - y)
            elif op == BAM_CDEL:
                x += ln
        bq = (qa - bq + 64) & 0xFF
    else:
        length = 0
        for k, (op, ln) in enumerate(cig):
            if op in _MATCH:
                if k + 1 < len(cig) and cig[k + 1][0] in _MATCH:
                    length += ln
                    continue
                ln += length
                length = 0
            if ln == 0:
                continue
            if op in _MATCH:
                ln = min(ln, n - y)
                ok = _match_ok(st, x, xb, y, ln)
                if ln == 0:   # a CIGAR past the query, as JAX fails it
                    raise IndexError("bytearray index out of range")
                seg = np.where(ok, qq[y:y + ln], 0)
                left = np.maximum.accumulate(seg)
                rght = np.maximum.accumulate(seg[::-1])[::-1]
                bq[y:y + ln] = np.minimum(left, rght)
                x += ln
                y += ln
            elif op in (BAM_CSOFT_CLIP, BAM_CINS):
                y += min(ln, n - y)
            elif op == BAM_CDEL:
                x += ln
        bq = (64 + np.where(qa <= bq, 0, qa - bq)) & 0xFF
    bq_bytes = bq.astype(np.uint8).tobytes()
    if apply_baq:
        b.qual = ((qa - (bq - 64)) & 0xFF).astype(np.uint8).tobytes()
        b.set_aux("ZQ", "Z", bq_bytes)
    else:
        b.set_aux("BQ", "Z", bq_bytes)
    return 0
