"""Synced VCF/BCF reader, the port's copy of htslib_tpu/synced_reader.py
(reference synced_bcf_reader.c:1-1561; allele
pairing bcf_sr_sort.c:1-717; API htslib/synced_bcf_reader.h).

N variant files iterated in locus lock-step: each next_line() advances
to the next (chrom, pos) present in any reader and exposes one matching
record (or None) per reader.  Feature parity with the reference:

  * buffered multi-record-per-position lookahead
    (_reader_fill_buffer, synced_bcf_reader.c:653)
  * index-backed region jumps (TBI/CSI via tbx.py / index.py) with
    prev_end dedup of records spanning adjacent regions, plus a
    streaming region filter when no index exists
  * target filtering with the pos / record / variant overlap modes
  * the full bcf_sr_sort pairing matrix: variant/group decomposition,
    duplicate-record uniquifying, scored varset merging with
    exact-match and multi-allelic subset fast paths
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from htslib_tpu_torch.vcf import BcfRecord, open_vcf
from htslib_tpu_torch.vcf.header import BcfHeader

# htslib/synced_bcf_reader.h:85-92
BCF_SR_PAIR_SNPS = 1 << 0
BCF_SR_PAIR_INDELS = 1 << 1
BCF_SR_PAIR_ANY = 1 << 2
BCF_SR_PAIR_SOME = 1 << 3      # only exact/subset allele matches pair
BCF_SR_PAIR_SNP_REF = 1 << 4
BCF_SR_PAIR_INDEL_REF = 1 << 5
BCF_SR_PAIR_EXACT = 1 << 6
BCF_SR_PAIR_ID = 1 << 7
BCF_SR_PAIR_BOTH = BCF_SR_PAIR_SNPS | BCF_SR_PAIR_INDELS
BCF_SR_PAIR_BOTH_REF = (BCF_SR_PAIR_BOTH | BCF_SR_PAIR_SNP_REF
                        | BCF_SR_PAIR_INDEL_REF)
BCF_SR_PAIR_ALL = BCF_SR_PAIR_BOTH_REF | BCF_SR_PAIR_ANY

# variant types (htslib/vcf.h:590-606)
VCF_REF = 0
VCF_SNP = 1
VCF_MNP = 2
VCF_INDEL = 4
VCF_OTHER = 8
VCF_BND = 16
VCF_OVERLAP = 32
VCF_INS = 64
VCF_DEL = 128

# sort-internal types (bcf_sr_sort.c:11-14)
SR_REF = 1
SR_SNP = 2
SR_INDEL = 4
SR_OTHER = 8

_UINT32_MAX = 0xFFFFFFFF


def variant_type(ref: str, alt: str) -> int:
    """bcf_set_variant_type (vcf.c:5373): classify one REF>ALT pair."""
    if alt == "*":
        return VCF_OVERLAP
    if len(ref) == 1 and len(alt) == 1:
        if alt == "." or ref == alt or alt == "X":
            return VCF_REF
        return VCF_SNP
    if alt.startswith("<"):
        if alt in ("<X>", "<*>", "<NON_REF>"):
            return VCF_REF
        return VCF_OTHER
    if alt[0] in "][":
        return VCF_BND
    # strip common prefix
    i = 0
    while i < len(ref) and i < len(alt) and ref[i].upper() == alt[i].upper():
        i += 1
    r, a = ref[i:], alt[i:]
    if a and not r:
        if a[-1] in "][":
            return VCF_BND
        return VCF_INDEL | VCF_INS
    if r and not a:
        return VCF_INDEL | VCF_DEL
    if not r and not a:
        return VCF_REF
    if a[-1] in "][":
        return VCF_BND
    # strip common suffix (keeping at least one char each)
    j = 0
    while j < len(r) - 1 and j < len(a) - 1 and \
            r[-1 - j].upper() == a[-1 - j].upper():
        j += 1
    rc, ac = r[:len(r) - j], a[:len(a) - j]
    if len(ac) == 1:
        if len(rc) == 1:
            return VCF_SNP
        if rc[0].upper() == ac[0].upper():
            return VCF_INDEL | VCF_DEL
        return VCF_OTHER
    if len(rc) == 1:
        if rc[0].upper() == ac[0].upper():
            return VCF_INDEL | VCF_INS
        return VCF_OTHER
    return VCF_MNP if len(rc) == len(ac) else VCF_OTHER


def record_var_type(rec: BcfRecord) -> int:
    """bcf_get_variant_types equivalent: OR over all ALT alleles."""
    t = 0
    for alt in rec.alleles[1:]:
        t |= variant_type(rec.alleles[0], alt)
    return t


def _sr_type(vt: int) -> int:
    """VCF_* composite -> SR_* composite (bcf_sr_sort.c:526-536)."""
    if vt == VCF_REF:
        return SR_REF
    t = 0
    if vt & VCF_SNP:
        t |= SR_SNP
    if vt & VCF_MNP:
        t |= SR_SNP
    if vt & VCF_INDEL:
        t |= SR_INDEL
    if vt & VCF_OTHER:
        t |= SR_OTHER
    return t


def _init_scores(pair: int) -> List[int]:
    """bcf_sr_init_scores (bcf_sr_sort.c:36): 256-entry pairwise type
    score matrix; 0 = forbidden."""
    score = [0] * 256
    if pair & BCF_SR_PAIR_ANY:
        pair |= (BCF_SR_PAIR_SNPS | BCF_SR_PAIR_INDELS
                 | BCF_SR_PAIR_SNP_REF | BCF_SR_PAIR_INDEL_REF)
    if pair & BCF_SR_PAIR_SNPS:
        score[(SR_SNP << 4) | SR_SNP] = 3
    if pair & BCF_SR_PAIR_INDELS:
        score[(SR_INDEL << 4) | SR_INDEL] = 3
    if pair & BCF_SR_PAIR_SNP_REF:
        score[(SR_SNP << 4) | SR_REF] = 2
        score[(SR_REF << 4) | SR_SNP] = 2
    if pair & BCF_SR_PAIR_INDEL_REF:
        score[(SR_INDEL << 4) | SR_REF] = 2
        score[(SR_REF << 4) | SR_INDEL] = 2
    if pair & BCF_SR_PAIR_ANY:
        for i in range(256):
            if not score[i]:
                score[i] = 1
    for i in range(256):
        if score[i]:
            continue
        mx = 0
        for jbit in range(4):
            j = 1 << jbit
            if not (i & (j << 4)):
                continue
            for kbit in range(4):
                k = 1 << kbit
                if not (i & k):
                    continue
                mx = max(mx, score[(j << 4) | k])
        score[i] = mx
    return score


def _als_set(s: str) -> List[str]:
    return [x.upper() for x in s.split(",")]


def _multi_is_exact(a: str, b: str) -> bool:
    """multi_is_exact (bcf_sr_sort.c:94): same alleles, any order."""
    aa, bb = _als_set(a), _als_set(b)
    if len(aa) != len(bb) or len(a) != len(b):
        return False
    return all(x in bb for x in aa)


def _multi_is_subset(a: str, b: str) -> bool:
    """multi_is_subset (bcf_sr_sort.c:133): any shared allele."""
    bb = _als_set(b)
    return any(x in bb for x in _als_set(a))


class _Var:
    __slots__ = ("str", "type", "nalt", "vcf", "rec", "mask")

    def __init__(self, s: str):
        self.str = s            # base string, no dup suffix
        self.type = 0           # SR_* composite
        self.nalt = 0
        self.vcf: List[int] = []
        self.rec: List[BcfRecord] = []
        self.mask = 0           # bitmask of groups


class _VarSet:
    __slots__ = ("vars", "mask", "cnt")

    def __init__(self, ivar: int, mask: int, cnt: int):
        self.vars = [ivar]
        self.mask = mask
        self.cnt = cnt


# ---------------------------------------------------------------------------
# regions
# ---------------------------------------------------------------------------

_MAX_COOR = (1 << 50) - 1    # MAX_CSI_COOR-ish sentinel


def _parse_decimal(s: str, i: int) -> Tuple[int, int]:
    j = i
    while j < len(s) and s[j].isdigit():
        j += 1
    return (int(s[i:j]) if j > i else 0), j


def _parse_region_list(s: str) -> List[Tuple[str, int, int]]:
    """_regions_init_string (synced_bcf_reader.c:1101): header-free
    grammar — chr | chr:pos | chr:beg-end | chr:beg- | {weird:name}[...]
    comma-separated.  First ':' ends a bare name; braces quote.
    Returns (name, start0, end0); raises ValueError on bad syntax."""
    out: List[Tuple[str, int, int]] = []
    i, n = 0, len(s)
    while True:
        if i < n and s[i] == "{":
            j = s.find("}", i)
            if j < 0:
                raise ValueError(f"mismatching braces in: {s!r}")
            name = s[i + 1:j]
            i = j + 1
        else:
            j = i
            while j < n and s[j] not in ",:":
                j += 1
            name = s[i:j]
            i = j
        if i < n and s[i] == ":":
            i += 1
            frm, i2 = _parse_decimal(s, i)
            if i2 == i:
                raise ValueError(f"could not parse region(s): {s!r}")
            i = i2
            if i >= n or s[i] == ",":
                out.append((name, frm - 1, frm - 1))
                if i >= n:
                    break
                i += 1
                continue
            if s[i] != "-":
                raise ValueError(f"could not parse region(s): {s!r}")
            i += 1
            to, i2 = _parse_decimal(s, i)
            if i2 == i:
                to = _MAX_COOR + 1
            i = i2
            if i < n and s[i] != ",":
                raise ValueError(f"could not parse region(s): {s!r}")
            out.append((name, frm - 1, to - 1))
            if i >= n:
                break
            i += 1
        elif i >= n or s[i] == ",":
            if name:
                out.append((name, 0, _MAX_COOR))
            if i >= n:
                break
            i += 1
        else:
            raise ValueError(f"could not parse region(s): {s!r}")
    return out


class _Regions:
    """Sorted, merged region list with iteration state and the prev_end
    dedup (bcf_sr_regions_t, synced_bcf_reader.c:1024-1175)."""

    def __init__(self, specs):
        if isinstance(specs, str):
            specs = [specs]
        by_seq: Dict[str, List[Tuple[int, int]]] = {}
        self.seqs: List[str] = []
        for spec in specs:
            for name, b, e in _parse_region_list(spec):
                if name not in by_seq:
                    by_seq[name] = []
                    self.seqs.append(name)
                by_seq[name].append((b, e))
        self.regs: Dict[str, List[Tuple[int, int]]] = {}
        for name, lst in by_seq.items():
            lst.sort()
            # regions_merge: merge overlapping/touching (end >= start)
            merged = [lst[0]]
            for b, e in lst[1:]:
                if merged[-1][1] >= b:
                    merged[-1] = (merged[-1][0], max(merged[-1][1], e))
                else:
                    merged.append((b, e))
            self.regs[name] = merged
        self.iseq = 0
        self.ireg = -1
        self.prev_end = -1
        self.start = -1
        self.end = -1

    def next(self) -> int:
        """bcf_sr_regions_next: advance; -1 at end."""
        while self.iseq < len(self.seqs):
            self.ireg += 1
            regs = self.regs[self.seqs[self.iseq]]
            if self.ireg < len(regs):
                self.start, self.end = regs[self.ireg]
                return 0
            self.iseq += 1
            self.ireg = -1
        return -1

    @property
    def seq(self) -> Optional[str]:
        return self.seqs[self.iseq] if self.iseq < len(self.seqs) else None

    def overlap(self, name: str, beg: int, end: int) -> bool:
        """Stateless bcf_sr_regions_overlap."""
        for b, e in self.regs.get(name, ()):
            if b <= end and e >= beg:
                return True
        return False


def _rec_bounds(rec: BcfRecord, mode: int) -> Tuple[int, int]:
    """regions/targets overlap window per mode (synced_bcf_reader.c:621
    _set_variant_boundaries for mode 2)."""
    if mode == 0:
        return rec.pos, rec.pos
    if mode == 1:
        return rec.pos, rec.pos + rec.rlen - 1
    off = rec.rlen
    if rec.alleles:
        ref = rec.alleles[0]
        for alt in rec.alleles[1:]:
            j = 0
            while j < len(ref) and j < len(alt) and ref[j] == alt[j]:
                j += 1
            off = min(off, j)
            if not off:
                break
    else:
        off = 0
    return rec.pos + off, rec.pos + rec.rlen - 1


# ---------------------------------------------------------------------------
# per-file reader
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, fname: str):
        self.fname = fname
        self.fp = open_vcf(fname)
        self.header: BcfHeader = self.fp.header
        self.buf: List[BcfRecord] = []
        self.eof = False
        self.itr = None           # active region record iterator
        self.indexed = self._load_index()

    def _load_index(self) -> bool:
        import os
        from htslib_tpu_torch.vcf.io import BcfReader
        if isinstance(self.fp, BcfReader):
            self._is_bcf = True
            return os.path.exists(self.fname + ".csi")
        self._is_bcf = False
        return (os.path.exists(self.fname + ".tbi")
                or os.path.exists(self.fname + ".csi"))

    def seek(self, seq: str, start: int, end: int) -> None:
        """_reader_seek: open an index iterator over [start, end]."""
        self.buf = []
        self.eof = False
        if self._is_bcf:
            rid = self.header.name2rid(seq)
            if rid < 0:
                self.itr = iter(())
                return
            self.itr = self.fp.fetch(rid, start, end + 1)
        else:
            from htslib_tpu_torch.tbx import Tabix
            if not hasattr(self, "_tbx"):
                self._tbx = Tabix.load_for(self.fname)
            tid = self._tbx.name2tid(seq)
            if tid < 0:
                self.itr = iter(())
                return
            lines = self._tbx.query(self.fp.fp, tid, start, end + 1)
            hdr = self.header
            self.itr = (BcfRecord.from_vcf(l, hdr) for l in lines)

    def _read1(self) -> Optional[BcfRecord]:
        if self.itr is not None:
            return next(self.itr, None)
        return self.fp.read1()

    def fill_buffer(self, sr: "SyncedReader") -> None:
        """_reader_fill_buffer (synced_bcf_reader.c:653): buffer every
        record at the first position (+ one lookahead record)."""
        if self.buf and (self.buf[-1].rid != self.buf[0].rid
                         or self.buf[-1].pos != self.buf[0].pos):
            return
        if self.itr is None and self.eof:
            return
        if sr.regions is not None and self.indexed and self.itr is None:
            return   # awaiting next region seek
        while True:
            rec = self._read1()
            if rec is None:
                if self.itr is not None:
                    self.itr = None     # region exhausted
                    if sr.regions is not None and self.indexed:
                        break
                self.eof = True
                break
            if sr.regions is not None:
                beg, end = _rec_bounds(rec, sr.regions_overlap)
                if self.indexed:
                    # dedup across adjacent regions + clamp to region
                    if (beg <= sr.regions.prev_end
                            or end < sr.regions.start
                            or beg > sr.regions.end):
                        continue
                else:
                    # streaming filter: no index, scan everything
                    name = self.header.rid2name(rec.rid)
                    if not sr.regions.overlap(name, beg, end):
                        continue
            self.buf.append(rec)
            if rec.rid != self.buf[0].rid or rec.pos != self.buf[0].pos:
                break

    def shift(self) -> Optional[BcfRecord]:
        """_reader_shift_buffer: pop the first record."""
        return self.buf.pop(0) if self.buf else None

    def take_at(self, rid: int, pos: int) -> List[BcfRecord]:
        """Extract every buffered record at (rid, pos)."""
        out = [r for r in self.buf if r.rid == rid and r.pos == pos]
        self.buf = [r for r in self.buf
                    if not (r.rid == rid and r.pos == pos)]
        return out


# ---------------------------------------------------------------------------
# synced reader
# ---------------------------------------------------------------------------

class SyncedReader:
    def __init__(self, pair: int = BCF_SR_PAIR_EXACT,
                 regions: Optional[Sequence[str]] = None,
                 targets: Optional[Sequence[str]] = None,
                 regions_overlap: int = 1, targets_overlap: int = 0):
        self.readers: List[_Reader] = []
        self.pair = pair or BCF_SR_PAIR_EXACT
        self.regions = _Regions(regions) if regions else None
        self.targets = _Regions(targets) if targets else None
        self.regions_overlap = regions_overlap
        self.targets_overlap = targets_overlap
        self._score = _init_scores(self.pair)
        self._chr_order: Dict[str, int] = {}
        self._rows: List[List[Optional[BcfRecord]]] = []
        self._regions_started = False
        self.lines: List[Optional[BcfRecord]] = []

    @property
    def nreaders(self) -> int:
        return len(self.readers)

    def add_reader(self, fname: str) -> None:
        rdr = _Reader(fname)
        self.readers.append(rdr)
        for name in rdr.header.ctg_names:
            if name not in self._chr_order:
                self._chr_order[name] = len(self._chr_order)

    # -- main loop (next_line, synced_bcf_reader.c:779) -----------------
    def next_line(self) -> int:
        if self._rows:
            return self._pop_row()
        while True:
            if self.regions is not None and self._next_region_if_done() < 0:
                self.lines = [None] * self.nreaders
                return 0
            for rdr in self.readers:
                rdr.fill_buffer(self)
            # find the minimum (chrom, pos); collect active readers
            best: Optional[Tuple[int, int]] = None
            active: List[int] = []
            for i, rdr in enumerate(self.readers):
                if not rdr.buf:
                    continue
                key = self._chrom_key(rdr, rdr.buf[0])
                if best is None or key < best:
                    best = key
                    active = [i]
                elif key == best:
                    active.append(i)
            if best is None:
                if self.regions is None or \
                        not any(r.indexed for r in self.readers):
                    self.lines = [None] * self.nreaders
                    return 0
                continue   # try next region
            # target filtering at min_pos (synced_bcf_reader.c:825)
            if self.targets is not None:
                match = False
                for i in list(active):
                    rdr = self.readers[i]
                    rec = rdr.buf[0]
                    beg, end = _rec_bounds(rec, self.targets_overlap)
                    name = rdr.header.rid2name(rec.rid)
                    if self.targets.overlap(name, beg, end):
                        match = True
                    else:
                        rdr.shift()
                if not match:
                    continue
                active = [i for i in active if self.readers[i].buf
                          and self._chrom_key(
                              self.readers[i],
                              self.readers[i].buf[0]) == best]
                if not active:
                    continue
            break
        # fast path: a single active reader pops one record at a time
        # (bcf_sr_sort_next, bcf_sr_sort.c:618)
        if len(active) == 1:
            i = active[0]
            rec = self.readers[i].shift()
            self.lines = [None] * self.nreaders
            self.lines[i] = rec
            return 1
        self._rows = self._sort_set(active)
        return self._pop_row()

    def _pop_row(self) -> int:
        row = self._rows.pop(0)
        self.lines = row
        return sum(1 for r in row if r is not None)

    def _chrom_key(self, rdr: _Reader, rec: BcfRecord) -> Tuple[int, int]:
        name = rdr.header.rid2name(rec.rid)
        if name not in self._chr_order:
            self._chr_order[name] = len(self._chr_order)
        return self._chr_order[name], rec.pos

    def _next_region_if_done(self) -> int:
        """_readers_next_region (synced_bcf_reader.c:595)."""
        indexed = [r for r in self.readers if r.indexed]
        if not indexed:
            self._regions_started = True
            return 0    # streaming filter mode: no seeks
        if self._regions_started and any(
                r.buf or r.itr is not None for r in indexed):
            return 0
        prev_iseq = self.regions.iseq
        prev_end = self.regions.end
        if self.regions.next() < 0:
            return -1
        self.regions.prev_end = (prev_end if self._regions_started
                                 and prev_iseq == self.regions.iseq else -1)
        self._regions_started = True
        for r in indexed:
            r.seek(self.regions.seq, self.regions.start, self.regions.end)
        return 0

    # -- bcf_sr_sort port (bcf_sr_sort.c:339 bcf_sr_sort_set) -----------
    def _sort_set(self, active: List[int]
                  ) -> List[List[Optional[BcfRecord]]]:
        rid0 = self.readers[active[0]].buf[0].rid
        # NB rid spaces can differ between readers; capture per reader
        vars_: List[_Var] = []
        var_by_key: Dict[str, int] = {}
        grp_by_key: Dict[str, int] = {}
        grp_vars: List[List[int]] = []     # per group: var indices
        reader_grp: Dict[int, int] = {}

        for ireader in active:
            rdr = self.readers[ireader]
            rec0 = rdr.buf[0]
            recs = rdr.take_at(rec0.rid, rec0.pos)
            my_strs: List[str] = []
            my_vars: List[int] = []
            for rec in recs:
                base = self._var_str(rdr, rec)
                my_strs.append(base)
                key = base
                dup = 0
                while True:
                    ivar = var_by_key.get(key)
                    if ivar is None:
                        break
                    if vars_[ivar].vcf[-1] != ireader:
                        break
                    key = base + str(dup)
                    dup += 1
                if ivar is None:
                    ivar = len(vars_)
                    v = _Var(base)
                    vars_.append(v)
                    var_by_key[key] = ivar
                v = vars_[ivar]
                v.nalt = rec.n_allele - 1
                v.type = _sr_type(record_var_type(rec))
                v.vcf.append(ireader)
                v.rec.append(rec)
                my_vars.append(ivar)
            gkey = ";".join(sorted(my_strs))
            igrp = grp_by_key.get(gkey)
            if igrp is None:
                igrp = len(grp_vars)
                grp_by_key[gkey] = igrp
                grp_vars.append(my_vars)
            reader_grp[ireader] = igrp

        # variant -> group bitmask
        for igrp, vlist in enumerate(grp_vars):
            for ivar in vlist:
                vars_[ivar].mask |= 1 << igrp

        # initial varsets: one per variant
        vsets = [_VarSet(i, v.mask, len(v.vcf))
                 for i, v in enumerate(vars_)]

        rows: List[List[Optional[BcfRecord]]] = []
        while vsets:
            imax = 0
            for i in range(1, len(vsets)):
                if vsets[imax].cnt < vsets[i].cnt:
                    imax = i
            ipair = -1
            max_score = 0
            for i, vs in enumerate(vsets):
                if vsets[imax].mask & vs.mask:
                    continue
                s = self._pair_score(vars_, vsets[imax], vs)
                if max_score < s:
                    max_score = s
                    ipair = i
            if ipair != -1 and ipair != imax:
                lo, hi = min(imax, ipair), max(imax, ipair)
                dst, src = vsets[lo], vsets[hi]
                dst.vars += src.vars
                dst.mask |= src.mask
                dst.cnt += src.cnt
                del vsets[hi]
                continue
            # emit (push_vset)
            row: List[Optional[BcfRecord]] = [None] * self.nreaders
            for ivar in vsets[imax].vars:
                v = vars_[ivar]
                for jvcf, rec in zip(v.vcf, v.rec):
                    row[jvcf] = rec
            rows.append(row)
            del vsets[imax]
        return rows

    def _var_str(self, rdr: _Reader, rec: BcfRecord) -> str:
        """The per-record variant string (bcf_sr_sort.c:368-423):
        'REF>ALT,REF>ALT[/END]' with optional leading 'ID:'."""
        parts = []
        if self.pair & BCF_SR_PAIR_ID:
            parts.append((rec.id or ".") + ":")
        if rec.n_allele == 1:
            parts.append(rec.alleles[0] + ">.")
        else:
            end_pos = None
            alts = []
            for alt in rec.alleles[1:]:
                s = rec.alleles[0] + ">" + alt
                if alt.startswith("<"):
                    if end_pos is None:
                        e = rec.get_info(rdr.header, "END")
                        end_pos = (int(e.value[0]) if e is not None
                                   and e.value is not None
                                   and len(e.value) else 0)
                    if end_pos:
                        s += "/" + str(end_pos)
                alts.append(s)
            parts.append(",".join(alts))
        return "".join(parts)

    def _pair_score(self, vars_: List[_Var], iv: _VarSet,
                    jv: _VarSet) -> int:
        """pairing_score (bcf_sr_sort.c:153)."""
        pair = self.pair
        mn = _UINT32_MAX
        for i in iv.vars:
            ivar = vars_[i]
            for j in jv.vars:
                jvar = vars_[j]
                if pair & BCF_SR_PAIR_EXACT:
                    if ivar.type != jvar.type:
                        continue
                    if ivar.str == jvar.str:
                        return _UINT32_MAX
                    if _multi_is_exact(ivar.str, jvar.str):
                        return _UINT32_MAX
                    continue
                if ivar.type == jvar.type and ivar.str == jvar.str:
                    return _UINT32_MAX
                if (ivar.type & jvar.type) and \
                        _multi_is_subset(ivar.str, jvar.str):
                    return _UINT32_MAX
                s = self._score[((ivar.type & 0xF) << 4) | (jvar.type & 0xF)]
                if not s:
                    return 0
                mn = min(mn, s)
        if pair & BCF_SR_PAIR_EXACT:
            return 0
        cnt = sum(len(vars_[i].vcf) for i in iv.vars)
        cnt += sum(len(vars_[j].vcf) for j in jv.vars)
        return (1 << (28 + mn)) + cnt

    # -- accessors -------------------------------------------------------
    def has_line(self, i: int) -> bool:
        return self.lines[i] is not None

    def get_line(self, i: int) -> Optional[BcfRecord]:
        return self.lines[i]

    def get_header(self, i: int) -> BcfHeader:
        return self.readers[i].header

    def close(self) -> None:
        for r in self.readers:
            r.fp.close()
