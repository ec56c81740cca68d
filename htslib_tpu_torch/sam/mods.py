"""Base modifications: MM/ML/MN aux tags parsed and walked a position
at a time (the port's copy of htslib_tpu/sam/mods.py; reference
sam_mods.c:230-703, API htslib/sam.h:2226-2440).

Each (canonical base, strand, modification code) of the MM string is a
channel with its skip counts and per-event qualities; a reversed read
flips the lists and starts from the remainder at its left edge
(sam_mods.c:334-361).  Implicit (`.`) and explicit (`?`) channels both
parse; `HTS_MOD_REPORT_UNCHECKED` reports the positions an explicit
channel did not check.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from htslib_tpu_torch.sam.record import FREVERSE, SEQ_NT16_STR, BamRecord, _NT16_TABLE

HTS_MOD_UNKNOWN = -1    # in MM but not ML
HTS_MOD_UNCHECKED = -2  # not in MM and in explicit mode
HTS_MOD_REPORT_UNCHECKED = 1

_SEQI_RC = [0, 8, 4, 12, 2, 10, 6, 14, 1, 9, 5, 13, 3, 11, 7, 15]
_INT_MAX = 0x7FFFFFFF


class BaseMod:
    __slots__ = ("modified_base", "canonical_base", "strand", "qual")

    def __init__(self, modified_base, canonical_base, strand, qual):
        self.modified_base = modified_base  # chr code or -ChEBI
        self.canonical_base = canonical_base
        self.strand = strand
        self.qual = qual


class _Channel:
    __slots__ = ("type", "strand", "canonical", "implicit", "counts",
                 "quals", "ci", "count")

    def __init__(self, type_, strand, canonical, implicit, counts, quals):
        self.type = type_
        self.strand = strand
        self.canonical = canonical  # nt16 code
        self.implicit = implicit
        self.counts = counts        # remaining deltas after the first
        self.quals = quals          # per-event quals (None = no ML)
        self.ci = 0                 # next index into counts/quals
        self.count = counts[0] if counts else _INT_MAX


class BaseModState:
    def __init__(self):
        self.channels: List[_Channel] = []
        self.seq_pos = 0
        self.flags = 0
        self._seq_nib: Optional[np.ndarray] = None
        self._reverse = False

    # ------------------------------------------------------------------
    def parse(self, b: BamRecord, flags: int = 0) -> int:
        """bam_parse_basemod2: returns 0 ok (no mods still ok), -1 error."""
        self.channels = []
        self.seq_pos = 0
        self.flags = flags
        # sequence nibbles for freq / iteration (needed even with no MM)
        packed = np.frombuffer(b.seq4, np.uint8)
        nib = np.empty(b.l_qseq, np.uint8)
        nib[0::2] = packed[:(b.l_qseq + 1) // 2] >> 4
        nib[1::2] = packed[:b.l_qseq // 2] & 0xF
        self._seq_nib = nib
        self._reverse = bool(b.flag & FREVERSE)

        mm = b.get_aux("MM")
        if mm is None:
            mm = b.get_aux("Mm")
        if mm is None:
            return 0
        if not isinstance(mm, str):
            return -1
        mn = b.get_aux("MN")
        if mn is not None and b.l_qseq:
            # bam_aux2i: non-integer MN reads as 0 => length mismatch error
            if not isinstance(mn, (int,)) or mn != b.l_qseq:
                return -1
        ml = b.get_aux("ML")
        if ml is None:
            ml = b.get_aux("Ml")
        ml_list = list(ml) if ml is not None else None
        ml_pos = 0

        freq = np.bincount(nib, minlength=16) if len(nib) else np.zeros(16, int)
        freq[15] = b.l_qseq  # all bases count as N for base mods (seq_freq)

        i, n = 0, len(mm)
        while i < n:
            btype_c = mm[i]
            i += 1
            if btype_c == "U":
                btype_c = "T"
            if btype_c not in "ACGTN":
                return -1
            btype = int(_NT16_TABLE[ord(btype_c)])
            if i >= n or mm[i] not in "+-":
                return -1
            strand = 1 if mm[i] == "-" else 0
            i += 1
            # mod codes: letters, or a single ChEBI number
            codes: List[int] = []
            if i < n and mm[i].isdigit():
                j = i
                while j < n and mm[j].isdigit():
                    j += 1
                codes.append(-int(mm[i:j]))
                i = j
            else:
                j = i
                while j < n and mm[j].isalpha():
                    j += 1
                if j == i:
                    return -1
                codes = [ord(c) for c in mm[i:j]]
                i = j
            implicit = 1
            if i < n and mm[i] == ".":
                i += 1
            elif i < n and mm[i] == "?":
                implicit = 0
                i += 1
            elif i < n and mm[i] not in ",;":
                return -1
            # deltas
            deltas: List[int] = []
            while i < n and mm[i] == ",":
                j = i + 1
                while j < n and mm[j].isdigit():
                    j += 1
                if j == i + 1:
                    return -1
                deltas.append(int(mm[i + 1:j]))
                i = j
            if i >= n or mm[i] != ";":
                return -1
            i += 1
            stride = len(codes)
            nevents = len(deltas)
            # per-channel quals (strided slices of the ML block)
            ch_quals: List[Optional[List[int]]] = []
            for ci in range(stride):
                if ml_list is not None:
                    q = ml_list[ml_pos + ci: ml_pos + nevents * stride: stride]
                    if len(q) != nevents:
                        return -1
                    ch_quals.append(q)
                else:
                    ch_quals.append(None)
            if ml_list is not None:
                ml_pos += nevents * stride
            if self._reverse:
                total = sum(d + 1 for d in deltas)
                remainder = int(freq[_SEQI_RC[btype]]) - total
                if remainder < 0:
                    return -1
                # first = left-edge remainder, then the stored gaps in
                # reverse (the original first delta becomes the unrecorded
                # right edge)
                counts = ([remainder] + list(reversed(deltas[1:]))
                          if deltas else [remainder])
                for ci in range(stride):
                    if ch_quals[ci] is not None:
                        ch_quals[ci] = list(reversed(ch_quals[ci]))
            else:
                counts = deltas
            for ci, code in enumerate(codes):
                ch = _Channel(code, strand, btype, implicit,
                              counts if counts else [],
                              ch_quals[ci])
                ch.ci = 0
                ch.count = counts[0] if counts else _INT_MAX
                if counts:
                    ch.ci = 1
                self.channels.append(ch)
        if ml_list is not None and ml_pos != len(ml_list):
            return -1
        self.nmods = len(self.channels)
        return 0

    # ------------------------------------------------------------------
    def at_next_pos(self, b: BamRecord, max_mods: int = 256) -> List[BaseMod]:
        """bam_mods_at_next_pos: mods at the current seq position, then
        advance."""
        if self.seq_pos >= b.l_qseq:
            return []
        base = int(self._seq_nib[self.seq_pos])
        self.seq_pos += 1
        if self._reverse:
            base = _SEQI_RC[base]
        out: List[BaseMod] = []
        for ch in self.channels:
            if ch.canonical != base and ch.canonical != 15:
                continue
            if ch.count > 0:
                ch.count -= 1
                if not ch.implicit and (self.flags & HTS_MOD_REPORT_UNCHECKED):
                    out.append(BaseMod(ch.type, SEQ_NT16_STR[ch.canonical],
                                       ch.strand, HTS_MOD_UNCHECKED))
                continue
            ch.count -= 1  # mirror the C post-decrement past zero
            # event: emit with qual
            ei = ch.ci - 1  # current event index
            q = (ch.quals[ei] if ch.quals is not None and 0 <= ei < len(ch.quals)
                 else HTS_MOD_UNKNOWN)
            out.append(BaseMod(ch.type, SEQ_NT16_STR[ch.canonical],
                               ch.strand, q))
            if ch.ci < len(ch.counts):
                ch.count = ch.counts[ch.ci]
                ch.ci += 1
            else:
                ch.count = _INT_MAX
        return out

    def next_basemod(self, b: BamRecord, max_mods: int = 256,
                     ) -> Tuple[List[BaseMod], int]:
        """bam_next_basemod: skip to the next modified position; returns
        (mods, pos) with mods == [] at EOF."""
        unchecked = self.flags & HTS_MOD_REPORT_UNCHECKED
        nxt = [0x7F7F7F7F] * 16
        for ch in self.channels:
            base = ch.canonical
            if self._reverse:
                base = _SEQI_RC[base]
            if unchecked and not ch.implicit:
                nxt[base] = 0
            elif nxt[base] > ch.count:
                nxt[base] = ch.count
        freq = [0] * 16
        i = self.seq_pos
        nqs = b.l_qseq
        while i < nqs:
            bc = int(self._seq_nib[i])
            if nxt[bc] <= freq[bc] or nxt[15] <= freq[15]:
                break
            freq[bc] += 1
            if bc != 15:
                freq[15] += 1
            i += 1
        pos = self.seq_pos = i
        for ch in self.channels:
            base = ch.canonical if not self._reverse else _SEQI_RC[ch.canonical]
            if ch.count < 0x7F000000:
                ch.count -= freq[base]
        if nqs and self.seq_pos >= nqs:
            return [], pos
        return self.at_next_pos(b, max_mods), pos

    def at_qpos(self, b: BamRecord, qpos: int, max_mods: int = 256,
                ) -> List[BaseMod]:
        """bam_mods_at_qpos."""
        out: List[BaseMod] = []
        while self.seq_pos <= qpos:
            out = self.at_next_pos(b, max_mods)
        return out

    # ------------------------------------------------------------------
    def recorded(self) -> List[int]:
        return [ch.type for ch in self.channels]

    def query_type(self, code: int) -> Optional[Tuple[int, int, str]]:
        """(strand, implicit, canonical) for a mod code."""
        for ch in self.channels:
            if ch.type == code:
                return ch.strand, ch.implicit, "?AC?G???T??????N"[ch.canonical]
        return None

    def queryi(self, i: int) -> Optional[Tuple[int, int, str]]:
        if 0 <= i < len(self.channels):
            ch = self.channels[i]
            return ch.strand, ch.implicit, "?AC?G???T??????N"[ch.canonical]
        return None
