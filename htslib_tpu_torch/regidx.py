"""In-memory interval index with custom payloads: the port's copy of
htslib_tpu/regidx.py (reference regidx.c:1-688, API htslib/regidx.h).

Per-chromosome sorted interval lists with a binned max-end index for
overlap queries; built-in parsers for BED (0-based half-open), TAB
(1-based inclusive) and region strings.
"""
from __future__ import annotations

import bisect
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from htslib_tpu_torch.bgzf import BgzfReader
from htslib_tpu_torch.index import parse_decimal

MAX_POS = (1 << 35) - 1


class RegIdx:
    def __init__(self):
        self._regs: Dict[str, List[Tuple[int, int, Any]]] = {}
        self._sorted = False
        self._maxend: Dict[str, List[int]] = {}

    # -- construction ----------------------------------------------------
    def push(self, chrom: str, beg: int, end: int, payload: Any = None) -> None:
        """regidx_push (regidx.c:316): 0-based inclusive [beg, end]."""
        self._regs.setdefault(chrom, []).append((beg, end, payload))
        self._sorted = False

    def insert_line(self, line: str, parser: Callable) -> bool:
        """regidx_insert with a parser (BED/TAB/VCF)."""
        parsed = parser(line)
        if parsed is None:
            return False
        chrom, beg, end, payload = parsed
        self.push(chrom, beg, end, payload)
        return True

    def _ensure_sorted(self) -> None:
        if self._sorted:
            return
        for chrom, lst in self._regs.items():
            lst.sort(key=lambda r: (r[0], r[1]))
            # running max of interval ends for pruned scans
            mx: List[int] = []
            m = -1
            for b, e, _ in lst:
                m = max(m, e)
                mx.append(m)
            self._maxend[chrom] = mx
        self._sorted = True

    # -- queries ---------------------------------------------------------
    def overlap(self, chrom: str, beg: int, end: Optional[int] = None,
                ) -> Iterator[Tuple[int, int, Any]]:
        """regidx_overlap (regidx.c:401): 0-based inclusive query."""
        if end is None:
            end = beg
        self._ensure_sorted()
        lst = self._regs.get(chrom)
        if not lst:
            return
        mx = self._maxend[chrom]
        # find first interval with beg_i <= end; walk left bound via maxend
        hi = bisect.bisect_right(lst, (end, MAX_POS, None))
        # scan backwards is O(n) worst case; use maxend prune:
        i = 0
        # binary search leftmost i where maxend[i] >= beg
        lo, hi2 = 0, hi
        while lo < hi2:
            mid = (lo + hi2) // 2
            if mx[mid] < beg:
                lo = mid + 1
            else:
                hi2 = mid
        for j in range(lo, hi):
            b, e, payload = lst[j]
            if b <= end and e >= beg:
                yield b, e, payload

    def has_overlap(self, chrom: str, beg: int, end: Optional[int] = None) -> bool:
        for _ in self.overlap(chrom, beg, end):
            return True
        return False

    @property
    def seq_names(self) -> List[str]:
        return list(self._regs.keys())

    def nregs(self) -> int:
        return sum(len(v) for v in self._regs.values())


# -- parsers (regidx.c:466-538) ---------------------------------------------

def parse_bed(line: str):
    """0-based, half-open -> 0-based inclusive."""
    if not line or line.startswith("#"):
        return None
    cols = line.rstrip("\n").split("\t")
    if len(cols) < 3:
        return None
    try:
        beg = int(cols[1])
        end = int(cols[2]) - 1
    except ValueError:
        return None
    return cols[0], beg, end, None


def parse_tab(line: str):
    """1-based, inclusive; end defaults to beg (regidx_parse_tab)."""
    if not line or line.startswith("#"):
        return None
    cols = line.rstrip("\n").split()
    if len(cols) < 2:
        return None
    try:
        beg = int(cols[1]) - 1
        end = int(cols[2]) - 1 if len(cols) > 2 else beg
    except ValueError:
        return None
    if end < beg:
        end = beg
    return cols[0], beg, end, None


def parse_reg(line: str):
    """chr:beg-end region strings (regidx_parse_reg)."""
    if not line:
        return None
    line = line.strip()
    colon = line.rfind(":")
    if colon < 0:
        return line, 0, MAX_POS, None
    chrom = line[:colon]
    rng = line[colon + 1:]
    if "-" in rng:
        b, e = rng.split("-", 1)
        beg = parse_decimal(b, 1)[0] - 1 if b else 0
        end = parse_decimal(e, 1)[0] - 1 if e else MAX_POS
    else:
        beg = end = parse_decimal(rng, 1)[0] - 1
    return chrom, beg, end, None


def parse_vcf(line: str):
    if not line or line.startswith("#"):
        return None
    cols = line.split("\t", 5)
    if len(cols) < 4:
        return None
    try:
        beg = int(cols[1]) - 1
    except ValueError:
        return None
    end = beg + len(cols[3]) - 1
    return cols[0], beg, end, None


def regidx_from_file(path: str, parser: Callable = parse_tab) -> RegIdx:
    idx = RegIdx()
    with BgzfReader(path) as fp:
        while True:
            raw = fp.readline()
            if not raw:
                break
            idx.insert_line(raw.decode(), parser)
    return idx
