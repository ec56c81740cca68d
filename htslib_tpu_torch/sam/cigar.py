"""CIGAR constants, text and lengths (the port's copy of the part of
htslib_tpu/sam/cigar.py that the record, the CRAM codecs and the SAM
text parser need; reference htslib/sam.h:65-134)."""
from __future__ import annotations

import numpy as np

BAM_CMATCH = 0
BAM_CINS = 1
BAM_CDEL = 2
BAM_CREF_SKIP = 3
BAM_CSOFT_CLIP = 4
BAM_CHARD_CLIP = 5
BAM_CPAD = 6
BAM_CEQUAL = 7
BAM_CDIFF = 8
BAM_CBACK = 9

BAM_CIGAR_STR = "MIDNSHP=XB"
BAM_CIGAR_SHIFT = 4
BAM_CIGAR_MASK = 0xF

# htslib/sam.h:112 bam_cigar_type: bit 1 = consumes query, bit 2 = consumes ref
BAM_CIGAR_TYPE = 0x3C1A7

_CHAR2OP = {c: i for i, c in enumerate(BAM_CIGAR_STR)}

_CONSUME_Q = tuple((BAM_CIGAR_TYPE >> (op * 2)) & 1 for op in range(16))
_CONSUME_R = tuple((BAM_CIGAR_TYPE >> (op * 2 + 1)) & 1 for op in range(16))


def cigar_gen(length: int, op: int) -> int:
    return (length << BAM_CIGAR_SHIFT) | op


def parse_cigar(text: str) -> np.ndarray:
    """CIGAR text -> packed uint32 ops (sam_parse_cigar, sam.c:2419);
    "*" is none."""
    if text == "*":
        return np.empty(0, np.uint32)
    out = []
    n = 0
    ndigits = 0
    for ch in text:
        if ch.isdigit():
            n = n * 10 + ord(ch) - 48
            ndigits += 1
        else:
            op = _CHAR2OP.get(ch)
            if op is None or ndigits == 0:
                raise ValueError(f"invalid CIGAR {text!r}")
            out.append(cigar_gen(n, op))
            n = 0
            ndigits = 0
    if ndigits:
        raise ValueError(f"trailing digits in CIGAR {text!r}")
    return np.array(out, np.uint32)


def format_cigar(cigar: np.ndarray) -> str:
    """Packed ops -> CIGAR text, "*" when empty.  An op code past 9 has
    no letter: it raises IndexError, as the JAX package's formatter."""
    if len(cigar) == 0:
        return "*"
    return "".join(f"{int(c) >> 4}{BAM_CIGAR_STR[int(c) & 0xF]}"
                   for c in cigar)


def cigar2qlen(cigar: np.ndarray) -> int:
    """Query length consumed (bam_cigar2qlen, sam.c:254)."""
    return sum(int(c) >> BAM_CIGAR_SHIFT for c in np.asarray(cigar).tolist()
               if _CONSUME_Q[int(c) & BAM_CIGAR_MASK])


def cigar2rlen(cigar: np.ndarray) -> int:
    """Reference length consumed (bam_cigar2rlen, sam.c:266)."""
    return sum(int(c) >> BAM_CIGAR_SHIFT for c in np.asarray(cigar).tolist()
               if _CONSUME_R[int(c) & BAM_CIGAR_MASK])


def reg2bin(beg: int, end: int, min_shift: int = 14, n_lvls: int = 5) -> int:
    """CSI/BAI binning (hts_reg2bin, htslib/hts.h:1516)."""
    end -= 1
    lvl, s = n_lvls, min_shift
    t = ((1 << (n_lvls * 3)) - 1) // 7
    while lvl > 0:
        if beg >> s == end >> s:
            return t + (beg >> s)
        lvl -= 1
        s += 3
        t -= 1 << (lvl * 3)
    return 0
