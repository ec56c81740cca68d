"""Filter expression language (the port's copy of htslib_tpu/hts_expr.py;
reference hts_expr.c:154-927, API
hts_filter_init/hts_filter_passes; SAM bindings sam.c:1210
bam_sym_lookup, used by hts_set_filter_expression).

Recursive-descent evaluator with C-like precedence:
  unary (! ~ + -) > mul (* / %) > add (+ -) > & > ^ > | >
  cmp (< <= > >=) > eq (== != =~ !~) > && / ||
Values are numeric (C doubles) or strings; missing aux tags yield an
*undefined* value which fails comparisons (treated as false at the top
level).
"""
from __future__ import annotations

import math
import re
from typing import Callable, Optional, Tuple

from htslib_tpu_torch.sam.cigar import (BAM_CHARD_CLIP, BAM_CSOFT_CLIP,
                                        cigar2qlen, cigar2rlen, format_cigar)
from htslib_tpu_torch.sam.record import BamRecord


class Val:
    __slots__ = ("is_str", "d", "s", "defined")

    def __init__(self, d=0.0, s=None, defined=True):
        self.is_str = s is not None
        self.d = d
        self.s = s
        self.defined = defined

    @classmethod
    def undef(cls):
        return cls(0.0, None, defined=False)

    def truth(self) -> bool:
        if not self.defined:
            return False
        if self.is_str:
            return bool(self.s)
        return self.d != 0


class HtsFilter:
    def __init__(self, expr: str):
        self.expr = expr
        self._regex_cache = {}

    # -- lexer helpers ---------------------------------------------------
    def _ws(self):
        while self.pos < len(self.expr) and self.expr[self.pos] in " \t":
            self.pos += 1

    def _peek(self, s: str) -> bool:
        return self.expr.startswith(s, self.pos)

    def _eat(self, s: str) -> bool:
        if self._peek(s):
            self.pos += len(s)
            return True
        return False

    # -- grammar ---------------------------------------------------------
    def passes(self, lookup: Callable[[str], Optional[Tuple[str, Val]]]) -> bool:
        """Evaluate against a symbol lookup; lookup(rest_of_string)
        returns (consumed_prefix, Val) or None."""
        self.pos = 0
        self.lookup = lookup
        v = self._expression()
        self._ws()
        if self.pos != len(self.expr):
            raise ValueError(f"trailing input in expression: "
                             f"{self.expr[self.pos:]!r}")
        return v.truth()

    def _expression(self) -> Val:
        return self._and_expr()

    def _and_expr(self) -> Val:
        res = self._eq_expr()
        while True:
            self._ws()
            if self._eat("&&"):
                val = self._eq_expr()
                if not res.defined or not val.defined:
                    res = Val.undef()
                else:
                    res = Val(1.0 if (res.truth() and val.truth()) else 0.0)
            elif self._eat("||"):
                val = self._eq_expr()
                t = ((res.defined and res.truth())
                     or (val.defined and val.truth()))
                if not t and (not res.defined or not val.defined):
                    res = Val.undef()
                else:
                    res = Val(1.0 if t else 0.0)
            else:
                return res

    def _eq_expr(self) -> Val:
        res = self._cmp_expr()
        self._ws()
        if self._eat("=="):
            val = self._eq_expr()
            if not res.defined or not val.defined:
                return Val.undef()
            if res.is_str:
                return Val(1.0 if (val.is_str and res.s == val.s) else 0.0)
            return Val(1.0 if (not val.is_str and res.d == val.d) else 0.0)
        if self._eat("!="):
            val = self._eq_expr()
            if not res.defined or not val.defined:
                return Val.undef()
            if res.is_str:
                return Val(1.0 if (not val.is_str or res.s != val.s) else 0.0)
            return Val(1.0 if (val.is_str or res.d != val.d) else 0.0)
        if self._peek("=~") or self._peek("!~"):
            neg = self._peek("!~")
            self.pos += 2
            val = self._eq_expr()
            if not val.is_str or not res.is_str:
                raise ValueError("regex compare needs strings")
            if not res.defined or not val.defined:
                return Val.undef()
            creg = self._regex_cache.get(val.s)
            if creg is None:
                creg = re.compile(val.s)
                self._regex_cache[val.s] = creg
            m = creg.search(res.s) is not None
            return Val(1.0 if (m != neg) else 0.0)
        return res

    def _cmp_expr(self) -> Val:
        res = self._bitor_expr()
        self._ws()
        for op in ("<=", ">=", "<", ">"):
            if self._peek(op) and not self._peek("<<") and not self._peek(">>"):
                self.pos += len(op)
                val = self._cmp_expr()
                if not res.defined or not val.defined:
                    return Val.undef()
                if res.is_str and val.is_str:
                    a, b = res.s, val.s
                elif not res.is_str and not val.is_str:
                    a, b = res.d, val.d
                else:
                    return Val(0.0)
                r = {"<": a < b, "<=": a <= b, ">": a > b, ">=": a >= b}[op]
                return Val(1.0 if r else 0.0)
        return res

    def _bitor_expr(self) -> Val:
        res = self._bitxor_expr()
        while True:
            self._ws()
            if self._peek("||") or not self._peek("|"):
                return res
            self.pos += 1
            val = self._bitxor_expr()
            if not res.defined or not val.defined:
                res = Val.undef()
            else:
                res = Val(float(int(res.d) | int(val.d)))

    def _bitxor_expr(self) -> Val:
        res = self._bitand_expr()
        while True:
            self._ws()
            if not self._eat("^"):
                return res
            val = self._bitand_expr()
            if not res.defined or not val.defined:
                res = Val.undef()
            else:
                res = Val(float(int(res.d) ^ int(val.d)))

    def _bitand_expr(self) -> Val:
        res = self._add_expr()
        while True:
            self._ws()
            if self._peek("&&") or not self._peek("&"):
                return res
            self.pos += 1
            val = self._add_expr()
            if not res.defined or not val.defined:
                res = Val.undef()
            else:
                res = Val(float(int(res.d) & int(val.d)))

    def _add_expr(self) -> Val:
        res = self._mul_expr()
        while True:
            self._ws()
            if self._eat("+"):
                val = self._mul_expr()
                if not res.defined or not val.defined:
                    res = Val.undef()
                elif res.is_str and val.is_str:
                    res = Val(s=res.s + val.s)
                elif res.is_str or val.is_str:
                    raise ValueError("arith on strings")
                else:
                    res = Val(res.d + val.d)
            elif self._peek("-") and not self.expr.startswith("-=", self.pos):
                self.pos += 1
                val = self._mul_expr()
                if not res.defined or not val.defined:
                    res = Val.undef()
                elif res.is_str or val.is_str:
                    raise ValueError("arith on strings")
                else:
                    res = Val(res.d - val.d)
            else:
                return res

    def _mul_expr(self) -> Val:
        res = self._unary_expr()
        while True:
            self._ws()
            if self._eat("*"):
                val = self._unary_expr()
                res = self._arith(res, val, lambda a, b: a * b)
            elif self._eat("/"):
                val = self._unary_expr()
                res = self._arith(res, val,
                                  lambda a, b: a / b if b else math.nan)
            elif self._eat("%"):
                val = self._unary_expr()
                res = self._arith(res, val,
                                  lambda a, b: math.fmod(a, b) if b else math.nan)
            else:
                return res

    @staticmethod
    def _arith(res: Val, val: Val, f) -> Val:
        if not res.defined or not val.defined:
            return Val.undef()
        if res.is_str or val.is_str:
            raise ValueError("arith on strings")
        d = f(res.d, val.d)
        if isinstance(d, float) and math.isnan(d):
            return Val.undef()
        return Val(d)

    def _unary_expr(self) -> Val:
        self._ws()
        if self._eat("!"):
            v = self._unary_expr()
            if not v.defined:
                return Val.undef()
            return Val(0.0 if v.truth() else 1.0)
        if self._eat("~"):
            v = self._unary_expr()
            if not v.defined:
                return Val.undef()
            return Val(float(~int(v.d)))
        if self._eat("+"):
            return self._unary_expr()
        if self._peek("-") and not self.expr.startswith("-~", self.pos):
            # handled in simple number parse for literals; unary minus:
            self.pos += 1
            v = self._unary_expr()
            if not v.defined:
                return Val.undef()
            if v.is_str:
                raise ValueError("negate string")
            return Val(-v.d)
        return self._simple_expr()

    _FUNCS1 = {"length", "min", "max", "avg", "sqrt", "log", "exp",
               "exists", "default", "pow"}

    def _simple_expr(self) -> Val:
        self._ws()
        e = self.expr
        p = self.pos
        n = len(e)
        if p < n and (e[p].isdigit() or e[p] == "."):
            m = re.match(r"0[xX][0-9a-fA-F]+|(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?",
                         e[p:])
            tok = m.group(0)
            self.pos = p + len(tok)
            if tok.lower().startswith("0x"):
                return Val(float(int(tok, 16)))
            return Val(float(tok))
        if p < n and e[p] == '"':
            j = p + 1
            out = []
            while j < n and e[j] != '"':
                if e[j] == "\\" and j + 1 < n:
                    nxt = e[j + 1]
                    if nxt in '"\\':
                        out.append(nxt)
                    elif nxt in "tnr":
                        out.append({"t": "\t", "n": "\n", "r": "\r"}[nxt])
                    else:
                        # unknown escape: keep backslash + char
                        # (hts_expr.c:332 default case)
                        out.append("\\" + nxt)
                    j += 2
                else:
                    out.append(e[j])
                    j += 1
            if j >= n:
                raise ValueError("unterminated string")
            self.pos = j + 1
            return Val(s="".join(out))
        if p < n and e[p] == "(":
            self.pos = p + 1
            v = self._expression()
            self._ws()
            if not self._eat(")"):
                raise ValueError("missing )")
            return v
        # functions
        for fname in self._FUNCS1:
            if e.startswith(fname + "(", p):
                self.pos = p + len(fname) + 1
                v = self._expression()
                if fname in ("pow", "default"):
                    self._ws()
                    if not self._eat(","):
                        raise ValueError("missing , in " + fname)
                    v2 = self._expression()
                else:
                    v2 = None
                self._ws()
                if not self._eat(")"):
                    raise ValueError("missing )")
                return self._apply_func(fname, v, v2)
        # symbol lookup
        hit = self.lookup(e[p:])
        if hit is None:
            raise ValueError(f"unknown symbol at {e[p:]!r}")
        consumed, val = hit
        self.pos = p + consumed
        return val

    @staticmethod
    def _apply_func(fname: str, v: Val, v2: Optional[Val]) -> Val:
        if fname == "exists":
            return Val(1.0 if v.defined else 0.0)
        if fname == "default":
            return v if v.defined else v2
        if not v.defined:
            return Val.undef()
        if fname == "length":
            if not v.is_str:
                raise ValueError("length() needs a string")
            return Val(float(len(v.s)))
        if fname in ("min", "max", "avg"):
            if not v.is_str:
                raise ValueError(f"{fname}() needs a string")
            if not v.s:
                return Val.undef()
            vals = [ord(c) for c in v.s]
            if fname == "min":
                return Val(float(min(vals)))
            if fname == "max":
                return Val(float(max(vals)))
            return Val(sum(vals) / len(vals))
        if v.is_str:
            raise ValueError(f"{fname}() needs a number")
        if fname == "sqrt":
            d = math.sqrt(v.d) if v.d >= 0 else math.nan
        elif fname == "log":
            d = math.log(v.d) if v.d > 0 else math.nan
        elif fname == "exp":
            d = math.exp(v.d)
        elif fname == "pow":
            if v2 is None or v2.is_str:
                raise ValueError("pow() args")
            d = math.pow(v.d, v2.d)
        else:
            raise ValueError(fname)
        if math.isnan(d):
            return Val.undef()
        return Val(d)


# ---------------------------------------------------------------------------
# SAM record symbol bindings (bam_sym_lookup, sam.c:1210)
# ---------------------------------------------------------------------------

_FLAG_BITS = {
    "paired": 0x1, "proper_pair": 0x2, "unmap": 0x4, "munmap": 0x8,
    "reverse": 0x10, "mreverse": 0x20, "read1": 0x40, "read2": 0x80,
    "secondary": 0x100, "qcfail": 0x200, "dup": 0x400,
    "supplementary": 0x800,
}


def bam_symbol_lookup(rec: BamRecord, header) -> Callable:
    def lookup(s: str):
        if s.startswith("["):
            e = s.find("]")
            if e < 0:
                return None
            tag = s[1:e]
            v = rec.get_aux(tag)
            if v is None:
                return e + 1, Val.undef()
            if isinstance(v, str):
                return e + 1, Val(s=v)
            if isinstance(v, (int, float)):
                return e + 1, Val(float(v))
            return e + 1, Val.undef()  # B arrays unsupported in filters
        for name in ("cigar", "endpos", "flag", "hclen", "library", "mapq",
                     "mpos", "mrname", "mrefid", "ncigar", "pnext", "pos",
                     "qlen", "qname", "qual", "refid", "rlen", "rname",
                     "rnext", "sclen", "seq", "tlen", "tid"):
            if s.startswith(name):
                rest = s[len(name):]
                if name == "flag" and rest.startswith("."):
                    for sub, bit in _FLAG_BITS.items():
                        if rest[1:].startswith(sub):
                            return (len(name) + 1 + len(sub),
                                    Val(float(rec.flag & bit)))
                    return None
                return len(name), _bam_value(rec, header, name)
        return None
    return lookup


def _bam_value(rec: BamRecord, header, name: str) -> Val:
    if name == "cigar":
        return Val(s=format_cigar(rec.cigar))
    if name == "endpos":
        return Val(float(rec.endpos()))
    if name == "flag":
        return Val(float(rec.flag))
    if name == "hclen":
        hclen = 0
        cig = rec.cigar
        if len(cig) > 0 and (int(cig[0]) & 0xF) == BAM_CHARD_CLIP:
            hclen = int(cig[0]) >> 4
        if len(cig) > 1 and (int(cig[-1]) & 0xF) == BAM_CHARD_CLIP:
            hclen += int(cig[-1]) >> 4
        return Val(float(hclen))
    if name == "library":
        lib = ""
        rg = rec.get_aux("RG")
        if rg is not None and header is not None:
            line = header.find_line_id("RG", "ID", rg)
            if line is not None:
                lib = line.get("LB") or ""
        return Val(s=lib)
    if name == "mapq":
        return Val(float(rec.mapq))
    if name in ("mpos", "pnext"):
        return Val(float(rec.mpos + 1))
    if name == "mrname":
        return Val(s=header.tid2name(rec.mtid) if rec.mtid >= 0 else "*")
    if name == "mrefid":
        return Val(float(rec.mtid))
    if name == "ncigar":
        return Val(float(len(rec.cigar)))
    if name == "pos":
        return Val(float(rec.pos + 1))
    if name == "qlen":
        return Val(float(cigar2qlen(rec.cigar)))
    if name == "qname":
        return Val(s=rec.qname.decode())
    if name == "qual":
        return Val(s=rec.qual.decode("latin-1"))
    if name in ("refid", "tid"):
        return Val(float(rec.tid))
    if name == "rlen":
        return Val(float(cigar2rlen(rec.cigar)))
    if name == "rname":
        return Val(s=header.tid2name(rec.tid) if rec.tid >= 0 else "*")
    if name == "rnext":
        return Val(s=header.tid2name(rec.mtid) if rec.mtid >= 0 else "*")
    if name == "sclen":
        sclen = 0
        cig = rec.cigar
        nc = len(cig)
        if nc > 0 and (int(cig[0]) & 0xF) == BAM_CSOFT_CLIP:
            sclen += int(cig[0]) >> 4
        elif (nc > 1 and (int(cig[0]) & 0xF) == BAM_CHARD_CLIP
              and (int(cig[1]) & 0xF) == BAM_CSOFT_CLIP):
            sclen += int(cig[1]) >> 4
        if nc > 0 and (int(cig[nc - 1]) & 0xF) == BAM_CSOFT_CLIP:
            sclen += int(cig[nc - 1]) >> 4
        elif (nc > 1 and (int(cig[nc - 1]) & 0xF) == BAM_CHARD_CLIP
              and (int(cig[nc - 2]) & 0xF) == BAM_CSOFT_CLIP):
            sclen += int(cig[nc - 2]) >> 4
        return Val(float(sclen))
    if name == "seq":
        return Val(s=rec.seq if rec.l_qseq else "")
    if name == "tlen":
        return Val(float(rec.isize))
    raise ValueError(name)


def sam_passes_filter(rec: BamRecord, header, filt: HtsFilter) -> bool:
    """sam_passes_filter (sam.c:1535)."""
    return filt.passes(bam_symbol_lookup(rec, header))
