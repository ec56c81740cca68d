"""Name tokeniser — CRAM 3.1 TOK3 block method (reference call sites
cram/cram_io.c:1737,1891 tok3_encode_names/tok3_decode_names), as host
Python.  The port's own copy of the JAX package's host codec, kept byte
for byte in its arithmetic so that both packages decode the same wire.

Architecture per the CRAM 3.1 specification's name-tokenisation
section: each read name is split into digit-run / alpha-run /
single-character tokens; token columns are compared against the
previous name, giving MATCH (identical), DELTA/DELTA0 (small numeric
increment, the big win for instrument:run:tile:x:y names), or literal
DIGITS/DIGITS0/ALPHA/CHAR; per-(column,kind) byte streams are then
entropy-coded with rANS Nx16 or the adaptive arith coder.

Wire format:

    u7   ulen      total decoded length (names NUL-joined, trailing NUL)
    u7   nnames
    byte use_arith (0 = rANS Nx16, 1 = arith)
    repeated until end of stream:
      byte pos, byte kind, u7 clen, clen-byte compressed sub-stream

Column kinds: 0 TYPE (one type byte per name at this column),
1 ALPHA (NUL-terminated strings), 2 CHAR, 3 DIGITS (u32le),
4 DZLEN (zero-padded widths), 5 DELTA (byte increments).
Type bytes: 0 END, 1 MATCH, 2 DELTA, 3 DELTA0, 4 DIGITS, 5 DIGITS0,
6 CHAR, 7 ALPHA; column 0's type byte is 8 DUP (identical to previous
name) or 9 DIFF.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from htslib_tpu_torch.codecs import arith, rans4x16
from htslib_tpu_torch.codecs.rans4x16 import u7_get, u7_put

K_TYPE, K_ALPHA, K_CHAR, K_DIGITS, K_DZLEN, K_DELTA = range(6)
T_END, T_MATCH, T_DELTA, T_DELTA0, T_DIGITS, T_DIGITS0, T_CHAR, T_ALPHA, \
    T_DUP, T_DIFF = range(10)

MAX_TOK = 250


def _tokenize(name: bytes) -> List[bytes]:
    toks: List[bytes] = []
    i, n = 0, len(name)
    while i < n:
        c = name[i]
        if 48 <= c <= 57:
            j = i
            while j < n and 48 <= name[j] <= 57:
                j += 1
            if j - i > 9:           # avoid u32 overflow: literal alpha run
                toks.append(name[i:j])
            else:
                toks.append(name[i:j])
            i = j
        elif (65 <= c <= 90) or (97 <= c <= 122):
            j = i
            while j < n and ((65 <= name[j] <= 90) or (97 <= name[j] <= 122)):
                j += 1
            toks.append(name[i:j])
            i = j
        else:
            toks.append(name[i:i + 1])
            i += 1
    if len(toks) > MAX_TOK:
        toks = toks[:MAX_TOK - 1] + [b"".join(toks[MAX_TOK - 1:])]
    return toks


def _is_digits(tok: bytes) -> bool:
    return tok.isdigit() and len(tok) <= 9


def _compress_stream(data: bytes, use_arith: int) -> bytes:
    if not data:
        return b""
    best: Optional[bytes] = None
    codec = arith if use_arith else rans4x16
    for fl in (0, 1, 0x20):         # order-0, order-1, CAT fallback
        c = codec.compress(data, fl)
        if best is None or len(c) < len(best):
            best = c
    return best


def _uncompress_stream(data: bytes, use_arith: int) -> bytes:
    if not data:
        return b""
    if use_arith:
        return arith.uncompress(data)
    return rans4x16.uncompress(data)


def encode_names(names: List[bytes], use_arith: int = 0) -> bytes:
    streams: Dict[Tuple[int, int], bytearray] = {}

    def put(pos: int, kind: int, b: bytes) -> None:
        streams.setdefault((pos, kind), bytearray()).extend(b)

    prev_name: Optional[bytes] = None
    prev_toks: List[bytes] = []
    for name in names:
        if prev_name is not None and name == prev_name:
            put(0, K_TYPE, bytes([T_DUP]))
            continue
        put(0, K_TYPE, bytes([T_DIFF]))
        toks = _tokenize(name)
        for ti, tok in enumerate(toks):
            pos = ti + 1
            prev = prev_toks[ti] if ti < len(prev_toks) else None
            if tok == prev:
                put(pos, K_TYPE, bytes([T_MATCH]))
                continue
            if _is_digits(tok):
                zero_pad = tok[0:1] == b"0" and len(tok) > 1
                v = int(tok)
                if (prev is not None and _is_digits(prev)):
                    pv = int(prev)
                    pzp = prev[0:1] == b"0" and len(prev) > 1
                    d = v - pv
                    if 0 <= d <= 255 and zero_pad == pzp and \
                            (not zero_pad or len(tok) == len(prev)):
                        put(pos, K_TYPE,
                            bytes([T_DELTA0 if zero_pad else T_DELTA]))
                        put(pos, K_DELTA, bytes([d]))
                        continue
                if zero_pad:
                    put(pos, K_TYPE, bytes([T_DIGITS0]))
                    put(pos, K_DIGITS, v.to_bytes(4, "little"))
                    put(pos, K_DZLEN, bytes([len(tok)]))
                else:
                    put(pos, K_TYPE, bytes([T_DIGITS]))
                    put(pos, K_DIGITS, v.to_bytes(4, "little"))
                continue
            if len(tok) == 1 and not tok.isalpha():
                put(pos, K_TYPE, bytes([T_CHAR]))
                put(pos, K_CHAR, tok)
            else:
                put(pos, K_TYPE, bytes([T_ALPHA]))
                put(pos, K_ALPHA, tok + b"\0")
        put(len(toks) + 1, K_TYPE, bytes([T_END]))
        prev_name = name
        prev_toks = toks

    out = bytearray()
    ulen = sum(len(n) + 1 for n in names)
    u7_put(out, ulen)
    u7_put(out, len(names))
    out.append(1 if use_arith else 0)
    for (pos, kind) in sorted(streams):
        comp = _compress_stream(bytes(streams[(pos, kind)]), use_arith)
        out.append(pos)
        out.append(kind)
        u7_put(out, len(comp))
        out += comp
    return bytes(out)


class _Reader:
    __slots__ = ("data", "p")

    def __init__(self, data: bytes):
        self.data = data
        self.p = 0

    def byte(self) -> int:
        b = self.data[self.p]
        self.p += 1
        return b

    def take(self, n: int) -> bytes:
        b = self.data[self.p:self.p + n]
        if len(b) != n:
            raise ValueError("tok3: truncated stream")
        self.p += n
        return b

    def zstring(self) -> bytes:
        e = self.data.index(0, self.p)
        s = self.data[self.p:e]
        self.p = e + 1
        return s


def decode_names(buf: bytes) -> bytes:
    ulen, p = u7_get(buf, 0)
    nnames, p = u7_get(buf, p)
    use_arith = buf[p]
    p += 1
    streams: Dict[Tuple[int, int], _Reader] = {}
    while p < len(buf):
        pos = buf[p]
        kind = buf[p + 1]
        p += 2
        clen, p = u7_get(buf, p)
        streams[(pos, kind)] = _Reader(
            _uncompress_stream(bytes(buf[p:p + clen]), use_arith))
        p += clen

    def rd(pos: int, kind: int) -> _Reader:
        r = streams.get((pos, kind))
        if r is None:
            raise ValueError(f"tok3: missing stream ({pos},{kind})")
        return r

    out = bytearray()
    prev_name: Optional[bytes] = None
    prev_toks: List[bytes] = []
    for _ in range(nnames):
        t0 = rd(0, K_TYPE).byte()
        if t0 == T_DUP:
            if prev_name is None:
                raise ValueError("tok3: DUP with no previous name")
            out += prev_name + b"\0"
            continue
        if t0 != T_DIFF:
            raise ValueError("tok3: bad name-level type")
        toks: List[bytes] = []
        pos = 1
        while True:
            t = rd(pos, K_TYPE).byte()
            if t == T_END:
                break
            prev = prev_toks[pos - 1] if pos - 1 < len(prev_toks) else None
            if t == T_MATCH:
                if prev is None:
                    raise ValueError("tok3: MATCH with no previous token")
                tok = prev
            elif t in (T_DELTA, T_DELTA0):
                if prev is None or not prev.isdigit():
                    raise ValueError("tok3: DELTA with no numeric previous")
                d = rd(pos, K_DELTA).byte()
                v = int(prev) + d
                if t == T_DELTA0:
                    tok = str(v).encode().rjust(len(prev), b"0")
                else:
                    tok = str(v).encode()
            elif t in (T_DIGITS, T_DIGITS0):
                v = int.from_bytes(rd(pos, K_DIGITS).take(4), "little")
                if t == T_DIGITS0:
                    w = rd(pos, K_DZLEN).byte()
                    tok = str(v).encode().rjust(w, b"0")
                else:
                    tok = str(v).encode()
            elif t == T_CHAR:
                tok = rd(pos, K_CHAR).take(1)
            elif t == T_ALPHA:
                tok = rd(pos, K_ALPHA).zstring()
            else:
                raise ValueError(f"tok3: bad token type {t}")
            toks.append(tok)
            pos += 1
        name = b"".join(toks)
        out += name + b"\0"
        prev_name = name
        prev_toks = toks
    if len(out) != ulen:
        raise ValueError("tok3: decoded length mismatch")
    return bytes(out)
