"""BAM record model (the port's copy of htslib_tpu/sam/record.py's
`BamRecord`; reference htslib/sam.h:214-332, sam.c:784-900 binary I/O,
sam.c:4324 SAM format, sam.c:2662 SAM parse).

A BamRecord keeps the parsed core fields and the variable-length payload
split into qname / packed CIGAR / 4-bit seq / qual / aux blob.  The aux
blob stays in BAM wire encoding so round trips are exact and its CRUD
mirrors bam_aux_* (sam.c:4761-5180).  The device chains use it as their
host truth (ops/bam2sam.py), for BAQ's per-record bookkeeping
(realn.py), and the CRAM encoder and decoder (cram/) build and read it.
"""
from __future__ import annotations

import struct
from typing import Iterator, List, Optional, Tuple, Union

import numpy as np

from htslib_tpu_torch.sam.cigar import (BAM_CIGAR_SHIFT, BAM_CREF_SKIP,
                                        BAM_CSOFT_CLIP, cigar2qlen,
                                        cigar2rlen, format_cigar,
                                        parse_cigar, reg2bin)

# -- flags (htslib/sam.h:151-178) -------------------------------------------
FPAIRED = 0x1
FPROPER_PAIR = 0x2
FUNMAP = 0x4
FMUNMAP = 0x8
FREVERSE = 0x10
FMREVERSE = 0x20
FREAD1 = 0x40
FREAD2 = 0x80
FSECONDARY = 0x100
FQCFAIL = 0x200
FDUP = 0x400
FSUPPLEMENTARY = 0x800

# -- nt16 encoding (hts.c:239 seq_nt16_table, hts.c:262 seq_nt16_str) --------
SEQ_NT16_STR = "=ACMGRSVTWYHKDBN"
_NT16_TABLE = np.full(256, 15, dtype=np.uint8)
for _i, _c in enumerate(SEQ_NT16_STR):
    _NT16_TABLE[ord(_c)] = _i
    _NT16_TABLE[ord(_c.lower())] = _i
for _i, _c in enumerate("0123"):          # legacy numeric encoding
    _NT16_TABLE[ord(_c)] = 1 << _i
_NT16_TABLE[ord("U")] = 8
_NT16_TABLE[ord("u")] = 8
_NT16_STR_ARR = np.frombuffer(SEQ_NT16_STR.encode(), np.uint8)

_CORE_STRUCT = struct.Struct("<iiBBHHHiiii")

_AUX_SIZE = {"A": 1, "c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4,
             "f": 4, "d": 8}
_AUX_FMT = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i",
            "I": "<I", "f": "<f", "d": "<d"}


def _fmt_g(x: float) -> str:
    """C's "%g" for doubles — matches ksprintf(.., "%g") and kputd."""
    return "%g" % x


class BamRecord:
    __slots__ = ("tid", "pos", "mapq", "bin", "flag", "mtid", "mpos",
                 "isize", "qname", "cigar", "seq4", "l_qseq", "qual", "aux")

    def __init__(self):
        self.tid = -1
        self.pos = -1
        self.mapq = 0
        self.bin = 0
        self.flag = FUNMAP
        self.mtid = -1
        self.mpos = -1
        self.isize = 0
        self.qname = b"*"
        self.cigar = np.empty(0, np.uint32)
        self.seq4 = b""          # packed nibbles, ceil(l_qseq/2) bytes
        self.l_qseq = 0
        self.qual = b""          # l_qseq bytes; 0xff = missing
        self.aux = b""           # BAM wire-format aux blob

    # ------------------------------------------------------------------
    # Binary (BAM) I/O
    # ------------------------------------------------------------------
    @classmethod
    def from_bam_buffer(cls, buf: Union[bytes, memoryview], offset: int = 0,
                        size: Optional[int] = None) -> "BamRecord":
        """Parse one record from its payload (after the 4-byte block_size).

        Validation mirrors bam_read1 (sam.c:809-850).
        """
        b = cls()
        mv = memoryview(buf)
        if size is None:
            size = len(mv) - offset
        if size < 32:
            raise ValueError("BAM record too short")
        (refid, pos, l_read_name, mapq, bin_, n_cigar, flag, l_qseq,
         next_refid, next_pos, tlen) = _CORE_STRUCT.unpack_from(mv, offset)
        if l_read_name == 0:
            raise ValueError("BAM record: empty query name")
        p = offset + 32
        end = offset + size
        need = l_read_name + 4 * n_cigar + (l_qseq + 1) // 2 + l_qseq
        if 32 + need > size:
            raise ValueError("BAM record: corrupt variable-length data")
        b.tid, b.pos, b.mapq, b.bin = refid, pos, mapq, bin_
        b.flag, b.mtid, b.mpos, b.isize = flag, next_refid, next_pos, tlen
        b.l_qseq = l_qseq
        b.qname = bytes(mv[p:p + l_read_name - 1])
        p += l_read_name
        b.cigar = np.frombuffer(mv[p:p + 4 * n_cigar], dtype="<u4").copy()
        p += 4 * n_cigar
        nseq = (l_qseq + 1) // 2
        b.seq4 = bytes(mv[p:p + nseq])
        p += nseq
        b.qual = bytes(mv[p:p + l_qseq])
        p += l_qseq
        b.aux = bytes(mv[p:end])
        b._tag2cigar()
        return b

    def _tag2cigar(self) -> bool:
        """Promote a CG:B,I long CIGAR into the cigar field
        (bam_tag2cigar, sam.c:680)."""
        if len(self.cigar) == 0:
            return False
        test = BAM_CSOFT_CLIP | (self.l_qseq << BAM_CIGAR_SHIFT)
        if int(self.cigar[0]) != test:
            return False
        if self.tid < 0 or self.pos < 0:
            return False
        hit = self._aux_find(b"CG")
        if hit is None:
            return False
        start, vstart, t = hit
        if t != ord("B") or self.aux[vstart] not in (ord("I"), ord("i")):
            return False
        (n,) = struct.unpack_from("<I", self.aux, vstart + 1)
        if n < len(self.cigar) or n >= 1 << 29:
            return False
        vals = np.frombuffer(self.aux, dtype="<u4", count=n,
                             offset=vstart + 5).copy()
        end = vstart + 5 + 4 * n
        self.cigar = vals
        self.aux = self.aux[:start] + self.aux[end:]
        self.bin = reg2bin(self.pos, self.endpos())
        return True

    def to_bam_buffer(self) -> bytes:
        """Serialize payload (without leading block_size) — bam_write1
        (sam.c:862), including the CG escape for >65535 CIGAR ops."""
        cigar = self.cigar
        aux = self.aux
        n_cigar = len(cigar)
        if n_cigar > 0xFFFF:
            # replace with fake cigar + CG:B,I tag (sam.c:884-905)
            rlen = cigar2rlen(cigar)
            fake = np.array([self.l_qseq << 4 | BAM_CSOFT_CLIP,
                             rlen << 4 | BAM_CREF_SKIP], np.uint32)
            cg = (b"CGBI" + struct.pack("<I", n_cigar)
                  + cigar.astype("<u4").tobytes())
            aux = aux + cg
            cigar = fake
            n_cigar = 2
        l_read_name = len(self.qname) + 1
        core = _CORE_STRUCT.pack(
            self.tid, self.pos, l_read_name, self.mapq, self.bin,
            n_cigar, self.flag, self.l_qseq, self.mtid, self.mpos,
            self.isize)
        return b"".join([core, self.qname, b"\0",
                         cigar.astype("<u4").tobytes(), self.seq4,
                         self.qual, aux])

    # ------------------------------------------------------------------
    # Derived values
    # ------------------------------------------------------------------
    def endpos(self) -> int:
        """bam_endpos (sam.c:673): pos + ref length (min 1)."""
        rlen = 0 if (self.flag & FUNMAP) else cigar2rlen(self.cigar)
        return self.pos + (rlen if rlen else 1)

    @property
    def seq(self) -> str:
        if self.l_qseq == 0:
            return "*"
        packed = np.frombuffer(self.seq4, np.uint8)
        nib = np.empty(self.l_qseq, np.uint8)
        hi = packed >> 4
        lo = packed & 0xF
        nib[0::2] = hi[: (self.l_qseq + 1) // 2]
        nib[1::2] = lo[: self.l_qseq // 2]
        return _NT16_STR_ARR[nib].tobytes().decode("ascii")

    def set_seq(self, seq: str, qual: Optional[bytes] = None) -> None:
        if seq == "*" or not seq:
            self.l_qseq = 0
            self.seq4 = b""
            self.qual = b""
            return
        codes = _NT16_TABLE[np.frombuffer(seq.encode(), np.uint8)]
        n = len(codes)
        if n % 2:
            codes = np.concatenate([codes, [0]])
        packed = (codes[0::2] << 4) | codes[1::2]
        self.l_qseq = n
        self.seq4 = packed.astype(np.uint8).tobytes()
        self.qual = qual if qual is not None else b"\xff" * n

    @property
    def qual_str(self) -> str:
        if self.l_qseq == 0 or (self.qual and self.qual[0] == 0xFF):
            return "*"
        return bytes(q + 33 for q in self.qual).decode("ascii")

    # ------------------------------------------------------------------
    # Aux CRUD (bam_aux_*, sam.c:4761-5180)
    # ------------------------------------------------------------------
    def _aux_find(self, tag: bytes) -> Optional[Tuple[int, int, int]]:
        """Return (tag_start, value_start, type_byte) or None."""
        s, aux = 0, self.aux
        n = len(aux)
        while s + 3 <= n:
            t = aux[s + 2]
            vstart = s + 3
            if aux[s:s + 2] == tag:
                return s, vstart, t
            s = self._skip_aux_value(vstart, t)
            if s < 0:
                raise ValueError("corrupt aux data")
        return None

    def _skip_aux_value(self, p: int, t: int) -> int:
        aux = self.aux
        c = chr(t)
        if c in _AUX_SIZE:
            return p + _AUX_SIZE[c]
        if c in ("Z", "H"):
            e = aux.find(b"\0", p)
            return -1 if e < 0 else e + 1
        if c == "B":
            if p + 5 > len(aux):
                return -1
            sub = chr(aux[p])
            (n,) = struct.unpack_from("<I", aux, p + 1)
            sz = _AUX_SIZE.get(sub, 0)
            if sz == 0:
                return -1
            return p + 5 + sz * n
        return -1

    def aux_items(self) -> Iterator[Tuple[bytes, str, object]]:
        """Each aux field as (tag, type char, value); a B array's value is
        (subtype, numpy array)."""
        s, aux = 0, self.aux
        n = len(aux)
        while s + 3 <= n:
            tag = aux[s:s + 2]
            t = chr(aux[s + 2])
            p = s + 3
            val: object
            if t in _AUX_FMT:
                (val,) = struct.unpack_from(_AUX_FMT[t], aux, p)
                nxt = p + _AUX_SIZE[t]
            elif t == "A":
                val = chr(aux[p])
                nxt = p + 1
            elif t in ("Z", "H"):
                e = aux.find(b"\0", p)
                if e < 0:
                    raise ValueError("unterminated Z/H aux")
                val = aux[p:e].decode("ascii", "replace")
                nxt = e + 1
            elif t == "B":
                sub = chr(aux[p])
                (cnt,) = struct.unpack_from("<I", aux, p + 1)
                dt = {"c": "<i1", "C": "<u1", "s": "<i2", "S": "<u2",
                      "i": "<i4", "I": "<u4", "f": "<f4"}[sub]
                val = (sub, np.frombuffer(aux, dt, cnt, p + 5).copy())
                nxt = p + 5 + _AUX_SIZE[sub] * cnt
            else:
                raise ValueError(f"unknown aux type {t!r}")
            yield tag, t, val
            s = nxt

    def get_aux(self, tag: Union[str, bytes]):
        tag = tag.encode() if isinstance(tag, str) else tag
        hit = self._aux_find(tag)
        if hit is None:
            return None
        _, p, t = hit
        c = chr(t)
        aux = self.aux
        if c in _AUX_FMT:
            return struct.unpack_from(_AUX_FMT[c], aux, p)[0]
        if c == "A":
            return chr(aux[p])
        if c in ("Z", "H"):
            e = aux.find(b"\0", p)
            return aux[p:e].decode("ascii", "replace")
        if c == "B":
            sub = chr(aux[p])
            (cnt,) = struct.unpack_from("<I", aux, p + 1)
            dt = {"c": "<i1", "C": "<u1", "s": "<i2", "S": "<u2",
                  "i": "<i4", "I": "<u4", "f": "<f4"}[sub]
            return np.frombuffer(aux, dt, cnt, p + 5).copy()
        return None

    def del_aux(self, tag: Union[str, bytes]) -> bool:
        tag = tag.encode() if isinstance(tag, str) else tag
        hit = self._aux_find(tag)
        if hit is None:
            return False
        start, p, t = hit
        end = self._skip_aux_value(p, t)
        self.aux = self.aux[:start] + self.aux[end:]
        return True

    def set_aux(self, tag: Union[str, bytes], type_: str, value) -> None:
        """bam_aux_update_* / bam_aux_append semantics: replace in place
        (keeping tag order) or append if absent."""
        tag = tag.encode() if isinstance(tag, str) else tag
        enc = encode_aux(tag, type_, value)
        hit = self._aux_find(tag)
        if hit is None:
            self.aux += enc
        else:
            start, p, t = hit
            end = self._skip_aux_value(p, t)
            self.aux = self.aux[:start] + enc + self.aux[end:]

    # ------------------------------------------------------------------
    # SAM text
    # ------------------------------------------------------------------
    def to_sam(self, header) -> str:
        """Byte-exact sam_format1_append (sam.c:4324)."""
        out: List[str] = []
        out.append(self.qname.decode("ascii"))
        out.append(str(self.flag))
        out.append(header.tid2name(self.tid) if self.tid >= 0 else "*")
        out.append(str(self.pos + 1))
        out.append(str(self.mapq))
        out.append(format_cigar(self.cigar))
        if self.mtid < 0:
            out.append("*")
        elif self.mtid == self.tid:
            out.append("=")
        else:
            out.append(header.tid2name(self.mtid))
        out.append(str(self.mpos + 1))
        out.append(str(self.isize))
        out.append(self.seq)
        out.append(self.qual_str)
        line = "\t".join(out)
        auxs = format_aux_blob(self.aux)
        if auxs:
            line += "\t" + auxs
        return line

    @classmethod
    def from_sam(cls, line: str, header,
                 lenient_refs: bool = False) -> "BamRecord":
        """sam_parse1 (sam.c:2662).  A trailing CR is stripped like
        hts_getline's KS_SEP_LINE terminator handling (DOS line
        endings, test/index_dos.sam)."""
        line = line.rstrip("\n")
        if line.endswith("\r"):
            line = line[:-1]
        cols = line.split("\t")
        if len(cols) < 11:
            raise ValueError(f"SAM record has {len(cols)} fields; need 11")
        b = cls()
        b.qname = cols[0].encode("ascii")
        if not b.qname:
            raise ValueError("empty query name")
        flag = cols[1]
        b.flag = int(flag, 16) if flag.startswith("0x") else int(flag)
        rname = cols[2]
        if rname == "*":
            b.tid = -1
        else:
            b.tid = header.name2tid(rname)
            if b.tid < 0:
                if lenient_refs or header.nref == 0:
                    b.tid = header.add_ref(rname, 0)
                else:
                    raise ValueError(f"unknown reference name {rname!r}")
        b.pos = int(cols[3]) - 1
        if b.pos < 0 and b.tid >= 0:
            # unmapped with coordinate 0 (sam.c:2720)
            b.tid = -1 if rname == "*" else b.tid
        b.mapq = int(cols[4])
        b.cigar = parse_cigar(cols[5])
        if len(b.cigar) and b.pos < 0:
            raise ValueError("mapped query cannot have zero coordinate")
        rnext = cols[6]
        if rnext == "*":
            b.mtid = -1
        elif rnext == "=":
            b.mtid = b.tid
        else:
            b.mtid = header.name2tid(rnext)
            if b.mtid < 0:
                if lenient_refs or header.nref == 0:
                    b.mtid = header.add_ref(rnext, 0)
                else:
                    raise ValueError(f"unknown mate reference name {rnext!r}")
        b.mpos = int(cols[7]) - 1
        b.isize = int(cols[8])
        seq = cols[9]
        qual = cols[10]
        if seq != "*":
            b.set_seq(seq)
            if qual != "*":
                if len(qual) != b.l_qseq:
                    raise ValueError("SEQ and QUAL are of different length")
                b.qual = bytes(ord(q) - 33 for q in qual)
        elif qual != "*":
            raise ValueError("QUAL defined for missing SEQ")
        if len(b.cigar) and b.l_qseq and cigar2qlen(b.cigar) != b.l_qseq:
            raise ValueError("CIGAR and query sequence are of different length")
        rlen = cigar2rlen(b.cigar)
        if b.pos >= 0:
            b.bin = reg2bin(b.pos, b.pos + (rlen if rlen else 1))
        else:
            b.bin = reg2bin(-1, 0)
        parts = []
        for col in cols[11:]:
            parts.append(parse_aux_field(col))
        b.aux = b"".join(parts)
        b._tag2cigar()
        return b

    def copy(self) -> "BamRecord":
        c = BamRecord()
        for name in self.__slots__:
            v = getattr(self, name)
            setattr(c, name, v.copy() if isinstance(v, np.ndarray) else v)
        return c


# ---------------------------------------------------------------------------
# Aux encode/format helpers
# ---------------------------------------------------------------------------

def parse_aux_field(col: str) -> bytes:
    """Encode one SAM TAG:TYPE:VALUE field in BAM wire format
    (sam.c:2570-2650 aux parsing, incl. smallest-int-type selection)."""
    if len(col) < 5 or col[2] != ":" or col[4] != ":":
        raise ValueError(f"malformed aux field {col!r}")
    tag = col[:2].encode("ascii")
    t = col[3]
    v = col[5:]
    if t in ("A", "a", "c", "C"):
        return tag + b"A" + v[:1].encode("ascii")
    if t in ("i", "I"):
        x = int(v)
        return tag + _encode_int_aux(x)
    if t == "f":
        return tag + b"f" + struct.pack("<f", float(v))
    if t == "d":
        return tag + b"d" + struct.pack("<d", float(v))
    if t in ("Z", "H"):
        if t == "H" and len(v) % 2:
            raise ValueError("hex field does not have an even number of digits")
        return tag + t.encode() + v.encode("ascii") + b"\0"
    if t == "B":
        if not v:
            raise ValueError("empty B array")
        sub = v[0]
        rest = v[1:]
        if rest and not rest.startswith(","):
            raise ValueError("B aux field type not followed by ','")
        items = rest[1:].split(",") if len(rest) > 1 else []
        return tag + encode_B_array(sub, items)
    raise ValueError(f"unrecognized aux type {t!r}")


def _encode_int_aux(x: int) -> bytes:
    if x < 0:
        if x >= -128:
            return b"c" + struct.pack("<b", x)
        if x >= -32768:
            return b"s" + struct.pack("<h", x)
        return b"i" + struct.pack("<i", x)
    if x <= 0xFF:
        return b"C" + struct.pack("<B", x)
    if x <= 0xFFFF:
        return b"S" + struct.pack("<H", x)
    return b"I" + struct.pack("<I", x)


def encode_B_array(sub: str, items: List[str]) -> bytes:
    n = len(items)
    head = b"B" + sub.encode() + struct.pack("<I", n)
    if sub == "f":
        return head + b"".join(struct.pack("<f", float(s)) for s in items)
    fmt = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i", "I": "<I"}.get(sub)
    if fmt is None:
        raise ValueError(f"unknown B subtype {sub!r}")
    try:
        return head + b"".join(struct.pack(fmt, int(s)) for s in items)
    except struct.error:
        # rescue with a wider type (sam_parse_B_vals_r retry, sam.c:2452-2485)
        vals = [int(s) for s in items]
        mn, mx = min(vals), max(vals)
        if mn < 0:
            if mn >= -128 and mx <= 127:
                sub2 = "c"
            elif mn >= -32768 and mx <= 32767:
                sub2 = "s"
            elif mn >= -(1 << 31) and mx < (1 << 31):
                sub2 = "i"
            else:
                raise ValueError("numeric value in B array out of allowed range")
        else:
            if mx < 0xFF:
                sub2 = "C"
            elif mx <= 0xFFFF:
                sub2 = "S"
            elif mx <= 0xFFFFFFFF:
                sub2 = "I"
            else:
                raise ValueError("numeric value in B array out of allowed range")
        return encode_B_array(sub2, items)


def encode_aux(tag: bytes, type_: str, value) -> bytes:
    """Encode a typed python value (bam_aux_append semantics)."""
    if type_ == "A":
        return tag + b"A" + (value.encode() if isinstance(value, str)
                             else bytes([value]))
    if type_ in ("i", "I", "c", "C", "s", "S"):
        return tag + _encode_int_aux(int(value))
    if type_ == "f":
        return tag + b"f" + struct.pack("<f", float(value))
    if type_ == "d":
        return tag + b"d" + struct.pack("<d", float(value))
    if type_ in ("Z", "H"):
        v = value if isinstance(value, bytes) else str(value).encode()
        return tag + type_.encode() + v + b"\0"
    if type_ == "B":
        sub, arr = value
        arr = np.asarray(arr)
        dt = {"c": "<i1", "C": "<u1", "s": "<i2", "S": "<u2",
              "i": "<i4", "I": "<u4", "f": "<f4"}[sub]
        return (tag + b"B" + sub.encode() + struct.pack("<I", len(arr))
                + arr.astype(dt).tobytes())
    raise ValueError(f"unknown aux type {type_!r}")


def format_aux_blob(aux: bytes) -> str:
    """Format an aux blob as tab-separated SAM text — byte-exact
    sam_format_aux1 (htslib/sam.h:1463)."""
    parts: List[str] = []
    s, n = 0, len(aux)
    while s + 3 <= n:
        tag = aux[s:s + 2].decode("ascii")
        t = chr(aux[s + 2])
        p = s + 3
        if t == "C":
            parts.append(f"{tag}:i:{aux[p]}")
            p += 1
        elif t == "c":
            parts.append(f"{tag}:i:{struct.unpack_from('<b', aux, p)[0]}")
            p += 1
        elif t == "S":
            parts.append(f"{tag}:i:{struct.unpack_from('<H', aux, p)[0]}")
            p += 2
        elif t == "s":
            parts.append(f"{tag}:i:{struct.unpack_from('<h', aux, p)[0]}")
            p += 2
        elif t == "I":
            parts.append(f"{tag}:i:{struct.unpack_from('<I', aux, p)[0]}")
            p += 4
        elif t == "i":
            parts.append(f"{tag}:i:{struct.unpack_from('<i', aux, p)[0]}")
            p += 4
        elif t == "A":
            parts.append(f"{tag}:A:{chr(aux[p])}")
            p += 1
        elif t == "f":
            v = struct.unpack_from("<f", aux, p)[0]
            parts.append(f"{tag}:f:{_fmt_g(v)}")
            p += 4
        elif t == "d":
            v = struct.unpack_from("<d", aux, p)[0]
            parts.append(f"{tag}:d:{_fmt_g(v)}")
            p += 8
        elif t in ("Z", "H"):
            e = aux.find(b"\0", p)
            if e < 0:
                raise ValueError("unterminated Z/H aux")
            parts.append(f"{tag}:{t}:{aux[p:e].decode('ascii')}")
            p = e + 1
        elif t == "B":
            sub = chr(aux[p])
            (cnt,) = struct.unpack_from("<I", aux, p + 1)
            p += 5
            vals: List[str] = []
            if sub == "f":
                arr = np.frombuffer(aux, "<f4", cnt, p)
                vals = [_fmt_g(float(x)) for x in arr]
                p += 4 * cnt
            else:
                dt, sz = {"c": ("<i1", 1), "C": ("<u1", 1),
                          "s": ("<i2", 2), "S": ("<u2", 2),
                          "i": ("<i4", 4), "I": ("<u4", 4)}[sub]
                arr = np.frombuffer(aux, dt, cnt, p)
                vals = [str(int(x)) for x in arr]
                p += sz * cnt
            parts.append(f"{tag}:B:{sub}" + "".join("," + v for v in vals))
        else:
            raise ValueError(f"unknown aux type {t!r} in record")
        s = p
    return "\t".join(parts)
