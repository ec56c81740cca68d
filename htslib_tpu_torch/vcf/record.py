"""VCF/BCF record model — bcf1_t equivalent (reference htslib/vcf.h:236-260,
vcf.c:3987 vcf_parse, vcf.c:4304 vcf_format, vcf.c:2256/2510 bcf_read/write).

Values use BCF canonical typing: integers are int32 numpy arrays with the
INT32 missing/vector-end sentinels; floats are uint32 *bit-pattern* arrays
(so the 0x7F800001/0x7F800002 sentinels survive exactly); strings are raw
bytes.  When a record was decoded from BCF, the original shared/indiv
blobs are retained and reused verbatim on re-encode unless modified
(mirroring bcf1_t's lazy dirty-tracking).

The port's copy of htslib_tpu/vcf/record.py: host code, byte for byte
the JAX package's (it has no native branch).
"""
from __future__ import annotations

import struct
from typing import List, Optional, Tuple, Union

import numpy as np

from htslib_tpu_torch.util.log import log_warning
from htslib_tpu_torch.vcf.header import (BCF_HL_FLT, BCF_HL_FMT,
                                         BCF_HL_INFO, BCF_HT_FLAG,
                                         BCF_HT_INT, BCF_HT_REAL,
                                         BCF_HT_STR, BcfHeader)

# binary types (htslib/vcf.h:104)
BCF_BT_NULL = 0
BCF_BT_INT8 = 1
BCF_BT_INT16 = 2
BCF_BT_INT32 = 3
BCF_BT_INT64 = 4
BCF_BT_FLOAT = 5
BCF_BT_CHAR = 7

INT8_MISSING = -128
INT8_VECTOR_END = -127
INT16_MISSING = -32768
INT16_VECTOR_END = -32767
INT32_MISSING = -2147483648
INT32_VECTOR_END = -2147483647
FLOAT_MISSING = 0x7F800001
FLOAT_VECTOR_END = 0x7F800002
STR_MISSING = 0x07
STR_VECTOR_END = 0x00

# encodable ranges (htslib/vcf.h BCF_MAX_BT_*)
MAX_BT_INT8 = 127
MIN_BT_INT8 = -120
MAX_BT_INT16 = 32767
MIN_BT_INT16 = -32760
MAX_BT_INT32 = 2147483647
MIN_BT_INT32 = -2147483640



def _fmt_g(x: float) -> str:
    return "%g" % x


def float_bits_missing() -> np.ndarray:
    return np.array([FLOAT_MISSING], np.uint32)


# ---------------------------------------------------------------------------
# typed-value wire helpers (vcf.c:2834 bcf_enc_*; :2140 decode checks)
# ---------------------------------------------------------------------------

def enc_size(out: bytearray, size: int, bt: int) -> None:
    if size >= 15:
        out.append(15 << 4 | bt)
        enc_typed_int(out, size)
    else:
        out.append(size << 4 | bt)


def enc_typed_int(out: bytearray, x: int) -> None:
    """bcf_enc_int1: smallest of int8/16/32 honouring reserved values."""
    if x == INT32_VECTOR_END:
        out.append(1 << 4 | BCF_BT_INT8)
        out += struct.pack("<b", INT8_VECTOR_END)
    elif x == INT32_MISSING:
        out.append(1 << 4 | BCF_BT_INT8)
        out += struct.pack("<b", INT8_MISSING)
    elif MIN_BT_INT8 <= x <= MAX_BT_INT8:
        out.append(1 << 4 | BCF_BT_INT8)
        out += struct.pack("<b", x)
    elif MIN_BT_INT16 <= x <= MAX_BT_INT16:
        out.append(1 << 4 | BCF_BT_INT16)
        out += struct.pack("<h", x)
    else:
        out.append(1 << 4 | BCF_BT_INT32)
        out += struct.pack("<i", x)


def enc_vint(out: bytearray, a: np.ndarray, wsize: int = -1) -> None:
    """bcf_enc_vint (vcf.c:2834)."""
    n = len(a)
    if n <= 0:
        enc_size(out, 0, BCF_BT_NULL)
        return
    if n == 1:
        enc_typed_int(out, int(a[0]))
        return
    if wsize <= 0:
        wsize = n
    # reference semantics (vcf.c:2845): max over ALL values (sentinels are
    # hugely negative so they never win), min over non-sentinel values only
    mx = int(a.max())
    mask = a > INT32_VECTOR_END
    mn = int(a[mask].min()) if mask.any() else (1 << 31) - 1
    if mx <= MAX_BT_INT8 and mn >= MIN_BT_INT8:
        enc_size(out, wsize, BCF_BT_INT8)
        vals = np.where(a == INT32_VECTOR_END, INT8_VECTOR_END,
                        np.where(a == INT32_MISSING, INT8_MISSING, a))
        out += vals.astype("<i1").tobytes()
    elif mx <= MAX_BT_INT16 and mn >= MIN_BT_INT16:
        enc_size(out, wsize, BCF_BT_INT16)
        vals = np.where(a == INT32_VECTOR_END, INT16_VECTOR_END,
                        np.where(a == INT32_MISSING, INT16_MISSING, a))
        out += vals.astype("<i2").tobytes()
    else:
        enc_size(out, wsize, BCF_BT_INT32)
        out += a.astype("<i4").tobytes()


def enc_vfloat(out: bytearray, bits: np.ndarray) -> None:
    enc_size(out, len(bits), BCF_BT_FLOAT)
    out += bits.astype("<u4").tobytes()


def enc_vchar(out: bytearray, data: bytes) -> None:
    enc_size(out, len(data), BCF_BT_CHAR)
    out += data


def dec_typed(buf: memoryview, p: int) -> Tuple[int, int, int, int]:
    """Decode a type descriptor: returns (n, bt, data_offset, data_end)."""
    d = buf[p]
    bt = d & 0xF
    n = d >> 4
    p += 1
    if n == 15:
        n, bt2, p2, _ = dec_typed(buf, p)
        # n encoded as typed scalar int
        n = _read_scalar_int(buf, bt2, p2)
        p = p2 + (1 << _bt_shift(bt2))
    size = (n << _bt_shift(bt)) if bt != BCF_BT_NULL else 0
    return n, bt, p, p + size


def _bt_shift(bt: int) -> int:
    return {BCF_BT_INT8: 0, BCF_BT_INT16: 1, BCF_BT_INT32: 2,
            BCF_BT_INT64: 3, BCF_BT_FLOAT: 2, BCF_BT_CHAR: 0,
            BCF_BT_NULL: 0}[bt]


def _read_scalar_int(buf: memoryview, bt: int, p: int) -> int:
    if bt == BCF_BT_INT8:
        return struct.unpack_from("<b", buf, p)[0]
    if bt == BCF_BT_INT16:
        return struct.unpack_from("<h", buf, p)[0]
    if bt == BCF_BT_INT32:
        return struct.unpack_from("<i", buf, p)[0]
    raise ValueError(f"invalid size descriptor type {bt}")


def _read_int_vec(buf: memoryview, bt: int, p: int, n: int) -> np.ndarray:
    """Widen to int32 canonical sentinels."""
    if bt == BCF_BT_INT8:
        a = np.frombuffer(buf, "<i1", n, p).astype(np.int32)
        a[a == INT8_MISSING] = INT32_MISSING
        a[a == INT8_VECTOR_END] = INT32_VECTOR_END
    elif bt == BCF_BT_INT16:
        a = np.frombuffer(buf, "<i2", n, p).astype(np.int32)
        a[a == INT16_MISSING] = INT32_MISSING
        a[a == INT16_VECTOR_END] = INT32_VECTOR_END
    elif bt == BCF_BT_INT32:
        a = np.frombuffer(buf, "<i4", n, p).astype(np.int32)
    elif bt == BCF_BT_NULL:
        a = np.empty(0, np.int32)
    else:
        raise ValueError(f"expected int vector, got type {bt}")
    return a


# ---------------------------------------------------------------------------

class InfoEntry:
    __slots__ = ("key", "type", "value")

    def __init__(self, key: int, type_: int, value):
        self.key = key
        self.type = type_    # BCF_HT_* logical type
        self.value = value   # None | np.int32[] | np.uint32 bits[] | bytes


class FmtEntry:
    __slots__ = ("key", "type", "value", "is_gt")

    def __init__(self, key: int, type_: int, value, is_gt: bool = False):
        self.key = key
        self.type = type_
        self.value = value   # np arrays [n_sample, width] or uint8 char matrix
        self.is_gt = is_gt


class BcfRecord:
    __slots__ = ("rid", "pos", "rlen", "qual_bits", "id", "alleles",
                 "filters", "info", "fmt", "n_sample", "_shared", "_indiv")

    def __init__(self):
        self.rid = -1
        self.pos = -1
        self.rlen = 0
        self.qual_bits = FLOAT_MISSING
        self.id = ""
        self.alleles: List[str] = []
        self.filters: List[int] = []
        self.info: List[InfoEntry] = []
        self.fmt: List[FmtEntry] = []
        self.n_sample = 0
        self._shared: Optional[bytes] = None
        self._indiv: Optional[bytes] = None

    # -- qual ------------------------------------------------------------
    @property
    def qual(self) -> Optional[float]:
        if self.qual_bits == FLOAT_MISSING:
            return None
        return struct.unpack("<f", struct.pack("<I", self.qual_bits))[0]

    @qual.setter
    def qual(self, v: Optional[float]) -> None:
        if v is None:
            self.qual_bits = FLOAT_MISSING
        else:
            self.qual_bits = struct.unpack("<I", struct.pack("<f", v))[0]
        self._shared = None

    @property
    def n_allele(self) -> int:
        return len(self.alleles)

    def get_info(self, header: BcfHeader, key: str):
        kid = header.id2int(key)
        for e in self.info:
            if e.key == kid:
                return e
        return None

    def get_fmt(self, header: BcfHeader, key: str):
        kid = header.id2int(key)
        for e in self.fmt:
            if e.key == kid:
                return e
        return None

    # ==================================================================
    # VCF text parse (vcf_parse, vcf.c:3987)
    # ==================================================================
    @classmethod
    def from_vcf(cls, line: str, header: BcfHeader) -> "BcfRecord":
        cols = line.rstrip("\n").split("\t")
        if len(cols) < 8:
            raise ValueError(f"VCF record has {len(cols)} fields; need >= 8")
        v = cls()
        rid = header.name2rid(cols[0])
        if rid < 0:
            rid = header.add_missing_contig(cols[0])
        v.rid = rid
        v.pos = int(cols[1]) - 1
        v.id = "" if cols[2] == "." else cols[2]
        ref = cols[3]
        v.alleles = [ref]
        if cols[4] != "." and cols[4] != "":
            v.alleles += cols[4].split(",")
        v.rlen = len(ref)
        if cols[5] == ".":
            v.qual_bits = FLOAT_MISSING
        else:
            v.qual_bits = struct.unpack(
                "<I", struct.pack("<f", float(cols[5])))[0]
        v.filters = []
        if cols[6] != ".":
            for name in cols[6].split(";"):
                fid = header.id2int(name)
                if fid < 0 or not header.id_defined(BCF_HL_FLT, fid):
                    fid = header.add_missing(BCF_HL_FLT, name)
                v.filters.append(fid)
        # INFO
        end_val = None
        if cols[7] != ".":
            for item in cols[7].split(";"):
                if not item:
                    continue
                if "=" in item:
                    key, sval = item.split("=", 1)
                else:
                    key, sval = item, None
                kid = header.id2int(key)
                if kid < 0 or not header.id_defined(BCF_HL_INFO, kid):
                    kid = header.add_missing(BCF_HL_INFO, key)
                ht, _, _ = header.coltype(BCF_HL_INFO, kid)
                if sval is None or ht == BCF_HT_FLAG:
                    v.info.append(InfoEntry(kid, BCF_HT_FLAG, None))
                    continue
                if ht == BCF_HT_INT:
                    vals = np.array(
                        [INT32_MISSING if x == "." else int(x)
                         for x in sval.split(",")], np.int32)
                    v.info.append(InfoEntry(kid, BCF_HT_INT, vals))
                    if key == "END":
                        end_val = int(vals[0]) if vals[0] != INT32_MISSING else None
                elif ht == BCF_HT_REAL:
                    bits = np.array(
                        [FLOAT_MISSING if x == "." else
                         struct.unpack("<I", struct.pack("<f", float(x)))[0]
                         for x in sval.split(",")], np.uint32)
                    v.info.append(InfoEntry(kid, BCF_HT_REAL, bits))
                else:
                    v.info.append(InfoEntry(kid, BCF_HT_STR, sval.encode()))
        if end_val is not None and end_val > v.pos:
            v.rlen = end_val - v.pos
        # FORMAT + samples (vcf_parse_format_*, vcf.c:3137-3686)
        if len(cols) > 8 and header.n_samples:
            v._parse_format(cols, header)
        v.n_sample = header.n_samples
        return v

    def _parse_format(self, cols: List[str], header: BcfHeader) -> None:
        keys = cols[8].split(":")
        n_sample = header.n_samples
        sample_cols = cols[9:9 + n_sample]
        if len(sample_cols) < n_sample:
            raise ValueError("fewer sample columns than samples in header")
        split_samples = [s.split(":") for s in sample_cols]
        seen = set()
        for ki, key in enumerate(keys):
            kid = header.id2int(key)
            if kid < 0 or not header.id_defined(BCF_HL_FMT, kid):
                kid = header.add_missing(BCF_HL_FMT, key)
            if kid in seen:
                # duplicate FORMAT key: first occurrence wins
                # (vcf_parse_format_check2, vcf.c:3190)
                log_warning("Duplicate FORMAT tag %s at %d", key, self.pos + 1)
                continue
            seen.add(kid)
            is_gt = key == "GT"
            ht, _, _ = header.coltype(BCF_HL_FMT, kid)
            raw = [s[ki] if ki < len(s) else None for s in split_samples]
            if is_gt:
                parsed = [self._parse_gt(r, header.v44) for r in raw]
                width = max((len(p) for p in parsed), default=1) or 1
                arr = np.full((n_sample, width), INT32_VECTOR_END, np.int32)
                for si, p in enumerate(parsed):
                    arr[si, :len(p)] = p
                    if len(p) == 0:
                        arr[si, 0] = 0  # lone '.' => missing allele
                self.fmt.append(FmtEntry(kid, BCF_HT_INT, arr, True))
            elif ht == BCF_HT_INT:
                parsed = [None if r is None else
                          [INT32_MISSING if x in (".", "") else int(x)
                           for x in r.split(",")] for r in raw]
                width = max((len(p) for p in parsed if p), default=1) or 1
                arr = np.full((n_sample, width), INT32_VECTOR_END, np.int32)
                for si, p in enumerate(parsed):
                    if p is None:
                        arr[si, 0] = INT32_MISSING
                    else:
                        arr[si, :len(p)] = p
                self.fmt.append(FmtEntry(kid, BCF_HT_INT, arr))
            elif ht == BCF_HT_REAL:
                parsed = [None if r is None else
                          [FLOAT_MISSING if x in (".", "") else
                           struct.unpack("<I", struct.pack("<f", float(x)))[0]
                           for x in r.split(",")] for r in raw]
                width = max((len(p) for p in parsed if p), default=1) or 1
                arr = np.full((n_sample, width), FLOAT_VECTOR_END, np.uint32)
                for si, p in enumerate(parsed):
                    if p is None:
                        arr[si, 0] = FLOAT_MISSING
                    else:
                        arr[si, :len(p)] = p
                self.fmt.append(FmtEntry(kid, BCF_HT_REAL, arr))
            else:
                # a missing/'.' sample value is stored as the literal
                # '.' byte, exactly like the text parse leg (vcf.c:3541
                # copies the char; bcf_str_missing 0x07 is only written
                # by the update API) — the reference prints 0x07 as
                # empty, so matching the wire matters for interop
                svals = [b"." if r is None or r == "" else r.encode()
                         for r in raw]
                width = max((len(s) for s in svals), default=1) or 1
                arr = np.zeros((n_sample, width), np.uint8)
                for si, s in enumerate(svals):
                    arr[si, :len(s)] = np.frombuffer(s, np.uint8)
                self.fmt.append(FmtEntry(kid, BCF_HT_STR, arr))

    @staticmethod
    def _parse_gt(r: Optional[str], v44: bool = False) -> List[int]:
        """'0/1' -> [(a+1)<<1|phase...] (vcf.c:3263 vcf_parse_format_gt).

        For VCF >= 4.4 (vcf.c:3434): a leading '|'/'/' sets the first
        allele's phasing explicitly; without a prefix it is inferred —
        haploid calls are implicitly phased (unless missing), and a
        multi-allele first phase copies "all others phased"."""
        if r is None or r == "" or r == ".":
            return []
        explicit = v44 and r[0] in "|/"
        vals: List[int] = []
        phased = 0
        i, n = 0, len(r)
        # leading phasing prefix (vcf4.4)
        while i < n:
            if r[i] == "|":
                phased = 1
                i += 1
                continue
            if r[i] == "/":
                phased = 0
                i += 1
                continue
            if r[i] == ".":
                vals.append(0 | phased)
                i += 1
            else:
                j = i
                while j < n and r[j].isdigit():
                    j += 1
                allele = int(r[i:j])
                if allele > (0x7FFFFFFF >> 1) - 1:
                    # allele bound (vcf.c:3480): too large to encode
                    raise ValueError(f"GT allele too large: {r!r}")
                vals.append(((allele + 1) << 1) | phased)
                i = j
        if v44 and not explicit and vals:
            if len(vals) == 1:
                if vals[0] >> 1:        # haploid, known: implicitly phased
                    vals[0] |= 1
            else:
                anyunphased = any(not (v & 1) for v in vals[1:])
                vals[0] |= 0 if anyunphased else 1
        return vals

    # ==================================================================
    # VCF text format (vcf_format, vcf.c:4304)
    # ==================================================================
    def to_vcf(self, header: BcfHeader) -> str:
        out: List[str] = []
        out.append(header.rid2name(self.rid) if self.rid >= 0 else ".")
        out.append(str(self.pos + 1))
        out.append(self.id if self.id else ".")
        out.append(self.alleles[0] if self.alleles else ".")
        if len(self.alleles) > 1:
            out.append(",".join(self.alleles[1:]))
        else:
            out.append(".")
        q = self.qual
        out.append("." if q is None else _fmt_g(q))
        if self.filters:
            out.append(";".join(header.int2id(f) for f in self.filters))
        else:
            out.append(".")
        if self.info:
            items = []
            for e in self.info:
                key = header.int2id(e.key)
                if e.type == BCF_HT_FLAG or e.value is None:
                    items.append(key)
                elif e.type == BCF_HT_INT:
                    items.append(key + "=" + _fmt_int_arr(e.value))
                elif e.type == BCF_HT_REAL:
                    items.append(key + "=" + _fmt_float_arr(e.value))
                else:
                    items.append(key + "=" + e.value.decode("utf-8"))
            out.append(";".join(items))
        else:
            out.append(".")
        if self.fmt:
            out.append(":".join(header.int2id(f.key) for f in self.fmt))
            for si in range(self.n_sample):
                parts = []
                for f in self.fmt:
                    if f.is_gt:
                        parts.append(_fmt_gt(f.value[si], header.v44))
                    elif f.type == BCF_HT_INT:
                        parts.append(_fmt_int_arr(f.value[si]))
                    elif f.type == BCF_HT_REAL:
                        parts.append(_fmt_float_arr(f.value[si]))
                    else:
                        parts.append(_fmt_char_arr(f.value[si]))
                out.append(":".join(parts) if parts else ".")
        elif self.n_sample or (header.n_samples and not self.fmt):
            for _ in range(header.n_samples + (1 if header.n_samples else 0)):
                out.append(".")
        return "\t".join(out)

    # ==================================================================
    # BCF binary (bcf_read/bcf_write, vcf.c:2256/2510)
    # ==================================================================
    @classmethod
    def from_bcf(cls, shared: bytes, indiv: bytes, header: Optional[BcfHeader],
                 ) -> "BcfRecord":
        v = cls()
        v._shared = shared
        v._indiv = indiv
        buf = memoryview(shared)
        (rid, pos, rlen) = struct.unpack_from("<iii", buf, 0)
        (qual_bits,) = struct.unpack_from("<I", buf, 12)
        (n_ai,) = struct.unpack_from("<I", buf, 16)
        (n_fs,) = struct.unpack_from("<I", buf, 20)
        n_info = n_ai & 0xFFFF
        n_allele = n_ai >> 16
        v.n_sample = n_fs & 0xFFFFFF
        n_fmt = n_fs >> 24
        v.rid, v.pos, v.rlen, v.qual_bits = rid, pos, rlen, qual_bits
        p = 24
        # ID
        n, bt, p, e = dec_typed(buf, p)
        v.id = bytes(buf[p:e]).decode() if bt == BCF_BT_CHAR else ""
        p = e
        # alleles
        for _ in range(n_allele):
            n, bt, p, e = dec_typed(buf, p)
            v.alleles.append(bytes(buf[p:e]).decode())
            p = e
        # FILTER
        n, bt, p2, e = dec_typed(buf, p)
        v.filters = [int(x) for x in _read_int_vec(buf, bt, p2, n)]
        p = e
        # INFO
        for _ in range(n_info):
            n, bt, p2, e = dec_typed(buf, p)
            key = _read_scalar_int(buf, bt, p2)
            p = e
            n, bt, p2, e = dec_typed(buf, p)
            if bt in (BCF_BT_INT8, BCF_BT_INT16, BCF_BT_INT32):
                val = _read_int_vec(buf, bt, p2, n)
                v.info.append(InfoEntry(key, BCF_HT_INT, val))
            elif bt == BCF_BT_FLOAT:
                v.info.append(InfoEntry(
                    key, BCF_HT_REAL, np.frombuffer(buf, "<u4", n, p2).copy()))
            elif bt == BCF_BT_CHAR:
                v.info.append(InfoEntry(key, BCF_HT_STR, bytes(buf[p2:e])))
            elif bt == BCF_BT_NULL:
                v.info.append(InfoEntry(key, BCF_HT_FLAG, None))
            else:
                raise ValueError(f"unsupported INFO type {bt}")
            p = e
        # FORMAT
        buf2 = memoryview(indiv)
        p = 0
        gt_id = header.id2int("GT") if header is not None else -1
        for _ in range(n_fmt):
            n, bt, p2, e = dec_typed(buf2, p)
            key = _read_scalar_int(buf2, bt, p2)
            p = e
            n, bt, p2, e0 = dec_typed(buf2, p)
            # per-sample vectors of length n
            total = n * v.n_sample
            if bt in (BCF_BT_INT8, BCF_BT_INT16, BCF_BT_INT32):
                flat = _read_int_vec(buf2, bt, p2, total)
                arr = flat.reshape(v.n_sample, n) if v.n_sample else flat.reshape(0, max(n, 1))
                if (key == gt_id and arr.size and
                        not (header is not None and header.v44)):
                    # updatephasing (vcf.c:1985, run from bcf_record_check
                    # for versions < 4.4): derive the first allele's
                    # phase so binary values match v4.4 semantics.
                    # Haploid: phased unless missing.  Wider: phased iff
                    # the AND of all later phase bits is set — vector
                    # ends (0x..01) count as phased, so short (haploid)
                    # rows in a padded matrix come out phased too.
                    if n == 1:
                        arr[arr[:, 0] != 0, 0] |= 1
                    else:
                        allph = (arr[:, 1:] & 1).astype(bool).all(axis=1)
                        arr[allph, 0] |= 1
                v.fmt.append(FmtEntry(key, BCF_HT_INT, arr, key == gt_id))
            elif bt == BCF_BT_FLOAT:
                flat = np.frombuffer(buf2, "<u4", total, p2).copy()
                v.fmt.append(FmtEntry(
                    key, BCF_HT_REAL, flat.reshape(v.n_sample, n)))
            elif bt == BCF_BT_CHAR:
                flat = np.frombuffer(buf2, np.uint8, total, p2).copy()
                v.fmt.append(FmtEntry(
                    key, BCF_HT_STR, flat.reshape(v.n_sample, n)))
            elif bt == BCF_BT_NULL:
                v.fmt.append(FmtEntry(key, BCF_HT_INT,
                                      np.empty((v.n_sample, 0), np.int32),
                                      key == gt_id))
            else:
                raise ValueError(f"unsupported FORMAT type {bt}")
            p = p2 + total * (1 << _bt_shift(bt))
        return v

    def to_bcf(self) -> Tuple[bytes, bytes]:
        """Serialize (shared, indiv); reuses original blobs if present."""
        if self._shared is not None and self._indiv is not None:
            return self._shared, self._indiv
        shared = bytearray()
        shared += struct.pack("<iii", self.rid, self.pos, self.rlen)
        shared += struct.pack("<I", self.qual_bits)
        shared += struct.pack("<I", (len(self.alleles) << 16) | len(self.info))
        shared += struct.pack("<I", (len(self.fmt) << 24) | self.n_sample)
        if self.id:
            enc_vchar(shared, self.id.encode())
        else:
            enc_size(shared, 0, BCF_BT_CHAR)
        for al in self.alleles:
            enc_vchar(shared, al.encode())
        enc_vint(shared, np.array(self.filters, np.int32))
        for e in self.info:
            enc_typed_int(shared, e.key)
            if e.type == BCF_HT_FLAG or e.value is None:
                enc_size(shared, 0, BCF_BT_NULL)
            elif e.type == BCF_HT_INT:
                enc_vint(shared, e.value)
            elif e.type == BCF_HT_REAL:
                enc_vfloat(shared, e.value)
            else:
                enc_vchar(shared, e.value)
        indiv = bytearray()
        for f in self.fmt:
            enc_typed_int(indiv, f.key)
            if f.type == BCF_HT_INT:
                width = f.value.shape[1] if f.value.ndim == 2 else 0
                enc_vint(indiv, f.value.reshape(-1), wsize=width)
            elif f.type == BCF_HT_REAL:
                enc_size(indiv, f.value.shape[1], BCF_BT_FLOAT)
                indiv += f.value.astype("<u4").tobytes()
            else:
                enc_size(indiv, f.value.shape[1], BCF_BT_CHAR)
                indiv += f.value.astype(np.uint8).tobytes()
        return bytes(shared), bytes(indiv)

    def mark_dirty(self) -> None:
        """Invalidate retained wire blobs after mutation."""
        self._shared = None
        self._indiv = None

    # ==================================================================
    # write-side record CRUD (bcf_update_*, vcf.c:5546-6035,
    # htslib/vcf.h:640-1100).  Return 0 on success, -1 when the tag is
    # not defined in the header (the htslib contract); mutations
    # invalidate the retained wire blobs so to_bcf() re-encodes.
    # ==================================================================

    def update_info(self, header: BcfHeader, key: str, values=None,
                    type: Optional[int] = None) -> int:
        """bcf_update_info (vcf.c:5546).  values=None removes the tag;
        True sets a FLAG; int/float/str or sequences update.  None
        elements inside a sequence become the missing sentinel."""
        kid = header.id2int(key)
        if kid < 0 or not header.id_defined(BCF_HL_INFO, kid):
            return -1
        ht = type
        if ht is None:
            ht, _, _ = header.coltype(BCF_HL_INFO, kid)
        idx = next((i for i, e in enumerate(self.info) if e.key == kid),
                   None)
        is_end = key == "END"
        is_svlen = key == "SVLEN"

        remove = values is None or values is False or (
            isinstance(values, (list, tuple, np.ndarray)) and len(values) == 0)
        if remove:
            if idx is not None:
                del self.info[idx]
                self.mark_dirty()
            if is_end or is_svlen:
                self.rlen = get_rlen(header, self)
            return 0

        if ht == BCF_HT_FLAG or values is True:
            val = None
            ht = BCF_HT_FLAG
        elif ht == BCF_HT_STR:
            if isinstance(values, bytes):
                val = values
            elif isinstance(values, str):
                val = values.encode()
            else:
                val = ",".join(str(v) for v in values).encode()
        elif ht == BCF_HT_REAL:
            val = _coerce_float_bits(values)
        else:
            ht = BCF_HT_INT
            val = _coerce_int32(values)
            if is_end:
                if len(val) != 1:
                    return -1
        e = InfoEntry(kid, ht, val)
        if idx is not None:
            self.info[idx] = e
        else:
            self.info.append(e)
        self.mark_dirty()
        if is_end or is_svlen:
            self.rlen = get_rlen(header, self)
        return 0

    def update_format(self, header: BcfHeader, key: str, values=None,
                      type: Optional[int] = None) -> int:
        """bcf_update_format (vcf.c:5710).  values: [n_sample, width]
        array (or nested sequence); None removes the tag.  A new GT
        entry is inserted first (VCF spec order, vcf.c:5779)."""
        kid = header.id2int(key)
        idx = next((i for i, e in enumerate(self.fmt) if e.key == kid),
                   None)
        remove = values is None or (
            isinstance(values, (list, tuple, np.ndarray)) and len(values) == 0)
        if kid < 0 or not header.id_defined(BCF_HL_FMT, kid):
            return 0 if remove else -1
        is_len = key == "LEN"
        if remove:
            if idx is not None:
                del self.fmt[idx]
                self.mark_dirty()
            if is_len:
                self.rlen = get_rlen(header, self)
            return 0

        self.n_sample = header.n_samples
        ht = type
        if ht is None:
            ht, _, _ = header.coltype(BCF_HL_FMT, kid)
        is_gt = key == "GT"
        if is_gt:
            ht = BCF_HT_INT
        if ht == BCF_HT_REAL:
            arr = _coerce_float_bits_2d(values, self.n_sample)
        elif ht == BCF_HT_STR:
            arr = _coerce_char_matrix(values, self.n_sample)
        else:
            ht = BCF_HT_INT
            arr = _coerce_int32_2d(values, self.n_sample)
        entry = FmtEntry(kid, ht, arr, is_gt)
        if idx is not None:
            self.fmt[idx] = entry
        elif is_gt and self.fmt:
            self.fmt.insert(0, entry)
        else:
            self.fmt.append(entry)
        self.mark_dirty()
        if is_len:
            self.rlen = get_rlen(header, self)
        return 0

    def update_format_string(self, header: BcfHeader, key: str,
                             strings) -> int:
        """bcf_update_format_string (vcf.c:5684): one string per sample,
        padded to equal width with NULs."""
        if strings is None or len(strings) == 0:
            return self.update_format(header, key, None, BCF_HT_STR)
        return self.update_format(header, key, strings, BCF_HT_STR)

    def update_genotypes(self, header: BcfHeader, gts) -> int:
        """bcf_update_genotypes (htslib/vcf.h:1022): gts are encoded
        values from gt_phased()/gt_unphased()/GT_MISSING, shaped
        [n_sample, ploidy]; ragged rows are VECTOR_END padded."""
        return self.update_format(header, "GT", gts, BCF_HT_INT)

    def update_alleles(self, header: BcfHeader, alleles) -> int:
        """bcf_update_alleles (vcf.c:5906) + _bcf1_sync_alleles rlen
        refresh."""
        self.alleles = [a if isinstance(a, str) else a.decode()
                        for a in alleles]
        self.mark_dirty()
        self.rlen = get_rlen(header, self)
        return 0

    def update_alleles_str(self, header: BcfHeader,
                           alleles_string: str) -> int:
        return self.update_alleles(header, alleles_string.split(","))

    def update_filter(self, header: BcfHeader, flt_ids) -> int:
        """bcf_update_filter (vcf.c:5824): replace the whole set."""
        self.filters = [int(f) for f in (flt_ids or [])]
        self.mark_dirty()
        return 0

    def add_filter(self, header: BcfHeader, flt_id: int) -> int:
        """bcf_add_filter (vcf.c:5837): PASS (id 0) clears the rest;
        adding over lone PASS replaces it.  Returns 1 if added."""
        if flt_id in self.filters:
            return 0
        if flt_id == 0 or (len(self.filters) == 1 and self.filters[0] == 0):
            self.filters = [flt_id]
        else:
            self.filters.append(flt_id)
        self.mark_dirty()
        return 1

    def remove_filter(self, header: BcfHeader, flt_id: int,
                      pass_: bool = False) -> int:
        """bcf_remove_filter (vcf.c:5855)."""
        if flt_id not in self.filters:
            return 0
        self.filters.remove(flt_id)
        if not self.filters and pass_:
            self.add_filter(header, 0)
        else:
            self.mark_dirty()
        return 0

    def has_filter(self, header: BcfHeader, name: str) -> int:
        """bcf_has_filter (vcf.c:5869): 1/0, -1 if undefined. '.' means
        PASS; PASS also matches an empty filter set."""
        if name == ".":
            name = "PASS"
        fid = header.id2int(name)
        if fid < 0 or not header.id_defined(BCF_HL_FLT, fid):
            return -1
        if fid == 0 and not self.filters:
            return 1
        return 1 if fid in self.filters else 0

    def update_id(self, id_: Optional[str]) -> int:
        """bcf_update_id (vcf.c:5988)."""
        self.id = "" if id_ in (None, ".") else id_
        self.mark_dirty()
        return 0

    def add_id(self, id_: Optional[str]) -> int:
        """bcf_add_id (vcf.c:6002): append ';'-separated if absent."""
        if not id_:
            return 0
        if self.id:
            if id_ in self.id.split(";"):
                return 0
            self.id = self.id + ";" + id_
        else:
            self.id = id_
        self.mark_dirty()
        return 0


# ---------------------------------------------------------------------------
# genotype encoding macros (htslib/vcf.h:1030-1037)
# ---------------------------------------------------------------------------

GT_MISSING = 0


def gt_phased(idx: int) -> int:
    return ((idx + 1) << 1) | 1


def gt_unphased(idx: int) -> int:
    return (idx + 1) << 1


def gt_allele(val: int) -> int:
    return (val >> 1) - 1


def gt_is_phased(val: int) -> bool:
    return bool(val & 1)


# ---------------------------------------------------------------------------
# update_* value coercion
# ---------------------------------------------------------------------------

def _coerce_int32(values) -> np.ndarray:
    """Scalars/sequences -> int32 with None -> MISSING."""
    if isinstance(values, np.ndarray):
        return values.astype(np.int32, copy=False).reshape(-1)
    if not isinstance(values, (list, tuple)):
        values = [values]
    return np.array([INT32_MISSING if v is None else int(v)
                     for v in values], np.int32)


def _coerce_float_bits(values) -> np.ndarray:
    """Scalars/sequences -> uint32 float bit patterns; None -> MISSING."""
    if isinstance(values, np.ndarray):
        if values.dtype == np.uint32:
            return values.reshape(-1)
        return values.astype("<f4").reshape(-1).view(np.uint32).copy()
    if not isinstance(values, (list, tuple)):
        values = [values]
    out = np.empty(len(values), np.uint32)
    for i, v in enumerate(values):
        out[i] = (FLOAT_MISSING if v is None else
                  struct.unpack("<I", struct.pack("<f", float(v)))[0])
    return out


def _ragged_rows(values, n_sample: int):
    """values as n_sample rows (sequences / scalars / None)."""
    if isinstance(values, np.ndarray) and values.ndim == 2:
        rows = [values[i] for i in range(values.shape[0])]
    elif isinstance(values, np.ndarray):
        flat = values.reshape(-1)
        if n_sample and len(flat) % n_sample == 0:
            w = len(flat) // n_sample
            rows = [flat[i * w:(i + 1) * w] for i in range(n_sample)]
        else:
            rows = [flat]
    else:
        rows = []
        for v in values:
            if v is None or isinstance(v, (int, float)):
                rows.append([v])
            else:
                rows.append(list(v))
    if len(rows) != n_sample:
        raise ValueError(
            f"FORMAT update needs {n_sample} sample rows, got {len(rows)}")
    return rows


def _coerce_int32_2d(values, n_sample: int) -> np.ndarray:
    rows = _ragged_rows(values, n_sample)
    width = max((len(r) for r in rows), default=1) or 1
    arr = np.full((n_sample, width), INT32_VECTOR_END, np.int32)
    for i, r in enumerate(rows):
        for j, v in enumerate(r):
            arr[i, j] = INT32_MISSING if v is None else int(v)
    return arr


def _coerce_float_bits_2d(values, n_sample: int) -> np.ndarray:
    if isinstance(values, np.ndarray) and values.dtype == np.uint32 \
            and values.ndim == 2:
        return values
    rows = _ragged_rows(values, n_sample)
    width = max((len(r) for r in rows), default=1) or 1
    arr = np.full((n_sample, width), FLOAT_VECTOR_END, np.uint32)
    for i, r in enumerate(rows):
        for j, v in enumerate(r):
            if v is None:
                arr[i, j] = FLOAT_MISSING
            elif isinstance(v, (np.uint32, np.integer)) and \
                    isinstance(r, np.ndarray) and r.dtype == np.uint32:
                arr[i, j] = int(v)
            else:
                arr[i, j] = struct.unpack(
                    "<I", struct.pack("<f", float(v)))[0]
    return arr


def _coerce_char_matrix(values, n_sample: int) -> np.ndarray:
    """One string per sample -> NUL-padded fixed-width char matrix
    (bcf_update_format_string, vcf.c:5684)."""
    if isinstance(values, np.ndarray) and values.dtype == np.uint8 \
            and values.ndim == 2:
        return values
    svals = []
    for v in values:
        if v is None:
            svals.append(b".")
        elif isinstance(v, bytes):
            svals.append(v)
        else:
            svals.append(str(v).encode())
    if len(svals) != n_sample:
        raise ValueError(
            f"FORMAT update needs {n_sample} sample strings, got {len(svals)}")
    width = max((len(s) for s in svals), default=1) or 1
    arr = np.zeros((n_sample, width), np.uint8)
    for i, s in enumerate(svals):
        arr[i, :len(s)] = np.frombuffer(s, np.uint8)
    return arr


# ---------------------------------------------------------------------------
# rlen derivation (get_rlen, vcf.c:6420): max over REF length, INFO/END,
# INFO/SVLEN (symbolic CNV/DEL/DUP/INV alts only) and FORMAT/LEN (gVCF
# <*>/<NON_REF> records only)
# ---------------------------------------------------------------------------

def _svlen_on_ref_alt(alt: str) -> bool:
    """svlen_on_ref_for_vcf_alt (hts_internal.h:181)."""
    if len(alt) < 5 or alt[0] != "<" or alt[-1] != ">":
        return False
    if alt[4] not in (">", ":"):
        return False
    return alt[1:4] in ("CNV", "DEL", "DUP", "INV")


def get_rlen(header: BcfHeader, v: "BcfRecord") -> int:
    use_svlen = False
    gvcf = False
    for alt in v.alleles[1:]:
        if not alt.startswith("<"):
            continue
        if _svlen_on_ref_alt(alt):
            use_svlen = True
        elif alt in ("<*>", "<NON_REF>"):
            gvcf = True
    len_ref = len(v.alleles[0]) if v.alleles else 0

    endinfo = v.get_info(header, "END") if header.id2int("END") >= 0 else None
    svleninfo = (v.get_info(header, "SVLEN")
                 if use_svlen and header.id2int("SVLEN") >= 0 else None)
    lenfmt = (v.get_fmt(header, "LEN")
              if gvcf and header.id2int("LEN") >= 0 else None)

    end = 0
    if endinfo is not None and endinfo.value is not None \
            and len(endinfo.value) > 0:
        e0 = int(endinfo.value[0])
        end = 0 if e0 == INT32_MISSING else e0

    # SVLEN leg (vcf.c:6558): largest |SVLEN| over symbolic alleles
    length = 0
    if svleninfo is not None and svleninfo.value is not None:
        for i in range(len(svleninfo.value)):
            if i + 1 >= len(v.alleles):
                break
            if not _svlen_on_ref_alt(v.alleles[i + 1]):
                continue
            t = int(svleninfo.value[i])
            t = 0 if t == INT32_MISSING else abs(t)
            length = max(length, t)
    if (svleninfo is None or not length) and end:
        length = end - v.pos - 1 if end > v.pos else 0
    end_svlen = v.pos + length + 1

    # FORMAT/LEN leg (vcf.c:6600)
    length = 0
    if lenfmt is not None and lenfmt.value is not None \
            and lenfmt.type == BCF_HT_INT:
        for t in lenfmt.value.reshape(-1):
            t = int(t)
            if t in (INT32_MISSING, INT32_VECTOR_END):
                continue
            length = max(length, t)
    if (lenfmt is None or not length) and end:
        length = end - v.pos if end > v.pos else 0
    end_fmtlen = v.pos + length

    hpos = max(end, end_svlen, end_fmtlen)
    return max(hpos - v.pos, len_ref)


# ---------------------------------------------------------------------------
# value formatting (bcf_fmt_array, vcf.c:3036)
# ---------------------------------------------------------------------------

def _fmt_int_arr(a: np.ndarray) -> str:
    parts = []
    for x in np.atleast_1d(a):
        if x == INT32_VECTOR_END:
            break
        parts.append("." if x == INT32_MISSING else str(int(x)))
    if not parts:
        return "" if len(np.atleast_1d(a)) else "."
    return ",".join(parts)


def _fmt_float_arr(bits: np.ndarray) -> str:
    parts = []
    arr = np.atleast_1d(bits)
    floats = arr.view(np.float32) if arr.dtype == np.uint32 else arr
    for i, b in enumerate(arr):
        if b == FLOAT_VECTOR_END:
            break
        if b == FLOAT_MISSING:
            parts.append(".")
        else:
            parts.append(_fmt_g(float(floats[i])))
    if not parts:
        return "" if len(arr) else "."
    return ",".join(parts)


def _fmt_char_arr(a: np.ndarray) -> str:
    if len(a) == 0:
        return "."
    out = []
    for c in a:
        if c == 0:
            break
        out.append("." if c == STR_MISSING else chr(c))
    return "".join(out) if out else ""


def _fmt_gt(vals: np.ndarray, v44: bool = False) -> str:
    """bcf_format_gt_v2 (vcf.c:6345).  For VCF >= 4.4 a first-allele
    phasing prefix is emitted only when the reader's inference would
    otherwise get it wrong (vcf.c:6382): '|' for a phased first allele
    when a later allele is unphased (or a lone phased '.'), '/' for an
    unphased first allele when it is a known haploid or no later allele
    is unphased."""
    parts = []
    val0 = 0
    anyunphased = False
    ploidy = 0
    for i, val in enumerate(vals):
        v = int(val)
        if v == INT32_VECTOR_END:
            break
        ploidy += 1
        if i == 0:
            val0 = v
        else:
            parts.append("|" if v & 1 else "/")
            anyunphased |= not (v & 1)
        allele = v >> 1
        parts.append("." if allele == 0 else str(allele - 1))
    if not parts:
        return "."
    if v44:
        if val0 & 1:
            if (ploidy > 1 and anyunphased) or (ploidy <= 1 and not (val0 >> 1)):
                parts.insert(0, "|")
        else:
            if (ploidy <= 1 and val0 != 0) or (ploidy > 1 and not anyunphased):
                parts.insert(0, "/")
    return "".join(parts)
