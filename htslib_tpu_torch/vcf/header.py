"""VCF/BCF header model (reference vcf.c bcf_hdr_*, htslib/vcf.h:122-180).

Three dictionaries mirror bcf_hdr_t: BCF_DT_ID (shared FILTER/INFO/FORMAT
string table, PASS fixed at id 0), BCF_DT_CTG (contigs), BCF_DT_SAMPLE.
Header lines are kept verbatim for byte-exact text round trips; structured
lines additionally parse their <key=value> pairs for Number/Type metadata
and IDX handling (vcf.c:4015 bcf_hdr_parse_line).

The port's copy of htslib_tpu/vcf/header.py: host code, byte for byte
the JAX package's.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from htslib_tpu_torch.util.log import log_warning

# header line types (htslib/vcf.h:64)
BCF_HL_FLT = 0
BCF_HL_INFO = 1
BCF_HL_FMT = 2
BCF_HL_CTG = 3
BCF_HL_STR = 4
BCF_HL_GEN = 5

# value types (htslib/vcf.h:71)
BCF_HT_FLAG = 0
BCF_HT_INT = 1
BCF_HT_REAL = 2
BCF_HT_STR = 3
BCF_HT_LONG = 0x101

# Number= classes (htslib/vcf.h:76)
BCF_VL_FIXED = 0
BCF_VL_VAR = 1
BCF_VL_A = 2
BCF_VL_G = 3
BCF_VL_R = 4
BCF_VL_P = 5   # VCFv4.4, FORMAT only: one value per GT allele
BCF_VL_LA = 6  # VCFv4.5 local alleles (htslib/vcf.h:79-82)
BCF_VL_LG = 7
BCF_VL_LR = 8
BCF_VL_M = 9   # one value per base modification

_HT_NAME = {"Integer": BCF_HT_INT, "Float": BCF_HT_REAL,
            "String": BCF_HT_STR, "Character": BCF_HT_STR,
            "Flag": BCF_HT_FLAG}
_VL_NAME = {"A": BCF_VL_A, "G": BCF_VL_G, "R": BCF_VL_R, ".": BCF_VL_VAR}
# VCFv4.4/4.5 codes valid only on FORMAT lines (vcf.c:947-951)
_VL_NAME_FMT = {"P": BCF_VL_P, "LA": BCF_VL_LA, "LG": BCF_VL_LG,
                "LR": BCF_VL_LR, "M": BCF_VL_M}


def _parse_structured(value: str) -> List[Tuple[str, str]]:
    """Parse '<ID=x,Number=1,Description="a,b">' into ordered pairs,
    mirroring bcf_hdr_parse_line2 (vcf.c:690-760): spaces around '='
    skipped, trailing value spaces trimmed, quoted values keep their
    quotes, '[...]' arrays kept verbatim, nested <> tracked."""
    assert value.startswith("<")
    s = value[1:]
    pairs: List[Tuple[str, str]] = []
    i, n = 0, len(s)
    nopen = 1
    while i < n and nopen > 0:
        while i < n and s[i] == " ":
            i += 1
        k0 = i
        while i < n and s[i] not in "=> ":
            i += 1
        key = s[k0:i]
        while i < n and s[i] == " ":
            i += 1
        if i >= n or s[i] != "=" or not key:
            break
        i += 1
        while i < n and s[i] == " ":
            i += 1
        quoted = False
        bracket = False
        if i < n and s[i] == '"':
            quoted = True
            i += 1
        elif i < n and s[i] == "[":
            bracket = True
        v0 = i
        while i < n:
            c = s[i]
            if quoted:
                if c == '"' and (i == v0 or s[i - 1] != "\\"):
                    break
            elif bracket:
                if c == "]":
                    i += 1
                    break
            else:
                if c == "<":
                    nopen += 1
                elif c == ">":
                    nopen -= 1
                    if nopen == 0:
                        break
                elif c == "," and nopen == 1:
                    break
            i += 1
        val = s[v0:i]
        if not quoted:
            val = val.rstrip(" ")
        if quoted:
            val = '"' + val + '"'
            i += 1  # closing quote
        pairs.append((key, val))
        # advance past , or >
        while i < n and s[i] == " ":
            i += 1
        if i < n and s[i] == ">":
            nopen -= 1
            i += 1
        elif i < n and s[i] == ",":
            i += 1
    return pairs


class HeaderRec:
    """bcf_hrec_t: one ##key=value line."""

    __slots__ = ("key", "value", "pairs", "raw")

    def __init__(self, key: str, value: Optional[str],
                 pairs: Optional[List[Tuple[str, str]]], raw: str):
        self.key = key          # e.g. 'INFO', 'fileformat', 'contig'
        self.value = value      # for generic ##key=value lines
        self.pairs = pairs      # for structured <...> lines
        self.raw = raw          # original text (no newline)

    def get(self, k: str) -> Optional[str]:
        """Value with surrounding quotes stripped."""
        if not self.pairs:
            return None
        for key, val in self.pairs:
            if key == k:
                if len(val) >= 2 and val[0] == '"' and val[-1] == '"':
                    return val[1:-1]
                return val
        return None

    def set(self, k: str, v: str, quoted: bool = False) -> None:
        if self.pairs is None:
            self.pairs = []
        if quoted:
            v = '"' + v + '"'
        for i, (key, _) in enumerate(self.pairs):
            if key == k:
                self.pairs[i] = (k, v)
                self._rebuild_raw()
                return
        self.pairs.append((k, v))
        self._rebuild_raw()

    def format(self, is_bcf: bool = False) -> str:
        """_bcf_hrec_format (vcf.c): canonical '##key=<k=v,...>'; IDX
        omitted for VCF output."""
        if self.pairs is None:
            return self.raw
        body = ",".join(f"{k}={v}" for k, v in self.pairs
                        if is_bcf or k != "IDX")
        return f"##{self.key}=<{body}>"

    def _rebuild_raw(self) -> None:
        self.raw = self.format(is_bcf=True)


class IdInfo:
    """Per-ID metadata for each of the FLT/INFO/FMT contexts
    (bcf_idinfo_t, htslib/vcf.h:110)."""

    __slots__ = ("number", "type", "vl", "hrec")

    def __init__(self):
        self.number = [0xFFFFF] * 3   # fixed count, or 0xfffff for var
        self.type = [-1] * 3
        self.vl = [BCF_VL_FIXED] * 3
        self.hrec: List[Optional[HeaderRec]] = [None] * 3


class BcfHeader:
    def __init__(self, text: str = ""):
        self.hrecs: List[HeaderRec] = []
        self.samples: List[str] = []
        # BCF_DT_ID dictionary
        self.id_names: List[str] = []
        self.id_info: List[IdInfo] = []
        self._id_lookup: Dict[str, int] = {}
        # contigs
        self.ctg_names: List[str] = []
        self.ctg_lens: List[int] = []
        self._ctg_lookup: Dict[str, int] = {}
        self.version = "VCFv4.2"
        self._ensure_pass()
        if text:
            self.parse(text)
        else:
            # bcf_hdr_init("w") seeds a writable header with the
            # fileformat line and the implicit PASS filter (vcf.c:3846)
            self.add_hrec_line("##fileformat=VCFv4.2")
            self.add_hrec_line(
                '##FILTER=<ID=PASS,Description="All filters passed">')

    # ------------------------------------------------------------------
    @property
    def v44(self) -> bool:
        """True for VCF >= 4.4 (the reference's VCF44 gate, vcf.c:132):
        GT gets explicit first-allele phasing prefixes and inference."""
        v = self.version
        if not v.startswith("VCFv"):
            return False
        try:
            parts = v[4:].split(".")
            major, minor = int(parts[0]), int(parts[1])
        except (ValueError, IndexError):
            return False
        return (major, minor) >= (4, 4)

    def _ensure_pass(self) -> None:
        if "PASS" not in self._id_lookup:
            i = self._intern_id("PASS")
            info = self.id_info[i]
            info.number[BCF_HL_FLT] = 0
            info.type[BCF_HL_FLT] = BCF_HT_FLAG

    def _intern_id(self, name: str, idx: Optional[int] = None) -> int:
        if name in self._id_lookup:
            return self._id_lookup[name]
        if idx is None:
            idx = len(self.id_names)
        while len(self.id_names) <= idx:
            self.id_names.append("")
            self.id_info.append(IdInfo())
        if self.id_names[idx] and self.id_names[idx] != name:
            raise ValueError(f"conflicting IDX {idx} for {name!r}")
        self.id_names[idx] = name
        self._id_lookup[name] = idx
        return idx

    def _intern_ctg(self, name: str, length: int = 0,
                    idx: Optional[int] = None) -> int:
        if name in self._ctg_lookup:
            return self._ctg_lookup[name]
        if idx is None:
            idx = len(self.ctg_names)
        while len(self.ctg_names) <= idx:
            self.ctg_names.append("")
            self.ctg_lens.append(0)
        self.ctg_names[idx] = name
        self.ctg_lens[idx] = length
        self._ctg_lookup[name] = idx
        return idx

    # ------------------------------------------------------------------
    def parse(self, text: str) -> None:
        """bcf_hdr_parse (vcf.c:4131)."""
        for raw in text.split("\n"):
            raw = raw.rstrip("\r")
            if not raw:
                continue
            if raw.startswith("##"):
                self.add_hrec_line(raw)
            elif raw.startswith("#CHROM"):
                cols = raw.split("\t")
                if len(cols) > 9:
                    self.samples = cols[9:]
                elif len(cols) == 9:
                    self.samples = []
                else:
                    self.samples = []
        # ensure an explicit PASS FILTER line exists (bcf_hdr_parse adds one
        # right after ##fileformat, vcf.c:4172)
        if not any(r.key == "FILTER" and r.get("ID") == "PASS"
                   for r in self.hrecs):
            raw = '##FILTER=<ID=PASS,Description="All filters passed">'
            rec = HeaderRec("FILTER", None,
                            [("ID", "PASS"),
                             ("Description", '"All filters passed"')], raw)
            pos = 0
            for i, r in enumerate(self.hrecs):
                if r.key == "fileformat":
                    pos = i + 1
                    break
            self.hrecs.insert(pos, rec)
            self._register(rec)

    def add_hrec_line(self, raw: str) -> Optional[HeaderRec]:
        body = raw[2:]
        eq = body.find("=")
        if eq < 0:
            log_warning("malformed header line: %s", raw)
            return None
        key = body[:eq]
        value = body[eq + 1:]
        if value.startswith("<"):
            pairs = _parse_structured(value)
            rec = HeaderRec(key, None, pairs, raw)
            # a dictionary line whose ID already has a line of this key
            # is ignored, first wins (bcf_hdr_add_hrec, vcf.c:986)
            rid = rec.get("ID")
            if (key in ("FILTER", "INFO", "FORMAT", "contig")
                    and rid is not None and self.has_hrec(key, rid)):
                return None
        else:
            rec = HeaderRec(key, value, None, raw)
            if key == "fileformat":
                self.version = value
                # only one fileformat line: update in place
                for old in self.hrecs:
                    if old.key == "fileformat":
                        old.value = value
                        old.raw = raw
                        return old
        self.hrecs.append(rec)
        self._register(rec)
        return rec

    def _register(self, rec: HeaderRec) -> None:
        if rec.pairs is None:
            return
        rid = rec.get("ID")
        idx = rec.get("IDX")
        idx = int(idx) if idx is not None else None
        if rec.key == "contig":
            if rid is not None:
                length = rec.get("length")
                self._intern_ctg(rid, int(length) if length else 0, idx)
            return
        hl = {"FILTER": BCF_HL_FLT, "INFO": BCF_HL_INFO,
              "FORMAT": BCF_HL_FMT}.get(rec.key)
        if hl is None or rid is None:
            return
        i = self._intern_id(rid, idx)
        info = self.id_info[i]
        info.hrec[hl] = rec
        if hl == BCF_HL_FLT:
            info.number[hl] = 0
            info.type[hl] = BCF_HT_FLAG
            return
        num = rec.get("Number")
        typ = rec.get("Type")
        info.type[hl] = _HT_NAME.get(typ or "String", BCF_HT_STR)
        vl_names = dict(_VL_NAME)
        if hl == BCF_HL_FMT:
            vl_names.update(_VL_NAME_FMT)
        if num in vl_names:
            info.vl[hl] = vl_names[num]
            info.number[hl] = 0xFFFFF
        elif num is not None:
            try:
                info.number[hl] = int(num)
                info.vl[hl] = BCF_VL_FIXED
            except ValueError:
                info.vl[hl] = BCF_VL_VAR
                info.number[hl] = 0xFFFFF
        if rec.key == "INFO" and info.type[hl] == BCF_HT_FLAG:
            info.number[hl] = 0

    # -- lookups ---------------------------------------------------------
    def id2int(self, name: str) -> int:
        return self._id_lookup.get(name, -1)

    def int2id(self, i: int) -> str:
        return self.id_names[i]

    def name2rid(self, name: str) -> int:
        return self._ctg_lookup.get(name, -1)

    def rid2name(self, rid: int) -> str:
        return self.ctg_names[rid]

    @property
    def n_samples(self) -> int:
        return len(self.samples)

    def coltype(self, hl: int, id_: int) -> Tuple[int, int, int]:
        """(type, vl, fixed_number) of id in context hl."""
        info = self.id_info[id_]
        return info.type[hl], info.vl[hl], info.number[hl]

    def id_defined(self, hl: int, id_: int) -> bool:
        return 0 <= id_ < len(self.id_info) and self.id_info[id_].type[hl] != -1

    # -- dynamic additions (vcf_parse auto-add, vcf.c:3748) --------------
    def add_missing(self, hl: int, name: str) -> int:
        kind = {BCF_HL_FLT: "FILTER", BCF_HL_INFO: "INFO",
                BCF_HL_FMT: "FORMAT"}[hl]
        log_warning("%s '%s' is not defined in the header, assuming "
                    "Type=String", kind, name)
        if hl == BCF_HL_FLT:
            raw = f'##FILTER=<ID={name},Description="Dummy">'
        else:
            raw = (f'##{kind}=<ID={name},Number=1,Type=String,'
                   f'Description="Dummy">')
        rec = self.add_hrec_line(raw)
        return self.id2int(name)

    def add_missing_contig(self, name: str) -> int:
        log_warning("Contig '%s' is not defined in the header. (Quick "
                    "workaround: index the file with tabix.)", name)
        self.add_hrec_line(f"##contig=<ID={name}>")
        return self.name2rid(name)

    # -- text ------------------------------------------------------------
    def text(self, with_idx: bool = False) -> str:
        """bcf_hdr_format (vcf.c:4560)."""
        lines = []
        for rec in self.hrecs:
            if rec.pairs is None:
                lines.append(rec.raw)
                continue
            if with_idx and rec.key in ("FILTER", "INFO", "FORMAT",
                                        "contig") and rec.get("IDX") is None:
                rid = rec.get("ID")
                idx = (self.name2rid(rid) if rec.key == "contig"
                       else self.id2int(rid))
                tmp = HeaderRec(rec.key, None, list(rec.pairs), rec.raw)
                tmp.set("IDX", str(idx))
                lines.append(tmp.format(is_bcf=True))
            else:
                lines.append(rec.format(is_bcf=with_idx))
        chrom = "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"
        if self.samples:
            chrom += "\tFORMAT\t" + "\t".join(self.samples)
        lines.append(chrom)
        return "\n".join(lines) + "\n"

    def copy(self) -> "BcfHeader":
        h = BcfHeader()
        for rec in self.hrecs:
            h.add_hrec_line(rec.raw)
        h.samples = list(self.samples)
        return h

    def sequences(self) -> List[str]:
        return list(self.ctg_names)

    # -- convenience -----------------------------------------------------
    def has_hrec(self, key: str, id_: str) -> bool:
        for rec in self.hrecs:
            if rec.key == key and rec.get("ID") == id_:
                return True
        return False

    def remove_hrec(self, key: str, id_: Optional[str] = None,
                    structured: Optional[bool] = None) -> None:
        """bcf_hdr_remove (vcf.c:4460): drop lines (does not renumber
        existing dictionary entries, as in the reference).  `structured`
        narrows the match to BCF_HL_STR lines (True: ``##key=<...>``)
        or BCF_HL_GEN lines (False: ``##key=text``) — the reference
        removes by line type, so removing generic 'unused' lines leaves
        a structured ``##unused=<XX=..>`` in place."""
        keep = []
        for rec in self.hrecs:
            if (rec.key == key and (id_ is None or rec.get("ID") == id_)
                    and (structured is None
                         or (rec.pairs is not None) == structured)):
                continue
            keep.append(rec)
        self.hrecs = keep

    def append_line(self, raw: str) -> None:
        self.add_hrec_line(raw.rstrip("\n"))

    # -- header hygiene (bcf_hdr_check_sanity, vcf.c:1290-1430) ---------
    _SANITY_INFO = {
        "AA": ("1", BCF_HT_STR), "AC": ("A", BCF_HT_INT),
        "AD": ("R", BCF_HT_INT), "ADF": ("R", BCF_HT_INT),
        "ADR": ("R", BCF_HT_INT), "AF": ("A", BCF_HT_REAL),
        "AN": ("1", BCF_HT_INT), "BQ": ("1", BCF_HT_REAL),
        "CIGAR": ("A", BCF_HT_STR), "DB": ("0", BCF_HT_FLAG),
        "DP": ("1", BCF_HT_INT), "END": ("1", BCF_HT_INT),
        "H2": ("0", BCF_HT_FLAG), "H3": ("0", BCF_HT_FLAG),
        "MQ": ("1", BCF_HT_REAL), "MQ0": ("1", BCF_HT_INT),
        "NS": ("1", BCF_HT_INT), "SB": ("4", BCF_HT_INT),
        "SOMATIC": ("0", BCF_HT_FLAG), "VALIDATED": ("0", BCF_HT_FLAG),
        "1000G": ("0", BCF_HT_FLAG),
    }
    _SANITY_FMT = {
        "AD": ("R", BCF_HT_INT), "ADF": ("R", BCF_HT_INT),
        "ADR": ("R", BCF_HT_INT), "EC": ("A", BCF_HT_INT),
        "GL": ("G", BCF_HT_REAL), "GP": ("G", BCF_HT_REAL),
        "PL": ("G", BCF_HT_INT), "PP": ("G", BCF_HT_INT),
        "DP": ("1", BCF_HT_INT), "LEN": ("1", BCF_HT_INT),
        "FT": ("1", BCF_HT_STR), "GQ": ("1", BCF_HT_INT),
        "GT": ("1", BCF_HT_STR), "HQ": ("2", BCF_HT_INT),
        "MQ": ("1", BCF_HT_INT), "PQ": ("1", BCF_HT_INT),
        "PS": ("1", BCF_HT_INT),
        "PSL": ("P", BCF_HT_STR), "PSO": ("P", BCF_HT_INT),
        "PSQ": ("P", BCF_HT_INT),
        "LGL": ("LG", BCF_HT_INT), "LGP": ("LG", BCF_HT_INT),
        "LPL": ("LG", BCF_HT_INT), "LPP": ("LG", BCF_HT_INT),
        "LEC": ("LA", BCF_HT_INT), "LAD": ("LR", BCF_HT_INT),
        "LADF": ("LR", BCF_HT_INT), "LADR": ("LR", BCF_HT_INT),
    }

    def check_sanity(self) -> List[str]:
        """Warn when reserved INFO/FORMAT tags are declared with a
        Number or Type that contradicts the VCF spec
        (bcf_hdr_check_sanity, vcf.c:1290).  Returns the warnings."""
        from htslib_tpu_torch.util.log import log_warning
        name_to_vl = dict(_VL_NAME)
        name_to_vl.update(_VL_NAME_FMT)
        out = []
        for hl, table in ((BCF_HL_INFO, self._SANITY_INFO),
                          (BCF_HL_FMT, self._SANITY_FMT)):
            kind = "INFO" if hl == BCF_HL_INFO else "FORMAT"
            for name, (num_str, want_type) in table.items():
                i = self._id_lookup.get(name)
                if i is None or self.id_info[i].hrec[hl] is None:
                    continue
                info = self.id_info[i]
                if num_str.isdigit():
                    ok = (info.vl[hl] == BCF_VL_FIXED
                          and info.number[hl] == int(num_str))
                else:
                    ok = info.vl[hl] == name_to_vl[num_str]
                if not ok and info.vl[hl] != BCF_VL_VAR:
                    out.append(f"{name} should be declared as "
                               f"Number={num_str}")
                if info.type[hl] != want_type:
                    tname = {BCF_HT_FLAG: "Flag", BCF_HT_INT: "Integer",
                             BCF_HT_REAL: "Float",
                             BCF_HT_STR: "String"}[want_type]
                    out.append(f"{name} ({kind}) should be declared as "
                               f"Type={tname}")
        for w in out:
            log_warning("%s", w)
        return out
