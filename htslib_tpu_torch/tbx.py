"""Tabix — generic coordinate indexing of bgzipped text: the port's copy
of htslib_tpu/tbx.py (reference tbx.c).

Builds TBI/CSI indexes over tab-delimited text (VCF/BED/GFF/SAM/GAF
presets, tbx.c:43-56), with the column configuration and the name<->tid
dictionary stored in the index meta block (tbx.c:375).
"""
from __future__ import annotations

import os
import re
import struct
from typing import Dict, Iterator, List, Optional, Tuple

from htslib_tpu_torch.bgzf import BgzfReader
from htslib_tpu_torch.index import (HTS_FMT_CSI, HTS_FMT_TBI, HtsIndex,
                                    parse_region)
from htslib_tpu_torch.util.log import log_warning

TBX_GENERIC = 0
TBX_SAM = 1
TBX_VCF = 2
TBX_UCSC = 0x10000
TBX_GAF = 4


class TbxConf:
    """tbx_conf_t (htslib/tbx.h:38): preset flags + column numbers."""

    def __init__(self, preset: int, sc: int, bc: int, ec: int,
                 meta_char: int, line_skip: int):
        self.preset = preset
        self.sc = sc
        self.bc = bc
        self.ec = ec
        self.meta_char = meta_char
        self.line_skip = line_skip

    def pack(self) -> bytes:
        return struct.pack("<6i", self.preset, self.sc, self.bc, self.ec,
                           self.meta_char, self.line_skip)

    @classmethod
    def unpack(cls, raw: bytes) -> "TbxConf":
        return cls(*struct.unpack_from("<6i", raw))


CONF_GFF = TbxConf(0, 1, 4, 5, ord("#"), 0)
CONF_BED = TbxConf(TBX_UCSC, 1, 2, 3, ord("#"), 0)
CONF_PSLTBL = TbxConf(TBX_UCSC, 15, 17, 18, ord("#"), 0)
CONF_SAM = TbxConf(TBX_SAM, 3, 4, 0, ord("@"), 0)
CONF_VCF = TbxConf(TBX_VCF, 1, 2, 0, ord("#"), 0)
CONF_GAF = TbxConf(TBX_GAF, 1, 6, 0, ord("#"), 0)

PRESETS = {"gff": CONF_GFF, "bed": CONF_BED, "psltbl": CONF_PSLTBL,
           "sam": CONF_SAM, "vcf": CONF_VCF, "gaf": CONF_GAF}


def _svlen_on_ref_alt(alt: str) -> bool:
    """Symbolic ALTs whose span comes from SVLEN (tbx.c
    svlen_on_ref_for_vcf_alt): <DEL>, <DUP>, <INV>, <CNV> families."""
    if not alt.startswith("<"):
        return False
    for key in ("<DEL", "<DUP", "<INV", "<CNV"):
        if alt.startswith(key):
            return True
    return False


def tbx_parse1(conf: TbxConf, line: str) -> Optional[Tuple[str, int, int]]:
    """Extract (name, beg, end) 0-based half-open from one line
    (tbx_parse1, tbx.c:96).  Returns None for malformed lines."""
    cols = line.rstrip("\n").split("\t")
    preset = conf.preset & 0xFFFF
    try:
        name = cols[conf.sc - 1]
    except IndexError:
        return None
    if preset == TBX_GAF:
        # smallest/largest node id in the path column
        try:
            path = cols[conf.bc - 1]
        except IndexError:
            return None
        ids = [int(x) for x in re.findall(r"\d+", path)]
        if not ids:
            return None
        return "", min(ids), max(ids)
    try:
        beg = int(cols[conf.bc - 1])
    except (IndexError, ValueError):
        return None
    end = beg
    if not (conf.preset & TBX_UCSC):
        beg -= 1
    elif conf.bc <= conf.ec:
        end += 1
    if beg < 0:
        log_warning("Coordinate <= 0 detected. Did you forget to use the -0 option?")
        beg = 0
    if end < 1:
        end = 1
    if preset == TBX_GENERIC:
        if conf.ec > 0 and conf.ec != conf.bc:
            try:
                end = int(cols[conf.ec - 1])
            except (IndexError, ValueError):
                return None
    elif preset == TBX_SAM:
        if len(cols) >= 6:
            l = 0
            for num, op in re.findall(r"(\d+)([A-Za-z=])", cols[5]):
                if op.upper() in ("M", "D", "N"):
                    l += int(num)
            if l == 0:
                l = 1
            end = beg + l
    elif preset == TBX_VCF:
        if len(cols) >= 4 and cols[3]:
            end = beg + len(cols[3])
        svlen_mask: List[bool] = []
        use_svlen = False
        if len(cols) >= 5:
            for alt in cols[4].split(","):
                flag = _svlen_on_ref_alt(alt)
                svlen_mask.append(flag)
                use_svlen = use_svlen or flag
        if len(cols) >= 8:
            info = cols[7]
            # END=
            val = _info_field(info, "END")
            if val is not None and val != ".":
                try:
                    e = int(val)
                    if e > beg:
                        end = e
                except ValueError:
                    pass
            if use_svlen:
                sval = _info_field(info, "SVLEN")
                if sval is not None:
                    svlen = 0
                    for i, s in enumerate(sval.split(",")):
                        if i < len(svlen_mask) and svlen_mask[i]:
                            try:
                                svlen = max(svlen, abs(int(s)))
                            except ValueError:
                                pass
                    if svlen and beg + svlen > end:
                        end = beg + svlen
    return name, beg, end


def _info_field(info: str, key: str) -> Optional[str]:
    for part in info.split(";"):
        if part.startswith(key + "="):
            return part[len(key) + 1:].split(";")[0]
    return None


class Tabix:
    """tbx_t: an HtsIndex plus the column conf and name dictionary."""

    def __init__(self, idx: HtsIndex, conf: TbxConf, names: List[str]):
        self.idx = idx
        self.conf = conf
        self.names = names
        self._name2tid: Dict[str, int] = {n: i for i, n in enumerate(names)}

    def name2tid(self, name: str) -> int:
        return self._name2tid.get(name, -1)

    @property
    def seqnames(self) -> List[str]:
        return self.names

    # -- build (tbx_index, tbx.c:437) ------------------------------------
    @classmethod
    def build(cls, fname: str, conf: TbxConf = CONF_VCF, min_shift: int = 0,
              out_path: Optional[str] = None) -> "Tabix":
        fmt = HTS_FMT_CSI if min_shift > 0 else HTS_FMT_TBI
        if min_shift == 0:
            min_shift, n_lvls = 14, 5
        else:
            # tbx.c:524: n_lvls = (TBX_MAX_SHIFT - min_shift + 2) / 3
            n_lvls = (31 - min_shift + 2) // 3
        fp = BgzfReader(fname)
        if not fp.is_bgzf:
            fp.close()
            raise IOError(f"{fname} is not BGZF-compressed; cannot be indexed")
        idx = HtsIndex(0, fmt, min_shift, n_lvls)
        names: List[str] = []
        name2tid: Dict[str, int] = {}
        lineno = 0
        last = fp.tell()
        idx._last_off = idx._save_off = last
        idx._off_beg = idx._off_end = last
        started = False
        while True:
            line = fp.readline()
            if not line:
                break
            lineno += 1
            text = line.decode("utf-8", "replace")
            if (lineno <= conf.line_skip
                    or (text and ord(text[0]) == conf.meta_char)):
                if not started:
                    # offset0 = offset after the last leading meta line
                    # (tbx.c:469 hts_idx_init(..., last_off, ...))
                    last = fp.tell()
                    idx._last_off = idx._save_off = last
                    idx._off_beg = idx._off_end = last
                continue
            started = True
            parsed = tbx_parse1(conf, text)
            last = fp.tell()
            if parsed is None:
                continue
            name, beg, end = parsed
            tid = name2tid.get(name)
            if tid is None:
                tid = len(names)
                name2tid[name] = tid
                names.append(name)
            idx.push(tid, beg, end, last, True)
        idx.finish(last)
        fp.close()
        nm = b"".join(n.encode() + b"\0" for n in names)
        idx.meta = conf.pack() + struct.pack("<I", len(nm)) + nm
        tbx = cls(idx, conf, names)
        if out_path is None:
            out_path = fname + (".csi" if fmt == HTS_FMT_CSI else ".tbi")
        idx.save(out_path)
        return tbx

    # -- load (tbx_index_load, tbx.c:599) --------------------------------
    @classmethod
    def load(cls, idx_path: str) -> "Tabix":
        idx = HtsIndex.load(idx_path)
        if len(idx.meta) < 28:
            raise IOError(f"{idx_path}: missing tabix meta")
        conf = TbxConf.unpack(idx.meta)
        (l_nm,) = struct.unpack_from("<I", idx.meta, 24)
        names = [n.decode() for n in idx.meta[28:28 + l_nm].split(b"\0") if n]
        return cls(idx, conf, names)

    @classmethod
    def load_for(cls, fname: str) -> "Tabix":
        for ext in (".tbi", ".csi"):
            if os.path.exists(fname + ext):
                return cls.load(fname + ext)
        raise FileNotFoundError(f"no tabix index for {fname}")

    # -- query -----------------------------------------------------------
    def query(self, fp: BgzfReader, tid: int, beg: int, end: int,
              ) -> Iterator[str]:
        """Yield matching lines (tbx_readrec filtering, tbx.c:353)."""
        for u, v in self.idx.query_chunks(tid, beg, end):
            fp.seek(u)
            while fp.tell() < v:
                line = fp.readline()
                if not line:
                    break
                text = line.decode("utf-8", "replace")
                parsed = tbx_parse1(self.conf, text)
                if parsed is None:
                    continue
                name, b, e = parsed
                if self.name2tid(name) != tid:
                    continue
                if b >= end:
                    return
                if e > beg:
                    yield text.rstrip("\n")

    def query_region(self, fp: BgzfReader, region: str) -> Iterator[str]:
        res = parse_region(region, self.name2tid)
        if res is None:
            raise ValueError(f"could not parse region {region!r}")
        tid, beg, end, _ = res
        return self.query(fp, tid, beg, end)
