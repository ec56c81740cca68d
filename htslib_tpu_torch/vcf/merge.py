"""Header merging and record translation across VCF/BCF headers: the
port's copy of htslib_tpu/vcf/merge.py.

Equivalents of bcf_hdr_merge (reference vcf.c:4918) and bcf_translate
(vcf.c:5020): merge combines header records from `src` into `dst`
(first-definition-wins for conflicting IDs, warning on Number/Type
disagreements); translate remaps a record's numeric dictionary indices
(contig rid, FILTER ids, INFO/FORMAT keys) from the source header's
dictionaries to the destination's, typically after a merge.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from htslib_tpu_torch.util.log import log_warning
from htslib_tpu_torch.vcf.header import BCF_HL_FMT, BCF_HL_INFO, BcfHeader
from htslib_tpu_torch.vcf.record import BcfRecord

_DICT_KEYS = ("FILTER", "INFO", "FORMAT")


def _version_num(v: str) -> Tuple[int, int]:
    # "VCFv4.3" -> (4, 3); bcf_get_version semantics (vcf.c:2174)
    try:
        core = v.split("v")[-1]
        major, minor = core.split(".")[:2]
        return int(major), int(minor)
    except (ValueError, IndexError):
        return (0, 0)


def bcf_hdr_merge(dst: Optional[BcfHeader], src: BcfHeader) -> BcfHeader:
    """Combine `src`'s header records into `dst` (vcf.c:4918).

    With dst=None, returns a fresh copy of src (with IDX attributes
    re-assigned).  Generic ``##key=value`` lines are compared by key
    only; structured lines by (line type, ID).  For INFO/FORMAT IDs
    already present in dst, dst's definition wins and a warning is
    logged if Number or Type disagree.
    """
    if dst is None:
        return src.copy()

    for rec in src.hrecs:
        rid = rec.get("ID") if rec.pairs is not None else None
        if rec.pairs is None and rec.value is not None:
            # generic ##key=value line: compare by key only
            match = next((d for d in dst.hrecs
                          if d.pairs is None and d.key == rec.key), None)
            if match is None:
                dst.append_line(rec.raw)
            elif rec.key == "fileformat":
                if _version_num(rec.value) > _version_num(match.value or ""):
                    match.value = rec.value
                    match.raw = f"##fileformat={rec.value}"
                    dst.version = rec.value
        elif rec.pairs is not None and rec.key not in _DICT_KEYS + ("contig",):
            # other structured lines (ALT/META/PEDIGREE/...): need an ID
            if rid is None:
                continue
            if not any(d.pairs is not None and d.key == rec.key
                       and d.get("ID") == rid for d in dst.hrecs):
                dst.append_line(rec.raw)
        elif rec.pairs is not None:
            # FILTER/INFO/FORMAT/contig
            match = next((d for d in dst.hrecs
                          if d.key == rec.key and d.get("ID") == rid), None)
            if match is None:
                dst.append_line(rec.raw)
            elif rec.key in ("INFO", "FORMAT"):
                hl = BCF_HL_INFO if rec.key == "INFO" else BCF_HL_FMT
                si = src.id_info[src.id2int(rid)]
                di = dst.id_info[dst.id2int(rid)]
                if si.number[hl] != di.number[hl]:
                    log_warning('Trying to combine "%s" tag definitions of '
                                'different lengths', rid)
                if si.type[hl] != di.type[hl]:
                    log_warning('Trying to combine "%s" tag definitions of '
                                'different types', rid)
    return dst


class _Translation:
    """Cached src->dst dictionary index maps (src_hdr->transl)."""

    def __init__(self, dst: BcfHeader, src: BcfHeader):
        self.id_map = [dst._id_lookup.get(name, -1) if name else -1
                       for name in src.id_names]
        self.ctg_map = [dst._ctg_lookup.get(name, -1) if name else -1
                        for name in src.ctg_names]
        self.identity = (all(m == i or m == -1
                             for i, m in enumerate(self.id_map))
                         and all(m == i or m == -1
                                 for i, m in enumerate(self.ctg_map)))


_transl_cache: Dict[Tuple[int, int], _Translation] = {}


def bcf_translate(dst_hdr: BcfHeader, src_hdr: BcfHeader,
                  rec: BcfRecord) -> int:
    """Remap `rec`'s dictionary ids from src_hdr's to dst_hdr's
    dictionaries (vcf.c:5020).  Ids absent from dst are left unchanged
    (as in the reference, which skips dst_id < 0)."""
    key = (id(dst_hdr), id(src_hdr))
    tr = _transl_cache.get(key)
    if tr is None:
        tr = _Translation(dst_hdr, src_hdr)
        if len(_transl_cache) > 64:
            _transl_cache.clear()
        _transl_cache[key] = tr
    if tr.identity:
        return 0
    if 0 <= rec.rid < len(tr.ctg_map) and tr.ctg_map[rec.rid] >= 0:
        rec.rid = tr.ctg_map[rec.rid]
    rec.filters = [tr.id_map[f] if 0 <= f < len(tr.id_map)
                   and tr.id_map[f] >= 0 else f for f in rec.filters]
    for e in rec.info:
        if 0 <= e.key < len(tr.id_map) and tr.id_map[e.key] >= 0:
            e.key = tr.id_map[e.key]
    for e in rec.fmt:
        if 0 <= e.key < len(tr.id_map) and tr.id_map[e.key] >= 0:
            e.key = tr.id_map[e.key]
    rec.mark_dirty()
    return 0
