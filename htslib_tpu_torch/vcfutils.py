"""VCF utility functions, the port's copy of htslib_tpu/vcfutils.py
(reference vcfutils.c:1-1485, htslib/vcfutils.h):
allele counting (bcf_calc_ac), genotype classification (bcf_gt_type),
allele trimming/subsetting (bcf_trim_alleles / bcf_remove_allele_set with
Number=A/R/G and VCFv4.5 local-allele LA/LG/LR handling), and genotype
index helpers."""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from htslib_tpu_torch.vcf.header import (BCF_HL_INFO, BCF_HL_FMT, BCF_HT_FLAG,
                                   BCF_HT_INT, BCF_HT_REAL, BCF_HT_STR,
                                   BCF_VL_A, BCF_VL_G, BCF_VL_R, BCF_VL_LA,
                                   BCF_VL_LG, BCF_VL_LR, BcfHeader)
from htslib_tpu_torch.vcf.record import (FLOAT_MISSING, FLOAT_VECTOR_END,
                                   INT32_MISSING, INT32_VECTOR_END,
                                   BcfRecord)

# bcf_unpack "which" selectors (htslib/vcf.h BCF_UN_*); our records are
# always fully decoded so these only select calc_ac's data source
BCF_UN_INFO = 4
BCF_UN_FMT = 8

# genotype classes (htslib/vcfutils.h:112-118)
GT_HOM_RR = 0
GT_HOM_AA = 1
GT_HET_RA = 2
GT_HET_AA = 3
GT_HAPL_R = 4
GT_HAPL_A = 5
GT_UNKN = 6


def gt2alleles(gt_idx: int) -> Tuple[int, int]:
    """bcf_gt2alleles (htslib/vcfutils.h:118): diploid genotype index ->
    (allele j, allele k) with j <= k."""
    k = 0
    dk = 1
    while gt_idx >= dk:
        gt_idx -= dk
        dk += 1
        k += 1
    return gt_idx, k


def alleles2gt(j: int, k: int) -> int:
    """bcf_alleles2gt: (j, k) -> genotype index."""
    if j > k:
        j, k = k, j
    return k * (k + 1) // 2 + j


def ij2G(i: int, j: int) -> int:
    return alleles2gt(i, j)


def acgt2int(c: str) -> int:
    """bcf_acgt2int (htslib/vcfutils.h:121)."""
    c = c.upper()
    return {"A": 0, "C": 1, "G": 2, "T": 3}.get(c, 4)


def int2acgt(i: int) -> str:
    return "ACGTN"[i] if 0 <= i <= 4 else "N"


# ---------------------------------------------------------------------------
# bcf_calc_ac (vcfutils.c:32)
# ---------------------------------------------------------------------------

def calc_ac(header: BcfHeader, rec: BcfRecord,
            which: int = BCF_UN_FMT) -> Optional[List[int]]:
    """bcf_calc_ac (vcfutils.c:32): per-allele counts [REF, ALT1, ...].

    With BCF_UN_INFO set, INFO/AN+AC are used when both are present;
    with BCF_UN_FMT set, genotypes are split.  Returns None when the
    counts cannot be determined (the reference's 0 return)."""
    n_allele = rec.n_allele
    ac = [0] * n_allele

    if which & BCF_UN_INFO:
        an_e = rec.get_info(header, "AN")
        ac_e = rec.get_info(header, "AC")
        if an_e is not None and ac_e is not None \
                and an_e.value is not None and ac_e.value is not None:
            an = int(np.asarray(an_e.value).reshape(-1)[0])
            acv = np.asarray(ac_e.value).reshape(-1)
            if len(acv) != n_allele - 1:
                from htslib_tpu_torch.util.log import warning
                warning("Incorrect number of AC fields at %s:%d" %
                        (header.ctg_names[rec.rid], rec.pos + 1))
                return None
            nac = 0
            for i, v in enumerate(acv):
                ac[i + 1] = int(v)
                nac += int(v)
            if an < nac:
                raise ValueError("Incorrect AN/AC counts at %s:%d" %
                                 (header.ctg_names[rec.rid], rec.pos + 1))
            ac[0] = an - nac
            return ac

    if which & BCF_UN_FMT:
        gt = rec.get_fmt(header, "GT")
        if gt is None:
            return None
        vals = np.asarray(gt.value)
        for row in vals.reshape(rec.n_sample, -1):
            for v in row:
                v = int(v)
                if v == INT32_VECTOR_END:
                    break                 # smaller ploidy
                if v == INT32_MISSING or (v >> 1) == 0:
                    continue              # missing allele
                al = (v >> 1) - 1
                if al >= n_allele:
                    raise ValueError(
                        "Incorrect allele %d at %s:%d" %
                        (al, header.ctg_names[rec.rid], rec.pos + 1))
                ac[al] += 1
        return ac

    return None


# ---------------------------------------------------------------------------
# bcf_gt_type (vcfutils.c:134)
# ---------------------------------------------------------------------------

def gt_type(fmt_gt, isample: int) -> Tuple[int, int, int]:
    """bcf_gt_type (vcfutils.c:134): classify sample `isample`'s
    genotype.  Returns (GT_*, ial, jal) where ial/jal are 0-based
    indexes of the first/second non-reference allele (reference's *_ial
    convention: ial-1 when set, else 0)."""
    row = np.asarray(fmt_gt.value).reshape(-1) if np.asarray(
        fmt_gt.value).ndim == 1 else np.asarray(fmt_gt.value)[isample]
    nals = has_ref = has_alt = 0
    ial = jal = 0
    for v in row:
        v = int(v)
        if v == INT32_VECTOR_END:
            break                         # smaller ploidy
        if v == INT32_MISSING or (v >> 1) == 0:
            return GT_UNKN, 0, 0          # missing allele
        tmp = v >> 1
        if tmp > 1:
            if not ial:
                ial = tmp
                has_alt = 1
            elif tmp != ial:
                if tmp < ial:
                    jal = ial
                    ial = tmp
                else:
                    jal = tmp
                has_alt = 2
        else:
            has_ref = 1
        nals += 1
    ial_out = ial - 1 if ial > 0 else ial
    jal_out = jal - 1 if jal > 0 else jal
    if not nals:
        return GT_UNKN, ial_out, jal_out
    if nals == 1:
        return (GT_HAPL_R if has_ref else GT_HAPL_A), ial_out, jal_out
    if not has_ref:
        return (GT_HOM_AA if has_alt == 1 else GT_HET_AA), ial_out, jal_out
    if not has_alt:
        return GT_HOM_RR, ial_out, jal_out
    return GT_HET_RA, ial_out, jal_out


# ---------------------------------------------------------------------------
# bcf_trim_alleles (vcfutils.c:186)
# ---------------------------------------------------------------------------

def trim_alleles(header: BcfHeader, rec: BcfRecord) -> int:
    """bcf_trim_alleles (vcfutils.c:186): remove ALT alleles unused by any
    genotype; returns number removed."""
    gt = rec.get_fmt(header, "GT")
    n_allele = rec.n_allele
    if n_allele <= 1:
        return 0
    used = np.zeros(n_allele, bool)
    used[0] = True
    if gt is not None:
        vals = np.asarray(gt.value).reshape(-1)
        for v in vals:
            v = int(v)
            if v in (INT32_MISSING, INT32_VECTOR_END) or v >> 1 == 0:
                continue
            al = (v >> 1) - 1
            if 0 <= al < n_allele:
                used[al] = True
    else:
        used[:] = True
    n_rm = int((~used).sum())
    if n_rm == 0:
        return 0
    remove_alleles(header, rec, ~used)
    return n_rm


# ---------------------------------------------------------------------------
# bcf_remove_allele_set (vcfutils.c:659)
# ---------------------------------------------------------------------------

def _numeric_end(arr: np.ndarray, is_float: bool) -> int:
    """Index of the first vector-end sentinel (array length if none)."""
    end = FLOAT_VECTOR_END if is_float else INT32_VECTOR_END
    if is_float:
        hits = np.nonzero(np.asarray(arr, np.uint32) == end)[0]
    else:
        hits = np.nonzero(np.asarray(arr) == end)[0]
    return int(hits[0]) if hits.size else len(arr)


def _subset_str_csv(raw: bytes, sel_keep) -> Optional[bytes]:
    """Subset a comma-separated string vector; sel_keep(j)->bool.
    Returns None when the value is a lone '.' (missing)."""
    parts = raw.split(b",")
    if len(parts) == 1 and parts[0][:1] == b".":
        return None
    return b",".join(p for j, p in enumerate(parts) if sel_keep(j))


def remove_alleles(header: BcfHeader, rec: BcfRecord,
                   rm_mask: np.ndarray) -> None:
    """bcf_remove_allele_set (vcfutils.c:659): drop flagged ALT alleles,
    remapping GT and subsetting Number=A/R/G INFO and FORMAT vectors
    (diploid G as the lower-triangle pair subset, per-sample haploid G
    as an R subset) plus VCFv4.5 local-allele LAA/LA/LG/LR fields."""
    n_allele = rec.n_allele
    keep = ~np.asarray(rm_mask, bool)
    keep[0] = True
    amap = -np.ones(n_allele, np.int32)
    j = 0
    for i in range(n_allele):
        if keep[i]:
            amap[i] = j
            j += 1
    nrm = int((~keep).sum())
    if nrm == 0:
        return

    nR_ori = n_allele
    nR_new = n_allele - nrm
    nA_ori, nA_new = nR_ori - 1, nR_new - 1
    nG_ori = nR_ori * (nR_ori + 1) // 2

    # lower-triangle pair list in VCF Number=G order (vcfutils.c:801:
    # outer j over alleles, inner k<=j)
    g_pairs = [(jj, kk) for jj in range(nR_ori) for kk in range(jj + 1)]
    selA = np.nonzero(keep[1:])[0]            # indexes into A vectors
    selR = np.nonzero(keep)[0]                # indexes into R vectors
    selG = np.array([l for l, (jj, kk) in enumerate(g_pairs)
                     if keep[jj] and keep[kk]], np.int64)

    rec.update_alleles(header,
                       [a for i, a in enumerate(rec.alleles) if keep[i]])

    # ---- INFO Number=A/R/G (vcfutils.c:729-949) -----------------------
    # removing every ALT empties Number=A vectors; bcf_update_info with
    # n=0 deletes the tag (vcf.c bcf_update_info n==0 path)
    if nA_new == 0:
        drop = {e.key for e in rec.info
                if header.coltype(BCF_HL_INFO, e.key)[1] == BCF_VL_A
                and e.type != BCF_HT_FLAG}
        rec.info = [e for e in rec.info if e.key not in drop]
    for e in rec.info:
        _, vl, _ = header.coltype(BCF_HL_INFO, e.key)
        if vl not in (BCF_VL_A, BCF_VL_R, BCF_VL_G) or e.type == BCF_HT_FLAG:
            continue
        v = e.value
        if isinstance(v, bytes):
            if vl == BCF_VL_A:
                out = _subset_str_csv(v, lambda j: keep[j + 1])
            elif vl == BCF_VL_R:
                out = _subset_str_csv(v, lambda j: keep[j])
            else:
                out = _subset_str_csv(
                    v, lambda l: keep[g_pairs[l][0]] and keep[g_pairs[l][1]])
            if out is not None:
                e.value = out
        elif v is not None and hasattr(v, "ndim"):
            arr = np.asarray(v).reshape(-1)
            is_float = e.type == BCF_HT_REAL
            end = _numeric_end(arr, is_float)
            if end == 1 and int(arr[0]) in (
                    FLOAT_MISSING if is_float else INT32_MISSING,):
                continue                      # single missing value
            sel = {BCF_VL_A: selA, BCF_VL_R: selR, BCF_VL_G: selG}[vl]
            e.value = arr[sel[sel < end]]
    rec.mark_dirty()

    # ---- GT remap (vcfutils.c:952-996) --------------------------------
    gt = rec.get_fmt(header, "GT")
    if gt is not None:
        flat = np.asarray(gt.value).reshape(-1)
        for idx in range(flat.size):
            v = int(flat[idx])
            if v in (INT32_MISSING, INT32_VECTOR_END) or (v >> 1) == 0:
                continue
            al = (v >> 1) - 1
            na = int(amap[al]) if 0 <= al < nR_ori else -1
            # removed alleles become missing, preserving phase
            flat[idx] = ((na + 1) << 1 | (v & 1)) if na >= 0 else (v & 1)

    # ---- LAA remap (vcfutils.c:998-1077) ------------------------------
    laa = rec.get_fmt(header, "LAA")
    laa_maps: Optional[List[np.ndarray]] = None
    lr_orig: Optional[List[int]] = None
    if laa is not None and not isinstance(laa.value, bytes) \
            and np.asarray(laa.value).ndim == 2:
        vals = np.asarray(laa.value)
        nvals = vals.shape[1]
        laa_maps, lr_orig = [], []
        max_k = 0
        changed = False
        new_vals = vals.copy()
        for s in range(vals.shape[0]):
            row = vals[s]
            smap = np.full(nvals + 1, -1, np.int32)
            smap[0] = 0
            k = 0
            jj = 0
            for jj in range(nvals):
                a = int(row[jj])
                if a in (INT32_VECTOR_END, INT32_MISSING):
                    break
                allele = a if 0 < a < nR_ori else 0
                if not allele or amap[allele] < 0:
                    changed = True
                    continue
                if allele != amap[allele]:
                    changed = True
                new_vals[s, k] = amap[allele]
                k += 1
                smap[jj + 1] = k
            else:
                jj = nvals
            lr_orig.append(jj + 1 if jj < nvals else nvals + 1)
            max_k = max(max_k, k)
            for kk in range(k, nvals):
                new_vals[s, kk] = (INT32_VECTOR_END if kk > 0
                                   else INT32_MISSING)
            laa_maps.append(smap)
        if changed:
            if max_k == 0:
                new_vals = np.full((vals.shape[0], 1), INT32_MISSING,
                                   vals.dtype)
            elif max_k < nvals:
                new_vals = new_vals[:, :max_k]
            laa.value = new_vals

    # ---- FORMAT Number=A/R/G/LA/LG/LR (vcfutils.c:1079-1430) ----------
    local_vls = (BCF_VL_LA, BCF_VL_LG, BCF_VL_LR)
    if nA_new == 0:
        # numeric Number=A FORMAT fields become 0-wide; bcf_update_format
        # with n=0 deletes the tag (string fields keep a per-sample '.')
        drop = {e.key for e in rec.fmt
                if not e.is_gt
                and header.coltype(BCF_HL_FMT, e.key)[1] == BCF_VL_A
                and e.type in (BCF_HT_INT, BCF_HT_REAL)}
        rec.fmt = [e for e in rec.fmt if e.key not in drop]
    for e in rec.fmt:
        if e.is_gt:
            continue
        _, vl, _ = header.coltype(BCF_HL_FMT, e.key)
        if vl not in (BCF_VL_A, BCF_VL_R, BCF_VL_G) + local_vls:
            continue
        if e.type == BCF_HT_FLAG or e.value is None:
            continue
        is_local = vl in local_vls
        if is_local and laa_maps is None:
            raise ValueError("No LAA data; required by a FORMAT field "
                             "with a local-allele Number code")
        if e.type == BCF_HT_STR:
            _subset_fmt_str(e, vl, keep, g_pairs, nR_ori,
                            laa_maps, lr_orig)
        else:
            _subset_fmt_numeric(e, vl, keep, amap, g_pairs,
                                nR_ori, nR_new, laa_maps, lr_orig)
    rec.mark_dirty()


def _subset_fmt_numeric(e, vl, keep, amap, g_pairs, nR_ori, nR_new,
                        laa_maps, lr_orig) -> None:
    """Per-sample numeric FORMAT subsetting (vcfutils.c:1269-1430)."""
    vals = np.asarray(e.value)
    n_sample, nori = vals.shape
    is_float = e.type == BCF_HT_REAL
    v_end = FLOAT_VECTOR_END if is_float else INT32_VECTOR_END
    v_missing = FLOAT_MISSING if is_float else INT32_MISSING
    is_local = vl in (BCF_VL_LA, BCF_VL_LG, BCF_VL_LR)

    nA_ori = nR_ori - 1
    nG_ori = nR_ori * (nR_ori + 1) // 2
    g_diploid = (vl in (BCF_VL_G, BCF_VL_LG)) and nori != nR_ori

    if is_local and not g_diploid:
        # local allele lists keep their per-sample width (already
        # remapped through LAA); nothing global shrinks
        nnew = nori
    elif vl == BCF_VL_A:
        if nori != nA_ori:
            return                          # unexpected width; leave as-is
        nnew = nR_new - 1
    elif not g_diploid:                     # R or haploid G
        if vl == BCF_VL_R and nori != nR_ori:
            return
        nnew = nR_new
    else:                                   # diploid G
        if not is_local and nori != nG_ori:
            return
        nnew = (nR_new * (nR_new + 1) // 2) if not is_local else nori

    out = np.full((n_sample, max(nnew, 1)), v_end,
                  np.uint32 if is_float else vals.dtype)
    for s in range(n_sample):
        row = vals[s]
        if is_local:
            smap = laa_maps[s]
            s_nR = min(lr_orig[s], nR_ori)
            def kept(a):
                return smap[a + 1] >= 0 if a + 1 < len(smap) else False
        else:
            s_nR = nR_ori
            def kept(a):
                return bool(keep[a])
        k_dst = 0
        if g_diploid:
            l_ori = 0
            done = False
            for jj in range(s_nR):
                for kk in range(jj + 1):
                    if l_ori >= nori or int(row[l_ori]) == v_end:
                        done = True
                        break
                    ok = (kept(jj) and kept(kk)) if not is_local else (
                        smap[jj + 1] >= 0 and smap[kk + 1] >= 0
                        if jj + 1 < len(smap) and kk + 1 < len(smap)
                        else False)
                    if ok:
                        out[s, k_dst] = row[l_ori]
                        k_dst += 1
                    l_ori += 1
                if done:
                    break
        else:
            inc = 1 if vl in (BCF_VL_A, BCF_VL_LA) else 0
            top = min(nori, s_nR - inc if is_local else nori)
            for k_src in range(top):
                if int(row[k_src]) == v_end:
                    break
                a = k_src + inc
                ok = (smap[a] >= 0 if is_local and a < len(smap)
                      else (not is_local and kept(a)))
                if not ok:
                    continue
                out[s, k_dst] = row[k_src]
                k_dst += 1
        if k_dst == 0:
            out[s, 0] = v_missing
    e.value = out


def _subset_fmt_str(e, vl, keep, g_pairs, nR_ori, laa_maps, lr_orig) -> None:
    """Per-sample string FORMAT subsetting (vcfutils.c:1106-1260):
    values are a [n_sample, size] char matrix of comma-separated
    entries, '.' for missing, NUL padded."""
    vals = np.asarray(e.value)
    n_sample, size = vals.shape
    is_local = vl in (BCF_VL_LA, BCF_VL_LG, BCF_VL_LR)
    rows_out: List[bytes] = []
    nG_ori = nR_ori * (nR_ori + 1) // 2
    for s in range(n_sample):
        raw = bytes(vals[s]).rstrip(b"\x00")
        parts = raw.split(b",") if raw else [b""]
        if len(parts) == 1 and parts[0][:1] == b".":
            rows_out.append(b".")
            continue
        if is_local:
            smap = laa_maps[s]
            s_nR = min(lr_orig[s], nR_ori)
            def kept(a):
                return smap[a + 1] >= 0 if a + 1 < len(smap) else False
        else:
            s_nR = nR_ori
            def kept(a):
                return bool(keep[a])
        if vl in (BCF_VL_G, BCF_VL_LG):
            s_nG = s_nR * (s_nR + 1) // 2
            if len(parts) == s_nG:          # diploid
                pairs = [(jj, kk) for jj in range(s_nR)
                         for kk in range(jj + 1)]
                sel = [p for l, p in enumerate(parts)
                       if kept(pairs[l][0]) and kept(pairs[l][1])]
            else:                           # haploid: R-style
                sel = [p for j, p in enumerate(parts)
                       if j < s_nR and kept(j)]
        else:
            inc = 1 if vl in (BCF_VL_A, BCF_VL_LA) else 0
            sel = [p for j, p in enumerate(parts) if kept(j + inc)]
        rows_out.append(b",".join(sel) if sel else b".")
    width = max(len(r) for r in rows_out)
    out = np.zeros((n_sample, width), np.uint8)
    for s, r in enumerate(rows_out):
        out[s, :len(r)] = np.frombuffer(r, np.uint8)
    e.value = out
