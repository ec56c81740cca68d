"""Columnar BAM record batches and the file-level BAM <-> SAM entry points
(the port's copy of htslib_tpu/sam/batch.py; reference sam.c:784
bam_read1, sam.c:4324 sam_format1, sam.c:3215 the SAM parse workers).

A byte range of records becomes a structure of arrays (`BamColumns`):
the fixed 32-byte cores as int32 columns and the variable segments
(qname, cigar, seq, qual, aux) as ragged views into the flat stream.
`format_sam_batch` writes SAM text from it with numpy alone: field
lengths, exclusive prefix sums, one output buffer filled by ragged
scatters (vectorised int -> ascii in place of kputw, nibble -> base in
place of simd.c:121).  Records that do not vectorise (a CG long-CIGAR
escape, float aux values formatted by %g) go through the record API on
a mask.  This is the JAX package's pure path: the host truth that the
device chain is held to.  `bam_to_sam_bytes` gives a batch to the native
formatter first (`native.bam_to_sam`, falling back here on an IOError),
as the JAX function does.

`bam_file_to_sam(path, device)` is `samtools view x.bam`: the file's
compressed bytes read once through hfile.py `hopen` (a path, a URL, an
htsget ticket), the header parsed on the host, the members past it
inflated on the device in one call (bgzf.py `inflate_range`, kernel X4
on the card) and the records formatted on the device
(ops/bam2sam.py `bam_payload_to_sam_device`: X5 and B1, the aux tails on
the host).  `bam_stream_to_sam` runs the same format on an inflated
stream.  `sam_text_to_bam` parses SAM lines on the host, by the native
parser (`native.sam_to_bam`) or, where that refuses the text or the
library is off, a line at a time (`BamRecord.from_sam`);
`sam_to_bam_file` runs it over chunks on pipeline.py's host threads, the
members deflated by bgzf.py `deflate_blocks` (libdeflate, or zlib with
the library off).
"""
from __future__ import annotations

import io
import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from htslib_tpu_torch import _build
from htslib_tpu_torch.bgzf import (BGZF_BLOCK_SIZE, BGZF_EOF, BgzfReader,
                                   BlockTable, deflate_blocks, inflate_host,
                                   inflate_range, read_file, scan_blocks)
from htslib_tpu_torch.ops.bam2sam import bam_payload_to_sam_device
from htslib_tpu_torch.sam.bam import read_bam_header, write_bam_header
from htslib_tpu_torch.sam.header import SamHeader
from htslib_tpu_torch.sam.record import (SEQ_NT16_STR, BamRecord,
                                         format_aux_blob)

_NT16_BYTES = np.frombuffer(SEQ_NT16_STR.encode(), np.uint8)
_CIGAR_CHARS = np.frombuffer(b"MIDNSHP=XB??????", np.uint8)


# ---------------------------------------------------------------------------
# ragged helpers
# ---------------------------------------------------------------------------

def _excl_cumsum(x: np.ndarray, dtype=np.int64) -> np.ndarray:
    out = np.zeros(len(x), dtype)
    np.cumsum(x[:-1], dtype=dtype, out=out[1:])
    return out


def ragged_indices(lens: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """For segment lengths lens, return (seg_id, intra_offset) for every
    element of the flattened ragged array."""
    lens = lens.astype(np.int64)
    total = int(lens.sum())
    seg_id = np.repeat(np.arange(len(lens), dtype=np.int64), lens)
    starts = _excl_cumsum(lens)
    intra = np.arange(total, dtype=np.int64) - np.repeat(starts, lens)
    return seg_id, intra


def ragged_gather(data: np.ndarray, offs: np.ndarray, lens: np.ndarray,
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Gather variable-length ranges [offs[i], offs[i]+lens[i]) of data into
    one flat array; returns (flat, seg_id, intra)."""
    seg_id, intra = ragged_indices(lens)
    src = offs.astype(np.int64)[seg_id] + intra
    return data[src], seg_id, intra


def ragged_scatter(out: np.ndarray, dst_offs: np.ndarray, lens: np.ndarray,
                   values: np.ndarray) -> None:
    """Scatter flat values into out at per-segment destinations."""
    seg_id, intra = ragged_indices(lens)
    out[dst_offs.astype(np.int64)[seg_id] + intra] = values


# ---------------------------------------------------------------------------
# vectorised int -> decimal ascii
# ---------------------------------------------------------------------------

_POW10 = 10 ** np.arange(19, dtype=np.int64)


def dec_len(x: np.ndarray) -> np.ndarray:
    """Formatted length of each signed integer (digits + optional '-')."""
    x = x.astype(np.int64)
    neg = x < 0
    ax = np.where(neg, -x, x)
    nd = np.ones(len(x), np.int64)
    for p in range(1, 19):
        nd += (ax >= _POW10[p])
    return nd + neg


def write_ints(out: np.ndarray, ends: np.ndarray, x: np.ndarray) -> None:
    """Write decimal ascii of x so the last digit lands at ends-1
    (a vectorised kputw/kputll, kstring.c:357/423: digits emitted
    right-to-left)."""
    x = x.astype(np.int64)
    neg = x < 0
    ax = np.where(neg, -x, x).astype(np.uint64)
    nd = dec_len(x) - neg  # digit count
    maxd = int(nd.max()) if len(nd) else 0
    pos = ends.astype(np.int64) - 1
    for k in range(maxd):
        live = k < nd
        digit = ((ax // np.uint64(10 ** k)) % np.uint64(10)).astype(np.uint8)
        idx = pos[live] - k
        out[idx] = digit[live] + 48
    sign_idx = pos[neg] - nd[neg]
    out[sign_idx] = ord("-")


# ---------------------------------------------------------------------------
# column batch
# ---------------------------------------------------------------------------

@dataclass
class BamColumns:
    """SoA view over a flat uncompressed BAM record stream."""
    data: np.ndarray       # uint8 flat stream (records back to back)
    offs: np.ndarray       # int64 [n] offset of each record's block_size field
    sizes: np.ndarray      # int64 [n] total record size incl. 4-byte length
    # core columns (int32 unless noted)
    tid: np.ndarray
    pos: np.ndarray
    mapq: np.ndarray
    bin: np.ndarray
    flag: np.ndarray
    mtid: np.ndarray
    mpos: np.ndarray
    tlen: np.ndarray
    l_qname: np.ndarray    # incl. trailing NUL
    n_cigar: np.ndarray
    l_qseq: np.ndarray
    # derived segment offsets (absolute into data)
    qname_off: np.ndarray
    cigar_off: np.ndarray
    seq_off: np.ndarray
    qual_off: np.ndarray
    aux_off: np.ndarray
    aux_len: np.ndarray

    @property
    def n(self) -> int:
        return len(self.offs)

    def record(self, i: int) -> BamRecord:
        """Materialise one record through the row-wise API (slow path)."""
        o, s = int(self.offs[i]), int(self.sizes[i])
        return BamRecord.from_bam_buffer(self.data, o + 4, s - 4)


def decode_bam_columns(data: np.ndarray, offs: np.ndarray,
                       sizes: np.ndarray) -> BamColumns:
    """Vectorised core unpack of every record (bam_read1 field extraction,
    sam.c:809-822, across the whole batch at once)."""
    offs = offs.astype(np.int64)
    sizes = sizes.astype(np.int64)
    base = offs + 4
    # gather the 32-byte cores as [n, 32]
    idx = base[:, None] + np.arange(32, dtype=np.int64)[None, :]
    cores = data[idx]
    i32 = cores.view(np.uint8).reshape(len(offs), 32)

    def u32(col):
        return (i32[:, col].astype(np.uint32)
                | (i32[:, col + 1].astype(np.uint32) << 8)
                | (i32[:, col + 2].astype(np.uint32) << 16)
                | (i32[:, col + 3].astype(np.uint32) << 24))

    def s32(col):
        return u32(col).astype(np.int32)

    tid = s32(0)
    pos = s32(4)
    l_qname = i32[:, 8].astype(np.int32)
    mapq = i32[:, 9].astype(np.int32)
    bin_ = (i32[:, 10].astype(np.int32) | (i32[:, 11].astype(np.int32) << 8))
    n_cigar = (i32[:, 12].astype(np.int32) | (i32[:, 13].astype(np.int32) << 8))
    flag = (i32[:, 14].astype(np.int32) | (i32[:, 15].astype(np.int32) << 8))
    l_qseq = s32(16)
    mtid = s32(20)
    mpos = s32(24)
    tlen = s32(28)

    qname_off = base + 32
    cigar_off = qname_off + l_qname
    seq_off = cigar_off + 4 * n_cigar.astype(np.int64)
    qual_off = seq_off + (l_qseq.astype(np.int64) + 1) // 2
    aux_off = qual_off + l_qseq
    rec_end = offs + sizes
    aux_len = rec_end - aux_off
    if np.any(aux_len < 0):
        raise IOError("corrupt BAM record (variable data overruns block)")
    return BamColumns(
        data=data, offs=offs, sizes=sizes, tid=tid, pos=pos, mapq=mapq,
        bin=bin_, flag=flag, mtid=mtid, mpos=mpos, tlen=tlen,
        l_qname=l_qname, n_cigar=n_cigar, l_qseq=l_qseq,
        qname_off=qname_off, cigar_off=cigar_off, seq_off=seq_off,
        qual_off=qual_off, aux_off=aux_off, aux_len=aux_len)


# ---------------------------------------------------------------------------
# vectorised SAM formatting
# ---------------------------------------------------------------------------

def _name_table(header: SamHeader) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Concatenated ref-name bytes + per-tid offset/length, with '*' as the
    entry for tid -1 (index nref)."""
    names = [n.encode() for n in header.ref_names] + [b"*"]
    flat = np.frombuffer(b"".join(names), np.uint8)
    lens = np.array([len(n) for n in names], np.int64)
    offs = _excl_cumsum(lens)
    return flat, offs, lens


def _cg_slow_mask(cols: BamColumns) -> np.ndarray:
    """Records that may carry a CG long-CIGAR escape (bam_tag2cigar trigger
    condition, sam.c:685): first cigar op == l_qseq<<4|SOFT_CLIP."""
    mask = (cols.n_cigar > 0) & (cols.tid >= 0) & (cols.pos >= 0)
    if not mask.any():
        return mask
    first = np.zeros(cols.n, np.uint32)
    m_idx = np.nonzero(mask)[0]
    co = cols.cigar_off[m_idx]
    b0 = cols.data[co].astype(np.uint32)
    b1 = cols.data[co + 1].astype(np.uint32)
    b2 = cols.data[co + 2].astype(np.uint32)
    b3 = cols.data[co + 3].astype(np.uint32)
    first[m_idx] = b0 | (b1 << 8) | (b2 << 16) | (b3 << 24)
    want = (cols.l_qseq.astype(np.uint32) << 4) | 4  # BAM_CSOFT_CLIP
    out = mask.copy()
    out[m_idx] = first[m_idx] == want[m_idx]
    return out & mask


def format_sam_batch(cols: BamColumns, header: SamHeader) -> bytes:
    """Format a whole batch as SAM text, byte-exact vs the record path."""
    n = cols.n
    if n == 0:
        return b""
    data = cols.data

    # --- per-record CG/slow-path detection ---------------------------------
    slow = _cg_slow_mask(cols)

    # --- aux text (vectorised tokenizer + formatter) -----------------------
    aux_text, aux_lens = _format_aux_batch(cols, slow)

    # --- field lengths -----------------------------------------------------
    nflat, noffs, nlens = _name_table(header)
    tid_i = np.where(cols.tid < 0, header.nref, cols.tid).astype(np.int64)
    rname_len = nlens[tid_i]
    # rnext: '=' if mtid==tid>=0 else name/'*'
    mtid_i = np.where(cols.mtid < 0, header.nref, cols.mtid).astype(np.int64)
    same = (cols.mtid >= 0) & (cols.mtid == cols.tid)
    rnext_len = np.where(same, 1, nlens[mtid_i])

    qname_len = cols.l_qname.astype(np.int64) - 1
    flag_len = dec_len(cols.flag)
    pos_len = dec_len(cols.pos + 1)
    mapq_len = dec_len(cols.mapq)
    mpos_len = dec_len(cols.mpos + 1)
    tlen_len = dec_len(cols.tlen)

    # cigar text length: per-op digits+1; '*' when n_cigar==0
    cig_flat, cig_rec, _ = ragged_gather(
        data.view(np.uint8), cols.cigar_off, 4 * cols.n_cigar.astype(np.int64))
    cig_u32 = cig_flat.reshape(-1, 4).copy().view("<u4").reshape(-1).astype(np.uint32)
    op_len = (cig_u32 >> 4).astype(np.int64)
    op_code = (cig_u32 & 0xF).astype(np.int64)
    op_rec = cig_rec[::4]
    op_text_len = dec_len(op_len) + 1
    cigar_len = np.zeros(n, np.int64)
    np.add.at(cigar_len, op_rec, op_text_len)
    cigar_len = np.where(cols.n_cigar == 0, 1, cigar_len)

    seq_len = np.where(cols.l_qseq == 0, 1, cols.l_qseq).astype(np.int64)
    # qual '*' when l_qseq==0 or first qual byte 0xff (sam.c:4370)
    has_seq = cols.l_qseq > 0
    q0 = np.zeros(n, np.uint8)
    q0[has_seq] = data[cols.qual_off[has_seq]]
    qual_star = (~has_seq) | (q0 == 0xFF)
    qual_len = np.where(qual_star, 1, cols.l_qseq).astype(np.int64)

    aux_field_len = aux_lens  # includes leading tab per record if nonzero

    line_len = (qname_len + flag_len + rname_len + pos_len + mapq_len
                + cigar_len + rnext_len + mpos_len + tlen_len + seq_len
                + qual_len + 10  # 10 tabs
                + aux_field_len + 1)  # trailing newline
    starts = _excl_cumsum(line_len)
    total = int(line_len.sum())
    out = np.empty(total, np.uint8)

    # --- write fields ------------------------------------------------------
    p = starts.copy()

    def put_tab():
        nonlocal p
        out[p] = 9
        p = p + 1

    # qname
    ragged_scatter(out, p, qname_len,
                   ragged_gather(data, cols.qname_off, qname_len)[0])
    p = p + qname_len
    put_tab()
    write_ints(out, p + flag_len, cols.flag)
    p = p + flag_len
    put_tab()
    ragged_scatter(out, p, rname_len,
                   ragged_gather(nflat, noffs[tid_i], rname_len)[0])
    p = p + rname_len
    put_tab()
    write_ints(out, p + pos_len, cols.pos.astype(np.int64) + 1)
    p = p + pos_len
    put_tab()
    write_ints(out, p + mapq_len, cols.mapq)
    p = p + mapq_len
    put_tab()
    # cigar
    star_idx = np.nonzero(cols.n_cigar == 0)[0]
    out[p[star_idx]] = ord("*")
    if len(op_len):
        # end position of each op's text within the line
        op_end_in_rec = np.zeros(len(op_len), np.int64)
        # cumulative sum of op_text_len within each record
        cum = np.cumsum(op_text_len)
        rec_base = _excl_cumsum(np.bincount(op_rec, weights=None, minlength=n).astype(np.int64))
        # within-record cumulative: cum - cum_before_record_start
        first_op_idx = rec_base  # index of first op of each record in op arrays
        cum_before = np.zeros(len(op_len), np.int64)
        nz = np.nonzero(np.bincount(op_rec, minlength=n))[0]
        start_cum = np.concatenate([[0], cum])[first_op_idx]
        cum_before = np.repeat(start_cum[nz], np.bincount(op_rec, minlength=n)[nz])
        within_end = cum - cum_before
        op_ends = p[op_rec] + within_end
        out[op_ends - 1] = _CIGAR_CHARS[op_code]
        write_ints(out, op_ends - 1, op_len)
    p = p + cigar_len
    put_tab()
    # rnext: '=' / name / '*'
    same_idx = np.nonzero(same)[0]
    out[p[same_idx]] = ord("=")
    other = ~same
    if other.any():
        o_idx = np.nonzero(other)[0]
        ragged_scatter(out, p[o_idx], rnext_len[o_idx],
                       ragged_gather(nflat, noffs[mtid_i[o_idx]], rnext_len[o_idx])[0])
    p = p + rnext_len
    put_tab()
    write_ints(out, p + mpos_len, cols.mpos.astype(np.int64) + 1)
    p = p + mpos_len
    put_tab()
    write_ints(out, p + tlen_len, cols.tlen)
    p = p + tlen_len
    put_tab()
    # seq
    noseq_idx = np.nonzero(cols.l_qseq == 0)[0]
    out[p[noseq_idx]] = ord("*")
    if has_seq.any():
        lq = cols.l_qseq.astype(np.int64)
        seg, intra = ragged_indices(lq)
        byte_idx = cols.seq_off[seg] + (intra >> 1)
        packed = data[byte_idx]
        nib = np.where(intra & 1, packed & 0xF, packed >> 4).astype(np.uint8)
        ragged_scatter(out, p, lq, _NT16_BYTES[nib])
    p = p + seq_len
    put_tab()
    # qual
    qs_idx = np.nonzero(qual_star)[0]
    out[p[qs_idx]] = ord("*")
    qn = ~qual_star
    if qn.any():
        qi = np.nonzero(qn)[0]
        lq = cols.l_qseq[qi].astype(np.int64)
        ragged_scatter(out, p[qi], lq,
                       ragged_gather(data, cols.qual_off[qi], lq)[0] + 33)
    p = p + qual_len
    # aux (pre-rendered, includes leading tab)
    if aux_text is not None:
        ragged_scatter(out, p, aux_field_len, aux_text)
    p = p + aux_field_len
    out[p] = 10  # newline
    # Patch slow-path records (CG escapes) through the record API
    if slow.any():
        out = _patch_slow_records(out, starts, line_len, cols, header, slow)
        return out
    return out.tobytes()


def _patch_slow_records(out: np.ndarray, starts: np.ndarray,
                        line_len: np.ndarray, cols: BamColumns,
                        header: SamHeader, slow: np.ndarray) -> bytes:
    pieces: List[bytes] = []
    prev = 0
    for i in np.nonzero(slow)[0]:
        s, e = int(starts[i]), int(starts[i] + line_len[i])
        pieces.append(out[prev:s].tobytes())
        pieces.append(cols.record(i).to_sam(header).encode() + b"\n")
        prev = e
    pieces.append(out[prev:].tobytes())
    return b"".join(pieces)


# ---------------------------------------------------------------------------
# vectorised aux formatting
# ---------------------------------------------------------------------------

_TYPE_SIZE = np.zeros(256, np.int64)
for _t, _s in [("A", 1), ("c", 1), ("C", 1), ("s", 2), ("S", 2), ("i", 4),
               ("I", 4), ("f", 4), ("d", 8)]:
    _TYPE_SIZE[ord(_t)] = _s
_SUB_SIZE = _TYPE_SIZE.copy()


def _format_aux_batch(cols: BamColumns, slow: np.ndarray,
                      ) -> Tuple[Optional[np.ndarray], np.ndarray]:
    """Render each record's aux blob to SAM text (leading tab included).

    Vectorised frontier tokenizer: all records advance through their aux
    entries in lock-step; per-type value formatting is vectorised.  Float
    (%g) entries divert through the Python formatter per record (rare).
    Returns (flat text bytes or None, per-record text length).
    """
    n = cols.n
    aux_lens_total = cols.aux_len.astype(np.int64)
    out_lens = np.zeros(n, np.int64)
    if int(aux_lens_total.sum()) == 0:
        return None, out_lens
    data = cols.data

    # Records containing f/d/H or malformed entries fall back row-wise.
    # Tokenize with a frontier loop.
    ptr = cols.aux_off.astype(np.int64).copy()
    end = ptr + aux_lens_total
    live = ptr < end
    entries_rec: List[np.ndarray] = []
    entries_off: List[np.ndarray] = []
    entries_type: List[np.ndarray] = []
    fallback = slow.copy()

    # precompute NUL positions for Z/H strlen via searchsorted
    zero_pos = np.nonzero(data == 0)[0]

    while live.any():
        li = np.nonzero(live)[0]
        pp = ptr[li]
        ok = pp + 3 <= end[li]
        bad = li[~ok]
        fallback[bad] = True
        live[bad] = False
        li = li[ok]
        pp = pp[ok]
        if len(li) == 0:
            break
        t = data[pp + 2]
        vstart = pp + 3
        sz = _TYPE_SIZE[t]
        nxt = np.where(sz > 0, vstart + sz, np.int64(-1))
        # Z/H: find next NUL
        zh = (t == ord("Z")) | (t == ord("H"))
        if zh.any():
            zi = np.nonzero(zh)[0]
            pos_in_zeros = np.searchsorted(zero_pos, vstart[zi])
            have = pos_in_zeros < len(zero_pos)
            nulpos = np.where(have, zero_pos[np.minimum(pos_in_zeros, len(zero_pos) - 1)], -2)
            nxt[zi] = nulpos + 1
        isB = t == ord("B")
        if isB.any():
            bi = np.nonzero(isB)[0]
            sub = data[vstart[bi]]
            cnt = (data[vstart[bi] + 1].astype(np.int64)
                   | (data[vstart[bi] + 2].astype(np.int64) << 8)
                   | (data[vstart[bi] + 3].astype(np.int64) << 16)
                   | (data[vstart[bi] + 4].astype(np.int64) << 24))
            ssz = _SUB_SIZE[sub]
            good = ssz > 0
            nxt[bi] = np.where(good, vstart[bi] + 5 + ssz * cnt, np.int64(-1))
        invalid = (nxt < 0) | (nxt > end[li])
        fb = li[invalid]
        fallback[fb] = True
        live[fb] = False
        keep = ~invalid
        li, pp, t, nxt = li[keep], pp[keep], t[keep], nxt[keep]
        entries_rec.append(li)
        entries_off.append(pp)
        entries_type.append(t)
        ptr[li] = nxt
        done = nxt >= end[li]
        live[li[done]] = False

    if entries_rec:
        e_rec = np.concatenate(entries_rec)
        e_off = np.concatenate(entries_off)
        e_type = np.concatenate(entries_type)
        # drop entries of fallback records
        keep = ~fallback[e_rec]
        e_rec, e_off, e_type = e_rec[keep], e_off[keep], e_type[keep]
        # float/double/B entries push their record to the fallback path only
        # for f/d (and B:f); H is fine (hex text is stored verbatim).
        fd = (e_type == ord("f")) | (e_type == ord("d"))
        isB = e_type == ord("B")
        if isB.any():
            bsub = np.zeros(len(e_type), np.uint8)
            bsub[isB] = data[e_off[isB] + 3]
            fd |= isB & (bsub == ord("f"))
        if fd.any():
            fb_recs = np.unique(e_rec[fd])
            fallback[fb_recs] = True
            keep = ~fallback[e_rec]
            e_rec, e_off, e_type = e_rec[keep], e_off[keep], e_type[keep]
    else:
        e_rec = np.empty(0, np.int64)
        e_off = np.empty(0, np.int64)
        e_type = np.empty(0, np.uint8)

    # ---- compute text length of each entry -------------------------------
    # every entry: '\t' + 2 tag chars + ':' + typechar + ':' + value
    # (int types all collapse to 'i')
    vstart = e_off + 3
    val_len = np.zeros(len(e_rec), np.int64)
    int_vals = np.zeros(len(e_rec), np.int64)

    def load_int(idx: np.ndarray, off: np.ndarray, t: int) -> np.ndarray:
        if t in (ord("c"), ord("C")):
            v = data[off].astype(np.int64)
            if t == ord("c"):
                v = np.where(v > 127, v - 256, v)
            return v
        if t in (ord("s"), ord("S")):
            v = data[off].astype(np.int64) | (data[off + 1].astype(np.int64) << 8)
            if t == ord("s"):
                v = np.where(v > 32767, v - 65536, v)
            return v
        v = (data[off].astype(np.int64) | (data[off + 1].astype(np.int64) << 8)
             | (data[off + 2].astype(np.int64) << 16)
             | (data[off + 3].astype(np.int64) << 24))
        if t == ord("i"):
            v = np.where(v > 0x7FFFFFFF, v - (1 << 32), v)
        return v

    for t in (b"cCsSiI"):
        m = e_type == t
        if m.any():
            mi = np.nonzero(m)[0]
            v = load_int(mi, vstart[mi], t)
            int_vals[mi] = v
            val_len[mi] = dec_len(v)
    mA = e_type == ord("A")
    val_len[mA] = 1
    mZH = (e_type == ord("Z")) | (e_type == ord("H"))
    if mZH.any():
        zi = np.nonzero(mZH)[0]
        pos_in_zeros = np.searchsorted(zero_pos, vstart[zi])
        nulpos = zero_pos[pos_in_zeros]
        val_len[zi] = nulpos - vstart[zi]
    mB = e_type == ord("B")
    # B arrays: value text = subchar + (',' + int)*  (f handled via fallback)
    b_vals = None
    if mB.any():
        bi = np.nonzero(mB)[0]
        sub = data[vstart[bi]]
        cnt = (data[vstart[bi] + 1].astype(np.int64)
               | (data[vstart[bi] + 2].astype(np.int64) << 8)
               | (data[vstart[bi] + 3].astype(np.int64) << 16)
               | (data[vstart[bi] + 4].astype(np.int64) << 24))
        ssz = _SUB_SIZE[sub]
        # flatten all B elements
        el_seg, el_intra = ragged_indices(cnt)
        el_entry = bi[el_seg]
        el_off = vstart[el_entry] + 5 + el_intra * ssz[el_seg]
        el_sub = sub[el_seg]
        el_val = np.zeros(len(el_entry), np.int64)
        for t in (b"cCsSiI"):
            m = el_sub == t
            if m.any():
                mi = np.nonzero(m)[0]
                el_val[mi] = load_int(mi, el_off[mi], t)
        el_len = dec_len(el_val) + 1  # comma + digits
        per_entry = np.zeros(len(e_rec), np.int64)
        np.add.at(per_entry, el_entry, el_len)
        val_len[bi] = 1 + per_entry[bi]
        b_vals = (bi, el_entry, el_val, el_len, sub)

    entry_len = 6 + val_len  # '\t' + tag(2) + ':' + type + ':'
    ok_mask = ~fallback[e_rec]
    # all current entries belong to non-fallback records already
    np.add.at(out_lens, e_rec, entry_len)

    # fallback records: render via python
    fb_texts = {}
    for i in np.nonzero(fallback)[0]:
        blob = data[cols.aux_off[i]:cols.aux_off[i] + cols.aux_len[i]].tobytes()
        txt = format_aux_blob(blob)
        fb_texts[i] = ("\t" + txt).encode() if txt else b""
        out_lens[i] = len(fb_texts[i])

    total = int(out_lens.sum())
    if total == 0:
        return None, out_lens
    flat = np.empty(total, np.uint8)
    rec_starts = _excl_cumsum(out_lens)

    # entry end positions within each record's aux text
    if len(e_rec):
        order = np.argsort(e_rec, kind="stable")
        e_rec_s = e_rec[order]
        entry_len_s = entry_len[order]
        cum = np.cumsum(entry_len_s)
        counts = np.bincount(e_rec_s, minlength=n).astype(np.int64)
        first_idx = _excl_cumsum(counts)
        nzrec = np.nonzero(counts)[0]
        start_cum = np.concatenate([[0], cum])[first_idx]
        cum_before = np.repeat(start_cum[nzrec], counts[nzrec])
        within_end = cum - cum_before
        ends = rec_starts[e_rec_s] + within_end          # end of each entry
        starts_e = ends - entry_len_s
        # header: \t T G : t :
        tagpos = starts_e
        flat[tagpos] = 9
        flat[tagpos + 1] = data[e_off[order]]
        flat[tagpos + 2] = data[e_off[order] + 1]
        flat[tagpos + 3] = ord(":")
        tchar = e_type[order].copy()
        is_int = np.isin(tchar, np.frombuffer(b"cCsSiI", np.uint8))
        tchar[is_int] = ord("i")
        flat[tagpos + 4] = tchar
        flat[tagpos + 5] = ord(":")
        # values
        vs = vstart[order]
        ii = np.nonzero(is_int)[0]
        if len(ii):
            write_ints(flat, ends[ii], int_vals[order][ii])
        ai = np.nonzero(tchar == ord("A"))[0]
        flat[ends[ai] - 1] = data[vs[ai]]
        zhi = np.nonzero((tchar == ord("Z")) | (tchar == ord("H")))[0]
        if len(zhi):
            zl = val_len[order][zhi]
            ragged_scatter(flat, ends[zhi] - zl, zl,
                           ragged_gather(data, vs[zhi], zl)[0])
        if b_vals is not None:
            bi, el_entry, el_val, el_len, sub = b_vals
            # map entry idx -> position after reorder
            pos_of_entry = np.empty(len(e_rec), np.int64)
            pos_of_entry[order] = np.arange(len(order))
            # value region starts right after "B:x" subchar
            ent_pos = pos_of_entry[bi]
            flat[ends[ent_pos] - val_len[order][ent_pos]] = sub
            # element ends within entry value area
            el_cum = np.cumsum(el_len)
            el_counts = np.bincount(el_entry, minlength=len(e_rec)).astype(np.int64)
            el_first = _excl_cumsum(el_counts)
            el_nz = np.nonzero(el_counts)[0]
            el_start_cum = np.concatenate([[0], el_cum])[el_first]
            el_before = np.repeat(el_start_cum[el_nz], el_counts[el_nz])
            el_within = el_cum - el_before
            base = ends[pos_of_entry[el_entry]] - val_len[order][pos_of_entry[el_entry]] + 1
            el_ends = base + el_within
            flat[el_ends - dec_len(el_val) - 1] = ord(",")
            write_ints(flat, el_ends, el_val)

    for i, txt in fb_texts.items():
        s = int(rec_starts[i])
        flat[s:s + len(txt)] = np.frombuffer(txt, np.uint8)

    return flat, out_lens


def bam_to_sam_bytes(data: np.ndarray, offs: np.ndarray, sizes: np.ndarray,
                     header: SamHeader) -> bytes:
    """SAM text of the records at `offs` (each `sizes` bytes with its u32
    length) of the uncompressed stream `data`: the multithreaded C++
    formatter (the sam_format_worker equivalent), or the numpy formatter
    (the JAX function's pure path) with the library off or for a record
    the native formatter rejects."""
    from htslib_tpu_torch.native import native
    if native is not None:
        try:
            return native.bam_to_sam(data, offs, sizes, header.ref_names)
        except IOError:
            pass  # malformed record: fall through to python path
    return format_sam_batch(decode_bam_columns(data, offs, sizes), header)


def bam_stream_to_sam(data, header: SamHeader, start: int = 0,
                      device="cuda", timing: Optional[dict] = None
                      ) -> np.ndarray:
    """SAM text (uint8) of an uncompressed record stream from byte
    `start`: the record scan and the format on `device`
    (`bam_payload_to_sam_device`: X5 and B1 on the card, their plain
    versions on the CPU; the host formatter's whole line for a CIGAR in a
    CG tag, as the JAX function gives it).  Raises IOError on a truncated stream, as the
    JAX function does.  `timing`, where given, gets the format's parts."""
    payload = bytes(memoryview(np.asarray(data, np.uint8))[start:])
    text = bam_payload_to_sam_device(payload, header, device=device,
                                     timing=timing, host_lines=True)
    return np.frombuffer(text, np.uint8)


def _header_end(raw: np.ndarray, table: BlockTable
                ) -> Tuple[SamHeader, int]:
    """The BAM header at the start of a BGZF file's stream, its members
    inflated on the host one at a time until it is whole, and its
    length in the uncompressed stream."""
    buf = b""
    for i in range(table.n):
        buf += inflate_host(raw, BlockTable(*(a[i:i + 1] for a in (
            table.coffsets, table.csizes, table.usizes))))
        bio = io.BytesIO(buf)
        try:
            return read_bam_header(bio), bio.tell()
        except EOFError:
            continue
    bio = io.BytesIO(buf)
    return read_bam_header(bio), bio.tell()


def read_bam_stream(path, device="cuda", timing: Optional[dict] = None
                    ) -> Tuple[SamHeader, bytes]:
    """A BAM file's header and its uncompressed record stream.  `path` is
    a name that `hopen` opens (a local path, an http(s) or ftp URL, an
    htsget ticket) or a binary file object; its compressed bytes are read
    once.  The header is parsed on the host; the members past it are
    inflated in one `inflate_range` call on `device` (X4 on the card,
    CRC32 and ISIZE checked).  A file that is not BGZF (plain gzip, or
    uncompressed) is read on the host.  A build or launch that fails
    raises.  `timing`, where given, gets read_s (the file read, the
    member walk and the header) and inflate_s."""
    dev = _build.resolve_device(device)
    timing = {} if timing is None else timing
    t0 = _build.clock(dev)
    raw = read_file(path)
    if raw[:2].tobytes() == b"\x1f\x8b":
        try:
            table = scan_blocks(raw)
        except (IOError, ValueError):
            table = None
    else:
        table = None
    if table is None:
        # plain gzip or uncompressed: no members for the device inflate
        bio = io.BytesIO(BgzfReader(io.BytesIO(raw.tobytes())).read(-1))
        hdr = read_bam_header(bio)
        payload = bio.read()
        timing["read_s"] = _build.clock(dev) - t0
        return hdr, payload
    hdr, u_skip = _header_end(raw, table)
    timing["read_s"] = _build.clock(dev) - t0
    inflated: dict = {}
    payload = inflate_range(raw, table.coffsets, table.csizes,
                            table.uoffsets, table.usizes, u_skip,
                            table.total_usize, dev, inflated)
    timing["inflate_s"] = sum(inflated.values())
    return hdr, payload


def bam_file_to_sam(path, device="cuda", timing: Optional[dict] = None):
    """BAM file -> SAM text in one call (`samtools view x.bam`): the
    header and record stream by `read_bam_stream` (X4 on the card), the
    records formatted by `bam_payload_to_sam_device` (X5, B1).  Returns
    (header, SAM text as uint8), as the JAX function does.  A build or
    launch that fails raises; nothing falls back to the host formatter.
    Raises IOError on a truncated record stream.  `timing`, where given,
    gets read_s (the file read, the member walk and the header),
    inflate_s, format_s and format (the format's parts)."""
    dev = _build.resolve_device(device)
    timing = {} if timing is None else timing
    hdr, payload = read_bam_stream(path, dev, timing)
    t0 = _build.clock(dev)
    parts: dict = {}
    text = bam_payload_to_sam_device(payload, hdr, device=dev, timing=parts,
                                     host_lines=True)
    timing["format_s"] = _build.clock(dev) - t0
    timing["format"] = parts
    return hdr, np.frombuffer(text, np.uint8)


def sam_text_to_bam(text: bytes, header: SamHeader) -> np.ndarray:
    """SAM text -> the u32-framed BAM record stream (uint8): the native
    multithreaded parser (the sam_parse_worker direction, sam.c:3215), or
    where it rejects a line (an unknown reference name with no
    references, a CIGAR of more than 65,535 ops) or the library is off, a
    line at a time through `BamRecord.from_sam` (sam_parse1; the JAX
    function's Python path); header and blank lines are skipped."""
    from htslib_tpu_torch.native import native
    if native is not None:
        try:
            return native.sam_to_bam(np.frombuffer(text, np.uint8),
                                     header.ref_names)
        except IOError:
            pass
    parts = []
    for line in text.split(b"\n"):
        if not line or line.startswith(b"@"):
            continue
        buf = BamRecord.from_sam(line.decode("utf-8").rstrip("\r"),
                                 header).to_bam_buffer()
        parts.append(struct.pack("<I", len(buf)) + buf)
    return np.frombuffer(b"".join(parts), np.uint8)


def _text_chunks(text: bytes, chunk_bytes: int):
    """`text` in pieces of about `chunk_bytes`, each ending at a line's
    end."""
    pos, n = 0, len(text)
    while pos < n:
        end = min(pos + chunk_bytes, n)
        if end < n:
            nl = text.rfind(b"\n", pos, end)
            end = nl + 1 if nl >= 0 else n
        yield text[pos:end]
        pos = end


def sam_to_bam_file(text: bytes, header: SamHeader, out_path: str,
                    level: int = 6, chunk_bytes: int = 8 << 20) -> int:
    """SAM text -> a BAM file: chunks of lines parsed by `sam_text_to_bam`
    on pipeline.py's host threads (`pipeline_map`, results in order),
    their records after the header cut into BGZF_BLOCK_SIZE members and
    deflated at `level` (`deflate_blocks`), then the EOF member (the
    sam_dispatcher_read and BGZF write stack, sam.c:3325, bgzf.c:1852).
    Returns the uncompressed bytes written, the header's included."""
    from htslib_tpu_torch.hfile import hopen
    from htslib_tpu_torch.pipeline import pipeline_map

    hb = io.BytesIO()
    write_bam_header(hb, header)
    pending = bytearray(hb.getvalue())
    written = 0
    with hopen(out_path, "wb") as fp:
        def flush(force: bool = False) -> None:
            nonlocal pending, written
            cut = (len(pending) if force
                   else len(pending) // BGZF_BLOCK_SIZE * BGZF_BLOCK_SIZE)
            mv = memoryview(pending)
            for member in deflate_blocks(
                    [bytes(mv[at:min(at + BGZF_BLOCK_SIZE, cut)])
                     for at in range(0, cut, BGZF_BLOCK_SIZE)], level):
                fp.write(member)
            mv.release()
            written += cut
            del pending[:cut]

        for blob in pipeline_map(lambda c: sam_text_to_bam(c, header)
                                 .tobytes(), _text_chunks(text, chunk_bytes),
                                 window=3):
            pending += blob
            flush()
        flush(force=True)
        fp.write(BGZF_EOF)
    return written
