"""The device BAM -> SAM chain: record-boundary scan -> core-field unpack
-> nibble2base -> qual+33 -> int -> decimal -> whole SAM line prefixes,
over a batch of records on the card.

Port of htslib_tpu/ops/bam2sam.py: `device_record_scan` (:34, kernel X5,
csrc/record_scan.cu), `device_format_records` (:73, torch ops, with
kernel B1 through ops/seqfmt.nibble_to_base) and
`bam_payload_to_sam_device` (:210).  The aux tails stay on the host: C's
`%g` is the JAX design's host boundary (docs/DEVICE_LIMITS.md), so the
wrapper renders each record's aux blob with sam/record.format_aux_blob
and splices it in.  A record's line and its tail meet in one bytes
object; records without aux need no host work past the download.

Reference hot path: bam_read1 field extraction (sam.c:809-822),
sam_format1_append (sam.c:4324), nibble2base (simd.c:121).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from htslib_tpu_torch import _build
from htslib_tpu_torch.ops.seqfmt import (dec_len_device, itoa_fixed,
                                         nibble_to_base, qual_to_ascii,
                                         unpack_core_fields)
from htslib_tpu_torch.sam.header import SamHeader
from htslib_tpu_torch.sam.record import BamRecord, format_aux_blob

CIG_CHARS = np.frombuffer(b"MIDNSHP=XB??????", np.uint8)
DIG_W = 11   # itoa_fixed's width: an int32 with its sign


def _wrap32(v: int) -> int:
    """v as an int32 sum wraps."""
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def record_scan_plain(payload: torch.Tensor, max_records: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of kernel X5: the JAX fori_loop transcribed step by
    step (int32 sums, the length read at clip(pos, 0, U - 4), a step ok
    while pos + 4 <= U).  A chain of dependent steps has no tensor form,
    so the host walks the payload's bytes; the results go back to the
    payload's device.  Returns (offsets int32 [max_records], -1 past n;
    sizes int32; n int32 scalar)."""
    buf = payload.cpu().numpy().tobytes()
    u = len(buf)
    offs = np.full(max_records, -1, np.int32)
    sizes = np.zeros(max_records, np.int32)
    pos = n = 0
    while n < max_records and _wrap32(pos + 4) <= u:
        at = min(max(pos, 0), u - 4)
        bsz = int.from_bytes(buf[at:at + 4], "little", signed=True)
        offs[n], sizes[n] = pos, bsz
        pos = _wrap32(pos + 4 + bsz)
        n += 1
    dev = payload.device
    return (torch.from_numpy(offs).to(dev), torch.from_numpy(sizes).to(dev),
            torch.tensor(n, dtype=torch.int32, device=dev))


# Kernel X5's segmented design (csrc/record_scan.cu): segments of
# 2^SEG_SHIFT bytes, taken for payloads of SEG_MIN_BYTES or more; smaller
# ones take the serial kernel (both set by probe_x1_x5.py's sweep).
SEG_SHIFT = 16
SEG_MIN_BYTES = 1 << 17


def seg_fits(u: int, max_records: int) -> bool:
    """Whether kernel X5 walks a payload of u bytes in parallel segments
    (the segmented kernels) rather than on one thread."""
    return u >= SEG_MIN_BYTES and max_records > 0


def record_scan_cuda(payload: torch.Tensor, max_records: int,
                     segmented: Optional[bool] = None,
                     shift: int = SEG_SHIFT,
                     stats: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel X5 on a uint8 [U] payload on the card; same results as
    `record_scan_plain`.  `segmented` forces the segmented kernels (True)
    or the serial one (False); None takes `seg_fits`.  `stats` (int32 [4]
    on the card), where given, gets the segmented scan's segments,
    segments walked again, serial-tail steps and segments verified."""
    _build.require_cuda(payload, torch.uint8, "payload")
    if payload.dim() != 1 or payload.numel() >= 1 << 31:
        raise ValueError("payload: expected [U] bytes, U < 2^31")
    if max_records < 0 or max_records >= 1 << 31:
        raise ValueError("max_records: expected 0 <= max_records < 2^31")
    if not 4 <= shift <= 16:
        raise ValueError("shift: expected 4 <= shift <= 16")
    if payload.data_ptr() % 16:
        payload = payload.clone()      # the windows copy 16-byte chunks
    u = payload.numel()
    if segmented is None:
        segmented = seg_fits(u, max_records)
    dev = payload.device
    offs = torch.empty(max_records, dtype=torch.int32, device=dev)
    sizes = torch.empty(max_records, dtype=torch.int32, device=dev)
    n = torch.empty((), dtype=torch.int32, device=dev)
    lib = _build.load("record_scan")
    if segmented and u > 0:
        n_seg = -(-u >> shift)
        summ = torch.empty(5 * n_seg, dtype=torch.int32, device=dev)
        starts = torch.empty(n_seg << (shift - 2), dtype=torch.int16,
                             device=dev)
        if stats is None:
            stats = torch.empty(4, dtype=torch.int32, device=dev)
        _build.require_cuda(stats, torch.int32, "stats", (4,))
        rc = lib.record_scan_seg_launch(
            payload.data_ptr(), u, max_records, offs.data_ptr(),
            sizes.data_ptr(), n.data_ptr(), summ.data_ptr(),
            starts.data_ptr(), stats.data_ptr(), shift,
            _build.stream_handle(payload))
        key = "record_scan_seg"
    else:
        rc = lib.record_scan_launch(payload.data_ptr(), u, max_records,
                                    offs.data_ptr(), sizes.data_ptr(),
                                    n.data_ptr(),
                                    _build.stream_handle(payload))
        key = "record_scan"
    _build.check(lib, rc, key)
    _build.LAUNCHES[key] += 1
    if _build.SHAPES is not None:
        _build.SHAPES.append((key, u, max_records))
    return offs, sizes, n


def window_bytes() -> int:
    """Bytes of the payload a window of kernel X5 holds (two in shared
    memory)."""
    return _build.load("record_scan").record_scan_window_bytes()


def device_record_scan(payload: torch.Tensor, max_records: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Record-boundary walk over a u32-length-prefixed BAM record stream
    (the bam_read1 framing, sam.c:784): offsets[k+1] = offsets[k] + 4 +
    block_len.  Returns (offsets [max_records], sizes, n_records): kernel
    X5 for a payload on the card, the plain version for one on the CPU."""
    if payload.is_cuda:
        return record_scan_cuda(payload, max_records)
    if payload.device.type != "cpu":
        raise ValueError(f"unsupported device {payload.device}")
    return record_scan_plain(payload, max_records)


def _gather_rows(payload: torch.Tensor, starts: torch.Tensor,
                 width: int) -> torch.Tensor:
    """[N] start offsets -> [N, width] byte rows (clamped gathers)."""
    idx = starts.long()[:, None] + torch.arange(width, device=payload.device)
    return payload[idx.clamp(0, payload.numel() - 1)]


def _put_max(out: torch.Tensor, tgt: torch.Tensor, src: torch.Tensor):
    """The JAX `out.at[rows, min(tgt, w - 1)].max(where(tgt < w, src, 0),
    mode="drop")` on out int32 [N, w + 1], whose last column takes what
    JAX drops: a negative index counts from the row's end, as JAX's index
    normalisation makes it, and one still below 0 is dropped."""
    w = out.shape[1] - 1
    idx = tgt.long().clamp(max=w - 1)
    idx = torch.where(idx < 0, idx + w, idx)
    idx = torch.where(idx < 0, w, idx)
    val = torch.where(tgt < w, src.to(torch.int32), 0)
    out.scatter_reduce_(1, idx, val, "amax")


def _star_rows(n: int, w: int, dev) -> torch.Tensor:
    """uint8 [n, w] of "*" then zeros."""
    rows = torch.zeros((n, w), dtype=torch.uint8, device=dev)
    rows[:, 0] = ord("*")
    return rows


def _format(payload, names_tbl, offs, max_qname: int, max_ops: int,
            max_len: int, out_w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chain after the scan: line prefixes uint8 [N, out_w] and their
    lengths int32 [N] of the records at `offs` (-1: a row past n)."""
    dev = payload.device
    N = offs.shape[0]
    base = torch.where(offs >= 0, offs.long() + 4, 0)
    f = unpack_core_fields(_gather_rows(payload, base, 32))
    tid, pos, mapq = f["tid"], f["pos"], f["mapq"]
    l_qname, n_cigar, flag = f["l_qname"], f["n_cigar"], f["flag"]
    l_qseq, mtid, mpos, tlen = f["l_qseq"], f["mtid"], f["mpos"], f["tlen"]

    qname = _gather_rows(payload, base + 32, max_qname)
    cig = _gather_rows(payload, base + 32 + l_qname, 4 * max_ops).view(
        torch.int32).long() & 0xFFFFFFFF
    seq_off = base + 32 + l_qname + 4 * n_cigar
    packed = _gather_rows(payload, seq_off, (max_len + 1) // 2)
    bases = nibble_to_base(packed)[:, :max_len]
    quals = _gather_rows(payload, seq_off + (l_qseq.long() + 1) // 2,
                         max_len)

    def col(v):
        return itoa_fixed(v), dec_len_device(v)

    flag_t, flag_l = col(flag)
    pos_t, pos_l = col(pos + 1)
    mapq_t, mapq_l = col(mapq)
    mpos_t, mpos_l = col(mpos + 1)
    tlen_t, tlen_l = col(tlen)

    # reference names: row tid (-1 -> the "*" row at index n_ref); RNEXT
    # "=" when mtid == tid and mapped
    n_ref = names_tbl.shape[0] - 1
    rname = names_tbl[torch.where(tid < 0, n_ref, tid).clamp(0, n_ref).long()]
    rname_l = (rname != 0).sum(1)
    mt_row = names_tbl[torch.where(mtid < 0, n_ref, mtid).clamp(
        0, n_ref).long()]
    same = (mtid == tid) & (mtid >= 0)
    eq_row = torch.zeros_like(mt_row)
    eq_row[:, 0] = ord("=")
    rnext = torch.where(same[:, None], eq_row, mt_row)
    rnext_l = torch.where(same, 1, (mt_row != 0).sum(1))

    # CIGAR text: each op's digits and letter at its cumsum offset
    ops = cig & 0xF
    lens = (cig >> 4).to(torch.int32)
    op_valid = torch.arange(max_ops, device=dev)[None, :] < n_cigar[:, None]
    op_txt = itoa_fixed(lens.reshape(-1)).reshape(N, max_ops, DIG_W)
    op_dig = dec_len_device(lens.reshape(-1)).reshape(N, max_ops)
    op_len = torch.where(op_valid, op_dig + 1, 0)
    cig_w = max_ops * (DIG_W + 1)
    op_start = torch.cumsum(op_len, 1) - op_len
    within = torch.arange(DIG_W + 1, device=dev)[None, None, :]
    chars = torch.from_numpy(CIG_CHARS.copy()).to(dev)[ops]
    src = torch.cat([op_txt, chars[:, :, None]], 2)
    skip = (DIG_W - op_dig)[:, :, None]
    tgt = torch.where((within >= skip) & op_valid[:, :, None],
                      op_start[:, :, None] + within - skip, cig_w)
    cig_acc = torch.zeros((N, cig_w + 1), dtype=torch.int32, device=dev)
    _put_max(cig_acc, tgt.reshape(N, -1), src.reshape(N, -1))
    star = n_cigar == 0
    cig_txt = torch.where(star[:, None], _star_rows(N, cig_w, dev),
                          cig_acc[:, :cig_w].to(torch.uint8))
    cig_len = torch.where(star, 1, op_len.sum(1))

    # SEQ/QUAL text, "*" where empty or (QUAL) the first quality is 0xFF
    seq_l = torch.where(l_qseq > 0, l_qseq, 1)
    no_seq = l_qseq == 0
    seq_txt = torch.where(no_seq[:, None], _star_rows(N, max_len, dev), bases)
    qmask = torch.arange(max_len, device=dev)[None, :] < l_qseq[:, None]
    no_qual = no_seq | (quals[:, 0] == 0xFF)
    qual_txt = torch.where(no_qual[:, None], _star_rows(N, max_len, dev),
                           qual_to_ascii(quals, qmask))
    qual_l = torch.where(no_qual, 1, l_qseq)

    # line assembly: each column at its cumsum offset, a tab after each
    # but the last
    cols = [(qname, l_qname - 1, False), (flag_t, flag_l, True),
            (rname, rname_l, False), (pos_t, pos_l, True),
            (mapq_t, mapq_l, True), (cig_txt, cig_len, False),
            (rnext, rnext_l, False), (mpos_t, mpos_l, True),
            (tlen_t, tlen_l, True), (seq_txt, seq_l, False),
            (qual_txt, qual_l, False)]
    total = sum(ln.long() + 1 for _, ln, _ in cols) - 1
    out = torch.zeros((N, out_w + 1), dtype=torch.int32, device=dev)
    cur = torch.zeros(N, dtype=torch.long, device=dev)
    tab = torch.full((N, 1), ord("\t"), dtype=torch.int32, device=dev)
    for ci, (txt, ln, right) in enumerate(cols):
        ln = ln.long()
        w = txt.shape[1]
        within2 = torch.arange(w, device=dev)[None, :]
        start_in = (w - ln)[:, None] if right else torch.zeros(
            (N, 1), dtype=torch.long, device=dev)
        keep = (within2 >= start_in) & (within2 < start_in + ln[:, None])
        _put_max(out, torch.where(keep, cur[:, None] + within2 - start_in,
                                  out_w), txt)
        cur = cur + ln
        if ci < len(cols) - 1:
            _put_max(out, cur[:, None], tab)
            cur = cur + 1
    return out[:, :out_w].to(torch.uint8), total.to(torch.int32)


def device_format_records(payload: torch.Tensor, names_tbl: torch.Tensor,
                          max_records: int, max_qname: int, max_ops: int,
                          max_len: int, name_w: int, out_w: int):
    """The chain: scan -> unpack -> per-column text -> assembled SAM line
    prefixes (everything before the aux tail), on the payload's device.

    payload: uint8 [U] record stream; names_tbl: uint8 [n_ref + 1, name_w]
    reference names padded with NULs, row n_ref "*".  Returns four values,
    as the JAX function does: (lines uint8 [max_records, out_w], line
    lengths int32 [max_records], n_records int32, sizes int32
    [max_records])."""
    offs, sizes, n = device_record_scan(payload, max_records)
    out, total = _format(payload, names_tbl, offs, max_qname, max_ops,
                         max_len, out_w)
    return out, total, n, sizes


def _names_table(header) -> np.ndarray:
    names = [nm.encode() for nm in header.ref_names]
    tbl = np.zeros((len(names) + 1, max([len(nm) for nm in names] + [1])),
                   np.uint8)
    for i, nm in enumerate(names):
        tbl[i, :len(nm)] = np.frombuffer(nm, np.uint8)
    tbl[len(names), 0] = ord("*")
    return tbl


def _lengths(c: torch.Tensor):
    """l_read_name, n_cigar_op and the signed l_seq of core fields c
    int64 [N, 32]."""
    l_seq = c[:, 16] | (c[:, 17] << 8) | (c[:, 18] << 16) | (c[:, 19] << 24)
    l_seq = torch.where(l_seq >= 1 << 31, l_seq - (1 << 32), l_seq)
    return c[:, 8], c[:, 12] | (c[:, 13] << 8), l_seq


def _u32(c: torch.Tensor, at: int) -> torch.Tensor:
    """The little-endian u32 at byte `at` of core fields c, as int64."""
    return (c[:, at] | (c[:, at + 1] << 8) | (c[:, at + 2] << 16)
            | (c[:, at + 3] << 24))


def _check_records(pl_t: torch.Tensor, offs: torch.Tensor,
                   sizes: torch.Tensor):
    """The size checks of `BamRecord.from_bam_buffer`, vectorised on the
    payload's device.  Returns (the first record that fails one, or N;
    each record's core fields int64 [N, 32]; each record's aux blob
    start)."""
    base = offs + 4
    ok_size = sizes >= 32
    core = torch.where(ok_size[:, None],
                       base[:, None] + torch.arange(32, device=base.device),
                       0)
    c = pl_t[core].long()
    l_name, n_cig, l_seq = _lengths(c)
    need = l_name + 4 * n_cig + (l_seq + 1) // 2 + l_seq
    bad = torch.nonzero(~ok_size | (l_name == 0) | (32 + need > sizes))
    first = int(bad[0, 0]) if bad.numel() else len(offs)
    return first, c, base + 32 + need


def _text_faults(pl_t: torch.Tensor, offs: torch.Tensor, c: torch.Tensor
                 ) -> Tuple[int, np.ndarray]:
    """What the host formatter (`BamRecord.to_sam`) refuses, or must do
    its own way, in records whose sizes passed, vectorised on the
    payload's device.  It raises UnicodeDecodeError on a QNAME byte past
    0x7F, IndexError on a CIGAR op code past 9 (`format_cigar`), and
    ValueError or UnicodeDecodeError on a quality past 94 (its text, q +
    33, is no ASCII byte) unless the first quality is 0xFF.  A QNAME
    holding a tab shifts the JAX wrapper's split of the host line, and a
    record whose first CIGAR op is a soft clip of the whole query may
    carry its CIGAR in a CG tag (bam_tag2cigar): both take the host
    formatter's path.  Returns (the first refused record, or N; the
    records for the host path)."""
    dev = pl_t.device
    n = len(offs)
    if n == 0:
        return 0, np.empty(0, np.int64)
    u = pl_t.numel()
    l_name, n_cig, l_seq = _lengths(c)
    name_at = offs + 36
    cig_at = name_at + l_name
    qual_at = cig_at + 4 * n_cig + (l_seq + 1) // 2

    # one region code a byte: 1 inside a QNAME's text, 2 inside a QUAL
    # whose first byte is not 0xFF (the records' ranges are disjoint)
    has_qual = (l_seq > 0) & (pl_t[qual_at.clamp(0, u - 1)] != 0xFF)
    mark = torch.zeros(u + 1, dtype=torch.int32, device=dev)
    for lo, hi, code in ((name_at, name_at + l_name - 1,
                          torch.ones(n, dtype=torch.int32, device=dev)),
                         (qual_at, qual_at + l_seq, 2 * has_qual.int())):
        mark.index_add_(0, lo.clamp(0, u), code)
        mark.index_add_(0, torch.where(code != 0, hi, lo).clamp(0, u), -code)
    region = torch.cumsum(mark[:-1], 0, dtype=torch.int32)
    refused = (((region == 1) & (pl_t >= 0x80))
               | ((region == 2) & (pl_t >= 95)))
    tabbed = (region == 1) & (pl_t == ord("\t"))

    def rec_of(byte_mask):
        at = torch.nonzero(byte_mask).flatten()
        return torch.searchsorted(offs, at, right=True) - 1

    op_rec = torch.repeat_interleave(torch.arange(n, device=dev), n_cig)
    op_at = cig_at[op_rec] + 4 * (
        torch.arange(len(op_rec), device=dev)
        - (torch.cumsum(n_cig, 0) - n_cig)[op_rec])
    bad_rec = torch.cat([rec_of(refused),
                         op_rec[(pl_t[op_at] & 0xF) >= 10]])
    first = int(bad_rec.min()) if bad_rec.numel() else n
    cig0 = sum(pl_t[(cig_at + k).clamp(0, u - 1)].long() << (8 * k)
               for k in range(4))
    cg = ((n_cig > 0) & (cig0 == (4 | (l_seq << 4)))
          & (_u32(c, 0) < 1 << 31) & (_u32(c, 4) < 1 << 31))
    host = torch.unique(torch.cat([torch.nonzero(cg).flatten(),
                                   rec_of(tabbed)]))
    return first, host.cpu().numpy()


def _host_line(payload: bytes, off: int, size: int, header) -> str:
    """A record's whole line by the host formatter (to_sam)."""
    rec = BamRecord.from_bam_buffer(memoryview(payload), off + 4, size)
    return rec.to_sam(SamHeader(ref_names=header.ref_names))


def _host_tail(payload: bytes, off: int, size: int, header) -> str:
    """A record's aux tail as the JAX wrapper takes it from the host
    formatter: its line split on tabs, the fields past the eleventh."""
    parts = _host_line(payload, off, size, header).split("\t")
    return "\t" + "\t".join(parts[11:]) if len(parts) > 11 else ""


def _aux_texts(payload: bytes, offs: np.ndarray, sizes: np.ndarray,
               aux_at: np.ndarray, host: np.ndarray, header) -> dict:
    """Record index -> its aux tail ("\\t" and the tags' SAM text) for the
    records with a non-empty aux blob, in record order, so the first
    record the host formatter refuses raises.  The records in `host`
    (`_text_faults`) go through the whole host formatter, which moves a
    long CIGAR out of a CG tag (bam_tag2cigar), as the JAX wrapper's
    does."""
    out = {}
    ends = offs + 4 + sizes
    host_rows = set(host.tolist())
    for i in np.union1d(np.flatnonzero(ends > aux_at), host):
        if i in host_rows:
            text = _host_tail(payload, int(offs[i]), int(sizes[i]), header)
        else:
            text = format_aux_blob(payload[aux_at[i]:ends[i]])
            text = "\t" + text if text else ""
        if text:
            out[int(i)] = text
    return out


def bam_payload_to_sam_device(payload: bytes, header,
                              aux_texts: Optional[List[str]] = None,
                              device="cuda",
                              timing: Optional[dict] = None,
                              host_lines: bool = False) -> bytes:
    """SAM text of a u32-framed BAM record stream: the device chain for
    the line prefixes (X5, B1 and torch ops), the aux tails rendered on
    the host (or `aux_texts`, one per record, as the JAX function takes
    them) and spliced in.  Byte-exact against the host formatter.
    `header` is any object with `ref_names`.  Raises
    IOError on a truncated stream and, with `aux_texts` None, what the
    JAX function's host formatter raises, for the first record it
    refuses.  With `host_lines` (and `aux_texts` None), the records that
    take the host formatter's path (a CIGAR in a CG tag, a tab in a
    QNAME) get its whole line, as the file-level formatters give them
    (sam/batch.py; htslib's sam_format1), where the JAX wrapper keeps the
    device's line and splits the host's tail from it.  `timing`, where
    given, gets seconds by part: framing_s (the
    host framing scan, maxima and names table), upload_s, check_s (the
    record checks), scan_s (X5), format_s, download_s, aux_s (the tails)
    and splice_s."""
    dev = _build.resolve_device(device)
    clock = _build.clock
    t0 = clock(dev)
    offs, p, u = [], 0, len(payload)
    while p + 4 <= u:
        bsz = int.from_bytes(payload[p:p + 4], "little")
        offs.append(p)
        p += 4 + bsz
    if p != u:
        raise IOError("truncated BAM record stream")
    N = len(offs)
    if N == 0:
        return b""
    pl = np.frombuffer(payload, np.uint8)
    o = np.asarray(offs, np.int64)
    at = o[:, None] + np.arange(24)
    hdr = pl[np.minimum(at, u - 1)].astype(np.int64)
    sizes = (hdr[:, 0] | (hdr[:, 1] << 8) | (hdr[:, 2] << 16)
             | (hdr[:, 3] << 24))
    max_qname = int(hdr[:, 12].max())
    max_ops = max(1, int((hdr[:, 16] | (hdr[:, 17] << 8)).max()))
    max_len = max(1, int((hdr[:, 20] | (hdr[:, 21] << 8) | (hdr[:, 22] << 16)
                          | (hdr[:, 23] << 24)).max()))
    tbl = _names_table(header)
    out_w = (max_qname + 11 * 4 + tbl.shape[1] * 2 + max_ops * (DIG_W + 1)
             + max_len * 2 + 16)
    t1 = clock(dev)
    pl_t = torch.from_numpy(pl.copy()).to(dev)
    tbl_t = torch.from_numpy(tbl).to(dev)
    t2 = clock(dev)
    if aux_texts is None:
        # the JAX wrapper formats every record on the host first: raise
        # what it raises, for the first record it refuses
        o_t = torch.from_numpy(o).to(dev)
        first, c, aux_at = _check_records(pl_t, o_t,
                                          torch.from_numpy(sizes).to(dev))
        text_bad, host = _text_faults(pl_t, o_t[:first], c[:first])
        aux_at = aux_at.cpu().numpy()
        if min(first, text_bad) < N:
            first = min(first, text_bad)
            _aux_texts(payload, o[:first], sizes[:first], aux_at[:first],
                       host[host < first], header)
            _host_tail(payload, int(o[first]), int(sizes[first]), header)
            raise RuntimeError(f"record {first}: refused by the record "
                               "checks but not by the host formatter")
    t3 = clock(dev)
    d_offs, _sizes, _n = device_record_scan(pl_t, N)
    t4 = clock(dev)
    line, total = _format(pl_t, tbl_t, d_offs, max_qname, max_ops, max_len,
                          out_w)
    t5 = clock(dev)
    # out_w leaves room past the longest line for its newline
    line[torch.arange(N, device=dev), total.long()] = ord("\n")
    keep = torch.arange(out_w, device=dev)[None, :] <= total[:, None]
    text = line[keep].cpu().numpy().tobytes()
    ends = np.cumsum(total.cpu().numpy().astype(np.int64) + 1) - 1
    t6 = clock(dev)
    whole = {}
    if aux_texts is None:
        tails = _aux_texts(payload, o, sizes, aux_at, host, header)
        if host_lines:
            for i in host.tolist():
                whole[i] = _host_line(payload, int(o[i]), int(sizes[i]),
                                      header)
                tails.pop(i, None)
    else:
        tails = {i: s for i, s in enumerate(aux_texts) if s}
    t7 = clock(dev)
    if tails or whole:
        pieces, prev = [], 0
        for i in sorted(set(tails) | set(whole)):
            if i in whole:
                start = int(ends[i - 1]) + 1 if i else 0
                pieces += [text[prev:start], whole[i].encode()]
            else:
                pieces += [text[prev:ends[i]], tails[i].encode()]
            prev = int(ends[i])
        pieces.append(text[prev:])
        text = b"".join(pieces)
    if timing is not None:
        timing.update(framing_s=t1 - t0, upload_s=t2 - t1, check_s=t3 - t2,
                      scan_s=t4 - t3, format_s=t5 - t4, download_s=t6 - t5,
                      aux_s=t7 - t6, splice_s=clock(dev) - t7,
                      records=N, aux_records=len(tails))
    return text
