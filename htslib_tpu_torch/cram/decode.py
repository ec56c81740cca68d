"""CRAM slice decoding -> BAM records (the port's copy of the Python path
of htslib_tpu/cram/decode.py; reference cram/cram_decode.c).

Per-slice: parse the compression header's codec maps once, then play the
per-record decode loop (cram_decode_slice:2346, cram_decode_seq:1096),
resolve intra-slice mate references (cram_decode_slice_xref:2140) and
convert to BamRecords (cram_to_bam:3100).  A CRAM 3 slice that is not
multi-reference, read without pruning, goes first to the native slice
decoder (`native.cram_decode_slice`, htstpu_cram_decode_slice) on its
blocks' uncompressed payloads, where and when the JAX package sends it
there; the loop here decodes it where the native library is off or bails
on the slice's configuration.  With `required_fields` (SAM_* bits) the
series no requested field needs are not read, and their EXTERNAL blocks
are not even uncompressed (`_active_series`).  A block whose
`_uncompressed` bytes are already set (cram/batch.py decodes the rANS
blocks of a batch of slices on the device) is not decoded again.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from htslib_tpu_torch.cram.codecs import (CORE_ID, Codec, SliceStreams,
                                          parse_encoding)
from htslib_tpu_torch.cram.io import CramBlock
from htslib_tpu_torch.cram.structs import (
    CRAM_FLAG_DETACHED, CRAM_FLAG_EXPLICIT_TLEN, CRAM_FLAG_MATE_DOWNSTREAM,
    CRAM_FLAG_NO_SEQ, CRAM_FLAG_PRESERVE_QUAL_SCORES, CRAM_M_REVERSE,
    CRAM_M_UNMAP, CT_CORE, CT_EXTERNAL, l1)
from htslib_tpu_torch.cram.v4 import varint_vec
from htslib_tpu_torch.sam.cigar import (BAM_CDEL, BAM_CHARD_CLIP, BAM_CINS,
                                        BAM_CMATCH, BAM_CPAD, BAM_CREF_SKIP,
                                        BAM_CSOFT_CLIP, cigar2rlen, reg2bin)
from htslib_tpu_torch.sam.header import SamHeader
from htslib_tpu_torch.sam.record import (FMREVERSE, FMUNMAP, FPAIRED,
                                         FREVERSE, FUNMAP, BamRecord)

INT64_MIN = -(1 << 63)

# SAM_* required-field bits (htslib/sam.h:35-50, used with
# CRAM_OPT_REQUIRED_FIELDS / hts_set_opt)
SAM_QNAME = 0x1
SAM_FLAG = 0x2
SAM_RNAME = 0x4
SAM_POS = 0x8
SAM_MAPQ = 0x10
SAM_CIGAR = 0x20
SAM_RNEXT = 0x40
SAM_PNEXT = 0x80
SAM_TLEN = 0x100
SAM_SEQ = 0x200
SAM_QUAL = 0x400
SAM_AUX = 0x800
SAM_RGAUX = 0x1000

# the feature-playback series: decoded as a unit because the CIGAR and
# sequence structure interleave (cram_decode_seq, cram_decode.c:1096)
_FEAT_SERIES = ("FN", "FC", "FP", "BS", "IN", "SC", "DL", "HC", "PD",
                "RS", "BB", "BA")


def _active_series(hdr: "CompressionHeader", required: int):
    """Required-fields pruning (cram_dependent_data_series,
    cram_decode.c:553): which gated series groups decode, widened to a
    fixpoint over shared blocks (a skipped series must not leave a stream
    that an active series reads out of step).  Returns None when
    everything decodes, else (active keys, whether aux values decode,
    the content ids of the blocks needed)."""
    if not required:
        return None

    def ids_of(keys):
        out = set()
        for k in keys:
            c = hdr.codecs.get(k)
            if c is not None:
                out |= c.block_ids()
        return out

    groups = {
        "RN": ({"RN"}, ids_of(["RN"]), bool(required & SAM_QNAME)),
        "QS": ({"QS"}, ids_of(["QS"]), bool(required & SAM_QUAL)),
        "AUX": (set(), set().union(*(c.block_ids() for c in
                                     hdr.tag_codecs.values())),
                bool(required & (SAM_AUX | SAM_RGAUX))),
        "FEAT": (set(_FEAT_SERIES), ids_of(_FEAT_SERIES),
                 bool(required & (SAM_CIGAR | SAM_SEQ | SAM_QUAL
                                  | SAM_TLEN))),
    }
    always = [k for k in hdr.codecs
              if k not in {"RN", "QS"} and k not in _FEAT_SERIES]
    active_ids = ids_of(always)
    active = {g for g, (_, _, on) in groups.items() if on}
    for g in active:
        active_ids |= groups[g][1]
    changed = True
    while changed:
        changed = False
        # a skipped group sharing a block with the active set (CORE
        # included) is switched on
        for g, (_, gids, _) in groups.items():
            if g not in active and gids & active_ids:
                active.add(g)
                active_ids |= gids
                changed = True
        # QS bytes are read inside the feature loop, so an active QS
        # stream switches the feature group on
        if "QS" in active and "FEAT" not in active:
            active.add("FEAT")
            active_ids |= groups["FEAT"][1]
            changed = True
    keys = set(always)
    for g in active:
        keys |= groups[g][0]
    return keys, "AUX" in active, active_ids - {CORE_ID}


@dataclass
class CompressionHeader:
    read_names_included: bool = True
    AP_delta: bool = True
    no_ref: bool = False          # RR=false
    qs_seq_orient: bool = True
    sub_matrix: Dict[int, bytes] = field(default_factory=dict)
    TD: List[bytes] = field(default_factory=list)
    codecs: Dict[str, Codec] = field(default_factory=dict)
    tag_codecs: Dict[int, Codec] = field(default_factory=dict)
    raw: Optional[bytes] = None   # uncompressed header bytes (native path)


def decode_compression_header(block: CramBlock,
                              vmajor: int = 3) -> CompressionHeader:
    """cram_decode_compression_header (cram_decode.c:144)."""
    buf = block.uncompress()
    vv = varint_vec(vmajor)
    hdr = CompressionHeader()
    hdr.raw = bytes(buf)
    # default substitution matrix "CGTN AGTN ACTN ACGN ACGT"
    default = ["CGTN", "AGTN", "ACTN", "ACGN", "ACGT"]
    hdr.sub_matrix = {i: default[i].encode() for i in range(5)}
    p = 0
    # preservation map
    _, p = vv.get32(buf, p)
    n, p = vv.get32(buf, p)
    for _ in range(n):
        key = buf[p:p + 2].decode()
        p += 2
        if key in ("MI", "UI", "PI", "RN", "AP", "RR", "QO"):
            val = buf[p]
            p += 1
            if key == "RN":
                hdr.read_names_included = bool(val)
            elif key == "AP":
                hdr.AP_delta = bool(val)
            elif key == "RR":
                hdr.no_ref = not val
            elif key == "QO":
                hdr.qs_seq_orient = bool(val)
        elif key == "SM":
            sm = buf[p:p + 5]
            p += 5
            mats = {}
            for i in range(5):
                others = [b for b in "ACGTN" if b != "ACGTN"[i]]
                row = bytearray(4)
                for j in range(4):
                    code = (sm[i] >> (6 - 2 * j)) & 3
                    row[code] = ord(others[j])
                mats[i] = bytes(row)
            hdr.sub_matrix = mats
        elif key == "TD":
            ln, p = vv.get32(buf, p)
            blob = buf[p:p + ln]
            p += ln
            hdr.TD = blob.split(b"\x00")[:-1] if blob.endswith(b"\x00") else blob.split(b"\x00")
        else:
            raise IOError(f"unknown preservation map key {key!r}")
    # data series encodings
    _, p = vv.get32(buf, p)
    n, p = vv.get32(buf, p)
    for _ in range(n):
        key = buf[p:p + 2].decode()
        p += 2
        codec, p = parse_encoding(buf, p, vv)
        hdr.codecs[key] = codec
    # tag encodings
    _, p = vv.get32(buf, p)
    n, p = vv.get32(buf, p)
    for _ in range(n):
        kid, p = vv.get32(buf, p)
        codec, p = parse_encoding(buf, p, vv)
        hdr.tag_codecs[kid] = codec
    return hdr


@dataclass
class SliceHeader:
    ref_seq_id: int
    ref_seq_start: int
    ref_seq_span: int
    num_records: int
    record_counter: int
    num_blocks: int
    content_ids: List[int]
    ref_base_id: int
    md5: bytes


def decode_slice_header(block: CramBlock, vmajor: int) -> SliceHeader:
    """cram_decode_slice_header (cram_decode.c:954): signed ref_seq_id,
    64-bit start/span under CRAM 4 (cram_decode.c:980)."""
    buf = block.uncompress() if block.method else block.data
    vv = varint_vec(vmajor)
    p = 0
    ref_seq_id, p = vv.get32s(buf, p)
    if vmajor >= 4:
        ref_seq_start, p = vv.get64(buf, p)
        ref_seq_span, p = vv.get64(buf, p)
    else:
        ref_seq_start, p = vv.get32(buf, p)
        ref_seq_span, p = vv.get32(buf, p)
    num_records, p = vv.get32(buf, p)
    if vmajor >= 3:
        record_counter, p = vv.get64(buf, p)
    elif vmajor == 2:
        record_counter, p = vv.get32(buf, p)
    else:
        record_counter = 0
    num_blocks, p = vv.get32(buf, p)
    nids, p = vv.get32(buf, p)
    content_ids = []
    for _ in range(nids):
        v, p = vv.get32(buf, p)
        content_ids.append(v)
    ref_base_id, p = vv.get32(buf, p)
    if ref_base_id == 0xFFFFFFFF:
        ref_base_id = -1  # unsigned put of -1 (cram_encode.c:551)
    md5 = bytes(buf[p:p + 16])
    return SliceHeader(ref_seq_id, ref_seq_start, ref_seq_span, num_records,
                       record_counter, num_blocks, content_ids, ref_base_id,
                       md5)


_AUX_SIZE = {ord("A"): 1, ord("c"): 1, ord("C"): 1, ord("s"): 2,
             ord("S"): 2, ord("i"): 4, ord("I"): 4, ord("f"): 4, ord("d"): 8}


class CramRecordTmp:
    __slots__ = ("flags", "cram_flags", "ref_id", "len", "apos", "rg",
                 "name", "mate_flags", "mate_ref_id", "mate_pos", "tlen",
                 "explicit_tlen", "mate_line", "aux", "cigar", "mqual",
                 "seq", "qual", "aend")

    def __init__(self):
        self.flags = 0
        self.cram_flags = 0
        self.ref_id = -1
        self.len = 0
        self.apos = 0
        self.rg = -1
        self.name = b""
        self.mate_flags = 0
        self.mate_ref_id = -1
        self.mate_pos = 0
        self.tlen = INT64_MIN
        self.explicit_tlen = INT64_MIN
        self.mate_line = -1
        self.aux = b""
        self.cigar: List[int] = []
        self.mqual = 0
        self.seq = b""
        self.qual = b""
        self.aend = 0


def decode_slice(hdr: CompressionHeader, sh: SliceHeader,
                 blocks: List[CramBlock], header: SamHeader,
                 get_ref, vmajor: int, decode_md: bool = True,
                 required_fields: int = 0) -> List[BamRecord]:
    """cram_decode_slice (cram_decode.c:2346).  required_fields (SAM_*
    bits, 0 = everything) prunes gated series: their blocks are not even
    uncompressed (cram_dependent_data_series, cram_decode.c:553); fields
    not requested carry unspecified values."""
    act = _active_series(hdr, required_fields)
    if act is None:
        act_keys, aux_values, needed_ids = None, True, None
    else:
        act_keys, aux_values, needed_ids = act

    def on(key: str) -> bool:
        return act_keys is None or key in act_keys

    core = b""
    ext: Dict[int, bytes] = {}
    for b in blocks:
        if b.content_type == CT_CORE:
            core = b.uncompress()
        elif b.content_type == CT_EXTERNAL:
            if (needed_ids is None or b.content_id in needed_ids
                    or b.content_id == sh.ref_base_id):
                ext[b.content_id] = b.uncompress()
    st = SliceStreams(core, ext)
    cs = hdr.codecs

    # reference window for this slice
    ref = None
    ref_start = sh.ref_seq_start  # 1-based
    if sh.ref_seq_id >= 0 and not hdr.no_ref:
        if sh.ref_base_id >= 0:
            for b in blocks:
                if b.content_id == sh.ref_base_id:
                    ref = b.uncompress()
                    break
        else:
            ref = get_ref(sh.ref_seq_id, sh.ref_seq_start,
                          sh.ref_seq_start + sh.ref_seq_span - 1)
        # slice MD5 check (cram_decode.c:2481-2540; zero digest = skip)
        if ref is not None and sh.md5 != b"\0" * 16:
            import hashlib
            window = ref[:sh.ref_seq_span]
            if hashlib.md5(window).digest() != sh.md5:
                raise IOError(
                    f"MD5 checksum reference mismatch at "
                    f"#{sh.ref_seq_id}:{sh.ref_seq_start}-"
                    f"{sh.ref_seq_start + sh.ref_seq_span - 1}; "
                    "please check the reference given is correct")

    # native fast path (htstpu_cram_decode_slice): CRAM v3, no pruning,
    # single-ref/unmapped/no-ref slices; bails back here on anything exotic
    if act is None and vmajor == 3 and sh.ref_seq_id != -2:
        res = _native_decode_slice(hdr, sh, blocks, header, ref, ref_start,
                                   decode_md)
        if res is not None:
            return res

    recs: List[CramRecordTmp] = []
    last_apos = sh.ref_seq_start
    rg_names = [ln.get("ID") for ln in header.lines if ln.type == "RG"]
    multi_ref_cache: Dict[int, bytes] = {}

    def codec(key: str) -> Codec:
        c = cs.get(key)
        if c is None:
            raise IOError(f"CRAM: missing codec for data series {key}")
        return c

    for rec_i in range(sh.num_records):
        cr = CramRecordTmp()
        cr.flags = codec("BF").read_int(st)
        cr.cram_flags = codec("CF").read_int(st) if "CF" in cs else 0
        cf = cr.cram_flags
        if sh.ref_seq_id == -2:
            cr.ref_id = codec("RI").read_int(st) if "RI" in cs else -1
        else:
            cr.ref_id = sh.ref_seq_id
        cr.len = codec("RL").read_int(st) if "RL" in cs else 0
        apos = codec("AP").read_int(st) if "AP" in cs else sh.ref_seq_start
        if hdr.AP_delta:
            apos += last_apos
        last_apos = apos
        cr.apos = apos
        if "RG" in cs:
            cr.rg = codec("RG").read_int(st)
            if cr.rg == -1 or cr.rg >= len(rg_names):
                cr.rg = -1
        if hdr.read_names_included and "RN" in cs and on("RN"):
            cr.name = codec("RN").read_array(st)
        if cf & CRAM_FLAG_DETACHED:
            cr.mate_flags = codec("MF").read_int(st) if "MF" in cs else 0
            if not hdr.read_names_included and "RN" in cs and on("RN"):
                cr.name = codec("RN").read_array(st)
            if "NS" in cs:
                cr.mate_ref_id = codec("NS").read_int(st)
            if "NP" in cs:
                cr.mate_pos = codec("NP").read_int(st)
            if "TS" in cs:
                cr.tlen = codec("TS").read_int(st)
            else:
                cr.tlen = INT64_MIN
        elif cf & CRAM_FLAG_MATE_DOWNSTREAM:
            if "NF" in cs:
                cr.mate_line = codec("NF").read_int(st) + rec_i + 1
            cr.tlen = INT64_MIN
            if cf & CRAM_FLAG_EXPLICIT_TLEN and "TS" in cs:
                cr.explicit_tlen = codec("TS").read_int(st)
        elif cf & CRAM_FLAG_EXPLICIT_TLEN:
            if "TS" in cs:
                cr.explicit_tlen = codec("TS").read_int(st)
        # aux tags
        has_MD, has_NM = _decode_aux(hdr, st, cr, rg_names,
                                     values=aux_values)
        # per-record reference (multiref slices)
        rref = ref
        rref_start = ref_start
        if sh.ref_seq_id == -2 and cr.ref_id >= 0 and not hdr.no_ref:
            if cr.ref_id not in multi_ref_cache:
                multi_ref_cache[cr.ref_id] = get_ref(cr.ref_id, 1, -1)
            rref = multi_ref_cache[cr.ref_id]
            rref_start = 1
        if not (cr.flags & FUNMAP) and on("FN"):
            _decode_seq(hdr, st, cr, rref, rref_start, header, cf,
                        vmajor, has_MD, has_NM,
                        # CRAM <4: decode_md is off/on; CRAM 4: auto — only
                        # '*' placeholder tags trigger generation
                        # (cram_decode.c:1114-1117)
                        decode_md and vmajor < 4, qs_on=on("QS"))
        elif not (cr.flags & FUNMAP):
            # features pruned: the structure fields are unspecified, but
            # MQ (always on) still reads its stream
            cr.cigar = []
            cr.aend = cr.apos
            cr.mqual = cs["MQ"].read_int(st) if "MQ" in cs else 40
            cr.seq = b""
            cr.qual = b""
            cr.len = 0
        else:
            cr.cigar = []
            cr.aend = cr.apos
            cr.mqual = 0
            if "BA" in cs and cr.len and on("BA"):
                cr.seq = codec("BA").read_bytes(st, cr.len)
            if cf & CRAM_FLAG_PRESERVE_QUAL_SCORES:
                if "QS" in cs and cr.len >= 0 and on("QS"):
                    cr.qual = codec("QS").read_bytes(st, cr.len)
            else:
                cr.qual = b"\xff" * cr.len
            if not cr.seq:
                cr.qual = b""
                cr.len = 0
        if (not hdr.qs_seq_orient and (cr.flags & FREVERSE) and cr.qual):
            cr.qual = cr.qual[::-1]
        recs.append(cr)

    _slice_xref(recs)
    return _to_bam(recs, sh, header, rg_names)


def _native_payloads(blocks: List[CramBlock]):
    """(content types, content ids, uncompressed payloads) of a slice's
    CORE and EXTERNAL blocks, in block order: the native decoder's
    input."""
    payloads = []
    ctypes_list = []
    cids = []
    for b in blocks:
        if b.content_type in (CT_CORE, CT_EXTERNAL):
            payloads.append(b.uncompress())
            ctypes_list.append(b.content_type)
            cids.append(b.content_id)
    return ctypes_list, cids, payloads


def _native_decode_slice(hdr: CompressionHeader, sh: SliceHeader,
                         blocks: List[CramBlock], header: SamHeader,
                         ref: Optional[bytes], ref_start: int,
                         decode_md: bool) -> Optional[List[BamRecord]]:
    """Try the C++ slice decoder (native/src/htstpu.cc
    htstpu_cram_decode_slice).  Returns None when unavailable or when the
    native side bails (unsupported codec/configuration) — the caller then
    runs the Python decoder on the same (immutable) inputs."""
    from htslib_tpu_torch.native import native
    if native is None or hdr.raw is None:
        return None
    ctypes_list, cids, payloads = _native_payloads(blocks)
    rg_names = [ln.get("ID") for ln in header.lines if ln.type == "RG"]
    blob = native.cram_decode_slice(
        hdr.raw, sh.ref_seq_id, sh.ref_seq_start, sh.ref_seq_span,
        sh.num_records, sh.record_counter, ctypes_list, cids, payloads,
        None if hdr.no_ref else ref, ref_start,
        header.tid2len(sh.ref_seq_id), rg_names, decode_md)
    if blob is None:
        return None
    out: List[BamRecord] = []
    mv = memoryview(blob)
    p = 0
    n = len(mv)
    while p + 4 <= n:
        bsz = int.from_bytes(mv[p:p + 4], "little")
        out.append(BamRecord.from_bam_buffer(mv, p + 4, bsz))
        p += 4 + bsz
    if p != n or len(out) != sh.num_records:
        return None
    return out


def decode_slice_blob(hdr: CompressionHeader, sh: SliceHeader,
                      blocks: List[CramBlock], header: SamHeader,
                      get_ref, vmajor: int, decode_md: bool = True,
                      ) -> bytes:
    """One slice as a blob of BAM records, each framed by its u32 length:
    the batch form of decode_slice, which SAM formatting takes whole
    (ops/bam2sam.py).  A CRAM 3 slice that is not multi-reference goes
    to the native slice decoder, whose blob is passed through untouched;
    where the native library is off or bails, the Python record decoder
    runs and its records are serialised."""
    ref = None
    ref_start = sh.ref_seq_start
    if sh.ref_seq_id >= 0 and not hdr.no_ref:
        if sh.ref_base_id >= 0:
            for b in blocks:
                if b.content_id == sh.ref_base_id:
                    ref = b.uncompress()
                    break
        else:
            ref = get_ref(sh.ref_seq_id, sh.ref_seq_start,
                          sh.ref_seq_start + sh.ref_seq_span - 1)
        if ref is not None and sh.md5 != b"\0" * 16:
            import hashlib
            if hashlib.md5(ref[:sh.ref_seq_span]).digest() != sh.md5:
                raise IOError("MD5 checksum reference mismatch at "
                              f"#{sh.ref_seq_id}:{sh.ref_seq_start}")
    from htslib_tpu_torch.native import native
    if (native is not None and vmajor == 3 and sh.ref_seq_id != -2
            and hdr.raw is not None):
        ctypes_list, cids, payloads = _native_payloads(blocks)
        rg_names = [ln.get("ID") for ln in header.lines
                    if ln.type == "RG"]
        blob = native.cram_decode_slice(
            hdr.raw, sh.ref_seq_id, sh.ref_seq_start, sh.ref_seq_span,
            sh.num_records, sh.record_counter, ctypes_list, cids, payloads,
            None if hdr.no_ref else ref, ref_start,
            header.tid2len(sh.ref_seq_id), rg_names, decode_md)
        if blob is not None:
            return bytes(blob)
    parts = []
    for rec in decode_slice(hdr, sh, blocks, header, get_ref, vmajor,
                            decode_md=decode_md):
        buf = rec.to_bam_buffer()
        parts.append(struct.pack("<I", len(buf)) + buf)
    return b"".join(parts)


def _decode_aux(hdr: CompressionHeader, st: SliceStreams,
                cr: CramRecordTmp, rg_names=(),
                values: bool = True) -> Tuple[int, int]:
    """cram_decode_aux (cram_decode.c:976).  Returns (has_MD, has_NM);
    -1 means a CRAM 4 '*' placeholder tag forcing auto-generation
    (cram_decode.c:2045-2087).  With values=False (required-fields
    pruning) the TL series is still read but no tag stream is."""
    if "TL" not in hdr.codecs:
        return 0, 0
    TL = hdr.codecs["TL"].read_int(st)
    if TL < 0 or TL >= len(hdr.TD):
        raise IOError("CRAM: invalid TL")
    TN = hdr.TD[TL]
    if not values:
        tags = [TN[i:i + 2] for i in range(0, len(TN), 3)]
        cr.aux = b""
        return int(b"MD" in tags), int(b"NM" in tags)
    aux = bytearray()
    has_MD = has_NM = 0
    for i in range(0, len(TN), 3):
        tag = TN[i:i + 3]
        if tag[2:3] == b"*":
            # CRAM 4 auto-tag placeholders: values are regenerated by the
            # decoder, nothing is read from the tag streams
            if tag[:2] == b"MD":
                has_MD = -1
            elif tag[:2] == b"NM":
                has_NM = -1
            elif tag[:2] == b"RG":
                if 0 <= cr.rg < len(rg_names) and rg_names[cr.rg]:
                    aux += b"RGZ" + rg_names[cr.rg].encode() + b"\x00"
                    cr.rg = -1
            continue
        if tag[:2] == b"MD":
            has_MD = 1
        elif tag[:2] == b"NM":
            has_NM = 1
        kid = (tag[0] << 16) | (tag[1] << 8) | tag[2]
        codec = hdr.tag_codecs.get(kid)
        if codec is None:
            raise IOError(f"CRAM: no codec for tag {tag!r}")
        try:
            val = codec.read_array(st)
        except IOError:
            sz = _AUX_SIZE.get(tag[2], 0)
            if sz == 0:
                raise
            val = codec.read_bytes(st, sz)
        if tag[:2] == b"cF" and len(val) == 1:
            continue  # cF control tag is consumed, not emitted
        aux += tag + val
    cr.aux = bytes(aux)
    return has_MD, has_NM


def _decode_seq(hdr: CompressionHeader, st: SliceStreams, cr: CramRecordTmp,
                ref: Optional[bytes], ref_start: int, header: SamHeader,
                cf: int, vmajor: int, has_MD: int = 0, has_NM: int = 0,
                decode_md: bool = True, qs_on: bool = True) -> None:
    """cram_decode_seq (cram_decode.c:1096) — feature playback, including
    MD/NM auto-generation (hts_hopen enables CRAM_OPT_DECODE_MD auto,
    hts.c:1584)."""
    cs = hdr.codecs
    seq = bytearray(b"=" * cr.len if ref is None else b"\x00" * cr.len)
    qual = bytearray(b"\xff" * cr.len)
    ref_len = header.tid2len(cr.ref_id)

    # has_MD/has_NM < 0 are CRAM 4 '*' placeholders forcing generation
    # (cram_decode.c:1114-1120: (do_md && !has_MD) || has_MD < 0)
    gen_md = (((decode_md and not has_MD) or has_MD < 0)
              and ref is not None and cr.ref_id >= 0
              and not (cr.cram_flags & CRAM_FLAG_NO_SEQ))
    gen_nm = (((decode_md and not has_NM) or has_NM < 0)
              and ref is not None and cr.ref_id >= 0
              and not (cr.cram_flags & CRAM_FLAG_NO_SEQ))
    md_parts: List[bytes] = []
    md_dist = 0
    nm = 0

    def md_char(c: int) -> None:
        """add_md_char: flush distance then a ref char."""
        nonlocal md_dist
        if md_dist >= 0 and gen_md:
            md_parts.append(str(md_dist).encode())
            md_parts.append(bytes([c]))
        md_dist = 0

    def md_match_frag(frag: bytes) -> None:
        """advance over matching bases, treating ref 'N' as mismatch."""
        nonlocal md_dist, nm
        if not (gen_md or gen_nm) or md_dist < 0:
            return
        for c in frag:
            if c == 0x4E:  # 'N'
                md_char(c)
                nm += 1
            else:
                md_dist += 1

    fn = cs["FN"].read_int(st) if "FN" in cs else 0
    cigar: List[int] = []
    cig_op = BAM_CMATCH
    cig_len = 0
    seq_pos = 1
    ref_pos = cr.apos - 1  # 0-based
    prev_pos = 0

    def ref_at(rp: int, ln: int) -> bytes:
        """ref bases [rp, rp+ln) 0-based genome coords."""
        s = rp - (ref_start - 1)
        chunk = ref[s:s + ln]
        if len(chunk) < ln:
            chunk = chunk + b"N" * (ln - len(chunk))
        return chunk

    def flush(op):
        nonlocal cig_op, cig_len
        if cig_len and cig_op != op:
            cigar.append((cig_len << 4) | cig_op)
            cig_len = 0
        cig_op = op

    for f in range(fn):
        op = chr(cs["FC"].read_byte(st)) if "FC" in cs else "B"
        pos = cs["FP"].read_int(st) + prev_pos if "FP" in cs else 0
        if pos <= 0:
            raise IOError("CRAM: feature position before start of read")
        if pos > seq_pos:
            if ref is not None and cr.ref_id >= 0:
                frag = ref_at(ref_pos, pos - seq_pos)
                if ref_len and ref_pos + pos - seq_pos > ref_len:
                    avail = max(ref_len - ref_pos, 0)
                    frag = frag[:avail] + b"N" * (pos - seq_pos - avail)
                    if md_dist >= 0:
                        md_dist += pos - seq_pos
                else:
                    md_match_frag(frag)
                if cr.len:
                    seq[seq_pos - 1:pos - 1] = frag
            flush(BAM_CMATCH)
            cig_len += pos - seq_pos
            ref_pos += pos - seq_pos
            seq_pos = pos
        prev_pos = pos

        if op == "S":
            flush(BAM_CSOFT_CLIP)
            if "SC" in cs:
                data = cs["SC"].read_array(st)
                if cr.len:
                    seq[pos - 1:pos - 1 + len(data)] = data
                cigar.append((len(data) << 4) | BAM_CSOFT_CLIP)
                cig_op = BAM_CSOFT_CLIP
                cig_len = 0
                seq_pos += len(data)
        elif op == "X":
            flush(BAM_CMATCH)
            if "BS" in cs:
                code = cs["BS"].read_byte(st)
                if cr.ref_id < 0 or ref is None or ref_pos >= (ref_len or 1 << 62):
                    base_row = hdr.sub_matrix[4]
                    if md_dist >= 0 and gen_md:
                        md_parts.append(str(md_dist).encode())
                    md_dist = -1
                else:
                    rc = ref_at(ref_pos, 1)[0]
                    base_row = hdr.sub_matrix[l1(rc)]
                    md_char(rc)
                    nm += 1
                if pos - 1 < cr.len:
                    seq[pos - 1] = base_row[code]
            cig_len += 1
            seq_pos += 1
            ref_pos += 1
        elif op == "D":
            flush(BAM_CDEL)
            n = cs["DL"].read_int(st) if "DL" in cs else 0
            if (gen_md or gen_nm) and n:
                if md_dist >= 0 and gen_md:
                    md_parts.append(str(md_dist).encode())
                if not ref_len or ref_pos + n <= ref_len:
                    if gen_md:
                        md_parts.append(b"^" + ref_at(ref_pos, n))
                        md_dist = 0
                    nm += n
                else:
                    avail = max(ref_len - ref_pos, 0)
                    if gen_md and avail > 0:
                        md_parts.append(b"^" + ref_at(ref_pos, avail) + b"0")
                        nm += avail
                    md_dist = -1
            cig_len += n
            ref_pos += n
        elif op == "I":
            flush(BAM_CINS)
            if "IN" in cs:
                data = cs["IN"].read_array(st)
                if cr.len:
                    seq[pos - 1:pos - 1 + len(data)] = data
                cig_len += len(data)
                seq_pos += len(data)
                nm += len(data)
        elif op == "i":
            flush(BAM_CINS)
            if "BA" in cs:
                b = cs["BA"].read_byte(st)
                if cr.len:
                    seq[pos - 1] = b
            cig_len += 1
            seq_pos += 1
            nm += 1
        elif op == "b":
            flush(BAM_CMATCH)
            n = cr.len - (pos - 1) if cr.len else 1
            if "BB" in cs:
                data = cs["BB"].read_array(st)
                n = len(data)
                if cr.len:
                    seq[pos - 1:pos - 1 + n] = data
                if gen_md or gen_nm:
                    # every stored base treated as a mismatch vs ref
                    # (cram_decode.c:1505)
                    if md_dist >= 0 and gen_md:
                        md_parts.append(str(md_dist).encode())
                    x = 0
                    for x in range(n):
                        if x and gen_md:
                            md_parts.append(b"0")
                        if (ref_len and ref_pos + x >= ref_len) or ref is None:
                            md_dist = -1
                            break
                        if gen_md:
                            md_parts.append(ref_at(ref_pos + x, 1))
                    else:
                        x = n
                    nm += x
                    md_dist = 0
            cig_len += n
            seq_pos += n
            ref_pos += n
        elif op == "q":
            flush(BAM_CMATCH)
            if "QQ" in cs:
                data = cs["QQ"].read_array(st)
                if cr.len:
                    qual[pos - 1:pos - 1 + len(data)] = data
        elif op == "B":
            flush(BAM_CMATCH)
            if "BA" in cs:
                b = cs["BA"].read_byte(st)
                if cr.len:
                    seq[pos - 1] = b
                if gen_md or gen_nm:
                    if md_dist >= 0 and gen_md:
                        md_parts.append(str(md_dist).encode())
                    if (ref_len and ref_pos >= ref_len) or ref is None:
                        md_dist = -1
                    else:
                        if gen_md:
                            md_parts.append(ref_at(ref_pos, 1))
                        nm += 1
                        md_dist = 0
            if "QS" in cs and qs_on:
                q = cs["QS"].read_byte(st)
                if not (cf & CRAM_FLAG_PRESERVE_QUAL_SCORES) and cr.len > 0 \
                        and qual[0] == 0xFF:
                    qual[:] = b"\x1e" * cr.len
                if cr.len:
                    qual[pos - 1] = q
            cig_len += 1
            seq_pos += 1
            ref_pos += 1
        elif op == "Q":
            if "QS" in cs and qs_on:
                q = cs["QS"].read_byte(st)
                if not (cf & CRAM_FLAG_PRESERVE_QUAL_SCORES) and cr.len > 0 \
                        and qual[0] == 0xFF:
                    qual[:] = b"\x1e" * cr.len
                if cr.len:
                    qual[pos - 1] = q
        elif op == "H":
            flush(BAM_CHARD_CLIP)
            if "HC" in cs:
                n = cs["HC"].read_int(st)
                cig_len += n
        elif op == "P":
            flush(BAM_CPAD)
            if "PD" in cs:
                n = cs["PD"].read_int(st)
                cig_len += n
        elif op == "N":
            flush(BAM_CREF_SKIP)
            if "RS" in cs:
                n = cs["RS"].read_int(st)
                cig_len += n
                ref_pos += n
        else:
            raise IOError(f"CRAM: unknown feature code {op!r}")

    # implicit trailing match
    if cr.len >= seq_pos:
        if ref is not None and cr.ref_id >= 0:
            remainder = cr.len - seq_pos + 1
            frag = ref_at(ref_pos, remainder)
            if ref_len and ref_pos + remainder > ref_len:
                avail = max(ref_len - ref_pos, 0)
                frag = frag[:avail] + b"N" * (remainder - avail)
                if md_dist >= 0:
                    md_dist += remainder
            else:
                md_match_frag(frag)
            seq[seq_pos - 1:cr.len] = frag
            ref_pos += remainder
        elif cr.ref_id >= 0:
            ref_pos += cr.len - seq_pos + 1
        flush(BAM_CMATCH)
        cig_len += cr.len - seq_pos + 1
    if (gen_md) and md_dist >= 0:
        md_parts.append(str(md_dist).encode())
    if cig_len:
        cigar.append((cig_len << 4) | cig_op)
    cr.cigar = cigar
    cr.aend = max(ref_pos, cr.apos)
    cr.mqual = cs["MQ"].read_int(st) if "MQ" in cs else 40
    if cf & CRAM_FLAG_PRESERVE_QUAL_SCORES and "QS" in cs and qs_on:
        qual = bytearray(cs["QS"].read_bytes(st, cr.len))
    if cr.cram_flags & CRAM_FLAG_NO_SEQ:
        cr.len = 0
        seq = bytearray()
        qual = bytearray()
    cr.seq = bytes(seq)
    cr.qual = bytes(qual)
    # append generated MD/NM to the aux blob (cram_decode.c:1846-1906)
    if gen_md:
        cr.aux += b"MDZ" + b"".join(md_parts) + b"\x00"
    if gen_nm:
        if nm <= 0xFF:
            cr.aux += b"NMC" + bytes([nm])
        elif nm <= 0xFFFF:
            cr.aux += b"NMS" + struct.pack("<H", nm)
        else:
            cr.aux += b"NMI" + struct.pack("<I", nm)


def _slice_xref(recs: List[CramRecordTmp]) -> None:
    """cram_decode_slice_xref (cram_decode.c:2140)."""
    n = len(recs)
    for i, cr in enumerate(recs):
        if cr.mate_line >= 0:
            if cr.mate_line >= n:
                raise IOError("CRAM: mate line out of bounds")
            if cr.tlen == INT64_MIN:
                id1 = id2 = i
                aleft, aright = cr.apos, cr.aend
                ref = cr.ref_id
                left_cnt = right_cnt = 0
                while True:
                    if aleft > recs[id2].apos:
                        aleft, left_cnt = recs[id2].apos, 1
                    elif aleft == recs[id2].apos:
                        left_cnt += 1
                    if aright < recs[id2].aend:
                        aright, right_cnt = recs[id2].aend, 1
                    elif aright == recs[id2].aend:
                        right_cnt += 1
                    if recs[id2].mate_line == -1:
                        recs[id2].mate_line = i
                        break
                    if recs[id2].mate_line <= id2 or recs[id2].mate_line >= n:
                        raise IOError("CRAM: bad mate chain")
                    id2 = recs[id2].mate_line
                    if recs[id2].ref_id != ref:
                        ref = -1
                    if id2 == id1:
                        break
                if ref != -1:
                    tlen = aright - aleft + 1
                    id2 = i
                    r0 = recs[id2]
                    if r0.apos == aleft and (r0.aend < aright or left_cnt <= 1):
                        r0.tlen = tlen
                        tlen = -tlen
                    elif (r0.apos == aleft and r0.aend == aright
                          and left_cnt > 1 and right_cnt > 1):
                        if r0.flags & 0x40:  # FREAD1
                            r0.tlen = tlen
                            tlen = -tlen
                        else:
                            r0.tlen = -tlen
                    else:
                        r0.tlen = -tlen
                    id2 = r0.mate_line
                    while id2 != i:
                        recs[id2].tlen = tlen
                        id2 = recs[id2].mate_line
                else:
                    id2 = i
                    recs[id2].tlen = 0
                    id2 = recs[id2].mate_line
                    while id2 != i:
                        recs[id2].tlen = 0
                        id2 = recs[id2].mate_line
            mate = recs[cr.mate_line]
            cr.mate_pos = mate.apos
            cr.mate_ref_id = mate.ref_id
            cr.flags |= FPAIRED
            if mate.flags & FUNMAP:
                cr.flags |= FMUNMAP
                cr.tlen = 0
            if cr.flags & FUNMAP:
                cr.tlen = 0
            if mate.flags & FREVERSE:
                cr.flags |= FMREVERSE
        else:
            if cr.mate_flags & CRAM_M_REVERSE:
                cr.flags |= FPAIRED | FMREVERSE
            if cr.mate_flags & CRAM_M_UNMAP:
                cr.flags |= FMUNMAP
            if not (cr.flags & FPAIRED):
                cr.mate_ref_id = -1
        if cr.tlen == INT64_MIN:
            cr.tlen = 0
    for cr in recs:
        if cr.explicit_tlen != INT64_MIN:
            cr.tlen = cr.explicit_tlen


def _to_bam(recs: List[CramRecordTmp], sh: SliceHeader, header: SamHeader,
            rg_names: List[Optional[str]], prefix: str = "?",
            ) -> List[BamRecord]:
    """cram_to_bam (cram_decode.c:3100)."""
    out = []
    for i, cr in enumerate(recs):
        b = BamRecord()
        if cr.name:
            b.qname = cr.name
        elif (cr.mate_line >= 0 and cr.mate_line < len(recs)
                and recs[cr.mate_line].name):
            b.qname = recs[cr.mate_line].name
        else:
            mate_i = cr.mate_line if 0 <= cr.mate_line < i else i
            b.qname = f"{prefix}:{sh.record_counter + mate_i + 1}".encode()
        b.flag = cr.flags
        b.tid = cr.ref_id
        b.pos = cr.apos - 1
        b.mapq = cr.mqual
        b.cigar = np.array(cr.cigar, np.uint32)
        b.mtid = cr.mate_ref_id
        b.mpos = cr.mate_pos - 1
        b.isize = cr.tlen
        b.set_seq(cr.seq.decode("latin-1") if cr.seq else "*", None)
        if cr.len:
            b.qual = cr.qual
        b.aux = cr.aux
        if cr.rg >= 0 and rg_names[cr.rg] is not None:
            b.aux += b"RGZ" + rg_names[cr.rg].encode() + b"\x00"
        rlen = cigar2rlen(b.cigar) if not (b.flag & FUNMAP) else 0
        b.bin = reg2bin(b.pos, b.pos + (rlen if rlen else 1))
        b._tag2cigar()
        out.append(b)
    return out
