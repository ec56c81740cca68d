"""CRAM encoder (the port's copy of the Python path of
htslib_tpu/cram/encode.py; reference cram/cram_encode.c:4042
cram_put_bam_seq, :3382 process_one_read, :1843 cram_encode_container).

Records are planned into containers of slices; each slice's data series
are built record by record into EXTERNAL streams (matches implicit
against a reference where one is given, else every base in the BB/IN/SC
byte arrays), and each stream's block method is chosen by trial
(`CodecMetrics`: rANS 4x8 of both orders, GZIP, RAW, and for CRAM 3.1
rANS Nx16 and its PACK transform, with FQZ and the name tokeniser as
challengers).  Every codec is the port's own host codec, so the bytes
are those of the JAX encoder with its native library off (its native
encoder writes other, equally valid, bytes).  Containers are built and
written in order in the calling thread, which writes the bytes of the
JAX encoder at any `nthreads`.  With `write_index` each slice gets its
CRAI entry as its container is written, and the `.crai` is saved at
close; with `device_profile` (CRAM 3.1) quality blocks are pinned to a
32-way rANS Nx16 wire that the port's quality lane decodes on the device.
"""
from __future__ import annotations

import bz2
import hashlib
import lzma
import os
import struct
import zlib
from collections import defaultdict
from typing import BinaryIO, Dict, List, Optional, Tuple, Union

import numpy as np

from htslib_tpu_torch.codecs import arith, fqzcomp, rans4x8, rans4x16, tok3
from htslib_tpu_torch.cram.index import CraiEntry, CramIndex
from htslib_tpu_torch.cram.refs import RefRegistry
from htslib_tpu_torch.cram.structs import (
    ARITH, BZIP2, CRAM_FLAG_DETACHED, CRAM_FLAG_MATE_DOWNSTREAM,
    CRAM_FLAG_NO_SEQ, CRAM_FLAG_PRESERVE_QUAL_SCORES, CRAM_M_REVERSE,
    CRAM_M_UNMAP, CT_COMPRESSION_HEADER, CT_CORE, CT_EXTERNAL,
    CT_FILE_HEADER, CT_MAPPED_SLICE, E_BYTE_ARRAY_LEN, E_BYTE_ARRAY_STOP,
    E_EXTERNAL, E_VARINT_SIGNED, E_VARINT_UNSIGNED, FQZ, GZIP, LZMA, RANS,
    RANSPR, RAW, TOK3, l1)
from htslib_tpu_torch.cram.v4 import VarintVec, varint_vec
from htslib_tpu_torch.hfile import hopen
from htslib_tpu_torch.sam.cigar import (BAM_CDEL, BAM_CHARD_CLIP, BAM_CINS,
                                        BAM_CPAD, BAM_CREF_SKIP,
                                        BAM_CSOFT_CLIP, cigar2qlen,
                                        cigar2rlen)
from htslib_tpu_torch.sam.header import SamHeader
from htslib_tpu_torch.sam.record import (FMREVERSE, FMUNMAP, FPAIRED,
                                         FREVERSE, FSECONDARY,
                                         FSUPPLEMENTARY, FUNMAP, BamRecord)

# data series -> (content id, kind);  kind: int (ITF8) / byte / bytes
SERIES = {
    "BF": 1, "CF": 2, "RI": 3, "RL": 4, "AP": 5, "RG": 6, "MF": 7,
    "NS": 8, "NP": 9, "TS": 10, "TL": 11, "FN": 12, "FC": 13, "FP": 14,
    "DL": 15, "BA": 16, "BS": 17, "MQ": 18, "QS": 19, "IN": 20, "RN": 21,
    "SC": 22, "HC": 23, "PD": 24, "RS": 25, "BB": 26, "NF": 28,
}
# BB length sub-stream: its own external block, like the reference's
# DS_BB_len (cram_structs.h:189, cram_encode.c:2322)
BB_LEN_CID = 27
TAG_ID_BASE = 0x100000


def _enc_encoding_external(cid: int, vv: VarintVec) -> bytes:
    params = vv.put32(cid)
    return vv.put32(E_EXTERNAL) + vv.put32(len(params)) + params


def _enc_encoding_varint(cid: int, vv: VarintVec, signed: bool) -> bytes:
    """CRAM 4 VARINT_{UN,}SIGNED encoding declaration: content id +
    offset 0 (cram_varint_decode_init, cram_codecs.c:760)."""
    params = vv.put32(cid) + vv.put64s(0)
    eid = E_VARINT_SIGNED if signed else E_VARINT_UNSIGNED
    return vv.put32(eid) + vv.put32(len(params)) + params


def _enc_encoding_byte_array_stop(stop: int, cid: int, vv: VarintVec) -> bytes:
    params = bytes([stop]) + vv.put32(cid)
    return vv.put32(E_BYTE_ARRAY_STOP) + vv.put32(len(params)) + params


def _enc_encoding_byte_array_len(cid: int, vv: VarintVec,
                                 len_cid: Optional[int] = None) -> bytes:
    # CRAM 4 forbids EXTERNAL for integers (cram_external_encode_init,
    # cram_codecs.c:597): the length sub-encoding becomes VARINT_UNSIGNED.
    # len_cid defaults to the value stream (lengths interleaved with the
    # bytes, as the reference does for aux tags); pass a distinct id for
    # split streams like BB/DS_BB_len (cram_encode.c:2322).
    if len_cid is None:
        len_cid = cid
    if vv.v4:
        inner = (_enc_encoding_varint(len_cid, vv, False)
                 + _enc_encoding_external(cid, vv))
    else:
        inner = (_enc_encoding_external(len_cid, vv)
                 + _enc_encoding_external(cid, vv))
    return vv.put32(E_BYTE_ARRAY_LEN) + vv.put32(len(inner)) + inner


class _Stream:
    """One data-series byte stream; integer writes follow the file
    version's varint vtable (ITF8 for CRAM <4, uint7/sint7 for CRAM 4)."""
    __slots__ = ("buf", "vv")

    def __init__(self, vv: VarintVec):
        self.buf = bytearray()
        self.vv = vv

    def vint(self, v: int):
        self.buf += self.vv.put32(v)

    def vints(self, v: int):
        self.buf += self.vv.put32s(v)

    def byte(self, v: int):
        self.buf.append(v & 0xFF)

    def raw(self, b: bytes):
        self.buf += b


def _fqz_compress(data: bytes, lens) -> bytes:
    return fqzcomp.compress(data, list(lens))


def _device_qs(data: bytes, method: int, comp: bytes) -> Tuple[int, bytes]:
    """A QS block pinned to a device-decodable 32-way rANS Nx16 wire:
    order 0, or order 1 where it is at least 3% smaller (its device
    decode is slower than order 0's, so a marginal size win is not worth
    it).  Keeps (method, comp) where order 0 cannot encode the block."""
    try:
        comp = rans4x16.compress(data, 0x04)
    except (ValueError, ZeroDivisionError):
        return method, comp
    try:
        c1 = rans4x16.compress(data, 0x05)
        if len(c1) < 0.97 * len(comp):
            comp = c1
    except (ValueError, ZeroDivisionError):
        pass
    return RANSPR, comp


def _ref_extents(recs) -> Dict[int, Tuple[int, int]]:
    """tid -> (first 1-based position, last end) over a multi-ref slice's
    records (a RawRun's columns or BamRecords)."""
    by_ref: Dict[int, Tuple[int, int]] = {}
    if isinstance(recs, RawRun):
        rows = zip(recs.tids.tolist(), recs.poss.tolist(),
                   recs.ends.tolist())
    else:
        rows = ((r.tid, r.pos, r.endpos()) for r in recs)
    for tid, pos, end in rows:
        lo, hi = by_ref.get(tid, (1 << 62, -1))
        by_ref[tid] = (min(lo, pos + 1), max(hi, end))
    return by_ref


def _tok3_encode(data: bytes) -> bytes:
    return tok3.encode_names(data.split(b"\0")[:-1])


def _gzip_compress(data: bytes, level: int = 6) -> bytes:
    """GZIP block method (cram/cram_io.c:1604): zlib with a gzip wrapper."""
    co = zlib.compressobj(min(level, 9), zlib.DEFLATED, 31)
    return co.compress(data) + co.flush()


# reference meth_cost values by block method id (cram_io.c:2115-2153)
_METHOD_COST = {0: 1.0, 1: 1.04, 2: 1.07, 3: 1.08, 4: 1.0, 5: 1.005,
                6: 1.04, 7: 1.05, 8: 1.05}


class RawRun:
    """A run of records for the file-level encode (cram/batch.py
    bam_to_cram_file): a u32-framed BAM record stream shared by every run,
    each record's frame offset and size, and its tid, pos and end as
    numpy columns, which the container planner reads; the slice encoder
    materialises the records."""

    __slots__ = ("data", "offs", "sizes", "tids", "poss", "ends")

    def __init__(self, data, offs, sizes, tids, poss, ends):
        self.data = data          # the WHOLE record stream (shared)
        self.offs = offs          # np.int64 absolute frame offsets
        self.sizes = sizes
        self.tids = tids
        self.poss = poss
        self.ends = ends

    def __len__(self):
        return len(self.offs)

    def __getitem__(self, key):
        if not isinstance(key, slice):
            raise TypeError("RawRun supports slicing only")
        return RawRun(self.data, self.offs[key], self.sizes[key],
                      self.tids[key], self.poss[key], self.ends[key])

    def materialize(self):
        out = []
        for i in range(len(self.offs)):
            o = int(self.offs[i])
            out.append(BamRecord.from_bam_buffer(
                self.data[o + 4:o + int(self.sizes[i])]))
        return out


class CodecMetrics:
    """Online per-data-series codec selection (the cram_metrics model,
    cram/cram_structs.h:284-305 + cram_compress_block3 trials,
    cram_io.c:1912-2160): every TRIAL_EVERY containers each candidate
    method is tried on the series' block and the cost-weighted winner is
    cached for the following containers."""

    TRIAL_EVERY = 32
    CANDIDATES = ("rans0", "rans1", "gzip", "raw")
    CANDIDATES_V31 = CANDIDATES + ("r16o0", "r16o1", "r16pack")

    def __init__(self, v31: bool = False, use_bz2: bool = False,
                 use_arith: bool = False, level: int = 6,
                 use_lzma: bool = False):
        self.best: Dict[int, str] = {}
        self.count: Dict[int, int] = defaultdict(int)
        self.level = level
        cands = self.CANDIDATES_V31 if v31 else self.CANDIDATES
        if v31 and use_arith:
            cands = cands + ("arith1",)
        if use_bz2:
            cands = cands + ("bzip2",)
        if use_lzma:
            cands = cands + ("lzma",)
        self.candidates = cands

    TRIAL_SAMPLE = 1 << 18   # trial candidates on at most 256 KiB

    def choose(self, cid: int, data: bytes) -> Tuple[int, bytes]:
        n = self.count[cid]
        self.count[cid] += 1
        if len(data) < 64:
            return RAW, data
        if cid in self.best and n % self.TRIAL_EVERY:
            return self._apply(self.best[cid], data)
        # candidate trial round.  Large blocks are sampled: every
        # candidate runs on a prefix and only the cost-weighted winner
        # compresses the full series (bounds the 8-candidate trial cost
        # that cram_compress_block3 pays on whole blocks,
        # cram_io.c:1912-2160)
        sampled = len(data) > self.TRIAL_SAMPLE
        probe = bytes(data[:self.TRIAL_SAMPLE]) if sampled else data
        sizes = {}
        outs = {}
        for cand in self.candidates:
            m, comp = self._apply(cand, probe)
            # the reference's relative method costs (meth_cost,
            # cram_io.c:2115-2153)
            weight = {"raw": 1.0, "rans0": 1.0, "rans1": 1.01,
                      "gzip": 1.04, "r16o0": 1.0, "r16o1": 1.01,
                      "r16pack": 1.01, "arith1": 1.04,
                      "bzip2": 1.07, "lzma": 1.08}[cand]
            sizes[cand] = len(comp) * weight
            outs[cand] = (m, comp)
        winner = min(sizes, key=sizes.get)
        self.best[cid] = winner
        if sampled:
            return self._apply(winner, data)
        return outs[winner]

    def _apply(self, cand: str, data: bytes) -> Tuple[int, bytes]:
        if cand == "raw":
            return RAW, data
        if cand == "gzip":
            return GZIP, _gzip_compress(data, self.level)
        if cand == "bzip2":
            return BZIP2, bz2.compress(data, 9)
        if cand == "lzma":
            return LZMA, lzma.compress(data, format=lzma.FORMAT_XZ)
        if cand.startswith("r16"):
            fl = {"r16o0": 0, "r16o1": 1, "r16pack": 0x81}[cand]
            try:
                return RANSPR, rans4x16.compress(data, fl)
            except (ValueError, ZeroDivisionError):
                return RAW, data
        if cand.startswith("arith"):
            try:
                return ARITH, arith.compress(data, 1)
            except (ValueError, ZeroDivisionError):
                return RAW, data
        order = 0 if cand == "rans0" else 1
        try:
            return RANS, rans4x8.compress(data, order)
        except (ValueError, ZeroDivisionError):
            return RAW, data


def _write_block(out: bytearray, method: int, content_type: int,
                 content_id: int, data: bytes,
                 precompressed: Optional[bytes] = None,
                 vv: Optional[VarintVec] = None) -> None:
    if vv is None:
        vv = varint_vec(3)
    if precompressed is not None:
        comp = precompressed
    elif method == GZIP:
        comp = _gzip_compress(data)
    else:
        comp = data
    hdr = bytes([method, content_type]) + vv.put32(content_id) \
        + vv.put32(len(comp)) + vv.put32(len(data))
    crc = zlib.crc32(hdr + comp) & 0xFFFFFFFF
    out += hdr
    out += comp
    out += struct.pack("<I", crc)


_CONS_CODE = np.full(256, 4, np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CONS_CODE[_b] = _i
    _CONS_CODE[_b + 32] = _i
_CONS_BASE = np.frombuffer(b"ACGTN", np.uint8)


def _consensus_reference(recs: List[BamRecord], start: int,
                         wend: int) -> bytes:
    """Majority-vote consensus over the slice window from the reads'
    aligned bases (cram_generate_reference, cram_encode.c:1730);
    uncovered positions become N."""
    L = wend - start + 1
    counts = np.zeros((5, L), np.int32)
    for rec in recs:
        if rec.tid < 0 or (rec.flag & FUNMAP) or not rec.l_qseq:
            continue
        seq = np.frombuffer(rec.seq.encode(), np.uint8)
        qpos = 0
        rpos = rec.pos + 1  # 1-based
        for c in rec.cigar:
            op = int(c) & 0xF
            ln = int(c) >> 4
            if op in (0, 7, 8):
                off = rpos - start
                lo = max(0, -off)
                hi = min(ln, L - off)
                if hi > lo:
                    codes = _CONS_CODE[seq[qpos + lo:qpos + hi]]
                    np.add.at(counts, (codes, off + np.arange(lo, hi)), 1)
                qpos += ln
                rpos += ln
            elif op in (1, 4):
                qpos += ln
            elif op in (2, 3):
                rpos += ln
    best = counts.argmax(axis=0)
    best[counts.max(axis=0) == 0] = 4
    return _CONS_BASE[best].tobytes()


class CramEncoder:
    def __init__(self, dst: Union[str, BinaryIO], header: SamHeader,
                 ref: Optional[str] = None, seqs_per_slice: int = 10000,
                 version: Tuple[int, int] = (3, 0), embed_ref: int = 0,
                 nthreads: Optional[int] = None,
                 lossy_names: int = 0, write_index: bool = False,
                 slices_per_container: int = 1,
                 device_profile: bool = False,
                 profile: Optional[str] = None):
        self.fp = hopen(dst, "wb") if isinstance(dst, str) else dst
        # codec enables follow the reference defaults (cram_io.c:5370):
        # name tokeniser on for >= 3.1, fqzcomp/arith/bz2 off until a
        # profile turns them on
        self.use_tok = version >= (3, 1)
        self.use_fqz = False
        self._use_bz2 = False
        self._use_arith = False
        self._archive = False
        self._level = 6
        # pin the QS series to 32-way rANS Nx16 (a valid 3.1 wire that any
        # decoder reads) so the device quality lane decodes it
        # (ops/device_stats.py)
        self.device_profile = device_profile
        # the JAX encoder's container threads (cram_flush_container_mt);
        # the port builds containers in order, with the same bytes
        self.nthreads = nthreads
        # on-the-fly .crai (cram_index_slice, cram_index.c:695)
        self.index_entries: Optional[List[CraiEntry]] = (
            [] if write_index else None)
        self.index_path = (dst + ".crai" if write_index
                           and isinstance(dst, str) else None)
        self.header = header
        self.refs = None
        if ref is not None:
            self.refs = RefRegistry(header, fasta=ref)
            # Annotate @SQ with M5 (+UR) like the reference does when
            # writing CRAM against a fasta (cram/cram_io.c:2892
            # refs2id/cram_ref_write path via sam_hdr_update_line), so
            # any decoder can resolve the reference by MD5 through
            # REF_PATH/REF_CACHE.
            self.header = header = header.copy()
            for line in header.lines:
                if line.type != "SQ" or line.get("M5") is not None:
                    continue
                name = line.get("SN")
                tid = header.name2tid(name) if name else -1
                if tid < 0:
                    continue
                try:
                    seq = self.refs.get(tid, 1, -1)
                except Exception:
                    continue
                line.set("M5", hashlib.md5(seq).hexdigest())
                if isinstance(ref, str) and line.get("UR") is None:
                    line.set("UR", os.path.abspath(ref))
            header._dirty = True
        self.version = version
        self.seqs_per_slice = seqs_per_slice
        # CRAM_OPT_SLICES_PER_CONTAINER (cram_io.c:5852 option handling)
        self.slices_per_container = max(1, slices_per_container)
        # CRAM_OPT_EMBED_REF: carry the reference window as an extra
        # external block so slices decode without the fasta
        self.embed_ref = embed_ref
        # CRAM_OPT_LOSSY_NAMES: drop read names for mate-linked pairs;
        # the decoder synthesizes prefix:counter names (cram_decode.c
        # cram_to_bam nameless path)
        self.lossy_names = lossy_names
        self.queue: List[BamRecord] = []
        self.record_counter = 0
        self.metrics = CodecMetrics(v31=version >= (3, 1),
                                    use_bz2=self._use_bz2,
                                    use_arith=self._use_arith,
                                    level=self._level)
        if profile is not None:
            self.set_profile(profile)
        # challenger-codec trial cache (FQZ on QS, TOK3 on RN): like
        # cram_metrics, the expensive candidate is re-tried only every
        # TRIAL_EVERY containers and the winner is reused in between
        # (cram_compress_block3's periodic revised trials,
        # cram_io.c:2137-2153)
        self._challenger: Dict[str, Dict[str, object]] = {
            "fqz": {"n": 0, "use": None},
            "tok3": {"n": 0, "use": None},
        }
        self.vv = varint_vec(version[0])
        self.v4 = version[0] >= 4
        self._write_file_def()
        self._write_header_container()

    # ------------------------------------------------------------------
    def set_profile(self, profile: str) -> None:
        """CRAM_OPT_PROFILE (cram_io.c:5915-5946): fast/normal/small/
        archive adjust the gzip level, the enabled codecs (bz2, fqz,
        arith, name tokeniser) and the default slice size."""
        if profile == "normal":
            return
        self._archive = profile == "archive"
        if profile == "fast":
            self._level = 1
            self.use_tok = False
        elif profile == "small":
            self._level = 6
            self._use_bz2 = True
            self.use_fqz = True
            if self.seqs_per_slice == 10000:
                self.seqs_per_slice = 25000
        elif profile == "archive":
            self._level = 7
            self._use_bz2 = True
            self.use_fqz = True
            self._use_arith = True
            if self.seqs_per_slice == 10000:
                self.seqs_per_slice = 100000
        else:
            raise ValueError(f"unknown CRAM profile {profile!r}")
        self._rebuild_metrics()

    def set_level(self, level: int) -> None:
        """CRAM_OPT_COMPRESSION_LEVEL: gzip block level (and, past 7,
        the lzma enable in the reference; we cap at libdeflate 12)."""
        self._level = max(1, min(int(level), 12))
        self._rebuild_metrics()

    def _rebuild_metrics(self) -> None:
        # archive at level > 7 also enables lzma (cram_io.c:5938)
        self.metrics = CodecMetrics(v31=self.version >= (3, 1),
                                    use_bz2=self._use_bz2,
                                    use_arith=self._use_arith,
                                    level=self._level,
                                    use_lzma=self._archive
                                    and self._level > 7)

    def _write_file_def(self):
        self.fp.write(b"CRAM" + bytes(self.version) + b"htslib_tpu".ljust(20, b"\0"))

    def _container(self, blocks_payload: bytes, ref_id: int, start: int,
                   span: int, nrec: int, nbases: int, nblocks: int,
                   landmarks: List[int], counter: Optional[int] = None,
                   ) -> bytes:
        vv = self.vv
        head = bytearray()
        head += vv.put32s(ref_id)
        if self.v4:
            head += vv.put64(start)
            head += vv.put64(span)
        else:
            head += vv.put32(start)
            head += vv.put32(span)
        head += vv.put32(nrec)
        head += vv.put64(self.record_counter if counter is None
                         else counter)
        head += vv.put64(nbases)
        head += vv.put32(nblocks)
        head += vv.put32(len(landmarks))
        for lm in landmarks:
            head += vv.put32(lm)
        if self.v4:
            # CRAM 4 frames the length itself as a varint; the CRC covers
            # every header byte (cram_io.c:3818-3825 varint_decode32_crc)
            full = vv.put32(len(blocks_payload)) + bytes(head)
            crc = zlib.crc32(full) & 0xFFFFFFFF
            return full + struct.pack("<I", crc) + blocks_payload
        # CRC covers the 4-byte length + header varints (cram_io.c:3816)
        crc = zlib.crc32(struct.pack("<i", len(blocks_payload)) + bytes(head)) & 0xFFFFFFFF
        return (struct.pack("<i", len(blocks_payload)) + bytes(head)
                + struct.pack("<I", crc) + blocks_payload)

    def _write_header_container(self):
        text = self.header.full_text_with_refs().encode()
        payload = struct.pack("<i", len(text)) + text
        # pad generously (cram_io.c writes a blank-padded header block)
        payload += b"\0" * 1024
        blocks = bytearray()
        _write_block(blocks, RAW, CT_FILE_HEADER, 0, payload, vv=self.vv)
        cont = self._container(bytes(blocks), 0, 0, 0, 0, 0, 1, [0])
        self.fp.write(cont)

    # ------------------------------------------------------------------
    def write(self, rec: BamRecord) -> None:
        self.queue.append(rec)
        if len(self.queue) >= self.seqs_per_slice * self.slices_per_container:
            self.flush()

    def flush(self) -> None:
        if not self.queue:
            return
        recs = self.queue
        self.queue = []
        if self.embed_ref:
            # embedded references require single-ref slices: split into
            # per-tid container runs (htslib disables multi_seq when
            # embedding, cram_encode.c embed_ref handling)
            run: List[BamRecord] = []
            for rec in recs:
                if run and rec.tid != run[-1].tid:
                    self._write_data_container(run)
                    self.record_counter += len(run)
                    run = []
                run.append(rec)
            if run:
                self._write_data_container(run)
                self.record_counter += len(run)
        else:
            self._write_data_container(recs)
            self.record_counter += len(recs)

    # ------------------------------------------------------------------
    def _write_data_container(self, recs: List[BamRecord]) -> None:
        """Encode and write one container, and add its slices' CRAI
        entries at its file offset."""
        cont, entries = self._build_container(recs, self.record_counter)
        cpos = self.fp.tell() if self.index_entries is not None else 0
        self.fp.write(cont)
        if self.index_entries is not None:
            for tid, start, span, lm, ssize in entries:
                self.index_entries.append(
                    CraiEntry(tid, start, span, cpos, lm, ssize))

    def _build_container(self, recs: List[BamRecord], counter0: int):
        """One container = one or more slices (CRAM_OPT_SLICES_PER_
        CONTAINER; cram_encode_container, cram_encode.c:1843): a shared
        compression header, then per-slice header+core+external blocks
        at the landmark offsets.  Returns (its bytes, its slices' CRAI
        entries (tid, start, span, landmark, size), relative to the
        container)."""
        n = max(1, self.seqs_per_slice)
        if self.slices_per_container > 1 and len(recs) > n:
            groups = [recs[i:i + n] for i in range(0, len(recs), n)]
        else:
            groups = [recs]
        plans = [self._slice_ref_plan(g) for g in groups]
        # the RR preservation bit is container-wide: if any mapped slice
        # cannot fetch its reference, the whole container goes no-ref
        if any(p["fetch_failed"] for p in plans):
            for p in plans:
                p["use_ref"] = False
                p["ref_seq"] = None
                p["mref_cache"] = {}
                p["ref_md5"] = b"\0" * 16
        use_ref_any = any(p["use_ref"] for p in plans)

        tag_dict: List[bytes] = []
        tag_lines: Dict[bytes, int] = {}
        used_tags: Dict[int, bytes] = {}
        slices = []
        all_cids: set = set()
        any_multiref = any(p["multiref"] for p in plans)
        counter = counter0
        total_bases = 0
        for g, p in zip(groups, plans):
            s = self._encode_slice(g, p, tag_dict, tag_lines, used_tags,
                                   counter)
            counter += len(g)
            total_bases += s["nbases"]
            all_cids |= s["cids"]
            slices.append(s)

        comp_hdr = self._compression_header(tag_dict, sorted(used_tags),
                                            any_multiref, all_cids,
                                            no_ref=not use_ref_any)
        blocks = bytearray()
        _write_block(blocks, RAW, CT_COMPRESSION_HEADER, 0, comp_hdr,
                     vv=self.vv)
        landmarks = []
        for s in slices:
            landmarks.append(len(blocks))
            blocks += s["blocks"]

        # container summary ref fields
        srefs = {p["slice_ref"] for p in plans}
        if len(srefs) == 1 and not any_multiref:
            c_ref = srefs.pop()
            if c_ref >= 0:
                c_start = min(p["start"] for p in plans)
                c_span = max(p["start"] + p["span"] for p in plans) - c_start
            else:
                c_start = c_span = 0
        else:
            c_ref, c_start, c_span = -2, 0, 0

        nblocks = 1 + sum(s["nblocks"] for s in slices)
        cont = self._container(bytes(blocks), c_ref, c_start, c_span,
                               len(recs), total_bases, nblocks, landmarks,
                               counter=counter0)
        entries = []
        if self.index_entries is not None:
            for lm, s, g, p in zip(landmarks, slices, groups, plans):
                ssize = len(s["blocks"])
                if p["multiref"]:
                    # per-refid extents (cram_index_build_multiref)
                    for tid, (lo, hi) in _ref_extents(g).items():
                        entries.append((-1, 0, 0, lm, ssize) if tid < 0
                                       else (tid, lo, hi - lo + 1, lm,
                                             ssize))
                elif p["slice_ref"] < 0:
                    entries.append((-1, 0, 0, lm, ssize))
                else:
                    entries.append((p["slice_ref"], p["start"], s["span"],
                                    lm, ssize))
        return cont, entries
    # ------------------------------------------------------------------
    def _slice_ref_plan(self, recs: List[BamRecord]) -> dict:
        """Per-slice reference window decision (the front of
        cram_encode_container): single- vs multi-ref, fetched window or
        generated consensus, MD5."""
        if isinstance(recs, RawRun):
            ref_ids = set(int(t) for t in np.unique(recs.tids))
            mapped = recs.tids >= 0
            mapped_pos = (recs.poss[mapped] + 1).tolist() \
                if mapped.any() else []
        else:
            ref_ids = {r.tid for r in recs}
            mapped_pos = [r.pos + 1 for r in recs if r.tid >= 0]
        multiref = len(ref_ids) > 1
        slice_ref = -2 if multiref else next(iter(ref_ids))
        start = min(mapped_pos) if (not multiref and slice_ref >= 0) else 0
        plan = {"multiref": multiref, "slice_ref": slice_ref,
                "start": start, "span": 0, "ref_seq": None,
                "ref_md5": b"\0" * 16, "ref_span": 0,
                "mref_cache": {}, "use_ref": False, "fetch_failed": False}
        use_ref = (self.refs is not None and (multiref or slice_ref >= 0))
        if use_ref and not multiref:
            start = max(start, 1)
            if isinstance(recs, RawRun):
                m = recs.tids >= 0
                wend = int(recs.ends[m].max()) if m.any() else start
            else:
                wend = max((r.endpos() for r in recs if r.tid >= 0),
                           default=start)
            wend = max(wend, start)
            try:
                ref_seq = self.refs.get(slice_ref, start, wend)
            except Exception:
                plan["fetch_failed"] = True
            else:
                plan.update(start=start, ref_seq=ref_seq, use_ref=True,
                            ref_md5=hashlib.md5(ref_seq).digest(),
                            ref_span=wend - start + 1)
        elif use_ref:
            cache = {}
            for tid in sorted(t for t in ref_ids if t >= 0):
                try:
                    cache[tid] = self.refs.get(tid, 1, -1)
                except Exception:
                    plan["fetch_failed"] = True
                    cache = {}
                    break
            else:
                plan.update(mref_cache=cache, use_ref=True)
        elif (self.embed_ref == 2 and not multiref and slice_ref >= 0
              and mapped_pos):
            # no external reference: majority-vote consensus embedded
            # (cram_generate_reference, cram_encode.c:1730)
            start = max(start, 1)
            wend = max((r.endpos() for r in recs if r.tid >= 0),
                       default=start)
            wend = max(wend, start)
            ref_seq = _consensus_reference(recs, start, wend)
            plan.update(start=start, ref_seq=ref_seq, use_ref=True,
                        ref_md5=hashlib.md5(ref_seq).digest(),
                        ref_span=wend - start + 1)
        return plan

    def _encode_slice(self, recs: List[BamRecord], plan: dict,
                      tag_dict: List[bytes], tag_lines: Dict[bytes, int],
                      used_tags: Dict[int, bytes],
                      record_counter: int) -> dict:
        """Build one slice's data series streams and emit its header +
        core + external blocks (cram_encode_slice, cram_encode.c:1096)."""
        streams: Dict[int, _Stream] = defaultdict(lambda: _Stream(self.vv))
        multiref = plan["multiref"]
        slice_ref = plan["slice_ref"]
        start = plan["start"]
        use_ref = plan["use_ref"]
        ref_seq = plan["ref_seq"]
        mref_cache = plan["mref_cache"]
        end = 0
        nbases = 0

        def S(key) -> _Stream:
            return streams[SERIES[key] if isinstance(key, str) else key]

        # the slice encoder reads whole records: a RawRun is materialised
        if isinstance(recs, RawRun):
            recs = recs.materialize()

        # mate linkage pre-pass: pair primary paired reads by qname and
        # keep the link only when the decoder xref reproduces them
        link = [-1] * len(recs)
        linked_down = [False] * len(recs)
        pending: Dict[bytes, int] = {}
        for i, rec in enumerate(recs):
            if (not rec.flag & FPAIRED
                    or rec.flag & (FSECONDARY | FSUPPLEMENTARY)):
                continue
            j = pending.pop(rec.qname, None)
            if j is None:
                pending[rec.qname] = i
            elif self._mate_link_ok(recs[j], rec):
                link[j] = i
                linked_down[i] = True

        # CRAM 4 always delta-encodes AP (cram_encode.c:2203 pos_sorted ||
        # MAJOR_VERS >= 4); the decoder's accumulator starts at the slice
        # ref_seq_start (cram_decode.c last_apos init)
        ap_delta = self.v4
        last_pos = (start if (not multiref and slice_ref >= 0) else 0) \
            if ap_delta else 0

        qs_lens = []
        for i, rec in enumerate(recs):
            nbases += rec.l_qseq
            cf = CRAM_FLAG_PRESERVE_QUAL_SCORES
            if link[i] >= 0:
                cf |= CRAM_FLAG_MATE_DOWNSTREAM
            elif not linked_down[i]:
                cf |= CRAM_FLAG_DETACHED
            # seq "*": RL carries the CIGAR-implied query length and QS
            # carries 0xFF quals of that length; NO_SEQ makes the decoder
            # reset len to 0 afterwards (cram_encode.c:3766 fake_qual)
            qlen = rec.l_qseq
            if qlen == 0:
                cf |= CRAM_FLAG_NO_SEQ
                if not (rec.flag & FUNMAP) and len(rec.cigar):
                    qlen = cigar2qlen(rec.cigar)
            S("BF").vint(rec.flag)
            S("CF").vint(cf)
            if multiref:
                S("RI").vints(rec.tid)
            S("RL").vint(qlen)
            if ap_delta:
                S("AP").vints(rec.pos + 1 - last_pos)
                last_pos = rec.pos + 1
            else:
                S("AP").vint(rec.pos + 1)
            # RG kept as an ordinary stored tag (preserves tag order);
            # the RG series carries -1 so the decoder adds no duplicate
            S("RG").vints(-1)
            # names (RN, stop byte 0); with lossy_names only detached
            # records keep theirs (cram_encode.c lossy read-name mode)
            if not self.lossy_names:
                S("RN").raw(rec.qname + b"\0")
            if cf & CRAM_FLAG_DETACHED:
                # detached mate info
                mf = 0
                if rec.flag & FMREVERSE:
                    mf |= CRAM_M_REVERSE
                if rec.flag & FMUNMAP:
                    mf |= CRAM_M_UNMAP
                S("MF").vint(mf)
                if self.lossy_names:
                    # names kept only for detached records, in the
                    # decoder's MF->RN->NS read order
                    S("RN").raw(rec.qname + b"\0")
                S("NS").vints(rec.mtid)
                S("NP").vint(rec.mpos + 1)
                S("TS").vints(rec.isize)
            elif cf & CRAM_FLAG_MATE_DOWNSTREAM:
                S("NF").vint(link[i] - i - 1)
            # aux tags
            line, vals = self._encode_tags(rec)
            tl = tag_lines.get(line)
            if tl is None:
                tl = len(tag_dict)
                tag_lines[line] = tl
                tag_dict.append(line)
            S("TL").vint(tl)
            for kid, val in vals:
                used_tags[kid] = b""
                st = streams[TAG_ID_BASE + kid]
                st.vint(len(val))
                st.raw(val)
            if not (rec.flag & FUNMAP):
                if multiref and use_ref:
                    self._encode_features(rec, S,
                                          mref_cache.get(rec.tid), 1)
                else:
                    self._encode_features(rec, S, ref_seq, start)
                if rec.tid == slice_ref or not multiref:
                    end = max(end, rec.endpos())
            else:
                if rec.l_qseq:
                    S("BA").raw(rec.seq.encode())
            # quals last (decode order: features -> MQ -> QS)
            if rec.l_qseq:
                S("QS").raw(rec.qual)
                qs_lens.append(len(rec.qual))
            elif qlen:
                S("QS").raw(b"\xff" * qlen)
                qs_lens.append(qlen)

        return self._emit_slice_tail(
            {cid: bytes(st.buf) for cid, st in streams.items()},
            qs_lens, len(recs), plan, record_counter, nbases, end)

    # ------------------------------------------------------------------
    def _emit_slice_tail(self, stream_bytes: Dict[int, bytes], qs_lens,
                         n_recs: int, plan: dict, record_counter: int,
                         nbases: int, end: int) -> dict:
        """Slice header + core + external block emission (cram_encode_slice
        tail, cram_encode.c:1096)."""
        multiref = plan["multiref"]
        slice_ref = plan["slice_ref"]
        start = plan["start"]
        use_ref = plan["use_ref"]
        ref_seq = plan["ref_seq"]
        span = max(end - start + 1, 0) \
            if (not multiref and slice_ref >= 0) else 0
        if use_ref and not multiref:
            span = max(span, plan["ref_span"])
        ext_ids = sorted(stream_bytes.keys())
        embed = (self.embed_ref and use_ref and not multiref
                 and ref_seq is not None)
        EMBED_REF_ID = 100  # clear of series ids, below TAG_ID_BASE
        all_ids = ext_ids + ([EMBED_REF_ID] if embed else [])
        vv = self.vv
        slice_hdr = bytearray()
        slice_hdr += vv.put32s(slice_ref)
        if self.v4:
            slice_hdr += vv.put64(start if slice_ref >= 0 else 0)
            slice_hdr += vv.put64(span)
        else:
            slice_hdr += vv.put32(start if slice_ref >= 0 else 0)
            slice_hdr += vv.put32(span)
        slice_hdr += vv.put32(n_recs)
        slice_hdr += vv.put64(record_counter)
        slice_hdr += vv.put32(1 + len(all_ids))  # core + externals
        slice_hdr += vv.put32(len(all_ids))
        for cid in all_ids:
            slice_hdr += vv.put32(cid)
        # ref_base_id is written with the unsigned put (cram_encode.c:551
        # varint_put32), so -1 goes on the wire as 0xFFFFFFFF under CRAM 4
        slice_hdr += vv.put32(EMBED_REF_ID if embed
                              else (0xFFFFFFFF if self.v4 else -1))
        slice_hdr += plan["ref_md5"]

        blocks = bytearray()
        _write_block(blocks, RAW, CT_MAPPED_SLICE, 0, bytes(slice_hdr),
                     vv=vv)
        _write_block(blocks, RAW, CT_CORE, 0, b"", vv=vv)
        for cid in ext_ids:
            data = stream_bytes[cid]
            method, comp = self.metrics.choose(cid, data)
            if (self.device_profile and self.version >= (3, 1)
                    and cid == SERIES["QS"] and len(data) >= 64):
                method, comp = _device_qs(data, method, comp)
            elif (self.use_fqz and self.version >= (3, 1)
                    and cid == SERIES["QS"]
                    and len(data) >= 512 and sum(qs_lens) == len(data)):
                # fqzcomp quality model (FQZ, cram_io.c:1821; meth_cost
                # 1.05, cram_io.c:2115)
                method, comp = self._challenge(
                    "fqz", lambda: _fqz_compress(data, qs_lens), 1.05,
                    method, comp, FQZ)
            if (self.use_tok and self.version >= (3, 1)
                    and cid == SERIES["RN"] and len(data) >= 64):
                # name tokeniser for the read-name series (TOK3)
                method, comp = self._challenge(
                    "tok3", lambda: _tok3_encode(data), 1.05, method, comp,
                    TOK3)
            _write_block(blocks, method, CT_EXTERNAL, cid, data,
                         precompressed=comp if method != RAW else None,
                         vv=vv)
        if embed:
            method, comp = self.metrics.choose(EMBED_REF_ID, ref_seq)
            _write_block(blocks, method, CT_EXTERNAL, EMBED_REF_ID, ref_seq,
                         precompressed=comp if method != RAW else None,
                         vv=vv)
        return {"blocks": bytes(blocks), "nbases": nbases,
                "cids": set(stream_bytes.keys()),
                "nblocks": 2 + len(all_ids), "span": span}

    def _challenge(self, kind: str, make, weight: float, method: int,
                   comp: bytes, new_method: int) -> Tuple[int, bytes]:
        """A challenger codec against the metrics winner (method, comp):
        tried every TRIAL_EVERY blocks of its kind, its verdict reused in
        between (cram_compress_block3's periodic revised trials,
        cram_io.c:2137-2153).  Returns the (method, bytes) to write."""
        st = self._challenger[kind]
        n = st["n"]
        st["n"] = n + 1
        trial = st["use"] is None or n % CodecMetrics.TRIAL_EVERY == 0
        use = st["use"]
        if not (trial or use):
            return method, comp
        try:
            c = make()
        except ValueError:
            return method, comp
        wins = len(c) * weight < len(comp) * _METHOD_COST.get(method, 1.0)
        if trial:
            st["use"] = wins
        if wins or (use and not trial):
            return new_method, c
        return method, comp

    # ------------------------------------------------------------------
    @staticmethod
    def _mate_link_ok(a: BamRecord, b: BamRecord) -> bool:
        """Link a -> b (b downstream in the same slice) only when the
        decoder's cross-reference (cram_decode_slice_xref,
        cram_decode.c:2140) would reconstruct both records' mate fields,
        flags, and tlen exactly as stored.  Self-validating equivalent of
        process_one_read's mate matching (cram_encode.c:3382)."""
        def apos(r):
            return r.pos + 1

        def aend(r):
            if r.flag & FUNMAP:
                return apos(r)
            rl = cigar2rlen(r.cigar)
            return apos(r) + rl - 1 if rl > 0 else apos(r)

        aleft = min(apos(a), apos(b))
        aright = max(aend(a), aend(b))
        left_cnt = sum(1 for r in (a, b) if apos(r) == aleft)
        right_cnt = sum(1 for r in (a, b) if aend(r) == aright)
        if a.tid != b.tid:
            tlen_a = tlen_b = 0
        else:
            tlen = aright - aleft + 1
            if apos(a) == aleft and (aend(a) < aright or left_cnt <= 1):
                tlen_a, tlen_b = tlen, -tlen
            elif (apos(a) == aleft and aend(a) == aright
                  and left_cnt > 1 and right_cnt > 1):
                tlen_a, tlen_b = (tlen, -tlen) if a.flag & 0x40 \
                    else (-tlen, tlen)
            else:
                tlen_a, tlen_b = -tlen, tlen
        for x, y, tl in ((a, b, tlen_a), (b, a, tlen_b)):
            fl = x.flag | FPAIRED
            if y.flag & FUNMAP:
                fl |= FMUNMAP
                tl = 0
            if x.flag & FUNMAP:
                tl = 0
            if y.flag & FREVERSE:
                fl |= FMREVERSE
            if (fl != x.flag or y.tid != x.mtid or y.pos != x.mpos
                    or tl != x.isize):
                return False
        return True

    # ------------------------------------------------------------------
    def _encode_tags(self, rec: BamRecord) -> Tuple[bytes, List[Tuple[int, bytes]]]:
        """Returns (TD line, [(tag_key_int, value_bytes)]).  RG is carried
        via the RG series, not as a tag (cram_encode.c drops it)."""
        line = bytearray()
        vals: List[Tuple[int, bytes]] = []
        for tag, t, _ in rec.aux_items():
            start, p, tbyte = rec._aux_find(tag)
            endv = rec._skip_aux_value(p, tbyte)
            key3 = tag + t.encode()
            kid = (key3[0] << 16) | (key3[1] << 8) | key3[2]
            line += key3
            vals.append((kid, rec.aux[p:endv]))
        return bytes(line), vals

    def _encode_features(self, rec: BamRecord, S,
                         ref_seq: Optional[bytes] = None,
                         ref_start: int = 0) -> None:
        """Feature extraction (process_one_read, cram_encode.c:3382).

        No-ref mode carries M/=/X runs as BB byte arrays; reference mode
        leaves matches implicit and emits X (substitution-code) features
        for single-base mismatches, falling back to B (literal base +
        qual) where the substitution matrix cannot express the base or
        the position is outside the reference window."""
        seq = rec.seq.encode() if rec.l_qseq else b""
        quals = rec.qual
        feats: List[Tuple[int, str]] = []  # (qpos 1-based, code)
        payload: List[Tuple[str, object]] = []
        qpos = 1
        rpos = rec.pos  # 0-based genome coordinate
        sub_rows = {0: b"CGTN", 1: b"AGTN", 2: b"ACTN", 3: b"ACGN",
                    4: b"ACGT"}
        for c in rec.cigar:
            op = int(c) & 0xF
            ln = int(c) >> 4
            if op in (0, 7, 8) and not seq:
                # seq "*": match runs carry no features; the decoder
                # rebuilds the CIGAR from the gaps between features
                # (process_one_read "Seq '*'" branch, cram_encode.c:3628)
                rpos += ln
                qpos += ln
            elif op in (0, 7, 8) and ref_seq is not None:  # M/=/X vs ref
                for i in range(ln):
                    r = rpos + i - (ref_start - 1)
                    b = seq[qpos - 1 + i] if seq else 0
                    rb = ref_seq[r] if 0 <= r < len(ref_seq) else None
                    if rb is not None and rb == b:
                        continue  # implicit match
                    row = sub_rows[l1(rb)] if rb is not None else None
                    if row is not None and b in row:
                        payload.append(("X", row.index(b)))
                        feats.append((qpos + i, "X"))
                    else:
                        q = quals[qpos - 1 + i] if qpos - 1 + i < len(quals) else 0xFF
                        payload.append(("B", (b if b else 0x4E, q)))
                        feats.append((qpos + i, "B"))
                rpos += ln
                qpos += ln
            elif op in (0, 7, 8):  # M/=/X, no-ref: whole run as bases
                payload.append(("b", seq[qpos - 1:qpos - 1 + ln] if seq
                                else b"\0" * ln))
                feats.append((qpos, "b"))
                rpos += ln
                qpos += ln
            elif op == BAM_CINS:
                # seq "*": 'N' placeholder bases (cram_add_insertion
                # NULL-base branch, cram_encode.c:2759)
                payload.append(("I", seq[qpos - 1:qpos - 1 + ln] if seq
                                else b"N" * ln))
                feats.append((qpos, "I"))
                qpos += ln
            elif op == BAM_CSOFT_CLIP:
                payload.append(("S", seq[qpos - 1:qpos - 1 + ln] if seq
                                else b"N" * ln))
                feats.append((qpos, "S"))
                qpos += ln
            elif op == BAM_CDEL:
                payload.append(("D", ln))
                feats.append((qpos, "D"))
                rpos += ln
            elif op == BAM_CREF_SKIP:
                payload.append(("N", ln))
                feats.append((qpos, "N"))
                rpos += ln
            elif op == BAM_CHARD_CLIP:
                payload.append(("H", ln))
                feats.append((qpos, "H"))
            elif op == BAM_CPAD:
                payload.append(("P", ln))
                feats.append((qpos, "P"))
        S("FN").vint(len(feats))
        prev = 0
        for (fpos, code), (code2, data) in zip(feats, payload):
            S("FC").byte(ord(code))
            S("FP").vint(fpos - prev)
            prev = fpos
            if code == "b":
                # split length/value streams (DS_BB_len + DS_BB)
                S(BB_LEN_CID).vint(len(data))
                S("BB").raw(data)
            elif code == "I":
                # nul-terminated (byte_array_stop, cram_encode.c:2427)
                st = S("IN")
                st.raw(data)
                st.byte(0)
            elif code == "S":
                st = S("SC")
                st.raw(data)
                st.byte(0)
            elif code == "X":
                S("BS").byte(data)
            elif code == "B":
                S("BA").byte(data[0])
                S("QS").byte(data[1])
            elif code == "D":
                S("DL").vint(data)
            elif code == "N":
                S("RS").vint(data)
            elif code == "H":
                S("HC").vint(data)
            elif code == "P":
                S("PD").vint(data)
        S("MQ").vint(rec.mapq)

    # ------------------------------------------------------------------
    # data series carried as raw bytes (EXTERNAL under every version);
    # the rest are integers (EXTERNAL+ITF8 for CRAM <4, VARINT for CRAM 4)
    _BYTE_SERIES = {"FC", "BS", "BA", "QS"}
    # integer series that can go negative and need VARINT_SIGNED in CRAM 4
    _SIGNED_SERIES = {"RI", "AP", "RG", "NS", "TS"}

    def _compression_header(self, tag_dict: List[bytes],
                            used_tag_ids: List[int], multiref: bool,
                            used_cids: set, no_ref: bool = True) -> bytes:
        vv = self.vv
        # preservation map
        pres = bytearray()
        n = 0
        for key, val in (("RN", 0 if self.lossy_names else 1),
                         ("AP", 1 if self.v4 else 0),
                         ("RR", 0 if no_ref else 1)):
            pres += key.encode() + bytes([val])
            n += 1
        pres += b"SM" + bytes([0x1B] * 5)
        n += 1
        td_blob = b"".join(line + b"\0" for line in tag_dict)
        pres += b"TD" + vv.put32(len(td_blob)) + td_blob
        n += 1
        pres_full = vv.put32(n) + bytes(pres)
        out = bytearray()
        out += vv.put32(len(pres_full)) + pres_full
        # data series encodings
        ds = bytearray()
        nds = 0
        for key, cid in SERIES.items():
            if cid not in used_cids:
                continue
            if key in ("RN", "IN", "SC"):
                # nul-terminated byte arrays, matching the reference's
                # choice for these series (cram_encode.c:2398-2430,2439)
                enc = _enc_encoding_byte_array_stop(0, cid, vv)
            elif key == "BB":
                enc = _enc_encoding_byte_array_len(cid, vv,
                                                   len_cid=BB_LEN_CID)
            elif self.v4 and key not in self._BYTE_SERIES:
                enc = _enc_encoding_varint(cid, vv,
                                           key in self._SIGNED_SERIES)
            else:
                enc = _enc_encoding_external(cid, vv)
            ds += key.encode() + enc
            nds += 1
        ds_full = vv.put32(nds) + bytes(ds)
        out += vv.put32(len(ds_full)) + ds_full
        # tag encodings
        te = bytearray()
        nte = 0
        for kid in used_tag_ids:
            te += vv.put32(kid)
            te += _enc_encoding_byte_array_len(TAG_ID_BASE + kid, vv)
            nte += 1
        te_full = vv.put32(nte) + bytes(te)
        out += vv.put32(len(te_full)) + te_full
        return bytes(out)

    # ------------------------------------------------------------------
    def close(self) -> None:
        self.flush()
        self._write_eof()
        self.fp.flush()
        self.fp.close()
        if self.index_entries is not None and self.index_path:
            CramIndex(self.index_entries).save(self.index_path)

    def _write_eof(self):
        blocks = bytearray()
        # minimal empty compression header block ("01 00" x3 under every
        # version: uint7 and ITF8 agree on 0 and 1)
        vv = self.vv
        empty = (vv.put32(1) + vv.put32(0)
                 + vv.put32(1) + vv.put32(0)
                 + vv.put32(1) + vv.put32(0))
        _write_block(blocks, RAW, CT_COMPRESSION_HEADER, 0, empty, vv=vv)
        saved = self.record_counter
        self.record_counter = 0
        cont = self._container(bytes(blocks), -1, 0x454F46, 0, 0, 0, 1, [0])
        self.record_counter = saved
        self.fp.write(cont)
