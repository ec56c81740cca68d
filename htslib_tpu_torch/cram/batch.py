"""CRAM -> SAM over container ranges with the device doing the batchable
work, and the whole-file BAM -> CRAM writer (the port's copy of
htslib_tpu/cram/batch.py).

The JAX package decodes each slice with one fused native call, or
falls back to its Python record decoder and SAM formatter.  The port
keeps that fallback's host record decode (cram/decode.py) and moves its
two batchable stages to the device:

  1. block entropy decode.  For each run of `window` slices, every CORE
     and EXTERNAL block with data whose wire a device function decodes
     (`block_wire`: rANS 4x8 of either order; rANS Nx16 without a
     transform, 4-way or 32-way, either order) goes through one call of
     ops/rans.py `uncompress_batch` or `uncompress_nx16_batch` (kernels
     B7, X1; X2, X3, B2, B5; their large-table or dense variants for
     order-1 tables past A2_MAX rows).  The routes are decided from the blocks' bytes before any
     launch; a device error raises and no block is decoded again on the
     host.  Every other block (RAW, GZIP, BZIP2, LZMA, ARITH, FQZ, TOK3,
     Nx16 with a transform) is decoded by the port's host codecs
     (cram/io.py `CramBlock.uncompress`);
  2. SAM formatting.  The range's slices, decoded to u32-framed BAM
     records, are formatted by one call of ops/bam2sam.py
     `bam_payload_to_sam_device` (X5, B1 and the torch line assembly).

Slices are decoded in file order in the calling thread: the record
decode is Python under the GIL, which the JAX package's pipeline
threads do not speed up.  With `device="cpu"` the kernels' plain
versions run.

A region query (`samtools view file.cram chr:beg-end`) is the index's
containers decoded on the device: cram/index.py
`CramIndex.container_offsets`, then `cram_range_to_sam` over each run of
consecutive containers, the lines outside the region dropped by the
caller (or `CramReader.fetch` on the host).
"""
from __future__ import annotations

from collections import Counter
from itertools import islice
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from htslib_tpu_torch import _build
from htslib_tpu_torch.cram import CRAM_EOF_START, CramReader, CramWriter
from htslib_tpu_torch.cram.decode import (CompressionHeader, SliceHeader,
                                          decode_compression_header,
                                          decode_slice_blob,
                                          decode_slice_header)
from htslib_tpu_torch.cram.encode import RawRun
from htslib_tpu_torch.cram.io import CramBlock
from htslib_tpu_torch.cram.structs import (CT_COMPRESSION_HEADER, CT_CORE,
                                           CT_EXTERNAL, CT_MAPPED_SLICE,
                                           CT_UNMAPPED_SLICE, RANS, RANSPR)
from htslib_tpu_torch.ops.bam2sam import bam_payload_to_sam_device
from htslib_tpu_torch.ops.rans import uncompress_batch, uncompress_nx16_batch
from htslib_tpu_torch.sam.bam import BamReader
from htslib_tpu_torch.sam.header import SamHeader

# the launch key of the kernel that decodes each wire (ops/rans.py; an
# order-1 table past A2_MAX rows takes the large variant's key, "_large"
# before "_decode", or past the large variant's waves the dense one's,
# "_dense")
WIRE_KERNELS = {
    "4x8_o0": "rans4x8_o0_decode",                   # B7
    "4x8_o1": "rans4x8_o1_decode",                   # X1
    "nx16_4way_o0": "rans_nx16_4way_o0_decode",      # X2
    "nx16_4way_o1": "rans_nx16_4way_o1_decode",      # X3
    "nx16_32way_o0": "rans_nx16_o0_decode",          # B2
    "nx16_32way_o1": "rans_nx16_o1_decode",          # B5
}

SliceJob = Tuple[CompressionHeader, SliceHeader, List[CramBlock]]


def _slice_jobs(r: CramReader, end_offset: Optional[int] = None,
                ) -> Iterator[SliceJob]:
    """Serial walk of containers -> (comp_hdr, slice_hdr, blocks), the
    blocks read but not decoded.  `end_offset` bounds the walk to
    containers starting before it (a shard plan's range,
    parallel/distributed.py)."""
    while True:
        if end_offset is not None and r.fp.tell() >= end_offset:
            return
        c = r.io.read_container_header()
        if c is None:
            return
        if c.ref_seq_id == -1 and c.ref_seq_start == CRAM_EOF_START:
            return
        if c.length == 0 or c.num_records == 0:
            r.io.skip_container_data(c)
            continue
        comp_block = r.io.read_block()
        if comp_block.content_type != CT_COMPRESSION_HEADER:
            raise IOError("CRAM: expected compression header block")
        chdr = decode_compression_header(comp_block, r.version[0])
        end = c.data_offset + c.length
        while r.fp.tell() < end:
            hdr_block = r.io.read_block()
            if hdr_block.content_type not in (CT_MAPPED_SLICE,
                                              CT_UNMAPPED_SLICE):
                raise IOError("CRAM: unexpected block content type "
                              f"{hdr_block.content_type} in container")
            sh = decode_slice_header(hdr_block, r.version[0])
            blocks = [r.io.read_block() for _ in range(sh.num_blocks)]
            yield chdr, sh, blocks


def block_wire(block: CramBlock) -> Optional[str]:
    """The device wire of a slice's data block (a key of WIRE_KERNELS),
    or None where the host decodes it: another method, an Nx16 stream
    with a transform flag (PACK, RLE, STRIPE, CAT, NOSZ), or no data."""
    d = block.data
    if (block.content_type not in (CT_CORE, CT_EXTERNAL)
            or block.raw_size <= 0):
        return None
    if block.method == RANS and len(d) > 9 and d[0] in (0, 1):
        return f"4x8_o{d[0]}"
    if block.method == RANSPR and len(d) > 1 and not d[0] & ~0x05:
        return f"nx16_{32 if d[0] & 0x04 else 4}way_o{d[0] & 0x01}"
    return None


def decode_blocks(blocks: List[CramBlock], device="cuda",
                  timing: Optional[dict] = None) -> Counter:
    """Decode every data block of `blocks`: those with a device wire in
    one call of each ops/rans.py entry point on `device`, the rest with
    the host codecs; each block's `_uncompressed` is set.  Returns the
    blocks by wire ("host" for the rest).  `timing`, where given, gets
    device_blocks_s and host_blocks_s added."""
    dev = _build.resolve_device(device)
    wires = [block_wire(b) for b in blocks]
    t0 = _build.clock(dev)
    for prefix, decode in (("4x8", uncompress_batch),
                           ("nx16", uncompress_nx16_batch)):
        idx = [i for i, w in enumerate(wires) if w and w.startswith(prefix)]
        if not idx:
            continue
        outs = decode([blocks[i].data for i in idx], device=dev)
        for i, out in zip(idx, outs):
            if len(out) != blocks[i].raw_size:
                raise IOError(f"CRAM block inflated to {len(out)}, "
                              f"expected {blocks[i].raw_size}")
            blocks[i]._uncompressed = out
    t1 = _build.clock(dev)
    for b, w in zip(blocks, wires):
        if w is None and b.content_type in (CT_CORE, CT_EXTERNAL):
            b.uncompress()
    if timing is not None:
        timing["device_blocks_s"] = (timing.get("device_blocks_s", 0.0)
                                     + t1 - t0)
        timing["host_blocks_s"] = (timing.get("host_blocks_s", 0.0)
                                   + _build.clock(dev) - t1)
    return Counter(w or "host" for b, w in zip(blocks, wires)
                   if b.content_type in (CT_CORE, CT_EXTERNAL))


def cram_file_to_sam(path: str, ref: Optional[str] = None,
                     decode_md: bool = True, window: int = 8,
                     device="cuda", timing: Optional[dict] = None,
                     ) -> Tuple[SamHeader, np.ndarray]:
    """CRAM file -> SAM text (cram_to_bam + sam_format1 over the whole
    file): `cram_range_to_sam` with no bounds.  Returns (header, uint8
    text)."""
    return cram_range_to_sam(path, None, None, ref=ref, decode_md=decode_md,
                             window=window, device=device, timing=timing)


def cram_range_to_sam(path: str, offset: Optional[int],
                      end_offset: Optional[int], ref: Optional[str] = None,
                      decode_md: bool = True, window: int = 8,
                      device="cuda", timing: Optional[dict] = None,
                      ) -> Tuple[SamHeader, np.ndarray]:
    """CRAM container byte range -> SAM text: seeks to `offset` (a
    container boundary, e.g. from a shard plan) and decodes the
    containers that start before `end_offset`; None bounds mean the
    start of the data and EOF.  Blocks go to the device `window` slices
    at a time (`decode_blocks`), the slices are decoded on the host in
    file order, and their records are formatted in one device call.
    Returns (header, uint8 text).  `timing`, where given, gets seconds by
    stage (device_blocks_s, host_blocks_s, record_decode_s, format_s and
    the formatter's own parts under "format"), and slices, records and
    blocks by wire."""
    dev = _build.resolve_device(device)
    parts: Dict = {} if timing is None else timing
    wires: Counter = Counter()
    blobs: List[bytes] = []
    with CramReader(path, ref=ref, decode_md=decode_md) as r:
        hdr = r.header
        if offset is not None:
            r.fp.seek(offset)
        jobs = _slice_jobs(r, end_offset)
        while True:
            batch = list(islice(jobs, max(window, 1)))
            if not batch:
                break
            wires += decode_blocks([b for _, _, bl in batch for b in bl],
                                   dev, parts)
            t0 = _build.clock(dev)
            for chdr, sh, blocks in batch:
                blobs.append(decode_slice_blob(chdr, sh, blocks, hdr,
                                               r.refs.get, r.version[0],
                                               decode_md=decode_md))
            parts["record_decode_s"] = (parts.get("record_decode_s", 0.0)
                                        + _build.clock(dev) - t0)
            parts["slices"] = parts.get("slices", 0) + len(batch)
    payload = b"".join(blobs)
    t0 = _build.clock(dev)
    fmt: Dict = {}
    text = bam_payload_to_sam_device(payload, hdr, device=dev, timing=fmt)
    parts["format_s"] = _build.clock(dev) - t0
    parts["format"] = fmt
    parts["records"] = fmt.get("records", 0)
    parts["wires"] = dict(wires)
    return hdr, np.frombuffer(text, np.uint8)


def _raw_run(data: np.ndarray, offs: np.ndarray, sizes: np.ndarray
             ) -> RawRun:
    """The planner's columns of a u32-framed record stream: tid, pos and
    the end (bam_endpos: pos + reference span, at least 1; unmapped
    records span 1), gathered with numpy."""
    buf = data.tobytes()
    arr = np.frombuffer(buf, np.uint8)
    n = len(offs)
    offs = np.asarray(offs, np.int64)
    sizes = np.asarray(sizes, np.int64)

    def u32(field_off):
        cols = np.add.outer(offs + field_off, np.arange(4, dtype=np.int64))
        b = arr[cols].astype(np.uint32)
        return b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)

    tids = u32(4).astype(np.int32)
    poss = u32(8).astype(np.int32)
    l_qname = arr[offs + 12].astype(np.int64)
    n_cigar = (arr[offs + 16].astype(np.int64)
               | (arr[offs + 17].astype(np.int64) << 8))
    flags = (arr[offs + 18].astype(np.int64)
             | (arr[offs + 19].astype(np.int64) << 8))
    # ragged CIGAR gather: each record's reference span
    cig_start = offs + 4 + 32 + l_qname
    span = np.zeros(n, np.int64)
    total = int(n_cigar.sum())
    if total:
        rec_of = np.repeat(np.arange(n), n_cigar)
        within = np.arange(total) - np.repeat(np.cumsum(n_cigar) - n_cigar,
                                              n_cigar)
        wpos = np.repeat(cig_start, n_cigar) + 4 * within
        cw = (arr[wpos].astype(np.uint32)
              | (arr[wpos + 1].astype(np.uint32) << 8)
              | (arr[wpos + 2].astype(np.uint32) << 16)
              | (arr[wpos + 3].astype(np.uint32) << 24))
        op = cw & 0xF
        consumes = (op == 0) | (op == 2) | (op == 3) | (op == 7) | (op == 8)
        np.add.at(span, rec_of, np.where(consumes, (cw >> 4).astype(
            np.int64), 0))
    span = np.where((flags & 4) != 0, 0, span)
    ends = poss + np.where(span > 0, span, 1)
    return RawRun(buf, offs, sizes, tids, poss, ends)


def bam_to_cram_file(bam_path: str, cram_path: str, ref=None,
                     **opts) -> int:
    """Whole-file BAM -> CRAM (the test_view -C shape): the BAM's record
    stream read once (sam/bam.py `BamReader.raw_records`), planned into
    containers of seqs_per_slice x slices_per_container records by its
    tid/pos/end columns, each container encoded by the CramWriter's
    encoder.  `opts` are CramWriter's: `write_index=True` writes the
    `.crai` beside the file, `device_profile=True` (CRAM 3.1) pins the
    quality blocks to a wire the device decodes.  Returns the record
    count."""
    with BamReader(bam_path) as r:
        header = r.header
        run = _raw_run(*r.raw_records())
    n = len(run)
    with CramWriter(cram_path, header, ref=ref, **opts) as w:
        enc = w._enc
        if enc.embed_ref:
            raise ValueError("bam_to_cram_file: embed_ref needs the "
                             "record path (CramWriter.write)")
        per = max(1, enc.seqs_per_slice * enc.slices_per_container)
        for lo in range(0, n, per):
            chunk = run[lo:lo + per]
            enc._write_data_container(chunk)
            enc.record_counter += len(chunk)
    return n
