"""Compressed CRAM quality streams -> decode -> histogram, on the card.

Port of htslib_tpu/ops/device_stats.py, order-0 lane: rANS Nx16 O0
32-way QS streams go to the card once, kernel B3 (csrc/rans_nx16_o0.cu)
decodes every stream of the batch and counts its symbols into a
per-stream histogram in one launch, and only the [streams, qbins] counts
come back.  The decoded bytes never reach device memory.

`cram_qual_hist` routes each QS block as the JAX function does.  A block
the JAX package decodes on the device goes to kernel B3 where it is a
plain O0 32-way stream; where it needs a kernel the port does not have
yet (order-1, STRIPE, PACK, rANS 4x8), it raises NotImplementedError
naming that kernel rather than decoding on the host.  A block the JAX
package decodes on the host is decoded here with the port's own codecs
(cram/io.py), which raise NotImplementedError for codecs not yet ported.
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from htslib_tpu_torch import _build
from htslib_tpu_torch.codecs.rans4x16 import (_read_alphabet,
                                              _read_freq_table, u7_get,
                                              u7_put)
from htslib_tpu_torch.cram import CRAM_EOF_START
from htslib_tpu_torch.cram.io import CramIO, read_file_definition
from htslib_tpu_torch.cram.structs import CT_EXTERNAL, RANS, RANSPR
from htslib_tpu_torch.ops.rans_nx16 import frame_streams, rans_o0

QBINS = 64          # quality alphabet (phred 0..63)
QS_CONTENT_ID = 19  # external block id of the QS series (cram/encode.py)
A2_MAX = 4096       # stacked-table row budget of the JAX order-1 kernels


def qualstats_device(blocks: List[bytes], device="cuda",
                     offsets: Optional[List[int]] = None,
                     qbins: int = QBINS) -> Tuple[np.ndarray, dict]:
    """Per-stream symbol histograms of rANS Nx16 O0 32-way streams,
    decoded and counted on `device`.  `offsets[i]` is subtracted from
    stream i's symbols before binning (e.g. 33 for ASCII series), and
    symbols clip to [0, qbins - 1].  Returns (hist int64 [n, qbins],
    timing dict: uncompressed_bytes, compressed_bytes, decode_s)."""
    dev = _build.resolve_device(device)
    for data in blocks:
        if data[0] != 0x04:
            raise ValueError("device qualstats: plain 32-way O0 only")
    if not 1 <= qbins <= 256:
        raise ValueError("qbins must be in 1..256")
    timing = {"uncompressed_bytes": 0,
              "compressed_bytes": sum(len(b) for b in blocks),
              "decode_s": 0.0}
    if not blocks:
        return np.zeros((0, qbins), np.int64), timing
    b = frame_streams(blocks, dev)
    off = np.zeros(len(blocks), np.int32)
    if offsets is not None:
        n = min(len(offsets), len(blocks))
        off[:n] = offsets[:n]
    t0 = time.time()
    hist = rans_o0(b, offs=torch.from_numpy(off).to(dev), qbins=qbins)[0]
    out = hist.cpu().numpy().astype(np.int64)
    timing["decode_s"] = time.time() - t0
    timing["uncompressed_bytes"] = b.total_out
    return out, timing


def qualstats_host(datas: List[bytes]) -> np.ndarray:
    """Reference histograms (numpy) with the same QBINS clipping."""
    out = []
    for d in datas:
        a = np.minimum(np.frombuffer(d, np.uint8), QBINS - 1)
        out.append(np.bincount(a, minlength=QBINS)[:QBINS])
    return np.stack(out).astype(np.int64)


# -- routing: which QS wires the JAX package decodes on its device ----------

def _o1_fits(data: bytes) -> None:
    """Raise ValueError unless an Nx16 stream is a plain O1 32-way wire
    whose stacked (ctx, sym) table fits the JAX O1 kernel (the checks of
    rans_o1_pallas._parse_o1_header and o1_pads)."""
    flags = data[0]
    if flags & ~0x05 or not flags & 0x04 or not flags & 0x01:
        raise ValueError("device O1 kernel: plain 32-way O1 only")
    p = 1
    _ulen, p = u7_get(data, p)
    tlen, p = u7_get(data, p)
    tab = data[p:p + tlen]
    ctxs, tp = _read_alphabet(tab, 0)
    nrows = 0
    for _ in ctxs:
        f, tp = _read_freq_table(tab, tp)
        nrows += int((f > 0).sum())
    if nrows > A2_MAX:
        raise ValueError("alphabet too large for the device O1 kernel")


def _stripe_subs(raw: bytes) -> List[Tuple[bytes, bool]]:
    """STRIPE sub-stream bodies with their order-1 bit; ValueError when a
    sub-stream is not a plain 32-way wire (device_stats._stripe_rewrap)."""
    flags = raw[0]
    if not flags & 0x08 or flags & 0xF0:
        raise ValueError("not a plain stripe stream")
    p = 1
    _ulen, p = u7_get(raw, p)
    N = raw[p]
    p += 1
    lens = []
    for _ in range(N):
        v, p = u7_get(raw, p)
        lens.append(v)
    subs = []
    for ln in lens:
        body = bytes(raw[p:p + ln])
        p += ln
        if not body or body[0] & ~0x15 or not body[0] & 0x04:
            raise ValueError("stripe sub-stream not device-decodable")
        subs.append((body, bool(body[0] & 0x01)))
    return subs


def _pack_core(raw: bytes) -> bytes:
    """The plain core stream under a PACK stream; ValueError when the
    device lane does not take it (device_stats._pack_rewrap)."""
    if raw[0] & 0x78:
        raise ValueError("unsupported pack combination")
    p = 1
    _ulen, p = u7_get(raw, p)
    P = raw[p]
    p += 1 + P
    plen, p = u7_get(raw, p)
    if P <= 1:
        raise ValueError("constant pack: no core stream")
    if P > 16:
        raise ValueError("pack width > 4 bits")
    core = bytearray([raw[0] & 0x05])
    u7_put(core, plen)
    return bytes(core) + raw[p:]


def _unported_kernel(method: int, raw: bytes) -> Optional[str]:
    """For a QS block the JAX cram_qual_hist sends to a device kernel the
    port lacks, that kernel; else None (the block is plain O0 for kernel
    B3, or the JAX package decodes it on the host)."""
    if method == RANSPR and len(raw) > 1:
        f = raw[0]
        try:
            if f == 0x05:
                _o1_fits(raw)
                return ("B6, rans_o1_pallas._make_seg1_hist_kernel "
                        "(Nx16 order-1)")
            if f & 0x08 and not f & 0xF0:
                for sub, is_o1 in _stripe_subs(raw):
                    if is_o1:
                        _o1_fits(bytes([sub[0] & 0x05, 0]) + sub[1:])
                return ("the STRIPE front end, device_stats._stripe_rewrap "
                        "(over B3/B6)")
            if f in (0x84, 0x85):
                core = _pack_core(raw)
                if f == 0x85:
                    _o1_fits(core)
                return ("the PACK front end, device_stats._pack_rewrap "
                        "(over B3/B6)")
        except ValueError:
            return None
    elif method == RANS and len(raw) > 9 and raw[0] in (0, 1):
        # order-1 tables denser than A2_MAX rows decode on the JAX host
        # instead, with the rANS 4x8 codec, which is not ported either
        return (f"B8, rans4x8_pallas._seg4_hist_kernel (rANS 4x8 "
                f"order-{raw[0]})")
    return None


def cram_qual_hist(path: str, device="cuda",
                   stats: Optional[dict] = None) -> np.ndarray:
    """Whole-file quality histogram ([QBINS] int64, the samtools stats
    QUAL pass) of a CRAM: QS blocks stream from the containers; plain
    rANS Nx16 O0 32-way blocks decode and count on `device` (kernel B3,
    all in one launch), host-decoded blocks are counted with numpy.
    `stats` receives device_blocks and host_blocks as the JAX function
    counts them."""
    dev = _build.resolve_device(device)
    dev16: List[bytes] = []
    host_hist = np.zeros(QBINS, np.int64)
    n_dev = n_host = 0
    with open(path, "rb") as fp:
        version, _ = read_file_definition(fp)
        io = CramIO(fp, version)
        c = io.read_container_header()
        if c is None:
            raise IOError("CRAM: missing header container")
        fp.seek(c.data_offset + c.length)
        while True:
            c = io.read_container_header()
            if c is None:
                break
            if c.ref_seq_id == -1 and c.ref_seq_start == CRAM_EOF_START:
                break
            end = c.data_offset + c.length
            while fp.tell() < end:
                blk = io.read_block()
                if (blk.content_type != CT_EXTERNAL
                        or blk.content_id != QS_CONTENT_ID):
                    continue
                raw = bytes(blk.data)
                if blk.method == RANSPR and len(raw) > 1 and raw[0] == 0x04:
                    dev16.append(raw)
                    n_dev += 1
                    continue
                kernel = _unported_kernel(blk.method, raw)
                if kernel is not None:
                    raise NotImplementedError(
                        f"QS block (method {blk.method}, flags "
                        f"0x{raw[0]:02x}) decodes on the device through "
                        f"{kernel}, which is not ported yet")
                q = np.minimum(np.frombuffer(blk.uncompress(), np.uint8),
                               QBINS - 1)
                host_hist += np.bincount(q, minlength=QBINS)[:QBINS]
                n_host += 1
    if dev16:
        dh, _ = qualstats_device(dev16, device=dev)
        host_hist += dh.sum(axis=0)
    if stats is not None:
        stats["device_blocks"] = n_dev
        stats["host_blocks"] = n_host
    return host_hist
