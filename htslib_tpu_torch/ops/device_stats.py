"""Compressed CRAM quality streams -> decode -> histogram, on the card.

Port of htslib_tpu/ops/device_stats.py.  QS streams go to the card once,
a kernel decodes every stream of the batch and counts its symbols into a
per-stream histogram in one launch, and only the [streams, qbins] counts
come back; the decoded bytes never reach device memory.  One kernel per
wire:
  - rANS Nx16 order-0 32-way: kernel B3 (csrc/rans_nx16_o0.cu),
    `qualstats_device`;
  - rANS Nx16 order-1 32-way: kernel B6 (csrc/rans_nx16_o1.cu),
    `qualstats_device_o1`;
  - rANS 4x8 order 0 or 1 (CRAM 3.0): kernel B8 (csrc/rans4x8.cu),
    `qualstats_device_4x8`.
Every kernel also decodes the stream's tail, so no stream is finished on
the host.

`cram_qual_hist` routes each QS block as the JAX function does
(`qs_route`): STRIPE streams split into their plain sub-streams, PACK
streams send their core to B3/B6 with 256 bins and remap the histogram on
the host, and blocks the JAX package decodes on the host are decoded here
with the port's own codecs (cram/io.py), ARITH, FQZ and TOK3 included.
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from htslib_tpu_torch import _build
from htslib_tpu_torch.codecs.rans4x16 import u7_get, u7_put
from htslib_tpu_torch.cram import CRAM_EOF_START
from htslib_tpu_torch.cram.io import CramIO, read_file_definition
from htslib_tpu_torch.cram.structs import CT_EXTERNAL, RANS, RANSPR
from htslib_tpu_torch.ops.rans4x8 import (_parse_4x8_o1, frame_4x8,
                                          o1_gate_4x8, rans4x8)
from htslib_tpu_torch.ops.rans_nx16 import frame_streams, rans_o0
from htslib_tpu_torch.ops.rans_nx16_o1 import (_parse_o1_header,
                                               frame_o1_streams, o1_pads,
                                               rans_o1)

QBINS = 64          # quality alphabet (phred 0..63)
QS_CONTENT_ID = 19  # external block id of the QS series (cram/encode.py)


def _timing(blocks: List[bytes]) -> dict:
    return {"uncompressed_bytes": 0,
            "compressed_bytes": sum(len(b) for b in blocks),
            "decode_s": 0.0}


def _run(batch, run, timing: dict, reps: int = 1) -> np.ndarray:
    """Histograms of a framed batch through `run` (a kernel wrapper
    returning them first), timed into `timing` with the JAX package's
    keys: decode_s is the wall time of the launch and download, or with
    reps > 1 the best of `reps` re-runs of the already framed,
    device-resident batch; MBps_uncompressed_collect_wall or
    MBps_uncompressed_resident is the rate over it."""
    t0 = time.time()
    out = run(batch)[0].cpu().numpy().astype(np.int64)
    timing["decode_s"] = time.time() - t0
    timing["uncompressed_bytes"] = batch.total_out
    if reps > 1:
        best = None
        for _ in range(reps):
            t0 = time.time()
            run(batch)
            if batch.x0.is_cuda:
                torch.cuda.synchronize(batch.x0.device)
            dt = time.time() - t0
            best = dt if best is None else min(best, dt)
        timing["decode_s"] = best
    if timing["decode_s"] > 0:
        key = ("MBps_uncompressed_resident" if reps > 1
               else "MBps_uncompressed_collect_wall")
        timing[key] = round(
            timing["uncompressed_bytes"] / timing["decode_s"] / 1e6, 2)
    return out


def _check_qbins(qbins: int) -> None:
    if not 1 <= qbins <= 256:
        raise ValueError("qbins must be in 1..256")


def qualstats_device(blocks: List[bytes], device="cuda", reps: int = 1,
                     offsets: Optional[List[int]] = None,
                     qbins: int = QBINS) -> Tuple[np.ndarray, dict]:
    """Per-stream symbol histograms of rANS Nx16 O0 32-way streams,
    decoded and counted on `device`.  `offsets[i]` is subtracted from
    stream i's symbols before binning (e.g. 33 for ASCII series), and
    symbols clip to [0, qbins - 1].  Returns (hist int64 [n, qbins],
    timing dict: uncompressed_bytes, compressed_bytes, decode_s and
    MBps_uncompressed_collect_wall, or with reps > 1 decode_s the best of
    `reps` device-resident re-runs and MBps_uncompressed_resident)."""
    dev = _build.resolve_device(device)
    for data in blocks:
        if data[0] != 0x04:
            raise ValueError("device qualstats: plain 32-way O0 only")
    _check_qbins(qbins)
    timing = _timing(blocks)
    if not blocks:
        return np.zeros((0, qbins), np.int64), timing
    off = np.zeros(len(blocks), np.int32)
    if offsets is not None:
        n = min(len(offsets), len(blocks))
        off[:n] = offsets[:n]
    offs = torch.from_numpy(off).to(dev)
    return _run(frame_streams(blocks, dev),
                lambda b: rans_o0(b, offs=offs, qbins=qbins), timing,
                reps), timing


def qualstats_device_o1(blocks: List[bytes], device="cuda", reps: int = 1,
                        qbins: int = QBINS) -> Tuple[np.ndarray, dict]:
    """Per-stream histograms (clip(sym, 0, qbins - 1)) of rANS Nx16
    ORDER-1 32-way streams, decoded and counted on `device` (kernel B6),
    tails included.  Raises as the JAX function does for streams that are
    not plain O1 32-way or whose tables pass the A2_MAX gate."""
    dev = _build.resolve_device(device)
    parsed = [_parse_o1_header(d) for d in blocks]
    o1_pads(parsed)
    _check_qbins(qbins)
    timing = _timing(blocks)
    if not blocks:
        return np.zeros((0, qbins), np.int64), timing
    return _run(frame_o1_streams(parsed, dev),
                lambda b: rans_o1(b, qbins=qbins), timing, reps), timing


def qualstats_device_4x8(blocks: List[bytes], device="cuda", reps: int = 1,
                         qbins: int = QBINS, o1: bool = False
                         ) -> Tuple[np.ndarray, dict]:
    """Per-stream histograms (clip(sym, 0, qbins - 1)) of rANS 4x8
    streams (the CRAM 3.0 wire), ORDER-0 or ORDER-1 (`o1`), decoded and
    counted on `device` (kernel B8), tails included."""
    dev = _build.resolve_device(device)
    _check_qbins(qbins)
    timing = _timing(blocks)
    if not blocks:
        return np.zeros((0, qbins), np.int64), timing
    return _run(frame_4x8(blocks, o1, dev),
                lambda b: rans4x8(b, qbins=qbins), timing, reps), timing


def qualstats_host(datas: List[bytes]) -> np.ndarray:
    """Reference histograms (numpy) with the same QBINS clipping."""
    out = []
    for d in datas:
        a = np.minimum(np.frombuffer(d, np.uint8), QBINS - 1)
        out.append(np.bincount(a, minlength=QBINS)[:QBINS])
    return np.stack(out).astype(np.int64)


# -- STRIPE and PACK front ends: host byte work over B3/B6 -------------------

def _stripe_rewrap(raw: bytes):
    """Split a STRIPE-transformed Nx16 stream (flags & 0x08) into its
    N sub-streams, each rewrapped as a PLAIN stream (sub-streams are
    coded with flags&(O1|N32)|NOSZ over every N-th byte, so a synthetic
    header of the same flags + the known sub-length makes each one a
    standalone stream).  A histogram is stripe-order-independent, so
    the per-sub histograms just sum.  Returns a list of
    (sub_stream, is_o1); raises ValueError when a sub-stream is not a
    plain 32-way wire."""
    flags = raw[0]
    if not (flags & 0x08) or flags & 0xF0:  # no NOSZ/CAT/RLE/PACK outer
        raise ValueError("not a plain stripe stream")
    p = 1
    ulen, p = u7_get(raw, p)
    N = raw[p]
    p += 1
    lens = []
    for _ in range(N):
        v, p = u7_get(raw, p)
        lens.append(v)
    subs = []
    for j in range(N):
        body = bytes(raw[p:p + lens[j]])
        p += lens[j]
        want = (ulen - j + N - 1) // N
        if not body or body[0] & ~0x15 or not (body[0] & 0x04):
            raise ValueError("stripe sub-stream not device-decodable")
        hdr = bytearray([body[0] & 0x05])     # drop NOSZ, keep O1|X32
        u7_put(hdr, want)
        subs.append((bytes(hdr) + body[1:], bool(body[0] & 0x01)))
    return subs


def _pack_rewrap(raw: bytes):
    """Split a PACK-transformed Nx16 stream (flags & 0x80) into its
    pack map and a synthetic PLAIN stream for the core coder (the wire
    after the pack meta is exactly a plain stream body: freq table +
    states + payload), so the kernels decode the packed bytes and the
    histogram is remapped on the host.  Returns
    (syms, width_bits, ulen, plen, core_stream)."""
    flags = raw[0]
    if flags & 0x78:        # STRIPE/NOSZ/CAT/RLE not handled here
        raise ValueError("unsupported pack combination")
    p = 1
    ulen, p = u7_get(raw, p)
    P = raw[p]
    p += 1
    syms = bytes(raw[p:p + P])
    p += P
    plen, p = u7_get(raw, p)
    if P <= 1:
        raise ValueError("constant pack: no core stream")
    if P <= 2:
        w = 1
    elif P <= 4:
        w = 2
    elif P <= 16:
        w = 4
    else:
        raise ValueError("pack width > 4 bits")
    core = bytearray([flags & 0x05])
    u7_put(core, plen)
    core += raw[p:]
    return syms, w, ulen, plen, bytes(core)


def _pack_hist_remap(core_hist: np.ndarray, syms: bytes, w: int,
                     ulen: int, plen: int, qbins: int) -> np.ndarray:
    """Histogram of packed core bytes [256] -> histogram of unpacked
    symbols [qbins] (pad slots decode as syms[0] and are subtracted)."""
    per = 8 // w
    mask = (1 << w) - 1
    out = np.zeros(qbins, np.int64)
    for v in range(256):
        c = int(core_hist[v])
        if not c:
            continue
        for slot in range(per):
            sub = (v >> (slot * w)) & mask
            if sub < len(syms):
                out[min(syms[sub], qbins - 1)] += c
    pad = plen * per - ulen
    if pad > 0:
        out[min(syms[0], qbins - 1)] -= pad
    return out


# -- routing ------------------------------------------------------------------

def qs_route(method: int, raw: bytes):
    """Where `cram_qual_hist` sends a QS block, exactly as the JAX
    function routes it (htslib_tpu/ops/device_stats.py:773-832).
    Returns (lane, item): lane "nx16_o0" or "nx16_o1" (item: the stream),
    "stripe" (item: `_stripe_rewrap`'s sub-streams), "pack" (item:
    `_pack_rewrap`'s tuple plus the order-1 bit), "4x8_o0" or "4x8_o1"
    (item: the stream), or (None, None) for a block decoded on the host.
    Order-1 tables must pass the JAX kernels' A2_MAX gate."""
    if method == RANSPR and len(raw) > 1:
        f = raw[0]
        try:
            if f == 0x04:
                return "nx16_o0", raw
            if f == 0x05:
                o1_pads([_parse_o1_header(raw)])
                return "nx16_o1", raw
            if f & 0x08 and not f & 0xF0:
                subs = _stripe_rewrap(raw)
                for sub, is_o1 in subs:
                    if is_o1:
                        o1_pads([_parse_o1_header(sub)])
                return "stripe", subs
            if f in (0x84, 0x85):
                pk = _pack_rewrap(raw)
                if f == 0x85:
                    o1_pads([_parse_o1_header(pk[4])])
                return "pack", pk + (f == 0x85,)
        except ValueError:
            pass
    elif method == RANS and len(raw) > 9 and raw[0] == 0:
        return "4x8_o0", raw
    elif method == RANS and len(raw) > 9 and raw[0] == 1:
        try:
            o1_gate_4x8(_parse_4x8_o1(raw)[1])
            return "4x8_o1", raw
        except ValueError:
            pass
    return None, None


def cram_qual_hist(path: str, device="cuda",
                   stats: Optional[dict] = None) -> np.ndarray:
    """Whole-file quality histogram ([QBINS] int64, the samtools stats
    QUAL pass) of a CRAM: QS blocks stream from the containers and are
    routed by `qs_route`; each lane's streams decode and count on
    `device` in one launch per kernel, host-decoded blocks are counted
    with numpy.  `stats` receives device_blocks and host_blocks as the
    JAX function counts them."""
    dev = _build.resolve_device(device)
    lanes = {"nx16_o0": [], "nx16_o1": [], "4x8_o0": [], "4x8_o1": []}
    packs: List[tuple] = []   # (syms, w, ulen, plen, core, is_o1)
    hist = np.zeros(QBINS, np.int64)
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
                lane, item = qs_route(blk.method, raw)
                if lane is None:
                    q = np.minimum(np.frombuffer(blk.uncompress(), np.uint8),
                                   QBINS - 1)
                    hist += np.bincount(q, minlength=QBINS)[:QBINS]
                    n_host += 1
                    continue
                n_dev += 1
                if lane == "stripe":
                    for sub, is_o1 in item:
                        lanes["nx16_o1" if is_o1 else "nx16_o0"].append(sub)
                elif lane == "pack":
                    packs.append(item)
                else:
                    lanes[lane].append(item)
    for lane, runner in (("nx16_o0", qualstats_device),
                         ("nx16_o1", qualstats_device_o1),
                         ("4x8_o0", qualstats_device_4x8),
                         ("4x8_o1", lambda b, device: qualstats_device_4x8(
                             b, device=device, o1=True))):
        if lanes[lane]:
            hist += runner(lanes[lane], device=dev)[0].sum(axis=0)
    for is_o1, runner in ((False, qualstats_device),
                          (True, qualstats_device_o1)):
        cores = [p for p in packs if p[5] == is_o1]
        if not cores:
            continue
        ch, _ = runner([p[4] for p in cores], device=dev, qbins=256)
        for (syms, w, ulen, plen, _core, _o1), h in zip(cores, ch):
            hist += _pack_hist_remap(h, syms, w, ulen, plen, QBINS)
    if stats is not None:
        stats["device_blocks"] = n_dev
        stats["host_blocks"] = n_host
    return hist
