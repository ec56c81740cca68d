#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (htslib_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's kernels from htslib_tpu_torch/csrc with nvcc, drives the
port's main path at full size through its public entry points, holds every
result against a host truth, then holds each kernel against its plain
PyTorch version on the card and times both.  Phases:

  1. the card's name and power limit (nvidia-smi);
  2. the kernel build, timed;
  3. leg 1, the BAM record-batch step: entry()'s forward over 400,000
     records (seq4 uint8 [400000, 64], starts sorted over 1 Mbp, spans of
     50-150 bp, tile 1 << 20), checked against numpy: flag sum, the bytes
     of nibble_to_base, coverage, and the step's int32 total;
  4. leg 2, the CRAM quality lane: 40 QS-sized streams of 1 MiB, encoded
     on the host with the port's rans4x16.compress(d, 0x04):
     qualstats_device must equal numpy.bincount of the raw qualities, and
     decode_nx16_o0_batch must give 8 of the streams back byte for byte;
     its wall time is printed in parts (the histogram call's framing and
     transfer, its launch and download, the checks, the decode call) and,
     after phase 6, less its kernels' times: its host side;
  4b. leg 3, the quality lane on the other rANS wires: 40 x 1 MiB Nx16
     order-1 (0x05) bounded random walks and 40 x 1 MiB rANS 4x8 streams
     (20 order 0, 20 order 1), encoded on the host with the port's codecs:
     qualstats_device_o1 and qualstats_device_4x8 (both orders) must equal
     numpy.bincount of the raw qualities, and decode_nx16_o1_batch and
     decode_4x8_o0_batch must give 8 streams each back byte for byte;
  5. the file-level lane: cram_qual_hist on each committed fixture (CRAM
     3.1 order 0, CRAM 3.1 order 1, CRAM 3.0 rANS 4x8, CRAM 3.1 STRIPE and
     PACK) must equal the histogram and block counts committed beside it,
     with blocks decoded on the device;
  5b. leg 4, the encode lane: encode_nx16_o0_batch on the card over leg
     2's 40 raw 1 MiB streams must give leg 2's host encodings byte for
     byte, and 8 of the device-encoded streams must decode (B2) back to
     their raw bytes; after the main path its host side is printed in
     parts (a second pass through the entry point's steps, each ended by a
     synchronise: the framing, the wrapper's checks, the launch and
     kernel, the payload gather and download, the headers);
  5c. leg 5, the resolve chains: make_resolve_bench (G=128 chains, 32,768
     steps, the JAX package's bench shape) and make_huffman_resolve_bench
     (L=128 chains, the same depth) must equal their numpy chains; their
     lookups per second are printed;
  6. each kernel (B1, B2, B3, B5, B6, B7, B8 in both orders, B9, B4, B10)
     against its plain version at the main path's shapes, and one JSON
     line with launches, error and times.  The plain versions of B5-B9
     take half a millisecond to a millisecond per round on the card, so
     they are held against their kernels at full size over the first 4096
     rounds (states, cursors, contexts, emitted words and those rounds'
     symbols or counts), and over whole streams on a 64 KiB batch; those
     of B4 and B10 run all 32,768 steps.  B5, B6 and B8 order 1 are also
     held over a whole 64 KiB wide-alphabet stream whose lookups meet slow
     buckets.  B9 is also held, whole and against the host codec, on its
     edge streams (lengths 1, 31, 32, 33 and about its 32-round window,
     one-symbol streams, f = 1 symbols).  Each chain-bound row gives
     ns_per_round (ms over its longest chain), the B2, B3 and B5-B9 rows
     the streams one SM holds (streams_per_sm; B10 chains_per_sm), and the
     B5, B6, B9 and B10 rows their shared memory a block (smem_bytes); the
     B5/B6 rows the share of rounds in which some state's lookup met a slow
     bucket (slow_share).
     Outputs are bytes and integers, so the tolerance is zero: kernel and
     plain version must be equal.

Launch counts are reset just before phase 3 and read just after phase 5c.
Any mismatch raises.  The last line is {"ok": true, "device": {...}}.
Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""
from __future__ import annotations

import json
import multiprocessing
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
TESTDATA = os.path.join(REPO, "htslib_tpu_torch", "testdata")
FIXTURES = [os.path.join(TESTDATA, f) for f in (
    "qual_o0.cram", "qual_o1.cram", "qual_v30.cram", "qual_stripe_pack.cram")]

N_RECORDS = 400_000
MAX_LEN = 128
TILE_LEN = 1 << 20
N_STREAMS = 40
STREAM_BYTES = 1 << 20
N_DECODE = 8
SMALL_BYTES = 1 << 16   # whole-stream kernel/plain comparisons
N_SMALL = 4
PLAIN_ROUNDS = 4096     # prefix of the full-size kernel/plain comparisons
CHAINS = 128            # resolve chains (the JAX package's bench: G=128)
CHAIN_ROUNDS = 32768    # steps of each resolve chain (its bench depth)
# peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s; 32-bit scalar
# operations are held to the non-tensor fp32 rate, the nearest listed one
HBM_BYTES_S = 3.35e12
SCALAR_OPS_S = 67e12


def _encode(data: bytes, wire: str = "nx16_o0") -> bytes:
    """One stream on one rANS wire, with the port's own host codecs."""
    from htslib_tpu_torch.codecs import rans4x8, rans4x16
    if wire.startswith("4x8"):
        return rans4x8.compress(data, int(wire[-1]))
    return rans4x16.compress(data, 0x05 if wire == "nx16_o1" else 0x04)


def _encode_all(raws, wires):
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                             mp_context=ctx) as pool:
        return list(pool.map(_encode, raws, wires, chunksize=1))


def _walks(rng, n: int, size: int, read: int = 100):
    """n quality streams of `size` bytes: bounded random walks over 2..41,
    one per read of `read` bp, as a QS series concatenates its reads."""
    k = -(-size // read)
    out = []
    for _ in range(n):
        q = np.clip(rng.integers(25, 38, (k, 1))
                    + np.cumsum(rng.integers(-2, 3, (k, read)), axis=1),
                    2, 41)
        out.append(q.reshape(-1)[:size].astype(np.uint8).tobytes())
    return out


def leg1_batch(n: int = N_RECORDS, seed: int = 1):
    """Records for the record-batch step: random cores and packed
    sequences, sorted starts over 1 Mbp, spans of 50-150 bp."""
    rng = np.random.default_rng(seed)
    cores = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    seq4 = rng.integers(0, 256, (n, MAX_LEN // 2), dtype=np.uint8)
    starts = np.sort(rng.integers(0, 1_000_000, n)).astype(np.int32)
    ends = (starts + rng.integers(50, 151, n)).astype(np.int32)
    return cores, seq4, starts, ends, np.ones(n, bool)


def leg2_streams(n: int = N_STREAMS, size: int = STREAM_BYTES,
                 seed: int = 2):
    """QS-sized quality streams, raw and encoded: most uniform over
    20..40, the last fifth bounded random walks over 0..44."""
    rng = np.random.default_rng(seed)
    raws = []
    for i in range(n):
        if i < n - n // 5:
            q = rng.integers(20, 41, size, dtype=np.uint8)
        else:
            q = np.clip(np.cumsum(rng.integers(-2, 3, size)) + 20,
                        0, 44).astype(np.uint8)
        raws.append(q.tobytes())
    return raws, _encode_all(raws, ["nx16_o0"] * n)


def leg3_streams(n: int = N_STREAMS, size: int = STREAM_BYTES,
                 small: int = SMALL_BYTES, n_small: int = N_SMALL,
                 seed: int = 3):
    """QS-sized streams on the other rANS wires, raw and encoded, with
    n_small streams of `small` bytes per wire for the whole-stream
    comparisons: {wire: (raws, encs, small raws, small encs)} for wires
    nx16_o1 (n bounded random walks), 4x8_o0 (n/2, uniform over 20..40)
    and 4x8_o1 (n/2 random walks), and under "4x8_o1_wide" one (raw,
    encoded) 4x8 order-1 `wide_stream` of `small` bytes, and under
    "nx16_o1_wide" the same bytes on the Nx16 order-1 wire."""
    rng = np.random.default_rng(seed)
    half = n // 2
    raws = {"nx16_o1": _walks(rng, n, size),
            "4x8_o0": [rng.integers(20, 41, size, dtype=np.uint8).tobytes()
                       for _ in range(half)],
            "4x8_o1": _walks(rng, half, size)}
    smalls = {w: (_walks(rng, n_small, small) if w.endswith("o1")
                  else [rng.integers(20, 41, small, dtype=np.uint8)
                        .tobytes() for _ in range(n_small)])
              for w in raws}
    jobs = [(w, d) for w, ds in list(raws.items()) + list(smalls.items())
            for d in ds]
    encs = _encode_all([d for _, d in jobs], [w for w, _ in jobs])
    out, k = {}, 0
    for w in raws:
        out[w] = [raws[w], encs[k:k + len(raws[w])]]
        k += len(raws[w])
    for w in raws:
        out[w] += [smalls[w], encs[k:k + n_small]]
        k += n_small
    wide = wide_stream(rng, small)
    out["4x8_o1_wide"] = (wide, _encode(wide, "4x8_o1"))
    out["nx16_o1_wide"] = (wide, _encode(wide, "nx16_o1"))
    return out


def wide_stream(rng, size: int) -> bytes:
    """Every other byte 0 and then a random one: order-1 context 0 has
    ~256 successors of frequency ~16, so a 64-slot bucket of its table
    holds several row starts: a slow bucket, whose lookups B5/B6 take
    through its map and B8 through its walk."""
    d = np.zeros(size, np.uint8)
    d[1::2] = rng.integers(0, 256, size // 2)
    return d.tobytes()


def enc_edge_streams(seed: int = 31):
    """B9's edge cases: lengths 1, 31, 32 and 33 (the all-live rounds and
    the last round's predicate), one-symbol streams (f = 4096, whose
    threshold f << 19 is 2^31), a stream whose rare symbols have f = 1
    (the reciprocal's bias case), and lengths about the kernel's 32-round
    window (1,023, 1,024, 2,049 and 3,000 symbols)."""
    rng = np.random.default_rng(seed)
    rare = np.full(20000, 40, np.uint8)
    rare[rng.choice(20000, 30, replace=False)] = np.arange(30, dtype=np.uint8)
    return [rng.integers(0, 40, n, dtype=np.uint8).tobytes()
            for n in (1, 31, 32, 33, 1023, 1024, 2049, 3000)] + [
        bytes([7]) * 5000, bytes([200]) * 33, rare.tobytes()]


def fallback_buckets(tables) -> int:
    """(context, 64-slot bucket) pairs of stream 0's order-1 table in
    which two or more rows start after the bucket's first slot: the
    buckets whose lookups can reach the loop."""
    n = int(tables.n_rows[0])
    rows = tables.rows.cpu().numpy().view(np.uint32)[:n].astype(np.int64)
    cs = tables.ctx_start[0].cpu().numpy()
    ctx = np.repeat(np.arange(256), np.diff(cs))
    cum = (rows >> 12) & 0xFFF
    inside = cum & 63 != 0
    _, counts = np.unique(ctx[inside] * 64 + (cum[inside] >> 6),
                          return_counts=True)
    return int((counts >= 2).sum())


def nt16_numpy(seq4: np.ndarray) -> np.ndarray:
    lut = np.frombuffer(b"=ACMGRSVTWYHKDBN", np.uint8)
    out = np.empty((seq4.shape[0], 2 * seq4.shape[1]), np.uint8)
    out[:, 0::2] = lut[seq4 >> 4]
    out[:, 1::2] = lut[seq4 & 15]
    return out


def coverage_numpy(starts, ends, tile_len):
    diff = np.zeros(tile_len + 1, np.int64)
    np.add.at(diff, np.clip(starts, 0, tile_len), 1)
    np.add.at(diff, np.clip(ends, 0, tile_len), -1)
    return np.cumsum(diff[:-1])


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"mismatch: {what}")


def hist_of(raw: bytes, qbins: int) -> np.ndarray:
    return np.bincount(np.minimum(np.frombuffer(raw, np.uint8), qbins - 1),
                       minlength=qbins)


def main_path(device, batch, raws, encs, leg3, tile_len=TILE_LEN,
              n_decode=N_DECODE):
    """Phases 3-5c through the port's entry points on `device`, each
    result held against its host truth.  Returns (leg-1 args on the
    device, seconds of each phase, leg 4's timing dict and leg 5's
    lookups per second)."""
    from htslib_tpu_torch.entry import entry
    from htslib_tpu_torch.ops.device_stats import (QBINS, cram_qual_hist,
                                                   qualstats_device,
                                                   qualstats_device_4x8,
                                                   qualstats_device_o1)
    from htslib_tpu_torch.ops.huffman import make_huffman_resolve_bench
    from htslib_tpu_torch.ops.pileup_kernel import coverage_tile
    from htslib_tpu_torch.ops.rans4x8 import decode_4x8_o0_batch
    from htslib_tpu_torch.ops.rans_enc import encode_nx16_o0_batch
    from htslib_tpu_torch.ops.rans_nx16 import (decode_nx16_o0_batch,
                                                make_resolve_bench)
    from htslib_tpu_torch.ops.rans_nx16_o1 import decode_nx16_o1_batch
    from htslib_tpu_torch.ops.seqfmt import nibble_to_base, unpack_core_fields

    cores, seq4, starts, ends, _valid = batch
    flags_np = cores[:, 14].astype(np.int64) | (cores[:, 15].astype(np.int64)
                                                << 8)
    bases_np = nt16_numpy(seq4)
    cov_np = coverage_numpy(starts, ends, tile_len)
    fixture_want = []
    for path in FIXTURES:
        with open(path + ".hist.json") as fp:
            fixture_want.append(json.load(fp))
    secs = {}

    t0 = time.time()
    forward, args = entry(device=device, tile_len=tile_len, batch=batch)
    total = int(forward(*args))
    want = (int(flags_np.sum()) + int(bases_np.sum(dtype=np.int64))
            + int(cov_np.sum()) + (1 << 31)) % (1 << 32) - (1 << 31)
    require(total == want, f"leg 1 total {total} != {want}")
    require(int(unpack_core_fields(args[0])["flag"].sum())
            == int(flags_np.sum()), "leg 1 flag sum")
    require(np.array_equal(nibble_to_base(args[1]).cpu().numpy(), bases_np),
            "leg 1 nibble_to_base bytes")
    cov = coverage_tile(args[2], args[3], args[4], 0, tile_len)
    require(np.array_equal(cov.cpu().numpy(), cov_np), "leg 1 coverage")
    secs["leg1"] = time.time() - t0

    # leg 2, its parts timed apart: the histogram call (its framing and
    # transfer, then its launch and download, `decode_s`), the checks
    # against the raw streams, and the decode call with its check
    t0 = time.time()
    hist, timing = qualstats_device(encs, device=device)
    t1 = time.time()
    for i, raw in enumerate(raws):
        require(np.array_equal(hist[i], hist_of(raw, QBINS)),
                f"leg 2 histogram of stream {i}")
    t2 = time.time()
    out = decode_nx16_o0_batch(encs[:n_decode], device=device)
    t3 = time.time()
    require(out == raws[:n_decode], "leg 2 decoded bytes")
    secs["leg2"] = time.time() - t0
    leg2 = {"hist_call_s": t1 - t0, "hist_launch_download_s":
            timing["decode_s"], "hist_framing_s": t1 - t0
            - timing["decode_s"], "hist_checks_s": t2 - t1,
            "decode_call_s": t3 - t2, "decode_check_s": time.time() - t3}

    t0 = time.time()
    for wire, run in (
            ("nx16_o1", lambda e: qualstats_device_o1(e, device=device)),
            ("4x8_o0", lambda e: qualstats_device_4x8(e, device=device)),
            ("4x8_o1", lambda e: qualstats_device_4x8(e, device=device,
                                                      o1=True))):
        w_raws, w_encs = leg3[wire][:2]
        hist, _ = run(w_encs)
        for i, raw in enumerate(w_raws):
            require(np.array_equal(hist[i], hist_of(raw, QBINS)),
                    f"leg 3 {wire} histogram of stream {i}")
    for wire, dec in (("nx16_o1", decode_nx16_o1_batch),
                      ("4x8_o0", decode_4x8_o0_batch)):
        w_raws, w_encs = leg3[wire][:2]
        require(dec(w_encs[:n_decode], device=device) == w_raws[:n_decode],
                f"leg 3 {wire} decoded bytes")
    secs["leg3"] = time.time() - t0

    t0 = time.time()
    for path, want in zip(FIXTURES, fixture_want):
        stats = {}
        fh = cram_qual_hist(path, device=device, stats=stats)
        name = os.path.basename(path)
        require(fh.tolist() == want["hist"], f"{name} histogram")
        require(stats["device_blocks"] > 0, f"{name} device blocks {stats}")
        require(stats == {"device_blocks": want["device_blocks"],
                          "host_blocks": want["host_blocks"]},
                f"{name} stats {stats}")
    secs["file"] = time.time() - t0

    t0 = time.time()
    enc_timing = {}
    out = encode_nx16_o0_batch(raws, device=device, timing=enc_timing)
    for i, (got, want) in enumerate(zip(out, encs)):
        require(got == want, f"leg 4 device encoding of stream {i}")
    require(len(out) == len(encs), "leg 4 stream count")
    require(decode_nx16_o0_batch(out[:n_decode], device=device)
            == raws[:n_decode], "leg 4 round trip through B2")
    secs["leg4"] = time.time() - t0
    notes = {"leg4_timing": enc_timing, "leg2": leg2}

    t0 = time.time()
    fn, fargs, ref_chain = make_resolve_bench(G=CHAINS, rounds=CHAIN_ROUNDS,
                                              device=device)
    t1 = time.time()
    got = fn(*fargs).cpu().numpy()
    notes["rans_resolve_lookups_per_s"] = CHAINS * CHAIN_ROUNDS / (
        time.time() - t1)
    require(np.array_equal(got, ref_chain().view(np.int32)),
            "leg 5 rANS resolve chain")
    fn, fargs, ref_step, v0 = make_huffman_resolve_bench(
        L=CHAINS, rounds=CHAIN_ROUNDS, device=device)
    t1 = time.time()
    got = fn(*fargs).cpu().numpy()
    notes["huffman_resolve_lookups_per_s"] = CHAINS * CHAIN_ROUNDS / (
        time.time() - t1)
    v = v0[0]
    for _ in range(CHAIN_ROUNDS):
        v, _sym = ref_step(v)
    require(np.array_equal(got, np.broadcast_to(v, got.shape)),
            "leg 5 Huffman resolve chain")
    secs["leg5"] = time.time() - t0
    return args, secs, notes


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of fn over `iters` calls, from CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def bound_ms(n_bytes: float, n_ops: float):
    """The least time for the work: bytes over the memory rate or
    operations over the scalar rate, whichever is larger."""
    tb = n_bytes / HBM_BYTES_S * 1e3
    to = n_ops / SCALAR_OPS_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def kernels_vs_plain(seq4_d, encs, launches):
    """Phase 6: each kernel against its plain version on the same card
    tensors, with times.  Returns the rows of the kernels line."""
    import torch

    from htslib_tpu_torch.ops.device_stats import QBINS
    from htslib_tpu_torch.ops import rans_nx16
    from htslib_tpu_torch.ops.rans_nx16 import (frame_streams, rans_o0_cuda,
                                                rans_o0_plain)
    from htslib_tpu_torch.ops.seqfmt import (nibble_to_base_cuda,
                                             nibble_to_base_plain)
    rows = []
    got = nibble_to_base_cuda(seq4_d)
    ref = nibble_to_base_plain(seq4_d)
    require(torch.equal(got, ref), "B1 kernel != plain")
    # the library yardstick: one gather through a 256-entry table of
    # base pairs (u16), indexed by the packed byte
    pairs = nt16_numpy(np.arange(256, dtype=np.uint8)[:, None])
    lut2 = torch.from_numpy(pairs.view(np.int16)[:, 0].copy()).to(
        seq4_d.device)
    lib = lut2[seq4_d.long()].view(torch.uint8)
    require(torch.equal(lib, ref), "B1 library yardstick != plain")
    n = seq4_d.numel()
    b_ms, b_by = bound_ms(3 * n, 6 * n)
    rows.append({
        "name": "nibble_to_base", "route": "cuda",
        "source": "htslib_tpu_torch/csrc/nibble.cu",
        "replaces": "htslib_tpu/ops/seqfmt.py:54",
        "launches": launches["nibble_to_base"],
        "max_abs_err": int((got.int() - ref.int()).abs().max()),
        "ms": cuda_ms(lambda: nibble_to_base_cuda(seq4_d), 50),
        "plain_ms": cuda_ms(lambda: nibble_to_base_plain(seq4_d), 10),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: lut2[seq4_d.long()], 10),
        "shape": list(seq4_d.shape), "match": True})

    for key, blocks, qb, line in (
            ("rans_nx16_o0_decode", encs[:N_DECODE], None, 234),
            ("rans_nx16_o0_hist", encs, QBINS, 323)):
        b = frame_streams(blocks, seq4_d.device)
        offs = torch.zeros(b.n_streams, dtype=torch.int32,
                           device=seq4_d.device)
        got = rans_o0_cuda(b, offs=offs, qbins=qb)
        torch.cuda.synchronize()
        t0 = time.time()
        ref = rans_o0_plain(b, offs=offs, qbins=qb)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        for g, r, what in zip(got, ref, ("output", "states", "cursors")):
            require(torch.equal(g, r), f"{key} kernel != plain ({what})")
        n_sym = b.total_out
        n_out = n_sym if qb is None else 4 * qb * b.n_streams
        # per symbol: mask, table lookup, two table loads, shift,
        # multiply-add, subtract, compare, and the store or bin
        b_ms, b_by = bound_ms(sum(len(x) for x in blocks) + n_out,
                              10 * n_sym)
        rows.append({
            "name": key, "route": "cuda",
            "source": "htslib_tpu_torch/csrc/rans_nx16_o0.cu",
            "replaces": f"htslib_tpu/ops/rans_pallas.py:{line}",
            "launches": launches[key],
            "max_abs_err": int((got[0].long() - ref[0].long()).abs().max()),
            "ms": cuda_ms(lambda: rans_o0_cuda(b, offs=offs, qbins=qb), 5),
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "streams": b.n_streams, "symbols": n_sym,
            "chain_rounds": -(-int(b.ulen.max()) // 32),
            # a checkout older than the kernels' blocks_per_sm gives None
            "streams_per_sm": (rans_nx16.blocks_per_sm(qb) if hasattr(
                rans_nx16, "blocks_per_sm") else None), "match": True})
    return rows


def leg3_kernels_vs_plain(device, leg3, launches):
    """Phase 6 for kernels B5-B8: each kernel against its plain version on
    the same card tensors, at full size over the first PLAIN_ROUNDS
    rounds and over whole streams on the 64 KiB batch, with times.
    Returns the rows of the kernels line."""
    import torch

    from htslib_tpu_torch.ops.device_stats import QBINS
    from htslib_tpu_torch.ops.rans4x8 import (blocks_per_sm, frame_4x8,
                                              rans4x8_cuda, rans4x8_plain)
    from htslib_tpu_torch.ops.rans_nx16_o1 import (_parse_o1_header,
                                                   frame_o1_streams,
                                                   rans_o1_cuda,
                                                   rans_o1_plain)

    def o1_batch(blocks):
        return frame_o1_streams([_parse_o1_header(e) for e in blocks],
                                device)

    def chain_o1(n, nway):   # the last state's length (order 1)
        return n - (nway - 1) * (n // nway)

    # (launch key, wire, streams, qbins, framing, kernel, plain, source,
    #  TPU kernel, chain rounds of a stream of n symbols, ops per symbol:
    #  mask, lookup (order 1: bucket, row and one compare more), two
    #  field extracts, multiply-add, compare, refill select, and the store
    #  or bin)
    specs = [
        ("rans_nx16_o1_decode", "nx16_o1", N_DECODE, None, o1_batch,
         rans_o1_cuda, rans_o1_plain, "rans_nx16_o1.cu",
         "rans_o1_pallas.py:98", lambda n: chain_o1(n, 32), 12),
        ("rans_nx16_o1_hist", "nx16_o1", None, QBINS, o1_batch,
         rans_o1_cuda, rans_o1_plain, "rans_nx16_o1.cu",
         "rans_o1_pallas.py:170", lambda n: chain_o1(n, 32), 12),
        ("rans4x8_o0_decode", "4x8_o0", N_DECODE, None,
         lambda e: frame_4x8(e, False, device), rans4x8_cuda, rans4x8_plain,
         "rans4x8.cu", "rans4x8_pallas.py:49", lambda n: -(-n // 4), 10),
        ("rans4x8_o0_hist", "4x8_o0", None, QBINS,
         lambda e: frame_4x8(e, False, device), rans4x8_cuda, rans4x8_plain,
         "rans4x8.cu", "rans4x8_pallas.py:120", lambda n: -(-n // 4), 10),
        ("rans4x8_o1_hist", "4x8_o1", None, QBINS,
         lambda e: frame_4x8(e, True, device), rans4x8_cuda, rans4x8_plain,
         "rans4x8.cu", "rans4x8_pallas.py:120", lambda n: chain_o1(n, 4),
         12),
    ]
    rows = []
    for (key, wire, n_streams, qb, frame, kern, plain, src, line, chain,
         ops) in specs:
        blocks = leg3[wire][1][:n_streams]
        b = frame(blocks)
        offs = torch.zeros(b.n_streams, dtype=torch.int32, device=device)
        got = kern(b, PLAIN_ROUNDS, offs, qb)
        torch.cuda.synchronize()
        t0 = time.time()
        ref = plain(b, PLAIN_ROUNDS, offs, qb)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        for g, r, what in zip(got, ref, ("output", "states", "cursors",
                                         "contexts")):
            require(torch.equal(g, r),
                    f"{key} kernel != plain over {PLAIN_ROUNDS} rounds "
                    f"({what})")
        err = int((got[0].long() - ref[0].long()).abs().max())
        small = frame(leg3[wire][3])
        soffs = torch.zeros(small.n_streams, dtype=torch.int32, device=device)
        for g, r, what in zip(kern(small, -1, soffs, qb),
                              plain(small, -1, soffs, qb),
                              ("output", "states", "cursors", "contexts")):
            require(torch.equal(g, r),
                    f"{key} kernel != plain on whole 64 KiB streams ({what})")
        n_sym = b.total_out
        n_out = n_sym if qb is None else 4 * qb * b.n_streams
        b_ms, b_by = bound_ms(sum(len(x) for x in blocks) + n_out,
                              ops * n_sym)
        rows.append({
            "name": key, "route": "cuda",
            "source": f"htslib_tpu_torch/csrc/{src}",
            "replaces": f"htslib_tpu/ops/{line}",
            "launches": launches[key], "max_abs_err": err,
            "ms": cuda_ms(lambda: kern(b, -1, offs, qb), 3),
            "plain_ms": plain_ms, "plain_rounds": PLAIN_ROUNDS,
            "ms_at_plain_rounds": cuda_ms(
                lambda: kern(b, PLAIN_ROUNDS, offs, qb), 3),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "streams": b.n_streams, "symbols": n_sym,
            "chain_rounds": max(chain(int(n)) for n in b.ulen.tolist()),
            "match": True})
        if key.startswith("rans4x8"):
            rows[-1]["streams_per_sm"] = blocks_per_sm(qb is not None, b.o1)
        else:
            rows[-1].update(o1_table_notes(b, offs, qb))
    # B5, B6 and B8 order 1 over a whole wide-alphabet stream, whose
    # lookups meet slow buckets (B5/B6: their maps; B8: the walk)
    wide = o1_batch([leg3["nx16_o1_wide"][1]])
    n_fall = fallback_buckets(wide.tables)
    require(n_fall > 0, "wide Nx16 order-1 stream: no slow bucket")
    woffs = torch.zeros(1, dtype=torch.int32, device=device)
    for row, qb in zip(rows[:2], (None, QBINS)):
        slow = torch.zeros(1, dtype=torch.int32, device=device)
        for g, r, what in zip(rans_o1_cuda(wide, -1, woffs, qb, slow),
                              rans_o1_plain(wide, -1, woffs, qb),
                              ("output", "states", "cursors", "contexts")):
            require(torch.equal(g, r), f"{row['name']} kernel != plain on "
                    f"the whole wide-alphabet stream ({what})")
        rounds = int(wide.ulen[0]) - 31 * (int(wide.ulen[0]) // 32)
        require(int(slow[0]) > 0, f"{row['name']}: no round of the wide "
                "stream met a slow bucket")
        row["wide_stream"] = {"bytes": int(wide.ulen[0]),
                              "fallback_buckets": n_fall,
                              "slow_share": int(slow[0]) / rounds,
                              "match": True}
    wide = frame_4x8([leg3["4x8_o1_wide"][1]], True, device)
    n_fall = fallback_buckets(wide.tables)
    require(n_fall > 0, "wide 4x8 order-1 stream: no bucket reaches the "
            "lookup's loop")
    woffs = torch.zeros(1, dtype=torch.int32, device=device)
    for g, r, what in zip(rans4x8_cuda(wide, -1, woffs, QBINS),
                          rans4x8_plain(wide, -1, woffs, QBINS),
                          ("output", "states", "cursors", "contexts")):
        require(torch.equal(g, r), "rans4x8_o1_hist kernel != plain on the "
                f"whole wide-alphabet stream ({what})")
    rows[-1]["wide_stream"] = {"bytes": int(wide.ulen[0]),
                               "fallback_buckets": n_fall, "match": True}
    return rows


def o1_table_notes(b, offs, qb):
    """Of kernel B5 (qb None) or B6 on batch b: its shared memory a block,
    the streams one SM holds, the slow buckets of stream 0 and the share
    of rounds in which some state's bucket was slow (its lookup took the
    bucket's map)."""
    import torch

    from htslib_tpu_torch.ops import rans_nx16_o1 as to1
    slow = torch.zeros(b.n_streams, dtype=torch.int32, device=offs.device)
    to1.rans_o1_cuda(b, -1, offs, qb, slow)
    n = b.ulen.long()
    return {"smem_bytes": to1.o1_smem_bytes(b.tables, qb is not None),
            "streams_per_sm": to1.blocks_per_sm(b.tables, qb is not None),
            "fallback_buckets": fallback_buckets(b.tables),
            "slow_share": float(slow.sum()) / float((n - 31 * (n // 32))
                                                    .sum())}


def new_kernels_vs_plain(device, raws, leg3, launches):
    """Phase 6 for kernels B9, B4 and B10: each kernel against its plain
    version on the same card tensors, with times.  B9 at full size over
    the first PLAIN_ROUNDS rounds and over whole streams on the 64 KiB
    batches; B4 and B10 over all CHAIN_ROUNDS steps.  Returns the rows of
    the kernels line."""
    import torch

    from htslib_tpu_torch.ops.huffman import (huffman_resolve_cuda,
                                              huffman_resolve_plain,
                                              make_huffman_resolve_bench)
    from htslib_tpu_torch.ops import huffman, rans_enc
    from htslib_tpu_torch.ops.rans_enc import (encode_nx16_o0_batch,
                                               frame_enc, rans_enc_cuda,
                                               rans_enc_plain)
    from htslib_tpu_torch.ops.rans_nx16 import (make_resolve_bench,
                                                rans_resolve_cuda,
                                                rans_resolve_plain)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.time() - t0) * 1e3

    rows = []
    b = frame_enc(raws, device)
    got = rans_enc_cuda(b, PLAIN_ROUNDS)
    ref, plain_ms = timed(lambda: rans_enc_plain(b, PLAIN_ROUNDS))
    for g, r, what in zip(got, ref, ("words", "states", "counts")):
        require(torch.equal(g, r), f"rans_nx16_o0_encode kernel != plain "
                f"over {PLAIN_ROUNDS} rounds ({what})")
    err = int((got[0].long() - ref[0].long()).abs().max())
    small = frame_enc(leg3["4x8_o0"][2] + leg3["nx16_o1"][2], device)
    for g, r, what in zip(rans_enc_cuda(small), rans_enc_plain(small),
                          ("words", "states", "counts")):
        require(torch.equal(g, r), "rans_nx16_o0_encode kernel != plain "
                f"on whole 64 KiB streams ({what})")
    edge_raw = enc_edge_streams()
    edge = frame_enc(edge_raw, device)
    for g, r, what in zip(rans_enc_cuda(edge), rans_enc_plain(edge),
                          ("words", "states", "counts")):
        require(torch.equal(g, r), "rans_nx16_o0_encode kernel != plain "
                f"on the edge streams ({what})")
    require(encode_nx16_o0_batch(edge_raw, device=device)
            == [_encode(d) for d in edge_raw],
            "rans_nx16_o0_encode edge streams != host codec")
    f = edge.freqs
    edge_note = {"lengths": [len(d) for d in edge_raw],
                 "f1_symbols": int((f == 1).sum()),
                 "one_symbol_streams": int((f == 4096).sum()),
                 "match": True}
    full = rans_enc_cuda(b)
    n_sym = sum(len(r) for r in raws)
    # bytes: the symbols in, the emitted words and final states out; per
    # symbol: table load, compare, select, shift, divide, remainder,
    # shift, two adds, ballot, popcount and store (12 operations: the
    # step's work, counted as the division form does it whatever the
    # kernel does it with)
    b_ms, b_by = bound_ms(n_sym + 2 * int(full[2].long().sum())
                          + 4 * full[1].numel(), 12 * n_sym)
    rows.append({
        "name": "rans_nx16_o0_encode", "route": "cuda",
        "source": "htslib_tpu_torch/csrc/rans_nx16_enc.cu",
        "replaces": "htslib_tpu/ops/rans_enc_pallas.py:89",
        "launches": launches["rans_nx16_o0_encode"], "max_abs_err": err,
        "ms": cuda_ms(lambda: rans_enc_cuda(b), 3),
        "plain_ms": plain_ms, "plain_rounds": PLAIN_ROUNDS,
        "ms_at_plain_rounds": cuda_ms(lambda: rans_enc_cuda(b, PLAIN_ROUNDS),
                                      3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "streams": b.n_streams, "symbols": n_sym,
        "chain_rounds": -(-max(len(r) for r in raws) // 32),
        # a checkout older than these exports gives None
        "smem_bytes": _export(rans_enc, "smem_bytes"),
        "streams_per_sm": _export(rans_enc, "blocks_per_sm"),
        "edge_streams": edge_note, "match": True})

    # (launch key, bench, kernel, plain, source, TPU kernel, operations
    #  per step: B4 mask, table load, two field extracts, shift,
    #  multiply-add, compare and renormalising select (8); B10 16 compares
    #  and their sum, two table loads, shift, add, subtract, range check,
    #  order load and the five-operation mix (47))
    specs = [
        ("rans_resolve_bench", lambda: make_resolve_bench(
            G=CHAINS, rounds=CHAIN_ROUNDS, device=device)[1],
         rans_resolve_cuda, rans_resolve_plain, "rans_resolve_bench.cu",
         "rans_pallas.py:542", 8),
        ("huffman_resolve_bench", lambda: make_huffman_resolve_bench(
            L=CHAINS, rounds=CHAIN_ROUNDS, device=device)[1],
         huffman_resolve_cuda, huffman_resolve_plain, "huffman_resolve.cu",
         "huffman_pallas.py:116", 47),
    ]
    for key, bench, kern, plain, src, line, ops in specs:
        targs = bench()
        got = kern(*targs, CHAIN_ROUNDS)
        ref, plain_ms = timed(lambda: plain(*targs, CHAIN_ROUNDS))
        require(torch.equal(got, ref), f"{key} kernel != plain")
        ms = cuda_ms(lambda: kern(*targs, CHAIN_ROUNDS), 3)
        n_bytes = sum(t.numel() * t.element_size() for t in targs) \
            + got.numel() * got.element_size()
        b_ms, b_by = bound_ms(n_bytes, ops * CHAINS * CHAIN_ROUNDS)
        rows.append({
            "name": key, "route": "cuda",
            "source": f"htslib_tpu_torch/csrc/{src}",
            "replaces": f"htslib_tpu/ops/{line}",
            "launches": launches[key],
            "max_abs_err": int((got.long() - ref.long()).abs().max()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "chains": CHAINS,
            "chain_rounds": CHAIN_ROUNDS,
            "lookups_per_s": CHAINS * CHAIN_ROUNDS / (ms / 1e3),
            "match": True})
    rows[-1].update({
        "smem_bytes": _export(huffman, "smem_bytes"),
        "chains_per_sm": _export(huffman, "chains_per_sm"),
        "bound_note": "47 operations a step: the canonical resolve's work, "
                      "counted so whatever implements it"})
    return rows


def _export(module, fn: str):
    """module.fn(), or None where the checkout's module lacks it."""
    f = getattr(module, fn, None)
    return f() if f else None


def leg4_parts(raws, encs, device):
    """Leg 4's host side in parts: encode_nx16_o0_batch's steps run one by
    one over leg 2's raw streams, each ended by a synchronise (a second
    pass, after the main path's): the framing (bincounts, _norm_freqs and
    the upload), the wrapper's checks and allocation, the launch and
    kernel, payload_tails' gather and download, and the headers.  Returns
    seconds by part; the output must be leg 2's host encodings."""
    import torch

    from htslib_tpu_torch import _build
    from htslib_tpu_torch.codecs.rans4x16 import _write_freq_table, u7_put
    from htslib_tpu_torch.ops import rans_enc as te
    sync = torch.cuda.synchronize
    t0 = time.perf_counter()
    b = te.frame_enc(raws, device)
    sync()
    t1 = time.perf_counter()
    words, x_f, n_emit = te.rans_enc_cuda(b)
    sync()
    t2 = time.perf_counter()
    lib = _build.load("rans_nx16_enc")
    rc = lib.rans_nx16_enc_launch(
        b.syms.data_ptr(), b.off.data_ptr(), b.ulen.data_ptr(),
        b.freqs.data_ptr(), b.cum.data_ptr(), words.data_ptr(),
        x_f.data_ptr(), n_emit.data_ptr(), b.n_streams, -1,
        _build.stream_handle(b.syms))
    _build.check(lib, rc, "rans_nx16_o0_encode")
    sync()
    t3 = time.perf_counter()
    bodies = te.payload_tails(b, words, n_emit)
    t4 = time.perf_counter()
    x_fin = x_f.cpu().numpy().view(np.uint32).astype("<u4")
    freqs = b.freqs.cpu().numpy()
    out = []
    for i, d in enumerate(raws):
        head = bytearray([0x04])
        u7_put(head, len(d))
        _write_freq_table(head, freqs[i])
        out.append(bytes(head) + x_fin[i].tobytes() + bodies[i])
    t5 = time.perf_counter()
    require(out == encs, "leg 4 parts: encodings != host codec")
    return {"frame_s": t1 - t0, "checks_alloc_s": (t2 - t1) - (t3 - t2),
            "launch_kernel_s": t3 - t2, "tails_s": t4 - t3,
            "headers_s": t5 - t4, "total_s": t5 - t0}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isfile(os.path.join(REPO, "htslib_tpu_torch",
                                       "_build.py")):
        print("chip_smoke: htslib_tpu_torch/ not found beside the script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from htslib_tpu_torch import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = (smi.stdout.strip().splitlines()[0] if smi.returncode == 0
            else f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"card: {card}", flush=True)

    t0 = time.time()
    libs = _build.build()
    build_s = time.time() - t0
    print(f"build: {build_s:.1f} s", flush=True)
    for name, path in libs.items():
        with open(path + ".log") as fp:
            for line in fp:
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")

    t0 = time.time()
    batch = leg1_batch()
    raws, encs = leg2_streams()
    leg3 = leg3_streams()
    print(f"inputs: {time.time() - t0:.1f} s", flush=True)

    _build.reset_launches()
    args, secs, notes = main_path("cuda", batch, raws, encs, leg3)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"main path ok: {secs}, launches {launches}", flush=True)
    print(f"leg 2 wall: {secs['leg2']:.3f} s, parts {notes['leg2']}",
          flush=True)
    print(f"leg 3 wall: {secs['leg3']:.3f} s", flush=True)
    print(f"leg 4 wall: {secs['leg4']:.3f} s, timing "
          f"{notes['leg4_timing']}", flush=True)
    print(f"leg 5 wall: {secs['leg5']:.3f} s, lookups/s: rANS "
          f"{notes['rans_resolve_lookups_per_s']:.6g}, Huffman "
          f"{notes['huffman_resolve_lookups_per_s']:.6g}", flush=True)
    for k, v in launches.items():
        require(v >= 1, f"kernel {k} not launched on the main path")
    print(f"leg 4 host side in parts: {leg4_parts(raws, encs, 'cuda')}",
          flush=True)

    t0 = time.time()
    rows = kernels_vs_plain(args[1], encs, launches)
    print(f"phase 6, B1-B3: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    rows += leg3_kernels_vs_plain(args[1].device, leg3, launches)
    print(f"phase 6, B5-B8: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    rows += new_kernels_vs_plain(args[1].device, raws, leg3, launches)
    print(f"phase 6, B9, B4, B10: {time.time() - t0:.1f} s", flush=True)
    # the figure the chain-bound kernels are designed against
    for row in rows:
        if "chain_rounds" in row:
            row["ns_per_round"] = row["ms"] / row["chain_rounds"] * 1e6
    # leg 2's host side: its wall time less its two kernels' times
    kern_s = sum(r["ms"] for r in rows if r["name"] in (
        "rans_nx16_o0_hist", "rans_nx16_o0_decode")) / 1e3
    print(f"leg 2 host side: {secs['leg2'] - kern_s:.4f} s of "
          f"{secs['leg2']:.4f} s (kernels B3 + B2 {kern_s * 1e3:.3f} ms)",
          flush=True)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
