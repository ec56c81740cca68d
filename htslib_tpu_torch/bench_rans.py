#!/usr/bin/env python3
"""Batch-size sweep of the chain-bound rANS decode kernels on one card:
Nx16 order 1 (B5, B6) and 4x8 (B7, and B8 of both orders).

    python3 -m htslib_tpu_torch.bench_rans [--label NAME] [--out FILE]
        [--kernels KEY,...] [--sizes S,...] [--iters N]

Run it from the root of a checkout: it times that checkout's kernels.
Four 1 MiB quality streams per kind are encoded on the host (uniform over
20..40 for 4x8 order 0; bounded random walks restarted every 100-bp read,
as leg 3 of chip_smoke.py, for the order-1 wires) and copied on the card
into batches of S streams, each stream with its own payload and tables.
For each kernel and S: one launch checked against the host truth (every
stream's histogram or bytes), then the mean of `--iters` launches from
CUDA events.  Each line printed (and appended to --out) is one JSON
object: kernel, streams, ms, ns a round (ms over one stream's rounds:
32,768 for Nx16, 262,144 for 4x8), decoded MB/s, the host-clock time of
one synchronised call of the wrapper (its checks and sizing, the launch
and the kernel: wall_ms; first_wall_ms for the checked first call, the
process's first use of the kernel at the first size) and, where the
checkout's kernel reports it, the streams one SM holds.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAM_BYTES = 1 << 20
N_BASE = 4
QBINS = 64
SIZES = (4, 8, 20, 132, 264, 528, 1056)
# (launch key, wire, qbins, rounds of one stream)
KERNELS = (("rans_nx16_o1_decode", "nx16_o1", None, STREAM_BYTES // 32),
           ("rans_nx16_o1_hist", "nx16_o1", QBINS, STREAM_BYTES // 32),
           ("rans4x8_o0_decode", "4x8_o0", None, STREAM_BYTES // 4),
           ("rans4x8_o0_hist", "4x8_o0", QBINS, STREAM_BYTES // 4),
           ("rans4x8_o1_hist", "4x8_o1", QBINS, STREAM_BYTES // 4))


def base_streams(seed: int = 3):
    """N_BASE raw streams per kind: {"o0": [...], "o1": [...]}."""
    rng = np.random.default_rng(seed)
    o0 = [rng.integers(20, 41, STREAM_BYTES, dtype=np.uint8).tobytes()
          for _ in range(N_BASE)]
    k = -(-STREAM_BYTES // 100)
    o1 = []
    for _ in range(N_BASE):
        q = np.clip(rng.integers(25, 38, (k, 1))
                    + np.cumsum(rng.integers(-2, 3, (k, 100)), axis=1), 2, 41)
        o1.append(q.reshape(-1)[:STREAM_BYTES].astype(np.uint8).tobytes())
    return {"o0": o0, "o1": o1}


def _encode(data: bytes, wire: str) -> bytes:
    from htslib_tpu_torch.codecs import rans4x8, rans4x16
    if wire == "nx16_o1":
        return rans4x16.compress(data, 0x05)
    return rans4x8.compress(data, int(wire[-1]))


def replicate(b, k: int):
    """Batch b (a 4x8 or an Nx16 order-1 batch) repeated k times on its
    device, every copy with its own payload bytes and tables."""
    import dataclasses

    import torch

    from htslib_tpu_torch.ops.rans_nx16_o1 import Nx16O1Batch, O1Tables
    dev = b.payload.device
    width = -(-b.payload.numel() // 4) * 4
    payload = torch.zeros((k, width), dtype=torch.uint8, device=dev)
    payload[:, :b.payload.numel()] = b.payload
    rep = torch.arange(k, device=dev)[:, None]
    t = b.tables
    if t is not None:
        t = O1Tables(
            t.rows.repeat(k), (t.row_off[None, :] + t.rows.numel() * rep)
            .reshape(-1), t.n_rows.repeat(k), t.ctx_start.repeat(k, 1))
    ulen = b.ulen.repeat(k)
    common = dict(payload=payload.reshape(-1), tables=t, x0=b.x0.repeat(k, 1),
                  ulen=ulen, out_off=torch.cumsum(ulen.long(), 0) - ulen.long())
    if isinstance(b, Nx16O1Batch):
        return dataclasses.replace(
            b, word_off=(b.word_off[None, :] + width // 2 * rep).reshape(-1),
            n_words=b.n_words.repeat(k), **common)
    return dataclasses.replace(
        b, byte_off=(b.byte_off[None, :] + width * rep).reshape(-1),
        n_bytes=b.n_bytes.repeat(k), freqs=b.freqs.repeat(k, 1), **common)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn over `iters` calls, from CUDA events."""
    import torch
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def wall_ms(fn):
    """(host-clock ms of one call of fn, synchronised before and after;
    fn's result)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, res


def _kernel(key: str, wire: str, dev):
    """(framing of encoded blocks, launch (batch, offs, qbins), streams an
    SM holds for a batch or None) of one kernel of the checkout."""
    from htslib_tpu_torch.ops import rans4x8 as t8
    from htslib_tpu_torch.ops import rans_nx16_o1 as to1
    hist = key.endswith("hist")
    if wire == "nx16_o1":
        per_sm = getattr(to1, "blocks_per_sm", None)
        return (lambda e: to1.frame_o1_streams(
                    [to1._parse_o1_header(x) for x in e], dev),
                lambda b, offs, qb: to1.rans_o1_cuda(b, -1, offs, qb),
                per_sm and (lambda b: per_sm(b.tables, hist)))
    per_sm = getattr(t8, "blocks_per_sm", None)
    o1 = wire == "4x8_o1"
    return (lambda e: t8.frame_4x8(e, o1, dev),
            lambda b, offs, qb: t8.rans4x8_cuda(b, -1, offs, qb),
            per_sm and (lambda b: per_sm(hist, o1)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out", default=None)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)))
    ap.add_argument("--kernels", default=",".join(k[0] for k in KERNELS))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_rans: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi failed"
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    keys = args.kernels.split(",")
    kernels = [k for k in KERNELS if k[0] in keys]
    wires = sorted({k[1] for k in kernels})
    raws = base_streams()
    jobs = [(d, w) for w in wires for d in raws[w[-2:]]]
    with ProcessPoolExecutor(max_workers=min(8, len(jobs)),
                             mp_context=multiprocessing.get_context("spawn")
                             ) as pool:
        encs = list(pool.map(_encode, *zip(*jobs)))
    encs = {w: encs[i * N_BASE:(i + 1) * N_BASE] for i, w in enumerate(wires)}
    truth = {o: torch.from_numpy(np.frombuffer(b"".join(raws[o]), np.uint8)
                                 .reshape(N_BASE, -1).copy()).to(dev)
             for o in ("o0", "o1")}
    hist = {o: torch.stack([torch.bincount(r.long().clamp(max=QBINS - 1),
                                           minlength=QBINS)
                            for r in truth[o]]).int() for o in truth}
    sizes = [int(s) for s in args.sizes.split(",")]
    lines = []
    for key, wire, qbins, rounds in kernels:
        frame, run, per_sm = _kernel(key, wire, dev)
        base = frame(encs[wire])
        for n_streams in sizes:
            k = n_streams // N_BASE
            b = replicate(base, k)
            offs = torch.zeros(b.n_streams, dtype=torch.int32, device=dev)
            first_ms, got = wall_ms(lambda: run(b, offs, qbins)[0])
            want = (truth[wire[-2:]].repeat(k, 1).reshape(-1) if qbins is None
                    else hist[wire[-2:]].repeat(k, 1))
            if not torch.equal(got, want):
                raise RuntimeError(f"{key} at {n_streams} streams: kernel "
                                   "!= host truth")
            ms = cuda_ms(lambda: run(b, offs, qbins), args.iters)
            line = {"label": args.label, "kernel": key,
                    "streams": b.n_streams, "ms": ms,
                    "ns_per_round": ms / rounds * 1e6,
                    "MBps": b.total_out / ms / 1e3,
                    "wall_ms": wall_ms(lambda: run(b, offs, qbins))[0],
                    "first_wall_ms": first_ms,
                    "streams_per_sm": per_sm(b) if per_sm else None,
                    "sms": sms, "card": card}
            print(json.dumps(line), flush=True)
            lines.append(line)
            del b, got
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as fp:
            for line in lines:
                fp.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
