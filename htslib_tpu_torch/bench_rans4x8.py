#!/usr/bin/env python3
"""Batch-size sweep of the rANS 4x8 kernels (B7, and B8 of both orders) on
one card.

    python3 -m htslib_tpu_torch.bench_rans4x8 [--label NAME] [--out FILE]

Run it from the root of a checkout: it times that checkout's kernels.
Four 1 MiB quality streams per order are encoded on the host (order 0
uniform over 20..40, order 1 bounded random walks restarted every 100-bp
read, as leg 3 of chip_smoke.py) and copied on the card into batches of S
streams, each stream with its own payload and tables.  For each kernel and
S: one launch checked against the host truth (every stream's histogram or
bytes), then the mean of `--iters` launches from CUDA events.  Each line
printed (and appended to --out) is one JSON object: kernel, streams, ms,
ns a round (ms over the 262,144 rounds of one stream), decoded MB/s and,
where the checkout's kernel reports it, the streams one SM holds.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import subprocess
import sys
from concurrent.futures import ProcessPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAM_BYTES = 1 << 20
N_BASE = 4
QBINS = 64
SIZES = (4, 8, 20, 132, 264, 528, 1056)
# (launch key, order, qbins)
KERNELS = (("rans4x8_o0_decode", 0, None), ("rans4x8_o0_hist", 0, QBINS),
           ("rans4x8_o1_hist", 1, QBINS))


def base_streams(seed: int = 3):
    """N_BASE raw streams per order: {0: [...], 1: [...]}."""
    rng = np.random.default_rng(seed)
    o0 = [rng.integers(20, 41, STREAM_BYTES, dtype=np.uint8).tobytes()
          for _ in range(N_BASE)]
    k = -(-STREAM_BYTES // 100)
    o1 = []
    for _ in range(N_BASE):
        q = np.clip(rng.integers(25, 38, (k, 1))
                    + np.cumsum(rng.integers(-2, 3, (k, 100)), axis=1), 2, 41)
        o1.append(q.reshape(-1)[:STREAM_BYTES].astype(np.uint8).tobytes())
    return {0: o0, 1: o1}


def _encode(data: bytes, order: int) -> bytes:
    from htslib_tpu_torch.codecs import rans4x8
    return rans4x8.compress(data, order)


def replicate(b, k: int):
    """Batch b repeated k times on its device, every copy with its own
    payload bytes and tables."""
    import torch

    from htslib_tpu_torch.ops.rans4x8 import Rans4x8Batch
    from htslib_tpu_torch.ops.rans_nx16_o1 import O1Tables
    dev = b.payload.device
    width = -(-b.payload.numel() // 4) * 4
    payload = torch.zeros((k, width), dtype=torch.uint8, device=dev)
    payload[:, :b.payload.numel()] = b.payload
    rep = torch.arange(k, device=dev)[:, None]
    tables = None
    if b.o1:
        t = b.tables
        tables = O1Tables(
            t.rows.repeat(k), (t.row_off[None, :] + t.rows.numel() * rep)
            .reshape(-1), t.n_rows.repeat(k), t.ctx_start.repeat(k, 1))
    ulen = b.ulen.repeat(k)
    return Rans4x8Batch(
        payload.reshape(-1), (b.byte_off[None, :] + width * rep).reshape(-1),
        b.n_bytes.repeat(k), b.freqs.repeat(k, 1), tables, b.x0.repeat(k, 1),
        ulen, torch.cumsum(ulen.long(), 0) - ulen.long())


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out", default=None)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_rans4x8: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from htslib_tpu_torch.ops import rans4x8 as t8

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi failed"
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    raws = base_streams()
    jobs = [(d, o) for o in (0, 1) for d in raws[o]]
    with ProcessPoolExecutor(max_workers=min(8, len(jobs)),
                             mp_context=multiprocessing.get_context("spawn")
                             ) as pool:
        encs = list(pool.map(_encode, *zip(*jobs)))
    encs = {0: encs[:N_BASE], 1: encs[N_BASE:]}
    truth = {o: torch.from_numpy(np.frombuffer(b"".join(raws[o]), np.uint8)
                                 .reshape(N_BASE, -1).copy()).to(dev)
             for o in (0, 1)}
    hist = {o: torch.stack([torch.bincount(r.long().clamp(max=QBINS - 1),
                                           minlength=QBINS)
                            for r in truth[o]]).int() for o in (0, 1)}
    sizes = [int(s) for s in args.sizes.split(",")]
    lines = []
    for key, order, qbins in KERNELS:
        base = t8.frame_4x8(encs[order], bool(order), dev)
        per_sm = (t8.blocks_per_sm(qbins is not None, bool(order))
                  if hasattr(t8, "blocks_per_sm") else None)
        for n_streams in sizes:
            k = n_streams // N_BASE
            b = replicate(base, k)
            offs = torch.zeros(b.n_streams, dtype=torch.int32, device=dev)
            got = t8.rans4x8_cuda(b, -1, offs, qbins)[0]
            want = (truth[order].repeat(k, 1).reshape(-1) if qbins is None
                    else hist[order].repeat(k, 1))
            if not torch.equal(got, want):
                raise RuntimeError(f"{key} at {n_streams} streams: kernel "
                                   "!= host truth")
            ms = cuda_ms(lambda: t8.rans4x8_cuda(b, -1, offs, qbins),
                         args.iters)
            rounds = -(-STREAM_BYTES // 4)
            line = {"label": args.label, "kernel": key,
                    "streams": b.n_streams, "ms": ms,
                    "ns_per_round": ms / rounds * 1e6,
                    "MBps": b.total_out / ms / 1e3,
                    "streams_per_sm": per_sm, "sms": sms, "card": card}
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
