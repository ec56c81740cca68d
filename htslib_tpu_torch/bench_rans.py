#!/usr/bin/env python3
"""Batch-size sweep of the chain-bound kernels on one card: the rANS
decodes, Nx16 order 0 (B2, B3), Nx16 order 1 (B5, B6) and 4x8 (B7, and B8
of both orders), the Nx16 order-0 encode (B9) and the Huffman resolve
chain (B10).

    python3 -m htslib_tpu_torch.bench_rans [--label NAME] [--out FILE]
        [--kernels KEY,...] [--sizes S,...] [--iters N]

Run it from the root of a checkout: it times that checkout's kernels.
Four 1 MiB quality streams per kind are encoded on the host and copied on
the card into batches of S streams, each stream with its own payload and
tables.  The kinds: `uniform` over 20..40 (leg 2 of chip_smoke.py, and
4x8 order 0), `walk` (leg 2's random walks over 0..44: long constant runs
at 0 and 44), and `reads` (bounded random walks restarted every 100-bp
read, as leg 3, for the order-1 wires); B2 and B3 run on both leg-2
kinds.  For each kernel, kind and S: one launch checked against the host
truth (every stream's histogram or bytes), then the mean of `--iters`
launches from CUDA events.  Each line printed (and appended to --out) is
one JSON object: kernel, kind, streams, ms, ns a round (ms over one
stream's rounds: 32,768 for Nx16, 262,144 for 4x8), decoded MB/s, the
host-clock time of one synchronised call of the wrapper (its checks and
sizing, the launch and the kernel: wall_ms; first_wall_ms for the checked
first call, the process's first use of the kernel at the first size)
and, where the checkout's kernel reports it, the streams one SM holds.
B9 encodes the raw `uniform` and `walk` streams, each batch checked
against the host codec's final states and words (ns a round over 32,768
rounds, encoded MB/s); B10 runs the device bench's chains
(`make_huffman_resolve_bench`, 32,768 steps) at 128 to 1,056 chains,
each checked against a numpy chain (ns a step, lookups/s, chains an SM).
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
HUFF_SIZES = (128, 264, 528, 1056)   # B10 chains
CHAIN_ROUNDS = 32768                 # B10 steps (the device bench's depth)
ENC_KIND = ("uniform", "walk")       # B9's streams
# (launch key, wire, kind of stream, qbins, rounds of one stream)
KERNELS = (("rans_nx16_o0_decode", "nx16_o0", "uniform", None,
            STREAM_BYTES // 32),
           ("rans_nx16_o0_decode", "nx16_o0", "walk", None,
            STREAM_BYTES // 32),
           ("rans_nx16_o0_hist", "nx16_o0", "uniform", QBINS,
            STREAM_BYTES // 32),
           ("rans_nx16_o0_hist", "nx16_o0", "walk", QBINS,
            STREAM_BYTES // 32),
           ("rans_nx16_o1_decode", "nx16_o1", "reads", None,
            STREAM_BYTES // 32),
           ("rans_nx16_o1_hist", "nx16_o1", "reads", QBINS,
            STREAM_BYTES // 32),
           ("rans4x8_o0_decode", "4x8_o0", "uniform", None,
            STREAM_BYTES // 4),
           ("rans4x8_o0_hist", "4x8_o0", "uniform", QBINS,
            STREAM_BYTES // 4),
           ("rans4x8_o1_hist", "4x8_o1", "reads", QBINS, STREAM_BYTES // 4))


def base_streams(seed: int = 3):
    """N_BASE raw streams per kind: {"uniform": [...], "walk": [...],
    "reads": [...]}."""
    rng = np.random.default_rng(seed)
    uniform = [rng.integers(20, 41, STREAM_BYTES, dtype=np.uint8).tobytes()
               for _ in range(N_BASE)]
    k = -(-STREAM_BYTES // 100)
    reads = []
    for _ in range(N_BASE):
        q = np.clip(rng.integers(25, 38, (k, 1))
                    + np.cumsum(rng.integers(-2, 3, (k, 100)), axis=1), 2, 41)
        reads.append(q.reshape(-1)[:STREAM_BYTES].astype(np.uint8).tobytes())
    walk = [np.clip(np.cumsum(rng.integers(-2, 3, STREAM_BYTES)) + 20, 0, 44)
            .astype(np.uint8).tobytes() for _ in range(N_BASE)]
    return {"uniform": uniform, "walk": walk, "reads": reads}


def _encode(data: bytes, wire: str) -> bytes:
    from htslib_tpu_torch.codecs import rans4x8, rans4x16
    if wire.startswith("nx16"):
        return rans4x16.compress(data, 0x05 if wire == "nx16_o1" else 0x04)
    return rans4x8.compress(data, int(wire[-1]))


def replicate(b, k: int):
    """Batch b (a 4x8, an Nx16 order-0 or an Nx16 order-1 batch) repeated
    k times on its device, every copy with its own payload bytes and
    tables."""
    import dataclasses

    import torch

    from htslib_tpu_torch.ops.rans_nx16 import Nx16Batch
    from htslib_tpu_torch.ops.rans_nx16_o1 import Nx16O1Batch, O1Tables
    dev = b.payload.device
    width = -(-b.payload.numel() // 4) * 4
    payload = torch.zeros((k, width), dtype=torch.uint8, device=dev)
    payload[:, :b.payload.numel()] = b.payload
    rep = torch.arange(k, device=dev)[:, None]
    ulen = b.ulen.repeat(k)
    common = dict(payload=payload.reshape(-1), x0=b.x0.repeat(k, 1),
                  ulen=ulen, out_off=torch.cumsum(ulen.long(), 0) - ulen.long())
    if isinstance(b, Nx16Batch):
        return dataclasses.replace(
            b, word_off=(b.word_off[None, :] + width // 2 * rep).reshape(-1),
            n_words=b.n_words.repeat(k), freqs=b.freqs.repeat(k, 1), **common)
    t = b.tables
    if t is not None:
        t = O1Tables(
            t.rows.repeat(k), (t.row_off[None, :] + t.rows.numel() * rep)
            .reshape(-1), t.n_rows.repeat(k), t.ctx_start.repeat(k, 1))
    if isinstance(b, Nx16O1Batch):
        return dataclasses.replace(
            b, word_off=(b.word_off[None, :] + width // 2 * rep).reshape(-1),
            n_words=b.n_words.repeat(k), tables=t, **common)
    return dataclasses.replace(
        b, byte_off=(b.byte_off[None, :] + width * rep).reshape(-1),
        n_bytes=b.n_bytes.repeat(k), freqs=b.freqs.repeat(k, 1), tables=t,
        **common)


def replicate_enc(b, k: int):
    """EncBatch b repeated k times on its device, every copy with its own
    symbols, region and tables."""
    import torch

    from htslib_tpu_torch.ops.rans_enc import EncBatch
    total = b.syms.numel() - 1   # the spare byte
    rep = torch.arange(k, device=b.syms.device)[:, None]
    return EncBatch(
        torch.cat([b.syms[:total].repeat(k), b.syms[total:]]),
        (b.off[None, :] + total * rep).reshape(-1), b.ulen.repeat(k),
        b.freqs.repeat(k, 1), b.cum.repeat(k, 1))


def enc_truth(data: bytes, freqs: np.ndarray) -> bytes:
    """The host codec's Nx16 order-0 32-way encode of data with the
    frequencies freqs [256]: its 32 final states (128 bytes), then its
    payload."""
    from htslib_tpu_torch.codecs.rans4x16 import _enc_core
    f = freqs.astype(np.int64)
    return _enc_core(np.frombuffer(data, np.uint8), f, np.cumsum(f) - f, 32)


def enc_want(b, cores):
    """Kernel B9's outputs for EncBatch b, from the host codec's encodings
    of its streams (enc_truth): (words int16, final states int32 [S, 32],
    words emitted int32 [S]) on b's device."""
    import torch
    dev = b.syms.device
    x = torch.from_numpy(np.stack([np.frombuffer(c[:128], "<u4").view(
        np.int32) for c in cores])).to(dev)
    words = torch.zeros(b.syms.numel(), dtype=torch.int16, device=dev)
    ends = (b.off + b.ulen.long()).tolist()
    n_emit = []
    for end, c in zip(ends, cores):
        body = np.frombuffer(c[128:], "<u2").view(np.int16)
        words[end - body.size:end] = torch.from_numpy(body.copy()).to(dev)
        n_emit.append(body.size)
    return words, x, torch.tensor(n_emit, dtype=torch.int32, device=dev)


def huff_truth(args, rounds: int) -> np.ndarray:
    """The Huffman resolve chain in numpy: `rounds` canonical resolves of
    every chain of the bench's tables args (limits, firsts, bases, order,
    v0); the last windows int32 [L]."""
    from htslib_tpu_torch.ops.huffman import MAXBITS, NSYM_PAD, next_window
    lim, first, base, order, v = [a.cpu().numpy().astype(np.int64)
                                  for a in args]
    cols = np.arange(v.size)
    bmf = base - first
    for _ in range(rounds):
        lstar = 1 + (v[None, :] >= lim).sum(0)
        code = np.where(lstar <= MAXBITS,
                        v >> np.clip(MAXBITS - lstar, 0, None), 0)
        idx = bmf[lstar - 1, cols] + code
        inside = (idx >= 0) & (idx < NSYM_PAD)
        sym = np.where(inside, order[np.where(inside, idx, 0), cols], 0)
        v = next_window(v, sym & 0xFFFFFFFF) & 0xFFFFFFFF
    return v.astype(np.int32)


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
    from htslib_tpu_torch.ops import rans_nx16 as t0
    from htslib_tpu_torch.ops import rans_nx16_o1 as to1
    hist = key.endswith("hist")
    if wire == "nx16_o0":
        per_sm = getattr(t0, "blocks_per_sm", None)
        return (lambda e: t0.frame_streams(e, dev),
                lambda b, offs, qb: t0.rans_o0_cuda(b, -1, offs, qb),
                per_sm and (lambda b: per_sm(QBINS if hist else None)))
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


def sweep_enc(raws, sizes, args, dev, card, sms):
    """B9 through its wrapper at each batch size, on each ENC_KIND."""
    import torch

    from htslib_tpu_torch.ops import rans_enc as te
    per_sm = getattr(te, "blocks_per_sm", None)
    bases = {kind: te.frame_enc(raws[kind], dev) for kind in ENC_KIND}
    jobs = [(d, bases[kind].freqs[i].cpu().numpy()) for kind in ENC_KIND
            for i, d in enumerate(raws[kind])]
    with ProcessPoolExecutor(max_workers=min(8, len(jobs)),
                             mp_context=multiprocessing.get_context("spawn")
                             ) as pool:
        cores = list(pool.map(enc_truth, *zip(*jobs)))
    lines = []
    for ki, kind in enumerate(ENC_KIND):
        want = enc_want(bases[kind], cores[ki * N_BASE:(ki + 1) * N_BASE])
        for n_streams in sizes:
            k = n_streams // N_BASE
            b = replicate_enc(bases[kind], k)
            first_ms, got = wall_ms(lambda: te.rans_enc_cuda(b))
            if not (torch.equal(got[0][:-1], want[0][:-1].repeat(k))
                    and torch.equal(got[1], want[1].repeat(k, 1))
                    and torch.equal(got[2], want[2].repeat(k))):
                raise RuntimeError(f"rans_nx16_o0_encode on {kind} at "
                                   f"{n_streams} streams: != host codec")
            ms = cuda_ms(lambda: te.rans_enc_cuda(b), args.iters)
            line = {"label": args.label, "kernel": "rans_nx16_o0_encode",
                    "kind": kind, "streams": b.n_streams, "ms": ms,
                    "ns_per_round": ms / (STREAM_BYTES // 32) * 1e6,
                    "MBps": (b.syms.numel() - 1) / ms / 1e3,
                    "wall_ms": wall_ms(lambda: te.rans_enc_cuda(b))[0],
                    "first_wall_ms": first_ms,
                    "streams_per_sm": per_sm() if per_sm else None,
                    "sms": sms, "card": card}
            print(json.dumps(line), flush=True)
            lines.append(line)
            del b, got
    return lines


def sweep_huff(args, dev, card, sms):
    """B10 through its wrapper at each of HUFF_SIZES chains."""
    import torch

    from htslib_tpu_torch.ops import huffman as th
    per_sm = getattr(th, "chains_per_sm", None)
    lines = []
    for L in HUFF_SIZES:
        targs = th.make_huffman_resolve_bench(L=L, rounds=CHAIN_ROUNDS,
                                              device=dev)[1]
        first_ms, got = wall_ms(lambda: th.huffman_resolve_cuda(
            *targs, CHAIN_ROUNDS))
        if not np.array_equal(got.cpu().numpy(),
                              huff_truth(targs, CHAIN_ROUNDS)):
            raise RuntimeError(f"huffman_resolve_bench at L={L}: != numpy")
        ms = cuda_ms(lambda: th.huffman_resolve_cuda(*targs, CHAIN_ROUNDS),
                     args.iters)
        line = {"label": args.label, "kernel": "huffman_resolve_bench",
                "chains": L, "ms": ms,
                "ns_per_step": ms / CHAIN_ROUNDS * 1e6,
                "lookups_per_s": L * CHAIN_ROUNDS / (ms / 1e3),
                "wall_ms": wall_ms(lambda: th.huffman_resolve_cuda(
                    *targs, CHAIN_ROUNDS))[0], "first_wall_ms": first_ms,
                "chains_per_sm": per_sm() if per_sm else None,
                "sms": sms, "card": card}
        print(json.dumps(line), flush=True)
        lines.append(line)
        del got
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out", default=None)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)))
    ap.add_argument("--kernels", default=",".join(
        list(dict.fromkeys(k[0] for k in KERNELS))
        + ["rans_nx16_o0_encode", "huffman_resolve_bench"]))
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
    pairs = sorted({(k[1], k[2]) for k in kernels})
    raws = base_streams()
    jobs = [(d, w) for w, kind in pairs for d in raws[kind]]
    encs = []
    if jobs:
        with ProcessPoolExecutor(
                max_workers=min(8, len(jobs)),
                mp_context=multiprocessing.get_context("spawn")) as pool:
            encs = list(pool.map(_encode, *zip(*jobs)))
    encs = {p: encs[i * N_BASE:(i + 1) * N_BASE] for i, p in enumerate(pairs)}
    truth = {o: torch.from_numpy(np.frombuffer(b"".join(raws[o]), np.uint8)
                                 .reshape(N_BASE, -1).copy()).to(dev)
             for o in {kind for _, kind in pairs}}
    hist = {o: torch.stack([torch.bincount(r.long().clamp(max=QBINS - 1),
                                           minlength=QBINS)
                            for r in truth[o]]).int() for o in truth}
    sizes = [int(s) for s in args.sizes.split(",")]
    lines = []
    for key, wire, kind, qbins, rounds in kernels:
        frame, run, per_sm = _kernel(key, wire, dev)
        base = frame(encs[wire, kind])
        for n_streams in sizes:
            k = n_streams // N_BASE
            b = replicate(base, k)
            offs = torch.zeros(b.n_streams, dtype=torch.int32, device=dev)
            first_ms, got = wall_ms(lambda: run(b, offs, qbins)[0])
            want = (truth[kind].repeat(k, 1).reshape(-1) if qbins is None
                    else hist[kind].repeat(k, 1))
            if not torch.equal(got, want):
                raise RuntimeError(f"{key} on {kind} at {n_streams} streams: "
                                   "kernel != host truth")
            ms = cuda_ms(lambda: run(b, offs, qbins), args.iters)
            line = {"label": args.label, "kernel": key, "kind": kind,
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
    if "rans_nx16_o0_encode" in keys:
        lines += sweep_enc(raws, sizes, args, dev, card, sms)
    if "huffman_resolve_bench" in keys:
        lines += sweep_huff(args, dev, card, sms)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as fp:
            for line in lines:
                fp.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
