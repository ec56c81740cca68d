#!/usr/bin/env python3
"""Same-call comparison of builds of the rANS Nx16 order-0 kernels (B2,
B3) on one card.

    python3 -m htslib_tpu_torch.probe_rans_o0 --variant NAME=SOURCE[:D=V,...]
        [--variant ...] [--sizes S,...] [--iters N] [--out FILE]

Each variant is a `.cu` file with the C entry point `rans_nx16_o0_launch`
(this checkout's `csrc/rans_nx16_o0.cu`, a parent checkout's, or either
with `-D` defines), compiled with `_build.py`'s nvcc flags into a library
of its own under `build/probe/`, all variants at once.  The streams are
`bench_rans.py`'s 1 MiB `uniform` and `walk` kinds, copied into batches
of S streams.  For each kernel (B2, B3 at 64 bins), kind and S, every
variant's launch is checked against the host truth, then the variants
are timed in turns, forwards and back (A B C C B A), each the mean of
`--iters` launches from CUDA events.  Each line printed (and appended to
--out) is one JSON object: variant, kernel, kind, streams, ms (the mean
of its two turns), both turns, ns a round and, where the variant reports
it, the streams one SM holds.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_variant(name: str, spec: str) -> str:
    """Compile `SOURCE[:D=V,...]` into build/probe/<name>.so; returns the
    library's path."""
    from htslib_tpu_torch import _build
    src, _, defs = spec.partition(":")
    out_dir = os.path.join(_build.BUILD, "probe")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"{name}.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS,
           *[f"-D{d}" for d in defs.split(",") if d],
           "-I", os.path.dirname(os.path.abspath(src)), "-o", lib, src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    regs = [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
            if "registers" in ln or "spill" in ln]
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stderr[-3000:]}")
    print(f"built {name}: {' | '.join(regs)}", flush=True)
    return lib


def build_variant(name: str, spec: str) -> ctypes.CDLL:
    """Compile `SOURCE[:D=V,...]` and load it with the B2/B3 entry
    point's argument types."""
    h = ctypes.CDLL(compile_variant(name, spec))
    h.rans_nx16_o0_launch.argtypes = [ctypes.c_void_p] * 12 \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    h.rans_nx16_o0_launch.restype = ctypes.c_int
    return h


def launch(lib, b, offs, qbins):
    """One launch of a variant on batch b; returns its symbols or
    histogram (the wrapper's outputs, allocated as rans_o0_cuda does)."""
    import torch

    from htslib_tpu_torch import _build
    S, dev = b.n_streams, b.payload.device
    x_out = torch.empty((S, 32), dtype=torch.int32, device=dev)
    cur_out = torch.empty(S, dtype=torch.int32, device=dev)
    if qbins is None:
        res = torch.empty(b.total_out, dtype=torch.uint8, device=dev)
        out_ptr, hist_ptr = res.data_ptr(), None
    else:
        res = torch.empty((S, qbins), dtype=torch.int32, device=dev)
        out_ptr, hist_ptr = None, res.data_ptr()
    rc = lib.rans_nx16_o0_launch(
        b.payload.data_ptr(), b.word_off.data_ptr(), b.n_words.data_ptr(),
        b.freqs.data_ptr(), b.x0.data_ptr(), b.ulen.data_ptr(),
        b.out_off.data_ptr(), out_ptr, offs.data_ptr(), hist_ptr,
        x_out.data_ptr(), cur_out.data_ptr(), S, qbins or 0, -1,
        _build.stream_handle(b.payload))
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return res


def per_sm(lib, qbins):
    fn = getattr(lib, "rans_nx16_o0_blocks_per_sm", None)
    if fn is None:
        return None
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    return fn(int(qbins is not None), qbins or 0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", required=True)
    ap.add_argument("--sizes", default="8,40,1056")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--kinds", default="uniform,walk")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_rans_o0: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    from htslib_tpu_torch.bench_rans import (N_BASE, QBINS, _encode,
                                             base_streams, cuda_ms,
                                             replicate)
    from htslib_tpu_torch.ops.rans_nx16 import frame_streams

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi failed"
    specs = dict(v.split("=", 1) for v in args.variant)
    with ThreadPoolExecutor(max_workers=len(specs)) as pool:
        libs = dict(zip(specs, pool.map(build_variant, specs,
                                        specs.values())))
    dev = torch.device("cuda")
    raws = base_streams()
    lines = []
    for kind in args.kinds.split(","):
        base = frame_streams([_encode(d, "nx16_o0") for d in raws[kind]],
                             dev)
        truth = torch.from_numpy(np.frombuffer(b"".join(raws[kind]),
                                               np.uint8).copy()).to(dev)
        hist = torch.stack([torch.bincount(r.long().clamp(max=QBINS - 1),
                                           minlength=QBINS)
                            for r in truth.view(N_BASE, -1)]).int()
        for key, qbins in (("rans_nx16_o0_decode", None),
                           ("rans_nx16_o0_hist", QBINS)):
            for n_streams in [int(s) for s in args.sizes.split(",")]:
                k = n_streams // N_BASE
                b = replicate(base, k)
                offs = torch.zeros(b.n_streams, dtype=torch.int32,
                                   device=dev)
                want = truth.repeat(k) if qbins is None else hist.repeat(k, 1)
                for name, lib in libs.items():
                    if not torch.equal(launch(lib, b, offs, qbins), want):
                        raise RuntimeError(f"{name} {key} on {kind} at "
                                           f"{n_streams}: != host truth")
                order = list(libs) + list(libs)[::-1]
                turns = {name: [] for name in libs}
                for name in order:
                    turns[name].append(cuda_ms(
                        lambda: launch(libs[name], b, offs, qbins),
                        args.iters))
                for name in libs:
                    ms = sum(turns[name]) / len(turns[name])
                    line = {"variant": name, "kernel": key, "kind": kind,
                            "streams": b.n_streams, "ms": ms,
                            "turns_ms": turns[name],
                            "ns_per_round": ms / (len(raws[kind][0]) / 32)
                            * 1e6,
                            "streams_per_sm": per_sm(libs[name], qbins),
                            "card": card}
                    print(json.dumps(line), flush=True)
                    lines.append(line)
                del b
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as fp:
            for line in lines:
                fp.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
