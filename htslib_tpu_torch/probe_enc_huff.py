#!/usr/bin/env python3
"""Same-call comparison of builds of the rANS Nx16 order-0 encode (B9), of
the Huffman resolve chain (B10) and of the rANS resolve chain (B4) on one
card.

    python3 -m htslib_tpu_torch.probe_enc_huff [--enc NAME=SOURCE[:D=V,...]]
        [--huff NAME=SOURCE[:D=V,...]] [--resolve NAME=SOURCE[:D=V,...]]
        [--enc-sizes S,...] [--huff-sizes L,...] [--iters N] [--out FILE]
        [--sass DIR]

Each variant is a `.cu` file with B9's C entry point `rans_nx16_enc_launch`
(--enc), B10's `huffman_resolve_launch` (--huff) or B4's
`rans_resolve_bench_launch` (--resolve): this checkout's
`csrc/rans_nx16_enc.cu`, `csrc/huffman_resolve.cu` or
`csrc/rans_resolve_bench.cu`, a parent checkout's, or any with `-D`
defines.  All variants are compiled at
once (`probe_rans_o0.compile_variant`, `_build.py`'s nvcc flags), each
into a library of its own under `build/probe/`; with --sass each one's
`cuobjdump -sass` is written to DIR/<name>.sass.

B9: `bench_rans.py`'s four 1 MiB `uniform` and four `walk` streams (leg
2's kinds), copied into batches of S streams.  B10 and B4: the device
bench's chains (`make_huffman_resolve_bench`, `make_resolve_bench`, 32,768
steps) at L chains (--huff-sizes).  For each size every variant's launch is
checked against the host truth (B9: the host codec's final states and
words, `bench_rans.enc_truth`; B10: the numpy chain
`bench_rans.huff_truth`; B4: the bench's numpy `ref_chain`), then the
variants are timed in
turns, forwards and back (A B C C B A), each the mean of `--iters`
launches from CUDA events.
Each line printed (and appended to --out) is one JSON object: variant,
kernel, kind, streams or chains, ms (the mean of its two turns), both
turns, ns a round or step, and where the variant reports them its shared
memory a block and the streams or chains one SM holds.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import multiprocessing
import os
import subprocess
import sys
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAIN_ROUNDS = 32768


def _export(lib, fn: str):
    """lib's argumentless int export `fn`, or None where it lacks it."""
    f = getattr(lib, fn, None)
    if f is None:
        return None
    f.argtypes = []
    f.restype = ctypes.c_int
    return f()


def enc_outputs(b):
    """Zeroed output buffers of B9 for batch b, as rans_enc_cuda allocates
    them: (words, final states, words emitted)."""
    import torch
    S, dev = b.n_streams, b.syms.device
    return (torch.zeros(b.syms.numel(), dtype=torch.int16, device=dev),
            torch.zeros((S, 32), dtype=torch.int32, device=dev),
            torch.zeros(S, dtype=torch.int32, device=dev))


def enc_launch(lib, b, outs):
    """One launch of a B9 variant into outs (enc_outputs); returns outs.
    A launch rewrites every word the encode emits, so outs are zeroed
    once, outside the timed launches."""
    from htslib_tpu_torch import _build
    words, x_out, n_emit = outs
    S = b.n_streams
    rc = lib.rans_nx16_enc_launch(
        b.syms.data_ptr(), b.off.data_ptr(), b.ulen.data_ptr(),
        b.freqs.data_ptr(), b.cum.data_ptr(), words.data_ptr(),
        x_out.data_ptr(), n_emit.data_ptr(), S, -1,
        _build.stream_handle(b.syms))
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return words, x_out, n_emit


def huff_launch(lib, args, rounds: int):
    import torch

    from htslib_tpu_torch import _build
    v_out = torch.empty_like(args[4])
    rc = lib.huffman_resolve_launch(*[a.data_ptr() for a in args],
                                    v_out.data_ptr(), int(args[4].numel()),
                                    rounds, _build.stream_handle(v_out))
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return v_out


def resolve_launch(lib, args, rounds: int):
    import torch

    from htslib_tpu_torch import _build
    x_out = torch.empty_like(args[1])
    rc = lib.rans_resolve_bench_launch(args[0].data_ptr(), args[1].data_ptr(),
                                       x_out.data_ptr(), int(args[1].numel()),
                                       rounds, _build.stream_handle(x_out))
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return x_out


def turns_ms(fns: dict, iters: int) -> dict:
    """Each fn timed in turns forwards and back: {name: [ms, ms]}."""
    from htslib_tpu_torch.bench_rans import cuda_ms
    out = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        out[name].append(cuda_ms(fns[name], iters))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--enc", action="append", default=[])
    ap.add_argument("--huff", action="append", default=[])
    ap.add_argument("--resolve", action="append", default=[])
    ap.add_argument("--enc-sizes", default="8,40,1056")
    ap.add_argument("--huff-sizes", default="128,1056")
    ap.add_argument("--kinds", default="uniform,walk")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--sass", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_enc_huff: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from htslib_tpu_torch import _build
    from htslib_tpu_torch.bench_rans import (N_BASE, base_streams,
                                             enc_truth, enc_want,
                                             huff_truth, replicate_enc)
    from htslib_tpu_torch.ops.huffman import make_huffman_resolve_bench
    from htslib_tpu_torch.ops.rans_enc import frame_enc
    from htslib_tpu_torch.ops.rans_nx16 import make_resolve_bench
    from htslib_tpu_torch.probe_rans_o0 import compile_variant

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi failed"
    specs = {f"enc:{k}": v for k, v in (e.split("=", 1) for e in args.enc)}
    specs.update({f"huff:{k}": v for k, v in (e.split("=", 1)
                                               for e in args.huff)})
    specs.update({f"resolve:{k}": v for k, v in (e.split("=", 1)
                                                  for e in args.resolve)})
    with ThreadPoolExecutor(max_workers=max(1, len(specs))) as pool:
        paths = dict(zip(specs, pool.map(
            lambda kv: compile_variant(kv[0].replace(":", "_"), kv[1]),
            specs.items())))
    if args.sass:
        os.makedirs(args.sass, exist_ok=True)
        cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
        for name, path in paths.items():
            res = subprocess.run([cuobjdump, "-sass", path],
                                 capture_output=True, text=True)
            with open(os.path.join(args.sass, name.replace(":", "_")
                                   + ".sass"), "w") as fp:
                fp.write(res.stdout + res.stderr)
    libs = {}
    for name, path in paths.items():
        h = ctypes.CDLL(path)
        if name.startswith("enc:"):
            h.rans_nx16_enc_launch.argtypes = [ctypes.c_void_p] * 8 \
                + [ctypes.c_int] * 2 + [ctypes.c_void_p]
            h.rans_nx16_enc_launch.restype = ctypes.c_int
        elif name.startswith("resolve:"):
            h.rans_resolve_bench_launch.argtypes = [ctypes.c_void_p] * 3 \
                + [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
            h.rans_resolve_bench_launch.restype = ctypes.c_int
        else:
            h.huffman_resolve_launch.argtypes = [ctypes.c_void_p] * 6 \
                + [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
            h.huffman_resolve_launch.restype = ctypes.c_int
        libs[name] = h
    dev = torch.device("cuda")
    lines = []

    def emit(line):
        line["card"] = card
        print(json.dumps(line), flush=True)
        lines.append(line)

    enc = {k[4:]: v for k, v in libs.items() if k.startswith("enc:")}
    if enc:
        raws = base_streams()
        kinds = args.kinds.split(",")
        bases = {kind: frame_enc(raws[kind], dev) for kind in kinds}
        jobs = [(d, bases[kind].freqs[i].cpu().numpy()) for kind in kinds
                for i, d in enumerate(raws[kind])]
        with ProcessPoolExecutor(
                max_workers=min(8, len(jobs)),
                mp_context=multiprocessing.get_context("spawn")) as pool:
            cores = list(pool.map(enc_truth, *zip(*jobs)))
        for ki, kind in enumerate(kinds):
            base = bases[kind]
            want = enc_want(base, cores[ki * N_BASE:(ki + 1) * N_BASE])
            for n_streams in [int(s) for s in args.enc_sizes.split(",")]:
                k = n_streams // N_BASE
                b = replicate_enc(base, k)
                outs = {}
                for name, lib in enc.items():
                    outs[name] = enc_outputs(b)
                    w, x, ne = enc_launch(lib, b, outs[name])
                    if not (torch.equal(x, want[1].repeat(k, 1))
                            and torch.equal(ne, want[2].repeat(k))
                            and torch.equal(w[:-1], want[0][:-1].repeat(k))):
                        raise RuntimeError(f"{name} encode on {kind} at "
                                           f"{n_streams}: != host codec")
                turns = turns_ms({name: (lambda lib=lib, o=outs[name]:
                                         enc_launch(lib, b, o))
                                  for name, lib in enc.items()}, args.iters)
                rounds = -(-len(raws[kind][0]) // 32)
                for name, lib in enc.items():
                    ms = sum(turns[name]) / 2
                    emit({"variant": name, "kernel": "rans_nx16_o0_encode",
                          "kind": kind, "streams": b.n_streams, "ms": ms,
                          "turns_ms": turns[name],
                          "ns_per_round": ms / rounds * 1e6,
                          "smem_bytes": _export(
                              lib, "rans_nx16_enc_smem_bytes"),
                          "streams_per_sm": _export(
                              lib, "rans_nx16_enc_blocks_per_sm")})
                del b, outs, w, x, ne

    huff = {k[5:]: v for k, v in libs.items() if k.startswith("huff:")}
    for L in ([int(s) for s in args.huff_sizes.split(",")] if huff else []):
        targs = make_huffman_resolve_bench(L=L, rounds=CHAIN_ROUNDS,
                                           device=dev)[1]
        want = torch.from_numpy(huff_truth(targs, CHAIN_ROUNDS)).to(dev)
        for name, lib in huff.items():
            if not torch.equal(huff_launch(lib, targs, CHAIN_ROUNDS), want):
                raise RuntimeError(f"{name} Huffman chain at L={L}: != numpy")
        turns = turns_ms({name: (lambda lib=lib: huff_launch(
            lib, targs, CHAIN_ROUNDS)) for name, lib in huff.items()},
            args.iters)
        for name, lib in huff.items():
            ms = sum(turns[name]) / 2
            emit({"variant": name, "kernel": "huffman_resolve_bench",
                  "chains": L, "ms": ms, "turns_ms": turns[name],
                  "ns_per_step": ms / CHAIN_ROUNDS * 1e6,
                  "smem_bytes": _export(lib, "huffman_resolve_smem_bytes"),
                  "chains_per_sm": _export(
                      lib, "huffman_resolve_chains_per_sm")})

    res = {k[8:]: v for k, v in libs.items() if k.startswith("resolve:")}
    for G in ([int(s) for s in args.huff_sizes.split(",")] if res else []):
        _, targs, ref_chain = make_resolve_bench(G=G, rounds=CHAIN_ROUNDS,
                                                 device=dev)
        want = torch.from_numpy(ref_chain()[0].view(np.int32)).to(dev)
        for name, lib in res.items():
            if not torch.equal(resolve_launch(lib, targs, CHAIN_ROUNDS),
                               want):
                raise RuntimeError(f"{name} rANS chain at G={G}: != numpy")
        turns = turns_ms({name: (lambda lib=lib: resolve_launch(
            lib, targs, CHAIN_ROUNDS)) for name, lib in res.items()},
            args.iters)
        for name, lib in res.items():
            ms = sum(turns[name]) / 2
            emit({"variant": name, "kernel": "rans_resolve_bench",
                  "chains": G, "ms": ms, "turns_ms": turns[name],
                  "ns_per_step": ms / CHAIN_ROUNDS * 1e6,
                  "smem_bytes": _export(lib, "rans_resolve_bench_smem_bytes"),
                  "chains_per_sm": _export(
                      lib, "rans_resolve_bench_chains_per_sm")})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as fp:
            for line in lines:
                fp.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
