#!/usr/bin/env python3
"""Same-call comparison of builds of kernel X4 (inflate) on one card, and
the sweep that sets kernel X6's (the BAQ HMM's) split between a warp a
read and a thread a read.

    python3 -m htslib_tpu_torch.probe_x4_x6 [--inflate NAME=SOURCE ...]
        [--sweep] [--iters N] [--out FILE]

X4: each variant is a `.cu` file with the entry points of this checkout's
`csrc/inflate.cu` (`inflate_launch`, `inflate_smem_bytes`,
`inflate_blocks_per_sm`, and where the source has them the slot variant's
`inflate_slot_launch`, `inflate_slot_smem_bytes`,
`inflate_slot_blocks_per_sm`, timed as NAME-slot), compiled with
`_build.py`'s nvcc flags into a library of its own under `build/probe/`,
all at once.  A parent checkout's source is the old design.  The batches:
chip_smoke.py's leg 7 members (1,232 zlib level-6 members of BAM
records), the first 792 of them (one wave of the ring variant on 132
SMs), the 1,232 repeated to 4,224 and to 16,016 members, and the 792
pieces deflated as literals only (zlib's Huffman-only strategy: a step a
literal, no match).  Every variant's output is checked against the raw
bytes, then the variants are timed in turns, forwards and back (A B B A),
each the mean of --iters launches from CUDA events.  A line gives ms, ns
a step of the longest member, shared memory a block, blocks an SM and
waves.

--sweep: this checkout's X6 on batches shaped as leg 9's reads
(`hmm_batch`) of 100 to 2,000 bp, 200 to 100,000 reads a batch, every
read a thread against every read a warp, in turns.

Each line printed (and appended to --out) is one JSON object with the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import zlib
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_variant(name: str, src: str) -> ctypes.CDLL:
    """Compile SOURCE into build/probe/inflate-<name>.so and load it with
    the argument types of _build's library "inflate"."""
    from htslib_tpu_torch import _build
    out_dir = os.path.join(_build.BUILD, "probe")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"inflate-{name}.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS,
           "-I", os.path.dirname(os.path.abspath(src)), "-o", lib, src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stderr[-3000:]}")
    regs = [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"built inflate {name}: {' | '.join(regs)}", flush=True)
    h = ctypes.CDLL(lib)
    for fn, argtypes in _build._SIGNATURES["inflate"].items():
        if hasattr(h, fn):
            getattr(h, fn).argtypes = argtypes
            getattr(h, fn).restype = ctypes.c_int
    h.kernel_error_string.argtypes = [ctypes.c_int]
    h.kernel_error_string.restype = ctypes.c_char_p
    return h


def inflate_variants(libs):
    """{name: (launch, smem bytes, blocks an SM)} of each build, and of
    its slot variant where the build has one."""
    out = {}
    for name, lib in libs.items():
        out[name] = (lib.inflate_launch, lib.inflate_smem_bytes(),
                     lib.inflate_blocks_per_sm())
        if hasattr(lib, "inflate_slot_launch"):
            out[name + "-slot"] = (lib.inflate_slot_launch,
                                   lib.inflate_slot_smem_bytes(),
                                   lib.inflate_slot_blocks_per_sm())
    return out


def inflate_lines(libs, iters, card):
    import torch

    from chip_smoke import (bam_record_stream, bgzf_members, deflate_raw,
                            in_turns, leg1_batch, torch_sms)
    from htslib_tpu_torch import _build
    from htslib_tpu_torch.ops import inflate as ti
    dev = torch.device("cuda")
    payloads, pieces = bgzf_members(bam_record_stream(leg1_batch()))
    # the same bytes as literals only: a step a literal, no match
    lits = [deflate_raw(p, 6, zlib.Z_HUFFMAN_ONLY) for p in pieces[:792]]
    sms = torch_sms(dev)
    variants = inflate_variants(libs)
    n_all = len(payloads)
    lines = []
    for kind, pls, pcs in (
            ("bam", payloads[:792], pieces[:792]),
            ("bam", payloads, pieces),
            ("bam", (payloads * 4)[:4224], (pieces * 4)[:4224]),
            ("bam", payloads * 13, pieces * 13),
            ("literals", lits, pieces[:792])):
        n = len(pls)
        b = ti.frame_members(pls, [len(p) for p in pcs], dev)
        offs = b.out_off.cpu().numpy()

        def run(launch, b=b):
            out = torch.empty(b.total_out, dtype=torch.uint8, device=dev)
            stats = torch.empty((b.n_members, 4), dtype=torch.int32,
                                device=dev)
            rc = launch(b.payload.data_ptr(), b.in_off.data_ptr(),
                        b.in_len.data_ptr(), out.data_ptr(),
                        b.out_off.data_ptr(), b.out_cap.data_ptr(),
                        stats.data_ptr(), b.n_members,
                        _build.stream_handle(b.payload))
            if rc:
                raise RuntimeError(f"inflate launch: CUDA error {rc}")
            return out, stats

        steps = {}
        for name, (launch, _, _) in variants.items():
            out, stats = run(launch)
            h = out.cpu().numpy()
            if bool(stats[:, 0].any()) or any(
                    h[o:o + len(p)].tobytes() != p
                    for o, p in zip(offs, pcs)):
                raise RuntimeError(f"inflate {name}: != the raw bytes")
            steps[name] = int(stats[:, 3].max())
            del out, stats
        ms, turns = in_turns({k: (lambda v=v: run(v[0]))
                              for k, v in variants.items()}, iters)
        for name, (_, smem, per_sm) in variants.items():
            line = {"probe": "inflate", "variant": name, "kind": kind,
                    "members": n, "leg7_members": n_all,
                    "ms": ms[name], "turns_ms": turns[name],
                    "longest_steps": steps[name],
                    "ns_per_step": ms[name] / steps[name] * 1e6,
                    "smem_bytes": smem, "blocks_per_sm": per_sm,
                    "waves": -(-n // (per_sm * sms)), "card": card}
            print(json.dumps(line), flush=True)
            lines.append(line)
        del b
        torch.cuda.empty_cache()
    return lines


def hmm_batch(n: int, length: int, seed: int, dtype):
    """chip_smoke.hmm_reads padded for the HMM: (arrays on the card, J)."""
    import torch

    from chip_smoke import hmm_reads
    from htslib_tpu_torch.ops import probaln as tp
    refs, qs, quals, bws = hmm_reads(n, length, seed)
    arrays, J = tp.pad_batch(refs, qs, quals, dtype=dtype, bws=bws)
    return [torch.from_numpy(a).cuda() for a in arrays], J


def sweep_lines(iters, card):
    import numpy as np
    import torch

    from chip_smoke import in_turns
    from htslib_tpu_torch.ops import probaln as tp
    lines = []
    for n, lengths in ((200, (100, 150, 250, 400, 600, 1000, 2000)),
                       (2000, (100, 150, 250, 400, 600, 1000, 2000)),
                       (20000, (100, 150, 250, 400)),
                       (30000, (100, 150, 250)),
                       (50000, (100, 150, 250)),
                       (100000, (100, 150, 250))):
        for length in lengths:
            a, J = hmm_batch(n, length, 7, np.float64)
            split = {"thread": torch.zeros(n, dtype=torch.bool,
                                           device=a[0].device),
                     "warp": torch.ones(n, dtype=torch.bool,
                                        device=a[0].device)}
            thread = tp.launch(*a, 0.001, 0.1, split["thread"])
            warp = tp.launch(*a, 0.001, 0.1, split["warp"])
            if not all(torch.equal(x, y) for x, y in zip(thread, warp)):
                raise RuntimeError(f"sweep {n} x {length}: warp != thread")
            ms, turns = in_turns(
                {k: (lambda m=m: tp.launch(*a, 0.001, 0.1, m))
                 for k, m in split.items()}, iters)
            line = {"probe": "probaln_sweep", "reads": n, "qlen": length,
                    "J": J, "thread_ms": ms["thread"], "warp_ms": ms["warp"],
                    "turns_ms": turns, "card": card}
            print(json.dumps(line), flush=True)
            lines.append(line)
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--inflate", action="append", default=[])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_x4_x6: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi failed"
    specs = [tuple(v.split("=", 1)) for v in args.inflate]
    libs = {}
    if specs:
        with ThreadPoolExecutor(max_workers=len(specs)) as pool:
            built = list(pool.map(lambda s: compile_variant(*s), specs))
        libs = {name: h for (name, _), h in zip(specs, built)}
    lines = []
    if libs:
        lines += inflate_lines(libs, args.iters, card)
    if args.sweep:
        lines += sweep_lines(args.iters, card)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as fp:
            for line in lines:
                fp.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
