#!/usr/bin/env python3
"""Same-call comparison of builds of kernel X1 (rANS 4x8 order-1 symbols;
with it X3 and B8 order 1, which share its round) and of kernel X5 (the
BAM record scan) on one card: the sweeps that set the order-1 table's
layout threshold (`ops/rans4x8.py` WIDE_WAVES) and X5's segmented-path
threshold (`ops/bam2sam.py` SEG_MIN_BYTES).

    python3 -m htslib_tpu_torch.probe_x1_x5 [--rans NAME=SOURCE ...]
        [--scan NAME=SOURCE ...] [--iters N] [--out FILE] [--sass DIR]

Each variant is a `.cu` file with the entry points of this checkout's
`csrc/rans4x8.cu` (`rans4x8_launch`; where the source has it,
`rans4x8_wide_launch`, timed as NAME-wide) or `csrc/record_scan.cu`
(`record_scan_launch`; where the source has it, `record_scan_seg_launch`,
timed as NAME-seg at 2^14, 2^15 and 2^16-byte segments), compiled with
`_build.py`'s nvcc flags into a library of its own under `build/probe/`,
all at once.  A parent checkout's sources are the old designs.

X1: 4, 20, 132, 528 and 1,056 streams of 1 MiB (20 distinct leg-3 walks,
repeated) and one stream of the qualities of 10,000 of leg 8's varied
records (about a CRAM 3.0 slice's quality block); B8 order 1 (histogram)
at 20, 132, 528 and 1,056 and X3 (the 4-way Nx16 order-1 wire) at 8 and
132 streams.  Every variant's output is checked against the raw bytes
(or the first variant's histogram), then the variants are timed in turns,
forwards and back (A B B A), each the mean of --iters launches from CUDA
events.  A line gives ms, ns a round of the longest stream, streams an SM
and waves.

X5: leg 1's records as a BAM record stream (201 bytes a record) at 100 to
400,000 records, and leg 8's 50,000 varied records: every variant's
offsets, sizes and n checked against the plain version, then timed in
turns; a line gives ms and ns a record.

--sass DIR: `cuobjdump -sass` of each build into DIR, for instruction
counts.  Each line printed (and appended to --out) is one JSON object
with the card's name and power limit.
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

X1_STREAMS = (4, 20, 132, 528, 1056)
B8_STREAMS = (20, 132, 528, 1056)
X3_STREAMS = (8, 132)
X5_RECORDS = (100, 200, 500, 1000, 2000, 5000, 10_000, 50_000, 100_000,
              400_000)
SEG_SHIFTS = (14, 15, 16)


def compile_variant(kind: str, name: str, src: str, sass_dir=None):
    """Compile SOURCE into build/probe/<kind>-<name>.so and load it with
    the argument types of _build's library `kind`."""
    from htslib_tpu_torch import _build
    out_dir = os.path.join(_build.BUILD, "probe")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"{kind}-{name}.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS,
           "-I", os.path.dirname(os.path.abspath(src)), "-o", lib, src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stderr[-3000:]}")
    regs = [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"built {kind} {name}: {' | '.join(regs)}", flush=True)
    if sass_dir:
        os.makedirs(sass_dir, exist_ok=True)
        cubin = os.path.join(out_dir, f"{kind}-{name}.cubin")
        subprocess.run([_build._nvcc(), *[f for f in _build.NVCC_FLAGS
                                          if f not in ("-shared",)],
                        "-cubin", "-I", os.path.dirname(os.path.abspath(src)),
                        "-o", cubin, src], capture_output=True, check=True)
        dump = subprocess.run([os.path.join(os.path.dirname(_build._nvcc()),
                                            "cuobjdump"), "-sass", cubin],
                              capture_output=True, text=True, check=True)
        with open(os.path.join(sass_dir, f"{kind}-{name}.sass"), "w") as fp:
            fp.write(dump.stdout)
    h = ctypes.CDLL(lib)
    for fn, argtypes in _build._SIGNATURES[kind].items():
        if hasattr(h, fn):
            getattr(h, fn).argtypes = argtypes
            getattr(h, fn).restype = ctypes.c_int
    h.kernel_error_string.argtypes = [ctypes.c_int]
    h.kernel_error_string.restype = ctypes.c_char_p
    return h


def _check(rc: int, what: str):
    if rc:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def rans_runner(lib, b, qbins, wide: bool):
    """A callable that runs one launch of a build on batch b (symbols, or
    with qbins B8's histogram): the compact table by rans4x8_launch, the
    wide one by rans4x8_wide_launch; it returns the output tensor."""
    import torch

    from htslib_tpu_torch import _build
    from htslib_tpu_torch.ops import rans4x8 as t8
    dev = b.payload.device
    S = b.n_streams
    t = b.tables
    slow = t8.max_slow(t)
    offs = torch.zeros(S, dtype=torch.int32, device=dev)

    def run():
        x_out = torch.empty((S, 4), dtype=torch.int32, device=dev)
        ctx_out = torch.empty((S, 4), dtype=torch.int32, device=dev)
        cur_out = torch.empty(S, dtype=torch.int32, device=dev)
        if qbins is None:
            res = torch.empty(b.total_out, dtype=torch.uint8, device=dev)
            out, hist = res.data_ptr(), None
        else:
            res = torch.empty((S, qbins), dtype=torch.int32, device=dev)
            out, hist = None, res.data_ptr()
        common = [b.payload.data_ptr(), b.byte_off.data_ptr(),
                  b.n_bytes.data_ptr(), b.freqs.data_ptr(),
                  t.rows.data_ptr(), t.row_off.data_ptr(),
                  t.n_rows.data_ptr(), t.ctx_start.data_ptr()]
        if wide:
            rc = lib.rans4x8_wide_launch(
                *common, b.x0.data_ptr(), b.ulen.data_ptr(),
                b.out_off.data_ptr(), out, offs.data_ptr(), hist,
                x_out.data_ptr(), cur_out.data_ptr(), ctx_out.data_ptr(), S,
                qbins or 0, -1, int(b.w16), slow,
                _build.stream_handle(b.payload))
        else:
            rc = lib.rans4x8_launch(
                *common, None, b.x0.data_ptr(), b.ulen.data_ptr(),
                b.out_off.data_ptr(), out, offs.data_ptr(), hist,
                x_out.data_ptr(), cur_out.data_ptr(), ctx_out.data_ptr(), S,
                qbins or 0, -1, 1, int(b.w16),
                _build.stream_handle(b.payload))
        _check(rc, "rans4x8 launch")
        return res
    return run


def rans_variants(libs):
    """{name: (lib, wide)}: each build's compact table, and its wide one
    where the build has it."""
    out = {}
    for name, lib in libs.items():
        out[name] = (lib, False)
        if hasattr(lib, "rans4x8_wide_launch"):
            out[name + "-wide"] = (lib, True)
    return out


def slice_qualities(n: int = 10_000) -> bytes:
    """The qualities of n of leg 8's varied records, concatenated as a
    CRAM slice's QS block holds them."""
    from chip_smoke import record_starts, varied_bam_stream
    stream = varied_bam_stream(n)
    out = bytearray()
    for p in record_starts(stream):
        l_name = stream[p + 12]
        n_cig = int.from_bytes(stream[p + 16:p + 18], "little")
        l_seq = int.from_bytes(stream[p + 20:p + 24], "little")
        q = p + 36 + l_name + 4 * n_cig + (l_seq + 1) // 2
        if l_seq and stream[q] != 0xFF:
            out += stream[q:q + l_seq]
    return bytes(out)


def rans_lines(libs, iters, card):
    import torch

    from chip_smoke import _encode_all, _walks, in_turns, torch_sms
    from htslib_tpu_torch.bench_rans import replicate
    from htslib_tpu_torch.ops import rans4x8 as t8
    import numpy as np
    dev = torch.device("cuda")
    sms = torch_sms(dev)
    raws = _walks(np.random.default_rng(3), 20, 1 << 20)
    qual = slice_qualities()
    encs = _encode_all(raws + raws[:8] + [qual],
                       ["4x8_o1"] * 20 + ["nx16_4way_o1"] * 8 + ["4x8_o1"])
    base = t8.frame_4x8(encs[:20], True, dev)
    base16 = t8.frame_nx16_4way(encs[20:28], True, dev)
    cases = [("x1", n, None, base, raws) for n in X1_STREAMS]
    cases.append(("x1_slice", 1, None, t8.frame_4x8(encs[28:], True, dev),
                  [qual]))
    cases += [("b8_o1", n, 64, base, raws) for n in B8_STREAMS]
    cases += [("x3", n, None, base16, raws[:8]) for n in X3_STREAMS]
    variants = rans_variants(libs)
    lines = []
    for kind, n, qbins, b0, rs in cases:
        k = -(-n // b0.n_streams)
        b = replicate(b0, k) if k > 1 else b0
        if b.n_streams > n:
            from dataclasses import replace

            from htslib_tpu_torch.ops.rans_nx16_o1 import O1Tables
            t = b.tables
            b = replace(b, byte_off=b.byte_off[:n], n_bytes=b.n_bytes[:n],
                        freqs=b.freqs[:n], x0=b.x0[:n], ulen=b.ulen[:n],
                        out_off=b.out_off[:n],
                        tables=O1Tables(t.rows, t.row_off[:n], t.n_rows[:n],
                                        t.ctx_start[:n]))
        want_syms = b"".join((rs * k)[:n])
        runs = {name: rans_runner(lib, b, qbins, wide)
                for name, (lib, wide) in variants.items()}
        first = None
        for name, run in runs.items():
            got = run()
            if qbins is None:
                if got.cpu().numpy().tobytes() != want_syms:
                    raise RuntimeError(f"{kind} {n} {name}: != raw bytes")
            elif first is None:
                first = got
            elif not torch.equal(got, first):
                raise RuntimeError(f"{kind} {n} {name}: histogram differs")
            del got
        ms, turns = in_turns(runs, iters)
        rounds = max(int(u) - 3 * (int(u) // 4) for u in b.ulen.tolist())
        slow = t8.max_slow(b.tables)
        for name, (lib, wide) in variants.items():
            hist = qbins is not None
            if wide:
                per_sm = lib.rans4x8_wide_blocks_per_sm(int(hist),
                                                         int(b.w16), slow)
            else:
                per_sm = lib.rans4x8_blocks_per_sm(int(hist), 1, int(b.w16),
                                                   0)
            line = {"probe": "rans4x8_o1", "kind": kind, "variant": name,
                    "layout": "wide" if wide else "compact",
                    "streams": n, "ms": ms[name], "turns_ms": turns[name],
                    "chain_rounds": rounds,
                    "ns_per_round": ms[name] / rounds * 1e6,
                    "streams_per_sm": per_sm, "max_slow": slow,
                    "waves": -(-n // (per_sm * sms)) if per_sm > 0 else None,
                    "card": card}
            print(json.dumps(line), flush=True)
            lines.append(line)
        del b, runs
        torch.cuda.empty_cache()
    return lines


def scan_runner(lib, t, n, shift):
    """A callable that runs one X5 launch of a build on payload t: the
    serial kernel (shift None) or the segmented one."""
    import torch

    from htslib_tpu_torch import _build
    dev = t.device
    u = t.numel()

    def run():
        offs = torch.empty(n, dtype=torch.int32, device=dev)
        sizes = torch.empty(n, dtype=torch.int32, device=dev)
        cnt = torch.empty((), dtype=torch.int32, device=dev)
        if shift is None:
            rc = lib.record_scan_launch(t.data_ptr(), u, n, offs.data_ptr(),
                                        sizes.data_ptr(), cnt.data_ptr(),
                                        _build.stream_handle(t))
        else:
            n_seg = -(-u >> shift)
            summ = torch.empty(5 * n_seg, dtype=torch.int32, device=dev)
            starts = torch.empty(n_seg << (shift - 2), dtype=torch.int16,
                                 device=dev)
            stats = torch.empty(4, dtype=torch.int32, device=dev)
            rc = lib.record_scan_seg_launch(
                t.data_ptr(), u, n, offs.data_ptr(), sizes.data_ptr(),
                cnt.data_ptr(), summ.data_ptr(), starts.data_ptr(),
                stats.data_ptr(), shift, _build.stream_handle(t))
        _check(rc, "record_scan launch")
        return offs, sizes, cnt
    return run


def scan_lines(libs, iters, card):
    import numpy as np
    import torch

    from chip_smoke import (bam_record_stream, in_turns, leg1_batch,
                            varied_bam_stream)
    from htslib_tpu_torch.ops import bam2sam as tb
    dev = torch.device("cuda")
    full = bam_record_stream(leg1_batch())
    per = 201
    cases = [("leg1", n, full[:n * per]) for n in X5_RECORDS]
    cases.append(("varied", 50_000, varied_bam_stream(50_000)))
    lines = []
    for kind, n, payload in cases:
        t = torch.from_numpy(np.frombuffer(payload, np.uint8).copy()).to(dev)
        runs = {}
        for name, lib in libs.items():
            runs[name] = scan_runner(lib, t, n, None)
            if hasattr(lib, "record_scan_seg_launch"):
                for sh in SEG_SHIFTS:
                    runs[f"{name}-seg{sh}"] = scan_runner(lib, t, n, sh)
        want = tb.record_scan_plain(t, n)
        for name, run in runs.items():
            if not all(torch.equal(g, w) for g, w in zip(run(), want)):
                raise RuntimeError(f"record_scan {kind} {n} {name}: != plain")
        ms, turns = in_turns(runs, iters)
        for name in runs:
            line = {"probe": "record_scan", "kind": kind, "variant": name,
                    "records": n, "bytes": len(payload), "ms": ms[name],
                    "turns_ms": turns[name],
                    "ns_per_record": ms[name] / n * 1e6, "card": card}
            print(json.dumps(line), flush=True)
            lines.append(line)
        del t
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rans", action="append", default=[])
    ap.add_argument("--scan", action="append", default=[])
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--sass", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_x1_x5: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi failed"
    specs = [("rans4x8",) + tuple(v.split("=", 1)) for v in args.rans] \
        + [("record_scan",) + tuple(v.split("=", 1)) for v in args.scan]
    with ThreadPoolExecutor(max_workers=max(1, len(specs))) as pool:
        built = list(pool.map(lambda s: compile_variant(*s, args.sass),
                              specs))
    rans = {n: h for (k, n, _), h in zip(specs, built) if k == "rans4x8"}
    scan = {n: h for (k, n, _), h in zip(specs, built) if k == "record_scan"}
    lines = []
    if scan:
        lines += scan_lines(scan, args.iters, card)
    if rans:
        lines += rans_lines(rans, args.iters, card)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as fp:
            for line in lines:
                fp.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
