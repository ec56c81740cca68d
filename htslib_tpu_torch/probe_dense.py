#!/usr/bin/env python3
"""Same-call comparison of builds of the order-1 variants for tables past
A2_MAX rows on one card: X1 and X3 (csrc/rans4x8.cu) and B5
(csrc/rans_nx16_o1.cu), each through the dense table in device memory and,
where the build has it, the large table in shared memory.  The sweep that
sets how many waves of the large variant a past-A2_MAX group may take
(`ops/rans4x8.py` and `ops/rans_nx16_o1.py` LARGE_WAVES).

    python3 -m htslib_tpu_torch.probe_dense --build NAME=CSRC_DIR ...
        [--streams 2,4,40,...] [--iters N] [--out FILE] [--sass DIR]

Each build is a directory holding `rans4x8.cu` and `rans_nx16_o1.cu` with
their headers (this checkout's `htslib_tpu_torch/csrc`, or a parent
checkout's), compiled with `_build.py`'s nvcc flags into libraries of
their own under `build/probe/`, all at once.  A build is timed as
NAME-dense (the dense variants, `rans4x8_launch` and `rans_nx16_o1_launch`
with a dense table) and, where its sources have the large table, as
NAME-large (`rans4x8_large_launch`, `rans_nx16_o1_launch` with `large`).

Inputs: uniform random bytes (4 distinct 1 MiB streams, all 65,536 rows)
and the HiFi-style quality block of chip_smoke.py (`hifi_qualities`,
1.16 MB, about 7,300 rows), each encoded on the three order-1 wires (4x8,
Nx16 4-way, Nx16 32-way) and repeated to 2, 4, 40, 132, 264, 528 and
1,056 streams.  Every variant's symbols are checked against the raw bytes
on the card, then the variants are timed in turns, forwards and back (A B
B A), each the mean of --iters launches from CUDA events.  A line gives
ms, ns a round of the longest stream, shared memory a block, streams an
SM and waves (the large variant's; the dense variants' blocks hold no
table), and, for the large variant of B5, the share of rounds in which a
lane walked.

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

STREAMS = (2, 4, 40, 132, 264, 528, 1056)
WIRES = ("4x8_o1", "nx16_4way_o1", "nx16_o1")
RANDOM_BYTES = 1 << 20
N_RANDOM = 4
# the parent's B5 entry point, before the error word and the large flag
OLD_NX16_O1_LAUNCH = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p]


def build_libs(name: str, csrc: str, sass_dir=None):
    """{kind: library} of one build: rans4x8 and rans_nx16_o1 from
    csrc."""
    from htslib_tpu_torch.probe_x1_x5 import compile_variant
    libs = {}
    for kind in ("rans4x8", "rans_nx16_o1"):
        libs[kind] = compile_variant(kind, name,
                                     os.path.join(csrc, f"{kind}.cu"),
                                     sass_dir)
    lib = libs["rans_nx16_o1"]
    if not hasattr(lib, "rans_nx16_o1_large_smem_bytes"):
        lib.rans_nx16_o1_launch.argtypes = OLD_NX16_O1_LAUNCH
    return libs


def has_large(libs) -> bool:
    return hasattr(libs["rans4x8"], "rans4x8_large_launch")


def _check(rc: int, what: str):
    if rc:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def runner(libs, b, wire: str, large: bool, slow=None):
    """A callable that runs one launch of a build's variant on batch b (the
    dense variant on its dense tables, or the large one on its rows) and
    returns its symbols."""
    import torch

    from htslib_tpu_torch import _build
    from htslib_tpu_torch.ops import rans_nx16_o1 as to1
    dev = b.payload.device
    S = b.n_streams
    nway = 32 if wire == "nx16_o1" else 4
    t = b.tables
    rows = int(t.n_rows.max()) if large else 0
    shift, smem = (large_shape(libs, b, nway) if large else (None, None))

    def run():
        x_out = torch.empty((S, nway), dtype=torch.int32, device=dev)
        ctx_out = torch.empty((S, nway), dtype=torch.int32, device=dev)
        cur_out = torch.empty(S, dtype=torch.int32, device=dev)
        out = torch.empty(b.total_out, dtype=torch.uint8, device=dev)
        err = _build.error_word(dev)
        st = _build.stream_handle(b.payload)
        t_ptrs = ([t.rows.data_ptr(), t.row_off.data_ptr(),
                   t.n_rows.data_ptr(), t.ctx_start.data_ptr()] if large
                  else [None] * 4)
        if nway == 4 and large:
            rc = libs["rans4x8"].rans4x8_large_launch(
                b.payload.data_ptr(), b.byte_off.data_ptr(),
                b.n_bytes.data_ptr(), b.freqs.data_ptr(), *t_ptrs,
                b.x0.data_ptr(), b.ulen.data_ptr(), b.out_off.data_ptr(),
                out.data_ptr(), x_out.data_ptr(), cur_out.data_ptr(),
                ctx_out.data_ptr(), err.data_ptr(), S, -1, int(b.w16), rows,
                shift, st)
        elif nway == 4:
            rc = libs["rans4x8"].rans4x8_launch(
                b.payload.data_ptr(), b.byte_off.data_ptr(),
                b.n_bytes.data_ptr(), b.freqs.data_ptr(), *t_ptrs,
                b.dense.data_ptr(), b.x0.data_ptr(), b.ulen.data_ptr(),
                b.out_off.data_ptr(), out.data_ptr(), None, None,
                x_out.data_ptr(), cur_out.data_ptr(), ctx_out.data_ptr(), S,
                0, -1, 1, int(b.w16), st)
        else:
            lib = libs["rans_nx16_o1"]
            head = [b.payload.data_ptr(), b.word_off.data_ptr(),
                    b.n_words.data_ptr(), *t_ptrs,
                    None if large else b.dense.data_ptr(), b.x0.data_ptr(),
                    b.ulen.data_ptr(), b.out_off.data_ptr(), out.data_ptr(),
                    None, None, x_out.data_ptr(), cur_out.data_ptr(),
                    ctx_out.data_ptr(),
                    None if slow is None else slow.data_ptr()]
            if lib.rans_nx16_o1_launch.argtypes == OLD_NX16_O1_LAUNCH:
                rc = lib.rans_nx16_o1_launch(
                    *head, S, 0, -1, to1.dense_smem_bytes(), st)
            else:
                rc = lib.rans_nx16_o1_launch(
                    *head, err.data_ptr(), S, 0, -1,
                    smem if large else to1.dense_smem_bytes(),
                    shift if large else 0, st)
        _check(rc, f"{wire} launch")
        _build.check_word(err, f"{wire} probe")
        return out
    return run


def large_shape(libs, b, nway: int):
    """(bucket shift, shared memory a block) of a build's large variant on
    batch b, as the port's wrappers choose them (`finest_shift`)."""
    import torch

    from htslib_tpu_torch.ops import rans_nx16_o1 as to1
    sms = torch.cuda.get_device_properties(
        b.payload.device).multi_processor_count
    rows = int(b.tables.n_rows.max())
    if nway == 4:
        lib = libs["rans4x8"]
        shift = to1.finest_shift(
            lambda k: lib.rans4x8_large_blocks_per_sm(int(b.w16), rows, k),
            b.n_streams, sms)
        return shift, lib.rans4x8_large_smem_bytes(rows, shift)
    lib = libs["rans_nx16_o1"]
    n_ctx = int(to1.o1_table_sizes(b.tables)[0].max())
    shift = to1.finest_shift(
        lambda k: lib.rans_nx16_o1_large_blocks_per_sm(
            lib.rans_nx16_o1_large_smem_bytes(rows, n_ctx, k)),
        b.n_streams, sms)
    return shift, lib.rans_nx16_o1_large_smem_bytes(rows, n_ctx, shift)


def batches(dev, kind: str, wire: str, n: int, base):
    """(dense batch, large batch, raw symbols on the card) of n streams of
    `kind` on `wire`: the encoded bases framed once (the first n where n is
    fewer) and repeated on the card."""
    import numpy as np
    import torch

    from htslib_tpu_torch.bench_rans import replicate
    from htslib_tpu_torch.ops import rans4x8 as t8
    from htslib_tpu_torch.ops import rans_nx16_o1 as to1
    raws, encs = base[kind][0], base[kind][1][wire]
    raws, encs = raws[:n], encs[:n]
    reps = n // len(encs)
    if reps * len(encs) != n:
        raise ValueError(f"{n} streams: not a multiple of {len(encs)}")
    want = torch.from_numpy(np.frombuffer(b"".join(raws * reps),
                                          dtype=np.uint8).copy()).to(dev)
    out = []
    for dense in (True, False):
        if wire == "nx16_o1":
            b = to1.frame_o1_streams([to1._parse_nx16_header(e)
                                      for e in encs], dev, dense=dense,
                                     large=not dense)
        else:
            frame = t8.frame_4x8 if wire == "4x8_o1" else t8.frame_nx16_4way
            b = frame(encs, True, dev, dense=dense, large=not dense)
        out.append(replicate(b, reps) if reps > 1 else b)
    return out[0], out[1], want


def inputs(seed: int = 16):
    """{kind: (raws, {wire: encoded})}: N_RANDOM random 1 MiB streams and
    the HiFi-style block, on every order-1 wire."""
    import numpy as np

    from chip_smoke import _encode_all, hifi_qualities
    rng = np.random.default_rng(seed)
    rand = [rng.integers(0, 256, RANDOM_BYTES, dtype=np.uint8).tobytes()
            for _ in range(N_RANDOM)]
    hifi = [hifi_qualities()]
    jobs = [(w, d) for w in WIRES for d in rand + hifi]
    encs = _encode_all([d for _, d in jobs], [w for w, _ in jobs])
    out = {"random": (rand, {}), "hifi": (hifi, {})}
    k = 0
    for w in WIRES:
        out["random"][1][w] = encs[k:k + N_RANDOM]
        out["hifi"][1][w] = [encs[k + N_RANDOM]]
        k += N_RANDOM + 1
    return out


def lines(builds, sizes, iters, card):
    import torch

    from chip_smoke import in_turns, torch_sms
    from htslib_tpu_torch.ops import rans4x8 as t8
    from htslib_tpu_torch.ops import rans_nx16_o1 as to1
    dev = torch.device("cuda")
    sms = torch_sms(dev)
    base = inputs()
    out = []
    for wire in WIRES:
        nway = 32 if wire == "nx16_o1" else 4
        for kind in ("random", "hifi"):
            for n in sizes:
                bd, bl, want = batches(dev, kind, wire, n, base)
                slow = torch.zeros(n, dtype=torch.int32, device=dev)
                runs, meta = {}, {}
                for name, libs in builds.items():
                    runs[name + "-dense"] = runner(libs, bd, wire, False)
                    meta[name + "-dense"] = (libs, False)
                    if has_large(libs):
                        runs[name + "-large"] = runner(
                            libs, bl, wire, True,
                            slow if nway == 32 else None)
                        meta[name + "-large"] = (libs, True)
                for name, run in runs.items():
                    if not torch.equal(run(), want):
                        raise RuntimeError(f"{wire} {kind} {n} {name}: "
                                           "!= raw bytes")
                ms, turns = in_turns(runs, iters)
                ulen = max(bl.ulen.tolist())
                rounds = ulen - (nway - 1) * (ulen // nway)
                rows = int(bl.tables.n_rows.max())
                for name in runs:
                    libs, large = meta[name]
                    line = {"probe": "dense_o1", "wire": wire, "kind": kind,
                            "variant": name, "streams": n, "ms": ms[name],
                            "turns_ms": turns[name], "chain_rounds": rounds,
                            "ns_per_round": ms[name] / rounds * 1e6,
                            "rows": rows, "card": card}
                    if large:
                        shift, smem = large_shape(libs, bl, nway)
                        if nway == 4:
                            per_sm = libs[
                                "rans4x8"].rans4x8_large_blocks_per_sm(
                                    int(bl.w16), rows, shift)
                        else:
                            per_sm = libs["rans_nx16_o1"]\
                                .rans_nx16_o1_large_blocks_per_sm(smem)
                            # one launch's walked rounds
                            slow.zero_()
                            runs[name]()
                            line["slow_share"] = float(
                                slow.double().mean()) / rounds
                        line.update(shift=shift, smem_bytes=smem,
                                    streams_per_sm=per_sm,
                                    waves=-(-n // (per_sm * sms))
                                    if per_sm > 0 else None)
                    print(json.dumps(line), flush=True)
                    out.append(line)
                del bd, bl, want, runs
                torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--build", action="append", default=[],
                    help="NAME=CSRC_DIR")
    ap.add_argument("--streams", default=",".join(map(str, STREAMS)))
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--out", default=None)
    ap.add_argument("--sass", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_dense: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi failed"
    specs = [tuple(v.split("=", 1)) for v in args.build] or [
        ("tree", os.path.join(ROOT, "htslib_tpu_torch", "csrc"))]
    with ThreadPoolExecutor(max_workers=len(specs)) as pool:
        built = list(pool.map(lambda s: build_libs(*s, args.sass), specs))
    builds = {name: libs for (name, _), libs in zip(specs, built)}
    got = lines(builds, [int(x) for x in args.streams.split(",")],
                args.iters, card)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as fp:
            for line in got:
                fp.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
