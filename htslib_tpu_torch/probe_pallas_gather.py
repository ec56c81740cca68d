#!/usr/bin/env python3
"""The rANS slot-resolve chain of the gather probe on the card (kernel P1).

    python3 -m htslib_tpu_torch.probe_pallas_gather

Port of scripts/probe_pallas_gather.py: the same dependent chain, shaped
like the rANS slot-resolution loop (cram/cram_io.c:1668 call sites), per
round and state

    m = x & 0xFFF;  (f, c) of the symbol whose slots hold m;
    x = f * (x >> 12) + m - c

over G = 256 chains of 4 states for 512 rounds, on the script's seeded
tables (`make_tables`).  `resolve_cmp` runs it: kernel P1
(csrc/resolve_cmp.cu, which replaces the script's Pallas `pallas_cmp`) for
tensors on the card, `resolve_cmp_plain` (torch ops, round by round) for
tensors on the CPU.  `main` times P1 and, beside it, a chain of
`torch.gather` lookups into the packed slot table (the counterpart of the
script's `xla_gather`), checks that both give the plain version's states,
and prints one JSON object: G-lookups a second and ms of each.  It runs on
the card only and writes no file.
"""
from __future__ import annotations

import json
import sys
from typing import Tuple

import numpy as np
import torch

from htslib_tpu_torch import _build

G = 256          # chains
NSTATES = 4      # rANS 4x8 interleave
TOTFREQ = 4096
ROUNDS = 512     # dependent rounds a call
SEED = 7
REPS = 6         # timed calls of each chain
_U32 = 0xFFFFFFFF


def make_tables(rng: np.random.RandomState
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random valid frequency tables, the script's recipe: (cum int32
    [G, 257], freqs int32 [G, 256], packed uint32 [G, 4096] slot entries
    sym | (f - 1) << 8 | c << 20)."""
    freqs = rng.randint(1, 64, (G, 256)).astype(np.int64)
    scale = freqs.sum(1, keepdims=True)
    freqs = np.maximum(1, freqs * TOTFREQ // scale)
    for g in range(G):
        freqs[g, 0] += TOTFREQ - freqs[g].sum()
        assert freqs[g, 0] > 0
    cum = np.zeros((G, 257), np.int64)
    np.cumsum(freqs, axis=1, out=cum[:, 1:])
    packed = np.zeros((G, TOTFREQ), np.uint32)
    for g in range(G):
        d = np.repeat(np.arange(256), freqs[g])
        packed[g] = (d | ((freqs[g][d] - 1) << 8) | (cum[g][d] << 20)
                     ).astype(np.uint32)
    return cum.astype(np.int32), freqs.astype(np.int32), packed


def make_inputs(seed: int = SEED):
    """The script's draws: (cum, freqs, packed) of `make_tables`, then
    x0 int32 [G, 4] in [2^23, 2^30)."""
    rng = np.random.RandomState(seed)
    cum, freqs, packed = make_tables(rng)
    x0 = rng.randint(1 << 23, 1 << 30, (G, NSTATES)).astype(np.int32)
    return cum, freqs, packed, x0


def resolve_cmp_plain(cum: torch.Tensor, freqs: torch.Tensor,
                      x0: torch.Tensor, rounds: int = ROUNDS
                      ) -> torch.Tensor:
    """Plain PyTorch version of kernel P1: `rounds` rounds of every chain
    and state, the symbol of slot m the one whose bounds hold it
    (cum[s] <= m < cum[s + 1]).  State is int64 masked to 32 bits.
    Returns the final states int32 [G, 4]."""
    upper = cum[:, 1:].long().contiguous()
    cl = cum.long()
    f = freqs.long()
    x = x0.long() & _U32
    for _ in range(rounds):
        m = x & (TOTFREQ - 1)
        s = torch.searchsorted(upper, m, right=True)
        x = (torch.gather(f, 1, s) * (x >> 12) + m
             - torch.gather(cl, 1, s)) & _U32
    return x.to(torch.int32)


def check_tables(cum: torch.Tensor, freqs: torch.Tensor) -> None:
    """Raise unless each chain's bounds are its frequencies' running sum
    from 0 to 4096 with every frequency at least 1 (the kernel's table
    build trusts that every slot has one symbol)."""
    c = cum.long()
    if bool((freqs < 1).any() | (c[:, 0] != 0).any()
            | (c[:, 256] != TOTFREQ).any()
            | (c[:, 1:] - c[:, :-1] != freqs.long()).any()):
        raise ValueError("cum/freqs: not a normalised table with every "
                         "frequency at least 1")


def resolve_cmp_cuda(cum: torch.Tensor, freqs: torch.Tensor,
                     x0: torch.Tensor, rounds: int = ROUNDS
                     ) -> torch.Tensor:
    """Kernel P1, one launch for every chain; same result as
    `resolve_cmp_plain`."""
    g = int(cum.shape[0])
    _build.require_cuda(cum, torch.int32, "cum", (g, 257))
    _build.require_cuda(freqs, torch.int32, "freqs", (g, 256))
    _build.require_cuda(x0, torch.int32, "x0", (g, NSTATES))
    check_tables(cum, freqs)
    x_out = torch.empty_like(x0)
    lib = _build.load("resolve_cmp")
    rc = lib.resolve_cmp_launch(cum.data_ptr(), freqs.data_ptr(),
                                x0.data_ptr(), x_out.data_ptr(), g,
                                int(rounds), _build.stream_handle(cum))
    _build.check(lib, rc, "resolve_cmp")
    _build.LAUNCHES["resolve_cmp"] += 1
    return x_out


def resolve_cmp(cum, freqs, x0, rounds: int = ROUNDS, device="cuda"
                ) -> torch.Tensor:
    """The chain on `device`: cum, freqs and x0 (numpy arrays or tensors)
    are moved there, then kernel P1 runs on the card or the plain version
    on the CPU.  Returns the final states int32 [G, 4]."""
    dev = _build.resolve_device(device)
    args = [torch.as_tensor(a).to(dev) for a in (cum, freqs, x0)]
    if dev.type == "cuda":
        return resolve_cmp_cuda(*args, rounds)
    return resolve_cmp_plain(*args, rounds)


def gather_chain(packed: torch.Tensor, x0: torch.Tensor,
                 rounds: int = ROUNDS) -> torch.Tensor:
    """The script's `xla_gather` as torch ops: each round one
    `torch.gather` of the four states' slot entries from the packed
    table, f = ((e >> 8) & 0xFFF) + 1 and c = e >> 20.  The probe's
    yardstick, not a path of the port."""
    tbl = packed.long() & _U32
    x = x0.long() & _U32
    for _ in range(rounds):
        m = x & (TOTFREQ - 1)
        e = torch.gather(tbl, 1, m)
        x = ((((e >> 8) & 0xFFF) + 1) * (x >> 12) + m - (e >> 20)) & _U32
    return x.to(torch.int32)


def main() -> int:
    if not torch.cuda.is_available():
        print(json.dumps({"error": "no CUDA device"}))
        return 1
    cum, freqs, packed, x0 = make_inputs()
    dev = torch.device("cuda")
    cum_d, freqs_d, x0_d = (torch.from_numpy(v).to(dev)
                            for v in (cum, freqs, x0))
    packed_d = torch.from_numpy(packed.view(np.int32)).to(dev)
    want = resolve_cmp_plain(cum_d, freqs_d, x0_d)
    out = {"device": torch.cuda.get_device_name(0), "G": G,
           "nstates": NSTATES, "rounds": ROUNDS,
           "lookups_per_call": G * NSTATES * ROUNDS}
    for name, fn in (("resolve_cmp", lambda: resolve_cmp_cuda(
            cum_d, freqs_d, x0_d)), ("torch_gather", lambda: gather_chain(
                packed_d, x0_d))):
        got = fn()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(REPS):
            fn()
        t1.record()
        t1.synchronize()
        ms = t0.elapsed_time(t1) / REPS
        out[name + "_ms"] = ms
        out[name + "_Glookups_s"] = G * NSTATES * ROUNDS / (ms * 1e-3) / 1e9
        out[name + "_matches_plain"] = bool(torch.equal(got, want))
    out["cmp_vs_gather"] = (out["resolve_cmp_Glookups_s"]
                            / out["torch_gather_Glookups_s"])
    print(json.dumps(out, indent=2))
    return 0 if out["resolve_cmp_matches_plain"] else 1


if __name__ == "__main__":
    sys.exit(main())
