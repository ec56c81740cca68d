#!/usr/bin/env python3
"""Per-stage cost of the rANS Nx16 order-0 decode round on the card
(kernel P2): the round with chosen stages removed.

    python3 -m htslib_tpu_torch.probe_rans_ablate

Port of scripts/probe_rans_ablate.py, which compiles the Pallas round
(ops/rans_pallas.py `_seg_kernel`) with stages removed.  The port
ablates its own round, B2's (csrc/rans_nx16_o0.cu: a warp a stream, the
slot table in shared memory, refills by a ballot and popc, the payload
staged into a shared ring between blocks of 32 rounds), in
csrc/rans_ablate.cu, one template argument a mode (`MODES`):

  full        the round;
  no_select   refill word fixed at 1, no word read, the cursor advancing
              and the ring staged;
  no_resolve  no table: sym = x & 4095, x = (x * 5 + 7) & 0x7FFFFFFF;
  no_scan     no ballot: each lane reads at its own cursor and advances it;
  only_loop   the output alone: x, then x + 1, no ring;
  slice_cost  the payload's loads alone: lane j reads the word at the
              cursor + j from the ring, the cursor advancing by 32.

Every mode runs `rounds` rounds (SEG, 2,048, by default) over BLOCKS (32)
streams of NWAY (32) states, the JAX probe's 1,024 lanes, and returns the
symbols int32 [rounds, streams * 32] (stream b's state j at column
b * 32 + j), each lane's final state and its cursor (words from the
payload's start).  `ablate` launches the kernel for a batch on the card
and takes the plain PyTorch version (`ablate_plain`, the same rounds as
tensor ops over every stream and state) for one on the CPU.

`main` encodes BLOCKS seeded quality-like streams of SEG * 32 bytes with
the port's host codec (codecs/rans4x16.py, 32-way order 0), checks every
mode against its plain version and the full mode's symbols against the
raw bytes, times each mode (through `ablate_cuda`, whose check waits
for the card, and launched directly by `launcher`) and B2's decode of
the same streams and rounds (launched directly, `b2_launcher`) from CUDA
events, and prints one JSON object: ns a round and MB/s (lanes' symbols
a second) of each mode, and B2's ns a round.  It runs on the card only and writes no file.
"""
from __future__ import annotations

import json
import sys
from typing import List, Tuple

import numpy as np
import torch

from htslib_tpu_torch import _build
from htslib_tpu_torch.ops.rans_nx16 import (NWAY, RANS16_L, TOTFREQ,
                                            Nx16Batch, _slot_symbols,
                                            frame_streams)

BLOCKS = 32          # streams a call
SEG = 2048           # rounds a call
REPS = 8             # timed calls a mode
MODES = ("full", "no_select", "no_resolve", "no_scan", "only_loop",
         "slice_cost")
# the canonical operations of a state's round in each mode, for the
# bound: full is the table load, the step's mask, shift and multiply-add,
# the symbol's shift and mask, the compare, ballot, rank (mask and popc),
# the word's load and the refill's shift and or, and the cursor's add and
# clamp
OPS_PER_ROUND = {"full": 16, "no_select": 13, "no_resolve": 15,
                 "no_scan": 10, "only_loop": 1, "slice_cost": 4}
_TABLE_MODES = ("full", "no_select", "no_scan")
_U32 = 0xFFFFFFFF


def launch_key(mode: str) -> str:
    return "rans_ablate_" + mode


def quality_streams(n: int = BLOCKS, size: int = SEG * NWAY,
                    seed: int = 21) -> List[bytes]:
    """`n` seeded quality-like streams of `size` bytes: each over a
    64-symbol alphabet (2..65) drawn from its own random frequencies, as
    the JAX probe's 64-symbol tables."""
    rng = np.random.default_rng(seed)
    raws = []
    for _ in range(n):
        p = rng.integers(1, 64, 64).astype(np.float64)
        raws.append((rng.choice(64, size, p=p / p.sum()) + 2).astype(
            np.uint8).tobytes())
    return raws


def make_batch(raws: List[bytes], device) -> Nx16Batch:
    """The streams encoded by the port's host codec (32-way order 0) and
    framed for decode on `device`."""
    from htslib_tpu_torch.codecs.rans4x16 import compress
    return frame_streams([compress(r, 0x04) for r in raws],
                         _build.resolve_device(device))


def resolve_step(freqs: torch.Tensor, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One resolve and advance of every state: (symbol, next state) of
    states x [S, 32] under the streams' frequencies [S, 256], the step
    of the full mode's round (and B2's) before its refill."""
    f = freqs.long()
    cum = torch.cumsum(f, 1) - f
    m = x.long() & (TOTFREQ - 1)
    s = torch.gather(_slot_symbols(f), 1, m)
    nxt = (torch.gather(f, 1, s) * ((x.long() & _U32) >> 12) + m
           - torch.gather(cum, 1, s)) & _U32
    return s, nxt


def ablate_plain(b: Nx16Batch, mode: str, rounds: int = SEG
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel P2 in `mode`: the same rounds as
    tensor ops over [streams, 32 states], state int64 masked to 32 bits.
    Returns (symbols int32 [rounds, S * 32], states int32 [S * 32],
    cursors int32 [S * 32])."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    dev = b.freqs.device
    S = b.n_streams
    words = b.payload.view(torch.int16).long() & 0xFFFF
    nw = b.n_words.long()[:, None]
    wo = b.word_off[:, None]
    lanes = torch.arange(NWAY, device=dev)[None, :]

    def word(idx):
        inb = idx < nw
        return torch.where(inb, words[torch.where(inb, wo + idx, 0)], 0)

    x = b.x0.long() & _U32
    cur = torch.zeros((S, NWAY), dtype=torch.long, device=dev)
    syms = torch.empty((rounds, S, NWAY), dtype=torch.long, device=dev)
    for r in range(rounds):
        if mode == "only_loop":
            syms[r] = x
            x = (x + 1) & _U32
            continue
        if mode == "slice_cost":
            syms[r] = word(cur + lanes)
            cur = torch.minimum(cur + NWAY, nw)
            continue
        if mode == "no_resolve":
            sym = x & (TOTFREQ - 1)
            x = (x * 5 + 7) & 0x7FFFFFFF
        else:
            sym, x = resolve_step(b.freqs, x)
        need = x < RANS16_L
        if mode == "no_scan":
            x = torch.where(need, ((x << 16) | word(cur)) & _U32, x)
            cur = torch.where(need, torch.minimum(cur + 1, nw), cur)
        else:
            needi = need.long()
            w = (torch.ones_like(x) if mode == "no_select"
                 else word(cur + torch.cumsum(needi, 1) - needi))
            x = torch.where(need, ((x << 16) | w) & _U32, x)
            cur = torch.minimum(cur + needi.sum(1, keepdim=True), nw)
        syms[r] = sym
    return (syms.reshape(rounds, S * NWAY).to(torch.int32),
            x.reshape(-1).to(torch.int32), cur.reshape(-1).to(torch.int32))


def check_batch(b: Nx16Batch, mode: str) -> None:
    """Raise on what the kernel does not take: a table of one symbol or
    one past 4096 where the mode reads the table (the step of a mono
    table is B2's loop of its own), or a stream outside its buffer."""
    bad = (((b.word_off + b.n_words) * 2 > b.payload.numel())
           | (b.word_off < 0) | (b.n_words < 0)).any()
    if mode in _TABLE_MODES:
        bad = bad | (b.freqs < 0).any() | (b.freqs.sum(1) > TOTFREQ).any() \
            | (b.freqs >= TOTFREQ).any()
    if bool(bad):
        raise ValueError("batch: a stream lies outside its buffer, or a "
                         "table has one symbol or sums past 4096")


def ablate_cuda(b: Nx16Batch, mode: str, rounds: int = SEG
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel P2 in `mode`, one launch for every stream; same results as
    `ablate_plain`."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    S = b.n_streams
    req = _build.require_cuda
    req(b.payload, torch.uint8, "payload")
    req(b.word_off, torch.int64, "word_off", (S,))
    req(b.n_words, torch.int32, "n_words", (S,))
    req(b.freqs, torch.int32, "freqs", (S, 256))
    req(b.x0, torch.int32, "x0", (S, NWAY))
    if b.payload.numel() % 2 or b.payload.data_ptr() % 2:
        raise ValueError("payload: expected whole, aligned 16-bit words")
    check_batch(b, mode)
    dev = b.payload.device
    syms = torch.empty((rounds, S * NWAY), dtype=torch.int32, device=dev)
    x_out = torch.empty(S * NWAY, dtype=torch.int32, device=dev)
    cur_out = torch.empty(S * NWAY, dtype=torch.int32, device=dev)
    lib = _build.load("rans_ablate")
    rc = lib.rans_ablate_launch(
        b.payload.data_ptr(), b.word_off.data_ptr(), b.n_words.data_ptr(),
        b.freqs.data_ptr(), b.x0.data_ptr(), syms.data_ptr(),
        x_out.data_ptr(), cur_out.data_ptr(), S, int(rounds),
        MODES.index(mode), _build.stream_handle(b.payload))
    _build.check(lib, rc, launch_key(mode))
    _build.LAUNCHES[launch_key(mode)] += 1
    return syms, x_out, cur_out


def launcher(b: Nx16Batch, mode: str, rounds: int = SEG):
    """For timing: a function that launches kernel P2 in `mode` on batch
    b with no check and no count, once `ablate_cuda` has checked b."""
    ablate_cuda(b, mode, rounds)
    dev = b.payload.device
    outs = [torch.empty(n, dtype=torch.int32, device=dev)
            for n in (rounds * b.n_streams * NWAY, b.n_streams * NWAY,
                      b.n_streams * NWAY)]
    lib = _build.load("rans_ablate")

    def launch():
        _build.check(lib, lib.rans_ablate_launch(
            b.payload.data_ptr(), b.word_off.data_ptr(),
            b.n_words.data_ptr(), b.freqs.data_ptr(), b.x0.data_ptr(),
            *[o.data_ptr() for o in outs], b.n_streams, int(rounds),
            MODES.index(mode), _build.stream_handle(b.payload)),
            launch_key(mode))
    return launch


def b2_launcher(b: Nx16Batch, rounds: int = SEG):
    """For timing, the round the full mode ablates: a function that
    launches B2's decode (csrc/rans_nx16_o0.cu) of b's first `rounds`
    rounds with no check and no count, once its wrapper has checked b."""
    from htslib_tpu_torch.ops.rans_nx16 import rans_o0_cuda
    rans_o0_cuda(b, rounds)
    dev = b.payload.device
    S = b.n_streams
    out = torch.zeros(b.total_out, dtype=torch.uint8, device=dev)
    x_out = torch.empty((S, NWAY), dtype=torch.int32, device=dev)
    cur_out = torch.empty(S, dtype=torch.int32, device=dev)
    lib = _build.load("rans_nx16_o0")

    def launch():
        _build.check(lib, lib.rans_nx16_o0_launch(
            b.payload.data_ptr(), b.word_off.data_ptr(),
            b.n_words.data_ptr(), b.freqs.data_ptr(), b.x0.data_ptr(),
            b.ulen.data_ptr(), b.out_off.data_ptr(), out.data_ptr(), None,
            None, x_out.data_ptr(), cur_out.data_ptr(), S, 0, int(rounds),
            _build.stream_handle(b.payload)), "rans_nx16_o0_decode")
    return launch


def ablate(b: Nx16Batch, mode: str, rounds: int = SEG
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`rounds` rounds of `mode`: the kernel for a batch on the card, the
    plain version for one on the CPU."""
    if b.payload.is_cuda:
        return ablate_cuda(b, mode, rounds)
    if b.payload.device.type != "cpu":
        raise ValueError(f"unsupported device {b.payload.device}")
    return ablate_plain(b, mode, rounds)


def raw_symbols(raws: List[bytes], rounds: int = SEG) -> np.ndarray:
    """What the full mode must give: each stream's first rounds * 32
    bytes laid out as its symbols, int32 [rounds, len(raws) * 32]."""
    a = np.stack([np.frombuffer(r, np.uint8)[:rounds * NWAY]
                  .reshape(rounds, NWAY) for r in raws], 1)
    return a.reshape(rounds, -1).astype(np.int32)


def _ns_a_round(fn) -> float:
    """Mean ns a round of fn (SEG rounds a call) over REPS warm calls,
    from CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(REPS):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / REPS / SEG * 1e6


def main() -> int:
    if not torch.cuda.is_available():
        print(json.dumps({"error": "no CUDA device"}))
        return 1
    raws = quality_streams()
    b = make_batch(raws, "cuda")
    out = {"device": torch.cuda.get_device_name(0), "seg_rounds": SEG,
           "lanes": BLOCKS * NWAY,
           # B2 itself over the same streams and rounds, launched
           # directly: the round that full ablates
           "b2_launch_ns_per_round": _ns_a_round(b2_launcher(b))}
    ok = True
    for mode in MODES:
        got = ablate_cuda(b, mode)
        want = ablate_plain(b, mode)
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        if mode == "full":
            same = same and np.array_equal(got[0].cpu().numpy(),
                                           raw_symbols(raws))
        ok = ok and same
        ns_round = _ns_a_round(lambda: ablate_cuda(b, mode))
        out[mode + "_ns_per_round"] = ns_round
        out[mode + "_MBps"] = BLOCKS * NWAY / (ns_round * 1e-9) / 1e6
        out[mode + "_launch_ns_per_round"] = _ns_a_round(launcher(b, mode))
        out[mode + "_matches_plain"] = same
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
