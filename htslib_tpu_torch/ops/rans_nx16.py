"""rANS Nx16 order-0 32-way decode on the card (kernels B2 and B3), and
the rANS resolve chain (kernel B4, its step in csrc/rans_resolve_step.cuh).

Port of htslib_tpu/ops/rans_pallas.py: `decode_nx16_o0_batch` (its
`_seg_kernel`) here, the histogram variant (its `_seg_hist_kernel`)
through `rans_o0(..., qbins=...)`, which ops/device_stats.py drives, and
`make_resolve_bench` (its `make_resolve_bench.kernel`,
csrc/rans_resolve_bench.cu).

Layout.  The Pallas kernels decode 32 streams per call in state-major
[8, 1024] lanes over telescoped [A, 1024] tables and packed [W, 32]
payload columns, 2048 rounds per call.  The port keeps the wire and the
outputs, not that layout: a batch holds each stream's payload words back
to back (`Nx16Batch`), its 256 frequencies and its 32 initial states, and
one launch decodes every stream of the batch to its end
(csrc/rans_nx16_o0.cu, one warp per stream; `blocks_per_sm` gives the
streams one SM holds).

`rans_o0` launches the kernel for tensors on the card and takes the plain
PyTorch version (`rans_o0_plain`, the same rounds as tensor ops over all
streams and states at once) for tensors on the CPU.  State is held as
int64 masked to 32 bits there, because torch.uint32 lacks shifts, `+` and
`<` on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from htslib_tpu_torch import _build
from htslib_tpu_torch.codecs.rans4x16 import _read_freq_table, u7_get

TOTFREQ = 4096
TF_SHIFT = 12
RANS16_L = 1 << 15
NWAY = 32
_U32 = 0xFFFFFFFF


@dataclass
class Nx16Batch:
    """Streams framed for decode, all tensors on one device."""
    payload: torch.Tensor   # u8: payloads back to back, each padded to even
    word_off: torch.Tensor  # int64 [S]: first 16-bit word of each stream
    n_words: torch.Tensor   # int32 [S]: words in each (padded) payload
    freqs: torch.Tensor     # int32 [S, 256]: frequencies, each row sums 4096
    x0: torch.Tensor        # int32 [S, 32]: initial states (u32 bits)
    ulen: torch.Tensor      # int32 [S]: symbols in each stream
    out_off: torch.Tensor   # int64 [S]: each stream's first output byte

    @property
    def n_streams(self) -> int:
        return int(self.freqs.shape[0])

    @property
    def total_out(self) -> int:
        return int(self.ulen.sum())


def pack_payloads(payloads: List[np.ndarray], unit: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Payloads back to back in one zero-padded u8 buffer, each starting
    at a multiple of `unit` bytes.  Returns (buffer, first unit of each
    payload int64, units in each int64)."""
    n_units = np.array([(len(p) + unit - 1) // unit for p in payloads],
                       np.int64)
    first = exclusive_cumsum(n_units)
    # one spare unit keeps the buffer non-empty when every payload is
    buf = np.zeros(unit * (int(n_units.sum()) + 1), np.uint8)
    for o, p in zip(first, payloads):
        buf[unit * o:unit * o + len(p)] = p
    return buf, first, n_units


def exclusive_cumsum(a: np.ndarray) -> np.ndarray:
    out = np.zeros(len(a), np.int64)
    np.cumsum(a[:-1], out=out[1:])
    return out


def frame_streams(blocks: List[bytes], device,
                  normalised: bool = True) -> Nx16Batch:
    """Parse the headers of plain Nx16 O0 32-way streams (flag byte
    included; flags checked by the caller) into an `Nx16Batch`.  A table
    that sums below 4096 raises ValueError unless `normalised` is False
    (the JAX ops/rans.py decode reads its slots past the sum as symbol 0;
    the JAX Pallas front ends refuse it); one past 4096 always raises."""
    S = len(blocks)
    freqs = np.zeros((S, 256), np.int32)
    states = np.zeros((S, NWAY), np.uint32)
    ulen = np.zeros(S, np.int64)
    payloads = []
    for i, data in enumerate(blocks):
        p = 1
        ulen[i], p = u7_get(data, p)
        if ulen[i] >= 1 << 31:
            raise ValueError("stream too long for the Nx16 kernel")
        f, p = _read_freq_table(data, p)
        if f.sum() > TOTFREQ or (normalised and f.sum() != TOTFREQ):
            raise ValueError("unnormalised frequency table")
        freqs[i] = f
        states[i] = np.frombuffer(data, "<u4", NWAY, p)
        payloads.append(np.frombuffer(data, np.uint8, len(data) - p - 4 * NWAY,
                                      p + 4 * NWAY))
    payload, word_off, n_words = pack_payloads(payloads, 2)

    def dev(a):
        return torch.from_numpy(a).to(device)

    return Nx16Batch(dev(payload), dev(word_off),
                     dev(n_words.astype(np.int32)), dev(freqs),
                     dev(states.view(np.int32)), dev(ulen.astype(np.int32)),
                     dev(exclusive_cumsum(ulen)))


def _slot_symbols(f: torch.Tensor) -> torch.Tensor:
    """Frequencies int64 [G, 256] -> the symbol owning each of the 4096
    slots, int64 [G, 4096]; 256 for a slot past the sum."""
    slots = torch.arange(TOTFREQ, device=f.device).expand(
        f.shape[0], TOTFREQ).contiguous()
    return torch.searchsorted(torch.cumsum(f, 1), slots, right=True)


def rans_o0_plain(b: Nx16Batch, max_rounds: int = -1,
                  offs: Optional[torch.Tensor] = None,
                  qbins: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernels B2/B3: the same rounds as tensor
    ops over [streams, 32 states].  Returns (symbols u8 [total_out], or
    with `qbins` the histogram int32 [S, qbins] of clip(sym - offs, 0,
    qbins - 1); final states int32 [S, 32]; final word cursors int32 [S]).
    A slot past a table's sum decodes as symbol 0 with f = 1 and cum 0,
    as the JAX package's packed entry 0 does."""
    dev = b.freqs.device
    S = b.n_streams
    # a 257th symbol of f = 1 and cum 0 owns the slots past the sum, and
    # is emitted as symbol 0
    f = torch.cat([b.freqs.long(), torch.ones((S, 1), dtype=torch.long,
                                              device=dev)], 1)
    cum = torch.cumsum(f, 1) - f
    cum[:, 256] = 0
    sym_of = _slot_symbols(f[:, :256])
    words = b.payload.view(torch.int16).long() & 0xFFFF
    nw = b.n_words.long()[:, None]
    wo = b.word_off[:, None]
    n = b.ulen.long()[:, None]
    rounds = (n[:, 0] + NWAY - 1) // NWAY
    if max_rounds >= 0:
        rounds = rounds.clamp(max=max_rounds)
    lanes = torch.arange(NWAY, device=dev)[None, :]
    x = b.x0.long() & _U32
    cur = torch.zeros((S, 1), dtype=torch.long, device=dev)
    total = b.total_out
    if qbins is None:
        out = torch.zeros(total + 1, dtype=torch.uint8, device=dev)
    else:
        out = torch.zeros((S, qbins), dtype=torch.long, device=dev)
        off = (offs.long() if offs is not None
               else torch.zeros(S, dtype=torch.long, device=dev))[:, None]
    for r in range(int(rounds.max()) if S else 0):
        pos = r * NWAY + lanes
        act = (pos < n) & (r < rounds)[:, None]
        m = x & (TOTFREQ - 1)
        s = torch.gather(sym_of, 1, m)
        step = (torch.gather(f, 1, s) * (x >> TF_SHIFT) + m
                - torch.gather(cum, 1, s)) & _U32
        x = torch.where(act, step, x)
        s = torch.where(s == 256, 0, s)
        if qbins is None:
            # inactive lanes write to the spare last byte
            at = torch.where(act, b.out_off[:, None] + pos, total)
            out[at.reshape(-1)] = s.reshape(-1).to(torch.uint8)
        else:
            out.scatter_add_(1, (s - off).clamp(0, qbins - 1), act.long())
        x, cur = refill16(x, act & (x < RANS16_L), cur, words, wo, nw)
    res = out[:total] if qbins is None else out.to(torch.int32)
    return res, x.to(torch.int32), cur[:, 0].to(torch.int32)


def refill16(x, need, cur, words, wo, nw):
    """One round's refills of [S, 32] states in state order: state j of
    stream i, where `need`, shifts in word cur + (states below j that
    need one) of its stream (0 past the end); the cursor advances by the
    count, clamped to the stream's end.  Returns (x, cur)."""
    needi = need.long()
    idx = cur + torch.cumsum(needi, 1) - needi
    inb = idx < nw
    word = torch.where(inb, words[torch.where(inb, wo + idx, 0)], 0)
    x = torch.where(need, ((x << 16) | word) & _U32, x)
    return x, torch.minimum(cur + needi.sum(1, keepdim=True), nw)


def blocks_per_sm(qbins: Optional[int] = None) -> int:
    """Streams that one SM of the card decodes at once in kernel B2 (or,
    with `qbins`, B3 at that many bins): the blocks its shared memory
    holds."""
    lib = _build.load("rans_nx16_o0")
    n = lib.rans_nx16_o0_blocks_per_sm(int(qbins is not None), qbins or 0)
    _build.check(lib, max(-n, 0), "rans_nx16_o0 occupancy")
    return n


def rans_o0_cuda(b: Nx16Batch, max_rounds: int = -1,
                 offs: Optional[torch.Tensor] = None,
                 qbins: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel B2 (symbols) or, with `qbins`, kernel B3 (histogram) over
    the whole batch in one launch; same results as `rans_o0_plain`."""
    S = b.n_streams
    req = _build.require_cuda
    req(b.payload, torch.uint8, "payload")
    req(b.word_off, torch.int64, "word_off", (S,))
    req(b.n_words, torch.int32, "n_words", (S,))
    req(b.freqs, torch.int32, "freqs", (S, 256))
    req(b.x0, torch.int32, "x0", (S, NWAY))
    req(b.ulen, torch.int32, "ulen", (S,))
    req(b.out_off, torch.int64, "out_off", (S,))
    if b.payload.numel() % 2 or b.payload.data_ptr() % 2:
        raise ValueError("payload: expected whole, aligned 16-bit words")
    # the kernel trusts these: every read and write stays inside its buffer
    bad = (((b.word_off + b.n_words) * 2 > b.payload.numel())
           | (b.word_off < 0) | (b.n_words < 0) | (b.ulen < 0)
           | (b.out_off < 0) | (b.out_off + b.ulen > b.total_out)).any() \
        | (b.freqs < 0).any() | (b.freqs.sum(1) > TOTFREQ).any()
    if bool(bad):
        raise ValueError("batch: a stream lies outside its buffers or has "
                         "frequencies past 4096")
    dev = b.payload.device
    x_out = torch.empty((S, NWAY), dtype=torch.int32, device=dev)
    cur_out = torch.empty(S, dtype=torch.int32, device=dev)
    if qbins is None:
        # positions a max_rounds stop leaves undecoded hold 0, as in
        # the plain version
        res = (torch.empty if max_rounds < 0 else torch.zeros)(
            b.total_out, dtype=torch.uint8, device=dev)
        out_ptr, hist_ptr, offs_ptr, key = res.data_ptr(), None, None, \
            "rans_nx16_o0_decode"
    else:
        if not 1 <= qbins <= 256:
            raise ValueError("qbins must be in 1..256")
        if offs is None:
            offs = torch.zeros(S, dtype=torch.int32, device=dev)
        req(offs, torch.int32, "offs", (S,))
        res = torch.empty((S, qbins), dtype=torch.int32, device=dev)
        out_ptr, hist_ptr, offs_ptr, key = None, res.data_ptr(), \
            offs.data_ptr(), "rans_nx16_o0_hist"
    lib = _build.load("rans_nx16_o0")
    rc = lib.rans_nx16_o0_launch(
        b.payload.data_ptr(), b.word_off.data_ptr(), b.n_words.data_ptr(),
        b.freqs.data_ptr(), b.x0.data_ptr(), b.ulen.data_ptr(),
        b.out_off.data_ptr(), out_ptr, offs_ptr, hist_ptr, x_out.data_ptr(),
        cur_out.data_ptr(), S, qbins or 0, max_rounds,
        _build.stream_handle(b.payload))
    _build.check(lib, rc, key)
    _build.LAUNCHES[key] += 1
    return res, x_out, cur_out


def rans_o0(b: Nx16Batch, max_rounds: int = -1,
            offs: Optional[torch.Tensor] = None, qbins: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode a batch: the kernel for a batch on the card, the plain
    version for one on the CPU.  `max_rounds` >= 0 stops every stream
    after that many rounds (the state a JAX segment call leaves)."""
    if b.payload.is_cuda:
        return rans_o0_cuda(b, max_rounds, offs, qbins)
    if b.payload.device.type != "cpu":
        raise ValueError(f"unsupported device {b.payload.device}")
    return rans_o0_plain(b, max_rounds, offs, qbins)


def decode_nx16_o0_batch(blocks: List[bytes],
                         device="cuda") -> List[bytes]:
    """Wire-exact rANS Nx16 order-0 32-way decode of whole streams (flag
    byte included, format per codecs/rans4x16.py), every stream of the
    list in one kernel launch."""
    dev = _build.resolve_device(device)
    for data in blocks:  # the JAX decode's errors, in its order
        if data[0] & ~0x04:
            raise ValueError("device Nx16 kernel: plain O0 only")
        if not data[0] & 0x04:
            raise ValueError("device Nx16 kernel: 32-way only")
    if not blocks:
        return []
    return decode_o0_streams(frame_streams(blocks, dev))


def decode_o0_streams(b: Nx16Batch) -> List[bytes]:
    """Each stream of a framed batch decoded (B2 on the card), as bytes."""
    syms = rans_o0(b)[0].cpu().numpy()
    offs = b.out_off.cpu().numpy()
    lens = b.ulen.cpu().numpy()
    return [syms[o:o + n].tobytes() for o, n in zip(offs, lens)]


# -- the resolve chain (kernel B4) -------------------------------------------

def rans_resolve_plain(freqs: torch.Tensor, x0: torch.Tensor,
                       rounds: int) -> torch.Tensor:
    """Plain PyTorch version of kernel B4: `rounds` steps of G chains,
    each x = f[s] * (x >> 12) + (x & 4095) - cum[s] for the symbol s
    owning slot x & 4095, then x = (x << 16) | 1 where x < 2^15.
    freqs int32 [G, 256], x0 int32 [G]; returns the states int32 [G]."""
    f = freqs.long()
    cum = torch.cumsum(f, 1) - f
    sym_of = _slot_symbols(f)
    x = x0.long()[:, None] & _U32
    for _ in range(rounds):
        m = x & (TOTFREQ - 1)
        s = torch.gather(sym_of, 1, m)
        x = (torch.gather(f, 1, s) * (x >> TF_SHIFT) + m
             - torch.gather(cum, 1, s)) & _U32
        x = torch.where(x < RANS16_L, ((x << 16) | 1) & _U32, x)
    return x[:, 0].to(torch.int32)


def resolve_smem_bytes() -> int:
    """Bytes of shared memory a chain (a block) of kernel B4 takes."""
    return _build.load("rans_resolve_bench").rans_resolve_bench_smem_bytes()


def resolve_chains_per_sm() -> int:
    """Chains of kernel B4 that one SM of the card runs at once."""
    lib = _build.load("rans_resolve_bench")
    n = lib.rans_resolve_bench_chains_per_sm()
    _build.check(lib, max(-n, 0), "rans_resolve_bench occupancy")
    return n


def rans_resolve_cuda(freqs: torch.Tensor, x0: torch.Tensor,
                      rounds: int) -> torch.Tensor:
    """Kernel B4, one launch for every chain; same result as
    `rans_resolve_plain`."""
    G = int(freqs.shape[0])
    _build.require_cuda(freqs, torch.int32, "freqs", (G, 256))
    _build.require_cuda(x0, torch.int32, "x0", (G,))
    # the slot table build trusts the frequencies to stay inside 4096
    if bool((freqs < 0).any() | (freqs.sum(1) != TOTFREQ).any()):
        raise ValueError("freqs: an unnormalised frequency table")
    x_out = torch.empty(G, dtype=torch.int32, device=freqs.device)
    lib = _build.load("rans_resolve_bench")
    rc = lib.rans_resolve_bench_launch(freqs.data_ptr(), x0.data_ptr(),
                                       x_out.data_ptr(), G, rounds,
                                       _build.stream_handle(freqs))
    _build.check(lib, rc, "rans_resolve_bench")
    _build.LAUNCHES["rans_resolve_bench"] += 1
    return x_out


def rans_resolve(freqs: torch.Tensor, x0: torch.Tensor,
                 rounds: int) -> torch.Tensor:
    """The resolve chain: the kernel for tensors on the card, the plain
    version for tensors on the CPU."""
    if freqs.is_cuda:
        return rans_resolve_cuda(freqs, x0, rounds)
    if freqs.device.type != "cpu":
        raise ValueError(f"unsupported device {freqs.device}")
    return rans_resolve_plain(freqs, x0, rounds)


def make_resolve_bench(G: int = 128, rounds: int = 4096, unroll: int = 4,
                       seed: int = 7, device="cuda"):
    """The resolve-rate benchmark (port of the JAX package's
    make_resolve_bench): G chains over seeded 256-symbol tables.  Returns
    (fn, args, ref_chain): fn(*args) runs rounds // unroll * unroll steps
    (the JAX loop's count) and gives int32 [8, G], every row the chains'
    states, as the JAX fn does; args are (freqs int32 [G, 256], x0 int32
    [G]) on `device`, from the JAX function's draws; ref_chain(nrounds)
    is the same chain in numpy (renormalisation included), uint32
    [8, G], by default over fn's steps."""
    dev = _build.resolve_device(device)
    rng = np.random.RandomState(seed)
    freqs = rng.randint(1, 64, (G, 256)).astype(np.int64)
    freqs = np.maximum(1, freqs * TOTFREQ // freqs.sum(1, keepdims=True))
    freqs[:, 0] += TOTFREQ - freqs.sum(1)
    x0 = rng.randint(1 << 23, 1 << 30, (1, G))[0].astype(np.int32)
    steps = rounds // unroll * unroll

    def fn(freqs_t, x0_t):
        return rans_resolve(freqs_t, x0_t, steps)[None, :].expand(8, -1)

    def ref_chain(nrounds=None):
        cum = np.cumsum(freqs, 1) - freqs
        sym_of = np.stack([np.repeat(np.arange(256), f) for f in freqs])
        gi = np.arange(G)
        x = x0.astype(np.int64)
        for _ in range(steps if nrounds is None else nrounds):
            m = x & (TOTFREQ - 1)
            s = sym_of[gi, m]
            x = freqs[gi, s] * (x >> TF_SHIFT) + m - cum[gi, s]
            x = np.where(x < RANS16_L, (x << 16) | 1, x)
        return np.broadcast_to((x & _U32).astype(np.uint32), (8, G)).copy()

    args = (torch.from_numpy(freqs.astype(np.int32)).to(dev),
            torch.from_numpy(x0).to(dev))
    return fn, args, ref_chain
