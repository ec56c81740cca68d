"""rANS Nx16 order-0 32-way encode on the card (kernel B9).

Port of htslib_tpu/ops/rans_enc_pallas.py: `encode_nx16_o0_batch` (its
`_enc_kernel`), byte for byte the wire of codecs/rans4x16.py
compress(data, 0x04).

Layout.  The Pallas kernel encodes 32 streams per call in state-major
[8, 1024] lanes, reads symbols packed four rounds to an int32 row and
writes packed word and mask planes that the host compacts.  The port
keeps the wire, not that layout: a batch holds every stream's symbols
back to back (`EncBatch`) with its normalised frequencies and cumulative
frequencies, and one launch encodes every stream of the batch
(csrc/rans_nx16_enc.cu, one warp per stream).  Stream i's emitted words
land, in wire order, at the tail of its region [off[i], off[i] + n) of
the word buffer; the host slices the tails in one download and writes the
headers, as the JAX host code does.

`rans_enc` launches the kernel for tensors on the card and takes the
plain PyTorch version (`rans_enc_plain`, the same rounds as tensor ops
over all streams and states at once) for tensors on the CPU.  State is
held as int64 masked to 32 bits there, because torch.uint32 lacks shifts,
`+` and `<` on the CPU.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from htslib_tpu_torch import _build
from htslib_tpu_torch.codecs.rans4x16 import (_norm_freqs, _write_freq_table,
                                              u7_put)
from htslib_tpu_torch.ops.rans_nx16 import (NWAY, RANS16_L, TF_SHIFT,
                                            TOTFREQ, exclusive_cumsum)


@dataclass
class EncBatch:
    """Streams framed for encode, all tensors on one device."""
    syms: torch.Tensor   # u8 [total]: every stream's symbols back to back
    off: torch.Tensor    # int64 [S]: each stream's first symbol, and the
    #                      first word of its region in the word buffer
    ulen: torch.Tensor   # int32 [S]: symbols in each stream
    freqs: torch.Tensor  # int32 [S, 256]: normalised, each row sums 4096
    cum: torch.Tensor    # int32 [S, 256]: exclusive cumsum of freqs

    @property
    def n_streams(self) -> int:
        return int(self.freqs.shape[0])


def frame_enc(datas: List[bytes], device) -> EncBatch:
    """Frame non-empty streams for encode; the frequencies are the host
    codec's (`_norm_freqs` of the symbol counts)."""
    lens = np.array([len(d) for d in datas], np.int64)
    if lens.size and lens.max() >= 1 << 31:
        raise ValueError("stream too long for the Nx16 kernel")
    syms = np.frombuffer(b"".join(datas), np.uint8)
    freqs = np.stack([_norm_freqs(np.bincount(
        np.frombuffer(d, np.uint8), minlength=256).astype(np.int64))
        for d in datas])
    cum = np.cumsum(freqs, 1) - freqs

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    # one spare byte keeps the buffer non-empty for an empty batch
    return EncBatch(dev(np.concatenate([syms, np.zeros(1, np.uint8)])),
                    dev(exclusive_cumsum(lens)), dev(lens.astype(np.int32)),
                    dev(freqs.astype(np.int32)),
                    dev(cum.astype(np.int32)))


def rans_enc_plain(b: EncBatch, max_rounds: int = -1
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel B9: the same rounds as tensor ops
    over [streams, 32 states].  Returns (words int16 [syms.numel()], each
    stream's emitted words at the tail of its region in wire order, zero
    elsewhere; final states int32 [S, 32]; words emitted int32 [S])."""
    dev = b.syms.device
    S = b.n_streams
    f = b.freqs.long()
    cum = b.cum.long()
    lanes = torch.arange(NWAY, device=dev)[None, :]
    n = b.ulen.long()[:, None]
    cnt = torch.div(n - lanes + NWAY - 1, NWAY,
                    rounding_mode="floor").clamp(min=0)
    rounds = (n[:, 0] + NWAY - 1) // NWAY
    if max_rounds >= 0:
        rounds = rounds.clamp(max=max_rounds)
    # lane_at[i, k]: the state that comes k-th in stream i's rounds
    lane_at = (n - 1 - lanes) % NWAY
    total = b.syms.numel()
    words = torch.zeros(total + 1, dtype=torch.long, device=dev)
    x = torch.full((S, NWAY), RANS16_L, dtype=torch.long, device=dev)
    emitted = torch.zeros((S, 1), dtype=torch.long, device=dev)
    first = b.off[:, None]
    for t in range(int(rounds.max()) if S else 0):
        live = (t < cnt) & (t < rounds)[:, None]
        pos = torch.where(live, first + lanes + NWAY * (cnt - 1 - t), 0)
        s = torch.where(live, b.syms[pos].long(), 0)
        fs = torch.where(live, torch.gather(f, 1, s), 1)
        emit = live & (x >= fs << 19)
        xe = torch.where(emit, x >> 16, x)
        step = ((xe // fs) << TF_SHIFT) + xe % fs + torch.gather(cum, 1, s)
        e_ord = torch.gather(emit.long(), 1, lane_at)
        rank = torch.zeros_like(e_ord).scatter_(
            1, lane_at, torch.cumsum(e_ord, 1) - e_ord)
        # emission e of a stream goes to word n - 1 - e of its region;
        # lanes that do not emit write to the spare last word
        at = torch.where(emit, first + n - 1 - (emitted + rank), total)
        words[at.reshape(-1)] = torch.where(emit, x & 0xFFFF, 0).reshape(-1)
        x = torch.where(live, step, x)
        emitted = emitted + emit.sum(1, keepdim=True)
    words = words[:total]
    # the words' 16 bits as int16
    return (torch.where(words >= 1 << 15, words - (1 << 16), words)
            .to(torch.int16), x.to(torch.int32),
            emitted[:, 0].to(torch.int32))


def rans_enc_cuda(b: EncBatch, max_rounds: int = -1
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel B9 over the whole batch in one launch; same results as
    `rans_enc_plain`."""
    S = b.n_streams
    req = _build.require_cuda
    req(b.syms, torch.uint8, "syms")
    req(b.off, torch.int64, "off", (S,))
    req(b.ulen, torch.int32, "ulen", (S,))
    req(b.freqs, torch.int32, "freqs", (S, 256))
    req(b.cum, torch.int32, "cum", (S, 256))
    # the kernel trusts these: every read and write stays inside its buffer
    f = b.freqs.long()
    bad = ((b.off < 0) | (b.ulen < 0)
           | (b.off + b.ulen > b.syms.numel())).any() \
        | (f < 0).any() | (f.sum(1) != TOTFREQ).any() \
        | (b.cum.long() != torch.cumsum(f, 1) - f).any()
    if bool(bad):
        raise ValueError("batch: a stream lies outside its buffers or has "
                         "an unnormalised frequency table")
    dev = b.syms.device
    # positions a stream does not emit to hold 0, as in the plain version
    words = torch.zeros(b.syms.numel(), dtype=torch.int16, device=dev)
    x_out = torch.empty((S, NWAY), dtype=torch.int32, device=dev)
    n_emit = torch.empty(S, dtype=torch.int32, device=dev)
    lib = _build.load("rans_nx16_enc")
    rc = lib.rans_nx16_enc_launch(
        b.syms.data_ptr(), b.off.data_ptr(), b.ulen.data_ptr(),
        b.freqs.data_ptr(), b.cum.data_ptr(), words.data_ptr(),
        x_out.data_ptr(), n_emit.data_ptr(), S, max_rounds,
        _build.stream_handle(b.syms))
    _build.check(lib, rc, "rans_nx16_o0_encode")
    _build.LAUNCHES["rans_nx16_o0_encode"] += 1
    return words, x_out, n_emit


def rans_enc(b: EncBatch, max_rounds: int = -1
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Encode a batch: the kernel for a batch on the card, the plain
    version for one on the CPU.  `max_rounds` >= 0 stops every stream
    after that many rounds."""
    if b.syms.is_cuda:
        return rans_enc_cuda(b, max_rounds)
    if b.syms.device.type != "cpu":
        raise ValueError(f"unsupported device {b.syms.device}")
    return rans_enc_plain(b, max_rounds)


def payload_tails(b: EncBatch, words: torch.Tensor,
                  n_emit: torch.Tensor) -> List[bytes]:
    """Each stream's payload: the last n_emit words of its region, as
    little-endian u16, gathered on the tensors' device and downloaded
    once."""
    ne = n_emit.long()
    starts = b.off + b.ulen.long() - ne
    tot = int(ne.sum())
    within = torch.arange(tot, device=ne.device) - torch.repeat_interleave(
        torch.cumsum(ne, 0) - ne, ne, output_size=tot)
    idx = torch.repeat_interleave(starts, ne, output_size=tot) + within
    flat = words[idx].cpu().numpy().view(np.uint16).astype("<u2").tobytes()
    ends = 2 * np.cumsum(ne.cpu().numpy())
    return [flat[e - 2 * k:e] for e, k in zip(ends, ne.cpu().numpy())]


def encode_nx16_o0_batch(datas: List[bytes], device="cuda",
                         timing: Optional[dict] = None) -> List[bytes]:
    """Wire-exact rANS Nx16 order-0 32-way encode: byte-identical to
    codecs/rans4x16.py compress(data, 0x04), every stream of the list in
    one kernel launch.  `timing` (optional dict) receives, added to what
    it holds, the end-to-end time less the instrumentation (`enc_s`), the
    best of 3 device-resident re-runs (`enc_resident_s`) and the bytes
    encoded (`bytes`)."""
    dev = _build.resolve_device(device)
    t_all0 = time.time()
    for d in datas:
        if len(d) == 0:
            raise ValueError("empty stream")
    if not datas:
        return []
    b = frame_enc(datas, dev)
    words, x_f, n_emit = rans_enc(b)
    t_res = 0.0
    if timing is not None:
        t_res = None
        for _ in range(3):
            t0 = time.time()
            rans_enc(b)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.time() - t0
            t_res = dt if t_res is None else min(t_res, dt)
    bodies = payload_tails(b, words, n_emit)
    x_fin = x_f.cpu().numpy().view(np.uint32).astype("<u4")
    freqs = b.freqs.cpu().numpy()
    out = []
    for i, d in enumerate(datas):
        head = bytearray([0x04])
        u7_put(head, len(d))
        _write_freq_table(head, freqs[i])
        out.append(bytes(head) + x_fin[i].tobytes() + bodies[i])
    if timing is not None:
        timing["enc_resident_s"] = timing.get("enc_resident_s", 0.0) + t_res
        timing["bytes"] = timing.get("bytes", 0) + sum(len(d) for d in datas)
        # 4 passes ran (1 real + 3 re-runs): charge exactly one
        timing["enc_s"] = (timing.get("enc_s", 0.0)
                           + (time.time() - t_all0) - 3 * t_res)
    return out
