"""BAM record unpacking and SAM text staging on the card.

Port of htslib_tpu/ops/seqfmt.py, on the same padded batch layout:
  * unpack_core_fields: [N, 32] uint8 record cores -> int32 columns
    (the vectorised bam_read1 field extraction, sam.c:809-822)
  * nibble_to_base: packed 4-bit sequences -> ASCII bases (kernel B1,
    csrc/nibble.cu; the JAX package's `_nibble_kernel`)
  * qual_to_ascii: qual+33 with padding masked to 0
  * dec_len_device / itoa_fixed: vectorised int -> decimal staging
"""
from __future__ import annotations

import numpy as np
import torch

from htslib_tpu_torch import _build

SEQ_NT16_STR = "=ACMGRSVTWYHKDBN"
_NT16_ARR = np.frombuffer(SEQ_NT16_STR.encode(), np.uint8)


def unpack_core_fields(cores: torch.Tensor) -> dict:
    """cores: uint8 [N, 32] -> dict of int32 columns (little-endian
    fields read through int32/int16 views of the rows)."""
    c = cores.contiguous()
    w32 = c.view(torch.int32)                         # [N, 8]
    w16 = c.view(torch.int16).to(torch.int32) & 0xFFFF  # [N, 16]
    b = c.to(torch.int32)
    return {
        "tid": w32[:, 0],
        "pos": w32[:, 1],
        "l_qname": b[:, 8],
        "mapq": b[:, 9],
        "bin": w16[:, 5],
        "n_cigar": w16[:, 6],
        "flag": w16[:, 7],
        "l_qseq": w32[:, 4],
        "mtid": w32[:, 5],
        "mpos": w32[:, 6],
        "tlen": w32[:, 7],
    }


def nibble_to_base_plain(packed: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel B1: packed uint8 [rows, W] ->
    ASCII uint8 [rows, 2W], high nibble first."""
    lut = torch.from_numpy(_NT16_ARR.copy()).to(packed.device)
    hi = lut[(packed >> 4).long()]
    lo = lut[(packed & 0xF).long()]
    rows, w = packed.shape
    return torch.stack([hi, lo], dim=-1).reshape(rows, 2 * w)


def nibble_to_base_cuda(packed: torch.Tensor) -> torch.Tensor:
    """Kernel B1 (csrc/nibble.cu) on a packed uint8 [rows, W] tensor on
    the card."""
    _build.require_cuda(packed, torch.uint8, "packed")
    if packed.dim() != 2:
        raise ValueError("packed: expected [rows, W]")
    rows, w = packed.shape
    out = torch.empty((rows, 2 * w), dtype=torch.uint8, device=packed.device)
    lib = _build.load("nibble")
    rc = lib.nibble_to_base_launch(packed.data_ptr(), out.data_ptr(),
                                   packed.numel(),
                                   _build.stream_handle(packed))
    _build.check(lib, rc, "nibble_to_base")
    _build.LAUNCHES["nibble_to_base"] += 1
    return out


def nibble_to_base(packed: torch.Tensor) -> torch.Tensor:
    """packed uint8 [rows, W] -> ASCII uint8 [rows, 2W]: kernel B1 for a
    tensor on the card, the plain version for one on the CPU."""
    if packed.is_cuda:
        return nibble_to_base_cuda(packed.contiguous())
    if packed.device.type != "cpu":
        raise ValueError(f"unsupported device {packed.device}")
    return nibble_to_base_plain(packed)


def qual_to_ascii(qual: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """qual uint8 [N, L] + validity mask -> ASCII (qual+33, wrapping as
    uint8), 0 padding."""
    return torch.where(mask, qual.to(torch.uint8) + 33,
                       torch.zeros((), dtype=torch.uint8,
                                   device=qual.device))


_POW10_I32 = [1, 10, 100, 1000, 10 ** 4, 10 ** 5, 10 ** 6, 10 ** 7,
              10 ** 8, 10 ** 9]


def dec_len_device(x: torch.Tensor) -> torch.Tensor:
    """Formatted decimal length of int32 values in (-2^31, 2^31)
    (digits + sign)."""
    x = x.to(torch.int32)
    neg = (x < 0).to(torch.int32)
    ax = x.abs()
    nd = torch.ones_like(ax)
    for p in _POW10_I32[1:]:
        nd = nd + (ax >= p).to(torch.int32)
    return nd + neg


def itoa_fixed(x: torch.Tensor, max_digits: int = 11) -> torch.Tensor:
    """Right-aligned decimal ASCII of int32 values in a fixed
    [N, max_digits] uint8 buffer, zero-padded on the left."""
    dev = x.device
    x = x.to(torch.int32)
    neg = x < 0
    ax = x.abs()
    nd = dec_len_device(x) - neg.to(torch.int32)
    pows = torch.tensor([_POW10_I32[min(max_digits - 1 - c, 9)]
                         for c in range(max_digits)], dtype=torch.int32,
                        device=dev)
    digits = (ax[:, None] // pows[None, :]) % 10
    col_from_right = torch.arange(max_digits - 1, -1, -1, dtype=torch.int32,
                                  device=dev)
    live = col_from_right[None, :] < nd[:, None]
    out = torch.where(live, digits + 48, 0)
    sign_col = max_digits - 1 - nd
    put_sign = neg[:, None] & (torch.arange(max_digits, device=dev)[None, :]
                               == sign_col[:, None])
    return torch.where(put_sign, ord("-"), out).to(torch.uint8)
