"""rANS decode of whole-stream batches on the card: rANS 4x8 (CRAM 3.0) of
both orders, mixed, and plain rANS Nx16 (CRAM 3.1) of both orders, 4-way
and 32-way, mixed.

Port of htslib_tpu/ops/rans.py: `uncompress_batch` (:141) and
`uncompress_nx16_batch` (:282).  Those run one XLA loop a (wire, order,
width) group over dense [B, 256 * 4096] tables; the port launches one
hand-written kernel a group, each decoding every stream of its group to
its own end:

    4x8 order 0          B7 (csrc/rans4x8.cu, decode_4x8_o0_batch)
    4x8 order 1          X1 (csrc/rans4x8.cu)
    Nx16 32-way order 0  B2 (csrc/rans_nx16_o0.cu, decode_nx16_o0_batch)
    Nx16 32-way order 1  B5 (csrc/rans_nx16_o1.cu, decode_nx16_o1_batch)
    Nx16 4-way order 0   X2 (csrc/rans4x8.cu, the Nx16 refill)
    Nx16 4-way order 1   X3 (csrc/rans4x8.cu, the Nx16 refill)

The outputs are the JAX functions' bytes, in the input order: the JAX
4-way order-0 loop runs every stream to the batch's longest and cuts it
after, the port stops each stream at its length.  Errors are the JAX
functions' where the kernels take what JAX takes: ValueError on any
Nx16 transform flag and on frequencies past 4096, and on a zero-length
4x8 stream, whose empty table the JAX function's parse (as the port's
`_read_freqs`) reads past.  The kernels' order-1 tables hold at most
A2_MAX (4,096) (context, symbol) rows, so an order-1 stream with more
raises ValueError, where the JAX functions decode it; and a 32-way
order-0 table must sum to 4096 (B2), as every encoder's does.  With
`device="cpu"` the kernels' plain PyTorch versions run.
"""
from __future__ import annotations

from typing import List

from htslib_tpu_torch import _build
from htslib_tpu_torch.codecs.rans4x16 import u7_get
from htslib_tpu_torch.ops.rans4x8 import (decode_streams, frame_4x8,
                                          frame_nx16_4way)
from htslib_tpu_torch.ops.rans_nx16 import decode_nx16_o0_batch
from htslib_tpu_torch.ops.rans_nx16_o1 import decode_nx16_o1_batch


def uncompress_batch(blocks: List[bytes], device="cuda") -> List[bytes]:
    """Decode rANS 4x8 streams of order 0 and 1, mixed (the order byte
    first, as the JAX function takes them), one launch an order.  A
    stream of another order byte gives b"", as in JAX."""
    dev = _build.resolve_device(device)
    res = [b""] * len(blocks)
    for order in (0, 1):
        idx = [i for i, data in enumerate(blocks) if data[0] == order]
        if idx:
            b = frame_4x8([blocks[i] for i in idx], bool(order), dev)
            for i, out in zip(idx, decode_streams(b)):
                res[i] = out
    return res


def uncompress_nx16_batch(blocks: List[bytes], device="cuda") -> List[bytes]:
    """Decode plain rANS Nx16 streams of order 0 and 1, 4-way and 32-way,
    mixed (flags 0x00, 0x01, 0x04, 0x05), one launch a (width, order)
    group; a zero-length stream gives b"".  Raises ValueError, before any
    decode, on a transform flag."""
    dev = _build.resolve_device(device)
    groups: dict = {}
    for i, data in enumerate(blocks):
        flags = data[0]
        if flags & ~0x05:
            raise ValueError("device Nx16 core handles plain O0/O1 "
                             "streams; transforms are host-side")
        groups.setdefault((flags & 0x04, flags & 0x01), []).append(i)
    res = [b""] * len(blocks)
    for (n32, o1), idxs in groups.items():
        idxs = [i for i in idxs if u7_get(blocks[i], 1)[0]]
        if not idxs:
            continue
        datas = [blocks[i] for i in idxs]
        if n32:
            outs = (decode_nx16_o1_batch if o1 else decode_nx16_o0_batch)(
                datas, device=dev)
        else:
            outs = decode_streams(frame_nx16_4way(datas, bool(o1), dev))
        for i, out in zip(idxs, outs):
            res[i] = out
    return res
