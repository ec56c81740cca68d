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

The order-1 kernels' record tables hold at most A2_MAX (4,096) (context,
symbol) rows; the order-1 streams with more go, in a launch of their own
group, to one of two variants of the same kernel (X1, X3 or B5), each
answering as the JAX function's own [256, 4096] table of packed entries
does, so every order-1 stream the JAX functions decode decodes here too:
the large variant, which builds the stream's rows in shared memory (one
stream an SM at the wire's 65,536 rows), for a group of at most
LARGE_WAVES waves of it (`large_fits` of ops/rans4x8.py and
ops/rans_nx16_o1.py), else the dense variant, over that table itself, 4
MiB a stream in device memory, built on the card in the group's framing.
The route is decided on the host, from the rows and alphabets the
streams' parse counts, before any launch; a refused launch raises and is
never retried on the other route.

The outputs are the JAX functions' bytes, in the input order: the JAX
4-way order-0 loop runs every stream to the batch's longest and cuts it
after, the port stops each stream at its length.  Errors are the JAX
functions' where the kernels take what JAX takes: ValueError on any
Nx16 transform flag and on frequencies past 4096, and on a zero-length
4x8 stream, whose empty table the JAX function's parse (as the port's
`_read_freqs`) reads past.  An order-0 table that sums below 4096 (no
encoder writes one) decodes as the JAX function decodes it, on both Nx16
widths: a slot past the sum is the JAX packed entry 0, symbol 0 with f = 1
and cum 0 (the host codec reads it otherwise:
tests/test_torch_rans_dense.py).  With `device="cpu"` the kernels' plain
PyTorch versions run.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

from htslib_tpu_torch import _build
from htslib_tpu_torch.codecs.rans4x16 import u7_get
from htslib_tpu_torch.ops import rans4x8 as t8
from htslib_tpu_torch.ops import rans_nx16_o1 as to1
from htslib_tpu_torch.ops.rans4x8 import (_parse_4x8_o1, decode_streams,
                                          frame_4x8, frame_nx16_4way)
from htslib_tpu_torch.ops.rans_nx16 import decode_o0_streams, frame_streams
from htslib_tpu_torch.ops.rans_nx16_o1 import (A2_MAX, _parse_nx16_header,
                                               decode_o1_streams,
                                               frame_o1_streams, o1_row_count)

# the launch groups of an order-1 wire: the record tables (within A2_MAX
# rows), and past them the large table or the dense one
ROUTES = ("", "_large", "_dense")


def _by_rows(idx: List[int], blocks: List[bytes], parse: Callable,
             fits: Callable, timing: Optional[dict]
             ) -> Tuple[List[List[int]], dict]:
    """Order-1 streams split by their tables into ROUTES' groups: within
    A2_MAX rows; past it, all in the large group where fits(their tables)
    says the large variant takes them, else all in the dense one.
    Returns (the groups, each stream's parse(block), its table second, by
    index, which the framing takes in place of a second parse).  The
    host seconds this takes add to timing["route_s"] where `timing` is
    given."""
    t0 = time.perf_counter()
    groups: List[List[int]] = [[], [], []]
    parsed = {}
    for i in idx:
        parsed[i] = parse(blocks[i])
        groups[2 * (o1_row_count(parsed[i][1]) > A2_MAX)].append(i)
    if groups[2] and fits([parsed[i][1] for i in groups[2]]):
        groups[1], groups[2] = groups[2], []
    if timing is not None:
        timing["route_s"] = (timing.get("route_s", 0.0)
                             + time.perf_counter() - t0)
    return groups, parsed


def _group(dev, timing: Optional[dict], name: str, n: int, frame, decode):
    """One launch group: decode(frame(part)), where `timing` is given
    noted under `name` as its streams, frame_s (parse, tables, upload;
    with dense tables their build on the device, dense_table_s, within
    it; a large group builds none) and decode_s (launch, kernel, download
    and slicing)."""
    if timing is None:
        return decode(frame(None))
    part = {"streams": n}
    t0 = _build.clock(dev)
    b = frame(part)
    t1 = _build.clock(dev)
    outs = decode(b)
    part.update(frame_s=t1 - t0, decode_s=_build.clock(dev) - t1)
    timing[name] = part
    return outs


def uncompress_batch(blocks: List[bytes], device="cuda",
                     timing: Optional[dict] = None) -> List[bytes]:
    """Decode rANS 4x8 streams of order 0 and 1, mixed (the order byte
    first, as the JAX function takes them), one launch an order (order-1
    streams past A2_MAX rows in one more).  A stream of another order
    byte gives b"", as in JAX.  `timing`, where given, gets each launch
    group's parts (`_group`) under 4x8_o0, 4x8_o1, 4x8_o1_large and
    4x8_o1_dense, and the order-1 tables' parse that routes them under
    route_s."""
    dev = _build.resolve_device(device)
    res = [b""] * len(blocks)
    for order in (0, 1):
        idx = [i for i, data in enumerate(blocks) if data[0] == order]
        groups, parsed = (_by_rows(idx, blocks, _parse_4x8_o1,
                                   lambda Fs: t8.large_fits(Fs, False, dev),
                                   timing)
                          if order else ([idx, [], []], {}))
        for route, g in zip(ROUTES, groups):
            if g:
                outs = _group(
                    dev, timing, f"4x8_o{order}" + route, len(g),
                    lambda t: frame_4x8([blocks[i] for i in g], bool(order),
                                        dev, route == "_dense", t,
                                        [parsed[i] for i in g] if order
                                        else None, route == "_large"),
                    decode_streams)
                for i, out in zip(g, outs):
                    res[i] = out
    return res


def uncompress_nx16_batch(blocks: List[bytes], device="cuda",
                          timing: Optional[dict] = None) -> List[bytes]:
    """Decode plain rANS Nx16 streams of order 0 and 1, 4-way and 32-way,
    mixed (flags 0x00, 0x01, 0x04, 0x05), one launch a (width, order)
    group (order-1 streams past A2_MAX rows in one more); a zero-length
    stream gives b"".  Raises ValueError, before any decode, on a
    transform flag.  `timing`, where given, gets each launch group's
    parts (`_group`) under nx16_{4,32}way_o{0,1}[_large|_dense], and the
    order-1 tables' parse that routes them under route_s."""
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
        nway = 32 if n32 else 4
        fits = ((lambda Fs: to1.large_fits(Fs, dev)) if n32
                else (lambda Fs: t8.large_fits(Fs, True, dev)))
        parts, parsed = (_by_rows(idxs, blocks,
                                  lambda d: _parse_nx16_header(d, nway),
                                  fits, timing)
                         if o1 else ([idxs, [], []], {}))
        for route, part in zip(ROUTES, parts):
            if not part:
                continue
            datas = [blocks[i] for i in part]
            ps = [parsed[i] for i in part] if o1 else None
            dense, large = route == "_dense", route == "_large"
            if n32 and o1:
                # decode_nx16_o1_batch's body, on the streams' parses
                frame, decode = (lambda t: frame_o1_streams(
                    ps, dev, dense, t, large), decode_o1_streams)
            elif n32:
                frame, decode = (lambda t: frame_streams(
                    datas, dev, normalised=False), decode_o0_streams)
            else:
                frame, decode = (lambda t: frame_nx16_4way(
                    datas, bool(o1), dev, dense, t, ps, large),
                    decode_streams)
            outs = _group(dev, timing, f"nx16_{nway}way_o{int(bool(o1))}"
                          + route, len(part), frame, decode)
            for i, out in zip(part, outs):
                res[i] = out
    return res
