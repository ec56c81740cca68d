"""Backward-sweeping VCF/BCF reader, the port's copy of
htslib_tpu/vcf_sweep.py (reference vcf_sweep.c:1-190, API
htslib/vcf_sweep.h): iterate records in reverse file order with
constant memory by walking the file in chunks from the back.

As in the reference, the first backward call builds an index of record
offsets sampled every `block_size` uncompressed bytes (vcf_sweep.c
sw_fill_buffer/idx machinery); bwd() then seeks to the previous chunk
boundary, re-reads that chunk's records forward into a small buffer and
drains it in reverse — memory is O(chunk), not O(file).
"""
from __future__ import annotations

from typing import List, Optional

from htslib_tpu_torch.vcf import BcfRecord, open_vcf

SW_FWD = 0
SW_BWD = 1


class VcfSweep:
    """bcf_sweep_t: fwd() iterates forward, bwd() backward."""

    def __init__(self, fname: str, block_size: int = 1 << 16):
        self.fname = fname
        self.block_size = block_size
        self._rd = open_vcf(fname)
        self.header = self._rd.header
        self.direction = SW_FWD
        self._idx: Optional[List[int]] = None   # chunk-start tell() marks
        self._iidx = 0
        self._buf: List[BcfRecord] = []

    # -- forward ---------------------------------------------------------
    def fwd(self) -> Optional[BcfRecord]:
        if self.direction != SW_FWD:
            # restart forward from the head (the reference reopens at 0)
            self._rd.close()
            self._rd = open_vcf(self.fname)
            self.direction = SW_FWD
        return self._rd.read1()

    # -- backward --------------------------------------------------------
    def _build_index(self) -> None:
        """One forward pass recording the reader offset at every chunk
        boundary (>= block_size consumed since the last mark)."""
        rd = open_vcf(self.fname)
        idx = []
        last_mark = None
        while True:
            pos = rd.tell()
            rec = rd.read1()
            if rec is None:
                break
            # virtual offsets: compressed-block part in the high bits —
            # use them as opaque monotone marks
            if last_mark is None or self._dist(last_mark, pos):
                idx.append(pos)
                last_mark = pos
        rd.close()
        self._idx = idx
        self._iidx = len(idx)

    def _dist(self, a: int, b: int) -> bool:
        # chunk boundary when the compressed offset advanced past
        # block_size>>4 compressed bytes (virtual offset high 48 bits)
        return (b >> 16) - (a >> 16) >= max(self.block_size >> 4, 1)

    def _fill_buffer(self) -> None:
        """Read one chunk [idx[iidx-1], idx[iidx]) forward into the
        buffer (sw_fill_buffer, vcf_sweep.c)."""
        self._buf = []
        if self._iidx == 0:
            return
        self._iidx -= 1
        start = self._idx[self._iidx]
        end = self._idx[self._iidx + 1] \
            if self._iidx + 1 < len(self._idx) else None
        rd = open_vcf(self.fname)
        rd.seek(start)
        while True:
            pos = rd.tell()
            if end is not None and pos >= end:
                break
            rec = rd.read1()
            if rec is None:
                break
            self._buf.append(rec)
        rd.close()

    def bwd(self) -> Optional[BcfRecord]:
        if self.direction != SW_BWD:
            self.direction = SW_BWD
            if self._idx is None:
                self._build_index()
            self._iidx = len(self._idx)
            self._buf = []
        while not self._buf:
            if self._iidx == 0:
                return None
            self._fill_buffer()
        return self._buf.pop()

    def close(self) -> None:
        self._rd.close()

    def __enter__(self):
        return self

    def __exit__(self, *e):
        self.close()
