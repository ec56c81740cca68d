"""CRAM reference sequences (the port's copy of htslib_tpu/cram/refs.py;
reference cram/cram_io.c:2541-3409).

A sequence is looked up as cram_populate_ref (cram_io.c:2977) does, in
the supplied FASTA (`ref=`, with its `.fai`), then in the local file
that its @SQ line's UR tag names; it is cached whole.  The REF_CACHE and
REF_PATH lookups by M5 checksum (htslib_tpu/refcache.py) are not ported:
a sequence found in neither place raises IOError.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

from htslib_tpu_torch.faidx import Faidx
from htslib_tpu_torch.sam.header import SamHeader


class RefRegistry:
    def __init__(self, header: SamHeader, fasta: Optional[str] = None):
        self.header = header
        self.fai: Optional[Faidx] = Faidx.load(fasta) if fasta else None
        self._cache: Dict[int, bytes] = {}

    def _load_full(self, tid: int) -> bytes:
        if tid in self._cache:
            return self._cache[tid]
        name = self.header.tid2name(tid)
        seq: Optional[bytes] = None
        if self.fai is not None and self.fai.has_seq(name):
            seq = self.fai.fetch_seq(name).encode().upper()
        if seq is None:
            sq = self.header.find_line_id("SQ", "SN", name)
            ur = sq.get("UR") if sq is not None else None
            if (ur and not ur.startswith(("http:", "https:", "ftp:"))
                    and os.path.isfile(ur)):
                fai = Faidx.load(ur)
                if fai.has_seq(name):
                    seq = fai.fetch_seq(name).encode().upper()
                fai.close()
        if seq is None:
            raise IOError(f"unable to load reference for {name!r}; pass "
                          "ref=FILE")
        self._cache[tid] = seq
        return seq

    def get(self, tid: int, start: int, end: int) -> bytes:
        """1-based inclusive range; end=-1 means the whole sequence
        (cram_get_ref, cram_io.c:3409)."""
        seq = self._load_full(tid)
        if end == -1:
            return seq if start <= 1 else seq[start - 1:]
        return seq[start - 1:end]
