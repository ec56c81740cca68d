"""Host allocator tuning for hosts where page faults are expensive (the
port's copy of htslib_tpu/util/memory.py).

On virtualised hosts, first-touch page faults can cost ~1000x a
normal fault.  glibc malloc by default mmaps every allocation >128KiB and
munmaps it on free, so every large numpy temporary re-faults its pages.
``tune_host_allocator`` turns that off (keep large blocks on the heap,
never trim) and optionally pre-faults a working-set arena, making batch
pipelines allocation-cost-free after warm-up.

The reference faces the same class of problem with per-block 64KiB
buffers and solves it with free-lists (bgzf.c job pools, cram spare-bam
lists); this is the whole-process equivalent.
"""
from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

_M_TRIM_THRESHOLD = -1
_M_TOP_PAD = -2
_M_MMAP_THRESHOLD = -3
_M_MMAP_MAX = -4

_tuned = False


def tune_host_allocator(prefault_bytes: int = 0) -> bool:
    """Disable malloc mmap/trim so large buffers are reused, optionally
    pre-faulting `prefault_bytes` of heap.  Idempotent; returns success."""
    global _tuned
    ok = True
    if not _tuned:
        try:
            libc = ctypes.CDLL(None)
            libc.mallopt(_M_MMAP_MAX, 0)
            libc.mallopt(_M_TRIM_THRESHOLD, 0x7FFFFFFF)
            libc.mallopt(_M_TOP_PAD, 16 << 20)
            _tuned = True
        except Exception:
            ok = False
    if prefault_bytes > 0:
        try:
            block = np.empty(prefault_bytes, np.uint8)
            block[::4096] = 0  # touch every page
            del block
        except MemoryError:
            ok = False
    return ok
