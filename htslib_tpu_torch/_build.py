"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for Hopper (`sm_90a`) into a
shared library with a plain C interface, `build/<name>-<hash>.so`, and
loaded with `ctypes`.  The hash covers the `.cu` source and every `.cuh`
header beside it, so an edited source builds anew and an unchanged one is
loaded from disk.  A file lock keeps concurrent processes from building
the same library twice, and a library is written under a temporary name
and renamed into place, so a process that finds it finds it whole: rank
processes started together load what their parent built, and build it
once between them when it did not.  Nothing is built on a host without
CUDA: `load` raises there, and callers only reach it for tensors that lie
on the card.

`LAUNCHES` counts, per kernel, the launches each wrapper made; a wrapper
adds one where it launches its kernel and nowhere else.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Optional

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: Dict[str, int] = {
    "nibble_to_base": 0, "rans_nx16_o0_decode": 0, "rans_nx16_o0_hist": 0,
    "rans_nx16_o1_decode": 0, "rans_nx16_o1_hist": 0,
    "rans4x8_o0_decode": 0, "rans4x8_o0_hist": 0, "rans4x8_o1_hist": 0,
    "rans_nx16_o0_encode": 0, "rans_resolve_bench": 0,
    "huffman_resolve_bench": 0, "rans4x8_o1_decode": 0,
    "rans_nx16_4way_o0_decode": 0, "rans_nx16_4way_o1_decode": 0,
    "rans4x8_o1_dense_decode": 0, "rans_nx16_4way_o1_dense_decode": 0,
    "rans_nx16_o1_dense_decode": 0, "rans4x8_o1_large_decode": 0,
    "rans_nx16_4way_o1_large_decode": 0, "rans_nx16_o1_large_decode": 0,
    "inflate": 0, "inflate_slot": 0,
    "record_scan": 0, "record_scan_seg": 0, "probaln": 0,
    "probaln_warp": 0}
# where a list: each launch of the kernels whose wrappers record their
# shapes (ops/rans4x8.py, ops/bam2sam.py) appends (launch key, ...its
# shape), so a run can reckon launches that no timing covers
# (chip_smoke.py); None costs nothing
SHAPES: Optional[list] = None
_LIBS: Dict[str, ctypes.CDLL] = {}
# (function, argtypes) per library: every pointer and the stream are
# c_void_p, so ctypes never narrows them to 32-bit ints
_SIGNATURES = {
    "nibble": {
        "nibble_to_base_launch": [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_longlong, ctypes.c_void_p],
    },
    "rans_nx16_o0": {
        "rans_nx16_o0_launch": [ctypes.c_void_p] * 12
        + [ctypes.c_int] * 3 + [ctypes.c_void_p],
        "rans_nx16_o0_blocks_per_sm": [ctypes.c_int] * 2,
    },
    "rans_nx16_o1": {
        "rans_nx16_o1_launch": [ctypes.c_void_p] * 19
        + [ctypes.c_int] * 5 + [ctypes.c_void_p],
        "rans_nx16_o1_smem_bytes": [ctypes.c_int] * 4,
        "rans_nx16_o1_blocks_per_sm": [ctypes.c_int] * 2,
        "rans_nx16_o1_large_smem_bytes": [ctypes.c_int] * 3,
        "rans_nx16_o1_large_blocks_per_sm": [ctypes.c_int],
    },
    "rans4x8": {
        "rans4x8_launch": [ctypes.c_void_p] * 18
        + [ctypes.c_int] * 5 + [ctypes.c_void_p],
        "rans4x8_blocks_per_sm": [ctypes.c_int] * 4,
        "rans4x8_smem_bytes": [ctypes.c_int] * 3,
        "rans4x8_wide_launch": [ctypes.c_void_p] * 18
        + [ctypes.c_int] * 5 + [ctypes.c_void_p],
        "rans4x8_wide_smem_bytes": [ctypes.c_int] * 2,
        "rans4x8_wide_blocks_per_sm": [ctypes.c_int] * 3,
        "rans4x8_large_launch": [ctypes.c_void_p] * 16
        + [ctypes.c_int] * 5 + [ctypes.c_void_p],
        "rans4x8_large_smem_bytes": [ctypes.c_int] * 2,
        "rans4x8_large_blocks_per_sm": [ctypes.c_int] * 3,
    },
    "rans_nx16_enc": {
        "rans_nx16_enc_launch": [ctypes.c_void_p] * 8
        + [ctypes.c_int] * 2 + [ctypes.c_void_p],
        "rans_nx16_enc_smem_bytes": [],
        "rans_nx16_enc_blocks_per_sm": [],
    },
    "rans_resolve_bench": {
        "rans_resolve_bench_launch": [ctypes.c_void_p] * 3
        + [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p],
        "rans_resolve_bench_smem_bytes": [],
        "rans_resolve_bench_chains_per_sm": [],
    },
    "huffman_resolve": {
        "huffman_resolve_launch": [ctypes.c_void_p] * 6
        + [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p],
        "huffman_resolve_smem_bytes": [],
        "huffman_resolve_chains_per_sm": [],
    },
    "inflate": {
        "inflate_launch": [ctypes.c_void_p] * 7 + [ctypes.c_int,
                                                   ctypes.c_void_p],
        "inflate_slot_launch": [ctypes.c_void_p] * 7 + [ctypes.c_int,
                                                        ctypes.c_void_p],
        "inflate_smem_bytes": [],
        "inflate_blocks_per_sm": [],
        "inflate_slot_smem_bytes": [],
        "inflate_slot_blocks_per_sm": [],
    },
    "record_scan": {
        "record_scan_launch": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 4,
        "record_scan_seg_launch": [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_int] + [ctypes.c_void_p] * 6
        + [ctypes.c_int, ctypes.c_void_p],
        "record_scan_window_bytes": [],
    },
    "probaln": {
        "probaln_launch": [ctypes.c_void_p] * 14 + [ctypes.c_int] * 3
        + [ctypes.c_double] * 2 + [ctypes.c_int, ctypes.c_void_p],
        "probaln_warp_launch": [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3
        + [ctypes.c_double] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
        "probaln_warp_j_max": [],
    },
}
# flags of one source beyond NVCC_FLAGS: X6 must not contract a * b + c
# into a fused multiply-add, so its float64 integers are the JAX function's
SOURCE_FLAGS = {"probaln": ["-fmad=false"]}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _source_hash(name: str) -> str:
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [f"{name}.cu"] + headers:
        with open(os.path.join(CSRC, f), "rb") as fp:
            h.update(f.encode() + b"\0" + fp.read())
    h.update(" ".join(NVCC_FLAGS + SOURCE_FLAGS.get(name, [])).encode())
    return h.hexdigest()[:16]


def _compile(name: str) -> str:
    """Compile csrc/<name>.cu unless its library is already built; returns
    the library path.  nvcc's own report (-Xptxas -v: registers, shared
    memory, spills) is written beside the library as <lib>.log."""
    os.makedirs(BUILD, exist_ok=True)
    lib = os.path.join(BUILD, f"{name}-{_source_hash(name)}.so")
    if os.path.exists(lib):
        return lib    # whole: a library appears only by an atomic rename
    with open(os.path.join(BUILD, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(lib):
                tmp = f"{lib}.{os.getpid()}.tmp"
                cmd = [_nvcc(), *NVCC_FLAGS, *SOURCE_FLAGS.get(name, []),
                       "-I", CSRC, "-o", tmp,
                       os.path.join(CSRC, f"{name}.cu")]
                res = subprocess.run(cmd, capture_output=True, text=True)
                with open(f"{lib}.log", "w") as log:
                    log.write(" ".join(cmd) + "\n" + res.stdout + res.stderr)
                if res.returncode != 0:
                    raise RuntimeError(f"nvcc failed for {name}.cu:\n"
                                       f"{res.stderr[-4000:]}")
                os.replace(tmp, lib)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib


def build(names: Iterable[str] = tuple(_SIGNATURES)) -> Dict[str, str]:
    """Compile the named kernel libraries, one nvcc process per source,
    all started together; returns {name: library path}."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA kernels are built only on a host with a "
                           "CUDA device")
    names = list(names)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(_compile, names)))


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built at first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    lib = ctypes.CDLL(build([name])[name])
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (cudaGetLastError)."""
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


# the codes of a kernel's error word (rans_nx16_o1_step.cuh RANS_REFUSE_*)
REFUSALS = {1: "its tables outgrew the shared memory the launch was sized "
               "for",
            2: "its slow buckets outnumbered the maps the launch was sized "
               "for"}


def error_word(device) -> torch.Tensor:
    """A zeroed int32 error word on `device` for a kernel that refuses a
    stream by setting it (csrc rans_refuse) rather than trapping."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def check_word(word: torch.Tensor, what: str) -> None:
    """Raise if a kernel set its error word: it refused a stream whose
    layout outgrew its launch (waits for the launch to end)."""
    code = int(word.item())
    if code:
        raise RuntimeError(f"{what}: a block refused its stream: "
                           f"{REFUSALS.get(code, f'code {code}')}")


def stream_handle(t: torch.Tensor) -> int:
    """PyTorch's current CUDA stream on the tensor's device, as an int."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(t: torch.Tensor, dtype: torch.dtype, name: str,
                 shape=None) -> None:
    """Validate a kernel argument: on the card, of `dtype`, contiguous and
    (where given) of `shape`."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU.  Raises rather than fall back when no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def clock(device) -> float:
    """Host seconds once `device`'s queued work has ended: the clock of
    the entry points' `timing` dicts."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()
