"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for Hopper (`sm_90a`) into a
shared library with a plain C interface, `build/<name>-<hash>.so`, and
loaded with `ctypes`.  The hash covers the `.cu` source and every `.cuh`
header beside it, so an edited source builds anew and an unchanged one is
loaded from disk.  A file lock keeps concurrent processes from building
the same library twice.  Nothing is built on a host without CUDA: `load`
raises there, and callers only reach it for tensors that lie on the card.

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
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable

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
    "huffman_resolve_bench": 0}
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
        "rans_nx16_o1_launch": [ctypes.c_void_p] * 17
        + [ctypes.c_int] * 4 + [ctypes.c_void_p],
        "rans_nx16_o1_smem_bytes": [ctypes.c_int] * 4,
        "rans_nx16_o1_blocks_per_sm": [ctypes.c_int] * 2,
    },
    "rans4x8": {
        "rans4x8_launch": [ctypes.c_void_p] * 17
        + [ctypes.c_int] * 4 + [ctypes.c_void_p],
        "rans4x8_blocks_per_sm": [ctypes.c_int] * 2,
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
    },
    "huffman_resolve": {
        "huffman_resolve_launch": [ctypes.c_void_p] * 6
        + [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p],
        "huffman_resolve_smem_bytes": [],
        "huffman_resolve_chains_per_sm": [],
    },
}


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
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _compile(name: str) -> str:
    """Compile csrc/<name>.cu unless its library is already built; returns
    the library path.  nvcc's own report (-Xptxas -v: registers, shared
    memory, spills) is written beside the library as <lib>.log."""
    os.makedirs(BUILD, exist_ok=True)
    lib = os.path.join(BUILD, f"{name}-{_source_hash(name)}.so")
    with open(os.path.join(BUILD, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(lib):
                tmp = f"{lib}.{os.getpid()}.tmp"
                cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
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
