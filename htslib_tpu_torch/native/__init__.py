"""ctypes bridge to the port's native host library (libhtstpu).

The port's copy of htslib_tpu/native/__init__.py, over its own copies of
the C++ engine (src/htstpu.cc) and the htscodecs shim (htscodecs_shim/):
the production host route for BGZF inflate and deflate, record framing
scans, SAM/BAM/VCF/BCF formatting and parsing, the mpileup engine, and
CRAM slice decode and encode with the CRAM 3.1 codecs.

The library is built at first use (the first attribute of `native` that
reaches the library), from the sources beside this file, into
htslib_tpu_torch/build/libhtstpu-<hash>.so: g++ for the C++ and gcc for
the shim, the flags of the JAX package's Makefile (-O3 -march=native
-fPIC, -std=c++17 / -std=c11; linked -shared -pthread -ldeflate -llzma
-ldl), the C files compiled in parallel.  The hash covers every source
and header, the flags, the compiler's version and the host's CPU flags,
so an edited source or another host builds anew.  A file lock keeps
concurrent processes from building it twice, and the library is written
under a temporary name and renamed into place.  Where <libdeflate.h> or
<lzma.h> does not compile and link, compat/ stands in for it: libdeflate's
calls on zlib (inflate gives the same bytes, deflate gives zlib's) and
liblzma's one call through dlopen of liblzma.so.5.  A failed build
raises, with the compiler's report.

`native` is set by default; the pure-Python and device routes are
taken by setting `htslib_tpu_torch.native.native = None`, as the JAX
package's tests set `htslib_tpu.native.native`.  The per-call
fallbacks of the callers (an IOError of a malformed record, the slice
decoder's bail on a configuration it does not handle) are the JAX
package's.

`CALLS` counts the calls of each bridge function; a function adds one
when it is called and nowhere else.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from htslib_tpu_torch.util.log import log_info

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(os.path.dirname(_DIR), "build")

MAX_BLOCK = 0x10000

CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall"]
CFLAGS = ["-O3", "-march=native", "-fPIC", "-std=c11", "-Wall"]
LDFLAGS = ["-shared", "-pthread"]
# the shim's sources that the JAX package's Makefile builds (SHIM_SRCS)
SHIM_SRCS = ["rANS_static4x16pr.c", "rANS_static32x16pr_avx2.c",
             "rANS_static32x16pr_sse4.c", "arith_dynamic.c",
             "fqzcomp_qual.c", "tokenise_name3.c", "rANS_static.c",
             "pack.c", "rle.c"]
# each system library, the program that shows it compiles and links, and
# what stands in where it does not (compat/)
_LIBS = {
    "deflate": ("#include <libdeflate.h>\nint main(void) {"
                " return libdeflate_alloc_compressor(6) == 0; }\n",
                ["-ldeflate"], ["-lz"]),
    "lzma": ("#include <lzma.h>\nint main(void) {"
             " return lzma_stream_buffer_decode != 0 ? 0 : 1; }\n",
             ["-llzma"], []),
}

CALLS: Dict[str, int] = {}
_CALLS_LOCK = threading.Lock()    # bridge calls come from pool threads
# seconds of the last build in this process (0 where the library was
# found built), and the system libraries compat/ stood in for
BUILD_INFO: Dict[str, object] = {"seconds": 0.0, "compat": [],
                                 "path": None}


def reset_calls() -> None:
    for k in CALLS:
        CALLS[k] = 0


def _counted(fn):
    """Count each call of a bridge function in CALLS[its name]."""
    CALLS[fn.__name__] = 0

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _CALLS_LOCK:
            CALLS[fn.__name__] += 1
        return fn(*args, **kwargs)
    return wrapper


def _tools() -> Tuple[str, str]:
    cxx = os.environ.get("CXX") or "g++"
    cc = os.environ.get("CC") or "gcc"
    for tool in (cxx, cc):
        if shutil.which(tool) is None:
            raise RuntimeError(f"native build: compiler {tool!r} not found")
    return cxx, cc


def _probe(cxx: str, name: str, out_dir: str) -> bool:
    """Whether the system library `name` of _LIBS compiles and links."""
    prog, libs, _ = _LIBS[name]
    with tempfile.TemporaryDirectory(dir=out_dir) as d:
        src = os.path.join(d, "probe.cc")
        with open(src, "w") as fp:
            fp.write(prog)
        res = subprocess.run([cxx, src, "-o", os.path.join(d, "probe"),
                              *libs], capture_output=True)
    return res.returncode == 0


def _compat_for(cxx: str, tools_key: str, out_dir: str) -> List[str]:
    """The system libraries of _LIBS that do not compile and link here,
    probed once for this compiler and host and kept in `out_dir`, so a
    process that loads the built library probes nothing."""
    path = os.path.join(out_dir, "libhtstpu-probe-" + hashlib.sha256(
        tools_key.encode()).hexdigest()[:16] + ".txt")
    if os.path.exists(path):
        with open(path) as fp:
            return fp.read().split()
    compat = [n for n in _LIBS if not _probe(cxx, n, out_dir)]
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as fp:
        fp.write(" ".join(compat))
    os.replace(tmp, path)
    return compat


def _cpu_flags() -> str:
    try:
        with open("/proc/cpuinfo") as fp:
            for line in fp:
                if line.startswith("flags"):
                    return line
    except OSError:
        pass
    return platform.processor()


def source_hash(root: str = _DIR, flags: Tuple[str, ...] = ()) -> str:
    """The hash that names the library: every file of root's src/,
    htscodecs_shim/ and compat/, by relative name and bytes, and
    `flags` (the compilers, their versions and flags, the host's CPU
    flags)."""
    h = hashlib.sha256()
    for sub in ("src", "htscodecs_shim", "compat"):
        d = os.path.join(root, sub)
        for f in sorted(os.listdir(d)):
            with open(os.path.join(d, f), "rb") as fp:
                h.update(f"{sub}/{f}".encode() + b"\0" + fp.read() + b"\0")
    h.update("\0".join(flags).encode())
    return h.hexdigest()[:16]


def _run(cmd: List[str]) -> None:
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("native build failed: " + " ".join(cmd) + "\n"
                           + res.stderr[-6000:])


def build(root: str = _DIR, out_dir: str = BUILD) -> str:
    """Build the library from root's sources unless it is built; returns
    its path.  Raises RuntimeError, with the compiler's report, where a
    step fails."""
    os.makedirs(out_dir, exist_ok=True)
    cxx, cc = _tools()
    versions = [subprocess.run([t, "-dumpfullversion"], capture_output=True,
                               text=True).stdout.strip() for t in (cxx, cc)]
    compat = _compat_for(cxx, "\0".join((cxx, cc, *versions, _cpu_flags())),
                         out_dir)
    inc = ["-I", os.path.join(root, "compat")] if compat else []
    libs = [x for n in _LIBS
            for x in (_LIBS[n][2] if n in compat else _LIBS[n][1])] + ["-ldl"]
    key = (cxx, cc, *versions, *CXXFLAGS, *CFLAGS, *LDFLAGS, *inc, *libs,
           _cpu_flags())
    lib = os.path.join(out_dir, f"libhtstpu-{source_hash(root, key)}.so")
    BUILD_INFO.update(seconds=0.0, compat=compat, path=lib)
    if os.path.exists(lib):
        return lib    # whole: a library appears only by an atomic rename
    with open(os.path.join(out_dir, "libhtstpu.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(lib):
                return lib
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
                shim = os.path.join(root, "htscodecs_shim")
                jobs = [[cxx, *CXXFLAGS, *inc, "-c", "-o",
                         os.path.join(tmp, "htstpu.o"),
                         os.path.join(root, "src", "htstpu.cc")]]
                jobs += [[cc, *CFLAGS, "-c", "-o",
                          os.path.join(tmp, s[:-2] + ".o"),
                          os.path.join(shim, s)] for s in SHIM_SRCS]
                with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
                    list(pool.map(_run, jobs))
                objs = [j[j.index("-o") + 1] for j in jobs]
                part = os.path.join(tmp, "libhtstpu.so")
                _run([cxx, *CXXFLAGS, *LDFLAGS, "-o", part, *objs, *libs])
                os.replace(part, lib)
            BUILD_INFO["seconds"] = time.perf_counter() - t0
            log_info("native library built in %.1f s (%s)%s",
                     BUILD_INFO["seconds"], os.path.basename(lib),
                     f"; compat/ for {', '.join(compat)}" if compat else "")
            return lib
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


class _Native:
    """The library's functions, built and loaded at the first use of
    `_lib` (the JAX package's `_Native`, which loads at import)."""

    def __init__(self):
        self._handle: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    @property
    def _lib(self) -> ctypes.CDLL:
        if self._handle is None:
            with self._lock:
                if self._handle is None:
                    lib = ctypes.CDLL(build())
                    self._setup(lib)
                    self._handle = lib
        return self._handle

    def load(self) -> ctypes.CDLL:
        """Build (where needed) and load the library now."""
        return self._lib

    @staticmethod
    def _setup(lib: ctypes.CDLL) -> None:
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.htstpu_bgzf_scan.restype = ctypes.c_int64
        lib.htstpu_bgzf_scan.argtypes = [u8p, ctypes.c_uint64, ctypes.c_uint64,
                                         u64p, u32p, u32p]
        lib.htstpu_inflate_batch.restype = ctypes.c_int64
        lib.htstpu_inflate_batch.argtypes = [
            u8p, ctypes.c_uint64, ctypes.c_int64, u64p, u32p, u32p, u64p, u8p,
            ctypes.c_int, ctypes.c_int]
        lib.htstpu_deflate_batch.restype = ctypes.c_int64
        lib.htstpu_deflate_batch.argtypes = [
            u8p, ctypes.c_int64, u64p, u32p, ctypes.c_int, u8p, u32p,
            ctypes.c_int]
        lib.htstpu_bam_scan.restype = ctypes.c_int64
        lib.htstpu_bam_scan.argtypes = [u8p, ctypes.c_uint64, ctypes.c_uint64,
                                        ctypes.c_uint64, u64p, u32p]
        lib.htstpu_crc32.restype = ctypes.c_uint32
        lib.htstpu_crc32.argtypes = [ctypes.c_uint32, u8p, ctypes.c_uint64]
        lib.htstpu_bam_to_sam.restype = ctypes.c_int64
        lib.htstpu_bam_to_sam.argtypes = [
            u8p, u64p, u32p, ctypes.c_int64, u8p, u64p, u32p,
            ctypes.c_int32, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int]
        lib.htstpu_bam_scan_format.restype = ctypes.c_int64
        lib.htstpu_bam_scan_format.argtypes = [
            u8p, ctypes.c_uint64, ctypes.c_uint64, u8p, u64p, u32p,
            ctypes.c_int32, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int]
        lib.htstpu_bgzf_to_sam.restype = ctypes.c_int64
        lib.htstpu_bgzf_to_sam.argtypes = [
            u8p, ctypes.c_uint64, ctypes.c_uint64, u8p, u64p, u32p,
            ctypes.c_int32, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)), ctypes.c_int]
        lib.htstpu_sam_to_bam.restype = ctypes.c_int64
        lib.htstpu_sam_to_bam.argtypes = [
            u8p, ctypes.c_uint64, u8p, u64p, u32p, ctypes.c_int32,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)), ctypes.c_int]
        lib.htstpu_mpileup.restype = ctypes.c_int64
        lib.htstpu_mpileup.argtypes = [
            u8p, ctypes.c_uint64, u8p, u64p, u32p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
        lib.htstpu_vcf_parse.restype = ctypes.c_int64
        lib.htstpu_vcf_parse.argtypes = [
            u8p, ctypes.c_uint64,
            u8p, u64p, u32p, i32p, i32p, i32p, ctypes.c_int32,
            u8p, u64p, u32p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            u8p, ctypes.c_int64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
        lib.htstpu_bcf_to_vcf.restype = ctypes.c_int64
        lib.htstpu_bcf_to_vcf.argtypes = [
            u8p, ctypes.c_uint64, u8p, u64p, u32p, ctypes.c_int32,
            u8p, u64p, u32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
        lib.htstpu_buf_free.restype = None
        lib.htstpu_cram_slice_to_sam.restype = ctypes.c_int64
        lib.htstpu_cram_encode_slice.restype = ctypes.c_int64
        lib.htstpu_cram_encode_slice.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
            ctypes.c_int32, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
            ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.rans_compress_4x16.restype = u8p
        lib.rans_compress_4x16.argtypes = [
            ctypes.c_char_p, ctypes.c_uint, ctypes.POINTER(ctypes.c_uint),
            ctypes.c_int]
        lib.rans_uncompress_4x16.restype = u8p
        lib.rans_uncompress_4x16.argtypes = [
            ctypes.c_char_p, ctypes.c_uint, ctypes.POINTER(ctypes.c_uint)]
        lib.arith_compress_to.restype = u8p
        lib.arith_compress_to.argtypes = [
            ctypes.c_char_p, ctypes.c_uint, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint), ctypes.c_int]
        lib.arith_uncompress_to.restype = u8p
        lib.arith_uncompress_to.argtypes = [
            ctypes.c_char_p, ctypes.c_uint, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint)]
        lib.fqz_compress.restype = u8p
        lib.fqz_compress.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t), ctypes.c_int, ctypes.c_void_p]
        lib.fqz_decompress.restype = u8p
        lib.fqz_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t),
            ctypes.c_void_p, ctypes.c_int]
        lib.tok3_encode_names.restype = u8p
        lib.tok3_encode_names.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        lib.tok3_decode_names.restype = u8p
        lib.tok3_decode_names.argtypes = [
            ctypes.c_char_p, ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint32)]
        lib.htstpu_buf_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        lib.htstpu_rans4x8_uncompress.restype = ctypes.c_int64
        lib.htstpu_rans4x8_uncompress.argtypes = [u8p, ctypes.c_uint64, u8p,
                                                  ctypes.c_uint64]
        lib.htstpu_rans4x8_compress.restype = ctypes.c_int64
        lib.htstpu_rans4x8_compress.argtypes = [
            u8p, ctypes.c_uint64, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
        lib.htstpu_gzip_compress.restype = ctypes.c_int64
        lib.htstpu_gzip_compress.argtypes = [
            u8p, ctypes.c_uint64, ctypes.c_int32,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
        lib.htstpu_bam_fields.restype = ctypes.c_int64
        lib.htstpu_bam_fields.argtypes = [
            u8p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32)]
        lib.htstpu_cram_decode_slice.restype = ctypes.c_int64
        lib.htstpu_cram_decode_slice.argtypes = [
            u8p, ctypes.c_uint64,                       # comp_hdr
            ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int64,             # slice header
            ctypes.c_int32, i32p, i32p, u64p, u64p, u8p,  # blocks
            u8p, ctypes.c_uint64, ctypes.c_int64, ctypes.c_int64,  # ref
            ctypes.c_int32, u8p, u64p, u32p, u8p,       # read groups
            ctypes.c_int32,                             # decode_md
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]

    @staticmethod
    def _u8(arr: np.ndarray):
        return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    @staticmethod
    def _ptr(arr: np.ndarray, ctype):
        return arr.ctypes.data_as(ctypes.POINTER(ctype))

    @_counted
    def bgzf_scan(self, data: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        data = np.ascontiguousarray(data)
        cap = max(len(data) // 28 + 1, 16)
        co = np.empty(cap, np.uint64)
        cs = np.empty(cap, np.uint32)
        us = np.empty(cap, np.uint32)
        n = self._lib.htstpu_bgzf_scan(
            self._u8(data), len(data), cap,
            self._ptr(co, ctypes.c_uint64), self._ptr(cs, ctypes.c_uint32),
            self._ptr(us, ctypes.c_uint32))
        if n < 0:
            raise IOError(f"BGZF scan failed (err {n})")
        return co[:n].copy(), cs[:n].copy(), us[:n].copy()

    @_counted
    def inflate_batch(self, data: np.ndarray, coffsets: np.ndarray,
                      csizes: np.ndarray, usizes: np.ndarray,
                      verify_crc: bool = True, nthreads: int = 0) -> np.ndarray:
        data = np.ascontiguousarray(data)
        coffsets = np.ascontiguousarray(coffsets, np.uint64)
        csizes = np.ascontiguousarray(csizes, np.uint32)
        usizes = np.ascontiguousarray(usizes, np.uint32)
        out_offsets = np.zeros(len(usizes), np.uint64)
        np.cumsum(usizes[:-1], dtype=np.uint64, out=out_offsets[1:])
        total = int(usizes.sum(dtype=np.uint64))
        out = np.empty(total, np.uint8)
        r = self._lib.htstpu_inflate_batch(
            self._u8(data), len(data), len(usizes),
            self._ptr(coffsets, ctypes.c_uint64),
            self._ptr(csizes, ctypes.c_uint32),
            self._ptr(usizes, ctypes.c_uint32),
            self._ptr(out_offsets, ctypes.c_uint64), self._u8(out),
            1 if verify_crc else 0, nthreads)
        if r < 0:
            raise IOError(f"BGZF inflate failed on block {-(r + 1000)}")
        return out

    @_counted
    def deflate_blocks(self, chunks: List[bytes], level: int = -1,
                       nthreads: int = 0) -> List[bytes]:
        n = len(chunks)
        if n == 0:
            return []
        lens = np.array([len(c) for c in chunks], np.uint32)
        in_offsets = np.zeros(n, np.uint64)
        np.cumsum(lens[:-1], dtype=np.uint64, out=in_offsets[1:])
        data = np.frombuffer(b"".join(chunks), np.uint8)
        out = np.empty(n * MAX_BLOCK, np.uint8)
        out_lens = np.zeros(n, np.uint32)
        if level > 9:
            level = 9
        r = self._lib.htstpu_deflate_batch(
            self._u8(data), n, self._ptr(in_offsets, ctypes.c_uint64),
            self._ptr(lens, ctypes.c_uint32), level, self._u8(out),
            self._ptr(out_lens, ctypes.c_uint32), nthreads)
        if r < 0:
            raise IOError(f"BGZF deflate failed on chunk {-(r + 2000)}")
        return [out[i * MAX_BLOCK: i * MAX_BLOCK + int(out_lens[i])].tobytes()
                for i in range(n)]

    @_counted
    def deflate_batch_np(self, data: np.ndarray, in_offsets: np.ndarray,
                         in_lens: np.ndarray, level: int = -1,
                         nthreads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """Zero-copy variant: returns (out buffer [n*MAX_BLOCK], out_lens)."""
        n = len(in_lens)
        data = np.ascontiguousarray(data)
        in_offsets = np.ascontiguousarray(in_offsets, np.uint64)
        in_lens = np.ascontiguousarray(in_lens, np.uint32)
        out = np.empty(n * MAX_BLOCK, np.uint8)
        out_lens = np.zeros(n, np.uint32)
        if level > 9:
            level = 9
        r = self._lib.htstpu_deflate_batch(
            self._u8(data), n, self._ptr(in_offsets, ctypes.c_uint64),
            self._ptr(in_lens, ctypes.c_uint32), level, self._u8(out),
            self._ptr(out_lens, ctypes.c_uint32), nthreads)
        if r < 0:
            raise IOError(f"BGZF deflate failed on chunk {-(r + 2000)}")
        return out, out_lens

    @_counted
    def bam_scan(self, data: np.ndarray, start: int) -> Tuple[np.ndarray, np.ndarray]:
        data = np.ascontiguousarray(data)
        cap = max((len(data) - start) // 36 + 1, 16)
        offs = np.empty(cap, np.uint64)
        sizes = np.empty(cap, np.uint32)
        n = self._lib.htstpu_bam_scan(
            self._u8(data), len(data), start, cap,
            self._ptr(offs, ctypes.c_uint64), self._ptr(sizes, ctypes.c_uint32))
        if n < 0:
            raise IOError(f"BAM record scan failed (err {n})")
        return offs[:n].copy(), sizes[:n].copy()

    @_counted
    def crc32(self, data: np.ndarray, crc: int = 0) -> int:
        data = np.ascontiguousarray(data)
        return int(self._lib.htstpu_crc32(crc, self._u8(data), len(data)))

    @_counted
    def bam_to_sam(self, data: np.ndarray, offs: np.ndarray,
                   sizes: np.ndarray, ref_names: List[str],
                   nthreads: int = 0) -> bytes:
        """Format a whole record batch as SAM text (multithreaded C++)."""
        data = np.ascontiguousarray(data)
        offs = np.ascontiguousarray(offs, np.uint64)
        sizes = np.ascontiguousarray(sizes, np.uint32)
        names = [n.encode() for n in ref_names]
        name_buf = np.frombuffer(b"".join(names) + b"\0", np.uint8)
        name_lens = np.array([len(n) for n in names] or [0], np.uint32)
        name_offs = np.zeros(max(len(names), 1), np.uint64)
        if len(names) > 1:
            np.cumsum(name_lens[:-1], dtype=np.uint64, out=name_offs[1:])
        out_ptr = ctypes.POINTER(ctypes.c_uint8)()
        r = self._lib.htstpu_bam_to_sam(
            self._u8(data), self._ptr(offs, ctypes.c_uint64),
            self._ptr(sizes, ctypes.c_uint32), len(offs),
            self._u8(name_buf), self._ptr(name_offs, ctypes.c_uint64),
            self._ptr(name_lens, ctypes.c_uint32), len(names),
            ctypes.byref(out_ptr), nthreads)
        if r < 0:
            raise IOError(f"native SAM format failed on record {-(r + 3000)}")
        try:
            return ctypes.string_at(out_ptr, r)
        finally:
            self._lib.htstpu_buf_free(out_ptr)

    @_counted
    def bam_scan_format(self, data: np.ndarray, start: int,
                        ref_names: List[str],
                        nthreads: int = 0) -> np.ndarray:
        """Fused record-scan + SAM formatting over an uncompressed BAM
        stream: the serial framing walk overlaps with the format
        workers instead of preceding them.  Returns a zero-copy uint8
        view of the native buffer (freed when the array dies)."""
        import weakref
        data = np.ascontiguousarray(data)
        names = [n.encode() for n in ref_names]
        name_buf = np.frombuffer(b"".join(names) + b"\0", np.uint8)
        name_lens = np.array([len(n) for n in names] or [0], np.uint32)
        name_offs = np.zeros(max(len(names), 1), np.uint64)
        if len(names) > 1:
            np.cumsum(name_lens[:-1], dtype=np.uint64, out=name_offs[1:])
        out_ptr = ctypes.POINTER(ctypes.c_uint8)()
        r = self._lib.htstpu_bam_scan_format(
            self._u8(data), len(data), start,
            self._u8(name_buf), self._ptr(name_offs, ctypes.c_uint64),
            self._ptr(name_lens, ctypes.c_uint32), len(names),
            ctypes.byref(out_ptr), nthreads)
        if r == -2 or r == -3:
            self._lib.htstpu_buf_free(out_ptr)
            raise IOError("truncated BAM record stream")
        if r < 0:
            raise IOError(f"native SAM format failed on record {-(r + 3000)}")
        cbuf = ctypes.cast(out_ptr,
                           ctypes.POINTER(ctypes.c_uint8 * r)).contents
        weakref.finalize(cbuf, self._lib.htstpu_buf_free, out_ptr)
        return np.frombuffer(cbuf, np.uint8)

    @_counted
    def bgzf_to_sam(self, raw: np.ndarray, u_skip: int,
                    ref_names: List[str], verify_crc: bool = True,
                    nthreads: int = 0) -> np.ndarray:
        """Fully fused BGZF->SAM: block inflate + record scan + SAM
        formatting overlap in one native thread team (the batch analogue
        of bgzf.c:1598 + sam.c:3325 MT pipelines).  `u_skip` skips the
        BAM header's uncompressed bytes.  Zero-copy uint8 result."""
        import weakref
        raw = np.ascontiguousarray(raw)
        names = [n.encode() for n in ref_names]
        name_buf = np.frombuffer(b"".join(names) + b"\0", np.uint8)
        name_lens = np.array([len(n) for n in names] or [0], np.uint32)
        name_offs = np.zeros(max(len(names), 1), np.uint64)
        if len(names) > 1:
            np.cumsum(name_lens[:-1], dtype=np.uint64, out=name_offs[1:])
        out_ptr = ctypes.POINTER(ctypes.c_uint8)()
        r = self._lib.htstpu_bgzf_to_sam(
            self._u8(raw), len(raw), u_skip,
            self._u8(name_buf), self._ptr(name_offs, ctypes.c_uint64),
            self._ptr(name_lens, ctypes.c_uint32), len(names),
            1 if verify_crc else 0, ctypes.byref(out_ptr), nthreads)
        if r in (-2, -3):
            raise IOError("truncated or malformed BGZF/BAM stream")
        if r < 0:
            if r <= -3000:
                raise IOError(f"native SAM format failed on record {-(r + 3000)}")
            raise IOError(f"BGZF inflate failed on block {-(r + 1000)}")
        cbuf = ctypes.cast(out_ptr,
                           ctypes.POINTER(ctypes.c_uint8 * r)).contents
        weakref.finalize(cbuf, self._lib.htstpu_buf_free, out_ptr)
        return np.frombuffer(cbuf, np.uint8)

    @_counted
    def sam_to_bam(self, text: np.ndarray, ref_names: List[str],
                   nthreads: int = 0) -> np.ndarray:
        """Parse SAM text into a BAM record stream (u32 length-prefixed
        records), multithreaded (sam_parse_worker equivalent).  Raises
        IOError naming the offending line on malformed input or when a
        line needs the Python slow path (unknown reference, >65535-op
        CIGAR)."""
        import weakref
        text = np.ascontiguousarray(text)
        names = [n.encode() for n in ref_names]
        name_buf = np.frombuffer(b"".join(names) + b"\0", np.uint8)
        name_lens = np.array([len(n) for n in names] or [0], np.uint32)
        name_offs = np.zeros(max(len(names), 1), np.uint64)
        if len(names) > 1:
            np.cumsum(name_lens[:-1], dtype=np.uint64, out=name_offs[1:])
        out_ptr = ctypes.POINTER(ctypes.c_uint8)()
        r = self._lib.htstpu_sam_to_bam(
            self._u8(text), len(text),
            self._u8(name_buf), self._ptr(name_offs, ctypes.c_uint64),
            self._ptr(name_lens, ctypes.c_uint32), len(names),
            ctypes.byref(out_ptr), nthreads)
        if r < 0:
            raise IOError(f"native SAM parse failed on line {-(r + 4000)}")
        cbuf = ctypes.cast(out_ptr,
                           ctypes.POINTER(ctypes.c_uint8 * r)).contents
        weakref.finalize(cbuf, self._lib.htstpu_buf_free, out_ptr)
        return np.frombuffer(cbuf, np.uint8)

    @_counted
    def mpileup(self, data: np.ndarray, ref_names: List[str],
                skip_mask: int = 0, overlaps: bool = True,
                window=None) -> bytes:
        """Pileup text (test/pileup.c format) over a u32-framed BAM
        record stream — native resolve_cigar2 + overlap tweak engine.
        `window` = ((lo_tid, lo_pos), (hi_tid, hi_pos)) gates column
        emission to a coordinate tile (halo reads still processed).
        Raises BlockingIOError on kBail (caller uses the Python
        engine)."""
        data = np.ascontiguousarray(data)
        names = [n.encode() for n in ref_names]
        name_buf = np.frombuffer(b"".join(names) + b"\0", np.uint8)
        name_lens = np.array([len(n) for n in names] or [0], np.uint32)
        name_offs = np.zeros(max(len(names), 1), np.uint64)
        if len(names) > 1:
            np.cumsum(name_lens[:-1], dtype=np.uint64, out=name_offs[1:])
        out_ptr = ctypes.POINTER(ctypes.c_uint8)()
        if window is None:
            lo, hi = (-(1 << 30), 0), ((1 << 30), 1 << 62)
        else:
            lo, hi = window
        r = self._lib.htstpu_mpileup(
            self._u8(data), len(data),
            self._u8(name_buf), self._ptr(name_offs, ctypes.c_uint64),
            self._ptr(name_lens, ctypes.c_uint32), len(names),
            skip_mask, 1 if overlaps else 0,
            int(lo[0]), int(lo[1]), int(hi[0]), int(hi[1]),
            ctypes.byref(out_ptr))
        if r == -100:
            raise BlockingIOError("native mpileup bailed")
        if r < 0:
            raise IOError(f"native mpileup failed ({r})")
        try:
            return ctypes.string_at(out_ptr, r)
        finally:
            self._lib.htstpu_buf_free(out_ptr)

    @staticmethod
    def _strtab(names: List[str]):
        bufs = [n.encode() for n in names]
        buf = np.frombuffer(b"".join(bufs) + b"\0", np.uint8)
        lens = np.array([len(n) for n in bufs] or [0], np.uint32)
        offs = np.zeros(max(len(bufs), 1), np.uint64)
        if len(bufs) > 1:
            np.cumsum(lens[:-1], dtype=np.uint64, out=offs[1:])
        return buf, offs, lens

    @_counted
    def bcf_to_vcf(self, data: np.ndarray, ctg_names: List[str],
                   id_names: List[str], gt_id: int,
                   v44: bool = False) -> bytes:
        """Format a BCF record stream as VCF text (vcf_format port,
        vcf.c:4304)."""
        data = np.ascontiguousarray(data)
        cb, co, cl = self._strtab(ctg_names)
        ib, io_, il = self._strtab(id_names)
        out_ptr = ctypes.POINTER(ctypes.c_uint8)()
        r = self._lib.htstpu_bcf_to_vcf(
            self._u8(data), len(data),
            self._u8(cb), self._ptr(co, ctypes.c_uint64),
            self._ptr(cl, ctypes.c_uint32), len(ctg_names),
            self._u8(ib), self._ptr(io_, ctypes.c_uint64),
            self._ptr(il, ctypes.c_uint32), len(id_names),
            gt_id, 1 if v44 else 0, ctypes.byref(out_ptr))
        if r < 0:
            raise IOError(f"native BCF format failed on record {-(r + 5000)}")
        try:
            return ctypes.string_at(out_ptr, r)
        finally:
            self._lib.htstpu_buf_free(out_ptr)

    @_counted
    def vcf_parse(self, body: np.ndarray, id_names: List[str],
                  flt_def: np.ndarray, info_type: np.ndarray,
                  fmt_type: np.ndarray, ctg_names: List[str],
                  gt_id: int, end_id: int, n_samples: int,
                  n_lines: int, v44: bool = False) -> Tuple[bytes, np.ndarray]:
        """Parse VCF body text into BCF frames (vcf_parse port,
        vcf.c:3987).  Returns (frames, bails): frames holds the encoded
        records of non-bailing lines in order; bails[i]=1 marks lines
        Python must re-parse (unknown names etc.)."""
        body = np.ascontiguousarray(body)
        ib, io_, il = self._strtab(id_names)
        cb, co, cl = self._strtab(ctg_names)
        fd = np.ascontiguousarray(flt_def, np.int32)
        it = np.ascontiguousarray(info_type, np.int32)
        ft = np.ascontiguousarray(fmt_type, np.int32)
        bails = np.zeros(max(n_lines, 1), np.uint8)
        out_ptr = ctypes.POINTER(ctypes.c_uint8)()
        r = self._lib.htstpu_vcf_parse(
            self._u8(body), len(body),
            self._u8(ib), self._ptr(io_, ctypes.c_uint64),
            self._ptr(il, ctypes.c_uint32),
            self._ptr(fd, ctypes.c_int32), self._ptr(it, ctypes.c_int32),
            self._ptr(ft, ctypes.c_int32), len(id_names),
            self._u8(cb), self._ptr(co, ctypes.c_uint64),
            self._ptr(cl, ctypes.c_uint32), len(ctg_names),
            gt_id, end_id, n_samples, 1 if v44 else 0,
            self._u8(bails), n_lines, ctypes.byref(out_ptr))
        if r < 0:
            raise IOError(f"native VCF parse failed ({r})")
        try:
            return ctypes.string_at(out_ptr, r), bails
        finally:
            self._lib.htstpu_buf_free(out_ptr)

    @_counted
    def cram_decode_slice(self, comp_hdr: bytes, ref_seq_id: int,
                          ref_seq_start: int, ref_seq_span: int,
                          num_records: int, record_counter: int,
                          content_types, content_ids, payloads,
                          ref: Optional[bytes], ref_start: int,
                          ref_chrom_len: int, rg_names, decode_md: bool,
                          ) -> Optional[bytes]:
        """Decode one CRAM v3 slice natively.  Returns the u32-framed BAM
        record blob, or None when the native decoder bails (unsupported
        configuration) — never raises on unsupported input."""
        ch = np.frombuffer(comp_hdr, np.uint8)
        nblk = len(payloads)
        blk_buf = np.frombuffer(b"".join(payloads) + b"\0", np.uint8)
        blk_lens = np.array([len(x) for x in payloads] or [0], np.uint64)
        blk_offs = np.zeros(max(nblk, 1), np.uint64)
        if nblk > 1:
            np.cumsum(blk_lens[:-1], dtype=np.uint64, out=blk_offs[1:])
        ct = np.array(content_types or [0], np.int32)
        ci = np.array(content_ids or [0], np.int32)
        rnames = [(n.encode() if n is not None else b"") for n in rg_names]
        rg_buf = np.frombuffer(b"".join(rnames) + b"\0", np.uint8)
        rg_lens = np.array([len(x) for x in rnames] or [0], np.uint32)
        rg_offs = np.zeros(max(len(rnames), 1), np.uint64)
        if len(rnames) > 1:
            np.cumsum(rg_lens[:-1], dtype=np.uint64, out=rg_offs[1:])
        rg_valid = np.array([1 if n is not None else 0 for n in rg_names]
                            or [0], np.uint8)
        refarr = (np.frombuffer(ref, np.uint8) if ref
                  else np.zeros(1, np.uint8))
        out_ptr = ctypes.POINTER(ctypes.c_uint8)()
        r = self._lib.htstpu_cram_decode_slice(
            self._u8(ch), len(ch),
            ref_seq_id, ref_seq_start, ref_seq_span,
            num_records, record_counter,
            nblk, self._ptr(ct, ctypes.c_int32),
            self._ptr(ci, ctypes.c_int32),
            self._ptr(blk_offs, ctypes.c_uint64),
            self._ptr(blk_lens, ctypes.c_uint64), self._u8(blk_buf),
            self._u8(refarr), len(ref) if ref else 0, ref_start,
            ref_chrom_len,
            len(rg_names), self._u8(rg_buf),
            self._ptr(rg_offs, ctypes.c_uint64),
            self._ptr(rg_lens, ctypes.c_uint32), self._u8(rg_valid),
            1 if decode_md else 0, ctypes.byref(out_ptr))
        if r < 0:
            return None
        try:
            return ctypes.string_at(out_ptr, r)
        finally:
            self._lib.htstpu_buf_free(out_ptr)

    @_counted
    def rans4x8_uncompress(self, data: bytes, out_sz: int) -> bytes:
        """Decode one CRAM 3.0 rANS stream (incl. 9-byte header)."""
        buf = np.frombuffer(data, np.uint8)
        out = np.empty(max(out_sz, 1), np.uint8)
        r = self._lib.htstpu_rans4x8_uncompress(self._u8(buf), len(buf),
                                                self._u8(out), out_sz)
        if r < 0:
            raise ValueError("malformed rANS 4x8 stream")
        return out[:r].tobytes()

    @_counted
    def bam_fields(self, data: np.ndarray, offs: np.ndarray):
        """Planner columns for a u32-framed BAM stream: (tids, poss,
        ends, flags) with bam_endpos CIGAR spans (unmapped -> pos+1)."""
        data = np.ascontiguousarray(data)
        offs = np.ascontiguousarray(offs, np.int64)
        n = len(offs)
        tids = np.empty(n, np.int32)
        poss = np.empty(n, np.int32)
        ends = np.empty(n, np.int64)
        flags = np.empty(n, np.int32)
        r = self._lib.htstpu_bam_fields(
            self._u8(data), len(data), self._ptr(offs, ctypes.c_int64), n,
            self._ptr(tids, ctypes.c_int32), self._ptr(poss, ctypes.c_int32),
            self._ptr(ends, ctypes.c_int64), self._ptr(flags, ctypes.c_int32))
        if r < 0:
            raise IOError(f"bam_fields failed at record {-r - 1}")
        return tids, poss, ends, flags

    @_counted
    def gzip_compress(self, data: bytes, level: int = 6) -> bytes:
        """Plain gzip-container deflate via libdeflate (the CRAM GZIP
        block method, cram/cram_io.c:1604) — ~2-3x zlib."""
        buf = np.frombuffer(data, np.uint8) if not isinstance(
            data, np.ndarray) else data
        out_ptr = ctypes.POINTER(ctypes.c_uint8)()
        r = self._lib.htstpu_gzip_compress(self._u8(buf), len(buf), level,
                                           ctypes.byref(out_ptr))
        if r < 0:
            raise ValueError("gzip compress failed")
        try:
            return ctypes.string_at(out_ptr, r)
        finally:
            self._lib.htstpu_buf_free(out_ptr)

    @_counted
    def rans4x8_compress(self, data: bytes, order: int) -> bytes:
        buf = np.frombuffer(data, np.uint8)
        out_ptr = ctypes.POINTER(ctypes.c_uint8)()
        r = self._lib.htstpu_rans4x8_compress(self._u8(buf), len(buf), order,
                                              ctypes.byref(out_ptr))
        if r < 0:
            raise ValueError("rANS 4x8 encode failed")
        try:
            return ctypes.string_at(out_ptr, r)
        finally:
            self._lib.htstpu_buf_free(out_ptr)

    @_counted
    def cram_slice_to_sam(self, comp_hdr: bytes, ref_seq_id: int,
                          ref_seq_start: int, ref_seq_span: int,
                          num_records: int, record_counter: int,
                          content_types, content_ids, methods, raw_sizes,
                          payloads, ref: Optional[bytes], ref_start: int,
                          ref_chrom_len: int, rg_names, decode_md: bool,
                          ref_names) -> Optional[np.ndarray]:
        """Fused slice decode: block decompression (all CRAM 3.x block
        methods) + record decode + SAM formatting in one GIL-free call.
        Returns SAM text (uint8) or None when the native path bails."""
        import weakref
        ch = np.frombuffer(comp_hdr, np.uint8)
        nblk = len(payloads)
        blk_buf = np.frombuffer(b"".join(payloads) + b"\0", np.uint8)
        blk_lens = np.array([len(x) for x in payloads] or [0], np.uint64)
        blk_offs = np.zeros(max(nblk, 1), np.uint64)
        if nblk > 1:
            np.cumsum(blk_lens[:-1], dtype=np.uint64, out=blk_offs[1:])
        ct = np.array(list(content_types) or [0], np.int32)
        ci = np.array(list(content_ids) or [0], np.int32)
        mt = np.array(list(methods) or [0], np.int32)
        rs = np.array(list(raw_sizes) or [0], np.uint64)
        rg_b = b"".join((n or "").encode() for n in rg_names) + b"\0"
        rg_buf = np.frombuffer(rg_b, np.uint8)
        rg_lens = np.array([len((n or "").encode()) for n in rg_names]
                           or [0], np.uint32)
        rg_offs = np.zeros(max(len(rg_names), 1), np.uint64)
        if len(rg_names) > 1:
            np.cumsum(rg_lens[:-1], dtype=np.uint64, out=rg_offs[1:])
        rg_valid = np.array([1 if n else 0 for n in rg_names] or [0],
                            np.uint8)
        names = [n.encode() for n in ref_names]
        name_buf = np.frombuffer(b"".join(names) + b"\0", np.uint8)
        name_lens = np.array([len(n) for n in names] or [0], np.uint32)
        name_offs = np.zeros(max(len(names), 1), np.uint64)
        if len(names) > 1:
            np.cumsum(name_lens[:-1], dtype=np.uint64, out=name_offs[1:])
        if ref is None:
            ref_arr = np.zeros(1, np.uint8)
            ref_len = 0
        else:
            ref_arr = np.frombuffer(ref, np.uint8)
            ref_len = len(ref)
        out_ptr = ctypes.POINTER(ctypes.c_uint8)()
        r = self._lib.htstpu_cram_slice_to_sam(
            self._u8(ch), len(ch), ref_seq_id, ref_seq_start, ref_seq_span,
            num_records, record_counter, nblk,
            self._ptr(ct, ctypes.c_int32), self._ptr(ci, ctypes.c_int32),
            self._ptr(mt, ctypes.c_int32), self._ptr(rs, ctypes.c_uint64),
            self._ptr(blk_offs, ctypes.c_uint64),
            self._ptr(blk_lens, ctypes.c_uint64), self._u8(blk_buf),
            self._u8(ref_arr), ref_len, ref_start, ref_chrom_len,
            len(rg_names), self._u8(rg_buf),
            self._ptr(rg_offs, ctypes.c_uint64),
            self._ptr(rg_lens, ctypes.c_uint32), self._u8(rg_valid),
            1 if decode_md else 0,
            self._u8(name_buf), self._ptr(name_offs, ctypes.c_uint64),
            self._ptr(name_lens, ctypes.c_uint32), len(names),
            ctypes.byref(out_ptr))
        if r == -100:
            return None
        if r < 0:
            raise IOError(f"native CRAM slice decode failed ({r})")
        cbuf = ctypes.cast(out_ptr,
                           ctypes.POINTER(ctypes.c_uint8 * r)).contents
        weakref.finalize(cbuf, self._lib.htstpu_buf_free, out_ptr)
        return np.frombuffer(cbuf, np.uint8)

    @_counted
    def cram_encode_slice(self, blob: bytes, slice_ref: int,
                          slice_start: int, ref: Optional[bytes],
                          ref_start: int, use_ref: bool):
        """Native slice encoder (process_one_read hot loop).  Returns
        (n_records, nbases, end_pos, {cid: stream bytes}, td_lines,
        rec_tl uint32 array, qs_lens uint32 array) or None when the
        native path bails."""
        buf = blob if isinstance(blob, np.ndarray) \
            else np.frombuffer(blob, np.uint8)
        buf = np.ascontiguousarray(buf)
        if ref is None:
            ref_arr = np.zeros(1, np.uint8)
            ref_len = 0
        else:
            ref_arr = np.frombuffer(ref, np.uint8)
            ref_len = len(ref)
        out_ptr = ctypes.POINTER(ctypes.c_uint8)()
        r = self._lib.htstpu_cram_encode_slice(
            self._u8(buf), len(buf), slice_ref, slice_start,
            self._u8(ref_arr), ref_len, ref_start, 1 if use_ref else 0,
            ctypes.byref(out_ptr))
        if r == -100:
            return None
        if r < 0:
            raise IOError(f"native CRAM slice encode failed ({r})")
        try:
            raw = ctypes.string_at(out_ptr, r)
        finally:
            self._lib.htstpu_buf_free(out_ptr)
        mv = memoryview(raw)
        import struct as _st
        n, = _st.unpack_from("<I", mv, 0)
        nbases, end_pos = _st.unpack_from("<qq", mv, 4)
        n_streams, = _st.unpack_from("<I", mv, 20)
        p = 24
        table = []
        for _ in range(n_streams):
            cid, = _st.unpack_from("<i", mv, p)
            ln, = _st.unpack_from("<Q", mv, p + 4)
            table.append((cid, ln))
            p += 12
        n_td, = _st.unpack_from("<I", mv, p)
        td_len, = _st.unpack_from("<Q", mv, p + 4)
        p += 12
        td_blob = bytes(mv[p:p + td_len])
        p += td_len
        rec_tl = np.frombuffer(raw, np.uint32, n, p).copy()
        p += n * 4
        qs_lens = np.frombuffer(raw, np.uint32, n, p).copy()
        p += n * 4
        streams = {}
        for cid, ln in table:
            streams[cid] = bytes(mv[p:p + ln])
            p += ln
        td_lines = td_blob.split(b"\0")[:-1] if td_len else []
        if len(td_lines) != n_td:
            raise IOError("native CRAM encode: TD framing mismatch")
        return n, nbases, end_pos, streams, td_lines, rec_tl, qs_lens

    # ---- CRAM 3.1 codecs (htscodecs_shim, same wire as codecs/*.py) ----

    @_counted
    def rans4x16_compress(self, data: bytes, flags: int) -> bytes:
        n = ctypes.c_uint()
        ptr = self._lib.rans_compress_4x16(data, len(data),
                                           ctypes.byref(n), flags)
        if not ptr:
            raise ValueError("rANS Nx16 encode failed")
        try:
            return ctypes.string_at(ptr, n.value)
        finally:
            self._lib.htstpu_buf_free(ptr)

    @_counted
    def rans4x16_uncompress(self, data: bytes) -> bytes:
        n = ctypes.c_uint()
        ptr = self._lib.rans_uncompress_4x16(data, len(data),
                                             ctypes.byref(n))
        if not ptr:
            raise ValueError("malformed rANS Nx16 stream")
        try:
            return ctypes.string_at(ptr, n.value)
        finally:
            self._lib.htstpu_buf_free(ptr)

    @_counted
    def arith_compress(self, data: bytes, order: int) -> bytes:
        n = ctypes.c_uint()
        ptr = self._lib.arith_compress_to(data, len(data), None,
                                          ctypes.byref(n), order)
        if not ptr:
            raise ValueError("arith encode failed")
        try:
            return ctypes.string_at(ptr, n.value)
        finally:
            self._lib.htstpu_buf_free(ptr)

    @_counted
    def arith_uncompress(self, data: bytes) -> bytes:
        n = ctypes.c_uint()
        ptr = self._lib.arith_uncompress_to(data, len(data), None,
                                            ctypes.byref(n))
        if not ptr:
            raise ValueError("malformed arith stream")
        try:
            return ctypes.string_at(ptr, n.value)
        finally:
            self._lib.htstpu_buf_free(ptr)

    @_counted
    def fqz_compress(self, data: bytes, lens) -> bytes:
        class _Slice(ctypes.Structure):
            _fields_ = [("num_records", ctypes.c_int),
                        ("len", ctypes.POINTER(ctypes.c_uint32)),
                        ("flags", ctypes.POINTER(ctypes.c_uint32))]
        lens = list(lens) if lens is not None else [len(data)]
        arr = (ctypes.c_uint32 * max(len(lens), 1))(*lens)
        fl = (ctypes.c_uint32 * max(len(lens), 1))()
        sl = _Slice(len(lens), arr, fl)
        osz = ctypes.c_size_t()
        ptr = self._lib.fqz_compress(3, ctypes.byref(sl), data, len(data),
                                     ctypes.byref(osz), 0, None)
        if not ptr:
            raise ValueError("fqz encode failed")
        try:
            return ctypes.string_at(ptr, osz.value)
        finally:
            self._lib.htstpu_buf_free(ptr)

    @_counted
    def fqz_decompress(self, data: bytes) -> bytes:
        osz = ctypes.c_size_t()
        ptr = self._lib.fqz_decompress(data, len(data), ctypes.byref(osz),
                                       None, 0)
        if not ptr:
            raise ValueError("malformed fqz stream")
        try:
            return ctypes.string_at(ptr, osz.value)
        finally:
            self._lib.htstpu_buf_free(ptr)

    @_counted
    def tok3_encode(self, blk: bytes, use_arith: int = 0) -> bytes:
        n = ctypes.c_int()
        ptr = self._lib.tok3_encode_names(blk, len(blk), 7, use_arith,
                                          ctypes.byref(n), None)
        if not ptr:
            raise ValueError("tok3 encode failed")
        try:
            return ctypes.string_at(ptr, n.value)
        finally:
            self._lib.htstpu_buf_free(ptr)

    @_counted
    def tok3_decode(self, data: bytes) -> bytes:
        n = ctypes.c_uint32()
        ptr = self._lib.tok3_decode_names(data, len(data), ctypes.byref(n))
        if not ptr:
            raise ValueError("malformed tok3 stream")
        try:
            return ctypes.string_at(ptr, n.value)
        finally:
            self._lib.htstpu_buf_free(ptr)


native: Optional[_Native] = _Native()
