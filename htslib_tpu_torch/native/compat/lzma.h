/* The one liblzma call of src/htstpu.cc, for a host that has liblzma's
 * shared library (liblzma.so.5) but not its headers or link name.  The
 * native build puts this directory on the include path only where
 * <lzma.h> does not compile and link (htslib_tpu_torch/native/
 * __init__.py).  The function is looked up with dlopen at its first
 * call, as src/htstpu.cc looks up libbz2; where the library is missing,
 * the call fails and the block is reported corrupt.  C++ only. */
#ifndef HTSLIB_TPU_TORCH_COMPAT_LZMA_H
#define HTSLIB_TPU_TORCH_COMPAT_LZMA_H

#include <dlfcn.h>
#include <stddef.h>
#include <stdint.h>

typedef enum { LZMA_OK = 0, LZMA_PROG_ERROR = 11 } lzma_ret;
typedef struct lzma_allocator lzma_allocator;

typedef lzma_ret (*compat_lzma_sbd_fn)(uint64_t*, uint32_t,
                                       const lzma_allocator*,
                                       const uint8_t*, size_t*, size_t,
                                       uint8_t*, size_t*, size_t);

static inline lzma_ret lzma_stream_buffer_decode(
    uint64_t* memlimit, uint32_t flags, const lzma_allocator* allocator,
    const uint8_t* in, size_t* in_pos, size_t in_size, uint8_t* out,
    size_t* out_pos, size_t out_size) {
  // looked up once, by the first caller (a thread-safe static)
  static const compat_lzma_sbd_fn fn = [] {
    void* h = dlopen("liblzma.so.5", RTLD_NOW);
    return h ? (compat_lzma_sbd_fn)dlsym(h, "lzma_stream_buffer_decode")
             : (compat_lzma_sbd_fn)nullptr;
  }();
  if (!fn) return LZMA_PROG_ERROR;
  return fn(memlimit, flags, allocator, in, in_pos, in_size, out, out_pos,
            out_size);
}

#endif
