/* The libdeflate calls of src/htstpu.cc on zlib, for a host that has
 * zlib's headers but not libdeflate's.  The native build puts this
 * directory on the include path only where <libdeflate.h> does not
 * compile and link (htslib_tpu_torch/native/__init__.py).
 *
 * Inflate gives libdeflate's bytes.  Deflate gives zlib's, at the same
 * level clamped to zlib's 0-9 (raw DEFLATE, window 15, memLevel 8, the
 * default strategy): the bytes of Python's zlib.compressobj(level,
 * DEFLATED, -15), which the port's pure route writes.  A compressor or
 * decompressor holds its z_stream, reset before each call. */
#ifndef HTSLIB_TPU_TORCH_COMPAT_LIBDEFLATE_H
#define HTSLIB_TPU_TORCH_COMPAT_LIBDEFLATE_H

#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <zlib.h>

enum libdeflate_result {
  LIBDEFLATE_SUCCESS = 0,
  LIBDEFLATE_BAD_DATA = 1,
  LIBDEFLATE_SHORT_OUTPUT = 2,
  LIBDEFLATE_INSUFFICIENT_SPACE = 3,
};

struct libdeflate_compressor {
  int level;
};

struct libdeflate_decompressor {
  z_stream zs[3];   /* raw, zlib and gzip wrappers */
  int ready[3];
};

static inline struct libdeflate_compressor*
libdeflate_alloc_compressor(int level) {
  struct libdeflate_compressor* c =
      (struct libdeflate_compressor*)malloc(sizeof *c);
  if (c) c->level = level < 0 ? 6 : (level > 9 ? 9 : level);
  return c;
}

static inline void
libdeflate_free_compressor(struct libdeflate_compressor* c) {
  free(c);
}

/* deflate `in` whole with window bits `wbits` into `out`: the
 * compressed size, or 0 where it does not fit in `avail` bytes.  The
 * calls are those of CPython's zlib module for compressobj().compress()
 * then flush(): deflate(Z_NO_FLUSH) over the whole input, then
 * deflate(Z_FINISH), each phase handed output room in steps of 32 KiB,
 * 64 KiB, 256 KiB, 1 MiB and on (its _BlocksOutputBuffer).  Stored
 * blocks (level 0) are cut where the room runs out, so the same steps
 * give the same bytes. */
static inline size_t compat_deflate(const struct libdeflate_compressor* c,
                                    int wbits, const void* in, size_t n,
                                    void* out, size_t avail) {
  static const size_t steps[] = {32 << 10, 64 << 10, 256 << 10, 1 << 20,
                                 4 << 20, 8 << 20, 16 << 20, 16 << 20,
                                 32 << 20, 32 << 20, 32 << 20, 32 << 20,
                                 64 << 20, 64 << 20, 128 << 20, 128 << 20,
                                 256 << 20};
  const int nsteps = (int)(sizeof steps / sizeof steps[0]);
  size_t cap = n + (n >> 12) + (n >> 14) + (n >> 25) + 4096;
  unsigned char* buf = (unsigned char*)malloc(cap);
  if (!buf) return 0;
  z_stream zs;
  memset(&zs, 0, sizeof zs);
  if (deflateInit2(&zs, c->level, Z_DEFLATED, wbits, 8,
                   Z_DEFAULT_STRATEGY) != Z_OK) {
    free(buf);
    return 0;
  }
  zs.next_in = (Bytef*)in;
  zs.avail_in = (uInt)n;
  size_t used = 0;
  int r = Z_OK;
  for (int phase = 0; phase < 2 && r != Z_STREAM_END; phase++) {
    int k = 0;
    do {
      size_t room = steps[k < nsteps - 1 ? k : nsteps - 1];
      k++;
      if (used + room > cap) {   /* the step is kept; the scratch grows */
        unsigned char* nb = (unsigned char*)realloc(buf, used + room);
        if (!nb) { deflateEnd(&zs); free(buf); return 0; }
        buf = nb;
        cap = used + room;
      }
      zs.next_out = buf + used;
      zs.avail_out = (uInt)room;
      r = deflate(&zs, phase == 0 ? Z_NO_FLUSH : Z_FINISH);
      used += room - zs.avail_out;
      if (r == Z_STREAM_ERROR) { deflateEnd(&zs); free(buf); return 0; }
    } while (zs.avail_out == 0);
  }
  deflateEnd(&zs);
  size_t got = (r == Z_STREAM_END && used <= avail) ? used : 0;
  if (got) memcpy(out, buf, got);
  free(buf);
  return got;
}

static inline size_t
libdeflate_deflate_compress(struct libdeflate_compressor* c, const void* in,
                            size_t n, void* out, size_t avail) {
  return compat_deflate(c, -15, in, n, out, avail);
}

static inline size_t
libdeflate_gzip_compress(struct libdeflate_compressor* c, const void* in,
                         size_t n, void* out, size_t avail) {
  return compat_deflate(c, 31, in, n, out, avail);
}

static inline size_t
libdeflate_gzip_compress_bound(struct libdeflate_compressor* c, size_t n) {
  (void)c;
  /* zlib's deflateBound for stored blocks, the worst case, plus the
   * gzip header and trailer */
  return n + (n >> 12) + (n >> 14) + (n >> 25) + 13 + 18 + 64;
}

static inline struct libdeflate_decompressor*
libdeflate_alloc_decompressor(void) {
  struct libdeflate_decompressor* d =
      (struct libdeflate_decompressor*)calloc(1, sizeof *d);
  return d;
}

static inline void
libdeflate_free_decompressor(struct libdeflate_decompressor* d) {
  if (!d) return;
  for (int i = 0; i < 3; i++)
    if (d->ready[i]) inflateEnd(&d->zs[i]);
  free(d);
}

/* inflate one whole stream of wrapper `k` (0 raw, 1 zlib, 2 gzip) into
 * `out`; as libdeflate, a NULL `actual` asks for exactly `avail` bytes */
static inline enum libdeflate_result
compat_inflate(struct libdeflate_decompressor* d, int k, const void* in,
               size_t n, void* out, size_t avail, size_t* actual) {
  static const int wbits[3] = {-15, 15, 31};
  z_stream* zs = &d->zs[k];
  if (!d->ready[k]) {
    memset(zs, 0, sizeof *zs);
    if (inflateInit2(zs, wbits[k]) != Z_OK) return LIBDEFLATE_BAD_DATA;
    d->ready[k] = 1;
  } else if (inflateReset(zs) != Z_OK) {
    return LIBDEFLATE_BAD_DATA;
  }
  zs->next_in = (Bytef*)in;
  zs->avail_in = (uInt)n;
  zs->next_out = (Bytef*)out;
  zs->avail_out = (uInt)avail;
  int r = inflate(zs, Z_FINISH);
  if (r != Z_STREAM_END)
    return (r == Z_BUF_ERROR && zs->avail_out == 0)
               ? LIBDEFLATE_INSUFFICIENT_SPACE : LIBDEFLATE_BAD_DATA;
  size_t got = zs->total_out;
  if (actual) {
    *actual = got;
  } else if (got != avail) {
    return LIBDEFLATE_SHORT_OUTPUT;
  }
  return LIBDEFLATE_SUCCESS;
}

static inline enum libdeflate_result
libdeflate_deflate_decompress(struct libdeflate_decompressor* d,
                              const void* in, size_t n, void* out,
                              size_t avail, size_t* actual) {
  return compat_inflate(d, 0, in, n, out, avail, actual);
}

static inline enum libdeflate_result
libdeflate_zlib_decompress(struct libdeflate_decompressor* d, const void* in,
                           size_t n, void* out, size_t avail,
                           size_t* actual) {
  return compat_inflate(d, 1, in, n, out, avail, actual);
}

static inline enum libdeflate_result
libdeflate_gzip_decompress(struct libdeflate_decompressor* d, const void* in,
                           size_t n, void* out, size_t avail,
                           size_t* actual) {
  return compat_inflate(d, 2, in, n, out, avail, actual);
}

static inline uint32_t libdeflate_crc32(uint32_t crc, const void* buf,
                                        size_t len) {
  return (uint32_t)crc32_z(crc, (const Bytef*)buf, len);
}

#endif
