// The step of the BAM record-boundary chain (kernel X5, record_scan.cu),
// shared with the g++ harness of tests/test_torch_bam2sam.py.  Host
// compilers see plain inline functions.
//
// The chain is the JAX package's device_record_scan (ops/bam2sam.py:34),
// a loop over max_records steps in int32: step k is ok while
// pos + 4 <= U; it then records offs[k] = pos and sizes[k] = the int32
// read little-endian at clip(pos, 0, U - 4), and moves pos to
// pos + 4 + size.  A step that is not ok records (-1, 0) and leaves pos
// where it is, so every later step is not ok either: the count n is the
// steps before the first that is not.  Sums wrap as int32 sums do, so a
// length with bit 31 set moves pos back (even below 0, where the read is
// clipped to 0), and a record that overruns U still counts.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define RSCAN_HD __host__ __device__ __forceinline__
#else
#define RSCAN_HD static inline
#endif

// a + b as int32 sums wrap
RSCAN_HD int32_t rscan_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

// Whether the step at pos is ok in a payload of U bytes.
RSCAN_HD bool rscan_ok(int32_t pos, int32_t u) {
  return rscan_add(pos, 4) <= u;
}

// Where the step at pos reads its length: clip(pos, 0, U - 4).
RSCAN_HD int32_t rscan_at(int32_t pos, int32_t u) {
  const int32_t p = pos < 0 ? 0 : pos;
  return p > u - 4 ? u - 4 : p;
}

// The little-endian int32 at byte `off` of `w`.
RSCAN_HD int32_t rscan_len(const uint8_t* w, int64_t off) {
  return (int32_t)((uint32_t)w[off] | ((uint32_t)w[off + 1] << 8) |
                   ((uint32_t)w[off + 2] << 16) |
                   ((uint32_t)w[off + 3] << 24));
}

// The chain's steps from step *k at *pos while the length they read lies
// in the window w = payload bytes [wbase, wbase + wlen): each records
// offs/sizes[*k] and advances *k and *pos.  Stops before a step whose
// length lies outside the window (returns false), or at the first step that
// is not ok or at max_records (returns true: the chain is done).
RSCAN_HD bool rscan_walk(const uint8_t* w, int64_t wbase, int64_t wlen,
                         int32_t u, int32_t* pos, int32_t* k,
                         int32_t max_records, int32_t* offs,
                         int32_t* sizes) {
  int32_t p = *pos, kk = *k;
  bool done = false;
  for (;;) {
    if (kk >= max_records || !rscan_ok(p, u)) {
      done = true;
      break;
    }
    const int64_t at = rscan_at(p, u);
    if (at < wbase || at + 4 > wbase + wlen) break;
    const int32_t bsz = rscan_len(w, at - wbase);
    offs[kk] = p;
    sizes[kk] = bsz;
    p = rscan_add(rscan_add(p, 4), bsz);
    ++kk;
  }
  *pos = p;
  *k = kk;
  return done;
}
