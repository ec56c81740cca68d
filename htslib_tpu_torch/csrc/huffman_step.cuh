// One canonical-Huffman resolve of the Huffman resolve chain (kernel B10,
// huffman_resolve.cu).  Host compilers see plain inline functions (the
// qualifiers are defined away), so a CPU harness can drive the exact
// arithmetic the card runs.
//
// Tables per chain (htslib_tpu_torch/ops/huffman.py build_tables), entry
// r of each at [r * stride]: limits[16] (the monotone MSB-justified end
// of each code length's codes, limits[15] = 2^15), firsts[16] and
// bases[16] (the first code and first symbol index of length r + 1) and
// order[320] (symbols in canonical order, zero past the alphabet).
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define HUFF_HD __host__ __device__ __forceinline__
#else
#define HUFF_HD static inline
#endif

#define HUFF_MAXBITS 15
#define HUFF_ROWS 16
#define HUFF_NSYM_PAD 320

// The symbol of the 15-bit window v (0 <= v < 2^15):
// l* = 1 + #{r : v >= limits[r]}, idx = bases[l*-1] + (v >> (15 - l*))
// - firsts[l*-1], sym = order[idx] for 0 <= idx < 320 and 0 otherwise (as
// the Pallas kernel's telescoping sum gives).  l* = 16 (a window past the
// last code of an incomplete code) shifts v out entirely, as XLA's
// logical shift by a negative amount does.
HUFF_HD uint32_t huff_resolve(uint32_t v, const int32_t* limits,
                              const int32_t* firsts, const int32_t* bases,
                              const int32_t* order, int stride) {
  int l = 1;
  for (int r = 0; r < HUFF_ROWS; ++r) l += (int32_t)v >= limits[r * stride];
  const uint32_t code = l <= HUFF_MAXBITS ? v >> (HUFF_MAXBITS - l) : 0u;
  const int32_t idx = (int32_t)((uint32_t)bases[(l - 1) * stride] + code -
                                (uint32_t)firsts[(l - 1) * stride]);
  return idx >= 0 && idx < HUFF_NSYM_PAD ? (uint32_t)order[idx * stride]
                                         : 0u;
}

// The chain's next window: the symbol mixed back into the window.
HUFF_HD uint32_t huff_next(uint32_t v, uint32_t sym) {
  return ((v * 5u + sym * 40503u) >> 7) & ((1u << HUFF_MAXBITS) - 1u);
}
