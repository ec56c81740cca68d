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

// The same resolve, lean: the 16 limits held by the caller (registers on
// the card), their compares summed as a tree, and one word a length,
// bmf[r * stride] = bases[r] - firsts[r] (mod 2^32), in place of two.
HUFF_HD uint32_t huff_resolve_lean(uint32_t v, const int32_t* lim,
                                   const int32_t* bmf, const int32_t* order,
                                   int stride) {
  int c[HUFF_ROWS];
  for (int r = 0; r < HUFF_ROWS; ++r) c[r] = (int32_t)v >= lim[r];
  for (int w = 1; w < HUFF_ROWS; w *= 2)
    for (int r = 0; r < HUFF_ROWS; r += 2 * w) c[r] += c[r + w];
  const int l = 1 + c[0];
  const uint32_t code = l <= HUFF_MAXBITS ? v >> (HUFF_MAXBITS - l) : 0u;
  const uint32_t idx = (uint32_t)bmf[(l - 1) * stride] + code;
  return idx < HUFF_NSYM_PAD ? (uint32_t)order[idx * stride] : 0u;
}

// The prefix table: entry p stands for the 2^(15 - kbits) windows whose
// top kbits bits are p.  It holds their symbol where the resolve gives
// one symbol for all of them, and `sent` where it does not (a length
// limit falls inside the range, or the code length exceeds kbits) or
// where the symbol is `sent` itself or does not fit the entry; a step
// that reads `sent` resolves its window with huff_resolve_lean, so the
// table gives the canonical resolve of every window by construction.
// With kbits = 15 it is the whole window table.
HUFF_HD uint32_t huff_prefix_entry(uint32_t p, int kbits,
                                   const int32_t* limits,
                                   const int32_t* firsts,
                                   const int32_t* bases,
                                   const int32_t* order, int stride,
                                   uint32_t sent) {
  const int32_t lo = (int32_t)(p << (HUFF_MAXBITS - kbits));
  const int32_t hi = lo + (1 << (HUFF_MAXBITS - kbits)) - 1;
  int l = 1;
  bool split = false;
  for (int r = 0; r < HUFF_ROWS; ++r) {
    const int32_t lim = limits[r * stride];
    l += lo >= lim;
    split |= lo < lim && lim <= hi;
  }
  if (split || (l > kbits && l <= HUFF_MAXBITS)) return sent;
  const uint32_t sym =
      huff_resolve((uint32_t)lo, limits, firsts, bases, order, stride);
  return sym < sent ? sym : sent;
}

// The byte offset of the prefix-table entry of window v = (x >> 7) &
// 0x7fff, taken from the unmasked mix x (huff_mix) with one shift and one
// mask: (v >> (15 - kbits)) << row_shift, where 2^row_shift bytes part a
// chain's consecutive entries (kbits + row_shift <= 22).
HUFF_HD uint32_t huff_prefix_offset(uint32_t x, int kbits, int row_shift) {
  return (x >> (22 - kbits - row_shift)) &
         (((1u << kbits) - 1u) << row_shift);
}

// The mix of window v and its symbol, before its shift and mask.
HUFF_HD uint32_t huff_mix(uint32_t v, uint32_t sym) {
  return v * 5u + sym * 40503u;
}

// The chain's next window: the symbol mixed back into the window.
HUFF_HD uint32_t huff_next(uint32_t v, uint32_t sym) {
  return (huff_mix(v, sym) >> 7) & ((1u << HUFF_MAXBITS) - 1u);
}
