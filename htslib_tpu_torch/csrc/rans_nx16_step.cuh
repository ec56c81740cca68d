// Per-state round step of rANS Nx16 order-0 decode (CRAM 3.1,
// htscodecs rans_uncompress_O0_32x16), shared by the decode and the
// histogram kernel in rans_nx16_o0.cu.  Host compilers see plain inline
// functions (the qualifiers are defined away), so a CPU harness can drive
// the exact arithmetic the card runs.
//
// Wire: 32 interleaved states, symbol i decoded by state i % 32; after each
// decode a state below 2^15 shifts in the next little-endian 16-bit word of
// the stream, the states of one round refilling in state order.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define RANS_HD __host__ __device__ __forceinline__
#else
#define RANS_HD static inline
#endif

#define RANS_TF_SHIFT 12
#define RANS_TOTFREQ 4096
#define RANS16_L (1u << 15)
#define RANS_NWAY 32

// Slot table of one stream from its 256 frequencies f (which sum to at
// most 4096): entry m packs, for the symbol s owning slot m, (f[s] - 1) in
// bits 0-11, m - cum[s] (the slot's offset within s) in bits 12-23 and s
// in bits 24-31, so a decode step needs one table load.  Slots past the
// sum (a rANS 4x8 table may sum to less than 4096; no valid stream reaches
// them) hold 0.  Lane `lane` of `nlanes` fills the symbols s with
// s % nlanes == lane and the spare slots k with k % nlanes == lane; each
// lane sums cum itself, so the lanes need no scan between them.
RANS_HD void rans_o0_build_slots(const uint16_t* f, uint32_t* slot, int lane,
                                 int nlanes) {
  uint32_t c = 0;
  for (int s = 0; s < 256; ++s) {
    const uint32_t fs = f[s];
    if (s % nlanes == lane)
      for (uint32_t k = c; k < c + fs && k < RANS_TOTFREQ; ++k)
        slot[k] = (fs - 1) | ((k - c) << 12) | ((uint32_t)s << 24);
    c += fs;
  }
  for (uint32_t k = c; k < RANS_TOTFREQ; ++k)
    if (k % nlanes == (uint32_t)lane) slot[k] = 0;
}

// Resolve slot x & 4095 to its symbol s and advance the state:
// x = f[s] * (x >> 12) + (x & 4095) - cum[s].  Returns the symbol.
RANS_HD uint32_t rans_o0_decode(uint32_t* x, const uint32_t* slot) {
  const uint32_t e = slot[*x & (RANS_TOTFREQ - 1)];
  *x = ((e & 0xFFFu) + 1u) * (*x >> RANS_TF_SHIFT) + ((e >> 12) & 0xFFFu);
  return e >> 24;
}

RANS_HD bool rans_needs_refill(uint32_t x) { return x < RANS16_L; }

// Word `idx` of a stream holding `n_words` words; 0 past its end, so a
// corrupt header can never read beyond the stream's payload.
RANS_HD uint32_t rans_word(const uint16_t* words, int64_t idx,
                           int64_t n_words) {
  return idx < n_words ? (uint32_t)words[idx] : 0u;
}

RANS_HD uint32_t rans_refill(uint32_t x, uint32_t word) {
  return (x << 16) | word;
}

// The cursor after a round that consumed `used` words, clamped to the end.
RANS_HD int64_t rans_advance(int64_t cur, int used, int64_t n_words) {
  return cur + used < n_words ? cur + used : n_words;
}

// Histogram bin of a symbol: clip(sym - off, 0, qbins - 1).
RANS_HD int rans_hist_bin(uint32_t sym, int off, int qbins) {
  const int q = (int)sym - off;
  return q < 0 ? 0 : (q > qbins - 1 ? qbins - 1 : q);
}
