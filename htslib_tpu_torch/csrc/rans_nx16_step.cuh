// Per-state round step of rANS Nx16 order-0 decode (CRAM 3.1,
// htscodecs rans_uncompress_O0_32x16), shared by the decode and the
// histogram kernel in rans_nx16_o0.cu (and by the order-1 and resolve
// kernels), with the order-0 kernels' payload ring and histogram counts.
// Host compilers see plain inline functions (the qualifiers are defined
// away), so a CPU harness can drive the exact arithmetic the card runs.
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

// The cursor after a round that consumed `used` words, clamped to `end`:
// rans_advance in 32 bits, for cursors of streams under 2^31 words.
RANS_HD uint32_t rans_advance32(uint32_t cur, uint32_t used, uint32_t end) {
  return cur + used < end ? cur + used : end;
}

// The order-0 decode kernels' slot table (rans_nx16_o0.cu): entry m
// packs, for the symbol s owning slot m, f[s] mod 4096 in bits 0-11, s in
// bits 12-19 and m - cum[s] in bits 20-31, so a step is one load, a mask
// and a multiply-add (rans_o0_fstep), the offset's shift beside the mask.
// f[s] mod 4096 is 0 only where s owns every slot: such a table leaves
// every state as it is (rans_o0_mono).  Slots past the sum hold 0; lane
// `lane` of `nlanes` fills what rans_o0_build_slots's lane fills.
RANS_HD void rans_o0_build_fslots(const uint16_t* f, uint32_t* slot,
                                  int lane, int nlanes) {
  uint32_t c = 0;
  for (int s = 0; s < 256; ++s) {
    const uint32_t fs = f[s];
    if (s % nlanes == lane)
      for (uint32_t k = c; k < c + fs && k < RANS_TOTFREQ; ++k)
        slot[k] = (fs & 0xFFFu) | ((uint32_t)s << 12) | ((k - c) << 20);
    c += fs;
  }
  for (uint32_t k = c; k < RANS_TOTFREQ; ++k)
    if (k % nlanes == (uint32_t)lane) slot[k] = 0;
}

// Whether a table of frequencies f gives one symbol every slot; lane
// `lane` of `nlanes` looks at the symbols s with s % nlanes == lane.
RANS_HD bool rans_o0_mono(const uint16_t* f, int lane, int nlanes) {
  bool mono = false;
  for (int s = lane; s < 256; s += nlanes) mono |= f[s] >= RANS_TOTFREQ;
  return mono;
}

// The state after decoding x from its slot entry e (a table that is not
// mono): f[s] * (x >> 12) + (x & 4095) - cum[s].
RANS_HD uint32_t rans_o0_fstep(uint32_t x, uint32_t e) {
  return (e & 0xFFFu) * (x >> RANS_TF_SHIFT) + (e >> 20);
}

// The symbol (or, after rans_o0_bin_fslots, the bin) of slot entry e.
RANS_HD uint32_t rans_o0_fsym(uint32_t e) { return (e >> 12) & 0xFFu; }

// B3's slot table: bits 12-19 of every slot hold its symbol's histogram
// bin instead of the symbol, so a round counts without a clip.  Lane
// `lane` of `nlanes` rewrites the slots k with k % nlanes == lane, after
// the whole table is built.
RANS_HD void rans_o0_bin_fslots(uint32_t* slot, int off, int qbins,
                                int lane, int nlanes) {
  for (int k = lane; k < RANS_TOTFREQ; k += nlanes)
    slot[k] = (slot[k] & 0xFFF00FFFu) |
              ((uint32_t)rans_hist_bin(rans_o0_fsym(slot[k]), off, qbins)
               << 12);
}

// The order-0 kernels' payload ring: word i of a stream (counted from
// the 4-byte boundary at or below its first word) sits at
// ring[i % RANS_RING_WORDS] once chunk i / RANS_RING_CHUNK has been
// copied in, and the chunk at the ring's start is copied again into
// RANS_RING_MIRROR slots past its end, so the words at a cursor plus a
// state's rank (< 32) lie in a row and need no wrap.  Rounds run in
// blocks of RANS_BLOCK_ROUNDS; a block that starts at cursor c reads
// words below c + RANS_BLOCK_WORDS (32 words a round at most).
#define RANS_RING_WORDS 2048u
#define RANS_RING_MIRROR 32u
#define RANS_RING_CHUNK 64u
#define RANS_BLOCK_ROUNDS 32u
#define RANS_BLOCK_WORDS (RANS_BLOCK_ROUNDS * RANS_NWAY)

// Byte offset in the ring of the word at cursor `cur`.
RANS_HD uint32_t rans_ring_off(uint32_t cur) {
  return (2u * cur) & (2u * RANS_RING_WORDS - 2u);
}

// The word `rank` (< 32) past the cursor whose ring offset is `off`.
RANS_HD uint32_t rans_ring_word(const uint16_t* ring, uint32_t off,
                                uint32_t rank) {
  return *reinterpret_cast<const uint16_t*>(
      reinterpret_cast<const char*>(ring) + off + 2u * rank);
}

// Chunks that hold every word a cursor clamped to `end` can read (up to
// end + 31), the words past `end` zero-filled.
RANS_HD uint32_t rans_ring_cap(uint32_t end) {
  return (end + RANS_NWAY + RANS_RING_CHUNK - 1u) / RANS_RING_CHUNK;
}

// Chunks that may have been copied in while the cursor is at `cur`: a
// chunk's slots must hold only words below cur, which no round reads
// again; none past the cap.
RANS_HD uint32_t rans_ring_limit(uint32_t cur, uint32_t cap) {
  const uint32_t l = cur / RANS_RING_CHUNK + RANS_RING_WORDS / RANS_RING_CHUNK;
  return l < cap ? l : cap;
}

// Whether chunks 0 .. front - 1 hold every word a block of rounds from
// cursor `cur` can read.
RANS_HD bool rans_ring_ready(uint32_t front, uint32_t cur, uint32_t cap) {
  const uint32_t need =
      (cur + RANS_BLOCK_WORDS + RANS_RING_CHUNK - 1u) / RANS_RING_CHUNK;
  return front >= (need < cap ? need : cap);
}

// B3's counts: lane l counts bins 2k and 2k + 1 in the two 16-bit halves
// of word k * 32 + l, so each lane owns one bank whatever its bins, and a
// round counts with a plain load, add and store.  A half takes at most one
// count a round; rans_fold_counts moves the counts into 32-bit totals
// before 65,536 rounds have passed.
RANS_HD void rans_count(uint32_t* cnt, uint32_t bin, int lane) {
  cnt[(bin >> 1) * RANS_NWAY + (uint32_t)lane] += 1u << ((bin & 1u) * 16u);
}

// Add every lane's counts to tot[0 .. qbins - 1] and zero them.  Lane
// `lane` of `nlanes` folds the word rows k with k % nlanes == lane; with
// 32 lanes the row's columns are read rotated by k, so the lanes' loads
// fall in 32 banks.
RANS_HD void rans_fold_counts(uint32_t* cnt, uint32_t* tot, int qbins,
                              int lane, int nlanes) {
  for (int k = lane; k < (qbins + 1) / 2; k += nlanes) {
    uint32_t lo = 0, hi = 0;
    for (int i = 0; i < RANS_NWAY; ++i) {
      uint32_t* c = cnt + k * RANS_NWAY + ((i + k) & (RANS_NWAY - 1));
      lo += *c & 0xFFFFu;
      hi += *c >> 16;
      *c = 0;
    }
    tot[2 * k] += lo;
    if (2 * k + 1 < qbins) tot[2 * k + 1] += hi;
  }
}
