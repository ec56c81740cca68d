// Per-state round step of rANS Nx16 order-0 32-way encode (CRAM 3.1,
// htscodecs rans_compress_O0_32x16), used by rans_nx16_enc.cu.  Host
// compilers see plain inline functions (the qualifiers are defined away),
// so a CPU harness can drive the exact arithmetic the card runs.
//
// Wire: symbol i of n is encoded by state i % 32, i running from n - 1
// down to 0, every state starting at 2^15.  Before a symbol of frequency
// f a state x >= f << 19 emits its low 16 bits and shifts them out (at
// most once, as x < 2^31); then x = ((x / f) << 12) + x % f + cum.  The
// stream stores the emitted words in reverse order of emission.
//
// Rounds: round t is each state's t-th symbol from its end; the symbols
// n-1-32t .. n-32-32t of the scalar order fall in round t, so within a
// round the states go r0, r0 - 1, ..., 0, 31, ..., r0 + 1 with
// r0 = (n - 1) % 32, and states above r0 hold one symbol fewer when
// n % 32 != 0.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define RANS_ENC_HD __host__ __device__ __forceinline__
#else
#define RANS_ENC_HD static inline
#endif

#define RANS_ENC_L (1u << 15)
#define RANS_ENC_TF_SHIFT 12
#define RANS_ENC_NWAY 32

// A symbol's frequency f (1..4096) and cumulative frequency (0..4095)
// packed in one word, so a step needs one table load.
RANS_ENC_HD uint32_t rans_enc_pack(uint32_t f, uint32_t cum) {
  return f | (cum << 16);
}

// Symbols that state j encodes in a stream of n.
RANS_ENC_HD int64_t rans_enc_count(int64_t n, int j) {
  return n > j ? (n - j + RANS_ENC_NWAY - 1) / RANS_ENC_NWAY : 0;
}

// Stream position of state j's t-th symbol from its end (t < count).
RANS_ENC_HD int64_t rans_enc_pos(int64_t count, int j, int64_t t) {
  return j + (int64_t)RANS_ENC_NWAY * (count - 1 - t);
}

// Encode one symbol (packed f, cum) into *x.  Returns 1 when x emitted
// a word first, with the word in *word.  f << 19 reaches 2^31 for
// f = 4096, so the compare is unsigned.
RANS_ENC_HD int rans_enc_put(uint32_t* x, uint32_t fc, uint32_t* word) {
  const uint32_t f = fc & 0xFFFFu;
  uint32_t v = *x;
  const int emit = v >= (f << 19);
  *word = v & 0xFFFFu;
  if (emit) v >>= 16;
  *x = ((v / f) << RANS_ENC_TF_SHIFT) + v % f + (fc >> 16);
  return emit;
}

// Mask of the states that come before state j in a round's order
// r0, r0 - 1, ..., 0, 31, ..., r0 + 1: an emitter's rank among the round's
// emitters is popc(emitters & rans_enc_before(j, r0)).
RANS_ENC_HD uint32_t rans_enc_before(int j, int r0) {
  const uint32_t above = ~((2u << j) - 1u);  // states j+1..31 (none: j=31)
  const uint32_t upto = (2u << r0) - 1u;     // states 0..r0
  return j <= r0 ? (above & upto) : (upto | above);
}
