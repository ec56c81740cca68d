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
//
// The step divides by a reciprocal (RansEncSym, htscodecs' RansEncSymbol
// and the JAX kernel's _enc_tables): with s = ceil(log2 f), rcp =
// ceil(2^(s+31) / f) and q = mulhi32(x, rcp) >> (s - 1), q = x / f for
// every x < 2^31, and the new state is x + cum + q * (4096 - f).  For
// f = 1, rcp = 2^32 - 1 and shift 0 give q = x - 1 (x >= 1), which the
// bias cum + 4095 makes up for.  The division form (rans_enc_put_div) is
// kept beside it as the yardstick of the CPU harness.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define RANS_ENC_HD __host__ __device__ __forceinline__
#else
#define RANS_ENC_HD static inline
#endif

#define RANS_ENC_L (1u << 15)
#define RANS_ENC_TF_SHIFT 12
#define RANS_ENC_TOTFREQ (1u << RANS_ENC_TF_SHIFT)
#define RANS_ENC_NWAY 32

// One symbol's encode entry, read by one 16-byte shared load.  cs holds
// the shift in bits 0-4 (read through a funnel shift, which masks the
// amount to 5 bits, so it needs no extract) and 4096 - f from bit 16.
struct alignas(16) RansEncSym {
  uint32_t rcp;    // ceil(2^(s+31) / f); 2^32 - 1 for f = 1
  uint32_t x_max;  // f << 19: a state at or above it emits first
  uint32_t bias;   // cum, or cum + 4095 for f = 1
  uint32_t cs;     // s - 1 (0 for f = 1) | (4096 - f) << 16
};

// The entry of a symbol of frequency f (0..4096; 0 for a symbol the
// stream lacks, whose entry is never read) and cumulative frequency cum.
RANS_ENC_HD RansEncSym rans_enc_sym(uint32_t f, uint32_t cum) {
  RansEncSym e;
  e.x_max = f << 19;
  if (f < 2) {
    e.rcp = 0xFFFFFFFFu;
    e.bias = cum + RANS_ENC_TOTFREQ - 1;
    e.cs = (RANS_ENC_TOTFREQ - f) << 16;
  } else {
    uint32_t s = 0;
    while (f > (1u << s)) ++s;
    e.rcp = (uint32_t)(((1ull << (s + 31)) + f - 1) / f);
    e.bias = cum;
    e.cs = (s - 1) | (RANS_ENC_TOTFREQ - f) << 16;
  }
  return e;
}

RANS_ENC_HD uint32_t rans_enc_mulhi(uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  return __umulhi(a, b);
#else
  return (uint32_t)(((uint64_t)a * b) >> 32);
#endif
}

// q >> (cs & 31)
RANS_ENC_HD uint32_t rans_enc_shr(uint32_t q, uint32_t cs) {
#if defined(__CUDA_ARCH__)
  return __funnelshift_r(q, 0u, cs);
#else
  return q >> (cs & 31u);
#endif
}

// x / f for x < 2^31 (for f = 1: x - 1, x >= 1), as the step computes it.
RANS_ENC_HD uint32_t rans_enc_quot(uint32_t x, const RansEncSym& e) {
  return rans_enc_shr(rans_enc_mulhi(x, e.rcp), e.cs);
}

// Symbols that state j encodes in a stream of n.
RANS_ENC_HD uint32_t rans_enc_count(uint32_t n, int j) {
  return n > (uint32_t)j ? (n - j + RANS_ENC_NWAY - 1) / RANS_ENC_NWAY : 0u;
}

// Stream position of state j's t-th symbol from its end (t < count).
RANS_ENC_HD uint32_t rans_enc_pos(uint32_t count, int j, uint32_t t) {
  return j + RANS_ENC_NWAY * (count - 1 - t);
}

// Encode one symbol into *x.  Returns 1 when x emitted a word first,
// with the state before the step in *word (its low 16 bits are the
// word).  f << 19 reaches 2^31 for f = 4096, so the compare is unsigned.
// The chain: compare, select of the shifted state, mulhi, shift,
// multiply-add (the add of the bias runs beside the mulhi).
RANS_ENC_HD int rans_enc_put(uint32_t* x, const RansEncSym& e,
                             uint32_t* word) {
  uint32_t v = *x;
  const int emit = v >= e.x_max;
  *word = v;
  if (emit) v >>= 16;
  *x = v + e.bias + rans_enc_quot(v, e) * (e.cs >> 16);
  return emit;
}

// The same step by exact division: the form the reciprocal replaces,
// kept as the CPU harness's yardstick.
RANS_ENC_HD int rans_enc_put_div(uint32_t* x, uint32_t f, uint32_t cum,
                                 uint32_t* word) {
  uint32_t v = *x;
  const int emit = v >= (f << 19);
  *word = v;
  if (emit) v >>= 16;
  *x = ((v / f) << RANS_ENC_TF_SHIFT) + v % f + cum;
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
