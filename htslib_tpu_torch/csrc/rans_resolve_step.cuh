// Step of the rANS resolve chain (kernel B4, rans_resolve_bench.cu): the
// chain x = f[s] * (x >> 12) + (x & 4095) - cum[s] for the symbol s owning
// slot x & 4095, then x = (x << 16) | 1 where x < 2^15.  Host compilers
// see plain inline functions, so a CPU harness runs the loop the card runs.
//
// The table is two u16 columns of 4096 slots: tab[m] = 2 f[s] and
// tab[4096 + m] = 2 (m - cum[s]).  The chain runs on Y = 2y, y the state
// before its renormalisation, which fits 32 bits while y < 2^31: a decode
// step never raises a state (f * (x >> 12) + (m - cum) <= 4096 (x >> 12)
// + m = x) and a renormalised one is below 2^31.  Doubling makes the slot's
// byte offset in a u16 column Y & 0x1FFE, one logic op, and the entry's
// doubled f and offset give the doubled next state from one multiply-add.
// The renormalisation is taken off the chain: x = y * 65536 + 1 always
// lands in slot 1, whose entry sits in registers, so the load reads slot
// y & 4095 whatever y is; the renormalised state's step (slot 1's entry,
// x >> 12 = y << 4) is computed beside the load, and a multiply-add
// predicated on y >= 2^15 overwrites it with the loaded entry's.  The
// chain's step: logic op, shared load, predicated multiply-add.
#pragma once

#include "rans_nx16_step.cuh"

#define RANS_RESOLVE_TOP 0x80000000u

// Lane `lane` of `nlanes` fills the slots of the symbols s with
// s % nlanes == lane, and the spare slots k with k % nlanes == lane (no
// table the wrapper takes has any: its frequencies sum to 4096).
RANS_HD void rans_resolve_build(const uint16_t* f, uint16_t* tab, int lane,
                                int nlanes) {
  uint32_t c = 0;
  for (int s = 0; s < 256; ++s) {
    const uint32_t fs = f[s];
    if (s % nlanes == lane)
      for (uint32_t k = c; k < c + fs && k < RANS_TOTFREQ; ++k) {
        tab[k] = (uint16_t)(2u * fs);
        tab[RANS_TOTFREQ + k] = (uint16_t)(2u * (k - c));
      }
    c += fs;
  }
  for (uint32_t k = c; k < RANS_TOTFREQ; ++k)
    if (k % nlanes == (uint32_t)lane) tab[k] = tab[RANS_TOTFREQ + k] = 0;
}

// One step of the chain on any 32-bit state x, renormalisation included.
RANS_HD uint32_t rans_resolve_canon(uint32_t x, const uint16_t* tab) {
  const uint32_t m = x & (RANS_TOTFREQ - 1);
  const uint32_t y =
      (tab[m] >> 1) * (x >> RANS_TF_SHIFT) + (tab[RANS_TOTFREQ + m] >> 1);
  return y < RANS16_L ? (y << 16) | 1u : y;
}

// One step on Y = 2y (y < 2^31, before its renormalisation); f1, o1 are
// slot 1's entries.  Returns the next step's Y.  On the card the choice is
// a predicated multiply-add (inline PTX: a select after the load, as the
// compiler writes it from C, costs one more instruction on the chain).
RANS_HD uint32_t rans_resolve_step(uint32_t Y, const uint16_t* tab,
                                   uint32_t f1, uint32_t o1) {
  const char* at = reinterpret_cast<const char*>(tab) + (Y & 0x1FFEu);
  const uint32_t f = *reinterpret_cast<const uint16_t*>(at);
  const uint32_t o =
      *reinterpret_cast<const uint16_t*>(at + 2 * RANS_TOTFREQ);
  uint32_t next = f1 * (Y << 3) + o1;
#if defined(__CUDA_ARCH__)
  asm("{\n .reg .pred p;\n setp.ge.u32 p, %1, 65536;\n"
      " @p mad.lo.u32 %0, %2, %3, %4;\n}"
      : "+r"(next)
      : "r"(Y), "r"(f), "r"(Y >> 13), "r"(o));
#else
  if (Y >= 2u * RANS16_L) next = f * (Y >> 13) + o;
#endif
  return next;
}

// The state Y (= 2y) stands for: y renormalised.
RANS_HD uint32_t rans_resolve_unfold(uint32_t Y) {
  const uint32_t y = Y >> 1;
  return y < RANS16_L ? (y << 16) | 1u : y;
}

// `rounds` steps of the chain from x.  Steps run canonically while the
// state is outside [2^15, 2^31) (a start below 2^15, or one whose table
// keeps it at 2^31 or above), then in the doubled form, `kUnroll` steps a
// loop step on a 32-bit count.
template <int kUnroll>
RANS_HD uint32_t rans_resolve_chain(uint32_t x, const uint16_t* tab,
                                    int64_t rounds) {
  for (; rounds > 0 && (x < RANS16_L || x >= RANS_RESOLVE_TOP); --rounds)
    x = rans_resolve_canon(x, tab);
  if (rounds <= 0) return x;
  const uint32_t f1 = tab[1], o1 = tab[RANS_TOTFREQ + 1];
  uint32_t Y = 2u * x;
  while (rounds > 0) {
    const uint32_t n =
        rounds < (1 << 30) ? (uint32_t)rounds : (uint32_t)(1 << 30);
    rounds -= n;
    uint32_t i = 0;
    for (; i + kUnroll <= n; i += kUnroll)
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) Y = rans_resolve_step(Y, tab, f1, o1);
    for (; i < n; ++i) Y = rans_resolve_step(Y, tab, f1, o1);
  }
  return rans_resolve_unfold(Y);
}
