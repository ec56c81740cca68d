// Per-state round step of rANS 4x8 decode (CRAM 3.0, htscodecs
// rANS_static.c), shared by the kernels in rans4x8.cu.  Host compilers see
// plain inline functions, so a CPU harness can drive the exact arithmetic
// the card runs.
//
// Wire: 4 interleaved states, 12-bit frequencies (a table may sum to less
// than 4096), byte renormalisation against 2^23.  Order 0 decodes symbol i
// with state i % 4.  Order 1 is the order-1 layout of
// rans_nx16_o1_step.cuh with nway = 4 (quarters of n / 4 symbols, the tail
// on state 3).  After each round the states renormalise in order 0..3 from
// one byte pointer: a state below 2^23 shifts in one byte, and one below
// 2^15 a second (from a state >= 2^23 a decode step leaves x >= 2^11, so
// two bytes always lift it back above 2^23).
#pragma once

#include "rans_nx16_o1_step.cuh"

#define RANS8_L (1u << 23)
#define RANS8_NWAY 4

// Bytes a state takes after its decode step: 0, 1 or 2.
RANS_HD int rans8_refill_count(uint32_t x) {
  return (x < RANS8_L ? 1 : 0) + (x < (1u << 15) ? 1 : 0);
}

// The state after taking `need` bytes, b1 first.
RANS_HD uint32_t rans8_refill(uint32_t x, int need, uint32_t b1,
                              uint32_t b2) {
  if (need >= 1) x = (x << 8) | b1;
  if (need == 2) x = (x << 8) | b2;
  return x;
}

// Byte `idx` of a payload of `n_bytes` bytes; 0 past its end.
RANS_HD uint32_t rans8_byte(const uint8_t* bytes, int64_t idx,
                            int64_t n_bytes) {
  return idx < n_bytes ? (uint32_t)bytes[idx] : 0u;
}

// Whether state j decodes in round r, and at which output position.
RANS_HD bool rans8_live(bool o1, int64_t n, int j, int64_t r, int64_t* pos) {
  if (o1) {
    *pos = (int64_t)j * (n / RANS8_NWAY) + r;
    return r < rans_o1_state_len(n, j, RANS8_NWAY);
  }
  *pos = r * RANS8_NWAY + j;
  return *pos < n;
}

// Rounds of a stream of n symbols: the longest state's length.
RANS_HD int64_t rans8_rounds(bool o1, int64_t n) {
  return o1 ? rans_o1_state_len(n, RANS8_NWAY - 1, RANS8_NWAY)
            : (n + RANS8_NWAY - 1) / RANS8_NWAY;
}
