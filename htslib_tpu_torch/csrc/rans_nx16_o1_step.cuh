// Per-state round step of rANS order-1 decode, shared by the Nx16 order-1
// kernels (rans_nx16_o1.cu, CRAM 3.1, htscodecs rans_uncompress_O1_32x16)
// and the 4x8 order-1 histogram kernel (rans4x8.cu, CRAM 3.0).  Host
// compilers see plain inline functions, so a CPU harness can drive the
// exact arithmetic the card runs.
//
// Order-1 wire (Nx16 with nway = 32, 4x8 with nway = 4): the stream splits
// into nway contiguous segments of seg = n / nway symbols, state j owning
// positions j*seg + r; the last state also carries the n - nway*seg tail,
// so its length is n - (nway-1)*seg.  Each state's context is its previous
// symbol, 0 at its segment head; refills interleave in state order.
//
// The table.  A full [ctx, 4096] slot table is 4 MiB per stream, far past
// shared memory.  Instead each stream's present (ctx, sym) pairs are rows
// packed like the order-0 slot entries, (f-1) | cum<<12 | sym<<24, sorted
// by (ctx, cum): at most RANS_O1_MAX_ROWS of them (the JAX package's
// stacked-table budget, which also routes denser tables to the host).
// ctx_start[c] .. ctx_start[c+1] are context c's rows, and bucket[c][k]
// is the offset, from ctx_start[c], of the row owning slot k*64 (a context
// has at most 256 rows, so a byte holds it).  A lookup loads the bucket's
// row and steps forward past rows that start at or below the slot: one
// step when the symbols are wider than 64 slots, a few otherwise.
// 16 KB of rows + 16 KB of buckets + 0.5 KB of starts per stream.
#pragma once

#include "rans_nx16_step.cuh"

#define RANS_O1_MAX_ROWS 4096
#define RANS_O1_BUCKET_SHIFT 6
#define RANS_O1_BUCKETS (RANS_TOTFREQ >> RANS_O1_BUCKET_SHIFT)

RANS_HD uint32_t rans_row_cum(uint32_t e) { return (e >> 12) & 0xFFFu; }

// Symbols decoded by state j of an order-1 stream of n symbols.
RANS_HD int64_t rans_o1_state_len(int64_t n, int j, int nway) {
  const int64_t seg = n / nway;
  return j < nway - 1 ? seg : n - (int64_t)(nway - 1) * seg;
}

// Bucket table from the rows and context starts.  Lane `lane` of `nlanes`
// fills the contexts c with c % nlanes == lane, walking each context's
// rows once.  A context with no rows gets offset 0 (no valid stream
// reaches it; the lookup then stays inside the row buffer).
RANS_HD void rans_o1_build_buckets(const uint32_t* rows,
                                   const uint16_t* ctx_start,
                                   uint8_t* bucket, int lane, int nlanes) {
  for (int c = lane; c < 256; c += nlanes) {
    const int lo = ctx_start[c], hi = ctx_start[c + 1];
    int r = lo;
    for (int k = 0; k < RANS_O1_BUCKETS; ++k) {
      const uint32_t slot = (uint32_t)k << RANS_O1_BUCKET_SHIFT;
      while (r + 1 < hi && rans_row_cum(rows[r + 1]) <= slot) ++r;
      bucket[c * RANS_O1_BUCKETS + k] = (uint8_t)(r - lo);
    }
  }
}

// The row of context ctx (< 256) owning slot m: the last of its rows
// whose cum is <= m.  Slots past a context's sum resolve to its last row.
RANS_HD uint32_t rans_o1_lookup(const uint32_t* rows,
                                const uint16_t* ctx_start,
                                const uint8_t* bucket, uint32_t ctx,
                                uint32_t m) {
  int r = ctx_start[ctx] +
          bucket[ctx * RANS_O1_BUCKETS + (m >> RANS_O1_BUCKET_SHIFT)];
  const int hi = ctx_start[ctx + 1];
  while (r + 1 < hi && rans_row_cum(rows[r + 1]) <= m) ++r;
  return rows[r];
}

// Resolve slot x & 4095 in context ctx and advance the state:
// x = f * (x >> 12) + (x & 4095) - cum.  Returns the symbol, which is the
// state's next context.
RANS_HD uint32_t rans_o1_decode(uint32_t* x, uint32_t ctx,
                                const uint32_t* rows,
                                const uint16_t* ctx_start,
                                const uint8_t* bucket) {
  const uint32_t m = *x & (RANS_TOTFREQ - 1);
  const uint32_t e = rans_o1_lookup(rows, ctx_start, bucket, ctx, m);
  *x = ((e & 0xFFFu) + 1u) * (*x >> RANS_TF_SHIFT) + m - rans_row_cum(e);
  return e >> 24;
}
