// Round step of rANS 4x8 decode (CRAM 3.0, htscodecs rANS_static.c), shared
// by the kernels in rans4x8.cu.  Host compilers see plain inline functions,
// so a CPU harness can drive the exact arithmetic the card runs.
//
// Wire: 4 interleaved states, 12-bit frequencies (a table may sum to less
// than 4096), byte renormalisation against 2^23.  Order 0 decodes symbol i
// with state i % 4.  Order 1 is the order-1 layout of
// rans_nx16_o1_step.cuh with nway = 4 (quarters of n / 4 symbols, the tail
// on state 3).  After each round the states renormalise in order 0..3 from
// one byte pointer: a state below 2^23 shifts in one byte, and one below
// 2^15 a second (from a state >= 2^23 a decode step leaves x >= 2^11, so
// two bytes always lift it back above 2^23).
//
// The 4-way rANS Nx16 wire (CRAM 3.1 without the X32 flag) has the same
// four states, layouts and tables and differs only in its refill: a state
// below 2^15 shifts in one little-endian 16-bit word (`rans16_refill_bits`,
// `rans8_swap16`).  `rans8_round` takes the refill as a template argument,
// so the 4x8 rounds compile as they did without it.
//
// One thread runs a whole round (`rans8_round`): the four states, their
// contexts and the payload bytes at the cursor all sit in its registers.
// A round takes at most 8 bytes, so the bytes come from a 64-bit window of
// the payload at the cursor, held big-endian (`rans8_window`, from three
// byte-swapped payload words); state j's bytes start at a prefix sum of the
// bits the states before it take, and a funnel shift moves them into the
// state.  `Rans8Window` holds the three words at the cursor, read at the
// end of the round before the one that needs them.
//
// On the card a round is bound by its instruction count: one warp issues
// it, every lane the same, at about two SM cycles an instruction on an
// H100 (an order-0 round is 76 instructions).  A batch larger than the
// card's SMs is bound by how many streams share an SM, that is by the
// shared memory a stream's tables take.  So the tables are the packed
// 32-bit words of the Nx16 step headers (order 0: 16 KB; order 1: the
// table of rans_nx16_o1_step.cuh over all 256 contexts, 18 KB of records
// and 32 KB of buckets), read by one load, with the order-1 buckets holding
// the byte offset of their row so that no context start sits on the
// chain.  Their field extracts cost three instructions a state, about
// an eighth of a round more than 16-byte records whose fields are ready to
// use, and let an SM hold six times the streams.
#pragma once

#include "rans_nx16_o1_step.cuh"

#define RANS8_L (1u << 23)
#define RANS8_NWAY 4

RANS_HD uint32_t rans8_bswap(uint32_t v) {
#if defined(__CUDA_ARCH__)
  return __byte_perm(v, 0, 0x0123);
#else
  return __builtin_bswap32(v);
#endif
}

// The top 32 bits of (hi:lo) << (s % 32).
RANS_HD uint32_t rans8_funnel(uint32_t lo, uint32_t hi, uint32_t s) {
#if defined(__CUDA_ARCH__)
  return __funnelshift_l(lo, hi, s);
#else
  s &= 31u;
  return s ? (hi << s) | (lo >> (32u - s)) : hi;
#endif
}

// Bits a state takes after its decode step: 0, 8 or 16.
RANS_HD uint32_t rans8_refill_bits(uint32_t x) {
  return x >= (1u << 15) ? (x >= RANS8_L ? 0u : 8u) : 16u;
}

// Bits a state of the 4-way Nx16 wire takes after its decode step: 0 or 16.
RANS_HD uint32_t rans16_refill_bits(uint32_t x) {
  return x < RANS16_L ? 16u : 0u;
}

// The window's top two bytes b0 (first), b1 as one little-endian word in
// the top half: (b1 << 24) | (b0 << 16), the low half kept.  A funnel
// shift by 16 then takes the word b0 | b1 << 8 the Nx16 wire refills.
RANS_HD uint32_t rans8_swap16(uint32_t v) {
#if defined(__CUDA_ARCH__)
  return __byte_perm(v, 0, 0x2310);
#else
  return ((v << 8) & 0xFF000000u) | ((v >> 8) & 0x00FF0000u) |
         (v & 0xFFFFu);
#endif
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

// Payload word idx (4 bytes as they lie in memory, little-endian) of a
// payload of n_bytes bytes as the window reads it: bytes past the end
// cleared (they read 0), then byte-swapped so the first byte is on top.
RANS_HD uint32_t rans8_stage_word(uint32_t v, uint32_t idx,
                                  uint32_t n_bytes) {
  const uint32_t at = idx * 4u;
  const uint32_t valid = at >= n_bytes ? 0u : n_bytes - at;
  const uint32_t mask =
      valid >= 4u ? 0xFFFFFFFFu : (1u << (8u * valid)) - 1u;
  return rans8_bswap(v & mask);
}

// The 8 payload bytes from byte `pos` on, big-endian (the first byte on
// top: hi:lo), out of the byte-swapped words w0, w1, w2 at word pos / 4.
RANS_HD void rans8_window(uint32_t w0, uint32_t w1, uint32_t w2,
                          uint32_t pos, uint32_t* hi, uint32_t* lo) {
  const uint32_t sh = pos * 8u;  // the funnel shift takes it mod 32
  *hi = rans8_funnel(w1, w0, sh);
  *lo = rans8_funnel(w2, w1, sh);
}

// The four symbols of a round in one word, state j's in byte j, from the
// four slot or row words whose symbol is in bits 24-31.
RANS_HD uint32_t rans8_pack(const uint32_t* e) {
#if defined(__CUDA_ARCH__)
  return __byte_perm(__byte_perm(e[0], e[1], 0x0073),
                     __byte_perm(e[2], e[3], 0x0073), 0x5410);
#else
  return (e[0] >> 24) | ((e[1] >> 16) & 0xFF00u) | ((e[2] >> 8) & 0xFF0000u) |
         (e[3] & 0xFF000000u);
#endif
}

// The end of a round: state j (where bit j of `live` is set) takes its
// decoded value xs[j] and shifts in its refill bytes from the window hi:lo
// (kW16: the Nx16 wire's words).  Returns the bytes the round took.
template <bool kW16>
RANS_HD uint32_t rans8_refill(uint32_t* x, const uint32_t* xs, unsigned live,
                              uint32_t hi, uint32_t lo) {
  uint32_t bits[RANS8_NWAY];
  for (int j = 0; j < RANS8_NWAY; ++j) {
    const bool on = (live >> j) & 1u;
    if (on) x[j] = xs[j];
    bits[j] = on ? (kW16 ? rans16_refill_bits(xs[j])
                         : rans8_refill_bits(xs[j]))
                 : 0u;
  }
  const uint64_t win = ((uint64_t)hi << 32) | lo;
  const uint32_t at[RANS8_NWAY] = {0u, bits[0], bits[0] + bits[1],
                                   bits[0] + bits[1] + bits[2]};
  for (int j = 0; j < RANS8_NWAY; ++j) {
    const uint32_t w = (uint32_t)((win << at[j]) >> 32);
    x[j] = rans8_funnel(kW16 ? rans8_swap16(w) : w, x[j], bits[j]);
  }
  return (at[3] + bits[3]) >> 3;
}

// One round of the four states in order 0..3: state j decodes where bit j
// of `live` is set (order 0 through the slot table `tab`; order 1 through
// the records `tab` and `bucket`, its context held as ctx7 = ctx * 128,
// the four lookups issued together and any loop after them), and shifts
// in its refill bytes from the window hi:lo (kW16: the Nx16 wire's words).
// Leaves the four symbols in *syms (state j's in byte j) and returns the
// bytes the round took.  kDense (order 1 only): `tab` is the stream's dense
// [256, 4096] table of rans_o1_dense in place of the records and buckets.
template <bool kO1, bool kW16 = false, bool kDense = false>
RANS_HD uint32_t rans8_round(uint32_t* x, uint32_t* ctx7, uint32_t* syms,
                             unsigned live, uint32_t hi, uint32_t lo,
                             const uint32_t* tab, const uint16_t* bucket) {
  static_assert(kO1 || !kDense, "the dense table is an order-1 table");
  uint32_t e[RANS8_NWAY], xs[RANS8_NWAY];
  if (kDense) {
    for (int j = 0; j < RANS8_NWAY; ++j)
      e[j] = rans_o1_dense(tab, ctx7[j], x[j]);
  } else if (kO1) {
    bool slow[RANS8_NWAY];
    for (int j = 0; j < RANS8_NWAY; ++j)
      e[j] = rans_o1_pick(tab, bucket, ctx7[j], x[j], &slow[j]);
    if (slow[0] || slow[1] || slow[2] || slow[3])
      for (int j = 0; j < RANS8_NWAY; ++j)
        if (slow[j]) e[j] = rans_o1_walk(tab, bucket, ctx7[j], x[j]);
  }
  if (kO1) {
    // x = f * (x >> 12) + (x & 4095) - cum
    for (int j = 0; j < RANS8_NWAY; ++j)
      xs[j] = ((e[j] & 0xFFFu) + 1u) * (x[j] >> RANS_TF_SHIFT) +
              (x[j] & (RANS_TOTFREQ - 1)) - rans_row_cum(e[j]);
  } else {
    // x = f * (x >> 12) + (the slot's offset in its symbol)
    for (int j = 0; j < RANS8_NWAY; ++j) {
      e[j] = tab[x[j] & (RANS_TOTFREQ - 1)];
      xs[j] = ((e[j] & 0xFFFu) + 1u) * (x[j] >> RANS_TF_SHIFT) +
              ((e[j] >> 12) & 0xFFFu);
    }
  }
  *syms = rans8_pack(e);
  if (kO1)
    for (int j = 0; j < RANS8_NWAY; ++j)
      if ((live >> j) & 1u) ctx7[j] = (e[j] >> 17) & 0x7F80u;  // symbol*128
  return rans8_refill<kW16>(x, xs, live, hi, lo);
}

// ---------------------------------------------------------------------------
// The wide order-1 table (X1, X3 and B8 order 1 on a batch that fits one
// wave of it, rans4x8.cu): ready-to-use records and a lookup with no loop
// and no branch.
//
// A record is 16 bytes read by one load: f, -cum, the next context (its
// symbol * 256, the byte offset of its buckets) and the symbol in bits
// 24-31, so a decode step is a shift, a mask and a multiply-add, with no
// field to extract.  rec[r] is row r, rec[n] a zero row (symbol 0, f = 1,
// cum 0, as the compact table's).  A u32 bucket per 64 slots of each of
// the 256 contexts (64 KB) decides the record from the slot by arithmetic:
// where at most one row starts inside the bucket after its first slot,
// the bucket holds (r << 6) | (64 - b), r the record owning its first
// slot and b the offset of the row starting inside it (64 where none
// does), so the record is (bucket + (x & 63)) >> 6; a context with no rows
// holds the record at its start (the next context's first row, or the
// zero row) with b = 64.  Where two or more rows start inside a bucket
// (RANS8_WIDE_SLOW) the bucket holds the number m of its map, 64 u16
// record indices, one a slot, built at set-up (`rans8_wide_maps`): the
// lookup then takes one predicated load more, with no branch in the round.
// 132 KB of records and buckets and 128 bytes a slow bucket hold one
// stream an SM, where the compact tables hold four.

#define RANS8_WIDE_SLOW 0x80000000u
#define RANS8_WIDE_RECORDS (RANS_O1_MAX_ROWS + 1)
#define RANS8_WIDE_MAP 64  // u16 record indices a slow bucket's map holds

struct alignas(16) Rans8Rec {
  uint32_t f, neg_cum, ctx, sym;
};

// The record of a packed row e ((f-1) | cum << 12 | sym << 24).
RANS_HD Rans8Rec rans8_wide_record(uint32_t e) {
  return {(e & 0xFFFu) + 1u, 0u - rans_row_cum(e), (e >> 24) << 8,
          e & 0xFF000000u};
}

// The records and buckets of one stream from its n rows and context
// starts (ctx_start[256] = n), as above, with every slow bucket set to
// RANS8_WIDE_SLOW (its map comes from `rans8_wide_maps`).  Lane `lane` of
// `nlanes` fills the rows r and the contexts c with r, c % nlanes == lane.
RANS_HD void rans8_wide_build(const uint32_t* rows, const uint16_t* ctx_start,
                              Rans8Rec* rec, uint32_t* bucket, int lane,
                              int nlanes) {
  const int n = ctx_start[256];
  for (int r = lane; r < n; r += nlanes) rec[r] = rans8_wide_record(rows[r]);
  if (lane == 0) rec[n] = rans8_wide_record(0u);
  for (int c = lane; c < 256; c += nlanes) {
    const int lo = ctx_start[c], hi = ctx_start[c + 1];
    uint32_t* bk = bucket + c * RANS_O1_BUCKETS;
    if (lo == hi) {
      for (int j = 0; j < RANS_O1_BUCKETS; ++j) bk[j] = (uint32_t)lo << 6;
      continue;
    }
    int r = lo;
    for (int j = 0; j < RANS_O1_BUCKETS; ++j) {
      const uint32_t slot = (uint32_t)j << RANS_O1_BUCKET_SHIFT;
      while (r + 1 < hi && rans_row_cum(rows[r + 1]) <= slot) ++r;
      uint32_t b = 64u;
      int inside = 0;
      for (int q = r + 1; q < hi && rans_row_cum(rows[q]) < slot + 64u;
           ++q, ++inside)
        if (inside == 0) b = rans_row_cum(rows[q]) - slot;
      bk[j] = inside >= 2 ? RANS8_WIDE_SLOW : ((uint32_t)r << 6) | (64u - b);
    }
  }
}

// The slow buckets of the contexts c with c % nlanes == lane.
RANS_HD int rans8_wide_count_slow(const uint32_t* bucket, int lane,
                                  int nlanes) {
  int n = 0;
  for (int c = lane; c < 256; c += nlanes)
    for (int j = 0; j < RANS_O1_BUCKETS; ++j)
      n += bucket[c * RANS_O1_BUCKETS + j] == RANS8_WIDE_SLOW;
  return n;
}

// The maps of the slow buckets of the contexts c % nlanes == lane,
// numbered from `first` in order of (c, bucket): maps[m * 64 + t] is the
// record owning slot t of the bucket (the last of its context's rows whose
// cum is <= the slot), and the bucket becomes RANS8_WIDE_SLOW | m.
RANS_HD void rans8_wide_maps(const uint32_t* rows, const uint16_t* ctx_start,
                             uint32_t* bucket, uint16_t* maps, int first,
                             int lane, int nlanes) {
  int m = first;
  for (int c = lane; c < 256; c += nlanes) {
    const int lo = ctx_start[c], hi = ctx_start[c + 1];
    uint32_t* bk = bucket + c * RANS_O1_BUCKETS;
    int r = lo;
    for (int j = 0; j < RANS_O1_BUCKETS && lo < hi; ++j) {
      if (bk[j] != RANS8_WIDE_SLOW) continue;
      for (uint32_t t = 0; t < RANS8_WIDE_MAP; ++t) {
        const uint32_t slot = ((uint32_t)j << RANS_O1_BUCKET_SHIFT) + t;
        while (r + 1 < hi && rans_row_cum(rows[r + 1]) <= slot) ++r;
        maps[m * RANS8_WIDE_MAP + t] = (uint16_t)r;
      }
      bk[j] = RANS8_WIDE_SLOW | (uint32_t)m++;
    }
  }
}

// The record of slot x & 4095 of the context whose buckets start at byte
// ctx of `bucket`.
RANS_HD const Rans8Rec* rans8_wide_lookup(const Rans8Rec* rec,
                                          const uint32_t* bucket,
                                          const uint16_t* maps, uint32_t ctx,
                                          uint32_t x) {
  const uint32_t v = *reinterpret_cast<const uint32_t*>(
      reinterpret_cast<const uint8_t*>(bucket) + (ctx | ((x >> 4) & 0xFCu)));
  const uint32_t t = x & (RANS8_WIDE_MAP - 1u);
  uint32_t idx = (v + t) >> 6;
  if (v & RANS8_WIDE_SLOW) idx = maps[((v & 0xFFFFu) << 6) | t];
  return rec + idx;
}

// One order-1 round through the wide table: rans8_round's, the contexts
// held as symbol * 256.
template <bool kW16 = false>
RANS_HD uint32_t rans8_round_wide(uint32_t* x, uint32_t* ctx, uint32_t* syms,
                                  unsigned live, uint32_t hi, uint32_t lo,
                                  const Rans8Rec* rec, const uint32_t* bucket,
                                  const uint16_t* maps) {
  Rans8Rec e[RANS8_NWAY];
  uint32_t xs[RANS8_NWAY], sym[RANS8_NWAY];
  for (int j = 0; j < RANS8_NWAY; ++j)
    e[j] = *rans8_wide_lookup(rec, bucket, maps, ctx[j], x[j]);
  for (int j = 0; j < RANS8_NWAY; ++j) {
    xs[j] = e[j].f * (x[j] >> RANS_TF_SHIFT) + (x[j] & (RANS_TOTFREQ - 1)) +
            e[j].neg_cum;
    sym[j] = e[j].sym;
  }
  *syms = rans8_pack(sym);
  for (int j = 0; j < RANS8_NWAY; ++j)
    if ((live >> j) & 1u) ctx[j] = e[j].ctx;
  return rans8_refill<kW16>(x, xs, live, hi, lo);
}

// One order-1 round through the large table (rans_nx16_o1_step.cuh, for
// tables past RANS_O1_MAX_ROWS rows: X1 and X3 on the streams ops/rans.py
// routes past A2_MAX): rans8_round's, the four picks issued together and,
// where one of them is slow, a walk behind one branch (a pick covers three
// rows: the thread runs four states, and every candidate costs
// instructions); contexts held as symbol * 128.
template <bool kW16 = false>
RANS_HD uint32_t rans8_round_large(uint32_t* x, uint32_t* ctx7,
                                   uint32_t* syms, unsigned live, uint32_t hi,
                                   uint32_t lo, const RansO1Large& t) {
  RansO1Hit e[RANS8_NWAY];
  uint32_t xs[RANS8_NWAY];
  unsigned slow = 0;  // bit j: state j's pick is slow
  for (int j = 0; j < RANS8_NWAY; ++j) {
    bool sj;
    e[j] = rans_o1_large_pick<3>(t, ctx7[j], x[j], &sj);
    slow |= (unsigned)sj << j;
  }
  if (slow)
    for (int j = 0; j < RANS8_NWAY; ++j)
      if ((slow >> j) & 1u) e[j] = rans_o1_large_walk(t, ctx7[j], x[j]);
  for (int j = 0; j < RANS8_NWAY; ++j)
    xs[j] = e[j].f * (x[j] >> RANS_TF_SHIFT) + (x[j] & (RANS_TOTFREQ - 1)) -
            e[j].cum;
  *syms = e[0].sym | e[1].sym << 8 | e[2].sym << 16 | e[3].sym << 24;
  for (int j = 0; j < RANS8_NWAY; ++j)
    if ((live >> j) & 1u) ctx7[j] = e[j].sym << 7;
  return rans8_refill<kW16>(x, xs, live, hi, lo);
}

// The byte cursor and the three (byte-swapped) words at it.  The cursor
// runs on past the payload's end, where every byte reads 0 (`rans8_cap`
// holds it a little beyond); the wire's cursor, clamped at n_bytes, is
// min(pos, n_bytes).
struct Rans8Window {
  uint32_t w0, w1, w2;
  uint32_t pos;
};

// The three words at byte `pos`, word i read from src[i & mask] (src holds
// two more words after src[mask], copies of src[0] and src[1]).
RANS_HD void rans8_load(Rans8Window* w, uint32_t pos, const uint32_t* src,
                        uint32_t mask) {
  const uint32_t* at = src + ((pos >> 2) & mask);
  w->w0 = at[0];
  w->w1 = at[1];
  w->w2 = at[2];
  w->pos = pos;
}

// Take k (<= 8) bytes.
RANS_HD void rans8_advance(Rans8Window* w, uint32_t k, const uint32_t* src,
                           uint32_t mask) {
  rans8_load(w, w->pos + k, src, mask);
}

// Hold the cursor at `cap` (>= n_bytes) once past it: the bytes there read
// 0 as well, so the decode does not change, and the cursor cannot wrap.
RANS_HD void rans8_cap(Rans8Window* w, uint32_t cap, const uint32_t* src,
                       uint32_t mask) {
  if (w->pos > cap) rans8_load(w, cap, src, mask);
}
