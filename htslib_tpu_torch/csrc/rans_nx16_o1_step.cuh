// The order-1 rANS table and lookup, shared by the Nx16 order-1 kernels
// (rans_nx16_o1.cu, CRAM 3.1, htscodecs rans_uncompress_O1_32x16) and the
// 4x8 order-1 histogram kernel (rans4x8.cu, CRAM 3.0).  Host compilers see
// plain inline functions, so a CPU harness can drive the exact arithmetic
// the card runs.
//
// Order-1 wire (Nx16 with nway = 32, 4x8 with nway = 4): the stream splits
// into nway contiguous segments of seg = n / nway symbols, state j owning
// positions j*seg + r; the last state also carries the n - nway*seg tail,
// so its length is n - (nway-1)*seg.  Each state's context is its previous
// symbol, 0 at its segment head; refills interleave in state order.
//
// The table.  A full [ctx, 4096] slot table is 4 MiB per stream, far past
// shared memory.  Instead each stream's present (ctx, sym) pairs are rows
// (f-1) | cum<<12 | sym<<24, sorted by (ctx, cum): at most
// RANS_O1_MAX_ROWS of them (the JAX package's stacked-table budget, which
// also routes denser tables to the host), context c's rows at ctx_start[c]
// .. ctx_start[c+1].  `rans_o1_build` turns them into records (the rows, a
// zero row after them, and a pair per empty context) and one u16 bucket per
// 64 slots of each context holding the byte offset of the record owning
// the bucket's first slot, so a lookup is a bucket load, a load of that
// record and the next, and a select (`rans_o1_pick`); only a bucket in
// which two or more rows start after its first slot is flagged
// RANS_O1_SLOW and needs more: `rans_o1_walk`, a loop over its rows (the
// 4x8 kernel), or a per-slot map of the bucket built from that walk, one
// load more (`rans_o1_maps`, `rans_o1_mapped`: the Nx16 kernels, whose
// quality streams meet a slow bucket in about half their rounds, where the
// slowest of 32 lanes would walk several rows).  The contexts are indexed
// either by symbol value (256 of them: the 4x8 kernel) or densely, over
// the stream's own alphabet (`rans_o1_mark`, `rans_o1_index`: context 0,
// the contexts with rows and the rows' symbols), in which case a record
// carries its symbol's dense index in place of the symbol and the buckets
// take 128 bytes per context of that alphabet rather than 32 KB (the Nx16
// kernels).  Either way a state holds its context as ctx7 = index * 128,
// the byte offset of its buckets, taken from a record by one shift and
// mask.
#pragma once

#include "rans_nx16_step.cuh"

#define RANS_O1_MAX_ROWS 4096
#define RANS_O1_BUCKET_SHIFT 6
#define RANS_O1_BUCKETS (RANS_TOTFREQ >> RANS_O1_BUCKET_SHIFT)
// records of a table: the rows, a zero row, a pair per empty context
#define RANS_O1_RECORDS (RANS_O1_MAX_ROWS + 1 + 2 * 256)
// set in a bucket whose lookups need more than the pick
#define RANS_O1_SLOW 0x8000u
static_assert(4 * RANS_O1_RECORDS <= RANS_O1_SLOW,
              "a record's byte offset must fit below the bucket's flag");

RANS_HD uint32_t rans_row_cum(uint32_t e) { return (e >> 12) & 0xFFFu; }

// Symbols decoded by state j of an order-1 stream of n symbols.
RANS_HD int64_t rans_o1_state_len(int64_t n, int j, int nway) {
  const int64_t seg = n / nway;
  return j < nway - 1 ? seg : n - (int64_t)(nway - 1) * seg;
}

// The dense context alphabet of one stream, in two steps.  `mark` sets
// present[v] (256 bytes, cleared before) for context 0, every context with
// rows and every row's symbol; lane `lane` of `nlanes` marks the rows r
// and values v with r, v % nlanes == lane.  `index` then gives each
// present value its rank, index_of[v] = d and ctx_of[d] = v (lane `lane`
// writes the values v % nlanes == lane), and returns the alphabet's size.
// Context 0 is present and the smallest value, so its index is 0.
RANS_HD void rans_o1_mark(const uint32_t* rows, const uint16_t* ctx_start,
                          uint8_t* present, int lane, int nlanes) {
  for (int r = lane; r < ctx_start[256]; r += nlanes)
    present[rows[r] >> 24] = 1;
  for (int c = lane; c < 256; c += nlanes)
    if (c == 0 || ctx_start[c] < ctx_start[c + 1]) present[c] = 1;
}

RANS_HD int rans_o1_index(const uint8_t* present, uint8_t* index_of,
                          uint8_t* ctx_of, int lane, int nlanes) {
  int d = 0;
  for (int v = 0; v < 256; ++v) {
    if (!present[v]) continue;
    if (v % nlanes == lane) {
      index_of[v] = (uint8_t)d;
      ctx_of[d] = (uint8_t)v;
    }
    ++d;
  }
  return d;
}

// Records and buckets of one stream from its n rows and context starts
// (ctx_start[256] = n).  rec holds the rows (with index_of given, each row's
// symbol replaced by index_of[symbol]), a zero row at n and, for the
// context of index k if it has no rows, the row at its start (the zero row
// past the last) and a zero row at n + 1 + 2k.  bucket[k*64 + j] is the
// byte offset in rec of the record of context k owning slot j*64, with
// RANS_O1_SLOW set where two or more of its rows start inside the bucket
// after that slot.  The contexts are k = 0 .. n_ctx - 1, of value
// ctx_of[k] (or k where ctx_of is null: n_ctx = 256, records keep their
// symbols).  Lane `lane` of `nlanes` fills the rows r and the contexts k
// with r, k % nlanes == lane.
RANS_HD uint32_t rans_o1_record(uint32_t row, const uint8_t* index_of) {
  return index_of ? (row & 0xFFFFFFu) | ((uint32_t)index_of[row >> 24] << 24)
                  : row;
}

RANS_HD void rans_o1_build(const uint32_t* rows, const uint16_t* ctx_start,
                           uint32_t* rec, uint16_t* bucket, int lane,
                           int nlanes, int n_ctx = 256,
                           const uint8_t* ctx_of = nullptr,
                           const uint8_t* index_of = nullptr) {
  const int n = ctx_start[256];
  for (int r = lane; r < n; r += nlanes)
    rec[r] = rans_o1_record(rows[r], index_of);
  if (lane == 0) rec[n] = 0u;
  for (int k = lane; k < n_ctx; k += nlanes) {
    const int c = ctx_of ? ctx_of[k] : k;
    const int lo = ctx_start[c], hi = ctx_start[c + 1];
    uint16_t* bk = bucket + k * RANS_O1_BUCKETS;
    if (lo == hi) {
      const int e = n + 1 + 2 * k;
      rec[e] = lo < n ? rans_o1_record(rows[lo], index_of) : 0u;
      rec[e + 1] = 0u;
      for (int j = 0; j < RANS_O1_BUCKETS; ++j) bk[j] = (uint16_t)(4 * e);
      continue;
    }
    int r = lo;
    for (int j = 0; j < RANS_O1_BUCKETS; ++j) {
      const uint32_t slot = (uint32_t)j << RANS_O1_BUCKET_SHIFT;
      while (r + 1 < hi && rans_row_cum(rows[r + 1]) <= slot) ++r;
      const bool slow = r + 2 < hi && rans_row_cum(rows[r + 2]) <
                                          slot + (1u << RANS_O1_BUCKET_SHIFT);
      bk[j] = (uint16_t)(4 * r + (slow ? RANS_O1_SLOW : 0u));
    }
  }
}

// The record of the row of context ctx7 / 128 owning slot x & 4095: the
// last of its rows whose cum is <= the slot (slots past a context's sum:
// its last row; an empty context: the row at its start).  The bucket's row
// owns the bucket's first slot, so outside a RANS_O1_SLOW bucket the
// answer is that row or the next one: `rans_o1_pick` loads both together
// and selects, and sets *slow where the bucket needs more.  The
// row after a context's last starts at cum 0 (a context's first row does,
// and so does a zero row), which is how the select knows it belongs to no
// later slot of the context.
RANS_HD const uint32_t* rans_o1_bucket(const uint32_t* rec,
                                       const uint16_t* bucket, uint32_t ctx7,
                                       uint32_t x, uint32_t* v) {
  // (ctx*64 + m/64) * 2
  *v = *reinterpret_cast<const uint16_t*>(
      reinterpret_cast<const uint8_t*>(bucket) + (ctx7 | ((x >> 5) & 0x7Eu)));
  return reinterpret_cast<const uint32_t*>(
      reinterpret_cast<const uint8_t*>(rec) + (*v & ~RANS_O1_SLOW));
}

// Whether the row e1, the one after a candidate, starts past slot x & 4095
// of the candidate's context.
RANS_HD bool rans_o1_past(uint32_t e1, uint32_t x) {
  const uint32_t c1 = e1 & 0xFFF000u;  // its cum << 12
  return c1 == 0u || ((x << 12) & 0xFFF000u) < c1;
}

RANS_HD uint32_t rans_o1_pick(const uint32_t* rec, const uint16_t* bucket,
                              uint32_t ctx7, uint32_t x, bool* slow,
                              uint32_t* bucket_value = nullptr) {
  uint32_t v;
  const uint32_t* r = rans_o1_bucket(rec, bucket, ctx7, x, &v);
  const uint32_t e0 = r[0], e1 = r[1];
  *slow = (v & RANS_O1_SLOW) != 0u;
  if (bucket_value) *bucket_value = v;
  return rans_o1_past(e1, x) ? e0 : e1;
}

// From the record r of a context's row owning a slot at or below slot
// x & 4095, the record of the row owning that slot.
RANS_HD const uint32_t* rans_o1_walk_from(const uint32_t* r, uint32_t x) {
  while (!rans_o1_past(r[1], x)) ++r;
  return r;
}

RANS_HD uint32_t rans_o1_walk(const uint32_t* rec, const uint16_t* bucket,
                              uint32_t ctx7, uint32_t x) {
  uint32_t v;
  return *rans_o1_walk_from(rans_o1_bucket(rec, bucket, ctx7, x, &v), x);
}

// Maps of the slow buckets, so that a slow lookup costs one load more
// than a pick and no loop (the Nx16 kernels).  Each slow bucket gets
// RANS_O1_MAP_BYTES: the byte offset in rec of its record (u16), then for
// each of its 64 slots the rows from that record to the slot's own, as
// `rans_o1_walk_from` finds it (u8: rows start at distinct cums, so at
// most 63).  `count` gives the slow buckets of the contexts k with
// k % nlanes == lane; `maps` numbers them from `first` in order of (k,
// bucket), writes their maps and sets each such bucket to RANS_O1_SLOW |
// 4 x its number (a multiple of 4, so the pick's load through it stays
// aligned, and inside rec: a slow bucket has two rows of its own).
// `mapped` is the lookup of a slot in a bucket so set.
#define RANS_O1_MAP_BYTES 68
static_assert(RANS_O1_MAP_BYTES % 4 == 0, "maps must keep their alignment");
RANS_HD int rans_o1_count_slow(const uint16_t* bucket, int n_ctx, int lane,
                               int nlanes) {
  int n = 0;
  for (int k = lane; k < n_ctx; k += nlanes)
    for (int j = 0; j < RANS_O1_BUCKETS; ++j)
      n += (bucket[k * RANS_O1_BUCKETS + j] & RANS_O1_SLOW) != 0u;
  return n;
}

RANS_HD void rans_o1_maps(const uint32_t* rec, uint16_t* bucket,
                          uint8_t* maps, int n_ctx, int first, int lane,
                          int nlanes) {
  int i = first;
  for (int k = lane; k < n_ctx; k += nlanes)
    for (int j = 0; j < RANS_O1_BUCKETS; ++j) {
      uint16_t* v = bucket + k * RANS_O1_BUCKETS + j;
      if (!(*v & RANS_O1_SLOW)) continue;
      uint8_t* mp = maps + i * RANS_O1_MAP_BYTES;
      const uint16_t off = (uint16_t)(*v & ~RANS_O1_SLOW);
      *reinterpret_cast<uint16_t*>(mp) = off;
      const uint32_t* r0 = reinterpret_cast<const uint32_t*>(
          reinterpret_cast<const uint8_t*>(rec) + off);
      const uint32_t* r = r0;
      for (uint32_t t = 0; t < (1u << RANS_O1_BUCKET_SHIFT); ++t) {
        r = rans_o1_walk_from(r, ((uint32_t)j << RANS_O1_BUCKET_SHIFT) + t);
        mp[2 + t] = (uint8_t)(r - r0);
      }
      *v = (uint16_t)(RANS_O1_SLOW | 4u * (uint32_t)i++);
    }
}

RANS_HD uint32_t rans_o1_mapped(const uint32_t* rec, const uint8_t* maps,
                                uint32_t v, uint32_t x) {
  const uint8_t* mp = maps + (v & ~RANS_O1_SLOW) * (RANS_O1_MAP_BYTES / 4);
  const uint32_t off = *reinterpret_cast<const uint16_t*>(mp);
  const uint32_t step = mp[2 + (x & ((1u << RANS_O1_BUCKET_SHIFT) - 1u))];
  return *reinterpret_cast<const uint32_t*>(
      reinterpret_cast<const uint8_t*>(rec) + off + 4u * step);
}

// A state's decode step from the record e of its slot:
// x = f * (x >> 12) + (x & 4095) - cum.
RANS_HD uint32_t rans_o1_advance(uint32_t x, uint32_t e) {
  return ((e & 0xFFFu) + 1u) * (x >> RANS_TF_SHIFT) +
         (x & (RANS_TOTFREQ - 1)) - rans_row_cum(e);
}

// The next context of a state, ctx7 = index * 128, from its record.
RANS_HD uint32_t rans_o1_ctx7(uint32_t e) { return (e >> 17) & 0x7F80u; }

// The dense lookup, for tables past RANS_O1_MAX_ROWS rows: a stream's
// [256, 4096] table in device memory (4 MiB) holds at ctx * 4096 + slot the
// JAX package's packed entry sym | (f-1) << 8 | cum << 20 of the row owning
// the slot (htslib_tpu/ops/rans.py _pack_table), 0 past the context's sum
// (symbol 0, f = 1, cum 0, as the JAX decode reads it).  The lookup returns
// it as a row record, its symbol in place of a dense index, so the round's
// step, context and output stay those of the record kernels: contexts are
// symbol values, ctx7 = ctx * 128.
RANS_HD uint32_t rans_o1_dense_row(uint32_t d) {
  return ((d >> 8) & 0xFFFu) | ((d >> 20) << 12) | (d << 24);
}

RANS_HD uint32_t rans_o1_dense(const uint32_t* dense, uint32_t ctx7,
                               uint32_t x) {
  return rans_o1_dense_row(dense[(ctx7 << 5) | (x & (RANS_TOTFREQ - 1))]);
}
