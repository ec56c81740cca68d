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

// Why a kernel refused a stream.  A kernel whose layout outgrows what its
// launch was sized for sets its error word (`rans_refuse`, the first code
// wins) and returns, so the process keeps its CUDA context; the wrapper
// reads the word after the launch and raises.
#define RANS_REFUSE_SMEM 1  // the tables outgrew the block's shared memory
#define RANS_REFUSE_MAPS 2  // more slow buckets than the launch's maps hold
#if defined(__CUDACC__)
__device__ __forceinline__ void rans_refuse(int32_t* err, int code) {
  atomicCAS(err, 0, code);
}
#endif

// ---------------------------------------------------------------------------
// The large order-1 table, for tables past RANS_O1_MAX_ROWS rows up to the
// wire's 65,536 (the streams ops/rans.py sends past A2_MAX: X1, X3 and B5),
// in shared memory, decoding as the JAX function's dense [256, 4096] table
// of packed entries does: a slot past its context's sum (every slot of a
// context with no rows) is entry 0, symbol 0 with f = 1 and cum 0.
//
// Budget.  A block has 232,448 bytes.  The rows' u32 records take 256 KiB
// at 65,536 rows, a u16 bucket cannot address past 8,192 records, and a
// near-uniform table (256 rows a context, ~16 slots a row) has every
// 64-slot bucket slow: maps for all of them would take 2 MiB.  So the rows
// are split into planes, and nothing is kept per slot:
//   cum[r]     u16, row r's cum; the row after a context's last reads 0
//              (the next context's first row starts at cum 0, and eight
//              zeros pad the plane), so the next row's cum gives f without
//              a sentinel, and a context's end comes from its info word;
//   sym[r]     u8, its symbol (B5: the symbol's dense index);
//   info[k]    u32, context k's first row | its sum (end) << 17;
//   bucket[k << (12 - shift) | j]  u8, the row (counted from the
//              context's first) that owns slot j << shift of context k: a
//              context has at most 256 rows.
// At 65,536 rows, 256 contexts and buckets of 32 slots (shift 5): 2 x
// 65,544 + 65,544 + 1,024 + 32,768 = 230,424 bytes, under the block's
// budget by 2,024 bytes: the 4x8 kernels' ring and symbol buffer (1,160)
// or B5's fixed part (1,792) fit beside it.  A launch sizes its planes for
// the batch's largest table and chooses the shift (3, 4 or 5: buckets of
// 8, 16 or 32 slots; ops/ `large_shift`): the finest whose blocks still
// fit, which smaller tables (a HiFi alphabet's 94 x 94 pairs, B5's dense
// alphabets) afford, so fewer lookups walk.
//
// Lookup (`rans_o1_large_pick<kSpan>`).  The bucket gives row r, owning
// the bucket's first slot; the answer is one of r .. r + kSpan - 1 unless
// kSpan rows after r start at or before the slot.  The cums r .. r + kSpan
// load together after the bucket (and the info word beside it), the row
// is chosen by kSpan - 1 compares, and its symbol is one load more: four
// dependent shared loads a round, as the compact table's three and a
// symbol.  A slot where kSpan rows after r start at or before it, or one
// past its context's sum, sets *slow, and the caller takes the walk
// (`rans_o1_large_walk`, at most 31 rows, and the JAX entry 0 past the
// sum): the 4x8 round (kSpan 3: its thread runs four states, and each
// candidate costs instructions) behind one branch over its four states, B5
// (kSpan 5: a lane runs one state, and the warp waits for its slowest
// lane) behind a vote.
#define RANS_O1_LARGE_MAX_ROWS 65536
#define RANS_O1_LARGE_SHIFT 5      // the coarsest buckets: 32 slots
#define RANS_O1_LARGE_SHIFT_MIN 3  // the finest: 8 slots
#define RANS_O1_LARGE_START 0x1FFFFu  // info: the first row, 17 bits
#define RANS_O1_LARGE_END_SHIFT 17    // info: the sum, 13 bits
static_assert((RANS_TOTFREQ >> RANS_O1_LARGE_SHIFT) == 128,
              "ctx7 = index * 128 is a context's buckets at shift 5");

#define RANS_O1_LARGE_PAD 8  // zero cums after the rows: a pick's reach

// Byte offsets of a stream's planes from the start of its tables, for n
// rows, n_ctx contexts and buckets of 1 << shift slots; the planes cum and
// sym, which the rows alone size, come first, so a kernel can fill them
// before it knows its alphabet.
struct RansO1LargeLayout {
  int cum, sym, info, bucket, end;
};

RANS_HD RansO1LargeLayout rans_o1_large_layout(
    int n, int n_ctx, int shift = RANS_O1_LARGE_SHIFT) {
  // the rows and their zeros, in whole words
  const int n4 = (n + RANS_O1_LARGE_PAD + 3) & ~3;
  RansO1LargeLayout l;
  l.cum = 0;
  l.sym = 2 * n4;
  l.info = l.sym + n4;
  l.bucket = l.info + 4 * n_ctx;
  l.end = l.bucket + (RANS_TOTFREQ >> shift) * n_ctx;
  return l;
}

// A stream's planes, built (`RansO1LargeOut`) or read (`RansO1Large`),
// with the bucket shift (`up`: 5 - shift, which turns ctx7 = index * 128
// into the context's first bucket).
struct RansO1LargeOut {
  uint16_t* cum;
  uint8_t* sym;
  uint32_t* info;
  uint8_t* bucket;
  uint32_t shift;
};
struct RansO1Large {
  const uint16_t* cum;
  const uint8_t* sym;
  const uint32_t* info;
  const uint8_t* bucket;
  uint32_t shift, up;
};

RANS_HD RansO1LargeOut rans_o1_large_planes(
    uint8_t* base, const RansO1LargeLayout& l,
    int shift = RANS_O1_LARGE_SHIFT) {
  return {reinterpret_cast<uint16_t*>(base + l.cum), base + l.sym,
          reinterpret_cast<uint32_t*>(base + l.info), base + l.bucket,
          (uint32_t)shift};
}

RANS_HD RansO1Large rans_o1_large_view(const RansO1LargeOut& o) {
  return {o.cum, o.sym, o.info, o.bucket, o.shift,
          (uint32_t)RANS_O1_LARGE_SHIFT - o.shift};
}

// The row planes of n rows (lane `lane` of `nlanes` fills the rows r with
// r % nlanes == lane, eight loads in flight, and the zeros after them);
// where `present` is given, it also marks each row's symbol there (B5's
// alphabet: `rans_o1_mark`'s first loop).
RANS_HD void rans_o1_large_put(const RansO1LargeOut& o, int r, uint32_t e,
                               uint8_t* present) {
  o.cum[r] = (uint16_t)rans_row_cum(e);
  o.sym[r] = (uint8_t)(e >> 24);
  if (present) present[e >> 24] = 1;
}

RANS_HD void rans_o1_large_rows(const uint32_t* rows, int n,
                                const RansO1LargeOut& o, int lane,
                                int nlanes, uint8_t* present = nullptr) {
  int r = lane;
  for (; r + 7 * nlanes < n; r += 8 * nlanes) {
    uint32_t e[8];
    for (int i = 0; i < 8; ++i) e[i] = rows[r + i * nlanes];
    for (int i = 0; i < 8; ++i) rans_o1_large_put(o, r + i * nlanes, e[i],
                                                  present);
  }
  for (; r < n; r += nlanes) rans_o1_large_put(o, r, rows[r], present);
  for (int z = n + lane; z < n + RANS_O1_LARGE_PAD; z += nlanes) {
    o.cum[z] = 0;
    o.sym[z] = 0;
  }
}

// The context words and buckets, from the rows' cum plane (filled, and
// every lane past it) and the rows' context starts (ctx_start[256] = n):
// contexts k = 0 .. n_ctx - 1 of value ctx_of[k] (or k where ctx_of is
// null), lane `lane` of `nlanes` taking k % nlanes == lane.  With index_of
// (B5), the lane first turns the symbols of its rows into their dense
// indices.
template <typename CS>
RANS_HD void rans_o1_large_contexts(const uint32_t* rows, const CS* ctx_start,
                                    const RansO1LargeOut& o, int lane,
                                    int nlanes, int n_ctx = 256,
                                    const uint8_t* ctx_of = nullptr,
                                    const uint8_t* index_of = nullptr) {
  if (index_of)
    for (int r = lane; r < (int)ctx_start[256]; r += nlanes)
      o.sym[r] = index_of[o.sym[r]];
  const int per_ctx = RANS_TOTFREQ >> o.shift;
  for (int k = lane; k < n_ctx; k += nlanes) {
    const int c = ctx_of ? ctx_of[k] : k;
    const int lo = (int)ctx_start[c], hi = (int)ctx_start[c + 1];
    const uint32_t end =
        lo < hi ? rans_row_cum(rows[hi - 1]) + (rows[hi - 1] & 0xFFFu) + 1u
                : 0u;
    o.info[k] = (uint32_t)lo | end << RANS_O1_LARGE_END_SHIFT;
    uint8_t* bk = o.bucket + k * per_ctx;
    int r = lo;
    for (int j = 0; j < per_ctx; ++j) {
      const uint32_t slot = (uint32_t)j << o.shift;
      while (r + 1 < hi && o.cum[r + 1] <= slot) ++r;
      bk[j] = (uint8_t)(lo < hi ? r - lo : 0);
    }
  }
}

// A lookup's answer, fields ready: f, cum and the symbol (B5: its index).
struct RansO1Hit {
  uint32_t f, cum, sym;
};

// The answer for slot s of the context with info word `info`, from the
// cum of the row owning it (or, past the sum, the context's last row) and
// of the row after it (0 after the context's last).
RANS_HD RansO1Hit rans_o1_large_hit(uint32_t info, uint32_t s, uint32_t cum,
                                    uint32_t next, uint32_t sym) {
  const uint32_t end = info >> RANS_O1_LARGE_END_SHIFT;
  RansO1Hit h = {(next ? next : end) - cum, cum, sym};
  if (s >= end) h = {1u, 0u, 0u};  // the JAX packed entry 0
  return h;
}

// Row r of the context ctx7 / 128 owning the first slot of slot s's bucket
// (absolute), and the context's info word.
RANS_HD uint32_t rans_o1_large_row(const RansO1Large& t, uint32_t ctx7,
                                   uint32_t s, uint32_t* info) {
  *info = t.info[ctx7 >> 7];
  return (*info & RANS_O1_LARGE_START) +
         t.bucket[(ctx7 << t.up) | (s >> t.shift)];
}

// Whether a row whose cum is c, following a candidate, starts at or before
// slot s inside the candidate's context (a cum of 0 is the next context's).
RANS_HD bool rans_o1_large_in(uint32_t c, uint32_t s) { return c - 1u < s; }

// The pick's answer where it does not set *slow (where it does, the
// answer is the walk's).
template <int kSpan>
RANS_HD RansO1Hit rans_o1_large_pick(const RansO1Large& t, uint32_t ctx7,
                                     uint32_t x, bool* slow) {
  static_assert(kSpan >= 2 && kSpan < RANS_O1_LARGE_PAD,
                "a pick reads the cums r .. r + kSpan");
  const uint32_t s = x & (RANS_TOTFREQ - 1u);
  uint32_t info;
  const uint32_t r = rans_o1_large_row(t, ctx7, s, &info);
  uint32_t c[kSpan + 1];
  for (int i = 0; i <= kSpan; ++i) c[i] = t.cum[r + i];
  uint32_t cum = c[0], next = c[1], k = 0;
  bool in = true;  // rows r + 1 .. r + i all start at or before s
  for (int i = 1; i < kSpan; ++i) {
    in = in && rans_o1_large_in(c[i], s);
    if (in) {
      cum = c[i];
      next = c[i + 1];
      ++k;
    }
  }
  const uint32_t end = info >> RANS_O1_LARGE_END_SHIFT;
  *slow = (in && rans_o1_large_in(c[kSpan], s)) || s >= end;
  return {(next ? next : end) - cum, cum, t.sym[r + k]};
}

// The answer by a walk of the bucket's rows, for a slow pick.
RANS_HD RansO1Hit rans_o1_large_walk(const RansO1Large& t, uint32_t ctx7,
                                     uint32_t x) {
  const uint32_t s = x & (RANS_TOTFREQ - 1u);
  uint32_t info;
  uint32_t r = rans_o1_large_row(t, ctx7, s, &info);
  while (rans_o1_large_in(t.cum[r + 1], s)) ++r;
  return rans_o1_large_hit(info, s, t.cum[r], t.cum[r + 1], t.sym[r]);
}
