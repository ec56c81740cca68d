// The step of the BAM record-boundary chain (kernel X5, record_scan.cu)
// and the arithmetic of its segmented passes, shared with the g++
// harnesses of tests/test_torch_bam2sam.py and test_torch_record_scan.py.
// Host compilers see plain inline functions.
//
// The chain is the JAX package's device_record_scan (ops/bam2sam.py:34),
// a loop over max_records steps in int32: step k is ok while
// pos + 4 <= U; it then records offs[k] = pos and sizes[k] = the int32
// read little-endian at clip(pos, 0, U - 4), and moves pos to
// pos + 4 + size.  A step that is not ok records (-1, 0) and leaves pos
// where it is, so every later step is not ok either: the count n is the
// steps before the first that is not.  Sums wrap as int32 sums do, so a
// length with bit 31 set moves pos back (even below 0, where the read is
// clipped to 0), and a record that overruns U still counts.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define RSCAN_HD __host__ __device__ __forceinline__
#else
#define RSCAN_HD static inline
#endif

// a + b as int32 sums wrap
RSCAN_HD int32_t rscan_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

// Whether the step at pos is ok in a payload of U bytes.
RSCAN_HD bool rscan_ok(int32_t pos, int32_t u) {
  return rscan_add(pos, 4) <= u;
}

// Where the step at pos reads its length: clip(pos, 0, U - 4).
RSCAN_HD int32_t rscan_at(int32_t pos, int32_t u) {
  const int32_t p = pos < 0 ? 0 : pos;
  return p > u - 4 ? u - 4 : p;
}

// The little-endian int32 at byte `off` of `w`.
RSCAN_HD int32_t rscan_len(const uint8_t* w, int64_t off) {
  return (int32_t)((uint32_t)w[off] | ((uint32_t)w[off + 1] << 8) |
                   ((uint32_t)w[off + 2] << 16) |
                   ((uint32_t)w[off + 3] << 24));
}

// The chain's steps from step *k at *pos while the length they read lies
// in the window w = payload bytes [wbase, wbase + wlen): each records
// offs/sizes[*k] and advances *k and *pos.  Stops before a step whose
// length lies outside the window (returns false), or at the first step that
// is not ok or at max_records (returns true: the chain is done).
RSCAN_HD bool rscan_walk(const uint8_t* w, int64_t wbase, int64_t wlen,
                         int32_t u, int32_t* pos, int32_t* k,
                         int32_t max_records, int32_t* offs,
                         int32_t* sizes) {
  int32_t p = *pos, kk = *k;
  bool done = false;
  for (;;) {
    if (kk >= max_records || !rscan_ok(p, u)) {
      done = true;
      break;
    }
    const int64_t at = rscan_at(p, u);
    if (at < wbase || at + 4 > wbase + wlen) break;
    const int32_t bsz = rscan_len(w, at - wbase);
    offs[kk] = p;
    sizes[kk] = bsz;
    p = rscan_add(rscan_add(p, 4), bsz);
    ++kk;
  }
  *pos = p;
  *k = kk;
  return done;
}

// ---------------------------------------------------------------------------
// The chain in parallel segments (record_scan.cu's segmented kernels).
//
// The payload is cut into segments of 2^shift bytes.  A chain whose steps
// all move forward (a length >= 0, no int32 wrap) visits each segment's
// positions in order, so the first position it reaches inside segment s,
// its entry, decides every step it takes there.  Pass 1 guesses each
// segment's entry from its bytes (`rscan_looks`: the first position from
// which the chain looks like BAM records) and walks the chain from the
// guess to the segment's end (`rscan_seg_walk`), recording its positions,
// its step count c and its exit e, or stopping at a step it cannot keep in
// order (a negative length, a length that would wrap: `rscan_regular`).
// Segment 0's entry is 0, which is exact.  Pass 2 (`rscan_follow`) follows
// the true chain from position 0 over the segments' summaries: a segment
// whose guess equals the position the chain enters it at walked the
// chain's own steps, so the chain goes on from its exit with its count
// added; a segment whose guess the chain misses is walked again from the
// true entry, and a stopped walk hands the chain to the serial walk above
// (`rscan_walk`), which keeps every int32 quirk.  Nothing is taken on
// trust: every step the segments contribute was walked from a position
// the chain is known to reach.

// Steps the guess checks ahead, and the bytes a BAM record's fixed fields
// take after its length.
#define RSCAN_GUESS_STEPS 4
#define RSCAN_FIXED 32

// What a segment's walk ended on: its exit is a position at or past the
// segment's end, or one that is not ok (the chain ends there); or a step
// that is not in order lies at its exit.
#define RSCAN_EXIT 0
#define RSCAN_FLAG 1

// What the follow of pass 2 stopped on.
#define RSCAN_TILE 0   // the next segment's summary is not loaded
#define RSCAN_MISS 1   // the next segment must be walked from the chain's
                       // position
#define RSCAN_DONE 2   // the chain is known to its end or max_records
#define RSCAN_TAIL 3   // the serial walk takes the chain from here

// Whether the step at pos (0 <= pos <= U - 4) of length bsz keeps the chain
// in order: it moves forward, and neither its sum nor the next step's
// pos + 4 can wrap.
RSCAN_HD bool rscan_regular(int32_t pos, int32_t bsz) {
  return bsz >= 0 && (int64_t)pos + 8 + bsz <= (int64_t)INT32_MAX;
}

// Whether the chain from position p looks like BAM records (the bam_read1
// framing, sam.c:784) for RSCAN_GUESS_STEPS steps, read in the window w =
// payload bytes [wbase, wend): a block_size of at least 32, a reference id
// of -1 or more, a read name of at least its NUL, whose last byte is 0,
// the name, CIGAR, SEQ and QUAL sizes within the block, and a next record
// that starts inside the window or exactly at the payload's end (where
// the chain ends well).  A chain whose next header lies past the window
// looks like records if one step was checked.  Any rule would do: the
// guess is verified.
RSCAN_HD bool rscan_looks(const uint8_t* w, int64_t wbase, int64_t wend,
                          int32_t u, int32_t p) {
  for (int i = 0; i < RSCAN_GUESS_STEPS; ++i) {
    if (p == u) return i > 0;
    if (!rscan_ok(p, u)) return false;
    if ((int64_t)p + 4 + RSCAN_FIXED > wend) return i > 0;
    const uint8_t* r = w + (p - wbase);
    const int32_t bsz = rscan_len(r, 0);
    if (bsz < RSCAN_FIXED) return false;
    const int64_t next = (int64_t)p + 4 + bsz;
    if (next > wend && next != u) return false;
    const int32_t ref = rscan_len(r, 4);
    const int32_t l_name = r[12];
    const int32_t n_cig = r[16] | (r[17] << 8);
    const int32_t l_seq = rscan_len(r, 20);
    if (ref < -1 || l_name < 1 || l_seq < 0) return false;
    if ((int64_t)RSCAN_FIXED + l_name + 4 * n_cig + (l_seq + 1) / 2 +
            l_seq > bsz)
      return false;
    const int64_t nul = (int64_t)p + 4 + RSCAN_FIXED + l_name - 1;
    if (nul < wend && w[nul - wbase] != 0) return false;
    p = (int32_t)next;
  }
  return true;
}

// Walk the chain from position g (lo <= g < hi, in the window w = payload
// bytes from wbase on, holding at least [lo, hi + 4)) while it lies inside
// the segment [lo, hi) and its steps are in order: each step's position
// goes to starts[] as its offset from lo.  Returns the steps; *exit gets
// the position the walk stopped at and *status RSCAN_FLAG where that
// position's step is not in order (it is ok and inside the segment), else
// RSCAN_EXIT (the position is at or past hi, or not ok).
RSCAN_HD int32_t rscan_seg_walk(const uint8_t* w, int64_t wbase, int32_t u,
                                int32_t lo, int32_t hi, int32_t g,
                                uint16_t* starts, int32_t* exit,
                                int32_t* status) {
  int32_t p = g, c = 0;
  *status = RSCAN_EXIT;
  while (p < hi && rscan_ok(p, u)) {
    const int32_t bsz = rscan_len(w, p - wbase);
    if (!rscan_regular(p, bsz)) {
      *status = RSCAN_FLAG;
      break;
    }
    starts[c++] = (uint16_t)(p - lo);
    p = p + 4 + bsz;
  }
  *exit = p;
  return c;
}

// The chain's state in pass 2: its position, the steps before it, and the
// segments walked again so far.
struct RscanFollow {
  int32_t pos, k, rewalks;
};

// Pass 2: follow the chain from st over the segments whose summaries
// (guess g, exit e, steps c, status f) are loaded for segments s0 <= s <
// s1, indexed s - s0.  Each segment the chain enters at its guess is
// verified: seg_k[s] gets the chain's step count at its entry, and the
// chain moves to its exit.  Returns RSCAN_DONE where the chain ends (a
// position that is not ok) or has max_records steps, RSCAN_TAIL after a
// verified segment whose walk stopped at a step not in order (st at that
// step), RSCAN_MISS where the chain enters a segment away from its guess
// (st at the entry), RSCAN_TILE where it enters a segment >= s1.
RSCAN_HD int rscan_follow(const int32_t* g, const int32_t* e,
                          const int32_t* c, const int32_t* f, int32_t s0,
                          int32_t s1, int shift, int32_t u,
                          int32_t max_records, int32_t* seg_k,
                          RscanFollow* st) {
  for (;;) {
    if (st->k >= max_records || !rscan_ok(st->pos, u)) return RSCAN_DONE;
    const int32_t s = st->pos >> shift;
    if (s >= s1) return RSCAN_TILE;
    if (g[s - s0] != st->pos) return RSCAN_MISS;
    seg_k[s] = st->k;
    st->k += c[s - s0];
    st->pos = e[s - s0];
    if (f[s - s0] == RSCAN_FLAG)
      return st->k >= max_records ? RSCAN_DONE : RSCAN_TAIL;
  }
}
