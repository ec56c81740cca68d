// Per-member DEFLATE decoder (RFC 1951) of the inflate kernel (inflate.cu),
// with the exact error semantics of the JAX package's device inflate
// (htslib_tpu/ops/inflate.py: a lockstep state machine, pass A, then token
// resolution, pass B).  Host compilers see plain inline functions, so a CPU
// harness can drive the decoder the card runs, with one lane.
//
// The JAX decoder advances every member one item a step: a block header
// (with, in the same step, the first chunk of a stored block or, for a
// dynamic block, the precode and the first code-length symbol), one
// code-length symbol, one stored chunk of at most 8,191 bytes, or one
// literal/length symbol with its distance.  Steps run in chunks of 512; a
// member whose code lengths are complete waits for the table build that
// runs between chunks, and after 512 chunks a member not done is in error.
// Its errors, which this decoder reproduces step for step (the step index
// is counted here, builds included):
//   - a step that begins with the bit cursor past the payload's end (an EOB
//     or a stored block that ends past it is not an error);
//   - block type 3;
//   - a precode, literal/length or distance code with no entry;
//   - a literal/length symbol of 286 or more;
//   - 65,552 tokens (literals, matches and stored chunks) or more;
//   - the 512 x 512 step cap;
//   - (on the host) output of another size than the member's ISIZE.
// What JAX does not check, this decoder does not either: NLEN, an
// over-subscribed or incomplete code (a code resolves to the shortest
// length whose canonical range holds it, as JAX's 15-bit table does), a
// repeat past the code lengths' count, a leading repeat code 16 (it
// repeats 0), HLIT up to 31, distance codes 30 and 31 (JAX's token for
// them reads as one literal 0xFF byte) and a distance past the output's
// start (a byte reads output byte max(pos - dist, 0); position 0 copying
// itself reads the low byte of dist - 1).  Bytes past the payload read 0.
//
// Memory (InflSmem, one per member, shared memory on the card): the
// payload's words are staged ahead of the bit cursor into a ring of
// INFL_NSEG segments (cp.async on the card, each lane a word of a
// segment), and the stream's next bits wait in a 64-bit register
// reservoir (InflIn) that a step refills from the ring with words it
// loaded at its start, so no step reads its input bits from device
// memory.  The output window, which matches copy from, is one of two
// (infl_member's RING):
//   - a 32 KiB ring in shared memory, DEFLATE's farthest distance, flushed
//     to the member's slot in device memory a 4 KiB chunk at a time
//     (16-byte stores where the slot is 16-byte aligned), positions at or
//     past the capacity never.  A match before the output's start happens
//     before the ring has wrapped, so ring byte 0 is still output byte 0.
//     No step touches device memory, but a member takes 37 KB of shared
//     memory;
//   - the member's slot itself, positions at or past the capacity never
//     written: matches read device memory (mostly L2), and a member takes
//     under 5 KB.
// Stored blocks copy straight from the payload in device memory, a chunk
// a step across the lanes, and the reservoir seeks past them.
#pragma once

#include <stdint.h>
#include <string.h>

#if defined(__CUDACC__)
#define INFL_HD __host__ __device__ __forceinline__
#else
#define INFL_HD static inline
#endif
// the warp's lanes order their memory accesses (a no-op for one lane)
#if defined(__CUDA_ARCH__)
#define INFL_SYNC() __syncwarp()
#else
#define INFL_SYNC() ((void)0)
#endif

#define INFL_OUT_MAX 65536
#define INFL_MAX_TOK (INFL_OUT_MAX + 16)
#define INFL_STORED_CHUNK 8191
#define INFL_STEPS_A_CHUNK 512
#define INFL_STEP_CAP (512 * 512)
#define INFL_MAXBITS 15
#define INFL_LIT_BITS 10  // the literal/length lookup; longer codes walk
#define INFL_DST_BITS 8   // the distance lookup
#define INFL_PRE_BITS 7   // the precode lookup (precode lengths are <= 7)
#define INFL_NLENS 320    // 288 literal/length + 32 distance code lengths
#define INFL_RING 32768   // the output window: DEFLATE's farthest distance
#define INFL_RING_MASK (INFL_RING - 1)
#define INFL_FLUSH 4096   // output bytes flushed to device memory at once
#define INFL_SEG 32       // payload words a staged segment (a word a lane)
#define INFL_NSEG 4       // segments in the payload ring
#define INFL_IN_WORDS (INFL_SEG * INFL_NSEG)

// Error codes (InflResult.err); any nonzero one makes the member corrupt.
enum {
  INFL_OK = 0,
  INFL_E_OVERRUN = 1,    // a step began past the payload's end
  INFL_E_BTYPE = 2,      // block type 3
  INFL_E_PRECODE = 3,    // a precode code with no entry
  INFL_E_LITLEN = 4,     // a literal/length code with no entry
  INFL_E_SYMBOL = 5,     // literal/length symbol 286 or 287
  INFL_E_DIST = 6,       // a distance code with no entry
  INFL_E_TOKENS = 7,     // MAX_TOK tokens
  INFL_E_STEPS = 8       // the step cap
};

// A canonical code: for each length l, the first code, the number of
// symbols and the index of the first of them in `order` (the symbols
// sorted by (length, symbol)).
struct InflCode {
  int32_t first[INFL_MAXBITS + 1];
  int32_t cnt[INFL_MAXBITS + 1];
  int32_t base[INFL_MAXBITS + 1];
};

// One member's tables: lookups of (length << 9) | symbol by the next
// INFL_*_BITS bits of the stream (0: no code of that many bits or fewer),
// the codes, their symbol orders and the code lengths being read.
struct InflTables {
  uint16_t lit[1 << INFL_LIT_BITS];
  uint16_t dst[1 << INFL_DST_BITS];
  uint16_t pre[1 << INFL_PRE_BITS];
  InflCode lit_c, dst_c, pre_c;
  uint16_t lit_order[288];
  uint16_t dst_order[32];
  uint16_t pre_order[19];
  uint8_t lens[INFL_NLENS];
};

// A member's shared memory: the payload ring and the code tables (and,
// beside them, the output ring where the member keeps one).
struct InflSmem {
  uint32_t in[INFL_IN_WORDS];
  InflTables t;
};

// Output position q's byte in the window: the ring's slot q % INFL_RING,
// or the slot's byte q.
template <bool RING>
INFL_HD uint32_t infl_at(uint32_t q) {
  return RING ? q & INFL_RING_MASK : q;
}

// The bit reader: the stream's next nb bits in bb (LSB first, the bits
// above them 0), the next payload word w to enter bb, the bits consumed p
// (the JAX decoder's cursor), and the payload ring's segments: [base,
// base + INFL_NSEG) staged or in flight, those up to `ready` landed.
struct InflIn {
  uint64_t bb;
  uint32_t nb, w, p;
  uint32_t base, ready;
};

// What a member's decode leaves: its error code, the bytes its tokens
// produce (past the output's capacity included), its tokens and steps.
struct InflResult {
  int32_t err, produced, tokens, steps;
};

// RFC 1951 section 3.2.5 tables as the JAX package holds them (length
// codes 29-30 and distance codes 30-31 read base 0, no extra bits), by
// formula: code c past the first few has e extra bits and base
// ((4 + c % 4) << e) + 3 (lengths) or ((2 + c % 2) << e) + 1 (distances).
INFL_HD uint32_t infl_length_extra(uint32_t c) {
  return c < 8 || c >= 28 ? 0u : (c - 4u) >> 2;
}
INFL_HD uint32_t infl_length_base(uint32_t c) {
  if (c < 8) return c + 3u;
  if (c >= 28) return c == 28 ? 258u : 0u;
  return ((4u + (c & 3u)) << infl_length_extra(c)) + 3u;
}
INFL_HD uint32_t infl_dist_extra(uint32_t c) {
  return c < 4 || c >= 30 ? 0u : (c - 2u) >> 1;
}
INFL_HD uint32_t infl_dist_base(uint32_t c) {
  if (c < 4) return c + 1u;
  if (c >= 30) return 0u;
  return ((2u + (c & 1u)) << infl_dist_extra(c)) + 1u;
}

// The n low bits of v, reversed.
INFL_HD uint32_t infl_brev(uint32_t v, int n) {
#if defined(__CUDA_ARCH__)
  return __brev(v) >> (32 - n);
#else
  uint32_t r = 0;
  for (int i = 0; i < n; ++i) r |= ((v >> i) & 1u) << (n - 1 - i);
  return r;
#endif
}

// Word i of a payload of n bytes (words back to back from its first
// byte), the bytes past its end cleared.
INFL_HD uint32_t infl_word(const uint32_t* words, uint32_t n, uint32_t i) {
  const uint32_t at = 4u * i;
  if (at >= n) return 0u;
  const uint32_t v = words[i];
  return n - at >= 4u ? v : v & ((1u << (8u * (n - at))) - 1u);
}

// Stage segment `seg` of the payload (words seg * INFL_SEG on) into its
// slot of the payload ring: lane `lane` of `nlanes` copies words lane,
// lane + nlanes, ...; bytes past the payload's n read 0.  On the card a
// cp.async group of the lane's, which infl_wait_segments lands.
INFL_HD void infl_stage(uint32_t* in_ring, const uint32_t* words, uint32_t n,
                        uint32_t seg, int lane, int nlanes) {
  uint32_t* dst = in_ring + (seg % INFL_NSEG) * INFL_SEG;
  for (int k = lane; k < INFL_SEG; k += nlanes) {
    const uint32_t i = seg * INFL_SEG + (uint32_t)k;
#if defined(__CUDA_ARCH__)
    const uint32_t at = 4u * i;
    const uint32_t avail = at >= n ? 0u : (n - at >= 4u ? 4u : n - at);
    const uint32_t sa = (uint32_t)__cvta_generic_to_shared(dst + k);
    const uint32_t* src = avail ? words + i : words;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sa),
                 "l"(src), "r"(avail)
                 : "memory");
#else
    dst[k] = infl_word(words, n, i);
#endif
  }
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Land the lane's staged segments but the `pending` newest (0 .. 3), then
// order the warp: every lane's words of those segments are visible.
INFL_HD void infl_wait_segments(uint32_t pending) {
#if defined(__CUDA_ARCH__)
  if (pending == 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else if (pending == 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 3;\n" ::: "memory");
#else
  (void)pending;
#endif
  INFL_SYNC();
}

// After in->w moved: stage the segments that slots freed below w make
// room for (all of them anew after a move outside the staged ones, as a
// seek back past a stored block's header can make), and land the
// segments of words w and w + 1, the words a step may read.
INFL_HD void infl_advance(InflIn* in, uint32_t* in_ring, const uint32_t* words,
                          uint32_t n, int lane, int nlanes) {
  const uint32_t lo = in->w / INFL_SEG, need = (in->w + 1) / INFL_SEG;
  if (lo < in->base || lo >= in->base + INFL_NSEG) {
    infl_wait_segments(0);  // nothing in flight; every lane past its reads
    for (uint32_t sg = lo; sg < lo + INFL_NSEG; ++sg)
      infl_stage(in_ring, words, n, sg, lane, nlanes);
    in->base = lo;
    infl_wait_segments(lo + INFL_NSEG - 1 - need);
    in->ready = need;
    return;
  }
  if (lo != in->base) {
    INFL_SYNC();  // every lane has read the slots being refilled
    for (uint32_t sg = in->base + INFL_NSEG; sg < lo + INFL_NSEG; ++sg)
      infl_stage(in_ring, words, n, sg, lane, nlanes);
    in->base = lo;
  }
  if (need > in->ready) {
    infl_wait_segments(in->base + INFL_NSEG - 1 - need);
    in->ready = need;
  }
}

// The reader at bit 0 of a payload: the first segments staged, the
// reservoir filled.
INFL_HD void infl_in_start(InflIn* in, uint32_t* in_ring,
                           const uint32_t* words, uint32_t n, int lane,
                           int nlanes) {
  for (uint32_t sg = 0; sg < INFL_NSEG; ++sg)
    infl_stage(in_ring, words, n, sg, lane, nlanes);
  infl_wait_segments(INFL_NSEG - 2);
  in->base = 0;
  in->ready = 1;
  in->bb = (uint64_t)in_ring[0] | ((uint64_t)in_ring[1] << 32);
  in->nb = 64;
  in->w = 2;
  in->p = 0;
  infl_advance(in, in_ring, words, n, lane, nlanes);
}

// Drop k bits (k <= nb, k < 64) of the reservoir.
INFL_HD void infl_drop(InflIn* in, uint32_t k) {
  in->bb >>= k;
  in->nb -= k;
  in->p += k;
}

// Top the reservoir up to at least 33 bits with word w, staging and
// landing what that takes (the slow paths: headers, code lengths).
INFL_HD void infl_fill(InflIn* in, uint32_t* in_ring, const uint32_t* words,
                       uint32_t n, int lane, int nlanes) {
  if (in->nb > 32) return;
  in->bb |= (uint64_t)in_ring[in->w % INFL_IN_WORDS] << in->nb;
  in->nb += 32;
  ++in->w;
  infl_advance(in, in_ring, words, n, lane, nlanes);
}

// Move the reader to bit p (past a stored block), the reservoir filled.
INFL_HD void infl_seek(InflIn* in, uint32_t p, uint32_t* in_ring,
                       const uint32_t* words, uint32_t n, int lane,
                       int nlanes) {
  in->w = p >> 5;
  infl_advance(in, in_ring, words, n, lane, nlanes);
  const uint32_t o = p & 31u;
  in->bb = (uint64_t)(in_ring[in->w % INFL_IN_WORDS] >> o);
  in->nb = 32u - o;
  in->p = p;
  ++in->w;
  infl_advance(in, in_ring, words, n, lane, nlanes);
  infl_fill(in, in_ring, words, n, lane, nlanes);
}

INFL_HD uint32_t infl_byte(const uint8_t* bytes, uint32_t n, uint32_t q) {
  return q < n ? bytes[q] : 0u;
}

// The lookup entry of the k-bit window v: the shortest length l <= k whose
// canonical range holds the window's first l bits (taken MSB-first).
INFL_HD uint32_t infl_entry(const InflCode* c, const uint16_t* order,
                            uint32_t v, int k) {
  const uint32_t rev = infl_brev(v, k);
  for (int l = 1; l <= k; ++l) {
    const int32_t off = (int32_t)(rev >> (k - l)) - c->first[l];
    if (off >= 0 && off < c->cnt[l])
      return ((uint32_t)l << 9) | order[c->base[l] + off];
  }
  return 0u;
}

// Build the code of nsym lengths (0: unused) and its k-bit lookup.  Lane 0
// counts and orders the symbols; then lane `lane` of `nlanes` fills the
// entries v with v % nlanes == lane.
INFL_HD void infl_build(const uint8_t* lens, int nsym, InflCode* c,
                        uint16_t* order, uint16_t* tab, int k, int lane,
                        int nlanes) {
  if (lane == 0) {
    for (int l = 0; l <= INFL_MAXBITS; ++l) c->cnt[l] = 0;
    for (int s = 0; s < nsym; ++s)
      if (lens[s]) ++c->cnt[lens[s]];
    int32_t code = 0, b = 0;
    c->first[0] = c->base[0] = 0;
    for (int l = 1; l <= INFL_MAXBITS; ++l) {
      code = (code + (l > 1 ? c->cnt[l - 1] : 0)) << 1;
      c->first[l] = code;
      c->base[l] = b;
      b += c->cnt[l];
    }
    int32_t next[INFL_MAXBITS + 1];
    for (int l = 0; l <= INFL_MAXBITS; ++l) next[l] = c->base[l];
    for (int s = 0; s < nsym; ++s)
      if (lens[s]) order[next[lens[s]]++] = (uint16_t)s;
  }
  INFL_SYNC();
  for (int v = lane; v < (1 << k); v += nlanes)
    tab[v] = (uint16_t)infl_entry(c, order, (uint32_t)v, k);
  INFL_SYNC();
}

// Decode the code at the window w (the stream's next bits, LSB-first):
// (length << 9) | symbol, or 0 where no length up to 15 holds it.
INFL_HD uint32_t infl_decode(const uint16_t* tab, int k, const InflCode* c,
                             const uint16_t* order, uint32_t w) {
  const uint32_t e = tab[w & ((1u << k) - 1u)];
  if (e) return e;
  uint32_t code = infl_brev(w & ((1u << k) - 1u), k);
  for (int l = k + 1; l <= INFL_MAXBITS; ++l) {
    code = (code << 1) | ((w >> (l - 1)) & 1u);
    const int32_t off = (int32_t)code - c->first[l];
    if (off >= 0 && off < c->cnt[l])
      return ((uint32_t)l << 9) | order[c->base[l] + off];
  }
  return 0u;
}

// The fixed code's lengths (RFC 1951 section 3.2.6): 288 literal/length
// and 32 distance codes.
INFL_HD void infl_fixed_lens(uint8_t* lens, int lane, int nlanes) {
  for (int s = lane; s < INFL_NLENS; s += nlanes)
    lens[s] = s < 144 ? 8 : s < 256 ? 9 : s < 280 ? 7 : s < 288 ? 8 : 5;
  INFL_SYNC();
}

// Build the literal/length and distance codes from t->lens: nlit then
// ndist lengths.
INFL_HD void infl_build_block(InflTables* t, int nlit, int ndist, int lane,
                              int nlanes) {
  // lengths past nlit (up to 288) and past ndist (up to 32) are 0: the
  // distance lengths move to their own row first
  uint8_t* d = t->lens + 288;
  if (lane == 0) {
    uint8_t tmp[32];
    for (int i = 0; i < 32; ++i) tmp[i] = i < ndist ? t->lens[nlit + i] : 0;
    for (int i = nlit; i < 288; ++i) t->lens[i] = 0;
    for (int i = 0; i < 32; ++i) d[i] = tmp[i];
  }
  INFL_SYNC();
  infl_build(t->lens, 288, &t->lit_c, t->lit_order, t->lit, INFL_LIT_BITS,
             lane, nlanes);
  infl_build(d, 32, &t->dst_c, t->dst_order, t->dst, INFL_DST_BITS, lane,
             nlanes);
}

// Copy `len` bytes at output position pos from max(q - dist, 0) for each
// q, in the output window `win`.  Lanes copy in parallel where the source
// lies wholly before pos (where a ring slot written may be another lane's
// source, dist + len past the ring, every lane loads before any stores);
// else lane 0 copies byte by byte the match that reaches before the
// output's start (JAX's clamp).  Positions at or past `cap` are not
// written to a slot, nor, by the clamp, to the ring.
template <bool RING>
INFL_HD void infl_match(uint8_t* win, uint32_t cap, uint32_t pos,
                        uint32_t len, uint32_t dist, int lane, int nlanes) {
  INFL_SYNC();  // the bytes before pos, written by any lane, are visible
  if (pos >= dist) {
    const uint32_t src = pos - dist;
    const bool wraps = RING && dist + len > INFL_RING;
    // i % dist for i < len <= 258 by a float reciprocal, corrected once
    // (an overlapping match only: the rest read i)
    float rcp = 0.0f;
    if (dist < len) rcp = 1.0f / (float)dist;
    for (uint32_t i0 = 0; i0 < len; i0 += (uint32_t)nlanes) {
      const uint32_t i = i0 + (uint32_t)lane;
      uint32_t k = i;
      if (k >= dist) {
        k = i - (uint32_t)((float)i * rcp) * dist;
        if ((int32_t)k < 0) k += dist;
        if (k >= dist) k -= dist;
      }
      const bool put = i < len && (RING || pos + i < cap);
      uint8_t v = 0;
      if (put) v = win[infl_at<RING>(src + k)];
      if (wraps) INFL_SYNC();
      if (put) win[infl_at<RING>(pos + i)] = v;
    }
  } else if (lane == 0) {
    // pos < dist <= 32,768: a ring has not wrapped before pos, so slot 0
    // is byte 0 until position 32,768, which reads it first
    for (uint32_t i = 0; i < len; ++i) {
      const uint32_t q = pos + i;
      if (q >= cap) break;
      win[infl_at<RING>(q)] =
          q == 0 ? (uint8_t)(dist - 1u) : win[q >= dist ? q - dist : 0u];
    }
  }
}

// 16 bytes from src to dst, both 16-byte aligned.
INFL_HD void infl_copy16(uint8_t* dst, const uint8_t* src) {
#if defined(__CUDA_ARCH__)
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
#else
  memcpy(dst, src, 16);
#endif
}

// Output positions [lo, min(hi, cap)) from the ring to out, lo a multiple
// of 16: 16-byte stores across the lanes where out + lo is 16-byte
// aligned, bytes for the rest.
INFL_HD void infl_flush(const uint8_t* ring, uint8_t* out, uint32_t lo,
                        uint32_t hi, uint32_t cap, int lane, int nlanes) {
  if (hi > cap) hi = cap;
  if (lo >= hi) return;
  INFL_SYNC();  // the ring's bytes, written by any lane, are visible
  uint32_t vend = lo;
  if (((uintptr_t)(out + lo) & 15u) == 0) {
    vend = lo + ((hi - lo) & ~15u);
    for (uint32_t a = lo + 16u * (uint32_t)lane; a < vend;
         a += 16u * (uint32_t)nlanes)
      infl_copy16(out + a, ring + (a & INFL_RING_MASK));
  }
  for (uint32_t a = vend + (uint32_t)lane; a < hi; a += (uint32_t)nlanes)
    out[a] = ring[a & INFL_RING_MASK];
}

// Decode one member: its payload (`words`, 4-byte aligned, `n` bytes) into
// out[0 .. cap), cap <= INFL_OUT_MAX, with the shared memory `sm` and,
// where RING, the output ring `ring` (INFL_RING bytes, 16-byte aligned;
// else unused).  Every lane runs the same decode (the branches are
// uniform); the writes are split across lanes.  Returns the same result
// on every lane.
template <bool RING>
INFL_HD InflResult infl_member(const uint32_t* words, uint32_t n, uint8_t* out,
                               uint32_t cap, uint8_t* ring, InflSmem* sm,
                               int lane, int nlanes) {
  enum { HDR, LENS, STORED, SYM, BUILD, DONE };
  const uint8_t* bytes = reinterpret_cast<const uint8_t*>(words);
  InflTables* t = &sm->t;
  uint8_t* win = RING ? ring : out;  // the window matches copy from
  uint32_t* in_ring = sm->in;
  const uint32_t end_bits = 8u * n;
  InflResult r = {INFL_OK, 0, 0, 0};
  InflIn in;
  infl_in_start(&in, in_ring, words, n, lane, nlanes);
  uint32_t step = 0, pos = 0, tokens = 0, flushed = 0;
  uint32_t stored_off = 0, stored_rem = 0;
  int phase = HDR, bfinal = 0, nlit = 0, ndist = 0, nlens = 0, filled = 0;
  int last = 0;  // the last code length a non-16 code-length symbol gave
  for (;;) {
    if (phase == SYM) {
      // The literal and length steps, a step a pass; a step that is not
      // one (the caps or the payload's end reached, end of block, a code
      // with no entry, symbol 286 or 287) leaves the loop at its start,
      // having changed nothing, and runs below.
      bool stop = false;
      for (;;) {
        // a run of literals, a step each, whose steps need nothing more: the
        // code in the lookup, 33 bits left in the reservoir after it, no
        // flush due, the caps and the payload's end not reached; it leaves
        // with the lookup of the next step's code in le
        uint32_t le;
        for (;;) {
          le = t->lit[(uint32_t)in.bb & ((1u << INFL_LIT_BITS) - 1u)];
          const uint32_t lb = le >> 9;
          if (le == 0 || (le & 511u) >= 256u || in.nb - lb <= 32u ||
              step >= INFL_STEP_CAP || in.p > end_bits ||
              tokens + 1u >= INFL_MAX_TOK ||
              (RING && ((pos + 1u) & (uint32_t)(INFL_FLUSH - 1)) == 0))
            break;
          if (RING || pos < cap)
            win[infl_at<RING>(pos)] = (uint8_t)le;  // every lane, one byte
          ++pos;
          ++tokens;
          ++step;
          infl_drop(&in, lb);
        }
        if (step >= INFL_STEP_CAP || in.p > end_bits) break;
        const uint32_t wa = in_ring[in.w % INFL_IN_WORDS];
        const uint32_t wb = in_ring[(in.w + 1) % INFL_IN_WORDS];
        if (le == 0)  // a code past the lookup's 10 bits
          le = infl_decode(t->lit, INFL_LIT_BITS, &t->lit_c, t->lit_order,
                           (uint32_t)in.bb);
        const uint32_t ls = le & 511u;
        if (le == 0 || ls == 256 || ls >= 286) break;
        const uint32_t lb = le >> 9;
        uint32_t took = 0;
        if (ls < 256) {
          if (RING || pos < cap)
            win[infl_at<RING>(pos)] = (uint8_t)ls;  // every lane, one byte
          ++pos;
          ++tokens;
          infl_drop(&in, lb);
        } else {
          const uint32_t lc = ls - 257u, lx = infl_length_extra(lc);
          const uint32_t length =
              infl_length_base(lc) +
              ((uint32_t)(in.bb >> lb) & ((1u << lx) - 1u));
          infl_drop(&in, lb + lx);
          if (in.nb <= 32) {
            in.bb |= (uint64_t)wa << in.nb;
            in.nb += 32;
            took = 1;
          }
          const uint32_t de = infl_decode(t->dst, INFL_DST_BITS, &t->dst_c,
                                          t->dst_order, (uint32_t)in.bb);
          if (de == 0) {
            r.err = INFL_E_DIST;
            stop = true;
            break;
          }
          const uint32_t db = de >> 9, ds = de & 31u,
                         dx = infl_dist_extra(ds);
          const uint32_t dist =
              infl_dist_base(ds) +
              ((uint32_t)(in.bb >> db) & ((1u << dx) - 1u));
          infl_drop(&in, db + dx);
          ++tokens;
          if (ds >= 30) {
            if (RING || pos < cap) win[infl_at<RING>(pos)] = 0xFFu;
            ++pos;
          } else {
            infl_match<RING>(win, cap, pos, length, dist, lane, nlanes);
            pos += length;
          }
        }
        if (in.nb <= 32) {
          in.bb |= (uint64_t)(took ? wb : wa) << in.nb;
          in.nb += 32;
          ++took;
        }
        if (took) {
          in.w += took;
          if (in.w / INFL_SEG != in.base || (in.w + 1) / INFL_SEG > in.ready)
            infl_advance(&in, in_ring, words, n, lane, nlanes);
        }
        if (RING && (pos & ~(uint32_t)(INFL_FLUSH - 1)) > flushed) {
          const uint32_t to = pos & ~(uint32_t)(INFL_FLUSH - 1);
          infl_flush(ring, out, flushed, to, cap, lane, nlanes);
          flushed = to;
        }
        if (tokens >= INFL_MAX_TOK) {
          r.err = INFL_E_TOKENS;
          stop = true;
          break;
        }
        ++step;
      }
      if (stop) break;
    }
    if (step >= INFL_STEP_CAP) {
      r.err = INFL_E_STEPS;
      break;
    }
    if (in.p > end_bits) {
      r.err = INFL_E_OVERRUN;
      break;
    }
    if (phase == HDR) {
      bfinal = (int)(in.bb & 1u);
      const uint32_t btype = (uint32_t)(in.bb >> 1) & 3u;
      if (btype == 3) {
        r.err = INFL_E_BTYPE;
        break;
      }
      infl_drop(&in, 3u);
      if (btype == 0) {
        // LEN at the next byte boundary; NLEN is not checked
        infl_drop(&in, (8u - (in.p & 7u)) & 7u);
        infl_fill(&in, in_ring, words, n, lane, nlanes);
        stored_rem = (uint32_t)in.bb & 0xFFFFu;
        stored_off = (in.p + 32u) >> 3;
        in.p += 32u;  // the reservoir seeks past the block at its end
        phase = STORED;
      } else if (btype == 1) {
        infl_fixed_lens(t->lens, lane, nlanes);
        infl_fill(&in, in_ring, words, n, lane, nlanes);
        nlit = 288;
        ndist = 32;
        phase = BUILD;
      } else {
        nlit = (int)(in.bb & 31u) + 257;
        ndist = (int)((in.bb >> 5) & 31u) + 1;
        const int hclen4 = (int)((in.bb >> 10) & 15u) + 4;
        infl_drop(&in, 14u);
        // the precode's lengths, in the order of RFC 1951 section 3.2.7
        const uint8_t perm[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                  11, 4,  12, 3, 13, 2, 14, 1, 15};
        uint8_t plens[19];
        for (int j = 0; j < 19; ++j) plens[j] = 0;
        for (int j = 0; j < hclen4; ++j) {
          infl_fill(&in, in_ring, words, n, lane, nlanes);
          plens[perm[j]] = (uint8_t)(in.bb & 7u);
          infl_drop(&in, 3u);
        }
        if (lane == 0)
          for (int j = 0; j < 19; ++j) t->lens[j] = plens[j];
        INFL_SYNC();
        infl_build(t->lens, 19, &t->pre_c, t->pre_order, t->pre,
                   INFL_PRE_BITS, lane, nlanes);
        if (lane == 0)
          for (int i = 0; i < INFL_NLENS; ++i) t->lens[i] = 0;
        INFL_SYNC();
        infl_fill(&in, in_ring, words, n, lane, nlanes);
        nlens = nlit + ndist;
        filled = 0;
        last = 0;
        phase = LENS;
      }
    }
    if (phase == LENS) {
      // one code-length symbol (a step of its own, or the dynamic
      // header's step's last item)
      const uint64_t w = in.bb;
      const uint32_t pe = t->pre[w & ((1u << INFL_PRE_BITS) - 1u)];
      if (pe == 0) {
        r.err = INFL_E_PRECODE;
        break;
      }
      const uint32_t bits = pe >> 9, sym = pe & 511u;
      const uint32_t after = (uint32_t)(w >> bits);
      uint32_t rep = 1, extra = 0;
      int val = (int)sym;
      if (sym == 16) {
        rep = 3u + (after & 3u);
        extra = 2;
        val = last;
      } else if (sym == 17) {
        rep = 3u + (after & 7u);
        extra = 3;
        val = 0;
      } else if (sym == 18) {
        rep = 11u + (after & 127u);
        extra = 7;
        val = 0;
      }
      if (sym != 16) last = val;
      if (lane == 0)
        for (uint32_t i = 0; i < rep; ++i)
          if (filled + (int)i < nlens) t->lens[filled + i] = (uint8_t)val;
      filled += (int)rep;
      infl_drop(&in, bits + extra);
      infl_fill(&in, in_ring, words, n, lane, nlanes);
      if (filled >= nlens) {
        INFL_SYNC();
        phase = BUILD;
      }
    }
    if (phase == STORED) {
      const uint32_t chunk =
          stored_rem < INFL_STORED_CHUNK ? stored_rem : INFL_STORED_CHUNK;
      if (chunk) {
        for (uint32_t i = (uint32_t)lane; i < chunk; i += (uint32_t)nlanes)
          if (RING || pos + i < cap)
            win[infl_at<RING>(pos + i)] =
                (uint8_t)infl_byte(bytes, n, stored_off + i);
        pos += chunk;
        ++tokens;
      }
      stored_off += chunk;
      stored_rem -= chunk;
      in.p += chunk << 3;
      if (stored_rem == 0) {
        phase = bfinal ? DONE : HDR;
        if (phase == HDR) infl_seek(&in, in.p, in_ring, words, n, lane, nlanes);
      }
    }
    if (phase == SYM) {
      // what the loop above leaves: end of block, or a symbol in error
      const uint32_t le = infl_decode(t->lit, INFL_LIT_BITS, &t->lit_c,
                                      t->lit_order, (uint32_t)in.bb);
      if (le == 0) {
        r.err = INFL_E_LITLEN;
        break;
      }
      if ((le & 511u) != 256) {
        r.err = INFL_E_SYMBOL;
        break;
      }
      infl_drop(&in, le >> 9);
      infl_fill(&in, in_ring, words, n, lane, nlanes);
      phase = bfinal ? DONE : HDR;
    }
    if (RING && (pos & ~(uint32_t)(INFL_FLUSH - 1)) > flushed) {
      const uint32_t to = pos & ~(uint32_t)(INFL_FLUSH - 1);
      infl_flush(ring, out, flushed, to, cap, lane, nlanes);
      flushed = to;
    }
    if (tokens >= INFL_MAX_TOK) {
      r.err = INFL_E_TOKENS;
      break;
    }
    if (phase == DONE) {
      ++step;
      break;
    }
    if (phase == BUILD) {
      // the build runs between chunks: the member's next step is the
      // first of the next chunk
      step = (step / INFL_STEPS_A_CHUNK + 1u) * INFL_STEPS_A_CHUNK;
      if (step >= INFL_STEP_CAP) {
        r.err = INFL_E_STEPS;
        break;
      }
      infl_build_block(t, nlit, ndist, lane, nlanes);
      phase = SYM;
    } else {
      ++step;
    }
  }
  if (RING) infl_flush(ring, out, flushed, pos, cap, lane, nlanes);
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
  INFL_SYNC();
  r.produced = (int32_t)pos;
  r.tokens = (int32_t)tokens;
  r.steps = (int32_t)step;
  return r;
}
