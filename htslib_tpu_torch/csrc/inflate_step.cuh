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
#pragma once

#include <stdint.h>

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

// The 64 bits of the stream from bit p on (LSB-first); 0 past the end.
INFL_HD uint64_t infl_peek(const uint32_t* words, uint32_t n, uint32_t p) {
  const uint32_t w = p >> 5, o = p & 31u;
  const uint64_t a = ((uint64_t)infl_word(words, n, w + 1) << 32) |
                     infl_word(words, n, w);
  if (o == 0) return a;
  return (a >> o) | ((uint64_t)infl_word(words, n, w + 2) << (64 - o));
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

// Copy `len` bytes at output position pos from max(q - dist, 0) for each q,
// positions at or past `cap` not written.  Lanes copy in parallel where
// the source lies wholly before pos; else lane 0 copies byte by byte.
INFL_HD void infl_match(uint8_t* out, uint32_t cap, uint32_t pos,
                        uint32_t len, uint32_t dist, int lane, int nlanes) {
  INFL_SYNC();  // the bytes before pos, written by any lane, are visible
  if (pos >= dist) {
    const uint32_t src = pos - dist;
    for (uint32_t i = (uint32_t)lane; i < len; i += (uint32_t)nlanes) {
      const uint32_t q = pos + i;
      if (q < cap) out[q] = out[src + i % dist];
    }
  } else if (lane == 0) {
    for (uint32_t i = 0; i < len; ++i) {
      const uint32_t q = pos + i;
      if (q >= cap) break;
      out[q] = q == 0 ? (uint8_t)(dist - 1u)
                      : out[q >= dist ? q - dist : 0u];
    }
  }
}

// Decode one member: its payload (`words`, 4-byte aligned, `n` bytes) into
// out[0 .. cap), cap <= INFL_OUT_MAX, with the tables `t`.  Every lane runs
// the same decode (the branches are uniform); the writes are split across
// lanes.  Returns the same result on every lane.
INFL_HD InflResult infl_member(const uint32_t* words, uint32_t n, uint8_t* out,
                               uint32_t cap, InflTables* t, int lane,
                               int nlanes) {
  enum { HDR, LENS, STORED, SYM, BUILD, DONE };
  const uint8_t* bytes = reinterpret_cast<const uint8_t*>(words);
  const uint32_t end_bits = 8u * n;
  InflResult r = {INFL_OK, 0, 0, 0};
  uint32_t p = 0, step = 0, pos = 0, tokens = 0;
  uint32_t stored_off = 0, stored_rem = 0;
  int phase = HDR, bfinal = 0, nlit = 0, ndist = 0, nlens = 0, filled = 0;
  int last = 0;  // the last code length a non-16 code-length symbol gave
  for (;;) {
    if (step >= INFL_STEP_CAP) {
      r.err = INFL_E_STEPS;
      break;
    }
    if (p > end_bits) {
      r.err = INFL_E_OVERRUN;
      break;
    }
    if (phase == HDR) {
      const uint64_t w = infl_peek(words, n, p);
      bfinal = (int)(w & 1u);
      const uint32_t btype = (uint32_t)(w >> 1) & 3u;
      if (btype == 3) {
        r.err = INFL_E_BTYPE;
        break;
      }
      if (btype == 0) {
        const uint32_t pb = (p + 3u + 7u) & ~7u;
        stored_rem = (uint32_t)infl_peek(words, n, pb) & 0xFFFFu;
        stored_off = (pb + 32u) >> 3;
        p = pb + 32u;
        phase = STORED;
      } else if (btype == 1) {
        p += 3u;
        infl_fixed_lens(t->lens, lane, nlanes);
        nlit = 288;
        ndist = 32;
        phase = BUILD;
      } else {
        nlit = (int)((w >> 3) & 31u) + 257;
        ndist = (int)((w >> 8) & 31u) + 1;
        const int hclen4 = (int)((w >> 13) & 15u) + 4;
        p += 17u;
        // the precode's lengths, in the order of RFC 1951 section 3.2.7
        const uint64_t pw = infl_peek(words, n, p);
        const uint8_t perm[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                  11, 4,  12, 3, 13, 2, 14, 1, 15};
        if (lane == 0) {
          uint8_t plens[19];
          for (int j = 0; j < 19; ++j) plens[j] = 0;
          for (int j = 0; j < hclen4; ++j)
            plens[perm[j]] = (uint8_t)((pw >> (3 * j)) & 7u);
          for (int j = 0; j < 19; ++j) t->lens[j] = plens[j];
        }
        INFL_SYNC();
        infl_build(t->lens, 19, &t->pre_c, t->pre_order, t->pre,
                   INFL_PRE_BITS, lane, nlanes);
        p += 3u * (uint32_t)hclen4;
        if (lane == 0)
          for (int i = 0; i < INFL_NLENS; ++i) t->lens[i] = 0;
        INFL_SYNC();
        nlens = nlit + ndist;
        filled = 0;
        last = 0;
        phase = LENS;
      }
    }
    if (phase == LENS) {
      // one code-length symbol (a step of its own, or the dynamic
      // header's step's last item)
      const uint64_t w = infl_peek(words, n, p);
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
      p += bits + extra;
      if (filled >= nlens) {
        INFL_SYNC();
        phase = BUILD;
      }
    }
    if (phase == STORED) {
      const uint32_t chunk =
          stored_rem < INFL_STORED_CHUNK ? stored_rem : INFL_STORED_CHUNK;
      if (chunk) {
        for (uint32_t i = (uint32_t)lane; i < chunk; i += (uint32_t)nlanes) {
          const uint32_t q = pos + i;
          if (q < cap) out[q] = (uint8_t)infl_byte(bytes, n, stored_off + i);
        }
        pos += chunk;
        ++tokens;
      }
      stored_off += chunk;
      stored_rem -= chunk;
      p += chunk << 3;
      if (stored_rem == 0) phase = bfinal ? DONE : HDR;
    }
    if (phase == SYM) {
      const uint64_t w = infl_peek(words, n, p);
      const uint32_t le = infl_decode(t->lit, INFL_LIT_BITS, &t->lit_c,
                                      t->lit_order, (uint32_t)w);
      if (le == 0) {
        r.err = INFL_E_LITLEN;
        break;
      }
      const uint32_t lb = le >> 9, ls = le & 511u;
      if (ls < 256) {
        if (lane == 0 && pos < cap) out[pos] = (uint8_t)ls;
        ++pos;
        ++tokens;
        p += lb;
      } else if (ls == 256) {
        p += lb;
        phase = bfinal ? DONE : HDR;
      } else if (ls >= 286) {
        r.err = INFL_E_SYMBOL;
        break;
      } else {
        const uint32_t lc = ls - 257u, lx = infl_length_extra(lc);
        const uint32_t length =
            infl_length_base(lc) + ((uint32_t)(w >> lb) & ((1u << lx) - 1u));
        const uint32_t at = lb + lx;
        const uint32_t de = infl_decode(t->dst, INFL_DST_BITS, &t->dst_c,
                                        t->dst_order, (uint32_t)(w >> at));
        if (de == 0) {
          r.err = INFL_E_DIST;
          break;
        }
        const uint32_t db = de >> 9, ds = de & 31u, dx = infl_dist_extra(ds);
        const uint32_t dist =
            infl_dist_base(ds) +
            ((uint32_t)(w >> (at + db)) & ((1u << dx) - 1u));
        p += at + db + dx;
        ++tokens;
        if (ds >= 30) {
          // JAX's token for distance 0 reads as one literal byte 0xFF
          if (lane == 0 && pos < cap) out[pos] = 0xFFu;
          ++pos;
        } else {
          infl_match(out, cap, pos, length, dist, lane, nlanes);
          pos += length;
        }
      }
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
  INFL_SYNC();
  r.produced = (int32_t)pos;
  r.tokens = (int32_t)tokens;
  r.steps = (int32_t)step;
  return r;
}
