/* rANS Nx16 codec — the CRAM 3.1 entropy coder (reference call sites
 * cram/cram_io.c:1699,1859; the htscodecs submodule holding the original
 * is an EMPTY directory in this snapshot).
 *
 * Wire format (project-wide definition, followed byte-for-byte by the
 * Python mirror htslib_tpu/codecs/rans4x16.py — the two implementations
 * are cross-validated in tests/test_rans4x16.py):
 *
 *   byte  flags: 0x01 ORDER1, 0x04 X32 (32-way interleave), 0x08 STRIPE,
 *                0x10 NOSZ, 0x20 CAT, 0x40 RLE, 0x80 PACK
 *   [u7 ulen]            unless NOSZ
 *   CAT:    raw bytes
 *   STRIPE: byte N=4; N x u7 clen; N substreams (flags&(O1|X32)|NOSZ),
 *           substream j holding bytes j, j+N, ...
 *   PACK:   byte P, P symbols, u7 packed_len   (P<=16; 1/2/4-bit LSB-first)
 *   RLE:    u7 meta_len, meta(= byte L, L syms [absent when L=0 meaning
 *           all 256], then u7 run-1 per literal of an RLE symbol),
 *           u7 lit_len
 *   core:   order-0: freq table (run-coded alphabet, 0 terminator, u7
 *           freqs normalised to 4096) then N interleaved 16-bit-renorm
 *           rANS states (u32le heads, byte-reversed emission);
 *           order-1: u7 table_len, context alphabet + per-context freq
 *           tables; stream split into N contiguous segments, one state
 *           per segment, context = previous byte (0 at segment heads).
 */
#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include "rANS_static4x16.h"
#include "rANS_static16_int.h"
#include "varint.h"

#define TF_SHIFT 12
#define TOTFREQ (1u << TF_SHIFT)
#define R4X16_L (1u << 15)

/* SIMD tier dispatch: AVX2 -> SSE4.1 -> scalar.  RANS32X16_TIER
 * (avx2|sse4|scalar) caps the tier for testing, so the SSE4 cores get
 * exercised on AVX2 hosts (tests/test_codecs31.py). */
static int tier_cap(void) {
    const char *e = getenv("RANS32X16_TIER");   /* re-read: tests flip it */
    if (e) {
        if (!strcmp(e, "scalar")) return 0;
        if (!strcmp(e, "sse4")) return 1;
    }
    return 2;
}

/* ---- uint7 adapters over varint.h ---- */
static int u7_put(uint8_t *tmp, uint64_t v) {
    return var_put_u64(tmp, NULL, v);
}
static int u7_get(const uint8_t *buf, uint64_t len, uint64_t *p,
                  uint32_t *v) {
    if (*p >= len) return -1;
    int n = var_get_u32((uint8_t *)buf + *p, (uint8_t *)buf + len, v);
    if (n <= 0) return -1;
    *p += (uint64_t)n;
    return 0;
}

/* ---- dynamic buffer ---- */
typedef struct { uint8_t *d; size_t len, cap; } rbuf_t;

static int rb_need(rbuf_t *b, size_t n) {
    if (b->len + n <= b->cap) return 0;
    size_t nc = b->cap ? b->cap * 2 : 4096;
    while (nc < b->len + n) nc *= 2;
    uint8_t *nd = (uint8_t *)realloc(b->d, nc);
    if (!nd) return -1;
    b->d = nd; b->cap = nc;
    return 0;
}
static int rb_put(rbuf_t *b, const void *p, size_t n) {
    if (rb_need(b, n)) return -1;
    memcpy(b->d + b->len, p, n);
    b->len += n;
    return 0;
}
static int rb_putc(rbuf_t *b, uint8_t c) { return rb_put(b, &c, 1); }
static int rb_putu7(rbuf_t *b, uint64_t v) {
    uint8_t tmp[10];
    int n = u7_put(tmp, v);
    return rb_put(b, tmp, n);
}

/* ---- run-coded symbol alphabet (ascending) ---- */
static void wr_alphabet(rbuf_t *b, const int *syms, int n) {
    int i = 0;
    while (i < n) {
        rb_putc(b, (uint8_t)syms[i]);
        if (i > 0 && syms[i] == syms[i - 1] + 1) {
            int run = 0;
            while (i + run + 1 < n && syms[i + run + 1] == syms[i + run] + 1
                   && run < 255)
                run++;
            rb_putc(b, (uint8_t)run);
            i += run + 1;
        } else {
            i++;
        }
    }
}

static int rd_alphabet(const uint8_t *buf, uint64_t len, uint64_t *p,
                       int *syms /*256*/) {
    int n = 0, last = -2;
    for (;;) {
        if (n == 0) {
            if (*p >= len) return -1;
            int s = buf[(*p)++];
            syms[n++] = s;
            last = s;
            continue;
        }
        if (*p >= len) return -1;
        int s = buf[(*p)++];
        if (s == 0 && last != -1)
            break;
        if (n >= 256) return -1;
        syms[n++] = s;
        if (s == last + 1) {
            if (*p >= len) return -1;
            int run = buf[(*p)++];
            while (run-- > 0) {
                if (n >= 256) return -1;
                syms[n] = syms[n - 1] + 1;
                n++;
            }
        }
        last = syms[n - 1];
    }
    return n;
}

/* normalise counts to sum TOTFREQ; mirrors the float math of the Python
 * _norm_freqs exactly (double truncation, drift onto first argmax) */
static int norm_freqs(const int64_t *counts, int64_t *f, int64_t total) {
    int64_t n = 0;
    int i;
    for (i = 0; i < 256; i++) n += counts[i];
    if (n == 0) { memset(f, 0, 256 * sizeof(*f)); return 0; }
    for (i = 0; i < 256; i++)
        f[i] = (int64_t)((double)counts[i] * (double)total / (double)n);
    for (i = 0; i < 256; i++)
        if (counts[i] > 0 && f[i] == 0) f[i] = 1;
    int64_t sum = 0;
    for (i = 0; i < 256; i++) sum += f[i];
    int am = 0;
    for (i = 1; i < 256; i++) if (f[i] > f[am]) am = i;
    f[am] += total - sum;
    int amc = 0;
    for (i = 1; i < 256; i++) if (counts[i] > counts[amc]) amc = i;
    if (f[amc] <= 0) return -1;
    return 0;
}

static void wr_freq_table(rbuf_t *b, const int64_t *f) {
    int syms[256], n = 0, i;
    for (i = 0; i < 256; i++) if (f[i]) syms[n++] = i;
    wr_alphabet(b, syms, n);
    rb_putc(b, 0);
    for (i = 0; i < n; i++) rb_putu7(b, (uint64_t)f[syms[i]]);
}

static int rd_freq_table(const uint8_t *buf, uint64_t len, uint64_t *p,
                         int64_t *f) {
    int syms[256];
    int n = rd_alphabet(buf, len, p, syms), i;
    if (n < 0) return -1;
    memset(f, 0, 256 * sizeof(*f));
    for (i = 0; i < n; i++) {
        uint32_t v;
        if (u7_get(buf, len, p, &v) < 0) return -1;
        f[syms[i]] = v;
    }
    return 0;
}

/* ---- order-0 core ---- */
static int enc_core_o0(const uint8_t *in, int64_t n, const int64_t *f,
                       const int64_t *cum, int nway, rbuf_t *out) {
    uint32_t st[32];
    int j;
    for (j = 0; j < nway; j++) st[j] = R4X16_L;
    rbuf_t body = {0, 0, 0};
    int64_t i;
    for (i = n - 1; i >= 0; i--) {
        j = (int)(i % nway);
        int s = in[i];
        uint32_t x = st[j];
        uint32_t freq = (uint32_t)f[s];
        uint32_t x_max = ((R4X16_L >> TF_SHIFT) << 16) * freq;
        while (x >= x_max) {
            if (rb_putc(&body, (x >> 8) & 0xFF) || rb_putc(&body, x & 0xFF))
                { free(body.d); return -1; }
            x >>= 16;
        }
        st[j] = ((x / freq) << TF_SHIFT) + (x % freq) + (uint32_t)cum[s];
    }
    for (j = 0; j < nway; j++) {
        uint8_t h[4] = { (uint8_t)st[j], (uint8_t)(st[j] >> 8),
                         (uint8_t)(st[j] >> 16), (uint8_t)(st[j] >> 24) };
        if (rb_put(out, h, 4)) { free(body.d); return -1; }
    }
    if (rb_need(out, body.len)) { free(body.d); return -1; }
    for (i = (int64_t)body.len - 1; i >= 0; i--)
        out->d[out->len++] = body.d[i];
    free(body.d);
    return 0;
}

static int dec_core_o0(const uint8_t *buf, uint64_t len, uint64_t *p,
                       int64_t n_out, const int64_t *f, const int64_t *cum,
                       int nway, uint8_t *out) {
    uint8_t sym_of[TOTFREQ];
    int s, j;
    memset(sym_of, 0, sizeof sym_of);
    for (s = 0; s < 256; s++)
        if (f[s]) {
            int64_t c = cum[s], e = cum[s] + f[s];
            if (c < 0 || e > TOTFREQ) return -1;
            memset(sym_of + c, s, (size_t)(e - c));
        }
    uint32_t st[32];
    for (j = 0; j < nway; j++) {
        if (*p + 4 > len) return -1;
        st[j] = (uint32_t)buf[*p] | ((uint32_t)buf[*p + 1] << 8)
              | ((uint32_t)buf[*p + 2] << 16) | ((uint32_t)buf[*p + 3] << 24);
        *p += 4;
    }
    int64_t i;
    for (i = 0; i < n_out; i++) {
        j = (int)(i % nway);
        uint32_t x = st[j];
        uint32_t m = x & (TOTFREQ - 1);
        s = sym_of[m];
        out[i] = (uint8_t)s;
        x = (uint32_t)f[s] * (x >> TF_SHIFT) + m - (uint32_t)cum[s];
        while (x < R4X16_L) {
            if (*p + 2 > len) break;
            x = (x << 16) | buf[*p] | ((uint32_t)buf[*p + 1] << 8);
            *p += 2;
        }
        st[j] = x;
    }
    return 0;
}

/* ---- order-1 core: floor segments, round-robin renormalisation,
 * last-state tail (matches codecs/rans4x16.py byte-for-byte) ---- */
static int enc_core_o1(const uint8_t *in, int64_t n, int64_t (*F)[256],
                       int64_t (*C)[256], int nway, rbuf_t *out) {
    uint32_t st[32];
    int j;
    for (j = 0; j < nway; j++) st[j] = R4X16_L;
    int64_t seg = n / nway;
    /* decode order: (r, j) round-robin, then tail on state nway-1 */
    int64_t n_order = n;
    int64_t *order = (int64_t *)malloc((size_t)(n_order ? n_order : 1) * 8);
    if (!order) return -1;
    int64_t k = 0, r, t;
    for (r = 0; r < seg; r++)
        for (j = 0; j < nway; j++)
            order[k++] = (int64_t)j * seg + r;
    for (t = (int64_t)nway * seg; t < n; t++)
        order[k++] = t;
    rbuf_t body = {0, 0, 0};
    int64_t oi;
    for (oi = n_order - 1; oi >= 0; oi--) {
        int64_t i = order[oi];
        int jj = seg ? (int)(i / seg) : nway - 1;
        if (jj > nway - 1) jj = nway - 1;
        int head = (seg && i % seg == 0 && i < (int64_t)nway * seg)
                   || (!seg && i == 0);
        int ctx = head ? 0 : in[i - 1];
        int s = in[i];
        uint32_t freq = (uint32_t)F[ctx][s];
        uint32_t x = st[jj];
        uint32_t x_max = ((R4X16_L >> TF_SHIFT) << 16) * freq;
        while (x >= x_max) {
            if (rb_putc(&body, (x >> 8) & 0xFF) || rb_putc(&body, x & 0xFF))
                { free(order); free(body.d); return -1; }
            x >>= 16;
        }
        st[jj] = ((x / freq) << TF_SHIFT) + (x % freq) + (uint32_t)C[ctx][s];
    }
    free(order);
    for (j = 0; j < nway; j++) {
        uint8_t h[4] = { (uint8_t)st[j], (uint8_t)(st[j] >> 8),
                         (uint8_t)(st[j] >> 16), (uint8_t)(st[j] >> 24) };
        if (rb_put(out, h, 4)) { free(body.d); return -1; }
    }
    if (rb_need(out, body.len)) { free(body.d); return -1; }
    for (oi = (int64_t)body.len - 1; oi >= 0; oi--)
        out->d[out->len++] = body.d[oi];
    free(body.d);
    return 0;
}

static int dec_core_o1(const uint8_t *buf, uint64_t len, uint64_t *p,
                       int64_t n_out, int64_t (*F)[256], int64_t (*C)[256],
                       int nway, uint8_t *out) {
    uint8_t *sym_of = (uint8_t *)malloc(256 * TOTFREQ);
    uint8_t built[256];
    if (!sym_of) return -1;
    memset(built, 0, sizeof built);
    uint32_t st[32];
    int j;
    for (j = 0; j < nway; j++) {
        if (*p + 4 > len) { free(sym_of); return -1; }
        st[j] = (uint32_t)buf[*p] | ((uint32_t)buf[*p + 1] << 8)
              | ((uint32_t)buf[*p + 2] << 16) | ((uint32_t)buf[*p + 3] << 24);
        *p += 4;
    }
    int64_t seg = n_out / nway;
    int ctxs[32];
    for (j = 0; j < nway; j++) ctxs[j] = 0;
    int64_t r;
    int64_t i;
#define O1_STEP(jj, idx) do { \
        int ctx = ctxs[jj]; \
        if (!built[ctx]) { \
            int s2; \
            memset(sym_of + ctx * TOTFREQ, 0, TOTFREQ); \
            for (s2 = 0; s2 < 256; s2++) \
                if (F[ctx][s2]) { \
                    int64_t c0 = C[ctx][s2], e0 = C[ctx][s2] + F[ctx][s2]; \
                    if (c0 < 0 || e0 > TOTFREQ) { free(sym_of); return -1; } \
                    memset(sym_of + ctx * TOTFREQ + c0, s2, \
                           (size_t)(e0 - c0)); \
                } \
            built[ctx] = 1; \
        } \
        uint32_t x = st[jj]; \
        uint32_t m = x & (TOTFREQ - 1); \
        int s = sym_of[ctx * TOTFREQ + m]; \
        out[idx] = (uint8_t)s; \
        x = (uint32_t)F[ctx][s] * (x >> TF_SHIFT) + m - (uint32_t)C[ctx][s]; \
        while (x < R4X16_L) { \
            if (*p + 2 > len) break; \
            x = (x << 16) | buf[*p] | ((uint32_t)buf[*p + 1] << 8); \
            *p += 2; \
        } \
        st[jj] = x; \
        ctxs[jj] = s; \
    } while (0)
    for (r = 0; r < seg; r++)
        for (j = 0; j < nway; j++)
            O1_STEP(j, (int64_t)j * seg + r);
    for (i = (int64_t)nway * seg; i < n_out; i++)
        O1_STEP(nway - 1, i);
#undef O1_STEP
    free(sym_of);
    return 0;
}

/* ---- PACK transform ---- */
static int pack_width(int P) {
    return P <= 1 ? 0 : P <= 2 ? 1 : P <= 4 ? 2 : P <= 16 ? 4 : -1;
}

/* ---- RLE transform (encode) ---- */
static int rle_encode(const uint8_t *in, int64_t n, rbuf_t *meta,
                      rbuf_t *lits) {
    int64_t saved[256];
    memset(saved, 0, sizeof saved);
    int64_t i = 0;
    while (i < n) {
        int64_t j2 = i;
        while (j2 < n && in[j2] == in[i]) j2++;
        saved[in[i]] += (j2 - i) - 2;
        i = j2;
    }
    int rle_syms[256], L = 0, s;
    for (s = 0; s < 256; s++) if (saved[s] > 0) rle_syms[L++] = s;
    if (L == 0 && n) { rle_syms[0] = in[0]; L = 1; }
    uint8_t is_rle[256];
    memset(is_rle, 0, sizeof is_rle);
    rb_putc(meta, L == 256 ? 0 : (uint8_t)L);
    if (L != 256)
        for (s = 0; s < L; s++) rb_putc(meta, (uint8_t)rle_syms[s]);
    for (s = 0; s < L; s++) is_rle[rle_syms[s]] = 1;
    i = 0;
    while (i < n) {
        int64_t j2 = i;
        while (j2 < n && in[j2] == in[i]) j2++;
        if (is_rle[in[i]]) {
            rb_putc(lits, in[i]);
            rb_putu7(meta, (uint64_t)(j2 - i - 1));
        } else {
            int64_t k;
            for (k = i; k < j2; k++) rb_putc(lits, in[i]);
        }
        i = j2;
    }
    return 0;
}

static int rle_decode(const uint8_t *meta, uint64_t mlen,
                      const uint8_t *lits, uint64_t llen,
                      uint8_t *out, int64_t n_out) {
    uint64_t mp = 0;
    if (mp >= mlen) return n_out == 0 ? 0 : -1;
    int L = meta[mp++];
    uint8_t is_rle[256];
    if (L == 0) {
        memset(is_rle, 1, sizeof is_rle);
    } else {
        memset(is_rle, 0, sizeof is_rle);
        if (mp + (uint64_t)L > mlen) return -1;
        int s;
        for (s = 0; s < L; s++) is_rle[meta[mp++]] = 1;
    }
    int64_t o = 0;
    uint64_t lp = 0;
    while (lp < llen && o < n_out) {
        uint8_t b = lits[lp++];
        if (is_rle[b]) {
            uint32_t run;
            if (u7_get(meta, mlen, &mp, &run) < 0) return -1;
            int64_t r = (int64_t)run + 1;
            if (r > n_out - o) r = n_out - o;
            memset(out + o, b, (size_t)r);
            o += r;
        } else {
            out[o++] = b;
        }
    }
    return o == n_out ? 0 : -1;
}

/* ---- top level ---- */
static int compress_rec(const uint8_t *in, uint64_t in_size, int flags,
                        rbuf_t *out);

static int stripe_compress(const uint8_t *in, uint64_t in_size, int flags,
                           rbuf_t *out) {
    const int N = 4;
    rbuf_t subs[4] = {{0,0,0},{0,0,0},{0,0,0},{0,0,0}};
    uint8_t *tmp = (uint8_t *)malloc(in_size / N + 2);
    int j, r = 0;
    if (!tmp) return -1;
    rb_putc(out, (uint8_t)N);
    for (j = 0; j < N && !r; j++) {
        uint64_t m = 0, i;
        for (i = j; i < in_size; i += N) tmp[m++] = in[i];
        r = compress_rec(tmp, m,
                         (flags & (1 /*O1*/ | RANS_ORDER_X32))
                         | RANS_ORDER_NOSZ, &subs[j]);
    }
    free(tmp);
    for (j = 0; j < N && !r; j++) r = rb_putu7(out, subs[j].len);
    for (j = 0; j < N && !r; j++) r = rb_put(out, subs[j].d, subs[j].len);
    for (j = 0; j < N; j++) free(subs[j].d);
    return r;
}

static int compress_rec(const uint8_t *in, uint64_t in_size, int flags,
                        rbuf_t *out) {
    if (flags & RANS_ORDER_PACK) {
        int seen[256];
        memset(seen, 0, sizeof seen);
        uint64_t i;
        int P = 0;
        for (i = 0; i < in_size; i++)
            if (!seen[in[i]]) { seen[in[i]] = 1; P++; }
        if (P > 16) flags &= ~RANS_ORDER_PACK;
    }
    if ((flags & RANS_ORDER_RLE) && in_size == 0)
        flags &= ~RANS_ORDER_RLE;
    rb_putc(out, (uint8_t)flags);
    if (!(flags & RANS_ORDER_NOSZ)) rb_putu7(out, in_size);
    if (flags & RANS_ORDER_CAT)
        return rb_put(out, in, in_size);
    if (flags & RANS_ORDER_STRIPE)
        return stripe_compress(in, in_size, flags, out);

    const uint8_t *payload = in;
    uint64_t paylen = in_size;
    uint8_t *pack_buf = NULL, *rle_buf = NULL;
    if (flags & RANS_ORDER_PACK) {
        int syms[16], P = 0, seen[256];
        memset(seen, 0, sizeof seen);
        uint64_t i;
        for (i = 0; i < paylen; i++) seen[payload[i]] = 1;
        int s;
        for (s = 0; s < 256; s++) if (seen[s]) syms[P++] = s;
        rb_putc(out, (uint8_t)P);
        for (s = 0; s < P; s++) rb_putc(out, (uint8_t)syms[s]);
        int w = pack_width(P);
        if (w == 0) {
            rb_putu7(out, 0);
            payload = NULL; paylen = 0;
        } else {
            uint8_t lut[256];
            for (s = 0; s < P; s++) lut[syms[s]] = (uint8_t)s;
            int per = 8 / w;
            uint64_t plen = (paylen + per - 1) / per;
            pack_buf = (uint8_t *)calloc(plen ? plen : 1, 1);
            if (!pack_buf) return -1;
            for (i = 0; i < paylen; i++)
                pack_buf[i / per] |=
                    (uint8_t)(lut[payload[i]] << ((i % per) * w));
            rb_putu7(out, plen);
            payload = pack_buf; paylen = plen;
        }
    }
    if (flags & RANS_ORDER_RLE) {
        rbuf_t meta = {0,0,0}, lits = {0,0,0};
        if (rle_encode(payload, (int64_t)paylen, &meta, &lits)) {
            free(pack_buf); free(meta.d); free(lits.d);
            return -1;
        }
        rb_putu7(out, meta.len);
        rb_put(out, meta.d, meta.len);
        rb_putu7(out, lits.len);
        free(meta.d);
        rle_buf = lits.d;
        payload = lits.d ? lits.d : (const uint8_t *)"";
        paylen = lits.len;
    }
    int nway = (flags & RANS_ORDER_X32) ? 32 : 4;
    int r = 0;
    if (paylen == 0) {
        /* nothing after transforms */
    } else if (flags & 1) {   /* ORDER1 */
        int64_t (*F)[256] = (int64_t (*)[256])calloc(256, 256 * 8);
        int64_t (*Fn)[256] = (int64_t (*)[256])calloc(256, 256 * 8);
        int64_t (*C)[256] = (int64_t (*)[256])calloc(256, 256 * 8);
        if (!F || !Fn || !C) { free(F); free(Fn); free(C); r = -1; goto done; }
        int64_t seg = (int64_t)paylen / nway;
        uint64_t i;
        for (i = 0; i < paylen; i++) {
            int head = (seg && (int64_t)i % seg == 0
                        && (int64_t)i < (int64_t)nway * seg)
                       || (!seg && i == 0);
            int ctx = head ? 0 : payload[i - 1];
            F[ctx][payload[i]]++;
        }
        int ctxs[256], nctx = 0, ctx;
        rbuf_t tab = {0,0,0};
        for (ctx = 0; ctx < 256; ctx++) {
            int64_t sum = 0, s;
            for (s = 0; s < 256; s++) sum += F[ctx][s];
            if (sum) {
                ctxs[nctx++] = ctx;
                if (norm_freqs(F[ctx], Fn[ctx], TOTFREQ)) { r = -1; }
                int64_t cum = 0;
                for (s = 0; s < 256; s++) {
                    C[ctx][s] = cum;
                    cum += Fn[ctx][s];
                }
            }
        }
        if (!r) {
            wr_alphabet(&tab, ctxs, nctx);
            rb_putc(&tab, 0);
            int k;
            for (k = 0; k < nctx; k++) wr_freq_table(&tab, Fn[ctxs[k]]);
            rb_putu7(out, tab.len);
            rb_put(out, tab.d, tab.len);
            int done = 0;
            if (nway == 32 && paylen >= 512) {
                /* vector tiers: AVX2 -> SSE4.1 (rANS_static32x16pr_*.c) */
                uint8_t *segb = NULL;
                size_t slen = 0;
                int r2 = 1;
                if (tier_cap() >= 2)
                    r2 = rans32x16_enc_o1_avx2(
                        payload, (int64_t)paylen,
                        (const int64_t (*)[256])Fn,
                        (const int64_t (*)[256])C, &segb, &slen);
                if (r2 == 1 && tier_cap() >= 1)
                    r2 = rans32x16_enc_o1_sse4(
                        payload, (int64_t)paylen,
                        (const int64_t (*)[256])Fn,
                        (const int64_t (*)[256])C, &segb, &slen);
                if (r2 == 0) {
                    r = rb_put(out, segb, slen);
                    free(segb);
                    done = 1;
                } else if (r2 == -1) {
                    r = -1;
                    done = 1;
                }
            }
            if (!done)
                r = enc_core_o1(payload, (int64_t)paylen, Fn, C, nway,
                                out);
        }
        free(tab.d); free(F); free(Fn); free(C);
    } else {
        int64_t counts[256], f[256], cum[257];
        memset(counts, 0, sizeof counts);
        uint64_t i;
        for (i = 0; i < paylen; i++) counts[payload[i]]++;
        if (norm_freqs(counts, f, TOTFREQ)) { r = -1; goto done; }
        cum[0] = 0;
        int s;
        for (s = 0; s < 256; s++) cum[s + 1] = cum[s] + f[s];
        wr_freq_table(out, f);
        int done = 0;
        if (nway == 32 && paylen >= 512) {
            /* vector tiers: AVX2 -> SSE4.1 (rANS_static32x16pr_*.c) */
            uint8_t *seg = NULL;
            size_t slen = 0;
            int r2 = 1;
            if (tier_cap() >= 2)
                r2 = rans32x16_enc_o0_avx2(payload, (int64_t)paylen, f,
                                           cum, &seg, &slen);
            if (r2 == 1 && tier_cap() >= 1)
                r2 = rans32x16_enc_o0_sse4(payload, (int64_t)paylen, f,
                                           cum, &seg, &slen);
            if (r2 == 0) {
                r = rb_put(out, seg, slen);
                free(seg);
                done = 1;
            } else if (r2 == -1) {
                r = -1;
                done = 1;
            }
        }
        if (!done)
            r = enc_core_o0(payload, (int64_t)paylen, f, cum, nway, out);
    }
done:
    free(pack_buf);
    free(rle_buf);
    return r;
}

static int uncompress_rec(const uint8_t *buf, uint64_t len, uint64_t *p,
                          int64_t expected, uint8_t **out_p,
                          int64_t *out_len);

static int stripe_uncompress(const uint8_t *buf, uint64_t len, uint64_t *p,
                             int64_t ulen, uint8_t *out) {
    if (*p >= len) return -1;
    int N = buf[(*p)++], j;
    if (N <= 0 || N > 255) return -1;
    uint64_t *lens = (uint64_t *)malloc((size_t)N * 8);
    if (!lens) return -1;
    for (j = 0; j < N; j++) {
        uint32_t v;
        if (u7_get(buf, len, p, &v) < 0) { free(lens); return -1; }
        lens[j] = v;
    }
    for (j = 0; j < N; j++) {
        int64_t want = (ulen - j + N - 1) / N;
        if (*p + lens[j] > len) { free(lens); return -1; }
        uint64_t sp = 0;
        uint8_t *part = NULL;
        int64_t plen = 0;
        if (uncompress_rec(buf + *p, lens[j], &sp, want, &part, &plen)
            || plen != want) {
            free(part); free(lens);
            return -1;
        }
        int64_t i;
        for (i = 0; i < plen; i++) out[j + i * N] = part[i];
        free(part);
        *p += lens[j];
    }
    free(lens);
    return 0;
}

static int uncompress_rec(const uint8_t *buf, uint64_t len, uint64_t *p,
                          int64_t expected, uint8_t **out_p,
                          int64_t *out_len) {
    if (*p >= len) return -1;
    int flags = buf[(*p)++];
    int64_t ulen;
    if (flags & RANS_ORDER_NOSZ) {
        if (expected < 0) return -1;
        ulen = expected;
    } else {
        uint32_t v;
        if (u7_get(buf, len, p, &v) < 0) return -1;
        ulen = v;
    }
    uint8_t *out = (uint8_t *)malloc(ulen ? (size_t)ulen : 1);
    if (!out) return -1;
    *out_p = out;
    *out_len = ulen;
    if (flags & RANS_ORDER_CAT) {
        if (*p + (uint64_t)ulen > len) return -1;
        memcpy(out, buf + *p, (size_t)ulen);
        *p += (uint64_t)ulen;
        return 0;
    }
    if (flags & RANS_ORDER_STRIPE)
        return stripe_uncompress(buf, len, p, ulen, out);

    uint64_t pack_meta_at = 0;
    int have_pack = flags & RANS_ORDER_PACK;
    int64_t n_core = ulen, plen = 0;
    if (have_pack) {
        pack_meta_at = *p;
        if (*p >= len) return -1;
        int P = buf[(*p)++];
        *p += (uint64_t)P;
        uint32_t v;
        if (*p > len || u7_get(buf, len, p, &v) < 0) return -1;
        plen = v;
        n_core = plen;
    }
    const uint8_t *rle_meta = NULL;
    uint64_t rle_meta_len = 0;
    if (flags & RANS_ORDER_RLE) {
        uint32_t mlen, llen;
        if (u7_get(buf, len, p, &mlen) < 0) return -1;
        if (*p + mlen > len) return -1;
        rle_meta = buf + *p;
        rle_meta_len = mlen;
        *p += mlen;
        if (u7_get(buf, len, p, &llen) < 0) return -1;
        n_core = llen;
    }
    uint8_t *core = NULL;
    int r = 0;
    if (n_core == 0) {
        core = (uint8_t *)malloc(1);
        if (!core) return -1;
    } else {
        core = (uint8_t *)malloc((size_t)n_core);
        if (!core) return -1;
        int nway = (flags & RANS_ORDER_X32) ? 32 : 4;
        if (flags & 1) {
            uint32_t tlen;
            if (u7_get(buf, len, p, &tlen) < 0 || *p + tlen > len) {
                free(core); return -1;
            }
            const uint8_t *tab = buf + *p;
            *p += tlen;
            uint64_t tp = 0;
            int ctxs[256];
            int nctx = rd_alphabet(tab, tlen, &tp, ctxs);
            if (nctx < 0) { free(core); return -1; }
            int64_t (*F)[256] = (int64_t (*)[256])calloc(256, 256 * 8);
            int64_t (*C)[256] = (int64_t (*)[256])calloc(256, 256 * 8);
            if (!F || !C) { free(F); free(C); free(core); return -1; }
            int k;
            for (k = 0; k < nctx && !r; k++)
                r = rd_freq_table(tab, tlen, &tp, F[ctxs[k]]);
            if (!r) {
                int ctx, s;
                for (ctx = 0; ctx < 256; ctx++) {
                    int64_t cum = 0;
                    for (s = 0; s < 256; s++) {
                        C[ctx][s] = cum;
                        cum += F[ctx][s];
                    }
                }
                uint64_t p0 = *p;
                int r2 = 1;
                if (nway == 32 && n_core >= 512) {
                    if (tier_cap() >= 2)
                        r2 = rans32x16_dec_o1_avx2(
                            buf, len, p, n_core,
                            (const int64_t (*)[256])F,
                            (const int64_t (*)[256])C, core);
                    if (r2 == 1 && tier_cap() >= 1)
                        r2 = rans32x16_dec_o1_sse4(
                            buf, len, p, n_core,
                            (const int64_t (*)[256])F,
                            (const int64_t (*)[256])C, core);
                }
                if (r2 == 1) {
                    *p = p0;
                    r = dec_core_o1(buf, len, p, n_core, F, C, nway, core);
                } else {
                    r = r2;
                }
            }
            free(F); free(C);
        } else {
            int64_t f[256], cum[256];
            r = rd_freq_table(buf, len, p, f);
            if (!r) {
                int64_t c = 0;
                int s;
                for (s = 0; s < 256; s++) { cum[s] = c; c += f[s]; }
                uint64_t p0 = *p;
                int r2 = 1;
                if (nway == 32 && n_core >= 512) {
                    if (tier_cap() >= 2)
                        r2 = rans32x16_dec_o0_avx2(buf, len, p, n_core,
                                                   f, cum, core);
                    if (r2 == 1 && tier_cap() >= 1)
                        r2 = rans32x16_dec_o0_sse4(buf, len, p, n_core,
                                                   f, cum, core);
                }
                if (r2 == 1) {
                    *p = p0;
                    r = dec_core_o0(buf, len, p, n_core, f, cum, nway,
                                    core);
                } else {
                    r = r2;
                }
            }
        }
    }
    if (r) { free(core); return -1; }
    /* undo transforms: core -> [rle] -> [pack] -> out */
    const uint8_t *cur = core;
    int64_t cur_len = n_core;
    uint8_t *rle_out = NULL;
    if (flags & RANS_ORDER_RLE) {
        int64_t want = have_pack ? plen : ulen;
        rle_out = (uint8_t *)malloc(want ? (size_t)want : 1);
        if (!rle_out || rle_decode(rle_meta, rle_meta_len, cur, cur_len,
                                   rle_out, want)) {
            free(core); free(rle_out);
            return -1;
        }
        cur = rle_out;
        cur_len = want;
    }
    if (have_pack) {
        uint64_t mp = pack_meta_at;
        int P = buf[mp++];
        const uint8_t *syms = buf + mp;
        int w = pack_width(P);
        if (w < 0) { free(core); free(rle_out); return -1; }
        if (P == 0) {
            if (ulen != 0) { free(core); free(rle_out); return -1; }
        } else if (w == 0) {
            memset(out, syms[0], (size_t)ulen);
        } else {
            int per = 8 / w, mask = (1 << w) - 1;
            int64_t i;
            if (cur_len * per < ulen) { free(core); free(rle_out); return -1; }
            for (i = 0; i < ulen; i++) {
                int v = (cur[i / per] >> ((i % per) * w)) & mask;
                if (v >= P) { free(core); free(rle_out); return -1; }
                out[i] = syms[v];
            }
        }
    } else {
        if (cur_len != ulen) { free(core); free(rle_out); return -1; }
        memcpy(out, cur, (size_t)ulen);
    }
    free(core);
    free(rle_out);
    return 0;
}

/* ---- public API (htscodecs-compatible) ---- */

unsigned int rans_compress_bound_4x16(unsigned int size, int order) {
    (void)order;
    return size + (size >> 1) + 1024;
}

unsigned char *rans_compress_4x16(unsigned char *in, unsigned int in_size,
                                  unsigned int *out_size, int order) {
    rbuf_t out = {0, 0, 0};
    if (compress_rec(in, in_size, order & 0xFF, &out)) {
        free(out.d);
        return NULL;
    }
    *out_size = (unsigned int)out.len;
    return out.d;
}

unsigned char *rans_uncompress_4x16(unsigned char *in, unsigned int in_size,
                                    unsigned int *out_size) {
    uint64_t p = 0;
    uint8_t *out = NULL;
    int64_t out_len = 0;
    if (uncompress_rec(in, in_size, &p, -1, &out, &out_len)) {
        free(out);
        return NULL;
    }
    *out_size = (unsigned int)out_len;
    return out;
}

unsigned char *rans_uncompress_to_4x16(unsigned char *in, unsigned int in_size,
                                       unsigned char *out,
                                       unsigned int *out_size) {
    uint64_t p = 0;
    uint8_t *tmp = NULL;
    int64_t tmp_len = 0;
    if (uncompress_rec(in, in_size, &p, (int64_t)*out_size, &tmp, &tmp_len)) {
        free(tmp);
        return NULL;
    }
    if ((unsigned int)tmp_len > *out_size) { free(tmp); return NULL; }
    memcpy(out, tmp, (size_t)tmp_len);
    *out_size = (unsigned int)tmp_len;
    free(tmp);
    return out;
}
