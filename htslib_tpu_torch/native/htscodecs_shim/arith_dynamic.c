/* Adaptive arithmetic (range) coder — CRAM 3.1 "arith" block method
 * (reference call sites cram/cram_io.c:1718,1879; original lives in the
 * absent htscodecs submodule as arith_dynamic.c).
 *
 * Wire format (project-wide definition, mirrored byte-for-byte by
 * htslib_tpu/codecs/arith.py and cross-validated in tests):
 *
 *   byte  order: 0x01 ORDER1, 0x08 STRIPE, 0x10 NOSZ, 0x20 CAT,
 *                0x40 RLE, 0x80 PACK   (same vocabulary as rANS Nx16)
 *   [u7 ulen]          unless NOSZ
 *   CAT:    raw bytes
 *   STRIPE: byte N=4; N x u7 clen; substreams (order&1 | NOSZ)
 *   PACK:   byte P, P symbols, u7 packed_len   (as rANS Nx16)
 *   RLE:    u7 meta_len, meta, u7 lit_len      (as rANS Nx16)
 *   core:   byte nsym (0 => 256) then range-coded payload
 *           (c_range_coder.h) under adaptive models
 *           (c_simple_model.h): order-0 one model, order-1 one model
 *           per preceding byte (context 0 at stream start).
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include "arith_dynamic.h"
#include "c_range_coder.h"
#include "c_simple_model.h"
#include "varint.h"

/* reuse the rANS shim's transforms via small local copies of the
 * buffer/varint helpers (kept static to avoid symbol clashes) */
typedef struct { uint8_t *d; size_t len, cap; } abuf_t;

static int ab_need(abuf_t *b, size_t n) {
    if (b->len + n <= b->cap) return 0;
    size_t nc = b->cap ? b->cap * 2 : 4096;
    while (nc < b->len + n) nc *= 2;
    uint8_t *nd = (uint8_t *)realloc(b->d, nc);
    if (!nd) return -1;
    b->d = nd; b->cap = nc;
    return 0;
}
static int ab_put(abuf_t *b, const void *p, size_t n) {
    if (ab_need(b, n)) return -1;
    memcpy(b->d + b->len, p, n);
    b->len += n;
    return 0;
}
static int ab_putc(abuf_t *b, uint8_t c) { return ab_put(b, &c, 1); }
static int ab_putu7(abuf_t *b, uint64_t v) {
    uint8_t tmp[10];
    int n = var_put_u64(tmp, NULL, v);
    return ab_put(b, tmp, n);
}
static int a_u7_get(const uint8_t *buf, uint64_t len, uint64_t *p,
                    uint32_t *v) {
    if (*p >= len) return -1;
    int n = var_get_u32((uint8_t *)buf + *p, (uint8_t *)buf + len, v);
    if (n <= 0) return -1;
    *p += (uint64_t)n;
    return 0;
}

#define A_ORDER1 0x01
#define A_STRIPE 0x08
#define A_NOSZ   0x10
#define A_CAT    0x20
#define A_RLE    0x40
#define A_PACK   0x80

static int a_pack_width(int P) {
    return P <= 1 ? 0 : P <= 2 ? 1 : P <= 4 ? 2 : P <= 16 ? 4 : -1;
}

static int a_rle_encode(const uint8_t *in, int64_t n, abuf_t *meta,
                        abuf_t *lits) {
    int64_t saved[256];
    memset(saved, 0, sizeof saved);
    int64_t i = 0;
    while (i < n) {
        int64_t j = i;
        while (j < n && in[j] == in[i]) j++;
        saved[in[i]] += (j - i) - 2;
        i = j;
    }
    int rle_syms[256], L = 0, s;
    for (s = 0; s < 256; s++) if (saved[s] > 0) rle_syms[L++] = s;
    if (L == 0 && n) { rle_syms[0] = in[0]; L = 1; }
    uint8_t is_rle[256];
    memset(is_rle, 0, sizeof is_rle);
    ab_putc(meta, L == 256 ? 0 : (uint8_t)L);
    if (L != 256)
        for (s = 0; s < L; s++) ab_putc(meta, (uint8_t)rle_syms[s]);
    for (s = 0; s < L; s++) is_rle[rle_syms[s]] = 1;
    i = 0;
    while (i < n) {
        int64_t j = i;
        while (j < n && in[j] == in[i]) j++;
        if (is_rle[in[i]]) {
            ab_putc(lits, in[i]);
            ab_putu7(meta, (uint64_t)(j - i - 1));
        } else {
            int64_t k;
            for (k = i; k < j; k++) ab_putc(lits, in[i]);
        }
        i = j;
    }
    return 0;
}

static int a_rle_decode(const uint8_t *meta, uint64_t mlen,
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
            if (a_u7_get(meta, mlen, &mp, &run) < 0) return -1;
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

/* ---- range-coded core ---- */
static int a_enc_core(const uint8_t *in, int64_t n, int order1,
                      abuf_t *out) {
    int nsym = 0;
    int64_t i;
    for (i = 0; i < n; i++)
        if (in[i] >= nsym) nsym = in[i] + 1;
    if (nsym == 0) nsym = 1;
    ab_putc(out, (uint8_t)(nsym & 0xFF));   /* 0 => 256 */
    uint8_t *rc_buf = (uint8_t *)malloc(2 * (size_t)n + 1024);
    if (!rc_buf) return -1;
    RangeCoder rc;
    RC_StartEncode(&rc, rc_buf);
    if (order1) {
        SimpleModel *models =
            (SimpleModel *)malloc(256 * sizeof(SimpleModel));
        uint8_t built[256];
        if (!models) { free(rc_buf); return -1; }
        memset(built, 0, sizeof built);
        int ctx = 0;
        for (i = 0; i < n; i++) {
            if (!built[ctx]) { SM_Init(&models[ctx], nsym); built[ctx] = 1; }
            SM_EncodeSymbol(&models[ctx], &rc, in[i]);
            ctx = in[i];
        }
        free(models);
    } else {
        SimpleModel *m = (SimpleModel *)malloc(sizeof(SimpleModel));
        if (!m) { free(rc_buf); return -1; }
        SM_Init(m, nsym);
        for (i = 0; i < n; i++)
            SM_EncodeSymbol(m, &rc, in[i]);
        free(m);
    }
    size_t rlen = RC_FinishEncode(&rc);
    int r = ab_put(out, rc_buf, rlen);
    free(rc_buf);
    return r;
}

unsigned int arith_compress_bound(unsigned int size, int order) {
    (void)order;
    return size + (size >> 1) + 1024;
}

static int a_compress_rec(const uint8_t *in, uint64_t in_size, int order,
                          abuf_t *out);

static int a_stripe_compress(const uint8_t *in, uint64_t in_size, int order,
                             abuf_t *out) {
    const int N = 4;
    abuf_t subs[4] = {{0,0,0},{0,0,0},{0,0,0},{0,0,0}};
    uint8_t *tmp = (uint8_t *)malloc(in_size / N + 2);
    int j, r = 0;
    if (!tmp) return -1;
    ab_putc(out, (uint8_t)N);
    for (j = 0; j < N && !r; j++) {
        uint64_t m = 0, i;
        for (i = j; i < in_size; i += N) tmp[m++] = in[i];
        r = a_compress_rec(tmp, m, (order & A_ORDER1) | A_NOSZ, &subs[j]);
    }
    free(tmp);
    for (j = 0; j < N && !r; j++) r = ab_putu7(out, subs[j].len);
    for (j = 0; j < N && !r; j++) r = ab_put(out, subs[j].d, subs[j].len);
    for (j = 0; j < N; j++) free(subs[j].d);
    return r;
}

static int a_compress_rec(const uint8_t *in, uint64_t in_size, int order,
                          abuf_t *out) {
    if (order & A_PACK) {
        int seen[256];
        memset(seen, 0, sizeof seen);
        uint64_t i;
        int P = 0;
        for (i = 0; i < in_size; i++)
            if (!seen[in[i]]) { seen[in[i]] = 1; P++; }
        if (P > 16) order &= ~A_PACK;
    }
    if ((order & A_RLE) && in_size == 0)
        order &= ~A_RLE;
    ab_putc(out, (uint8_t)order);
    if (!(order & A_NOSZ)) ab_putu7(out, in_size);
    if (order & A_CAT)
        return ab_put(out, in, in_size);
    if (order & A_STRIPE)
        return a_stripe_compress(in, in_size, order, out);

    const uint8_t *payload = in;
    uint64_t paylen = in_size;
    uint8_t *pack_buf = NULL, *rle_buf = NULL;
    int r = 0;
    if (order & A_PACK) {
        int syms[16], P = 0, seen[256], s;
        memset(seen, 0, sizeof seen);
        uint64_t i;
        for (i = 0; i < paylen; i++) seen[payload[i]] = 1;
        for (s = 0; s < 256; s++) if (seen[s]) syms[P++] = s;
        ab_putc(out, (uint8_t)P);
        for (s = 0; s < P; s++) ab_putc(out, (uint8_t)syms[s]);
        int w = a_pack_width(P);
        if (w == 0) {
            ab_putu7(out, 0);
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
            ab_putu7(out, plen);
            payload = pack_buf; paylen = plen;
        }
    }
    if (order & A_RLE) {
        abuf_t meta = {0,0,0}, lits = {0,0,0};
        if (a_rle_encode(payload, (int64_t)paylen, &meta, &lits)) {
            free(pack_buf); free(meta.d); free(lits.d);
            return -1;
        }
        ab_putu7(out, meta.len);
        ab_put(out, meta.d, meta.len);
        ab_putu7(out, lits.len);
        free(meta.d);
        rle_buf = lits.d;
        payload = lits.d ? lits.d : (const uint8_t *)"";
        paylen = lits.len;
    }
    if (paylen > 0)
        r = a_enc_core(payload, (int64_t)paylen, order & A_ORDER1, out);
    free(pack_buf);
    free(rle_buf);
    return r;
}

static int a_uncompress_rec(const uint8_t *buf, uint64_t len, uint64_t *p,
                            int64_t expected, uint8_t **out_p,
                            int64_t *out_len);

static int a_stripe_uncompress(const uint8_t *buf, uint64_t len, uint64_t *p,
                               int64_t ulen, uint8_t *out) {
    if (*p >= len) return -1;
    int N = buf[(*p)++], j;
    if (N <= 0) return -1;
    uint64_t *lens = (uint64_t *)malloc((size_t)N * 8);
    if (!lens) return -1;
    for (j = 0; j < N; j++) {
        uint32_t v;
        if (a_u7_get(buf, len, p, &v) < 0) { free(lens); return -1; }
        lens[j] = v;
    }
    for (j = 0; j < N; j++) {
        int64_t want = (ulen - j + N - 1) / N;
        if (*p + lens[j] > len) { free(lens); return -1; }
        uint64_t sp = 0;
        uint8_t *part = NULL;
        int64_t plen = 0;
        if (a_uncompress_rec(buf + *p, lens[j], &sp, want, &part, &plen)
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

static int a_dec_core2(const uint8_t *buf, uint64_t len, uint64_t *p,
                       int order1, int64_t n_out, uint8_t *out) {
    if (*p >= len) return -1;
    int nsym = buf[(*p)++];
    if (nsym == 0) nsym = 256;
    RangeCoder rc;
    RC_StartDecode(&rc, buf + *p, buf + len);
    int64_t i;
    if (order1) {
        SimpleModel *models =
            (SimpleModel *)malloc(256 * sizeof(SimpleModel));
        uint8_t built[256];
        if (!models) return -1;
        memset(built, 0, sizeof built);
        int ctx = 0;
        for (i = 0; i < n_out; i++) {
            if (!built[ctx]) { SM_Init(&models[ctx], nsym); built[ctx] = 1; }
            int s = SM_DecodeSymbol(&models[ctx], &rc);
            out[i] = (uint8_t)s;
            ctx = s;
        }
        free(models);
    } else {
        SimpleModel *m = (SimpleModel *)malloc(sizeof(SimpleModel));
        if (!m) return -1;
        SM_Init(m, nsym);
        for (i = 0; i < n_out; i++)
            out[i] = (uint8_t)SM_DecodeSymbol(m, &rc);
        free(m);
    }
    *p = (uint64_t)(rc.in - buf);
    return 0;
}

static int a_uncompress_rec(const uint8_t *buf, uint64_t len, uint64_t *p,
                            int64_t expected, uint8_t **out_p,
                            int64_t *out_len) {
    if (*p >= len) return -1;
    int order = buf[(*p)++];
    int64_t ulen;
    if (order & A_NOSZ) {
        if (expected < 0) return -1;
        ulen = expected;
    } else {
        uint32_t v;
        if (a_u7_get(buf, len, p, &v) < 0) return -1;
        ulen = v;
    }
    uint8_t *out = (uint8_t *)malloc(ulen ? (size_t)ulen : 1);
    if (!out) return -1;
    *out_p = out;
    *out_len = ulen;
    if (order & A_CAT) {
        if (*p + (uint64_t)ulen > len) return -1;
        memcpy(out, buf + *p, (size_t)ulen);
        *p += (uint64_t)ulen;
        return 0;
    }
    if (order & A_STRIPE)
        return a_stripe_uncompress(buf, len, p, ulen, out);

    uint64_t pack_meta_at = 0;
    int have_pack = order & A_PACK;
    int64_t n_core = ulen, plen = 0;
    if (have_pack) {
        pack_meta_at = *p;
        if (*p >= len) return -1;
        int P = buf[(*p)++];
        *p += (uint64_t)P;
        uint32_t v;
        if (*p > len || a_u7_get(buf, len, p, &v) < 0) return -1;
        plen = v;
        n_core = plen;
    }
    const uint8_t *rle_meta = NULL;
    uint64_t rle_meta_len = 0;
    if (order & A_RLE) {
        uint32_t mlen, llen;
        if (a_u7_get(buf, len, p, &mlen) < 0) return -1;
        if (*p + mlen > len) return -1;
        rle_meta = buf + *p;
        rle_meta_len = mlen;
        *p += mlen;
        if (a_u7_get(buf, len, p, &llen) < 0) return -1;
        n_core = llen;
    }
    uint8_t *core = (uint8_t *)malloc(n_core ? (size_t)n_core : 1);
    if (!core) return -1;
    if (n_core > 0 &&
        a_dec_core2(buf, len, p, order & A_ORDER1, n_core, core)) {
        free(core);
        return -1;
    }
    const uint8_t *cur = core;
    int64_t cur_len = n_core;
    uint8_t *rle_out = NULL;
    if (order & A_RLE) {
        int64_t want = have_pack ? plen : ulen;
        rle_out = (uint8_t *)malloc(want ? (size_t)want : 1);
        if (!rle_out || a_rle_decode(rle_meta, rle_meta_len, cur, cur_len,
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
        int w = a_pack_width(P);
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

unsigned char *arith_compress_to(unsigned char *in, unsigned int in_size,
                                 unsigned char *out, unsigned int *out_size,
                                 int order) {
    abuf_t b = {0, 0, 0};
    if (a_compress_rec(in, in_size, order & 0xFF, &b)) {
        free(b.d);
        return NULL;
    }
    if (out == NULL) {
        *out_size = (unsigned int)b.len;
        return b.d;
    }
    if (b.len > *out_size) { free(b.d); return NULL; }
    memcpy(out, b.d, b.len);
    *out_size = (unsigned int)b.len;
    free(b.d);
    return out;
}

unsigned char *arith_uncompress_to(unsigned char *in, unsigned int in_size,
                                   unsigned char *out,
                                   unsigned int *out_sz) {
    uint64_t p = 0;
    uint8_t *tmp = NULL;
    int64_t tmp_len = 0;
    int64_t expected = out ? (int64_t)*out_sz : -1;
    if (a_uncompress_rec(in, in_size, &p, expected, &tmp, &tmp_len)) {
        free(tmp);
        return NULL;
    }
    if (out == NULL) {
        *out_sz = (unsigned int)tmp_len;
        return tmp;
    }
    if ((unsigned int)tmp_len > *out_sz) { free(tmp); return NULL; }
    memcpy(out, tmp, (size_t)tmp_len);
    *out_sz = (unsigned int)tmp_len;
    free(tmp);
    return out;
}
