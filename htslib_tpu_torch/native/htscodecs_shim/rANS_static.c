/* rANS 4x8 static entropy codec — CRAM 3.0 wire format.
 *
 * C port of this project's own implementation
 * (htslib_tpu/native/src/htstpu.cc htstpu_rans4x8_* and
 * htslib_tpu/codecs/rans4x8.py), which is cross-validated against the
 * reference corpus (test/range.cram, produced by authentic htscodecs).
 * Provided so the reference htslib can be built and benchmarked on this
 * host despite its htscodecs submodule being absent from the snapshot.
 *
 * Format (CRAM 3.0 spec §rANS codec): 1-byte order, u32le compressed
 * size (after the 9-byte header), u32le uncompressed size, frequency
 * table(s) normalised to 4096, then 4 interleaved rANS states.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include "rANS_static.h"

#define TF_SHIFT 12
#define TOTFREQ (1u << TF_SHIFT)
#define RANS_L (1u << 23)

/* ---- dynamic byte buffer ---- */
typedef struct { uint8_t *d; size_t len, cap; } buf_t;

static int buf_put(buf_t *b, const void *p, size_t n) {
    if (b->len + n > b->cap) {
        size_t nc = b->cap ? b->cap * 2 : 4096;
        while (nc < b->len + n) nc *= 2;
        uint8_t *nd = realloc(b->d, nc);
        if (!nd) return -1;
        b->d = nd; b->cap = nc;
    }
    memcpy(b->d + b->len, p, n);
    b->len += n;
    return 0;
}
static int buf_putc(buf_t *b, uint8_t c) { return buf_put(b, &c, 1); }

/* ---- ITF8 freq values (cram/cram_io.c:138 format, <=2 bytes here) ---- */
static int itf8_get(const uint8_t *b, uint64_t len, uint64_t *p, uint32_t *v) {
    if (*p >= len) return 0;
    uint8_t b0 = b[*p];
    int extra = b0 < 0x80 ? 0 : b0 < 0xC0 ? 1 : b0 < 0xE0 ? 2
              : b0 < 0xF0 ? 3 : 4;
    if (*p + 1 + extra > len) return 0;
    const uint8_t *q = b + *p + 1;
    switch (extra) {
    case 0: *v = b0; break;
    case 1: *v = ((b0 & 0x3Fu) << 8) | q[0]; break;
    case 2: *v = ((b0 & 0x1Fu) << 16) | (q[0] << 8) | q[1]; break;
    case 3: *v = ((b0 & 0x0Fu) << 24) | (q[0] << 16) | (q[1] << 8) | q[2]; break;
    default:
        *v = ((b0 & 0x0Fu) << 28) | (q[0] << 20) | (q[1] << 12) | (q[2] << 4)
           | (q[3] & 0x0F);
        break;
    }
    *p += 1 + extra;
    return 1;
}

static void itf8_put(buf_t *out, uint32_t v) {
    if (v < 0x80) buf_putc(out, (uint8_t)v);
    else if (v < 0x4000) {
        buf_putc(out, (uint8_t)(0x80 | (v >> 8)));
        buf_putc(out, (uint8_t)(v & 0xFF));
    } else if (v < 0x200000) {
        buf_putc(out, (uint8_t)(0xC0 | (v >> 16)));
        buf_putc(out, (uint8_t)((v >> 8) & 0xFF));
        buf_putc(out, (uint8_t)(v & 0xFF));
    } else {
        buf_putc(out, (uint8_t)(0xE0 | (v >> 24)));
        buf_putc(out, (uint8_t)((v >> 16) & 0xFF));
        buf_putc(out, (uint8_t)((v >> 8) & 0xFF));
        buf_putc(out, (uint8_t)(v & 0xFF));
    }
}

/* ---- freq table wire I/O: ascending syms, (sym+1, runlen) RLE escape ---- */
static int read_freqs(const uint8_t *b, uint64_t len, uint64_t *pp,
                      uint32_t freqs[256]) {
    memset(freqs, 0, 256 * sizeof(uint32_t));
    uint64_t p = *pp;
    if (p >= len) return 0;
    int sym = b[p++], rle = 0;
    for (;;) {
        uint32_t f;
        if (!itf8_get(b, len, &p, &f)) return 0;
        freqs[sym] = f;
        if (rle == 0 && p < len && b[p] == sym + 1) {
            sym = b[p++];
            if (p >= len) return 0;
            rle = b[p++];
        } else if (rle > 0) {
            rle--;
            if (++sym > 255) return 0;
        } else {
            if (p >= len) return 0;
            sym = b[p++];
        }
        if (sym == 0) break;
    }
    *pp = p;
    return 1;
}

static void write_freqs(buf_t *out, const uint32_t freqs[256]) {
    uint8_t syms[256];
    int n = 0, i = 0;
    for (int s = 0; s < 256; s++)
        if (freqs[s]) syms[n++] = (uint8_t)s;
    while (i < n) {
        int run = 0;
        while (i + run + 1 < n && syms[i + run + 1] == syms[i + run] + 1) run++;
        buf_putc(out, syms[i]);
        itf8_put(out, freqs[syms[i]]);
        if (run >= 1) {
            buf_putc(out, (uint8_t)(syms[i] + 1));
            buf_putc(out, (uint8_t)(run - 1));
            for (int j = 1; j <= run; j++) itf8_put(out, freqs[syms[i + j]]);
            i += run + 1;
        } else {
            i++;
        }
    }
    buf_putc(out, 0);
}

static int normalize(const uint64_t *hist, uint32_t freqs[256]) {
    uint64_t s = 0;
    for (int i = 0; i < 256; i++) s += hist[i];
    if (s == 0) { memset(freqs, 0, 256 * sizeof(uint32_t)); return 1; }
    int64_t total = 0;
    int argmax = 0;
    for (int i = 0; i < 256; i++) {
        uint64_t f = hist[i] * TOTFREQ / s;
        if (hist[i] && f == 0) f = 1;
        freqs[i] = (uint32_t)f;
        total += (int64_t)f;
        if (freqs[i] > freqs[argmax]) argmax = i;
    }
    int64_t diff = (int64_t)TOTFREQ - total;
    if ((int64_t)freqs[argmax] + diff <= 0) return 0;
    freqs[argmax] = (uint32_t)((int64_t)freqs[argmax] + diff);
    return 1;
}

typedef struct {
    uint8_t sym[TOTFREQ];
    uint16_t freq[TOTFREQ];
    uint16_t cum[TOTFREQ];
} rans_tbl;

static int tbl_build(rans_tbl *t, const uint32_t freqs[256]) {
    uint32_t c = 0;
    for (int s = 0; s < 256; s++) {
        uint32_t f = freqs[s];
        if (c + f > TOTFREQ) return 0;
        for (uint32_t k = 0; k < f; k++) {
            t->sym[c + k] = (uint8_t)s;
            t->freq[c + k] = (uint16_t)f;
            t->cum[c + k] = (uint16_t)c;
        }
        c += f;
    }
    for (; c < TOTFREQ; c++) { t->sym[c] = 0; t->freq[c] = 0; t->cum[c] = 0; }
    return 1;
}

static inline void renorm_dec(uint32_t *x, const uint8_t *b, uint64_t len,
                              uint64_t *ptr) {
    while (*x < RANS_L && *ptr < len) *x = (*x << 8) | b[(*ptr)++];
}

static inline void renorm_enc(uint32_t *x, uint32_t f, buf_t *rev) {
    uint32_t x_max = ((RANS_L >> TF_SHIFT) << 8) * f;
    while (*x >= x_max) {
        buf_putc(rev, (uint8_t)(*x & 0xFF));
        *x >>= 8;
    }
}

unsigned int rans_compress_bound(unsigned int size, int order) {
    return size + 1024 + (order ? 257 * 257 * 3 : 257 * 3) + 9;
}

unsigned char *rans_uncompress(unsigned char *in, unsigned int in_size,
                               unsigned int *out_size) {
    if (in_size < 9) return NULL;
    uint64_t in_len = in_size;
    int order = in[0];
    uint32_t out_sz;
    memcpy(&out_sz, in + 5, 4);
    uint8_t *out = malloc(out_sz ? out_sz : 1);
    if (!out) return NULL;
    if (out_sz == 0) { *out_size = 0; return out; }
    uint64_t p = 9;

    if (order == 0) {
        uint32_t freqs[256];
        rans_tbl *tbl = malloc(sizeof(*tbl));
        if (!tbl) goto err;
        if (!read_freqs(in, in_len, &p, freqs) || !tbl_build(tbl, freqs)) {
            free(tbl);
            goto err;
        }
        if (p + 16 > in_len) { free(tbl); goto err; }
        uint32_t x[4];
        memcpy(x, in + p, 16);
        uint64_t ptr = p + 16;
        for (uint64_t k = 0; k < out_sz; k++) {
            int j = (int)(k & 3);
            uint32_t m = x[j] & (TOTFREQ - 1);
            out[k] = tbl->sym[m];
            x[j] = tbl->freq[m] * (x[j] >> TF_SHIFT) + m - tbl->cum[m];
            renorm_dec(&x[j], in, in_len, &ptr);
        }
        free(tbl);
        *out_size = out_sz;
        return out;
    }
    if (order != 1) goto err;

    {
        rans_tbl *tbls = NULL;
        uint16_t (*cum)[257] = calloc(256, sizeof(*cum));
        int tidx[256];
        int ntbl = 0, cap = 0;
        if (!cum) goto err;
        for (int i = 0; i < 256; i++) tidx[i] = -1;
        if (p >= in_len) { free(cum); goto err; }
        int sym = in[p++], rle = 0;
        for (;;) {
            uint32_t inner[256];
            if (!read_freqs(in, in_len, &p, inner)) goto err1;
            if (ntbl == cap) {
                cap = cap ? cap * 2 : 8;
                rans_tbl *nt = realloc(tbls, cap * sizeof(*tbls));
                if (!nt) goto err1;
                tbls = nt;
            }
            if (!tbl_build(&tbls[ntbl], inner)) goto err1;
            tidx[sym] = ntbl++;
            uint32_t c = 0;
            for (int s2 = 0; s2 < 256; s2++) {
                cum[sym][s2] = (uint16_t)c;
                c += inner[s2];
            }
            if (rle == 0 && p < in_len && in[p] == sym + 1) {
                sym = in[p++];
                if (p >= in_len) goto err1;
                rle = in[p++];
            } else if (rle > 0) {
                rle--;
                if (++sym > 255) goto err1;
            } else {
                if (p >= in_len) goto err1;
                sym = in[p++];
            }
            if (sym == 0) break;
        }
        if (p + 16 > in_len) goto err1;
        uint32_t x[4];
        memcpy(x, in + p, 16);
        uint64_t ptr = p + 16;
        uint64_t isz4 = out_sz >> 2;
        uint32_t l[4] = {0, 0, 0, 0};
        uint64_t pos[4] = {0, isz4, 2 * isz4, 3 * isz4};
        for (uint64_t i = 0; i < isz4; i++) {
            for (int j = 0; j < 4; j++) {
                int ti = tidx[l[j]];
                if (ti < 0) goto err1;
                rans_tbl *t = &tbls[ti];
                uint32_t m = x[j] & (TOTFREQ - 1);
                uint8_t s = t->sym[m];
                out[pos[j]++] = s;
                x[j] = t->freq[m] * (x[j] >> TF_SHIFT) + m - t->cum[m];
                renorm_dec(&x[j], in, in_len, &ptr);
                l[j] = s;
            }
        }
        for (uint64_t k = 4 * isz4; k < out_sz; k++) {
            int ti = tidx[l[3]];
            if (ti < 0) goto err1;
            rans_tbl *t = &tbls[ti];
            uint32_t m = x[3] & (TOTFREQ - 1);
            uint8_t s = t->sym[m];
            out[k] = s;
            x[3] = t->freq[m] * (x[3] >> TF_SHIFT) + m - t->cum[m];
            renorm_dec(&x[3], in, in_len, &ptr);
            l[3] = s;
        }
        free(tbls);
        free(cum);
        *out_size = out_sz;
        return out;
    err1:
        free(tbls);
        free(cum);
        goto err;
    }
err:
    free(out);
    return NULL;
}

unsigned char *rans_compress(unsigned char *in, unsigned int in_size,
                             unsigned int *out_size, int order) {
    buf_t body = {0}, rev = {0};
    uint64_t n = in_size;

    if (order == 0 || n < 4) {
        order = 0;
        uint64_t hist[256] = {0};
        for (uint64_t i = 0; i < n; i++) hist[in[i]]++;
        uint32_t freqs[256], cum[257] = {0};
        if (!normalize(hist, freqs)) goto err;
        for (int s = 0; s < 256; s++) cum[s + 1] = cum[s] + freqs[s];
        write_freqs(&body, freqs);
        uint32_t x[4] = {RANS_L, RANS_L, RANS_L, RANS_L};
        for (int64_t i = (int64_t)n - 1; i >= 0; i--) {
            int j = (int)(i & 3);
            uint8_t s = in[i];
            renorm_enc(&x[j], freqs[s], &rev);
            x[j] = ((x[j] / freqs[s]) << TF_SHIFT) + (x[j] % freqs[s]) + cum[s];
        }
        buf_put(&body, x, 16);
        for (int64_t i = (int64_t)rev.len - 1; i >= 0; i--)
            buf_putc(&body, rev.d[i]);
    } else {
        uint64_t isz4 = n >> 2;
        uint64_t *hist = calloc(256 * 256, sizeof(uint64_t));
        uint32_t *freqs = calloc(256 * 256, sizeof(uint32_t));
        uint32_t *cum = calloc(256 * 257, sizeof(uint32_t));
        if (!hist || !freqs || !cum) {
            free(hist); free(freqs); free(cum);
            goto err;
        }
        for (uint64_t i = 0; i < n; i++) {
            uint8_t c = (i == 0 || i == isz4 || i == 2 * isz4 || i == 3 * isz4)
                            ? 0 : in[i - 1];
            hist[(uint64_t)c * 256 + in[i]]++;
        }
        uint8_t used[256];
        int nused = 0;
        for (int c = 0; c < 256; c++) {
            uint64_t s = 0;
            for (int k = 0; k < 256; k++) s += hist[c * 256 + k];
            if (!s) continue;
            used[nused++] = (uint8_t)c;
            if (!normalize(&hist[c * 256], &freqs[c * 256])) {
                free(hist); free(freqs); free(cum);
                goto err;
            }
            for (int k = 0; k < 256; k++)
                cum[c * 257 + k + 1] = cum[c * 257 + k] + freqs[c * 256 + k];
        }
        int i = 0;
        while (i < nused) {
            int run = 0;
            while (i + run + 1 < nused && used[i + run + 1] == used[i + run] + 1)
                run++;
            buf_putc(&body, used[i]);
            write_freqs(&body, &freqs[used[i] * 256]);
            if (run >= 1) {
                buf_putc(&body, (uint8_t)(used[i] + 1));
                buf_putc(&body, (uint8_t)(run - 1));
                for (int j = 1; j <= run; j++)
                    write_freqs(&body, &freqs[used[i + j] * 256]);
                i += run + 1;
            } else {
                i++;
            }
        }
        buf_putc(&body, 0);
        uint32_t x[4] = {RANS_L, RANS_L, RANS_L, RANS_L};
        uint64_t starts[4] = {0, isz4, 2 * isz4, 3 * isz4};
        /* encode in exact reverse of the decoder's (round, state) order */
        for (int64_t k = (int64_t)n - 1; k >= (int64_t)(4 * isz4); k--) {
            uint8_t s = in[k], c = (uint64_t)k == starts[3] ? 0 : in[k - 1];
            uint32_t f = freqs[(uint64_t)c * 256 + s];
            renorm_enc(&x[3], f, &rev);
            x[3] = ((x[3] / f) << TF_SHIFT) + (x[3] % f)
                 + cum[(uint64_t)c * 257 + s];
        }
        for (int64_t i2 = (int64_t)isz4 - 1; i2 >= 0; i2--) {
            for (int j = 3; j >= 0; j--) {
                uint64_t pos = starts[j] + (uint64_t)i2;
                uint8_t s = in[pos], c = pos == starts[j] ? 0 : in[pos - 1];
                uint32_t f = freqs[(uint64_t)c * 256 + s];
                renorm_enc(&x[j], f, &rev);
                x[j] = ((x[j] / f) << TF_SHIFT) + (x[j] % f)
                     + cum[(uint64_t)c * 257 + s];
            }
        }
        buf_put(&body, x, 16);
        for (int64_t i2 = (int64_t)rev.len - 1; i2 >= 0; i2--)
            buf_putc(&body, rev.d[i2]);
        free(hist); free(freqs); free(cum);
    }

    {
        uint8_t *out = malloc(9 + body.len);
        if (!out) goto err;
        out[0] = (uint8_t)order;
        uint32_t csz = (uint32_t)body.len, usz = (uint32_t)n;
        memcpy(out + 1, &csz, 4);
        memcpy(out + 5, &usz, 4);
        memcpy(out + 9, body.d, body.len);
        *out_size = (unsigned int)(9 + body.len);
        free(body.d); free(rev.d);
        return out;
    }
err:
    free(body.d); free(rev.d);
    return NULL;
}
