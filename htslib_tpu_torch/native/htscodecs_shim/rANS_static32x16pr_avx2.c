/* AVX2 32-state rANS Nx16 cores (the X32 wire tier; reference build
 * list htscodecs_bundled.mk:26-40).  Byte-exact with the scalar cores
 * in rANS_static4x16pr.c: identical stream consumption order (states
 * ascending per 32-output round on decode, descending on encode) and
 * identical renormalisation.
 *
 * Vectorisation strategy: the per-state arithmetic (slot mask, table
 * gather, state update, reciprocal division on encode) runs 8 states
 * per YMM register; the strictly ordered byte-stream traffic (16-bit
 * refills/emissions) is done per-lane from a spilled copy, which keeps
 * the stream order exactly the scalar core's while the expensive
 * gathers and multiplies stay vectorised.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include "rANS_static16_int.h"

#if defined(__x86_64__) || defined(_M_X64)
#  define R32_X86 1
#else
#  define R32_X86 0
#endif

#if R32_X86
#include <immintrin.h>

#define TF_SHIFT 12
#define TOTFREQ (1u << TF_SHIFT)
#define R4X16_L (1u << 15)

int rans32x16_have_avx2(void) {
    static int have = -1;
    if (have < 0)
        have = __builtin_cpu_supports("avx2") ? 1 : 0;
    return have;
}

/* ---- order-0 decode ------------------------------------------------ */

__attribute__((target("avx2")))
int rans32x16_dec_o0_avx2(const uint8_t *buf, uint64_t len, uint64_t *p,
                          int64_t n_out, const int64_t *f,
                          const int64_t *cum, uint8_t *out) {
    if (!rans32x16_have_avx2()) return 1;
    /* packed slot table: f | cum<<12 | sym<<24 (calloc: uncovered slots
     * behave like the scalar sym_of's zero fill on malformed tables) */
    uint32_t *packed = (uint32_t *)calloc(TOTFREQ, 4);
    if (!packed) return -1;
    {
        int s;
        for (s = 0; s < 256; s++) {
            if (!f[s]) continue;
            int64_t c = cum[s], e = cum[s] + f[s];
            if (c < 0 || e > TOTFREQ) { free(packed); return -1; }
            /* f-1: a lone symbol has f == 4096, one past 12 bits */
            uint32_t v = (uint32_t)(f[s] - 1) | ((uint32_t)cum[s] << 12)
                       | ((uint32_t)s << 24);
            int64_t m;
            for (m = c; m < e; m++) packed[m] = v;
        }
    }
    uint32_t st[32] __attribute__((aligned(32)));
    int j;
    for (j = 0; j < 32; j++) {
        if (*p + 4 > len) { free(packed); return -1; }
        st[j] = (uint32_t)buf[*p] | ((uint32_t)buf[*p + 1] << 8)
              | ((uint32_t)buf[*p + 2] << 16) | ((uint32_t)buf[*p + 3] << 24);
        *p += 4;
    }
    const __m256i vmask = _mm256_set1_epi32(TOTFREQ - 1);
    const __m256i vL = _mm256_set1_epi32(R4X16_L);
    int64_t i = 0;
    int64_t n_full = n_out - (n_out % 32);
    uint64_t pp = *p;
    for (; i < n_full; i += 32) {
        int v;
        for (v = 0; v < 4; v++) {
            __m256i x = _mm256_load_si256((const __m256i *)(st + 8 * v));
            __m256i m = _mm256_and_si256(x, vmask);
            __m256i t = _mm256_i32gather_epi32((const int *)packed, m, 4);
            __m256i fv = _mm256_add_epi32(_mm256_and_si256(t, vmask),
                                          _mm256_set1_epi32(1));
            __m256i cv = _mm256_and_si256(_mm256_srli_epi32(t, 12), vmask);
            __m256i sv = _mm256_srli_epi32(t, 24);
            /* x = f*(x>>12) + m - cum */
            x = _mm256_add_epi32(
                    _mm256_mullo_epi32(fv, _mm256_srli_epi32(x, TF_SHIFT)),
                    _mm256_sub_epi32(m, cv));
            /* emit the 8 symbol bytes */
            {
                uint32_t sy[8] __attribute__((aligned(32)));
                _mm256_store_si256((__m256i *)sy, sv);
                uint8_t *o = out + i + 8 * v;
                o[0] = (uint8_t)sy[0]; o[1] = (uint8_t)sy[1];
                o[2] = (uint8_t)sy[2]; o[3] = (uint8_t)sy[3];
                o[4] = (uint8_t)sy[4]; o[5] = (uint8_t)sy[5];
                o[6] = (uint8_t)sy[6]; o[7] = (uint8_t)sy[7];
            }
            /* 16-bit refills, lanes ascending (stream order).  States
             * are < 2^31 so the signed compare is safe. */
            int need = _mm256_movemask_ps(_mm256_castsi256_ps(
                _mm256_cmpgt_epi32(vL, x)));
            if (need) {
                uint32_t xs[8] __attribute__((aligned(32)));
                _mm256_store_si256((__m256i *)xs, x);
                int l;
                for (l = 0; l < 8; l++) {
                    uint32_t xv = xs[l];
                    while (xv < R4X16_L) {
                        if (pp + 2 > len) break;
                        xv = (xv << 16) | buf[pp]
                           | ((uint32_t)buf[pp + 1] << 8);
                        pp += 2;
                    }
                    xs[l] = xv;
                }
                x = _mm256_load_si256((const __m256i *)xs);
            }
            _mm256_store_si256((__m256i *)(st + 8 * v), x);
        }
    }
    /* tail: states continue round-robin */
    for (; i < n_out; i++) {
        j = (int)(i % 32);
        uint32_t x = st[j];
        uint32_t m = x & (TOTFREQ - 1);
        uint32_t t = packed[m];
        out[i] = (uint8_t)(t >> 24);
        x = ((t & (TOTFREQ - 1)) + 1) * (x >> TF_SHIFT) + m
          - ((t >> 12) & (TOTFREQ - 1));
        while (x < R4X16_L) {
            if (pp + 2 > len) break;
            x = (x << 16) | buf[pp] | ((uint32_t)buf[pp + 1] << 8);
            pp += 2;
        }
        st[j] = x;
    }
    *p = pp;
    free(packed);
    return 0;
}

/* ---- order-1 decode ------------------------------------------------ */

__attribute__((target("avx2")))
int rans32x16_dec_o1_avx2(const uint8_t *buf, uint64_t len, uint64_t *p,
                          int64_t n_out, const int64_t F[256][256],
                          const int64_t C[256][256], uint8_t *out) {
    if (!rans32x16_have_avx2()) return 1;
    /* dense per-context packed tables (the cram_index-style container
     * scan of used contexts), indexed ctx<<12 | slot */
    uint32_t *packed = (uint32_t *)calloc((size_t)256 << TF_SHIFT, 4);
    uint8_t built[256];
    if (!packed) return -1;
    memset(built, 0, sizeof built);
    int ctx, s;
    for (ctx = 0; ctx < 256; ctx++) {
        int64_t sum = 0;
        for (s = 0; s < 256; s++) sum += F[ctx][s];
        if (!sum) continue;
        built[ctx] = 1;
        uint32_t *row = packed + ((size_t)ctx << TF_SHIFT);
        for (s = 0; s < 256; s++) {
            if (!F[ctx][s]) continue;
            int64_t c = C[ctx][s], e = C[ctx][s] + F[ctx][s];
            if (c < 0 || e > TOTFREQ) { free(packed); return -1; }
            uint32_t v = (uint32_t)(F[ctx][s] - 1)
                       | ((uint32_t)C[ctx][s] << 12)
                       | ((uint32_t)s << 24);
            int64_t m;
            for (m = c; m < e; m++) row[m] = v;
        }
    }
    uint32_t st[32] __attribute__((aligned(32)));
    uint32_t cx[32] __attribute__((aligned(32)));
    int j;
    for (j = 0; j < 32; j++) {
        if (*p + 4 > len) { free(packed); return -1; }
        st[j] = (uint32_t)buf[*p] | ((uint32_t)buf[*p + 1] << 8)
              | ((uint32_t)buf[*p + 2] << 16) | ((uint32_t)buf[*p + 3] << 24);
        *p += 4;
        cx[j] = 0;
    }
    int64_t seg = n_out / 32;
    const __m256i vmask = _mm256_set1_epi32(TOTFREQ - 1);
    const __m256i vL = _mm256_set1_epi32(R4X16_L);
    uint64_t pp = *p;
    int64_t r;
    for (r = 0; r < seg; r++) {
        int v;
        for (v = 0; v < 4; v++) {
            __m256i x = _mm256_load_si256((const __m256i *)(st + 8 * v));
            __m256i cxv = _mm256_load_si256((const __m256i *)(cx + 8 * v));
            __m256i m = _mm256_and_si256(x, vmask);
            __m256i idx = _mm256_or_si256(
                _mm256_slli_epi32(cxv, TF_SHIFT), m);
            __m256i t = _mm256_i32gather_epi32((const int *)packed, idx, 4);
            __m256i fv = _mm256_add_epi32(_mm256_and_si256(t, vmask),
                                          _mm256_set1_epi32(1));
            __m256i cv = _mm256_and_si256(_mm256_srli_epi32(t, 12), vmask);
            __m256i sv = _mm256_srli_epi32(t, 24);
            x = _mm256_add_epi32(
                    _mm256_mullo_epi32(fv, _mm256_srli_epi32(x, TF_SHIFT)),
                    _mm256_sub_epi32(m, cv));
            {
                uint32_t sy[8] __attribute__((aligned(32)));
                _mm256_store_si256((__m256i *)sy, sv);
                int l;
                for (l = 0; l < 8; l++)
                    out[(int64_t)(8 * v + l) * seg + r] = (uint8_t)sy[l];
            }
            _mm256_store_si256((__m256i *)(cx + 8 * v), sv);
            int need = _mm256_movemask_ps(_mm256_castsi256_ps(
                _mm256_cmpgt_epi32(vL, x)));
            if (need) {
                uint32_t xs[8] __attribute__((aligned(32)));
                _mm256_store_si256((__m256i *)xs, x);
                int l;
                for (l = 0; l < 8; l++) {
                    uint32_t xv = xs[l];
                    while (xv < R4X16_L) {
                        if (pp + 2 > len) break;
                        xv = (xv << 16) | buf[pp]
                           | ((uint32_t)buf[pp + 1] << 8);
                        pp += 2;
                    }
                    xs[l] = xv;
                }
                x = _mm256_load_si256((const __m256i *)xs);
            }
            _mm256_store_si256((__m256i *)(st + 8 * v), x);
        }
    }
    /* last-state tail */
    {
        int64_t i;
        for (i = (int64_t)32 * seg; i < n_out; i++) {
            int c2 = (int)cx[31];
            uint32_t x = st[31];
            uint32_t m = x & (TOTFREQ - 1);
            uint32_t t = packed[((size_t)c2 << TF_SHIFT) | m];
            int sym = (int)(t >> 24);
            out[i] = (uint8_t)sym;
            x = ((t & (TOTFREQ - 1)) + 1) * (x >> TF_SHIFT) + m
              - ((t >> 12) & (TOTFREQ - 1));
            while (x < R4X16_L) {
                if (pp + 2 > len) break;
                x = (x << 16) | buf[pp] | ((uint32_t)buf[pp + 1] << 8);
                pp += 2;
            }
            st[31] = x;
            cx[31] = (uint32_t)sym;
        }
    }
    *p = pp;
    free(packed);
    return 0;
}

/* ---- order-0 encode ------------------------------------------------ */

/* per-symbol encode tables: reciprocal so q = x/f is one mulhi + shift
 * (exact for the renormalised state range x < 2^31; f==1 uses
 * rcp = 2^32-1 so q = x-1 with the correction absorbed in bias) */
typedef struct {
    uint32_t rcp[256];
    uint32_t aux[256];   /* rshift | cmpl<<4 | bias<<17 */
    uint32_t x_max[256];
} enc_tbl_t;

static int enc_tbl_init(enc_tbl_t *T, const int64_t *f, const int64_t *cum) {
    int s;
    for (s = 0; s < 256; s++) {
        uint32_t fr = (uint32_t)f[s];
        uint32_t bias, rshift;
        uint64_t rcp;
        T->x_max[s] = ((R4X16_L >> TF_SHIFT) << 16) * fr;
        if (fr < 2) {
            rcp = 0xFFFFFFFFull;
            rshift = 0;
            bias = (uint32_t)cum[s] + TOTFREQ - 1;
        } else {
            uint32_t shift = 0;
            while (fr > (1u << shift)) shift++;
            rcp = ((((uint64_t)1 << (shift + 31)) + fr - 1) / fr);
            rshift = shift - 1;
            bias = (uint32_t)cum[s];
        }
        if (rcp > 0xFFFFFFFFull) return -1;
        T->rcp[s] = (uint32_t)rcp;
        T->aux[s] = rshift | ((TOTFREQ - fr) << 4) | (bias << 17);
    }
    return 0;
}

__attribute__((target("avx2")))
int rans32x16_enc_o0_avx2(const uint8_t *in, int64_t n, const int64_t *f,
                          const int64_t *cum, uint8_t **out,
                          size_t *out_len) {
    if (!rans32x16_have_avx2()) return 1;
    enc_tbl_t *T = (enc_tbl_t *)malloc(sizeof *T);
    if (!T) return -1;
    if (enc_tbl_init(T, f, cum)) { free(T); return -1; }
    /* emission body: worst case 2 bytes per symbol + slack */
    size_t cap = (size_t)(n > 0 ? n : 1) * 2 + 256;
    uint8_t *body = (uint8_t *)malloc(cap);
    if (!body) { free(T); return -1; }
    size_t blen = 0;
    uint32_t st[32] __attribute__((aligned(32)));
    int j;
    for (j = 0; j < 32; j++) st[j] = R4X16_L;

    int64_t i = n - 1;
    /* leading tail so the remaining count is a multiple of 32: these
     * highest positions map to states (n-1)%32 .. 0 in the scalar order */
    int64_t tail = n % 32;
    for (; i >= n - tail; i--) {
        int s = in[i];
        j = (int)(i % 32);
        uint32_t x = st[j];
        while (x >= T->x_max[s]) {
            body[blen++] = (x >> 8) & 0xFF;
            body[blen++] = x & 0xFF;
            x >>= 16;
        }
        uint32_t a = T->aux[s];
        uint32_t q = (uint32_t)((((uint64_t)x * T->rcp[s]) >> 32) >> (a & 0xF));
        st[j] = x + (a >> 17) + q * ((a >> 4) & 0x1FFF);
    }
    /* full chunks: i now ends a block of 32 with i%32 == 31 */
    const __m256i vlow13 = _mm256_set1_epi32(0x1FFF);
    for (; i >= 31; i -= 32) {
        const uint8_t *ip = in + i - 31;   /* ip[j] -> state j */
        int v;
        for (v = 3; v >= 0; v--) {         /* states 31..24 first */
            __m256i x = _mm256_load_si256((const __m256i *)(st + 8 * v));
            __m256i sv = _mm256_cvtepu8_epi32(
                _mm_loadl_epi64((const __m128i *)(ip + 8 * v)));
            __m256i xmax = _mm256_i32gather_epi32((const int *)T->x_max,
                                                  sv, 4);
            /* emission, lanes DESCENDING (scalar processes i downward) */
            __m256i nm = _mm256_xor_si256(
                _mm256_cmpgt_epi32(xmax, x), _mm256_set1_epi32(-1));
            int need = _mm256_movemask_ps(_mm256_castsi256_ps(nm));
            if (need) {
                uint32_t xs[8] __attribute__((aligned(32)));
                uint32_t xm[8] __attribute__((aligned(32)));
                _mm256_store_si256((__m256i *)xs, x);
                _mm256_store_si256((__m256i *)xm, xmax);
                int l;
                for (l = 7; l >= 0; l--) {
                    uint32_t xv = xs[l];
                    while (xv >= xm[l]) {
                        body[blen++] = (xv >> 8) & 0xFF;
                        body[blen++] = xv & 0xFF;
                        xv >>= 16;
                    }
                    xs[l] = xv;
                }
                x = _mm256_load_si256((const __m256i *)xs);
            }
            __m256i rcp = _mm256_i32gather_epi32((const int *)T->rcp,
                                                 sv, 4);
            __m256i aux = _mm256_i32gather_epi32((const int *)T->aux,
                                                 sv, 4);
            /* q = mulhi32(x, rcp) >> (aux&0xF) */
            __m256i pe = _mm256_mul_epu32(x, rcp);
            __m256i po = _mm256_mul_epu32(_mm256_srli_epi64(x, 32),
                                          _mm256_srli_epi64(rcp, 32));
            __m256i hi = _mm256_blend_epi32(
                _mm256_srli_epi64(pe, 32), po, 0xAA);
            __m256i q = _mm256_srlv_epi32(hi,
                                          _mm256_and_si256(aux,
                                              _mm256_set1_epi32(0xF)));
            __m256i cmpl = _mm256_and_si256(_mm256_srli_epi32(aux, 4),
                                            vlow13);
            __m256i bias = _mm256_srli_epi32(aux, 17);
            x = _mm256_add_epi32(_mm256_add_epi32(x, bias),
                                 _mm256_mullo_epi32(q, cmpl));
            _mm256_store_si256((__m256i *)(st + 8 * v), x);
        }
    }
    if ((size_t)blen + 128 + 4 * 32 > cap) { free(body); free(T); return -1; }
    /* final segment: 32 u32le heads + byte-reversed body */
    size_t total = 4 * 32 + blen;
    uint8_t *seg = (uint8_t *)malloc(total ? total : 1);
    if (!seg) { free(body); free(T); return -1; }
    for (j = 0; j < 32; j++) {
        seg[4 * j + 0] = (uint8_t)st[j];
        seg[4 * j + 1] = (uint8_t)(st[j] >> 8);
        seg[4 * j + 2] = (uint8_t)(st[j] >> 16);
        seg[4 * j + 3] = (uint8_t)(st[j] >> 24);
    }
    {
        size_t k;
        uint8_t *w = seg + 128;
        for (k = 0; k < blen; k++) w[k] = body[blen - 1 - k];
    }
    free(body);
    free(T);
    *out = seg;
    *out_len = total;
    return 0;
}

/* ---- order-1 encode ------------------------------------------------ */

__attribute__((target("avx2")))
int rans32x16_enc_o1_avx2(const uint8_t *in, int64_t n,
                          const int64_t F[256][256],
                          const int64_t C[256][256], uint8_t **out,
                          size_t *out_len) {
    if (!rans32x16_have_avx2()) return 1;
    if (n <= 0) return 1;               /* degenerate: scalar path */
    /* dense per-(ctx,sym) encode tables over used contexts */
    int ctx_idx[256];
    int nused = 0, c, s;
    for (c = 0; c < 256; c++) ctx_idx[c] = -1;
    for (c = 0; c < 256; c++) {
        int64_t sum = 0;
        for (s = 0; s < 256; s++) sum += F[c][s];
        if (sum) ctx_idx[c] = nused++;
    }
    uint32_t *rcp = (uint32_t *)malloc((size_t)nused * 256 * 4);
    uint32_t *aux = (uint32_t *)malloc((size_t)nused * 256 * 4);
    uint32_t *xmx = (uint32_t *)malloc((size_t)nused * 256 * 4);
    if (!rcp || !aux || !xmx) { free(rcp); free(aux); free(xmx); return -1; }
    for (c = 0; c < 256; c++) {
        if (ctx_idx[c] < 0) continue;
        size_t base = (size_t)ctx_idx[c] * 256;
        for (s = 0; s < 256; s++) {
            uint32_t fr = (uint32_t)F[c][s];
            uint32_t cm = (uint32_t)C[c][s];
            uint32_t bias, rshift;
            uint64_t r;
            xmx[base + s] = ((R4X16_L >> TF_SHIFT) << 16) * fr;
            if (fr < 2) {
                r = 0xFFFFFFFFull;
                rshift = 0;
                bias = cm + TOTFREQ - 1;
            } else {
                uint32_t sh = 0;
                while (fr > (1u << sh)) sh++;
                r = ((((uint64_t)1 << (sh + 31)) + fr - 1) / fr);
                rshift = sh - 1;
                bias = cm;
            }
            rcp[base + s] = (uint32_t)r;
            aux[base + s] = rshift | ((TOTFREQ - fr) << 4) | (bias << 17);
        }
    }
    size_t cap = (size_t)n * 2 + 256;
    uint8_t *body = (uint8_t *)malloc(cap);
    if (!body) { free(rcp); free(aux); free(xmx); return -1; }
    size_t blen = 0;
    uint32_t st[32] __attribute__((aligned(32)));
    int j;
    for (j = 0; j < 32; j++) st[j] = R4X16_L;
    int64_t seg = n / 32;

    /* tail first: the scalar core's reversed order array processes
     * i = n-1 .. 32*seg on state 31 */
    {
        int64_t i;
        for (i = n - 1; i >= 32 * seg; i--) {
            /* tail positions are never segment heads except i==0 (the
             * seg==0 small-n case) */
            int ctx = (i == 0) ? 0 : in[i - 1];
            int sym = in[i];
            int ci = ctx_idx[ctx];
            if (ci < 0) goto fail;
            size_t e = (size_t)ci * 256 + sym;
            uint32_t x = st[31];
            while (x >= xmx[e]) {
                body[blen++] = (x >> 8) & 0xFF;
                body[blen++] = x & 0xFF;
                x >>= 16;
            }
            uint32_t a = aux[e];
            uint32_t q = (uint32_t)((((uint64_t)x * rcp[e]) >> 32)
                                    >> (a & 0xF));
            st[31] = x + (a >> 17) + q * ((a >> 4) & 0x1FFF);
        }
    }
    /* rounds r = seg-1 .. 0, lanes 31..0 (the reversed round-robin).
     * Symbols/contexts come straight from the input: sym = in[j*seg+r],
     * ctx = r ? in[j*seg+r-1] : 0. */
    if (seg) {
        const __m256i vlow13 = _mm256_set1_epi32(0x1FFF);
        uint32_t cur_syms[32] __attribute__((aligned(32)));
        uint32_t prev_syms[32] __attribute__((aligned(32)));
        int64_t r;
        for (j = 0; j < 32; j++)
            cur_syms[j] = in[(int64_t)j * seg + (seg - 1)];
        for (r = seg - 1; r >= 0; r--) {
            int l;
            if (r > 0)
                for (l = 0; l < 32; l++)
                    prev_syms[l] = in[(int64_t)l * seg + (r - 1)];
            else
                memset(prev_syms, 0, sizeof prev_syms);
            /* per-lane dense table index = ctx_idx[ctx]*256 + sym */
            uint32_t idx[32] __attribute__((aligned(32)));
            for (l = 0; l < 32; l++) {
                int ci = ctx_idx[prev_syms[l]];
                if (ci < 0) goto fail;
                idx[l] = (uint32_t)ci * 256 + cur_syms[l];
            }
            int v;
            for (v = 3; v >= 0; v--) {       /* states 31..24 first */
                __m256i x = _mm256_load_si256((const __m256i *)(st + 8 * v));
                __m256i iv = _mm256_load_si256((const __m256i *)(idx + 8 * v));
                __m256i xmax = _mm256_i32gather_epi32((const int *)xmx,
                                                      iv, 4);
                __m256i nm = _mm256_xor_si256(
                    _mm256_cmpgt_epi32(xmax, x), _mm256_set1_epi32(-1));
                int need = _mm256_movemask_ps(_mm256_castsi256_ps(nm));
                if (need) {
                    uint32_t xs[8] __attribute__((aligned(32)));
                    uint32_t xm[8] __attribute__((aligned(32)));
                    _mm256_store_si256((__m256i *)xs, x);
                    _mm256_store_si256((__m256i *)xm, xmax);
                    for (l = 7; l >= 0; l--) {
                        uint32_t xv = xs[l];
                        while (xv >= xm[l]) {
                            body[blen++] = (xv >> 8) & 0xFF;
                            body[blen++] = xv & 0xFF;
                            xv >>= 16;
                        }
                        xs[l] = xv;
                    }
                    x = _mm256_load_si256((const __m256i *)xs);
                }
                __m256i rc = _mm256_i32gather_epi32((const int *)rcp,
                                                    iv, 4);
                __m256i au = _mm256_i32gather_epi32((const int *)aux,
                                                    iv, 4);
                __m256i pe = _mm256_mul_epu32(x, rc);
                __m256i po = _mm256_mul_epu32(_mm256_srli_epi64(x, 32),
                                              _mm256_srli_epi64(rc, 32));
                __m256i hi = _mm256_blend_epi32(
                    _mm256_srli_epi64(pe, 32), po, 0xAA);
                __m256i q = _mm256_srlv_epi32(
                    hi, _mm256_and_si256(au, _mm256_set1_epi32(0xF)));
                __m256i cmpl = _mm256_and_si256(_mm256_srli_epi32(au, 4),
                                                vlow13);
                __m256i bias = _mm256_srli_epi32(au, 17);
                x = _mm256_add_epi32(_mm256_add_epi32(x, bias),
                                     _mm256_mullo_epi32(q, cmpl));
                _mm256_store_si256((__m256i *)(st + 8 * v), x);
            }
            memcpy(cur_syms, prev_syms, sizeof cur_syms);
        }
    }
    {
        size_t total = 4 * 32 + blen;
        uint8_t *segb = (uint8_t *)malloc(total ? total : 1);
        if (!segb) goto fail;
        for (j = 0; j < 32; j++) {
            segb[4 * j + 0] = (uint8_t)st[j];
            segb[4 * j + 1] = (uint8_t)(st[j] >> 8);
            segb[4 * j + 2] = (uint8_t)(st[j] >> 16);
            segb[4 * j + 3] = (uint8_t)(st[j] >> 24);
        }
        size_t k;
        uint8_t *w = segb + 128;
        for (k = 0; k < blen; k++) w[k] = body[blen - 1 - k];
        free(body); free(rcp); free(aux); free(xmx);
        *out = segb;
        *out_len = total;
        return 0;
    }
fail:
    free(body); free(rcp); free(aux); free(xmx);
    return -1;
}

#else  /* !R32_X86 */

int rans32x16_have_avx2(void) { return 0; }
int rans32x16_dec_o0_avx2(const uint8_t *buf, uint64_t len, uint64_t *p,
                          int64_t n_out, const int64_t *f,
                          const int64_t *cum, uint8_t *out) {
    (void)buf; (void)len; (void)p; (void)n_out; (void)f; (void)cum;
    (void)out;
    return 1;
}
int rans32x16_dec_o1_avx2(const uint8_t *buf, uint64_t len, uint64_t *p,
                          int64_t n_out, const int64_t F[256][256],
                          const int64_t C[256][256], uint8_t *out) {
    (void)buf; (void)len; (void)p; (void)n_out; (void)F; (void)C;
    (void)out;
    return 1;
}
int rans32x16_enc_o0_avx2(const uint8_t *in, int64_t n, const int64_t *f,
                          const int64_t *cum, uint8_t **out,
                          size_t *out_len) {
    (void)in; (void)n; (void)f; (void)cum; (void)out; (void)out_len;
    return 1;
}
int rans32x16_enc_o1_avx2(const uint8_t *in, int64_t n,
                          const int64_t F[256][256],
                          const int64_t C[256][256], uint8_t **out,
                          size_t *out_len) {
    (void)in; (void)n; (void)F; (void)C; (void)out; (void)out_len;
    return 1;
}

#endif
