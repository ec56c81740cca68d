/* SSE4.1 32-state rANS Nx16 cores (the X32 wire tier for pre-AVX2
 * x86-64; reference build list htscodecs_bundled.mk:26-40).  Byte-exact
 * with the scalar cores in rANS_static4x16pr.c and the AVX2 cores in
 * rANS_static32x16pr_avx2.c: identical stream consumption order (states
 * ascending per 32-output round on decode, descending on encode) and
 * identical renormalisation.
 *
 * Narrowing strategy vs the AVX2 cores: 4 states per XMM register
 * (8 vectors).  SSE4.1 has no vector gather, so table lookups spill to
 * 4 scalar loads per vector; the state arithmetic (slot mask, f/c/sym
 * unpack, mullo update, renorm detection via movemask) stays
 * vectorised.  The encode reciprocal division q = (x*rcp >> 32) >>
 * rshift has no per-lane variable shift in SSE4.1; the table instead
 * carries sh2 = 2^(31-rshift) so q = ((x*rcp >> 32) * sh2) >> 31 runs
 * as two mul_epu32 pairs (exact: hi < 2^31, product < 2^62).
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
#include <smmintrin.h>

#define TF_SHIFT 12
#define TOTFREQ (1u << TF_SHIFT)
#define R4X16_L (1u << 15)

int rans32x16_have_sse4(void) {
    static int have = -1;
    if (have < 0)
        have = __builtin_cpu_supports("sse4.1") ? 1 : 0;
    return have;
}

/* hi32 of unsigned 32x32 multiply for 4 lanes */
__attribute__((target("sse4.1")))
static inline __m128i mulhi_epu32_sse(__m128i a, __m128i b) {
    __m128i pe = _mm_mul_epu32(a, b);                       /* lanes 0,2 */
    __m128i po = _mm_mul_epu32(_mm_srli_epi64(a, 32),
                               _mm_srli_epi64(b, 32));      /* lanes 1,3 */
    /* take the high halves: pe hi -> lanes 0,2; po hi -> lanes 1,3 */
    return _mm_blend_epi16(_mm_srli_epi64(pe, 32), po, 0xCC);
}

/* ---- order-0 decode ------------------------------------------------ */

__attribute__((target("sse4.1")))
int rans32x16_dec_o0_sse4(const uint8_t *buf, uint64_t len, uint64_t *p,
                          int64_t n_out, const int64_t *f,
                          const int64_t *cum, uint8_t *out) {
    if (!rans32x16_have_sse4()) return 1;
    uint32_t *packed = (uint32_t *)calloc(TOTFREQ, 4);
    if (!packed) return -1;
    {
        int s;
        for (s = 0; s < 256; s++) {
            if (!f[s]) continue;
            int64_t c = cum[s], e = cum[s] + f[s];
            if (c < 0 || e > TOTFREQ) { free(packed); return -1; }
            uint32_t v = (uint32_t)(f[s] - 1) | ((uint32_t)cum[s] << 12)
                       | ((uint32_t)s << 24);
            int64_t m;
            for (m = c; m < e; m++) packed[m] = v;
        }
    }
    uint32_t st[32] __attribute__((aligned(16)));
    int j;
    for (j = 0; j < 32; j++) {
        if (*p + 4 > len) { free(packed); return -1; }
        st[j] = (uint32_t)buf[*p] | ((uint32_t)buf[*p + 1] << 8)
              | ((uint32_t)buf[*p + 2] << 16) | ((uint32_t)buf[*p + 3] << 24);
        *p += 4;
    }
    const __m128i vmask = _mm_set1_epi32(TOTFREQ - 1);
    const __m128i vL = _mm_set1_epi32(R4X16_L);
    const __m128i v1 = _mm_set1_epi32(1);
    int64_t i = 0;
    int64_t n_full = n_out - (n_out % 32);
    uint64_t pp = *p;
    for (; i < n_full; i += 32) {
        int v;
        for (v = 0; v < 8; v++) {
            __m128i x = _mm_load_si128((const __m128i *)(st + 4 * v));
            __m128i m = _mm_and_si128(x, vmask);
            /* no gather in SSE4.1: 4 scalar lookups */
            uint32_t mv[4] __attribute__((aligned(16)));
            uint32_t tv[4] __attribute__((aligned(16)));
            _mm_store_si128((__m128i *)mv, m);
            tv[0] = packed[mv[0]]; tv[1] = packed[mv[1]];
            tv[2] = packed[mv[2]]; tv[3] = packed[mv[3]];
            __m128i t = _mm_load_si128((const __m128i *)tv);
            __m128i fv = _mm_add_epi32(_mm_and_si128(t, vmask), v1);
            __m128i cv = _mm_and_si128(_mm_srli_epi32(t, 12), vmask);
            /* x = f*(x>>12) + m - cum */
            x = _mm_add_epi32(
                    _mm_mullo_epi32(fv, _mm_srli_epi32(x, TF_SHIFT)),
                    _mm_sub_epi32(m, cv));
            {
                uint8_t *o = out + i + 4 * v;
                o[0] = (uint8_t)(tv[0] >> 24); o[1] = (uint8_t)(tv[1] >> 24);
                o[2] = (uint8_t)(tv[2] >> 24); o[3] = (uint8_t)(tv[3] >> 24);
            }
            /* 16-bit refills, lanes ascending (stream order) */
            int need = _mm_movemask_ps(_mm_castsi128_ps(
                _mm_cmpgt_epi32(vL, x)));
            if (need) {
                uint32_t xs[4] __attribute__((aligned(16)));
                _mm_store_si128((__m128i *)xs, x);
                int l;
                for (l = 0; l < 4; l++) {
                    uint32_t xv = xs[l];
                    while (xv < R4X16_L) {
                        if (pp + 2 > len) break;
                        xv = (xv << 16) | buf[pp]
                           | ((uint32_t)buf[pp + 1] << 8);
                        pp += 2;
                    }
                    xs[l] = xv;
                }
                x = _mm_load_si128((const __m128i *)xs);
            }
            _mm_store_si128((__m128i *)(st + 4 * v), x);
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

__attribute__((target("sse4.1")))
int rans32x16_dec_o1_sse4(const uint8_t *buf, uint64_t len, uint64_t *p,
                          int64_t n_out, const int64_t F[256][256],
                          const int64_t C[256][256], uint8_t *out) {
    if (!rans32x16_have_sse4()) return 1;
    uint32_t *packed = (uint32_t *)calloc((size_t)256 << TF_SHIFT, 4);
    if (!packed) return -1;
    int ctx, s;
    for (ctx = 0; ctx < 256; ctx++) {
        int64_t sum = 0;
        for (s = 0; s < 256; s++) sum += F[ctx][s];
        if (!sum) continue;
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
    uint32_t st[32] __attribute__((aligned(16)));
    uint32_t cx[32] __attribute__((aligned(16)));
    int j;
    for (j = 0; j < 32; j++) {
        if (*p + 4 > len) { free(packed); return -1; }
        st[j] = (uint32_t)buf[*p] | ((uint32_t)buf[*p + 1] << 8)
              | ((uint32_t)buf[*p + 2] << 16) | ((uint32_t)buf[*p + 3] << 24);
        *p += 4;
        cx[j] = 0;
    }
    int64_t seg = n_out / 32;
    const __m128i vmask = _mm_set1_epi32(TOTFREQ - 1);
    const __m128i vL = _mm_set1_epi32(R4X16_L);
    const __m128i v1 = _mm_set1_epi32(1);
    uint64_t pp = *p;
    int64_t r;
    for (r = 0; r < seg; r++) {
        int v;
        for (v = 0; v < 8; v++) {
            __m128i x = _mm_load_si128((const __m128i *)(st + 4 * v));
            __m128i m = _mm_and_si128(x, vmask);
            uint32_t mv[4] __attribute__((aligned(16)));
            uint32_t tv[4] __attribute__((aligned(16)));
            _mm_store_si128((__m128i *)mv, m);
            {
                const uint32_t *c4 = cx + 4 * v;
                tv[0] = packed[((size_t)c4[0] << TF_SHIFT) | mv[0]];
                tv[1] = packed[((size_t)c4[1] << TF_SHIFT) | mv[1]];
                tv[2] = packed[((size_t)c4[2] << TF_SHIFT) | mv[2]];
                tv[3] = packed[((size_t)c4[3] << TF_SHIFT) | mv[3]];
            }
            __m128i t = _mm_load_si128((const __m128i *)tv);
            __m128i fv = _mm_add_epi32(_mm_and_si128(t, vmask), v1);
            __m128i cv = _mm_and_si128(_mm_srli_epi32(t, 12), vmask);
            x = _mm_add_epi32(
                    _mm_mullo_epi32(fv, _mm_srli_epi32(x, TF_SHIFT)),
                    _mm_sub_epi32(m, cv));
            {
                int l;
                for (l = 0; l < 4; l++) {
                    uint32_t sym = tv[l] >> 24;
                    out[(int64_t)(4 * v + l) * seg + r] = (uint8_t)sym;
                    cx[4 * v + l] = sym;
                }
            }
            int need = _mm_movemask_ps(_mm_castsi128_ps(
                _mm_cmpgt_epi32(vL, x)));
            if (need) {
                uint32_t xs[4] __attribute__((aligned(16)));
                _mm_store_si128((__m128i *)xs, x);
                int l;
                for (l = 0; l < 4; l++) {
                    uint32_t xv = xs[l];
                    while (xv < R4X16_L) {
                        if (pp + 2 > len) break;
                        xv = (xv << 16) | buf[pp]
                           | ((uint32_t)buf[pp + 1] << 8);
                        pp += 2;
                    }
                    xs[l] = xv;
                }
                x = _mm_load_si128((const __m128i *)xs);
            }
            _mm_store_si128((__m128i *)(st + 4 * v), x);
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

/* ---- encode tables ------------------------------------------------- */

/* per-symbol encode tables (see rans_enc_sym_init provenance note in
 * htstpu.cc: the ryg_rans reciprocal method).  sh2 = 2^(31-rshift)
 * replaces the per-lane variable shift SSE4.1 lacks:
 * q = ((x*rcp >> 32) * sh2) >> 31. */
typedef struct {
    uint32_t rcp[256];
    uint32_t sh2[256];
    uint32_t cmpl[256];   /* TOTFREQ - f */
    uint32_t bias[256];
    uint32_t x_max[256];
} enc_tbl_sse_t;

static int enc_tbl_init_sse(enc_tbl_sse_t *T, const int64_t *f,
                            const int64_t *cum) {
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
        if (rcp > 0xFFFFFFFFull || rshift > 31) return -1;
        T->rcp[s] = (uint32_t)rcp;
        T->sh2[s] = 1u << (31 - rshift);
        T->cmpl[s] = TOTFREQ - fr;
        T->bias[s] = bias;
    }
    return 0;
}

/* one vectorised encode step for 4 states: emission (per-lane, lanes
 * descending = stream order), then x += bias + q*cmpl with the
 * two-stage mulhi reciprocal */
__attribute__((target("sse4.1")))
static inline __m128i enc_step4_sse(__m128i x, const uint32_t *xmax4,
                                    const uint32_t *rcp4,
                                    const uint32_t *sh24,
                                    const uint32_t *cmpl4,
                                    const uint32_t *bias4,
                                    uint8_t *body, size_t *blen) {
    __m128i xm = _mm_load_si128((const __m128i *)xmax4);
    /* unsigned x >= x_max detection: both < 2^31 here (x renormalised,
     * x_max = (2^3<<16)*f <= 2^31), signed compare is safe */
    __m128i ge = _mm_xor_si128(_mm_cmpgt_epi32(xm, x),
                               _mm_set1_epi32(-1));
    int need = _mm_movemask_ps(_mm_castsi128_ps(ge));
    if (need) {
        uint32_t xs[4] __attribute__((aligned(16)));
        int l;
        _mm_store_si128((__m128i *)xs, x);
        for (l = 3; l >= 0; l--) {
            uint32_t xv = xs[l];
            while (xv >= xmax4[l]) {
                body[(*blen)++] = (xv >> 8) & 0xFF;
                body[(*blen)++] = xv & 0xFF;
                xv >>= 16;
            }
            xs[l] = xv;
        }
        x = _mm_load_si128((const __m128i *)xs);
    }
    __m128i rc = _mm_load_si128((const __m128i *)rcp4);
    __m128i s2 = _mm_load_si128((const __m128i *)sh24);
    __m128i hi = mulhi_epu32_sse(x, rc);
    /* q = (hi * sh2) >> 31 (hi < 2^31, sh2 <= 2^31: product < 2^62) */
    __m128i qe = _mm_srli_epi64(_mm_mul_epu32(hi, s2), 31);
    __m128i qo = _mm_srli_epi64(
        _mm_mul_epu32(_mm_srli_epi64(hi, 32), _mm_srli_epi64(s2, 32)), 31);
    __m128i q = _mm_blend_epi16(qe, _mm_slli_epi64(qo, 32), 0xCC);
    __m128i cm = _mm_load_si128((const __m128i *)cmpl4);
    __m128i bi = _mm_load_si128((const __m128i *)bias4);
    return _mm_add_epi32(_mm_add_epi32(x, bi), _mm_mullo_epi32(q, cm));
}

/* ---- order-0 encode ------------------------------------------------ */

__attribute__((target("sse4.1")))
int rans32x16_enc_o0_sse4(const uint8_t *in, int64_t n, const int64_t *f,
                          const int64_t *cum, uint8_t **out,
                          size_t *out_len) {
    if (!rans32x16_have_sse4()) return 1;
    enc_tbl_sse_t *T = (enc_tbl_sse_t *)malloc(sizeof *T);
    if (!T) return -1;
    if (enc_tbl_init_sse(T, f, cum)) { free(T); return -1; }
    size_t cap = (size_t)(n > 0 ? n : 1) * 2 + 256;
    uint8_t *body = (uint8_t *)malloc(cap);
    if (!body) { free(T); return -1; }
    size_t blen = 0;
    uint32_t st[32] __attribute__((aligned(16)));
    int j;
    for (j = 0; j < 32; j++) st[j] = R4X16_L;

    int64_t i = n - 1;
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
        uint32_t q = (uint32_t)(((((uint64_t)x * T->rcp[s]) >> 32)
                                 * T->sh2[s]) >> 31);
        st[j] = x + T->bias[s] + q * T->cmpl[s];
    }
    for (; i >= 31; i -= 32) {
        const uint8_t *ip = in + i - 31;   /* ip[j] -> state j */
        int v;
        for (v = 7; v >= 0; v--) {         /* states 31..28 first */
            uint32_t xm4[4] __attribute__((aligned(16)));
            uint32_t rc4[4] __attribute__((aligned(16)));
            uint32_t s24[4] __attribute__((aligned(16)));
            uint32_t cm4[4] __attribute__((aligned(16)));
            uint32_t bi4[4] __attribute__((aligned(16)));
            int l;
            for (l = 0; l < 4; l++) {
                int s = ip[4 * v + l];
                xm4[l] = T->x_max[s]; rc4[l] = T->rcp[s];
                s24[l] = T->sh2[s]; cm4[l] = T->cmpl[s];
                bi4[l] = T->bias[s];
            }
            __m128i x = _mm_load_si128((const __m128i *)(st + 4 * v));
            x = enc_step4_sse(x, xm4, rc4, s24, cm4, bi4, body, &blen);
            _mm_store_si128((__m128i *)(st + 4 * v), x);
        }
    }
    if ((size_t)blen + 128 + 4 * 32 > cap) { free(body); free(T); return -1; }
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

__attribute__((target("sse4.1")))
int rans32x16_enc_o1_sse4(const uint8_t *in, int64_t n,
                          const int64_t F[256][256],
                          const int64_t C[256][256], uint8_t **out,
                          size_t *out_len) {
    if (!rans32x16_have_sse4()) return 1;
    if (n <= 0) return 1;               /* degenerate: scalar path */
    int ctx_idx[256];
    int nused = 0, c, s;
    for (c = 0; c < 256; c++) ctx_idx[c] = -1;
    for (c = 0; c < 256; c++) {
        int64_t sum = 0;
        for (s = 0; s < 256; s++) sum += F[c][s];
        if (sum) ctx_idx[c] = nused++;
    }
    uint32_t *rcp = (uint32_t *)malloc((size_t)nused * 256 * 4);
    uint32_t *sh2 = (uint32_t *)malloc((size_t)nused * 256 * 4);
    uint32_t *cmp = (uint32_t *)malloc((size_t)nused * 256 * 4);
    uint32_t *bia = (uint32_t *)malloc((size_t)nused * 256 * 4);
    uint32_t *xmx = (uint32_t *)malloc((size_t)nused * 256 * 4);
    uint8_t *body = NULL;
    if (!rcp || !sh2 || !cmp || !bia || !xmx) goto fail;
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
            sh2[base + s] = 1u << (31 - rshift);
            cmp[base + s] = TOTFREQ - fr;
            bia[base + s] = bias;
        }
    }
    {
        size_t cap = (size_t)n * 2 + 256;
        body = (uint8_t *)malloc(cap);
        if (!body) goto fail;
    }
    size_t blen = 0;
    uint32_t st[32] __attribute__((aligned(16)));
    int j;
    for (j = 0; j < 32; j++) st[j] = R4X16_L;
    int64_t seg = n / 32;

    /* tail first on state 31 (the scalar core's reversed order) */
    {
        int64_t i;
        for (i = n - 1; i >= 32 * seg; i--) {
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
            uint32_t q = (uint32_t)(((((uint64_t)x * rcp[e]) >> 32)
                                     * sh2[e]) >> 31);
            st[31] = x + bia[e] + q * cmp[e];
        }
    }
    if (seg) {
        uint32_t cur_syms[32], prev_syms[32];
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
            size_t idx[32];
            for (l = 0; l < 32; l++) {
                int ci = ctx_idx[prev_syms[l]];
                if (ci < 0) goto fail;
                idx[l] = (size_t)ci * 256 + cur_syms[l];
            }
            int v;
            for (v = 7; v >= 0; v--) {       /* states 31..28 first */
                uint32_t xm4[4] __attribute__((aligned(16)));
                uint32_t rc4[4] __attribute__((aligned(16)));
                uint32_t s24[4] __attribute__((aligned(16)));
                uint32_t cm4[4] __attribute__((aligned(16)));
                uint32_t bi4[4] __attribute__((aligned(16)));
                for (l = 0; l < 4; l++) {
                    size_t e = idx[4 * v + l];
                    xm4[l] = xmx[e]; rc4[l] = rcp[e]; s24[l] = sh2[e];
                    cm4[l] = cmp[e]; bi4[l] = bia[e];
                }
                __m128i x = _mm_load_si128((const __m128i *)(st + 4 * v));
                x = enc_step4_sse(x, xm4, rc4, s24, cm4, bi4, body, &blen);
                _mm_store_si128((__m128i *)(st + 4 * v), x);
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
        free(body); free(rcp); free(sh2); free(cmp); free(bia); free(xmx);
        *out = segb;
        *out_len = total;
        return 0;
    }
fail:
    free(body); free(rcp); free(sh2); free(cmp); free(bia); free(xmx);
    return -1;
}

#else  /* !R32_X86 */

int rans32x16_have_sse4(void) { return 0; }
int rans32x16_dec_o0_sse4(const uint8_t *buf, uint64_t len, uint64_t *p,
                          int64_t n_out, const int64_t *f,
                          const int64_t *cum, uint8_t *out) {
    (void)buf; (void)len; (void)p; (void)n_out; (void)f; (void)cum;
    (void)out;
    return 1;
}
int rans32x16_dec_o1_sse4(const uint8_t *buf, uint64_t len, uint64_t *p,
                          int64_t n_out, const int64_t F[256][256],
                          const int64_t C[256][256], uint8_t *out) {
    (void)buf; (void)len; (void)p; (void)n_out; (void)F; (void)C;
    (void)out;
    return 1;
}
int rans32x16_enc_o0_sse4(const uint8_t *in, int64_t n, const int64_t *f,
                          const int64_t *cum, uint8_t **out,
                          size_t *out_len) {
    (void)in; (void)n; (void)f; (void)cum; (void)out; (void)out_len;
    return 1;
}
int rans32x16_enc_o1_sse4(const uint8_t *in, int64_t n,
                          const int64_t F[256][256],
                          const int64_t C[256][256], uint8_t **out,
                          size_t *out_len) {
    (void)in; (void)n; (void)F; (void)C; (void)out; (void)out_len;
    return 1;
}

#endif
