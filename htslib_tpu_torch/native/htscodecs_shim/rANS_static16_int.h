/* Internal interface between the rANS Nx16 front end
 * (rANS_static4x16pr.c) and the vectorised 32-state cores
 * (rANS_static32x16pr*.c).  The 32-way wire format interleaves 32
 * 16-bit-renormalised states (u32le heads, byte-reversed emission);
 * these cores implement the same byte-exact streams with AVX2.
 *
 * Return convention: 0 ok, -1 malformed/alloc failure, 1 = tier not
 * available on this CPU/build (caller falls back to the scalar core).
 */
#ifndef RANS_STATIC16_INT_H
#define RANS_STATIC16_INT_H

#include <stdint.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

/* 1 when the AVX2 tier is compiled in AND the CPU supports it */
int rans32x16_have_avx2(void);

/* order-0, 32-way decode: states already NOT read — the core reads the
 * 32 u32le heads at *p itself and advances *p past every byte it
 * consumes.  f/cum are the 4096-normalised tables. */
int rans32x16_dec_o0_avx2(const uint8_t *buf, uint64_t len, uint64_t *p,
                          int64_t n_out, const int64_t *f,
                          const int64_t *cum, uint8_t *out);

/* order-1, 32-way decode: F/C are the per-context tables (ctx = previous
 * byte, 0 at segment heads); stream split into 32 floor(n/32) segments
 * plus a last-state tail. */
int rans32x16_dec_o1_avx2(const uint8_t *buf, uint64_t len, uint64_t *p,
                          int64_t n_out, const int64_t F[256][256],
                          const int64_t C[256][256], uint8_t *out);

/* order-0, 32-way encode: produces the complete core segment
 * ([32 x u32le heads][byte-reversed emission body]) in *out
 * (malloc'd, caller frees). */
int rans32x16_enc_o0_avx2(const uint8_t *in, int64_t n, const int64_t *f,
                          const int64_t *cum, uint8_t **out,
                          size_t *out_len);

/* order-1, 32-way encode: same output contract; F/C are the
 * per-context tables (ctx = previous byte, 0 at the 32 floor-segment
 * heads), emission order matching the scalar core's reversed
 * (round, state) order array. */
int rans32x16_enc_o1_avx2(const uint8_t *in, int64_t n,
                          const int64_t F[256][256],
                          const int64_t C[256][256], uint8_t **out,
                          size_t *out_len);

/* SSE4.1 tier (rANS_static32x16pr_sse4.c): same contracts as the AVX2
 * entries; the front end tries AVX2 first, then SSE4, then scalar. */
int rans32x16_have_sse4(void);
int rans32x16_dec_o0_sse4(const uint8_t *buf, uint64_t len, uint64_t *p,
                          int64_t n_out, const int64_t *f,
                          const int64_t *cum, uint8_t *out);
int rans32x16_dec_o1_sse4(const uint8_t *buf, uint64_t len, uint64_t *p,
                          int64_t n_out, const int64_t F[256][256],
                          const int64_t C[256][256], uint8_t *out);
int rans32x16_enc_o0_sse4(const uint8_t *in, int64_t n, const int64_t *f,
                          const int64_t *cum, uint8_t **out,
                          size_t *out_len);
int rans32x16_enc_o1_sse4(const uint8_t *in, int64_t n,
                          const int64_t F[256][256],
                          const int64_t C[256][256], uint8_t **out,
                          size_t *out_len);

#ifdef __cplusplus
}
#endif

#endif
