/* 32-state rANS Nx16 tier — portable core + ISA dispatch.
 *
 * The 32-way (X32) wire format is implemented in three places:
 *   - the scalar N-way cores in rANS_static4x16pr.c (always available),
 *   - the AVX2 cores in rANS_static32x16pr_avx2.c (x86-64, runtime
 *     __builtin_cpu_supports dispatch via rans32x16_have_avx2()),
 *   - this TU, which re-exports the capability probe for builds that
 *     compile the per-ISA file list from htscodecs_bundled.mk.
 *
 * The SSE4/AVX512/NEON translation units alias the best available tier
 * for their target (AVX2 is the implemented vector tier on x86-64; the
 * scalar core covers everything else) — the dispatch contract is the
 * same as upstream htscodecs' rans_cpu detection.
 */
#include "rANS_static16_int.h"

int rans32x16_simd_tier(void) {
    return rans32x16_have_avx2() ? 2 : 0;   /* 2=AVX2, 0=scalar */
}
