/* AVX512 tier alias: AVX512-capable CPUs also have AVX2, so they take
 * the AVX2 cores in rANS_static32x16pr_avx2.c (runtime dispatched).
 * This TU exists to satisfy the htscodecs_bundled.mk per-ISA file
 * list. */
#include "rANS_static16_int.h"
int rans32x16_have_avx512_tier(void) { return rans32x16_have_avx2(); }
