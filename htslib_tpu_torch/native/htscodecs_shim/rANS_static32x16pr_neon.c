/* NEON tier: DEFERRED (decision recorded 2026-08-21, round 5).
 *
 * No aarch64 hardware exists in this build/bench environment (x86-64
 * host, TPU accelerator), so a NEON tier could be written but never
 * compiled for its target ISA, executed, or benchmarked here.  Shipping
 * unexecuted SIMD code would be worse than an honest fallback: non-x86
 * targets take the scalar cores in rANS_static4x16pr.c, which are
 * byte-exact on every wire.  When an aarch64 target appears, the SSE4.1
 * TU (rANS_static32x16pr_sse4.c) is the template to port: 4 states per
 * 128-bit register, per-lane table lookups (NEON, like SSE4, has no
 * 32-bit gather), vectorised state update via vmulq_u32/vaddq_u32, and
 * the two-stage reciprocal multiply mapped to vmull_u32 pairs.
 * Reference per-ISA file list: htscodecs_bundled.mk:26-40. */
#include "rANS_static16_int.h"
int rans32x16_have_neon_tier(void) { return 0; }
