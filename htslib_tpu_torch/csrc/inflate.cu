// DEFLATE inflate of independent members (kernel X4), one launch for the
// whole batch: the BGZF read side in front of the BAM record path.
//
// Replaces: htslib_tpu/ops/inflate.py:429 _compiled, XLA code (no Pallas
// kernel): pass A, a lax.while_loop of lax.scan chunks that advances every
// member one DEFLATE item a step through about a hundred elementwise ops,
// with dense 2^15-entry tables a member rebuilt between chunks, then pass
// B, token resolution by cumsum, scatter and 16 rounds of pointer doubling
// over [B, 65536].  Run eagerly that is one launch per op per step; here a
// member is one serial decode (inflate_step.cuh), which needs neither the
// token list nor the pointer doubling, with the same bytes and the same
// errors as the JAX function.
//
// What bounds it: the decode's chain, not bytes or operations.  A member is
// one chain of dependent steps (each symbol's bit position is known only
// after the one before it is decoded), some 10,000-40,000 for a 64 KiB
// member; each step is one or two table lookups, the bits they take and a
// literal store or a match copy.  A batch of BGZF members is as many
// independent chains, so the card's throughput is the chains in flight
// over a step's latency, and a launch lasts as long as its longest
// member's chain (times the waves, where the batch outgrows the card).
//
// Design: one warp (one block) a member, as the rANS kernels take one warp
// a stream.  Every lane runs the same decode on the same values, so its
// branches are uniform and no value is broadcast.  The payload is staged
// ahead of the bit cursor by cp.async into a ring in shared memory and the
// bits wait in a 64-bit register reservoir refilled from words the step
// loaded at its start (inflate_step.cuh, InflSmem).  Literal/length steps
// run in a loop of their own, a run of plain literals in a tighter one
// still (every lane stores the literal, the same byte); the warp copies
// matches and stored chunks.  The codes' lookups (10 bits of literal/
// length, 8 of distance, 7 of precode, longer codes walking the canonical
// code) are built by the warp at each block.
//
// Two variants, which differ in the output window that matches read:
//   - inflate_launch: a 32 KiB ring in shared memory, flushed to the
//     member's slot 4 KiB at a time with 16-byte stores, so no step reads
//     device memory; 37,680 B a member, 6 members an SM (792 on 132 SMs);
//   - inflate_slot_launch: the member's slot in device memory, as the
//     first design had it (matches read it back, mostly from L2); 4,904 B
//     a member, 32 members an SM.
// A launch lasts about its longest member's steps x a step's time x its
// waves.  On an H100 over leg 7's BAM members (chip_smoke.py,
// probe_x4_x6.py), the ring takes 236 ns a step and the slot variant 266
// at 792 members (both one wave); at 1,232, 4,224 and 16,016 members the
// ring's waves (2, 6, 21) cost it 12.8, 36.8 and 128 ms against the slot
// variant's 8.0, 14.2 and 48.5.  So ops/inflate.py runs the ring while a
// batch fits one wave of it, and the slot variant past that.
//
// The step is bound by its own instruction chain (lookups, branches,
// 64-bit shifts), not by memory: taking device memory off it alone left
// it at 440 ns on an H100; the literal/length loops shorten the chain.
#include <cuda_runtime.h>
#include <stdint.h>

#include "inflate_step.cuh"

namespace {

constexpr int kWarp = 32;
// the output ring's offset in a block's shared memory, 16-byte aligned
constexpr int kRingAt = (sizeof(InflSmem) + 15) / 16 * 16;

// Bytes of shared memory a block of the variant takes.
constexpr int smem_of(bool ring) {
  return ring ? kRingAt + INFL_RING : (int)sizeof(InflSmem);
}

// The slot variant is held to 64 registers, for 32 members an SM (with a
// few bytes of spills): 14.2 against 16.8 ms at 4,224 of leg 7's members
// and 48.5 against 52.3 at 16,016 on an H100, 8.0 against 7.7 at 1,232.
template <bool RING>
__global__ void __launch_bounds__(kWarp, RING ? 1 : 32)
    inflate_kernel(const uint8_t* in, const int64_t* in_off,
                   const int32_t* in_len, uint8_t* out,
                   const int64_t* out_off, const int32_t* out_cap,
                   int32_t* stats) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x;
  const int m = blockIdx.x;
  const InflResult r = infl_member<RING>(
      reinterpret_cast<const uint32_t*>(in + in_off[m]), (uint32_t)in_len[m],
      out + out_off[m], (uint32_t)out_cap[m], smem + kRingAt,
      reinterpret_cast<InflSmem*>(smem), lane, kWarp);
  if (lane == 0) {
    stats[4 * m + 0] = r.err;
    stats[4 * m + 1] = r.produced;
    stats[4 * m + 2] = r.tokens;
    stats[4 * m + 3] = r.steps;
  }
}

template <bool RING>
int launch(const void* in, const void* in_off, const void* in_len, void* out,
           const void* out_off, const void* out_cap, void* stats, int n,
           void* stream) {
  if (n <= 0) return 0;
  inflate_kernel<RING><<<n, kWarp, smem_of(RING),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<const int64_t*>(in_off),
      static_cast<const int32_t*>(in_len), static_cast<uint8_t*>(out),
      static_cast<const int64_t*>(out_off),
      static_cast<const int32_t*>(out_cap), static_cast<int32_t*>(stats));
  return static_cast<int>(cudaGetLastError());
}

template <bool RING>
int blocks_per_sm() {
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, inflate_kernel<RING>, kWarp, smem_of(RING));
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

}  // namespace

// Inflate n members on `stream`: member m's payload is in_len[m] bytes at
// in + in_off[m] (4-byte aligned), its output out_cap[m] (<= 65,536) bytes
// at out + out_off[m]; stats[4m .. 4m+3] get its error code, the bytes its
// tokens produce, its tokens and its steps.  Returns cudaGetLastError()
// after the launch.  The output window is a shared-memory ring.
extern "C" int inflate_launch(const void* in, const void* in_off,
                              const void* in_len, void* out,
                              const void* out_off, const void* out_cap,
                              void* stats, int n, void* stream) {
  return launch<true>(in, in_off, in_len, out, out_off, out_cap, stats, n,
                      stream);
}

// The same with the output window in the member's slot.
extern "C" int inflate_slot_launch(const void* in, const void* in_off,
                                   const void* in_len, void* out,
                                   const void* out_off, const void* out_cap,
                                   void* stats, int n, void* stream) {
  return launch<false>(in, in_off, in_len, out, out_off, out_cap, stats, n,
                       stream);
}

// Bytes of shared memory a block (a member) takes, and the members one SM
// decodes at once (or minus a CUDA error code), of each variant.
extern "C" int inflate_smem_bytes() { return smem_of(true); }
extern "C" int inflate_blocks_per_sm() { return blocks_per_sm<true>(); }
extern "C" int inflate_slot_smem_bytes() { return smem_of(false); }
extern "C" int inflate_slot_blocks_per_sm() { return blocks_per_sm<false>(); }

extern "C" const char* kernel_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
