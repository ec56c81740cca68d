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
// member; each step is a 64-bit window read at the bit cursor (two or three
// 32-bit loads, cached), one or two shared-memory lookups and the output
// store.  A batch of BGZF members is as many independent chains, so the
// card's throughput is the chains in flight over a step's latency.
//
// Design: one warp (one block) a member, as the rANS kernels take one warp
// a stream.  Every lane runs the same decode on the same values, so its
// branches are uniform and no value is broadcast; lane 0 writes literals,
// the warp copies stored chunks and matches whose source lies wholly
// before them (out[pos + i] = out[pos - dist + i % dist], lane i's bytes),
// and lane 0 copies byte by byte the rare match that reaches before the
// output's start (JAX's clamp).  The codes' lookups (10 bits of literal/
// length, 8 of distance, 7 of precode, longer codes walking the canonical
// code) and the code lengths live in shared memory, about 4.5 KB a member,
// built by the warp at each block.  Output bytes go straight to the
// member's slot in device memory, never past its ISIZE (at most 64 KiB).
#include <cuda_runtime.h>
#include <stdint.h>

#include "inflate_step.cuh"

namespace {

constexpr int kWarp = 32;

__global__ void __launch_bounds__(kWarp)
    inflate_kernel(const uint8_t* in, const int64_t* in_off,
                   const int32_t* in_len, uint8_t* out,
                   const int64_t* out_off, const int32_t* out_cap,
                   int32_t* stats) {
  __shared__ InflTables t;
  const int lane = threadIdx.x;
  const int m = blockIdx.x;
  const InflResult r = infl_member(
      reinterpret_cast<const uint32_t*>(in + in_off[m]), (uint32_t)in_len[m],
      out + out_off[m], (uint32_t)out_cap[m], &t, lane, kWarp);
  if (lane == 0) {
    stats[4 * m + 0] = r.err;
    stats[4 * m + 1] = r.produced;
    stats[4 * m + 2] = r.tokens;
    stats[4 * m + 3] = r.steps;
  }
}

}  // namespace

// Inflate n members on `stream`: member m's payload is in_len[m] bytes at
// in + in_off[m] (4-byte aligned), its output out_cap[m] (<= 65,536) bytes
// at out + out_off[m]; stats[4m .. 4m+3] get its error code, the bytes its
// tokens produce, its tokens and its steps.  Returns cudaGetLastError()
// after the launch.
extern "C" int inflate_launch(const void* in, const void* in_off,
                              const void* in_len, void* out,
                              const void* out_off, const void* out_cap,
                              void* stats, int n, void* stream) {
  if (n <= 0) return 0;
  inflate_kernel<<<n, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<const int64_t*>(in_off),
      static_cast<const int32_t*>(in_len), static_cast<uint8_t*>(out),
      static_cast<const int64_t*>(out_off),
      static_cast<const int32_t*>(out_cap), static_cast<int32_t*>(stats));
  return static_cast<int>(cudaGetLastError());
}

// Bytes of shared memory a block (a member) takes.
extern "C" int inflate_smem_bytes() { return (int)sizeof(InflTables); }

// Members one SM decodes at once, or minus a CUDA error code.
extern "C" int inflate_blocks_per_sm() {
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, inflate_kernel, kWarp, 0);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

extern "C" const char* kernel_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
