// The rANS resolve chain on Hopper (kernel B4): G independent chains of
// `rounds` dependent decode steps, each followed by the renormalisation
// x = (x << 16) | 1 where x < 2^15.
//
// Replaces: htslib_tpu/ops/rans_pallas.py:make_resolve_bench.kernel (the
// "gather wall" figure of scripts/bench_device.py, step 1).
//
// What bounds it: the chain.  Every step needs the previous state, so a
// chain is `rounds` times the latency of one step (a shared-memory load,
// a multiply-add and a compare); the bytes and operations are negligible.
//
// Design: one 32-thread block per chain.  The lanes build the chain's
// 4096-slot table in shared memory with rans_o0_build_slots (one u32 per
// slot packing f - 1, the slot's offset within its symbol and the symbol,
// as the decode kernels do), so a step is one shared-memory load; then
// lane 0 runs the chain with rans_o0_decode.  G = 128 chains fit the 132
// SMs one block each, so the chains run side by side.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rans_nx16_step.cuh"

namespace {

__global__ void __launch_bounds__(32) rans_resolve_bench_kernel(
    const int32_t* __restrict__ freqs, const uint32_t* __restrict__ x0,
    uint32_t* __restrict__ x_out, int64_t rounds) {
  __shared__ uint32_t slot[RANS_TOTFREQ];
  __shared__ uint16_t f[256];
  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  for (int s = lane; s < 256; s += 32)
    f[s] = (uint16_t)freqs[(int64_t)g * 256 + s];
  __syncwarp();
  rans_o0_build_slots(f, slot, lane, 32);
  __syncwarp();
  if (lane != 0) return;
  uint32_t x = x0[g];
  for (int64_t r = 0; r < rounds; ++r) {
    rans_o0_decode(&x, slot);
    if (rans_needs_refill(x)) x = rans_refill(x, 1u);
  }
  x_out[g] = x;
}

}  // namespace

// Run G chains of `rounds` steps on `stream`.  Returns cudaGetLastError()
// after the launch.
extern "C" int rans_resolve_bench_launch(const void* freqs, const void* x0,
                                         void* x_out, int G, long long rounds,
                                         void* stream) {
  if (G <= 0) return 0;
  rans_resolve_bench_kernel<<<G, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(freqs), static_cast<const uint32_t*>(x0),
      static_cast<uint32_t*>(x_out), (int64_t)rounds);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
