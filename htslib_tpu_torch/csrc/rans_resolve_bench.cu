// The rANS resolve chain on Hopper (kernel B4): G independent chains of
// `rounds` dependent decode steps, each followed by the renormalisation
// x = (x << 16) | 1 where x < 2^15.
//
// Replaces: htslib_tpu/ops/rans_pallas.py:make_resolve_bench.kernel (the
// "gather wall" figure of scripts/bench_device.py, step 1).
//
// What bounds it: the chain.  Every step needs the previous state, so a
// chain is `rounds` times the latency of one step; the bytes and
// operations are negligible.  With one warp on its scheduler a step costs
// the latencies of the instructions on its chain, so the design puts as
// few as it can there (rans_resolve_step.cuh): the slot's address is one
// logic op on the doubled state, the table's two u16 columns hold the
// doubled f and offset (no field extract, no + 1), and the
// renormalisation is a predicated multiply-add after the load instead of a
// compare and select before its address: logic op, shared load,
// multiply-add, about 41 cycles (21 ns) a step against the parent's 12
// instructions and 34-37 ns.  Steps run 8 a loop step on a 32-bit count
// with no branch.
//
// Design: one 32-thread block per chain.  The lanes build the chain's
// table (16 KiB) in shared memory with rans_resolve_build, then lane 0
// runs the chain with rans_resolve_chain.  A block takes 16,896 bytes of
// shared memory, so an SM holds 13 chains and 1,056 chains (8 an SM) run
// in one wave.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rans_resolve_step.cuh"

namespace {

// steps a loop step (on the select form of the step, 16 measured no
// faster and 4 slower at 1,056 chains)
constexpr int kUnroll = 8;

struct Smem {
  uint16_t tab[2 * RANS_TOTFREQ];
  uint16_t f[256];
};

__global__ void __launch_bounds__(32) rans_resolve_bench_kernel(
    const int32_t* __restrict__ freqs, const uint32_t* __restrict__ x0,
    uint32_t* __restrict__ x_out, int64_t rounds) {
  __shared__ __align__(16) Smem sm;
  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  for (int s = lane; s < 256; s += 32)
    sm.f[s] = (uint16_t)freqs[(int64_t)g * 256 + s];
  __syncwarp();
  rans_resolve_build(sm.f, sm.tab, lane, 32);
  __syncwarp();
  if (lane != 0) return;
  x_out[g] = rans_resolve_chain<kUnroll>(x0[g], sm.tab, rounds);
}

// The largest shared-memory carveout, so that as many chains share an SM
// as their tables allow.
cudaError_t configure() {
  return cudaFuncSetAttribute(rans_resolve_bench_kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// Run G chains of `rounds` steps on `stream`.  Returns cudaGetLastError()
// after the launch, or the attribute's error.
extern "C" int rans_resolve_bench_launch(const void* freqs, const void* x0,
                                         void* x_out, int G, long long rounds,
                                         void* stream) {
  if (G <= 0) return 0;
  const cudaError_t e = configure();
  if (e != cudaSuccess) return static_cast<int>(e);
  rans_resolve_bench_kernel<<<G, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(freqs), static_cast<const uint32_t*>(x0),
      static_cast<uint32_t*>(x_out), (int64_t)rounds);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of shared memory a block (a chain) takes.
extern "C" int rans_resolve_bench_smem_bytes() { return (int)sizeof(Smem); }

// Chains one SM runs at once, or minus a CUDA error code.
extern "C" int rans_resolve_bench_chains_per_sm() {
  int n = 0;
  cudaError_t e = configure();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, rans_resolve_bench_kernel, 32, 0);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

extern "C" const char* kernel_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
