// The canonical-Huffman resolve chain on Hopper (kernel B10): L
// independent chains of `rounds` dependent resolves, each window built
// from the last window and its symbol (huffman_step.cuh).
//
// Replaces: htslib_tpu/ops/huffman_pallas.py:make_huffman_resolve_bench.
// kernel.
//
// What bounds it: the chain.  A resolve needs the previous window, so a
// chain is `rounds` times the latency of one resolve (16 compares against
// the length limits, two table loads, a shift, the order lookup and the
// mix); the bytes are a few KiB of tables.
//
// Design: one thread per chain, kChains chains per block, every chain's
// tables (limits, firsts, bases [16], order [320], int32) copied to shared
// memory laid out [entry][chain], so a lookup is one shared-memory load
// and the 32 lanes of a warp read 32 neighbouring words when their entries
// agree.  A thread reads only its own chain's column, so no barrier is
// needed.  32 chains take (48 + 320) x 32 x 4 = 47,104 bytes, inside the
// 48 KB of static shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

#include "huffman_step.cuh"

namespace {

constexpr int kChains = 32;  // chains per block
constexpr int kEntries = 3 * HUFF_ROWS + HUFF_NSYM_PAD;

__global__ void __launch_bounds__(kChains) huffman_resolve_kernel(
    const int32_t* __restrict__ limits, const int32_t* __restrict__ firsts,
    const int32_t* __restrict__ bases, const int32_t* __restrict__ order,
    const int32_t* __restrict__ v0, int32_t* __restrict__ v_out, int L,
    int64_t rounds) {
  __shared__ int32_t tab[kEntries * kChains];
  const int c = threadIdx.x;
  const int chain = blockIdx.x * kChains + c;
  if (chain >= L) return;
  int32_t* lim = tab + c;
  int32_t* first = lim + HUFF_ROWS * kChains;
  int32_t* base = first + HUFF_ROWS * kChains;
  int32_t* ord = base + HUFF_ROWS * kChains;
  for (int r = 0; r < HUFF_ROWS; ++r) {
    lim[r * kChains] = limits[(int64_t)r * L + chain];
    first[r * kChains] = firsts[(int64_t)r * L + chain];
    base[r * kChains] = bases[(int64_t)r * L + chain];
  }
  for (int e = 0; e < HUFF_NSYM_PAD; ++e)
    ord[e * kChains] = order[(int64_t)e * L + chain];
  uint32_t v = (uint32_t)v0[chain];
  for (int64_t r = 0; r < rounds; ++r)
    v = huff_next(v, huff_resolve(v, lim, first, base, ord, kChains));
  v_out[chain] = (int32_t)v;
}

}  // namespace

// Run L chains of `rounds` resolves on `stream`.  Returns
// cudaGetLastError() after the launch.
extern "C" int huffman_resolve_launch(const void* limits, const void* firsts,
                                      const void* bases, const void* order,
                                      const void* v0, void* v_out, int L,
                                      long long rounds, void* stream) {
  if (L <= 0) return 0;
  huffman_resolve_kernel<<<(L + kChains - 1) / kChains, kChains, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(limits), static_cast<const int32_t*>(firsts),
      static_cast<const int32_t*>(bases), static_cast<const int32_t*>(order),
      static_cast<const int32_t*>(v0), static_cast<int32_t*>(v_out), L,
      (int64_t)rounds);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
