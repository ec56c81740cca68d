// The rANS slot-resolve chain of the gather probe on Hopper (kernel P1):
// per chain and state, `rounds` dependent rounds of
//   m = x & 4095;  (f, c) of the symbol s with cum[s] <= m < cum[s + 1];
//   x = f * (x >> 12) + m - c,
// with no renormalisation, returning the final states.
//
// Replaces: scripts/probe_pallas_gather.py:135 `pallas_cmp` (its
// `cmp_kernel` at :111), the gatherless TPU form of the chain: a broadcast
// compare of m against the chain's 256 bounds held in VMEM and a masked
// row sum that recovers (f - 1) | c << 12.
//
// What bounds it: round latency.  Each state is a chain of `rounds`
// dependent steps, and the probe's 256 chains x 4 states are 1,024
// threads: too few to hide a round on 132 SMs, so time is rounds times a
// round's latency (a shared-memory load and a multiply-add).
//
// Design: a warp per chain (a block each).  The warp builds the chain's
// 4,096-slot table in shared memory from its bounds, one u32 a slot
// packing f - 1 in bits 0-11 and c in bits 12-23 (the TPU kernel's
// packed_fc), lane l filling the symbols s with s % 32 == l; then lanes 0-3
// run the chain's four states, a shared load, a mask and a multiply-add a
// round.  The compare of the TPU kernel becomes the table's build: every
// slot's entry is that of the one bound interval that holds it.  Arithmetic
// is in u32, which wraps where the int32 of the TPU kernel does (with
// states below 2^30 nothing overflows).
//
// Shared memory a block: 16,384 bytes of table and 1,028 of bounds.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kSlots = 4096;
constexpr int kStates = 4;

__global__ void __launch_bounds__(kWarp)
    resolve_cmp_kernel(const int32_t* cum, const int32_t* freqs,
                       const int32_t* x0, int32_t* x_out, int rounds) {
  __shared__ uint32_t slot[kSlots];
  __shared__ int32_t bound[257];
  const int lane = threadIdx.x;
  const int g = blockIdx.x;
  for (int s = lane; s < 257; s += kWarp) bound[s] = cum[(int64_t)g * 257 + s];
  __syncwarp();
  for (int s = lane; s < 256; s += kWarp) {
    const uint32_t f = (uint32_t)freqs[(int64_t)g * 256 + s];
    const int lo = bound[s] < 0 ? 0 : bound[s];
    const int hi = bound[s + 1] > kSlots ? kSlots : bound[s + 1];
    const uint32_t e = ((f - 1u) & 0xFFFu) | ((uint32_t)bound[s] << 12);
    for (int k = lo; k < hi; ++k) slot[k] = e;
  }
  __syncwarp();
  if (lane >= kStates) return;
  uint32_t x = (uint32_t)x0[(int64_t)g * kStates + lane];
#pragma unroll 8
  for (int r = 0; r < rounds; ++r) {
    const uint32_t m = x & (kSlots - 1);
    const uint32_t e = slot[m];
    x = ((e & 0xFFFu) + 1u) * (x >> 12) + m - (e >> 12);
  }
  x_out[(int64_t)g * kStates + lane] = (int32_t)x;
}

}  // namespace

// `chains` chains of 4 states on `stream`: cum int32 [chains, 257] (rising,
// cum[0] = 0, cum[256] = 4096), freqs int32 [chains, 256] (each >= 1), x0
// int32 [chains, 4]; writes x_out int32 [chains, 4].  Returns
// cudaGetLastError() after the launch.
extern "C" int resolve_cmp_launch(const void* cum, const void* freqs,
                                  const void* x0, void* x_out, int chains,
                                  int rounds, void* stream) {
  if (chains <= 0) return 0;
  resolve_cmp_kernel<<<chains, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cum), static_cast<const int32_t*>(freqs),
      static_cast<const int32_t*>(x0), static_cast<int32_t*>(x_out), rounds);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
