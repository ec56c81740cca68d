// BAM record-boundary scan (kernel X5): the chain of record offsets of a
// u32-length-prefixed BAM record stream, offsets[k+1] = offsets[k] + 4 +
// block_len (the bam_read1 framing, sam.c:784).
//
// Replaces: htslib_tpu/ops/bam2sam.py:34 device_record_scan, XLA code (no
// Pallas kernel): a fori_loop of max_records steps.  As torch ops that
// would be several launches a record.  The step, with the JAX function's
// int32 quirks, is record_scan_step.cuh.
//
// What bounds it: the chain.  Each step's position is known only once the
// step before it has read its length, so one thread walks the whole
// chain.  Walking it through device memory would pay a dependent miss a
// record (the payload is larger than L2), so one block streams the
// payload through shared memory instead: two windows of kWin bytes, the
// next one copied in with cp.async (16-byte chunks, the bytes past the
// payload zero-filled) while thread 0 walks the current one.  Consecutive
// windows overlap by 16 bytes, so a length that straddles a window's end
// lies whole in the next.  A length that sends the chain outside the next
// window (a jump back, or past it) stages a window at the new position
// before the walk goes on.  After the chain, the block fills the steps
// left with (-1, 0).
#include <cuda_runtime.h>
#include <stdint.h>

#include "record_scan_step.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int64_t kWin = 96 * 1024;      // bytes a window
constexpr int64_t kStride = kWin - 16;   // window starts are this apart

// Copy payload bytes [base, base + kWin) into w (16-byte chunks, zero past
// u); the caller commits and waits.  base and the payload are 16-byte
// aligned.
__device__ __forceinline__ void stage(uint8_t* w, const uint8_t* payload,
                                      int64_t base, int32_t u) {
  for (int64_t c = threadIdx.x; c < kWin / 16; c += kThreads) {
    const int64_t at = base + 16 * c;
    const int64_t left = (int64_t)u - at;
    const uint32_t n = left >= 16 ? 16u : (left > 0 ? (uint32_t)left : 0u);
    const uint8_t* src = payload + (n ? at : 0);
    const uint32_t dst =
        static_cast<uint32_t>(__cvta_generic_to_shared(w + 16 * c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n));
  }
}

__device__ __forceinline__ void commit_wait() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__global__ void __launch_bounds__(kThreads)
    record_scan_kernel(const uint8_t* payload, int32_t u, int32_t max_records,
                       int32_t* offs, int32_t* sizes, int32_t* n_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* win[2] = {smem, smem + kWin};
  __shared__ int32_t s_pos, s_k;
  __shared__ bool s_done;
  if (threadIdx.x == 0) {
    s_pos = 0;
    s_k = 0;
    s_done = max_records <= 0 || !rscan_ok(0, u);
  }
  int64_t base = 0;
  int cur = 0;
  if (u >= 4) {
    stage(win[0], payload, 0, u);
    commit_wait();
  }
  __syncthreads();
  // each thread's copy of s_done, read between barriers only: thread 0
  // writes s_done during the walk
  bool done = s_done;
  __syncthreads();
  while (!done) {
    const int64_t next = base + kStride;
    stage(win[cur ^ 1], payload, next, u);
    asm volatile("cp.async.commit_group;\n" ::);
    if (threadIdx.x == 0) {
      int32_t pos = s_pos, k = s_k;
      s_done = rscan_walk(win[cur], base, kWin, u, &pos, &k, max_records,
                          offs, sizes);
      s_pos = pos;
      s_k = k;
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    done = s_done;
    if (done) break;
    const int64_t at = rscan_at(s_pos, u);
    if (at >= next && at + 4 <= next + kWin) {
      base = next;
      cur ^= 1;
    } else {
      base = at & ~(int64_t)15;
      stage(win[cur], payload, base, u);
      commit_wait();
    }
    __syncthreads();
  }
  const int32_t n = s_k;
  for (int32_t k = n + threadIdx.x; k < max_records; k += kThreads) {
    offs[k] = -1;
    sizes[k] = 0;
  }
  if (threadIdx.x == 0) *n_out = n;
}

}  // namespace

// payload: u bytes, 16-byte aligned; offs/sizes: max_records int32 each;
// n_out: one int32.  Returns cudaGetLastError() (or the attribute call's
// error).
extern "C" int record_scan_launch(const void* payload, int u,
                                  int max_records, void* offs, void* sizes,
                                  void* n_out, void* stream) {
  const int smem = (int)(2 * kWin);
  cudaError_t e = cudaFuncSetAttribute(
      record_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  record_scan_kernel<<<1, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(payload), u, max_records,
      static_cast<int32_t*>(offs), static_cast<int32_t*>(sizes),
      static_cast<int32_t*>(n_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int record_scan_window_bytes() { return (int)kWin; }

extern "C" const char* kernel_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
