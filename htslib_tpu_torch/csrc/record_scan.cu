// BAM record-boundary scan (kernel X5): the chain of record offsets of a
// u32-length-prefixed BAM record stream, offsets[k+1] = offsets[k] + 4 +
// block_len (the bam_read1 framing, sam.c:784).
//
// Replaces: htslib_tpu/ops/bam2sam.py:34 device_record_scan, XLA code (no
// Pallas kernel): a fori_loop of max_records steps.  As torch ops that
// would be several launches a record.  The step, with the JAX function's
// int32 quirks, and the segmented passes' arithmetic are
// record_scan_step.cuh.
//
// What bounds it: the chain.  Each step's position is known only once the
// step before it has read its length.  Walked by one thread that is 75 ns
// a record (the serial kernel below), 1,200 times the bytes' bound on an
// 80 MB payload, with 131 of the card's 132 SMs idle.
//
// Two designs, chosen by the host by the payload's size
// (ops/bam2sam.py):
//
// The serial kernel (record_scan_kernel, small payloads): one block
// streams the payload through shared memory, two windows of kWin bytes,
// the next one copied in with cp.async (16-byte chunks, the bytes past the
// payload zero-filled) while thread 0 walks the current one.  Consecutive
// windows overlap by 16 bytes, so a length that straddles a window's end
// lies whole in the next.  A length that sends the chain outside the next
// window (a jump back, or past it) stages a window at the new position
// before the walk goes on.  After the chain, the block fills the steps
// left with (-1, 0).
//
// The segmented kernels (large payloads), speculation verified exactly:
// pass 1 (rscan_seg_kernel) gives each 2^shift-byte segment a block that
// stages it by cp.async, guesses the chain's entry from its bytes (the
// block's threads test a candidate position each) and walks the chain
// from the guess to the segment's end on one thread, keeping the
// positions as 16-bit offsets in a scratch buffer; pass 2
// (rscan_verify_kernel, one block) follows the true chain from position 0
// over the segments' summaries, loaded into shared memory a tile at a
// time, accepting a segment only where the chain enters it at its guess,
// walking a missed segment again from the true entry (at most kMaxRewalks
// times), and handing the chain to the serial walk at a step the segments
// cannot keep in order (a negative or wrapping length) or past the
// rewalks; pass 3 (rscan_write_kernel) gives each verified segment's
// steps their indices from the counts pass 2 summed and writes offsets and
// sizes in parallel, then fills the steps past n with (-1, 0).
#include <cuda_runtime.h>
#include <stdint.h>

#include "record_scan_step.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int64_t kWin = 96 * 1024;      // bytes a window
constexpr int64_t kStride = kWin - 16;   // window starts are this apart

constexpr int kSegThreads = 256;         // pass 1: candidates a round
constexpr int kSegMargin = 256;          // pass 1: bytes staged past a
                                         // segment, for the guess's reads
constexpr int kTile = 2048;              // pass 2: summaries a tile
constexpr int kMaxRewalks = 16;          // pass 2: segments walked again
constexpr int kWriteThreads = 256;

// Copy payload bytes [base, base + n) into w (16-byte chunks, zero past u;
// n a multiple of 16) with `nthreads` threads; the caller commits and
// waits.  base and the payload are 16-byte aligned.
__device__ __forceinline__ void stage(uint8_t* w, const uint8_t* payload,
                                      int64_t base, int64_t n, int32_t u,
                                      int nthreads) {
  for (int64_t c = threadIdx.x; c < n / 16; c += nthreads) {
    const int64_t at = base + 16 * c;
    const int64_t left = (int64_t)u - at;
    const uint32_t m = left >= 16 ? 16u : (left > 0 ? (uint32_t)left : 0u);
    const uint8_t* src = payload + (m ? at : 0);
    const uint32_t dst =
        static_cast<uint32_t>(__cvta_generic_to_shared(w + 16 * c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(m));
  }
}

__device__ __forceinline__ void commit_wait() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// The serial walk of the chain from step k at pos by the whole block (the
// windows are smem[0, 2 * kWin)), thread 0 walking: the serial kernel's
// loop.  Returns n, the chain's steps up to max_records, to every thread.
__device__ int32_t serial_walk(uint8_t* smem, const uint8_t* payload,
                               int32_t u, int32_t max_records, int32_t pos0,
                               int32_t k0, int32_t* offs, int32_t* sizes) {
  uint8_t* win[2] = {smem, smem + kWin};
  __shared__ int32_t s_pos, s_k;
  __shared__ bool s_done;
  __syncthreads();
  if (threadIdx.x == 0) {
    s_pos = pos0;
    s_k = k0;
    s_done = k0 >= max_records || !rscan_ok(pos0, u);
  }
  int64_t base = u >= 4 ? rscan_at(pos0, u) & ~(int64_t)15 : 0;
  int cur = 0;
  if (u >= 4) {
    stage(win[0], payload, base, kWin, u, blockDim.x);
    commit_wait();
  }
  __syncthreads();
  // each thread's copy of s_done, read between barriers only: thread 0
  // writes s_done during the walk
  bool done = s_done;
  __syncthreads();
  while (!done) {
    const int64_t next = base + kStride;
    stage(win[cur ^ 1], payload, next, kWin, u, blockDim.x);
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
      stage(win[cur], payload, base, kWin, u, blockDim.x);
      commit_wait();
    }
    __syncthreads();
  }
  const int32_t n = s_k;
  __syncthreads();
  return n;
}

__global__ void __launch_bounds__(kThreads)
    record_scan_kernel(const uint8_t* payload, int32_t u, int32_t max_records,
                       int32_t* offs, int32_t* sizes, int32_t* n_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int32_t n =
      serial_walk(smem, payload, u, max_records, 0, 0, offs, sizes);
  for (int32_t k = n + threadIdx.x; k < max_records; k += kThreads) {
    offs[k] = -1;
    sizes[k] = 0;
  }
  if (threadIdx.x == 0) *n_out = n;
}

// A segment's summary in device memory: the guess, exit, steps and status
// of each segment, then seg_k (-1 where pass 2 did not verify it), each
// n_seg int32.
struct Summary {
  int32_t *g, *e, *c, *f, *k;
};

__device__ __forceinline__ Summary summary(int32_t* sum, int32_t n_seg) {
  return {sum, sum + n_seg, sum + 2 * n_seg, sum + 3 * n_seg,
          sum + 4 * n_seg};
}

// Pass 1: segment s = blockIdx.x.
__global__ void __launch_bounds__(kSegThreads)
    rscan_seg_kernel(const uint8_t* payload, int32_t u, int shift,
                     int32_t n_seg, int32_t* sum, uint16_t* starts) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int32_t s_guess;
  const int32_t s = blockIdx.x;
  const int32_t seg = 1 << shift;
  const int32_t lo = s << shift;
  const int32_t hi = (int64_t)lo + seg < u ? lo + seg : u;
  const int64_t wlen = (int64_t)seg + kSegMargin;
  const int64_t wend = (int64_t)lo + wlen < u ? (int64_t)lo + wlen : u;
  stage(smem, payload, lo, wlen, u, kSegThreads);
  commit_wait();
  if (threadIdx.x == 0) s_guess = s == 0 ? 0 : INT32_MAX;
  __syncthreads();
  // the first position of the segment from which the chain looks like
  // records: the threads test kSegThreads candidates a round
  for (int32_t at = lo; s != 0 && at < hi; at += kSegThreads) {
    const int32_t p = at + (int32_t)threadIdx.x;
    const bool looks = p < hi && rscan_looks(smem, lo, wend, u, p);
    if (looks) atomicMin(&s_guess, p);
    if (__syncthreads_or(looks)) break;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const Summary m = summary(sum, n_seg);
    const int32_t g = s_guess == INT32_MAX ? -1 : s_guess;
    int32_t exit = -1, status = RSCAN_EXIT, c = 0;
    if (g >= 0)
      c = rscan_seg_walk(smem, lo, u, lo, hi, g,
                         starts + ((int64_t)s << (shift - 2)), &exit,
                         &status);
    m.g[s] = g;
    m.e[s] = exit;
    m.c[s] = c;
    m.f[s] = status;
    m.k[s] = -1;
  }
}

// Pass 2, one block: follow the chain over the summaries, walking missed
// segments again, then the serial tail where the chain needs it.  stats:
// segments, segments walked again, steps of the serial tail, segments
// verified.
__global__ void __launch_bounds__(kThreads)
    rscan_verify_kernel(const uint8_t* payload, int32_t u,
                        int32_t max_records, int shift, int32_t n_seg,
                        int32_t* sum, uint16_t* starts, int32_t* offs,
                        int32_t* sizes, int32_t* n_out, int32_t* stats) {
  extern __shared__ __align__(16) uint8_t smem[];
  // a tile of summaries, then the window of a segment walked again; the
  // serial tail's windows take the whole after them
  int32_t* tile = reinterpret_cast<int32_t*>(smem);
  uint8_t* seg_win = smem + 4 * 4 * kTile;
  const Summary m = summary(sum, n_seg);
  const int32_t seg = 1 << shift;
  __shared__ RscanFollow s_st;
  __shared__ int s_why;
  if (threadIdx.x == 0) s_st = {0, 0, 0};
  int32_t s0 = 0, s1 = 0;
  for (;;) {
    __syncthreads();
    const int32_t s = s_st.pos >> shift;
    if (rscan_ok(s_st.pos, u) && s_st.k < max_records && s >= s1) {
      // the tile of segments from the chain's
      s0 = s;
      s1 = s0 + kTile < n_seg ? s0 + kTile : n_seg;
      for (int i = threadIdx.x; i < s1 - s0; i += kThreads) {
        tile[i] = m.g[s0 + i];
        tile[kTile + i] = m.e[s0 + i];
        tile[2 * kTile + i] = m.c[s0 + i];
        tile[3 * kTile + i] = m.f[s0 + i];
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      RscanFollow st = s_st;
      s_why = rscan_follow(tile, tile + kTile, tile + 2 * kTile,
                           tile + 3 * kTile, s0, s1, shift, u, max_records,
                           m.k, &st);
      s_st = st;
    }
    __syncthreads();
    const int why = s_why;
    if (why == RSCAN_TILE) continue;
    if (why != RSCAN_MISS || s_st.rewalks >= kMaxRewalks) break;
    // walk the missed segment again from the chain's entry
    const int32_t ms = s_st.pos >> shift;
    const int32_t lo = ms << shift;
    const int32_t hi = (int64_t)lo + seg < u ? lo + seg : u;
    stage(seg_win, payload, lo, (int64_t)seg + 16, u, kThreads);
    commit_wait();
    __syncthreads();
    if (threadIdx.x == 0) {
      int32_t exit, status;
      const int32_t c = rscan_seg_walk(
          seg_win, lo, u, lo, hi, s_st.pos,
          starts + ((int64_t)ms << (shift - 2)), &exit, &status);
      const int32_t i = ms - s0;
      tile[i] = s_st.pos;
      tile[kTile + i] = exit;
      tile[2 * kTile + i] = c;
      tile[3 * kTile + i] = status;
      m.g[ms] = s_st.pos;
      m.e[ms] = exit;
      m.c[ms] = c;
      m.f[ms] = status;
      s_st.rewalks += 1;
    }
  }
  const int why = s_why;
  const RscanFollow st = s_st;
  int32_t n;
  if (why == RSCAN_DONE) {
    n = st.k < max_records ? st.k : max_records;
  } else {
    // a step not in order, or a segment missed past the rewalks: the
    // serial walk from the chain's verified position
    n = serial_walk(smem, payload, u, max_records, st.pos, st.k, offs,
                    sizes);
  }
  if (threadIdx.x == 0) {
    *n_out = n;
    int32_t verified = 0;
    for (int32_t s = 0; s < n_seg; ++s) verified += m.k[s] >= 0;
    stats[0] = n_seg;
    stats[1] = st.rewalks;
    stats[2] = why == RSCAN_DONE ? 0 : n - st.k;
    stats[3] = verified;
  }
}

// Pass 3: each verified segment's steps below n (a block a segment, grid
// stride), then (-1, 0) at the steps n .. max_records - 1 (every thread).
__global__ void __launch_bounds__(kWriteThreads)
    rscan_write_kernel(const uint8_t* payload, int32_t u, int32_t max_records,
                       int shift, int32_t n_seg, const int32_t* sum,
                       const uint16_t* starts, const int32_t* n_in,
                       int32_t* offs, int32_t* sizes) {
  const int32_t n = *n_in;
  const int32_t* c = sum + 2 * n_seg;
  const int32_t* seg_k = sum + 4 * n_seg;
  for (int32_t s = blockIdx.x; s < n_seg; s += gridDim.x) {
    const int32_t k0 = seg_k[s];
    if (k0 < 0) continue;
    const int32_t lo = s << shift;
    const uint16_t* st = starts + ((int64_t)s << (shift - 2));
    for (int32_t i = threadIdx.x; i < c[s] && k0 + i < n;
         i += kWriteThreads) {
      const int32_t p = lo + st[i];
      offs[k0 + i] = p;
      sizes[k0 + i] = rscan_len(payload, p);
    }
  }
  for (int64_t k = n + (int64_t)blockIdx.x * kWriteThreads + threadIdx.x;
       k < max_records; k += (int64_t)gridDim.x * kWriteThreads) {
    offs[k] = -1;
    sizes[k] = 0;
  }
}

cudaError_t set_smem(const void* fn, int bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

// payload: u bytes, 16-byte aligned; offs/sizes: max_records int32 each;
// n_out: one int32.  Returns cudaGetLastError() (or the attribute call's
// error).
extern "C" int record_scan_launch(const void* payload, int u,
                                  int max_records, void* offs, void* sizes,
                                  void* n_out, void* stream) {
  const int smem = (int)(2 * kWin);
  cudaError_t e = set_smem((const void*)record_scan_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  record_scan_kernel<<<1, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(payload), u, max_records,
      static_cast<int32_t*>(offs), static_cast<int32_t*>(sizes),
      static_cast<int32_t*>(n_out));
  return static_cast<int>(cudaGetLastError());
}

// The segmented scan: segments of 2^shift bytes (4 <= shift <= 16), n_seg
// = ceil(u / 2^shift) of them.  sum: 5 * n_seg int32 of scratch; starts:
// n_seg << (shift - 2) uint16 of scratch; stats: 4 int32 (segments,
// segments walked again, serial-tail steps, segments verified).  Same
// outputs as record_scan_launch.  Returns cudaGetLastError() after the
// three launches, or the first error before it.
extern "C" int record_scan_seg_launch(const void* payload, int u,
                                      int max_records, void* offs,
                                      void* sizes, void* n_out, void* sum,
                                      void* starts, void* stats, int shift,
                                      void* stream) {
  if (shift < 4 || shift > 16 || u <= 0) return (int)cudaErrorInvalidValue;
  const int32_t n_seg = (int32_t)(((int64_t)u + (1 << shift) - 1) >> shift);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* pl = static_cast<const uint8_t*>(payload);
  int32_t* sm = static_cast<int32_t*>(sum);
  uint16_t* sts = static_cast<uint16_t*>(starts);
  const int seg_smem = (1 << shift) + kSegMargin;
  const int ver_smem = (int)(2 * kWin);
  cudaError_t e = set_smem((const void*)rscan_seg_kernel, seg_smem);
  if (e == cudaSuccess)
    e = set_smem((const void*)rscan_verify_kernel, ver_smem);
  if (e != cudaSuccess) return (int)e;
  rscan_seg_kernel<<<n_seg, kSegThreads, seg_smem, st>>>(pl, u, shift, n_seg,
                                                         sm, sts);
  rscan_verify_kernel<<<1, kThreads, ver_smem, st>>>(
      pl, u, max_records, shift, n_seg, sm, sts, static_cast<int32_t*>(offs),
      static_cast<int32_t*>(sizes), static_cast<int32_t*>(n_out),
      static_cast<int32_t*>(stats));
  const int grid = n_seg < 4096 ? n_seg : 4096;
  rscan_write_kernel<<<grid, kWriteThreads, 0, st>>>(
      pl, u, max_records, shift, n_seg, sm, sts,
      static_cast<const int32_t*>(n_out), static_cast<int32_t*>(offs),
      static_cast<int32_t*>(sizes));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int record_scan_window_bytes() { return (int)kWin; }

extern "C" const char* kernel_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
