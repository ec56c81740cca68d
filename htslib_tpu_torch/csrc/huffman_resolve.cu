// The canonical-Huffman resolve chain on Hopper (kernel B10): L
// independent chains of `rounds` dependent resolves, each window built
// from the last window and its symbol (huffman_step.cuh).
//
// Replaces: htslib_tpu/ops/huffman_pallas.py:make_huffman_resolve_bench.
// kernel.
//
// What bounds it: the chain.  A resolve needs the previous window, so a
// chain is `rounds` times the latency of one step; the bytes are a few
// KiB of tables.  The canonical resolve (16 compares against the length
// limits, their sum, the base and first of that length, the shift, the
// order lookup) puts three dependent shared loads and the compares' sum
// on every step.
//
// Design: a prefix table.  The resolve is a function of the 15-bit
// window, and of its top 9 bits alone wherever no length limit falls
// inside the 64 windows that share them and the code there is no longer
// than 9 bits.  The block builds, in shared memory, one u32 entry for
// each of the 512 prefixes of each of its 32 chains (huff_prefix_entry):
// the symbol where it is one for all of the prefix's windows, else a
// sentinel.  All 256 threads build it, each entry from the canonical
// resolve, so the table gives the canonical resolve by construction; it is
// laid out [prefix][chain], one chain a lane, so a warp's 32 lookups fall
// in 32 banks.  A step is then the entry's offset from the unmasked mix
// (a shift and one three-input logic op that also adds the lane's column),
// one shared load and the mix: about 45 cycles.  The sentinel is checked
// off the chain: a block of 512 steps runs with no branch, each lane
// noting whether it met a sentinel, and where one did, the warp runs the
// block again from its start, resolving those windows with the lean
// canonical step (huff_resolve_lean: limits in registers, a tree of
// compares, one base-minus-first word a length, the order load).  The
// bench's codes (lengths 7-9) never meet one.  The first step resolves
// canonically, so any start window is taken, and no table value is
// refused: a symbol equal to the sentinel is resolved the lean way.
//
// Shared memory a block: 64 KiB of prefix table and 42 KiB of bases -
// firsts and order, 108,544 bytes, two blocks (64 chains) an SM
// (huffman_resolve_smem_bytes, huffman_resolve_chains_per_sm).
#include <cuda_runtime.h>
#include <stdint.h>

#include "huffman_step.cuh"

namespace {

constexpr int kBits = 9;       // prefix bits
constexpr int kChains = 32;    // a block, one a lane of warp 0
constexpr int kThreads = 256;  // build the tables
constexpr uint32_t kSent = 0xFFFFFFFFu;
constexpr int kTabEntries = (1 << kBits) * kChains;
constexpr int kCheck = 512;    // steps between sentinel checks
constexpr int kRowShift = 7;   // log2 of the bytes of a table row
constexpr unsigned kFull = 0xffffffffu;

// Bytes of shared memory a block takes: bases - firsts [16] and order
// [320] of every chain (int32, [entry][chain]), then the prefix table.
constexpr int kSmemBytes = (HUFF_ROWS + HUFF_NSYM_PAD + (1 << kBits)) *
                           kChains * 4;

// The entry of the prefix of window (x >> 7) & 0x7fff in the column of
// this lane, which lies col bytes into each row of the table tab: the
// offset's low bits are free, so the column joins it by one logic op
// (the shift, then one three-input LOP).
__device__ __forceinline__ uint32_t entry(const char* tab, uint32_t col,
                                          uint32_t x) {
  return *reinterpret_cast<const uint32_t*>(
      tab + (huff_prefix_offset(x, kBits, kRowShift) | col));
}

__global__ void __launch_bounds__(kThreads) huffman_resolve_kernel(
    const int32_t* __restrict__ limits, const int32_t* __restrict__ firsts,
    const int32_t* __restrict__ bases, const int32_t* __restrict__ order,
    const int32_t* __restrict__ v0, int32_t* __restrict__ v_out, int L,
    int64_t rounds) {
  extern __shared__ int4 smem[];
  int32_t* bmf = reinterpret_cast<int32_t*>(smem);
  int32_t* ord = bmf + HUFF_ROWS * kChains;
  uint32_t* tab = reinterpret_cast<uint32_t*>(ord + HUFF_NSYM_PAD * kChains);
  const int tid = threadIdx.x;
  const int chain0 = blockIdx.x * kChains;
  for (int i = tid; i < HUFF_ROWS * kChains; i += kThreads) {
    const int r = i / kChains, ch = chain0 + i % kChains;
    bmf[i] = ch < L ? (int32_t)((uint32_t)bases[r * L + ch] -
                                (uint32_t)firsts[r * L + ch])
                    : 0;
  }
  for (int i = tid; i < HUFF_NSYM_PAD * kChains; i += kThreads) {
    const int e = i / kChains, ch = chain0 + i % kChains;
    ord[i] = ch < L ? order[e * L + ch] : 0;
  }
  for (int i = tid; i < kTabEntries; i += kThreads) {
    const int ch = chain0 + i % kChains;
    if (ch < L)
      tab[i] = huff_prefix_entry(
          (uint32_t)(i / kChains), kBits, limits + ch, firsts + ch,
          bases + ch, order + ch, L, kSent);
  }
  __syncthreads();
  if (tid >= 32) return;  // warp 0 runs the block's chains
  const int c = tid;
  const int ch = chain0 + c;
  const bool mine = ch < L;
  const unsigned live = __ballot_sync(kFull, mine);
  if (!mine) return;

  int32_t lim[HUFF_ROWS];
#pragma unroll
  for (int r = 0; r < HUFF_ROWS; ++r) lim[r] = limits[r * L + ch];
  const int32_t* my_bmf = bmf + c;
  const int32_t* my_ord = ord + c;
  uint32_t v = (uint32_t)v0[ch];
  if (rounds > 0) {
    // x is the mix before its shift and mask, v = (x >> 7) & 0x7fff; the
    // first step resolves canonically, so any start window is taken
    uint32_t x = huff_mix(v, huff_resolve_lean(v, lim, my_bmf, my_ord,
                                               kChains));
    const char* tab_b = reinterpret_cast<const char*>(tab);
    const uint32_t col = 4u * c;
    for (int64_t done = 1; done < rounds; done += kCheck) {
      const int nb = rounds - done < kCheck ? (int)(rounds - done) : kCheck;
      const uint32_t x0 = x;
      bool sent = false;
      // the block's steps with no branch: the entry, the mix
#pragma unroll 8
      for (int i = 0; i < nb; ++i) {
        const uint32_t e = entry(tab_b, col, x);
        sent |= e == kSent;
        x = huff_mix((x >> 7) & 0x7fffu, e);
      }
      if (__any_sync(live, sent)) {
        // some window of the block fell on a sentinel: again, resolving
        // those windows canonically
        x = x0;
        for (int i = 0; i < nb; ++i) {
          const uint32_t w = (x >> 7) & 0x7fffu;
          uint32_t e = entry(tab_b, col, x);
          if (e == kSent) e = huff_resolve_lean(w, lim, my_bmf, my_ord,
                                                kChains);
          x = huff_mix(w, e);
        }
      }
    }
    v = (x >> 7) & 0x7fffu;
  }
  v_out[ch] = (int32_t)v;
}

cudaError_t configure() {
  cudaError_t e = cudaFuncSetAttribute(
      huffman_resolve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(huffman_resolve_kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// Run L chains of `rounds` resolves on `stream`.  Returns
// cudaGetLastError() after the launch.
extern "C" int huffman_resolve_launch(const void* limits, const void* firsts,
                                      const void* bases, const void* order,
                                      const void* v0, void* v_out, int L,
                                      long long rounds, void* stream) {
  if (L <= 0) return 0;
  const cudaError_t e = configure();
  if (e != cudaSuccess) return static_cast<int>(e);
  huffman_resolve_kernel<<<(L + kChains - 1) / kChains, kThreads, kSmemBytes,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(limits), static_cast<const int32_t*>(firsts),
      static_cast<const int32_t*>(bases), static_cast<const int32_t*>(order),
      static_cast<const int32_t*>(v0), static_cast<int32_t*>(v_out), L,
      (int64_t)rounds);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int huffman_resolve_smem_bytes() { return kSmemBytes; }

// Chains one SM runs at once; a negative CUDA error code on failure.
extern "C" int huffman_resolve_chains_per_sm() {
  cudaError_t e = configure();
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, huffman_resolve_kernel, kThreads, kSmemBytes);
  return e == cudaSuccess ? n * kChains : -static_cast<int>(e);
}

extern "C" const char* kernel_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
