// rANS Nx16 order-0 32-way encode on Hopper (kernel B9), one launch for
// the whole batch.
//
// Replaces: htslib_tpu/ops/rans_enc_pallas.py:_enc_kernel (driven by
// encode_nx16_o0_batch).
//
// What bounds it: not bytes.  Each stream is a chain of ceil(n/32)
// dependent rounds, 32,768 for a 1 MiB stream, so where a batch holds
// fewer streams than the card has SMs, time is rounds times the latency
// of a round; a whole-file batch is bound by the instructions of a round
// on each scheduler.
//
// Design: one warp per stream (one per block), lane j holding state j, so
// a round is one SIMT step and every stream of the batch runs at once.
// The state's chain holds no division and no memory load: each symbol's
// entry (rans_enc_sym: reciprocal, emit threshold, bias, shift and
// 4096 - f, 16 bytes) is built once per stream in shared memory, and a
// round is compare, select, mulhi, shift and multiply-add on the state.
// The reciprocal is what takes the division off the chain on any chip:
// the JAX kernel built its mulhi from 16-bit partial products because
// the TPU has no 32-bit high product, Hopper has one (__umulhi).  A
// lane's symbols depend only on the stream, never on its state, so they
// are in flight ahead of the chain: the symbol of round t + 32 is loaded
// in round t into the register round t just read (a rolling window of 32
// rounds, no copies; the compiler issues a group's loads together, so
// fewer rounds ahead leave a load from device memory exposed), and the
// entry is one shared load off the chain.  All rounds but the last are
// all-live (states above r0 run out one round early), so the loop carries
// no predicate; the last round (or a max_rounds stop) runs with one.
// Cursors, counts and offsets inside a stream are 32-bit (streams hold
// < 2^31 symbols, frame_enc checks), and a word's address is one wide
// multiply-add on the region's base (store_word).  Emission order is the
// wire's: a ballot collects the round's emitters, an emitter's rank is
// the popcount of the emitters before it in the round's rotation
// (rans_enc_before), and emission e of the stream is written to word
// n - 1 - e of the stream's n-word scratch region, so the region's tail
// is the payload in wire order (at most one emission per symbol, so n
// words suffice and every write stays inside the region).
//
// Shared memory a block: 4,096 bytes of entries (rans_nx16_enc_smem_bytes);
// registers bound the streams an SM, 28 (rans_nx16_enc_blocks_per_sm).
#include <cuda_runtime.h>
#include <stdint.h>

#include "rans_nx16_enc_step.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kAhead = 32;  // rounds between a symbol's load and its use

struct Lane {
  uint32_t x;        // the state
  uint32_t rem;      // n - 1 - words emitted: the next word's index
  uint32_t before;   // the states before this one in a round
  uint16_t* w;       // the stream's word region
};

// w[i] = v: the address is one wide multiply-add on the region's base
// (left to itself the compiler rebuilds it from the batch's base and the
// stream's offset, three instructions and a constant load a store).
__device__ __forceinline__ void store_word(uint16_t* w, uint32_t i,
                                           uint32_t v) {
  asm volatile(
      "{\n.reg .u64 a;\nmad.wide.u32 a, %1, 2, %0;\n"
      "st.global.u16 [a], %2;\n}\n" ::"l"(w),
      "r"(i), "h"((uint16_t)v)
      : "memory");
}

// One all-live round on symbol s.
__device__ __forceinline__ void round_live(Lane& l, const RansEncSym* tab,
                                           uint32_t s) {
  const RansEncSym e = tab[s];
  uint32_t word;
  const bool em = rans_enc_put(&l.x, e, &word);
  const unsigned mask = __ballot_sync(kFull, em);
  if (em) store_word(l.w, l.rem - __popc(mask & l.before), word);
  l.rem -= __popc(mask);
}

// One round in which the lanes with `live` false hold no symbol: they
// step on entry 0 and drop the result.
__device__ __forceinline__ void round_pred(Lane& l, const RansEncSym* tab,
                                           uint32_t s, bool live) {
  const RansEncSym e = tab[live ? s : 0u];
  uint32_t word, xs = l.x;
  const bool em = rans_enc_put(&xs, e, &word) && live;
  if (live) l.x = xs;
  const unsigned mask = __ballot_sync(kFull, em);
  if (em) store_word(l.w, l.rem - __popc(mask & l.before), word);
  l.rem -= __popc(mask);
}

__global__ void __launch_bounds__(32) rans_nx16_enc_kernel(
    const uint8_t* __restrict__ syms, const int64_t* __restrict__ off,
    const int32_t* __restrict__ ulen, const int32_t* __restrict__ freqs,
    const int32_t* __restrict__ cum, uint16_t* __restrict__ words,
    uint32_t* __restrict__ x_out, int32_t* __restrict__ n_emit,
    int max_rounds) {
  __shared__ RansEncSym tab[256];
  const int st = blockIdx.x;
  const int lane = threadIdx.x;
  for (int s = lane; s < 256; s += 32)
    tab[s] = rans_enc_sym((uint32_t)freqs[st * 256 + s],
                          (uint32_t)cum[st * 256 + s]);
  __syncwarp();

  const uint32_t n = (uint32_t)ulen[st];
  const uint8_t* d = syms + off[st];
  uint32_t rounds = (n + RANS_ENC_NWAY - 1) / RANS_ENC_NWAY;
  if (max_rounds >= 0 && rounds > (uint32_t)max_rounds)
    rounds = (uint32_t)max_rounds;
  // rounds in which every state holds a symbol
  const uint32_t full = min(n / RANS_ENC_NWAY, rounds);
  const uint32_t cnt = rans_enc_count(n, lane);
  const int r0 = n > 0 ? (int)((n - 1) % RANS_ENC_NWAY) : 0;
  Lane l{RANS_ENC_L, n - 1, rans_enc_before(lane, r0), words + off[st]};
  uint32_t t = 0;

  // this lane's symbol of round t is p[-32 t]
  const uint8_t* p = d + (int)(lane + RANS_ENC_NWAY * (cnt - 1));
  if (full >= (uint32_t)kAhead) {
    uint32_t s[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) s[k] = p[-RANS_ENC_NWAY * k];
    // s[k] holds round t + k; it is read, reloaded with round
    // t + kAhead + k, then used
    for (; t + 2 * kAhead <= full; t += kAhead, p -= RANS_ENC_NWAY * kAhead) {
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        const uint32_t sym = s[k];
        s[k] = p[-RANS_ENC_NWAY * (kAhead + k)];
        round_live(l, tab, sym);
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) round_live(l, tab, s[k]);
    t += kAhead;
    p -= RANS_ENC_NWAY * kAhead;
  }
  for (; t < rounds; ++t, p -= RANS_ENC_NWAY) {
    const bool live = t < cnt;
    round_pred(l, tab, live ? *p : 0u, live);
  }
  x_out[st * RANS_ENC_NWAY + lane] = l.x;
  if (lane == 0) n_emit[st] = (int32_t)(n - 1 - l.rem);
}

}  // namespace

// Encode n_streams streams on `stream`; words must be zeroed by the
// caller where a max_rounds stop leaves it unwritten.  Returns
// cudaGetLastError() after the launch.
extern "C" int rans_nx16_enc_launch(const void* syms, const void* off,
                                    const void* ulen, const void* freqs,
                                    const void* cum, void* words, void* x_out,
                                    void* n_emit, int n_streams,
                                    int max_rounds, void* stream) {
  if (n_streams <= 0) return 0;
  rans_nx16_enc_kernel<<<n_streams, 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(syms), static_cast<const int64_t*>(off),
      static_cast<const int32_t*>(ulen), static_cast<const int32_t*>(freqs),
      static_cast<const int32_t*>(cum), static_cast<uint16_t*>(words),
      static_cast<uint32_t*>(x_out), static_cast<int32_t*>(n_emit),
      max_rounds);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of shared memory a block takes.
extern "C" int rans_nx16_enc_smem_bytes() {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, rans_nx16_enc_kernel);
  return e == cudaSuccess ? static_cast<int>(a.sharedSizeBytes)
                          : -static_cast<int>(e);
}

// Streams (blocks) one SM encodes at once; a negative CUDA error code on
// failure.
extern "C" int rans_nx16_enc_blocks_per_sm() {
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, rans_nx16_enc_kernel, 32, 0);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

extern "C" const char* kernel_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
