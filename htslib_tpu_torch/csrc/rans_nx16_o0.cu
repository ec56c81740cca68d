// rANS Nx16 order-0 32-way decode on Hopper: symbols (kernel B2) or a
// per-stream histogram of them (kernel B3), one launch for the whole batch.
//
// Replaces: htslib_tpu/ops/rans_pallas.py:_seg_kernel (decode, driven by
// decode_nx16_o0_batch) and :_seg_hist_kernel (decode + histogram, driven
// by ops/device_stats.py:_stats_run).
//
// What bounds it: not bytes.  Each stream is a chain of ceil(ulen/32)
// dependent rounds (a shared-memory table lookup, a multiply-add, and for
// the states that renormalise a warp ballot and shuffle to fetch the next
// word), and no round can start before the previous one ends.  A 1 MiB
// stream is 32768 rounds, so time is rounds times the latency of a round.
//
// Design: one warp per stream, lane j holding state j, so a round is one
// SIMT step with no cross-stream coupling and every stream of the batch
// runs concurrently.  Each stream's 4096-slot table, one u32 per slot
// packing f-1, the slot's offset within its symbol and the symbol, is
// built by its warp in shared memory, so the lookup in the chain is one
// shared-memory load, not a global gather.  Refills follow the wire's
// order: ballot of the states that need a word, rank = popc(mask & lanes
// below), word = cursor + rank, then the cursor advances by popc(mask).
// The refill word comes from a register window of the stream's next 128
// words, read with warp shuffles, whose loads are issued two windows
// before use (and prefetched into L2 further ahead), so no global load
// sits on the chain.  The histogram variant counts into a per-warp shared
// histogram with shared atomics (integer counts, exact in any order) and
// never writes symbols.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rans_nx16_step.cuh"

namespace {

constexpr int kWarps = 2;             // streams per block
constexpr int kPrefetchWords = 1024;  // 2 KiB ahead, into L2

struct WarpTables {
  uint32_t slot[RANS_TOTFREQ];
  uint16_t f[256];
  int32_t hist[256];
};

template <bool kHist>
__global__ void __launch_bounds__(kWarps * 32) rans_nx16_o0_kernel(
    const uint8_t* __restrict__ payload, const int64_t* __restrict__ word_off,
    const int32_t* __restrict__ n_words, const int32_t* __restrict__ freqs,
    const uint32_t* __restrict__ x0, const int32_t* __restrict__ ulen,
    const int64_t* __restrict__ out_off, uint8_t* __restrict__ out,
    const int32_t* __restrict__ offs, int32_t* __restrict__ hist,
    uint32_t* __restrict__ x_out, int32_t* __restrict__ cur_out,
    int n_streams, int qbins, int max_rounds) {
  __shared__ WarpTables tabs[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int st = blockIdx.x * kWarps + warp;
  if (st >= n_streams) return;  // whole warps only; no block barrier below
  WarpTables& t = tabs[warp];
  for (int s = lane; s < 256; s += 32)
    t.f[s] = (uint16_t)freqs[(int64_t)st * 256 + s];
  if (kHist)
    for (int b = lane; b < qbins; b += 32) t.hist[b] = 0;
  __syncwarp();
  rans_o0_build_slots(t.f, t.slot, lane, 32);
  __syncwarp();

  const uint16_t* words =
      reinterpret_cast<const uint16_t*>(payload) + word_off[st];
  const int64_t nw = n_words[st];
  const int64_t n = ulen[st];
  int64_t rounds = (n + RANS_NWAY - 1) / RANS_NWAY;
  if (max_rounds >= 0 && rounds > max_rounds) rounds = max_rounds;
  const int off = kHist ? offs[st] : 0;
  uint8_t* o = kHist ? nullptr : out + out_off[st];
  const unsigned below = (1u << lane) - 1u;

  // Register window over the stream's words: lane k holds word base+k in
  // w[0], base+32+k in w[1], and the two windows after them in flight in
  // w[2] and w[3].  Refills read w[0..1] by shuffle, so no global load
  // sits on the chain; the cursor never runs 32 words past base.
  int64_t base = 0;
  uint32_t w[4];
  for (int i = 0; i < 4; ++i) w[i] = rans_word(words, 32 * i + lane, nw);

  uint32_t x = x0[(int64_t)st * RANS_NWAY + lane];
  int64_t cur = 0;
  for (int64_t r = 0; r < rounds; ++r) {
    // every lane steps and keeps the step only while its position is in
    // the stream, so the round has no divergent branch
    const int64_t pos = r * RANS_NWAY + lane;
    const bool live = pos < n;
    uint32_t xs = x;
    const uint32_t s = rans_o0_decode(&xs, t.slot);
    x = live ? xs : x;
    if (live) {
      if (kHist)
        atomicAdd(&t.hist[rans_hist_bin(s, off, qbins)], 1);
      else
        o[pos] = (uint8_t)s;
    }
    const bool need = live && rans_needs_refill(x);
    const unsigned mask = __ballot_sync(0xffffffffu, need);
    // word cur + rank of this state, as an offset into the window (< 64)
    const int k = (int)(cur - base) + __popc(mask & below);
    const uint32_t lo = __shfl_sync(0xffffffffu, w[0], k & 31);
    const uint32_t hi = __shfl_sync(0xffffffffu, w[1], k & 31);
    if (need) x = rans_refill(x, k < 32 ? lo : hi);
    cur = rans_advance(cur, __popc(mask), nw);
    if (cur - base >= 32) {
      base += 32;
      w[0] = w[1];
      w[1] = w[2];
      w[2] = w[3];
      w[3] = rans_word(words, base + 96 + lane, nw);
      if (lane == 0 && base + kPrefetchWords < nw)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(words + base +
                                                      kPrefetchWords));
    }
  }
  x_out[(int64_t)st * RANS_NWAY + lane] = x;
  if (lane == 0) cur_out[st] = (int32_t)cur;
  if (kHist) {
    __syncwarp();
    for (int b = lane; b < qbins; b += 32)
      hist[(int64_t)st * qbins + b] = t.hist[b];
  }
}

}  // namespace

// Decode (out != NULL) or histogram (hist != NULL) n_streams streams on
// `stream`.  Returns cudaGetLastError() after the launch.
extern "C" int rans_nx16_o0_launch(
    const void* payload, const void* word_off, const void* n_words,
    const void* freqs, const void* x0, const void* ulen, const void* out_off,
    void* out, const void* offs, void* hist, void* x_out, void* cur_out,
    int n_streams, int qbins, int max_rounds, void* stream) {
  if (n_streams <= 0) return 0;
  const dim3 grid((n_streams + kWarps - 1) / kWarps), block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const uint8_t*>(payload);
  const auto* wo = static_cast<const int64_t*>(word_off);
  const auto* nw = static_cast<const int32_t*>(n_words);
  const auto* fr = static_cast<const int32_t*>(freqs);
  const auto* xs = static_cast<const uint32_t*>(x0);
  const auto* ul = static_cast<const int32_t*>(ulen);
  auto* xo = static_cast<uint32_t*>(x_out);
  auto* co = static_cast<int32_t*>(cur_out);
  if (hist != nullptr)
    rans_nx16_o0_kernel<true><<<grid, block, 0, s>>>(
        p, wo, nw, fr, xs, ul, nullptr, nullptr,
        static_cast<const int32_t*>(offs), static_cast<int32_t*>(hist), xo,
        co, n_streams, qbins, max_rounds);
  else
    rans_nx16_o0_kernel<false><<<grid, block, 0, s>>>(
        p, wo, nw, fr, xs, ul, static_cast<const int64_t*>(out_off),
        static_cast<uint8_t*>(out), nullptr, nullptr, xo, co, n_streams,
        qbins, max_rounds);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
