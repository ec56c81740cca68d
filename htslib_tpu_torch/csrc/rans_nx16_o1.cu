// rANS Nx16 order-1 32-way decode on Hopper: symbols (kernel B5) or a
// per-stream histogram of them (kernel B6), one launch for the whole batch.
//
// Replaces: htslib_tpu/ops/rans_o1_pallas.py:_make_seg1_kernel (decode,
// driven by decode_nx16_o1_batch) and :_make_seg1_hist_kernel (decode +
// histogram, driven by ops/device_stats.py:qualstats_device_o1).  Unlike
// those, the <= 31-symbol tail on the last state runs here too, so no
// stream is finished on the host.
//
// What bounds it: not bytes.  Each stream is a chain of n - 31*(n/32)
// dependent rounds (its last state's length): a context-indexed table
// lookup in shared memory, a multiply-add, and for the states that
// renormalise a warp ballot and shuffle to fetch the next word.  A 1 MiB
// stream is 32,768 rounds, so time is rounds times the latency of a round.
//
// Design: one warp per stream (one per block), lane j holding state j and
// its context.  The order-1 table is the row/bucket form of
// rans_nx16_o1_step.cuh, built by the warp in shared memory (33 KB), so a
// lookup is a bucket load, a row load and a compare or two.  Refills and
// the word window are those of rans_nx16_o0.cu: ballot of the states that
// need a word, rank = popc(mask & lanes below), the word from a register
// window of the next 128 words read with shuffles, the cursor advanced by
// popc(mask).  State j writes positions j*seg + r (strided stores).  The
// histogram variant counts into a shared histogram with shared atomics.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rans_nx16_o1_step.cuh"

namespace {

constexpr int kPrefetchWords = 1024;  // 2 KiB ahead, into L2

struct O1Tables {
  uint32_t rows[RANS_O1_MAX_ROWS + 1];  // + a zero sentinel
  uint8_t bucket[256 * RANS_O1_BUCKETS];
  uint16_t ctx_start[258];
  int32_t hist[256];
};

template <bool kHist>
__global__ void __launch_bounds__(32) rans_nx16_o1_kernel(
    const uint8_t* __restrict__ payload, const int64_t* __restrict__ word_off,
    const int32_t* __restrict__ n_words, const uint32_t* __restrict__ rows,
    const int64_t* __restrict__ row_off, const int32_t* __restrict__ n_rows,
    const int32_t* __restrict__ ctx_start, const uint32_t* __restrict__ x0,
    const int32_t* __restrict__ ulen, const int64_t* __restrict__ out_off,
    uint8_t* __restrict__ out, const int32_t* __restrict__ offs,
    int32_t* __restrict__ hist, uint32_t* __restrict__ x_out,
    int32_t* __restrict__ cur_out, int32_t* __restrict__ ctx_out,
    int qbins, int max_rounds) {
  __shared__ O1Tables t;
  const int lane = threadIdx.x;
  const int st = blockIdx.x;
  const int nrows = n_rows[st];
  const uint32_t* rs = rows + row_off[st];
  for (int i = lane; i < nrows; i += 32) t.rows[i] = rs[i];
  if (lane == 0) t.rows[nrows] = 0;
  for (int c = lane; c < 257; c += 32)
    t.ctx_start[c] = (uint16_t)ctx_start[(int64_t)st * 257 + c];
  if (kHist)
    for (int b = lane; b < qbins; b += 32) t.hist[b] = 0;
  __syncwarp();
  rans_o1_build_buckets(t.rows, t.ctx_start, t.bucket, lane, 32);
  __syncwarp();

  const uint16_t* words =
      reinterpret_cast<const uint16_t*>(payload) + word_off[st];
  const int64_t nw = n_words[st];
  const int64_t n = ulen[st];
  const int64_t seg = n / RANS_NWAY;
  const int64_t len = rans_o1_state_len(n, lane, RANS_NWAY);
  int64_t rounds = rans_o1_state_len(n, RANS_NWAY - 1, RANS_NWAY);
  if (max_rounds >= 0 && rounds > max_rounds) rounds = max_rounds;
  const int off = kHist ? offs[st] : 0;
  uint8_t* o = kHist ? nullptr : out + out_off[st] + lane * seg;
  const unsigned below = (1u << lane) - 1u;

  // register window over the stream's words, as in rans_nx16_o0.cu
  int64_t base = 0;
  uint32_t w[4];
  for (int i = 0; i < 4; ++i) w[i] = rans_word(words, 32 * i + lane, nw);

  uint32_t x = x0[(int64_t)st * RANS_NWAY + lane];
  uint32_t ctx = 0;
  int64_t cur = 0;
  for (int64_t r = 0; r < rounds; ++r) {
    const bool live = r < len;
    uint32_t xs = x;
    const uint32_t s =
        rans_o1_decode(&xs, ctx, t.rows, t.ctx_start, t.bucket);
    if (live) {
      x = xs;
      ctx = s;
      if (kHist)
        atomicAdd(&t.hist[rans_hist_bin(s, off, qbins)], 1);
      else
        o[r] = (uint8_t)s;
    }
    const bool need = live && rans_needs_refill(x);
    const unsigned mask = __ballot_sync(0xffffffffu, need);
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
  ctx_out[(int64_t)st * RANS_NWAY + lane] = (int32_t)ctx;
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
extern "C" int rans_nx16_o1_launch(
    const void* payload, const void* word_off, const void* n_words,
    const void* rows, const void* row_off, const void* n_rows,
    const void* ctx_start, const void* x0, const void* ulen,
    const void* out_off, void* out, const void* offs, void* hist,
    void* x_out, void* cur_out, void* ctx_out, int n_streams, int qbins,
    int max_rounds, void* stream) {
  if (n_streams <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const uint8_t*>(payload);
  const auto* wo = static_cast<const int64_t*>(word_off);
  const auto* nw = static_cast<const int32_t*>(n_words);
  const auto* rw = static_cast<const uint32_t*>(rows);
  const auto* ro = static_cast<const int64_t*>(row_off);
  const auto* nr = static_cast<const int32_t*>(n_rows);
  const auto* cs = static_cast<const int32_t*>(ctx_start);
  const auto* xs = static_cast<const uint32_t*>(x0);
  const auto* ul = static_cast<const int32_t*>(ulen);
  auto* xo = static_cast<uint32_t*>(x_out);
  auto* co = static_cast<int32_t*>(cur_out);
  auto* cx = static_cast<int32_t*>(ctx_out);
  if (hist != nullptr)
    rans_nx16_o1_kernel<true><<<n_streams, 32, 0, s>>>(
        p, wo, nw, rw, ro, nr, cs, xs, ul, nullptr, nullptr,
        static_cast<const int32_t*>(offs), static_cast<int32_t*>(hist), xo,
        co, cx, qbins, max_rounds);
  else
    rans_nx16_o1_kernel<false><<<n_streams, 32, 0, s>>>(
        p, wo, nw, rw, ro, nr, cs, xs, ul,
        static_cast<const int64_t*>(out_off), static_cast<uint8_t*>(out),
        nullptr, nullptr, xo, co, cx, qbins, max_rounds);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
