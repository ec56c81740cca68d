// rANS 4x8 decode on Hopper (the CRAM 3.0 wire): order-0 symbols (kernel
// B7) or a per-stream histogram of order-0 or order-1 symbols (kernel B8,
// the order chosen at compile time), one launch for the whole batch.
//
// Replaces: htslib_tpu/ops/rans4x8_pallas.py:_seg4_kernel (decode, driven
// by decode_4x8_o0_batch) and :_seg4_hist_kernel (decode + histogram,
// driven by ops/device_stats.py:qualstats_device_4x8).  Unlike those, the
// odd tail (order 0: states 0..n%4-1; order 1: state 3) runs here too, so
// no stream is finished on the host.
//
// What bounds it: not bytes.  A stream is a chain of about n/4 dependent
// rounds, 262,144 for a 1 MiB stream, 8x the Nx16 chain of the same
// stream: each round a table lookup in shared memory, a multiply-add, and
// a byte refill whose offsets depend on every state of the round.
//
// Design: one warp per stream (one per block).  Lanes 0..3 hold the four
// states (and, for order 1, their contexts); all 32 lanes hold a register
// window of the stream's next 256 bytes as 32-bit words, read with
// shuffles, so no global load sits on the chain.  The tables are those of
// the step headers: the order-0 packed slot table (16 KB, zeros past the
// sum) or the order-1 row/bucket table (33 KB), built by the warp in shared
// memory.  Refills follow the wire's order from two ballots, m1 (states
// taking >= 1 byte) and m2 (states taking 2): state j's first byte is at
// cursor + popc(m1 & below) + popc(m2 & below), and the cursor advances by
// popc(m1) + popc(m2).  The histogram variants count into a shared
// histogram with shared atomics.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "rans4x8_step.cuh"

namespace {

constexpr int kPrefetchWords = 512;  // 2 KiB ahead, into L2

struct O0Tables {
  uint32_t slot[RANS_TOTFREQ];
  uint16_t f[256];
  int32_t hist[256];
};

struct O1Tables {
  uint32_t rows[RANS_O1_MAX_ROWS + 1];  // + a zero sentinel
  uint8_t bucket[256 * RANS_O1_BUCKETS];
  uint16_t ctx_start[258];
  int32_t hist[256];
};

// Word `idx` (4 bytes, little-endian) of a payload of n_words words.
__device__ __forceinline__ uint32_t word32(const uint32_t* words,
                                           int64_t idx, int64_t n_words) {
  return idx < n_words ? words[idx] : 0u;
}

// Byte k (< 256) of the window held in w0 (bytes 0..127) and w1 (128..255)
// across the warp; every lane must call it.
__device__ __forceinline__ uint32_t window_byte(uint32_t w0, uint32_t w1,
                                                int k) {
  const int wi = k >> 2;
  const uint32_t v0 = __shfl_sync(0xffffffffu, w0, wi & 31);
  const uint32_t v1 = __shfl_sync(0xffffffffu, w1, wi & 31);
  return ((wi < 32 ? v0 : v1) >> ((k & 3) * 8)) & 0xFFu;
}

template <bool kHist, bool kO1>
__global__ void __launch_bounds__(32) rans4x8_kernel(
    const uint8_t* __restrict__ payload, const int64_t* __restrict__ byte_off,
    const int32_t* __restrict__ n_bytes, const int32_t* __restrict__ freqs,
    const uint32_t* __restrict__ rows, const int64_t* __restrict__ row_off,
    const int32_t* __restrict__ n_rows,
    const int32_t* __restrict__ ctx_start, const uint32_t* __restrict__ x0,
    const int32_t* __restrict__ ulen, const int64_t* __restrict__ out_off,
    uint8_t* __restrict__ out, const int32_t* __restrict__ offs,
    int32_t* __restrict__ hist, uint32_t* __restrict__ x_out,
    int32_t* __restrict__ cur_out, int32_t* __restrict__ ctx_out,
    int qbins, int max_rounds) {
  using Tables = typename std::conditional<kO1, O1Tables, O0Tables>::type;
  __shared__ Tables t;
  const int lane = threadIdx.x;
  const int st = blockIdx.x;
  if constexpr (kO1) {
    const int nrows = n_rows[st];
    const uint32_t* rs = rows + row_off[st];
    for (int i = lane; i < nrows; i += 32) t.rows[i] = rs[i];
    if (lane == 0) t.rows[nrows] = 0;
    for (int c = lane; c < 257; c += 32)
      t.ctx_start[c] = (uint16_t)ctx_start[(int64_t)st * 257 + c];
  } else {
    for (int s = lane; s < 256; s += 32)
      t.f[s] = (uint16_t)freqs[(int64_t)st * 256 + s];
  }
  if (kHist)
    for (int b = lane; b < qbins; b += 32) t.hist[b] = 0;
  __syncwarp();
  if constexpr (kO1)
    rans_o1_build_buckets(t.rows, t.ctx_start, t.bucket, lane, 32);
  else
    rans_o0_build_slots(t.f, t.slot, lane, 32);
  __syncwarp();

  const uint32_t* words =
      reinterpret_cast<const uint32_t*>(payload + byte_off[st]);
  const int64_t nb = n_bytes[st];
  const int64_t nw = (nb + 3) / 4;
  const int64_t n = ulen[st];
  int64_t rounds = rans8_rounds(kO1, n);
  if (max_rounds >= 0 && rounds > max_rounds) rounds = max_rounds;
  const bool is_state = lane < RANS8_NWAY;
  const int off = kHist ? offs[st] : 0;
  uint8_t* o = kHist ? nullptr : out + out_off[st];
  const unsigned below = (1u << lane) - 1u;

  // window: lane k holds bytes base + 4k.. in w[0], base + 128 + 4k.. in
  // w[1], and the two windows after them in flight in w[2] and w[3]; a
  // round takes at most 8 bytes, so the cursor never runs 128 past base
  int64_t base = 0;  // in bytes, a multiple of 128
  uint32_t w[4];
  for (int i = 0; i < 4; ++i) w[i] = word32(words, 32 * i + lane, nw);

  uint32_t x = is_state ? x0[(int64_t)st * RANS8_NWAY + lane] : 0u;
  uint32_t ctx = 0;
  int64_t cur = 0;  // bytes taken
  for (int64_t r = 0; r < rounds; ++r) {
    int64_t pos;
    const bool live = is_state && rans8_live(kO1, n, lane, r, &pos);
    uint32_t xs = x;
    uint32_t s;
    if constexpr (kO1)
      s = rans_o1_decode(&xs, ctx, t.rows, t.ctx_start, t.bucket);
    else
      s = rans_o0_decode(&xs, t.slot);
    if (live) {
      x = xs;
      if (kO1) ctx = s;
      if (kHist)
        atomicAdd(&t.hist[rans_hist_bin(s, off, qbins)], 1);
      else
        o[pos] = (uint8_t)s;
    }
    const int need = live ? rans8_refill_count(x) : 0;
    const unsigned m1 = __ballot_sync(0xffffffffu, need >= 1);
    const unsigned m2 = __ballot_sync(0xffffffffu, need == 2);
    const int k =
        (int)(cur - base) + __popc(m1 & below) + __popc(m2 & below);
    const uint32_t b1 = window_byte(w[0], w[1], k);
    const uint32_t b2 = window_byte(w[0], w[1], k + 1);
    x = rans8_refill(x, need, b1, b2);
    cur = rans_advance(cur, __popc(m1) + __popc(m2), nb);
    if (cur - base >= 128) {
      base += 128;
      w[0] = w[1];
      w[1] = w[2];
      w[2] = w[3];
      w[3] = word32(words, base / 4 + 96 + lane, nw);
      if (lane == 0 && base / 4 + kPrefetchWords < nw)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(words + base / 4 +
                                                      kPrefetchWords));
    }
  }
  if (is_state) {
    x_out[(int64_t)st * RANS8_NWAY + lane] = x;
    ctx_out[(int64_t)st * RANS8_NWAY + lane] = (int32_t)ctx;
  }
  if (lane == 0) cur_out[st] = (int32_t)cur;
  if (kHist) {
    __syncwarp();
    for (int b = lane; b < qbins; b += 32)
      hist[(int64_t)st * qbins + b] = t.hist[b];
  }
}

}  // namespace

// Order-0 decode (out != NULL, o1 == 0) or order-0/1 histogram
// (hist != NULL) of n_streams streams on `stream`.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for an
// order-1 decode, which has no kernel.
extern "C" int rans4x8_launch(
    const void* payload, const void* byte_off, const void* n_bytes,
    const void* freqs, const void* rows, const void* row_off,
    const void* n_rows, const void* ctx_start, const void* x0,
    const void* ulen, const void* out_off, void* out, const void* offs,
    void* hist, void* x_out, void* cur_out, void* ctx_out, int n_streams,
    int qbins, int max_rounds, int o1, void* stream) {
  if (n_streams <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const uint8_t*>(payload);
  const auto* bo = static_cast<const int64_t*>(byte_off);
  const auto* nb = static_cast<const int32_t*>(n_bytes);
  const auto* fr = static_cast<const int32_t*>(freqs);
  const auto* rw = static_cast<const uint32_t*>(rows);
  const auto* ro = static_cast<const int64_t*>(row_off);
  const auto* nr = static_cast<const int32_t*>(n_rows);
  const auto* cs = static_cast<const int32_t*>(ctx_start);
  const auto* xs = static_cast<const uint32_t*>(x0);
  const auto* ul = static_cast<const int32_t*>(ulen);
  const auto* of = static_cast<const int64_t*>(out_off);
  auto* ot = static_cast<uint8_t*>(out);
  const auto* os = static_cast<const int32_t*>(offs);
  auto* hs = static_cast<int32_t*>(hist);
  auto* xo = static_cast<uint32_t*>(x_out);
  auto* co = static_cast<int32_t*>(cur_out);
  auto* cx = static_cast<int32_t*>(ctx_out);
  if (hist == nullptr && o1) return static_cast<int>(cudaErrorInvalidValue);
  if (hist == nullptr)
    rans4x8_kernel<false, false><<<n_streams, 32, 0, s>>>(
        p, bo, nb, fr, rw, ro, nr, cs, xs, ul, of, ot, os, hs, xo, co, cx,
        qbins, max_rounds);
  else if (o1)
    rans4x8_kernel<true, true><<<n_streams, 32, 0, s>>>(
        p, bo, nb, fr, rw, ro, nr, cs, xs, ul, of, ot, os, hs, xo, co, cx,
        qbins, max_rounds);
  else
    rans4x8_kernel<true, false><<<n_streams, 32, 0, s>>>(
        p, bo, nb, fr, rw, ro, nr, cs, xs, ul, of, ot, os, hs, xo, co, cx,
        qbins, max_rounds);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
