// rANS Nx16 order-0 32-way encode on Hopper (kernel B9), one launch for
// the whole batch.
//
// Replaces: htslib_tpu/ops/rans_enc_pallas.py:_enc_kernel (driven by
// encode_nx16_o0_batch).
//
// What bounds it: not bytes.  Each stream is a chain of ceil(n/32)
// dependent rounds (a shared-memory table load, a compare, a 32-bit
// division and a warp ballot), so a 1 MiB stream is 32768 rounds and
// time is rounds times the latency of a round.
//
// Design: one warp per stream, lane j holding state j, so a round is one
// SIMT step and every stream of the batch runs concurrently.  The
// stream's f and cum, packed one word per symbol, sit in shared memory.
// A lane's symbols are independent of its state, so each lane loads the
// symbols of the next kAhead rounds together (32 neighbouring bytes per
// round across the warp) and no global load sits on the chain.  The
// division is exact u32 division (the Pallas kernel's reciprocal multiply
// was forced by the TPU's lack of a 64-bit product).  Emission order is
// the wire's: a ballot collects the round's emitters, an emitter's rank is
// the popcount of the emitters before it in the round's rotation
// (rans_enc_before), and emission e of the stream is written to word
// n - 1 - e of the stream's n-word scratch region, so the region's tail is
// the payload in wire order (at most one emission per symbol, so n words
// suffice and every write stays inside the region).
#include <cuda_runtime.h>
#include <stdint.h>

#include "rans_nx16_enc_step.cuh"

namespace {

constexpr int kWarps = 2;  // streams per block
constexpr int kAhead = 8;  // rounds whose symbols are loaded together

__global__ void __launch_bounds__(kWarps * 32) rans_nx16_enc_kernel(
    const uint8_t* __restrict__ syms, const int64_t* __restrict__ off,
    const int32_t* __restrict__ ulen, const int32_t* __restrict__ freqs,
    const int32_t* __restrict__ cum, uint16_t* __restrict__ words,
    uint32_t* __restrict__ x_out, int32_t* __restrict__ n_emit,
    int n_streams, int max_rounds) {
  __shared__ uint32_t fc[kWarps][256];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int st = blockIdx.x * kWarps + warp;
  if (st >= n_streams) return;  // whole warps only; no block barrier below
  for (int s = lane; s < 256; s += 32)
    fc[warp][s] = rans_enc_pack((uint32_t)freqs[(int64_t)st * 256 + s],
                                (uint32_t)cum[(int64_t)st * 256 + s]);
  __syncwarp();

  const int64_t n = ulen[st];
  const uint8_t* d = syms + off[st];
  uint16_t* w = words + off[st];
  const int64_t cnt = rans_enc_count(n, lane);
  int64_t rounds = (n + RANS_ENC_NWAY - 1) / RANS_ENC_NWAY;
  if (max_rounds >= 0 && rounds > max_rounds) rounds = max_rounds;
  const int r0 = n > 0 ? (int)((n - 1) % RANS_ENC_NWAY) : 0;
  const uint32_t before = rans_enc_before(lane, r0);

  uint32_t x = RANS_ENC_L;
  int64_t emitted = 0;
  for (int64_t t0 = 0; t0 < rounds; t0 += kAhead) {
    uint32_t s[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
      s[k] = t0 + k < cnt ? d[rans_enc_pos(cnt, lane, t0 + k)] : 0u;
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (t0 + k >= rounds) break;  // the same for the whole warp
      const bool live = t0 + k < cnt;
      // a lane past its symbols steps with f = 1 and drops the result
      uint32_t xs = x, word;
      const bool e =
          rans_enc_put(&xs, live ? fc[warp][s[k]] : 1u, &word) && live;
      if (live) x = xs;
      const unsigned mask = __ballot_sync(0xffffffffu, e);
      if (e) w[n - 1 - (emitted + __popc(mask & before))] = (uint16_t)word;
      emitted += __popc(mask);
    }
  }
  x_out[(int64_t)st * RANS_ENC_NWAY + lane] = x;
  if (lane == 0) n_emit[st] = (int32_t)emitted;
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
  const dim3 grid((n_streams + kWarps - 1) / kWarps), block(kWarps * 32);
  rans_nx16_enc_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(syms), static_cast<const int64_t*>(off),
      static_cast<const int32_t*>(ulen), static_cast<const int32_t*>(freqs),
      static_cast<const int32_t*>(cum), static_cast<uint16_t*>(words),
      static_cast<uint32_t*>(x_out), static_cast<int32_t*>(n_emit),
      n_streams, max_rounds);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
