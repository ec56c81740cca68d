// rANS Nx16 order-0 32-way decode on Hopper: symbols (kernel B2) or a
// per-stream histogram of them (kernel B3), one launch for the whole batch.
//
// Replaces: htslib_tpu/ops/rans_pallas.py:_seg_kernel (decode, driven by
// decode_nx16_o0_batch) and :_seg_hist_kernel (decode + histogram, driven
// by ops/device_stats.py:_stats_run).
//
// What bounds it: round latency, not bytes or operations.  Each stream is
// a chain of ceil(ulen/32) dependent rounds, 32,768 for a 1 MiB stream: a
// shared-memory table lookup, a multiply-add, and for the states that
// renormalise a warp ballot and the load of their word.  Where a batch
// holds fewer streams than the card has SMs, nothing hides a round, so
// time is rounds times the round's latency; a whole-file batch is bound by
// how many streams an SM holds, that is by the shared memory a block takes.
//
// Design: one warp per stream (one per block), lane j holding state j.
// The stream's 4096-slot table, one u32 a slot packing f, the symbol (B3:
// the symbol's histogram bin, rans_o0_bin_fslots) and the slot's offset
// within its symbol (rans_o0_build_fslots), is built by the warp in shared
// memory, so the lookup is one shared load and the step a mask and a
// multiply-add; a table of one symbol (f = 4096, which leaves the states
// as they are) runs a loop of its own.  Each lane keeps the slot its
// state names beside the state, from the new state or, where it refills,
// from the refill word.  Refills follow the wire's order: ballot of the
// states that need a word, rank = popc(mask & lanes below), and the word
// is one shared load at the ring offset of the cursor plus 2 * rank
// (rans_ring_word): the payload is staged into a 2,048-word ring by
// cp.async, 64 words a copy (bytes past the payload zero-filled), between
// blocks of 32 rounds and up to 2,048 words ahead, and the ring's first 32
// words are copied again past its end, so the load needs no wrap and no
// global load, shuffle or window rotation sits in a round.  The cursor is
// 32-bit and clamps at the payload's end (rans_advance32).  Rounds run in
// blocks of 32 in which every state decodes, with no predicate; the < 32
// rounds left (tail, or a max_rounds stop) run one at a time with it.  B2
// stores each round's 32 symbols as one coalesced 32-byte store.  B3
// counts off the round's single histogram: lane l adds one to its own u16
// half-word column (rans_count: bins 2k, 2k+1 in word k * 32 + l), a
// load, add and store in the lane's own bank, with no atomic and no
// conflict even when every lane sees one symbol; the columns fold into
// u32 totals every 1,024 blocks and at the end.
//
// Shared memory a block: 16,384 bytes of table and 4,160 of ring (B2:
// 20,544, 10 streams an SM); B3 adds 64 bytes of counts and 4 of totals a
// bin, 24,896 bytes at 64 bins (8 streams an SM), 37,952 at 256
// (o0_smem_bytes, rans_nx16_o0_blocks_per_sm).
#include <cuda_runtime.h>
#include <stdint.h>

#include "rans_nx16_step.cuh"

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kBlock = RANS_BLOCK_ROUNDS;
constexpr uint32_t kFoldBlocks = 1024;  // blocks between folds: < 65,536 rounds
constexpr int kUnroll = 4;              // rounds a loop step
constexpr uint32_t kRingU32 = (RANS_RING_WORDS + RANS_RING_MIRROR) / 2;

// Bytes of shared memory a block takes: the table, the ring (the
// frequencies while the table is built), and for B3 the counts and
// totals.
inline int o0_smem_bytes(bool hist, int qbins) {
  const int b = 4 * (RANS_TOTFREQ + (int)kRingU32);
  return hist ? b + 4 * RANS_NWAY * ((qbins + 1) / 2) + 4 * qbins : b;
}

struct Args {
  const uint8_t* payload;
  const int64_t* word_off;
  const int32_t* n_words;
  const int32_t* freqs;
  const uint32_t* x0;
  const int32_t* ulen;
  const int64_t* out_off;
  uint8_t* out;
  const int32_t* offs;
  int32_t* hist;
  uint32_t* x_out;
  int32_t* cur_out;
  int qbins;
  int max_rounds;
};

// The payload of one stream, staged into the ring: `src` is the 4-byte
// boundary at or below the stream's first word (word `lead` of the ring's
// numbering is that first word), `nbytes` the bytes from src to the
// payload's end.
struct Ring {
  const uint32_t* src;
  uint32_t* ring;
  uint32_t nbytes, cap, issued;
  int lane;

  // Copy chunk q into its slots (4 bytes a lane, zero past the payload),
  // and a chunk at the ring's start into the mirror past its end too.
  __device__ __forceinline__ void copy(uint32_t q) {
    const uint32_t idx = q * (RANS_RING_CHUNK / 2) + (uint32_t)lane;
    const uint32_t at = 4u * idx;
    const uint32_t n = at >= nbytes ? 0u : (nbytes - at < 4u ? nbytes - at : 4u);
    const uint32_t* from = src + (n ? idx : 0u);
    const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(
        ring + (idx & (RANS_RING_WORDS / 2 - 1))));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(from), "r"(n)
                 : "memory");
    if ((q & (RANS_RING_WORDS / RANS_RING_CHUNK - 1)) == 0 &&
        lane < (int)RANS_RING_MIRROR / 2) {
      const uint32_t m = static_cast<uint32_t>(__cvta_generic_to_shared(
          ring + RANS_RING_WORDS / 2 + lane));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(m),
                   "l"(from), "r"(n)
                   : "memory");
    }
  }

  // Copy every chunk the ring may hold at cursor `cur`, then wait until
  // the words the next block of rounds can read have arrived: for the
  // earlier copies only, unless those do not reach far enough.
  __device__ __forceinline__ void stage(uint32_t cur) {
    const uint32_t front = issued;
    for (const uint32_t l = rans_ring_limit(cur, cap); issued < l; ++issued)
      copy(issued);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (rans_ring_ready(front, cur, cap))
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();
  }
};

// One stream's decode state: the lane's state and the slot it names, the
// cursor in the ring's numbering, its byte offset in the ring, and the
// clamp.
struct State {
  uint32_t x, m, cur, off, end;
};

// One round of the warp; the lane's state decodes where `live` (always in
// a full block).  A mono table leaves the state as it is.  The next slot
// is taken from the new state, or from the refill word where the state
// refills (its low 12 bits are the word's).  Returns the slot's symbol
// (B2) or bin (B3).
template <bool kAllLive, bool kMono>
__device__ __forceinline__ uint32_t o0_round(State& s, bool live,
                                             const uint32_t* slot,
                                             const uint16_t* ring, int lane) {
  const uint32_t e = slot[s.m];
  if (!kMono && (kAllLive || live)) {
    s.x = rans_o0_fstep(s.x, e);
    s.m = s.x & (RANS_TOTFREQ - 1);
  }
  const bool need = (kAllLive || live) && rans_needs_refill(s.x);
  const unsigned mask = __ballot_sync(kFull, need);
  const uint32_t w =
      rans_ring_word(ring, s.off, __popc(mask & ((1u << lane) - 1u)));
  if (need) {
    s.x = rans_refill(s.x, w);
    s.m = w & (RANS_TOTFREQ - 1);
  }
  s.cur = rans_advance32(s.cur, __popc(mask), s.end);
  s.off = rans_ring_off(s.cur);
  return rans_o0_fsym(e);
}

// The stream's rounds: blocks of 32 in which every state decodes, the
// ring staged after each, then the rest one round at a time (the last
// stage covers them).  B2 writes symbol r * 32 + lane to o[r * 32]; B3
// counts into the lane's columns, folded every kFoldBlocks blocks.
template <bool kHist, bool kMono>
__device__ __forceinline__ void o0_rounds(State& s, Ring& rg,
                                          const uint32_t* slot,
                                          const uint16_t* ring, uint8_t* o,
                                          uint32_t* cnt, uint32_t* tot,
                                          int qbins, uint32_t n,
                                          uint32_t rounds, int lane) {
  // rounds in which every state decodes
  const uint32_t full = n / RANS_NWAY < rounds ? n / RANS_NWAY : rounds;
  uint32_t r = 0, blocks = 0;
  for (; r + kBlock <= full; r += kBlock) {
#pragma unroll kUnroll
    for (uint32_t i = 0; i < kBlock; ++i) {
      const uint32_t v = o0_round<true, kMono>(s, true, slot, ring, lane);
      if (kHist)
        rans_count(cnt, v, lane);
      else
        o[(r + i) * RANS_NWAY] = (uint8_t)v;
    }
    if (kHist && ++blocks == kFoldBlocks) {
      __syncwarp();
      rans_fold_counts(cnt, tot, qbins, lane, kWarp);
      __syncwarp();
      blocks = 0;
    }
    rg.stage(s.cur);
  }
  for (; r < rounds; ++r) {
    const bool live = r * RANS_NWAY + (uint32_t)lane < n;
    const uint32_t v = o0_round<false, kMono>(s, live, slot, ring, lane);
    if (live) {
      if (kHist)
        rans_count(cnt, v, lane);
      else
        o[r * RANS_NWAY] = (uint8_t)v;
    }
  }
}

template <bool kHist>
__global__ void __launch_bounds__(kWarp) rans_nx16_o0_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int st = blockIdx.x;
  const int qbins = a.qbins;
  uint32_t* slot = reinterpret_cast<uint32_t*>(smem);
  uint32_t* ring32 = slot + RANS_TOTFREQ;
  const uint16_t* ring = reinterpret_cast<const uint16_t*>(ring32);
  uint32_t* cnt = ring32 + kRingU32;
  uint32_t* tot = cnt + RANS_NWAY * ((qbins + 1) / 2);

  // the table, built from the frequencies staged where the ring goes
  uint16_t* f = reinterpret_cast<uint16_t*>(ring32);
  for (int s = lane; s < 256; s += kWarp)
    f[s] = (uint16_t)a.freqs[(int64_t)st * 256 + s];
  if (kHist)
    for (int i = lane; i < RANS_NWAY * ((qbins + 1) / 2) + qbins; i += kWarp)
      cnt[i] = 0;
  __syncwarp();
  const bool mono = __any_sync(kFull, rans_o0_mono(f, lane, kWarp));
  rans_o0_build_fslots(f, slot, lane, kWarp);
  __syncwarp();
  if (kHist) {
    rans_o0_bin_fslots(slot, a.offs[st], qbins, lane, kWarp);
    __syncwarp();
  }

  // the ring takes the place of the frequencies: every lane is done with
  // them
  const uint16_t* words =
      reinterpret_cast<const uint16_t*>(a.payload) + a.word_off[st];
  const uint32_t lead =
      (uint32_t)(reinterpret_cast<uintptr_t>(words) >> 1) & 1u;
  State s;
  s.x = a.x0[(int64_t)st * RANS_NWAY + lane];
  s.m = s.x & (RANS_TOTFREQ - 1);
  s.cur = lead;
  s.off = rans_ring_off(lead);
  s.end = (uint32_t)a.n_words[st] + lead;
  Ring rg = {reinterpret_cast<const uint32_t*>(words - lead), ring32,
             2u * s.end, rans_ring_cap(s.end), 0, lane};
  rg.stage(s.cur);

  const uint32_t n = (uint32_t)a.ulen[st];
  uint32_t rounds = (n + RANS_NWAY - 1) / RANS_NWAY;
  if (a.max_rounds >= 0 && rounds > (uint32_t)a.max_rounds)
    rounds = (uint32_t)a.max_rounds;
  uint8_t* o = kHist ? nullptr : a.out + a.out_off[st] + lane;
  if (mono)
    o0_rounds<kHist, true>(s, rg, slot, ring, o, cnt, tot, qbins, n, rounds,
                           lane);
  else
    o0_rounds<kHist, false>(s, rg, slot, ring, o, cnt, tot, qbins, n,
                            rounds, lane);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  a.x_out[(int64_t)st * RANS_NWAY + lane] = s.x;
  if (lane == 0) a.cur_out[st] = (int32_t)(s.cur - lead);
  if (kHist) {
    __syncwarp();
    rans_fold_counts(cnt, tot, qbins, lane, kWarp);
    __syncwarp();
    for (int b = lane; b < qbins; b += kWarp)
      a.hist[(int64_t)st * qbins + b] = (int32_t)tot[b];
  }
}

// Set the variant up for `smem` bytes of dynamic shared memory, with the
// largest shared-memory carveout so that as many blocks share an SM as
// their tables allow; returns a CUDA error code.
template <bool kHist>
cudaError_t configure(int smem) {
  auto* fn = rans_nx16_o0_kernel<kHist>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(fn,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <bool kHist>
int blocks_per_sm(int smem) {
  cudaError_t e = configure<kHist>(smem);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, rans_nx16_o0_kernel<kHist>, kWarp, smem);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

}  // namespace

// Decode (out != NULL) or histogram (hist != NULL) n_streams streams on
// `stream`.  Returns cudaGetLastError() after the launch, or the error of
// the shared-memory attribute when it is refused.
extern "C" int rans_nx16_o0_launch(
    const void* payload, const void* word_off, const void* n_words,
    const void* freqs, const void* x0, const void* ulen, const void* out_off,
    void* out, const void* offs, void* hist, void* x_out, void* cur_out,
    int n_streams, int qbins, int max_rounds, void* stream) {
  if (n_streams <= 0) return 0;
  const Args a = {static_cast<const uint8_t*>(payload),
                  static_cast<const int64_t*>(word_off),
                  static_cast<const int32_t*>(n_words),
                  static_cast<const int32_t*>(freqs),
                  static_cast<const uint32_t*>(x0),
                  static_cast<const int32_t*>(ulen),
                  static_cast<const int64_t*>(out_off),
                  static_cast<uint8_t*>(out),
                  static_cast<const int32_t*>(offs),
                  static_cast<int32_t*>(hist),
                  static_cast<uint32_t*>(x_out),
                  static_cast<int32_t*>(cur_out),
                  qbins,
                  max_rounds};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool h = hist != nullptr;
  const int smem = o0_smem_bytes(h, qbins);
  const cudaError_t e = h ? configure<true>(smem) : configure<false>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (h)
    rans_nx16_o0_kernel<true><<<n_streams, kWarp, smem, s>>>(a);
  else
    rans_nx16_o0_kernel<false><<<n_streams, kWarp, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Streams of a launch of B2 (hist == 0) or B3 with qbins bins that one SM
// decodes at once; minus a CUDA error code on failure.
extern "C" int rans_nx16_o0_blocks_per_sm(int hist, int qbins) {
  const int smem = o0_smem_bytes(hist != 0, qbins);
  return hist ? blocks_per_sm<true>(smem) : blocks_per_sm<false>(smem);
}

extern "C" const char* kernel_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
