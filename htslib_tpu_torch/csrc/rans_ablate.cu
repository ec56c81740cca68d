// The rANS Nx16 order-0 round with chosen stages removed (kernel P2), for
// the per-stage cost of the port's own round: one template argument a
// mode, each mode the round with one stage taken out.
//
// Replaces: scripts/probe_rans_ablate.py:163 `compiled(mode).one` (its
// `make_kernel` at :78), the same ablation of the Pallas decode round
// (ops/rans_pallas.py `_seg_kernel`) in its Mosaic layout.
//
// The full round is B2's (csrc/rans_nx16_o0.cu, its arithmetic and ring
// from rans_nx16_step.cuh): a warp a stream, lane j holding state j and
// the slot it names; the slot's entry from the stream's 4,096-slot table
// in shared memory (rans_o0_build_fslots), the state stepped by one
// multiply-add (rans_o0_fstep), and the states below 2^15 refilled in
// state order from a ballot: rank = popc(mask & lanes below), the word one
// shared load at the ring offset of the cursor plus 2 * rank, the cursor
// advanced by popc(mask) and clamped at the payload's end.  The payload is
// staged into B2's 2,048-word ring by cp.async between blocks of 32
// rounds (`Ring`, B2's own), in every mode that reads words.  The modes:
//   full        the round;
//   no_select   the refill word is 1 and no word is read; the cursor still
//               advances and the ring is still staged;
//   no_resolve  no table: sym = x & 4095, x = (x * 5 + 7) & 0x7FFFFFFF (the
//               JAX probe's stand-in), then the refill as in full;
//   no_scan     no ballot: each lane keeps its own cursor and, where it
//               refills, reads the word at it and advances it by one; the
//               ring is staged from the lowest lane's cursor, and a block
//               of rounds whose highest cursor lies past what the ring can
//               hold reads its words from device memory instead;
//   only_loop   the round's output alone: x, then x + 1 (no ring);
//   slice_cost  the payload's loads alone: lane j reads the word at cursor
//               + j (0 past the end) from the ring as its output and the
//               cursor advances by 32.
// Every mode runs `rounds` rounds with every state live and writes its
// symbol of round r, lane j of stream b, to syms[r * 32 * streams + b * 32
// + j] (the JAX probe's [SEG, 1024] output for 32 streams), then each
// lane's state and cursor (words from the payload's start).
//
// What bounds it: round latency, as B2's: 32 streams are 32 warps on 132
// SMs, each a chain of rounds.  Shared memory a block: 16,384 bytes of
// table, 4,160 of ring and 512 of frequencies.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rans_nx16_step.cuh"

namespace {

constexpr int kWarp = 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr uint32_t kBlock = RANS_BLOCK_ROUNDS;
constexpr int kUnroll = 4;  // rounds a loop step, as B2's
constexpr uint32_t kRingU32 = (RANS_RING_WORDS + RANS_RING_MIRROR) / 2;

enum Mode {
  kFullMode = 0,
  kNoSelect = 1,
  kNoResolve = 2,
  kNoScan = 3,
  kOnlyLoop = 4,
  kSliceCost = 5
};

struct Args {
  const uint16_t* words;
  const int64_t* word_off;
  const int32_t* n_words;
  const int32_t* freqs;
  const uint32_t* x0;
  int32_t* syms;
  uint32_t* x_out;
  int32_t* cur_out;
  int rounds;
};

// B2's payload ring (rans_nx16_o0.cu `Ring`): `src` is the 4-byte boundary
// at or below the stream's first word (word `lead` of the ring's
// numbering is that first word), `nbytes` the bytes from src to the
// payload's end.  `stage` takes the lowest cursor a lane holds and the
// chunks the next block of rounds needs.
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

  // Chunks that hold every word below `hi` (none past the cap).
  __device__ __forceinline__ uint32_t need(uint32_t hi) const {
    const uint32_t c = (hi + RANS_RING_CHUNK - 1u) / RANS_RING_CHUNK;
    return c < cap ? c : cap;
  }

  // Copy every chunk the ring may hold while no cursor is below `lo`,
  // then wait until chunks 0 .. want - 1 have arrived: for the earlier
  // copies only, unless those do not reach far enough.
  __device__ __forceinline__ void stage(uint32_t lo, uint32_t want) {
    const uint32_t front = issued;
    for (const uint32_t l = rans_ring_limit(lo, cap); issued < l; ++issued)
      copy(issued);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (front >= want)
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();
  }
};

// A lane's state and the slot it names, its cursor in the ring's
// numbering, the cursor's byte offset in the ring, and the clamp.
struct Lane {
  uint32_t x, m, cur, off, end;
};

__host__ __device__ constexpr bool reads_ring(int mode) {
  return mode != kOnlyLoop;
}

__host__ __device__ constexpr bool reads_table(int mode) {
  return mode == kFullMode || mode == kNoSelect || mode == kNoScan;
}

// One round of mode kMode; returns the lane's output.  kGlobal (no_scan
// only) reads the refill word from device memory, `words` counted from
// the ring's word 0.
template <int kMode, bool kGlobal>
__device__ __forceinline__ uint32_t ablate_round(Lane& s, const uint32_t* slot,
                                                 const uint16_t* ring,
                                                 const uint16_t* words,
                                                 int lane) {
  if (kMode == kOnlyLoop) {
    const uint32_t v = s.x;
    s.x += 1u;
    return v;
  }
  if (kMode == kSliceCost) {
    const uint32_t v = rans_ring_word(ring, s.off, (uint32_t)lane);
    s.cur = rans_advance32(s.cur, kWarp, s.end);
    s.off = rans_ring_off(s.cur);
    return v;
  }
  uint32_t sym;
  if (kMode == kNoResolve) {
    sym = s.x & (RANS_TOTFREQ - 1);
    s.x = (s.x * 5u + 7u) & 0x7FFFFFFFu;
  } else {
    const uint32_t e = slot[s.m];
    s.x = rans_o0_fstep(s.x, e);
    s.m = s.x & (RANS_TOTFREQ - 1);
    sym = rans_o0_fsym(e);
  }
  const bool need = rans_needs_refill(s.x);
  if (kMode == kNoScan) {
    if (need) {
      const uint32_t w = kGlobal ? rans_word(words, s.cur, s.end)
                                 : rans_ring_word(ring, s.off, 0u);
      s.x = rans_refill(s.x, w);
      s.m = w & (RANS_TOTFREQ - 1);
      s.cur = rans_advance32(s.cur, 1u, s.end);
      s.off = rans_ring_off(s.cur);
    }
    return sym;
  }
  const unsigned mask = __ballot_sync(kAll, need);
  const uint32_t w =
      kMode == kNoSelect
          ? 1u
          : rans_ring_word(ring, s.off, __popc(mask & ((1u << lane) - 1u)));
  if (need) {
    s.x = rans_refill(s.x, w);
    s.m = w & (RANS_TOTFREQ - 1);
  }
  s.cur = rans_advance32(s.cur, __popc(mask), s.end);
  s.off = rans_ring_off(s.cur);
  return sym;
}

// `nr` (at most kBlock) rounds from round r; a whole block unrolled as
// B2's.
template <int kMode, bool kGlobal>
__device__ __forceinline__ void ablate_block(Lane& s, const uint32_t* slot,
                                             const uint16_t* ring,
                                             const uint16_t* words,
                                             int32_t* out, int64_t stride,
                                             uint32_t r, uint32_t nr,
                                             int lane) {
  if (nr == kBlock) {
#pragma unroll kUnroll
    for (uint32_t i = 0; i < kBlock; ++i)
      out[(int64_t)(r + i) * stride] =
          (int32_t)ablate_round<kMode, kGlobal>(s, slot, ring, words, lane);
  } else {
    for (uint32_t i = 0; i < nr; ++i)
      out[(int64_t)(r + i) * stride] =
          (int32_t)ablate_round<kMode, kGlobal>(s, slot, ring, words, lane);
  }
}

template <int kMode>
__global__ void __launch_bounds__(kWarp) rans_ablate_kernel(const Args a) {
  __shared__ uint32_t slot[RANS_TOTFREQ];
  __shared__ __align__(16) uint32_t ring32[kRingU32];
  __shared__ uint16_t f[256];
  const int lane = threadIdx.x;
  const int st = blockIdx.x;
  const int64_t lanes = (int64_t)gridDim.x * kWarp;
  const uint16_t* ring = reinterpret_cast<const uint16_t*>(ring32);
  if (reads_table(kMode)) {
    for (int s = lane; s < 256; s += kWarp)
      f[s] = (uint16_t)a.freqs[(int64_t)st * 256 + s];
    __syncwarp();
    rans_o0_build_fslots(f, slot, lane, kWarp);
    __syncwarp();
  }
  const uint16_t* first = a.words + a.word_off[st];
  const uint32_t lead =
      (uint32_t)(reinterpret_cast<uintptr_t>(first) >> 1) & 1u;
  const uint16_t* words = first - lead;
  Lane s;
  s.x = a.x0[(int64_t)st * kWarp + lane];
  s.m = s.x & (RANS_TOTFREQ - 1);
  s.cur = lead;
  s.off = rans_ring_off(lead);
  s.end = (uint32_t)a.n_words[st] + lead;
  Ring rg = {reinterpret_cast<const uint32_t*>(words), ring32, 2u * s.end,
             rans_ring_cap(s.end), 0, lane};
  int32_t* out = a.syms + (int64_t)st * kWarp + lane;
  const uint32_t rounds = (uint32_t)a.rounds;
  for (uint32_t r = 0; r < rounds; r += kBlock) {
    const uint32_t nr = rounds - r < kBlock ? rounds - r : kBlock;
    bool global = false;
    if (kMode == kNoScan) {
      // the lanes' cursors spread: stage from the lowest, and read from
      // device memory where the highest lies past the ring's reach
      const uint32_t lo = __reduce_min_sync(kAll, s.cur);
      const uint32_t want = rg.need(__reduce_max_sync(kAll, s.cur) + kBlock);
      rg.stage(lo, want);
      global = want > rg.issued;
    } else if (reads_ring(kMode)) {
      rg.stage(s.cur, rg.need(s.cur + RANS_BLOCK_WORDS));
    }
    if (global)
      ablate_block<kMode, true>(s, slot, ring, words, out, lanes, r, nr, lane);
    else
      ablate_block<kMode, false>(s, slot, ring, words, out, lanes, r, nr,
                                 lane);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  a.x_out[(int64_t)st * kWarp + lane] = s.x;
  a.cur_out[(int64_t)st * kWarp + lane] = (int32_t)(s.cur - lead);
}

template <int kMode>
void launch(const Args& a, int n_streams, cudaStream_t s) {
  rans_ablate_kernel<kMode><<<n_streams, kWarp, 0, s>>>(a);
}

}  // namespace

// `rounds` rounds of mode `mode` (0 full, 1 no_select, 2 no_resolve, 3
// no_scan, 4 only_loop, 5 slice_cost) over n_streams streams on `stream`:
// payload u16 words with each stream's first word and count, freqs int32
// [S, 256] (not of one symbol), x0 u32 [S, 32]; writes syms int32 [rounds,
// S * 32], x_out u32 [S * 32] and cur_out int32 [S * 32].  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for an
// unknown mode.
extern "C" int rans_ablate_launch(const void* payload, const void* word_off,
                                  const void* n_words, const void* freqs,
                                  const void* x0, void* syms, void* x_out,
                                  void* cur_out, int n_streams, int rounds,
                                  int mode, void* stream) {
  if (n_streams <= 0) return 0;
  const Args a = {static_cast<const uint16_t*>(payload),
                  static_cast<const int64_t*>(word_off),
                  static_cast<const int32_t*>(n_words),
                  static_cast<const int32_t*>(freqs),
                  static_cast<const uint32_t*>(x0),
                  static_cast<int32_t*>(syms),
                  static_cast<uint32_t*>(x_out),
                  static_cast<int32_t*>(cur_out),
                  rounds};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kFullMode: launch<kFullMode>(a, n_streams, s); break;
    case kNoSelect: launch<kNoSelect>(a, n_streams, s); break;
    case kNoResolve: launch<kNoResolve>(a, n_streams, s); break;
    case kNoScan: launch<kNoScan>(a, n_streams, s); break;
    case kOnlyLoop: launch<kOnlyLoop>(a, n_streams, s); break;
    case kSliceCost: launch<kSliceCost>(a, n_streams, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
