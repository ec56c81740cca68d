// rANS 4x8 decode on Hopper (the CRAM 3.0 wire): order-0 symbols (kernel
// B7) or a per-stream histogram of order-0 or order-1 symbols (kernel B8,
// the order chosen at compile time), one launch for the whole batch; and
// the symbols of three more wires on the same round: 4x8 order 1 (X1),
// and the 4-way rANS Nx16 wire of order 0 (X2) and order 1 (X3), whose
// states refill 16-bit words (rans4x8_step.cuh); and X1 and X3 over dense
// [256, 4096] tables in device memory (rans_o1_dense), for the order-1
// streams whose tables pass the records' RANS_O1_MAX_ROWS rows.
//
// Replaces: htslib_tpu/ops/rans4x8_pallas.py:_seg4_kernel (decode, driven
// by decode_4x8_o0_batch) and :_seg4_hist_kernel (decode + histogram,
// driven by ops/device_stats.py:qualstats_device_4x8).  Unlike those, the
// odd tail (order 0: states 0..n%4-1; order 1: state 3) runs here too, so
// no stream is finished on the host.  X1-X3 are the cases of
// htslib_tpu/ops/rans.py (uncompress_batch, uncompress_nx16_batch: XLA
// loops, no Pallas kernel) that no other kernel of the port decodes.
//
// What bounds it: round latency, not bytes or operations.  A stream is one
// chain of about n/4 dependent rounds, 262,144 for a 1 MiB stream: the four
// states share one byte cursor, so the wire cannot be split.  Where a
// batch holds fewer streams than the card has SMs, no other warp hides a
// round, and the kernel's time is one stream's rounds times the round's
// time, which with one warp on its scheduler is set by the round's
// instruction count (rans4x8_step.cuh).
//
// Design: one warp (one block) per stream, every lane running the same
// round on the same registers (rans4x8_step.cuh: the four states, their
// contexts and the payload window at the cursor), so the round has no
// cross-lane operation and every branch on the cursor is uniform.  A round
// is four independent lookups of a packed 32-bit word in shared memory
// (order 0: the slot's; order 1: a u16 bucket holding the byte offset of
// its row, then that row and the next, with a loop only where a 64-slot
// bucket holds two or more row starts after its first slot), four
// multiply-adds, the refill sizes, a 4-term prefix of bit offsets, and
// funnel shifts of a 64-bit big-endian window whose three words are read
// from shared memory at the end of the round before.  Rounds run in blocks
// of 32 with no branch but the loop's (and order 1's rare loop): the
// payload is staged into a ring of 128-byte chunks in shared memory by
// cp.async (bytes past the end zero-filled) six chunks ahead of the
// cursor, and between blocks the warp waits for the chunks copied a block
// earlier and byte-swaps them, so no global load sits on the chain.  Lane
// 0 stores each round's four symbols as one word; after the block lane L
// writes round L's four bytes out (B7, X1-X3: order 1 puts state j's
// symbols at j * (n / 4) + r, so each state's 32 bytes of a block lie in
// a row) or counts them into histogram row L % 4 with shared atomics (B8).
//
// Streams per SM: with one warp a stream, a batch of more streams than
// the card has SMs is bound by how many blocks an SM holds, which the
// shared memory sets.  A block takes 17 KB (B7, X2), 21 KB (B8 order 0)
// or 51-55 KB (X1, X3, B8 order 1: dynamic shared memory, past the 48 KB
// static limit), so an SM holds 12, 10 or 4 streams.
//
// The wide variants (X1, X3 and B8 order 1 on a batch of at most one
// wave of them: ops/rans4x8.py `wide_fits`) swap the order-1 lookup for
// the wide table of rans4x8_step.cuh: 16-byte records whose fields are
// ready to use and u32 buckets that select the record by arithmetic, the
// slow buckets through per-slot maps built at set-up, so the round has no
// loop and no branch.  A block takes 129 KB (133 KB with B8's histogram
// rows) and 128 bytes a slow bucket, sized per launch to the batch's
// most slow buckets: one stream an SM, where the compact tables hold
// four, so a batch past one wave keeps the compact tables.
//
// The dense variants swap only the lookup: each state's entry is one load
// from its stream's 4 MiB table in device memory (an L2 or memory latency
// on the round's chain where the records' pick was a shared-memory one),
// and their blocks take the ring and the symbol buffer only.
//
// The large variants (X1 and X3 on the streams past RANS_O1_MAX_ROWS rows
// of a batch of at most LARGE_WAVES waves of them: ops/rans4x8.py
// `large_fits`) decode those streams from shared memory instead, through
// the large table of rans_nx16_o1_step.cuh (u16 cum and u8 symbol planes,
// a u32 word and 32 to 128 u8 buckets a context: 230,424 bytes at the
// wire's 65,536 rows and 32-slot buckets), built by the warp after its
// Tables and sized per launch to the batch's most rows, the buckets as
// fine as the batch's waves allow, so the round's four lookups wait on
// shared memory, not on L2 or HBM (a build by 256 threads, the other
// warps leaving after it, made the round 15% slower: PERF.md, PR 16).  A
// full table holds one stream an SM, which is why the device-memory
// variants keep the batches past a few waves.
//
// A block whose tables outgrow what its launch was sized for (the wide
// table's slow buckets past its maps, a large table past its rows) sets
// the launch's error word and returns (rans_refuse), and the wrapper
// raises.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "rans4x8_step.cuh"

namespace {

constexpr int kWarp = 32;
constexpr uint32_t kChunkWords = 32;  // one coalesced 128-byte copy
constexpr uint32_t kRingChunks = 8;
constexpr uint32_t kRingWords = kRingChunks * kChunkWords;
constexpr uint32_t kRingMask = kRingWords - 1;
constexpr uint32_t kAhead = 6;   // chunks staged ahead of the cursor's
constexpr uint32_t kBlock = 32;  // rounds between stagings
constexpr int kUnroll = 2;      // rounds a loop step (4 measured no faster)

constexpr int kHistRows = 4;  // lane L counts into row L % 4

// The symbol buffer (lane 0 stores a round's four symbols as one word, and
// after each block of rounds lane L counts or writes out round L's) and,
// for B8, the histogram rows.
template <bool kHist>
struct Emit {
  uint32_t buf[kBlock];
};
template <>
struct Emit<true> {
  uint32_t buf[kBlock];
  int32_t hist[kHistRows][257];
};

struct O0Lookup {
  uint32_t tab[RANS_TOTFREQ];
};
struct O1Lookup {
  uint32_t tab[RANS_O1_RECORDS];
  uint16_t bucket[256 * RANS_O1_BUCKETS];
};
// no table in the block's Tables: the dense table lies in device memory,
// and the large table's planes follow the Tables in shared memory
struct NoLookup {};
// the wide order-1 table (rans4x8_step.cuh); the slow buckets' maps follow
// the block's Tables in shared memory
struct WideLookup {
  Rans8Rec rec[RANS8_WIDE_RECORDS];
  uint32_t bucket[256 * RANS_O1_BUCKETS];
};

// The lookup table a variant keeps in its Tables.
template <bool kO1, bool kDense, bool kWide, bool kLarge>
using LutOf = typename std::conditional<
    kDense || kLarge, NoLookup,
    typename std::conditional<
        kWide, WideLookup,
        typename std::conditional<kO1, O1Lookup, O0Lookup>::type>::type>::
    type;

template <bool kHist, bool kO1, bool kDense = false, bool kWide = false,
          bool kLarge = false>
struct Tables {
  LutOf<kO1, kDense, kWide, kLarge> lut;
  union {
    // the ring of payload chunks, and copies of its first two words
    uint32_t ring[kRingWords + 2];
    // the frequencies (order 0) or context starts (order 1), read only
    // while the tables are built
    uint16_t setup[258];
  };
  Emit<kHist> emit;
};

struct Args {
  const uint8_t* payload;
  const int64_t* byte_off;
  const int32_t* n_bytes;
  const int32_t* freqs;
  const uint32_t* rows;
  const int64_t* row_off;
  const int32_t* ctx_start;
  const uint32_t* dense;
  const uint32_t* x0;
  const int32_t* ulen;
  const int64_t* out_off;
  uint8_t* out;
  const int32_t* offs;
  int32_t* hist;
  uint32_t* x_out;
  int32_t* cur_out;
  int32_t* ctx_out;
  int32_t* err;  // the error word (rans_refuse); null where none refuses
  int qbins;
  int max_rounds;
  int max_slow;  // the wide table: slow buckets a block's maps hold
  int shift;     // the large table: its buckets hold 1 << shift slots
};

// One stream's decode state: the four states and contexts, the window at
// the cursor, and the ring's staging counters.  `round` is one round of
// the warp (every lane the same), forced inline so the state stays in
// registers; it returns the round's four symbols packed in a word.  kW16:
// the Nx16 wire's refill; kDense: order 1 through the stream's dense table;
// kWide: order 1 through the wide table (contexts held as symbol * 256);
// kLarge: order 1 through the large table.
template <bool kHist, bool kO1, bool kW16, bool kDense = false,
          bool kWide = false, bool kLarge = false>
struct Stream {
  Tables<kHist, kO1, kDense, kWide, kLarge>& t;
  const uint32_t* dense;
  const uint32_t* words;
  uint8_t* out;
  uint32_t nb, cap;
  int lane, off, qbins;
  int64_t quarter;  // n / 4: where order-1 symbols put state j's
  uint32_t x[RANS8_NWAY], ctx7[RANS8_NWAY];  // contexts times 128
  Rans8Window w;
  uint32_t issued, swapped;  // chunks copied in, and byte-swapped
  const uint16_t* maps;      // the wide table's slow-bucket maps
  RansO1Large large;         // the large table's planes

  // Copy chunk q into its ring slot (cp.async, the bytes past the payload
  // zero-filled).
  __device__ __forceinline__ void copy_chunk(uint32_t q) {
    const uint32_t idx = q * kChunkWords + lane;
    const uint32_t at = idx * 4u;
    const uint32_t n = at >= nb ? 0u : (nb - at < 4u ? nb - at : 4u);
    const uint32_t dst = static_cast<uint32_t>(
        __cvta_generic_to_shared(&t.ring[idx & kRingMask]));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(words + (n ? idx : 0u)), "r"(n));
  }

  // Make the chunks the next block of rounds reads ready: copy up to
  // kAhead chunks past the cursor's, wait for all but this call's copies,
  // and byte-swap the chunks that arrived (so the window reads them
  // big-endian).  Every lane runs it: the branches are uniform.
  __device__ __forceinline__ void stage() {
    rans8_cap(&w, cap, t.ring, kRingMask);
    const uint32_t before = issued;
    for (; issued <= (w.pos >> 7) + kAhead; ++issued) copy_chunk(issued);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncwarp();
    bool swapped_any = false;
    for (; swapped < before; ++swapped) {
      const uint32_t i = (swapped * kChunkWords + lane) & kRingMask;
      const uint32_t v = rans8_bswap(t.ring[i]);
      t.ring[i] = v;
      if (i < 2) t.ring[kRingWords + i] = v;
      swapped_any = true;
    }
    if (swapped_any) {
      __syncwarp();
      rans8_load(&w, w.pos, t.ring, kRingMask);
    }
  }

  __device__ __forceinline__ uint32_t round(unsigned live) {
    uint32_t syms, hi, lo;
    rans8_window(w.w0, w.w1, w.w2, w.pos, &hi, &lo);
    uint32_t k;
    if constexpr (kWide)
      k = rans8_round_wide<kW16>(x, ctx7, &syms, live, hi, lo, t.lut.rec,
                                 t.lut.bucket, maps);
    else if constexpr (kLarge)
      k = rans8_round_large<kW16>(x, ctx7, &syms, live, hi, lo, large);
    else if constexpr (kDense)
      k = rans8_round<true, kW16, true>(x, ctx7, &syms, live, hi, lo, dense,
                                        nullptr);
    else if constexpr (kO1)
      k = rans8_round<true, kW16>(x, ctx7, &syms, live, hi, lo, t.lut.tab,
                                  t.lut.bucket);
    else
      k = rans8_round<false, kW16>(x, ctx7, &syms, live, hi, lo, t.lut.tab,
                                   nullptr);
    rans8_advance(&w, k, t.ring, kRingMask);
    return syms;
  }

  // Symbol j (< 4) of round r: counted in this lane's histogram row, or
  // written to its position (rans8_live's).
  __device__ __forceinline__ void keep(uint32_t r, int j, uint32_t s) {
    if constexpr (kHist)
      atomicAdd(&t.emit.hist[lane % kHistRows][rans_hist_bin(s, off, qbins)],
                1);
    else if constexpr (kO1)
      out[j * quarter + r] = (uint8_t)s;
    else
      out[(int64_t)r * RANS8_NWAY + j] = (uint8_t)s;
  }

  // The buffered rounds r0 .. r0 + n - 1: lane L keeps round r0 + L's.
  __device__ __forceinline__ void flush(uint32_t r0, uint32_t n) {
    __syncwarp();
    if ((uint32_t)lane < n) {
      const uint32_t v = t.emit.buf[lane];
      for (int j = 0; j < RANS8_NWAY; ++j)
        keep(r0 + lane, j, (v >> (8 * j)) & 0xFFu);
    }
    __syncwarp();
  }
};

template <bool kHist, bool kO1, bool kW16, bool kDense = false,
          bool kWide = false, bool kLarge = false>
__global__ void __launch_bounds__(kWarp) rans4x8_kernel(const Args a) {
  static_assert(!kWide || (kO1 && !kDense), "the wide table is order 1's");
  static_assert(!kLarge || (kO1 && !kHist && !kDense && !kWide),
                "the large table decodes order-1 symbols");
  extern __shared__ __align__(16) unsigned char smem[];
  auto& t =
      *reinterpret_cast<Tables<kHist, kO1, kDense, kWide, kLarge>*>(smem);
  const int lane = threadIdx.x;
  const int st = blockIdx.x;
  const uint32_t nb = (uint32_t)a.n_bytes[st];
  // past the payload's last word every byte reads 0; the cap keeps the
  // cursor (and the ring's chunks) a few words beyond it
  Stream<kHist, kO1, kW16, kDense, kWide, kLarge> s = {
      t, kDense ? a.dense + (int64_t)st * (256 * RANS_TOTFREQ) : nullptr,
      reinterpret_cast<const uint32_t*>(a.payload + a.byte_off[st]),
      kHist ? nullptr : a.out + a.out_off[st], nb, 4u * ((nb + 3u) / 4u) + 32u,
      lane, kHist ? a.offs[st] : 0, a.qbins};

  s.maps = reinterpret_cast<const uint16_t*>(smem + sizeof(t));

  // the lookup tables (a dense table lies in device memory as it is)
  if constexpr (kWide) {
    uint16_t* maps = reinterpret_cast<uint16_t*>(smem + sizeof(t));
    const uint32_t* rows = a.rows + a.row_off[st];
    for (int c = lane; c < 257; c += kWarp)
      t.setup[c] = (uint16_t)a.ctx_start[(int64_t)st * 257 + c];
    __syncwarp();
    rans8_wide_build(rows, t.setup, t.lut.rec, t.lut.bucket, lane, kWarp);
    // number the slow buckets lane by lane: an exclusive prefix of the
    // lanes' counts (each lane counts and maps the contexts it built)
    const int cnt = rans8_wide_count_slow(t.lut.bucket, lane, kWarp);
    int incl = cnt;
    for (int o = 1; o < kWarp; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    // the host sized the maps for the batch's most slow buckets
    if (__shfl_sync(0xffffffffu, incl, kWarp - 1) > a.max_slow) {
      if (lane == 0) rans_refuse(a.err, RANS_REFUSE_MAPS);
      return;
    }
    rans8_wide_maps(rows, t.setup, t.lut.bucket, maps, incl - cnt, lane,
                    kWarp);
    __syncwarp();
  } else if constexpr (kLarge) {
    // the planes after the Tables, sized by the host for the batch's most
    // rows: a stream with more is refused
    const int32_t* cs = a.ctx_start + (int64_t)st * 257;
    const uint32_t* rows = a.rows + a.row_off[st];
    const int n = cs[256];
    const RansO1LargeLayout l = rans_o1_large_layout(n, 256, a.shift);
    uint32_t avail;
    asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(avail));
    if (sizeof(t) + (uint32_t)l.end > avail) {
      if (lane == 0) rans_refuse(a.err, RANS_REFUSE_SMEM);
      return;
    }
    const RansO1LargeOut o =
        rans_o1_large_planes(smem + sizeof(t), l, a.shift);
    rans_o1_large_rows(rows, n, o, lane, kWarp);
    __syncwarp();
    rans_o1_large_contexts(rows, cs, o, lane, kWarp);
    __syncwarp();
    s.large = rans_o1_large_view(o);
  } else if constexpr (kO1 && !kDense) {
    for (int c = lane; c < 257; c += kWarp)
      t.setup[c] = (uint16_t)a.ctx_start[(int64_t)st * 257 + c];
    __syncwarp();
    rans_o1_build(a.rows + a.row_off[st], t.setup, t.lut.tab, t.lut.bucket,
                   lane, kWarp);
  } else if constexpr (!kO1) {
    for (int i = lane; i < 256; i += kWarp)
      t.setup[i] = (uint16_t)a.freqs[(int64_t)st * 256 + i];
    __syncwarp();
    rans_o0_build_slots(t.setup, t.lut.tab, lane, kWarp);
  }
  if constexpr (kHist)
    for (int i = lane; i < kHistRows * 257; i += kWarp)
      (&t.emit.hist[0][0])[i] = 0;
  // the ring takes the place of the set-up words: every lane is done with
  // them before the first copy
  __syncwarp();
  // the first chunks, waited for in full
  for (; s.issued < kAhead + 1; ++s.issued) s.copy_chunk(s.issued);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  s.stage();

  const int64_t n = a.ulen[st];
  if constexpr (kO1 && !kHist) s.quarter = n / RANS8_NWAY;
  int64_t rounds = rans8_rounds(kO1, n);
  if (a.max_rounds >= 0 && rounds > a.max_rounds) rounds = a.max_rounds;
  // rounds in which all four states decode, then the tail
  const uint32_t full =
      (uint32_t)(n / RANS8_NWAY < rounds ? n / RANS8_NWAY : rounds);
  for (int j = 0; j < RANS8_NWAY; ++j) {
    s.x[j] = a.x0[(int64_t)st * RANS8_NWAY + j];
    s.ctx7[j] = 0;
  }
  // blocks of kBlock rounds with no branch but the loop's: a block takes
  // at most 256 bytes, so the chunks staged before it cover it
  uint32_t r = 0;
  for (; r + kBlock <= full; r += kBlock) {
#pragma unroll kUnroll
    for (uint32_t i = 0; i < kBlock; ++i) {
      const uint32_t p = s.round(0xFu);
      if (lane == 0) t.emit.buf[i] = p;
    }
    s.flush(r, kBlock);
    s.stage();
  }
  // the rest one round at a time
  for (; r < (uint32_t)rounds; ++r) {
    unsigned live = 0;
    for (int j = 0; j < RANS8_NWAY; ++j) {
      int64_t pos;
      if (rans8_live(kO1, n, j, r, &pos)) live |= 1u << j;
    }
    const uint32_t p = s.round(live);
    if (lane < RANS8_NWAY && ((live >> lane) & 1u))
      s.keep(r, lane, (p >> (8 * lane)) & 0xFFu);
    s.stage();
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  // lane 0 writes every state: indexing the states by lane would move
  // them to local memory
  if (lane == 0) {
    for (int j = 0; j < RANS8_NWAY; ++j) {
      a.x_out[(int64_t)st * RANS8_NWAY + j] = s.x[j];
      a.ctx_out[(int64_t)st * RANS8_NWAY + j] =
          (int32_t)(s.ctx7[j] >> (kWide ? 8 : 7));
    }
    // the wire's cursor stops at the payload's end (rans_advance)
    a.cur_out[st] = (int32_t)(s.w.pos < nb ? s.w.pos : nb);
  }
  if constexpr (kHist) {
    __syncwarp();
    for (int b = lane; b < a.qbins; b += kWarp) {
      int32_t sum = 0;
      for (int l = 0; l < kHistRows; ++l) sum += t.emit.hist[l][b];
      a.hist[(int64_t)st * a.qbins + b] = sum;
    }
  }
}

// Bytes of dynamic shared memory a block of the variant takes: its Tables
// and, for the wide table, the maps of `extra` slow buckets, for the large
// table the planes of `extra` rows with buckets of 1 << shift slots.
template <bool kHist, bool kO1, bool kDense, bool kWide, bool kLarge = false>
int smem_of(int extra, int shift = RANS_O1_LARGE_SHIFT) {
  return (int)sizeof(Tables<kHist, kO1, kDense, kWide, kLarge>) +
         (kWide ? 2 * RANS8_WIDE_MAP * extra : 0) +
         (kLarge ? rans_o1_large_layout(extra, 256, shift).end : 0);
}

// Set the variant up for its tables in dynamic shared memory, with the
// largest shared-memory carveout so that as many blocks share an SM as the
// tables allow; returns a CUDA error code.
template <bool kHist, bool kO1, bool kW16, bool kDense, bool kWide,
          bool kLarge = false>
cudaError_t configure(int smem) {
  auto* fn = rans4x8_kernel<kHist, kO1, kW16, kDense, kWide, kLarge>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(fn,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// One launch of the variant, its shared memory sized for `extra` (smem_of);
// returns a CUDA error code (an attribute's, or the launch's).
template <bool kHist, bool kO1, bool kW16, bool kDense = false,
          bool kWide = false, bool kLarge = false>
int launch(const Args& a, int n_streams, cudaStream_t s, int extra = 0) {
  const int smem = smem_of<kHist, kO1, kDense, kWide, kLarge>(extra, a.shift);
  const cudaError_t e =
      configure<kHist, kO1, kW16, kDense, kWide, kLarge>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  rans4x8_kernel<kHist, kO1, kW16, kDense, kWide, kLarge>
      <<<n_streams, kWarp, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Blocks (streams) of the variant one SM holds at once, its shared memory
// sized for `extra`, or minus a CUDA error code.
template <bool kHist, bool kO1, bool kW16, bool kDense = false,
          bool kWide = false, bool kLarge = false>
int blocks_per_sm(int extra = 0, int shift = RANS_O1_LARGE_SHIFT) {
  const int smem = smem_of<kHist, kO1, kDense, kWide, kLarge>(extra, shift);
  cudaError_t e = configure<kHist, kO1, kW16, kDense, kWide, kLarge>(smem);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, rans4x8_kernel<kHist, kO1, kW16, kDense, kWide, kLarge>, kWarp,
        smem);
  // a refused size (the wide table's maps past a block's shared memory)
  // must not stay behind as the next launch's error
  if (e != cudaSuccess) cudaGetLastError();
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

Args make_args(const void* payload, const void* byte_off, const void* n_bytes,
               const void* freqs, const void* rows, const void* row_off,
               const void* ctx_start, const void* dense, const void* x0,
               const void* ulen, const void* out_off, void* out,
               const void* offs, void* hist, void* x_out, void* cur_out,
               void* ctx_out, void* err, int qbins, int max_rounds,
               int max_slow) {
  return {static_cast<const uint8_t*>(payload),
          static_cast<const int64_t*>(byte_off),
          static_cast<const int32_t*>(n_bytes),
          static_cast<const int32_t*>(freqs),
          static_cast<const uint32_t*>(rows),
          static_cast<const int64_t*>(row_off),
          static_cast<const int32_t*>(ctx_start),
          static_cast<const uint32_t*>(dense),
          static_cast<const uint32_t*>(x0),
          static_cast<const int32_t*>(ulen),
          static_cast<const int64_t*>(out_off),
          static_cast<uint8_t*>(out),
          static_cast<const int32_t*>(offs),
          static_cast<int32_t*>(hist),
          static_cast<uint32_t*>(x_out),
          static_cast<int32_t*>(cur_out),
          static_cast<int32_t*>(ctx_out),
          static_cast<int32_t*>(err),
          qbins,
          max_rounds,
          max_slow,
          RANS_O1_LARGE_SHIFT};
}

}  // namespace

// Symbols (out != NULL) or an order-0/1 histogram (hist != NULL) of
// n_streams streams on `stream`: order o1, and with w16 the 4-way Nx16
// wire's refill (symbols only); n_rows is not read (a stream's
// ctx_start[256] is its row count).  With `dense` (order-1 symbols only),
// stream s's table is dense[s * 256 * 4096 ...] (rans_o1_dense) and the
// record tables are not read.  Returns cudaGetLastError() after the
// launch, the error of the shared-memory attribute when it is refused, or
// cudaErrorInvalidValue for a combination with no kernel (an Nx16
// histogram, a dense histogram or dense order 0).
extern "C" int rans4x8_launch(
    const void* payload, const void* byte_off, const void* n_bytes,
    const void* freqs, const void* rows, const void* row_off,
    const void* n_rows, const void* ctx_start, const void* dense,
    const void* x0,
    const void* ulen, const void* out_off, void* out, const void* offs,
    void* hist, void* x_out, void* cur_out, void* ctx_out, int n_streams,
    int qbins, int max_rounds, int o1, int w16, void* stream) {
  if (n_streams <= 0) return 0;
  if ((hist != nullptr && (w16 || dense != nullptr)) ||
      (dense != nullptr && !o1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(payload, byte_off, n_bytes, freqs, rows, row_off,
                           ctx_start, dense, x0, ulen, out_off, out, offs,
                           hist, x_out, cur_out, ctx_out, nullptr, qbins,
                           max_rounds, 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hist != nullptr)
    return o1 ? launch<true, true, false>(a, n_streams, s)
              : launch<true, false, false>(a, n_streams, s);
  if (dense != nullptr)
    return w16 ? launch<false, true, true, true>(a, n_streams, s)
               : launch<false, true, false, true>(a, n_streams, s);
  if (w16)
    return o1 ? launch<false, true, true>(a, n_streams, s)
              : launch<false, false, true>(a, n_streams, s);
  return o1 ? launch<false, true, false>(a, n_streams, s)
            : launch<false, false, false>(a, n_streams, s);
}

// Streams of a launch that one SM decodes at once: symbols (hist == 0: B7,
// X1-X3, with `dense` X1/X3 over dense tables) or a histogram (B8) of
// order o1, w16 the Nx16 refill; minus a CUDA error code on failure.
extern "C" int rans4x8_blocks_per_sm(int hist, int o1, int w16, int dense) {
  if ((hist && (w16 || dense)) || (dense && !o1))
    return -static_cast<int>(cudaErrorInvalidValue);
  if (dense)
    return w16 ? blocks_per_sm<false, true, true, true>()
               : blocks_per_sm<false, true, false, true>();
  if (hist)
    return o1 ? blocks_per_sm<true, true, false>()
              : blocks_per_sm<true, false, false>();
  if (w16)
    return o1 ? blocks_per_sm<false, true, true>()
              : blocks_per_sm<false, false, true>();
  return o1 ? blocks_per_sm<false, true, false>()
            : blocks_per_sm<false, false, false>();
}

// Bytes of shared memory a block (a stream) takes: symbols or a histogram
// (hist) of order o1, or (dense) order-1 symbols over a dense table (the
// refill does not change it).
extern "C" int rans4x8_smem_bytes(int hist, int o1, int dense) {
  if (dense) return (int)sizeof(Tables<false, true, true>);
  if (hist)
    return o1 ? (int)sizeof(Tables<true, true>)
              : (int)sizeof(Tables<true, false>);
  return o1 ? (int)sizeof(Tables<false, true>)
            : (int)sizeof(Tables<false, false>);
}

// The wide order-1 table's variants (rans4x8_step.cuh): X1 (symbols), X3
// (symbols, w16) or B8 order 1 (hist != NULL), the arguments of
// rans4x8_launch (order 1, no dense table), with shared memory for the
// maps of max_slow slow buckets a stream; a stream with more sets the
// int32 error word `err` (zeroed before) to RANS_REFUSE_MAPS.
extern "C" int rans4x8_wide_launch(
    const void* payload, const void* byte_off, const void* n_bytes,
    const void* freqs, const void* rows, const void* row_off,
    const void* n_rows, const void* ctx_start, const void* x0,
    const void* ulen, const void* out_off, void* out, const void* offs,
    void* hist, void* x_out, void* cur_out, void* ctx_out, void* err,
    int n_streams, int qbins, int max_rounds, int w16, int max_slow,
    void* stream) {
  if (n_streams <= 0) return 0;
  if ((hist != nullptr && w16) || max_slow < 0 || err == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(payload, byte_off, n_bytes, freqs, rows, row_off,
                           ctx_start, nullptr, x0, ulen, out_off, out, offs,
                           hist, x_out, cur_out, ctx_out, err, qbins,
                           max_rounds, max_slow);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hist != nullptr)
    return launch<true, true, false, false, true>(a, n_streams, s, max_slow);
  return w16 ? launch<false, true, true, false, true>(a, n_streams, s,
                                                      max_slow)
             : launch<false, true, false, false, true>(a, n_streams, s,
                                                       max_slow);
}

// The large order-1 table's variants: X1 (symbols) or X3 (w16) over
// tables of any row count up to RANS_O1_LARGE_MAX_ROWS, the arguments of
// rans4x8_wide_launch but the histogram, with shared memory for the planes
// of max_rows rows a stream and buckets of 1 << shift slots (shift 3-5); a
// stream with more rows sets the error word `err` to RANS_REFUSE_SMEM.
extern "C" int rans4x8_large_launch(
    const void* payload, const void* byte_off, const void* n_bytes,
    const void* freqs, const void* rows, const void* row_off,
    const void* n_rows, const void* ctx_start, const void* x0,
    const void* ulen, const void* out_off, void* out, void* x_out,
    void* cur_out, void* ctx_out, void* err, int n_streams, int max_rounds,
    int w16, int max_rows, int shift, void* stream) {
  if (n_streams <= 0) return 0;
  if (max_rows < 0 || max_rows > RANS_O1_LARGE_MAX_ROWS || err == nullptr ||
      shift < RANS_O1_LARGE_SHIFT_MIN || shift > RANS_O1_LARGE_SHIFT)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(payload, byte_off, n_bytes, freqs, rows, row_off,
                     ctx_start, nullptr, x0, ulen, out_off, out, nullptr,
                     nullptr, x_out, cur_out, ctx_out, err, 0, max_rounds, 0);
  a.shift = shift;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return w16 ? launch<false, true, true, false, false, true>(a, n_streams, s,
                                                             max_rows)
             : launch<false, true, false, false, false, true>(a, n_streams,
                                                              s, max_rows);
}

// Shared memory a block of the large variants takes, and the streams an SM
// holds (or minus a CUDA error code), for tables of max_rows rows and
// buckets of 1 << shift slots.
extern "C" int rans4x8_large_smem_bytes(int max_rows, int shift) {
  return smem_of<false, true, false, false, true>(max_rows, shift);
}

extern "C" int rans4x8_large_blocks_per_sm(int w16, int max_rows,
                                           int shift) {
  return w16 ? blocks_per_sm<false, true, true, false, false, true>(max_rows,
                                                                    shift)
             : blocks_per_sm<false, true, false, false, false, true>(
                   max_rows, shift);
}

// Shared memory a block of the wide variants takes, and the streams an SM
// holds (or minus a CUDA error code), for max_slow slow buckets a stream.
extern "C" int rans4x8_wide_smem_bytes(int hist, int max_slow) {
  return hist ? smem_of<true, true, false, true>(max_slow)
              : smem_of<false, true, false, true>(max_slow);
}

extern "C" int rans4x8_wide_blocks_per_sm(int hist, int w16, int max_slow) {
  if (hist && w16) return -static_cast<int>(cudaErrorInvalidValue);
  if (hist) return blocks_per_sm<true, true, false, false, true>(max_slow);
  return w16 ? blocks_per_sm<false, true, true, false, true>(max_slow)
             : blocks_per_sm<false, true, false, false, true>(max_slow);
}

extern "C" const char* kernel_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
