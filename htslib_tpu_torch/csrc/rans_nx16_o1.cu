// rANS Nx16 order-1 32-way decode on Hopper: symbols (kernel B5) or a
// per-stream histogram of them (kernel B6), one launch for the whole batch.
//
// Replaces: htslib_tpu/ops/rans_o1_pallas.py:98 _make_seg1_kernel (decode,
// driven by decode_nx16_o1_batch) and :170 _make_seg1_hist_kernel (decode
// + histogram, driven by ops/device_stats.py:qualstats_device_o1).  Unlike
// those, the <= 31-symbol tail on the last state runs here too, so no
// stream is finished on the host.
//
// What bounds it: round latency, not bytes or operations.  Each stream is
// a chain of n - 31*(n/32) dependent rounds (its last state's length), 32,768
// for a 1 MiB stream: an order-1 table lookup in shared memory, a
// multiply-add, and for the states that renormalise a warp ballot and
// shuffle to fetch the next word.  Where a batch holds fewer streams than
// the card has SMs nothing hides a round, so time is rounds times the
// round's latency; a whole-file batch of hundreds to thousands of streams
// is bound by how many streams an SM holds, that is by the shared memory a
// stream's tables take.
//
// Design: one warp per stream (one per block), lane j holding state j.
// The table is the one of rans_nx16_o1_step.cuh, indexed densely over the
// stream's own alphabet (built by the warp: rans_o1_mark, rans_o1_index,
// rans_o1_build), and each lane holds its context as ctx7 = index * 128,
// taken from its record, so a lookup is a u16 bucket load, then the load
// of its record and the next, then a select: no context start and no
// per-lane loop on the chain.  The 32 picks issue together.  A bucket in
// which two or more rows start after its first slot (RANS_O1_SLOW) has a
// 68-byte map of its slots, built from the table's walk (rans_o1_maps);
// only when __any_sync finds a lane in such a bucket do the slow lanes
// take one load more through its map (rans_o1_mapped).  Quality streams
// meet a slow bucket in about half their rounds, and a walk there costs the
// warp its slowest lane's rows.  Refills keep the wire's state order
// (rans_nx16_o0.cu): ballot of the states that need a word, rank =
// popc(mask & lanes below), the word from a register window of the next
// 128 words read with shuffles, the cursor advanced by popc(mask).  The
// output is off the round: rounds run in blocks of 32 in which every
// state decodes, each lane storing its symbol (B5) or dense index (B6)
// into a swizzled 1 KB buffer, conflict-free; after the block lane j reads
// back its 32 symbols as 8 words and writes them to its segment with
// aligned word stores (B5), or counts them into histogram row j % 8 (B6).
// The < 32 rounds left, tail included, run one at a time.
//
// Shared memory a block: 1,792 bytes, then for B6 8 histogram rows (32
// bytes a context), the records (4 x (rows + 1 + 2 x contexts)), the
// buckets (128 bytes a context) and the maps (68 bytes a slow bucket),
// sized per launch to the batch's largest table (rans_nx16_o1_smem_bytes):
// 15-16 KB for a leg-3 quality stream (41 contexts, ~800 rows, ~60 slow
// buckets), 13-14 streams an SM; at most 200 KB, one stream an SM, for
// the 4,096-row, 256-context limit with every possible bucket slow.
// ptxas (-Xptxas -v, sm_90a): see PERF.md, from the chip run's build log.
//
// The dense variant (B5 over a dense table) decodes the streams whose
// tables pass RANS_O1_MAX_ROWS rows: each lane's entry is one load from
// its stream's [256, 4096] table in device memory (rans_o1_dense, an L2 or
// memory latency on the round's chain), no table is built, and its block
// takes the fixed part of shared memory only.
//
// The large variant (B5 on the streams past RANS_O1_MAX_ROWS rows of a
// batch of at most LARGE_WAVES waves of it: ops/rans_nx16_o1.py
// `large_fits`) decodes them from shared memory instead: the large table
// of rans_nx16_o1_step.cuh over the stream's own alphabet (u16 cum and u8
// index planes, a u32 word and 32 to 128 u8 buckets a context; 232,216
// bytes with the fixed part at 65,536 rows, 256 contexts and 32-slot
// buckets, one stream an SM), sized per launch to the batch's most rows
// and contexts, the buckets as fine as the batch's waves allow.  A lane's
// lookup is a bucket load, six cums, four compares and its index; where
// five rows after the bucket's own start at or before the slot (or the
// slot is past its context's sum) it is slow, and when __any_sync finds
// one the slow lanes walk.  A warp waits for its slowest lane (PERF.md, PR
// 5), so the fast path is fixed-length and covers five rows, and the walk
// is counted in slow_rounds.
//
// A block whose tables outgrow the shared memory its launch was sized for
// sets the launch's error word and returns (rans_refuse); the wrapper
// raises.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rans_nx16_o1_step.cuh"

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlock = 32;          // rounds between flushes of the buffer
constexpr int kUnroll = 2;          // rounds a loop step
constexpr int kHistRows = 8;        // B6: lane j counts into row j % 8
constexpr int kPrefetchWords = 1024;  // 2 KiB ahead, into L2

// The fixed part of a block's shared memory; the tables follow (Layout).
struct Head {
  union {
    uint16_t setup[258];               // context starts, while building
    uint32_t buf[kBlock * kWarp / 4];  // a block's symbols (stage)
    int32_t bins[256];                 // B6: the histogram, at the end
  };
  uint8_t present[256];
  uint8_t index_of[256];
  uint8_t ctx_of[256];
};

// Byte offsets of a block's tables in shared memory, for a stream of n
// rows, n_ctx contexts and n_slow slow buckets: B6's histogram rows (row
// stride n_ctx | 1, so the rows' bins fall in different banks), the
// records, the buckets and the slow buckets' maps.
struct Layout {
  int hist, rec, bucket, maps, end;
};

__host__ __device__ inline Layout o1_layout(int n, int n_ctx, int n_slow,
                                            bool hist) {
  Layout l;
  l.hist = (int)sizeof(Head);
  l.rec = l.hist + (hist ? 4 * kHistRows * (n_ctx | 1) : 0);
  l.bucket = l.rec + 4 * (n + 1 + 2 * n_ctx);
  l.maps = l.bucket + 2 * RANS_O1_BUCKETS * n_ctx;
  l.end = l.maps + RANS_O1_MAP_BYTES * n_slow;
  return l;
}

struct Args {
  const uint8_t* payload;
  const int64_t* word_off;
  const int32_t* n_words;
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
  int32_t* slow_rounds;
  int32_t* err;  // the error word (rans_refuse)
  int qbins;
  int max_rounds;
  int shift;  // the large table: its buckets hold 1 << shift slots
};

// One stream's decode state: the lane's state and context, the word
// window (lane k holds word base+k in w[0], base+32+k in w[1], and the two
// windows after them in flight), the cursor, and the rounds in which some
// lane's bucket was slow.
struct State {
  uint32_t x, ctx7;
  uint32_t w[4];
  uint32_t base, cur, slow;
};

// One round of the warp; the lane's state decodes where `live` (always in
// a full block).  Returns the lane's record, its symbol's dense index in
// bits 24-31.  kDense: `rec` is the stream's dense table (rans_o1_dense),
// whose records carry the symbol itself; kLarge: the lookup is the large
// table's `big` (its symbols dense indices), and only bits 24-31 of the
// returned word are set.
template <bool kAllLive, bool kDense, bool kLarge = false>
__device__ __forceinline__ uint32_t o1_round(State& s, bool live,
                                             const uint32_t* rec,
                                             const uint16_t* bucket,
                                             const uint8_t* maps,
                                             const RansO1Large& big,
                                             const uint16_t* words,
                                             uint32_t nw, int lane) {
  uint32_t e;
  if constexpr (kLarge) {
    bool slow;
    RansO1Hit h = rans_o1_large_pick<5>(big, s.ctx7, s.x, &slow);
    if (__any_sync(kFull, slow)) {
      ++s.slow;
      if (slow) h = rans_o1_large_walk(big, s.ctx7, s.x);
    }
    if (kAllLive || live) {
      s.x = h.f * (s.x >> RANS_TF_SHIFT) + (s.x & (RANS_TOTFREQ - 1)) -
            h.cum;
      s.ctx7 = h.sym << 7;
    }
    e = h.sym << 24;
  } else {
    if constexpr (kDense) {
      e = rans_o1_dense(rec, s.ctx7, s.x);
    } else {
      bool slow;
      uint32_t v;
      e = rans_o1_pick(rec, bucket, s.ctx7, s.x, &slow, &v);
      if (__any_sync(kFull, slow)) {
        ++s.slow;
        if (slow) e = rans_o1_mapped(rec, maps, v, s.x);
      }
    }
    if (kAllLive || live) {
      s.x = rans_o1_advance(s.x, e);
      s.ctx7 = rans_o1_ctx7(e);
    }
  }
  const bool need = (kAllLive || live) && rans_needs_refill(s.x);
  const unsigned mask = __ballot_sync(kFull, need);
  // word cur + rank of this state, as an offset into the window (< 64)
  const uint32_t k = s.cur - s.base + __popc(mask & ((1u << lane) - 1u));
  const uint32_t lo = __shfl_sync(kFull, s.w[0], k & 31);
  const uint32_t hi = __shfl_sync(kFull, s.w[1], k & 31);
  if (need) s.x = rans_refill(s.x, k < 32 ? lo : hi);
  s.cur = (uint32_t)rans_advance(s.cur, __popc(mask), nw);
  if (s.cur - s.base >= 32) {
    s.base += 32;
    s.w[0] = s.w[1];
    s.w[1] = s.w[2];
    s.w[2] = s.w[3];
    s.w[3] = rans_word(words, s.base + 96 + lane, nw);
    if (lane == 0 && s.base + kPrefetchWords < nw)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(words + s.base +
                                                    kPrefetchWords));
  }
  return e;
}

// Word q (< 8) of lane j's row of the symbol buffer, which holds bytes
// 4q .. 4q+3 of its block.  The rows are rotated by j / 4 words, so the 32
// lanes' stores of one round, and their loads of one q, touch 32 banks.
__device__ __forceinline__ int buf_word(int lane, int q) {
  return 8 * lane + ((q + (lane >> 2)) & 7);
}

// The 32 bytes of W (little-endian) to p: bytes up to the first 4-byte
// boundary one at a time, then whole words, then the rest.
__device__ __forceinline__ void store32(uint8_t* p, const uint32_t* W) {
  const uint32_t h = (4u - (uint32_t)(reinterpret_cast<uintptr_t>(p) & 3u)) &
                     3u;
  for (uint32_t i = 0; i < 3; ++i)
    if (i < h) p[i] = (uint8_t)(W[0] >> (8 * i));
  uint32_t* q = reinterpret_cast<uint32_t*>(p + h);
  for (int k = 0; k < 7; ++k) q[k] = __funnelshift_r(W[k], W[k + 1], 8 * h);
  if (h == 0)
    q[7] = W[7];
  else
    for (uint32_t i = 29; i < 32; ++i)
      if (i >= 28 + h) p[i] = (uint8_t)(W[7] >> (8 * (i - 28)));
}

template <bool kHist, bool kDense = false, bool kLarge = false>
__global__ void __launch_bounds__(kWarp) rans_nx16_o1_kernel(const Args a) {
  static_assert(!(kHist && (kDense || kLarge)) && !(kDense && kLarge),
                "the dense and large variants decode symbols");
  extern __shared__ __align__(16) unsigned char smem[];
  Head& h = *reinterpret_cast<Head*>(smem);
  const int lane = threadIdx.x;
  const int st = blockIdx.x;
  const uint32_t* rec = nullptr;
  const uint16_t* bucket = nullptr;
  const uint8_t* maps = nullptr;
  RansO1Large big = {};
  int32_t* hrow = nullptr;
  int n_ctx = 256, stride = 0;
  Layout l = {};
  uint32_t smem_bytes;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(smem_bytes));

  if constexpr (kDense) {
    // contexts and symbols are values: each is its own dense index
    for (int v = lane; v < 256; v += kWarp) h.ctx_of[v] = (uint8_t)v;
    rec = a.dense + (int64_t)st * (256 * RANS_TOTFREQ);
  } else if constexpr (kLarge) {
    // the row planes (their size is the rows'), marking the rows' symbols,
    // then the alphabet, then the context words and buckets over it
    const int32_t* cs = a.ctx_start + (int64_t)st * 257;
    const uint32_t* rows = a.rows + a.row_off[st];
    const int n = cs[256];
    RansO1LargeLayout ll = rans_o1_large_layout(n, 0, a.shift);
    if (sizeof(Head) + (uint32_t)ll.end > smem_bytes) {
      if (lane == 0) rans_refuse(a.err, RANS_REFUSE_SMEM);
      return;
    }
    for (int v = lane; v < 256; v += kWarp) h.present[v] = 0;
    __syncwarp();
    RansO1LargeOut o = rans_o1_large_planes(smem + sizeof(Head), ll,
                                            a.shift);
    rans_o1_large_rows(rows, n, o, lane, kWarp, h.present);
    for (int c = lane; c < 256; c += kWarp)
      if (c == 0 || cs[c] < cs[c + 1]) h.present[c] = 1;
    __syncwarp();
    n_ctx = rans_o1_index(h.present, h.index_of, h.ctx_of, lane, kWarp);
    __syncwarp();
    ll = rans_o1_large_layout(n, n_ctx, a.shift);
    if (sizeof(Head) + (uint32_t)ll.end > smem_bytes) {
      if (lane == 0) rans_refuse(a.err, RANS_REFUSE_SMEM);
      return;
    }
    o = rans_o1_large_planes(smem + sizeof(Head), ll, a.shift);
    rans_o1_large_contexts(rows, cs, o, lane, kWarp, n_ctx, h.ctx_of,
                           h.index_of);
    big = rans_o1_large_view(o);
  } else {
    // the stream's alphabet, then its tables
    for (int c = lane; c < 257; c += kWarp)
      h.setup[c] = (uint16_t)a.ctx_start[(int64_t)st * 257 + c];
    for (int v = lane; v < 256; v += kWarp) h.present[v] = 0;
    __syncwarp();
    const uint32_t* rows = a.rows + a.row_off[st];
    rans_o1_mark(rows, h.setup, h.present, lane, kWarp);
    __syncwarp();
    n_ctx = rans_o1_index(h.present, h.index_of, h.ctx_of, lane, kWarp);
    __syncwarp();
    const int n_rows = h.setup[256];
    l = o1_layout(n_rows, n_ctx, 0, kHist);
    if ((uint32_t)l.end > smem_bytes) {  // the launch sized it wrong
      if (lane == 0) rans_refuse(a.err, RANS_REFUSE_SMEM);
      return;
    }
    uint32_t* rec_w = reinterpret_cast<uint32_t*>(smem + l.rec);
    uint16_t* bucket_w = reinterpret_cast<uint16_t*>(smem + l.bucket);
    uint8_t* maps_w = smem + l.maps;
    rans_o1_build(rows, h.setup, rec_w, bucket_w, lane, kWarp, n_ctx,
                  h.ctx_of, h.index_of);
    __syncwarp();
    // the slow buckets' maps, numbered lane by lane
    const int n_mine = rans_o1_count_slow(bucket_w, n_ctx, lane, kWarp);
    int first = n_mine;
    for (int d = 1; d < kWarp; d <<= 1) {
      const int up = __shfl_up_sync(kFull, first, d);
      if (lane >= d) first += up;
    }
    l = o1_layout(n_rows, n_ctx, __shfl_sync(kFull, first, kWarp - 1),
                  kHist);
    if ((uint32_t)l.end > smem_bytes) {
      if (lane == 0) rans_refuse(a.err, RANS_REFUSE_SMEM);
      return;
    }
    rans_o1_maps(rec_w, bucket_w, maps_w, n_ctx, first - n_mine, lane,
                 kWarp);
    rec = rec_w;
    bucket = bucket_w;
    maps = maps_w;
    stride = n_ctx | 1;
    if (kHist) {
      hrow = reinterpret_cast<int32_t*>(smem + l.hist) +
             (lane % kHistRows) * stride;
      for (int i = lane; i < kHistRows * stride; i += kWarp)
        reinterpret_cast<int32_t*>(smem + l.hist)[i] = 0;
    }
  }
  // the symbol buffer takes the place of the context starts: every lane
  // is done with them
  __syncwarp();

  const uint16_t* words =
      reinterpret_cast<const uint16_t*>(a.payload) + a.word_off[st];
  const uint32_t nw = (uint32_t)a.n_words[st];
  const int64_t n = a.ulen[st];
  const uint32_t seg = (uint32_t)(n / RANS_NWAY);
  const uint32_t len = (uint32_t)rans_o1_state_len(n, lane, RANS_NWAY);
  int64_t rounds64 = rans_o1_state_len(n, RANS_NWAY - 1, RANS_NWAY);
  if (a.max_rounds >= 0 && rounds64 > a.max_rounds) rounds64 = a.max_rounds;
  const uint32_t rounds = (uint32_t)rounds64;
  // rounds in which every state decodes
  const uint32_t full = seg < rounds ? seg : rounds;
  uint8_t* out = kHist ? nullptr
                       : a.out + a.out_off[st] + (int64_t)lane * seg;

  State s;
  s.x = a.x0[(int64_t)st * RANS_NWAY + lane];
  s.ctx7 = 0;  // context 0 has index 0
  for (int i = 0; i < 4; ++i) s.w[i] = rans_word(words, 32 * i + lane, nw);
  s.base = s.cur = s.slow = 0;

  uint8_t* buf = reinterpret_cast<uint8_t*>(h.buf);
  uint32_t r = 0;
  for (; r + kBlock <= full; r += kBlock) {
#pragma unroll kUnroll
    for (int i = 0; i < kBlock; ++i) {
      const uint32_t d =
          o1_round<true, kDense, kLarge>(s, true, rec, bucket, maps, big,
                                         words, nw, lane) >> 24;
      buf[4 * buf_word(lane, i >> 2) + (i & 3)] =
          kHist ? (uint8_t)d : h.ctx_of[d];
    }
    __syncwarp();
    uint32_t W[8];
    for (int q = 0; q < 8; ++q) W[q] = h.buf[buf_word(lane, q)];
    __syncwarp();
    if (kHist) {
      for (int q = 0; q < 8; ++q)
        for (int b = 0; b < 4; ++b) atomicAdd(&hrow[(W[q] >> (8 * b)) & 0xFF], 1);
    } else {
      store32(out + r, W);
    }
  }
  // the rest one round at a time
  for (; r < rounds; ++r) {
    const bool live = r < len;
    const uint32_t d =
        o1_round<false, kDense, kLarge>(s, live, rec, bucket, maps, big,
                                        words, nw, lane) >> 24;
    if (live) {
      if (kHist)
        atomicAdd(&hrow[d], 1);
      else
        out[r] = h.ctx_of[d];
    }
  }

  a.x_out[(int64_t)st * RANS_NWAY + lane] = s.x;
  a.ctx_out[(int64_t)st * RANS_NWAY + lane] = h.ctx_of[s.ctx7 >> 7];
  if (lane == 0) {
    a.cur_out[st] = (int32_t)s.cur;
    if (a.slow_rounds != nullptr) a.slow_rounds[st] = (int32_t)s.slow;
  }
  if (kHist) {
    // the rows summed by context, then into the bins (the buffer is free)
    __syncwarp();
    for (int b = lane; b < 256; b += kWarp) h.bins[b] = 0;
    __syncwarp();
    const int32_t* rows0 = reinterpret_cast<const int32_t*>(smem + l.hist);
    const int off = a.offs[st];
    for (int d = lane; d < n_ctx; d += kWarp) {
      int32_t sum = 0;
      for (int i = 0; i < kHistRows; ++i) sum += rows0[i * stride + d];
      atomicAdd(&h.bins[rans_hist_bin(h.ctx_of[d], off, a.qbins)], sum);
    }
    __syncwarp();
    for (int b = lane; b < a.qbins; b += kWarp)
      a.hist[(int64_t)st * a.qbins + b] = h.bins[b];
  }
}

// Set the variant up for `smem` bytes of dynamic shared memory, with the
// largest shared-memory carveout so that as many blocks share an SM as
// their tables allow; returns a CUDA error code.
template <bool kHist, bool kDense = false, bool kLarge = false>
cudaError_t configure(int smem) {
  auto* fn = rans_nx16_o1_kernel<kHist, kDense, kLarge>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(fn,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <bool kHist, bool kLarge = false>
int blocks_per_sm(int smem) {
  cudaError_t e = configure<kHist, false, kLarge>(smem);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, rans_nx16_o1_kernel<kHist, false, kLarge>, kWarp, smem);
  // a refused size must not stay behind as the next launch's error
  if (e != cudaSuccess) cudaGetLastError();
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

}  // namespace

// Bytes of dynamic shared memory a block of B5 (hist == 0) or B6 needs for
// a stream of n_rows rows, an alphabet of n_ctx contexts and n_slow slow
// buckets; a launch whose streams are all within these takes this many.
extern "C" int rans_nx16_o1_smem_bytes(int n_rows, int n_ctx, int n_slow,
                                       int hist) {
  return o1_layout(n_rows, n_ctx, n_slow, hist != 0).end;
}

// Bytes of dynamic shared memory a block of B5's large variant needs for a
// stream of n_rows rows, an alphabet of n_ctx contexts and buckets of
// 1 << shift slots.
extern "C" int rans_nx16_o1_large_smem_bytes(int n_rows, int n_ctx,
                                             int shift) {
  return (int)sizeof(Head) + rans_o1_large_layout(n_rows, n_ctx, shift).end;
}

// Decode (out != NULL) or histogram (hist != NULL) n_streams streams on
// `stream`, every block with smem_bytes of dynamic shared memory (with
// `dense`, symbols only: stream s's table is dense[s * 256 * 4096 ...],
// rans_o1_dense, and the record tables are not read; with large_shift 3-5,
// symbols only, through the large table with buckets of 1 << large_shift
// slots, for any row count up to RANS_O1_LARGE_MAX_ROWS); slow_rounds (may be NULL) gets, per stream, the
// rounds in which some state's bucket was slow (its lookup went through
// the bucket's map, or the large table's walk).  n_rows is not read (a
// stream's ctx_start[256] is its row count).  A stream whose tables
// outgrow smem_bytes sets the int32 error word `err` (zeroed before) to
// RANS_REFUSE_SMEM.  Returns cudaGetLastError() after the launch, or the
// error of the shared-memory attribute when it is refused.
extern "C" int rans_nx16_o1_launch(
    const void* payload, const void* word_off, const void* n_words,
    const void* rows, const void* row_off, const void* n_rows,
    const void* ctx_start, const void* dense, const void* x0,
    const void* ulen,
    const void* out_off, void* out, const void* offs, void* hist,
    void* x_out, void* cur_out, void* ctx_out, void* slow_rounds, void* err,
    int n_streams, int qbins, int max_rounds, int smem_bytes,
    int large_shift, void* stream) {
  (void)n_rows;
  if (n_streams <= 0) return 0;
  const bool large = large_shift != 0;
  if ((hist != nullptr && (dense != nullptr || large)) ||
      (dense != nullptr && large) || err == nullptr ||
      (large && (large_shift < RANS_O1_LARGE_SHIFT_MIN ||
                 large_shift > RANS_O1_LARGE_SHIFT)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = {static_cast<const uint8_t*>(payload),
                  static_cast<const int64_t*>(word_off),
                  static_cast<const int32_t*>(n_words),
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
                  static_cast<int32_t*>(slow_rounds),
                  static_cast<int32_t*>(err),
                  qbins,
                  max_rounds,
                  large ? large_shift : RANS_O1_LARGE_SHIFT};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (hist != nullptr) {
    e = configure<true>(smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    rans_nx16_o1_kernel<true><<<n_streams, kWarp, smem_bytes, s>>>(a);
  } else if (dense != nullptr) {
    e = configure<false, true>(smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    rans_nx16_o1_kernel<false, true><<<n_streams, kWarp, smem_bytes, s>>>(a);
  } else if (large) {
    e = configure<false, false, true>(smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    rans_nx16_o1_kernel<false, false, true>
        <<<n_streams, kWarp, smem_bytes, s>>>(a);
  } else {
    e = configure<false>(smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    rans_nx16_o1_kernel<false><<<n_streams, kWarp, smem_bytes, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// Streams of a launch with smem_bytes of dynamic shared memory a block
// that one SM decodes at once, in B5 (hist == 0) or B6; minus a CUDA error
// code on failure.
extern "C" int rans_nx16_o1_blocks_per_sm(int hist, int smem_bytes) {
  return hist ? blocks_per_sm<true>(smem_bytes)
              : blocks_per_sm<false>(smem_bytes);
}

// The same for B5's large variant.
extern "C" int rans_nx16_o1_large_blocks_per_sm(int smem_bytes) {
  return blocks_per_sm<false, true>(smem_bytes);
}

extern "C" const char* kernel_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
