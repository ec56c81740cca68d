// Banded glocal HMM realignment of a batch of reads (kernel X6): the BAQ
// forward/backward/MAP of probaln.c:77, a read a thread for the short
// reads and a read a warp for the long ones.
//
// Replaces: htslib_tpu/ops/probaln.py:50 probaln_batch, XLA code (no
// Pallas kernel): a lax.scan over the query rows, each with a serial
// D-chain lax.scan along the band (:120-131 forward, :220-226 backward),
// the MAP fused into the backward scan (:248-274).  As torch ops that is
// a handful of launches a band cell a row.  The arithmetic, in the JAX
// function's order, is probaln_step.cuh; this file lays the reads out.
//
// What bounds it: the chains.  A row needs the row before (its sum scales
// the next), and each row holds a serial D chain and serial sums that
// must keep XLA's order for float64 to give the JAX integers; the bytes
// (a read's forward rows, lq x J cells, kept for the MAP) come second.
//
// Design, two kernels in the float type of the query probabilities
// (template T: double, or float):
//   - probaln_kernel, one thread a read, for the short reads: the host
//     sorts them by band width and length so the 32 reads of a warp are
//     alike, and gives each warp its own scratch (the largest J and lq of
//     its reads, the 32 reads interleaved [row][cell][lane], so a warp's
//     loads and stores of one cell are one coalesced access).  Each read
//     runs its own band of 2 * bw + 2 cells and its own length.
//   - probaln_warp_kernel, one warp (a block) a read, for the reads at or
//     above the host's length threshold: a thread a read leaves a batch of
//     a few hundred long reads on a few SMs, each thread walking some
//     2,000 rows alone.  The lanes split each row's cells; lane 0 walks
//     the serial chains and sums from shared memory; the MAP runs a row a
//     lane after the backward pass (probaln_read_warp).
#include <cuda_runtime.h>
#include <stdint.h>

#include "probaln_step.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    probaln_kernel(const uint8_t* ref, const int32_t* rlen,
                   const uint8_t* query, const int32_t* qlen, const T* qprob,
                   const int32_t* bw, const int32_t* order,
                   const int64_t* warp_off, const int32_t* warp_j,
                   const int32_t* warp_q, T* scratch, int32_t* pr,
                   int32_t* state, uint8_t* q, uint8_t* flag, int32_t B,
                   int32_t R, int32_t Q, double d, double e) {
  const int32_t t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= B) return;
  const int32_t b = order[t], w = t / 32, lane = t % 32;
  const int64_t jw = warp_j[w], qw = warp_q[w];
  PbScratch<T> s;
  s.cell = 32;
  s.row = jw * 32;
  s.fM = scratch + warp_off[w] + lane;
  s.fI = s.fM + qw * s.row;
  s.ring = s.fI + qw * s.row;
  s.ss = s.ring + 8 * s.row;
  PbRead<T> r;
  r.ref = ref + (int64_t)b * R;
  r.query = query + (int64_t)b * Q;
  r.qp = qprob + (int64_t)b * Q;
  r.lr = rlen[b];
  r.lq = qlen[b];
  r.bw = bw[b];
  r.d = d;
  r.e = e;
  pr[b] = probaln_read<T>(r, s, state + (int64_t)b * Q, q + (int64_t)b * Q,
                          flag ? flag + (int64_t)b * Q : nullptr);
}

// One read a warp: read order[blockIdx.x], its scratch
// pb_warp_scratch(lq, J) elements at off[blockIdx.x], its exchange in
// dynamic shared memory.
template <typename T>
__global__ void __launch_bounds__(32)
    probaln_warp_kernel(const uint8_t* ref, const int32_t* rlen,
                        const uint8_t* query, const int32_t* qlen,
                        const T* qprob, const int32_t* bw,
                        const int32_t* order, const int64_t* off, T* scratch,
                        int32_t* pr, int32_t* state, uint8_t* q,
                        uint8_t* flag, int32_t R, int32_t Q, double d,
                        double e) {
  extern __shared__ __align__(16) unsigned char pb_smem[];
  const int32_t b = order[blockIdx.x];
  PbRead<T> r;
  r.ref = ref + (int64_t)b * R;
  r.query = query + (int64_t)b * Q;
  r.qp = qprob + (int64_t)b * Q;
  r.lr = rlen[b];
  r.lq = qlen[b];
  r.bw = bw[b];
  r.d = d;
  r.e = e;
  const int64_t cells = (int64_t)r.lq * (2 * r.bw + 2);
  PbWarpScratch<T> s;
  s.fM = scratch + off[blockIdx.x];
  s.fI = s.fM + cells;
  s.bM = s.fI + cells;
  s.bI = s.bM + cells;
  s.ss = s.bI + cells;
  s.lg = s.ss + r.lq;
  s.x = reinterpret_cast<T*>(pb_smem);
  const int32_t p =
      probaln_read_warp<T>(r, s, state + (int64_t)b * Q, q + (int64_t)b * Q,
                           flag ? flag + (int64_t)b * Q : nullptr);
  if (threadIdx.x == 0) pr[b] = p;
}

}  // namespace

// The short reads: B reads order[0..B) of the batch, a thread each; per
// warp w of them, scratch elements at warp_off[w]: (2 * warp_q[w] + 8) *
// warp_j[w] * 32 + warp_q[w] * 32.  Each read b's pr[b], and state and q
// (rows of Q) for its first qlen entries, are written, and where `flag` is
// not NULL its row of pb_map's flags.  dbl: T is double (else float).
// Returns cudaGetLastError().
extern "C" int probaln_launch(const void* ref, const void* rlen,
                              const void* query, const void* qlen,
                              const void* qprob, const void* bw,
                              const void* order, const void* warp_off,
                              const void* warp_j, const void* warp_q,
                              void* scratch, void* pr, void* state, void* q,
                              void* flag, int B, int R, int Q, double d,
                              double e,
                              int dbl, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)((B + kThreads - 1) / kThreads);
#define PB_ARGS(T)                                                          \
  static_cast<const uint8_t*>(ref), static_cast<const int32_t*>(rlen),     \
      static_cast<const uint8_t*>(query), static_cast<const int32_t*>(qlen), \
      static_cast<const T*>(qprob), static_cast<const int32_t*>(bw),       \
      static_cast<const int32_t*>(order),                                  \
      static_cast<const int64_t*>(warp_off),                               \
      static_cast<const int32_t*>(warp_j),                                 \
      static_cast<const int32_t*>(warp_q), static_cast<T*>(scratch),       \
      static_cast<int32_t*>(pr), static_cast<int32_t*>(state),             \
      static_cast<uint8_t*>(q), static_cast<uint8_t*>(flag), B, R, Q, d, e
  if (dbl)
    probaln_kernel<double><<<grid, kThreads, 0, st>>>(PB_ARGS(double));
  else
    probaln_kernel<float><<<grid, kThreads, 0, st>>>(PB_ARGS(float));
#undef PB_ARGS
  return static_cast<int>(cudaGetLastError());
}

// The long reads: n reads order[0..n), one warp each, read order[k]'s
// scratch pb_warp_scratch(qlen, 2 * bw + 2) elements at off[k]; jmax the
// largest 2 * bw + 2 of them (sizes the shared exchange, at most
// probaln_warp_j_max()).  Outputs as probaln_launch.  Returns
// cudaGetLastError().
extern "C" int probaln_warp_launch(const void* ref, const void* rlen,
                                   const void* query, const void* qlen,
                                   const void* qprob, const void* bw,
                                   const void* order, const void* off,
                                   void* scratch, void* pr, void* state,
                                   void* q, void* flag, int n, int R, int Q,
                                   double d, double e, int jmax, int dbl,
                                   void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem =
      (size_t)pb_xsize(jmax) * (dbl ? sizeof(double) : sizeof(float));
#define PB_WARGS(T)                                                         \
  static_cast<const uint8_t*>(ref), static_cast<const int32_t*>(rlen),     \
      static_cast<const uint8_t*>(query), static_cast<const int32_t*>(qlen), \
      static_cast<const T*>(qprob), static_cast<const int32_t*>(bw),       \
      static_cast<const int32_t*>(order), static_cast<const int64_t*>(off), \
      static_cast<T*>(scratch), static_cast<int32_t*>(pr),                 \
      static_cast<int32_t*>(state), static_cast<uint8_t*>(q),             \
      static_cast<uint8_t*>(flag), R, Q, d, e
  if (dbl)
    probaln_warp_kernel<double><<<n, 32, smem, st>>>(PB_WARGS(double));
  else
    probaln_warp_kernel<float><<<n, 32, smem, st>>>(PB_WARGS(float));
#undef PB_WARGS
  return static_cast<int>(cudaGetLastError());
}

// The widest band the warp kernel takes: its float64 exchange fits the
// 48 KB of shared memory a block gets without opting in.
extern "C" int probaln_warp_j_max() {
  return (int)(((48 * 1024 / sizeof(double)) - 4) / 6) & ~7;
}

extern "C" const char* kernel_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
