// Banded glocal HMM realignment of a batch of reads (kernel X6): the BAQ
// forward/backward/MAP of probaln.c:77, one read a thread.
//
// Replaces: htslib_tpu/ops/probaln.py:50 probaln_batch, XLA code (no
// Pallas kernel): a lax.scan over the query rows, each with a serial
// D-chain lax.scan along the band (:120-131 forward, :220-226 backward),
// the MAP fused into the backward scan (:248-274).  As torch ops that is
// a handful of launches a band cell a row.  The arithmetic, in the JAX
// function's order, is probaln_step.cuh; this file lays the reads out.
//
// What bounds it: bytes, then the chains.  A read's forward rows (M and
// I, lq x J cells) are kept for the MAP, so every cell is written once
// and read twice; the rest of a read's state (the D row of the row
// before, the three backward rows of the row below) is two rows a kind.
//
// Design: one thread a read, in the float type of the query
// probabilities (template T: double, or float).  The host sorts the reads
// by band width and length so the 32 reads of a warp are alike, and
// gives each warp its own scratch: the largest J and lq of its reads, the
// warp's 32 reads interleaved ([row][cell][lane]), so a warp's loads and
// stores of one cell are one coalesced access.  Each read runs its own
// band of 2 * bw + 2 cells and its own length; the batch's padding (J of
// its widest read) changes no output and costs nothing here.
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
                   int32_t* state, uint8_t* q, int32_t B, int32_t R,
                   int32_t Q, double d, double e) {
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
  pr[b] = probaln_read<T>(r, s, state + (int64_t)b * Q, q + (int64_t)b * Q);
}

}  // namespace

// Per warp w of the sorted reads, scratch elements at warp_off[w]:
// (2 * warp_q[w] + 8) * warp_j[w] * 32 + warp_q[w] * 32.  state and q
// [B, Q] are written for each read's first qlen entries.  dbl: T is
// double (else float).  Returns cudaGetLastError().
extern "C" int probaln_launch(const void* ref, const void* rlen,
                              const void* query, const void* qlen,
                              const void* qprob, const void* bw,
                              const void* order, const void* warp_off,
                              const void* warp_j, const void* warp_q,
                              void* scratch, void* pr, void* state, void* q,
                              int B, int R, int Q, double d, double e,
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
      static_cast<uint8_t*>(q), B, R, Q, d, e
  if (dbl)
    probaln_kernel<double><<<grid, kThreads, 0, st>>>(PB_ARGS(double));
  else
    probaln_kernel<float><<<grid, kThreads, 0, st>>>(PB_ARGS(float));
#undef PB_ARGS
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
