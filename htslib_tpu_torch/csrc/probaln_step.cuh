// One read of the banded glocal HMM (kernel X6, probaln.cu): forward,
// likelihood, backward and MAP, shared with the g++ harness of
// tests/test_torch_probaln.py.  Host compilers see plain inline functions.
//
// The arithmetic is the JAX package's probaln_batch (ops/probaln.py:50),
// operation for operation and in its order, where it departs from the
// scalar probaln_glocal (probaln.c:77): the likelihood is a sum of logs
// (:185-189) and the MAP quality is rest / sum, rest the mass off the
// maximum (:265-267).  Sums over the band run cell by cell from cell 0,
// as XLA's reductions do.  Built with -fmad=false (nvcc) and
// -ffp-contract=off (g++): no multiply-add is contracted, so a float64
// run gives the JAX function's integers.
//
// A read's band row i holds cells j = 0 .. J-1 (J = 2 * bw + 2), cell j
// standing for reference position k = x + j - 1 with x = max(i - bw, 0),
// active for max(1, i - bw) <= k <= min(lr, i + bw).
//
// Two routines run a read: probaln_read, one thread a read (the short
// reads), and probaln_read_warp, one warp a read (the long reads), whose
// lanes split each row's cells and whose serial chains and sums one lane
// walks in probaln_read's order, so both give the same bits.
#pragma once

#include <math.h>
#include <stdint.h>

#if defined(__CUDACC__)
#define PB_HD __host__ __device__ __forceinline__
#else
#define PB_HD static inline
#endif

#define PB_EI 0.25
#define PB_EM 0.33333333333

// Where a read's rows live: element (row r, cell j) of an array at
// base[r * row + j * cell].  fM and fI hold forward rows 1..lq (row r at
// r - 1); ring holds 8 rows (fD of two rows, then bM, bI and bD of two);
// ss holds s[1..lq], element r - 1 at ss[(r - 1) * cell].
template <typename T>
struct PbScratch {
  T* fM;
  T* fI;
  T* ring;
  T* ss;
  int64_t row, cell;
};

// One read: reference codes ref[0..lr) and query codes query[0..lq)
// (0..3, 4 or more ambiguous), the query's error probabilities qp, its
// band width bw, and the group's d and e.
template <typename T>
struct PbRead {
  const uint8_t* ref;
  const uint8_t* query;
  const T* qp;
  int32_t lr, lq, bw;
  double d, e;
};

PB_HD double pb_log(double v) { return log(v); }
PB_HD float pb_log(float v) { return logf(v); }

template <typename T>
PB_HD T pb_max(T a, T b) { return a > b ? a : b; }

// The emission E[(amb) * 2 + (match)] with E = [q * EM, 1 - q, 1, 1].
template <typename T>
PB_HD T pb_emis(int qc, T qp, int rc) {
  if (rc > 3 || qc > 3) return T(1);
  return rc == qc ? T(1) - qp : qp * T(PB_EM);
}

PB_HD int32_t pb_x(int32_t i, int32_t bw) { return i - bw > 0 ? i - bw : 0; }

// Cells [*jb, *je] are active in row i.
PB_HD void pb_active(int32_t i, int32_t bw, int32_t lr, int32_t* jb,
                     int32_t* je) {
  const int32_t x = pb_x(i, bw);
  const int32_t beg = i - bw > 1 ? i - bw : 1;
  const int32_t end = i + bw < lr ? i + bw : lr;
  *jb = beg - x + 1;
  *je = end - x + 1;
}

// The reference code of cell j in a row at x (4 off the reference).
PB_HD int pb_rc(const uint8_t* ref, int32_t lr, int32_t x, int32_t j) {
  const int32_t k = x + j - 2;
  return k >= 0 && k < lr ? (int)ref[k] : 4;
}

// The transition terms (probaln.c:118-131, as JAX types them).
template <typename T>
struct PbTerms {
  T m0, m1, m2, m3, m4, m6, m8, sM, sI, bM, bI, ei_m1, ei_m4;
};

template <typename T>
PB_HD PbTerms<T> pb_terms(int32_t lr, int32_t lq, double d, double e) {
  PbTerms<T> t;
  const T lqf = (T)lq, lrf = (T)lr;
  t.sM = T(1) / (T(2) * lqf + T(2));
  t.sI = t.sM;
  t.m0 = (T)(1.0 - d - d) * (T(1) - t.sM);
  t.m1 = (T)d * (T(1) - t.sM);
  t.m2 = t.m1;
  t.m3 = (T)(1.0 - e) * (T(1) - t.sI);
  t.m4 = (T)e * (T(1) - t.sI);
  t.m6 = (T)(1.0 - e);
  t.m8 = (T)e;
  t.bM = (T)(1.0 - d) / lrf;
  t.bI = (T)d / lrf;
  t.ei_m1 = T(PB_EI) * t.m1;
  t.ei_m4 = T(PB_EI) * t.m4;
  return t;
}

// The MAP of row i from its forward (fM, fI) and backward (bM, bI) cells
// and s_i: the state ((k - 1) << 2 | I?) of the largest product and the
// quality of the mass off it.  Writes state[i - 1] and q[i - 1], and
// where `flag` is given flag[i - 1]: 2 where the row's sum is 0 and 1
// where the largest product over the sum is 1, the rows on which the
// scalar's mx / sum (a division by zero) or its log(1 - mx / sum) (a log
// of 0) fails (probaln.c:255-258), else 0.
template <typename T>
PB_HD void pb_map(const T* fM, const T* fI, const T* bM, const T* bI,
                  int64_t cell, int32_t J, int32_t x, T s_i, int32_t* state,
                  uint8_t* q, int32_t i, uint8_t* flag = nullptr) {
  const T minv = T(1) / s_i;
  T ssum = T(0), mx = T(0);
  int32_t arg = 0;
  for (int32_t j = 0; j < J; ++j) {
    const T zm = minv * fM[j * cell] * bM[j * cell];
    const T zi = minv * fI[j * cell] * bI[j * cell];
    ssum = ssum + zm;
    if (zm > mx) {  // the first largest, as jnp.argmax takes it
      mx = zm;
      arg = 2 * j;
    }
    ssum = ssum + zi;
    if (zi > mx) {
      mx = zi;
      arg = 2 * j + 1;
    }
  }
  T rest = T(0);
  for (int32_t j = 0; j < J; ++j) {
    const T zm = minv * fM[j * cell] * bM[j * cell];
    const T zi = minv * fI[j * cell] * bI[j * cell];
    rest = rest + (2 * j == arg ? T(0) : zm);
    rest = rest + (2 * j + 1 == arg ? T(0) : zi);
  }
  const T frac = rest / pb_max(ssum, (T)1e-300);
  const int32_t kk =
      (int32_t)(T(-4.343) * pb_log(pb_max(frac, (T)1e-30)) + T(0.499));
  state[i - 1] = ((x + arg / 2 - 1 - 1) << 2) | (arg & 1);
  q[i - 1] = (uint8_t)(kk > 100 ? 99 : kk);
  if (flag)
    flag[i - 1] = ssum == T(0) ? 2 : (mx / ssum == T(1) ? 1 : 0);
}

// The whole read.  Returns Pr; writes state[0..lq) and q[0..lq), and
// with `flag` pb_map's flag[0..lq).
template <typename T>
PB_HD int32_t probaln_read(const PbRead<T>& r, const PbScratch<T>& s,
                           int32_t* state, uint8_t* q,
                           uint8_t* flag = nullptr) {
  const int32_t lr = r.lr, lq = r.lq, bw = r.bw, J = 2 * bw + 2;
  const int64_t cell = s.cell;
  const PbTerms<T> t = pb_terms<T>(lr, lq, r.d, r.e);
  T* fD[2] = {s.ring, s.ring + s.row};
  int32_t jb, je;

  // forward row 1 (probaln.c:141-150)
  {
    const int32_t x = pb_x(1, bw);
    pb_active(1, bw, lr, &jb, &je);
    T sum = T(0);
    for (int32_t j = 0; j < J; ++j) {
      const bool act = j >= jb && j <= je;
      const T m =
          act ? pb_emis<T>(r.query[0], r.qp[0], pb_rc(r.ref, lr, x, j)) * t.bM
              : T(0);
      const T ins = act ? T(PB_EI) * t.bI : T(0);
      s.fM[j * cell] = m;
      s.fI[j * cell] = ins;
      fD[1][j * cell] = T(0);
      sum = sum + (m + ins);
    }
    s.ss[0] = sum;
  }
  // forward rows 2..lq (probaln.c:151-170)
  for (int32_t i = 2; i <= lq; ++i) {
    const int32_t x = pb_x(i, bw), sh = x - pb_x(i - 1, bw);
    pb_active(i, bw, lr, &jb, &je);
    const int qc = r.query[i - 1];
    const T qpi = r.qp[i - 1];
    const T minv = T(1) / s.ss[(i - 2) * cell];
    const T *pM = s.fM + (int64_t)(i - 2) * s.row,
            *pI = s.fI + (int64_t)(i - 2) * s.row, *pD = fD[(i - 1) & 1];
    T *cM = s.fM + (int64_t)(i - 1) * s.row,
      *cI = s.fI + (int64_t)(i - 1) * s.row, *cD = fD[i & 1];
    T sum = T(0), dprev = T(0), mprev = T(0);
    for (int32_t j = 0; j < J; ++j) {
      const bool act = j >= jb && j <= je;
      T m11, i11, d11, m10, i10;
      if (sh == 1) {
        m11 = pM[j * cell];
        i11 = pI[j * cell];
        d11 = pD[j * cell];
        m10 = j + 1 < J ? pM[(j + 1) * cell] : T(0);
        i10 = j + 1 < J ? pI[(j + 1) * cell] : T(0);
      } else {
        m11 = j ? pM[(j - 1) * cell] : T(0);
        i11 = j ? pI[(j - 1) * cell] : T(0);
        d11 = j ? pD[(j - 1) * cell] : T(0);
        m10 = pM[j * cell];
        i10 = pI[j * cell];
      }
      const T ev = pb_emis<T>(qc, qpi, pb_rc(r.ref, lr, x, j));
      T m = ev * (t.m0 * minv * m11 + t.m3 * minv * i11 + t.m6 * minv * d11);
      T ins = T(PB_EI) * (t.m1 * minv * m10 + t.m4 * minv * i10);
      if (!act) m = ins = T(0);
      const T dd = (t.m2 * mprev + t.m8 * dprev) * (act ? T(1) : T(0));
      cM[j * cell] = m;
      cI[j * cell] = ins;
      cD[j * cell] = dd;
      sum = sum + (m + ins + dd);
      dprev = dd;
      mprev = m;
    }
    s.ss[(i - 1) * cell] = sum;
  }

  // likelihood (probaln.c:171-186, as a sum of logs)
  const T s_lq = s.ss[(lq - 1) * cell];
  const T *lM = s.fM + (int64_t)(lq - 1) * s.row,
          *lI = s.fI + (int64_t)(lq - 1) * s.row;
  T s_end = T(0);
  for (int32_t j = 0; j < J; ++j)
    s_end = s_end + (lM[j * cell] * t.sM + lI[j * cell] * t.sI);
  s_end = s_end / s_lq;
  T logs = T(0);
  for (int32_t i = 1; i <= lq; ++i)
    logs = logs + pb_log(pb_max(s.ss[(i - 1) * cell], (T)1e-300));
  const T pr1 = T(-4.343) * (logs + pb_log(s_end) + pb_log((T)lr * (T)lq));
  const int32_t pr = (int32_t)(pr1 + T(0.499));

  // backward and MAP (probaln.c:192-261): row lq from the end state, then
  // rows lq-1 .. 1, each from the row below it
  T* bM[2] = {s.ring + 2 * s.row, s.ring + 3 * s.row};
  T* bI[2] = {s.ring + 4 * s.row, s.ring + 5 * s.row};
  T* bD[2] = {s.ring + 6 * s.row, s.ring + 7 * s.row};
  {
    const T a0 = t.sM / (s_lq * s_end), a1 = t.sI / (s_lq * s_end);
    pb_active(lq, bw, lr, &jb, &je);
    T *cM = bM[lq & 1], *cI = bI[lq & 1], *cD = bD[lq & 1];
    for (int32_t j = 0; j < J; ++j) {
      const bool act = j >= jb && j <= je;
      cM[j * cell] = act ? a0 : T(0);
      cI[j * cell] = act ? a1 : T(0);
      cD[j * cell] = T(0);
    }
    pb_map<T>(lM, lI, cM, cI, cell, J, pb_x(lq, bw), s_lq, state, q, lq,
              flag);
  }
  for (int32_t i = lq - 1; i >= 1; --i) {
    const int32_t x = pb_x(i, bw), sh = pb_x(i + 1, bw) - x;
    pb_active(i, bw, lr, &jb, &je);
    const int qc = r.query[i];
    const T qpi = r.qp[i];
    const T y = i > 1 ? T(1) : T(0);
    const T s_i = s.ss[(i - 1) * cell];
    const T yscale = T(1) / s_i;
    const T *nM = bM[(i + 1) & 1], *nI = bI[(i + 1) & 1];
    T *cM = bM[i & 1], *cI = bI[i & 1], *cD = bD[i & 1];
    T dnext = T(0);
    for (int32_t j = J - 1; j >= 0; --j) {
      const bool act = j >= jb && j <= je;
      const int32_t k = x + j - 1;
      const T ev = k >= 0 && k < lr ? pb_emis<T>(qc, qpi, (int)r.ref[k])
                                    : T(0);
      const T m11 = sh == 1 ? nM[j * cell]
                            : (j + 1 < J ? nM[(j + 1) * cell] : T(0));
      const T i10 = sh == 1 ? (j ? nI[(j - 1) * cell] : T(0)) : nI[j * cell];
      const T ee = ev * m11;
      const T dj = (ee * t.m6 + t.m8 * dnext) * y * (act ? T(1) : T(0));
      T m = ee * t.m0 + t.ei_m1 * i10 + t.m2 * dnext;
      T ins = ee * t.m3 + t.ei_m4 * i10;
      if (!act) m = ins = T(0);
      cM[j * cell] = m * yscale;
      cI[j * cell] = ins * yscale;
      cD[j * cell] = dj * yscale;
      dnext = dj;
    }
    pb_map<T>(s.fM + (int64_t)(i - 1) * s.row, s.fI + (int64_t)(i - 1) * s.row,
              cM, cI, cell, J, x, s_i, state, q, i, flag);
  }
  return pr;
}

// ---------------------------------------------------------------------------
// One warp a read (the long-read variant of kernel X6)
// ---------------------------------------------------------------------------
//
// probaln_read's arithmetic with a row's cells split over the warp's 32
// lanes, lane l taking cells l, l + 32, ... (J may pass 32).  What needs
// only the row before runs on every lane at once: the emissions and the
// M and I terms of the forward rows, the emissions and M and I terms of
// the backward rows.  What XLA runs serially stays serial, in the same
// order, walked by lane 0: the forward D chain with the row sum from cell
// 0, the likelihood's two sums, the backward D chain from cell J - 1.  A
// warp scan or tree reduction would round float64 in another order and is
// not used.  The MAP of a row needs only that row's forward and backward
// cells, so the backward rows are kept beside the forward ones and the
// MAP runs after the backward pass, a row a lane, each with probaln_read's
// serial ssum / argmax / rest (pb_map).
//
// Memory: the lanes pass a row to each other through an exchange of six
// rows of Jp = J rounded up to 8 cells (M, I and D, two of each) and four
// scalars, in shared memory on the card; the forward and backward M and I
// rows (lq x J each, cell stride 1, so a warp's row is one coalesced
// access), the row sums and their logs in the warp's scratch.
//
// PB_LANES(body) runs body as every lane and then orders the lanes'
// memory: on the card each lane runs it and the warp synchronises; on the
// host (the g++ harness) the 32 lanes run it in turn.  Values one lane
// gives another pass through memory, never through registers.

#define PB_WARP 32

#if defined(__CUDA_ARCH__)
#define PB_LANES(...)                            \
  do {                                           \
    const int lane = (int)(threadIdx.x & 31u);   \
    __VA_ARGS__;                                 \
    __syncwarp();                                \
  } while (0)
#else
#define PB_LANES(...)                                      \
  do {                                                     \
    for (int lane = 0; lane < PB_WARP; ++lane) {           \
      __VA_ARGS__;                                         \
    }                                                      \
  } while (0)
#endif

// Row stride of the exchange: J rounded up to 8 cells, so lane 0 reads a
// row 8 cells at a time without a bound check.
PB_HD int32_t pb_xstride(int32_t J) { return (J + 7) & ~7; }

// Elements of the exchange of a read of band J.
PB_HD int64_t pb_xsize(int32_t J) { return 6 * (int64_t)pb_xstride(J) + 4; }

// Elements of a read's scratch (lq rows of J cells): fM, fI, bM, bI, then
// ss and lg (lq each).
PB_HD int64_t pb_warp_scratch(int32_t lq, int32_t J) {
  return (4 * (int64_t)J + 2) * lq;
}

template <typename T>
struct PbWarpScratch {
  T* fM;  // forward rows 1..lq (row r at (r - 1) * J)
  T* fI;
  T* bM;  // backward rows 1..lq, scaled as the MAP reads them
  T* bI;
  T* ss;  // s[1..lq]
  T* lg;  // log(max(s, 1e-300)) of each row
  T* x;   // the exchange: pb_xsize(J) elements
};

// The whole read, as probaln_read.  Returns Pr (on the card, on lane 0);
// writes state[0..lq) and q[0..lq), and with `flag` pb_map's flag[0..lq).
template <typename T>
PB_HD int32_t probaln_read_warp(const PbRead<T>& r, const PbWarpScratch<T>& s,
                                int32_t* state, uint8_t* q,
                                uint8_t* flag = nullptr) {
  const int32_t lr = r.lr, lq = r.lq, bw = r.bw, J = 2 * bw + 2;
  const int32_t Jp = pb_xstride(J);
  const PbTerms<T> t = pb_terms<T>(lr, lq, r.d, r.e);
  T* const XM[2] = {s.x, s.x + Jp};
  T* const XI[2] = {s.x + 2 * Jp, s.x + 3 * Jp};
  T* const XD[2] = {s.x + 4 * Jp, s.x + 5 * Jp};
  T* const sc = s.x + 6 * Jp;  // [0] the last row's sum, [1] s_end
  int32_t pr = 0;
  int32_t jb, je;

  // forward row 1 (probaln.c:141-150)
  {
    const int32_t x = pb_x(1, bw);
    pb_active(1, bw, lr, &jb, &je);
    PB_LANES(for (int32_t j = lane; j < J; j += PB_WARP) {
      const bool act = j >= jb && j <= je;
      const T m =
          act ? pb_emis<T>(r.query[0], r.qp[0], pb_rc(r.ref, lr, x, j)) * t.bM
              : T(0);
      const T ins = act ? T(PB_EI) * t.bI : T(0);
      s.fM[j] = m;
      s.fI[j] = ins;
      XM[1][j] = m;
      XI[1][j] = ins;
      XD[1][j] = T(0);
    });
    PB_LANES(if (lane == 0) {
      T sum = T(0);
      for (int32_t j = 0; j < J; ++j) sum = sum + (XM[1][j] + XI[1][j]);
      s.ss[0] = sum;
      sc[0] = sum;
    });
  }
  // forward rows 2..lq (probaln.c:151-170): the M and I terms by the
  // lanes, then the D chain and the row sum by lane 0
  for (int32_t i = 2; i <= lq; ++i) {
    const int32_t x = pb_x(i, bw), sh = x - pb_x(i - 1, bw);
    pb_active(i, bw, lr, &jb, &je);
    const int qc = r.query[i - 1];
    const T qpi = r.qp[i - 1];
    const T *pM = XM[(i - 1) & 1], *pI = XI[(i - 1) & 1],
            *pD = XD[(i - 1) & 1];
    T *cM = XM[i & 1], *cI = XI[i & 1], *cD = XD[i & 1];
    T* const gM = s.fM + (int64_t)(i - 1) * J;
    T* const gI = s.fI + (int64_t)(i - 1) * J;
    PB_LANES(
        const T minv = T(1) / sc[0];
        for (int32_t j = lane; j < J; j += PB_WARP) {
          const bool act = j >= jb && j <= je;
          T m11, i11, d11, m10, i10;
          if (sh == 1) {
            m11 = pM[j];
            i11 = pI[j];
            d11 = pD[j];
            m10 = j + 1 < J ? pM[j + 1] : T(0);
            i10 = j + 1 < J ? pI[j + 1] : T(0);
          } else {
            m11 = j ? pM[j - 1] : T(0);
            i11 = j ? pI[j - 1] : T(0);
            d11 = j ? pD[j - 1] : T(0);
            m10 = pM[j];
            i10 = pI[j];
          }
          const T ev = pb_emis<T>(qc, qpi, pb_rc(r.ref, lr, x, j));
          T m = ev * (t.m0 * minv * m11 + t.m3 * minv * i11 +
                      t.m6 * minv * d11);
          T ins = T(PB_EI) * (t.m1 * minv * m10 + t.m4 * minv * i10);
          if (!act) m = ins = T(0);
          cM[j] = m;
          cI[j] = ins;
          gM[j] = m;
          gI[j] = ins;
        });
    PB_LANES(if (lane == 0) {
      T rsum = T(0), dprev = T(0), mprev = T(0);
      for (int32_t j0 = 0; j0 < J; j0 += 8) {
        T mv[8], iv[8];
        for (int u = 0; u < 8; ++u) {
          mv[u] = cM[j0 + u];
          iv[u] = cI[j0 + u];
        }
        for (int u = 0; u < 8 && j0 + u < J; ++u) {
          const int32_t j = j0 + u;
          const bool act = j >= jb && j <= je;
          const T dd = (t.m2 * mprev + t.m8 * dprev) * (act ? T(1) : T(0));
          cD[j] = dd;
          rsum = rsum + (mv[u] + iv[u] + dd);
          dprev = dd;
          mprev = mv[u];
        }
      }
      s.ss[i - 1] = rsum;
      sc[0] = rsum;
    });
  }

  // likelihood (probaln.c:171-186, as a sum of logs): the logs by the
  // lanes, both sums by lane 0
  const T s_lq = s.ss[lq - 1];
  PB_LANES(
      for (int32_t i = lane; i < lq; i += PB_WARP) s.lg[i] =
          pb_log(pb_max(s.ss[i], (T)1e-300));
      if (lane == 0) {
        const T *lM = XM[lq & 1], *lI = XI[lq & 1];
        T s_end = T(0);
        for (int32_t j = 0; j < J; ++j)
          s_end = s_end + (lM[j] * t.sM + lI[j] * t.sI);
        sc[1] = s_end / s_lq;
      });
  PB_LANES(if (lane == 0) {
    T logs = T(0);
    for (int32_t i = 0; i < lq; ++i) logs = logs + s.lg[i];
    const T pr1 =
        T(-4.343) * (logs + pb_log(sc[1]) + pb_log((T)lr * (T)lq));
    pr = (int32_t)(pr1 + T(0.499));
  });

  // backward (probaln.c:192-241): row lq from the end state, then rows
  // lq-1 .. 1, each from the row below it
  {
    const T s_end = sc[1];
    const T a0 = t.sM / (s_lq * s_end), a1 = t.sI / (s_lq * s_end);
    pb_active(lq, bw, lr, &jb, &je);
    T *cM = XM[lq & 1], *cI = XI[lq & 1];
    T* const gM = s.bM + (int64_t)(lq - 1) * J;
    T* const gI = s.bI + (int64_t)(lq - 1) * J;
    PB_LANES(for (int32_t j = lane; j < J; j += PB_WARP) {
      const bool act = j >= jb && j <= je;
      cM[j] = gM[j] = act ? a0 : T(0);
      cI[j] = gI[j] = act ? a1 : T(0);
    });
  }
  T* const XE = XD[0];  // ev * m11 of the row's cells
  T* const XB = XD[1];  // the row's D chain
  for (int32_t i = lq - 1; i >= 1; --i) {
    const int32_t x = pb_x(i, bw), sh = pb_x(i + 1, bw) - x;
    pb_active(i, bw, lr, &jb, &je);
    const int qc = r.query[i];
    const T qpi = r.qp[i];
    const T y = i > 1 ? T(1) : T(0);
    const T yscale = T(1) / s.ss[i - 1];
    const T *nM = XM[(i + 1) & 1], *nI = XI[(i + 1) & 1];
    T *cM = XM[i & 1], *cI = XI[i & 1];
    T* const gM = s.bM + (int64_t)(i - 1) * J;
    T* const gI = s.bI + (int64_t)(i - 1) * J;
    PB_LANES(for (int32_t j = lane; j < J; j += PB_WARP) {
      const int32_t k = x + j - 1;
      const T ev = k >= 0 && k < lr ? pb_emis<T>(qc, qpi, (int)r.ref[k])
                                    : T(0);
      const T m11 = sh == 1 ? nM[j] : (j + 1 < J ? nM[j + 1] : T(0));
      XE[j] = ev * m11;
    });
    PB_LANES(if (lane == 0) {
      T dnext = T(0);
      for (int32_t j1 = J; j1 > 0; j1 -= 8) {  // cells j1 - 8 .. j1 - 1
        T ev8[8];
        for (int u = 0; u < 8; ++u) ev8[u] = j1 - 1 - u >= 0 ? XE[j1 - 1 - u]
                                                              : T(0);
        for (int u = 0; u < 8 && j1 - 1 - u >= 0; ++u) {
          const int32_t j = j1 - 1 - u;
          const bool act = j >= jb && j <= je;
          const T dj =
              (ev8[u] * t.m6 + t.m8 * dnext) * y * (act ? T(1) : T(0));
          XB[j] = dj;
          dnext = dj;
        }
      }
    });
    PB_LANES(for (int32_t j = lane; j < J; j += PB_WARP) {
      const bool act = j >= jb && j <= je;
      const T i10 = sh == 1 ? (j ? nI[j - 1] : T(0)) : nI[j];
      const T ee = XE[j];
      const T dnext = j + 1 < J ? XB[j + 1] : T(0);
      T m = ee * t.m0 + t.ei_m1 * i10 + t.m2 * dnext;
      T ins = ee * t.m3 + t.ei_m4 * i10;
      if (!act) m = ins = T(0);
      cM[j] = gM[j] = m * yscale;
      cI[j] = gI[j] = ins * yscale;
    });
  }

  // MAP (probaln.c:242-261), a row a lane, each row's sums serial
  PB_LANES(for (int32_t i = 1 + lane; i <= lq; i += PB_WARP) {
    const int64_t o = (int64_t)(i - 1) * J;
    pb_map<T>(s.fM + o, s.fI + o, s.bM + o, s.bI + o, 1, J, pb_x(i, bw),
              s.ss[i - 1], state, q, i, flag);
  });
  return pr;
}
