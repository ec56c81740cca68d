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
// quality of the mass off it.  Writes state[i - 1] and q[i - 1].
template <typename T>
PB_HD void pb_map(const T* fM, const T* fI, const T* bM, const T* bI,
                  int64_t cell, int32_t J, int32_t x, T s_i, int32_t* state,
                  uint8_t* q, int32_t i) {
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
}

// The whole read.  Returns Pr; writes state[0..lq) and q[0..lq).
template <typename T>
PB_HD int32_t probaln_read(const PbRead<T>& r, const PbScratch<T>& s,
                           int32_t* state, uint8_t* q) {
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
    pb_map<T>(lM, lI, cM, cI, cell, J, pb_x(lq, bw), s_lq, state, q, lq);
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
              cM, cI, cell, J, x, s_i, state, q, i);
  }
  return pr;
}
