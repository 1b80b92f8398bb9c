// Rows-body WLSQM fit, FP64, one thread per case (Hopper, sm_90a).
//
// Replaces the TPU kernel wlsqm_tpu/ops/pallas_fit.py:901 (_make_kernel,
// the rows body, launched by fit_pallas at l.1502).  That kernel computes
// in f32 pairs because the TPU has no f64; the H100 has native FP64, so
// this one computes in double and is held to the f64 engine.
//
// Per case: offsets d = (xk - xi) * inv_s (inv_s an exact power of two from
// the wrapper); weights (UNIFORM, or CENTER = a + b (1 - sqrt(d2 / max d2))^2);
// plain monomial basis rows c_kj from the power ladder d, d^2, d^2 d, d^2 d^2,
// recomputed from the offsets wherever a K-loop needs them (nothing sized
// by K is stored); known DOFs eliminated (fkeff = fk - sum_known g_j c_kj,
// identity rows and columns, zero RHS); A = C^T W C packed; Jacobi scale;
// Cholesky in place with the pivot guard max(acc, 1e-30); one solve and
// refine_steps residual sweeps through the rows.  Then, at run time:
// max_iter > 0 runs ALGO_ITERATIVE corrective refits with the reference's
// exact l-inf stagnation rule (a known DOF is never updated) and writes the
// per-case count; a non-null sens gets one solve and refine_steps sweeps per
// neighbour, from the initial factor.  Neighbours k >= nk are never read
// (padded slots may hold NaN); their sens rows are 0.  The wrapper applies
// the f64 de-scale, restores known fi and writes NaN into known sens columns.
//
// Bound on this card (data sheet: 3.35 TB/s; 67 TFLOP/s FP64 peak, on the
// tensor cores), counting each neighbour's basis row once:
//   sens path, 2D order 4, K = 30 (NO = 15): in 748 B + out 3,720 B per case
//     (sens alone 3,600 B: 7.5 GB at 2^21 cases), and ~1e5 flops per case
//     (each of the K sensitivity RHS takes two triangular solve pairs and a
//     K-long sweep) -- bound by FP64 operations, ~3 ms at 2^21 (bytes 2.8 ms);
//   dim3 path, 3D order 4, K = 48 (NO = 35): in 1,564 B + out 280 B per
//     case, ~1e5 flops (assembly 48 x 630 multiply-adds, Cholesky ~7 k,
//     one sweep) -- bound by FP64 operations, ~3 ms at 2^21.
// What this simple design does about that: nothing yet.  The packed factor
// (120 doubles at NO = 15, 630 at NO = 35) lives in local memory, which the
// hardware interleaves across a warp, so same-index accesses coalesce but
// spill through L1 to L2; each thread reads its own contiguous xk and writes
// its own contiguous K x NO sens block, so those accesses do not coalesce.
//
// Built with -DWLSQM_EMIT_COND=1 the kernel also writes the per-case
// conditioning key, replacing _cond_estimate (pallas_fit.py:382) and
// _cond_inv_f2 (l.412), the emit_cond output of that kernel (l.1067-1068):
// est = ||A_jac||_inf * ||A_jac^-1||_F >= cond_2(A_jac) of the scaled matrix
// with its identity rows for the known DOFs.  The row sums are taken before
// the Cholesky overwrites the matrix; the inverse's norm comes from the
// factor, per unit column e_i one forward and one backward substitution
// started at row i (~NO^3/3 multiply-adds, 8 more bytes written per case).
// The wrapper folds in the radius amplification max(inv_s, 1)^order.  A
// collapsed neighbourhood meets the pivot guard, so its key is huge or
// non-finite and compares False against any edge.  The key is a second
// library of the same source.  Both are compiled with -fmad=false and every
// fused multiply-add is written out as fma(): the compiler contracts nothing
// on its own, so the fit's arithmetic does not depend on what else the
// kernel computes, and every other output is the same bits with and without
// the key.
//
// Layout: 128 threads per block, grid ceil(B / 128), ragged tail masked.
// One template instance per (DIM, ORDER, WEIGHTING), 30 in all, so NO is a
// compile-time constant and the basis exponent lookups fold away.  The
// O(NO^2) and O(NO^3) loops are unrolled only up to NO = 15 (register-sized
// state, short ptxas times); above that they stay loops over the
// local-memory factor.  Plain C entry point, loaded with ctypes; launches on
// the caller's stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "fit_rows_tables.cuh"  // generated from tables.EXPONENTS

#ifndef WLSQM_EMIT_COND
#define WLSQM_EMIT_COND 0
#endif

namespace {

constexpr bool kEmitCond = WLSQM_EMIT_COND != 0;  // this library writes the key
constexpr int kThreads = 128;
constexpr int kWeightCenter = 2;  // defs.WEIGHT_CENTER
constexpr double kAlpha = 1e-4;   // reference: wlsqm/fitter/infra.pyx:45-46
constexpr double kBeta = 1.0 - 1e-4;
constexpr int kUnrollNO = 15;     // unroll the O(NO^2), O(NO^3) loops up to here

// packed lower triangle, j <= i
__host__ __device__ constexpr int lt(int i, int j) { return i * (i + 1) / 2 + j; }

// x <- (L L^T)^-1 x for a packed lower factor
template <int NO, int U>
__device__ __forceinline__ void chol_solve(const double* L, double (&x)[NO]) {
#pragma unroll (U)
  for (int i = 0; i < NO; ++i) {
    double t = x[i];
#pragma unroll (U)
    for (int q = 0; q < i; ++q) t = fma(-L[lt(i, q)], x[q], t);
    x[i] = t / L[lt(i, i)];
  }
#pragma unroll (U)
  for (int i = NO - 1; i >= 0; --i) {
    double t = x[i];
#pragma unroll (U)
    for (int q = i + 1; q < NO; ++q) t = fma(-L[lt(q, i)], x[q], t);
    x[i] = t / L[lt(i, i)];
  }
}

// ||(L L^T)^-1||_F^2 = sum_i ||(L L^T)^-1 e_i||^2 for a packed lower factor.
// Column i is solved from row i down (the rows above are 0 after the forward
// pass) and back up to row i; its entries above row i equal entries of later
// columns by symmetry, so every entry below the diagonal counts twice.
template <int NO, int U>
__device__ __forceinline__ double inv_frob2(const double* L) {
  double rd[NO];
#pragma unroll (U)
  for (int j = 0; j < NO; ++j) rd[j] = 1.0 / L[lt(j, j)];
  double f2 = 0.0;
#pragma unroll (U)
  for (int i = 0; i < NO; ++i) {
    double x[NO];
#pragma unroll (U)
    for (int r = i; r < NO; ++r) {
      double t = r == i ? 1.0 : 0.0;
#pragma unroll (U)
      for (int q = i; q < r; ++q) t = fma(-L[lt(r, q)], x[q], t);
      x[r] = t * rd[r];
    }
#pragma unroll (U)
    for (int r = NO - 1; r >= i; --r) {
      double t = x[r];
#pragma unroll (U)
      for (int q = r + 1; q < NO; ++q) t = fma(-L[lt(q, r)], x[q], t);
      x[r] = t * rd[r];
      f2 = fma(r == i ? x[r] : 2.0 * x[r], x[r], f2);
    }
  }
  return f2;
}

// One case's view of its neighbourhood: offsets, weights and basis rows.
template <int DIM, int ORDER, int WEIGHTING>
struct Hood {
  using T = RowsTables<DIM, ORDER>;
  static constexpr int NO = T::NO;

  const double* xc;  // (K, DIM) neighbours of this case
  double x0[DIM];
  double is;         // inv_s
  double max_d2;     // CENTER normaliser (scaled), 1 when every d = 0

  __device__ __forceinline__ void offsets(int k, double (&d)[DIM]) const {
#pragma unroll
    for (int a = 0; a < DIM; ++a) d[a] = (xc[k * DIM + a] - x0[a]) * is;
  }

  static __device__ __forceinline__ double sq(const double (&d)[DIM]) {
    double s = d[0] * d[0];
#pragma unroll
    for (int a = 1; a < DIM; ++a) s = fma(d[a], d[a], s);
    return s;
  }

  // basis row c of neighbour k; returns its weight
  __device__ __forceinline__ double row(int k, double (&c)[NO]) const {
    double d[DIM];
    offsets(k, d);
    double p[DIM][5];
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
      p[a][0] = 1.0;
      p[a][1] = d[a];
      p[a][2] = d[a] * d[a];
      p[a][3] = p[a][2] * d[a];
      p[a][4] = p[a][2] * p[a][2];
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      double v = 1.0;
      bool first = true;
#pragma unroll
      for (int a = 0; a < DIM; ++a) {
        const int e = T::ex(j, a);
        if (e != 0) {
          v = first ? p[a][e] : v * p[a][e];
          first = false;
        }
      }
      c[j] = v;
    }
    if (WEIGHTING != kWeightCenter) return 1.0;
    const double t = 1.0 - sqrt(sq(d) / max_d2);
    return fma(kBeta * t, t, kAlpha);
  }

  // ax = (C^T W C) sx over the valid neighbours (a sweep "through the rows")
  __device__ __forceinline__ void matvec(int n, const double (&sx)[NO],
                                         double (&ax)[NO]) const {
#pragma unroll
    for (int j = 0; j < NO; ++j) ax[j] = 0.0;
#pragma unroll 1
    for (int k = 0; k < n; ++k) {
      double c[NO];
      const double w = row(k, c);
      double t = 0.0;
#pragma unroll
      for (int j = 0; j < NO; ++j) t = fma(c[j], sx[j], t);
      t *= w;
#pragma unroll
      for (int j = 0; j < NO; ++j) ax[j] = fma(c[j], t, ax[j]);
    }
  }
};

template <int DIM, int ORDER, int WEIGHTING>
__global__ void __launch_bounds__(kThreads)
fit_rows(const double* __restrict__ xk, const double* __restrict__ fk,
         const int* __restrict__ nk, const double* __restrict__ xi,
         const double* __restrict__ inv_s, const double* __restrict__ ghat,
         double* __restrict__ fi, int* __restrict__ iters,
         double* __restrict__ sens, double* __restrict__ est, int64_t B, int K,
         int64_t knowns, int refine_steps, int max_iter) {
  using H = Hood<DIM, ORDER, WEIGHTING>;
  constexpr int NO = H::NO;
  constexpr int NT = NO * (NO + 1) / 2;
  constexpr int U = NO <= kUnrollNO ? NT : 1;  // NT >= every trip count below
  const int64_t cs = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (cs >= B) return;

  const int n = min(max(nk[cs], 0), K);
  const double* fc = fk + cs * (int64_t)K;
  H h;
  h.xc = xk + cs * (int64_t)K * DIM;
#pragma unroll
  for (int a = 0; a < DIM; ++a) h.x0[a] = xi[cs * DIM + a];
  h.is = inv_s[cs];
  h.max_d2 = 1.0;
  if (WEIGHTING == kWeightCenter) {
    double m = 0.0;
#pragma unroll 1
    for (int k = 0; k < n; ++k) {
      double d[DIM];
      h.offsets(k, d);
      m = fmax(m, H::sq(d));
    }
    h.max_d2 = m > 0.0 ? m : 1.0;
  }

  // known DOFs (bits below NO) and their scaled values
  const int64_t km = ghat != nullptr ? knowns : 0;
  auto known = [km](int j) { return ((km >> j) & 1LL) != 0; };
  double g[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) g[j] = known(j) ? ghat[cs * NO + j] : 0.0;

  // ---- assemble A (packed lower) and b over the valid neighbours ----
  double A[NT], b[NO];
#pragma unroll (U)
  for (int t = 0; t < NT; ++t) A[t] = 0.0;
#pragma unroll
  for (int j = 0; j < NO; ++j) b[j] = 0.0;
#pragma unroll 1
  for (int k = 0; k < n; ++k) {
    double c[NO];
    const double w = h.row(k, c);
    double f = fc[k];
    if (km != 0) {
#pragma unroll
      for (int j = 0; j < NO; ++j)
        if (known(j)) f = fma(-g[j], c[j], f);
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const double wc = c[j] * w;
      b[j] = fma(wc, f, b[j]);
#pragma unroll (U)
      for (int m = 0; m <= j; ++m) A[lt(j, m)] = fma(wc, c[m], A[lt(j, m)]);
    }
  }

  // known DOFs: identity rows and columns, zero RHS
  if (km != 0) {
#pragma unroll (U)
    for (int i = 0; i < NO; ++i) {
#pragma unroll (U)
      for (int m = 0; m <= i; ++m)
        if (known(i) || known(m)) A[lt(i, m)] = i == m ? 1.0 : 0.0;
      if (known(i)) b[i] = 0.0;
    }
  }

  // ---- Jacobi scale, Cholesky in place; the guard lets NaN through ----
  double s[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const double djj = A[lt(j, j)];
    s[j] = djj > 0.0 ? 1.0 / sqrt(djj) : 1.0;
  }
#pragma unroll (U)
  for (int i = 0; i < NO; ++i) {
#pragma unroll (U)
    for (int m = 0; m <= i; ++m) A[lt(i, m)] *= s[i] * s[m];
  }
  // the key's first factor: max abs row sum of the full symmetric scaled
  // matrix (NaN kept), taken before the factor overwrites it
  double ninf = 0.0;
  if constexpr (kEmitCond) {
    double rs[NO];
#pragma unroll
    for (int j = 0; j < NO; ++j) rs[j] = 0.0;
#pragma unroll (U)
    for (int i = 0; i < NO; ++i) {
#pragma unroll (U)
      for (int m = 0; m <= i; ++m) {
        const double v = fabs(A[lt(i, m)]);
        rs[i] += v;
        if (m != i) rs[m] += v;
      }
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) ninf = (rs[j] > ninf || rs[j] != rs[j]) ? rs[j] : ninf;
  }
#pragma unroll (U)
  for (int j = 0; j < NO; ++j) {
    double acc = A[lt(j, j)];
#pragma unroll (U)
    for (int q = 0; q < j; ++q) acc = fma(-A[lt(j, q)], A[lt(j, q)], acc);
    const double dj = sqrt(acc < 1e-30 ? 1e-30 : acc);
    A[lt(j, j)] = dj;
    const double invd = 1.0 / dj;
#pragma unroll (U)
    for (int i = j + 1; i < NO; ++i) {
      double t = A[lt(i, j)];
#pragma unroll (U)
      for (int q = 0; q < j; ++q) t = fma(-A[lt(i, q)], A[lt(j, q)], t);
      A[lt(i, j)] = t * invd;
    }
  }

  if constexpr (kEmitCond) est[cs] = ninf * sqrt(inv_frob2<NO, U>(A));

  // ---- solve in the scaled space, then sweep: y += solve(s b - s A (s y)) ----
  double y[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) y[j] = b[j] * s[j];
  chol_solve<NO, U>(A, y);
#pragma unroll 1
  for (int it = 0; it < refine_steps; ++it) {
    double sx[NO], r[NO];
#pragma unroll
    for (int j = 0; j < NO; ++j) sx[j] = y[j] * s[j];
    h.matvec(n, sx, r);
#pragma unroll
    for (int j = 0; j < NO; ++j) r[j] = known(j) ? 0.0 : fma(-s[j], r[j], b[j] * s[j]);
    chol_solve<NO, U>(A, r);
#pragma unroll
    for (int j = 0; j < NO; ++j) y[j] += r[j];
  }
  double xh[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) xh[j] = known(j) ? g[j] : y[j] * s[j];

  // ---- ALGO_ITERATIVE: corrective refits until the l-inf residual norm
  //      repeats exactly (reference: wlsqm/fitter/impl.pyx:986-1083) ----
  if (max_iter > 0) {
    bool done = false;
    double prev = -1.0;
    int itn = 0;
#pragma unroll 1
    for (int it = 0; it < max_iter && !done; ++it) {
      double bp[NO];
#pragma unroll
      for (int j = 0; j < NO; ++j) bp[j] = 0.0;
      double nrm = 0.0;
#pragma unroll 1
      for (int k = 0; k < n; ++k) {
        double c[NO];
        const double w = h.row(k, c);
        double m = 0.0;
#pragma unroll
        for (int j = 0; j < NO; ++j) m = fma(c[j], xh[j], m);
        const double r = fc[k] - m;
        nrm = fmax(nrm, fabs(r));
#pragma unroll
        for (int j = 0; j < NO; ++j) bp[j] = fma(c[j] * w, r, bp[j]);
      }
      done = nrm == prev;
      if (!done) {
#pragma unroll
        for (int j = 0; j < NO; ++j) bp[j] = known(j) ? 0.0 : bp[j] * s[j];
        chol_solve<NO, U>(A, bp);
#pragma unroll
        for (int j = 0; j < NO; ++j)
          if (!known(j)) xh[j] = fma(bp[j], s[j], xh[j]);
        ++itn;
      }
      prev = nrm;
    }
    iters[cs] = itn;
  }

  double* out = fi + cs * NO;
#pragma unroll
  for (int j = 0; j < NO; ++j) out[j] = xh[j];

  // ---- sensitivities: one column of A^-1 C^T W per neighbour, each with
  //      the DOFs' solve and sweeps (reference: wlsqm/fitter/impl.pyx:768-846) ----
  if (sens == nullptr) return;
  double* so = sens + cs * (int64_t)K * NO;
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    double* o = so + (int64_t)k * NO;
    if (k >= n) {
#pragma unroll
      for (int j = 0; j < NO; ++j) o[j] = 0.0;
      continue;
    }
    double c[NO], bk[NO], yk[NO];
    const double w = h.row(k, c);
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      bk[j] = known(j) ? 0.0 : (c[j] * w) * s[j];
      yk[j] = bk[j];
    }
    chol_solve<NO, U>(A, yk);
#pragma unroll 1
    for (int it = 0; it < refine_steps; ++it) {
      double sy[NO], r[NO];
#pragma unroll
      for (int j = 0; j < NO; ++j) sy[j] = yk[j] * s[j];
      h.matvec(n, sy, r);
#pragma unroll
      for (int j = 0; j < NO; ++j) r[j] = known(j) ? 0.0 : fma(-s[j], r[j], bk[j]);
      chol_solve<NO, U>(A, r);
#pragma unroll
      for (int j = 0; j < NO; ++j) yk[j] += r[j];
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) o[j] = yk[j] * s[j];
  }
}

struct Args {
  const double *xk, *fk;
  const int* nk;
  const double *xi, *inv_s, *ghat;
  double* fi;
  int* iters;
  double* sens;
  double* est;
  int64_t B;
  int K;
  int64_t knowns;
  int refine_steps, max_iter;
};

template <int DIM, int ORDER, int WEIGHTING>
void launch(const Args& a, cudaStream_t stream) {
  const unsigned grid = (unsigned)((a.B + kThreads - 1) / kThreads);
  fit_rows<DIM, ORDER, WEIGHTING><<<grid, kThreads, 0, stream>>>(
      a.xk, a.fk, a.nk, a.xi, a.inv_s, a.ghat, a.fi, a.iters, a.sens, a.est, a.B,
      a.K, a.knowns, a.refine_steps, a.max_iter);
}

// the (ORDER, WEIGHTING) instance of one dimension; false: no such order
template <int DIM>
bool launch_dim(const Args& a, int order, bool center, cudaStream_t st) {
#define WLSQM_CASE(ORD)                       \
  case ORD:                                   \
    if (center)                               \
      launch<DIM, ORD, kWeightCenter>(a, st); \
    else                                      \
      launch<DIM, ORD, 1>(a, st);             \
    return true;
  switch (order) {
    WLSQM_CASE(0)
    WLSQM_CASE(1)
    WLSQM_CASE(2)
    WLSQM_CASE(3)
    WLSQM_CASE(4)
    default:
      return false;
  }
#undef WLSQM_CASE
}

}  // namespace

// xk (B, K, DIM) f64 | fk (B, K) f64 | nk (B,) i32 | xi (B, DIM) f64 |
// inv_s (B,) f64 | ghat (B, NO) f64 or null (null: no known DOF) ->
// fi (B, NO) f64 in the scaled plain-monomial space | iters (B,) i32, written
// when max_iter > 0 | sens (B, K, NO) f64 or null | est (B,) f64, the key
// before the radius amplification: given exactly when the library was built
// with WLSQM_EMIT_COND=1, else null.
extern "C" int wlsqm_fit_rows(const void* xk, const void* fk, const void* nk,
                              const void* xi, const void* inv_s, const void* ghat,
                              void* fi, void* iters, void* sens, void* est,
                              int64_t B, int K, int dim, int order, int weighting,
                              int64_t knowns, int refine_steps, int max_iter,
                              void* stream) {
  if (max_iter > 0 && iters == nullptr) return (int)cudaErrorInvalidValue;
  if ((est != nullptr) != kEmitCond) return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaSuccess;
  const Args a{(const double*)xk, (const double*)fk, (const int*)nk,
               (const double*)xi, (const double*)inv_s, (const double*)ghat,
               (double*)fi, (int*)iters, (double*)sens, (double*)est, B, K,
               knowns, refine_steps, max_iter};
  cudaStream_t st = (cudaStream_t)stream;
  const bool center = weighting == kWeightCenter;
  const bool ok = dim == 1   ? launch_dim<1>(a, order, center, st)
                  : dim == 2 ? launch_dim<2>(a, order, center, st)
                  : dim == 3 ? launch_dim<3>(a, order, center, st)
                             : false;
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
