// Moment-assembly WLSQM fit, FP64, one thread per case (Hopper, sm_90a).
//
// Replaces the TPU kernel wlsqm_tpu/ops/pallas_fit.py:438
// (_make_kernel_moment, launched by fit_pallas at l.1502).  That kernel
// computes in f32 pairs because the TPU has no f64; the H100 has native
// FP64, so this one computes in double and is held to the f64 engine.
//
// Per case: offsets d = (xk - xi) * inv_s (inv_s an exact power of two from
// the wrapper); weights (UNIFORM, or CENTER = a + b (1 - sqrt(d2 / max d2))^2);
// the weighted moment lattice M[e] up to degree 2*ORDER, one multiply per
// moment along the chains of MomentTables<ORDER>; the RHS chain rooted at
// w*f; A[j,m] = M[slot(j,m)]; Jacobi scale from the moment diagonal;
// Cholesky of the scaled matrix; one solve; refine_steps residual sweeps
// through the moments.  Neighbours k >= nk are never read (padded slots may
// hold NaN).  The guards are the TPU kernel's: max d2 = 0 -> 1 (l.539),
// a non-positive diagonal -> scale 1 (l.650), a pivot below 1e-30 -> 1e-30
// (l.738).  The wrapper applies the f64 de-scale fact * 2^(-e_s*deg).
//
// Bound on this card, at 2D order 4, K = 30 (NO = 15 DOFs, NM = 45 moments):
//   in/out  ~860 bytes per case (xk 480, fk 240, xi 16, nk 4, inv_s 8, fi 120);
//   work    ~8-9 k f64 flops per case (assembly ~30 x 140, Cholesky
//           ~NO^3/3 multiply-adds, two triangular solves per solve, one sweep).
// At the data-sheet 3.35 TB/s and ~34 TFLOP/s FP64 (no tensor cores) both
// bounds land near 4 G fits/s.  What this simple design does about that:
// nothing yet.  A thread holds ~330 live doubles (M 45, b 15, L 120, s, y
// and the per-neighbour chain), far above 255 registers, so it spills to
// local memory; and each thread reads its own 480 contiguous bytes of xk,
// so neighbouring threads do not read neighbouring addresses.
//
// Built with -DWLSQM_EMIT_COND=1 the kernel also writes the per-case
// conditioning key, replacing _cond_estimate (pallas_fit.py:382) and
// _cond_inv_f2 (l.412), the emit_cond output of that kernel (l.717-719,
// 747-748): est = ||A_jac||_inf * ||A_jac^-1||_F >= cond_2(A_jac), from the
// moments, the scale and the factor the fit already holds: NO^2 row-sum
// terms, then per unit column e_i one forward and one backward substitution
// started at row i (rows above i follow by symmetry and are counted twice),
// ~NO^3/3 multiply-adds, 8 more bytes written per case.  The wrapper folds
// in the radius amplification max(inv_s, 1)^order.  A collapsed
// neighbourhood meets the pivot guard, so its key is huge or non-finite and
// compares False against any edge.  The key is a second library of the same
// source.  Both are compiled with -fmad=false and every fused multiply-add
// is written out as fma(): the compiler contracts nothing on its own, so the
// fit's arithmetic does not depend on what else the kernel computes, and fi
// is the same bits with and without the key.
//
// Layout: 128 threads per block, grid ceil(B / 128), ragged tail masked.
// One template instance per (ORDER, WEIGHTING), so every table lookup is a
// compile-time constant after unrolling.  Plain C entry point, loaded with
// ctypes; launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "fit_moment_tables.cuh"  // generated from the Python chain tables

#ifndef WLSQM_EMIT_COND
#define WLSQM_EMIT_COND 0
#endif

namespace {

constexpr bool kEmitCond = WLSQM_EMIT_COND != 0;  // this library writes the key
constexpr int kThreads = 128;
constexpr int kWeightCenter = 2;  // defs.WEIGHT_CENTER
constexpr double kAlpha = 1e-4;   // reference: wlsqm/fitter/infra.pyx:45-46
constexpr double kBeta = 1.0 - 1e-4;

// packed lower triangle, j <= i
__host__ __device__ constexpr int lt(int i, int j) { return i * (i + 1) / 2 + j; }

// x <- (L L^T)^-1 x for a packed lower factor
template <int NO>
__device__ __forceinline__ void chol_solve(const double (&L)[NO * (NO + 1) / 2],
                                           double (&x)[NO]) {
#pragma unroll
  for (int i = 0; i < NO; ++i) {
    double t = x[i];
#pragma unroll
    for (int q = 0; q < i; ++q) t = fma(-L[lt(i, q)], x[q], t);
    x[i] = t / L[lt(i, i)];
  }
#pragma unroll
  for (int i = NO - 1; i >= 0; --i) {
    double t = x[i];
#pragma unroll
    for (int q = i + 1; q < NO; ++q) t = fma(-L[lt(q, i)], x[q], t);
    x[i] = t / L[lt(i, i)];
  }
}

// ||(L L^T)^-1||_F^2 = sum_i ||(L L^T)^-1 e_i||^2 for a packed lower factor.
// Column i is solved from row i down (the rows above are 0 after the forward
// pass) and back up to row i; its entries above row i equal entries of later
// columns by symmetry, so every entry below the diagonal counts twice.
template <int NO>
__device__ __forceinline__ double inv_frob2(const double (&L)[NO * (NO + 1) / 2]) {
  double rd[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) rd[j] = 1.0 / L[lt(j, j)];
  double f2 = 0.0;
#pragma unroll
  for (int i = 0; i < NO; ++i) {
    double x[NO];
#pragma unroll
    for (int r = i; r < NO; ++r) {
      double t = r == i ? 1.0 : 0.0;
#pragma unroll
      for (int q = i; q < r; ++q) t = fma(-L[lt(r, q)], x[q], t);
      x[r] = t * rd[r];
    }
#pragma unroll
    for (int r = NO - 1; r >= i; --r) {
      double t = x[r];
#pragma unroll
      for (int q = r + 1; q < NO; ++q) t = fma(-L[lt(q, r)], x[q], t);
      x[r] = t * rd[r];
      f2 = fma(r == i ? x[r] : 2.0 * x[r], x[r], f2);
    }
  }
  return f2;
}

template <int ORDER, int WEIGHTING>
__global__ void __launch_bounds__(kThreads)
fit_moment_2d(const double* __restrict__ xk, const double* __restrict__ fk,
              const int* __restrict__ nk, const double* __restrict__ xi,
              const double* __restrict__ inv_s, double* __restrict__ fi,
              double* __restrict__ est, int64_t B, int K, int refine_steps) {
  using T = MomentTables<ORDER>;
  constexpr int NO = T::NO;
  constexpr int NM = T::NM;
  const int64_t c = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (c >= B) return;

  const int n = min(max(nk[c], 0), K);
  const double is = inv_s[c];
  const double x0 = xi[2 * c], y0 = xi[2 * c + 1];
  const double* xc = xk + c * (int64_t)K * 2;
  const double* fc = fk + c * (int64_t)K;

  double max_d2 = 1.0;
  if (WEIGHTING == kWeightCenter) {
    double m = 0.0;
    for (int k = 0; k < n; ++k) {
      const double dx = (xc[2 * k] - x0) * is, dy = (xc[2 * k + 1] - y0) * is;
      m = fmax(m, fma(dx, dx, dy * dy));
    }
    max_d2 = m > 0.0 ? m : 1.0;
  }

  double M[NM], b[NO];
#pragma unroll
  for (int i = 0; i < NM; ++i) M[i] = 0.0;
#pragma unroll
  for (int j = 0; j < NO; ++j) b[j] = 0.0;

  for (int k = 0; k < n; ++k) {
    const double d[2] = {(xc[2 * k] - x0) * is, (xc[2 * k + 1] - y0) * is};
    double w = 1.0;
    if (WEIGHTING == kWeightCenter) {
      const double t = 1.0 - sqrt(fma(d[0], d[0], d[1] * d[1]) / max_d2);
      w = fma(kBeta * t, t, kAlpha);
    }
    double v[NM];
    v[0] = w;
    M[0] += w;
#pragma unroll
    for (int i = 1; i < NM; ++i) {
      v[i] = v[T::mpar(i)] * d[T::maxis(i)];
      M[i] = fma(v[T::mpar(i)], d[T::maxis(i)], M[i]);
    }
    double r[NO];
    r[0] = w * fc[k];
    b[0] += r[0];
#pragma unroll
    for (int j = 1; j < NO; ++j) {
      r[j] = r[T::bpar(j)] * d[T::baxis(j)];
      b[j] = fma(r[T::bpar(j)], d[T::baxis(j)], b[j]);
    }
  }

  // Jacobi scale from the moment diagonal
  double s[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const double djj = M[T::slot(j, j)];
    s[j] = djj > 0.0 ? 1.0 / sqrt(djj) : 1.0;
  }

  // Cholesky of the scaled matrix, packed lower; the guard lets NaN through
  double L[NO * (NO + 1) / 2];
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    double acc = M[T::slot(j, j)] * (s[j] * s[j]);
#pragma unroll
    for (int q = 0; q < j; ++q) acc = fma(-L[lt(j, q)], L[lt(j, q)], acc);
    const double dj = sqrt(acc < 1e-30 ? 1e-30 : acc);
    L[lt(j, j)] = dj;
    const double invd = 1.0 / dj;
#pragma unroll
    for (int i = j + 1; i < NO; ++i) {
      double t = M[T::slot(j, i)] * (s[j] * s[i]);
#pragma unroll
      for (int q = 0; q < j; ++q) t = fma(-L[lt(i, q)], L[lt(j, q)], t);
      L[lt(i, j)] = t * invd;
    }
  }

  // the conditioning key: max abs row sum of the scaled matrix (NaN kept),
  // times the Frobenius norm of its inverse
  if constexpr (kEmitCond) {
    double ninf = 0.0;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      double r = 0.0;
#pragma unroll
      for (int m = 0; m < NO; ++m) r += fabs(M[T::slot(j, m)] * (s[j] * s[m]));
      ninf = (r > ninf || r != r) ? r : ninf;
    }
    est[c] = ninf * sqrt(inv_frob2<NO>(L));
  }

  // solve in the scaled space, then sweep: y += solve(s (b - A (s y)))
  double y[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) y[j] = b[j] * s[j];
  chol_solve<NO>(L, y);
  for (int it = 0; it < refine_steps; ++it) {
    double sx[NO], r[NO];
#pragma unroll
    for (int j = 0; j < NO; ++j) sx[j] = y[j] * s[j];
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      double acc = 0.0;
#pragma unroll
      for (int m = 0; m < NO; ++m) acc = fma(M[T::slot(j, m)], sx[m], acc);
      r[j] = (b[j] - acc) * s[j];
    }
    chol_solve<NO>(L, r);
#pragma unroll
    for (int j = 0; j < NO; ++j) y[j] += r[j];
  }

  double* out = fi + c * NO;
#pragma unroll
  for (int j = 0; j < NO; ++j) out[j] = y[j] * s[j];
}

template <int ORDER, int WEIGHTING>
void launch(const double* xk, const double* fk, const int* nk, const double* xi,
            const double* inv_s, double* fi, double* est, int64_t B, int K,
            int refine_steps, cudaStream_t stream) {
  const unsigned grid = (unsigned)((B + kThreads - 1) / kThreads);
  fit_moment_2d<ORDER, WEIGHTING><<<grid, kThreads, 0, stream>>>(
      xk, fk, nk, xi, inv_s, fi, est, B, K, refine_steps);
}

}  // namespace

// xk (B, K, 2) f64 | fk (B, K) f64 | nk (B,) i32 | xi (B, 2) f64 |
// inv_s (B,) f64 -> fi (B, NO) f64, in the scaled plain-monomial space |
// est (B,) f64, the key before the radius amplification: given exactly when
// the library was built with WLSQM_EMIT_COND=1, else null.
extern "C" int wlsqm_fit_moment_2d(const void* xk, const void* fk, const void* nk,
                                   const void* xi, const void* inv_s, void* fi,
                                   void* est, int64_t B, int K, int order,
                                   int weighting, int refine_steps, void* stream) {
  if ((est != nullptr) != kEmitCond) return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaSuccess;
  const double* x = (const double*)xk;
  const double* f = (const double*)fk;
  const int* n = (const int*)nk;
  const double* o = (const double*)xi;
  const double* s = (const double*)inv_s;
  double* out = (double*)fi;
  double* e = (double*)est;
  cudaStream_t st = (cudaStream_t)stream;
  const bool center = weighting == kWeightCenter;
#define WLSQM_CASE(ORD)                                                    \
  case ORD:                                                                \
    if (center)                                                            \
      launch<ORD, 2>(x, f, n, o, s, out, e, B, K, refine_steps, st);       \
    else                                                                   \
      launch<ORD, 1>(x, f, n, o, s, out, e, B, K, refine_steps, st);       \
    break;
  switch (order) {
    WLSQM_CASE(0)
    WLSQM_CASE(1)
    WLSQM_CASE(2)
    WLSQM_CASE(3)
    WLSQM_CASE(4)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef WLSQM_CASE
  return (int)cudaGetLastError();
}
