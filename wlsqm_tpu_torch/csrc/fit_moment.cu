// Moment-assembly WLSQM fit, FP64, one thread per case (Hopper, sm_90a).
//
// Replaces the TPU kernel wlsqm_tpu/ops/pallas_fit.py:438
// (_make_kernel_moment, launched by fit_pallas at l.1502).  That kernel
// computes in f32 pairs because the TPU has no f64; the H100 has native
// FP64, so this one computes in double and is held to the f64 engine.
//
// Per case: the radius scale (h^2 = max over k < nk of dx*dx + dy*dy of the
// unscaled offsets, e = ceil(0.5 * log2(h^2 > 0 ? h^2 : 1)), inv_s = 2^-e:
// the arithmetic of ops/fit_kernel._prescale, bit for bit, which fit_rows
// and condprobe keep using); offsets d = (xk - xi) * inv_s; weights
// (UNIFORM, or CENTER = a + b (1 - sqrt(d2 / max d2))^2); the weighted
// moments M[e] up to degree 2*ORDER, each neighbour's one multiply-add of
// dx^a and w dy^b, and the RHS from w f dy^b; A[j,m] = M[slot(j,m)];
// Jacobi scale from the moment diagonal; Cholesky of the scaled matrix; one
// solve; refine_steps residual sweeps through the moments; the de-scale in
// the store, fi_j = (y_j s_j) * fact_j 2^(-e deg_j) (the same two roundings
// as a separate pass).  Neighbours k >= nk are never read (padded slots may
// hold NaN).  The guards are the TPU kernel's: max d2 = 0 -> 1 (l.539), a
// non-positive diagonal -> scale 1 (l.650), a pivot below 1e-30 -> 1e-30
// (l.738).
//
// Bound on this card, at 2D order 4, K = 30 (NO = 15 DOFs, NM = 45 moments):
//   in/out  ~860 bytes per case (xk 480, fk 240, xi 16, nk 4, fi 120);
//   work    ~7 k f64 flops per case (assembly ~30 x 130, Cholesky
//           ~NO^3/3 multiply-adds, two triangular solves per solve, one sweep).
// At the data-sheet 3.35 TB/s and 67 TFLOP/s FP64 the bytes bound: 2.15 ms
// for 2^23 cases.  The design, after the register body (one thread per case, the
// whole factor in registers: 255 registers, 8.3 KB of spill loads, each
// thread reading its own 480 contiguous bytes of xk, the scale and the
// de-scale in ~19 ms of torch passes around it):
//   - a block of 64 threads, one case each.  The block's slabs of xk and fk
//     (contiguous in global memory) are copied into shared memory by
//     coalesced 8-byte cp.async, each case's rows at an odd stride, so the
//     three walks over a case's neighbours (h^2, max d2, the sums) read
//     shared memory without bank conflicts and xk comes from HBM once;
//   - the sums then leave registers for shared memory, in the slabs' place:
//     M, b, the scale, the reciprocal pivots and the factor's rows from
//     kRegRows on, per-entry rows of 64 doubles (a warp's 32 cases on
//     consecutive addresses); the factor's first rows stay in registers;
//     compiler barriers keep the shared values from being held in registers;
//   - the Cholesky and the solves are right-looking (each finished value
//     updates every later row: independent multiply-adds), the factor's
//     entries in the order of a row-by-row factor;
//   - the scale and the de-scale run here, so the wrapper makes no pass
//     over xk or fk and allocates nothing of size (B, K).
// The designs tried (four and two lanes per case with cp.async staging in a
// persistent grid, the factor in shared memory, the register body) and their
// times: chip_smoke.measure_moment_variants, PERF.md section 6.  ptxas
// still spills 400 bytes a thread at order 4 (chip_smoke.phase_headline
// fails above that; PERF.md says where the search stands).
//
// Built with -DWLSQM_EMIT_COND=1 the kernel also writes the per-case
// conditioning key, replacing _cond_estimate (pallas_fit.py:382) and
// _cond_inv_f2 (l.412), the emit_cond output of that kernel (l.717-719,
// 747-748): est = ||A_jac||_inf * ||A_jac^-1||_F * max(inv_s, 1)^order >=
// cond_2(A_jac) * amp, from the scale and the factor the fit already holds:
// the row sums from the scaled entries the factor starts from, and
// ||A^-1||_F^2 = ||Z Z^T||_F^2 with Z = L^-1 computed in place of the factor
// after the fit (~NO^3/3 multiply-adds), 8 more bytes written per case.  The
// row sums read those entries, not M[slot(j, m)]: in a loop that also reads
// the moments by slot, the compiler kept the generated switch as run-time
// jump tables (1,349 indirect branches at order 4, a key 4-5x the fit).  A
// collapsed neighbourhood meets the pivot guard, so its key is huge or
// non-finite and compares False against any edge.  The key is a second
// library of the same source.  Both are compiled with -fmad=false and every
// fused multiply-add is written out as fma(): the compiler contracts nothing
// on its own, so the fit's arithmetic does not depend on what else the
// kernel computes, and fi is the same bits with and without the key.
//
// Plain C entry points, loaded with ctypes; each launches on the caller's
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError().  wlsqm_moment_scale runs the fit's scale alone and
// writes e and inv_s per case (a check that the kernel scales as _prescale
// does).  Built with -DWLSQM_MOMENT_VARIANTS=1 the source also holds the
// designs the kernel was chosen from (fit_moment_variants.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "fit_moment_tables.cuh"  // generated from the Python chain tables

#ifndef WLSQM_EMIT_COND
#define WLSQM_EMIT_COND 0
#endif
#ifndef WLSQM_MOMENT_VARIANTS
#define WLSQM_MOMENT_VARIANTS 0
#endif

namespace {

constexpr bool kEmitCond = WLSQM_EMIT_COND != 0;  // this library writes the key
constexpr int kTB = 64;       // threads (cases) per block
constexpr int kRegRows = 11;  // rows of the factor kept in registers
constexpr int kWeightCenter = 2;  // defs.WEIGHT_CENTER
constexpr double kAlpha = 1e-4;   // reference: wlsqm/fitter/infra.pyx:45-46
constexpr double kBeta = 1.0 - 1e-4;

// packed lower triangle, j <= i
__host__ __device__ constexpr int lt(int i, int j) { return i * (i + 1) / 2 + j; }
// strictly lower triangle, j < i
__host__ __device__ constexpr int sl(int i, int j) { return i * (i - 1) / 2 + j; }

// 2^x for an integer-valued x: exact (ldexp) where x is finite and in
// range, exp2 elsewhere (inf, NaN), as torch.exp2 gives them
__device__ __forceinline__ double pow2(double x) {
  return fabs(x) < 1024.0 ? ldexp(1.0, (int)x) : exp2(x);
}

__device__ __forceinline__ double max_nan(double a, double b) {  // NaN wins, as amax
  return (b > a || b != b) ? b : a;
}

// a compiler barrier: values in shared memory are read again after it, not
// kept in registers across it (the per-case state lives in shared memory)
#define WLSQM_BARRIER() asm volatile("" ::: "memory")

// an 8-byte asynchronous copy from global to shared memory
__device__ __forceinline__ void cp_async8(double* s, const double* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(s)),
               "l"(g)
               : "memory");
}

// h^2 of one case: the products and the sum unfused as _prescale's
// delta * delta summed over the axes, the maximum NaN-propagating as amax
__device__ __forceinline__ double case_h2(const double* xc, int n, double x0, double y0) {
  double m = 0.0;
  for (int k = 0; k < n; ++k) {
    const double dx = xc[2 * k] - x0, dy = xc[2 * k + 1] - y0;
    m = max_nan(m, dx * dx + dy * dy);
  }
  return m;
}

// the case's power-of-two exponent e (inv_s = 2^-e), as
// engine.radius_pow2_scale: ceil(0.5 * log2(h2 > 0 ? h2 : 1))
__device__ __forceinline__ double scale_exponent(double h2) {
  return ceil(0.5 * log2(h2 > 0.0 ? h2 : 1.0));
}

// Shared memory of one block: per-entry rows of kTB doubles (entry e of the
// block's thread t at e * kTB + t: a warp's accesses to one entry are 32
// consecutive doubles, free of bank conflicts).  The factor's strictly
// lower rows 0..R-1 live in registers, rows R.. here; its diagonal is kept
// as reciprocals (the solves multiply by them).
template <int ORDER>
struct Layout {
  using T = MomentTables<ORDER>;
  static constexpr int NO = T::NO;
  static constexpr int R = NO < kRegRows ? NO : kRegRows;
  static constexpr int NLR = R * (R - 1) / 2;             // factor entries in registers
  static constexpr int NLT = NO * (NO - 1) / 2 - NLR;     // ... in shared memory
  static constexpr int M = 0, B = T::NM, S = B + NO, RD = S + NO, LT = RD + NO;
  static constexpr int kEntries = LT + NLT;
  static constexpr size_t kBytes = sizeof(double) * kEntries * kTB;
};

// the factor's strictly lower entry (i, j): registers for i < R, else shared
#define WLSQM_L(i, j) \
  ((i) < R ? LR[(i) < R ? sl(i, j) : 0] : sm[(Lay::LT + sl(i, j) - NLR) * kTB])
#define WLSQM_L_SET(i, j, v)                                \
  do {                                                      \
    if ((i) < R)                                            \
      LR[(i) < R ? sl(i, j) : 0] = (v);                     \
    else                                                    \
      sm[(Lay::LT + sl(i, j) - NLR) * kTB] = (v);           \
  } while (0)

template <int ORDER, int WEIGHTING>
__global__ void __launch_bounds__(kTB)
fit_moment_2d(const double* __restrict__ xk, const double* __restrict__ fk,
              const int* __restrict__ nk, const double* __restrict__ xi,
              double* __restrict__ fi, double* __restrict__ est, int64_t B, int K,
              int refine_steps, int staged) {
  using T = MomentTables<ORDER>;
  using Lay = Layout<ORDER>;
  constexpr int NO = T::NO;
  constexpr int NM = T::NM;
  constexpr int R = Lay::R;
  constexpr int NLR = Lay::NLR;
  extern __shared__ __align__(16) double smem[];
  const int tid = threadIdx.x;
  const int64_t c0 = (int64_t)blockIdx.x * kTB, c = c0 + tid;
  const bool valid = c < B;
  double* const sm = smem + tid;

  // ---- the block's slabs of xk and fk (contiguous in global memory) into
  //      shared memory by coalesced 8-byte cp.async, each case's rows at an
  //      odd stride, so that the cases' walks below are free of bank
  //      conflicts; past what one block can hold, the walks read global
  //      memory ----
  const int ldx = 2 * K + 1, ldf = K | 1;
  const double* xc = xk + c * (int64_t)K * 2;
  const double* fc = fk + c * (int64_t)K;
  if (staged) {
    const int cnt = (int)min((int64_t)kTB, B - c0);
    const double* gx = xk + c0 * K * 2;
    for (int g = tid; g < cnt * K * 2; g += kTB)
      cp_async8(smem + (g / (2 * K)) * ldx + g % (2 * K), gx + g);
    const double* gf = fk + c0 * K;
    double* const sf = smem + kTB * ldx;
    for (int g = tid; g < cnt * K; g += kTB) cp_async8(sf + (g / K) * ldf + g % K, gf + g);
    asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::: "memory");
    xc = smem + tid * ldx;
    fc = sf + tid * ldf;
  }
  __syncthreads();

  // ---- the scale (h^2 of the unscaled offsets), the CENTER normalisation,
  //      and the moments and the RHS in registers ----
  double e = 0.0, is = 1.0;
  double M[NM], b[NO];
#pragma unroll
  for (int i = 0; i < NM; ++i) M[i] = 0.0;
#pragma unroll
  for (int j = 0; j < NO; ++j) b[j] = 0.0;
  if (valid) {
    const int n = min(max(nk[c], 0), K);
    const double x0 = xi[2 * c], y0 = xi[2 * c + 1];
    e = scale_exponent(case_h2(xc, n, x0, y0));
    is = pow2(-e);
    double max_d2 = 1.0;
    if (WEIGHTING == kWeightCenter) {
      double m = 0.0;
      for (int k = 0; k < n; ++k) {
        const double dx = (xc[2 * k] - x0) * is, dy = (xc[2 * k + 1] - y0) * is;
        m = fmax(m, fma(dx, dx, dy * dy));
      }
      max_d2 = m > 0.0 ? m : 1.0;
    }
    // per neighbour: the powers of the scaled offsets, w dy^b and w f dy^b,
    // then one multiply-add per moment and per RHS entry
    for (int k = 0; k < n; ++k) {
      const double d[2] = {(xc[2 * k] - x0) * is, (xc[2 * k + 1] - y0) * is};
      double w = 1.0;
      if (WEIGHTING == kWeightCenter) {
        const double t = 1.0 - sqrt(fma(d[0], d[0], d[1] * d[1]) / max_d2);
        w = fma(kBeta * t, t, kAlpha);
      }
      double px[2 * ORDER + 1], py[2 * ORDER + 1], pf[ORDER + 1];
      px[0] = 1.0, py[0] = w, pf[0] = w * fc[k];
#pragma unroll
      for (int a = 1; a <= 2 * ORDER; ++a) {
        px[a] = px[a - 1] * d[0];
        py[a] = py[a - 1] * d[1];
      }
#pragma unroll
      for (int a = 1; a <= ORDER; ++a) pf[a] = pf[a - 1] * d[1];
#pragma unroll
      for (int i = 0; i < NM; ++i) M[i] = fma(px[T::mex(i)], py[T::mey(i)], M[i]);
#pragma unroll
      for (int j = 0; j < NO; ++j) b[j] = fma(px[T::ex(j)], pf[T::deg(j) - T::ex(j)], b[j]);
    }
  }
  __syncthreads();  // the slabs are read: the per-case state takes their place
  if (!valid) return;
  // M, b and the Jacobi scale from the moment diagonal to shared memory,
  // read back from there (the barrier keeps them out of registers)
#pragma unroll
  for (int i = 0; i < NM; ++i) sm[(Lay::M + i) * kTB] = M[i];
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const double djj = M[T::slot(j, j)];
    sm[(Lay::B + j) * kTB] = b[j];
    sm[(Lay::S + j) * kTB] = djj > 0.0 ? 1.0 / sqrt(djj) : 1.0;
  }
  WLSQM_BARRIER();
#define WLSQM_M(i) sm[(Lay::M + (i)) * kTB]
#define WLSQM_S(j) sm[(Lay::S + (j)) * kTB]
#define WLSQM_RD(j) sm[(Lay::RD + (j)) * kTB]

  // ---- Cholesky of the scaled matrix, right-looking: each finished column
  //      updates the trailing entries, every entry in pivot order (the
  //      operations of a row-by-row factor, with independent updates); the
  //      working diagonal lives in the reciprocal-pivot slots; the guard
  //      lets NaN through ----
  double LR[NLR > 0 ? NLR : 1];
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    WLSQM_BARRIER();
    const double sj = WLSQM_S(j);
    sm[(Lay::RD + j) * kTB] = WLSQM_M(T::slot(j, j)) * (sj * sj);
#pragma unroll
    for (int i = j + 1; i < NO; ++i) WLSQM_L_SET(i, j, WLSQM_M(T::slot(j, i)) * (sj * WLSQM_S(i)));
  }
  // the key's first factor (this library only): the max abs row sum of the
  // scaled matrix, NaN kept, read from the entries just set (the moments
  // times s_j s_m, the bits a row sum over M[slot(j, m)] would read)
  double ninf = 0.0;
  if constexpr (kEmitCond) {
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      WLSQM_BARRIER();
      double rs = 0.0;
#pragma unroll
      for (int m = 0; m < NO; ++m)
        rs += fabs(m == j ? WLSQM_RD(j) : m < j ? WLSQM_L(j, m) : WLSQM_L(m, j));
      ninf = max_nan(ninf, rs);
    }
  }
#pragma unroll
  for (int q = 0; q < NO; ++q) {
    WLSQM_BARRIER();
    const double acc = sm[(Lay::RD + q) * kTB];
    const double invd = 1.0 / sqrt(acc < 1e-30 ? 1e-30 : acc);
    sm[(Lay::RD + q) * kTB] = invd;
#pragma unroll
    for (int i = q + 1; i < NO; ++i) WLSQM_L_SET(i, q, WLSQM_L(i, q) * invd);
#pragma unroll
    for (int j = q + 1; j < NO; ++j) {
      WLSQM_BARRIER();  // one trailing column of shared-memory rows in registers at a time
      const double ljq = WLSQM_L(j, q);
      sm[(Lay::RD + j) * kTB] = fma(-ljq, ljq, sm[(Lay::RD + j) * kTB]);
#pragma unroll
      for (int i = j + 1; i < NO; ++i) WLSQM_L_SET(i, j, fma(-WLSQM_L(i, q), ljq, WLSQM_L(i, j)));
    }
  }

  // ---- solve in the scaled space, then sweep: y += solve(s (b - A (s y)));
  //      each solve's two passes right-looking (each known value updates
  //      every row after it: independent multiply-adds, each row's in pivot
  //      order), the reciprocal pivots in shared memory ----
  double y[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) y[j] = 0.0;
#pragma unroll 1
  for (int it = 0; it <= refine_steps; ++it) {
    double x[NO];
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      WLSQM_BARRIER();
      double acc = 0.0;
      if (it > 0) {
#pragma unroll
        for (int m = 0; m < NO; ++m) acc = fma(WLSQM_M(T::slot(j, m)), y[m] * WLSQM_S(m), acc);
      }
      x[j] = (sm[(Lay::B + j) * kTB] - acc) * WLSQM_S(j);
    }
#pragma unroll
    for (int q = 0; q < NO; ++q) {
      WLSQM_BARRIER();
      x[q] *= WLSQM_RD(q);
#pragma unroll
      for (int r = q + 1; r < NO; ++r) x[r] = fma(-WLSQM_L(r, q), x[q], x[r]);
    }
#pragma unroll
    for (int q = NO - 1; q >= 0; --q) {
      WLSQM_BARRIER();
      x[q] *= WLSQM_RD(q);
#pragma unroll
      for (int r = 0; r < q; ++r) x[r] = fma(-WLSQM_L(q, r), x[q], x[r]);
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) y[j] += x[j];
  }

  // ---- the de-scale in the store: (y s) * fact 2^(-e deg), an exact factor ----
  {
    double ip[ORDER + 1];
#pragma unroll
    for (int d = 0; d <= ORDER; ++d) ip[d] = pow2(-e * d);
    double* out = fi + c * NO;
#pragma unroll
    for (int j = 0; j < NO; ++j) out[j] = (y[j] * WLSQM_S(j)) * (T::fact(j) * ip[T::deg(j)]);
  }

  // ---- the key: ninf (taken before the factor) times the Frobenius norm
  //      of the scaled matrix's inverse, after the fit (fi does not see it) ----
  if constexpr (kEmitCond) {
    // Z = L^-1 in place of the factor's strict lower part, column by column
    // (Z[a][a] = rd_a stays in the pivot slots): Z[i][a] = -rd_i (L[i][a] rd_a
    // + sum_{a<q<i} L[i][q] Z[q][a]), rows in order, so each entry is
    // overwritten once its row no longer needs it
#pragma unroll
    for (int a = 0; a < NO; ++a) {
      WLSQM_BARRIER();
      const double ra = WLSQM_RD(a);
#pragma unroll
      for (int i = a + 1; i < NO; ++i) {
        double t = WLSQM_L(i, a) * ra;
#pragma unroll
        for (int q = a + 1; q < i; ++q) t = fma(WLSQM_L(i, q), WLSQM_L(q, a), t);
        WLSQM_L_SET(i, a, -t * WLSQM_RD(i));
      }
    }
    // ||Z Z^T||_F^2 = ||(L L^T)^-1||_F^2: the dot products of Z's rows,
    // those below the diagonal twice
    double f2 = 0.0;
#pragma unroll
    for (int k = 0; k < NO; ++k) {
      WLSQM_BARRIER();
      const double rk = WLSQM_RD(k);
#pragma unroll
      for (int i = k; i < NO; ++i) {
        double d = i == k ? rk * rk : WLSQM_L(i, k) * rk;
#pragma unroll
        for (int a = 0; a < k; ++a) d = fma(WLSQM_L(i, a), WLSQM_L(k, a), d);
        f2 = fma(i == k ? d : 2.0 * d, d, f2);
      }
    }
    double amp = 1.0;
#pragma unroll
    for (int o = 0; o < ORDER; ++o) amp *= fmax(is, 1.0);
    est[c] = ninf * sqrt(f2) * amp;
  }
#undef WLSQM_M
#undef WLSQM_S
#undef WLSQM_RD
}

// the fit's scale alone: e and inv_s per case, from case_h2 and
// scale_exponent exactly as fit_moment_2d computes them
__global__ void __launch_bounds__(kTB)
moment_scale(const double* __restrict__ xk, const int* __restrict__ nk,
             const double* __restrict__ xi, double* __restrict__ e_out,
             double* __restrict__ inv_s_out, int64_t B, int K) {
  const int64_t c = (int64_t)blockIdx.x * kTB + threadIdx.x;
  if (c >= B) return;
  const int n = min(max(nk[c], 0), K);
  const double e = scale_exponent(case_h2(xk + c * (int64_t)K * 2, n, xi[2 * c], xi[2 * c + 1]));
  e_out[c] = e;
  inv_s_out[c] = pow2(-e);
}

template <int ORDER, int WEIGHTING>
int launch(const double* xk, const double* fk, const int* nk, const double* xi, double* fi,
           double* est, int64_t B, int K, int refine_steps, cudaStream_t stream) {
  auto kernel = fit_moment_2d<ORDER, WEIGHTING>;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t slab = sizeof(double) * kTB * (size_t)(2 * K + 1 + (K | 1));
  const int staged = slab <= (size_t)optin;
  const size_t bytes = staged && slab > Layout<ORDER>::kBytes ? slab : Layout<ORDER>::kBytes;
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)((B + kTB - 1) / kTB), kTB, bytes, stream>>>(xk, fk, nk, xi, fi, est, B,
                                                                  K, refine_steps, staged);
  return (int)cudaGetLastError();
}

int dispatch(const void* xk, const void* fk, const void* nk, const void* xi, void* fi,
             void* est, int64_t B, int K, int order, int weighting, int refine_steps,
             void* stream) {
  const double* x = (const double*)xk;
  const double* f = (const double*)fk;
  const int* n = (const int*)nk;
  const double* o = (const double*)xi;
  double* out = (double*)fi;
  double* e = (double*)est;
  cudaStream_t st = (cudaStream_t)stream;
  const bool center = weighting == kWeightCenter;
#define WLSQM_CASE(ORD)                                                           \
  case ORD:                                                                       \
    return center ? launch<ORD, 2>(x, f, n, o, out, e, B, K, refine_steps, st)    \
                  : launch<ORD, 1>(x, f, n, o, out, e, B, K, refine_steps, st);
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
}

}  // namespace

// xk (B, K, 2) f64 | fk (B, K) f64 | nk (B,) i32 | xi (B, 2) f64 ->
// fi (B, NO) f64 in the reference's DOF convention | est (B,) f64, the key
// with its radius amplification: given exactly when the library was built
// with WLSQM_EMIT_COND=1, else null.
extern "C" int wlsqm_fit_moment_2d(const void* xk, const void* fk, const void* nk,
                                   const void* xi, void* fi, void* est, int64_t B, int K,
                                   int order, int weighting, int refine_steps, void* stream) {
  if ((est != nullptr) != kEmitCond) return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaSuccess;
  if (K <= 0 || refine_steps < 0) return (int)cudaErrorInvalidValue;
  return dispatch(xk, fk, nk, xi, fi, est, B, K, order, weighting, refine_steps, stream);
}

// xk (B, K, 2) | nk (B,) | xi (B, 2) -> e (B,), inv_s (B,): the fit's scale
extern "C" int wlsqm_moment_scale(const void* xk, const void* nk, const void* xi, void* e,
                                  void* inv_s, int64_t B, int K, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  moment_scale<<<(unsigned)((B + kTB - 1) / kTB), kTB, 0, (cudaStream_t)stream>>>(
      (const double*)xk, (const int*)nk, (const double*)xi, (double*)e, (double*)inv_s, B, K);
  return (int)cudaGetLastError();
}

#if WLSQM_MOMENT_VARIANTS
#include "fit_moment_variants.cuh"
#endif
