// Moment-assembly WLSQM fit, FP64 (Hopper, sm_90a): a thread body, one
// thread per case, for the small systems and a warp body, one warp per case,
// for 3D orders 3-4.
//
// Replaces the TPU kernel wlsqm_tpu/ops/pallas_fit.py:438
// (_make_kernel_moment, launched by fit_pallas at l.1502) in full: dims 1-3,
// orders 0-4, any knowns mask, the basic algorithm and ALGO_ITERATIVE.  That
// kernel computes in f32 pairs because the TPU has no f64; the H100 has
// native FP64, so this one computes in double and is held to the f64 engine.
//
// Per case: the radius scale (h^2 = max over k < nk of the unfused sum of the
// squared unscaled offsets, e = ceil(0.5 * log2(h^2 > 0 ? h^2 : 1)), inv_s =
// 2^-e: the arithmetic of ops/fit_kernel._prescale, bit for bit, which
// fit_rows and condprobe keep using); offsets d = (xk - xi) * inv_s; weights
// (UNIFORM, or CENTER = a + b (1 - sqrt(d2 / max d2))^2); the weighted
// moments M[e] up to degree 2*ORDER, each neighbour's product of its axes'
// power ladders (the last axis' ladder carries w) added to each moment, and
// the RHS from w f times the last axis' powers; known DOFs eliminated
// through the moments, b_m -= g_j M[e_j + e_m] with g the known value in the
// scaled space (fi_init / (fact 2^(-e deg)), bit for bit
// ops/fit_kernel._scaled_knowns), identity rows and columns and scale 1
// (l.633-650); A[j,m] = M[slot(j,m)]; Jacobi scale from the moment
// diagonal; Cholesky of the scaled matrix; one solve; refine_steps residual
// sweeps through the moments, y += solve(s (b - A (s y))); with max_iter > 0
// ALGO_ITERATIVE: per trip the l-inf norm of the data residual f_k -
// sum_j c_kj x_j over the neighbours, the reference's exact stagnation rule
// (stop when it repeats; wlsqm/fitter/impl.pyx:1057-1061), and else one
// corrective refit, which is exactly one such sweep (the normal-equation
// residual equals the data-space projection; l.817-885), and the per-case
// count; the de-scale in the store, fi_j = (y_j s_j) * fact_j 2^(-e deg_j),
// and the known values written back bit for bit (l.887-897).  Neighbours
// k >= nk are never read (padded slots may hold NaN).  The guards are the
// TPU kernel's: max d2 = 0 -> 1 (l.539), a non-positive diagonal -> scale 1
// (l.650), a pivot below 1e-30 -> 1e-30 (l.738).
//
// Bound on this card, at 2D order 4, K = 30 (NO = 15 DOFs, NM = 45 moments):
//   in/out  ~860 bytes per case (xk 480, fk 240, xi 16, nk 4, fi 120);
//   work    ~7 k f64 flops per case (assembly ~30 x 130, Cholesky
//           ~NO^3/3 multiply-adds, two triangular solves per solve, one sweep).
// At the data-sheet 3.35 TB/s and 67 TFLOP/s FP64 the bytes bound: 2.15 ms
// for 2^23 cases.  At 3D order 4, K = 48 (NO = 35, NM = 165): in ~1.6 KB,
// out 280 B per case, ~20 k flops (assembly 48 x 2 x 200, Cholesky ~14 k,
// the solves ~5 k): bound by bytes, ~1.0 ms for 2^21 cases.
//
// The thread body (NO < 20: 1D, 2D, 3D orders 0-2), after the register body
// (one thread per case, the whole factor in registers: 255 registers, 8.3 KB
// of spill loads, each thread reading its own 480 contiguous bytes of xk, the
// scale and the de-scale in ~19 ms of torch passes around it):
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
//   Knowns and ALGO_ITERATIVE are compiled into a second instance (EXT), so
//   the basic instance without them (the headline, 2D) keeps its code; in
//   1D and 3D the one instance has both.  ALGO_ITERATIVE's residual pass
//   reads the case's neighbours from global memory (the slabs are gone).
// The designs tried for the thread body (four and two lanes per case with
// cp.async staging in a persistent grid, the factor in shared memory, the
// register body) and their times: chip_smoke.measure_moment_variants,
// PERF.md section 6.  ptxas spills 400 bytes a thread at 2D order 4
// (chip_smoke.phase_headline fails above that).
//
// The warp body (3D orders 3-4, NO = 20 / 35, NM = 84 / 165): a thread's
// moments and factor (~6.9 KB at order 4) fit neither its registers nor 64
// threads' share of a block's shared memory, so one warp (one block of 32
// threads) takes a case, its state in shared memory:
//   - neighbours in chunks of 32, one per lane: each lane writes its
//     neighbour's products dx^a dy^b (the (a, b) pairs of the lattice) and
//     its z columns w dz^c and w f dz^c into the chunk's operands; the
//     moments and the RHS are then one product, D[(a, b)][c] = sum_k
//     (dx^a dy^b)_k (w dz^c)_k, on the FP64 tensor cores (mma m8n8k4: the
//     products added in neighbour order with one rounding each, the
//     arithmetic of the thread body's fma chain), and a generated table
//     says which moment or RHS entry each product is (on an H100 this took
//     the dim3 launch from 98.3 to 74.5 ms at 2^21 against lanes summing
//     their own moments from ladder tables, 1,150 shared-memory loads a lane
//     at K = 48; PERF.md);
//   - A[j,m] = M[slot(j,m)] scaled into a packed triangle, lanes over rows;
//   - the Cholesky by panels on the FP64 tensor cores, the single-RHS solves
//     and the blocked key: the rows kernel's warp-body functions
//     (warp_chol.cuh);
//   - the sweeps' A (s y) with lanes over rows from the moments; the
//     residual pass with lanes over neighbours and a shuffle max.
//
// Built with -DWLSQM_EMIT_COND=1 the kernel also writes the per-case
// conditioning key, replacing _cond_estimate (pallas_fit.py:382) and
// _cond_inv_f2 (l.412), the emit_cond output of that kernel (l.717-719,
// 747-748): est = ||A_jac||_inf * ||A_jac^-1||_F * max(inv_s, 1)^order >=
// cond_2(A_jac) * amp, from the scale and the factor the fit already holds
// (identity rows for the known DOFs): the row sums from the scaled entries
// the factor starts from, and ||A^-1||_F^2 = ||Z Z^T||_F^2 with Z = L^-1
// (the thread body: computed in place of the factor after the fit, ~NO^3/3
// multiply-adds; the warp body: by 8 x 8 blocks on the tensor cores), 8 more
// bytes written per case.  The row sums read those entries, not
// M[slot(j, m)]: in a loop that also reads the moments by slot, the compiler
// kept the generated switch as run-time jump tables (1,349 indirect branches
// at order 4, a key 4-5x the fit).  A collapsed neighbourhood meets the pivot
// guard, so its key is huge or non-finite and compares False against any
// edge.  The key is a second library of the same source.  Both are compiled
// with -fmad=false and every fused multiply-add is written out as fma(): the
// compiler contracts nothing on its own, so the fit's arithmetic does not
// depend on what else the kernel computes, and fi is the same bits with and
// without the key.
//
// One library per dimension (-DWLSQM_MOMENT_DIM), so the three build at once.
// Plain C entry points, loaded with ctypes; each launches on the caller's
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError().  wlsqm_moment_scale runs the fit's scale alone and
// writes e and inv_s per case (a check that the kernel scales as _prescale
// does).  Built with -DWLSQM_MOMENT_VARIANTS=1 (2D) the source also holds the
// designs the thread body was chosen from (fit_moment_variants.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "fit_moment_tables.cuh"  // generated from the Python chain tables
#include "warp_chol.cuh"          // the warp body's factor, solves and key

#ifndef WLSQM_EMIT_COND
#define WLSQM_EMIT_COND 0
#endif
#ifndef WLSQM_MOMENT_DIM
#define WLSQM_MOMENT_DIM 2
#endif
#ifndef WLSQM_MOMENT_VARIANTS
#define WLSQM_MOMENT_VARIANTS 0
#endif

namespace {

constexpr bool kEmitCond = WLSQM_EMIT_COND != 0;  // this library writes the key
constexpr int kDim = WLSQM_MOMENT_DIM;            // this library's dimension
constexpr int kTB = 64;       // threads (cases) per block of the thread body
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

// the squared unscaled distance of neighbour k: the products and the sum
// unfused as _prescale's delta * delta summed over the axes
template <int DIM>
__device__ __forceinline__ double unscaled_d2(const double* xc, int k, const double (&x0)[DIM]) {
  const double d0 = xc[DIM * k] - x0[0];
  double s = d0 * d0;
#pragma unroll
  for (int a = 1; a < DIM; ++a) {
    const double da = xc[DIM * k + a] - x0[a];
    s = s + da * da;
  }
  return s;
}

// h^2 of one case, the maximum NaN-propagating as amax
template <int DIM>
__device__ __forceinline__ double case_h2(const double* xc, int n, const double (&x0)[DIM]) {
  double m = 0.0;
  for (int k = 0; k < n; ++k) m = max_nan(m, unscaled_d2<DIM>(xc, k, x0));
  return m;
}

// the case's power-of-two exponent e (inv_s = 2^-e), as
// engine.radius_pow2_scale: ceil(0.5 * log2(h2 > 0 ? h2 : 1))
__device__ __forceinline__ double scale_exponent(double h2) {
  return ceil(0.5 * log2(h2 > 0.0 ? h2 : 1.0));
}

// the scaled offsets of neighbour k
template <int DIM>
__device__ __forceinline__ void offsets(const double* xc, int k, const double (&x0)[DIM],
                                        double is, double (&d)[DIM]) {
#pragma unroll
  for (int a = 0; a < DIM; ++a) d[a] = (xc[DIM * k + a] - x0[a]) * is;
}

// |d|^2 of scaled offsets, the last axis' square first
template <int DIM>
__device__ __forceinline__ double sq(const double (&d)[DIM]) {
  double s = d[DIM - 1] * d[DIM - 1];
#pragma unroll
  for (int a = DIM - 2; a >= 0; --a) s = fma(d[a], d[a], s);
  return s;
}

// the CENTER weight of scaled offsets d (1 for UNIFORM)
template <int DIM, int WEIGHTING>
__device__ __forceinline__ double weight(const double (&d)[DIM], double max_d2) {
  if (WEIGHTING != kWeightCenter) return 1.0;
  const double t = 1.0 - sqrt(sq<DIM>(d) / max_d2);
  return fma(kBeta * t, t, kAlpha);
}

// the plain monomial basis row c_j = prod_a d_a^{e_ja} of scaled offsets d,
// from per-axis power ladders (the data residual of ALGO_ITERATIVE)
template <int DIM, int ORDER>
__device__ __forceinline__ void basis_row(const double (&d)[DIM],
                                          double (&c)[MomentTables<DIM, ORDER>::NO]) {
  using T = MomentTables<DIM, ORDER>;
  double p[DIM][ORDER + 1];
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    p[a][0] = 1.0;
#pragma unroll
    for (int e = 1; e <= ORDER; ++e) p[a][e] = p[a][e - 1] * d[a];
  }
#pragma unroll
  for (int j = 0; j < T::NO; ++j) {
    double v = 1.0;
    bool first = true;
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
      const int e = T::de(j, a);
      if (e != 0) {
        v = first ? p[a][e] : v * p[a][e];
        first = false;
      }
    }
    c[j] = v;
  }
}

// a known value in the kernel's scaled space: gi / (fact 2^(-e deg)), the
// quotient ops/fit_kernel._scaled_knowns computes; 0 without fi_init
__device__ __forceinline__ double scaled_known(const double* gi, int64_t at, int fact,
                                               int deg, double e) {
  return gi != nullptr ? gi[at] / ((double)fact * pow2(-e * deg)) : 0.0;
}

// ---------------------------------------------------------------------------
// The thread body: one thread per case
// ---------------------------------------------------------------------------

// Shared memory of one block: per-entry rows of kTB doubles (entry e of the
// block's thread t at e * kTB + t: a warp's accesses to one entry are 32
// consecutive doubles, free of bank conflicts).  The factor's strictly
// lower rows 0..R-1 live in registers, rows R.. here; its diagonal is kept
// as reciprocals (the solves multiply by them).
template <int DIM, int ORDER>
struct Layout {
  using T = MomentTables<DIM, ORDER>;
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

template <int DIM, int ORDER, int WEIGHTING, bool EXT>
__global__ void __launch_bounds__(kTB)
fit_moment_thread(const double* __restrict__ xk, const double* __restrict__ fk,
                  const int* __restrict__ nk, const double* __restrict__ xi,
                  const double* __restrict__ gi, double* __restrict__ fi,
                  int* __restrict__ iters, double* __restrict__ est, int64_t B, int K,
                  int64_t knowns, int64_t ldg, int refine_steps, int max_iter, int staged) {
  using T = MomentTables<DIM, ORDER>;
  using Lay = Layout<DIM, ORDER>;
  constexpr int NO = T::NO;
  constexpr int NM = T::NM;
  constexpr int R = Lay::R;
  constexpr int NLR = Lay::NLR;
  static_assert(!T::kWarp, "a warp-body instance");
  extern __shared__ __align__(16) double smem[];
  const int tid = threadIdx.x;
  const int64_t c0 = (int64_t)blockIdx.x * kTB, c = c0 + tid;
  const bool valid = c < B;
  double* const sm = smem + tid;
  // a known DOF (the EXT instance only: elsewhere the predicate folds away)
  auto kn = [knowns](int j) { return EXT && ((knowns >> j) & 1LL) != 0; };

  // ---- the block's slabs of xk and fk (contiguous in global memory) into
  //      shared memory by coalesced 8-byte cp.async, each case's rows at an
  //      odd stride, so that the cases' walks below are free of bank
  //      conflicts; past what one block can hold, the walks read global
  //      memory ----
  const int ldx = (DIM * K) | 1, ldf = K | 1;
  const double* const xg = xk + c * (int64_t)K * DIM;
  const double* const fg = fk + c * (int64_t)K;
  const double* xc = xg;
  const double* fc = fg;
  if (staged) {
    const int cnt = (int)min((int64_t)kTB, B - c0);
    const double* gx = xk + c0 * K * DIM;
    for (int g = tid; g < cnt * K * DIM; g += kTB)
      cp_async8(smem + (g / (DIM * K)) * ldx + g % (DIM * K), gx + g);
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
  double e = 0.0, is = 1.0, max_d2 = 1.0;
  double x0[DIM];
  int n = 0;
  double M[NM], b[NO];
#pragma unroll
  for (int i = 0; i < NM; ++i) M[i] = 0.0;
#pragma unroll
  for (int j = 0; j < NO; ++j) b[j] = 0.0;
  if (valid) {
    n = min(max(nk[c], 0), K);
#pragma unroll
    for (int a = 0; a < DIM; ++a) x0[a] = xi[DIM * c + a];
    e = scale_exponent(case_h2<DIM>(xc, n, x0));
    is = pow2(-e);
    if (WEIGHTING == kWeightCenter) {
      double m = 0.0;
      for (int k = 0; k < n; ++k) {
        double d[DIM];
        offsets<DIM>(xc, k, x0, is, d);
        m = fmax(m, sq<DIM>(d));
      }
      max_d2 = m > 0.0 ? m : 1.0;
    }
    // per neighbour: the powers of the scaled offsets (the last axis' times
    // w), w f times the last axis' powers, then one multiply-add per moment
    // and per RHS entry (a product of two ladders first in 3D)
    for (int k = 0; k < n; ++k) {
      double d[DIM];
      offsets<DIM>(xc, k, x0, is, d);
      const double w = weight<DIM, WEIGHTING>(d, max_d2);
      double p[DIM][2 * ORDER + 1], pf[ORDER + 1];
#pragma unroll
      for (int a = 0; a < DIM - 1; ++a) p[a][0] = 1.0;
      p[DIM - 1][0] = w, pf[0] = w * fc[k];
#pragma unroll
      for (int q = 1; q <= 2 * ORDER; ++q)
#pragma unroll
        for (int a = 0; a < DIM; ++a) p[a][q] = p[a][q - 1] * d[a];
#pragma unroll
      for (int q = 1; q <= ORDER; ++q) pf[q] = pf[q - 1] * d[DIM - 1];
#pragma unroll
      for (int i = 0; i < NM; ++i) {
        if constexpr (DIM == 1) M[i] += p[0][T::me(i, 0)];
        else if constexpr (DIM == 2) M[i] = fma(p[0][T::me(i, 0)], p[1][T::me(i, 1)], M[i]);
        else M[i] = fma(p[0][T::me(i, 0)] * p[1][T::me(i, 1)], p[2][T::me(i, 2)], M[i]);
      }
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        if constexpr (DIM == 1) b[j] += pf[T::de(j, 0)];
        else if constexpr (DIM == 2) b[j] = fma(p[0][T::de(j, 0)], pf[T::de(j, 1)], b[j]);
        else b[j] = fma(p[0][T::de(j, 0)] * p[1][T::de(j, 1)], pf[T::de(j, 2)], b[j]);
      }
    }
    // the known values through the moments: b_m -= g_j M[e_j + e_m]
    if constexpr (EXT) {
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        if (kn(j)) {
          const double gj = scaled_known(gi, c * ldg + j, T::fact(j), T::deg(j), e);
#pragma unroll
          for (int m = 0; m < NO; ++m)
            if (!kn(m)) b[m] = b[m] - gj * M[T::slot(j, m)];
        }
      }
    }
  }
  __syncthreads();  // the slabs are read: the per-case state takes their place
  if (!valid) return;
  // M, b and the Jacobi scale from the moment diagonal (1 for a known DOF)
  // to shared memory, read back from there (the barrier keeps them out of
  // registers)
#pragma unroll
  for (int i = 0; i < NM; ++i) sm[(Lay::M + i) * kTB] = M[i];
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const double djj = M[T::slot(j, j)];
    sm[(Lay::B + j) * kTB] = b[j];
    sm[(Lay::S + j) * kTB] = kn(j) ? 1.0 : djj > 0.0 ? 1.0 / sqrt(djj) : 1.0;
  }
  WLSQM_BARRIER();
#define WLSQM_M(i) sm[(Lay::M + (i)) * kTB]
#define WLSQM_S(j) sm[(Lay::S + (j)) * kTB]
#define WLSQM_RD(j) sm[(Lay::RD + (j)) * kTB]

  // ---- Cholesky of the scaled matrix (identity rows and columns for the
  //      known DOFs), right-looking: each finished column updates the
  //      trailing entries, every entry in pivot order (the operations of a
  //      row-by-row factor, with independent updates); the working diagonal
  //      lives in the reciprocal-pivot slots; the guard lets NaN through ----
  double LR[NLR > 0 ? NLR : 1];
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    WLSQM_BARRIER();
    const double sj = WLSQM_S(j);
    sm[(Lay::RD + j) * kTB] = kn(j) ? 1.0 : WLSQM_M(T::slot(j, j)) * (sj * sj);
#pragma unroll
    for (int i = j + 1; i < NO; ++i)
      WLSQM_L_SET(i, j, kn(i) || kn(j) ? 0.0 : WLSQM_M(T::slot(j, i)) * (sj * WLSQM_S(i)));
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
  //      order), the reciprocal pivots in shared memory; a known DOF's row
  //      has a zero right-hand side, so its y stays 0 ----
  double y[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) y[j] = 0.0;
  auto sweep = [&](bool first) {
    double x[NO];
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      WLSQM_BARRIER();
      double acc = 0.0;
      if (!first) {
#pragma unroll
        for (int m = 0; m < NO; ++m)
          if (!kn(m)) acc = fma(WLSQM_M(T::slot(j, m)), y[m] * WLSQM_S(m), acc);
      }
      x[j] = kn(j) ? 0.0 : (sm[(Lay::B + j) * kTB] - acc) * WLSQM_S(j);
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
  };
#pragma unroll 1
  for (int it = 0; it <= refine_steps; ++it) sweep(it == 0);

  // ---- ALGO_ITERATIVE: corrective refits, each one sweep, until the l-inf
  //      norm of the data residual repeats exactly; the neighbours from
  //      global memory ----
  if constexpr (EXT) {
    if (max_iter > 0) {
      bool done = false;
      double prev = -1.0;
      int itn = 0;
#pragma unroll 1
      for (int it = 0; it < max_iter && !done; ++it) {
        double xh[NO];
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          WLSQM_BARRIER();
          xh[j] = kn(j) ? scaled_known(gi, c * ldg + j, T::fact(j), T::deg(j), e)
                        : y[j] * WLSQM_S(j);
        }
        double nrm = 0.0;
#pragma unroll 1
        for (int k = 0; k < n; ++k) {
          double d[DIM], cr[NO];
          offsets<DIM>(xg, k, x0, is, d);
          basis_row<DIM, ORDER>(d, cr);
          double m = 0.0;
#pragma unroll
          for (int j = 0; j < NO; ++j) m = fma(cr[j], xh[j], m);
          nrm = fmax(nrm, fabs(fg[k] - m));
        }
        done = nrm == prev;
        if (!done) {
          sweep(false);
          ++itn;
        }
        prev = nrm;
      }
      iters[c] = itn;
    }
  }

  // ---- the de-scale in the store: (y s) * fact 2^(-e deg), an exact
  //      factor; a known DOF gets fi_init's bits ----
  {
    double ip[ORDER + 1];
#pragma unroll
    for (int d = 0; d <= ORDER; ++d) ip[d] = pow2(-e * d);
    double* out = fi + c * NO;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      out[j] = kn(j) ? (gi != nullptr ? gi[c * ldg + j] : 0.0)
                     : (y[j] * WLSQM_S(j)) * (T::fact(j) * ip[T::deg(j)]);
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

// ---------------------------------------------------------------------------
// The warp body: one warp (one block of 32 threads) per case
// ---------------------------------------------------------------------------

// Shared-memory layout of one case, in doubles: the moments, then a region
// that holds the chunk's product operands during the assembly (the (x, y)
// pair products P, NPP rows of kKC neighbours, and the z columns Q: w dz^c
// and w f dz^c, 16 rows; neighbours contiguous, rows at stride kLDX) and
// after it the packed matrix and then factor, eight vectors (b, s, g, y,
// x, w, x^, reciprocal pivots) and the key's blocks.
template <int DIM, int ORDER>
struct WarpLayout {
  using T = MomentTables<DIM, ORDER>;
  static constexpr int NO = T::NO, NM = T::NM, NT = NO * (NO + 1) / 2;
  static constexpr int M = 0;
  static constexpr int U = (NM + 1) / 2 * 2;
  static constexpr int P = U, Q = P + T::NPP * wlsqm_warp::kLDX;
  static constexpr int OPS = (T::NPP + 16) * wlsqm_warp::kLDX;
  static constexpr int A = U, V = A + NT;
  static constexpr int BASE = U + (OPS > NT + 8 * NO ? OPS : NT + 8 * NO);
  static constexpr int KEY_NEED = NT + 8 * NO + wlsqm_warp::key_scratch<NO>();
  static constexpr int KEY = U + (OPS > KEY_NEED ? OPS : KEY_NEED);
};

template <int DIM, int ORDER, int WEIGHTING>
__global__ void __launch_bounds__(32, 12)
fit_moment_warp(const double* __restrict__ xk, const double* __restrict__ fk,
                const int* __restrict__ nk, const double* __restrict__ xi,
                const double* __restrict__ gi, double* __restrict__ fi,
                int* __restrict__ iters, double* __restrict__ est, int64_t B, int K,
                int64_t knowns, int64_t ldg, int refine_steps, int max_iter) {
  using T = MomentTables<DIM, ORDER>;
  using Lay = WarpLayout<DIM, ORDER>;
  constexpr int NO = T::NO, NM = T::NM, NPP = T::NPP, LD = wlsqm_warp::kLDX;
  constexpr int TP = NPP / 8;  // 8 x 8 tiles of pairs; two of columns
  static_assert(T::kWarp && DIM == 3, "the warp body serves 3D orders 3-4");
  static_assert(3 * ORDER + 2 <= 16, "the z columns fit two tiles");
  extern __shared__ __align__(16) double smem[];
  double* const Ms = smem + Lay::M;
  double* const Pt = smem + Lay::P;
  double* const Qt = smem + Lay::Q;
  double* const A = smem + Lay::A;
  double* const bv = smem + Lay::V;
  double* const sv = bv + NO;
  double* const gv = sv + NO;
  double* const yv = gv + NO;
  double* const xv = yv + NO;
  double* const wv = xv + NO;
  double* const xhv = wv + NO;
  double* const rdv = xhv + NO;
  double* const Y = rdv + NO;

  const int64_t cs = blockIdx.x;
  const int lane = threadIdx.x;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment coordinates
  const int n = min(max(nk[cs], 0), K);
  const double* const xc = xk + cs * (int64_t)K * DIM;
  const double* const fc = fk + cs * (int64_t)K;
  double x0[DIM];
#pragma unroll
  for (int a = 0; a < DIM; ++a) x0[a] = xi[cs * DIM + a];
  auto kn = [knowns](int j) { return ((knowns >> j) & 1LL) != 0; };

  // ---- the scale and CENTER's normaliser, lanes over neighbours ----
  double h2 = 0.0;
  for (int k = lane; k < n; k += 32) h2 = max_nan(h2, unscaled_d2<DIM>(xc, k, x0));
  const double e = scale_exponent(wlsqm_warp::warp_max_nan(h2));
  const double is = pow2(-e);
  double max_d2 = 1.0;
  if (WEIGHTING == kWeightCenter) {
    double m = 0.0;
    for (int k = lane; k < n; k += 32) {
      double d[DIM];
      offsets<DIM>(xc, k, x0, is, d);
      m = fmax(m, sq<DIM>(d));
    }
    m = wlsqm_warp::warp_max(m);
    max_d2 = m > 0.0 ? m : 1.0;
  }

  // ---- the moments and the RHS as one product on the FP64 tensor cores:
  //      D[(a, b)][c] = sum_k (dx^a dy^b)_k (w dz^c)_k, and with w f dz^c
  //      the RHS; each lane writes its neighbour's pair products and z
  //      columns (zeros past nk), the mma adds its products in neighbour
  //      order with one rounding each, so every sum is the fma chain
  //      fma(dx^a dy^b, w dz^c, M) of the thread body ----
  double acc[TP][2][2];
#pragma unroll
  for (int ti = 0; ti < TP; ++ti)
#pragma unroll
    for (int tj = 0; tj < 2; ++tj) acc[ti][tj][0] = acc[ti][tj][1] = 0.0;
#pragma unroll 1
  for (int k0 = 0; k0 < n; k0 += 32) {
    __syncwarp();
    {
      double px[2 * ORDER + 1], py[2 * ORDER + 1], pz[2 * ORDER + 1], pf[ORDER + 1];
      const bool live = k0 + lane < n;
      if (live) {
        double d[DIM];
        offsets<DIM>(xc, k0 + lane, x0, is, d);
        const double w = weight<DIM, WEIGHTING>(d, max_d2);
        px[0] = 1.0, py[0] = 1.0, pz[0] = w, pf[0] = w * fc[k0 + lane];
#pragma unroll
        for (int q = 1; q <= 2 * ORDER; ++q) {
          px[q] = px[q - 1] * d[0];
          py[q] = py[q - 1] * d[1];
          pz[q] = pz[q - 1] * d[2];
        }
#pragma unroll
        for (int q = 1; q <= ORDER; ++q) pf[q] = pf[q - 1] * d[2];
      }
#pragma unroll
      for (int p = 0; p < NPP; ++p)
        Pt[p * LD + lane] = live && p < (2 * ORDER + 1) * (2 * ORDER + 2) / 2
                                ? px[T::pa(p)] * py[T::pb(p)]
                                : 0.0;
#pragma unroll
      for (int c = 0; c < 16; ++c)
        Qt[c * LD + lane] = !live            ? 0.0
                            : c <= 2 * ORDER ? pz[c]
                            : c <= 3 * ORDER + 1 ? pf[c - 2 * ORDER - 1]
                                                 : 0.0;
    }
    __syncwarp();
    const int steps = (min(32, n - k0) + 3) / 4;
#pragma unroll 1
    for (int st = 0; st < steps; ++st) {
      const int k = 4 * st + t4;
      double bq[2];
#pragma unroll
      for (int tj = 0; tj < 2; ++tj) bq[tj] = Qt[(8 * tj + g) * LD + k];
#pragma unroll
      for (int ti = 0; ti < TP; ++ti) {
        const double ap = Pt[(8 * ti + g) * LD + k];
#pragma unroll
        for (int tj = 0; tj < 2; ++tj) wlsqm_warp::mma_8x8x4(acc[ti][tj], ap, bq[tj]);
      }
    }
  }
  __syncwarp();  // the operands are read: the matrix and the vectors take their place
#pragma unroll
  for (int ti = 0; ti < TP; ++ti)
#pragma unroll
    for (int tj = 0; tj < 2; ++tj)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int at = T::pc_at((8 * ti + g) * 16 + 8 * tj + 2 * t4 + q);
        if (at < NM) Ms[at] = acc[ti][tj][q];
        else if (at < NM + NO) bv[at - NM] = acc[ti][tj][q];
      }
  for (int j = lane; j < NO; j += 32)
    gv[j] = kn(j) ? scaled_known(gi, cs * ldg + j, T::fact_at(j), T::deg_at(j), e) : 0.0;
  __syncwarp();

  // ---- the known values through the moments, the Jacobi scale (1 for a
  //      known DOF), and the scaled matrix with identity rows and columns ----
  for (int m = lane; m < NO; m += 32) {
    if (!kn(m) && knowns != 0) {
      double bm = bv[m];
      for (int j = 0; j < NO; ++j)
        if (kn(j)) bm = bm - gv[j] * Ms[T::slot_at(j * NO + m)];
      bv[m] = bm;
    }
    const double dmm = Ms[T::slot_at(m * NO + m)];
    sv[m] = kn(m) ? 1.0 : dmm > 0.0 ? 1.0 / sqrt(dmm) : 1.0;
  }
  __syncwarp();
  for (int i = lane; i < NO; i += 32) {
    const double si = sv[i];
    for (int m = 0; m <= i; ++m)
      A[lt(i, m)] = kn(i) || kn(m) ? (i == m ? 1.0 : 0.0)
                                   : Ms[T::slot_at(m * NO + i)] * (sv[m] * si);
  }
  __syncwarp();
  // the key's first factor: the max abs row sum of the full symmetric
  // scaled matrix (NaN kept), taken before the factor overwrites it
  double ninf = 0.0;
  if constexpr (kEmitCond) {
    for (int j = lane; j < NO; j += 32) {
      double rs = 0.0;
      for (int m = 0; m < NO; ++m) rs += fabs(A[m <= j ? lt(j, m) : lt(m, j)]);
      ninf = max_nan(ninf, rs);
    }
    ninf = wlsqm_warp::warp_max_nan(ninf);
  }

  // ---- Cholesky in place by panels of 8 columns (the trailing tiles on the
  //      tensor cores); the key from the factor ----
  wlsqm_warp::chol_panels<NO>(A, rdv, lane);
  if constexpr (kEmitCond) {
    const double f2 = wlsqm_warp::warp_sum(wlsqm_warp::inv_frob2_blocked<NO>(A, rdv, Y, lane));
    double amp = 1.0;
#pragma unroll
    for (int o = 0; o < ORDER; ++o) amp *= fmax(is, 1.0);
    if (lane == 0) est[cs] = ninf * sqrt(f2) * amp;
  }

  // ---- solve in the scaled space, then sweep through the moments:
  //      y += solve(s (b - A (s y))), lanes over rows; a known DOF's row has
  //      a zero right-hand side ----
  for (int j = lane; j < NO; j += 32) yv[j] = kn(j) ? 0.0 : bv[j] * sv[j];
  __syncwarp();
  wlsqm_warp::chol_solve_warp<NO>(A, rdv, yv, lane);
  auto sweep = [&]() {
    for (int m = lane; m < NO; m += 32) wv[m] = yv[m] * sv[m];
    __syncwarp();
    for (int j = lane; j < NO; j += 32) {
      double acc = 0.0;
      for (int m = 0; m < NO; ++m)
        if (!kn(m)) acc = fma(Ms[T::slot_at(j * NO + m)], wv[m], acc);
      xv[j] = kn(j) ? 0.0 : (bv[j] - acc) * sv[j];
    }
    __syncwarp();
    wlsqm_warp::chol_solve_warp<NO>(A, rdv, xv, lane);
    for (int j = lane; j < NO; j += 32) yv[j] += xv[j];
    __syncwarp();
  };
#pragma unroll 1
  for (int it = 0; it < refine_steps; ++it) sweep();

  // ---- ALGO_ITERATIVE: corrective refits, each one sweep, until the l-inf
  //      norm of the data residual repeats exactly; lanes over neighbours ----
  if (max_iter > 0) {
    bool done = false;
    double prev = -1.0;
    int itn = 0;
#pragma unroll 1
    for (int it = 0; it < max_iter && !done; ++it) {
      for (int j = lane; j < NO; j += 32) xhv[j] = kn(j) ? gv[j] : yv[j] * sv[j];
      __syncwarp();
      double nrm = 0.0;
#pragma unroll 1
      for (int k = lane; k < n; k += 32) {
        double d[DIM], cr[NO];
        offsets<DIM>(xc, k, x0, is, d);
        basis_row<DIM, ORDER>(d, cr);
        double m = 0.0;
#pragma unroll
        for (int j = 0; j < NO; ++j) m = fma(cr[j], xhv[j], m);
        nrm = fmax(nrm, fabs(fc[k] - m));
      }
      nrm = wlsqm_warp::warp_max(nrm);
      done = nrm == prev;
      if (!done) {
        sweep();
        ++itn;
      }
      prev = nrm;
    }
    if (lane == 0) iters[cs] = itn;
  }

  // ---- the de-scale in the store; a known DOF gets fi_init's bits ----
  for (int j = lane; j < NO; j += 32)
    fi[cs * NO + j] = kn(j) ? (gi != nullptr ? gi[cs * ldg + j] : 0.0)
                            : (yv[j] * sv[j]) * (T::fact_at(j) * pow2(-e * T::deg_at(j)));
}

// the fit's scale alone: e and inv_s per case, from case_h2 and
// scale_exponent exactly as the thread body computes them
__global__ void __launch_bounds__(kTB)
moment_scale(const double* __restrict__ xk, const int* __restrict__ nk,
             const double* __restrict__ xi, double* __restrict__ e_out,
             double* __restrict__ inv_s_out, int64_t B, int K) {
  const int64_t c = (int64_t)blockIdx.x * kTB + threadIdx.x;
  if (c >= B) return;
  const int n = min(max(nk[c], 0), K);
  double x0[kDim];
#pragma unroll
  for (int a = 0; a < kDim; ++a) x0[a] = xi[kDim * c + a];
  const double e = scale_exponent(case_h2<kDim>(xk + c * (int64_t)K * kDim, n, x0));
  e_out[c] = e;
  inv_s_out[c] = pow2(-e);
}

struct Args {
  const double *xk, *fk;
  const int* nk;
  const double *xi, *gi;
  double* fi;
  int* iters;
  double* est;
  int64_t B;
  int K;
  int64_t knowns, ldg;
  int refine_steps, max_iter;
};

template <int ORDER, int WEIGHTING, bool EXT>
int launch_thread(const Args& a, cudaStream_t stream) {
  auto kernel = fit_moment_thread<kDim, ORDER, WEIGHTING, EXT>;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t slab = sizeof(double) * kTB * (size_t)(((kDim * a.K) | 1) + (a.K | 1));
  const int staged = slab <= (size_t)optin;
  const size_t lay = Layout<kDim, ORDER>::kBytes;
  const size_t bytes = staged && slab > lay ? slab : lay;
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)((a.B + kTB - 1) / kTB), kTB, bytes, stream>>>(
      a.xk, a.fk, a.nk, a.xi, a.gi, a.fi, a.iters, a.est, a.B, a.K, a.knowns, a.ldg,
      a.refine_steps, a.max_iter, staged);
  return (int)cudaGetLastError();
}

template <int ORDER, int WEIGHTING>
int launch_warp(const Args& a, cudaStream_t stream) {
  using Lay = WarpLayout<kDim, ORDER>;
  auto kernel = fit_moment_warp<kDim, ORDER, WEIGHTING>;
  const int bytes = 8 * (kEmitCond ? Lay::KEY : Lay::BASE);
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  if (a.B > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)a.B, 32, bytes, stream>>>(a.xk, a.fk, a.nk, a.xi, a.gi, a.fi, a.iters,
                                               a.est, a.B, a.K, a.knowns, a.ldg,
                                               a.refine_steps, a.max_iter);
  return (int)cudaGetLastError();
}

// the instance of (ORDER, WEIGHTING): the warp body where the tables say so;
// else the thread body, in 2D without knowns and ALGO_ITERATIVE unless ext
template <int ORDER, int WEIGHTING>
int launch(const Args& a, bool ext, cudaStream_t st) {
  if constexpr (MomentTables<kDim, ORDER>::kWarp) {
    return launch_warp<ORDER, WEIGHTING>(a, st);
  } else if constexpr (kDim == 2) {
    return ext ? launch_thread<ORDER, WEIGHTING, true>(a, st)
               : launch_thread<ORDER, WEIGHTING, false>(a, st);
  } else {
    return launch_thread<ORDER, WEIGHTING, true>(a, st);
  }
}

int dispatch(const Args& a, int order, int weighting, bool ext, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool center = weighting == kWeightCenter;
#define WLSQM_CASE(ORD) \
  case ORD:             \
    return center ? launch<ORD, kWeightCenter>(a, ext, st) : launch<ORD, 1>(a, ext, st);
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

// xk (B, K, dim) f64 | fk (B, K) f64 | nk (B,) i32 | xi (B, dim) f64 |
// gi: the known values, fi_init's rows at stride ldg (unit column stride), or
// null (known values 0) -> fi (B, NO) f64 in the reference's DOF convention
// (known DOFs: gi's bits) | iters (B,) i32, written when max_iter > 0 | est
// (B,) f64, the key with its radius amplification: given exactly when the
// library was built with WLSQM_EMIT_COND=1, else null.  dim must be this
// library's; knowns bits at or past NO are ignored; ext asks the 2D thread
// body's instance with knowns and ALGO_ITERATIVE (taken anyway where either
// is asked).
extern "C" int wlsqm_fit_moment(const void* xk, const void* fk, const void* nk,
                                const void* xi, const void* gi, void* fi, void* iters,
                                void* est, int64_t B, int K, int dim, int order,
                                int weighting, int64_t knowns, int64_t ldg, int refine_steps,
                                int max_iter, int ext, void* stream) {
  if ((est != nullptr) != kEmitCond) return (int)cudaErrorInvalidValue;
  if (max_iter > 0 && iters == nullptr) return (int)cudaErrorInvalidValue;
  if (dim != kDim || order < 0 || order > 4) return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaSuccess;
  if (K <= 0 || refine_steps < 0 || max_iter < 0) return (int)cudaErrorInvalidValue;
  const int no = dim == 1 ? order + 1 : dim == 2 ? (order + 1) * (order + 2) / 2
                                                 : (order + 1) * (order + 2) * (order + 3) / 6;
  const int64_t kmask = knowns & ((1LL << no) - 1);
  const Args a{(const double*)xk, (const double*)fk, (const int*)nk, (const double*)xi,
               (const double*)gi, (double*)fi, (int*)iters, (double*)est, B, K, kmask,
               ldg, refine_steps, max_iter};
  return dispatch(a, order, weighting, ext != 0 || kmask != 0 || max_iter > 0, stream);
}

// xk (B, K, dim) | nk (B,) | xi (B, dim) -> e (B,), inv_s (B,): the fit's scale
extern "C" int wlsqm_moment_scale(const void* xk, const void* nk, const void* xi, void* e,
                                  void* inv_s, int64_t B, int K, int dim, void* stream) {
  if (dim != kDim) return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaSuccess;
  moment_scale<<<(unsigned)((B + kTB - 1) / kTB), kTB, 0, (cudaStream_t)stream>>>(
      (const double*)xk, (const int*)nk, (const double*)xi, (double*)e, (double*)inv_s, B, K);
  return (int)cudaGetLastError();
}

#if WLSQM_MOMENT_VARIANTS
#include "fit_moment_variants.cuh"
#endif
