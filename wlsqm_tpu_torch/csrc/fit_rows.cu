// Rows-body WLSQM fit, FP64 (Hopper, sm_90a): a thread body for the small
// systems and a warp body, one warp per case, on the FP64 tensor cores.
//
// Replaces the TPU kernel wlsqm_tpu/ops/pallas_fit.py:901 (_make_kernel,
// the rows body, launched by fit_pallas at l.1502).  That kernel computes
// in f32 pairs because the TPU has no f64; the H100 has native FP64, so
// this one computes in double and is held to the f64 engine.
//
// Per case: offsets d = (xk - xi) * inv_s (inv_s an exact power of two from
// the wrapper); weights (UNIFORM, or CENTER = a + b (1 - sqrt(d2 / max d2))^2);
// plain monomial basis rows c_kj from the power ladder d, d^2, d^2 d, d^2 d^2;
// known DOFs eliminated (fkeff = fk - sum_known g_j c_kj, identity rows and
// columns, zero RHS); A = C^T W C; Jacobi scale; Cholesky in place with the
// pivot guard max(acc, 1e-30); one solve and refine_steps residual sweeps
// through the rows.  Then, at run time: max_iter > 0 runs ALGO_ITERATIVE
// corrective refits with the reference's exact l-inf stagnation rule (a
// known DOF is never updated) and writes the per-case count; a non-null
// sens gets, per neighbour, one solve and refine_steps sweeps from the
// initial factor.  Neighbours k >= nk are never read (padded slots may hold
// NaN); their sens rows are 0.  The wrapper applies the f64 de-scale,
// restores known fi and writes NaN into known sens columns.
//
// Built with -DWLSQM_EMIT_COND=1 the kernel also writes the per-case
// conditioning key, replacing _cond_estimate (pallas_fit.py:382) and
// _cond_inv_f2 (l.412), the emit_cond output of that kernel (l.1067-1068):
// est = ||A_jac||_inf * ||A_jac^-1||_F >= cond_2(A_jac) of the scaled matrix
// with its identity rows for the known DOFs.  The row sums are taken before
// the Cholesky overwrites the matrix; the inverse's norm comes from the
// factor (the thread body: one unit column e_i at a time; the warp body:
// L^-1 by 8 x 8 blocks on the tensor cores).  The wrapper folds in the radius
// amplification max(inv_s, 1)^order.  A collapsed neighbourhood meets the
// pivot guard, so its key is huge or non-finite and compares False against
// any edge.  The key is a second library of the same source.  Both are
// compiled with -fmad=false and every fused multiply-add is written out as
// fma() (the tensor-core products are explicit mma): the compiler contracts
// nothing on its own, so every other output is the same bits with and
// without the key, and every reduction runs in a fixed order (shuffle
// trees and tiles, no atomics), so a launch gives the same bits each time.
//
// Bound on this card (data sheet: 3.35 TB/s; 67 TFLOP/s FP64 peak, on the
// tensor cores), counting each neighbour's basis row once:
//   sens path, 2D order 4, K = 30 (NO = 15): in 748 B + out 3,720 B per case
//     (sens alone 3,600 B: 7.5 GB at 2^21 cases), ~1e5 flops per case --
//     bound by FP64 operations, ~3 ms at 2^21 (bytes 2.8 ms);
//   dim3 path, 3D order 4, K = 48 (NO = 35): in 1,564 B + out 280 B per
//     case, ~1e5 flops (assembly 48 x 630 multiply-adds, Cholesky ~7 k,
//     one sweep) -- bound by FP64 operations, ~3 ms at 2^21.
// What the design does about it.  One thread per case keeps a packed factor
// of NO (NO + 1) / 2 doubles; above a few hundred that lives in local memory
// (at NO = 35 the thread body measured 0.35% of its bound), and each
// thread's strided xk reads and K x NO sens writes do not coalesce.  So the
// instances with NO >= RowsTables<>::kWarp's cut (ops/fit_rows.WARP_MIN_NO)
// run the warp body, one warp (one 32-thread block) per case, its state in
// shared memory (RowsTables<>::kSmem*, independent of K):
//   * neighbours in chunks of 32, one per lane: offsets, CENTER's max d^2
//     (a shuffle max) and the basis rows, weights and fkeff of the chunk in
//     shared memory, rows k >= nk and the padding written as exact zeros;
//   * A and b as the lower 8 x 8 tiles of [C fkeff]^T W [C fkeff] with
//     mma.m8n8k4 FP64 (column NO of the padded rows carries fkeff, so row
//     NO of the product is b), accumulated over the chunks;
//   * Jacobi scale, the key's row sums, then the Cholesky by panels of 8
//     columns: column by column with lanes over rows inside a panel, the
//     trailing lower tiles updated on the tensor cores.  The FP64 mma adds
//     its four products in order, each with one rounding, as an fma chain
//     does: the panels and the tensor-core sweeps below gave the same bits
//     as column-by-column loops on an H100, in less time (PERF.md);
//   * single right-hand sides solved with lanes over rows and a shuffle per
//     pivot; the sweeps' C x and C^T (W C x) on the tensor cores, and
//     ALGO_ITERATIVE's residuals with lanes over neighbours, from the
//     chunk's rows in shared memory (rebuilt for chunks that are not
//     resident); the residual max is a shuffle max;
//   * the key as ||Z^T Z||_F with Z = L^-1 in 8 x 8 blocks: the diagonal
//     blocks by lane, the rest and Z^T Z as mma products;
//   * the sensitivities with lanes over right-hand-side columns (32
//     neighbours' (W C)^T s at a time as one multi-RHS solve),
//     the sweeps' C (s Y) and C^T (W T) on the tensor cores, and each
//     case's (K, NO) sens block written by consecutive lanes to
//     consecutive addresses.
// The thread body stays for the small systems (NO below the cut), its loops
// unrolled.  Its launch on the adjoint step (2D order 2, K = 12, do_sens,
// 2^20 cases: 0.99 GB moved, 0.29 ms at 3.35 TB/s) is bound in practice by
// chains of dependent FP64 divisions and multiply-adds: per case 12 sens
// columns, each two triangular solves of 12 divisions and a sweep through
// the K rows (the sens loop took 76% of a case's cycles before this design
// and 61% after; chip_smoke.measure_rows_phases).  The design before rebuilt
// every basis row and weight (a division and a square root each) from its
// own strided xk at every use, 144 times a refinement step of the sens loop.
// Now, with sens, a block of 64 cases stages its xk and fk by coalesced
// cp.async and each case writes its offsets and weights once into shared
// memory; every pass rebuilds its rows from them with a few multiplies; and
// at NO <= 6 the sens loop solves two columns side by side.  Keeping the
// basis rows in shared memory too, or writing the sens blocks out through
// it, was slower on the adjoint shapes (the shared memory cost resident
// warps, the write-out a barrier; PERF.md).
// The arithmetic of every output is the design before's, operation for
// operation: fi, the counts, sens and the key are its bits
// (chip_smoke.measure_rows_paths).  The cut was timed with both
// bodies at NO = 10, 15 and 20 (chip_smoke.measure_rows_cut; NVIDIA H100
// 80GB HBM3, 700 W; PERF.md): without sens the thread body is 3.4x / 2.2x
// faster at NO = 10 (2D / 3D), the warp body 2.2x faster at NO = 15 and
// 4.1x at NO = 20; with sens the warp body is faster from 3D NO = 10 on.
// So WARP_MIN_NO = 11.
//
// Layout: thread body kTB = 64 threads (cases) per block, grid
// ceil(B / 64), dynamic shared memory 8 * 64 * thread_layout().ld bytes,
// the ragged tail's threads keeping the block's barrier; warp body 32
// threads per block, grid B, dynamic shared memory (above 48 KB after
// cudaFuncSetAttribute).  One template instance per
// (DIM, ORDER, WEIGHTING), 30 in all, each compiled as one body only.
// Plain C entry point, loaded with ctypes; launches on the caller's stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "fit_rows_tables.cuh"  // generated from tables.EXPONENTS
#include "warp_chol.cuh"         // the warp body's factor, solves and key

#ifndef WLSQM_EMIT_COND
#define WLSQM_EMIT_COND 0
#endif

#ifndef WLSQM_PHASE_CLOCK
#define WLSQM_PHASE_CLOCK 0
#endif
#ifndef WLSQM_ROWS_NORMS
#define WLSQM_ROWS_NORMS 0
#endif

namespace {

// The trips' norms, a measurement build only (-DWLSQM_ROWS_NORMS=1; no route
// loads it): the thread body writes each ALGO_ITERATIVE trip's l-inf
// residual norm to row cs, column trip, of a (B, max_iter) buffer (set by
// wlsqm_rows_norm_buffer; the trips after the stop are left as they were),
// so that chip_smoke.measure_count_ties can tell an exact-stagnation tie
// from any other count disagreement.
#if WLSQM_ROWS_NORMS
__device__ double* g_norms;
#endif

// The phase clock, a measurement build only (-DWLSQM_PHASE_CLOCK=1; no route
// loads it): each case adds the clock64() cycles of each phase of its fit to
// its row of kPhases counters (zeroed by the caller, set by
// wlsqm_rows_phase_buffer; the warp body's lane 0 counts for its case):
// 0 staging and the CENTER max pass, 1 assembly (and the known DOFs' rows),
// 2 Jacobi scale and Cholesky (the key's row sums included), 3 the key's
// inverse norm, 4 solve and refinement sweeps, 5 ALGO_ITERATIVE, 6 the sens
// loop less its stores, 7 stores (fi, the counts, sens), 8 the whole fit.
// Elsewhere the marks compile to nothing.
constexpr int kPhases = 9;
#if WLSQM_PHASE_CLOCK
__device__ long long* g_phase_clock;
#define WLSQM_CLOCK_START() long long wlsqm_t0 = clock64(), wlsqm_tp = wlsqm_t0
#define WLSQM_CLOCK(slot, cs, on)                                                    \
  do {                                                                               \
    const long long wlsqm_now = clock64();                                           \
    if (on) g_phase_clock[(int64_t)(cs) * kPhases + (slot)] += wlsqm_now - wlsqm_tp; \
    wlsqm_tp = wlsqm_now;                                                            \
  } while (0)
#define WLSQM_CLOCK_END(cs, on)                                                    \
  do {                                                                             \
    if (on) g_phase_clock[(int64_t)(cs) * kPhases + 8] = clock64() - wlsqm_t0;     \
  } while (0)
#else
#define WLSQM_CLOCK_START() \
  do {                      \
  } while (0)
#define WLSQM_CLOCK(slot, cs, on) \
  do {                            \
  } while (0)
#define WLSQM_CLOCK_END(cs, on) \
  do {                          \
  } while (0)
#endif

constexpr bool kEmitCond = WLSQM_EMIT_COND != 0;  // this library writes the key
constexpr int kWeightCenter = 2;  // defs.WEIGHT_CENTER
constexpr double kAlpha = 1e-4;   // reference: wlsqm/fitter/infra.pyx:45-46
constexpr double kBeta = 1.0 - 1e-4;

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

// x[p] <- (L L^T)^-1 x[p] for P right-hand sides side by side: each one's
// arithmetic is chol_solve's, the P chains independent of each other
template <int P, int NO, int U>
__device__ __forceinline__ void chol_solve_n(const double* L, double (&x)[P][NO]) {
#pragma unroll (U)
  for (int i = 0; i < NO; ++i) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      double t = x[p][i];
#pragma unroll (U)
      for (int q = 0; q < i; ++q) t = fma(-L[lt(i, q)], x[p][q], t);
      x[p][i] = t / L[lt(i, i)];
    }
  }
#pragma unroll (U)
  for (int i = NO - 1; i >= 0; --i) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      double t = x[p][i];
#pragma unroll (U)
      for (int q = i + 1; q < NO; ++q) t = fma(-L[lt(q, i)], x[p][q], t);
      x[p][i] = t / L[lt(i, i)];
    }
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

  // the basis row c of offsets d, from per-axis power ladders
  static __device__ __forceinline__ void basis(const double (&d)[DIM], double (&c)[NO]) {
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
  }

  // the weight of offsets d
  __device__ __forceinline__ double weight(const double (&d)[DIM]) const {
    if (WEIGHTING != kWeightCenter) return 1.0;
    const double t = 1.0 - sqrt(sq(d) / max_d2);
    return fma(kBeta * t, t, kAlpha);
  }

  // basis row c of neighbour k; returns its weight
  __device__ __forceinline__ double row(int k, double (&c)[NO]) const {
    double d[DIM];
    offsets(k, d);
    basis(d, c);
    return weight(d);
  }
};

// The thread body's cases a block, and the shared memory its layout may
// take a block (measured on the H100 against 25, 64 and 8 KB budgets, 128
// cases a block and one or four sens columns: PERF.md).
constexpr int kTB = 64;
constexpr int kSmemBudget = 128 * 1024;
constexpr int kPlainTB = 128;  // cases a block of the instance that stages nothing
static_assert(kSmemBudget <= 227 * 1024, "more shared memory than a block may have");

// Sens columns a thread of the thread body solves side by side where NO is
// small: independent chains of dependent divisions and multiply-adds, with
// one row read for all of them.
__host__ __device__ constexpr int sens_cols(int no) {
  return no <= 6 ? 2 : 1;
}

// The thread body's shared memory, one case's slice of ld doubles (odd, so
// that a warp's 32 cases read their slices without bank conflicts), for K
// neighbours: the offsets (K, DIM), staged as xk and overwritten in place,
// fk (K) and the weights (K), when they fit the budget (else ld = 0).  A
// launch with sens and ld > 0 runs the staged instance; the rest run the
// instance that stages nothing (every pass reads xk and fk from global
// memory and rebuilds each row, the design before: without sens the few
// passes over the rows do not repay the staging).  The basis rows are not
// kept: each use rebuilds its row from the offsets and weight with a few
// multiplies, and the shared memory the rows would take cost more resident
// warps than it saved (PERF.md).
__host__ __device__ inline int thread_layout(int dim, int K) {
  const long long base = (long long)K * (dim + 2);
  return base > kSmemBudget / (8 * kTB) - 1 ? 0 : (int)(base | 1);
}

// an 8-byte asynchronous copy from global to shared memory
__device__ __forceinline__ void cp_async8(double* s, const double* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(s)),
               "l"(g)
               : "memory");
}

// The thread body: one case a thread.  Its arithmetic is the design
// before's, operation for operation (so fi, the counts, sens and the key are
// the same bits); what changed, in the STAGED instance (kTB cases a block),
// is where each neighbour's values come from (thread_layout): the block's xk
// and fk slabs, contiguous in global memory, are copied into shared memory
// by coalesced 8-byte cp.async; each case then writes its offsets in place of
// its xk and its weights there once, and every pass (assembly, sweeps, the
// ALGO_ITERATIVE trips, the sens loop's solves and sweeps) builds its rows
// from them.  In both instances the sens loop solves sens_cols() columns
// side by side.
template <int DIM, int ORDER, int WEIGHTING, bool STAGED>
__global__ void __launch_bounds__(STAGED ? kTB : kPlainTB)
fit_rows_thread(const double* __restrict__ xk, const double* __restrict__ fk,
                const int* __restrict__ nk, const double* __restrict__ xi,
                const double* __restrict__ inv_s, const double* __restrict__ ghat,
                double* __restrict__ fi, int* __restrict__ iters,
                double* __restrict__ sens, double* __restrict__ est, int64_t B, int K,
                int64_t knowns, int refine_steps, int max_iter, int ld) {
  using H = Hood<DIM, ORDER, WEIGHTING>;
  constexpr int NO = H::NO;
  constexpr int NT = NO * (NO + 1) / 2;
  constexpr int U = NT;  // >= every trip count below: the loops unroll fully
  static_assert(!RowsTables<DIM, ORDER>::kWarp, "a warp-body instance");
  extern __shared__ __align__(16) double smem[];
  constexpr int TB = STAGED ? kTB : kPlainTB;
  const int tid = threadIdx.x;
  const int64_t c0 = (int64_t)blockIdx.x * TB, cs = c0 + tid;
  const bool valid = cs < B;  // the rest of the last staged block only keeps its barrier
  if (!STAGED && !valid) return;
  WLSQM_CLOCK_START();

  // ---- the block's slabs of xk and fk into shared memory ----
  H h;
  h.xc = xk + (valid ? cs : 0) * (int64_t)K * DIM;
  const double* fc = fk + (valid ? cs : 0) * (int64_t)K;
  double *dv = nullptr, *wv = nullptr;  // offsets (K, DIM) and weights (K)
  if constexpr (STAGED) {
    double* const my = smem + (int64_t)tid * ld;
    dv = my;
    wv = my + K * (DIM + 1);
    const int cnt = (int)min((int64_t)kTB, B - c0);
    const double* gx = xk + c0 * K * DIM;
    for (int g = tid; g < cnt * K * DIM; g += kTB)
      cp_async8(smem + (int64_t)(g / (DIM * K)) * ld + g % (DIM * K), gx + g);
    const double* gf = fk + c0 * K;
    for (int g = tid; g < cnt * K; g += kTB)
      cp_async8(smem + (int64_t)(g / K) * ld + K * DIM + g % K, gf + g);
    asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::: "memory");
    h.xc = my;
    fc = my + K * DIM;
    __syncthreads();
  }

  const int n = valid ? min(max(nk[cs], 0), K) : 0;
#pragma unroll
  for (int a = 0; a < DIM; ++a) h.x0[a] = valid ? xi[cs * DIM + a] : 0.0;
  h.is = valid ? inv_s[cs] : 1.0;
  h.max_d2 = 1.0;
  // offsets once (in place of xk when staged), and CENTER's max d^2
  if (WEIGHTING == kWeightCenter || STAGED) {
    double m = 0.0;
#pragma unroll 1
    for (int k = 0; k < n; ++k) {
      double d[DIM];
      h.offsets(k, d);
      if constexpr (STAGED) {
#pragma unroll
        for (int a = 0; a < DIM; ++a) dv[k * DIM + a] = d[a];
      }
      if (WEIGHTING == kWeightCenter) m = fmax(m, H::sq(d));
    }
    if (WEIGHTING == kWeightCenter) h.max_d2 = m > 0.0 ? m : 1.0;
  }
  // the weights, once
  if constexpr (STAGED) {
#pragma unroll 1
    for (int k = 0; k < n; ++k) {
      double d[DIM];
#pragma unroll
      for (int a = 0; a < DIM; ++a) d[a] = dv[k * DIM + a];
      wv[k] = h.weight(d);
    }
  }
  WLSQM_CLOCK(0, cs, valid);

  // basis row c of neighbour k and its weight: from the offsets and weights
  // in shared memory, or from xk
  auto row = [&](int k, double (&c)[NO]) -> double {
    if constexpr (STAGED) {
      double d[DIM];
#pragma unroll
      for (int a = 0; a < DIM; ++a) d[a] = dv[k * DIM + a];
      H::basis(d, c);
      return wv[k];
    } else {
      return h.row(k, c);
    }
  };
  // ax[p] = (C^T W C) sx[p] over the valid neighbours (a sweep "through the
  // rows"), for P vectors side by side
  auto matvec_n = [&](auto& sx, auto& ax) {
    constexpr int P = sizeof(sx) / sizeof(sx[0]);
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int j = 0; j < NO; ++j) ax[p][j] = 0.0;
#pragma unroll 1
    for (int k = 0; k < n; ++k) {
      double c[NO];
      const double w = row(k, c);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        double t = 0.0;
#pragma unroll
        for (int j = 0; j < NO; ++j) t = fma(c[j], sx[p][j], t);
        t *= w;
#pragma unroll
        for (int j = 0; j < NO; ++j) ax[p][j] = fma(c[j], t, ax[p][j]);
      }
    }
  };

  // known DOFs (bits below NO) and their scaled values
  const int64_t km = ghat != nullptr ? knowns : 0;
  auto known = [km](int j) { return ((km >> j) & 1LL) != 0; };
  double g[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) g[j] = known(j) && valid ? ghat[cs * NO + j] : 0.0;

  // ---- assemble A (packed lower) and b over the valid neighbours ----
  double A[NT], b[NO];
#pragma unroll (U)
  for (int t = 0; t < NT; ++t) A[t] = 0.0;
#pragma unroll
  for (int j = 0; j < NO; ++j) b[j] = 0.0;
#pragma unroll 1
  for (int k = 0; k < n; ++k) {
    double c[NO];
    const double w = row(k, c);
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
  WLSQM_CLOCK(1, cs, valid);

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
  WLSQM_CLOCK(2, cs, valid);
  if constexpr (kEmitCond) {
    const double e = ninf * sqrt(inv_frob2<NO, U>(A));
    if (valid) est[cs] = e;
  }
  WLSQM_CLOCK(3, cs, valid);

  // ---- solve in the scaled space, then sweep: y += solve(s b - s A (s y)) ----
  double y[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) y[j] = b[j] * s[j];
  chol_solve<NO, U>(A, y);
#pragma unroll 1
  for (int it = 0; it < refine_steps; ++it) {
    double sx[1][NO], r[1][NO];
#pragma unroll
    for (int j = 0; j < NO; ++j) sx[0][j] = y[j] * s[j];
    matvec_n(sx, r);
#pragma unroll
    for (int j = 0; j < NO; ++j) r[0][j] = known(j) ? 0.0 : fma(-s[j], r[0][j], b[j] * s[j]);
    chol_solve<NO, U>(A, r[0]);
#pragma unroll
    for (int j = 0; j < NO; ++j) y[j] += r[0][j];
  }
  double xh[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) xh[j] = known(j) ? g[j] : y[j] * s[j];
  WLSQM_CLOCK(4, cs, valid);

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
        const double w = row(k, c);
        double m = 0.0;
#pragma unroll
        for (int j = 0; j < NO; ++j) m = fma(c[j], xh[j], m);
        const double r = fc[k] - m;
        nrm = fmax(nrm, fabs(r));
#pragma unroll
        for (int j = 0; j < NO; ++j) bp[j] = fma(c[j] * w, r, bp[j]);
      }
      done = nrm == prev;
#if WLSQM_ROWS_NORMS
      if (valid) g_norms[cs * max_iter + it] = nrm;
#endif
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
    WLSQM_CLOCK(5, cs, valid);
    if (valid) iters[cs] = itn;
  }

  if (valid) {
    double* out = fi + cs * NO;
#pragma unroll
    for (int j = 0; j < NO; ++j) out[j] = xh[j];
  }
  WLSQM_CLOCK(7, cs, valid);

  // ---- sensitivities: one column of A^-1 C^T W per neighbour, each with
  //      the DOFs' solve and sweeps (reference: wlsqm/fitter/impl.pyx:768-846),
  //      P columns side by side ----
  if (sens == nullptr) {
    WLSQM_CLOCK_END(cs, valid);
    return;
  }
  double* const so = sens + (valid ? cs : 0) * (int64_t)K * NO;
  constexpr int P = sens_cols(NO);
#pragma unroll 1
  for (int k = 0; k < K; k += P) {
    // columns k .. k + P - 1 side by side; past n (or past K) a column
    // solves zeros and is written as 0 (or not at all)
    double bk[P][NO], yk[P][NO];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      double c[NO];
      double w = 0.0;
      if (k + p < n) {
        w = row(k + p, c);
      } else {
#pragma unroll
        for (int j = 0; j < NO; ++j) c[j] = 0.0;
      }
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        bk[p][j] = known(j) ? 0.0 : (c[j] * w) * s[j];
        yk[p][j] = bk[p][j];
      }
    }
    chol_solve_n<P, NO, U>(A, yk);
#pragma unroll 1
    for (int it = 0; it < refine_steps; ++it) {
      double sy[P][NO], r[P][NO];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int j = 0; j < NO; ++j) sy[p][j] = yk[p][j] * s[j];
      matvec_n(sy, r);
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int j = 0; j < NO; ++j) r[p][j] = known(j) ? 0.0 : fma(-s[j], r[p][j], bk[p][j]);
      chol_solve_n<P, NO, U>(A, r);
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int j = 0; j < NO; ++j) yk[p][j] += r[p][j];
    }
    WLSQM_CLOCK(6, cs, valid);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int kk = k + p;
      if (kk >= K) break;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const double v = kk < n ? yk[p][j] * s[j] : 0.0;
        if (valid) __stcs(so + (int64_t)kk * NO + j, v);
      }
    }
    WLSQM_CLOCK(7, cs, valid);
  }
  WLSQM_CLOCK_END(cs, valid);
}

// ---------------------------------------------------------------------------
// The warp body: one warp (one block of 32 threads) per case
// ---------------------------------------------------------------------------

using wlsqm_warp::chol_panels;
using wlsqm_warp::chol_solve_cols;
using wlsqm_warp::chol_solve_warp;
using wlsqm_warp::inv_frob2_blocked;
using wlsqm_warp::kFull;
using wlsqm_warp::kKC;
using wlsqm_warp::kLDX;
using wlsqm_warp::mma_8x8x4;
using wlsqm_warp::warp_max;
using wlsqm_warp::warp_max_nan;
using wlsqm_warp::warp_sum;

// Shared-memory layout of one case, in doubles (RowsTables<>::kSmem* hold
// the same sums in bytes, generated by ops/fit_rows.warp_smem_bytes).
template <int NO>
struct WarpLayout {
  static constexpr int NP = (NO / 8 + 1) * 8;  // padded DOFs: column NO carries fkeff
  static constexpr int LDC = NP + 4;           // basis row stride (conflict-free fragments)
  static constexpr int NT = NO * (NO + 1) / 2;
  static constexpr int C = 0;                      // basis rows of the chunk (kKC, LDC)
  static constexpr int KV = C + kKC * LDC;         // w, fkeff, fk, t of the chunk
  static constexpr int A = KV + 4 * kKC;           // packed lower matrix, then factor
  static constexpr int V = A + (NT + 1) / 2 * 2;   // 8 vectors of NP
  static constexpr int BASE = V + 8 * NP;
  static constexpr int XB = NP * kLDX;             // one right-hand-side buffer
  static constexpr int KEY = BASE + XB;            // the key: Y
  static constexpr int SENS = BASE + 3 * XB + kKC * kLDX;  // sens: Y, Bk, R, T
  static_assert(wlsqm_warp::key_scratch<NO>() <= XB, "the key's blocks and products fit in Y");
};

// At most 168 registers a thread, so that eleven cases share an SM: as many
// as 3D order 4's shared memory allows (without the cap ptxas takes 254 and
// eight fit).  ptxas then spills a few hundred bytes a thread at 3D order 4
// (chip_smoke.phase_build prints it; PERF.md).
template <int DIM, int ORDER, int WEIGHTING>
__global__ void __launch_bounds__(32, 11)
fit_rows_warp(const double* __restrict__ xk, const double* __restrict__ fk,
              const int* __restrict__ nk, const double* __restrict__ xi,
              const double* __restrict__ inv_s, const double* __restrict__ ghat,
              double* __restrict__ fi, int* __restrict__ iters,
              double* __restrict__ sens, double* __restrict__ est, int64_t B, int K,
              int64_t knowns, int refine_steps, int max_iter) {
  using H = Hood<DIM, ORDER, WEIGHTING>;
  constexpr int NO = H::NO;
  using Lay = WarpLayout<NO>;
  constexpr int NP = Lay::NP, LDC = Lay::LDC, TT = NP / 8;
  constexpr int RPL = (NO + 31) / 32;  // rows (DOFs) per lane
  extern __shared__ double smem[];
  double* const Cs = smem + Lay::C;
  double* const wsv = smem + Lay::KV;
  double* const fev = wsv + kKC;
  double* const frv = fev + kKC;
  double* const tv = frv + kKC;
  double* const A = smem + Lay::A;
  double* const gv = smem + Lay::V;
  double* const sv = gv + NP;
  double* const bv = sv + NP;
  double* const yv = bv + NP;
  double* const xhv = yv + NP;
  double* const wv = xhv + NP;
  double* const rv = wv + NP;
  double* const rdv = rv + NP;  // reciprocal pivots of the factor
  double* const Y = smem + Lay::BASE;
  double* const Bk = Y + Lay::XB;
  double* const RS = Bk + Lay::XB;
  double* const Tm = RS + Lay::XB;

  const int64_t cs = blockIdx.x;
  const int lane = threadIdx.x;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment coordinates
  WLSQM_CLOCK_START();

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
    for (int k = lane; k < n; k += 32) {
      double d[DIM];
      h.offsets(k, d);
      m = fmax(m, H::sq(d));
    }
    m = warp_max(m);
    h.max_d2 = m > 0.0 ? m : 1.0;
  }

  const int64_t km = ghat != nullptr ? knowns : 0;
  auto known = [km](int j) { return ((km >> j) & 1LL) != 0; };
  for (int j = lane; j < NP; j += 32) gv[j] = j < NO && known(j) ? ghat[cs * NO + j] : 0.0;
  __syncwarp();
  WLSQM_CLOCK(0, cs, lane == 0);

  // basis rows, weights, fkeff and fk of neighbours [k0, k0 + kKC) into
  // shared memory, one per lane; rows k >= n and the padding are exact zeros
  int resident = -1;
  auto load_chunk = [&](int k0) {
    if (resident == k0) return;
    __syncwarp();
    const int k = k0 + lane;
    double* row = Cs + lane * LDC;
    if (k < n) {
      double c[NO];
      const double w = h.row(k, c);
      const double f = fc[k];
      double fe = f;
      if (km != 0) {
#pragma unroll
        for (int j = 0; j < NO; ++j)
          if (known(j)) fe = fma(-gv[j], c[j], fe);
      }
#pragma unroll
      for (int j = 0; j < NO; ++j) row[j] = c[j];
      wsv[lane] = w, fev[lane] = fe, frv[lane] = f;
    } else {
#pragma unroll
      for (int j = 0; j < NO; ++j) row[j] = 0.0;
      wsv[lane] = 0.0, fev[lane] = 0.0, frv[lane] = 0.0;
    }
#pragma unroll
    for (int j = NO; j < NP; ++j) row[j] = 0.0;
    resident = k0;
    __syncwarp();
  };

  // ---- A = C^T W C and b = C^T W fkeff on the FP64 tensor cores: the
  //      lower 8 x 8 tiles of [C fkeff]^T W [C fkeff]; row NO holds b ----
  {
    double acc[TT * (TT + 1) / 2][2];
#pragma unroll
    for (int p = 0; p < TT * (TT + 1) / 2; ++p) acc[p][0] = acc[p][1] = 0.0;
#pragma unroll 1
    for (int k0 = 0; k0 < n; k0 += kKC) {
      load_chunk(k0);
      const int steps = (min(kKC, n - k0) + 3) / 4;
#pragma unroll 1
      for (int st = 0; st < steps; ++st) {
        const int k = 4 * st + t4;
        const double wk = wsv[k];
        double av[TT], aw[TT];
#pragma unroll
        for (int ti = 0; ti < TT; ++ti) {
          const int j = 8 * ti + g;
          av[ti] = j == NO ? fev[k] : Cs[k * LDC + j];
          aw[ti] = av[ti] * wk;
        }
        int p = 0;
#pragma unroll
        for (int ti = 0; ti < TT; ++ti)
#pragma unroll
          for (int tj = 0; tj <= ti; ++tj) mma_8x8x4(acc[p++], aw[ti], av[tj]);
      }
    }
    int p = 0;
#pragma unroll
    for (int ti = 0; ti < TT; ++ti)
#pragma unroll
      for (int tj = 0; tj <= ti; ++tj, ++p)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = 8 * ti + g, col = 8 * tj + 2 * t4 + e;
          if (row < NO && col <= row) A[lt(row, col)] = acc[p][e];
          else if (row == NO && col < NO) bv[col] = acc[p][e];
        }
    __syncwarp();
  }

  // known DOFs: identity rows and columns, zero RHS
  if (km != 0) {
    for (int i = lane; i < NO; i += 32) {
      for (int m = 0; m <= i; ++m)
        if (known(i) || known(m)) A[lt(i, m)] = i == m ? 1.0 : 0.0;
      if (known(i)) bv[i] = 0.0;
    }
    __syncwarp();
  }
  WLSQM_CLOCK(1, cs, lane == 0);

  // ---- Jacobi scale ----
  for (int j = lane; j < NO; j += 32) {
    const double djj = A[lt(j, j)];
    sv[j] = djj > 0.0 ? 1.0 / sqrt(djj) : 1.0;
  }
  __syncwarp();
  for (int i = lane; i < NO; i += 32)
    for (int m = 0; m <= i; ++m) A[lt(i, m)] *= sv[i] * sv[m];
  __syncwarp();
  // the key's first factor: max abs row sum of the full symmetric scaled
  // matrix (NaN kept), taken before the factor overwrites it
  double ninf = 0.0;
  if constexpr (kEmitCond) {
    for (int j = lane; j < NO; j += 32) {
      double rs = 0.0;
      for (int m = 0; m < NO; ++m) rs += fabs(A[m <= j ? lt(j, m) : lt(m, j)]);
      ninf = (rs > ninf || rs != rs) ? rs : ninf;
    }
    ninf = warp_max_nan(ninf);
  }

  // ---- Cholesky in place by panels of 8 columns (the trailing tiles on the
  //      tensor cores) ----
  chol_panels<NO>(A, rdv, lane);
  WLSQM_CLOCK(2, cs, lane == 0);

  // ---- the key: ||(L L^T)^-1||_F^2 by 8 x 8 blocks of L^-1 ----
  if constexpr (kEmitCond) {
    const double f2 = warp_sum(inv_frob2_blocked<NO>(A, rdv, Y, lane));
    if (lane == 0) est[cs] = ninf * sqrt(f2);
  }
  WLSQM_CLOCK(3, cs, lane == 0);

  // one sweep through the rows: out = C^T W (C x) for x in shared memory,
  // both products on the tensor cores (x as the first of 8 columns)
  auto matvec = [&](const double* x, double* out) {
    double racc[TT][2];
#pragma unroll
    for (int ti = 0; ti < TT; ++ti) racc[ti][0] = racc[ti][1] = 0.0;
#pragma unroll 1
    for (int k0 = 0; k0 < n; k0 += kKC) {
      load_chunk(k0);
      double tacc[4][2];
#pragma unroll
      for (int ri = 0; ri < 4; ++ri) tacc[ri][0] = tacc[ri][1] = 0.0;
#pragma unroll
      for (int st = 0; st < NP / 4; ++st) {
        const int j = 4 * st + t4;
        const double b = g == 0 && j < NO ? x[j] : 0.0;
#pragma unroll
        for (int ri = 0; ri < 4; ++ri) mma_8x8x4(tacc[ri], Cs[(8 * ri + g) * LDC + j], b);
      }
      if (t4 == 0)
#pragma unroll
        for (int ri = 0; ri < 4; ++ri) tv[8 * ri + g] = tacc[ri][0] * wsv[8 * ri + g];
      __syncwarp();
      const int steps = (min(kKC, n - k0) + 3) / 4;
#pragma unroll 1
      for (int st = 0; st < steps; ++st) {
        const int k = 4 * st + t4;
        const double b = g == 0 ? tv[k] : 0.0;
#pragma unroll
        for (int ti = 0; ti < TT; ++ti) mma_8x8x4(racc[ti], Cs[k * LDC + 8 * ti + g], b);
      }
      __syncwarp();
    }
    if (t4 == 0)
#pragma unroll
      for (int ti = 0; ti < TT; ++ti)
        if (8 * ti + g < NO) out[8 * ti + g] = racc[ti][0];
    __syncwarp();
  };

  // ---- solve in the scaled space, then sweep: y += solve(s b - s A (s y)) ----
  for (int j = lane; j < NO; j += 32) yv[j] = bv[j] * sv[j];
  __syncwarp();
  chol_solve_warp<NO>(A, rdv, yv, lane);
#pragma unroll 1
  for (int it = 0; it < refine_steps; ++it) {
    for (int j = lane; j < NO; j += 32) wv[j] = yv[j] * sv[j];
    __syncwarp();
    matvec(wv, rv);
    for (int j = lane; j < NO; j += 32)
      rv[j] = known(j) ? 0.0 : fma(-sv[j], rv[j], bv[j] * sv[j]);
    __syncwarp();
    chol_solve_warp<NO>(A, rdv, rv, lane);
    for (int j = lane; j < NO; j += 32) yv[j] += rv[j];
    __syncwarp();
  }
  for (int j = lane; j < NO; j += 32) xhv[j] = known(j) ? gv[j] : yv[j] * sv[j];
  __syncwarp();
  WLSQM_CLOCK(4, cs, lane == 0);

  // ---- ALGO_ITERATIVE: corrective refits until the l-inf residual norm
  //      repeats exactly (reference: wlsqm/fitter/impl.pyx:986-1083) ----
  if (max_iter > 0) {
    bool done = false;
    double prev = -1.0;
    int itn = 0;
#pragma unroll 1
    for (int it = 0; it < max_iter && !done; ++it) {
      double bp[RPL];
#pragma unroll
      for (int hh = 0; hh < RPL; ++hh) bp[hh] = 0.0;
      double nrm = 0.0;
#pragma unroll 1
      for (int k0 = 0; k0 < n; k0 += kKC) {
        load_chunk(k0);
        double r = 0.0;
        if (k0 + lane < n) {
          const double* row = Cs + lane * LDC;
          double m = 0.0;
#pragma unroll
          for (int j = 0; j < NO; ++j) m = fma(row[j], xhv[j], m);
          r = frv[lane] - m;
          nrm = fmax(nrm, fabs(r));
        }
        tv[lane] = r;
        __syncwarp();
        const int kc = min(kKC, n - k0);
#pragma unroll
        for (int hh = 0; hh < RPL; ++hh) {
          const int j = lane + 32 * hh;
          if (j < NO)
#pragma unroll 4
            for (int k = 0; k < kc; ++k) bp[hh] = fma(Cs[k * LDC + j] * wsv[k], tv[k], bp[hh]);
        }
        __syncwarp();
      }
      nrm = warp_max(nrm);
      done = nrm == prev;
      if (!done) {
#pragma unroll
        for (int hh = 0; hh < RPL; ++hh) {
          const int j = lane + 32 * hh;
          if (j < NO) rv[j] = known(j) ? 0.0 : bp[hh] * sv[j];
        }
        __syncwarp();
        chol_solve_warp<NO>(A, rdv, rv, lane);
        for (int j = lane; j < NO; j += 32)
          if (!known(j)) xhv[j] = fma(rv[j], sv[j], xhv[j]);
        __syncwarp();
        ++itn;
      }
      prev = nrm;
    }
    WLSQM_CLOCK(5, cs, lane == 0);
    if (lane == 0) iters[cs] = itn;
  }

  for (int j = lane; j < NO; j += 32) fi[cs * NO + j] = xhv[j];
  WLSQM_CLOCK(7, cs, lane == 0);

  // ---- sensitivities: the K right-hand sides (W C)^T s, kKC at a time, as
  //      one multi-RHS solve with lanes over the columns; the sweeps' two
  //      products C (s Y) and C^T (W T) on the tensor cores ----
  if (sens == nullptr) {
    WLSQM_CLOCK_END(cs, lane == 0);
    return;
  }
  double* const so = sens + cs * (int64_t)K * NO;
#pragma unroll 1
  for (int c0 = 0; c0 < K; c0 += kKC) {
    const int ncol = min(kKC, K - c0);
    if (c0 < n) {
      load_chunk(c0);
      {  // column lane: neighbour c0 + lane (zero beyond n: its row is zero)
        const double* row = Cs + lane * LDC;
        const double w = wsv[lane];
        for (int j = 0; j < NP; ++j) {
          const double v = j < NO && !known(j) ? (row[j] * w) * sv[j] : 0.0;
          Bk[j * kLDX + lane] = v;
          Y[j * kLDX + lane] = v;
        }
      }
      __syncwarp();
      chol_solve_cols<NO>(A, rdv, Y, kKC, lane);
#pragma unroll 1
      for (int it = 0; it < refine_steps; ++it) {
        for (int j = 0; j < NP; ++j) RS[j * kLDX + lane] = j < NO ? Y[j * kLDX + lane] * sv[j] : 0.0;
        __syncwarp();
        double racc[TT][4][2];
#pragma unroll
        for (int ti = 0; ti < TT; ++ti)
#pragma unroll
          for (int ci = 0; ci < 4; ++ci) racc[ti][ci][0] = racc[ti][ci][1] = 0.0;
#pragma unroll 1
        for (int k0 = 0; k0 < n; k0 += kKC) {
          load_chunk(k0);
          {  // T = C (s Y) on the chunk's rows, then each row times its weight
            double tacc[4][4][2];
#pragma unroll
            for (int ri = 0; ri < 4; ++ri)
#pragma unroll
              for (int ci = 0; ci < 4; ++ci) tacc[ri][ci][0] = tacc[ri][ci][1] = 0.0;
#pragma unroll
            for (int st = 0; st < NP / 4; ++st) {
              const int j = 4 * st + t4;
              double a[4], b[4];
#pragma unroll
              for (int ri = 0; ri < 4; ++ri) a[ri] = Cs[(8 * ri + g) * LDC + j];
#pragma unroll
              for (int ci = 0; ci < 4; ++ci) b[ci] = RS[j * kLDX + 8 * ci + g];
#pragma unroll
              for (int ri = 0; ri < 4; ++ri)
#pragma unroll
                for (int ci = 0; ci < 4; ++ci) mma_8x8x4(tacc[ri][ci], a[ri], b[ci]);
            }
#pragma unroll
            for (int ri = 0; ri < 4; ++ri)
#pragma unroll
              for (int ci = 0; ci < 4; ++ci)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int row = 8 * ri + g;
                  Tm[row * kLDX + 8 * ci + 2 * t4 + e] = tacc[ri][ci][e] * wsv[row];
                }
          }
          __syncwarp();
          // R += C^T T over the chunk's rows
          const int steps = (min(kKC, n - k0) + 3) / 4;
#pragma unroll 1
          for (int st = 0; st < steps; ++st) {
            const int k = 4 * st + t4;
            double a[TT], b[4];
#pragma unroll
            for (int ti = 0; ti < TT; ++ti) a[ti] = Cs[k * LDC + 8 * ti + g];
#pragma unroll
            for (int ci = 0; ci < 4; ++ci) b[ci] = Tm[k * kLDX + 8 * ci + g];
#pragma unroll
            for (int ti = 0; ti < TT; ++ti)
#pragma unroll
              for (int ci = 0; ci < 4; ++ci) mma_8x8x4(racc[ti][ci], a[ti], b[ci]);
          }
          __syncwarp();
        }
        // r = bk - s (C^T W C)(s y), known rows 0; then y += solve(r)
#pragma unroll
        for (int ti = 0; ti < TT; ++ti)
#pragma unroll
          for (int ci = 0; ci < 4; ++ci)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = 8 * ti + g, col = 8 * ci + 2 * t4 + e;
              RS[j * kLDX + col] = j < NO && !known(j)
                                       ? fma(-sv[j], racc[ti][ci][e], Bk[j * kLDX + col])
                                       : 0.0;
            }
        __syncwarp();
        chol_solve_cols<NO>(A, rdv, RS, kKC, lane);
        for (int j = 0; j < NO; ++j) Y[j * kLDX + lane] += RS[j * kLDX + lane];
        __syncwarp();
      }
    }
    WLSQM_CLOCK(6, cs, lane == 0);
    // the (ncol, NO) block of neighbours c0.., consecutive lanes on
    // consecutive addresses; neighbours k >= n get 0
    double* o = so + (int64_t)c0 * NO;
    for (int f = lane; f < ncol * NO; f += 32) {
      const int k = f / NO, j = f - k * NO;
      o[f] = c0 + k < n ? Y[j * kLDX + k] * sv[j] : 0.0;
    }
    __syncwarp();
    WLSQM_CLOCK(7, cs, lane == 0);
  }
  WLSQM_CLOCK_END(cs, lane == 0);
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
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using T = RowsTables<DIM, ORDER>;
  if constexpr (T::kWarp) {
    using Lay = WarpLayout<T::NO>;
    static_assert(Lay::BASE * 8 == T::kSmemBase && Lay::KEY * 8 == T::kSmemKey &&
                      Lay::SENS * 8 == T::kSmemSens,
                  "warp layout differs from ops/fit_rows.warp_smem_bytes");
    const int bytes = a.sens ? T::kSmemSens : (kEmitCond ? T::kSmemKey : T::kSmemBase);
    auto kern = fit_rows_warp<DIM, ORDER, WEIGHTING>;
    if (bytes > 48 * 1024) {
      const cudaError_t e =
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (e != cudaSuccess) return e;
    }
    if (a.B > 0x7fffffffLL) return cudaErrorInvalidValue;
    kern<<<(unsigned)a.B, 32, bytes, stream>>>(a.xk, a.fk, a.nk, a.xi, a.inv_s, a.ghat,
                                               a.fi, a.iters, a.sens, a.est, a.B, a.K,
                                               a.knowns, a.refine_steps, a.max_iter);
  } else {
    const int ld = thread_layout(DIM, a.K);
    const bool staged = a.sens != nullptr && ld > 0;
    const int tb = staged ? kTB : kPlainTB, bytes = staged ? 8 * kTB * ld : 0;
    auto kern = staged ? fit_rows_thread<DIM, ORDER, WEIGHTING, true>
                       : fit_rows_thread<DIM, ORDER, WEIGHTING, false>;
    if (bytes > 48 * 1024) {
      const cudaError_t e =
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (e != cudaSuccess) return e;
    }
    const int64_t grid = (a.B + tb - 1) / tb;
    if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
    kern<<<(unsigned)grid, tb, bytes, stream>>>(a.xk, a.fk, a.nk, a.xi, a.inv_s, a.ghat, a.fi,
                                                a.iters, a.sens, a.est, a.B, a.K, a.knowns,
                                                a.refine_steps, a.max_iter, ld);
  }
  return cudaSuccess;
}

// the (ORDER, WEIGHTING) instance of one dimension; cudaErrorInvalidValue:
// no such order
template <int DIM>
cudaError_t launch_dim(const Args& a, int order, bool center, cudaStream_t st) {
#define WLSQM_CASE(ORD)                                                        \
  case ORD:                                                                    \
    return center ? launch<DIM, ORD, kWeightCenter>(a, st) : launch<DIM, ORD, 1>(a, st);
  switch (order) {
    WLSQM_CASE(0)
    WLSQM_CASE(1)
    WLSQM_CASE(2)
    WLSQM_CASE(3)
    WLSQM_CASE(4)
    default:
      return cudaErrorInvalidValue;
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
  const cudaError_t e = dim == 1   ? launch_dim<1>(a, order, center, st)
                        : dim == 2 ? launch_dim<2>(a, order, center, st)
                        : dim == 3 ? launch_dim<3>(a, order, center, st)
                                   : cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The thread body's layout for dim and K into out[3]: ld, cases a block,
// the shared-memory budget a block (the card tests read the staging edge
// from it).
extern "C" int wlsqm_rows_thread_layout(int dim, int K, int* out) {
  if (dim < 1 || dim > 3 || K < 0) return (int)cudaErrorInvalidValue;
  out[0] = thread_layout(dim, K), out[1] = kTB, out[2] = kSmemBudget;
  return (int)cudaSuccess;
}

#if WLSQM_PHASE_CLOCK
// the phase clock's counters: (B, kPhases) int64, zeroed by the caller
extern "C" int wlsqm_rows_phase_buffer(void* buf) {
  long long* p = (long long*)buf;
  return (int)cudaMemcpyToSymbol(g_phase_clock, &p, sizeof(p));
}
#endif

#if WLSQM_ROWS_NORMS
// the trips' norms: (B, max_iter) f64 on the card
extern "C" int wlsqm_rows_norm_buffer(void* buf) {
  double* p = (double*)buf;
  return (int)cudaMemcpyToSymbol(g_norms, &p, sizeof(p));
}
#endif
