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
// for 2^23 cases (2.16 ms with max_iter = 3: each trip's residual pass reads
// xk and fk again, but the function needs them once).  At 3D order 4, K = 48
// (NO = 35, NM = 165): in ~1.6 KB, out 280 B per case, ~47 k FP64 operations
// (each x^a y^b product once a neighbour, the moment and RHS sums, the
// Cholesky, two solves and a sweep; chip_smoke._moment_flops): bound by
// operations, 1.47 ms for 2^21 cases.
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
//   Three instances in every dimension: the basic one (the headline), one
//   with knowns (and ALGO_ITERATIVE beside them) and one with ALGO_ITERATIVE
//   alone (the iterative path), so neither's code burdens the others: with
//   the knowns' predicates and values the one 2D instance that had both
//   spilled 804 / 968 bytes and ran every fit phase at 2.25x the basic
//   instance's cycles (its phase clock, PERF.md).  1D and 3D ran that one
//   instance before; split, the 1D basic instance takes 62 registers
//   where it took 118, and on an H100 the dim1 launch (order 4, K = 15,
//   UNIFORM, 2^23) went from 1.31-1.39 to 1.03-1.09 ms, its ALGO_ITERATIVE
//   one from 2.45-2.53 to 2.20-2.23 ms (chip_smoke.measure_moment_paths, fi
//   and the counts the same bits).  In 1D and 3D each case reads its count
//   and origin before the staging wait (the 2D instances after it), and in
//   3D a block stages xk's slab alone and reads fk from global memory one
//   neighbour ahead: at K = 48
//   the slabs of both (99 KB) let two blocks share an SM, xk's alone (74 KB)
//   three, and the dim3_thread launch (order 2, CENTER, 2^21) went from
//   4.00-4.15 to 2.81-2.87 ms.  The
//   ALGO_ITERATIVE instance keeps the first 10 entries of its solution in
//   shared memory (the rest of a third of the SM's), so with the trips' own
//   live values (x^ in registers) it spills less than the basic instance.
//   Its residual pass reads the case's neighbours from global memory (the
//   slabs are gone), four at a time with their loads issued together, so
//   each sector a thread touches is fetched once and used whole: 47.12 ->
//   22.42 ms at 2^23, max_iter = 3, on an H100 (the trips 4.7, 3.7 and 2.9
//   ms; the 6 GB each reads again takes 1.8 ms at the card's 3.35 TB/s;
//   PERF.md).
// The designs tried for the thread body (four and two lanes per case with
// cp.async staging in a persistent grid, the factor in shared memory, the
// register body) and their times: chip_smoke.measure_moment_variants,
// PERF.md section 6.  ptxas spills 400 bytes a thread at 2D order 4 in the
// basic instance (chip_smoke.phase_headline fails above that, and
// phase_build if the ALGO_ITERATIVE instances spill more).
//
// The warp body (3D orders 3-4, NO = 20 / 35, NM = 84 / 165): a thread's
// moments and factor (~6.9 KB at order 4) fit neither its registers nor 64
// threads' share of a block's shared memory, so one warp (one block of 32
// threads) takes a case, its state in shared memory (11.2 KB at order 4),
// 16 cases an SM (the registers, 128 a lane).  Its phase clock led the
// design: the Cholesky, the two single-RHS solves and the sweep were 75% of
// a case's cycles.  On an H100 the dim3 launch (K = 48, 2^21) went from
// 74.99 to 32.16 ms:
//   - neighbours in chunks of 32, one a lane: each writes its neighbour's
//     power ladders dx^a, dy^b, w dz^c and w f dz^c where the factor will be,
//     and each lane forms its mma fragment of pair (a, b) as dx^a dy^b from
//     two ladder rows; the moments and the RHS are one product, D[(a, b)][c]
//     = sum_k (dx^a dy^b)_k (w dz^c)_k, on the FP64 tensor cores (mma
//     m8n8k4: the products added in neighbour order with one rounding each,
//     the arithmetic of the thread body's fma chain), and a generated table
//     says which moment or RHS entry each product is;
//   - A[j,m] = M[slot(j,m)] scaled into a packed triangle, lanes over its
//     entries (a generated (row, column, moment) table read coalesced);
//   - the Cholesky by panels of 8, each panel's columns in registers with
//     the pivot rows' entries passed by shuffles, one rsqrt a pivot, the
//     trailing tiles on the FP64 tensor cores;
//   - the solves by 8-row blocks on the tensor cores with the diagonal
//     blocks' inverses: ten dependent block steps a solve, not 70 shuffle
//     steps (a solve 20.2 k -> 4.4 k cycles a case);
//   - the sweeps' A (s y) with lanes over rows from the moments;
//   - the blocked key after the store, from the rows kernel's
//     inv_frob2_blocked (warp_chol.cuh), its blocks over the moments;
//   - the residual pass of ALGO_ITERATIVE with lanes over neighbours and a
//     shuffle max.
//   fi is within 6e-12 of the design before on the dim3 path.

// Built with -DWLSQM_PHASE_CLOCK=1 (a measurement library that no route
// loads) each case adds the clock64() cycles of each phase of its fit to a
// row of counters: chip_smoke.measure_moment_phases.
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
#ifndef WLSQM_PHASE_CLOCK
#define WLSQM_PHASE_CLOCK 0
#endif

namespace {

constexpr bool kEmitCond = WLSQM_EMIT_COND != 0;  // this library writes the key
constexpr int kDim = WLSQM_MOMENT_DIM;            // this library's dimension
constexpr int kTB = 64;       // threads (cases) per block of the thread body
constexpr int kRegRows = 11;  // rows of the factor kept in registers
constexpr int kWeightCenter = 2;  // defs.WEIGHT_CENTER
// the thread body's instances: without knowns and ALGO_ITERATIVE (2D only),
// with knowns (and ALGO_ITERATIVE), with ALGO_ITERATIVE alone (2D only)
constexpr int kBasic = 0, kKnowns = 1, kIterative = 2;
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

// The phase clock, a measurement build only (-DWLSQM_PHASE_CLOCK=1; no route
// loads it): each case adds the clock64() cycles of each phase of its fit to
// its row of kPhases counters (zeroed by the caller, set by
// wlsqm_moment_phase_buffer): 0 staging, 1 scale and normaliser, 2 assembly
// (moments, RHS, known values), 3 matrix build, 4 Cholesky, 5 key, 6 first
// solve, 7 refinement sweeps, 8-10 the ALGO_ITERATIVE trips' residual
// passes, 11-13 their sweeps (a fourth trip and later in the third's
// slots), 14 store, 15 the whole fit.  Elsewhere the marks compile to
// nothing.
constexpr int kPhases = 16;
#if WLSQM_PHASE_CLOCK
__device__ long long* g_phase_clock;
#define WLSQM_CLOCK_START() long long wlsqm_t0 = clock64(), wlsqm_tp = wlsqm_t0
#define WLSQM_CLOCK(slot, cs, on)                                                \
  do {                                                                           \
    const long long wlsqm_now = clock64();                                       \
    if (on) g_phase_clock[(int64_t)(cs) * kPhases + (slot)] += wlsqm_now - wlsqm_tp; \
    wlsqm_tp = wlsqm_now;                                                        \
  } while (0)
#define WLSQM_CLOCK_END(cs, on) \
  do {                          \
    if (on) g_phase_clock[(int64_t)(cs) * kPhases + 15] = clock64() - wlsqm_t0; \
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
  // after the rows, in the ALGO_ITERATIVE instance: the first kYS entries
  // of the solution y, per-entry rows as the others (registers the trips
  // need, so that instance spills no more than the basic one); at 2D order 4
  // the block keeps a third of an SM's shared memory
  static constexpr int kYS = NO > 10 ? 10 : 0;
  static constexpr int YS = kEntries;
  static constexpr size_t kIterBytes = kBytes + sizeof(double) * kYS * kTB;
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

template <int DIM, int ORDER, int WEIGHTING, int MODE>
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
  WLSQM_CLOCK_START();
  // a known DOF (the knowns instance only: elsewhere the predicate folds away)
  auto kn = [knowns](int j) { return MODE == kKnowns && ((knowns >> j) & 1LL) != 0; };

  // ---- the block's slabs of xk and fk (in 3D xk's alone; contiguous in
  //      global memory) into shared memory by coalesced 8-byte cp.async,
  //      each case's rows at an odd stride, so that the cases' walks below
  //      are free of bank conflicts; past what one block can hold, the walks
  //      read global memory ----
  const int ldx = (DIM * K) | 1, ldf = K | 1;
  double* const sm = smem + tid;
  const double* const xg = xk + c * (int64_t)K * DIM;
  const double* const fg = fk + c * (int64_t)K;
  const double* xc = xg;
  const double* fc = fg;
  // the case's count and origin, read before the staging wait, which their
  // latency would otherwise follow; the 2D instances (the headline's) read
  // them after it, as they did before the 1D and 3D instances were split
  constexpr bool kEarly = DIM != 2;
  int n = 0;
  double x0[DIM];
  auto read_case = [&]() {
    n = min(max(nk[c], 0), K);
#pragma unroll
    for (int a = 0; a < DIM; ++a) x0[a] = xi[DIM * c + a];
  };
  if (kEarly && valid) read_case();
  const bool xk_only = DIM == 3 && staged == 2;  // fk then read from global memory
  if (staged) {
    const int cnt = (int)min((int64_t)kTB, B - c0);
    const double* gx = xk + c0 * K * DIM;
    for (int g = tid; g < cnt * K * DIM; g += kTB)
      cp_async8(smem + (g / (DIM * K)) * ldx + g % (DIM * K), gx + g);
    const double* gf = fk + c0 * K;
    double* const sf = smem + kTB * ldx;
    if (!xk_only)
      for (int g = tid; g < cnt * K; g += kTB) cp_async8(sf + (g / K) * ldf + g % K, gf + g);
    asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::: "memory");
    xc = smem + tid * ldx;
    if (!xk_only) fc = sf + tid * ldf;
  }
  __syncthreads();
  WLSQM_CLOCK(0, c, valid);

  // ---- the scale (h^2 of the unscaled offsets), the CENTER normalisation,
  //      and the moments and the RHS in registers ----
  double e = 0.0, is = 1.0, max_d2 = 1.0;
  double M[NM], b[NO];
#pragma unroll
  for (int i = 0; i < NM; ++i) M[i] = 0.0;
#pragma unroll
  for (int j = 0; j < NO; ++j) b[j] = 0.0;
  if (valid) {
    if (!kEarly) read_case();
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
    WLSQM_CLOCK(1, c, true);
    // per neighbour: the powers of the scaled offsets (the last axis' times
    // w), w f times the last axis' powers, then one multiply-add per moment
    // and per RHS entry (a product of two ladders first in 3D); where only
    // xk is staged, fk from global memory one neighbour ahead
    double fnext = xk_only && n > 0 ? __ldg(fc) : 0.0;
    for (int k = 0; k < n; ++k) {
      double fv;
      if (xk_only) {
        fv = fnext;
        if (k + 1 < n) fnext = __ldg(fc + k + 1);
      } else {
        fv = fc[k];
      }
      double d[DIM];
      offsets<DIM>(xc, k, x0, is, d);
      const double w = weight<DIM, WEIGHTING>(d, max_d2);
      double p[DIM][2 * ORDER + 1], pf[ORDER + 1];
#pragma unroll
      for (int a = 0; a < DIM - 1; ++a) p[a][0] = 1.0;
      p[DIM - 1][0] = w, pf[0] = w * fv;
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
    if constexpr (MODE == kKnowns) {
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
    WLSQM_CLOCK(2, c, true);
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
  WLSQM_CLOCK(3, c, true);
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
  WLSQM_CLOCK(5, c, true);
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
  WLSQM_CLOCK(4, c, true);

  // ---- solve in the scaled space, then sweep: y += solve(s (b - A (s y)));
  //      each solve's two passes right-looking (each known value updates
  //      every row after it: independent multiply-adds, each row's in pivot
  //      order), the reciprocal pivots in shared memory; a known DOF's row
  //      has a zero right-hand side, so its y stays 0 ----
  // y: registers, but in the ALGO_ITERATIVE instance its first kYS entries
  // in shared memory
  double y[NO];
  constexpr int NYS = MODE == kIterative ? Lay::kYS : 0;
#define WLSQM_Y(j) ((j) < NYS ? sm[(Lay::YS + (j)) * kTB] : y[(j) < NYS ? 0 : (j)])
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    if (j < NYS) sm[(Lay::YS + j) * kTB] = 0.0;
    else y[j] = 0.0;
  }
  auto sweep = [&](bool first) {
    double x[NO];
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      WLSQM_BARRIER();
      double acc = 0.0;
      if (!first) {
#pragma unroll
        for (int m = 0; m < NO; ++m)
          if (!kn(m)) acc = fma(WLSQM_M(T::slot(j, m)), WLSQM_Y(m) * WLSQM_S(m), acc);
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
    for (int j = 0; j < NO; ++j) {
      if (j < NYS) sm[(Lay::YS + j) * kTB] += x[j];
      else y[j] += x[j];
    }
  };
  if constexpr (MODE == kBasic) {
#pragma unroll 1
    for (int it = 0; it <= refine_steps; ++it) {
      sweep(it == 0);
      WLSQM_CLOCK(it == 0 ? 6 : 7, c, true);
    }
  } else {
    // ---- then ALGO_ITERATIVE: corrective refits, each one sweep, until the
    //      l-inf norm of the data residual repeats exactly (one loop, so
    //      the sweep is inlined once).  The slabs are gone, so the residual
    //      pass reads the case's neighbours from global memory; each basis
    //      entry goes into the sum as it is formed, and what the pass needs
    //      of the case (its origin, scale, count and rows) it reads again,
    //      so the loop holds no registers beyond the fit's across the
    //      sweeps ----
    double prev = -1.0;
#pragma unroll 1
    for (int it = 0;; ++it) {
      sweep(it == 0);
      const int trip = it - refine_steps;  // residual passes before this one
      WLSQM_CLOCK(it == 0 ? 6 : trip <= 0 ? 7 : 10 + min(trip, 3), c, true);
      if (trip < 0) continue;
      if (trip >= max_iter) {
        if (max_iter > 0) iters[c] = max_iter;
        break;
      }
      const int nt = min(max(nk[c], 0), K);
      const double* const xt = xk + c * (int64_t)K * DIM;
      const double* const ft = fk + c * (int64_t)K;
      double o[DIM];
#pragma unroll
      for (int a = 0; a < DIM; ++a) o[a] = xi[DIM * c + a];
      const double ist = pow2(-e);
      double xh[NO];  // x^ = y s (the known values in their place)
#pragma unroll
      for (int jj = 0; jj < NO; ++jj) {
        WLSQM_BARRIER();
        xh[jj] = kn(jj) ? scaled_known(gi, c * ldg + jj, T::fact(jj), T::deg(jj), e)
                        : WLSQM_Y(jj) * WLSQM_S(jj);
      }
      // four neighbours at a time, their loads issued together: a thread's
      // rows are contiguous, so each 32-byte sector it touches is fetched
      // once and used whole, not kept in L1 for the next neighbour
      double nrm = 0.0;
#pragma unroll 1
      for (int k0 = 0; k0 < nt; k0 += 4) {
        double v[4][DIM + 1];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = k0 + q < nt ? k0 + q : nt - 1;
#pragma unroll
          for (int a = 0; a < DIM; ++a) v[q][a] = __ldg(xt + DIM * k + a);
          v[q][DIM] = __ldg(ft + k);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (k0 + q < nt) {
            WLSQM_BARRIER();
            double d[DIM];
#pragma unroll
            for (int a = 0; a < DIM; ++a) d[a] = (v[q][a] - o[a]) * ist;
            // the plain monomial basis row from per-axis power ladders, as
            // basis_row forms it, each entry into the sum at once
            double p[DIM][ORDER + 1];
#pragma unroll
            for (int a = 0; a < DIM; ++a) {
              p[a][0] = 1.0;
#pragma unroll
              for (int e2 = 1; e2 <= ORDER; ++e2) p[a][e2] = p[a][e2 - 1] * d[a];
            }
            double m = 0.0;
#pragma unroll
            for (int jj = 0; jj < NO; ++jj) {
              double mono = 1.0;
              bool first = true;
#pragma unroll
              for (int a = 0; a < DIM; ++a) {
                const int e2 = T::de(jj, a);
                if (e2 != 0) {
                  mono = first ? p[a][e2] : mono * p[a][e2];
                  first = false;
                }
              }
              m = fma(mono, xh[jj], m);
            }
            nrm = fmax(nrm, fabs(v[q][DIM] - m));
          }
        }
      }
      WLSQM_CLOCK(8 + min(trip, 2), c, true);
      if (nrm == prev) {
        iters[c] = trip;
        break;
      }
      prev = nrm;
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
                     : (WLSQM_Y(j) * WLSQM_S(j)) * (T::fact(j) * ip[T::deg(j)]);
  }
  WLSQM_CLOCK(14, c, true);

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
  WLSQM_CLOCK(5, c, true);
  WLSQM_CLOCK_END(c, true);
#undef WLSQM_M
#undef WLSQM_S
#undef WLSQM_RD
#undef WLSQM_Y
}

// ---------------------------------------------------------------------------
// The warp body: one warp (one block of 32 threads) per case
// ---------------------------------------------------------------------------

#ifndef WLSQM_WARP_MIN_BLOCKS
#define WLSQM_WARP_MIN_BLOCKS 16
#endif
// cases (warps) an SM keeps resident, as far as the registers go: 16 gives
// each lane 128 registers and few spills; one case's state is 11.2 KB, so
// shared memory would take 19 (chip_smoke.measure_warp_residency builds 12,
// 20 and 24 beside it: 20 and 24 run at 19, with 2-3x the spills, within 3%)
constexpr int kWarpMinBlocks = WLSQM_WARP_MIN_BLOCKS;
constexpr int kKC = 32;        // neighbours a chunk of the assembly: one a lane
constexpr int kLDL = kKC + 4;  // ladder row stride

// Shared-memory layout of one case, in doubles: the packed matrix (then its
// factor), the reciprocal pivots, the moments and seven vectors (b, s, g, y,
// x, w, x^).  During the assembly the chunk's power ladders take the front
// (nothing else is live then: the sums are in registers), one row of kLDL
// per power, a column per neighbour: dx^a (a = 0..2 ORDER), dy^b, then the
// z columns w dz^c (c = 0..2 ORDER) and w f dz^c (c = 0..ORDER) and two
// rows that the last tile's columns past 3 ORDER + 1 read (products the map
// drops).  With the key, its blocks follow the pivots once the fit is
// stored.
template <int DIM, int ORDER>
struct WarpLayout {
  using T = MomentTables<DIM, ORDER>;
  static constexpr int NO = T::NO, NM = T::NM, NT = NO * (NO + 1) / 2;
  static constexpr int A = 0, RD = NT, M = RD + NO, V = M + NM;
  static constexpr int TK = (NO + 7) / 8;     // 8 x 8 blocks a side
  static constexpr int ZD = V + 7 * NO;        // the diagonal blocks' inverses
  static constexpr int STATE = ZD + 64 * TK;
  static constexpr int LX = 0, LY = 2 * ORDER + 1, LZ = 2 * LY, OPS = (LZ + 16) * kLDL;
  static constexpr int BASE = STATE > OPS ? STATE : OPS;
  static constexpr int Y = RD + NO;
  static constexpr int KEY_NEED = Y + wlsqm_warp::key_scratch<NO>();
  static constexpr int KEY = BASE > KEY_NEED ? BASE : KEY_NEED;
};

// Cholesky in place by panels of 8 columns (the packed lower matrix A, NO
// rows): the updates of wlsqm_warp::chol_panels in the same order, with each
// panel's columns in registers (lanes over rows): a finished column updates
// the panel's later columns with the pivot rows' entries from their lanes
// by shuffles, so no column waits on a shared-memory round trip and a
// barrier; the trailing tiles less the panel's product on the tensor cores,
// every tile's loads issued together.  Each pivot's reciprocal is one
// rsqrt, not a square root and a division: those two were most of a
// column's chain.  rdv gets the reciprocal pivots; the diagonal of A is left
// as it is (no reader needs the pivots themselves).
template <int NO>
__device__ __forceinline__ void chol_moment(double* A, double* rdv, int lane) {
  using wlsqm_warp::kFull;
  using wlsqm_warp::lt;
  constexpr int RPL = (NO + 31) / 32;  // rows per lane
  constexpr int TT = NO / 8 + 1;       // 8 x 8 tiles a side, padding included
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int p0 = 0; p0 < NO; p0 += 8) {
    double tt[RPL][8];
#pragma unroll
    for (int h = 0; h < RPL; ++h)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int i = lane + 32 * h, j = p0 + c;
        tt[h][c] = j < NO && i >= j && i < NO ? A[lt(i, j)] : 0.0;
      }
    double acc = __shfl_sync(kFull, tt[p0 >> 5][0], p0 & 31);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = p0 + c;
      if (j < NO) {
        const double invd = rsqrt(acc < 1e-30 ? 1e-30 : acc);
        if (lane == 0) rdv[j] = invd;
#pragma unroll
        for (int h = 0; h < RPL; ++h) tt[h][c] *= invd;
        // the next pivot first, from its own lane's entries (what the
        // update below gives that lane), so one shuffle leaves the chain
        if (c + 1 < 8 && j + 1 < NO) {
          const int h1 = (j + 1) >> 5;
          acc = __shfl_sync(kFull, fma(-tt[h1][c], tt[h1][c], tt[h1][c + 1]), (j + 1) & 31);
        }
#pragma unroll
        for (int c2 = c + 1; c2 < 8; ++c2) {
          const int j2 = p0 + c2;
          if (j2 < NO) {
            const double ljc = __shfl_sync(kFull, tt[j2 >> 5][c], j2 & 31);
#pragma unroll
            for (int h = 0; h < RPL; ++h) tt[h][c2] = fma(-tt[h][c], ljc, tt[h][c2]);
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < RPL; ++h)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int i = lane + 32 * h, j = p0 + c;
        if (j < NO && i > j && i < NO) A[lt(i, j)] = tt[h][c];
      }
    if (p0 + 8 >= NO) break;
    __syncwarp();
    // A[rows, cols] -= L[rows, panel] L[cols, panel]^T for the tiles past it;
    // each lane reads and writes only its own fragment's entries there
#pragma unroll
    for (int ti = p0 / 8 + 1; ti < TT; ++ti) {
      const int row = 8 * ti + g;
      double a[2];
#pragma unroll
      for (int st = 0; st < 2; ++st) a[st] = row < NO ? -A[lt(row, p0 + 4 * st + t4)] : 0.0;
#pragma unroll
      for (int tj = p0 / 8 + 1; tj <= ti; ++tj) {
        const int brow = 8 * tj + g;
        double d[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * tj + 2 * t4 + e;
          d[e] = row < NO && col <= row ? A[lt(row, col)] : 0.0;
        }
#pragma unroll
        for (int st = 0; st < 2; ++st)
          wlsqm_warp::mma_8x8x4(d, a[st], brow < NO ? A[lt(brow, p0 + 4 * st + t4)] : 0.0);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * tj + 2 * t4 + e;
          if (row < NO && col <= row) A[lt(row, col)] = d[e];
        }
      }
    }
    __syncwarp();
  }
  __syncwarp();
}

// The inverses of the factor's 8 x 8 diagonal blocks, TK of them row-major
// at Zd + 64 I (zeros past NO), a lane per block column: the first stage of
// wlsqm_warp::inv_frob2_blocked, whose arithmetic it repeats
template <int NO>
__device__ __forceinline__ void diag_inverses(const double* L, const double* rd, double* Zd,
                                              int lane) {
  using wlsqm_warp::lt;
  constexpr int TK = (NO + 7) / 8;
#pragma unroll 1
  for (int p = lane; p < 8 * TK; p += 32) {
    const int I = p >> 3, c = p & 7, gc = 8 * I + c;
    double* const Z = Zd + 64 * I;
    double x[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int gr = 8 * I + r;
      double v = 0.0;
      if (r >= c && gr < NO && gc < NO) {
        if (r == c) {
          v = rd[gr];
        } else {
          double t = 0.0;
#pragma unroll
          for (int q = 0; q < r; ++q)
            if (q >= c) t = fma(-L[lt(gr, 8 * I + q)], x[q], t);
          v = t * rd[gr];
        }
      }
      x[r] = v;
      Z[r * 8 + c] = v;
    }
  }
  __syncwarp();
}

// x <- (L L^T)^-1 x by 8-row blocks on the FP64 tensor cores: forward,
// y_I = Z_I (x_I - sum_{J<I} L_IJ y_J), then backward, x_I = Z_I^T (y_I -
// sum_{J>I} L_JI^T x_J), with Z_I the diagonal blocks' inverses
// (diag_inverses).  Each block product is a matrix-vector product as an mma
// whose B columns all hold the vector (lane (g, t4) holds its entry 4 st +
// t4), so every lane of row g gets the row's sum; a block's result reaches
// the lanes that need its entries by a shuffle.  Ten dependent block steps
// in place of 2 NO shuffle-and-multiply-add steps, a fraction of the
// instructions.
template <int NO>
__device__ __forceinline__ void solve_moment(const double* L, const double* Zd, double* x,
                                             int lane) {
  using wlsqm_warp::kFull;
  using wlsqm_warp::lt;
  using wlsqm_warp::mma_8x8x4;
  constexpr int TK = (NO + 7) / 8;
  const int g = lane >> 2, t4 = lane & 3;
  double yk[TK][2];  // block J's entries 4 st + t4, this lane's B operands
#pragma unroll
  for (int I = 0; I < TK; ++I) {
    const int row = 8 * I + g;
    double d[2] = {0.0, 0.0};
#pragma unroll
    for (int J = 0; J < I; ++J)
#pragma unroll
      for (int st = 0; st < 2; ++st)
        mma_8x8x4(d, row < NO ? L[lt(row, 8 * J + 4 * st + t4)] : 0.0, yk[J][st]);
    const double t = (row < NO ? x[row] : 0.0) - d[0];
    double z[2] = {0.0, 0.0};
#pragma unroll
    for (int st = 0; st < 2; ++st)
      mma_8x8x4(z, Zd[64 * I + g * 8 + 4 * st + t4], __shfl_sync(kFull, t, (4 * st + t4) << 2));
#pragma unroll
    for (int st = 0; st < 2; ++st) yk[I][st] = __shfl_sync(kFull, z[0], (4 * st + t4) << 2);
  }
  __syncwarp();  // every lane has read x before the backward pass writes it
#pragma unroll
  for (int I = TK - 1; I >= 0; --I) {
    const int row = 8 * I + g;
    double d[2] = {0.0, 0.0};
#pragma unroll
    for (int J = TK - 1; J > I; --J)
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        const int r = 8 * J + 4 * st + t4;
        mma_8x8x4(d, r < NO && row < NO ? L[lt(r, row)] : 0.0, yk[J][st]);
      }
    // y_I's entry g (its lane of this row's group holds it), then
    // x_I = Z_I^T (y_I - ...)
    const double t = __shfl_sync(kFull, g & 4 ? yk[I][1] : yk[I][0], (lane & ~3) | (g & 3)) - d[0];
    double z[2] = {0.0, 0.0};
#pragma unroll
    for (int st = 0; st < 2; ++st)
      mma_8x8x4(z, Zd[64 * I + (4 * st + t4) * 8 + g], __shfl_sync(kFull, t, (4 * st + t4) << 2));
#pragma unroll
    for (int st = 0; st < 2; ++st) yk[I][st] = __shfl_sync(kFull, z[0], (4 * st + t4) << 2);
    if (t4 == 0 && row < NO) x[row] = z[0];
  }
  __syncwarp();
}

template <int DIM, int ORDER, int WEIGHTING>
__global__ void __launch_bounds__(32, kWarpMinBlocks)
fit_moment_warp(const double* __restrict__ xk, const double* __restrict__ fk,
                const int* __restrict__ nk, const double* __restrict__ xi,
                const double* __restrict__ gi, double* __restrict__ fi,
                int* __restrict__ iters, double* __restrict__ est, int64_t B, int K,
                int64_t knowns, int64_t ldg, int refine_steps, int max_iter) {
  using T = MomentTables<DIM, ORDER>;
  using Lay = WarpLayout<DIM, ORDER>;
  constexpr int NO = T::NO, NM = T::NM, NT = Lay::NT, LD = kLDL;
  constexpr int TP = T::NPP / 8;  // 8 x 8 tiles of pairs; two of columns
  static_assert(T::kWarp && DIM == 3, "the warp body serves 3D orders 3-4");
  static_assert(3 * ORDER + 2 <= 16, "the z columns fit two tiles");
  extern __shared__ __align__(16) double smem[];
  double* const Lad = smem;
  double* const A = smem + Lay::A;
  double* const rdv = smem + Lay::RD;
  double* const Ms = smem + Lay::M;
  double* const bv = smem + Lay::V;
  double* const sv = bv + NO;
  double* const gv = sv + NO;
  double* const yv = gv + NO;
  double* const xv = yv + NO;
  double* const wv = xv + NO;
  double* const xhv = wv + NO;
  double* const Zd = smem + Lay::ZD;
  double* const Y = smem + Lay::Y;

  const int64_t cs = blockIdx.x;
  const int lane = threadIdx.x;
  WLSQM_CLOCK_START();
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment coordinates
  const int n = min(max(nk[cs], 0), K);
  const double* const xc = xk + cs * (int64_t)K * DIM;
  const double* const fc = fk + cs * (int64_t)K;
  double x0[DIM];
#pragma unroll
  for (int a = 0; a < DIM; ++a) x0[a] = xi[cs * DIM + a];
  auto kn = [knowns](int j) { return ((knowns >> j) & 1LL) != 0; };
  WLSQM_CLOCK(0, cs, lane == 0);

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
  WLSQM_CLOCK(1, cs, lane == 0);

  // ---- the moments and the RHS as one product on the FP64 tensor cores:
  //      D[(a, b)][c] = sum_k (dx^a dy^b)_k (w dz^c)_k, and with w f dz^c
  //      the RHS; per chunk of 32 neighbours each lane writes its
  //      neighbour's power ladders (zeros past nk), and each lane forms its
  //      fragment of pair p = 8 ti + g as dx^a dy^b from two ladder rows (the
  //      product its owner would form: the same bits); the mma adds its
  //      products in neighbour order with one rounding each, so every sum is
  //      the fma chain fma(dx^a dy^b, w dz^c, M) of the thread body.  The
  //      pairs go by degree, so only the first TJ1 row tiles reach the second
  //      column tile (the RHS and dz^8): 8 tiles a step at order 4, not 12 ----
  int xa[TP], yb[TP];  // this lane's pairs' ladder rows, as offsets
#pragma unroll
  for (int ti = 0; ti < TP; ++ti) {
    const int ab = T::pab_at(8 * ti + g);
    xa[ti] = (Lay::LX + (ab & 15)) * LD;
    yb[ti] = (Lay::LY + (ab >> 4)) * LD;
  }
  double acc[TP][2][2];
#pragma unroll
  for (int ti = 0; ti < TP; ++ti)
#pragma unroll
    for (int tj = 0; tj < 2; ++tj) acc[ti][tj][0] = acc[ti][tj][1] = 0.0;
#pragma unroll 1
  for (int k0 = 0; k0 < n; k0 += kKC) {
    __syncwarp();
    {
      const bool live = k0 + lane < n;
      double d[DIM], w = 0.0, f = 0.0;
      if (live) {
        offsets<DIM>(xc, k0 + lane, x0, is, d);
        w = weight<DIM, WEIGHTING>(d, max_d2);
        f = fc[k0 + lane];
      } else {
        d[0] = d[1] = d[2] = 0.0;
      }
      double px = live ? 1.0 : 0.0, py = px, pz = w, pf = w * f;
      Lad[(Lay::LX) * LD + lane] = px;
      Lad[(Lay::LY) * LD + lane] = py;
      Lad[(Lay::LZ) * LD + lane] = pz;
      Lad[(Lay::LZ + 2 * ORDER + 1) * LD + lane] = pf;
#pragma unroll
      for (int q = 1; q <= 2 * ORDER; ++q) {
        px = px * d[0];
        py = py * d[1];
        pz = pz * d[2];
        Lad[(Lay::LX + q) * LD + lane] = px;
        Lad[(Lay::LY + q) * LD + lane] = py;
        Lad[(Lay::LZ + q) * LD + lane] = pz;
        if (q <= ORDER) {
          pf = pf * d[2];
          Lad[(Lay::LZ + 2 * ORDER + 1 + q) * LD + lane] = pf;
        }
      }
    }
    __syncwarp();
    const int steps = (min(kKC, n - k0) + 3) / 4;
#pragma unroll 1
    for (int st = 0; st < steps; ++st) {
      const int k = 4 * st + t4;
      double bq[2];
#pragma unroll
      for (int tj = 0; tj < 2; ++tj) bq[tj] = Lad[(Lay::LZ + 8 * tj + g) * LD + k];
#pragma unroll
      for (int ti = 0; ti < TP; ++ti) {
        const double ap = Lad[xa[ti] + k] * Lad[yb[ti] + k];
        wlsqm_warp::mma_8x8x4(acc[ti][0], ap, bq[0]);
        if (ti < T::TJ1) wlsqm_warp::mma_8x8x4(acc[ti][1], ap, bq[1]);
      }
    }
  }
  __syncwarp();  // the operands are read: the state takes their place
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
  WLSQM_CLOCK(2, cs, lane == 0);

  // ---- the known values through the moments, the Jacobi scale (1 for a
  //      known DOF), and the scaled matrix with identity rows and columns,
  //      lanes over its packed entries (the generated (row, column, moment)
  //      of each, read coalesced) ----
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
#pragma unroll
  for (int t = 0; t < (NT + 31) / 32; ++t) {
    const int idx = lane + 32 * t;
    if (idx < NT) {
      const unsigned v = T::tri_at(idx);
      const int i = v & 0xff, m = (v >> 8) & 0xff;
      A[idx] = kn(i) || kn(m) ? (i == m ? 1.0 : 0.0) : Ms[v >> 16] * (sv[m] * sv[i]);
    }
  }
  __syncwarp();
  WLSQM_CLOCK(3, cs, lane == 0);
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
  WLSQM_CLOCK(5, cs, lane == 0);

  // ---- Cholesky in place by panels of 8 columns (the trailing tiles on the
  //      tensor cores) ----
  chol_moment<NO>(A, rdv, lane);
  diag_inverses<NO>(A, rdv, Zd, lane);
  WLSQM_CLOCK(4, cs, lane == 0);

  // ---- solve in the scaled space, then sweep through the moments:
  //      y += solve(s (b - A (s y))), lanes over rows (the rows past 32 by
  //      the whole warp, each lane a share of the columns), each warp read of
  //      the symmetric slot table on consecutive entries; a known DOF's row
  //      has a zero right-hand side ----
  for (int j = lane; j < NO; j += 32) yv[j] = kn(j) ? 0.0 : bv[j] * sv[j];
  __syncwarp();
  solve_moment<NO>(A, Zd, yv, lane);
  WLSQM_CLOCK(6, cs, lane == 0);
  auto sweep = [&]() {
    for (int m = lane; m < NO; m += 32) wv[m] = yv[m] * sv[m];
    __syncwarp();
    if (lane < NO) {
      double acc = 0.0;
#pragma unroll
      for (int m = 0; m < NO; ++m)
        if (!kn(m)) acc = fma(Ms[T::slot_at(m * NO + lane)], wv[m], acc);
      xv[lane] = kn(lane) ? 0.0 : (bv[lane] - acc) * sv[lane];
    }
    // rows past 32 by the whole warp, each lane a share of the columns
#pragma unroll
    for (int r = 32; r < NO; ++r) {
      double part = 0.0;
#pragma unroll
      for (int m = lane; m < NO; m += 32)
        if (!kn(m)) part = fma(Ms[T::slot_at(r * NO + m)], wv[m], part);
      const double acc = wlsqm_warp::warp_sum(part);
      if (lane == 0) xv[r] = kn(r) ? 0.0 : (bv[r] - acc) * sv[r];
    }
    __syncwarp();
    solve_moment<NO>(A, Zd, xv, lane);
    for (int j = lane; j < NO; j += 32) yv[j] += xv[j];
    __syncwarp();
  };
#pragma unroll 1
  for (int it = 0; it < refine_steps; ++it) sweep();
  WLSQM_CLOCK(7, cs, lane == 0);

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
      WLSQM_CLOCK(8 + min(it, 2), cs, lane == 0);
      if (!done) {
        sweep();
        ++itn;
      }
      WLSQM_CLOCK(11 + min(it, 2), cs, lane == 0);
      prev = nrm;
    }
    if (lane == 0) iters[cs] = itn;
  }

  // ---- the de-scale in the store; a known DOF gets fi_init's bits ----
  for (int j = lane; j < NO; j += 32)
    fi[cs * NO + j] = kn(j) ? (gi != nullptr ? gi[cs * ldg + j] : 0.0)
                            : (yv[j] * sv[j]) * (T::fact_at(j) * pow2(-e * T::deg_at(j)));
  WLSQM_CLOCK(14, cs, lane == 0);

  // ---- the key from the factor, after the fit (fi does not see it): its
  //      blocks take the moments' and the vectors' place ----
  if constexpr (kEmitCond) {
    __syncwarp();
    const double f2 = wlsqm_warp::warp_sum(wlsqm_warp::inv_frob2_blocked<NO>(A, rdv, Y, lane));
    double amp = 1.0;
#pragma unroll
    for (int o = 0; o < ORDER; ++o) amp *= fmax(is, 1.0);
    if (lane == 0) est[cs] = ninf * sqrt(f2) * amp;
  }
  WLSQM_CLOCK(5, cs, lane == 0);
  WLSQM_CLOCK_END(cs, lane == 0);
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

template <int ORDER, int WEIGHTING, int MODE>
int launch_thread(const Args& a, cudaStream_t stream) {
  using Lay = Layout<kDim, ORDER>;
  auto kernel = fit_moment_thread<kDim, ORDER, WEIGHTING, MODE>;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  // what a block stages: 1 the slabs of xk and fk; in 3D 2, xk's slab
  // alone (fk read one neighbour ahead from global memory: at K = 48 three
  // blocks an SM, not two); 0 nothing, past what one block can hold (the
  // walks read global memory)
  const size_t slab = sizeof(double) * kTB *
                      (size_t)(((kDim * a.K) | 1) + (kDim == 3 ? 0 : (a.K | 1)));
  const int staged = slab <= (size_t)optin ? (kDim == 3 ? 2 : 1) : 0;
  const size_t lay = MODE == kBasic ? Lay::kBytes : Lay::kIterBytes;
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
// else the thread body's instance that mode names (kBasic, kKnowns,
// kIterative)
template <int ORDER, int WEIGHTING>
int launch(const Args& a, int mode, cudaStream_t st) {
  if constexpr (MomentTables<kDim, ORDER>::kWarp) {
    return launch_warp<ORDER, WEIGHTING>(a, st);
  } else {
    return mode == kKnowns      ? launch_thread<ORDER, WEIGHTING, kKnowns>(a, st)
           : mode == kIterative ? launch_thread<ORDER, WEIGHTING, kIterative>(a, st)
                                : launch_thread<ORDER, WEIGHTING, kBasic>(a, st);
  }
}

int dispatch(const Args& a, int order, int weighting, int mode, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool center = weighting == kWeightCenter;
#define WLSQM_CASE(ORD) \
  case ORD:             \
    return center ? launch<ORD, kWeightCenter>(a, mode, st) : launch<ORD, 1>(a, mode, st);
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
// library's; knowns bits at or past NO are ignored; ext names the 2D thread
// body's instance: 0 the call's own (knowns: the one with knowns; else
// max_iter > 0: the one with ALGO_ITERATIVE; else the basic one), 1 the one
// with knowns, 2 the one with ALGO_ITERATIVE (unless the call has knowns).
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
  const int mode = kmask != 0 || ext == kKnowns                  ? kKnowns
                   : max_iter > 0 || ext == kIterative ? kIterative
                                                       : kBasic;
  return dispatch(a, order, weighting, mode, stream);
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

#if WLSQM_PHASE_CLOCK
// the phase clock's counters: (B, kPhases) int64 on the card, zeroed
extern "C" int wlsqm_moment_phase_buffer(void* buf) {
  long long* p = (long long*)buf;
  return (int)cudaMemcpyToSymbol(g_phase_clock, &p, sizeof(p));
}
#endif

#if WLSQM_MOMENT_VARIANTS
#include "fit_moment_variants.cuh"
#endif
