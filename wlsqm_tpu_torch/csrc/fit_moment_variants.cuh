// The designs fit_moment.cu was chosen from, at the headline configuration
// (2D, order 4, WEIGHT_CENTER), for chip_smoke.measure_moment_variants.
// Included at the end of fit_moment.cu when WLSQM_MOMENT_VARIANTS=1; never in
// the shipped libraries.
//
//   0  the register body: one thread per case, the factor in registers, inv_s from
//      the wrapper, fi in the scaled space (the wrapper de-scales);
//   1  the same body with the scale and the de-scale in the kernel;
//   2  one thread per case, the scale in the kernel, the factor in shared
//      memory in an [entry][case] layout (64 cases a block);
//   3, 4, 5  G = 4 lanes per case, 32 cases a tile: each lane sums every
//      G-th neighbour's moments, a shuffle butterfly adds them, the factor's
//      rows spread over the lanes; the tiles' xk and fk slabs staged in
//      shared memory by cp.async in a persistent grid with nb_max = 0
//      (global loads), 1 (one buffer) and 2 (two buffers);
//   6, 7, 8  the same body with two lanes per case, nb_max = 0, 1, 2;
//   9  the shipped body (one thread per case, the moments, the scale and the
//      factor's last rows in shared memory);
//   10  body 1 with the shipped body's moment sums (power ladders: dx^a times
//       w dy^b) in place of the chains;
//   11  body 10 with the shipped body's reciprocal pivots in the solves (a
//       multiply where body 1 divides); its back solve still sums each row
//       in the forward order, where the shipped body's right-looking pass
//       sums it backwards (1 -> 10 -> 11 -> 9 changes one thing at a time:
//       the bits of fi, and the calibration units, of each step).
// Every variant + 100 runs WEIGHT_UNIFORM instead (bodies 1, 9, 10 and 11:
// the calibration sweep runs both weightings).
// wlsqm_moment_phase_cycles reads (and clears) the per-phase clock64 sums of
// thread 0 of each block of the group body (scale and max d2, assembly,
// butterfly and scratch stores, Cholesky, solve and sweeps, stores, key).

#include <type_traits>

namespace {

// per-phase clock64 sums of thread 0 of each block (the group body)
__device__ unsigned long long g_phase_cycles[8];
#define WLSQM_PHASE(i)                                                     \
  do {                                                                     \
    if (threadIdx.x == 0) {                                                \
      const long long now = clock64();                                     \
      atomicAdd(&g_phase_cycles[i], (unsigned long long)(now - t_phase));  \
      t_phase = now;                                                       \
    }                                                                      \
  } while (0)
#define WLSQM_PHASE_START long long t_phase = clock64()

constexpr int kCases = 32;    // group body: cases per tile, a block has 32 * G threads
constexpr unsigned kFull = 0xffffffffu;

// the same value on the G lanes of a group: a butterfly in a fixed order
template <int G>
__device__ __forceinline__ double group_sum(double v) {
#pragma unroll
  for (int o = 1; o < G; o <<= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// h^2 of the case over its G lanes: every G-th neighbour per lane, the
// products and the sum unfused as _prescale's delta * delta summed over the
// axes, the maximum NaN-propagating as amax
template <int G>
__device__ __forceinline__ double group_h2(const double* xs, int n, double x0, double y0,
                                           int r) {
  double m = 0.0;
  for (int k = r; k < n; k += G) {
    const double dx = xs[2 * k] - x0, dy = xs[2 * k + 1] - y0;
    m = max_nan(m, dx * dx + dy * dy);
  }
#pragma unroll
  for (int o = 1; o < G; o <<= 1) m = max_nan(m, __shfl_xor_sync(kFull, m, o));
  return m;
}

// moment index of (exponent of DOF row i) + (exponent of DOF j), i at run
// time (the lane's row), j a compile-time constant
template <class T>
__device__ __forceinline__ int slot_rt(int Di, int exi, int j) {
  const int D = Di + T::deg(j);
  return D * (D + 1) / 2 + exi + T::ex(j);
}

// ---------------------------------------------------------------------------
// The group body: G lanes per case, the factor's rows spread over them
// ---------------------------------------------------------------------------

// Per-case shared scratch: M (NM), b, s and the reciprocal pivots (NO
// each), an odd stride so that neighbouring cases start on other banks.
template <int ORDER>
struct Scratch {
  using T = MomentTables<2, ORDER>;
  static constexpr int M = 0, B = T::NM, S = B + T::NO, RD = S + T::NO;
  static constexpr int LDS = (RD + T::NO) | 1;
  static constexpr int kDoubles = (kCases * LDS + 1) / 2 * 2;  // slabs start 16-byte aligned
};

template <int ORDER, int WEIGHTING, int G>
__device__ __forceinline__ void fit_case_group(double* cs, const double* xs, const double* fs,
                                               int64_t c, int64_t B, int K,
                                               const int* __restrict__ nk,
                                               const double* __restrict__ xi,
                                               double* __restrict__ fi,
                                               double* __restrict__ est, int refine_steps,
                                               int r, int base) {
  using T = MomentTables<2, ORDER>;
  using S = Scratch<ORDER>;
  constexpr int NO = T::NO;
  constexpr int NM = T::NM;
  constexpr int NR = (NO + G - 1) / G;  // rows per lane: lane r holds rows r + G t
  WLSQM_PHASE_START;
  const bool valid = c < B;
  const int n = valid ? min(max(nk[c], 0), K) : 0;
  const double x0 = valid ? xi[2 * c] : 0.0, y0 = valid ? xi[2 * c + 1] : 0.0;

  const double e = scale_exponent(group_h2<G>(xs, n, x0, y0, r));
  const double is = pow2(-e);

  double max_d2 = 1.0;
  if (WEIGHTING == kWeightCenter) {
    double m = 0.0;
    for (int k = r; k < n; k += G) {
      const double dx = (xs[2 * k] - x0) * is, dy = (xs[2 * k + 1] - y0) * is;
      m = fmax(m, fma(dx, dx, dy * dy));
    }
#pragma unroll
    for (int o = 1; o < G; o <<= 1) m = fmax(m, __shfl_xor_sync(kFull, m, o));
    max_d2 = m > 0.0 ? m : 1.0;
  }
  WLSQM_PHASE(0);

  // ---- the moments and the RHS: every G-th neighbour, then a butterfly ----
  {
    double M[NM], b[NO];
#pragma unroll
    for (int i = 0; i < NM; ++i) M[i] = 0.0;
#pragma unroll
    for (int j = 0; j < NO; ++j) b[j] = 0.0;
    for (int k = r; k < n; k += G) {
      const double d[2] = {(xs[2 * k] - x0) * is, (xs[2 * k + 1] - y0) * is};
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
      double rv[NO];
      rv[0] = w * fs[k];
      b[0] += rv[0];
#pragma unroll
      for (int j = 1; j < NO; ++j) {
        rv[j] = rv[T::bpar(j)] * d[T::baxis(j)];
        b[j] = fma(rv[T::bpar(j)], d[T::baxis(j)], b[j]);
      }
    }
    WLSQM_PHASE(1);
#pragma unroll
    for (int i = 0; i < NM; ++i) M[i] = group_sum<G>(M[i]);
#pragma unroll
    for (int j = 0; j < NO; ++j) b[j] = group_sum<G>(b[j]);
    // Jacobi scale from the moment diagonal; the lanes store a share each
#pragma unroll
    for (int i = 0; i < NM; ++i)
      if (i % G == r) cs[S::M + i] = M[i];
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      if (j % G == r) {
        const double djj = M[T::slot(j, j)];
        cs[S::B + j] = b[j];
        cs[S::S + j] = djj > 0.0 ? 1.0 / sqrt(djj) : 1.0;
      }
    }
  }
  __syncwarp();
  WLSQM_PHASE(2);
  const double* const Ms = cs + S::M;
  const double* const bs = cs + S::B;
  const double* const ss = cs + S::S;
  double* const rd = cs + S::RD;

  // the lane's rows: degree and first exponent (for slot_rt), scale
  int Di[NR], exi[NR];
  double so[NR];
#pragma unroll
  for (int t = 0; t < NR; ++t) {
    const int i = min(r + G * t, NO - 1);
    int D = 0;
    while ((D + 1) * (D + 2) / 2 <= i) ++D;
    Di[t] = D;
    exi[t] = D - (i - D * (D + 1) / 2);
    so[t] = ss[i];
  }

  // ---- Cholesky of the scaled matrix, column by column (left-looking: each
  //      lane's rows less the broadcast row j); the guard lets NaN through ----
  double L[NR][NO];
#pragma unroll
  for (int t = 0; t < NR; ++t)
#pragma unroll
    for (int q = 0; q < NO; ++q) L[t][q] = 0.0;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const double sj = ss[j];
    double acc[NR];
#pragma unroll
    for (int t = 0; t < NR; ++t) {
      acc[t] = 0.0;
      if (G * t + G - 1 >= j) {
        const int i = r + G * t;
        if (i >= j && i < NO) acc[t] = Ms[slot_rt<T>(Di[t], exi[t], j)] * (sj * so[t]);
      }
    }
#pragma unroll
    for (int q = 0; q < j; ++q) {
      const double ljq = __shfl_sync(kFull, L[j / G][q], base + j % G);
#pragma unroll
      for (int t = 0; t < NR; ++t) {
        if (G * t + G - 1 >= j) {
          const int i = r + G * t;
          if (i >= j && i < NO) acc[t] = fma(-L[t][q], ljq, acc[t]);
        }
      }
    }
    const double dd = __shfl_sync(kFull, acc[j / G], base + j % G);
    const double dj = sqrt(dd < 1e-30 ? 1e-30 : dd);
    const double invd = 1.0 / dj;
#pragma unroll
    for (int t = 0; t < NR; ++t) {
      if (G * t + G - 1 >= j) {
        const int i = r + G * t;
        if (i == j) L[t][j] = dj;
        else if (i > j && i < NO) L[t][j] = acc[t] * invd;
      }
    }
    if (r == j % G) rd[j] = invd;
  }
  __syncwarp();
  WLSQM_PHASE(3);

  // ---- solve in the scaled space, then sweep: y += solve(s (b - A (s y))).
  //      Forward: the pivot's value broadcast, each lane updates its rows
  //      (fma in q order per row); backward: each lane dots its rows with
  //      the known values, a butterfly adds the partial sums; the solution
  //      comes back whole on every lane ----
  double y[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) y[j] = 0.0;
  for (int it = 0; it <= refine_steps; ++it) {
    double z[NR];
#pragma unroll
    for (int t = 0; t < NR; ++t) {
      z[t] = 0.0;
      const int i = r + G * t;
      if (i < NO) {
        double acc = 0.0;
        if (it > 0) {
#pragma unroll
          for (int m = 0; m < NO; ++m)
            acc = fma(Ms[slot_rt<T>(Di[t], exi[t], m)], y[m] * ss[m], acc);
        }
        z[t] = (bs[i] - acc) * so[t];
      }
    }
    double w[NO];
#pragma unroll
    for (int q = 0; q < NO; ++q) {
      const double wq = __shfl_sync(kFull, z[q / G], base + q % G) * rd[q];
      w[q] = wq;
#pragma unroll
      for (int t = 0; t < NR; ++t) {
        if (G * t + G - 1 > q) {
          const int i = r + G * t;
          if (i > q && i < NO) z[t] = fma(-L[t][q], wq, z[t]);
        }
      }
    }
    double yo[NR];
#pragma unroll
    for (int t = 0; t < NR; ++t) yo[t] = 0.0;
#pragma unroll
    for (int q = NO - 1; q >= 0; --q) {
      double p = 0.0;
#pragma unroll
      for (int t = 0; t < NR; ++t) {
        if (G * t + G - 1 > q) {
          const int m = r + G * t;
          if (m > q && m < NO) p = fma(L[t][q], yo[t], p);
        }
      }
      const double yq = (w[q] - group_sum<G>(p)) * rd[q];
      w[q] = yq;
      if (r == q % G) yo[q / G] = yq;
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) y[j] += w[j];
  }
  WLSQM_PHASE(4);

  // ---- the de-scale in the store: (y s) * fact 2^(-e deg), exact factor ----
  if (valid) {
    double* out = fi + c * NO;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      if (j % G == r) out[j] = (y[j] * ss[j]) * (T::fact(j) * pow2(-e * T::deg(j)));
  }
  WLSQM_PHASE(5);

  // ---- the key: max abs row sum of the scaled matrix (NaN kept) times
  //      ||Z Z^T||_F with Z = L^-1, after the fit (fi does not see it) ----
  if constexpr (kEmitCond) {
    double ninf = 0.0;
#pragma unroll
    for (int t = 0; t < NR; ++t) {
      if (r + G * t < NO) {
        double rs = 0.0;
#pragma unroll
        for (int m = 0; m < NO; ++m)
          rs += fabs(Ms[slot_rt<T>(Di[t], exi[t], m)] * (so[t] * ss[m]));
        ninf = max_nan(ninf, rs);
      }
    }
#pragma unroll
    for (int o = 1; o < G; o <<= 1) ninf = max_nan(ninf, __shfl_xor_sync(kFull, ninf, o));

    // Z = L^-1 in place, column a by forward substitution of e_a over the lanes
#pragma unroll
    for (int a = 0; a < NO; ++a) {
      double za[NR], zf[NR];
#pragma unroll
      for (int t = 0; t < NR; ++t) za[t] = r + G * t == a ? 1.0 : 0.0, zf[t] = 0.0;
#pragma unroll
      for (int q = a; q < NO; ++q) {
        const double zq = __shfl_sync(kFull, za[q / G], base + q % G) * rd[q];
        if (r == q % G) zf[q / G] = zq;
#pragma unroll
        for (int t = 0; t < NR; ++t) {
          if (G * t + G - 1 > q) {
            const int i = r + G * t;
            if (i > q && i < NO) za[t] = fma(-L[t][q], zq, za[t]);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < NR; ++t) {
        if (G * t + G - 1 >= a) {
          const int i = r + G * t;
          if (i >= a && i < NO) L[t][a] = zf[t];
        }
      }
    }
    // ||Z Z^T||_F^2: row k of Z broadcast, dotted with the lanes' rows i >= k
    double f2 = 0.0;
#pragma unroll
    for (int k = 0; k < NO; ++k) {
      double dk[NR];
#pragma unroll
      for (int t = 0; t < NR; ++t) dk[t] = 0.0;
#pragma unroll
      for (int a = 0; a <= k; ++a) {
        const double zka = __shfl_sync(kFull, L[k / G][a], base + k % G);
#pragma unroll
        for (int t = 0; t < NR; ++t) {
          if (G * t + G - 1 >= k) {
            const int i = r + G * t;
            if (i >= k && i < NO) dk[t] = fma(L[t][a], zka, dk[t]);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < NR; ++t) {
        if (G * t + G - 1 >= k) {
          const int i = r + G * t;
          if (i >= k && i < NO) f2 = fma(i == k ? dk[t] : 2.0 * dk[t], dk[t], f2);
        }
      }
    }
    f2 = group_sum<G>(f2);
    double amp = 1.0;
#pragma unroll
    for (int o = 0; o < ORDER; ++o) amp *= fmax(is, 1.0);
    if (valid && r == 0) est[c] = ninf * sqrt(f2) * amp;
  }
  WLSQM_PHASE(6);
}

// cp.async copies into shared memory, completing on the group's wait
__device__ __forceinline__ void cp_async(double* s, const double* g, int bytes16) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  if (bytes16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(sa), "l"(g) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(sa), "l"(g) : "memory");
}

// n contiguous doubles from global g to shared s (16-byte aligned) by the
// block: 16-byte pieces where g is 16-byte aligned, else 8-byte pieces
template <int NT>
__device__ __forceinline__ void copy_slab(double* s, const double* g, int64_t n, int tid) {
  if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    for (int64_t p = tid; p < n / 2; p += NT) cp_async(s + 2 * p, g + 2 * p, 1);
    if ((n & 1) && tid == 0) cp_async(s + n - 1, g + n - 1, 0);
  } else {
    for (int64_t p = tid; p < n; p += NT) cp_async(s + p, g + p, 0);
  }
}

// A persistent grid over tiles of kCases cases, G lanes each.  nb = 2: the
// next tile's slabs load into the other buffer while this one is solved;
// nb = 1: one buffer, loaded at the top of each tile; nb = 0: the cases
// read global memory directly (K too large for one buffer).
template <int ORDER, int WEIGHTING, int G>
__global__ void __launch_bounds__(kCases * G)
fit_moment_group(const double* __restrict__ xk, const double* __restrict__ fk,
              const int* __restrict__ nk, const double* __restrict__ xi,
              double* __restrict__ fi, double* __restrict__ est, int64_t B, int K,
              int refine_steps, int nb) {
  using S = Scratch<ORDER>;
  constexpr int NT = kCases * G;
  extern __shared__ __align__(16) double smem[];
  double* const slabs = smem + S::kDoubles;
  const int64_t slab = (int64_t)kCases * K * 3;
  const int64_t tiles = (B + kCases - 1) / kCases;
  const int tid = threadIdx.x, cl = tid / G, r = tid % G;
  const int base = (tid & 31) & ~(G - 1);

  auto issue = [&](int64_t tile, int buf) {
    const int64_t c0 = tile * kCases, cnt = min((int64_t)kCases, B - c0);
    double* s = slabs + buf * slab;
    copy_slab<NT>(s, xk + c0 * K * 2, cnt * K * 2, tid);
    copy_slab<NT>(s + (int64_t)kCases * K * 2, fk + c0 * K, cnt * K, tid);
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  int buf = 0;
  int64_t tile = blockIdx.x;
  if (nb == 2 && tile < tiles) issue(tile, 0);
  for (; tile < tiles; tile += gridDim.x) {
    const int64_t next = tile + gridDim.x;
    if (nb == 1) {
      issue(tile, 0);
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    } else if (nb == 2) {
      if (next < tiles) {
        issue(next, buf ^ 1);
        asm volatile("cp.async.wait_group 1;" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;" ::: "memory");
      }
    }
    __syncthreads();
    const int64_t c = tile * kCases + cl;
    const double* xs = xk + c * K * 2;
    const double* fs = fk + c * K;
    if (nb) {
      xs = slabs + buf * slab + (int64_t)cl * K * 2;
      fs = slabs + buf * slab + (int64_t)kCases * K * 2 + (int64_t)cl * K;
    }
    fit_case_group<ORDER, WEIGHTING, G>(smem + cl * S::LDS, xs, fs, c, B, K, nk, xi, fi, est,
                                        refine_steps, r, base);
    __syncthreads();
    if (nb == 2) buf ^= 1;
  }
}

template <int ORDER, int WEIGHTING, int G>
int launch_group(const double* xk, const double* fk, const int* nk, const double* xi, double* fi,
           double* est, int64_t B, int K, int refine_steps, int nb_max, cudaStream_t stream) {
  auto kernel = fit_moment_group<ORDER, WEIGHTING, G>;
  constexpr int NT = kCases * G;
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t scratch = sizeof(double) * Scratch<ORDER>::kDoubles;
  const size_t slab = sizeof(double) * (size_t)kCases * K * 3;
  int nb = nb_max;
  while (nb > 0 && scratch + nb * slab > (size_t)optin) --nb;
  const size_t bytes = scratch + nb * slab;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, bytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = (B + kCases - 1) / kCases;
  const int64_t grid = min(tiles, (int64_t)max(per_sm, 1) * sms);
  kernel<<<(unsigned)grid, NT, bytes, stream>>>(xk, fk, nk, xi, fi, est, B, K, refine_steps,
                                                nb);
  return (int)cudaGetLastError();
}

template <int G>
int dispatch_group(const void* xk, const void* fk, const void* nk, const void* xi, void* fi,
             void* est, int64_t B, int K, int weighting, int refine_steps, int nb_max,
             void* stream) {
  const double* x = (const double*)xk;
  const double* f = (const double*)fk;
  const int* n = (const int*)nk;
  const double* o = (const double*)xi;
  cudaStream_t st = (cudaStream_t)stream;
  return weighting == kWeightCenter
             ? launch_group<4, 2, G>(x, f, n, o, (double*)fi, (double*)est, B, K, refine_steps,
                                     nb_max, st)
             : launch_group<4, 1, G>(x, f, n, o, (double*)fi, (double*)est, B, K, refine_steps,
                                     nb_max, st);
}



template <int NO>
struct RegL {  // the packed factor in registers (every index folds after unrolling)
  double v[NO * (NO + 1) / 2];
  __device__ __forceinline__ double& operator[](int e) { return v[e]; }
};

template <int TB>
struct SmemL {  // the packed factor in shared memory, entry e of case tid at e * TB + tid
  double* p;
  __device__ __forceinline__ double& operator[](int e) { return p[e * TB]; }
};

// RECIP: multiply by the reciprocal pivots rd where the register body divides
template <int NO, bool RECIP, class LT>
__device__ __forceinline__ void chol_solve_t(LT& L, const double (&rd)[NO], double (&x)[NO]) {
#pragma unroll
  for (int i = 0; i < NO; ++i) {
    double t = x[i];
#pragma unroll
    for (int q = 0; q < i; ++q) t = fma(-L[lt(i, q)], x[q], t);
    x[i] = RECIP ? t * rd[i] : t / L[lt(i, i)];
  }
#pragma unroll
  for (int i = NO - 1; i >= 0; --i) {
    double t = x[i];
#pragma unroll
    for (int q = i + 1; q < NO; ++q) t = fma(-L[lt(q, i)], x[q], t);
    x[i] = RECIP ? t * rd[i] : t / L[lt(i, i)];
  }
}

template <int NO, class LT>
__device__ __forceinline__ double inv_frob2_t(LT& L) {
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

// the register body with four switches: OWN_SCALE (the scale and de-scale
// here, inv_s unused), SMEM_L (the factor in shared memory), LADDERS (the
// shipped body's moment sums) and RECIP (its reciprocal pivots)
template <int ORDER, int WEIGHTING, bool OWN_SCALE, bool SMEM_L, int TB, bool LADDERS,
          bool RECIP>
__global__ void __launch_bounds__(TB)
fit_moment_thread(const double* __restrict__ xk, const double* __restrict__ fk,
                  const int* __restrict__ nk, const double* __restrict__ xi,
                  const double* __restrict__ inv_s, double* __restrict__ fi,
                  double* __restrict__ est, int64_t B, int K, int refine_steps) {
  using T = MomentTables<2, ORDER>;
  constexpr int NO = T::NO;
  constexpr int NM = T::NM;
  extern __shared__ __align__(16) double smem[];
  const int64_t c = (int64_t)blockIdx.x * TB + threadIdx.x;
  if (c >= B) return;

  const int n = min(max(nk[c], 0), K);
  const double x0 = xi[2 * c], y0 = xi[2 * c + 1];
  const double* xc = xk + c * (int64_t)K * 2;
  const double* fc = fk + c * (int64_t)K;
  double e = 0.0, is;
  if (OWN_SCALE) {
    double h2 = 0.0;
    for (int k = 0; k < n; ++k) {
      const double dx = xc[2 * k] - x0, dy = xc[2 * k + 1] - y0;
      h2 = max_nan(h2, dx * dx + dy * dy);
    }
    e = scale_exponent(h2);
    is = pow2(-e);
  } else {
    is = inv_s[c];
  }

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
    if constexpr (LADDERS) {
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
    } else {
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
  }

  double s[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const double djj = M[T::slot(j, j)];
    s[j] = djj > 0.0 ? 1.0 / sqrt(djj) : 1.0;
  }

  using LT = typename std::conditional<SMEM_L, SmemL<TB>, RegL<NO>>::type;
  LT L;
  if constexpr (SMEM_L) L.p = smem + threadIdx.x;
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

  if constexpr (kEmitCond) {
    double ninf = 0.0;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      double r = 0.0;
#pragma unroll
      for (int m = 0; m < NO; ++m) r += fabs(M[T::slot(j, m)] * (s[j] * s[m]));
      ninf = (r > ninf || r != r) ? r : ninf;
    }
    double amp = 1.0;
    if (OWN_SCALE) {
#pragma unroll
      for (int o = 0; o < ORDER; ++o) amp *= fmax(is, 1.0);
    }
    est[c] = ninf * sqrt(inv_frob2_t<NO>(L)) * amp;
  }

  double rd[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) rd[j] = RECIP ? 1.0 / L[lt(j, j)] : 0.0;
  double y[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) y[j] = b[j] * s[j];
  chol_solve_t<NO, RECIP>(L, rd, y);
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
    chol_solve_t<NO, RECIP>(L, rd, r);
#pragma unroll
    for (int j = 0; j < NO; ++j) y[j] += r[j];
  }

  double* out = fi + c * NO;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    out[j] = y[j] * s[j];
    if (OWN_SCALE) out[j] = out[j] * (T::fact(j) * pow2(-e * T::deg(j)));
  }
}

template <int WEIGHTING, bool OWN_SCALE, bool SMEM_L, int TB, bool LADDERS = false,
          bool RECIP = false>
int launch_thread(const void* xk, const void* fk, const void* nk, const void* xi,
                  const void* inv_s, void* fi, void* est, int64_t B, int K, int refine_steps,
                  cudaStream_t st) {
  constexpr int NT = MomentTables<2, 4>::NO * (MomentTables<2, 4>::NO + 1) / 2;
  auto kernel = fit_moment_thread<4, WEIGHTING, OWN_SCALE, SMEM_L, TB, LADDERS, RECIP>;
  const int bytes = SMEM_L ? (int)sizeof(double) * NT * TB : 0;
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)((B + TB - 1) / TB), TB, bytes, st>>>(
      (const double*)xk, (const double*)fk, (const int*)nk, (const double*)xi,
      (const double*)inv_s, (double*)fi, (double*)est, B, K, refine_steps);
  return (int)cudaGetLastError();
}

}  // namespace

// variant as in the header comment (2D order 4, WEIGHT_CENTER; + 100:
// WEIGHT_UNIFORM); inv_s is read by variant 0 alone, which writes fi in the
// scaled space and est without the radius amplification
extern "C" int wlsqm_fit_moment_variant(int variant, const void* xk, const void* fk,
                                        const void* nk, const void* xi, const void* inv_s,
                                        void* fi, void* est, int64_t B, int K,
                                        int refine_steps, void* stream) {
  if ((est != nullptr) != kEmitCond) return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const bool uniform = variant >= 100;
  constexpr int C = kWeightCenter, U = 1;
#define WLSQM_THREAD(...)                                                                  \
  return uniform ? launch_thread<U, __VA_ARGS__>(xk, fk, nk, xi, inv_s, fi, est, B, K,      \
                                                 refine_steps, st)                          \
                 : launch_thread<C, __VA_ARGS__>(xk, fk, nk, xi, inv_s, fi, est, B, K,      \
                                                 refine_steps, st)
  switch (uniform ? variant - 100 : variant) {
    case 0:
      WLSQM_THREAD(false, false, 128);
    case 1:
      WLSQM_THREAD(true, false, 128);
    case 2:
      WLSQM_THREAD(true, true, 64);
    case 10:
      WLSQM_THREAD(true, false, 128, true, false);
    case 11:
      WLSQM_THREAD(true, false, 128, true, true);
    case 3:
    case 4:
    case 5:
      return dispatch_group<4>(xk, fk, nk, xi, fi, est, B, K, uniform ? U : C, refine_steps,
                               variant % 100 - 3, stream);
    case 6:
    case 7:
    case 8:
      return dispatch_group<2>(xk, fk, nk, xi, fi, est, B, K, uniform ? U : C, refine_steps,
                               variant % 100 - 6, stream);
    case 9:
      return dispatch(Args{(const double*)xk, (const double*)fk, (const int*)nk,
                           (const double*)xi, nullptr, (double*)fi, nullptr, (double*)est, B,
                           K, 0, 0, refine_steps, 0},
                      4, uniform ? U : C, false, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef WLSQM_THREAD
}

extern "C" int wlsqm_moment_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  static const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
}
