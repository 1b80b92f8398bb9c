// Warp-per-case building blocks shared by the rows kernel's warp body
// (fit_rows.cu) and the moment kernel's (fit_moment.cu): one warp holds one
// case's packed factor in shared memory; FP64 tensor-core tiles (mma
// m8n8k4), shuffle reductions, the panel Cholesky, single- and multi-RHS
// solves and the blocked key.  Every fused multiply-add is written as
// fma(), and every reduction runs in a fixed order, so a launch gives the
// same bits each time.

#pragma once

#include <cuda_runtime.h>

namespace wlsqm_warp {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kKC = 32;        // neighbours per chunk: one per lane
constexpr int kLDX = kKC + 4;  // row stride of the right-hand-side buffers

// packed lower triangle, j <= i
__host__ __device__ constexpr int lt(int i, int j) { return i * (i + 1) / 2 + j; }

__device__ __forceinline__ void mma_8x8x4(double (&d)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};"
               : "+d"(d[0]), "+d"(d[1])
               : "d"(a), "d"(b));
}

__device__ __forceinline__ double warp_max(double v) {  // fmax drops NaN, as the rows loop does
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmax(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ double warp_max_nan(double v) {  // NaN wins
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const double u = __shfl_xor_sync(kFull, v, o);
    v = (u > v || u != u) ? u : v;
  }
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {  // the same bits on every lane
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// x <- (L L^T)^-1 x for one vector in shared memory, lanes over rows (row
// r on lane r % 32), one shuffle per pivot; rd holds the pivots' reciprocals.
template <int NO>
__device__ __forceinline__ void chol_solve_warp(const double* L, const double* rd, double* x,
                                                int lane) {
  constexpr int RPL = (NO + 31) / 32;
  double v[RPL];
#pragma unroll
  for (int h = 0; h < RPL; ++h) v[h] = lane + 32 * h < NO ? x[lane + 32 * h] : 0.0;
#pragma unroll 1
  for (int q = 0; q < NO; ++q) {
    const double mine = (RPL == 1 || q < 32) ? v[0] : v[RPL - 1];
    const double xq = __shfl_sync(kFull, mine, q & 31) * rd[q];
#pragma unroll
    for (int h = 0; h < RPL; ++h) {
      const int r = lane + 32 * h;
      if (r == q) v[h] = xq;
      else if (r > q && r < NO) v[h] = fma(-L[lt(r, q)], xq, v[h]);
    }
  }
#pragma unroll 1
  for (int q = NO - 1; q >= 0; --q) {
    const double mine = (RPL == 1 || q < 32) ? v[0] : v[RPL - 1];
    const double xq = __shfl_sync(kFull, mine, q & 31) * rd[q];
#pragma unroll
    for (int h = 0; h < RPL; ++h) {
      const int r = lane + 32 * h;
      if (r == q) v[h] = xq;
      else if (r < q) v[h] = fma(-L[lt(q, r)], xq, v[h]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int h = 0; h < RPL; ++h)
    if (lane + 32 * h < NO) x[lane + 32 * h] = v[h];
  __syncwarp();
}

// X <- (L L^T)^-1 X for the columns col < ncols of X (NO rows, stride kLDX),
// lanes over columns: every lane reads the same factor entry (a broadcast).
// Up to kColsInRegisters rows a lane keeps its column in registers, the
// loops unrolled (the same operations in the same order, so the same bits);
// above, under the warp body's 168-register cap, such a column spills to
// local memory, so the solve stays in shared memory (on an H100 the
// registers made the sens launch faster at 2D order 4 and 3D order 3 and
// slower at 3D order 4; PERF.md).
constexpr int kColsInRegisters = 20;

template <int NO>
__device__ __forceinline__ void chol_solve_cols(const double* L, const double* rd, double* X,
                                                int ncols, int lane) {
  if (lane < ncols) {
    if constexpr (NO <= kColsInRegisters) {
      double x[NO];
#pragma unroll
      for (int r = 0; r < NO; ++r) x[r] = X[r * kLDX + lane];
#pragma unroll
      for (int q = 0; q < NO; ++q) {
        x[q] *= rd[q];
#pragma unroll
        for (int r = q + 1; r < NO; ++r) x[r] = fma(-L[lt(r, q)], x[q], x[r]);
      }
#pragma unroll
      for (int q = NO - 1; q >= 0; --q) {
        x[q] *= rd[q];
#pragma unroll
        for (int r = 0; r < q; ++r) x[r] = fma(-L[lt(q, r)], x[q], x[r]);
      }
#pragma unroll
      for (int r = 0; r < NO; ++r) X[r * kLDX + lane] = x[r];
    } else {
      double* x = X + lane;
#pragma unroll 1
      for (int q = 0; q < NO; ++q) {
        const double xq = x[q * kLDX] * rd[q];
        x[q * kLDX] = xq;
#pragma unroll 4
        for (int r = q + 1; r < NO; ++r) x[r * kLDX] = fma(-L[lt(r, q)], xq, x[r * kLDX]);
      }
#pragma unroll 1
      for (int q = NO - 1; q >= 0; --q) {
        const double xq = x[q * kLDX] * rd[q];
        x[q * kLDX] = xq;
#pragma unroll 4
        for (int r = 0; r < q; ++r) x[r * kLDX] = fma(-L[lt(q, r)], xq, x[r * kLDX]);
      }
    }
  }
  __syncwarp();
}

// ||(L L^T)^-1||_F^2 = ||Z^T Z||_F^2 with Z = L^-1, by 8 x 8 blocks (TK =
// ceil(NO / 8) block rows, padding exact zeros), in Y (block (I, J) at
// (I (I + 1) / 2 + J) * 64, row-major, then TK - 1 product buffers):
// the diagonal blocks inverted lane-parallel (lane per block column, at most
// 8 dependent rows), then Z[I, J] = -Z[I, I] sum_{J <= K < I} L[I, K] Z[K, J]
// block row by block row, and W[J1, J2] = sum_{I >= J1} Z[I, J1]^T Z[I, J2],
// each product on the FP64 tensor cores (mma m8n8k4, two k-steps per
// block), the squares of W summed from the fragments (off-diagonal blocks
// twice).  No lane runs a chain over all NO rows.  Returns this lane's part.
template <int NO>
__host__ __device__ constexpr int key_scratch() {  // doubles of Y the key needs
  return ((NO + 7) / 8 * ((NO + 7) / 8 + 1) / 2 + (NO + 7) / 8 - 1) * 64;
}

template <int NO>
__device__ __forceinline__ double inv_frob2_blocked(const double* L, const double* rd,
                                                    double* Y, int lane) {
  constexpr int TK = (NO + 7) / 8;
  const int g = lane >> 2, t4 = lane & 3;
  auto blk = [](int I, int J) { return (I * (I + 1) / 2 + J) * 64; };
  double* const P = Y + TK * (TK + 1) / 2 * 64;
#pragma unroll 1
  for (int p = lane; p < 8 * TK; p += 32) {
    const int I = p >> 3, c = p & 7, gc = 8 * I + c;
    double* const Zd = Y + blk(I, I);
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
      Zd[r * 8 + c] = v;
    }
  }
  __syncwarp();
  // block row I: P_J = sum_{J <= K < I} L[I, K] Z[K, J] for every J < I at
  // once (the fragment of L[I, K] read once, the J chains independent),
  // then Z[I, J] = -Z[I, I] P_J
#pragma unroll 1
  for (int I = 1; I < TK; ++I) {
    const int row = 8 * I + g;
    double d[TK > 1 ? TK - 1 : 1][2];
#pragma unroll
    for (int J = 0; J < TK - 1; ++J) d[J][0] = d[J][1] = 0.0;
#pragma unroll
    for (int Kb = 0; Kb < TK - 1; ++Kb) {
      if (Kb < I) {
#pragma unroll
        for (int st = 0; st < 2; ++st) {
          const int k = 4 * st + t4;
          const double a = row < NO ? L[lt(row, 8 * Kb + k)] : 0.0;
#pragma unroll
          for (int J = 0; J <= Kb; ++J) mma_8x8x4(d[J], a, Y[blk(Kb, J) + k * 8 + g]);
        }
      }
    }
#pragma unroll
    for (int J = 0; J < TK - 1; ++J)
      if (J < I)
#pragma unroll
        for (int e = 0; e < 2; ++e) P[J * 64 + g * 8 + 2 * t4 + e] = d[J][e];
    __syncwarp();
    const double* Zii = Y + blk(I, I);
#pragma unroll
    for (int J = 0; J < TK - 1; ++J) {
      if (J < I) {
        double z[2] = {0.0, 0.0};
#pragma unroll
        for (int st = 0; st < 2; ++st) {
          const int k = 4 * st + t4;
          mma_8x8x4(z, -Zii[g * 8 + k], P[J * 64 + k * 8 + g]);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) Y[blk(I, J) + g * 8 + 2 * t4 + e] = z[e];
      }
    }
    __syncwarp();
  }
  // W[J1, J2] = sum_{I >= J1} Z[I, J1]^T Z[I, J2], for every J2 <= J1 at
  // once (independent chains), the squares summed from the fragments
  double f2 = 0.0;
#pragma unroll
  for (int J1 = 0; J1 < TK; ++J1) {
    double w[TK][2];
#pragma unroll
    for (int J2 = 0; J2 < TK; ++J2) w[J2][0] = w[J2][1] = 0.0;
#pragma unroll
    for (int I = J1; I < TK; ++I) {
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        const int k = 4 * st + t4;
        const double a = Y[blk(I, J1) + k * 8 + g];
#pragma unroll
        for (int J2 = 0; J2 <= J1; ++J2) mma_8x8x4(w[J2], a, Y[blk(I, J2) + k * 8 + g]);
      }
    }
#pragma unroll
    for (int J2 = 0; J2 <= J1; ++J2) {
      const double m = J1 == J2 ? 1.0 : 2.0;
      f2 = fma(m * w[J2][0], w[J2][0], f2);
      f2 = fma(m * w[J2][1], w[J2][1], f2);
    }
  }
  return f2;
}

// Cholesky in place by panels of 8 columns of a packed lower matrix A (NO
// rows): within a panel column by column with lanes over rows, then the
// trailing lower tiles less the panel's product on the tensor cores; the
// guard sqrt(max(acc, 1e-30)) lets NaN through; rdv gets the reciprocal
// pivots.
template <int NO>
__device__ __forceinline__ void chol_panels(double* A, double* rdv, int lane) {
  constexpr int RPL = (NO + 31) / 32;  // rows per lane
  constexpr int TT = NO / 8 + 1;       // 8 x 8 tiles a side, padding included
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll 1
  for (int p0 = 0; p0 < NO; p0 += 8) {
    const int p1 = min(p0 + 8, NO);
#pragma unroll 1
    for (int j = p0; j < p1; ++j) {
      double tt[RPL];
#pragma unroll
      for (int hh = 0; hh < RPL; ++hh) {
        const int i = lane + 32 * hh;
        tt[hh] = i >= j && i < NO ? A[lt(i, j)] : 0.0;
      }
#pragma unroll 1
      for (int q = p0; q < j; ++q) {
        const double ljq = A[lt(j, q)];
#pragma unroll
        for (int hh = 0; hh < RPL; ++hh) {
          const int i = lane + 32 * hh;
          if (i >= j && i < NO) tt[hh] = fma(-A[lt(i, q)], ljq, tt[hh]);
        }
      }
      const double acc = __shfl_sync(kFull, (RPL == 1 || j < 32) ? tt[0] : tt[RPL - 1], j & 31);
      const double dj = sqrt(acc < 1e-30 ? 1e-30 : acc);
      const double invd = 1.0 / dj;
#pragma unroll
      for (int hh = 0; hh < RPL; ++hh) {
        const int i = lane + 32 * hh;
        if (i == j) A[lt(j, j)] = dj;
        else if (i > j && i < NO) A[lt(i, j)] = tt[hh] * invd;
      }
      if (lane == 0) rdv[j] = invd;
      __syncwarp();
    }
    if (p1 == NO) break;
    // A[rows, cols] -= L[rows, panel] L[cols, panel]^T for the tiles past it
#pragma unroll 1
    for (int ti = p0 / 8 + 1; ti < TT; ++ti) {
      const int row = 8 * ti + g;
      double a[2];
#pragma unroll
      for (int st = 0; st < 2; ++st) a[st] = row < NO ? -A[lt(row, p0 + 4 * st + t4)] : 0.0;
#pragma unroll 1
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
          mma_8x8x4(d, a[st], brow < NO ? A[lt(brow, p0 + 4 * st + t4)] : 0.0);
        __syncwarp();
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * tj + 2 * t4 + e;
          if (row < NO && col <= row) A[lt(row, col)] = d[e];
        }
      }
    }
    __syncwarp();
  }
}

}  // namespace wlsqm_warp
