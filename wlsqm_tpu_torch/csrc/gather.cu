// Row gather out[r, :] = u[idx[r], :] (Hopper, sm_90a).
//
// Replaces the TPU kernel wlsqm_tpu/ops/gather.py:168 (_gather_kernel,
// launched by _gather_sel at l.264 for gather_rows l.478 and
// gather_rows_pair l.366): the IBVP step's neighbour lookup fk = u[idx].
// The TPU kernel copies two windows of u per block of 16 cases into VMEM
// and selects with a one-hot matmul, because a TPU core cannot gather from
// HBM.  A Hopper thread loads any address, so this kernel gathers
// directly; the host plan (plan_window_gather) only checks the call.
//
// What it computes: for each plane p (one, or two for the f32 (hi, lo)
// pair) and each output row r, out_p[r, :] = u_p[idx[r], :], a row being W
// 32-bit words (W = F * itemsize / 4).  Bits are copied, never converted,
// so every 4- and 8-byte payload (f64, f32, int32, int64) comes through bit
// for bit: NaN patterns, -0 and inf included.  Every row comes from this
// kernel, the plan's overflow blocks included.
//
// Bound on this card (bytes): idx read once (4 B per row), out written
// once (4 W B per row), u read once (4 W B per point).  At n = B = 2^22,
// K = 28, f64: F = 1 1.44 GB, 0.431 ms; F = 3 3.39 GB, 1.012 ms; the Euler
// step's rows (K = 24, F = 8 f64, 64 B) 7.11 GB, 2.12 ms at the data-sheet
// 3.35 TB/s.  What the design does about it:
//   * one thread per 16-byte vector of the output, written with one
//     streaming store (st.global.cs), so that a warp stores 512 contiguous
//     bytes and the output does not evict from the 50 MB L2 the u rows that
//     a Morton-ordered cloud's neighbours share; the vector's LOAD-byte
//     pieces (the widest that the row width and u's alignment allow: 8 B
//     for f64 rows of an odd number of fields, 16 B for an even one) come
//     from their rows through the read-only path, one index load per row a
//     thread touches (neighbouring threads' loads of one index meet in L1).
//     gather_vec16 has the row width as a template argument (rows of 1, 2,
//     3, 4 or 6 words); gather_vecs takes any other width at run time and
//     finds a vector's row by a multiply and a shift with a multiplier the
//     host computes, where a 32-bit division cost it 3% on the Euler rows.
//     On those rows the width as a template measured 2.87 ms, the run-time
//     width with the division 2.97 ms, one thread a row with its four
//     16-byte loads in flight 4.76 ms, and the word copy that took these
//     rows before 7.16 ms (chip_smoke.measure_gather_variants; NVIDIA H100
//     80GB HBM3, 700 W; PERF.md);
//   * gather_words, for what no vector fits (an output that is not 16-byte
//     aligned): one thread per output word, the word index fastest;
//   * 64-bit offsets (R * W reaches 7e8 at 2^22 cases, K = 28, F = 3, f64);
//   * indices clamped into [0, n), so a bad index never reads outside u;
//   * the ragged last vector is copied word by word.
// The host (ops/gather._vector_plan) picks the instance from the row width
// and the pointers' alignment and passes it in; this entry checks it.
//
// Layout: 256 threads per block, grid (ceil(vectors or words / 256), planes).  Plain
// C entry point, loaded with ctypes; launches on the caller's stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int64_t clamp_row(int64_t i, int64_t n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__global__ void __launch_bounds__(kThreads)
gather_words(const uint32_t* __restrict__ u0, const uint32_t* __restrict__ u1,
             const int32_t* __restrict__ idx, uint32_t* __restrict__ out0,
             uint32_t* __restrict__ out1, int64_t n, int64_t total, int64_t W) {
  const int64_t o = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (o >= total) return;
  const uint32_t* __restrict__ u = blockIdx.y ? u1 : u0;
  uint32_t* __restrict__ out = blockIdx.y ? out1 : out0;
  const int64_t r = o / W;
  const int64_t w = o - r * W;
  const int64_t i = clamp_row(__ldg(idx + r), n);
  out[o] = __ldg(u + i * W + w);
}

// One thread per 16-byte vector of the output: its LOAD-byte pieces come
// from the rows they belong to (a piece never straddles two rows), and the
// vector is written with one streaming store, so a warp's stores are 512
// contiguous bytes.
template <int W, int LOAD>
__global__ void __launch_bounds__(kThreads)
gather_vec16(const uint32_t* __restrict__ u0, const uint32_t* __restrict__ u1,
             const int32_t* __restrict__ idx, uint32_t* __restrict__ out0,
             uint32_t* __restrict__ out1, int64_t n, int64_t rows) {
  constexpr int P = LOAD / 4;  // words per piece
  constexpr int PR = W / P;    // pieces per row
  constexpr int PV = 4 / P;    // pieces per vector
  const int64_t total = rows * W;
  const int64_t v = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (4 * v >= total) return;
  const uint32_t* __restrict__ u = blockIdx.y ? u1 : u0;
  uint32_t* __restrict__ out = blockIdx.y ? out1 : out0;
  if (4 * v + 4 > total) {  // the ragged last vector, word by word
    for (int64_t o = 4 * v; o < total; ++o) {
      const int64_t r = o / W;
      __stcs(out + o, __ldg(u + clamp_row(__ldg(idx + r), n) * W + (o - r * W)));
    }
    return;
  }
  uint32_t x[4];
#pragma unroll
  for (int q = 0; q < PV; ++q) {
    const int64_t p = v * PV + q;
    const int64_t r = p / PR;
    const uint32_t* src = u + clamp_row(__ldg(idx + r), n) * W + (p - r * PR) * P;
    if constexpr (P == 4) {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(src));
      x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
    } else if constexpr (P == 2) {
      const uint2 t = __ldg(reinterpret_cast<const uint2*>(src));
      x[2 * q] = t.x, x[2 * q + 1] = t.y;
    } else {
      x[q] = __ldg(src);
    }
  }
  __stcs(reinterpret_cast<uint4*>(out) + v, make_uint4(x[0], x[1], x[2], x[3]));
}

// p / d, for 32-bit p < 2^31 by a multiply and a shift with the host's
// (mul, shift) from div_magic (Granlund and Montgomery), else by a division
template <typename Idx>
__device__ __forceinline__ Idx quotient(Idx p, Idx d, uint32_t mul, int shift) {
  if constexpr (sizeof(Idx) == 4) return d == 1 ? p : __umulhi(p, mul) >> shift;
  else return p / d;
}

// One thread per 16-byte vector of the output for a row width W that no
// template above takes, W a run-time argument: the same pieces, stores and
// ragged last vector as gather_vec16, with the vector's first row found by
// quotient (Idx: 32 bits when the piece count is below 2^31, else 64) and
// each row's index loaded once a thread.
template <int LOAD, typename Idx>
__global__ void __launch_bounds__(kThreads)
gather_vecs(const uint32_t* __restrict__ u0, const uint32_t* __restrict__ u1,
            const int32_t* __restrict__ idx, uint32_t* __restrict__ out0,
            uint32_t* __restrict__ out1, int64_t n, int64_t rows, int W, uint32_t mul,
            int shift) {
  constexpr int P = LOAD / 4;  // words per piece
  constexpr int PV = 4 / P;    // pieces per vector
  const int64_t total = rows * W;
  const int64_t v = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (4 * v >= total) return;
  const uint32_t* __restrict__ u = blockIdx.y ? u1 : u0;
  uint32_t* __restrict__ out = blockIdx.y ? out1 : out0;
  if (4 * v + 4 > total) {  // the ragged last vector, word by word
    for (int64_t o = 4 * v; o < total; ++o) {
      const int64_t r = o / W;
      __stcs(out + o, __ldg(u + clamp_row(__ldg(idx + r), n) * W + (o - r * W)));
    }
    return;
  }
  const Idx PR = (Idx)(W / P);  // pieces per row
  const Idx p0 = (Idx)v * PV;
  Idx r = quotient(p0, PR, mul, shift), c = p0 - r * PR;
  const uint32_t* src = u + clamp_row(__ldg(idx + r), n) * W;
  uint32_t x[4];
#pragma unroll
  for (int q = 0; q < PV; ++q) {
    if (q > 0 && c == PR) {  // the vector goes on in the next row
      c = 0;
      src = u + clamp_row(__ldg(idx + ++r), n) * W;
    }
    const uint32_t* at = src + (int64_t)c * P;
    if constexpr (P == 4) {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(at));
      x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
    } else if constexpr (P == 2) {
      const uint2 t = __ldg(reinterpret_cast<const uint2*>(at));
      x[2 * q] = t.x, x[2 * q + 1] = t.y;
    } else {
      x[q] = __ldg(at);
    }
    ++c;
  }
  __stcs(reinterpret_cast<uint4*>(out) + v, make_uint4(x[0], x[1], x[2], x[3]));
}

struct Call {
  const uint32_t *u0, *u1;
  const int32_t* idx;
  uint32_t *out0, *out1;
  int64_t n, rows;
  int words;
  cudaStream_t st;
};

void launch_words(const Call& c) {
  const int64_t total = c.rows * (int64_t)c.words;
  const dim3 grid((unsigned)((total + kThreads - 1) / kThreads), c.u1 ? 2 : 1);
  gather_words<<<grid, kThreads, 0, c.st>>>(c.u0, c.u1, c.idx, c.out0, c.out1, c.n, total,
                                            c.words);
}

template <int W, int LOAD>
void launch_vec(const Call& c) {
  const int64_t vecs = (c.rows * W + 3) / 4;
  const dim3 grid((unsigned)((vecs + kThreads - 1) / kThreads), c.u1 ? 2 : 1);
  gather_vec16<W, LOAD><<<grid, kThreads, 0, c.st>>>(c.u0, c.u1, c.idx, c.out0, c.out1,
                                                     c.n, c.rows);
}

// the multiplier and shift of quotient for a divisor d >= 2 and dividends
// below 2^31: l = ceil(log2 d), mul = ceil(2^(31 + l) / d), shift = l - 1
void div_magic(uint32_t d, uint32_t* mul, int* shift) {
  int l = 0;
  while ((1ull << l) < d) ++l;
  *mul = (uint32_t)(((1ull << (31 + l)) + d - 1) / d), *shift = l - 1;
}

template <int LOAD>
void launch_vecs(const Call& c) {
  const int64_t vecs = (c.rows * c.words + 3) / 4;
  const dim3 grid((unsigned)((vecs + kThreads - 1) / kThreads), c.u1 ? 2 : 1);
  uint32_t mul = 0;
  int shift = 0;
  div_magic((uint32_t)(c.words / (LOAD / 4)), &mul, &shift);
  if (c.rows * c.words / (LOAD / 4) < (1LL << 31))
    gather_vecs<LOAD, uint32_t><<<grid, kThreads, 0, c.st>>>(
        c.u0, c.u1, c.idx, c.out0, c.out1, c.n, c.rows, c.words, mul, shift);
  else
    gather_vecs<LOAD, uint64_t><<<grid, kThreads, 0, c.st>>>(
        c.u0, c.u1, c.idx, c.out0, c.out1, c.n, c.rows, c.words, mul, shift);
}

// the vector instance of (words, load bytes): a template for rows of 1, 2,
// 3, 4 or 6 words, the run-time width for the rest
bool launch_vec_instance(const Call& c, int load) {
#define WLSQM_VEC(W, L)                      \
  if (c.words == W && load == L) {           \
    launch_vec<W, L>(c);                     \
    return true;                             \
  }
  WLSQM_VEC(1, 4)
  WLSQM_VEC(2, 4)
  WLSQM_VEC(2, 8)
  WLSQM_VEC(3, 4)
  WLSQM_VEC(4, 4)
  WLSQM_VEC(4, 8)
  WLSQM_VEC(4, 16)
  WLSQM_VEC(6, 4)
  WLSQM_VEC(6, 8)
#undef WLSQM_VEC
  switch (load) {
    case 4: launch_vecs<4>(c); return true;
    case 8: launch_vecs<8>(c); return true;
    case 16: launch_vecs<16>(c); return true;
    default: return false;
  }
}

bool aligned(const void* p, int bytes) { return ((uintptr_t)p) % bytes == 0; }

}  // namespace

// u0, u1: (n, words) int32 planes (u1 null for one plane); idx: (rows,)
// int32; out0, out1: (rows, words) int32.  load_bytes 0: the word instance;
// 4, 8 or 16: the vector instance with loads of that width, which needs out
// 16-byte aligned, u aligned to the loads and rows a whole number of loads
// (ops/gather._vector_plan).  Returns a CUDA
// error code; a plan that does not fit the pointers is cudaErrorInvalidValue.
extern "C" int wlsqm_gather_words(const void* u0, const void* u1, const void* idx,
                                  void* out0, void* out1, int64_t n, int64_t rows,
                                  int words, int load_bytes, void* stream) {
  if (n <= 0 || words <= 0 || (u1 == nullptr) != (out1 == nullptr))
    return (int)cudaErrorInvalidValue;
  if (rows <= 0) return (int)cudaSuccess;
  const Call c{(const uint32_t*)u0, (const uint32_t*)u1, (const int32_t*)idx,
               (uint32_t*)out0, (uint32_t*)out1, n, rows, words, (cudaStream_t)stream};
  if (load_bytes == 0) {
    if ((rows * (int64_t)words + kThreads - 1) / kThreads > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    launch_words(c);
    return (int)cudaGetLastError();
  }
  const bool fits = aligned(out0, 16) && (!out1 || aligned(out1, 16)) &&
                    aligned(u0, load_bytes) && (!u1 || aligned(u1, load_bytes)) &&
                    (4 * words) % load_bytes == 0;
  if (!fits || (rows * (int64_t)words + 3) / 4 / kThreads >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (!launch_vec_instance(c, load_bytes)) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
