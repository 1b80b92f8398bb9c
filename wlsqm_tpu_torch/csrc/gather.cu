// Row gather out[r, :] = u[idx[r], :] in 32-bit words (Hopper, sm_90a).
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
// pair) and each output word o = r * W + w, out_p[o] = u_p[idx[r] * W + w],
// where W = F * itemsize / 4 words make one row.  Words are copied, never
// converted, so every 4- and 8-byte payload (f64, f32, int32, int64) comes
// through bit for bit: NaN patterns, -0 and inf included.  Every row comes
// from this kernel, the plan's overflow blocks included.
//
// Bound on this card (bytes): idx read once (4 B per row), out written
// once (4 W B per row), u read once (4 W B per point).  At n = B = 2^22,
// K = 28, f64, F = 1: 0.470 + 0.940 + 0.034 GB = 1.44 GB, 0.43 ms at the
// data-sheet 3.35 TB/s.  What the design does about it:
//   * one thread per output word, the word index fastest, so a warp's
//     stores are 128 contiguous bytes;
//   * idx and u through the read-only cache (__ldg): a row's W words share
//     one idx load, and a Morton-ordered cloud's neighbours share cache
//     lines of u, which fits in the 50 MB L2 at these sizes;
//   * 64-bit offsets (R * W reaches 7e8 at 2^22 cases, K = 28, F = 3, f64);
//   * indices clamped into [0, n), so a bad index never reads outside u.
// Staging the plan's two windows in shared memory (TMA or cp.async) is a
// redesign for later, to be measured against this one.
//
// Layout: 256 threads per block, grid (ceil(R * W / 256), planes).  W is a
// template parameter for the common widths (the division folds to a
// multiply), a runtime value otherwise.  Plain C entry point, loaded with
// ctypes; launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int WORDS>
__global__ void __launch_bounds__(kThreads)
gather_words(const uint32_t* __restrict__ u0, const uint32_t* __restrict__ u1,
             const int32_t* __restrict__ idx, uint32_t* __restrict__ out0,
             uint32_t* __restrict__ out1, int64_t n, int64_t total, int runtime_words) {
  const int64_t o = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (o >= total) return;
  const int64_t W = WORDS > 0 ? WORDS : runtime_words;
  const uint32_t* __restrict__ u = blockIdx.y ? u1 : u0;
  uint32_t* __restrict__ out = blockIdx.y ? out1 : out0;
  const int64_t r = o / W;
  const int64_t w = o - r * W;
  int64_t i = __ldg(idx + r);
  i = i < 0 ? 0 : (i >= n ? n - 1 : i);
  out[o] = __ldg(u + i * W + w);
}

template <int WORDS>
void launch(const uint32_t* u0, const uint32_t* u1, const int32_t* idx, uint32_t* out0,
            uint32_t* out1, int64_t n, int64_t total, int words, cudaStream_t st) {
  const dim3 grid((unsigned)((total + kThreads - 1) / kThreads), u1 ? 2 : 1);
  gather_words<WORDS><<<grid, kThreads, 0, st>>>(u0, u1, idx, out0, out1, n, total, words);
}

}  // namespace

// u0, u1: (n, words) int32 planes (u1 null for one plane); idx: (rows,)
// int32; out0, out1: (rows, words) int32.  Returns a CUDA error code.
extern "C" int wlsqm_gather_words(const void* u0, const void* u1, const void* idx,
                                  void* out0, void* out1, int64_t n, int64_t rows,
                                  int words, void* stream) {
  if (n <= 0 || words <= 0 || (u1 == nullptr) != (out1 == nullptr))
    return (int)cudaErrorInvalidValue;
  if (rows <= 0) return (int)cudaSuccess;
  const int64_t total = rows * (int64_t)words;
  if ((total + kThreads - 1) / kThreads > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const uint32_t *a = (const uint32_t*)u0, *b = (const uint32_t*)u1;
  const int32_t* ix = (const int32_t*)idx;
  uint32_t *p = (uint32_t*)out0, *q = (uint32_t*)out1;
  cudaStream_t st = (cudaStream_t)stream;
  switch (words) {
    case 1: launch<1>(a, b, ix, p, q, n, total, words, st); break;
    case 2: launch<2>(a, b, ix, p, q, n, total, words, st); break;
    case 3: launch<3>(a, b, ix, p, q, n, total, words, st); break;
    case 4: launch<4>(a, b, ix, p, q, n, total, words, st); break;
    case 6: launch<6>(a, b, ix, p, q, n, total, words, st); break;
    default: launch<0>(a, b, ix, p, q, n, total, words, st); break;
  }
  return (int)cudaGetLastError();
}
