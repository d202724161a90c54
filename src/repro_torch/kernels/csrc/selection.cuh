// Register-resident selection helpers shared by the trmean and phocas kernels.
//
// One thread owns one coordinate j of the row-major (m, d) worker matrix.  It
// loads the m values of column j (neighbouring threads read neighbouring
// addresses, so every row load is coalesced across the warp), maps NaN to
// +inf exactly as core/selection.py::worker_rows does, pads the column to a
// compile-time power of two MP with +inf, and sorts it with the Batcher
// odd-even merge network of the reference's src/repro/core/selection.py
// batcher_pairs, expanded at compile time.  Every loop below is fully unrolled over compile-time bounds, so each
// v[i] is a fixed register: no dynamically indexed array, no local memory.
// Where a runtime count (b, m) picks values, the code walks every register
// with a predicate instead of indexing.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <utility>

namespace repro_torch {

constexpr int kThreads = 256;

// dtype codes shared with the Python wrappers (kernels/build.py).
constexpr int kF32 = 0;
constexpr int kF16 = 1;
constexpr int kBF16 = 2;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// jnp.maximum semantics: NaN in either operand gives NaN (fmaxf would drop it).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? CUDART_NAN_F : fmaxf(a, b);
}

template <int MP, typename T>
__device__ __forceinline__ void load_column(const T* __restrict__ u, int m,
                                            long long d, long long j,
                                            float (&v)[MP]) {
#pragma unroll
  for (int i = 0; i < MP; ++i) {
    float x = CUDART_INF_F;
    if (i < m) {
      x = to_f32(u[static_cast<long long>(i) * d + j]);
      if (isnan(x)) x = CUDART_INF_F;
    }
    v[i] = x;
  }
}

// The Batcher odd-even merge network on mp inputs, the schedule of the
// reference's batcher_pairs(mp): batcher_size(mp) compare-exchanges, the t-th
// between registers batcher_pair(mp, t, false) < batcher_pair(mp, t, true).
// Evaluated by the compiler only, so each compare-exchange names fixed
// registers.
__host__ __device__ constexpr int batcher_walk(int mp, int t, bool hi) {
  int n = 0;
  for (int p = 1; p < mp; p <<= 1) {
    for (int k = p; k >= 1; k >>= 1) {
      for (int j = k % p; j < mp - k; j += 2 * k) {
        for (int i = 0; i < k; ++i) {
          if ((i + j) / (2 * p) == (i + j + k) / (2 * p)) {
            if (n == t) return hi ? i + j + k : i + j;
            ++n;
          }
        }
      }
    }
  }
  return t < 0 ? -1 : n;  // t past the end: the network's size
}

__host__ __device__ constexpr int log2_of(int n) {
  return n <= 1 ? 0 : 1 + log2_of(n / 2);
}

__host__ __device__ constexpr int batcher_size(int mp) {
  return batcher_walk(mp, 1 << 30, false);
}

__host__ __device__ constexpr int batcher_pair(int mp, int t, bool hi) {
  return batcher_walk(mp, t, hi);
}

template <int A, int B, int MP>
__device__ __forceinline__ void compare_exchange(float (&v)[MP]) {
  static_assert(0 <= A && A < B && B < MP, "bad compare-exchange");
  const float a = v[A];
  const float c = v[B];
  v[A] = fminf(a, c);
  v[B] = fmaxf(a, c);
}

template <int MP, int... T>
__device__ __forceinline__ void sort_pairs(float (&v)[MP],
                                           std::integer_sequence<int, T...>) {
  (compare_exchange<batcher_pair(MP, T, false), batcher_pair(MP, T, true)>(v),
   ...);
}

// Ascending sort of the column in registers.
template <int MP>
__device__ __forceinline__ void sort_network(float (&v)[MP]) {
  sort_pairs<MP>(v, std::make_integer_sequence<int, batcher_size(MP)>{});
}

// sum / n as PyTorch's CUDA division by a scalar computes it: sum times the
// f32 reciprocal of n, so the kernels equal their plain versions bit for bit.
// __fmul_rn keeps the product rounded: nvcc may not fuse it into a later
// subtraction (phocas's window widths read the center).
__device__ __forceinline__ float divide(float sum, int n) {
  return __fmul_rn(sum, 1.0f / static_cast<float>(n));
}

// Sum of the sorted values v[lo .. lo+len), accumulated in ascending order as a
// masked sum.  Never a total minus the dropped values: a dropped 1e20 would
// cancel the kept values away in f32.
template <int MP>
__device__ __forceinline__ float window_sum(const float (&v)[MP], int lo,
                                            int len) {
  float s = 0.0f;
#pragma unroll
  for (int p = 0; p < MP; ++p) {
    if (p >= lo && p < lo + len) s += v[p];
  }
  return s;
}

}  // namespace repro_torch

// Instantiate KERNEL<MP, T> for the padded worker count and the input dtype of
// one launch.  Buckets: m <= 8, 16, 32, 64 (the wrapper rejects m > 64).
#define REPRO_DISPATCH_MP_DTYPE(KERNEL, m, dtype, grid, stream, ...)          \
  do {                                                                        \
    switch ((dtype) * 8 + ((m) <= 8 ? 0 : (m) <= 16 ? 1 : (m) <= 32 ? 2 : 3)) { \
      case 0: KERNEL<8, float><<<grid, kThreads, 0, stream>>>(                 \
          static_cast<const float*>(u), __VA_ARGS__); break;                  \
      case 1: KERNEL<16, float><<<grid, kThreads, 0, stream>>>(                \
          static_cast<const float*>(u), __VA_ARGS__); break;                  \
      case 2: KERNEL<32, float><<<grid, kThreads, 0, stream>>>(                \
          static_cast<const float*>(u), __VA_ARGS__); break;                  \
      case 3: KERNEL<64, float><<<grid, kThreads, 0, stream>>>(                \
          static_cast<const float*>(u), __VA_ARGS__); break;                  \
      case 8: KERNEL<8, __half><<<grid, kThreads, 0, stream>>>(                \
          static_cast<const __half*>(u), __VA_ARGS__); break;                 \
      case 9: KERNEL<16, __half><<<grid, kThreads, 0, stream>>>(               \
          static_cast<const __half*>(u), __VA_ARGS__); break;                 \
      case 10: KERNEL<32, __half><<<grid, kThreads, 0, stream>>>(              \
          static_cast<const __half*>(u), __VA_ARGS__); break;                 \
      case 11: KERNEL<64, __half><<<grid, kThreads, 0, stream>>>(              \
          static_cast<const __half*>(u), __VA_ARGS__); break;                 \
      case 16: KERNEL<8, __nv_bfloat16><<<grid, kThreads, 0, stream>>>(        \
          static_cast<const __nv_bfloat16*>(u), __VA_ARGS__); break;          \
      case 17: KERNEL<16, __nv_bfloat16><<<grid, kThreads, 0, stream>>>(       \
          static_cast<const __nv_bfloat16*>(u), __VA_ARGS__); break;          \
      case 18: KERNEL<32, __nv_bfloat16><<<grid, kThreads, 0, stream>>>(       \
          static_cast<const __nv_bfloat16*>(u), __VA_ARGS__); break;          \
      case 19: KERNEL<64, __nv_bfloat16><<<grid, kThreads, 0, stream>>>(       \
          static_cast<const __nv_bfloat16*>(u), __VA_ARGS__); break;          \
      default: return static_cast<int>(cudaErrorInvalidValue);                \
    }                                                                         \
  } while (0)
