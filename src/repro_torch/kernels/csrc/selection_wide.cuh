// Shared-memory selection for m > 64 workers, behind K1-K4's entry points.
//
// The register design of selection.cuh (one thread per coordinate, the whole
// column in registers) stops at m = 64: K1 already holds v[MP] and hi[MP],
// K3/K4 hold the column and a sorted copy, and a bucket of 128 would be 256
// floats per thread before anything else.  Here the column lives in shared
// memory instead:
//
// - A block stages an (m, C) tile of columns: each warp-wide load reads one
//   row of C neighbouring columns, so the loads are coalesced.  C is 32 while
//   the block's shared memory holds 32 columns, and fewer as m grows.  Each
//   column is padded to the power of two P >= m (+inf values) and stored with
//   a stride of P + 1 floats, so the transposed store hits 32 banks.
// - One warp sorts one column with a bitonic network over P, __syncwarp
//   between its stages.  The counts kinds sort (key, worker index) pairs,
//   ordered by key with NaN after every number and then by index: exactly
//   the stable argsort of core/selection.py::stable_ranks above its
//   pairwise range, so a worker's position in the sorted column is its
//   stable rank and the drops are exact by construction.  Padding carries
//   indices >= m and sorts after every real worker.
// - Lane 0 reads the aggregate off the sorted column with the register
//   kernels' arithmetic: NaN was mapped to +inf, the kept window is summed in
//   ascending order as a masked sum (never a total minus the dropped values),
//   Phocas takes the leftmost of the best windows, and divide() multiplies by
//   the f32 reciprocal.  The summation order is the plain version's, so the
//   aggregate equals it bit for bit.
// - K4 drops sorted positions < b and >= m - b.  K3 computes the distances
//   |key - center| from the staged column, sorts (distance, index) pairs a
//   second time and drops positions >= m - b.  The drops go into a shared
//   int tally (integer atomics in shared memory), then one integer atomicAdd
//   per worker and block into the (m,) counts: no float atomics, and counts
//   that do not depend on the order in which blocks run.
//
// This variant is simple and correct first; its speed is recorded in PERF.md.
#pragma once

#include "selection.cuh"

namespace repro_torch {

enum WideKind { kWideTrmean, kWidePhocas, kWideTrmeanCounts,
                kWidePhocasCounts };

constexpr int kWideMaxWarps = 8;
constexpr int kWideMaxCols = 32;                 // columns of one staged tile
constexpr int kWideTileBytes = 96 * 1024;        // target shared bytes a tile
constexpr int kWideMaxSmem = 232448;             // a block's opt-in maximum

__host__ __device__ constexpr bool wide_has_counts(int kind) {
  return kind == kWideTrmeanCounts || kind == kWidePhocasCounts;
}

// Shared-memory layout of one launch: C columns of `arrays` arrays of P + 1
// words each (K1/K2: the column; K4: the column and its indices; K3: the
// column, its staged copy and the indices), then the (m,) tally.
struct WideLayout {
  int p = 0;          // padded column length, a power of two >= m
  int cols = 0;       // columns per block; 0 if one column does not fit
  size_t bytes = 0;   // dynamic shared memory per block
};

inline WideLayout wide_layout(int kind, int m) {
  WideLayout l;
  l.p = 1;
  while (l.p < m) l.p <<= 1;
  const int arrays = kind == kWidePhocasCounts ? 3
                     : kind == kWideTrmeanCounts ? 2 : 1;
  const size_t col_bytes = static_cast<size_t>(arrays) * (l.p + 1) * 4;
  const size_t tally = wide_has_counts(kind) ? static_cast<size_t>(m) * 4 : 0;
  int cols = static_cast<int>(kWideTileBytes / col_bytes);
  cols = cols < 1 ? 1 : cols > kWideMaxCols ? kWideMaxCols : cols;
  l.bytes = cols * col_bytes + tally;
  l.cols = l.bytes <= static_cast<size_t>(kWideMaxSmem) ? cols : 0;
  return l;
}

// (x, ix) before (y, iy): by key, NaN after every number and equal to any
// other NaN, then by worker index.  The order of a stable argsort.
__device__ __forceinline__ bool pair_before(float x, int ix, float y, int iy) {
  const bool xn = isnan(x);
  const bool yn = isnan(y);
  if (xn || yn) return xn == yn ? ix < iy : yn;
  return x < y || (x == y && ix < iy);
}

// Ascending bitonic sort of key[0 .. p) (p a power of two) by the calling
// warp; with `idx` the (key, index) pairs by pair_before, else the keys alone
// (then never NaN) by fminf/fmaxf.  Stage by stage each lane takes pairs
// t = lane, lane + 32, ... of the p/2 disjoint compare-exchanges.
template <bool kPairs>
__device__ __forceinline__ void warp_bitonic_sort(float* key, int* idx,
                                                  int p) {
  const int lane = threadIdx.x & 31;
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = lane; t < p / 2; t += 32) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int l = i + j;
        const bool up = (i & k) == 0;
        const float a = key[i];
        const float c = key[l];
        if (kPairs) {
          const int ia = idx[i];
          const int ic = idx[l];
          if (up ? pair_before(c, ic, a, ia) : pair_before(a, ia, c, ic)) {
            key[i] = c;
            key[l] = a;
            idx[i] = ic;
            idx[l] = ia;
          }
        } else {
          key[i] = up ? fminf(a, c) : fmaxf(a, c);
          key[l] = up ? fmaxf(a, c) : fminf(a, c);
        }
      }
      __syncwarp();
    }
  }
}

// Sum of the sorted s[lo .. lo+len) in ascending order (window_sum's order).
__device__ __forceinline__ float wide_window_sum(const float* s, int lo,
                                                 int len) {
  float acc = 0.0f;
  for (int q = lo; q < lo + len; ++q) acc += s[q];
  return acc;
}

// nearest_window_mean of selection.cuh on a sorted shared column: windows
// s[w, w + m - b) for w = 0..b scored by nan_max(center - s[w],
// s[w+k-1] - center), the strictly smallest winning (leftmost on ties).
__device__ __forceinline__ float wide_nearest_window_mean(const float* s,
                                                          int m, int b,
                                                          float center) {
  const int k = m - b;
  float best = nan_max(center - s[0], s[k - 1] - center);
  int best_w = 0;
  for (int w = 1; w <= b; ++w) {
    const float width = nan_max(center - s[w], s[w + k - 1] - center);
    if (width < best) {
      best = width;
      best_w = w;
    }
  }
  return divide(wide_window_sum(s, best_w, k), k);
}

// One block: columns c0 .. c0 + C of the (m, d) matrix, one warp per column.
template <int kKind, typename T>
__global__ void __launch_bounds__(kWideMaxWarps * 32)
    wide_kernel(const T* __restrict__ u, float* __restrict__ out,
                int* __restrict__ counts, int m, long long d, int b, int p,
                int cols) {
  constexpr bool kCounts = wide_has_counts(kKind);
  constexpr bool kPhocas = kKind == kWidePhocas || kKind == kWidePhocasCounts;
  extern __shared__ float smem[];
  const int stride = p + 1;
  float* key = smem;                                        // cols x stride
  float* raw = key + (kKind == kWidePhocasCounts ? cols * stride : 0);
  int* idx = reinterpret_cast<int*>(key + (kKind == kWidePhocasCounts
                                               ? 2 * cols * stride
                                               : cols * stride));
  int* tally = idx + (kCounts ? cols * stride : 0);

  const long long c0 = static_cast<long long>(blockIdx.x) * cols;
  const int live = static_cast<int>(d - c0 < cols ? d - c0 : cols);
  if (kCounts) {
    for (int i = threadIdx.x; i < m; i += blockDim.x) tally[i] = 0;
  }
  for (int e = threadIdx.x; e < p * cols; e += blockDim.x) {
    const int r = e / cols;
    const int c = e - r * cols;
    float x = CUDART_INF_F;
    if (r < m && c < live) {
      x = to_f32(u[static_cast<long long>(r) * d + c0 + c]);
      if (isnan(x)) x = CUDART_INF_F;
    }
    key[c * stride + r] = x;
    if (kKind == kWidePhocasCounts) raw[c * stride + r] = x;
    if (kCounts) idx[c * stride + r] = r;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int c = threadIdx.x >> 5; c < live; c += warps) {
    float* s = key + c * stride;
    int* ix = idx + c * stride;
    warp_bitonic_sort<kKind == kWideTrmeanCounts>(s, ix, p);
    float center = 0.0f;
    if (lane == 0) {
      center = divide(wide_window_sum(s, b, m - 2 * b), m - 2 * b);
      out[c0 + c] = kPhocas ? wide_nearest_window_mean(s, m, b, center)
                            : center;
    }
    if (kKind == kWideTrmeanCounts) {
      for (int q = lane; q < m; q += 32) {
        if (q < b || q >= m - b) atomicAdd(&tally[ix[q]], 1);
      }
    }
    if (kKind == kWidePhocasCounts) {
      center = __shfl_sync(0xffffffffu, center, 0);
      const float* col = raw + c * stride;
      __syncwarp();                 // lane 0 has read s; now overwrite it
      for (int q = lane; q < p; q += 32) {
        s[q] = q < m ? fabsf(col[q] - center) : CUDART_NAN_F;
        ix[q] = q;
      }
      __syncwarp();
      warp_bitonic_sort<true>(s, ix, p);
      for (int q = m - b + lane; q < m; q += 32) atomicAdd(&tally[ix[q]], 1);
    }
    __syncwarp();
  }
  if (kCounts) {
    __syncthreads();
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      if (tally[i] != 0) atomicAdd(&counts[i], tally[i]);
    }
  }
}

template <int kKind, typename T>
inline int launch_wide_typed(const void* u, float* out, int* counts, int m,
                             long long d, int b, const WideLayout& l,
                             cudaStream_t stream) {
  auto fn = wide_kernel<kKind, T>;
  if (l.bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(l.bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (d + l.cols - 1) / l.cols;
  const int warps = l.cols < kWideMaxWarps ? l.cols : kWideMaxWarps;
  fn<<<static_cast<unsigned>(blocks), 32 * warps, l.bytes, stream>>>(
      static_cast<const T*>(u), out, counts, m, d, b, l.p, l.cols);
  return static_cast<int>(cudaGetLastError());
}

// Enqueue the wide kernel of `kKind` for 64 < m; cudaErrorInvalidValue where
// one column does not fit a block's shared memory (the wrappers raise first,
// at kernels/build.py's MAX_M) or the dtype is unknown.
template <int kKind>
inline int launch_wide(const void* u, float* out, int* counts, int m,
                       long long d, int b, int dtype, cudaStream_t stream) {
  const WideLayout l = wide_layout(kKind, m);
  if (l.cols < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case kF32:
      return launch_wide_typed<kKind, float>(u, out, counts, m, d, b, l,
                                             stream);
    case kF16:
      return launch_wide_typed<kKind, __half>(u, out, counts, m, d, b, l,
                                              stream);
    case kBF16:
      return launch_wide_typed<kKind, __nv_bfloat16>(u, out, counts, m, d, b,
                                                     l, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace repro_torch
