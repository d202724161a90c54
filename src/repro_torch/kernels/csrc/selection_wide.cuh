// Shared-memory selection for m > 64 workers, behind K1-K4's entry points.
//
// The register design of selection.cuh (one thread per coordinate, the whole
// column in registers) stops at m = 64: K3/K4 hold the column and a sorted
// copy, and a bucket of 128 would be 256 floats per thread before anything
// else.  Here a block stages an (m, C) tile of columns in shared memory: each
// warp-wide load reads one row of C neighbouring columns, so the loads are
// coalesced.  C is 32 while the block's shared memory holds 32 columns, and
// fewer as m grows.  Each column is padded with +inf to the power of two P >=
// m.  Two designs then sort and read the columns.
//
// K1/K2 up to kWarpSortMaxM workers (warp_sort_kernel): one warp loads one
// column into registers, P/32 keys a lane, and sorts it with a bitonic network
// whose stages pair registers of one lane or, for the larger strides, lanes
// through __shfl_xor_sync (warp_sort): no shared-memory round trip and no
// barrier per stage.  The warp writes the sorted column back once.  After a
// __syncthreads one thread per column reads the center, the window search and
// the window sum off it.  The column is stored with one spare word every 32
// positions (column_pos) and a column stride of P + P/32 + 1, an odd number
// of words, so that the tile's transposed stores, the warp's loads and
// write-back, and the 32 summing threads (one column each) hit 32 banks.
//
// The rest (K1/K2 past kWarpSortMaxM, K3 and K4 at any m > 64, wide_kernel):
// the column is stored with a stride of P + 1 floats.  One warp sorts one
// column with a bitonic network in shared memory, __syncwarp between its
// stages.  The counts kinds sort (key, worker index) pairs, ordered by key
// with NaN after every number and then by index: exactly the stable argsort
// of core/selection.py::stable_ranks above its pairwise range, so a worker's
// position in the sorted column is its stable rank and the drops are exact
// by construction.  Padding carries indices >= m and sorts after every real
// worker.  Lane 0 reads the aggregate off the sorted column.  K4 drops sorted
// positions < b and >= m - b.  K3 computes the distances |key - center| from
// the staged column, sorts (distance, index) pairs a second time and drops
// positions >= m - b.  The drops go into a shared int tally (integer atomics
// in shared memory), then one integer atomicAdd per worker and block into the
// (m,) 64-bit counts: no float atomics, and counts that do not depend on the
// order in which blocks run.
//
// Both read the aggregate with the register kernels' arithmetic: NaN was
// mapped to +inf, the kept window is summed in ascending order as a masked
// sum (never a total minus the dropped values), Phocas takes the leftmost of
// the best windows, and divide() multiplies by the f32 reciprocal.  The
// summation order is the plain version's, so the aggregate equals it bit for
// bit.
#pragma once

#include "selection.cuh"

namespace repro_torch {

enum WideKind { kWideTrmean, kWidePhocas, kWideTrmeanCounts,
                kWidePhocasCounts };

constexpr int kWideMaxWarps = 8;
constexpr int kWideMaxCols = 32;                 // columns of one staged tile
constexpr int kWideTileBytes = 96 * 1024;        // target shared bytes a tile
constexpr int kWideMaxSmem = 232448;             // a block's opt-in maximum
// Largest m whose K1/K2 column a warp sorts in registers (warp_sort_kernel):
// P / 32 <= 32 keys a lane.
constexpr int kWarpSortMaxM = 1024;

__host__ __device__ constexpr bool wide_warp_sorts(int kind, int p) {
  return (kind == kWideTrmean || kind == kWidePhocas) && p <= kWarpSortMaxM;
}

__host__ __device__ constexpr bool wide_has_counts(int kind) {
  return kind == kWideTrmeanCounts || kind == kWidePhocasCounts;
}

// Shared-memory layout of one launch: C columns of `arrays` arrays of
// `stride` words each (K1/K2: the column; K4: the column and its indices; K3:
// the column, its staged copy and the indices), then the (m,) tally.
struct WideLayout {
  int p = 0;          // padded column length, a power of two >= m
  int stride = 0;     // words of one column's array
  int cols = 0;       // columns per block; 0 if one column does not fit
  size_t bytes = 0;   // dynamic shared memory per block
};

// Shared-memory position of sorted position q in a warp_sort_kernel column:
// one spare word after every 32.
__device__ __forceinline__ int column_pos(int q) { return q + (q >> 5); }

__host__ __device__ constexpr int warp_sort_stride(int p) {
  return p + p / 32 + 1;
}

inline WideLayout wide_layout(int kind, int m) {
  WideLayout l;
  l.p = 1;
  while (l.p < m) l.p <<= 1;
  l.stride = wide_warp_sorts(kind, l.p) ? warp_sort_stride(l.p) : l.p + 1;
  const int arrays = kind == kWidePhocasCounts ? 3
                     : kind == kWideTrmeanCounts ? 2 : 1;
  const size_t col_bytes = static_cast<size_t>(arrays) * l.stride * 4;
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

// Position of sorted position q in a column: column_pos(q) in a
// warp_sort_kernel column (kSpread), q itself in a wide_kernel one.
template <bool kSpread>
__device__ __forceinline__ int wide_pos(int q) {
  return kSpread ? column_pos(q) : q;
}

// Sum of the sorted s[lo .. lo+len) in ascending order (window_sum's order).
template <bool kSpread>
__device__ __forceinline__ float wide_window_sum(const float* s, int lo,
                                                 int len) {
  float acc = 0.0f;
#pragma unroll 8
  for (int q = lo; q < lo + len; ++q) acc += s[wide_pos<kSpread>(q)];
  return acc;
}

// The b-trimmed mean of a sorted shared column (trimmed_mean of
// selection.cuh).
template <bool kSpread>
__device__ __forceinline__ float wide_trimmed_mean(const float* s, int m,
                                                   int b) {
  return divide(wide_window_sum<kSpread>(s, b, m - 2 * b), m - 2 * b);
}

// nearest_window_mean of selection.cuh on a sorted shared column: windows
// s[w, w + m - b) for w = 0..b scored by nan_max(center - s[w],
// s[w+k-1] - center), the strictly smallest winning (leftmost on ties).
template <bool kSpread>
__device__ __forceinline__ float wide_nearest_window_mean(const float* s,
                                                          int m, int b,
                                                          float center) {
  const int k = m - b;
  float best = nan_max(center - s[0], s[wide_pos<kSpread>(k - 1)] - center);
  int best_w = 0;
#pragma unroll 4
  for (int w = 1; w <= b; ++w) {
    const float width = nan_max(center - s[wide_pos<kSpread>(w)],
                                s[wide_pos<kSpread>(w + k - 1)] - center);
    if (width < best) {
      best = width;
      best_w = w;
    }
  }
  return divide(wide_window_sum<kSpread>(s, best_w, k), k);
}

// Compare-exchange of two registers of one lane, the smaller to `lo`.
__device__ __forceinline__ void lane_exchange(float& lo, float& hi) {
  const float a = lo;
  lo = fminf(a, hi);
  hi = fmaxf(a, hi);
}

__host__ __device__ constexpr int log2_of_pow2(int n) {
  return n <= 1 ? 0 : 1 + log2_of_pow2(n / 2);
}

// Ascending sort of the P = 32 R keys held by one warp, R a lane: sorted
// position q lands in register q % R of lane q / R.  Keys only, never NaN.
// The network is the bitonic sort in its mirror form: for each block size
// k = 2, 4, .., P, first compare-exchange q with q ^ (k - 1), its mirror in
// the block of k, then q with q ^ j for j = k/4, .., 1; the smaller key
// always goes to the lower position, so no stage carries a direction.  A
// stride below R pairs two registers of one lane; a larger one pairs lane l
// with lane l ^ (stride / R) through __shfl_xor_sync, the lower lane keeping
// the minimum (the mirror pairs register r with the partner's R - 1 - r).
// All loops run over compile-time bounds and are unrolled, so every x[r] is
// a fixed register.  All 32 lanes call this together.
template <int R>
__device__ __forceinline__ void warp_sort(float (&x)[R], int lane) {
  static_assert(R >= 1 && (R & (R - 1)) == 0, "R must be a power of two");
  constexpr int kLogP = log2_of_pow2(32 * R);
#pragma unroll
  for (int lk = 1; lk <= kLogP; ++lk) {
    const int k = 1 << lk;
    if (k <= R) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if ((r & (k / 2)) == 0) lane_exchange(x[r], x[r ^ (k - 1)]);
      }
    } else {
      float y[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        y[r] = __shfl_xor_sync(0xffffffffu, x[R - 1 - r], k / R - 1);
      }
      const bool lower = (lane & (k / (2 * R))) == 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        x[r] = lower ? fminf(x[r], y[r]) : fmaxf(x[r], y[r]);
      }
    }
#pragma unroll
    for (int lj = lk - 2; lj >= 0; --lj) {
      const int j = 1 << lj;
      if (j >= R) {
        const bool lower = (lane & (j / R)) == 0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float y = __shfl_xor_sync(0xffffffffu, x[r], j / R);
          x[r] = lower ? fminf(x[r], y) : fmaxf(x[r], y);
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if ((r & j) == 0) lane_exchange(x[r], x[r | j]);
        }
      }
    }
  }
}

// K1/K2 for 64 < m <= kWarpSortMaxM, one block on columns c0 .. c0 + C of the
// (m, d) matrix: P = 32 R (see the header).  Any assignment of a column's
// keys to the lanes sorts alike, so the warp loads key q = 32 r + lane into
// register r, the conflict-free order, and writes sorted position q back to
// column_pos(q).
template <bool kPhocas, int R, typename T>
__global__ void __launch_bounds__(kWideMaxWarps * 32)
    warp_sort_kernel(const T* __restrict__ u, float* __restrict__ out, int m,
                     long long d, int b, int cols) {
  constexpr int P = 32 * R;
  constexpr int kStride = warp_sort_stride(P);
  extern __shared__ float smem[];
  const long long c0 = static_cast<long long>(blockIdx.x) * cols;
  const int live = static_cast<int>(d - c0 < cols ? d - c0 : cols);
  // Thread t stages column t % C, rows t / C, t / C + rows_per_pass, ...,
  // kBatch loads in flight before their stores.
  constexpr int kBatch = 8;
  const int rows_per_pass = blockDim.x / cols;
  if (static_cast<int>(threadIdx.x) < rows_per_pass * cols) {
    const int c = threadIdx.x % cols;
    float* col = smem + c * kStride;
    for (int r0 = threadIdx.x / cols; r0 < P; r0 += kBatch * rows_per_pass) {
      float x[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int r = r0 + i * rows_per_pass;
        x[i] = CUDART_INF_F;
        if (r < m && c < live) {
          x[i] = to_f32(u[static_cast<long long>(r) * d + c0 + c]);
        }
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int r = r0 + i * rows_per_pass;
        if (r < P) col[column_pos(r)] = fminf(x[i], CUDART_INF_F);  // NaN: +inf
      }
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int c = threadIdx.x >> 5; c < live; c += warps) {
    float* s = smem + c * kStride;
    float x[R];
#pragma unroll
    for (int r = 0; r < R; ++r) x[r] = s[column_pos(32 * r + lane)];
    warp_sort<R>(x, lane);
#pragma unroll
    for (int r = 0; r < R; ++r) s[column_pos(R * lane + r)] = x[r];
  }
  __syncthreads();

  if (static_cast<int>(threadIdx.x) < live) {
    const float* s = smem + threadIdx.x * kStride;
    const float center = wide_trimmed_mean<true>(s, m, b);
    out[c0 + threadIdx.x] =
        kPhocas ? wide_nearest_window_mean<true>(s, m, b, center) : center;
  }
}

// One block: columns c0 .. c0 + C of the (m, d) matrix, one warp per column.
template <int kKind, typename T>
__global__ void __launch_bounds__(kWideMaxWarps * 32)
    wide_kernel(const T* __restrict__ u, float* __restrict__ out,
                unsigned long long* __restrict__ counts, int m, long long d,
                int b, int p,
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
      center = wide_trimmed_mean<false>(s, m, b);
      out[c0 + c] = kPhocas ? wide_nearest_window_mean<false>(s, m, b, center)
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
      if (tally[i] != 0) {
        atomicAdd(&counts[i], static_cast<unsigned long long>(tally[i]));
      }
    }
  }
}

// Opt `fn` in to `bytes` of dynamic shared memory where that exceeds the
// default 48 KB.
template <typename Fn>
inline cudaError_t allow_smem(Fn fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The warp sort's instance for the padded column P of one launch, R = P / 32
// keys a lane: R = 4 at P = 128 (the smallest P past kRegisterMaxM), doubled
// up to kWarpSortMaxM / 32.
template <bool kPhocas, typename T, int R = 4>
inline int launch_warp_sort(const void* u, float* out, int m, long long d,
                            int b, const WideLayout& l, dim3 grid, dim3 block,
                            cudaStream_t stream) {
  if (l.p > 32 * R) {
    if constexpr (32 * R < kWarpSortMaxM) {
      return launch_warp_sort<kPhocas, T, 2 * R>(u, out, m, d, b, l, grid,
                                                 block, stream);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto fn = warp_sort_kernel<kPhocas, R, T>;
  const cudaError_t err = allow_smem(fn, l.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<grid, block, l.bytes, stream>>>(static_cast<const T*>(u), out, m, d, b,
                                       l.cols);
  return static_cast<int>(cudaGetLastError());
}

template <int kKind, typename T>
inline int launch_wide_typed(const void* u, float* out,
                             unsigned long long* counts, int m,
                             long long d, int b, const WideLayout& l,
                             cudaStream_t stream) {
  const long long blocks = (d + l.cols - 1) / l.cols;
  const int warps = l.cols < kWideMaxWarps ? l.cols : kWideMaxWarps;
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(32 * warps);
  if constexpr (kKind == kWideTrmean || kKind == kWidePhocas) {
    if (wide_warp_sorts(kKind, l.p)) {
      return launch_warp_sort<kKind == kWidePhocas, T>(u, out, m, d, b, l,
                                                       grid, block, stream);
    }
  }
  auto fn = wide_kernel<kKind, T>;
  const cudaError_t err = allow_smem(fn, l.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<grid, block, l.bytes, stream>>>(static_cast<const T*>(u), out, counts,
                                       m, d, b, l.p, l.cols);
  return static_cast<int>(cudaGetLastError());
}

// Enqueue the wide kernel of `kKind` for 64 < m; cudaErrorInvalidValue where
// one column does not fit a block's shared memory (the wrappers raise first,
// at kernels/build.py's MAX_M) or the dtype is unknown.
template <int kKind>
inline int launch_wide(const void* u, float* out, unsigned long long* counts,
                       int m,
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
