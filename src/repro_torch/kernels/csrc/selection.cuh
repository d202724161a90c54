// Register-resident selection helpers shared by the trmean and phocas kernels
// (K1, K2) and their counts variants (K3, K4).
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
// Largest register bucket; larger m take the shared-memory variant
// (selection_wide.cuh).
constexpr int kRegisterMaxM = 64;

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

// The b-trimmed mean of the sorted column (Definition 7): the mean of
// sorted[b, m-b), selection.trimmed_mean_of_sorted.
template <int MP>
__device__ __forceinline__ float trimmed_mean(const float (&v)[MP], int m,
                                              int b) {
  return divide(window_sum<MP>(v, b, m - 2 * b), m - 2 * b);
}

// Phocas (Definition 8) from the sorted column and its b-trimmed mean
// `center`: the mean of the m - b values nearest the center.  They form one
// of the b + 1 contiguous windows sorted[w, w+k), k = m - b.  Each window is
// scored by its worst distance max(center - sorted[w], sorted[w+k-1] -
// center) and the strictly smallest score wins, so ties go to the leftmost
// window: exactly selection.nearest_window_sum.  The window's upper ends
// sorted[w+k-1] are brought to fixed registers by a log2(MP)-stage barrel
// shift by the runtime k - 1, so no register array is indexed at run time.
// `width`, where given, receives the winning score: the (m - b)-th smallest
// distance |v - center|, which K3's counts read (tally_far_drops).
template <int MP>
__device__ __forceinline__ float nearest_window_mean(const float (&v)[MP],
                                                     int m, int b,
                                                     float center,
                                                     float* width = nullptr) {
  const int k = m - b;
  // hi[w] = v[w + k - 1]: left barrel shift of the sorted column by k - 1.
  float hi[MP];
#pragma unroll
  for (int i = 0; i < MP; ++i) hi[i] = v[i];
  const int shift = k - 1;
#pragma unroll
  for (int s = 0; s < log2_of(MP); ++s) {
    if (shift & (1 << s)) {
#pragma unroll
      for (int i = 0; i < MP; ++i) {
        hi[i] = (i + (1 << s) < MP) ? hi[i + (1 << s)] : CUDART_INF_F;
      }
    }
  }

  // b <= (m+1)/2 - 1 < MP/2, so windows w = 0..b live in registers [0, MP/2).
  float best = nan_max(center - v[0], hi[0] - center);
  int best_w = 0;
#pragma unroll
  for (int w = 1; w < MP / 2; ++w) {
    if (w <= b) {
      const float width = nan_max(center - v[w], hi[w] - center);
      if (width < best) {
        best = width;
        best_w = w;
      }
    }
  }
  if (width != nullptr) *width = best;
  return divide(window_sum<MP>(v, best_w, k), k);
}

// Per-worker Phocas drop counts of one block (K3) in O(m) per coordinate.  A
// worker is dropped when the stable rank of its distance dist_i =
// |key_i - center| among the m real workers, by the pairwise predicate of
// core/selection.py::stable_ranks (dist_j < dist_i, or dist_j == dist_i and
// j < i), is at least m - b.  With W the (m - b)-th smallest distance, the
// best window's score of nearest_window_mean, that is: dist_i > W, or
// dist_i == W and #{j: dist_j < W} + #{j < i: dist_j == W} >= m - b.  So one
// count and one walk in worker order replace the m(m-1) pairwise compares.
//
// W equals the best window's score because the center lies inside every
// window w <= b, so a window's score is its largest distance, and the m - b
// nearest values form one of the windows; center - v[w] and |v[w] - center|
// round alike (IEEE subtraction is sign-symmetric).  Keys are never NaN
// (load_column maps NaN to +inf), so with a finite center no distance is
// NaN.  A NaN center (the kept window holds +inf and -inf) makes every
// distance NaN, which the pairwise predicate ranks 0: nobody is dropped.  A
// center of +inf (the kept window holds +inf, so at least b + 1 keys are
// +inf) makes those keys' distances NaN, ranked 0, and every other distance
// +inf; fewer than m - b workers remain to rank among themselves, so no rank
// reaches m - b (and symmetrically for -inf): such a column drops nobody.
// The walk gives the same, since every window then scores NaN (inf - inf at
// one end, or NaN throughout), so W is NaN and no comparison with it holds.
// `dist` enters as the column and holds the distances on return.  All 32
// lanes of every warp call this together, as for tally_trim_drops.
template <int MP>
__device__ __forceinline__ void tally_far_drops(float (&dist)[MP], int m,
                                                bool live, int b,
                                                float center, float width,
                                                int* tally) {
  if (b == 0) return;
  const int lane = threadIdx.x & 31;
  int below = 0;
#pragma unroll
  for (int j = 0; j < MP; ++j) {
    if (j >= m) break;
    dist[j] = fabsf(dist[j] - center);
    below += dist[j] < width ? 1 : 0;
  }
  int seen = 0;  // distances equal to W among workers 0 .. i-1
#pragma unroll
  for (int i = 0; i < MP; ++i) {
    if (i >= m) break;
    const float x = dist[i];
    const bool at = x == width;
    const bool drop = x > width || (at && below + seen >= m - b);
    seen += at ? 1 : 0;
    const unsigned votes = __ballot_sync(0xffffffffu, live && drop);
    if (lane == 0 && votes != 0u) atomicAdd(&tally[i], __popc(votes));
  }
}

// Per-worker trmean drop counts of one block (K4) in O(m) per coordinate,
// the drops of the stable ranks r_i < b or r_i >= m - b.  With
// the stable rank r_i = #{j: key_j < key_i} + #{j < i: key_j == key_i} and
// the sorted column's thresholds lo = sorted[b-1] and hi = sorted[m-b],
// worker i is dropped
// - at the bottom (r_i < b) iff key_i < lo, or key_i == lo and
//   #{j: key_j < lo} + #{j < i: key_j == lo} < b;
// - at the top (r_i >= m - b) iff key_i > hi, or key_i == hi and
//   #{j: key_j < hi} + #{j < i: key_j == hi} >= m - b.
// So two counts over the m real keys and one walk in index order, with
// running counts of the keys equal to lo and to hi, replace the m(m-1)
// pairwise compares.  A warp ballot per worker and __popc count the warp's
// drops, and lane 0 adds them to the block's shared tally.  Keys are never
// NaN (load_column maps NaN to +inf) and +-inf compare exactly; the sorted
// column's first m registers are the m
// real keys in order, since the +inf padding sorts after or ties with them.
// b = 0 drops nothing.  All 32 lanes of every warp must call this together:
// threads past the last coordinate pass live = false, which forces their vote
// to 0.  The early exits test m and b, the same in every thread, so the warp
// never diverges.
template <int MP>
__device__ __forceinline__ void tally_trim_drops(const float (&key)[MP],
                                                 const float (&sorted)[MP],
                                                 int m, bool live, int b,
                                                 int* tally) {
  if (b == 0) return;
  const int lane = threadIdx.x & 31;
  float lo = 0.0f;
  float hi = 0.0f;
#pragma unroll
  for (int i = 0; i < MP; ++i) {
    if (i == b - 1) lo = sorted[i];
    if (i == m - b) hi = sorted[i];
  }
  int below_lo = 0;
  int below_hi = 0;
#pragma unroll
  for (int j = 0; j < MP; ++j) {
    if (j >= m) break;
    below_lo += key[j] < lo ? 1 : 0;
    below_hi += key[j] < hi ? 1 : 0;
  }
  int seen_lo = 0;  // keys equal to lo among workers 0 .. i-1
  int seen_hi = 0;
#pragma unroll
  for (int i = 0; i < MP; ++i) {
    if (i >= m) break;
    const float x = key[i];
    const bool at_lo = x == lo;
    const bool at_hi = x == hi;
    const bool drop = x < lo || (at_lo && below_lo + seen_lo < b) ||
                      x > hi || (at_hi && below_hi + seen_hi >= m - b);
    seen_lo += at_lo ? 1 : 0;
    seen_hi += at_hi ? 1 : 0;
    const unsigned votes = __ballot_sync(0xffffffffu, live && drop);
    if (lane == 0 && votes != 0u) atomicAdd(&tally[i], __popc(votes));
  }
}

// Zero the block's (MP,) shared tally before any warp adds to it.
template <int MP>
__device__ __forceinline__ void zero_tally(int* tally) {
  if (threadIdx.x < MP) tally[threadIdx.x] = 0;
  __syncthreads();
}

// Add the block's tally to the (m,) int32 counts in device memory: one
// integer atomicAdd per worker and block, so the counts do not depend on the
// order in which blocks finish.
template <int MP>
__device__ __forceinline__ void flush_tally(const int* tally, int m,
                                            int* __restrict__ counts) {
  __syncthreads();
  if (threadIdx.x < m && tally[threadIdx.x] != 0) {
    atomicAdd(&counts[threadIdx.x], tally[threadIdx.x]);
  }
}

// The coordinate a thread loads: its own, or for the threads past the last
// coordinate of the last block, the last coordinate, so that every lane
// stays in the warp for the ballots without reading out of bounds.
__device__ __forceinline__ long long clamped_coordinate(long long d,
                                                        bool* live) {
  const long long j =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  *live = j < d;
  return *live ? j : d - 1;
}

}  // namespace repro_torch

// Instantiate KERNEL<MP, T> for the padded worker count and the input dtype of
// one launch.  Buckets: m <= 8, 16, 32, kRegisterMaxM (64); larger m take the
// shared-memory variant (selection_wide.cuh).
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
