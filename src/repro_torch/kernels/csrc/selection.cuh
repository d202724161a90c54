// Register-resident selection helpers shared by the trmean and phocas kernels
// (K1, K2) and their counts variants (K3, K4).
//
// One thread owns one coordinate j of the row-major (m, d) worker matrix.  It
// loads the m values of column j (neighbouring threads read neighbouring
// addresses, so every row load is coalesced across the warp), maps NaN to
// +inf exactly as core/selection.py::worker_rows does, pads the column with
// +inf to the size N of its bucket (next_bucket(m): 4, 8, 12, 16, 20, 24, 32,
// 48 or 64), and sorts it with the Batcher odd-even merge network of the
// reference's src/repro/core/selection.py batcher_pairs(next_pow2(N)), pruned
// to the compare-exchanges whose upper register is < N and expanded at
// compile time.  Every loop below is fully unrolled over compile-time bounds,
// so each v[i] is a fixed register: no dynamically indexed array, no local
// memory.  Where a runtime count (b, m) picks values, the code walks every
// register with a predicate instead of indexing; the one runtime offset, the
// window search's k - 1, indexes shared memory instead (nearest_window_mean).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>
#include <utility>

namespace repro_torch {

constexpr int kThreads = 256;

// The register buckets: m runs the instance of size next_bucket(m), the
// smallest bucket >= m.  Sizes close to the paper's m = 20 and the serving
// run's k = 3 replicas keep the +inf padding, and the work spent on it, small.
__host__ __device__ constexpr int next_bucket(int m) {
  return m <= 4 ? 4 : m <= 8 ? 8 : m <= 12 ? 12 : m <= 16 ? 16
       : m <= 20 ? 20 : m <= 24 ? 24 : m <= 32 ? 32 : m <= 48 ? 48 : 64;
}
// Largest register bucket; larger m take the shared-memory variant
// (selection_wide.cuh).
constexpr int kRegisterMaxM = 64;
static_assert(next_bucket(kRegisterMaxM) == kRegisterMaxM, "bad buckets");

// The bucket below n (0 below the first): bucket N takes m in
// (bucket_floor(N), N].
__host__ __device__ constexpr int bucket_floor(int n) {
  int f = 0;
  for (int x = 1; x < n; ++x) {
    if (next_bucket(x) == x) f = x;
  }
  return f;
}

// dtype codes shared with the Python wrappers (kernels/build.py).
constexpr int kF32 = 0;
constexpr int kF16 = 1;
constexpr int kBF16 = 2;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// jnp.maximum semantics: NaN in either operand gives NaN (fmaxf would drop
// it), in one instruction.  Only the sign of a zero result may differ from
// the comparison chain it replaces, and scores are only compared.
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Whether register i holds a worker in a launch of bucket N: every m of the
// bucket exceeds bucket_floor(N) (next_bucket picks the bucket), so the
// registers up to it always do and need no test.
template <int N>
__device__ __forceinline__ bool real_row(int i, int m) {
  return i <= bucket_floor(N) || i < m;
}

// Issue the loads of column j's m values, raw, walking a row pointer down
// the column; registers m .. N-1 are left unset and never read.
template <int N, typename T>
__device__ __forceinline__ void fetch_column(const T* __restrict__ u, int m,
                                             long long d, long long j,
                                             T (&raw)[N]) {
  const T* p = u + j;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (real_row<N>(i, m)) raw[i] = *p;
    p += d;
  }
}

// The column's keys: f32, NaN mapped to +inf, padded with +inf to N.
template <int N, typename T>
__device__ __forceinline__ void column_keys(const T (&raw)[N], int m,
                                            float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    // fminf returns the other operand for a NaN: NaN -> +inf, the rest as is.
    v[i] = real_row<N>(i, m) ? fminf(to_f32(raw[i]), CUDART_INF_F)
                             : CUDART_INF_F;
  }
}

template <int N, typename T>
__device__ __forceinline__ void load_column(const T* __restrict__ u, int m,
                                            long long d, long long j,
                                            float (&v)[N]) {
  T raw[N];
  fetch_column<N>(u, m, d, j, raw);
  column_keys<N>(raw, m, v);
}

// The Batcher odd-even merge network of the reference's
// batcher_pairs(mp), mp = next_pow2(n), in its order, keeping only the
// compare-exchanges whose upper register is < n: batcher_size(n) of them, the
// t-th between registers batcher_pair(n, t, false) < batcher_pair(n, t,
// true).  Evaluated by the compiler only, so each compare-exchange names
// fixed registers.
//
// Why the pruned pairs may go: registers n .. mp-1 of the full network would
// hold +inf padding (NaN is mapped to +inf on load, so nothing compares
// above it).  A compare-exchange (i, l), i < l, leaves the larger value in l,
// so one whose upper register l holds +inf changes nothing, and neither
// compare-exchanges among the padding nor those with their upper end in it
// move a value into the padding: by induction the padding holds +inf
// throughout and every pair with l >= n is a no-op.  The pruned network thus
// computes what the full one computes on the +inf-padded column, value for
// value, and sorts it.
__host__ __device__ constexpr int batcher_walk(int n, int t, bool hi) {
  int mp = 1;
  while (mp < n) mp <<= 1;
  int c = 0;
  for (int p = 1; p < mp; p <<= 1) {
    for (int k = p; k >= 1; k >>= 1) {
      for (int j = k % p; j < mp - k; j += 2 * k) {
        for (int i = 0; i < k; ++i) {
          if ((i + j) / (2 * p) == (i + j + k) / (2 * p) && i + j + k < n) {
            if (c == t) return hi ? i + j + k : i + j;
            ++c;
          }
        }
      }
    }
  }
  return t < 0 ? -1 : c;  // t past the end: the network's size
}

__host__ __device__ constexpr int batcher_size(int n) {
  return batcher_walk(n, 1 << 30, false);
}

__host__ __device__ constexpr int batcher_pair(int n, int t, bool hi) {
  return batcher_walk(n, t, hi);
}

template <int A, int B, int N>
__device__ __forceinline__ void compare_exchange(float (&v)[N]) {
  static_assert(0 <= A && A < B && B < N, "bad compare-exchange");
  const float a = v[A];
  const float c = v[B];
  v[A] = fminf(a, c);
  v[B] = fmaxf(a, c);
}

template <int N, int... T>
__device__ __forceinline__ void sort_pairs(float (&v)[N],
                                           std::integer_sequence<int, T...>) {
  (compare_exchange<batcher_pair(N, T, false), batcher_pair(N, T, true)>(v),
   ...);
}

// Ascending sort of the +inf-padded column in registers.
template <int N>
__device__ __forceinline__ void sort_network(float (&v)[N]) {
  sort_pairs<N>(v, std::make_integer_sequence<int, batcher_size(N)>{});
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
// The window is a bit mask, one bit a register, so each register's test is
// one instruction.
template <int N>
__device__ __forceinline__ float window_sum(const float (&v)[N], int lo,
                                            int len) {
  using Mask = std::conditional_t<(N <= 32), unsigned, unsigned long long>;
  constexpr int kBits = 8 * sizeof(Mask);
  const Mask keep = (len >= kBits ? ~Mask(0) : (Mask(1) << len) - 1) << lo;
  float s = 0.0f;
#pragma unroll
  for (int p = 0; p < N; ++p) {
    if ((keep >> p) & 1) s += v[p];
  }
  return s;
}

// The b-trimmed mean of the sorted column (Definition 7): the mean of
// sorted[b, m-b), selection.trimmed_mean_of_sorted.
template <int N>
__device__ __forceinline__ float trimmed_mean(const float (&v)[N], int m,
                                              int b) {
  return divide(window_sum<N>(v, b, m - 2 * b), m - 2 * b);
}

// Shared floats per thread for nearest_window_mean's staged upper ends: the
// b + 1 <= (m + 1) / 2 <= (N + 1) / 2 windows' ends.
template <int N>
__host__ __device__ constexpr int window_slots() {
  return (N + 1) / 2;
}

// Phocas (Definition 8) from the sorted column and its b-trimmed mean
// `center`: the mean of the m - b values nearest the center.  They form one
// of the b + 1 contiguous windows sorted[w, w+k), k = m - b.  Each window is
// scored by its worst distance max(center - sorted[w], sorted[w+k-1] -
// center) and the strictly smallest score wins, so ties go to the leftmost
// window: exactly selection.nearest_window_sum.
//
// The windows' upper ends sorted[w+k-1], w = 0..b, sit at the runtime offset
// k - 1, the same in every thread of a launch.  The thread stages them in
// shared memory, slot s = p - (k - 1) of sorted position p at stage[s *
// kThreads + threadIdx.x], so the 32 lanes of a warp hit 32 banks, and reads
// slot w back for window w: b + 1 stores and b + 1 loads take the place of a
// barrel shift of a second register column.  Each thread reads only its own
// slots, so no barrier is needed.  Positions below bucket_floor(N) / 2 are
// never an upper end (k - 1 = m - b - 1 >= (m - 1) / 2 for the smallest m
// of the bucket) and are not looked at; windows start at w <= b < N / 2.
// `width`, where given, receives the winning score: the (m - b)-th smallest
// distance |v - center|, which K3's counts read (tally_far_drops).
template <int N>
__device__ __forceinline__ float nearest_window_mean(const float (&v)[N],
                                                     int m, int b,
                                                     float center,
                                                     float* stage,
                                                     float* width = nullptr) {
  const int k = m - b;
  float* ends = stage + threadIdx.x;
#pragma unroll
  for (int p = bucket_floor(N) / 2; p < N; ++p) {
    if (p >= k - 1 && real_row<N>(p, m)) {
      ends[(p - (k - 1)) * kThreads] = v[p];
    }
  }
  float best = nan_max(center - v[0], ends[0] - center);
  int best_w = 0;
#pragma unroll
  for (int w = 1; w < window_slots<N>(); ++w) {
    if (w <= b) {
      const float score = nan_max(center - v[w], ends[w * kThreads] - center);
      if (score < best) {
        best = score;
        best_w = w;
      }
    }
  }
  if (width != nullptr) *width = best;
  return divide(window_sum<N>(v, best_w, k), k);
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
template <int N>
__device__ __forceinline__ void tally_far_drops(float (&dist)[N], int m,
                                                bool live, int b,
                                                float center, float width,
                                                int* tally) {
  if (b == 0) return;
  const int lane = threadIdx.x & 31;
  int below = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j >= m) break;
    dist[j] = fabsf(dist[j] - center);
    below += dist[j] < width ? 1 : 0;
  }
  int seen = 0;  // distances equal to W among workers 0 .. i-1
#pragma unroll
  for (int i = 0; i < N; ++i) {
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
template <int N>
__device__ __forceinline__ void tally_trim_drops(const float (&key)[N],
                                                 const float (&sorted)[N],
                                                 int m, bool live, int b,
                                                 int* tally) {
  if (b == 0) return;
  const int lane = threadIdx.x & 31;
  // lo = sorted[b-1], the largest of sorted[0, b), and hi = sorted[m-b], the
  // smallest of sorted[m-b, N), as running max/min: picking the register
  // whose index equals b - 1 lets the compiler turn the picks into an indexed
  // load and move the column to local memory.
  float lo = -CUDART_INF_F;
  float hi = CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i < b) lo = fmaxf(lo, sorted[i]);
    if (i >= m - b) hi = fminf(hi, sorted[i]);
  }
  int below_lo = 0;
  int below_hi = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j >= m) break;
    below_lo += key[j] < lo ? 1 : 0;
    below_hi += key[j] < hi ? 1 : 0;
  }
  int seen_lo = 0;  // keys equal to lo among workers 0 .. i-1
  int seen_hi = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
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

// Zero the block's (N,) shared tally before any warp adds to it.
template <int N>
__device__ __forceinline__ void zero_tally(int* tally) {
  if (threadIdx.x < N) tally[threadIdx.x] = 0;
  __syncthreads();
}

// Add the block's tally to the (m,) int32 counts in device memory: one
// integer atomicAdd per worker and block, so the counts do not depend on the
// order in which blocks finish.
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

// One register instance: the bucket size N and the input dtype T.
template <int kN, typename kT>
struct Instance {
  static constexpr int N = kN;
  using T = kT;
};

template <int N, typename F>
inline int launch_with_dtype(int dtype, F& launch) {
  switch (dtype) {
    case kF32: launch(Instance<N, float>{}); return 0;
    case kF16: launch(Instance<N, __half>{}); return 0;
    case kBF16: launch(Instance<N, __nv_bfloat16>{}); return 0;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Call launch(Instance<next_bucket(m), T>{}) for the input dtype of one
// launch, where `launch` enqueues the kernel instance it is handed; 0, or
// cudaErrorInvalidValue for an unknown dtype or m > kRegisterMaxM.
template <int N = next_bucket(1), typename F>
inline int dispatch_register(int m, int dtype, F&& launch) {
  if (m <= N) return launch_with_dtype<N>(dtype, launch);
  if constexpr (N < kRegisterMaxM) {
    return dispatch_register<next_bucket(N + 1)>(m, dtype, launch);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace repro_torch
