// K3: Phocas plus per-worker drop counts on Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/phocas/kernel.py
// phocas_counts_pallas (body _phocas_counts_kernel, with _drop_farthest):
// (m, d) of f32, f16 or bf16 -> ((d,) f32 Phocas aggregate, (m,) counts),
// where counts[i] is the number of coordinates at which worker i was among
// the b values farthest from the b-trimmed mean.  The counts are the
// defense's suspicion statistic.
//
// Bound: device-memory bytes.  The kernel reads m*d input elements once and
// writes d f32 outputs and m counts once.  Per coordinate it does the K1
// register work plus about 4m operations for the counts, below the memory
// time at the card's f32 rate.
//
// Design: one thread per coordinate for m <= 64, as K1 (see selection.cuh).
// The thread keeps the column unsorted in one register array and sorts a copy
// in another.  Center and aggregate come from the sorted copy exactly as in
// K1, so they equal the plain version bit for bit.  A worker is dropped at
// this coordinate when the stable rank of its distance |v - center|, among
// the m real workers, is at least m - b: ties drop the highest worker index
// first, as in the reference.  The drops come in O(m) (tally_far_drops): the
// best window's score W is the (m - b)-th smallest distance, the distances
// below W are counted once, and one walk in worker order settles the
// distances equal to W by their running count.  The pairwise ranks this
// replaces took m(m-1) compares per coordinate (about 380 at m = 20): 2.6x
// K1's time at the MLP width on an H100.  At a boundary distance tie the
// aggregate (leftmost window) and the counts (index-stable rank) can name
// different workers; the reference's plain path does the same.  The drops
// are counted with a warp ballot and __popc per worker, an int32 shared
// tally per block, and one atomicAdd per worker and block into the (m,)
// 64-bit buffer that the wrapper zeroes (past 2^31 coordinates a worker's
// count outgrows int32).  For 64 < m the column moves to shared
// memory and the counts come from a sort of (distance, worker) pairs
// (selection_wide.cuh).
#include "selection_wide.cuh"

namespace repro_torch {

template <int N, typename T>
__global__ void __launch_bounds__(kThreads)
    phocas_counts_kernel(const T* __restrict__ u, float* __restrict__ out,
                         unsigned long long* __restrict__ counts, int m,
                         long long d,
                         int b) {
  __shared__ int tally[N];
  __shared__ float stage[window_slots<N>() * kThreads];
  zero_tally<N>(tally);
  bool live;
  const long long j = clamped_coordinate(d, &live);
  float key[N];
  load_column<N>(u, m, d, j, key);
  float v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = key[i];
  sort_network<N>(v);
  const float center = trimmed_mean<N>(v, m, b);
  float width;
  const float agg = nearest_window_mean<N>(v, m, b, center, stage, &width);
  if (live) out[j] = agg;
  tally_far_drops<N>(key, m, live, b, center, width, tally);
  flush_tally(tally, m, counts);
}

}  // namespace repro_torch

using namespace repro_torch;

// u: row-major (m, d) of `dtype`; out: (d,) f32; counts: (m,) 64-bit, zeroed
// by the caller.  Enqueues one launch on `stream` and returns
// cudaGetLastError() (0 on success).  The caller has checked 0 <= b <= (m+1)/2
// - 1 and that the column fits a block's shared memory (kernels/build.py
// MAX_M): m <= 64 runs the register kernel, 64 < m the shared-memory variant
// of selection_wide.cuh.
extern "C" int repro_phocas_counts(const void* u, void* out, void* counts,
                                   int m, long long d, int b, int dtype,
                                   void* stream_ptr) {
  if (m < 1 || b < 0 || m - 2 * b < 1 || d < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (m > kRegisterMaxM) {
    return launch_wide<kWidePhocasCounts>(
        u, static_cast<float*>(out), static_cast<unsigned long long*>(counts),
        m, d, b, dtype, stream);
  }
  const unsigned grid = static_cast<unsigned>((d + kThreads - 1) / kThreads);
  const int rc = dispatch_register(m, dtype, [&](auto inst) {
    using I = decltype(inst);
    phocas_counts_kernel<I::N, typename I::T><<<grid, kThreads, 0, stream>>>(
        static_cast<const typename I::T*>(u), static_cast<float*>(out),
        static_cast<unsigned long long*>(counts), m, d, b);
  });
  return rc != 0 ? rc : static_cast<int>(cudaGetLastError());
}
