// K4: coordinate-wise b-trimmed mean plus per-worker drop counts on Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/trmean/kernel.py
// trmean_counts_pallas (body _trmean_counts_kernel): (m, d) of f32, f16 or
// bf16 -> ((d,) f32 trimmed mean, (m,) counts), where counts[i] is the number
// of coordinates at which worker i was among the b smallest or the b largest
// values.  The counts are the defense's suspicion statistic.
//
// Bound: device-memory bytes.  The kernel reads m*d input elements once and
// writes d f32 outputs and m counts once.  Per coordinate it does the K2
// register sort plus about 8m compares for the counts, far below the memory
// time at the card's f32 rate.
//
// Design: one thread per coordinate, as K2 (see selection.cuh).  The thread
// keeps the column unsorted in one register array and sorts a copy in
// another.  The aggregate comes from the sorted copy exactly as in K2, so it
// equals the plain version bit for bit.  A worker is dropped at this coordinate
// when the stable rank of its value, among the m real values, is below b or at
// least m - b: the index-stable tie rule of the reference (ties drop the
// highest worker index first), never the value-only sorted order.  The drops
// come in O(m) (tally_trim_drops): the thresholds sorted[b-1] and sorted[m-b]
// are read off the sorted copy, the keys below each are counted once, and one
// walk in worker order settles the keys equal to a threshold by their running
// count.  The pairwise ranks this replaces took m(m-1) compares per coordinate
// (about 570 at m = 20) with both register arrays live: 3.5x K2's time at the
// CNN width on an H100.  What remains over K2's time is the walk, issued for
// every coordinate: per worker a few compares, a ballot and a tally update.
// The drops are counted with a warp ballot and __popc per worker, an int32
// shared tally per block, and one atomicAdd per worker and block into the
// (m,) 64-bit buffer that the wrapper zeroes (past 2^31 coordinates a
// worker's count outgrows int32).  The TPU's 128-lane counts row,
// per-block partial counts and extraction variant are TPU layout and are
// not carried over.  For 64 < m the column moves to shared memory
// and the counts come from a sort of (value, worker) pairs
// (selection_wide.cuh).
#include "selection_wide.cuh"

namespace repro_torch {

template <int N, typename T>
__global__ void __launch_bounds__(kThreads)
    trmean_counts_kernel(const T* __restrict__ u, float* __restrict__ out,
                         unsigned long long* __restrict__ counts, int m,
                         long long d,
                         int b) {
  __shared__ int tally[N];
  zero_tally<N>(tally);
  bool live;
  const long long j = clamped_coordinate(d, &live);
  float key[N];
  load_column<N>(u, m, d, j, key);
  float v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = key[i];
  sort_network<N>(v);
  const float agg = trimmed_mean<N>(v, m, b);
  if (live) out[j] = agg;
  tally_trim_drops<N>(key, v, m, live, b, tally);
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
extern "C" int repro_trmean_counts(const void* u, void* out, void* counts,
                                   int m, long long d, int b, int dtype,
                                   void* stream_ptr) {
  if (m < 1 || b < 0 || m - 2 * b < 1 || d < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (m > kRegisterMaxM) {
    return launch_wide<kWideTrmeanCounts>(
        u, static_cast<float*>(out), static_cast<unsigned long long*>(counts),
        m, d, b, dtype, stream);
  }
  const unsigned grid = static_cast<unsigned>((d + kThreads - 1) / kThreads);
  const int rc = dispatch_register(m, dtype, [&](auto inst) {
    using I = decltype(inst);
    trmean_counts_kernel<I::N, typename I::T><<<grid, kThreads, 0, stream>>>(
        static_cast<const typename I::T*>(u), static_cast<float*>(out),
        static_cast<unsigned long long*>(counts), m, d, b);
  });
  return rc != 0 ? rc : static_cast<int>(cudaGetLastError());
}
