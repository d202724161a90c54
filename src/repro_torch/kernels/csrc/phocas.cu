// K1: Phocas (Definition 8) on Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/phocas/kernel.py
// phocas_pallas (bodies _phocas_kernel, _phocas_kernel_net): (m, d) of f32,
// f16 or bf16 -> (d,) f32, per coordinate the mean of the m - b values
// nearest to the b-trimmed mean.
//
// Bound: device-memory bytes.  The kernel reads m*d input elements once and
// writes d f32 outputs once.  Its per-coordinate work (the pruned network,
// whose 206 min/max at m = 20 are the largest part, two masked sums and the
// window search) takes issue time of the same order as the byte time on
// this card, so the design cuts instructions and overlaps them with the
// loads.
//
// Design: one thread per coordinate (see selection.cuh), the column padded
// to its bucket N (4, 8, 12, 16, 20, 24, 32, 48 or 64, the smallest >= m) and
// sorted by the reference's Batcher network pruned to N.  The center is the
// masked sum of sorted[b, m-b) over m - 2b; the aggregate is the best of the
// b + 1 windows of the m - b nearest values, whose upper ends the thread
// stages in shared memory at the launch-uniform offset k - 1
// (nearest_window_mean).  The kept window is summed as a masked sum in
// ascending order, never as a total minus the dropped values (the TPU
// extraction variant does that, and a 1e20 row then cancels the kept values
// in f32).  The grid is one wave of resident blocks (resident_blocks); each
// thread walks its columns with a stride of the grid and issues the next
// column's loads before it sorts the current one, so a warp's loads are in
// flight while it computes instead of every warp of a wave loading, then
// computing, in step.  For 64 < m the column moves to shared memory
// (selection_wide.cuh): up to kWarpSortMaxM workers one warp sorts it in
// registers and one thread per column sums it, above that one warp sorts it
// in shared memory, up to the m whose column still fits a block's shared
// memory.
#include "residency.cuh"
#include "selection_wide.cuh"

namespace repro_torch {

template <int N, typename T>
__global__ void __launch_bounds__(kThreads)
    phocas_kernel(const T* __restrict__ u, float* __restrict__ out, int m,
                  long long d, int b) {
  __shared__ float stage[window_slots<N>() * kThreads];
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= d) return;
  T raw[N];
  fetch_column<N>(u, m, d, j, raw);
  for (;;) {
    float v[N];
    column_keys<N>(raw, m, v);
    const long long next = j + step;
    if (next < d) fetch_column<N>(u, m, d, next, raw);  // lands during the sort
    sort_network<N>(v);
    out[j] = nearest_window_mean<N>(v, m, b, trimmed_mean<N>(v, m, b), stage);
    if (next >= d) return;
    j = next;
  }
}

}  // namespace repro_torch

using namespace repro_torch;

// u: row-major (m, d) of `dtype`; out: (d,) f32.  Enqueues one launch on
// `stream` and returns cudaGetLastError() (0 on success).  The caller has
// checked 0 <= b <= (m+1)/2 - 1 and that one column fits a block's shared
// memory: m <= 64 runs the register kernel, 64 < m the shared-memory variants
// of selection_wide.cuh.
extern "C" int repro_phocas(const void* u, void* out, int m, long long d,
                            int b, int dtype, void* stream_ptr) {
  if (m < 1 || b < 0 || m - 2 * b < 1 || d < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (m > kRegisterMaxM) {
    return launch_wide<kWidePhocas>(u, static_cast<float*>(out),
                                     nullptr, m, d, b, dtype, stream);
  }
  cudaError_t err = cudaSuccess;
  const int rc = dispatch_register(m, dtype, [&](auto inst) {
    using I = decltype(inst);
    int sms = 0;
    int per_sm = 0;
    err = resident_blocks<I>(
        reinterpret_cast<const void*>(phocas_kernel<I::N, typename I::T>),
        kThreads, 0, 0, 0, &sms, &per_sm);
    if (err != cudaSuccess) return;
    const long long wave = static_cast<long long>(sms) * per_sm;
    const long long need = (d + kThreads - 1) / kThreads;
    const unsigned grid = static_cast<unsigned>(need < wave ? need : wave);
    phocas_kernel<I::N, typename I::T><<<grid, kThreads, 0, stream>>>(
        static_cast<const typename I::T*>(u), static_cast<float*>(out), m, d,
        b);
  });
  if (rc != 0) return rc;
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
