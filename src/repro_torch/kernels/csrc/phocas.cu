// K1: Phocas (Definition 8) on Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/phocas/kernel.py
// phocas_pallas (bodies _phocas_kernel, _phocas_kernel_net): (m, d) of f32,
// f16 or bf16 -> (d,) f32, per coordinate the mean of the m - b values
// nearest to the b-trimmed mean.
//
// Bound: device-memory bytes.  The kernel reads m*d input elements once and
// writes d f32 outputs once; its per-coordinate work (one O(m log^2 m)
// register sort plus O(m log m) selects) is far below the card's compute rate
// at m <= 64.
//
// Design: one thread per coordinate (see selection.cuh).  After the register
// sort the center is the masked sum of sorted[b, m-b) over m - 2b, and the
// aggregate the best of the b + 1 windows of the m - b nearest values
// (selection.cuh nearest_window_mean).  The kept window is summed as a
// masked sum in ascending order, never as a total minus the dropped values
// (the TPU extraction variant does that, and a 1e20 row then cancels the
// kept values in f32).  For 64 < m the column moves to shared memory, one
// warp per column (selection_wide.cuh), up to the m whose column still fits a
// block's shared memory.
#include "selection_wide.cuh"

namespace repro_torch {

template <int MP, typename T>
__global__ void __launch_bounds__(kThreads)
    phocas_kernel(const T* __restrict__ u, float* __restrict__ out, int m,
                  long long d, int b) {
  const long long j =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= d) return;
  float v[MP];
  load_column<MP>(u, m, d, j, v);
  sort_network<MP>(v);

  out[j] = nearest_window_mean<MP>(v, m, b, trimmed_mean<MP>(v, m, b));
}

}  // namespace repro_torch

using namespace repro_torch;

// u: row-major (m, d) of `dtype`; out: (d,) f32.  Enqueues one launch on
// `stream` and returns cudaGetLastError() (0 on success).  The caller has
// checked 0 <= b <= (m+1)/2 - 1 and that one column fits a block's shared
// memory: m <= 64 runs the register kernel, 64 < m the shared-memory variant
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
  const unsigned grid = static_cast<unsigned>((d + kThreads - 1) / kThreads);
  REPRO_DISPATCH_MP_DTYPE(phocas_kernel, m, dtype, grid, stream,
                          static_cast<float*>(out), m, d, b);
  return static_cast<int>(cudaGetLastError());
}
