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
// sort the center is the masked sum of sorted[b, m-b) over m - 2b.  The m - b
// values nearest the center form one of the b + 1 contiguous windows
// sorted[j, j+k), k = m - b.  Each window is scored by its worst distance
// max(center - sorted[j], sorted[j+k-1] - center) and the strictly smallest
// score wins, so ties go to the leftmost window: exactly
// selection.nearest_window_sum.  The window's upper ends sorted[j+k-1] are
// brought to fixed registers by a log2(MP)-stage barrel shift by the runtime
// k - 1, so no register array is indexed at run time.  The kept window is
// summed as a masked sum in ascending order, never as a total minus the
// dropped values (the TPU extraction variant does that, and a 1e20 row then
// cancels the kept values in f32).
#include "selection.cuh"

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

  const float center = divide(window_sum<MP>(v, b, m - 2 * b), m - 2 * b);
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
  out[j] = divide(window_sum<MP>(v, best_w, k), k);
}

}  // namespace repro_torch

using namespace repro_torch;

// u: row-major (m, d) of `dtype`; out: (d,) f32.  Enqueues one launch on
// `stream` and returns cudaGetLastError() (0 on success).  The caller has
// checked 1 <= m <= 64 and 0 <= b <= (m+1)/2 - 1.
extern "C" int repro_phocas(const void* u, void* out, int m, long long d,
                            int b, int dtype, void* stream_ptr) {
  if (m < 1 || m > 64 || b < 0 || m - 2 * b < 1 || d < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const unsigned grid = static_cast<unsigned>((d + kThreads - 1) / kThreads);
  REPRO_DISPATCH_MP_DTYPE(phocas_kernel, m, dtype, grid, stream,
                          static_cast<float*>(out), m, d, b);
  return static_cast<int>(cudaGetLastError());
}
