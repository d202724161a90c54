// K2: coordinate-wise b-trimmed mean (Definition 7) on Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/trmean/kernel.py
// trmean_pallas (bodies _trmean_kernel, _trmean_kernel_net): (m, d) of f32,
// f16 or bf16 -> (d,) f32, the mean of the middle m - 2b order statistics of
// every coordinate.
//
// Bound: device-memory bytes.  The kernel reads m*d input elements once and
// writes d f32 outputs once, and does O(m log^2 m) register min/max per
// coordinate, far below the card's compute rate at m <= 64.
//
// Design: one thread per coordinate (see selection.cuh).  The column is sorted
// in registers by a fixed Batcher network and the kept window sorted[b, m-b)
// is summed in ascending order as a masked sum, which is the XLA selection
// path's arithmetic (selection.trim_family).  The TPU kernel's extraction
// variant subtracts the dropped values from the column total instead; with a
// 1e20 row that cancels the kept values in f32, and it lets NaN through.  This
// kernel maps NaN to +inf and never subtracts.  The TPU's (m, 2048) VMEM tiles
// and its network-vs-extraction heuristic (use_network) are TPU layout and are
// not carried over.
#include "selection.cuh"

namespace repro_torch {

template <int MP, typename T>
__global__ void __launch_bounds__(kThreads)
    trmean_kernel(const T* __restrict__ u, float* __restrict__ out, int m,
                  long long d, int b) {
  const long long j =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= d) return;
  float v[MP];
  load_column<MP>(u, m, d, j, v);
  sort_network<MP>(v);
  const int kept = m - 2 * b;
  out[j] = divide(window_sum<MP>(v, b, kept), kept);
}

}  // namespace repro_torch

using namespace repro_torch;

// u: row-major (m, d) of `dtype`; out: (d,) f32.  Enqueues one launch on
// `stream` and returns cudaGetLastError() (0 on success).  The caller has
// checked 1 <= m <= 64 and 0 <= b <= (m+1)/2 - 1.
extern "C" int repro_trmean(const void* u, void* out, int m, long long d,
                            int b, int dtype, void* stream_ptr) {
  if (m < 1 || m > 64 || b < 0 || m - 2 * b < 1 || d < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const unsigned grid = static_cast<unsigned>((d + kThreads - 1) / kThreads);
  REPRO_DISPATCH_MP_DTYPE(trmean_kernel, m, dtype, grid, stream,
                          static_cast<float*>(out), m, d, b);
  return static_cast<int>(cudaGetLastError());
}
