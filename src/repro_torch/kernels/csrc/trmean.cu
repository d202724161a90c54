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
// not carried over.  For 64 < m the column moves to shared memory, one warp
// per column (selection_wide.cuh), up to the m whose column still fits a
// block's shared memory.
#include "selection_wide.cuh"

namespace repro_torch {

template <int N, typename T>
__global__ void __launch_bounds__(kThreads)
    trmean_kernel(const T* __restrict__ u, float* __restrict__ out, int m,
                  long long d, int b) {
  const long long j =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= d) return;
  float v[N];
  load_column<N>(u, m, d, j, v);
  sort_network<N>(v);
  out[j] = trimmed_mean<N>(v, m, b);
}

}  // namespace repro_torch

using namespace repro_torch;

// u: row-major (m, d) of `dtype`; out: (d,) f32.  Enqueues one launch on
// `stream` and returns cudaGetLastError() (0 on success).  The caller has
// checked 0 <= b <= (m+1)/2 - 1 and that one column fits a block's shared
// memory: m <= 64 runs the register kernel, 64 < m the shared-memory variant
// of selection_wide.cuh.
extern "C" int repro_trmean(const void* u, void* out, int m, long long d,
                            int b, int dtype, void* stream_ptr) {
  if (m < 1 || b < 0 || m - 2 * b < 1 || d < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (m > kRegisterMaxM) {
    return launch_wide<kWideTrmean>(u, static_cast<float*>(out),
                                     nullptr, m, d, b, dtype, stream);
  }
  const unsigned grid = static_cast<unsigned>((d + kThreads - 1) / kThreads);
  const int rc = dispatch_register(m, dtype, [&](auto inst) {
    using I = decltype(inst);
    trmean_kernel<I::N, typename I::T><<<grid, kThreads, 0, stream>>>(
        static_cast<const typename I::T*>(u), static_cast<float*>(out), m, d,
        b);
  });
  return rc != 0 ? rc : static_cast<int>(cudaGetLastError());
}
