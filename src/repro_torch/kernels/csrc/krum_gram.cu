// K5: Krum's pairwise squared distances via a split-K Gram product on Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/krum/kernel.py
// pairwise_sq_dists_pallas (body _gram_kernel): (m, d) of f32, f16 or bf16 ->
// (m, m) f32, d2(i, j) = max(n_i + n_j - 2 G_ij, 0) with G = U U^T and
// n_i = G_ii, for any m.
//
// Bound: device-memory bytes.  The m*d input elements are read once; the
// m(m+1)/2 products per coordinate (210 at m = 20) stay below the card's f32
// rate outside the tensor cores, and the (m, m) output is tiny.
//
// Design.  The TPU kernel walks d sequentially on one core and carries the
// (m, m) sum in VMEM from one grid step to the next.  Blocks on Hopper run in
// parallel and in no order, so the sum is split in two launches:
//
// 1. gram_partials: block k takes a contiguous chunk of d.  It stages
//    (32 rows, 64 columns) tiles of the matrix in shared memory with
//    coalesced loads (row stride 65, so threads reading different rows at one
//    column hit different banks), and each thread owns up to four (i, j >= i)
//    pairs of the upper triangle, accumulating them in registers in column
//    order with fmaf.  For m > 32 the rows are taken 32 at a time, one block
//    pair (bi <= bj) after another, each over the whole chunk.  The block
//    writes its m(m+1)/2 partial sums to its own row of a scratch buffer.
// 2. gram_epilogue: one block per pair sums the partials of the chunks in a
//    fixed order (a strided sum per thread, then a fixed shared-memory tree),
//    does the same for the pair's two diagonal entries, applies the
//    epilogue and writes d2(i, j) and d2(j, i) from one value, so the output
//    is exactly symmetric and its diagonal uses the same n_i as every pair.
//
// No float atomics anywhere: the result repeats bit for bit from run to run,
// so Krum's argmin does too.  No tensor cores and no TF32: the reference holds
// the Gram form to atol 1e-6 * max + 1e-3, which TF32 would break.  The
// epilogue keeps the reference's rounding, (n_i + n_j) - 2 G_ij with no fused
// multiply-add, and clamps with v < 0 ? 0 : v so that NaN stays NaN, as
// jnp.maximum keeps it (fmaxf would return 0): two rows at +-1e20 meet as
// inf - inf.
#include "selection.cuh"

namespace repro_torch {

constexpr int kGramThreads = 256;
constexpr int kGramRows = 32;                 // rows of one staged tile
constexpr int kGramTile = 64;                 // columns of one staged tile
constexpr int kGramSlots = kGramRows * kGramRows / kGramThreads;  // pairs/thread

__host__ __device__ __forceinline__ long long pair_index(int m, int i,
                                                         int j) {
  // Row-major index of (i, j), i <= j, in the upper triangle of an (m, m).
  return static_cast<long long>(i) * m - static_cast<long long>(i) * (i - 1) / 2 +
         (j - i);
}

// First index of row a in the row-major upper triangle (with diagonal) of an
// (r, r) matrix, and the row that holds index p: a closed form, corrected by
// one step either way for the rounding of sqrtf (no loop, so the callers'
// per-slot arrays stay in registers).
__device__ __forceinline__ int triangle_start(int r, int a) {
  return a * r - a * (a - 1) / 2;
}

__device__ __forceinline__ int triangle_row(int r, int p) {
  const float w = static_cast<float>(2 * r + 1);
  int a = static_cast<int>((w - sqrtf(w * w - 8.f * p)) * 0.5f);
  a = max(0, min(a, r - 1));
  if (triangle_start(r, a) > p) --a;
  else if (a + 1 < r && triangle_start(r, a + 1) <= p) ++a;
  return a;
}

template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ u,
                                           long long d, int row0, int rows,
                                           long long c, int width,
                                           float (*s)[kGramTile + 1]) {
  for (int e = threadIdx.x; e < rows * kGramTile; e += kGramThreads) {
    const int r = e / kGramTile;
    const int k = e % kGramTile;
    s[r][k] = k < width
                  ? to_f32(u[static_cast<long long>(row0 + r) * d + c + k])
                  : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kGramThreads)
    gram_partials(const T* __restrict__ u, float* __restrict__ partials,
                  int m, long long d, long long chunk) {
  __shared__ float si[kGramRows][kGramTile + 1];
  __shared__ float sj[kGramRows][kGramTile + 1];
  const long long c0 = static_cast<long long>(blockIdx.x) * chunk;
  const long long c1 = c0 + chunk < d ? c0 + chunk : d;
  const long long npairs = static_cast<long long>(m) * (m + 1) / 2;
  float* part = partials + static_cast<long long>(blockIdx.x) * npairs;
  const int nb = (m + kGramRows - 1) / kGramRows;

  for (int bi = 0; bi < nb; ++bi) {
    for (int bj = bi; bj < nb; ++bj) {
      const bool diag = bi == bj;
      const int ri = min(kGramRows, m - bi * kGramRows);
      const int rj = min(kGramRows, m - bj * kGramRows);
      const int np = diag ? ri * (ri + 1) / 2 : ri * rj;
      int pa[kGramSlots], pb[kGramSlots];
      float acc[kGramSlots];
#pragma unroll
      for (int s = 0; s < kGramSlots; ++s) {
        int p = threadIdx.x + s * kGramThreads;
        acc[s] = 0.f;
        pa[s] = -1;
        pb[s] = -1;
        if (p < np) {
          if (diag) {
            const int a = triangle_row(ri, p);
            pa[s] = a;
            pb[s] = a + p - triangle_start(ri, a);
          } else {
            pa[s] = p / rj;
            pb[s] = p % rj;
          }
        }
      }
      float(*tj)[kGramTile + 1] = diag ? si : sj;
      for (long long c = c0; c < c1; c += kGramTile) {
        const int width =
            static_cast<int>(c1 - c < kGramTile ? c1 - c : kGramTile);
        stage_rows(u, d, bi * kGramRows, ri, c, width, si);
        if (!diag) stage_rows(u, d, bj * kGramRows, rj, c, width, sj);
        __syncthreads();
#pragma unroll
        for (int s = 0; s < kGramSlots; ++s) {
          if (pa[s] >= 0) {
            const float* x = si[pa[s]];
            const float* y = tj[pb[s]];
            float t = 0.f;        // the tile's 64 products, then the chunk's
#pragma unroll 16
            for (int k = 0; k < kGramTile; ++k) t = fmaf(x[k], y[k], t);
            acc[s] += t;
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int s = 0; s < kGramSlots; ++s) {
        if (pa[s] >= 0) {
          part[pair_index(m, bi * kGramRows + pa[s], bj * kGramRows + pb[s])] =
              acc[s];
        }
      }
    }
  }
}

// Sum of partials[k * npairs + idx] over the chunks k, in a fixed order: a
// strided sum per thread, then a fixed tree over the block.
__device__ __forceinline__ float chunk_sum(const float* __restrict__ partials,
                                          long long npairs, int nblocks,
                                          long long idx, float* red) {
  float acc = 0.f;
  for (int k = threadIdx.x; k < nblocks; k += kGramThreads) {
    acc += partials[static_cast<long long>(k) * npairs + idx];
  }
  red[threadIdx.x] = acc;
  __syncthreads();
#pragma unroll
  for (int w = kGramThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  const float total = red[0];
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kGramThreads)
    gram_epilogue(const float* __restrict__ partials, float* __restrict__ out,
                  int m, int nblocks) {
  __shared__ float red[kGramThreads];
  const long long npairs = static_cast<long long>(m) * (m + 1) / 2;
  long long p = blockIdx.x;                  // p -> (i, j), i <= j
  int i = 0;
  while (p >= m - i) {
    p -= m - i;
    ++i;
  }
  const int j = i + static_cast<int>(p);
  const float g = chunk_sum(partials, npairs, nblocks, pair_index(m, i, j),
                            red);
  const float ni = chunk_sum(partials, npairs, nblocks, pair_index(m, i, i),
                             red);
  const float nj = chunk_sum(partials, npairs, nblocks, pair_index(m, j, j),
                             red);
  if (threadIdx.x == 0) {
    float v = __fsub_rn(__fadd_rn(ni, nj), __fmul_rn(2.f, g));
    v = v < 0.f ? 0.f : v;                   // NaN stays NaN
    out[static_cast<long long>(i) * m + j] = v;
    out[static_cast<long long>(j) * m + i] = v;
  }
}

}  // namespace repro_torch

using namespace repro_torch;

// u: row-major (m, d) of `dtype`; out: (m, m) f32; scratch: nblocks *
// m(m+1)/2 f32, fully written by the first launch.  Chunks of d are whole
// 64-column tiles, split over `nblocks` blocks.  Enqueues two launches on
// `stream` and returns cudaGetLastError() after each (0 on success).
extern "C" int repro_krum_gram(const void* u, void* out, void* scratch, int m,
                               long long d, int nblocks, int dtype,
                               void* stream_ptr) {
  if (m < 1 || d < 1 || nblocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long tiles = (d + kGramTile - 1) / kGramTile;
  const long long chunk = (tiles + nblocks - 1) / nblocks * kGramTile;
  float* partials = static_cast<float*>(scratch);
  switch (dtype) {
    case kF32:
      gram_partials<float><<<nblocks, kGramThreads, 0, stream>>>(
          static_cast<const float*>(u), partials, m, d, chunk);
      break;
    case kF16:
      gram_partials<__half><<<nblocks, kGramThreads, 0, stream>>>(
          static_cast<const __half*>(u), partials, m, d, chunk);
      break;
    case kBF16:
      gram_partials<__nv_bfloat16><<<nblocks, kGramThreads, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(u), partials, m, d, chunk);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long npairs = static_cast<long long>(m) * (m + 1) / 2;
  gram_epilogue<<<static_cast<unsigned>(npairs), kGramThreads, 0, stream>>>(
      partials, static_cast<float*>(out), m, nblocks);
  return static_cast<int>(cudaGetLastError());
}
