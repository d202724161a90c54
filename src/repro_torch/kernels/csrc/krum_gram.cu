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
// parallel and in no order, so the sum is split over blocks and joined after
// grid-wide barriers, in one cooperative launch whose blocks are all
// resident at once (at most two an SM):
//
// 1. Partials: block k takes a contiguous chunk of d, whole 256-column tiles,
//    and walks it once per row-block pair (bi <= bj) of 32 rows (one pair
//    while m <= 32).  Tiles are staged in shared memory in a three-stage
//    ring: while the block multiplies one tile, cp.async copies the next two
//    (4-byte copies, since a row of d = 118,282 or 2,430,826 f32 is not
//    16-byte aligned; zero-filled past the chunk and past m).  f16/bf16 are
//    converted to f32 on the way in and staged synchronously.  Each thread
//    owns a 4x4 register tile of (i, j) pairs (the upper triangle of 4-row
//    groups) and a slice of the tile's columns, and reads both operands from
//    shared memory as float4 along the columns: 8 loads feed 64 FMAs (4 on
//    a diagonal tile, whose two operands are the same rows).  At
//    m = 20 the 15 register tiles x 17 column slices keep 255 of the 256
//    threads busy.  Each tile's products are summed from 0 and added to
//    the thread's total once per tile.  At the end of its chunk the block
//    adds its slices' partials in a fixed order through shared memory and
//    writes one (m, m) upper triangle of partial sums to its own slice of a
//    scratch buffer.  The grid is sized by the work: at least four tiles per
//    block, at most two blocks per SM (kernels/build.py gram_blocks).
// 2. Totals, after a grid barrier: one warp per upper-triangle entry sums
//    its partials over the chunks (each lane a strided sum, then a fixed
//    shuffle tree), so each partial is read once, in a fixed order.
// 3. Distances, after a second barrier: d2(i, j) and d2(j, i) are written
//    from one value, so the output is exactly symmetric and its diagonal
//    uses the same n_i as every pair.
//
// No atomics and no float atomics: the result repeats bit for bit from run to
// run, so Krum's argmin does too.  No tensor cores and no TF32: the reference
// holds the Gram form to atol 1e-6 * max + 1e-3, which TF32 would break.  The
// last step keeps the reference's rounding, (n_i + n_j) - 2 G_ij with no
// fused multiply-add, and clamps with v < 0 ? 0 : v so that NaN stays NaN, as
// jnp.maximum keeps it (fmaxf would return 0): two rows at +-1e20 meet as
// inf - inf.
#include <cooperative_groups.h>

#include <type_traits>

#include "residency.cuh"
#include "selection.cuh"

namespace cg = cooperative_groups;

namespace repro_torch {

constexpr int kGramThreads = 256;
constexpr int kGramRows = 32;                 // rows of one row block
constexpr int kGramTile = 256;                // columns of one staged tile
constexpr int kGramStride = kGramTile + 4;    // staged row, 16-byte aligned
constexpr int kGramGroups = kGramTile / 4;    // float4 column groups a tile
constexpr int kGramStages = 3;                // ring: two tiles in flight

// Row a of the row-major upper triangle (with diagonal) of an (r, r) matrix
// that holds index p, and that row's first index.
__host__ __device__ __forceinline__ long long triangle_start(long long r,
                                                             long long a) {
  return a * r - a * (a - 1) / 2;
}

__device__ __forceinline__ int triangle_row(int r, long long p) {
  const double w = 2.0 * r + 1.0;
  int a = static_cast<int>((w - sqrt(w * w - 8.0 * static_cast<double>(p))) *
                           0.5);
  a = max(0, min(a, r - 1));
  if (triangle_start(r, a) > p) --a;
  else if (a + 1 < r && triangle_start(r, a + 1) <= p) ++a;
  return a;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage `rows` rows from row0 of columns [c, c + kGramTile) into s (rows of
// kGramStride floats); rows >= m and columns >= c1 become 0.  Thread t takes
// column c + t of every row, so each warp's row load is coalesced.
template <typename T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ u, int m,
                                           long long d, int row0, int rows,
                                           long long c, long long c1,
                                           float* s) {
  const long long col = c + threadIdx.x;
  for (int r = 0; r < rows; ++r) {
    const bool valid = row0 + r < m && col < c1;
    const long long off = valid ? static_cast<long long>(row0 + r) * d + col
                                : 0;
    float* dst = s + r * kGramStride + threadIdx.x;
    if constexpr (std::is_same<T, float>::value) {
      cp_async4(dst, u + off, valid);
    } else {
      *dst = valid ? to_f32(u[off]) : 0.f;
    }
  }
}

// Sum of partials[k * mm + idx] over the nblocks chunks k by one warp, in
// a fixed order: lane l adds chunks l, l + 32, ... in turn, then a fixed
// shuffle tree; lane 0's value is returned to every lane.
__device__ __forceinline__ float warp_chunk_sum(
    const float* __restrict__ partials, long long mm, int nblocks,
    long long idx) {
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
#pragma unroll 4
  for (int k = lane; k < nblocks; k += 32) {
    acc += partials[static_cast<long long>(k) * mm + idx];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  return __shfl_sync(0xffffffffu, acc, 0);
}

// The (i, j), i <= j, of index p of the row-major upper triangle of (m, m).
__device__ __forceinline__ void triangle_pair(int m, long long p, int* i,
                                              int* j) {
  *i = triangle_row(m, p);
  *j = *i + static_cast<int>(p - triangle_start(m, *i));
}

template <typename T>
__global__ void __launch_bounds__(kGramThreads, 2)
    gram_kernel(const T* __restrict__ u, float* __restrict__ out,
                float* __restrict__ scratch, int m, long long d,
                long long chunk, int rows_a) {
  extern __shared__ __align__(16) float smem[];
  // Ring stages of rows_a (+ kGramRows for an off-diagonal pair) rows.
  const int stage_rows = rows_a + (m > kGramRows ? kGramRows : 0);
  const long long c0 = static_cast<long long>(blockIdx.x) * chunk;
  const long long c1 = c0 + chunk < d ? c0 + chunk : d;
  const int ntiles = c1 > c0 ? static_cast<int>((c1 - c0 + kGramTile - 1) /
                                                kGramTile)
                             : 0;
  const long long mm = static_cast<long long>(m) * m;
  float* part = scratch + static_cast<long long>(blockIdx.x) * mm;
  const int nb = (m + kGramRows - 1) / kGramRows;

  for (int bi = 0; bi < nb; ++bi) {
    for (int bj = bi; bj < nb; ++bj) {
      const bool diag = bi == bj;
      const int ri = min(kGramRows, m - bi * kGramRows);
      const int rj = min(kGramRows, m - bj * kGramRows);
      const int gi = (ri + 3) / 4;
      const int gj = (rj + 3) / 4;
      const int ntile = diag ? gi * (gi + 1) / 2 : gi * gj;
      const int slices = kGramThreads / ntile;
      const int tile = threadIdx.x / slices;
      const int slice = threadIdx.x - tile * slices;
      const bool active = tile < ntile;
      int ta = 0;
      int tb = 0;
      if (active) {
        if (diag) {
          ta = triangle_row(gi, tile);
          tb = ta + tile - static_cast<int>(triangle_start(gi, ta));
        } else {
          ta = tile / gj;
          tb = tile - ta * gj;
        }
      }
      // Row offsets of the thread's x rows (block bi) and y rows (block bj)
      // inside one ring stage.
      const int xrow = 4 * ta;
      const int yrow = diag ? 4 * tb : rows_a + 4 * tb;
      const bool same = xrow == yrow;        // a diagonal 4x4 tile: y is x
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
      }

      auto stage = [&](int t) {
        float* s = smem + (t % kGramStages) * stage_rows * kGramStride;
        const long long c = c0 + static_cast<long long>(t) * kGramTile;
        stage_tile(u, m, d, bi * kGramRows, 4 * gi, c, c1, s);
        if (!diag) {
          stage_tile(u, m, d, bj * kGramRows, 4 * gj, c, c1,
                     s + rows_a * kGramStride);
        }
        cp_async_commit();
      };
      // Tiles t + 1 and t + 2 load while tile t is multiplied.  The stage
      // that tile t + 2 overwrites was last read for tile t - 1, before the
      // barrier that ends that iteration.
      for (int t = 0; t < 2 && t < ntiles; ++t) stage(t);
      for (int t = 0; t < ntiles; ++t) {
        if (t + 2 < ntiles) {
          stage(t + 2);
          cp_async_wait<2>();
        } else if (t + 1 < ntiles) {
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        if (active) {
          // The tile's sums start from 0 and join acc once per tile: with
          // one long chain, data on a coarse grid (bf16 rows) round their
          // ties one way for hundreds of steps, a bias of ~2e-5 of the
          // distances at d = 2.4M.
          float part[4][4] = {};
          const float* s =
              smem + (t % kGramStages) * stage_rows * kGramStride;
          for (int g = slice; g < kGramGroups; g += slices) {
            float4 x[4];
            float4 y[4];
#pragma unroll
            for (int a = 0; a < 4; ++a) {
              x[a] = *reinterpret_cast<const float4*>(
                  s + (xrow + a) * kGramStride + 4 * g);
            }
#pragma unroll
            for (int a = 0; a < 4; ++a) {
              y[a] = same ? x[a]
                          : *reinterpret_cast<const float4*>(
                                s + (yrow + a) * kGramStride + 4 * g);
            }
#pragma unroll
            for (int a = 0; a < 4; ++a) {
#pragma unroll
              for (int b = 0; b < 4; ++b) {
                float v = part[a][b];
                v = fmaf(x[a].x, y[b].x, v);
                v = fmaf(x[a].y, y[b].y, v);
                v = fmaf(x[a].z, y[b].z, v);
                v = fmaf(x[a].w, y[b].w, v);
                part[a][b] = v;
              }
            }
          }
#pragma unroll
          for (int a = 0; a < 4; ++a) {
#pragma unroll
            for (int b = 0; b < 4; ++b) acc[a][b] += part[a][b];
          }
        }
        __syncthreads();
      }

      // The slices' partials, added in slice order through shared memory
      // (the ring is free: every thread is past the last barrier above).
      float* red = smem;
      if (active) {
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          red[(e * ntile + tile) * slices + slice] = acc[e / 4][e % 4];
        }
      }
      __syncthreads();
      for (int q = threadIdx.x; q < 16 * ntile; q += kGramThreads) {
        const int e = q / ntile;
        const int tl = q - e * ntile;
        int qa = 0;
        int qb = 0;
        if (diag) {
          qa = triangle_row(gi, tl);
          qb = qa + tl - static_cast<int>(triangle_start(gi, qa));
        } else {
          qa = tl / gj;
          qb = tl - qa * gj;
        }
        const int i = bi * kGramRows + 4 * qa + e / 4;
        const int j = bj * kGramRows + 4 * qb + e % 4;
        if (i < m && j < m && i <= j) {
          const float* r = red + (e * ntile + tl) * slices;
          float v = 0.f;
          for (int sl = 0; sl < slices; ++sl) v += r[sl];
          part[static_cast<long long>(i) * m + j] = v;
        }
      }
      __syncthreads();
    }
  }

  // Every block's partials are written.  Each upper-triangle entry p is
  // then summed over the chunks by one warp (each partial read once, in a
  // fixed order) into the totals after the partials, and once every total
  // is written, the distances follow from them.
  cg::grid_group grid = cg::this_grid();
  grid.sync();
  const int nblocks = static_cast<int>(gridDim.x);
  const long long npairs = static_cast<long long>(m) * (m + 1) / 2;
  const long long warps = static_cast<long long>(nblocks) * (kGramThreads / 32);
  const long long gw = static_cast<long long>(blockIdx.x) *
                           (kGramThreads / 32) + (threadIdx.x >> 5);
  const bool lane0 = (threadIdx.x & 31) == 0;
  float* totals = scratch + static_cast<long long>(nblocks) * mm;
  for (long long p = gw; p < npairs; p += warps) {
    int i, j;
    triangle_pair(m, p, &i, &j);
    const long long idx = static_cast<long long>(i) * m + j;
    const float t = warp_chunk_sum(scratch, mm, nblocks, idx);
    if (lane0) totals[idx] = t;
  }
  grid.sync();
  for (long long p = gw; p < npairs; p += warps) {
    if (!lane0) continue;
    int i, j;
    triangle_pair(m, p, &i, &j);
    const float ni = totals[static_cast<long long>(i) * m + i];
    const float nj = totals[static_cast<long long>(j) * m + j];
    const float g = totals[static_cast<long long>(i) * m + j];
    float v = __fsub_rn(__fadd_rn(ni, nj), __fmul_rn(2.f, g));
    v = v < 0.f ? 0.f : v;                   // NaN stays NaN
    out[static_cast<long long>(i) * m + j] = v;
    out[static_cast<long long>(j) * m + i] = v;
  }
}

// Dynamic shared memory of one block: the ring of stage_rows-row tiles, or
// the partials' reduction, whichever is larger.
inline size_t gram_smem_bytes(int stage_rows) {
  const size_t ring =
      kGramStages * static_cast<size_t>(stage_rows) * kGramStride * 4;
  const size_t red = 16 * static_cast<size_t>(kGramThreads) * 4;
  return ring > red ? ring : red;
}

constexpr int kGramRingSizes = 2 * kGramRows / 4 + 1;   // stage_rows / 4

// Names resident_blocks' cache of gram_kernel<T>: one slot per ring size.
template <typename T>
struct GramResidency {};

// The SMs of the current device and the blocks of gram_kernel<T> an SM holds
// with a ring of stage_rows rows.  The shared-memory opt-in, set once to the
// largest ring any m needs, and the occupancy query run once per device,
// dtype and ring size (residency.cuh), not at every launch.
template <typename T>
cudaError_t gram_residency(int stage_rows, int* sms, int* per_sm) {
  return resident_blocks<GramResidency<T>, kGramRingSizes>(
      reinterpret_cast<const void*>(gram_kernel<T>), kGramThreads,
      gram_smem_bytes(stage_rows), stage_rows / 4,
      gram_smem_bytes(2 * kGramRows), sms, per_sm);
}

// One cooperative launch: every block must be resident at once for the grid
// barriers, so the block count is capped at what the card holds.
template <typename T>
int launch_gram(const void* u, float* out, float* scratch, int m,
                long long d, int nblocks, cudaStream_t stream) {
  int rows_a = 4 * ((min(m, kGramRows) + 3) / 4);
  const int stage_rows = rows_a + (m > kGramRows ? kGramRows : 0);
  int sms = 0;
  int per_sm = 0;
  const cudaError_t err = gram_residency<T>(stage_rows, &sms, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  nblocks = min(nblocks, per_sm * sms);
  const long long tiles = (d + kGramTile - 1) / kGramTile;
  long long chunk = (tiles + nblocks - 1) / nblocks * kGramTile;
  const T* ut = static_cast<const T*>(u);
  void* args[] = {&ut, &out, &scratch, &m, &d, &chunk, &rows_a};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(gram_kernel<T>), dim3(nblocks),
      dim3(kGramThreads), args, gram_smem_bytes(stage_rows), stream));
}

}  // namespace repro_torch

using namespace repro_torch;

// u: row-major (m, d) of `dtype`; out: (m, m) f32; scratch: (nblocks + 1) *
// m * m f32: each block's upper triangle of partial sums, then the totals.
// Chunks of d are whole 256-column tiles, split over at most `nblocks`
// blocks.  Enqueues one cooperative launch on `stream` and returns its error
// code (0 on success).
extern "C" int repro_krum_gram(const void* u, void* out, void* scratch, int m,
                               long long d, int nblocks, int dtype,
                               void* stream_ptr) {
  if (m < 1 || d < 1 || nblocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  float* o = static_cast<float*>(out);
  float* sc = static_cast<float*>(scratch);
  switch (dtype) {
    case kF32:
      return launch_gram<float>(u, o, sc, m, d, nblocks, stream);
    case kF16:
      return launch_gram<__half>(u, o, sc, m, d, nblocks, stream);
    case kBF16:
      return launch_gram<__nv_bfloat16>(u, o, sc, m, d, nblocks, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
