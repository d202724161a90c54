// K6: forward flash attention (causal, optional sliding window, optional
// tanh soft-cap, grouped-query heads) on Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flashattn/kernel.py
// flash_attention_pallas (body _flash_kernel): q (B, S, H, hd) and k/v
// (B, T, Kv, hd) of f32, f16 or bf16 -> o (B, S, H, hd) in q's dtype, query
// head h reading kv head h / (H / Kv), query i and key j at positions i, j.
//
// Bound.  The larger of two times: the bytes of q, k and v read once and o
// written once over 3.35 TB/s, and the tensor-core operations, 4 * hd per
// unmasked (query, key) pair and head (two products of hd multiply-adds),
// over 989 TFLOP/s in bf16.  At the serving path's prefill, (B 8, S 512,
// H 32, Kv 8, hd 128) in bf16, that is 83.9 MB against 17.2 GFLOP: 25.0 us,
// bound by bytes.  At (B 1, S 4096), 137.5 GFLOP: 139 us, bound by
// operations.
//
// Numerics follow the Pallas kernel: scores in f32 times `scale`, then
// cap * tanhf(s / cap) when a cap is set; masked scores set to the finite
// kNegInf = -1e30; an online softmax with a running max m, denominator l
// and f32 accumulator per query row (l sums the f32 p; p is rounded to v's
// dtype before the p.v product); the output acc / max(l, 1e-30) cast to q's
// dtype.
//
// Design.  The TPU kernel walks the key blocks of one (512, 512) tile pair
// sequentially in its grid and keeps (m, l, acc) in VMEM between grid
// steps.  Here one block owns one (batch * head, 64-query tile) and loops
// over 64-key tiles itself, so nothing carries over between blocks and no
// block splits the keys: no atomics, and every output repeats bit for bit.
// - Shared memory holds the block's Q tile, the current K and V tiles, the
//   f32 scores, the rounded p and the f32 accumulator.  Each warp owns 16
//   query rows: their scores, p and accumulator rows are private to it, so
//   only the K/V staging needs the block's barriers.
// - bf16/f16: S = Q K^T and acc += P V with nvcuda::wmma 16x16x16
//   fragments, f32 accumulation (the accumulator tile is loaded from and
//   stored to shared memory around each product, which is what lets the
//   softmax rescale its rows).  f32: the same two products in plain f32
//   fmaf, no TF32, so f32 holds the reference's 2e-3.
// - The softmax walks the warp's 16 rows one at a time with the lanes
//   across the key columns (one warp shuffle tree for the row max and one
//   for the row sum); every lane keeps the 16 rows' (m, l) in registers.
//   The rescale and the final write also put the lanes across hd, so the
//   shared-memory accesses and the output stores are contiguous.
// - Shared-memory rows are padded by 16 bytes (4 floats, 8 halves), so the
//   rows of a 16x16 fragment do not all start in the same bank.
// - Key tiles that the causal or the window mask empties for every row of
//   the block are skipped.  The Pallas kernel computes them and its later
//   `correction` wipes their contribution; a row whose first tiles are all
//   masked gets p = exp(0) = 1 garbage against m = -1e30 here too, which
//   the first tile holding one of its keys multiplies by exp(-1e30 - m) = 0.
// - Ragged edges are masked in the kernel: query rows past S are staged as
//   zeros and never written, keys past T are staged as zeros and masked,
//   so the wrapper pads and copies nothing.
// - Templates over hd in {64, 128, 256}; 64-row query tiles and 64-key
//   tiles except f32 at hd 256, which takes 32 x 32 to fit 139 KB of
//   shared memory (above 48 KB needs cudaFuncSetAttribute, set at launch).
// - The heaviest causal query tiles (the last ones) are launched first.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace repro_torch {
namespace flash {

using namespace nvcuda;

constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, T, H, Kv;
  long long qs[3], ks[3], vs[3];  // strides in elements: batch, position, head
  float scale;
  int causal;
  int window;                     // 0 = no window
  float cap;                      // 0 = no soft-cap
};

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Tile sizes and padded shared-memory row strides (elements) of one
// instance.
template <typename T, int HD> struct Tiles {
  static constexpr int BQ = 64;
  static constexpr int BK = 64;
};
template <> struct Tiles<float, 256> {
  static constexpr int BQ = 32;
  static constexpr int BK = 32;
};

template <typename T, int HD, int BQ, int BK> struct Layout {
  static constexpr int kPadT = 16 / sizeof(T);   // 16 bytes of T
  static constexpr int LDQ = HD + kPadT;          // Q, K, V rows
  static constexpr int LDP = BK + kPadT;          // rounded p rows
  static constexpr int LDS = BK + 4;              // f32 score rows
  static constexpr int LDO = HD + 4;              // f32 accumulator rows
  static constexpr size_t kBytes =
      sizeof(T) * (static_cast<size_t>(BQ + 2 * BK) * LDQ +
                   static_cast<size_t>(BQ) * LDP) +
      sizeof(float) * static_cast<size_t>(BQ) * (LDS + LDO);
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stage `rows` rows of HD elements (global row stride `stride`) into dst
// (row stride LD) with 16-byte loads; rows at or past `valid` become zeros.
template <typename T, int HD, int LD, int NT>
__device__ __forceinline__ void stage_rows(T* dst, const T* src,
                                           long long stride, int rows,
                                           int valid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = HD / kVec;
  for (int i = threadIdx.x; i < rows * kPerRow; i += NT) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) {
      val = *reinterpret_cast<const uint4*>(src + r * stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// One warp's scores: s[16][BK] = q[16][HD] . k[BK][HD]^T, unscaled, in f32.
template <typename T, int HD, int BK, typename L>
__device__ __forceinline__ void warp_scores(const T* sq, const T* sk,
                                            float* ss, int lane) {
  if constexpr (std::is_same<T, float>::value) {
    const int r = lane >> 1;
    const int c0 = (lane & 1) * (BK / 2);
    const float* qrow = sq + r * L::LDQ;
    for (int c = c0; c < c0 + BK / 2; ++c) {
      const float* krow = sk + c * L::LDQ;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) acc = fmaf(qrow[d], krow[d], acc);
      ss[r * L::LDS + c] = acc;
    }
  } else {
#pragma unroll 1
    for (int j = 0; j < BK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.0f);
#pragma unroll 4
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> b;
        wmma::load_matrix_sync(a, sq + kk * 16, L::LDQ);
        wmma::load_matrix_sync(b, sk + j * 16 * L::LDQ + kk * 16, L::LDQ);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(ss + j * 16, c, L::LDS, wmma::mem_row_major);
    }
  }
}

// One warp's accumulator update: acc[16][HD] += p[16][BK] . v[BK][HD].
template <typename T, int HD, int BK, typename L>
__device__ __forceinline__ void warp_pv(const T* sp, const T* sv, float* so,
                                        int lane) {
  if constexpr (std::is_same<T, float>::value) {
    const int r = lane >> 1;
    const int d0 = (lane & 1) * (HD / 2);
    const float* prow = sp + r * L::LDP;
    for (int d = d0; d < d0 + HD / 2; ++d) {
      float acc = so[r * L::LDO + d];
#pragma unroll 8
      for (int j = 0; j < BK; ++j) acc = fmaf(prow[j], sv[j * L::LDQ + d], acc);
      so[r * L::LDO + d] = acc;
    }
  } else {
#pragma unroll 1
    for (int j = 0; j < HD / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::load_matrix_sync(c, so + j * 16, L::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b;
        wmma::load_matrix_sync(a, sp + kk * 16, L::LDP);
        wmma::load_matrix_sync(b, sv + kk * 16 * L::LDQ + j * 16, L::LDQ);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(so + j * 16, c, L::LDO, wmma::mem_row_major);
    }
  }
}

template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(BQ / 16 * 32) flash_fwd(Params p) {
  using L = Layout<T, HD, BQ, BK>;
  constexpr int NT = BQ / 16 * 32;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + BQ * L::LDQ;
  T* sV = sK + BK * L::LDQ;
  T* sP = sV + BK * L::LDQ;
  float* sS = reinterpret_cast<float*>(sP + BQ * L::LDP);
  float* sO = sS + BQ * L::LDS;

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kvh = h / (p.H / p.Kv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int w0 = q0 + warp * 16;              // the warp's first query
  T* sPw = sP + warp * 16 * L::LDP;
  float* sSw = sS + warp * 16 * L::LDS;
  float* sOw = sO + warp * 16 * L::LDO;

  const T* qb = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[2];
  const T* kb = static_cast<const T*>(p.k) + b * p.ks[0] + kvh * p.ks[2];
  const T* vb = static_cast<const T*>(p.v) + b * p.vs[0] + kvh * p.vs[2];
  stage_rows<T, HD, L::LDQ, NT>(sQ, qb + q0 * p.qs[1], p.qs[1], BQ,
                                min(BQ, p.S - q0));
  for (int i = threadIdx.x; i < BQ * L::LDO; i += NT) sO[i] = 0.f;

  // Key tiles holding at least one unmasked key for some row of the block.
  int kend = p.T;
  if (p.causal) kend = min(kend, min(q0 + BQ, p.S));
  const int kbeg = p.window > 0 ? max(0, q0 - p.window + 1) / BK * BK : 0;

  // Running max and denominator of the warp's 16 rows, in every lane.
  float m[16], l[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tiles
    const int valid = min(BK, p.T - k0);
    stage_rows<T, HD, L::LDQ, NT>(sK, kb + k0 * p.ks[1], p.ks[1], BK, valid);
    stage_rows<T, HD, L::LDQ, NT>(sV, vb + k0 * p.vs[1], p.vs[1], BK, valid);
    __syncthreads();

    warp_scores<T, HD, BK, L>(sQ + warp * 16 * L::LDQ, sK, sSw, lane);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int qp = w0 + r;
      float s[BK / 32];
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < BK / 32; ++i) {
        const int kp = k0 + lane + 32 * i;
        float x = sSw[r * L::LDS + lane + 32 * i] * p.scale;
        if (p.cap > 0.f) x = p.cap * tanhf(x / p.cap);
        bool ok = kp < p.T;
        if (p.causal) ok = ok && kp <= qp;
        if (p.window > 0) ok = ok && kp > qp - p.window;
        s[i] = ok ? x : kNegInf;
        mx = fmaxf(mx, s[i]);
      }
      const float m_new = fmaxf(m[r], warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 32; ++i) {
        const float e = expf(s[i] - m_new);
        sum += e;
        sPw[r * L::LDP + lane + 32 * i] = from_f32<T>(e);
      }
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int d = lane; d < HD; d += 32) sOw[r * L::LDO + d] *= corr;
    }
    __syncwarp();
    warp_pv<T, HD, BK, L>(sPw, sV, sOw, lane);
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int qp = w0 + r;
    if (qp < p.S) {
      const float denom = fmaxf(l[r], 1e-30f);
      T* ob = static_cast<T*>(p.o) +
              ((static_cast<long long>(b) * p.S + qp) * p.H + h) * HD;
#pragma unroll
      for (int d = lane; d < HD; d += 32) {
        ob[d] = from_f32<T>(sOw[r * L::LDO + d] / denom);
      }
    }
  }
}

template <typename T, int HD>
int launch(const Params& p, int B, void* stream) {
  constexpr int BQ = Tiles<T, HD>::BQ;
  constexpr int BK = Tiles<T, HD>::BK;
  constexpr size_t kSmem = Layout<T, HD, BQ, BK>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, HD, BQ, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * p.H, (p.S + BQ - 1) / BQ);
  flash_fwd<T, HD, BQ, BK><<<grid, BQ / 16 * 32, kSmem,
                             static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const Params& p, int B, int hd, void* stream) {
  switch (hd) {
    case 64: return launch<T, 64>(p, B, stream);
    case 128: return launch<T, 128>(p, B, stream);
    case 256: return launch<T, 256>(p, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace flash
}  // namespace repro_torch

extern "C" int repro_flash_attn(const void* q, const void* k, const void* v,
                                void* o, int B, int S, int T, int H, int Kv,
                                int hd, long long qsb, long long qss,
                                long long qsh, long long ksb, long long kss,
                                long long ksh, long long vsb, long long vss,
                                long long vsh, float scale, int causal,
                                int window, float cap, int dtype,
                                void* stream) {
  using repro_torch::flash::Params;
  using repro_torch::flash::launch_hd;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.S = S;
  p.T = T;
  p.H = H;
  p.Kv = Kv;
  p.qs[0] = qsb; p.qs[1] = qss; p.qs[2] = qsh;
  p.ks[0] = ksb; p.ks[1] = kss; p.ks[2] = ksh;
  p.vs[0] = vsb; p.vs[1] = vss; p.vs[2] = vsh;
  p.scale = scale;
  p.causal = causal;
  p.window = window;
  p.cap = cap;
  switch (dtype) {
    case 0: return launch_hd<float>(p, B, hd, stream);
    case 1: return launch_hd<__half>(p, B, hd, stream);
    case 2: return launch_hd<__nv_bfloat16>(p, B, hd, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
