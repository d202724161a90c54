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
// dtype.  The f16/bf16 kernel keeps scores and m in base-2 units (scale and
// cap times log2(e), then 2^x), which is the same softmax.
//
// What both kernels share.  The TPU kernel walks the key blocks of one
// (512, 512) tile pair sequentially in its grid and keeps (m, l, acc) in
// VMEM between grid steps.  Here one block owns one (batch * head, query
// tile) and loops over the key tiles itself, so nothing carries over
// between blocks and no block splits the keys: no atomics, and every output
// repeats bit for bit.  The heaviest causal query tiles (the last ones) are
// launched first.  Key tiles that the causal or the window mask empties for
// every row of the block are never loaded.  Ragged edges are masked in the
// kernel: query rows past S are staged as zeros and never written, keys
// past T are staged as zeros and masked, so the wrapper pads and copies
// nothing.  A row whose first tiles are all masked gets p = exp(0) = 1
// garbage against m = -1e30, as in the Pallas kernel, which the first tile
// holding one of its keys multiplies by exp(-1e30 - m) = 0.
//
// f16/bf16 (flash_fwd_mma), the FlashAttention-2 structure on Hopper's
// warp-level tensor-core and async-copy instructions:
// - Each warp owns 16 query rows.  S = Q K^T and acc += P V run as PTX
//   mma.sync.m16n8k16 with f32 accumulators, whose fragment layout the
//   PTX ISA documents: a lane holds rows g = lane / 4 and g + 8 of a 16x8
//   tile, columns 2 (lane % 4) and +1.  The warp's S tile (16 x BK) and
//   its accumulator (16 x hd) stay in registers for the whole key loop; no
//   score tile and no accumulator goes to shared memory.
// - Operands come from shared memory by ldmatrix.x4: Q and K (both rows of
//   hd) as the A and the "col" B operand, V (keys, hd) with .trans.  Each
//   lane's ldmatrix row offsets are computed once, so every fragment
//   address is a constant offset from a 32-bit shared address.
// - Softmax on the fragments: a row lives in the 4 lanes of a quad, so its
//   max takes two xor-shuffles (1, 2).  The rescale by exp(m_old - m_new)
//   multiplies the row's accumulator registers in place; l stays a per-lane
//   partial sum, added over the quad once at the end.  The exponentials are
//   single ex2.approx.ftz instructions.  p is rounded to v's dtype in
//   registers and is at once the A operand of the P V product: the
//   m16n8k16 accumulator layout of two neighbouring 8-key tiles is the A
//   layout of one 16-key slice.
// - K/V staging is a ring of two stages in dynamic shared memory, filled by
//   cp.async.cg 16-byte copies (zero-filled past T) in one commit group per
//   tile: the copies of tile t + 1 are in flight while tile t is computed.
//   Rows are padded by 16 bytes (hd + 8 elements), so the 8 row addresses
//   of every ldmatrix phase fall in 8 different 16-byte bank groups: no
//   bank conflicts, and no swizzle to get wrong.
// - A warp computes a key tile only if one of its rows sees a key there,
//   and applies the causal, window and ragged-T compares only on a tile
//   that straddles the diagonal, the window's edge or T; fully visible
//   tiles skip the per-element mask.  A skipped tile would only have added
//   exp2(-1e30 - m) = 0 to its rows.
// - The output goes back through the warp's own Q rows in shared memory, so
//   every lane stores whole 16-byte chunks of contiguous output rows.
// Tiles.  MmaTiles is 64 query rows (4 warps) by 64 keys for every head
// dim.  On an H100, 128-row tiles (8 warps) were slower at granite-8b's
// prefill shapes, and 32-key tiles came within about 5 % either way there
// and were slower at 4,096 tokens (tools/flash_tiles.py times the three);
// at 64 rows two or three blocks share an SM, so one block's barriers and
// prologue overlap another's products.  Instances (shared memory: the Q
// tile plus two K/V stages of padded rows; registers as ptxas -v reports
// them for sm_90a, printed by chip_smoke.py phase 1; no instance spills):
//   hd  64:  46,080 B, 147 registers, 3 blocks per SM
//   hd 128:  87,040 B, 185 registers, 2 blocks per SM
//   hd 256: 168,960 B, 255 registers, 1 block per SM
// It reaches about a fifth of its byte bound at granite-8b's prefill on an
// H100 (PERF.md): a warp's softmax sits between its two products, and with
// a few warps per SM the tensor cores wait on it.  wgmma and TMA
// (FlashAttention-3's producer/consumer warpgroups, whose softmax overlaps
// the other warpgroup's products) are the next step for this kernel.
//
// f32 (flash_fwd_f32): the two products in plain f32 fmaf on staged
// shared-memory tiles, no TF32: TF32 keeps about three decimal digits and
// is not shown to hold the reference's 2e-3, and f32 is off the serving
// path, which is bf16.  Each warp owns 16 query rows of a 64-query tile
// and 64-key tiles (32 x 32 at hd 256, 139 KB of shared memory); the
// softmax walks its rows one at a time with the lanes across the key
// columns, and shared rows are padded by 16 bytes.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace repro_torch {
namespace flash {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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

// ---------------------------------------------------------------------------
// f16/bf16: mma.sync fragments in registers, cp.async K/V ring
// ---------------------------------------------------------------------------

// Query rows per block (the block has one warp per 16 rows) and keys per
// tile, for every head dim.
struct MmaTiles {
  static constexpr int BQ = 64;
  static constexpr int BK = 64;
};

template <int HD, int BQ, int BK> struct MmaLayout {
  static constexpr int LD = HD + 8;                // row stride, elements
  static constexpr int kStages = 2;
  static constexpr int kStage = 2 * BK * LD;       // K then V of one stage
  static constexpr size_t kBytes =
      2 * (static_cast<size_t>(BQ) * LD +
           static_cast<size_t>(kStages) * kStage);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; zero-fills the 16 bytes when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a . b for one 16x8x16 tile: a a 16x16 row-major fragment, b the 16x8
// "col" fragment {b0, b1}, d f32.
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// 2^x by the special-function unit: one MUFU.EX2, results below 2^-126
// flushed to 0 (exp2f adds a range check and two scalings around it).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 rounded to T, packed low element first (one A-fragment register).
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo,
                                                                float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo,
                                                                     float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo,
                                                              float hi) {
  const __half2 x = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// Copy `rows` rows of HD elements from global (row stride `stride`) into a
// padded shared tile, 16 bytes per cp.async; rows at or past `valid` become
// zeros (their source address is clamped to row 0 and never read).
template <int HD, int LD, int NT, typename T>
__device__ __forceinline__ void copy_rows_async(T* dst, const T* src,
                                                long long stride, int rows,
                                                int valid) {
  constexpr int kChunks = HD / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += NT) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const bool ok = r < valid;
    cp_async16(smem_addr(dst + r * LD + c), src + (ok ? r : 0) * stride + c,
               ok);
  }
}

// The masks of one launch and the score transform in base-2 units: s *
// qk_scale, or cap_out * tanhf(s * cap_in) with a soft-cap.
struct TileArgs {
  int T;
  bool causal;
  int window;
  float qk_scale, cap_in, cap_out;
};

// One key tile for one warp: s = q k^T, the online softmax on the
// fragments, acc += p v, for the warp's 16 query rows.  qa, ka, va: the
// shared-memory byte addresses at which this lane's ldmatrix rows of the
// warp's Q rows and of the stage's K and V tiles start (see the kernel), so
// every fragment address is a compile-time offset from one of them; row0:
// the query position of the lane's first row (its second is row0 + 8).
template <bool MASK, bool CAP, typename T, int HD, int BK, int LD>
__device__ __forceinline__ void attend_tile(uint32_t qa, uint32_t ka,
                                            uint32_t va, int lane, int k0,
                                            int row0, const TileArgs& args,
                                            float (&o)[HD / 8][4],
                                            float (&m)[2], float (&l)[2]) {
  float s[BK / 8][4];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
  }
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(qa + sizeof(T) * kk * 16, a);
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t b[4];
      ldsm_x4(ka + sizeof(T) * (j * 16 * LD + kk * 16), b);
      mma16816<T>(s[2 * j], a, b[0], b[1]);
      mma16816<T>(s[2 * j + 1], a, b[2], b[3]);
    }
  }

  // Scores in base-2 units, masked where needed; the row max over the quad,
  // the rescale of l and of the accumulator rows, and p.
  const int t2 = (lane & 3) * 2;
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = CAP ? args.cap_out * tanhf(s[j][e] * args.cap_in)
                    : s[j][e] * args.qk_scale;
      if (MASK) {
        const int qp = row0 + (e >> 1) * 8;
        const int kp = k0 + j * 8 + t2 + (e & 1);
        bool ok = kp < args.T;
        if (args.causal) ok = ok && kp <= qp;
        if (args.window > 0) ok = ok && kp > qp - args.window;
        x = ok ? x : kNegInf;
      }
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    corr[r] = fast_exp2(m[r] - m_new);
    m[r] = m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float e2 = fast_exp2(s[j][e] - m[e >> 1]);
      s[j][e] = e2;
      l[e >> 1] += e2;
    }
  }
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    o[j][0] *= corr[0];
    o[j][1] *= corr[0];
    o[j][2] *= corr[1];
    o[j][3] *= corr[1];
  }

  // acc += p v: the S fragments of 8-key tiles 2kk and 2kk+1 are the A
  // fragment of the 16-key slice kk.
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack2<T>(s[2 * kk][0], s[2 * kk][1]);
    a[1] = pack2<T>(s[2 * kk][2], s[2 * kk][3]);
    a[2] = pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[3] = pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      uint32_t b[4];
      ldsm_x4_trans(va + sizeof(T) * (kk * 16 * LD + j * 16), b);
      mma16816<T>(o[2 * j], a, b[0], b[1]);
      mma16816<T>(o[2 * j + 1], a, b[2], b[3]);
    }
  }
}

// attend_tile with the per-element mask only where the tile needs it.
template <bool CAP, typename T, int HD, int BK, int LD>
__device__ __forceinline__ void attend_tile_masked(
    bool mask, uint32_t qa, uint32_t ka, uint32_t va, int lane, int k0,
    int row0, const TileArgs& args, float (&o)[HD / 8][4], float (&m)[2],
    float (&l)[2]) {
  if (mask) {
    attend_tile<true, CAP, T, HD, BK, LD>(qa, ka, va, lane, k0, row0, args,
                                          o, m, l);
  } else {
    attend_tile<false, CAP, T, HD, BK, LD>(qa, ka, va, lane, k0, row0, args,
                                           o, m, l);
  }
}

// One stage of the ring: K rows then V rows of the key tile at k0.
template <int HD, int LD, int NT, int BK, typename T>
__device__ __forceinline__ void copy_kv_async(T* stage, const T* kb,
                                              const T* vb, long long kstride,
                                              long long vstride, int k0,
                                              int kv_len) {
  const int valid = min(BK, kv_len - k0);
  copy_rows_async<HD, LD, NT>(stage, kb + k0 * kstride, kstride, BK, valid);
  copy_rows_async<HD, LD, NT>(stage + BK * LD, vb + k0 * vstride, vstride, BK,
                              valid);
}

template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(BQ / 16 * 32) flash_fwd_mma(Params p) {
  using L = MmaLayout<HD, BQ, BK>;
  constexpr int NT = BQ / 16 * 32;
  constexpr int LD = L::LD;
  constexpr int kChunks = HD / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sKV = sQ + BQ * LD;  // stage s: K at sKV + s * kStage, V BK rows later

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kvh = h / (p.H / p.Kv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int w0 = q0 + warp * 16;  // the warp's first query
  const int row0 = w0 + (lane >> 2);
  // This lane's ldmatrix row within a 16x16 fragment: Q (A operand) rows
  // lane % 16, columns 8 (lane / 16); K (B operand, two 8-key tiles) keys
  // lane % 8 + 8 (lane / 16), columns 8 ((lane / 8) % 2); V (B operand,
  // transposed) keys lane % 8 + 8 ((lane / 8) % 2), columns 8 (lane / 16).
  const int q_row = warp * 16 + (lane & 15);
  const int k_row = (lane & 7) + (lane >> 4) * 8;
  const int v_row = BK + (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t qa = smem_addr(sQ + q_row * LD + (lane >> 4) * 8);
  const uint32_t ka0 = smem_addr(sKV + k_row * LD + ((lane >> 3) & 1) * 8);
  const uint32_t va0 = smem_addr(sKV + v_row * LD + (lane >> 4) * 8);

  const T* qb = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[2];
  const T* kb = static_cast<const T*>(p.k) + b * p.ks[0] + kvh * p.ks[2];
  const T* vb = static_cast<const T*>(p.v) + b * p.vs[0] + kvh * p.vs[2];
  copy_rows_async<HD, LD, NT>(sQ, qb + q0 * p.qs[1], p.qs[1], BQ, p.S - q0);
  cp_async_commit();

  // Key tiles holding at least one unmasked key for some row of the block,
  // and for some row of this warp.
  int kend = p.T;
  if (p.causal) kend = min(kend, min(q0 + BQ, p.S));
  const int kbeg = p.window > 0 ? max(0, q0 - p.window + 1) / BK * BK : 0;
  const int ntiles = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;
  const int wlast = min(w0 + 15, p.S - 1);  // the warp's last written row
  const int wbeg = p.window > 0 ? max(0, w0 - p.window + 1) : 0;
  const int wend = p.causal ? min(p.T, wlast + 1) : p.T;
  if (ntiles > 0) {
    copy_kv_async<HD, LD, NT, BK>(sKV, kb, vb, p.ks[1], p.vs[1], kbeg, p.T);
  }
  cp_async_commit();

  const bool cap = p.cap > 0.f;
  TileArgs args;
  args.T = p.T;
  args.causal = p.causal != 0;
  args.window = p.window;
  args.qk_scale = p.scale * kLog2e;
  args.cap_in = cap ? p.scale / p.cap : 0.f;
  args.cap_out = p.cap * kLog2e;
  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
  }
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = kbeg + it * BK;
    if (it + 1 < ntiles) {
      copy_kv_async<HD, LD, NT, BK>(sKV + ((it + 1) & 1) * L::kStage, kb, vb,
                                    p.ks[1], p.vs[1], k0 + BK, p.T);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies (and Q's) have landed
    __syncthreads();
    if (w0 < p.S && k0 < wend && k0 + BK > wbeg) {
      const uint32_t stage = (it & 1) * sizeof(T) * L::kStage;
      const bool mask = k0 + BK > p.T ||
                        (p.causal && k0 + BK - 1 > w0) ||
                        (p.window > 0 && k0 <= w0 + 15 - p.window);
      if (cap) {
        attend_tile_masked<true, T, HD, BK, LD>(
            mask, qa, ka0 + stage, va0 + stage, lane, k0, row0, args, o, m, l);
      } else {
        attend_tile_masked<false, T, HD, BK, LD>(
            mask, qa, ka0 + stage, va0 + stage, lane, k0, row0, args, o, m, l);
      }
    }
    __syncthreads();  // every warp is done with this stage before its refill
  }
  cp_async_wait<0>();
  __syncthreads();  // every copy into sQ has landed before it is reused

  if (w0 >= p.S) return;
  // The output, through the warp's own Q rows, in whole 16-byte chunks.
  T* sOw = sQ + warp * 16 * LD;
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    *reinterpret_cast<uint32_t*>(sOw + g * LD + j * 8 + t2) =
        pack2<T>(o[j][0] / l[0], o[j][1] / l[0]);
    *reinterpret_cast<uint32_t*>(sOw + (g + 8) * LD + j * 8 + t2) =
        pack2<T>(o[j][2] / l[1], o[j][3] / l[1]);
  }
  __syncwarp();
  T* ob = static_cast<T*>(p.o);
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    if (w0 + r < p.S) {
      *reinterpret_cast<uint4*>(
          ob + ((static_cast<long long>(b) * p.S + w0 + r) * p.H + h) * HD +
          c) = *reinterpret_cast<const uint4*>(sOw + r * LD + c);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: fmaf products on staged shared-memory tiles
// ---------------------------------------------------------------------------

template <int HD> struct F32Tiles {
  static constexpr int BQ = 64;
  static constexpr int BK = 64;
};
template <> struct F32Tiles<256> {
  static constexpr int BQ = 32;
  static constexpr int BK = 32;
};

template <int HD, int BQ, int BK> struct F32Layout {
  static constexpr int LDQ = HD + 4;              // Q, K, V rows
  static constexpr int LDP = BK + 4;              // p rows
  static constexpr int LDS = BK + 4;              // score rows
  static constexpr int LDO = HD + 4;              // accumulator rows
  static constexpr size_t kBytes =
      sizeof(float) * (static_cast<size_t>(BQ + 2 * BK) * LDQ +
                       static_cast<size_t>(BQ) * (LDP + LDS + LDO));
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

// Stage `rows` rows of HD floats (global row stride `stride`) into dst
// (row stride LD) with 16-byte loads; rows at or past `valid` become zeros.
template <int HD, int LD, int NT>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long stride, int rows,
                                           int valid) {
  constexpr int kPerRow = HD / 4;
  for (int i = threadIdx.x; i < rows * kPerRow; i += NT) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) {
      val = *reinterpret_cast<const float4*>(src + r * stride + c);
    }
    *reinterpret_cast<float4*>(dst + r * LD + c) = val;
  }
}

// One warp's scores: s[16][BK] = q[16][HD] . k[BK][HD]^T, unscaled.
template <int HD, int BK, typename L>
__device__ __forceinline__ void warp_scores(const float* sq, const float* sk,
                                            float* ss, int lane) {
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
}

// One warp's accumulator update: acc[16][HD] += p[16][BK] . v[BK][HD].
template <int HD, int BK, typename L>
__device__ __forceinline__ void warp_pv(const float* sp, const float* sv,
                                        float* so, int lane) {
  const int r = lane >> 1;
  const int d0 = (lane & 1) * (HD / 2);
  const float* prow = sp + r * L::LDP;
  for (int d = d0; d < d0 + HD / 2; ++d) {
    float acc = so[r * L::LDO + d];
#pragma unroll 8
    for (int j = 0; j < BK; ++j) acc = fmaf(prow[j], sv[j * L::LDQ + d], acc);
    so[r * L::LDO + d] = acc;
  }
}

template <int HD, int BQ, int BK>
__global__ void __launch_bounds__(BQ / 16 * 32) flash_fwd_f32(Params p) {
  using L = F32Layout<HD, BQ, BK>;
  constexpr int NT = BQ / 16 * 32;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = sQ + BQ * L::LDQ;
  float* sV = sK + BK * L::LDQ;
  float* sP = sV + BK * L::LDQ;
  float* sS = sP + BQ * L::LDP;
  float* sO = sS + BQ * L::LDS;

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kvh = h / (p.H / p.Kv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int w0 = q0 + warp * 16;              // the warp's first query
  float* sPw = sP + warp * 16 * L::LDP;
  float* sSw = sS + warp * 16 * L::LDS;
  float* sOw = sO + warp * 16 * L::LDO;

  const float* qb = static_cast<const float*>(p.q) + b * p.qs[0] +
                    h * p.qs[2];
  const float* kb = static_cast<const float*>(p.k) + b * p.ks[0] +
                    kvh * p.ks[2];
  const float* vb = static_cast<const float*>(p.v) + b * p.vs[0] +
                    kvh * p.vs[2];
  stage_rows<HD, L::LDQ, NT>(sQ, qb + q0 * p.qs[1], p.qs[1], BQ,
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
    stage_rows<HD, L::LDQ, NT>(sK, kb + k0 * p.ks[1], p.ks[1], BK, valid);
    stage_rows<HD, L::LDQ, NT>(sV, vb + k0 * p.vs[1], p.vs[1], BK, valid);
    __syncthreads();

    warp_scores<HD, BK, L>(sQ + warp * 16 * L::LDQ, sK, sSw, lane);
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
        sPw[r * L::LDP + lane + 32 * i] = e;
      }
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int d = lane; d < HD; d += 32) sOw[r * L::LDO + d] *= corr;
    }
    __syncwarp();
    warp_pv<HD, BK, L>(sPw, sV, sOw, lane);
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int qp = w0 + r;
    if (qp < p.S) {
      const float denom = fmaxf(l[r], 1e-30f);
      float* ob = static_cast<float*>(p.o) +
                  ((static_cast<long long>(b) * p.S + qp) * p.H + h) * HD;
#pragma unroll
      for (int d = lane; d < HD; d += 32) ob[d] = sOw[r * L::LDO + d] / denom;
    }
  }
}

template <typename K>
int launch_kernel(K kernel, dim3 grid, int threads, size_t smem,
                  const Params& p, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch(const Params& p, int B, void* stream) {
  if constexpr (std::is_same<T, float>::value) {
    constexpr int BQ = F32Tiles<HD>::BQ;
    constexpr int BK = F32Tiles<HD>::BK;
    return launch_kernel(flash_fwd_f32<HD, BQ, BK>,
                         dim3(B * p.H, (p.S + BQ - 1) / BQ), BQ / 16 * 32,
                         F32Layout<HD, BQ, BK>::kBytes, p, stream);
  } else {
    constexpr int BQ = MmaTiles::BQ;
    constexpr int BK = MmaTiles::BK;
    return launch_kernel(flash_fwd_mma<T, HD, BQ, BK>,
                         dim3(B * p.H, (p.S + BQ - 1) / BQ), BQ / 16 * 32,
                         MmaLayout<HD, BQ, BK>::kBytes, p, stream);
  }
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
