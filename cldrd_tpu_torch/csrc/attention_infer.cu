// K5 (inference attention) for short rows on Hopper (sm_90a): the route
// of every bf16 launch with head_dim 64 and L <= 64
// (ops/attention.py::_kernel_route), which is the query encode's L=30.
// Rows of 65-256 take attention_sm90.cu's forward at p = 0; fp32,
// head_dim 32 and longer rows keep attention.cu.
//
// Replaces the TPU kernel cldrd_tpu/ops/attention.py::_attention_kernel
// (:61). Per (batch row b, head h): s = (q * scale) . k^T in fp32, masked
// keys at -1e9, probs = exp(s - max) / sum in fp32 rounded to bf16,
// out = bf16(probs . v) with fp32 accumulation. head_dim is 64, so
// scale = 2^-3 and (q * scale) . k = scale * (q . k) exactly: the kernel
// scales the fp32 product.
//
// Bound on an H100 SXM at the query encode (B=512, L=30, H=12, D=64,
// bf16): 94.4 MB moved (q, k, v read and out written once; 0.028 ms at
// 3.35 TB/s) against 2.8 GFLOP: bytes bind, by two orders of magnitude.
// What PR 2's tiled kernel (attention.cu) lost to that bound: a block of
// four warps per (64-query tile, h, b) padded 30 rows to 64 on both
// sides, walked K and V twice (one pass for max and sum, one for P.V),
// staged unswizzled WMMA tiles with a barrier per step, and its 6,144
// tiny blocks each paid the whole prologue.
//
// Design:
// - One warp owns one (b, h) row and a block holds four heads of one
//   batch row (grid: ceil(H / 4) x B), so a block reads four contiguous
//   128-byte runs of each token's 1,536-byte [H, D] slab. Rows pad to 32
//   (L <= 32) or 64, not 64 always.
// - The warp copies its head's Q, K and V with 16-byte cp.async (rows
//   past L zero-filled) into 128-byte-swizzled tiles of its own, and
//   synchronises with __syncwarp alone: no block barrier anywhere.
// - Products are mma.sync m16n8k16 (bf16 in, fp32 accumulate), fragments
//   by ldmatrix (V transposed). A 16-query row tile's whole score row
//   (up to 64 keys) stays in registers, so the softmax takes the exact
//   max and sum in one pass with no online rescale, and probs round to
//   bf16 where the reference's do; the S accumulator's layout is P.V's A
//   fragment, so probs never leave registers.
// - Keys past L score -inf and add nothing to the sum (never -1e9), so a
//   row whose real keys are all masked gives 1/L over its L keys, as the
//   reference's unpadded row does.
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attn_common.cuh"  // MASKED
#include "score_tile.cuh"   // allow_dynamic_smem, MAX_DEVICES

namespace cldrd_attn_infer {

using bf16 = __nv_bfloat16;
using cldrd::allow_dynamic_smem;
using cldrd::MAX_DEVICES;

constexpr int D = 64;        // head_dim of this route
constexpr int MAXL = 64;     // longest row of this route
constexpr int HPB = 4;       // heads (warps) per block
constexpr int THREADS = HPB * 32;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `chunk` of row `row` in a tile of 128-byte
// rows, chunk index xor-ed with the row's place in its 8-row group, so
// the eight rows an ldmatrix reads at one chunk hit eight bank groups
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d[16 x 8] += a[16 x 16] . b[16 x 8], bf16 in, fp32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// e / l from r = 1 / l with one exact correction (attention_sm90.cu's
// div_row): the correctly rounded quotient for e in [0, 1], l in [1, L]
__device__ __forceinline__ float div_row(float e, float l, float r) {
  const float q = e * r;
  return fmaf(fmaf(-q, l, e), r, q);
}

// Rows pad to LP (32 or 64). Per warp: Q, K, V tiles of LP rows of 128
// bytes. Fragment layouts (g = lane / 4, t = lane % 4): the m16n8
// accumulator's element e is row g + 8 * (e >> 1), column 2t + (e & 1).
template <int LP>
__global__ void __launch_bounds__(THREADS)
attn_infer_short_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const int* __restrict__ mask, bf16* __restrict__ out,
                        int L, int H, float scale) {
  constexpr int TILE_B = LP * 128;
  constexpr int NT = LP / 8;    // 8-key tiles of a score row
  constexpr int KT = LP / 16;   // 16-key depth steps of P.V
  constexpr int RT = LP / 16;   // 16-query row tiles
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x * HPB + warp, b = blockIdx.y;
  if (h >= H) return;
  const uint32_t sQ = smem_u32(smem) + warp * 3 * TILE_B;
  const uint32_t sK = sQ + TILE_B, sV = sK + TILE_B;

  // Q, K and V of head h; rows past L arrive as zeros
  const long long row0 = (long long)b * L;
#pragma unroll
  for (int i = lane; i < LP * 8; i += 32) {
    const int r = i >> 3, c = i & 7;
    const bool ok = r < L;
    const long long off = ((row0 + (ok ? r : 0)) * H + h) * D + c * 8;
    cp_async16(sQ + swz(r, c), q + off, ok);
    cp_async16(sK + swz(r, c), k + off, ok);
    cp_async16(sV + swz(r, c), v + off, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  const int g = lane >> 2, t = lane & 3;
  // the mask of this thread's key columns: 1 real, 0 masked, -1 past L
  int km[NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int key = n * 8 + 2 * t + j;
      km[n][j] = key < L ? (mask[row0 + key] != 0) : -1;
    }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();

  // ldmatrix addresses: lane supplies row (lane & 7) of matrix lane >> 3
  const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int rt = 0; rt < RT; ++rt) {
    if (rt * 16 >= L) break;  // warp-uniform: no query row left
    // S = Q . K^T for 16 queries x LP keys
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];  // rows 0-7 / 8-15 at chunk 2kk, then at 2kk + 1
      ldsm_x4(sQ + swz(rt * 16 + mr + 8 * (mi & 1), 2 * kk + (mi >> 1)), a);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t bk[4];  // keys of tile n, then n + 1, at 2kk and 2kk + 1
        ldsm_x4(sK + swz((n + (mi >> 1)) * 8 + mr, 2 * kk + (mi & 1)), bk);
        mma16816(s[n], a, bk[0], bk[1]);
        mma16816(s[n + 1], a, bk[2], bk[3]);
      }
    }
    // masked scores and the exact row max (a row lives in a lane quad)
    float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = km[n][e & 1];
        const float x = c < 0 ? -INFINITY
                              : (c ? s[n][e] * scale : cldrd_attn::MASKED);
        s[n][e] = x;
        m[e >> 1] = fmaxf(m[e >> 1], x);
      }
    float l[2] = {0.f, 0.f}, rl[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      m[x] = fmaxf(m[x], __shfl_xor_sync(0xffffffffu, m[x], 1));
      m[x] = fmaxf(m[x], __shfl_xor_sync(0xffffffffu, m[x], 2));
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        l[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      l[x] += __shfl_xor_sync(0xffffffffu, l[x], 1);
      l[x] += __shfl_xor_sync(0xffffffffu, l[x], 2);
      rl[x] = 1.f / l[x];
    }
    // probs in bf16 as P.V's A fragments: depth step j takes key tiles 2j
    // (a0 rows g, a1 rows g + 8) and 2j + 1 (a2, a3)
    uint32_t pa[KT][4];
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int hn = 0; hn < 2; ++hn)
#pragma unroll
        for (int x = 0; x < 2; ++x)
          pa[j][2 * hn + x] =
              pack_bf16(div_row(s[2 * j + hn][2 * x], l[x], rl[x]),
                        div_row(s[2 * j + hn][2 * x + 1], l[x], rl[x]));
    // out = P . V
    float o[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t bv[4];  // keys 16j.. / 16j + 8.. at chunk n, then n + 1
        ldsm_x4_t(sV + swz(16 * j + mr + 8 * (mi & 1), n + (mi >> 1)), bv);
        mma16816(o[n], pa[j], bv[0], bv[1]);
        mma16816(o[n + 1], pa[j], bv[2], bv[3]);
      }
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int r = rt * 16 + g + 8 * x;
      if (r >= L) continue;
      bf16* dst = out + ((row0 + r) * H + h) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(dst + n * 8) =
            pack_bf16(o[n][2 * x], o[n][2 * x + 1]);
    }
  }
}

template <int LP>
int run(const void* q, const void* k, const void* v, const int* mask,
        void* out, int B, int L, int H, float scale, cudaStream_t stream) {
  static bool smem_set[MAX_DEVICES] = {};
  auto kern = attn_infer_short_kernel<LP>;
  constexpr int smem = HPB * 3 * LP * 128;
  const cudaError_t e = allow_dynamic_smem(kern, smem, smem_set);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((H + HPB - 1) / HPB, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), mask, static_cast<bf16*>(out), L, H,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace cldrd_attn_infer

// C entry point for ctypes; returns a cudaError_t (0 on success).
// q/k/v/out [B, L, H, 64] bf16, contiguous, 16-byte aligned; mask [B, L]
// int32 (1 = real token); scale = 1/sqrt(64).
extern "C" int attn_infer_short_launch(const void* q, const void* k,
                                       const void* v, const int* mask,
                                       void* out, int B, int L, int H,
                                       float scale, void* stream) {
  using namespace cldrd_attn_infer;
  if (B <= 0 || B > 65535 || L <= 0 || L > MAXL || H <= 0)
    return (int)cudaErrorInvalidValue;
  if (L <= 32)
    return run<32>(q, k, v, mask, out, B, L, H, scale, (cudaStream_t)stream);
  return run<64>(q, k, v, mask, out, B, L, H, scale, (cudaStream_t)stream);
}
