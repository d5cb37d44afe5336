// Shared score-tile stage of the exact-search kernels extract_topk.cu
// (K1's bins other than 128 and fp32 operands; the main path's K1 takes
// extract_topk_sm90.cu) and fused_binmax.cu (K2, every launch).
//
// One thread block of NTHREADS threads computes the fp32 score tile
//   S[q, r] = sum_k Q[q0 + q, k] * C[r0 + r, k],   q < QB, r < TILE_ROWS
// into shared memory, laid out query-major: Ss[q * S_LD + r]. The depth
// axis is streamed through shared memory in chunks; rows past N, queries
// past B and columns past D load as zeros, so they add nothing to a sum.
//
// Two compute routes, chosen by the operand types at compile time:
// - bf16 queries against bf16 or int8 rows: WMMA m16n16k16 bf16 products
//   with fp32 accumulation. int8 codes widen to bf16 in the loader
//   (|code| <= 128 is exact in bf16); the per-row scale is applied by the
//   caller after the dot, in fp32, as the TPU kernels do.
// - anything with an fp32 operand: plain fp32 FMA, so an fp32 store scores
//   in true fp32 (no TF32 anywhere).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace cldrd {

constexpr int TILE_ROWS = 128;  // corpus rows per score tile
constexpr int QB = 64;          // queries per block
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int KC = 64;           // depth chunk of the bf16 route
constexpr int KC_LD = KC + 8;    // bf16 row stride (multiple of 8 for WMMA)
constexpr int KF = 32;           // depth chunk of the fp32 route
constexpr int KF_LD = KF + 1;
constexpr int S_LD = TILE_ROWS + 4;  // fp32 stride of the score tile

// bytes of the depth-chunk staging area (the larger of the two routes)
constexpr int STAGE_BF16 = (TILE_ROWS + QB) * KC_LD * 2;
constexpr int STAGE_F32 = (TILE_ROWS + QB) * KF_LD * 4;
constexpr int STAGE_BYTES =
    ((STAGE_BF16 > STAGE_F32 ? STAGE_BF16 : STAGE_F32) + 127) / 128 * 128;
constexpr int TILE_BYTES = QB * S_LD * 4;

// dtype codes shared with the Python wrappers
enum DType { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

// rows [r0, r0 + TILE_ROWS) x columns [k0, k0 + KC) of a bf16 matrix into
// Cs[r * KC_LD + k]; 16-byte vectors (D % 16 == 0 is checked by the host)
__device__ __forceinline__ void load_bf16_chunk(
    const __nv_bfloat16* __restrict__ src, long long nrows, int D,
    long long r0, int k0, int tile_rows, __nv_bfloat16* dst) {
  constexpr int VPR = KC / 8;
  for (int i = threadIdx.x; i < tile_rows * VPR; i += NTHREADS) {
    const int r = i / VPR, v = i % VPR;
    const long long gr = r0 + r;
    const int col = k0 + v * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < nrows && col < D)
      val = *reinterpret_cast<const uint4*>(src + gr * D + col);
    *reinterpret_cast<uint4*>(dst + r * KC_LD + v * 8) = val;
  }
}

// the same from int8 codes, widened to bf16 on the way into shared memory
__device__ __forceinline__ void load_bf16_chunk(
    const int8_t* __restrict__ src, long long nrows, int D, long long r0,
    int k0, int tile_rows, __nv_bfloat16* dst) {
  constexpr int VPR = KC / 16;
  for (int i = threadIdx.x; i < tile_rows * VPR; i += NTHREADS) {
    const int r = i / VPR, v = i % VPR;
    const long long gr = r0 + r;
    const int col = k0 + v * 16;
    int4 raw = make_int4(0, 0, 0, 0);
    if (gr < nrows && col < D)
      raw = *reinterpret_cast<const int4*>(src + gr * D + col);
    const int words[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t packed[8];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      // little-endian: byte b of word w is column 4w + b
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int lo = (int)(int8_t)((words[w] >> (16 * h)) & 0xff);
        const int hi = (int)(int8_t)((words[w] >> (16 * h + 8)) & 0xff);
        packed[2 * w + h] =
            (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn((float)lo)) |
            ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn((float)hi))
             << 16);
      }
    }
    uint4* d = reinterpret_cast<uint4*>(dst + r * KC_LD + v * 16);
    d[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
    d[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
  }
}

// rows x KF columns of any operand type, widened to fp32
template <typename T>
__device__ __forceinline__ void load_f32_chunk(
    const T* __restrict__ src, long long nrows, int D, long long r0, int k0,
    int tile_rows, float* dst) {
  for (int i = threadIdx.x; i < tile_rows * KF; i += NTHREADS) {
    const int r = i / KF, kk = i % KF;
    const long long gr = r0 + r;
    const int col = k0 + kk;
    float v = 0.f;
    if (gr < nrows && col < D) v = to_f32(src[gr * D + col]);
    dst[r * KF_LD + kk] = v;
  }
}

// WMMA route: warp w owns rows [16w, 16w + 16) and all QB queries
template <typename CT>
__device__ __forceinline__ void score_tile_mma(
    const __nv_bfloat16* __restrict__ q, const CT* __restrict__ c, int B,
    long long N, int D, int q0, long long r0, unsigned char* stage,
    float* Ss) {
  using namespace nvcuda;
  __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(stage);
  __nv_bfloat16* Qs = Cs + TILE_ROWS * KC_LD;
  const int warp = threadIdx.x / 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[QB / 16];
#pragma unroll
  for (int j = 0; j < QB / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
  for (int k0 = 0; k0 < D; k0 += KC) {
    __syncthreads();  // the previous chunk (and tile epilogue) is consumed
    load_bf16_chunk(c, N, D, r0, k0, TILE_ROWS, Cs);
    load_bf16_chunk(q, (long long)B, D, (long long)q0, k0, QB, Qs);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::load_matrix_sync(a, Cs + warp * 16 * KC_LD + kk, KC_LD);
#pragma unroll
      for (int j = 0; j < QB / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> b;
        wmma::load_matrix_sync(b, Qs + j * 16 * KC_LD + kk, KC_LD);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
  }
  // column-major store puts row r of query q at Ss[q * S_LD + r]
#pragma unroll
  for (int j = 0; j < QB / 16; ++j)
    wmma::store_matrix_sync(Ss + j * 16 * S_LD + warp * 16, acc[j], S_LD,
                            wmma::mem_col_major);
}

// fp32 FMA route: thread (tr, tq) owns rows [8tr, 8tr + 8) x queries
// [4tq, 4tq + 4)
template <typename QT, typename CT>
__device__ __forceinline__ void score_tile_fma(
    const QT* __restrict__ q, const CT* __restrict__ c, int B, long long N,
    int D, int q0, long long r0, unsigned char* stage, float* Ss) {
  float* Cs = reinterpret_cast<float*>(stage);
  float* Qs = Cs + TILE_ROWS * KF_LD;
  const int tr = threadIdx.x / 16;
  const int tq = threadIdx.x % 16;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < D; k0 += KF) {
    __syncthreads();
    load_f32_chunk(c, N, D, r0, k0, TILE_ROWS, Cs);
    load_f32_chunk(q, (long long)B, D, (long long)q0, k0, QB, Qs);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KF; ++kk) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = Cs[(tr * 8 + i) * KF_LD + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Qs[(tq * 4 + j) * KF_LD + kk];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      Ss[(tq * 4 + j) * S_LD + tr * 8 + i] = acc[i][j];
}

// dispatch: bf16 x {bf16, int8} takes the tensor cores, the rest fp32 FMA
template <typename QT, typename CT>
struct UsesMma {
  static constexpr bool value = false;
};
template <>
struct UsesMma<__nv_bfloat16, __nv_bfloat16> {
  static constexpr bool value = true;
};
template <>
struct UsesMma<__nv_bfloat16, int8_t> {
  static constexpr bool value = true;
};

template <typename QT, typename CT>
__device__ __forceinline__ void score_tile(const QT* __restrict__ q,
                                           const CT* __restrict__ c, int B,
                                           long long N, int D, int q0,
                                           long long r0, unsigned char* stage,
                                           float* Ss) {
  if constexpr (UsesMma<QT, CT>::value)
    score_tile_mma<CT>(q, c, B, N, D, q0, r0, stage, Ss);
  else
    score_tile_fma<QT, CT>(q, c, B, N, D, q0, r0, stage, Ss);
}

// Host side: raise a kernel's dynamic shared memory limit to `bytes` on
// the current device, once per device; `done` is the caller's flag array
// (one per kernel instantiation).
constexpr int MAX_DEVICES = 64;

template <typename Kernel>
cudaError_t allow_dynamic_smem(Kernel kern, int bytes, bool* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return e;
    done[dev] = true;
  }
  return cudaSuccess;
}

// Host-side dispatch over the (query dtype, corpus dtype) pairs; F is a
// functor template instantiated per pair. Returns cudaErrorInvalidValue
// for a pair no route takes.
template <template <typename, typename> class F, typename... Args>
int dispatch_dtypes(int q_dtype, int c_dtype, Args... args) {
  if (q_dtype == DT_BF16) {
    if (c_dtype == DT_BF16) return F<__nv_bfloat16, __nv_bfloat16>::run(args...);
    if (c_dtype == DT_I8) return F<__nv_bfloat16, int8_t>::run(args...);
    if (c_dtype == DT_F32) return F<__nv_bfloat16, float>::run(args...);
  } else if (q_dtype == DT_F32) {
    if (c_dtype == DT_F32) return F<float, float>::run(args...);
    if (c_dtype == DT_BF16) return F<float, __nv_bfloat16>::run(args...);
    if (c_dtype == DT_I8) return F<float, int8_t>::run(args...);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace cldrd
