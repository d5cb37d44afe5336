// The encoder's elementwise chain at every LayerNorm site: dropout of the
// branch -> residual add -> LayerNorm, forward and backward.
//
// Replaces no TPU kernel: on the TPU, XLA fuses the same chain of
// cldrd_tpu/models/distilbert.py (flax Dropout, the add, nn.LayerNorm)
// into a few passes. Run as PyTorch operations it was ~49 kernels a site
// over forward and backward, ~200 KB a token at D = 768, with autograd
// keeping the fp32 statistics' intermediates (ops/residual_norm.py holds
// that chain as the plain version).
//
// Forward, per row of D elements (x the branch; r the residual and u the
// branch's fp32 uniforms, both optional):
//   x' = u >= p ? round(x * inv) : 0        (inv = 1/(1-p) in fp32)
//   s  = round(x' + r)
//   mean and variance of s in fp32 (two passes over registers)
//   y  = round(((s - mean) * rstd) * w + b),  rstd = rsqrt(var + eps)
// "round" is to the compute dtype (bf16 or fp32): the plain chain's
// roundings, operation by operation, so y differs from it only by the
// order of the two fp32 row sums. Training saves s (compute dtype), the
// keep mask (one byte per 16-byte vector of x: 8 bits for bf16, 4 for
// fp32) and (mean, rstd); the uniforms are read once and not kept.
//
// Backward: g = dy * w, xhat = (s - mean) * rstd,
//   ds = round(rstd * (g - mean(g) - xhat * mean(g * xhat)))
//   dx = keep ? round(ds * inv) : 0
// dw = sum dy * xhat and db = sum dy over the rows: each block sums its
// rows in registers, then its warps in a fixed order into shared memory,
// and writes one partial row; a second kernel sums the partials in a
// fixed order. No atomics, so two launches give the same bits.
//
// Bound on an H100 SXM: bytes. At the passage tower's T = 61,440 rows of
// D = 768 bf16 with dropout, the forward reads x and r (1.5 KB each) and
// u (3 KB) and writes y and s (1.5 KB each) and the mask (96 B) a row;
// the backward reads dy, s and the mask and writes ds and dx (1.5 KB
// each): 15.5 KB a row, 0.95 GB a site, 0.28 ms at 3.35 TB/s. Design: a
// group of LPR lanes (a warp; a half warp at bf16 D = 384) owns a row,
// each lane VPL 16-byte vectors of it in registers, so every byte is
// read or written once; w and b come from L1. A few blocks an SM walk
// the rows, so the backward writes a few hundred partial rows of D.
// The row width is the launch's: D = 768 and 384 have their own
// instantiations, and generic ones take any multiple of 8 up to 4096.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cldrd_rn {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAX_D = 4096;
constexpr int DWB_COLS = 32;   // the partials' sum: columns a block
constexpr int DWB_SPLIT = 8;   // and threads a column
// Blocks an SM of the forward's persistent grid: what an SM holds of the
// main path's instantiations (64 registers a thread, by ptxas); one that
// holds fewer runs its blocks in waves. The backward's grid is capped by
// the caller's count of partial rows (ops/residual_norm.py sizes them).
constexpr int FWD_BLOCKS_PER_SM = 4;

// dtype codes shared with the Python wrappers (as csrc/score_tile.cuh)
enum DType { DT_F32 = 0, DT_BF16 = 1 };

// A 16-byte vector of the compute dtype, widened to and rounded from fp32.
template <typename T>
struct Pack;

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i])) |
             ((uint32_t)__bfloat16_as_ushort(
                  __float2bfloat16_rn(f[2 * i + 1]))
              << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Pack<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ __forceinline__ static float round(float x) { return x; }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

// The sum over a group of LPR lanes, in every lane of it. Each step adds
// two lanes' values in either order, which gives the same bits, so every
// lane ends with the same sum.
template <int LPR>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// n fp32 values (n a multiple of 4) from 16-byte aligned memory
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float* f) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(p)[q];
    f[4 * q] = v.x;
    f[4 * q + 1] = v.y;
    f[4 * q + 2] = v.z;
    f[4 * q + 3] = v.w;
  }
}

// Rows walk in steps that every thread of the block takes together (the
// group sums need every lane of a warp), so a group past the last row
// runs on with `live` false.
template <typename T, int VPL, int LPR>
__global__ void __launch_bounds__(NTHREADS)
residual_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
                         const float* __restrict__ u,
                         const float* __restrict__ w,
                         const float* __restrict__ b, T* __restrict__ y,
                         T* __restrict__ s_out,
                         uint8_t* __restrict__ keep_out,
                         float2* __restrict__ stats, int rows, int D,
                         float p, float inv, float eps) {
  using P = Pack<T>;
  constexpr int E = P::N;
  constexpr int SLOTS = NTHREADS / LPR;
  const int nvec = D / E;
  const int lane = threadIdx.x % LPR;
  const float rd = 1.0f / (float)D;
  for (int row0 = blockIdx.x * SLOTS; row0 < rows;
       row0 += gridDim.x * SLOTS) {
    const int row = row0 + threadIdx.x / LPR;
    const bool live = row < rows;
    const size_t base = (size_t)(live ? row : 0) * nvec;
    uint4 sv[VPL];
    uint8_t kv[VPL];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int v = i * LPR + lane;
      float f[E];
#pragma unroll
      for (int e = 0; e < E; ++e) f[e] = 0.f;
      kv[i] = 0;
      if (live && v < nvec) {
        P::unpack(reinterpret_cast<const uint4*>(x)[base + v], f);
        if (u != nullptr) {
          float uf[E];
          load_f32<E>(u + (base + v) * E, uf);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const bool k = uf[e] >= p;
            kv[i] |= (uint8_t)k << e;
            f[e] = k ? P::round(__fmul_rn(f[e], inv)) : 0.f;
          }
        }
        if (r != nullptr) {
          float rf[E];
          P::unpack(reinterpret_cast<const uint4*>(r)[base + v], rf);
#pragma unroll
          for (int e = 0; e < E; ++e) f[e] = P::round(__fadd_rn(f[e], rf[e]));
        }
#pragma unroll
        for (int e = 0; e < E; ++e) sum += f[e];
      }
      sv[i] = P::pack(f);
    }
    const float mean = group_sum<LPR>(sum) * rd;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int v = i * LPR + lane;
      if (live && v < nvec) {
        float f[E];
        P::unpack(sv[i], f);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float d = __fsub_rn(f[e], mean);
          sq = __fadd_rn(sq, __fmul_rn(d, d));
        }
      }
    }
    const float var = group_sum<LPR>(sq) * rd;
    const float rstd = rsqrtf(__fadd_rn(var, eps));
    if (!live) continue;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int v = i * LPR + lane;
      if (v >= nvec) continue;
      float f[E], wf[E], bf[E];
      P::unpack(sv[i], f);
      load_f32<E>(w + v * E, wf);
      load_f32<E>(b + v * E, bf);
#pragma unroll
      for (int e = 0; e < E; ++e)
        f[e] = __fadd_rn(
            __fmul_rn(__fmul_rn(__fsub_rn(f[e], mean), rstd), wf[e]), bf[e]);
      reinterpret_cast<uint4*>(y)[base + v] = P::pack(f);
      if (s_out != nullptr) reinterpret_cast<uint4*>(s_out)[base + v] = sv[i];
      if (keep_out != nullptr) keep_out[base + v] = kv[i];
    }
    if (stats != nullptr && lane == 0) stats[row] = make_float2(mean, rstd);
  }
}

template <typename T, int VPL, int LPR>
__global__ void __launch_bounds__(NTHREADS)
residual_norm_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ s,
                         const uint8_t* __restrict__ keep,
                         const float2* __restrict__ stats,
                         const float* __restrict__ w, T* __restrict__ ds_out,
                         T* __restrict__ dx_out, float* __restrict__ part_w,
                         float* __restrict__ part_b, int rows, int D,
                         float inv) {
  using P = Pack<T>;
  constexpr int E = P::N;
  constexpr int SLOTS = NTHREADS / LPR;
  extern __shared__ float red[];  // [2 * D]: the block's dw, db
  const int nvec = D / E;
  const int lane = threadIdx.x % LPR;
  const float rd = 1.0f / (float)D;
  float pw[VPL][E], pb[VPL][E];
#pragma unroll
  for (int i = 0; i < VPL; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) pw[i][e] = pb[i][e] = 0.f;
  for (int row0 = blockIdx.x * SLOTS; row0 < rows;
       row0 += gridDim.x * SLOTS) {
    const int row = row0 + threadIdx.x / LPR;
    const bool live = row < rows;
    const size_t base = (size_t)(live ? row : 0) * nvec;
    const float2 st = live ? stats[row] : make_float2(0.f, 0.f);
    uint4 dv[VPL], sv[VPL];
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int v = i * LPR + lane;
      if (live && v < nvec) {
        dv[i] = reinterpret_cast<const uint4*>(dy)[base + v];
        sv[i] = reinterpret_cast<const uint4*>(s)[base + v];
        float gf[E], sf[E], wf[E];
        P::unpack(dv[i], gf);
        P::unpack(sv[i], sf);
        load_f32<E>(w + v * E, wf);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float xh = __fmul_rn(__fsub_rn(sf[e], st.x), st.y);
          const float g = __fmul_rn(gf[e], wf[e]);
          sg += g;
          sgx += g * xh;
          pw[i][e] += gf[e] * xh;
          pb[i][e] += gf[e];
        }
      }
    }
    const float a = group_sum<LPR>(sg) * rd;
    const float c = group_sum<LPR>(sgx) * rd;
    if (!live) continue;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int v = i * LPR + lane;
      if (v >= nvec) continue;
      float gf[E], sf[E], wf[E];
      P::unpack(dv[i], gf);
      P::unpack(sv[i], sf);
      load_f32<E>(w + v * E, wf);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float xh = __fmul_rn(__fsub_rn(sf[e], st.x), st.y);
        const float g = __fmul_rn(gf[e], wf[e]);
        gf[e] = P::round(st.y * (g - a - xh * c));
      }
      if (ds_out != nullptr)
        reinterpret_cast<uint4*>(ds_out)[base + v] = P::pack(gf);
      if (dx_out != nullptr) {
        const uint8_t k = keep[base + v];
#pragma unroll
        for (int e = 0; e < E; ++e)
          gf[e] = (k >> e) & 1 ? P::round(__fmul_rn(gf[e], inv)) : 0.f;
        reinterpret_cast<uint4*>(dx_out)[base + v] = P::pack(gf);
      }
    }
  }
  // the block's partial dw, db: the lane groups of a warp hold the same
  // columns (fold them with shuffles), then the warps add in turn
#pragma unroll
  for (int i = 0; i < VPL; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e)
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1) {
        pw[i][e] += __shfl_xor_sync(0xffffffffu, pw[i][e], o);
        pb[i][e] += __shfl_xor_sync(0xffffffffu, pb[i][e], o);
      }
  const int warp = threadIdx.x / 32;
  const bool writer = threadIdx.x % 32 < LPR;
  for (int k = 0; k < NWARPS; ++k) {
    if (warp == k && writer) {
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int v = i * LPR + lane;
        if (v >= nvec) continue;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int col = v * E + e;
          red[col] = (k ? red[col] : 0.f) + pw[i][e];
          red[D + col] = (k ? red[D + col] : 0.f) + pb[i][e];
        }
      }
    }
    __syncthreads();
  }
  for (int col = threadIdx.x; col < D; col += NTHREADS) {
    part_w[(size_t)blockIdx.x * D + col] = red[col];
    part_b[(size_t)blockIdx.x * D + col] = red[D + col];
  }
}

// dw, db: the blocks' partial rows summed column by column, each column by
// DWB_SPLIT threads over strided partials, then in a fixed order.
__global__ void __launch_bounds__(DWB_COLS* DWB_SPLIT)
residual_norm_dwb_kernel(const float* __restrict__ part_w,
                         const float* __restrict__ part_b, int nparts, int D,
                         float* __restrict__ dw, float* __restrict__ db) {
  __shared__ float sw[DWB_SPLIT][DWB_COLS], sb[DWB_SPLIT][DWB_COLS];
  const int col = blockIdx.x * DWB_COLS + threadIdx.x;
  const int j = threadIdx.y;
  float aw = 0.f, ab = 0.f;
  if (col < D)
    for (int k = j; k < nparts; k += DWB_SPLIT) {
      aw += part_w[(size_t)k * D + col];
      ab += part_b[(size_t)k * D + col];
    }
  sw[j][threadIdx.x] = aw;
  sb[j][threadIdx.x] = ab;
  __syncthreads();
  if (j == 0 && col < D) {
    float tw = 0.f, tb = 0.f;
#pragma unroll
    for (int q = 0; q < DWB_SPLIT; ++q) {
      tw += sw[q][threadIdx.x];
      tb += sb[q][threadIdx.x];
    }
    dw[col] = tw;
    db[col] = tb;
  }
}

// The current device's SMs (the forward's grid), read once a device: an
// attribute query each launch would cost host time on a path bound by
// the host.
inline int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (cached[dev] == 0) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = sms > 0 ? sms : 1;
  }
  return cached[dev];
}

inline int min_int(int a, int b) { return a < b ? a : b; }

template <typename T, int VPL, int LPR>
int fwd(const void* x, const void* r, const float* u, const float* w,
        const float* b, void* y, void* s, uint8_t* keep, float* stats,
        int rows, int D, float p, float inv, float eps, cudaStream_t st) {
  constexpr int SLOTS = NTHREADS / LPR;
  const int grid =
      min_int((rows + SLOTS - 1) / SLOTS, sm_count() * FWD_BLOCKS_PER_SM);
  residual_norm_fwd_kernel<T, VPL, LPR><<<grid, NTHREADS, 0, st>>>(
      (const T*)x, (const T*)r, u, w, b, (T*)y, (T*)s, keep, (float2*)stats,
      rows, D, p, inv, eps);
  return (int)cudaGetLastError();
}

template <typename T, int VPL, int LPR>
int bwd(const void* dy, const void* s, const uint8_t* keep,
        const float* stats, const float* w, void* ds, void* dx,
        float* part_w, float* part_b, int max_parts, float* dw, float* db,
        int rows, int D, float inv, cudaStream_t st) {
  constexpr int SLOTS = NTHREADS / LPR;
  const size_t smem = 2 * (size_t)D * sizeof(float);
  const int grid = min_int((rows + SLOTS - 1) / SLOTS, max_parts);
  residual_norm_bwd_kernel<T, VPL, LPR><<<grid, NTHREADS, smem, st>>>(
      (const T*)dy, (const T*)s, keep, (const float2*)stats, w, (T*)ds,
      (T*)dx, part_w, part_b, rows, D, inv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  residual_norm_dwb_kernel<<<(D + DWB_COLS - 1) / DWB_COLS,
                             dim3(DWB_COLS, DWB_SPLIT), 0, st>>>(
      part_w, part_b, grid, D, dw, db);
  return (int)cudaGetLastError();
}

// The instantiation a row width takes, by its count of 16-byte vectors:
// 48 (bf16 D = 384, a half warp a row), 96 (bf16 768, fp32 384), 192
// (fp32 768); the generic ones up to 64, 256 and 1024.
#define CLDRD_RN_DISPATCH(FN, T, NVEC, ...)                       \
  ((NVEC) == 48    ? FN<T, 3, 16>(__VA_ARGS__)                    \
   : (NVEC) == 96  ? FN<T, 3, 32>(__VA_ARGS__)                    \
   : (NVEC) == 192 ? FN<T, 6, 32>(__VA_ARGS__)                    \
   : (NVEC) <= 64  ? FN<T, 2, 32>(__VA_ARGS__)                    \
   : (NVEC) <= 256 ? FN<T, 8, 32>(__VA_ARGS__)                    \
                   : FN<T, 32, 32>(__VA_ARGS__))

inline bool shape_ok(int dtype, int rows, int D) {
  return (dtype == DT_F32 || dtype == DT_BF16) && rows > 0 && D >= 8 &&
         D <= MAX_D && D % 8 == 0;
}

}  // namespace cldrd_rn

// y = LayerNorm(dropout(x) + r); r, u (the dropout's uniforms) and the
// saved s, keep, stats may each be null. x, r, y, s: [rows, D] in the
// compute dtype; u [rows, D] fp32; w, b [D] fp32; keep [rows, D / vector]
// bytes; stats [rows, 2] fp32 (mean, rstd).
extern "C" int residual_norm_fwd_launch(const void* x, const void* r,
                                        const float* u, const float* w,
                                        const float* b, void* y, void* s,
                                        uint8_t* keep, float* stats,
                                        int dtype, int rows, int D, float p,
                                        float inv, float eps, void* stream) {
  using namespace cldrd_rn;
  if (!shape_ok(dtype, rows, D)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_BF16)
    return CLDRD_RN_DISPATCH(fwd, __nv_bfloat16, D / 8, x, r, u, w, b, y, s,
                             keep, stats, rows, D, p, inv, eps, st);
  return CLDRD_RN_DISPATCH(fwd, float, D / 4, x, r, u, w, b, y, s, keep,
                           stats, rows, D, p, inv, eps, st);
}

// ds (the residual's gradient, null if not wanted) and dx = keep ? ds *
// inv : 0 (null without a mask) from dy, the forward's s, keep and
// stats; dw, db [D] fp32 through part_w, part_b [max_parts, D] fp32,
// one row a block of a grid of at most max_parts blocks.
extern "C" int residual_norm_bwd_launch(const void* dy, const void* s,
                                        const uint8_t* keep,
                                        const float* stats, const float* w,
                                        void* ds, void* dx, float* part_w,
                                        float* part_b, int max_parts,
                                        float* dw, float* db, int dtype,
                                        int rows, int D, float inv,
                                        void* stream) {
  using namespace cldrd_rn;
  if (!shape_ok(dtype, rows, D) || max_parts < 1 ||
      (dx != nullptr && keep == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_BF16)
    return CLDRD_RN_DISPATCH(bwd, __nv_bfloat16, D / 8, dy, s, keep, stats,
                             w, ds, dx, part_w, part_b, max_parts, dw, db,
                             rows, D, inv, st);
  return CLDRD_RN_DISPATCH(bwd, float, D / 4, dy, s, keep, stats, w, ds, dx,
                           part_w, part_b, max_parts, dw, db, rows, D, inv,
                           st);
}
