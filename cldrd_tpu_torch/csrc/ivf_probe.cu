// K6: IVF probe-and-score.
//
// Replaces the TPU kernels cldrd_tpu/ops/ivf_probe.py::_kernel_plain and
// ::_kernel_scaled (launched by probe_scores). For every (query b, probe p)
// it scores the slot rows of bucket probe[b, p] of a row-layout store
// [nb * slot, D] against q[b]:
//   out[b, p * slot + r] = (bf16(q[b]) . widen(rows[probe[b, p] * slot + r]))
//                          * scales[probe[b, p], r]          (int8 stores)
// with fp32 accumulation. int8 codes and bf16 values are exact in fp32, and
// so is a product of two bf16 values, so every product is exact and only
// the order of the fp32 sum differs from the plain version's matmul. Like
// the TPU kernel's _dot_cq, an fp32 query is rounded to bf16 first.
//
// On the TPU, scalar prefetch chose each grid step's bucket address. Here
// each block reads probe[b, p] itself and computes its rows' 64-bit
// offsets (the full-corpus store holds more than 2^31 elements).
//
// Bound on an H100 SXM: the probed rows, read once (B = 8, P = 32,
// slot = 2048, D = 768, int8: 403 MB, 0.12 ms at 3.35 TB/s); the work is
// 2 operations a byte, far below the tensor cores' line. Design: one
// block scores 128 rows of one bucket; a warp owns a row at a time, each
// lane loading 16-byte vectors of it, and keeps RU rows' loads in flight
// before reducing them with shuffles. The lane's slice of q lives in
// registers, so shared memory is not used. A bucket probed by several
// queries is read once per (query, probe); reading it once for all of
// them (and wgmma, TMA) is left to a later version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cldrd_ivf {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int ROWS_PER_BLOCK = 128;
constexpr int RU = 4;        // rows in flight per warp
constexpr int MAX_D = 1024;

// dtype codes shared with the Python wrappers (as csrc/score_tile.cuh)
enum DType { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2 };

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float bf16_round(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// element e of a 16-byte vector, widened to fp32 (exact)
template <typename CT>
struct Widen;
template <>
struct Widen<int8_t> {
  static constexpr int EPV = 16;
  __device__ __forceinline__ static float at(const uint4& v, int e) {
    const uint32_t w = e < 4 ? v.x : e < 8 ? v.y : e < 12 ? v.z : v.w;
    return (float)(int8_t)(w >> (8 * (e & 3)));
  }
};
template <>
struct Widen<__nv_bfloat16> {
  static constexpr int EPV = 8;
  __device__ __forceinline__ static float at(const uint4& v, int e) {
    const uint32_t w = e < 2 ? v.x : e < 4 ? v.y : e < 6 ? v.z : v.w;
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

template <typename QT, typename CT>
__global__ void __launch_bounds__(NTHREADS)
ivf_probe_kernel(const QT* __restrict__ q, const CT* __restrict__ rows,
                 const int* __restrict__ probe,
                 const float* __restrict__ scales, float* __restrict__ out,
                 int P, int nb, int slot, int D) {
  constexpr int EPV = Widen<CT>::EPV;
  constexpr int VPL = MAX_D / EPV / 32;  // vectors of a row per lane, at most
  const int bp = blockIdx.x;             // b * P + p
  const int b = bp / P;
  const int bucket = probe[bp];
  const int r_begin = blockIdx.y * ROWS_PER_BLOCK;
  const int r_end = min(slot, r_begin + ROWS_PER_BLOCK);
  float* dst = out + (long long)bp * slot;
  if (bucket < 0 || bucket >= nb) {  // not a bucket: NaN scores, visible
    for (int r = r_begin + threadIdx.x; r < r_end; r += NTHREADS)
      dst[r] = NAN;
    return;
  }
  const int nvec = D / EPV;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  float qv[VPL][EPV];
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int v = lane + 32 * j;
#pragma unroll
    for (int e = 0; e < EPV; ++e)
      qv[j][e] = v < nvec ? bf16_round(q[(long long)b * D + v * EPV + e]) : 0.f;
  }

  const long long row0 = (long long)bucket * slot;
  for (int r = r_begin + warp * RU; r < r_end; r += NWARPS * RU) {
    uint4 raw[RU][VPL];
#pragma unroll
    for (int u = 0; u < RU; ++u) {
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int v = lane + 32 * j;
        raw[u][j] = make_uint4(0u, 0u, 0u, 0u);
        if (v < nvec && r + u < r_end)
          raw[u][j] = *reinterpret_cast<const uint4*>(
              rows + (row0 + r + u) * D + (long long)v * EPV);
      }
    }
    float acc[RU];
#pragma unroll
    for (int u = 0; u < RU; ++u) {
      acc[u] = 0.f;
#pragma unroll
      for (int j = 0; j < VPL; ++j)
#pragma unroll
        for (int e = 0; e < EPV; ++e)
          acc[u] = fmaf(qv[j][e], Widen<CT>::at(raw[u][j], e), acc[u]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < RU; ++u) {
        if (r + u >= r_end) break;
        float s = acc[u];
        if (scales != nullptr) s *= scales[row0 + r + u];
        dst[r + u] = s;
      }
    }
  }
}

template <typename QT, typename CT>
int launch(const void* q, const void* rows, const int* probe,
           const float* scales, float* out, int B, int P, int nb, int slot,
           int D, cudaStream_t stream) {
  const dim3 grid((unsigned)(B * P),
                  (unsigned)((slot + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK));
  ivf_probe_kernel<QT, CT><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const CT*>(rows), probe, scales,
      out, P, nb, slot, D);
  return (int)cudaGetLastError();
}

}  // namespace cldrd_ivf

// C entry point for ctypes. Returns a cudaError_t (0 on success).
// q [B, D] (f32 or bf16), rows [nb * slot, D] (bf16 or int8), probe [B, P]
// i32, scales [nb, slot] f32 or NULL; out [B, P * slot] f32.
// D % 16 == 0, D <= 1024, B * P < 2^31.
extern "C" int ivf_probe_launch(const void* q, int q_dtype, const void* rows,
                                int c_dtype, const int* probe,
                                const float* scales, float* out, int B, int P,
                                int nb, int slot, int D, void* stream) {
  using namespace cldrd_ivf;
  if (B <= 0 || P <= 0 || nb <= 0 || slot <= 0 || D <= 0 || D % 16 != 0 ||
      D > MAX_D || (long long)B * P > 0x7fffffffLL ||
      (slot + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (q_dtype == DT_BF16 && c_dtype == DT_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, rows, probe, scales, out,
                                                B, P, nb, slot, D, s);
  if (q_dtype == DT_BF16 && c_dtype == DT_I8)
    return launch<__nv_bfloat16, int8_t>(q, rows, probe, scales, out, B, P,
                                         nb, slot, D, s);
  if (q_dtype == DT_F32 && c_dtype == DT_BF16)
    return launch<float, __nv_bfloat16>(q, rows, probe, scales, out, B, P,
                                        nb, slot, D, s);
  if (q_dtype == DT_F32 && c_dtype == DT_I8)
    return launch<float, int8_t>(q, rows, probe, scales, out, B, P, nb, slot,
                                 D, s);
  return (int)cudaErrorInvalidValue;
}
