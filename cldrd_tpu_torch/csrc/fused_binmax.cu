// K2: fused masked scores + per-bin maxima for the portable bin-max route,
// generic kernel: the launches ops/fused_binmax.py::kernel_route does not
// send to fused_binmax_sm90.cu, which are fp32 operands (queries or
// store) and widths that are not a multiple of 64 or exceed 768. No
// launch of the main path takes it since fused_binmax_sm90.cu.
//
// Replaces the TPU kernel cldrd_tpu/search/mips.py::_fused_kernel_factory
// (launched by _scores_and_binmax). One pass computes the fp32 score tile
// of 128 corpus rows x 64 queries (bf16 or int8-widened dots on the tensor
// cores with fp32 accumulation, or true fp32 for an fp32 operand), applies
// the per-row scale after the dot and the id < 0 -> -inf mask, writes the
// tile to scores [B, N] and reduces each bin of bin_rows rows to its max
// while the tile is still in shared memory, writing bmax [B, N / bin_rows].
// The reduction never re-reads the scores from device memory. A sum that
// is exactly zero is written as +0, as the plain version gives it.
//
// Bound on an H100 SXM: the [B, N] fp32 score write and the store read,
// or for fp32 operands the fp32 FMA rate (67 TFLOP/s): at B=512,
// N=1,048,576, D=768 with fp32 rows, 3.2 GB read and 2.15 GB written
// (1.6 ms) against 0.82 TFLOP (12.3 ms): operations bind. Design: score
// writes are row-contiguous per query (coalesced), and the bin max is a
// warp shuffle over float4 reads of the tile. Synchronous WMMA depth
// chunks, as in extract_topk.cu; this kernel is not tuned.
#include <math.h>

#include "score_tile.cuh"

namespace cldrd {
namespace {

constexpr int SMEM_BYTES = STAGE_BYTES + TILE_BYTES + 2 * TILE_ROWS * 4;

template <typename QT, typename CT>
__global__ void __launch_bounds__(NTHREADS)
fused_binmax_kernel(const QT* __restrict__ q, const CT* __restrict__ c,
                    const int* __restrict__ ids,
                    const float* __restrict__ scales,
                    float* __restrict__ out_s, float* __restrict__ out_bmax,
                    int B, long long N, int D, int bin_rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ss = reinterpret_cast<float*>(smem + STAGE_BYTES);
  float* row_scale = Ss + QB * S_LD;
  int* row_valid = reinterpret_cast<int*>(row_scale + TILE_ROWS);

  const int nqc = (B + QB - 1) / QB;
  const int qc = blockIdx.x % nqc;
  const long long tile = blockIdx.x / nqc;  // adjacent blocks share rows
  const int q0 = qc * QB;
  const long long r0 = tile * TILE_ROWS;
  const float NEG = -INFINITY;

  score_tile<QT, CT>(q, c, B, N, D, q0, r0, smem, Ss);
  if (threadIdx.x < TILE_ROWS) {
    const long long gr = r0 + threadIdx.x;
    const bool in = gr < N;
    row_scale[threadIdx.x] = (in && scales != nullptr) ? scales[gr] : 1.0f;
    row_valid[threadIdx.x] = in && ids[gr] >= 0;
  }
  __syncthreads();

  // scale + mask in place, and write the tile: consecutive threads take
  // consecutive rows of one query
  for (int i = threadIdx.x; i < QB * TILE_ROWS; i += NTHREADS) {
    const int ql = i / TILE_ROWS, r = i % TILE_ROWS;
    float s = (Ss[ql * S_LD + r] + 0.0f) * row_scale[r];  // -0 -> +0
    s = row_valid[r] ? s : NEG;
    Ss[ql * S_LD + r] = s;
    if (q0 + ql < B && r0 + r < N) out_s[(long long)(q0 + ql) * N + r0 + r] = s;
  }
  __syncthreads();

  // bin maxima: lane covers rows [4*lane, 4*lane + 4); a bin spans
  // bin_rows / 4 consecutive lanes, reduced by xor shuffles
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lanes_per_bin = bin_rows / 4;
  const long long nbins = N / bin_rows;
  constexpr int QPW = QB / NWARPS;
  for (int qq = 0; qq < QPW; ++qq) {
    const int ql = warp * QPW + qq;
    if (q0 + ql >= B) break;  // uniform across the warp
    const float4 x = *reinterpret_cast<const float4*>(Ss + ql * S_LD + 4 * lane);
    float mx = fmaxf(fmaxf(x.x, x.y), fmaxf(x.z, x.w));
    for (int off = 1; off < lanes_per_bin; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const long long row = r0 + 4 * lane;
    if (lane % lanes_per_bin == 0 && row < N)
      out_bmax[(long long)(q0 + ql) * nbins + row / bin_rows] = mx;
  }
}

template <typename QT, typename CT>
struct Launch {
  static int run(const void* q, const void* c, const int* ids,
                 const float* scales, float* out_s, float* out_bmax, int B,
                 long long N, int D, int bin_rows, cudaStream_t stream) {
    static bool smem_set[MAX_DEVICES] = {};
    auto kern = fused_binmax_kernel<QT, CT>;
    const cudaError_t e = allow_dynamic_smem(kern, SMEM_BYTES, smem_set);
    if (e != cudaSuccess) return (int)e;
    const long long nblocks =
        (long long)((B + QB - 1) / QB) * ((N + TILE_ROWS - 1) / TILE_ROWS);
    kern<<<(unsigned)nblocks, NTHREADS, SMEM_BYTES, stream>>>(
        static_cast<const QT*>(q), static_cast<const CT*>(c), ids, scales,
        out_s, out_bmax, B, N, D, bin_rows);
    return (int)cudaGetLastError();
  }
};

}  // namespace
}  // namespace cldrd

// C entry point for ctypes. Returns a cudaError_t (0 on success).
// q [B, D] (bf16 or f32), c [N, D] (bf16, f32 or int8), ids [N] i32,
// scales [N] f32 or NULL; out_s [B, N] f32, out_bmax [B, N / bin_rows] f32.
// bin_rows is a power of two in [8, 128] dividing N.
extern "C" int fused_binmax_launch(const void* q, int q_dtype, const void* c,
                                   int c_dtype, const int* ids,
                                   const float* scales, float* out_s,
                                   float* out_bmax, int B, long long N, int D,
                                   int bin_rows, void* stream) {
  using namespace cldrd;
  const bool pow2 = bin_rows > 0 && (bin_rows & (bin_rows - 1)) == 0;
  if (B <= 0 || N <= 0 || D <= 0 || D % 16 != 0 || !pow2 || bin_rows < 8 ||
      bin_rows > TILE_ROWS || N % bin_rows != 0)
    return (int)cudaErrorInvalidValue;
  return dispatch_dtypes<Launch>(q_dtype, c_dtype, q, c, ids, scales, out_s,
                                 out_bmax, B, N, D, bin_rows,
                                 (cudaStream_t)stream);
}
