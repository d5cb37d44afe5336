// K1: fused scores + two-level in-block top-m extraction for exact search.
//
// Replaces the TPU kernel cldrd_tpu/search/mips.py::_extract_kernel_factory
// (launched by _binmax_segment_extract). For each 2048-row super-block of
// the corpus and each query:
//   level 1: every 128-row bin yields its top-(R-1) (value, position) pairs
//            by R-1 rounds of max + lowest-row argmax + mask; the R-th
//            round's max is the bin's remainder bound, max-reduced over the
//            super-block into rem1;
//   level 2: the super-block's 16*(R-1) candidates yield their top-R2 by
//            rounds of max + lowest-position argmax + mask-by-position.
// Scores are fp32: bf16 (or int8-widened) dots on the tensor cores with
// fp32 accumulation, or true fp32 for an fp32 store; the per-row scale
// multiplies after the dot and rows with id < 0 score -inf.
//
// Outputs (B-major, so selection downstream needs no transpose):
//   out_v [B, nsup, R2] f32, out_p [B, nsup, R2] i32 (segment-local
//   positions), out_rem [B, nsup] f32. The [B, N] scores never reach
//   device memory.
//
// Bound on an H100 SXM: 2*B*N*D tensor-core operations against N*D corpus
// bytes. At B=512, N=8,847,360, D=768 with int8 rows that is 6.96 TFLOP
// (7.0 ms at 989 TFLOP/s) against 6.8 GB (2.0 ms at 3.35 TB/s): bound by
// operations. Design: one block owns one super-block x 64 queries and
// walks its 16 bins in a loop (the TPU carried level-1 candidates across
// sequential grid steps in VMEM; blocks here run in no order, so nothing
// crosses blocks). Blocks of one super-block are adjacent in the grid, so
// the corpus streams from HBM about once and is re-read from L2. The
// score tile, level-1 candidates and bounds live in shared memory. This
// first version stages depth chunks synchronously through WMMA; wgmma,
// TMA and a pipelined ring are the next steps toward the bound.
#include <climits>
#include <math.h>

#include "score_tile.cuh"

namespace cldrd {
namespace {

constexpr int SUP_ROWS = 2048;
constexpr int BIN = 128;                 // bin_rows the kernel takes
constexpr int BINS = SUP_ROWS / BIN;     // 16 bins per super-block
constexpr int MAX_M = 6;                 // level-1 candidates per bin (R-1)
constexpr int MAX_R2 = 16;               // level-2 rounds
constexpr int CAND_LD = BINS * MAX_M;    // 96 candidates per query
static_assert(CAND_LD <= 3 * 32, "level 2 holds 3 candidates per lane");
static_assert(TILE_ROWS == BIN, "one score tile is one bin");

constexpr int SMEM_BYTES = STAGE_BYTES + TILE_BYTES
                           + 2 * QB * CAND_LD * 4   // candidate values/positions
                           + QB * 4                 // rem per query
                           + 2 * TILE_ROWS * 4;     // row scale / validity

// better(a, b): larger value, ties to the smaller index
__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

template <typename QT, typename CT>
__global__ void __launch_bounds__(NTHREADS, 2)
extract_topk_kernel(const QT* __restrict__ q, const CT* __restrict__ c,
                    const int* __restrict__ ids,
                    const float* __restrict__ scales,
                    float* __restrict__ out_v, int* __restrict__ out_p,
                    float* __restrict__ out_rem, int B, int nsup, int D,
                    int m, int rounds2) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ss = reinterpret_cast<float*>(smem + STAGE_BYTES);
  float* cand_v = Ss + QB * S_LD;
  int* cand_p = reinterpret_cast<int*>(cand_v + QB * CAND_LD);
  float* s_rem = reinterpret_cast<float*>(cand_p + QB * CAND_LD);
  float* row_scale = s_rem + QB;
  int* row_valid = reinterpret_cast<int*>(row_scale + TILE_ROWS);

  const int nqc = B / QB;
  const int qc = blockIdx.x % nqc;
  const long long sup = blockIdx.x / nqc;  // adjacent blocks share rows
  const int q0 = qc * QB;
  const long long N = (long long)nsup * SUP_ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int QPW = QB / NWARPS;  // queries per warp
  const float NEG = -INFINITY;

  if (threadIdx.x < QB) s_rem[threadIdx.x] = NEG;

  for (int bin = 0; bin < BINS; ++bin) {
    const long long r0 = sup * SUP_ROWS + bin * BIN;
    // begins with a barrier: the previous bin's epilogue is done
    score_tile<QT, CT>(q, c, B, N, D, q0, r0, smem, Ss);
    if (threadIdx.x < TILE_ROWS) {
      const long long gr = r0 + threadIdx.x;
      row_scale[threadIdx.x] = scales != nullptr ? scales[gr] : 1.0f;
      row_valid[threadIdx.x] = ids[gr] >= 0;
    }
    __syncthreads();

    // level 1: warp w extracts for queries [w*QPW, (w+1)*QPW); lane holds
    // rows lane + 32j of the bin
    const int bin_base = (int)(sup * SUP_ROWS) + bin * BIN;
    for (int qq = 0; qq < QPW; ++qq) {
      const int ql = warp * QPW + qq;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = lane + 32 * j;
        const float s = Ss[ql * S_LD + r] * row_scale[r];
        v[j] = row_valid[r] ? s : NEG;
      }
      for (int rr = 0; rr <= m; ++rr) {
        float bv = v[0];
        int bi = lane;
#pragma unroll
        for (int j = 1; j < 4; ++j)
          if (v[j] > bv) {  // rows ascend with j: ties keep the lower row
            bv = v[j];
            bi = lane + 32 * j;
          }
        warp_best(bv, bi);
        if (rr == m) {  // the R-th max bounds everything left in the bin
          if (lane == 0) s_rem[ql] = fmaxf(s_rem[ql], bv);
          break;
        }
        if (lane == 0) {
          cand_v[ql * CAND_LD + bin * m + rr] = bv;
          cand_p[ql * CAND_LD + bin * m + rr] = bin_base + bi;
        }
        if ((bi & 31) == lane) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if ((bi >> 5) == j) v[j] = NEG;
        }
      }
    }
  }
  __syncthreads();

  // level 2 over the super-block's BINS*m candidates, by position
  const int ncand = BINS * m;
  for (int qq = 0; qq < QPW; ++qq) {
    const int ql = warp * QPW + qq;
    float v[3];
    int p[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int idx = lane + 32 * j;
      if (idx < ncand) {
        v[j] = cand_v[ql * CAND_LD + idx];
        p[j] = cand_p[ql * CAND_LD + idx];
      } else {
        v[j] = NEG;
        p[j] = INT_MAX;
      }
    }
    const long long row = (long long)(q0 + ql) * nsup + sup;
    for (int rr = 0; rr < rounds2; ++rr) {
      float bv = v[0];
      int bp = p[0];
#pragma unroll
      for (int j = 1; j < 3; ++j)
        if (better(v[j], p[j], bv, bp)) {
          bv = v[j];
          bp = p[j];
        }
      warp_best(bv, bp);
      if (lane == 0) {
        out_v[row * rounds2 + rr] = bv;
        out_p[row * rounds2 + rr] = bp;
      }
      // positions may repeat (an exhausted bin re-emits its lowest row):
      // masking by position removes every copy, as the TPU kernel does
#pragma unroll
      for (int j = 0; j < 3; ++j)
        if (p[j] == bp) v[j] = NEG;
    }
    if (lane == 0) out_rem[row] = s_rem[ql];
  }
}

template <typename QT, typename CT>
struct Launch {
  static int run(const void* q, const void* c, const int* ids,
                 const float* scales, float* out_v, int* out_p,
                 float* out_rem, int B, int nsup, int D, int m, int rounds2,
                 cudaStream_t stream) {
    static bool smem_set[MAX_DEVICES] = {};
    auto kern = extract_topk_kernel<QT, CT>;
    const cudaError_t e = allow_dynamic_smem(kern, SMEM_BYTES, smem_set);
    if (e != cudaSuccess) return (int)e;
    const long long nblocks = (long long)nsup * (B / QB);
    kern<<<(unsigned)nblocks, NTHREADS, SMEM_BYTES, stream>>>(
        static_cast<const QT*>(q), static_cast<const CT*>(c), ids, scales,
        out_v, out_p, out_rem, B, nsup, D, m, rounds2);
    return (int)cudaGetLastError();
  }
};

}  // namespace
}  // namespace cldrd

// C entry point for ctypes. Returns a cudaError_t (0 on success).
// q [B, D] (bf16 or f32), c [nsup*2048, D] (bf16, f32 or int8), ids [N]
// i32, scales [N] f32 or NULL; outputs as documented above.
extern "C" int extract_topk_launch(const void* q, int q_dtype, const void* c,
                                   int c_dtype, const int* ids,
                                   const float* scales, float* out_v,
                                   int* out_p, float* out_rem, int B,
                                   int nsup, int D, int rounds, int rounds2,
                                   void* stream) {
  using namespace cldrd;
  if (B <= 0 || B % QB != 0 || nsup <= 0 || D <= 0 || D % 16 != 0 ||
      rounds < 2 || rounds - 1 > MAX_M || rounds2 < 1 || rounds2 > MAX_R2)
    return (int)cudaErrorInvalidValue;
  return dispatch_dtypes<Launch>(q_dtype, c_dtype, q, c, ids, scales, out_v,
                                 out_p, out_rem, B, nsup, D, rounds - 1,
                                 rounds2, (cudaStream_t)stream);
}
