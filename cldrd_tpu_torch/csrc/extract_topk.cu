// K1: fused scores + two-level in-block top-m extraction for exact search.
// The route for bins other than 128 rows, fp32 queries or stores, and
// widths that are not a multiple of 128 up to 768
// (ops/extract_topk.py::kernel_route); every K1 launch of the main path
// takes extract_topk_sm90.cu.
//
// Replaces the TPU kernel cldrd_tpu/search/mips.py::_extract_kernel_factory
// (launched by _binmax_segment_extract). For each 2048-row super-block of
// the corpus and each query:
//   level 1: every bin of bin_rows rows (a power of two, 8 to 256) yields
//            its top-(R-1) (value, position) pairs by R-1 rounds of max +
//            lowest-row argmax + mask; the R-th round's max is the bin's
//            remainder bound, max-reduced over the super-block into rem1;
//   level 2: the super-block's (2048/bin_rows)*(R-1) candidates yield
//            their top-R2 by rounds of max + lowest-position argmax +
//            mask-by-position.
// Bins narrower than a warp reduce over groups of bin_rows lanes with the
// same (value desc, row asc) order. The level-2 candidates of small bins
// outgrow the 96-entry buffer per query, so a full buffer is compressed
// to its own level-2 result (top-R2 distinct positions, with the
// exhausted-round fill); level 2 over (compressed A) + B equals level 2
// over A + B, because a bin's copies of a position never straddle a
// compression. At 128-row bins the buffer never fills.
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
// walks its bins in a loop (the TPU carried level-1 candidates across
// sequential grid steps in VMEM; blocks here run in no order, so nothing
// crosses blocks). Blocks of one super-block are adjacent in the grid, so
// the corpus streams from HBM about once and is re-read from L2. The
// score tile, level-1 candidates and bounds live in shared memory. This
// first version stages depth chunks synchronously through WMMA; wgmma,
// TMA and a pipelined ring are the next steps toward the bound.
#include <climits>
#include <math.h>

#include "score_tile.cuh"
#include "topk_select.cuh"  // better, group_best, level2_warp

namespace cldrd {
namespace {

constexpr int SUP_ROWS = 2048;
constexpr int MAX_M = 6;                 // level-1 candidates per bin (R-1)
constexpr int MAX_R2 = 16;               // level-2 rounds
constexpr int CAND_LD = 96;              // candidate buffer per query
static_assert(CAND_LD <= 3 * 32, "level 2 holds 3 candidates per lane");
static_assert(CAND_LD >= MAX_R2 + 4 * MAX_M, "room after a compression");

// Bins of BIN rows. A lane holds VPL values of one bin; a group of G lanes
// holds a bin, BPW bins per warp pass. Rows are taken SPAN at a time: one
// 128-row score tile, or two for 256-row bins.
template <int BIN>
struct BinPlan {
  static constexpr int G = BIN < 32 ? BIN : 32;
  static constexpr int VPL = BIN / G;
  static constexpr int BPW = 32 / G;
  static constexpr int SPAN = BIN > TILE_ROWS ? BIN : TILE_ROWS;
  static constexpr int STEPS = SUP_ROWS / SPAN;
  static constexpr int PASSES = SPAN / BIN / BPW;
  static constexpr int TILES = SPAN / TILE_ROWS;
  // whether the candidate buffer can fill up (then it is compressed)
  static constexpr bool COMPRESSES = SUP_ROWS / BIN * MAX_M > CAND_LD;
  static constexpr int SMEM = STAGE_BYTES + TILES * TILE_BYTES
                              + 2 * QB * CAND_LD * 4   // candidates
                              + QB * 4                 // rem per query
                              + 2 * SPAN * 4;          // row scale / validity
  static_assert(SPAN % (BIN * BPW) == 0, "whole passes");
};

template <int BIN, typename QT, typename CT>
__global__ void __launch_bounds__(NTHREADS, 2)
extract_topk_kernel(const QT* __restrict__ q, const CT* __restrict__ c,
                    const int* __restrict__ ids,
                    const float* __restrict__ scales,
                    float* __restrict__ out_v, int* __restrict__ out_p,
                    float* __restrict__ out_rem, int B, int nsup, int D,
                    int m, int rounds2) {
  using P = BinPlan<BIN>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ss = reinterpret_cast<float*>(smem + STAGE_BYTES);
  float* cand_v = Ss + P::TILES * QB * S_LD;
  int* cand_p = reinterpret_cast<int*>(cand_v + QB * CAND_LD);
  float* s_rem = reinterpret_cast<float*>(cand_p + QB * CAND_LD);
  float* row_scale = s_rem + QB;
  int* row_valid = reinterpret_cast<int*>(row_scale + P::SPAN);

  const int nqc = B / QB;
  const int qc = blockIdx.x % nqc;
  const long long sup = blockIdx.x / nqc;  // adjacent blocks share rows
  const int q0 = qc * QB;
  const long long N = (long long)nsup * SUP_ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int QPW = QB / NWARPS;  // queries per warp
  const float NEG = -INFINITY;
  const int gi = lane / P::G, gl = lane % P::G;  // group, lane in group

  if (threadIdx.x < QB) s_rem[threadIdx.x] = NEG;
  int cnt = 0;  // candidates buffered per query (the same for every query)

  for (int step = 0; step < P::STEPS; ++step) {
    const long long r0 = sup * SUP_ROWS + (long long)step * P::SPAN;
    // each begins with a barrier: the previous step's epilogue is done
#pragma unroll
    for (int t = 0; t < P::TILES; ++t)
      score_tile<QT, CT>(q, c, B, N, D, q0, r0 + t * TILE_ROWS, smem,
                         Ss + t * QB * S_LD);
    for (int i = threadIdx.x; i < P::SPAN; i += NTHREADS) {
      const long long gr = r0 + i;
      row_scale[i] = scales != nullptr ? scales[gr] : 1.0f;
      row_valid[i] = ids[gr] >= 0;
    }
    __syncthreads();

    // level 1: warp w extracts for queries [w*QPW, (w+1)*QPW)
    const int step_base = (int)r0;
    int c_end = cnt;
    for (int qq = 0; qq < QPW; ++qq) {
      const int ql = warp * QPW + qq;
      float* qv = cand_v + ql * CAND_LD;
      int* qp = cand_p + ql * CAND_LD;
      int cq = cnt;
      for (int ps = 0; ps < P::PASSES; ++ps) {
        if (P::COMPRESSES && cq + P::BPW * m > CAND_LD) {
          // compress the buffer to its top rounds2 (same level-2 result)
          float ov;
          int op;
          level2_warp(qv, qp, cq, rounds2, ov, op);
          __syncwarp();
          if (lane < rounds2) {
            qv[lane] = ov;
            qp[lane] = op;
          }
          __syncwarp();
          cq = rounds2;
        }
        const int bin_row0 = (ps * P::BPW + gi) * BIN;  // within the step
        float v[P::VPL];
#pragma unroll
        for (int t = 0; t < P::VPL; ++t) {
          const int r = bin_row0 + gl + P::G * t;
          const float* tile =
              P::TILES == 1 ? Ss : Ss + (r / TILE_ROWS) * QB * S_LD;
          const float s = tile[ql * S_LD + r % TILE_ROWS] * row_scale[r];
          v[t] = row_valid[r] ? s : NEG;
        }
        for (int rr = 0; rr <= m; ++rr) {
          float bv = v[0];
          int bi = bin_row0 + gl;
#pragma unroll
          for (int t = 1; t < P::VPL; ++t)
            if (v[t] > bv) {  // rows ascend with t: ties keep the lower row
              bv = v[t];
              bi = bin_row0 + gl + P::G * t;
            }
          group_best<P::G>(bv, bi);
          if (rr == m) {  // the R-th max bounds everything left in the bin
            // groups narrower than the warp hold different bins
            const float wm = P::G < 32 ? warp_max_f(bv) : bv;
            if (lane == 0) s_rem[ql] = fmaxf(s_rem[ql], wm);
            break;
          }
          if (gl == 0) {
            qv[cq + gi * m + rr] = bv;
            qp[cq + gi * m + rr] = step_base + bi;
          }
          const int off = bi - bin_row0;  // within the bin
          if (off % P::G == gl) {
#pragma unroll
            for (int t = 0; t < P::VPL; ++t)
              if (off / P::G == t) v[t] = NEG;
          }
        }
        cq += P::BPW * m;
        if (P::COMPRESSES) __syncwarp();  // the buffer is read lane-wide
      }
      c_end = cq;
    }
    cnt = c_end;
  }
  __syncthreads();

  // level 2 over each query's buffered candidates, by position
  for (int qq = 0; qq < QPW; ++qq) {
    const int ql = warp * QPW + qq;
    float ov;
    int op;
    level2_warp(cand_v + ql * CAND_LD, cand_p + ql * CAND_LD, cnt, rounds2,
                ov, op);
    const long long row = (long long)(q0 + ql) * nsup + sup;
    if (lane < rounds2) {
      out_v[row * rounds2 + lane] = ov;
      out_p[row * rounds2 + lane] = op;
    }
    if (lane == 0) out_rem[row] = s_rem[ql];
  }
}

template <int BIN, typename QT, typename CT>
int run_bin(const void* q, const void* c, const int* ids, const float* scales,
            float* out_v, int* out_p, float* out_rem, int B, int nsup, int D,
            int m, int rounds2, cudaStream_t stream) {
  static bool smem_set[MAX_DEVICES] = {};
  auto kern = extract_topk_kernel<BIN, QT, CT>;
  constexpr int smem = BinPlan<BIN>::SMEM;
  const cudaError_t e = allow_dynamic_smem(kern, smem, smem_set);
  if (e != cudaSuccess) return (int)e;
  const long long nblocks = (long long)nsup * (B / QB);
  kern<<<(unsigned)nblocks, NTHREADS, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const CT*>(c), ids, scales,
      out_v, out_p, out_rem, B, nsup, D, m, rounds2);
  return (int)cudaGetLastError();
}

template <typename QT, typename CT>
struct Launch {
  static int run(int bin_rows, const void* q, const void* c, const int* ids,
                 const float* scales, float* out_v, int* out_p,
                 float* out_rem, int B, int nsup, int D, int m, int rounds2,
                 cudaStream_t stream) {
#define CLDRD_BIN(n)                                                        \
  case n:                                                                   \
    return run_bin<n, QT, CT>(q, c, ids, scales, out_v, out_p, out_rem, B,  \
                              nsup, D, m, rounds2, stream);
    switch (bin_rows) {
      CLDRD_BIN(8)
      CLDRD_BIN(16)
      CLDRD_BIN(32)
      CLDRD_BIN(64)
      CLDRD_BIN(128)
      CLDRD_BIN(256)
    }
#undef CLDRD_BIN
    return (int)cudaErrorInvalidValue;
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
                                   int bin_rows, void* stream) {
  using namespace cldrd;
  if (B <= 0 || B % QB != 0 || nsup <= 0 || D <= 0 || D % 16 != 0 ||
      rounds < 2 || rounds - 1 > MAX_M || rounds2 < 1 || rounds2 > MAX_R2)
    return (int)cudaErrorInvalidValue;
  return dispatch_dtypes<Launch>(q_dtype, c_dtype, bin_rows, q, c, ids,
                                 scales, out_v,
                                 out_p, out_rem, B, nsup, D, rounds - 1,
                                 rounds2, (cudaStream_t)stream);
}
