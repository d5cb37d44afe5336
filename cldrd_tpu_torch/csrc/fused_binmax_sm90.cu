// K2 for Hopper (sm_90a): masked fp32 scores [B, N] and the maximum of
// every bin of bin_rows rows [B, N / bin_rows], in one pass. The route of
// every bf16-query launch against a bf16 or int8 store with D a multiple
// of 64 from 128 to 768 and bins of 8-128 rows, any B >= 1 and any N the
// bin size divides (ops/fused_binmax.py::kernel_route): the portable
// search route's batches over 1,024 (FlatIPIndex.search_batched with a
// wide batch_size) and its ragged batches. fp32 operands and other widths
// keep fused_binmax.cu.
//
// Replaces the TPU kernel cldrd_tpu/search/mips.py::_fused_kernel_factory
// (:361, launched by _scores_and_binmax at :442). The function is
// fused_binmax_plain's: bf16 dots (int8 codes widened exactly to bf16)
// with fp32 accumulation, times the row's scale in fp32 after the dot,
// -inf where id < 0. A sum that is exactly zero is +0, as a sum started
// at +0 gives it (the plain version's, and what _top_k orders above -0).
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16):
// - B=512, N=1,048,576, D=768, bf16: 3.76 GB (the 2.15 GB score write,
//   the 1.61 GB store read once) = 1.12 ms against 0.82 TFLOP = 0.83 ms:
//   bytes bind.
// - B=2048 over a 1,769,472-row int8 segment with scales: 5.57 TFLOP =
//   5.63 ms against 16.0 GB = 4.77 ms: operations bind.
//
// Design, against fused_binmax.cu's three limits:
// - Products are wgmma m64n128k16 (bf16 in, fp32 accumulate) with both
//   operands in 128-byte-swizzled shared memory: 64 queries on the M side
//   (A), 128 store rows on the N side (B). The accumulator is query-major
//   like the output: a thread holds 2 queries x 32 rows (rows 8j + 2t,
//   8j + 2t + 1 of the tile), so a bin of 8-128 rows reduces in registers
//   and two quad shuffles, with no transpose.
// - A block takes 128 queries, one 64-query half per consumer
//   warpgroup, and walks a stripe of 32 row tiles; both warpgroups read
//   every 64-deep chunk of a row tile from the same ring stage, so a row
//   tile is fed (by TMA, or widened from int8) once per 128 queries.
//   Adjacent blocks are the stripe's query blocks, so the B/128 reads of
//   a row tile fall close together in time and all but the first hit in
//   L2. The queries are not resident: each stage also carries the
//   chunk's 128 queries (16 KB by TMA, from L2: the queries are 3 MB at
//   B=2048). Resident, 64 of them took 96 KB at D=768, which left a 4-stage
//   ring for each warpgroup's own tiles, and every row tile was fed once
//   per 64 queries; measured, the feed and not the products set the time
//   (tools/k2_variants.py; PERF.md has the runs).
// - Warp roles: a ring of up to 7 stages (32 KB: the chunk's queries and
//   rows) with FULL / EMPTY mbarriers, filled by a producer warpgroup (two
//   for int8): one thread issues the TMA copies (rows past N and queries
//   past B zero-filled); int8 codes are loaded by the producer's threads
//   three chunks ahead in registers (rows past N load as zeros) and
//   widened into the same swizzled bf16 layout (widen4: byte permutes and
//   bf16x2 subtractions, exact), so the wgmma warps never widen. The
//   producer also writes each tile's row factors ((scale, +0), or
//   (0, -inf) for id < 0 and rows past N) before the tile's last chunk is
//   marked full, and for int8 sends the next tile (one contiguous span of
//   the store) to L2 by a bulk prefetch at each tile's first chunk: a stripe's
//   blocks reach a chunk together, and without it they all waited on
//   device memory for it. Barriers count warps: a warp's lanes order their
//   shared-memory accesses with __syncwarp and lane 0 arrives.
// - Epilogue: each consumer scales and masks its accumulators in
//   registers and writes them, once both warpgroups' products have read
//   the tile's last two stages, into its 32 KB of those stages as four
//   [64][32] fp32 boxes under the 128-byte swizzle (a warp's 8 query rows
//   then do not share a bank); one thread issues cp.async.bulk.tensor
//   stores, which clip the box at B and N. The warpgroup reduces the bin
//   maxima from the same registers while the stores drain, and hands the
//   two stages back once the stores have read them
//   (cp.async.bulk.wait_group.read). Each tile's scores are written once;
//   nothing re-reads them.
// Shared memory at D=768: 7 stages x 32 KB, the row factors (1 KB),
// mbarriers, 1 KB of alignment: 231,680 bytes of the 232,448 a block may
// take (one block an SM). The ring takes at most the chunks of the depth
// (D >= 128: two stages hold the epilogue), which keeps the single
// row-factor buffer from being overwritten before it is read.
#include <cuda.h>  // CUtensorMap (types only: the encoder is looked up)
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "score_tile.cuh"  // DType, allow_dynamic_smem, MAX_DEVICES
#include "sm90_pipe.cuh"   // wgmma, mbarriers, TMA, widen4, tensor maps

namespace cldrd_k2_90 {

using namespace cldrd_sm90;
using cldrd::allow_dynamic_smem;
using cldrd::MAX_DEVICES;

constexpr int QB = 128;        // queries per block, 64 a consumer (wgmma M)
constexpr int TILE = 128;      // store rows per tile (wgmma N)
constexpr int KC = 64;         // depth of a chunk (128 bytes of bf16)
constexpr int MIN_D = 128, MAX_D = 768;
// 2 consumer warpgroups and the producer: one warpgroup for bf16 (TMA),
// two for int8 (widening)
__host__ __device__ constexpr int threads_for(bool i8) {
  return i8 ? 512 : 384;
}
__host__ __device__ constexpr int feed_for(bool i8) { return i8 ? 256 : 128; }
constexpr int Q_PART = QB * 128;     // 16 KB: a chunk of the queries
constexpr int STAGE = 2 * Q_PART;    // 32 KB: the chunk's queries, rows
constexpr int BOX = 64 * 128;        // 8 KB: [64 queries][32 scores] fp32
constexpr int SIDE = TILE * 8;       // a tile's row factors
constexpr int BARS = 256;            // mbarrier area
constexpr int MAX_STAGES = 8;
constexpr int TILES_PER_BLOCK = 32;  // a stripe
constexpr int SMEM_LIMIT = 232448;

// bytes of everything but the ring, alignment slack included
__host__ __device__ constexpr int fixed_bytes() {
  return 1024 + SIDE + BARS;
}
// ring stages for a depth D
__host__ __device__ constexpr int stages_for(int D) {
  const int fit = (SMEM_LIMIT - fixed_bytes()) / STAGE;
  const int s = fit < MAX_STAGES ? fit : MAX_STAGES;
  return s < D / KC ? s : D / KC;
}

// ------------------------------------ K2's own: staging stores, barriers

__device__ __forceinline__ void st_shared_v2f(uint32_t addr, float a,
                                              float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a),
               "f"(b)
               : "memory");
}
// consumer warpgroup wg's own barrier; both consumers' barrier (0 is
// __syncthreads)
__device__ __forceinline__ void wg_bar(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}
__device__ __forceinline__ void consumers_bar() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// ----------------------------------------------------------------- kernel

// The producer (thread p of its FEED): marks each item's stage full once
// the chunk's queries and rows and, for a tile's last chunk, the tile's
// row factors are in shared memory. Item n is chunk n % NC of tile
// t0 + n / NC.
template <bool I8>
__device__ __forceinline__ void produce(
    const CUtensorMap* map_q, const CUtensorMap* map_c,
    const int8_t* __restrict__ c8, const int* __restrict__ ids,
    const float* __restrict__ scales, int N, int D, int q0, int t0, int t1,
    int S, int p, uint32_t ring, uint32_t full, uint32_t empty,
    float* side) {
  constexpr int FEED = feed_for(I8);
  const int NC = D / KC;
  const int total = (t1 - t0) * NC;
  int s = 0;
  uint32_t ph = 0;
  // the row factors of row p of a tile (threads p < TILE): loaded at its
  // first chunk, written at its last as (scale, +0), or (0, -inf) for a
  // masked row or one past N
  int id_raw = -1;
  float sc_raw = 1.f;
  auto side_load = [&](int tile) {
    const int r = tile * TILE + p;
    if (p < TILE) {
      id_raw = r < N ? __ldg(ids + r) : -1;
      sc_raw = (r < N && scales != nullptr) ? __ldg(scales + r) : 1.f;
    }
  };
  auto side_store = [&]() {
    if (p < TILE)
      reinterpret_cast<float2*>(side)[p] = id_raw >= 0
                                               ? make_float2(sc_raw, 0.f)
                                               : make_float2(0.f, -INFINITY);
  };
  // one arrival a warp; thread 0's carries the stage's TMA bytes
  auto mark_full = [&](int tile, int k) {
    __syncwarp();
    if (p == 0) {
      const uint32_t st = ring + s * STAGE;
      mbar_expect_tx(full + 8 * s, I8 ? Q_PART : STAGE);
      tma_load(st, map_q, k * KC, q0, full + 8 * s);
      if (!I8)
        tma_load(st + Q_PART, map_c, k * KC, tile * TILE, full + 8 * s);
    } else if ((p & 31) == 0) {
      mbar_arrive(full + 8 * s);
    }
    if (++s == S) {
      s = 0;
      ph ^= 1;
    }
  };

  if constexpr (!I8) {
    for (int n = 0; n < total; ++n) {
      const int tile = t0 + n / NC, k = n % NC;
      if (k == 0) side_load(tile);
      mbar_wait<true>(empty + 8 * s, ph ^ 1);
      if (k == NC - 1) side_store();
      mark_full(tile, k);
    }
  } else {
    // thread p loads codes 16 (p & 3) .. + 15 of rows p / 4 and p / 4 + 64
    // of a chunk, AHEAD items ahead, and widens them into the chunk's
    // 16-byte groups 2 (p & 3) and + 1 of each row, swizzled
    constexpr int AHEAD = 3;
    constexpr int PIECES = TILE * 4 / FEED;  // 16-byte pieces a thread
    const long long row_bytes = D;
    const int rr = p >> 2, cq = p & 3;
    int f_n = 0;
    auto fetch = [&](uint4 (&dst)[PIECES]) {
      if (f_n < total) {
        const long long r0 = (long long)(t0 + f_n / NC) * TILE + rr;
        const int col = (f_n % NC) * KC + 16 * cq;
#pragma unroll
        for (int j = 0; j < PIECES; ++j) {
          const long long r = r0 + (FEED / 4) * j;
          dst[j] = r < N ? __ldg(reinterpret_cast<const uint4*>(
                               c8 + r * D + col))
                         : make_uint4(0u, 0u, 0u, 0u);
        }
      }
      ++f_n;
    };
    uint4 raw[AHEAD][PIECES];
#pragma unroll
    for (int jj = 0; jj < AHEAD; ++jj) fetch(raw[jj]);
    for (int n0 = 0; n0 < total; n0 += AHEAD) {
#pragma unroll
      for (int jj = 0; jj < AHEAD; ++jj) {
        const int n = n0 + jj;
        if (n < total) {
          const int tile = t0 + n / NC, k = n % NC;
          if (k == 0) {
            side_load(tile);
            // the next tile's rows, one contiguous span, into L2
            if (p == 0 && tile + 1 < t1) {
              const int r0 = (tile + 1) * TILE, r1 = min(N, r0 + TILE);
              prefetch_l2(c8 + r0 * row_bytes,
                          (uint32_t)((r1 - r0) * row_bytes));
            }
          }
          mbar_wait<true>(empty + 8 * s, ph ^ 1);
          const uint32_t st = ring + s * STAGE + Q_PART;
#pragma unroll
          for (int j = 0; j < PIECES; ++j) {
            const int row = rr + (FEED / 4) * j;
            const uint32_t w4[4] = {raw[jj][j].x, raw[jj][j].y, raw[jj][j].z,
                                    raw[jj][j].w};
            uint32_t o[8];
#pragma unroll
            for (int q = 0; q < 4; ++q) widen4(w4[q], o[2 * q], o[2 * q + 1]);
            st_shared_v4(st + row * 128 + (((2 * cq) ^ (row & 7)) << 4), o[0],
                         o[1], o[2], o[3]);
            st_shared_v4(st + row * 128 + (((2 * cq + 1) ^ (row & 7)) << 4),
                         o[4], o[5], o[6], o[7]);
          }
          if (k == NC - 1) side_store();
          fence_async_smem();  // the widened chunk is wgmma's to read
          mark_full(tile, k);
          fetch(raw[jj]);
        }
      }
    }
  }
}

template <bool I8>
__global__ void __launch_bounds__(threads_for(I8), 1)
fused_binmax_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_c,
                         const __grid_constant__ CUtensorMap map_s,
                         const int8_t* __restrict__ c8,
                         const int* __restrict__ ids,
                         const float* __restrict__ scales,
                         float* __restrict__ out_b, int B, int N, int D,
                         int bin_rows, int S) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_base = smem_u32(smem_raw);
  const uint32_t base = (raw_base + 1023u) & ~1023u;  // swizzle atoms: 1 KB
  unsigned char* sm = smem_raw + (base - raw_base);
  const int NC = D / KC;
  const uint32_t ring = base;
  const uint32_t sSide = ring + S * STAGE;
  // full(s) at sBar + 8 s, empty(s) at sBar + 64 + 8 s
  const uint32_t full = sSide + SIDE, empty = full + 64;
  float* side = reinterpret_cast<float*>(sm + (sSide - base));

  const int nqb = (B + QB - 1) / QB;
  const int q0 = (blockIdx.x % nqb) * QB;
  const int stripe = blockIdx.x / nqb;  // adjacent blocks share rows
  const int nt = (N + TILE - 1) / TILE;
  const int t0 = stripe * TILES_PER_BLOCK;
  const int t1 = min(nt, t0 + TILES_PER_BLOCK);
  const int tid = threadIdx.x, wg = tid >> 7;

  if (tid == 0) {
    for (int i = 0; i < MAX_STAGES; ++i) {
      mbar_init(full + 8 * i, feed_for(I8) / 32);  // producer warps
      mbar_init(empty + 8 * i, 8);                 // consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg >= 2) {
    produce<I8>(&map_q, &map_c, c8, ids, scales, N, D, q0, t0, t1, S,
                tid - 256, ring, full, empty, side);
    return;
  }

  // consumer warpgroup wg: queries q0 + 64 wg .. + 63 of every tile
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2,
            t = lane & 3, lead = (tid & 127) == 0;
  const int G = bin_rows / 8;  // 8-row column groups a bin
  const int nbins = N / bin_rows;
  const int qw = q0 + 64 * wg;
  float acc[64];
  int s = 0;
  uint32_t ph = 0;
  for (int tile = t0; tile < t1; ++tile) {
    int prev = -1, held = -1;  // held: the last chunk but one's stage
    for (int k = 0; k < NC; ++k) {
      mbar_wait<false>(full + 8 * s, ph);
      const uint32_t st = ring + s * STAGE;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)
        mma_n128(acc, sdesc(st + wg * BOX + kk * 32),
                 sdesc(st + Q_PART + kk * 32), (k | kk) != 0);
      wg_commit();
      if (prev >= 0) {  // the chunk before is done: its stage is free,
        wg_wait<1>();   // but the last chunk but one's stage holds scores
        if (k < NC - 1)
          mbar_arrive_warp(empty + 8 * prev);
        else
          held = prev;
      }
      prev = s;
      if (++s == S) {
        s = 0;
        ph ^= 1;
      }
    }
    wg_wait<0>();
    fence_regs(acc);
    // scale after the dot and mask in one rounding: fma(dot, scale, +0)
    // is dot * scale rounded once, and +0 for an exactly zero sum;
    // fma(dot, 0, -inf) is -inf. The row factors of the thread's columns
    // 8j + 2t + e are read before the stages are released (the producer
    // rewrites them after that)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(side + 16 * j + 4 * t);
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        acc[4 * j + 2 * x] = fmaf(acc[4 * j + 2 * x], v.x, v.y);
        acc[4 * j + 2 * x + 1] = fmaf(acc[4 * j + 2 * x + 1], v.z, v.w);
      }
    }
    // scores out by TMA through the tile's last two stages, which both
    // consumers' products have read once both pass this barrier: this
    // warpgroup's boxes 0-1 at 32 KB wg of the last chunk but one's stage
    // and 2-3 in the last's. Box b holds columns 32b .. 32b + 31, query
    // row q at q * 128, 16-byte group (column / 4) ^ (q & 7); q & 7 is g
    consumers_bar();
    const int r0 = tile * TILE;
    const uint32_t stg[2] = {ring + held * STAGE + wg * 2 * BOX,
                             ring + prev * STAGE + wg * 2 * BOX};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t box = stg[j >> 3] + ((j >> 2) & 1) * BOX;
      const int chunk = 2 * (j & 3) + (t >> 1);
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int ql = 16 * warp + g + 8 * x;
        st_shared_v2f(box + ql * 128 + ((chunk ^ g) << 4) + 8 * (t & 1),
                      acc[4 * j + 2 * x], acc[4 * j + 2 * x + 1]);
      }
    }
    fence_async_smem();  // the boxes are the bulk stores' to read
    wg_bar(wg);
    if (lead) {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        tma_store(&map_s, r0 + 32 * b, qw, stg[b >> 1] + (b & 1) * BOX);
      bulk_commit();
    }
    // bin maxima: a thread's maximum over each bin's columns (its two of
    // every 8-column group), then over the lane quad
#pragma unroll
    for (int i = 0; i < 64; i += 2) acc[i] = fmaxf(acc[i], acc[i + 1]);
#pragma unroll
    for (int lg = 1; lg < 16; lg <<= 1) {
      if (lg < G) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if ((j & lg) == 0)
#pragma unroll
            for (int x = 0; x < 2; ++x)
              acc[4 * j + 2 * x] =
                  fmaxf(acc[4 * j + 2 * x], acc[4 * (j + lg) + 2 * x]);
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (j % G) continue;  // not the first group of a bin
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        float v = acc[4 * j + 2 * x];
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
        const int q = qw + 16 * warp + g + 8 * x;
        const int bin = r0 / bin_rows + j / G;
        if (((j / G) & 3) == t && q < B && bin < nbins)
          out_b[(long long)q * nbins + bin] = v;
      }
    }
    // the stores have read this warpgroup's boxes: its share of the two
    // stages goes back to the producer
    if (lead) bulk_wait_read0();
    wg_bar(wg);
    mbar_arrive_warp(empty + 8 * held);
    mbar_arrive_warp(empty + 8 * prev);
  }
  if (lead) bulk_wait0();  // the scores are written
}

// ------------------------------------------------------------------- host

template <bool I8>
int run(const void* q, const void* c, const int* ids, const float* scales,
        float* out_s, float* out_b, int B, int N, int D, int bin_rows,
        cudaStream_t stream) {
  static bool smem_set[MAX_DEVICES] = {};
  auto kern = fused_binmax_sm90_kernel<I8>;
  const cudaError_t e = allow_dynamic_smem(kern, SMEM_LIMIT, smem_set);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap map_q = {}, map_c = {}, map_s = {};
  int err = make_map(&map_q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, q, D, B,
                     2ll * D, KC, QB);
  if (!err && !I8)
    err = make_map(&map_c, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, c, D, N,
                   2ll * D, KC, TILE);
  if (!err)
    err = make_map(&map_s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, out_s, N, B,
                   4ll * N, 32, 64);
  if (err) return err;
  const int S = stages_for(D);
  const int smem = fixed_bytes() + S * STAGE;
  const int nt = (N + TILE - 1) / TILE;
  const long long nblocks =
      (long long)((B + QB - 1) / QB) *
      ((nt + TILES_PER_BLOCK - 1) / TILES_PER_BLOCK);
  kern<<<(unsigned)nblocks, threads_for(I8), smem, stream>>>(
      map_q, map_c, map_s, static_cast<const int8_t*>(c), ids, scales, out_b,
      B, N, D, bin_rows, S);
  return (int)cudaGetLastError();
}

}  // namespace cldrd_k2_90

// C entry point for ctypes. Returns a cudaError_t (0 on success).
// q [B, D] bf16, c [N, D] bf16 or int8, ids [N] i32, scales [N] f32 or
// NULL; out_s [B, N] f32, out_bmax [B, N / bin_rows] f32; every pointer
// 16-byte aligned. D % 64 == 0, 128 <= D <= 768; bin_rows a power of two
// in [8, 128] dividing N; N < 2^31. The same arguments as
// fused_binmax_launch.
extern "C" int fused_binmax_sm90_launch(const void* q, int q_dtype,
                                        const void* c, int c_dtype,
                                        const int* ids, const float* scales,
                                        float* out_s, float* out_bmax, int B,
                                        long long N, int D, int bin_rows,
                                        void* stream) {
  using namespace cldrd_k2_90;
  const bool pow2 = bin_rows > 0 && (bin_rows & (bin_rows - 1)) == 0;
  if (q_dtype != cldrd::DT_BF16 || B <= 0 || N <= 0 || N >= (1ll << 31) ||
      D % KC != 0 || D < MIN_D || D > MAX_D || !pow2 || bin_rows < 8 ||
      bin_rows > TILE || N % bin_rows != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (c_dtype == cldrd::DT_I8)
    return run<true>(q, c, ids, scales, out_s, out_bmax, B, (int)N, D,
                     bin_rows, s);
  if (c_dtype == cldrd::DT_BF16)
    return run<false>(q, c, ids, scales, out_s, out_bmax, B, (int)N, D,
                      bin_rows, s);
  return (int)cudaErrorInvalidValue;
}
