// K7 for Hopper (sm_90a): the score-tile maximum of the int8 A/B.
// out[i, b] = max over the rows r of store tile i (tile_rows rows) of
// dot(c[r], q[b]), fp32 [N / tile_rows, B]; no ids, mask or row scale.
// Three variants, picked by the operand types
// (ops/int8_dot.py::kernel_route):
// - bf16:        bf16 queries x bf16 store, fp32 accumulation;
// - int8_cast:   bf16 queries x int8 store widened to bf16 in the kernel;
// - int8_native: int8 queries x int8 store, s32 accumulation, cast to
//   fp32 at the end (exact: |sum| <= 128 * 128 * 768 < 2^24).
//
// Replaces the TPU kernel examples/bench_int8_dot.py::make_kernel (:37,
// launched by bench at :86), which asks whether the int8 store's score
// product runs at the int8 matrix rate at the search's tile shape.
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16, 1,979 TOPS int8) at
// the A/B's shape N = 1,114,112, D = 768, B = 512: 2 * 512 * 768 * N =
// 876.17 G operations, so operations bind every variant:
// - bf16:        1.711 GB read = 0.511 ms against 0.886 ms of products;
// - int8_cast:   0.856 GB      = 0.256 ms against 0.886 ms (bf16 rate);
// - int8_native: 0.856 GB      = 0.256 ms against 0.443 ms (int8 rate).
// The output (2.2 MB) does not matter.
//
// Design: K2's pipeline (fused_binmax_sm90.cu; the shared parts are in
// sm90_pipe.cuh). A work item is 128 queries against one store tile,
// walked as tile_rows / 128 row tiles of 128; a consumer warpgroup takes
// 64 of the queries as wgmma's A (M = 64) and a row tile as B (N = 128),
// both K-major in 128-byte-swizzled shared memory, fed through a ring of
// 7 stages of 32 KB (a 128-byte-deep chunk of the 128 queries and of the
// 128 rows) with FULL / EMPTY mbarriers that count warps. Where it
// differs from K2:
// - No score write. Each thread keeps a running maximum of its two query
//   rows over the 32 columns it holds of every row tile (registers), and
//   at the end of the item reduces it over the lane quad by shuffles and
//   writes one value a (tile, query). A chunk's stage goes back to the
//   producer as soon as the products reading it retire.
// - int8_native: wgmma m64n128k32.s32.s8.s8 (SASS IGMMA). A chunk is 128
//   int8 codes deep (bf16: 64 values), so 24 products cover D = 768 where
//   bf16 takes 48; both operands come K-major by TMA (8-bit wgmma takes no
//   transposed operand, and queries [B, D] and store [N, D] are both
//   K-major as they lie), with the same 128-byte swizzle and descriptors
//   as bf16 (a depth step is 32 bytes in both). At D % 128 == 64 the last
//   chunk's upper half lies past D, and TMA fills it with zeros. The s32
//   accumulators become fp32 once, after the maximum.
// - int8_cast: the int8 rows are widened by two producer warpgroups into
//   the bf16 layout, as K2 does (widen4), and go through K2's
//   m64n128k16.f32.bf16.bf16; bf16 and int8_native load both operands by
//   TMA, from one producer thread.
// - Grid: persistent, one block an SM (the ring takes 224 KB), walking
//   the items blockIdx.x, + gridDim.x, ...; an item is (store tile,
//   query block) with the query block fastest, so the blocks reading one
//   store tile run side by side and all but the first find its rows in
//   L2. The ring runs on across items with no refill.
// - B % 128 == 0 and N % tile_rows == 0, so nothing is masked or clipped.
#include <cuda.h>  // CUtensorMap (types only: the encoder is looked up)
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "score_tile.cuh"  // DType, allow_dynamic_smem, MAX_DEVICES
#include "sm90_pipe.cuh"   // wgmma, mbarriers, TMA, widen4, tensor maps

namespace cldrd_k7_90 {

using namespace cldrd_sm90;
using cldrd_sm90::mma_n128;  // bf16, beside the s8 overload below
using cldrd::allow_dynamic_smem;
using cldrd::MAX_DEVICES;

enum Mode { BF16 = 0, CAST = 1, NATIVE = 2 };

constexpr int QB = 128;           // queries an item, 64 a consumer (M)
constexpr int TILE = 128;         // store rows a row tile (wgmma N)
constexpr int Q_PART = QB * 128;  // 16 KB: a chunk of the queries
constexpr int STAGE = 2 * Q_PART; // 32 KB: the chunk's queries, rows
constexpr int BOX = 64 * 128;     // 8 KB: a consumer's 64 queries of it
constexpr int BARS = 256;         // mbarrier area
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;
constexpr int MIN_D = 128, MAX_D = 768;
constexpr int FIXED = 1024 + BARS;  // alignment slack, mbarriers
constexpr int STAGES = (SMEM_LIMIT - FIXED) / STAGE < MAX_STAGES
                           ? (SMEM_LIMIT - FIXED) / STAGE
                           : MAX_STAGES;

// values a chunk (128 bytes of a row)
__host__ __device__ constexpr int kc_for(int m) {
  return m == NATIVE ? 128 : 64;
}
// 2 consumer warpgroups and the producer: one warpgroup (of which one
// thread issues TMA), two for int8_cast (widening)
__host__ __device__ constexpr int threads_for(int m) {
  return m == CAST ? 512 : 384;
}
__host__ __device__ constexpr int feed_warps(int m) {
  return m == CAST ? 8 : 1;
}

// where the n-th ring item of this block lies: chunk k of the row tile
// starting at row0, for the queries from q0
struct Walk {
  int nqb, RT, NC, T;
  __device__ __forceinline__ void at(int n, int& row0, int& q0,
                                     int& k) const {
    const int per_item = RT * NC;
    const int item = (int)blockIdx.x + (n / per_item) * (int)gridDim.x;
    const int in = n % per_item;
    row0 = (item / nqb) * T + (in / NC) * TILE;
    q0 = (item % nqb) * QB;
    k = in % NC;
  }
};

// d[64 x 128] (+)= A[64 x 32] . B[32 x 128], s8 x s8 -> s32, both K-major
// in shared memory; the accumulator layout is mma_n128's
#define K7_IACC16(d, o)                                                    \
  "+r"(d[o + 0]), "+r"(d[o + 1]), "+r"(d[o + 2]), "+r"(d[o + 3]),           \
      "+r"(d[o + 4]), "+r"(d[o + 5]), "+r"(d[o + 6]), "+r"(d[o + 7]),       \
      "+r"(d[o + 8]), "+r"(d[o + 9]), "+r"(d[o + 10]), "+r"(d[o + 11]),     \
      "+r"(d[o + 12]), "+r"(d[o + 13]), "+r"(d[o + 14]), "+r"(d[o + 15])
__device__ __forceinline__ void mma_n128(int (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : K7_IACC16(d, 0), K7_IACC16(d, 16), K7_IACC16(d, 32),
        K7_IACC16(d, 48)
      : "l"(a), "l"(b), "r"(accumulate)
      : "memory");
}

__device__ __forceinline__ float max2(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ int max2(int a, int b) { return max(a, b); }

// ----------------------------------------------------------------- kernel

// The producer (thread p of its warps): fills the ring with the block's
// items in order and marks each stage full once its chunk of the queries
// and rows is in shared memory.
template <int MODE>
__device__ __forceinline__ void produce(const CUtensorMap* map_q,
                                        const CUtensorMap* map_c,
                                        const int8_t* __restrict__ c8,
                                        const Walk& w, int D, int total,
                                        int p, uint32_t ring, uint32_t full,
                                        uint32_t empty) {
  constexpr int KC = kc_for(MODE);
  int s = 0;
  uint32_t ph = 0;
  auto advance = [&]() {
    if (++s == STAGES) {
      s = 0;
      ph ^= 1;
    }
  };
  if constexpr (MODE != CAST) {
    // one thread: both boxes by TMA
    for (int n = 0; n < total; ++n) {
      int row0, q0, k;
      w.at(n, row0, q0, k);
      mbar_wait<true>(empty + 8 * s, ph ^ 1);
      const uint32_t st = ring + s * STAGE;
      mbar_expect_tx(full + 8 * s, STAGE);
      tma_load(st, map_q, k * KC, q0, full + 8 * s);
      tma_load(st + Q_PART, map_c, k * KC, row0, full + 8 * s);
      advance();
    }
  } else {
    // thread p loads codes 16 (p & 3) .. + 15 of rows p / 4 and p / 4 + 64
    // of a chunk, AHEAD items ahead, and widens them into the chunk's
    // 16-byte groups 2 (p & 3) and + 1 of each row, swizzled (K2's feed)
    constexpr int FEED = 32 * feed_warps(MODE);
    constexpr int AHEAD = 3;
    constexpr int PIECES = TILE * 4 / FEED;  // 16-byte pieces a thread
    const int rr = p >> 2, cq = p & 3;
    int f_n = 0;
    auto fetch = [&](uint4 (&dst)[PIECES]) {
      if (f_n < total) {
        int row0, q0, k;
        w.at(f_n, row0, q0, k);
        const long long r0 = (long long)row0 + rr;
        const int col = k * KC + 16 * cq;
#pragma unroll
        for (int j = 0; j < PIECES; ++j)
          dst[j] = __ldg(reinterpret_cast<const uint4*>(
              c8 + (r0 + (FEED / 4) * j) * D + col));
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
          int row0, q0, k;
          w.at(n, row0, q0, k);
          // at a row tile's first chunk, the next row tile's rows (one
          // contiguous span of the store) into L2
          if (k == 0 && p == 0 && n + w.NC < total) {
            int nrow0, nq0, nk;
            w.at(n + w.NC, nrow0, nq0, nk);
            prefetch_l2(c8 + (long long)nrow0 * D, (uint32_t)(TILE * D));
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
          fence_async_smem();  // the widened chunk is wgmma's to read
          // one arrival a warp; thread 0's carries the queries' TMA bytes
          __syncwarp();
          if (p == 0) {
            mbar_expect_tx(full + 8 * s, Q_PART);
            tma_load(ring + s * STAGE, map_q, k * KC, q0, full + 8 * s);
          } else if ((p & 31) == 0) {
            mbar_arrive(full + 8 * s);
          }
          advance();
          fetch(raw[jj]);
        }
      }
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(threads_for(MODE), 1)
int8_dot_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_c,
                     const int8_t* __restrict__ c8, float* __restrict__ out,
                     int B, int N, int D, int T) {
  using Acc = typename std::conditional<MODE == NATIVE, int, float>::type;
  constexpr int KC = kc_for(MODE);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_base = smem_u32(smem_raw);
  const uint32_t ring = (raw_base + 1023u) & ~1023u;  // swizzle atoms: 1 KB
  // full(s) at ring + STAGES * STAGE + 8 s, empty(s) 64 bytes on
  const uint32_t full = ring + STAGES * STAGE, empty = full + 64;

  const Walk w{B / QB, T / TILE, (D + KC - 1) / KC, T};
  const int n_items = (N / T) * w.nqb;
  const int bid = blockIdx.x, nblocks = gridDim.x;  // nblocks <= n_items
  const int my_items = (n_items - 1 - bid) / nblocks + 1;
  const int total = my_items * w.RT * w.NC;
  const int tid = threadIdx.x, wg = tid >> 7;

  if (tid == 0) {
    for (int i = 0; i < MAX_STAGES; ++i) {
      mbar_init(full + 8 * i, feed_warps(MODE));  // producer warps
      mbar_init(empty + 8 * i, 8);                // consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg >= 2) {
    const int p = tid - 256;
    if (MODE == CAST || p == 0)
      produce<MODE>(&map_q, &map_c, c8, w, D, total, p, ring, full, empty);
    return;
  }

  // consumer warpgroup wg: queries q0 + 64 wg .. + 63 of every item
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2,
            t = lane & 3;
  Acc acc[64];
  int s = 0;
  uint32_t ph = 0;
  for (int i = 0; i < my_items; ++i) {
    const int item = bid + i * nblocks;
    // the maxima of the thread's query rows 16 warp + g (m[0]) and + 8
    Acc m[2];
    if constexpr (MODE == NATIVE) {
      m[0] = m[1] = INT_MIN;
    } else {
      m[0] = m[1] = -INFINITY;
    }
    for (int r = 0; r < w.RT; ++r) {
      int prev = -1;
      for (int k = 0; k < w.NC; ++k) {
        mbar_wait<false>(full + 8 * s, ph);
        const uint32_t st = ring + s * STAGE;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // 32 bytes of depth a product
          mma_n128(acc, sdesc(st + wg * BOX + kk * 32),
                   sdesc(st + Q_PART + kk * 32), (k | kk) != 0);
        wg_commit();
        if (prev >= 0) {  // the chunk before is done: its stage is free
          wg_wait<1>();
          mbar_arrive_warp(empty + 8 * prev);
        }
        prev = s;
        if (++s == STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
      wg_wait<0>();
      fence_regs(acc);
      mbar_arrive_warp(empty + 8 * prev);
      // element 4j + 2x + e is query row 16 warp + g + 8x, column 8j + 2t
      // + e of the row tile
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int x = 0; x < 2; ++x)
          m[x] = max2(m[x], max2(acc[4 * j + 2 * x], acc[4 * j + 2 * x + 1]));
    }
    const int tile = item / w.nqb;
    const int q = (item % w.nqb) * QB + 64 * wg + 16 * warp + g;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      Acc v = m[x];
      v = max2(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = max2(v, __shfl_xor_sync(0xffffffffu, v, 2));
      if (t == x) out[(long long)tile * B + q + 8 * x] = (float)v;
    }
  }
}

// ------------------------------------------------------------------- host

template <int MODE>
int run(const void* q, const void* c, float* out, int B, int N, int D, int T,
        cudaStream_t stream) {
  static bool smem_set[MAX_DEVICES] = {};
  static int sms[MAX_DEVICES] = {};
  auto kern = int8_dot_sm90_kernel<MODE>;
  cudaError_t e = allow_dynamic_smem(kern, SMEM_LIMIT, smem_set);
  if (e != cudaSuccess) return (int)e;
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (sms[dev] == 0) {
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return (int)e;
  }
  constexpr int KC = kc_for(MODE);
  constexpr int ELEM = MODE == NATIVE ? 1 : 2;
  const CUtensorMapDataType type = MODE == NATIVE
                                       ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap map_q = {}, map_c = {};
  int err = make_map(&map_q, type, q, D, B, (long long)ELEM * D, KC, QB);
  if (!err && MODE != CAST)
    err = make_map(&map_c, type, c, D, N, (long long)ELEM * D, KC, TILE);
  if (err) return err;
  const int n_items = (N / T) * (B / QB);
  const int grid = n_items < sms[dev] ? n_items : sms[dev];
  kern<<<grid, threads_for(MODE), FIXED + STAGES * STAGE, stream>>>(
      map_q, map_c, static_cast<const int8_t*>(c), out, B, N, D, T);
  return (int)cudaGetLastError();
}

}  // namespace cldrd_k7_90

// C entry point for ctypes. Returns a cudaError_t (0 on success).
// q [B, D] bf16 or int8, c [N, D] bf16 or int8 (bf16 x bf16, bf16 x int8
// or int8 x int8), out [N / tile_rows, B] f32; every pointer 16-byte
// aligned. B % 128 == 0; D % 64 == 0, 128 <= D <= 768; tile_rows a
// multiple of 128 dividing N; N < 2^31.
extern "C" int int8_dot_sm90_launch(const void* q, int q_dtype,
                                    const void* c, int c_dtype, float* out,
                                    int B, long long N, int D, int tile_rows,
                                    void* stream) {
  using namespace cldrd_k7_90;
  if (B <= 0 || B % QB != 0 || N <= 0 || N >= (1ll << 31) || D % 64 != 0 ||
      D < MIN_D || D > MAX_D || tile_rows <= 0 || tile_rows % TILE != 0 ||
      N % tile_rows != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int n = (int)N;
  if (q_dtype == cldrd::DT_BF16 && c_dtype == cldrd::DT_BF16)
    return run<BF16>(q, c, out, B, n, D, tile_rows, s);
  if (q_dtype == cldrd::DT_BF16 && c_dtype == cldrd::DT_I8)
    return run<CAST>(q, c, out, B, n, D, tile_rows, s);
  if (q_dtype == cldrd::DT_I8 && c_dtype == cldrd::DT_I8)
    return run<NATIVE>(q, c, out, B, n, D, tile_rows, s);
  return (int)cudaErrorInvalidValue;
}
