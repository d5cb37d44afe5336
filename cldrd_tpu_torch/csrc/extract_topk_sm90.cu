// K1 for Hopper (sm_90a): fused scores + two-level in-block top-m
// extraction, the route of every bf16-query launch against a bf16 or int8
// store with 128-row bins, D a multiple of 128 up to 768 and a batch that
// is a multiple of 64 (ops/extract_topk.py::kernel_route): the search
// phase, the pipeline's retrieve and the flat serving daemon. Other bin
// sizes, fp32 operands and other widths keep extract_topk.cu.
//
// Replaces the TPU kernel cldrd_tpu/search/mips.py::_extract_kernel_factory
// (:605, launched by _binmax_segment_extract at :814). The function is
// extract_topk.cu's at bin 128 (the same bits wherever every sum is exact,
// as on integer-valued inputs; elsewhere fp32 sums in another order, as
// any two kernels' products differ): for each 2048-row
// super-block and query, every 128-row bin gives its top-(R-1) (value,
// row) by rounds of max, lowest-row argmax and mask, the R-th round's max
// is the bin's remainder bound (max-reduced over the super-block into
// rem1), and level 2 takes the super-block's 16 * (R-1) candidates'
// top-R2 by rounds of max, lowest-position argmax and mask of every copy
// of that position; exhausted rounds re-emit the lowest position with
// -inf. Scores are bf16 (or int8 widened exactly to bf16) dots with fp32
// accumulation, times the row's scale in fp32 after the dot; rows with
// id < 0 score -inf. Outputs are B-major: out_v/out_p [B, nsup, R2],
// out_rem [B, nsup].
//
// Bound on an H100 SXM at B=512, N=8,847,360, D=768, int8 + scales:
// 2*B*N*D = 6.96 TFLOP on the tensor cores (7.0 ms at 989 TFLOP/s)
// against 6.8 GB (2.0 ms at 3.35 TB/s): operations bind. Beside the
// products, every score (4.5G) passes R rounds of selection, and every
// int8 code widens to bf16 once per 64-query block.
//
// Design, against extract_topk.cu's five costs:
// - Products are wgmma m64n64k16 (bf16 in, fp32 accumulate) with the
//   store's rows as the A operand, from registers, and the block's 64
//   queries as B, from 128-byte-swizzled shared memory. A thread loads the
//   16 contiguous codes (or 16 bf16 values) of a 64-deep chunk that its A
//   fragments need and widens int8 to bf16 in registers, once per element
//   and block: no widened tile is stored, fenced or waited for at a
//   barrier. This works because the fragments' depth positions are
//   permuted within each chunk, and the resident queries carry the same
//   permutation: a dot product does not depend on the order of its terms.
//   (On integer-valued inputs every order gives the same bits.)
// - The block's 64 queries (96 KB at D=768) stay resident in shared
//   memory for the whole super-block: they are read once per block, not
//   once per 128-row tile, with every 4-byte copy in flight at once.
// - Level 2 gives each query a group of 8 lanes, so a warp runs four
//   queries' rounds side by side rather than one after another.
// - Warp roles. Two wgmma warpgroups take alternate bins of the
//   super-block; each streams its bin (two 64-row accumulators) through
//   64-deep chunks, with the loads of the chunks two steps ahead (one
//   for bf16 rows) in flight in registers and two sets of A fragments,
//   so a chunk's loads, widening and wgmma overlap the previous chunk's
//   products. A third
//   warpgroup selects: each bin's fp32 scores (times the row scale, -inf
//   for id < 0) go once to a query-major tile of its wgmma warpgroup,
//   handed over by named barriers, and the selection reads a query's 128
//   rows with a lane quad, 32 values a thread, while the wgmma
//   warpgroups go on to their next bins. A round of level 1 takes a
//   thread's best of 32 as a tree of depth 5 for both of its queries side
//   by side, then the quad's best by two shuffles. setmaxnreg gives the
//   wgmma warpgroups the registers the selection does not need.
// - int8 codes widen with four byte permutes and two bf16x2 subtractions
//   per four codes: (128 + low 7 bits) - (128 or 256 by the sign bit),
//   exact, with no integer-to-float conversion.
// - Adjacent blocks share a super-block, so the B/64 reads of a
//   super-block fall close together in time and hit in L2: with the
//   block order turned around, so that every re-read misses, the kernel
//   took 31.27 ms against 23.91 at B=512 over the 8.8M int8 store
//   (tools/k1_variants.py, H100 80GB HBM3 at 700 W).
// - Not taken, measured with tools/k1_parts.cu (the score loop alone):
//   128 queries a block (m64n128k16, the store read by B/128 blocks)
//   took 24.73 ms against 25.70 for 64, and resident, their 192 KB leave
//   no room for the score tiles and candidates; a producer warp feeding a
//   4-stage ring by TMA took 26.16 ms (by 16-byte cp.async 31.84) against
//   the wgmma warps' own loads. PERF.md has the runs.
// Shared memory: queries (D/64 tiles of 8 KB), 2 wgmma warpgroups x a
// 64 x 128 fp32 score tile, the level-1 candidates (64 queries x 16 x
// (R-1) pairs), the remainder bounds: 213 KB at D=768 and R=7, one block
// an SM.
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "score_tile.cuh"   // DType, allow_dynamic_smem, MAX_DEVICES
#include "topk_select.cuh"  // better, group_best, level2

namespace cldrd_k1_90 {

using bf16 = __nv_bfloat16;
using cldrd::allow_dynamic_smem;
using cldrd::better;
using cldrd::MAX_DEVICES;

constexpr int SUP_ROWS = 2048;
constexpr int BIN = 128;                  // rows of a bin and of a tile
constexpr int BINS = SUP_ROWS / BIN;      // 16
constexpr int QB = 64;                    // queries per block
constexpr int KC = 64;                    // depth of a chunk (128 bytes)
constexpr int MAX_D = 768;                // resident queries: 96 KB
constexpr int THREADS = 384;              // 2 wgmma + 1 selection warpgroup
constexpr int NWG = 2;
constexpr int Q_TILE = QB * 128;          // one chunk of the queries
constexpr int S_LD = 136;                 // fp32 stride of a query's scores
constexpr int S_TILE = QB * S_LD * 4;     // a warpgroup's bin of scores
constexpr int MAX_M = 6;                  // level-1 candidates per bin
constexpr int MAX_R2 = 16;

// ------------------------------------------------------------ primitives

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16-byte chunk `chunk` of row `row` in a tile of 128-byte rows under the
// 128-byte swizzle (wgmma's B128 layout)
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// K-major operand under the 128-byte swizzle: stride byte offset 1024
// (one 8-row atom), layout B128
__device__ __forceinline__ uint64_t sdesc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pins registers that an in-flight wgmma writes or reads, so the compiler
// neither reads an accumulator before the wait nor reuses an A fragment's
// registers while a product may still read them
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define K1_ACC16(d, o)                                                     \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),           \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7]),       \
      "+f"(d[o + 8]), "+f"(d[o + 9]), "+f"(d[o + 10]), "+f"(d[o + 11]),     \
      "+f"(d[o + 12]), "+f"(d[o + 13]), "+f"(d[o + 14]), "+f"(d[o + 15])

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], A from registers (the m64k16
// fragment: a0 rows g, columns 2t, 2t + 1; a1 rows g + 8; a2, a3 the same
// at columns 2t + 8, 2t + 9; g = lane / 4 within the warp's 16 rows,
// t = lane % 4), B K-major in shared memory. Accumulator layout (warp w of
// the warpgroup, lane): element i is row 16w + g + 8*((i >> 1) & 1),
// column 8*(i >> 2) + 2t + (i & 1).
__device__ __forceinline__ void mma_rs_n64(float (&d)[32], const uint32_t* a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : K1_ACC16(d, 0), K1_ACC16(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate)
      : "memory");
}

// four int8 codes (one 32-bit word, code j in byte j) as two bf16x2
// (codes 0-1, 2-3): bf16 0x43hh is 128 + (hh & 0x7f) when hh's top bit
// is clear and 256 when hh is 0x80, so (0x43 | low 7 bits) - (0x43 | sign
// bit) is the code, exactly (|code| <= 128 has 8 significant bits)
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo,
                                       uint32_t& hi) {
  const uint32_t mag = w & 0x7F7F7F7Fu, sgn = w & 0x80808080u;
  const uint32_t a0 = __byte_perm(mag, 0x43434343u, 0x4140);
  const uint32_t a1 = __byte_perm(mag, 0x43434343u, 0x4342);
  const uint32_t b0 = __byte_perm(sgn, 0x43434343u, 0x4140);
  const uint32_t b1 = __byte_perm(sgn, 0x43434343u, 0x4342);
  __nv_bfloat162 r0 = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a0),
                              *reinterpret_cast<const __nv_bfloat162*>(&b0));
  __nv_bfloat162 r1 = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a1),
                              *reinterpret_cast<const __nv_bfloat162*>(&b1));
  lo = *reinterpret_cast<uint32_t*>(&r0);
  hi = *reinterpret_cast<uint32_t*>(&r1);
}

// A copy the compiler cannot fold away. wgmma reads its A fragment from
// registers until the wait that retires it, and no instruction may write
// those registers before then. Folded into a plain copy, the fragment is
// the loads' own registers, which the loop rewrites a chunk later while
// the product may still read them: ptxas then put other values there
// before the wait (72 such writes in the SASS; wrong scores that varied
// from run to run). As an asm move, the fragment has registers of its
// own, written again only after that wait. ops/_wgmma_check.py checks
// the SASS of every build for such writes (none with this copy).
__device__ __forceinline__ uint32_t copy_reg(uint32_t x) {
  uint32_t y;
  asm volatile("mov.b32 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// The depth permutation within a 64-deep chunk: a thread (t = lane % 4)
// loads the chunk's 16 contiguous elements 16t .. 16t + 15 of a row, and
// element 16t + 4s + j feeds k-step s of its A fragments at column
// 2t + (j & 1) + 8 (j >> 1). The queries in shared memory hold, at
// logical column l of the chunk, the element at that physical position.
__device__ __forceinline__ int chunk_position(int l) {
  const int s = l >> 4, r = l & 15;
  return 16 * ((r & 7) >> 1) + 4 * s + (r & 1) + 2 * (r >> 3);
}

// How a thread loads and widens its rows of a chunk: rows g and g + 8 of
// its warp's 16 in each of the bin's two 64-row halves, RAW 16-byte
// pieces for the four; to_a gives the A fragments of the four k-steps of
// both halves, a[(half * 4 + s) * 4 + reg].
template <typename CT>
struct Chunk;
template <>
struct Chunk<int8_t> {  // one piece a row: codes 16t .. 16t + 15
  static constexpr int RAW = 4;
  static constexpr int DEPTH = 2;  // chunks of loads in flight
  __device__ static void load(const int8_t* c, long long row0, int D, int k0,
                              int t, uint4 (&raw)[RAW]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)  // i = half * 2 + x: row 64 half + 8 x
      raw[i] = __ldg(reinterpret_cast<const uint4*>(
          c + (row0 + 64 * (i >> 1) + 8 * (i & 1)) * D + k0 + 16 * t));
  }
  __device__ static void to_a(const uint4 (&raw)[RAW], uint32_t (&a)[32]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t w[4] = {raw[i].x, raw[i].y, raw[i].z, raw[i].w};
#pragma unroll
      for (int s = 0; s < 4; ++s)  // word s: columns 2t.., 2t + 8..
        widen4(w[s], a[((i >> 1) * 4 + s) * 4 + (i & 1)],
               a[((i >> 1) * 4 + s) * 4 + 2 + (i & 1)]);
    }
  }
};
template <>
struct Chunk<bf16> {  // two pieces a row: values 16t .. 16t + 15
  static constexpr int RAW = 8;
  static constexpr int DEPTH = 1;  // with two, the wgmma warps spill
  __device__ static void load(const bf16* c, long long row0, int D, int k0,
                              int t, uint4 (&raw)[RAW]) {
#pragma unroll
    for (int i = 0; i < 8; ++i)  // i = (half * 2 + x) * 2 + piece
      raw[i] = __ldg(reinterpret_cast<const uint4*>(
          c + (row0 + 64 * (i >> 2) + 8 * ((i >> 1) & 1)) * D + k0 + 16 * t +
          8 * (i & 1)));
  }
  __device__ static void to_a(const uint4 (&raw)[RAW], uint32_t (&a)[32]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t w[8] = {raw[2 * i].x,     raw[2 * i].y,
                             raw[2 * i].z,     raw[2 * i].w,
                             raw[2 * i + 1].x, raw[2 * i + 1].y,
                             raw[2 * i + 1].z, raw[2 * i + 1].w};
#pragma unroll
      for (int s = 0; s < 4; ++s) {  // words 2s, 2s + 1: values 4s .. 4s + 3
        a[((i >> 1) * 4 + s) * 4 + (i & 1)] = copy_reg(w[2 * s]);
        a[((i >> 1) * 4 + s) * 4 + 2 + (i & 1)] = copy_reg(w[2 * s + 1]);
      }
    }
  }
};

// one level of the tree below: entries 2i and 2i + 1 into entry i
template <int W>
__device__ __forceinline__ void pair_level(float (&a)[16], int (&ia)[16]) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const bool l = a[2 * i] >= a[2 * i + 1];
    a[i] = l ? a[2 * i] : a[2 * i + 1];
    ia[i] = l ? ia[2 * i] : ia[2 * i + 1];
  }
}

// the best of 32 values (larger value, ties to the lower index) as a
// tree of depth 5: the left side of every pair holds the lower indices
__device__ __forceinline__ void best32(const float (&v)[32], float& bv,
                                       int& bu) {
  float a[16];
  int ia[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const bool l = v[2 * i] >= v[2 * i + 1];
    a[i] = l ? v[2 * i] : v[2 * i + 1];
    ia[i] = l ? 2 * i : 2 * i + 1;
  }
  pair_level<8>(a, ia);
  pair_level<4>(a, ia);
  pair_level<2>(a, ia);
  pair_level<1>(a, ia);
  bv = a[0];
  bu = ia[0];
}

// ----------------------------------------------------------------- kernel

// Warp roles: warpgroups 0 and 1 stream bins through wgmma (bin 2 it + w)
// and write each bin's scores to their own tile; warpgroup 2 selects from
// the two tiles in turn. Named barriers hand a tile over: FULL(w) when
// its scores are written, FREE(w) when the selection has read them. The
// register file is split 192 / 192 / 120 (setmaxnreg; 504 of the 512 a
// thread slot may take, leaving the allocator slack).
constexpr int MMA_REGS = 192, SEL_REGS = 120;
constexpr int BAR_FREE = 1, BAR_FULL = 3;  // + w; 0 is __syncthreads
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

template <typename CT>
__global__ void __launch_bounds__(THREADS, 1)
extract_topk_sm90_kernel(const bf16* __restrict__ q, const CT* __restrict__ c,
                         const int* __restrict__ ids,
                         const float* __restrict__ scales,
                         float* __restrict__ out_v, int* __restrict__ out_p,
                         float* __restrict__ out_rem, int B, int nsup, int D,
                         int m, int rounds2) {
  using CH = Chunk<CT>;
  constexpr int RAW = CH::RAW;
  constexpr int DEPTH = CH::DEPTH;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_base = smem_u32(smem_raw);
  const uint32_t base = (raw_base + 1023u) & ~1023u;  // swizzle atoms: 1 KB
  unsigned char* sm = smem_raw + (base - raw_base);
  const int NC = D / KC;  // chunks of the depth
  const uint32_t sQ = base;
  const int CL = BINS * m;  // candidates a query
  float* s_tile = reinterpret_cast<float*>(sm + NC * Q_TILE);
  float* cand_v = s_tile + NWG * QB * S_LD;
  int* cand_p = reinterpret_cast<int*>(cand_v + QB * CL);
  float* s_rem = reinterpret_cast<float*>(cand_p + QB * CL);

  const int nqc = B / QB;
  const int qc = blockIdx.x % nqc;
  const long long sup = blockIdx.x / nqc;  // adjacent blocks share rows
  const int q0 = qc * QB;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2,
            t = lane & 3;

  // the block's queries, resident, in the chunks' permuted depth order:
  // logical column l of chunk k of query r holds element 64k +
  // chunk_position(l), at sQ + k * Q_TILE, 16-byte group l / 8 swizzled;
  // one 4-byte copy per column pair, all in flight at once
  for (int i = tid; i < QB * NC * 32; i += THREADS) {
    const int r = i / (NC * 32), k = (i / 32) % NC, l = 2 * (i % 32);
    cp_async4(sQ + k * Q_TILE + swz(r, l >> 3) + 2 * (l & 7),
              q + (long long)(q0 + r) * D + k * KC + chunk_position(l));
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  fence_async_smem();
  __syncthreads();

  if (wg < NWG) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(MMA_REGS));
    float* S = s_tile + wg * QB * S_LD;  // this warpgroup's [query][row]
    // the stream of (bin, chunk) steps: bin 2 * it + wg, chunk k; the
    // loads of the step DEPTH ahead are in flight in registers
    int f_it = 0, f_k = 0;  // the next step to fetch
    auto fetch = [&](uint4 (&dst)[RAW]) {
      if (f_it < BINS / NWG)
        CH::load(c, sup * SUP_ROWS + (2 * f_it + wg) * BIN + 16 * warp + g,
                 D, f_k * KC, t, dst);
      if (++f_k == NC) {
        f_k = 0;
        ++f_it;
      }
    };
    uint4 raw[DEPTH][RAW];
#pragma unroll
    for (int j = 0; j < DEPTH; ++j) fetch(raw[j]);

    float acc[2][32];   // the bin's two 64-row halves x 64 queries
    uint32_t a[2][32];  // A fragments of two chunks in flight
    for (int it = 0; it < BINS / NWG; ++it) {
      const long long r0 = sup * SUP_ROWS + (long long)(2 * it + wg) * BIN;
      // the thread's four rows of the bin: 64 half + 16 warp + g + 8 x
      float sc[4];
      bool ok[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long r = r0 + 64 * (i >> 1) + 16 * warp + g + 8 * (i & 1);
        ok[i] = __ldg(ids + r) >= 0;
        sc[i] = scales != nullptr ? __ldg(scales + r) : 1.f;
      }
      // chunk k: widen its loads into A fragment set k & 1, put the loads
      // of the step DEPTH ahead in flight, then its eight wgmma; the chunk
      // before is done after them (its fragment set is free)
      for (int k0 = 0; k0 < NC; k0 += 2) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int k = k0 + j;
          CH::to_a(raw[j % DEPTH], a[j & 1]);
          fetch(raw[j % DEPTH]);
          wg_fence();
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int st = 0; st < KC / 16; ++st)
              mma_rs_n64(acc[h], &a[j & 1][(h * 4 + st) * 4],
                         sdesc(sQ + k * Q_TILE + st * 32), (k | st) != 0);
          wg_commit();
          wg_wait<1>();
          fence_regs(a[(j + 1) & 1]);  // the chunk before is done with them
        }
      }
      wg_wait<0>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      fence_regs(a[0]);
      fence_regs(a[1]);

      // the bin's scores, query-major: S[query][row]
      bar_sync(BAR_FREE + wg);  // the selection has read the last bin
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int x = (i >> 1) & 1;
          const int row = 64 * h + 16 * warp + g + 8 * x;
          const int qn = 8 * (i >> 2) + 2 * t + (i & 1);
          S[qn * S_LD + row] =
              ok[2 * h + x] ? acc[h][i] * sc[2 * h + x] : -INFINITY;
        }
      __threadfence_block();  // the scores are visible before the hand-over
      bar_arrive(BAR_FULL + wg);
    }
  } else {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(SEL_REGS));
    // level 1, bin by bin, for the thread's two queries (rows g and g + 8
    // of the warp's 16) side by side: u = 2 j + e is row 8 j + 2 t + e
    float rem[2] = {-INFINITY, -INFINITY};
    bar_arrive(BAR_FREE);  // both tiles start free
    bar_arrive(BAR_FREE + 1);
    for (int bin = 0; bin < BINS; ++bin) {
      const int w = bin & 1;
      const float* S = s_tile + w * QB * S_LD;
      bar_sync(BAR_FULL + w);
      float v[2][32];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const float* src = S + (warp * 16 + g + 8 * x) * S_LD + 2 * t;
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
          const float2 p2 = *reinterpret_cast<const float2*>(src + 8 * jj);
          v[x][2 * jj] = p2.x;
          v[x][2 * jj + 1] = p2.y;
        }
      }
      const int r0 = (int)(sup * SUP_ROWS) + bin * BIN;
      for (int rr = 0; rr <= m; ++rr) {
        float bv[2];
        int bu[2], own[2], row[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          best32(v[x], bv[x], bu[x]);
          own[x] = row[x] = 8 * (bu[x] >> 1) + 2 * t + (bu[x] & 1);
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const float ov = __shfl_xor_sync(0xffffffffu, bv[x], off);
            const int orow = __shfl_xor_sync(0xffffffffu, row[x], off);
            if (better(ov, orow, bv[x], row[x])) {
              bv[x] = ov;
              row[x] = orow;
            }
          }
        if (rr == m) {  // the R-th max bounds everything left in the bin
#pragma unroll
          for (int x = 0; x < 2; ++x) rem[x] = fmaxf(rem[x], bv[x]);
          break;
        }
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int ql = warp * 16 + g + 8 * x;
          if (t == 0) {
            cand_v[ql * CL + bin * m + rr] = bv[x];
            cand_p[ql * CL + bin * m + rr] = r0 + row[x];  // segment row
          }
          // the quad's pick is this thread's own best: take it out
          const bool mine = own[x] == row[x];
#pragma unroll
          for (int u = 0; u < 32; ++u)
            v[x][u] = mine && u == bu[x] ? -INFINITY : v[x][u];
        }
      }
      // the tile is free once its values are used, so its reads are done
      // (an arrive right after the loads let the next bin's writes
      // overtake them); the last two tiles are never refilled
      if (bin < BINS - NWG) bar_arrive(BAR_FREE + w);
    }
    if (t == 0) {
#pragma unroll
      for (int x = 0; x < 2; ++x) s_rem[warp * 16 + g + 8 * x] = rem[x];
    }
  }
  __syncthreads();

  // level 2 over each query's 16 * m candidates: a query per group of 8
  // lanes (12 candidates a lane), four queries of a warp side by side
  const int gi = lane >> 3, gl = lane & 7;
  for (int ql = (tid >> 5) * 4 + gi; ql < QB; ql += THREADS / 8) {
    const long long row = (long long)(q0 + ql) * nsup + sup;
    cldrd::level2<8, BINS * MAX_M / 8>(
        cand_v + ql * CL, cand_p + ql * CL, CL, rounds2, gl,
        [&](int r, float v, int p) {
          if (gl == 0) {
            out_v[row * rounds2 + r] = v;
            out_p[row * rounds2 + r] = p;
          }
        });
    if (gl == 0) out_rem[row] = s_rem[ql];
  }
}

int smem_bytes(int D, int m) {
  return 1024 + (D / KC) * Q_TILE + NWG * S_TILE + QB * BINS * m * 8 +
         QB * 4;
}

template <typename CT>
int run(const void* q, const void* c, const int* ids, const float* scales,
        float* out_v, int* out_p, float* out_rem, int B, int nsup, int D,
        int m, int rounds2, cudaStream_t stream) {
  static bool smem_set[MAX_DEVICES] = {};
  auto kern = extract_topk_sm90_kernel<CT>;
  // the attribute is set once, to the largest shape a launch may take
  const cudaError_t e =
      allow_dynamic_smem(kern, smem_bytes(MAX_D, MAX_M), smem_set);
  if (e != cudaSuccess) return (int)e;
  const long long nblocks = (long long)nsup * (B / QB);
  kern<<<(unsigned)nblocks, THREADS, smem_bytes(D, m), stream>>>(
      static_cast<const bf16*>(q), static_cast<const CT*>(c), ids, scales,
      out_v, out_p, out_rem, B, nsup, D, m, rounds2);
  return (int)cudaGetLastError();
}

}  // namespace cldrd_k1_90

// C entry point for ctypes. Returns a cudaError_t (0 on success).
// q [B, D] bf16, c [nsup*2048, D] bf16 or int8, ids [N] i32, scales [N]
// f32 or NULL; bins of 128 rows; B % 64 == 0, D % 128 == 0, D <= 768;
// outputs as documented above.
extern "C" int extract_topk_sm90_launch(const void* q, int q_dtype,
                                        const void* c, int c_dtype,
                                        const int* ids, const float* scales,
                                        float* out_v, int* out_p,
                                        float* out_rem, int B, int nsup,
                                        int D, int rounds, int rounds2,
                                        void* stream) {
  using namespace cldrd_k1_90;
  if (q_dtype != cldrd::DT_BF16 || B <= 0 || B % QB != 0 || nsup <= 0 ||
      D <= 0 || D % (2 * KC) != 0 || D > MAX_D || rounds < 2 ||
      rounds - 1 > MAX_M || rounds2 < 1 || rounds2 > MAX_R2)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (c_dtype == cldrd::DT_I8)
    return run<int8_t>(q, c, ids, scales, out_v, out_p, out_rem, B, nsup, D,
                       rounds - 1, rounds2, s);
  if (c_dtype == cldrd::DT_BF16)
    return run<__nv_bfloat16>(q, c, ids, scales, out_v, out_p, out_rem, B,
                              nsup, D, rounds - 1, rounds2, s);
  return (int)cudaErrorInvalidValue;
}
