// K5 (inference attention) at head_dim 64 and 64 < L <= 256 on Hopper
// (sm_90a): the route of every bf16 launch with head_dim 64 and
// 64 < L <= 256 (ops/attention.py::_kernel_route), which is the passage
// tower's attention in every index build (flat at L=256, 32-86 real
// tokens of 256; bucketed at 128 and 256), the curriculum's evaluation
// hook and the serve path's passage encodes. L <= 64 keeps
// attention_infer.cu, head_dim 32 attention_infer_d32.cu, fp32 and rows
// past 256 attention.cu.
//
// Replaces the TPU kernel cldrd_tpu/ops/attention.py::_attention_kernel
// (:61). Per (batch row b, head h), in the reference's order:
//   s = (q * bf16(1/8)) . k^T in fp32; keys with mask == 0 score -1e9;
//   probs = exp(s - max) / sum in fp32, rounded to bf16;
//   out = bf16(probs . v) with fp32 accumulation.
// bf16(1/8) = 2^-3 is a power of two, so (q * 2^-3) . k = 2^-3 (q . k)
// exactly, and s - max = 2^-3 (s' - max') for the unscaled products s':
// the kernel keeps the unscaled products (a masked key at -1e9 / 2^-3)
// and folds the scale into the exponential's argument.
//
// Bound on an H100 SXM: Q and O at every row plus K and V at the real
// keys only (a padded key's weight is exactly 0). At the flat index
// build's 512 x 256 with passages of 32-86 real tokens that is ~0.15 ms
// of bytes against ~0.02 ms of bf16 products; at a bucket's 512 x 256
// (129-256 real keys a row) ~0.20 ms against ~0.07. Bytes bind on paper.
// In the kernel the fp32 softmax binds as much: per score one ex2 on the
// SM's 16-a-clock special function units and about eight more
// instructions, as many issue slots as the score's two bf16 products take
// tensor-core cycles.
//
// attention_sm90.cu's forward, which this replaces on that route, was
// designed for training at L=256: every launch computes four 64-key
// tiles, so a 128-token bucket paid for 256 keys and every padded key
// tile was loaded and multiplied.
//
// Design:
// - Padded key tiles are skipped (attention_infer_d32.cu's scheme). A
//   block owns one (b, h) (grid H x B, one warpgroup). Every warp reads
//   the row's mask (all loads issued before use) and ballots it into
//   tiles of 16 keys; a tile with no real key is neither loaded nor
//   multiplied. That is exact whenever the row has a real key:
//   exp(-1e9 - max) is exactly 0 in fp32, so such a key adds exactly 0
//   to the sum and to P.V, and its probability rounds to bf16 0. A row
//   with no real key keeps every tile: there every score is -1e9 and the
//   reference gives 1/L over its L keys. The kept tiles are packed into
//   consecutive 16-key slots of shared memory, in pairs: an odd count
//   gets a pad slot of zeros whose keys score -inf. Inside a kept slot
//   keys are masked one by one (the mask need not be a prefix; the test
//   is != 0): each slot's 16 fills (0 for a real key, -1e9 / 2^-3 for a
//   masked one, -inf past L or in the pad slot: no weight, not even in
//   an all-masked row) sit in shared memory, and a score whose fill is
//   not 0 is replaced by it. A slot whose 16 keys are all real and
//   inside L skips that step (a warp-uniform branch).
// - Work follows the kept keys: the block picks, by its count of slot
//   pairs, an instantiation whose products span exactly those keys
//   (wgmma's N is fixed at compile time: m64n64 per four slots, m64n32
//   for a last pair), so the tensor-core pipeline has no branch. The
//   kernel is built for 8 kept tiles (L <= 128) and for 16 (L <= 256),
//   chosen by L on the host; the first needs half the registers and
//   holds twice the blocks an SM.
// - Q of the row, and K and V of the kept slots, are read from device
//   memory once per (b, h): 16-byte cp.async into 128-byte-swizzled rows
//   of shared memory (rows past L and the pad slot as zeros), Q and K in
//   one group and V in a second, in flight during the first chunk's
//   Q.K^T. The warpgroup walks the row's queries in chunks of 64: S =
//   Q.K^T by wgmma (bf16, fp32 accumulate) with both operands in shared
//   memory, so the tensor cores read each K row once per 64 queries. The
//   chunk's whole score row stays in registers (up to 128 fp32 a
//   thread), so the exact max and sum come in one pass with no online
//   rescale and no recomputed scores, and the probabilities round to
//   bf16 where the reference's do. The exponential is ex2.approx of
//   (s - max) * 2^-3 * log2 e (within a few fp32 ulps of exp; exactly 1
//   at s = max and 0 at a masked key), each probability e times the
//   row's correctly rounded 1 / sum (within 1.5 fp32 ulps of e / sum, and
//   exactly 1 / l where e = 1) before its bf16 rounding: the K5 softmax
//   of attn_common.cuh, which attention_infer.cu (L <= 64) shares, so a
//   passage gives the same bits in every length bucket. The accumulator's
//   layout is wgmma's register-A fragment, so P.V takes the probabilities
//   from registers and V from shared memory (MN-major).
// - O leaves through 16-byte stores: each warp writes its 16 rows into
//   the chunk's Q tile, free by then, and reads back whole 128-byte rows,
//   eight lanes a row.
//
// What binds it (tools/k5_d64_variants.py on an H100 SXM at 700 W):
// 0.1856 ms at B=240, L=256, 0.2438 at the 1024x128 bucket, 0.3888 at the
// 512x256 bucket and 0.2129 at the flat build's 512x256: 51-82% of the
// bytes bound. A block's query chunks take three quarters of its cycles,
// the mask and the copies the rest. The score row's registers hold two
// blocks an SM at L=256, so the softmax's dependent steps and the wgmma
// waits of one warpgroup are hidden only by the other's. The correctly
// rounded e / sum cost 8-11% over e * (1 / sum) at the full rows, expf
// 11-65% over ex2.approx (it also took the registers to 255); an
// mma.sync design (a warp per 16 queries, K and V read from shared
// memory for every 16 queries) took 0.2995 / 0.2806 / 0.5477 / 0.2724.
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attn_common.cuh"  // MASKED, LOG2E, ex2_approx
#include "score_tile.cuh"   // allow_dynamic_smem, MAX_DEVICES

namespace cldrd_attn_d64 {

using bf16 = __nv_bfloat16;
using cldrd::allow_dynamic_smem;
using cldrd::MAX_DEVICES;
using cldrd_attn::ex2_approx;
using cldrd_attn::LOG2E;

constexpr int D = 64;                   // head_dim of this route
constexpr int MAXL = 256;               // longest row of this route
constexpr int KT = 16;                  // keys a slot (a P.V depth step)
constexpr int QC = 64;                  // queries a chunk (wgmma's M)
constexpr int THREADS = 128;            // one warpgroup
constexpr int ROW_B = D * 2;            // bytes of a key or query row
constexpr int SLOT_B = KT * ROW_B;      // 2 KB
constexpr int CHUNK_B = QC * ROW_B;     // 8 KB
constexpr int KSTEP_K = 32;             // 16 dims of a K-major row
constexpr int SHORT_TILES = 8;          // the build for L <= 128
constexpr float SCALE = 0.125f;         // bf16(1/sqrt(64)) = 2^-3
constexpr unsigned FULL = 0xffffffffu;

// slots of K and V for rows of L: the key tiles, rounded up to pairs
__host__ __device__ constexpr int slot_room(int L) {
  return (((L + KT - 1) / KT) + 1) & ~1;
}

// Q's chunks, K and V slots and each slot's 16 score fills, after up to
// 1 KB that aligns the swizzle atoms
__host__ __device__ constexpr int smem_bytes(int L) {
  return 1024 + ((L + QC - 1) / QC) * CHUNK_B +
         slot_room(L) * (2 * SLOT_B + KT * 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `chunk` (0-7) of row `row` in a tile of
// 128-byte rows under the 128-byte swizzle (wgmma's B128): the chunk
// index xor-ed with the row's place in its 8-row atom
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return row * ROW_B + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes (cp.async) made visible to wgmma, which reads
// shared memory through the async proxy
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint4 lds16(uint32_t addr) {
  uint4 r;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "r"(addr));
  return r;
}

__device__ __forceinline__ float4 lds16f(uint32_t addr) {
  float4 r;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w)
               : "r"(addr));
  return r;
}

__device__ __forceinline__ void st_shared_f32(uint32_t addr, float x) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(x) : "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t x) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(x) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------------- wgmma

// shared-memory descriptor of a 128-byte-swizzled operand (start address,
// stride 1024 bytes = one 8-row atom; attention_sm90.cu's sdesc)
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
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// pins registers an in-flight wgmma writes or reads, so the compiler
// neither reads an accumulator before the wait nor reuses an A fragment
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define D16(d)                                                             \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define D32(d)                                                             \
  D16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),              \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),     \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),     \
      "+f"(d[30]), "+f"(d[31])
#define R16                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define R32                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// S[64 x 64] (+)= Q[64 x 16] . K[64 keys x 16]^T, both K-major in shared
// memory
__device__ __forceinline__ void qk64(float* d, uint64_t a, uint64_t b,
                                     int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : D32(d)
      : "l"(a), "l"(b), "r"(accumulate)
      : "memory");
}
// the same for 32 keys
__device__ __forceinline__ void qk32(float* d, uint64_t a, uint64_t b,
                                     int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " R16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : D16(d)
      : "l"(a), "l"(b), "r"(accumulate)
      : "memory");
}
// O[64 x 64] (+)= P[64 x 16 keys] . V[16 keys x 64], P from registers
// (the m64k16 fragment: four bf16 pairs a thread), V MN-major
__device__ __forceinline__ void pv(float* d, const uint32_t* a, uint64_t b,
                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate)
      : "memory");
}

// ------------------------------------------------------------ kernel

// What a block knows once its copies are in flight
struct Row {
  uint32_t sQ, sK, sV, sB;  // shared addresses
  uint32_t full;            // slots needing no fills
  bf16* out;                // row b, head h, token 0
  long long stride;         // elements between tokens
  int L, nchunk;
};

// The row's query chunks with NP kept slot pairs (2 NP slots, 32 NP keys):
// S by m64n64 per four slots and m64n32 for a last pair, the fills, the
// exact softmax, P.V, and O out. The accumulator's element i is row
// 16 warp + lane / 4 + 8 ((i >> 1) & 1) of the chunk, key 8 (i >> 2) +
// 2 (lane % 4) + (i & 1): slot j holds elements 8j .. 8j + 7 of it, keys
// 2t, 2t + 1 (i & 4 clear) and 2t + 8, 2t + 9, which is the order of a
// slot's fills and of P.V's A fragment (a0 = i 0-1, a1 = 2-3, a2 = 4-5,
// a3 = 6-7).
template <int NP>
__device__ __forceinline__ void rows(const Row& r) {
  constexpr int G4 = NP / 2, NS = 2 * NP;  // four-slot groups, slots
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const float c2 = SCALE * LOG2E;
  for (int c = 0; c < r.nchunk; ++c) {
    const uint32_t sQc = r.sQ + c * CHUNK_B;
    float s[16 * NP];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int g4 = 0; g4 < G4; ++g4)
        qk64(&s[32 * g4], sdesc(sQc + kk * KSTEP_K),
             sdesc(r.sK + g4 * 4 * SLOT_B + kk * KSTEP_K), kk > 0);
      if constexpr ((NP & 1) != 0)
        qk32(&s[32 * G4], sdesc(sQc + kk * KSTEP_K),
             sdesc(r.sK + G4 * 4 * SLOT_B + kk * KSTEP_K), kk > 0);
    }
    wg_commit();
    wg_wait0();
    fence_regs<16 * NP>(s);

    // fills where a slot has masked keys, keys past L or pads
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      if ((r.full >> j) & 1u) continue;  // warp-uniform
      const float4 f = lds16f(r.sB + j * 64 + t * 16);
      const float fe[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float fv = fe[((e >> 2) << 1) | (e & 1)];
        s[8 * j + e] = fv == 0.f ? s[8 * j + e] : fv;
      }
    }
    // the exact row max (a row lives in a lane quad), then
    // e = 2^((s - max) * 2^-3 * log2 e) and its sum, a slot's part first:
    // attn_common.cuh's K5 softmax, which attention_infer.cu shares, so a
    // passage gives the same bits in every length bucket
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, rl[2];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int x = 0; x < 2; ++x)
        m[x] = fmaxf(m[x], fmaxf(fmaxf(s[8 * j + 2 * x], s[8 * j + 2 * x + 1]),
                                 fmaxf(s[8 * j + 4 + 2 * x],
                                       s[8 * j + 5 + 2 * x])));
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      m[x] = fmaxf(m[x], __shfl_xor_sync(FULL, m[x], 1));
      m[x] = fmaxf(m[x], __shfl_xor_sync(FULL, m[x], 2));
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        s[8 * j + e] = ex2_approx((s[8 * j + e] - m[(e >> 1) & 1]) * c2);
#pragma unroll
      for (int x = 0; x < 2; ++x)
        l[x] += (s[8 * j + 2 * x] + s[8 * j + 2 * x + 1]) +
                (s[8 * j + 4 + 2 * x] + s[8 * j + 5 + 2 * x]);
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      l[x] += __shfl_xor_sync(FULL, l[x], 1);
      l[x] += __shfl_xor_sync(FULL, l[x], 2);
      rl[x] = __frcp_rn(l[x]);
    }
    // the probs e * (1 / l) rounded to bf16 as P.V's A fragments, slot
    // by slot
    uint32_t pa[8 * NP];
#pragma unroll
    for (int i = 0; i < 8 * NP; ++i) {
      const int x = i & 1;
      pa[i] = pack_bf16(s[2 * i] * rl[x], s[2 * i + 1] * rl[x]);
    }
    if (c == 0) {  // V, in flight so far (block-uniform)
      cp_async_wait<0>();
      fence_async_smem();
      __syncthreads();
    }
    float o[32];
    wg_fence();
#pragma unroll
    for (int j = 0; j < NS; ++j)
      pv(o, &pa[4 * j], sdesc(r.sV + j * SLOT_B), j > 0);
    wg_commit();
    wg_wait0();
    fence_regs<32>(o);
    fence_regs<8 * NP>(pa);

    // out through the warp's 16 rows of the chunk's Q tile, now free:
    // lane (g, t) writes dims 8n + 2t, +1 of rows g and g + 8 at chunk
    // n, then reads back whole rows, eight lanes a row
    const int g = lane >> 2;
    const uint32_t wrow = sQc + warp * 16 * ROW_B;
    __syncwarp();
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        st_shared_u32(wrow + swz(g + 8 * x, n) + t * 4,
                      pack_bf16(o[4 * n + 2 * x], o[4 * n + 2 * x + 1]));
    __syncwarp();
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int row = (lane >> 3) + 4 * y, ch = lane & 7;
      const int tok = c * QC + warp * 16 + row;
      const uint4 val = lds16(wrow + swz(row, ch));
      if (tok < r.L)
        *reinterpret_cast<uint4*>(r.out + tok * r.stride + ch * 8) = val;
    }
  }
}

// rows<np> for the block's np in 1 .. NP
template <int NP>
__device__ __forceinline__ void rows_by_pairs(int np, const Row& r) {
  if constexpr (NP > 1) {
    if (np < NP) {
      rows_by_pairs<NP - 1>(np, r);
      return;
    }
  }
  rows<NP>(r);
}

// NT: the most key tiles a row keeps (8 for L <= 128, 16 for L <= 256);
// MINB: the blocks an SM is to hold (the register budget)
template <int NT, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
attn_infer_d64_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const int* __restrict__ mask, bf16* __restrict__ out,
                      int L, int H) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1 KB
  const int tid = threadIdx.x, lane = tid & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const int ntile = (L + KT - 1) / KT, nchunk = (L + QC - 1) / QC;
  const long long row0 = (long long)b * L;
  const long long stride = (long long)H * D;  // elements between tokens
  const uint32_t sQ = base, sK = sQ + nchunk * CHUNK_B;
  const uint32_t sV = sK + slot_room(L) * SLOT_B;
  const uint32_t sB = sV + slot_room(L) * SLOT_B;

  // the row's mask first (the key copies wait for it), then the queries,
  // whose copies need nothing and overlap the rest; rows past L as zeros
  int mv[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) {
    const int key = i * 32 + lane;
    mv[i] = key < L ? mask[row0 + key] : 0;
  }
  for (int i = tid; i < nchunk * QC * 8; i += THREADS) {
    const int row = i >> 3, c = i & 7;
    const bool ok = row < L;
    cp_async16(sQ + swz(row, c),
               q + (row0 + (ok ? row : 0)) * stride + h * D + c * 8, ok);
  }
  // lane j (< ntile) holds tile j's real keys as 16 bits
  uint32_t real = 0;
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) {
    const uint32_t bal = __ballot_sync(FULL, mv[i] != 0);
    if (lane == 2 * i) real = bal & 0xffffu;
    if (lane == 2 * i + 1) real = bal >> 16;
  }
  // kept tiles: those with a real key, or every tile of a row with none
  const bool any = __any_sync(FULL, real != 0);
  const uint32_t kept =
      __ballot_sync(FULL, lane < ntile && (real != 0 || !any));
  const int nkept = __popc(kept), nslot = (nkept + 1) & ~1;
  // lane s (< nkept) takes the s-th kept tile
  int tile = 0;
  for (int j = 0, c = 0; j < NT; ++j)
    if ((kept >> j) & 1u) {
      if (c == lane) tile = j;
      ++c;
    }
  const uint32_t slot_real = __shfl_sync(FULL, real, tile);
  // slots whose 16 keys are all real and inside L need no fills
  const uint32_t full = __ballot_sync(
      FULL, lane < nkept && slot_real == 0xffffu && tile * KT + KT <= L);

  // each slot's scores where not the product: 0 for a real key (the
  // product stands), -1e9 / 2^-3 for a masked one, -inf past L and in a
  // pad slot; laid out so lane (g, t) reads keys 2t, 2t + 1, 2t + 8,
  // 2t + 9 as one 16-byte vector
  const int warp = tid >> 5;
  for (int slot = warp; slot < nslot; slot += THREADS / 32) {
    const uint32_t re = __shfl_sync(FULL, slot_real, slot);
    const int tl = __shfl_sync(FULL, tile, slot);
    if (lane < KT) {
      const float f = slot >= nkept || tl * KT + lane >= L ? -INFINITY
                      : ((re >> lane) & 1u) ? 0.f
                                            : cldrd_attn::MASKED / SCALE;
      st_shared_f32(sB + slot * 64 + ((lane & 7) >> 1) * 16 +
                        ((lane & 1) + 2 * (lane >> 3)) * 4,
                    f);
    }
  }

  // K (with Q, group 0), then V (group 1) of the kept slots: slot s at
  // rows 16s .. 16s + 15, a 128-byte row by eight threads; a pad slot as
  // zeros
  for (int pass = 0; pass < 2; ++pass) {
    const bf16* src = pass ? v : k;
    const uint32_t dst = pass ? sV : sK;
    for (int base_i = warp * 32; base_i < nslot * KT * 8;
         base_i += THREADS) {
      const int i = base_i + lane, slot = i >> 7, row = (i >> 3) & (KT - 1);
      const int c = i & 7;
      const int key = __shfl_sync(FULL, tile, slot) * KT + row;
      const bool ok = slot < nkept && key < L;
      cp_async16(dst + swz(slot * KT + row, c),
                 src + (row0 + (ok ? key : 0)) * stride + h * D + c * 8, ok);
    }
    cp_async_commit();
  }
  cp_async_wait<1>();
  fence_async_smem();
  __syncthreads();

  const Row r = {sQ, sK, sV, sB, full, out + row0 * stride + h * D, stride,
                 L, nchunk};
  rows_by_pairs<NT / 2>(nslot / 2, r);
}

// one build of the kernel: NT kept tiles at most, MINB blocks an SM
template <int NT, int MINB>
struct Build {
  static cudaError_t allow_smem() {
    static bool smem_set[MAX_DEVICES] = {};
    return allow_dynamic_smem(attn_infer_d64_kernel<NT, MINB>,
                              smem_bytes(NT * KT), smem_set);
  }
  static int launch(const void* q, const void* k, const void* v,
                    const int* mask, void* out, int B, int L, int H,
                    cudaStream_t stream) {
    const cudaError_t e = allow_smem();
    if (e != cudaSuccess) return (int)e;
    attn_infer_d64_kernel<NT, MINB><<<dim3(H, B), THREADS, smem_bytes(L),
                                      stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), mask, static_cast<bf16*>(out), L, H);
    return (int)cudaGetLastError();
  }
  static int blocks_per_sm(int L) {
    int n = 0;
    if (allow_smem() != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, attn_infer_d64_kernel<NT, MINB>, THREADS, smem_bytes(L)) !=
            cudaSuccess)
      return -1;
    return n;
  }
};
// rows of L <= 128: 8 kept tiles and 4 blocks an SM; past it 16 and 2
using Short = Build<SHORT_TILES, 4>;
using Long = Build<2 * SHORT_TILES, 2>;

}  // namespace cldrd_attn_d64

// C entry point for ctypes; returns a cudaError_t (0 on success).
// q/k/v/out [B, L, H, 64] bf16, contiguous, 16-byte aligned; mask [B, L]
// int32 (!= 0: a real token); scale = bf16(1/sqrt(64)) = 0.125 (the
// kernel folds it as a power of two; any other value is refused).
extern "C" int attn_infer_d64_launch(const void* q, const void* k,
                                     const void* v, const int* mask,
                                     void* out, int B, int L, int H,
                                     float scale, void* stream) {
  using namespace cldrd_attn_d64;
  if (B <= 0 || B > 65535 || L <= 0 || L > MAXL || H <= 0 ||
      scale != SCALE)
    return (int)cudaErrorInvalidValue;
  return L <= SHORT_TILES * KT
             ? Short::launch(q, k, v, mask, out, B, L, H,
                             (cudaStream_t)stream)
             : Long::launch(q, k, v, mask, out, B, L, H,
                            (cudaStream_t)stream);
}

// Blocks of the kernel resident on one SM at rows of L (registers and
// shared memory as built), or -1 on a CUDA error.
extern "C" int attn_infer_d64_blocks_per_sm(int L) {
  using namespace cldrd_attn_d64;
  if (L <= 0 || L > MAXL) return -1;
  return L <= SHORT_TILES * KT ? Short::blocks_per_sm(L)
                               : Long::blocks_per_sm(L);
}
