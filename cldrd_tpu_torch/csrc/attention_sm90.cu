// K3 (train attention forward) and K4 (its backward) for Hopper (sm_90a):
// the route of every bf16 training launch with head_dim 64 and L <= 256
// (ops/attention.py::_kernel_route), which covers the main path's passage
// rows (L=256), query rows (L=30) and packed rows (256 with segments).
// attention.cu keeps fp32, head_dim 32 and 256 < L <= 512. K5 has kernels
// of its own (attention_infer.cu, attention_infer_d64.cu,
// attention_infer_d32.cu); the forward here serves K5 only where a caller
// forces it (chip_smoke times it as the d64 route's old route).
//
// Replaces the TPU kernels cldrd_tpu/ops/attention.py::
//   _train_fwd_kernel_factory (:204, K3) and _train_bwd_kernel_factory
//   (:257, K4).
// The function is attention.cu's, for one (batch row b, head h), with
// s = (q * scale) . k^T in fp32, masked keys at -1e9 (and by segment for
// packed rows), keys past L at -inf, probs = exp(s - max) / sum rounded
// to bf16, dropout keep = hash(((b*H + h)*L + q)*L + k, seed) with
// probs_d = keep ? probs * inv : 0 (inv in bf16), out = probs_d . v;
// backward dv = probs_d^T g, dp = (g . v^T) * keep * inv32,
// ds = bf16(probs * (dp - rowsum)), dq = (ds . k) * scale32,
// dk = (ds^T . q) * scale32.
//
// Two differences in how, none in what:
// - head_dim is 64, so scale = 2^-3 and (q * scale) . k = scale * (q . k)
//   exactly: the kernels multiply the fp32 product by scale instead of
//   keeping a scaled copy of q.
// - rowsum(dp * probs) is taken as inv32 * (g . ov), with
//   ov = sum_k keep * probs * v in fp32, a second output of the forward
//   (one more P.V product, with the kept probs unscaled: exact in bf16).
//   The two are one sum in two orders, so they differ only by fp32
//   rounding, as the reference's own order does. A key tile's S and dP
//   then die as soon as its dS is formed, which is what makes the
//   backward fit in registers. (FlashAttention-2 takes rowsum(g * out)
//   with out the bf16 output; here that put about one bf16 ulp of noise
//   into every dq and dk element: the rounding of out and of
//   probs * inv. ov carries neither.)
//
// Bound on an H100 SXM at the passage tower's shape (B=240, H=12, L=256,
// D=64, bf16): the forward moves 377 MB (0.113 ms at 3.35 TB/s) against
// 48.3 GFLOP (0.049 ms at 989 TFLOP/s), the backward 661 MB (0.197 ms)
// against 120.8 GFLOP (0.122 ms): bytes bind both. (The function's own
// bytes; ov adds 189 MB written by the forward and read by the backward,
// the price of an exact row sum.) Per element of the
// [L, L] score matrix (189M per launch) each direction also computes one
// exp, one division and, with dropout, one murmur3 hash (3 multiplies,
// 3 shifts, 3 xors); at the H100's integer rate the hash alone costs
// about as much as the bytes bound, so each is computed once per element
// and direction, the division as a multiply by the row's reciprocal with
// one exact correction (div_row), and the keep test as an integer
// comparison (hash_keep_t).
//
// Design, against the four faults of attention.cu's first version:
// 1. Scores once per direction. The forward holds a 64-query chunk's
//    whole score row (up to 256 keys, 128 fp32 registers a thread) and
//    takes the exact max and sum in one sweep: no second Q.K^T, no online
//    rescale, and probs round exactly where the reference's do. The
//    backward forms S and dP once per element, from the forward's (max,
//    sum) residual, so its probs and keep bits are the forward's bit for
//    bit.
// 2. Each operand read once. One forward block owns (b, h, 64-query
//    chunk) and holds the row's K and V (64 KB) in shared memory. One
//    backward block owns a whole (b, h) row: K and V stay resident, Q, G
//    and ov stream through a two-stage ring of 64-row chunks. Each of
//    the two warpgroups owns two 64-key tiles; dQ of a chunk is finished
//    inside the block (all keys are there) as the sum of the two
//    warpgroups' partials and written once; dK and dV accumulate in
//    registers over the chunks and are written once.
// 3. Asynchronous 16-byte copies (cp.async, rows past L zero-filled)
//    into 128-byte-swizzled tiles: the forward's V and the backward's
//    next chunk are in flight while the tensor cores work.
// 4. wgmma (m64n64k16, bf16 in, fp32 accumulate) for every product,
//    operands straight from the swizzled tiles: S = Q.K^T and dP = G.V^T
//    K-major; P.V with P in registers (the accumulator's layout is the A
//    fragment's); dV += P_d^T.G and dK += dS^T.Q with both operands
//    MN-major (transposed) from shared memory; dQ = dS.K from the dS
//    tiles the warpgroup wrote. No score makes a round trip through
//    shared memory in fp32. The tensor-core code has no branch (every
//    launch computes all four key tiles; tiles past L hold zeros and
//    masked keys), so ptxas does not serialize the wgmma pipeline.
// No atomics: every sum runs in a fixed order (quad shuffles, one
// warpgroup per key tile, the second warpgroup's partial dQ added to the
// first's), so two launches on the same inputs give the same bits.
//
// Shapes: the forward is one warpgroup (128 threads) per block, ~75 KB of
// shared memory; the backward two warpgroups (256 threads, up to 255
// registers each: dK and dV of two 64-key tiles are 128 fp32 registers a
// thread, S and dP of one tile 64 more), ~211 KB, one block per SM.
// Rows shorter than 193 do the work of 256 (only the query tower's
// L=30 launches, the smallest of the path).
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attn_common.cuh"  // hash_keep_t, drop_index, masked_score
#include "score_tile.cuh"   // allow_dynamic_smem, MAX_DEVICES

namespace cldrd_attn90 {

using bf16 = __nv_bfloat16;
using cldrd::allow_dynamic_smem;
using cldrd::MAX_DEVICES;
using cldrd_attn::drop_index;
using cldrd_attn::hash_keep_t;
using cldrd_attn::keep_threshold;
using cldrd_attn::masked_score;

constexpr int D = 64;            // head_dim of this route
constexpr int MAXL = 256;        // longest row of this route
constexpr int TILE = 64;         // rows of a tile (queries or keys)
constexpr int TB = TILE * D * 2; // bytes of a tile: 64 rows of 128 bytes
constexpr int MAXT = MAXL / TILE;
constexpr int KSTEP_MN = 16 * 128;  // one 16-row depth step, MN-major
constexpr int KSTEP_K = 32;         // one 16-column depth step, K-major

// ------------------------------------------------------------ primitives

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `chunk` of row `row` in a tile of 128-byte
// rows under the 128-byte swizzle (TMA's SWIZZLE_128B, wgmma's B128): the
// chunk index is xor-ed with the row's position in its 8-row group
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
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
// generic-proxy writes (cp.async, st.shared) made visible to wgmma, which
// reads shared memory through the async proxy
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// rows [l0, l0 + 64) of head h, batch row b of a [B, L, H, 64] bf16
// tensor into the swizzled tile at dst; rows past L arrive as zeros
__device__ __forceinline__ void load_tile(const bf16* __restrict__ src,
                                          int b, int h, int L, int H, int l0,
                                          uint32_t dst, int tid, int nthr) {
  for (int i = tid; i < TILE * 8; i += nthr) {
    const int r = i >> 3, c = i & 7;
    const int l = l0 + r;
    const bool ok = l < L;
    const bf16* g =
        src + (((long long)b * L + (ok ? l : 0)) * H + h) * D + c * 8;
    cp_async16(dst + swz(r, c), g, ok);
  }
}

// the same for a [B, L, H, 64] fp32 tensor into a plain tile of 256-byte
// rows (read by the threads, not by wgmma)
__device__ __forceinline__ void load_tile_f32(const float* __restrict__ src,
                                              int b, int h, int L, int H,
                                              int l0, uint32_t dst, int tid,
                                              int nthr) {
  for (int i = tid; i < TILE * 16; i += nthr) {
    const int r = i >> 4, c = i & 15;
    const int l = l0 + r;
    const bool ok = l < L;
    const float* g =
        src + (((long long)b * L + (ok ? l : 0)) * H + h) * D + c * 4;
    cp_async16(dst + r * 256 + c * 16, g, ok);
  }
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout B128.
// The stride byte offset is 1024 (one 8-row swizzle atom) in both forms;
// the leading one is unused by these 64-wide tiles.
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
// pins registers that an in-flight wgmma writes or reads, so the compiler
// neither reads an accumulator before the wait nor reuses an A fragment
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

#define ACC32(d)                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])
#define OUT32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], both operands in shared memory;
// TA / TB = 1 reads the operand MN-major (transposed)
template <int TA, int TB_>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " OUT32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB_)
      : "memory");
}
// the same with A from registers (four bf16x2 per thread, the m64k16
// fragment) and B MN-major
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t* a,
                                       uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " OUT32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate)
      : "memory");
}

// e / l for e in [0, 1], l in [1, L], from r = 1 / l (rounded once per
// row): q = e * r, then one correction by the exact remainder e - q * l
// (Markstein's step), which gives the correctly rounded quotient in the
// normal range without div.rn's per-element range check and slow path,
// which masked keys (e = 0) take. Both directions call it, so the
// backward's probs are the forward's bit for bit.
__device__ __forceinline__ float div_row(float e, float l, float r) {
  const float q = e * r;
  return fmaf(fmaf(-q, l, e), r, q);
}

// a bf16 pair as one 32-bit register (.x in the low half), the layout of
// wgmma's A fragments and of two neighbouring columns in shared memory
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return as_u32(__halves2bfloat162(lo, hi));
}

// Accumulator layout of m64n64 (per thread of a warpgroup, warp w, lane):
// element i is row 16w + lane/4 + 8*((i >> 1) & 1), column
// 8*(i >> 2) + 2*(lane % 4) + (i & 1).
__device__ __forceinline__ int acc_col(int i, int lane) {
  return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
}

// key metadata of the row: kmask[k] = mask (-1 past L), kseg[k] = segment
template <bool SEG>
__device__ __forceinline__ void load_key_meta(const int* __restrict__ mask,
                                              const int* __restrict__ seg,
                                              int b, int L, int n, int* kmask,
                                              int* kseg, int tid, int nthr) {
  for (int i = tid; i < n; i += nthr) {
    kmask[i] = i < L ? (mask[(long long)b * L + i] != 0) : -1;
    kseg[i] = (SEG && i < L) ? seg[(long long)b * L + i] : 0;
  }
}

// ---------------------------------------------------------------- forward

constexpr int FWD_THREADS = 128;
constexpr int FWD_SMEM = (1 + 2 * MAXT) * TB + 2 * MAXL * 4 + 1024;

template <bool DROP, bool SEG>
__global__ void __launch_bounds__(FWD_THREADS)
attn_fwd_sm90_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ mask,
                     const int* __restrict__ seg, bf16* __restrict__ out,
                     float* __restrict__ stats, float* __restrict__ ov,
                     int L, int H, uint32_t seed, float p, float inv,
                     float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1 KB
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t sQ = base, sK = base + TB, sV = sK + MAXT * TB;
  int* kmask = reinterpret_cast<int*>(sm + (1 + 2 * MAXT) * TB);
  int* kseg = kmask + MAXL;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * TILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // group 0: the query chunk and K; group 1: V, in flight during Q.K^T.
  // All four key tiles, always: tiles past L hold zeros (no read) and
  // masked keys, so the tensor-core code has no branch.
  load_tile(q, b, h, L, H, q0, sQ, tid, FWD_THREADS);
  for (int j = 0; j < MAXT; ++j)
    load_tile(k, b, h, L, H, j * TILE, sK + j * TB, tid, FWD_THREADS);
  cp_async_commit();
  for (int j = 0; j < MAXT; ++j)
    load_tile(v, b, h, L, H, j * TILE, sV + j * TB, tid, FWD_THREADS);
  cp_async_commit();
  load_key_meta<SEG>(mask, seg, b, L, MAXL, kmask, kseg, tid, FWD_THREADS);
  int qrow[2], qs[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    qrow[x] = q0 + warp * 16 + (lane >> 2) + 8 * x;
    qs[x] = (SEG && qrow[x] < L) ? seg[(long long)b * L + qrow[x]] : 0;
  }
  cp_async_wait<1>();
  fence_async_smem();
  __syncthreads();

  // S = Q . K^T over every key tile of the row, one sweep (the first
  // depth step of a tile overwrites its accumulator)
  float s[MAXT][32];
  wg_fence();
#pragma unroll
  for (int j = 0; j < MAXT; ++j) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_ss<0, 0>(s[j], sdesc(sQ + kk * KSTEP_K),
                   sdesc(sK + j * TB + kk * KSTEP_K), kk > 0);
  }
  wg_commit();
  wg_wait0();
#pragma unroll
  for (int j = 0; j < MAXT; ++j) fence_regs(s[j]);

  // exact row max and sum over all keys (a row lives in a lane quad)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < MAXT; ++j) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int x = (i >> 1) & 1, c = j * TILE + acc_col(i, lane);
      s[j][i] = masked_score<SEG>(s[j][i] * scale, kmask[c], kseg[c],
                                  qs[x]);
      m[x] = fmaxf(m[x], s[j][i]);
    }
  }
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    m[x] = fmaxf(m[x], __shfl_xor_sync(0xffffffffu, m[x], 1));
    m[x] = fmaxf(m[x], __shfl_xor_sync(0xffffffffu, m[x], 2));
  }
#pragma unroll
  for (int j = 0; j < MAXT; ++j) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int x = (i >> 1) & 1;
      s[j][i] = expf(s[j][i] - m[x]);
      l[x] += s[j][i];
    }
  }
  float rl[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 1);
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 2);
    rl[x] = 1.f / l[x];
  }
  const uint32_t thr = keep_threshold(p);

  // probs rounded to bf16, packed as P.V's A fragments: step kk of tile
  // j takes columns 16kk.. (accumulator blocks 2kk and 2kk + 1). With
  // dropout these are first the kept probs unscaled (keep ? probs : 0,
  // exact in bf16), for ov = pa.V; then each is scaled by inv in place,
  // bf16(probs * inv) as the reference rounds it, for out = pa.V. One set
  // of fragments and one accumulator live at a time keeps the registers
  // under 255 without spills.
  uint32_t pa[MAXT][16];
#pragma unroll
  for (int j = 0; j < MAXT; ++j) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int x = (i >> 1) & 1, nb = i >> 2;
      // columns c and c + 1, converted to bf16 as a pair
      __nv_bfloat162 pr = __floats2bfloat162_rn(
          div_row(s[j][i], l[x], rl[x]), div_row(s[j][i + 1], l[x], rl[x]));
      if (DROP) {
        const float2 pf = __bfloat1622float2(pr);
        const uint32_t idx =
            drop_index(b, h, H, L, (uint32_t)qrow[x],
                       (uint32_t)(j * TILE + acc_col(i, lane)));
        pr = __floats2bfloat162_rn(hash_keep_t(idx, seed, thr) ? pf.x : 0.f,
                                   hash_keep_t(idx + 1u, seed, thr) ? pf.y
                                                                    : 0.f);
      }
      // fragment register (kk = nb / 2): a0 rows r, cols 0-1; a1 rows
      // r + 8; a2 / a3 the same at cols 8-9
      pa[j][(nb >> 1) * 4 + (nb & 1) * 2 + x] = as_u32(pr);
    }
  }

  cp_async_wait<0>();
  fence_async_smem();
  __syncthreads();
  float o[32];
  // ov = the kept probs . V (without dropout, out's own product)
  wg_fence();
#pragma unroll
  for (int j = 0; j < MAXT; ++j) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_rs(o, &pa[j][kk * 4], sdesc(sV + j * TB + kk * KSTEP_MN),
             (j | kk) != 0);
  }
  wg_commit();
  wg_wait0();
  fence_regs(o);
#pragma unroll
  for (int j = 0; j < MAXT; ++j) fence_regs(pa[j]);
  if (ov != nullptr) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      if (qrow[x] >= L) continue;
      float* dst = ov + (((long long)b * L + qrow[x]) * H + h) * D;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
        *reinterpret_cast<float2*>(dst + nb * 8 + 2 * (lane & 3)) =
            make_float2(o[nb * 4 + 2 * x], o[nb * 4 + 2 * x + 1]);
    }
  }
  if (DROP) {
    // probs_d = bf16(probs * inv) for the kept ones (0 stays 0)
#pragma unroll
    for (int j = 0; j < MAXT; ++j) {
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float2 pf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&pa[j][r]));
        pa[j][r] = as_u32(__floats2bfloat162_rn(pf.x * inv, pf.y * inv));
      }
    }
    wg_fence();
#pragma unroll
    for (int j = 0; j < MAXT; ++j) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rs(o, &pa[j][kk * 4], sdesc(sV + j * TB + kk * KSTEP_MN),
               (j | kk) != 0);
    }
    wg_commit();
    wg_wait0();
    fence_regs(o);
#pragma unroll
    for (int j = 0; j < MAXT; ++j) fence_regs(pa[j]);
  }

#pragma unroll
  for (int x = 0; x < 2; ++x) {
    if (qrow[x] >= L) continue;
    bf16* dst = out + (((long long)b * L + qrow[x]) * H + h) * D;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const int c = nb * 8 + 2 * (lane & 3);
      *reinterpret_cast<__nv_bfloat162*>(dst + c) = __floats2bfloat162_rn(
          o[nb * 4 + 2 * x], o[nb * 4 + 2 * x + 1]);
    }
    if (stats != nullptr && (lane & 3) == 0) {
      const long long row = ((long long)b * H + h) * L + qrow[x];
      stats[2 * row] = m[x];
      stats[2 * row + 1] = l[x];
    }
  }
}

// --------------------------------------------------------------- backward

constexpr int BWD_THREADS = 256;  // two warpgroups
// K, V (4 tiles each), Q, G (2 stages each), ov (2 stages of [64 x 64]
// fp32, two tiles' room each), dS, P_d (4 tiles each), and the second
// warpgroup's partial dQ ([64 x 64] fp32, two tiles' room)
constexpr int BWD_TILES = 2 * MAXT + 2 * 2 + 2 * 2 + 2 * MAXT + 2;
constexpr int BWD_SMEM = BWD_TILES * TB + 2 * MAXL * 4 + TILE * 4 + 1024;

// Q, G and ov of query chunk c into ring stage c % 2
__device__ __forceinline__ void load_chunk(const bf16* q, const bf16* g,
                                           const float* ov, int b, int h,
                                           int L, int H, int c, uint32_t sQ,
                                           uint32_t sG, uint32_t sO,
                                           int tid) {
  const uint32_t off = (c & 1) * TB;
  load_tile(q, b, h, L, H, c * TILE, sQ + off, tid, BWD_THREADS);
  load_tile(g, b, h, L, H, c * TILE, sG + off, tid, BWD_THREADS);
  load_tile_f32(ov, b, h, L, H, c * TILE, sO + 2 * off, tid, BWD_THREADS);
}

// One block owns a (b, h) row. Warpgroup w owns key tiles w and w + 2
// (all four tiles always: tiles past L hold zeros and masked keys, so the
// tensor-core code has no branch). For each 64-query chunk it forms S,
// dP, dS and P_d of its tiles, accumulates dK and dV, and a partial dQ
// over its tiles; the two partial dQ are added in a fixed order.
template <bool DROP, bool SEG>
__global__ void __launch_bounds__(BWD_THREADS, 1)
attn_bwd_sm90_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ mask,
                     const int* __restrict__ seg, const bf16* __restrict__ g,
                     const float* __restrict__ ov,
                     const float* __restrict__ stats, bf16* __restrict__ dq,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int L,
                     int H, uint32_t seed, float p, float inv, float inv32,
                     float scale, float scale32) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t sK = base, sV = sK + MAXT * TB;
  const uint32_t sQ = sV + MAXT * TB, sG = sQ + 2 * TB, sO = sG + 2 * TB;
  const uint32_t sDS = sO + 4 * TB, sPD = sDS + MAXT * TB;
  unsigned char* pDS = sm + (sDS - base);
  unsigned char* pPD = sm + (sPD - base);
  const unsigned char* pG = sm + (sG - base);
  const unsigned char* pO = sm + (sO - base);
  float* xdq = reinterpret_cast<float*>(sm + (sPD - base) + MAXT * TB);
  int* kmask = reinterpret_cast<int*>(sm + BWD_TILES * TB);
  int* kseg = kmask + MAXL;
  float* rsum = reinterpret_cast<float*>(kseg + MAXL);  // [64]

  const int h = blockIdx.x, b = blockIdx.y;
  const int nqc = (L + TILE - 1) / TILE;  // query chunks
  const int tid = threadIdx.x;
  const int wg = tid >> 7, wt = tid & 127, warp = wt >> 5, lane = tid & 31;
  const uint32_t thr = keep_threshold(p);

  // group 0: K and V of the row; groups 1, 2: query chunks 0 and 1
  for (int j = 0; j < MAXT; ++j) {
    load_tile(k, b, h, L, H, j * TILE, sK + j * TB, tid, BWD_THREADS);
    load_tile(v, b, h, L, H, j * TILE, sV + j * TB, tid, BWD_THREADS);
  }
  cp_async_commit();
  load_chunk(q, g, ov, b, h, L, H, 0, sQ, sG, sO, tid);
  cp_async_commit();
  if (nqc > 1) load_chunk(q, g, ov, b, h, L, H, 1, sQ, sG, sO, tid);
  cp_async_commit();
  load_key_meta<SEG>(mask, seg, b, L, MAXL, kmask, kseg, tid, BWD_THREADS);

  float dka[2][32], dva[2][32];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[t][i] = dva[t][i] = 0.f;

  for (int c = 0; c < nqc; ++c) {
    const uint32_t st = (c & 1) * TB;
    const int q0 = c * TILE;
    cp_async_wait<1>();  // chunk c (group c + 1) has landed
    fence_async_smem();
    __syncthreads();

    // rowsum = inv32 * (g . ov) of the chunk's 64 rows: four threads a
    // row, 16 columns each, summed in a fixed order
    {
      const int r = tid >> 2, part = tid & 3;
      float acc = 0.f;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int chunk = part * 2 + h2;  // columns 8 * chunk ..
        const uint4 gv =
            *reinterpret_cast<const uint4*>(pG + st + swz(r, chunk));
        const __nv_bfloat162* g2 =
            reinterpret_cast<const __nv_bfloat162*>(&gv);
        const float4* o4 = reinterpret_cast<const float4*>(
            pO + 2 * st + r * 256 + chunk * 32);
        const float4 oa = o4[0], ob = o4[1];
        const float of[8] = {oa.x, oa.y, oa.z, oa.w, ob.x, ob.y, ob.z, ob.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 gf = __bfloat1622float2(g2[e]);
          acc = fmaf(gf.x, of[2 * e], acc);
          acc = fmaf(gf.y, of[2 * e + 1], acc);
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (part == 0) rsum[r] = acc * inv32;
    }
    __syncthreads();

    // this thread's two query rows of the chunk
    int qrow[2], qs[2];
    float mr[2], lr[2], rr[2], dr[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int rl = warp * 16 + (lane >> 2) + 8 * x;
      qrow[x] = q0 + rl;
      const bool in = qrow[x] < L;
      const long long row = ((long long)b * H + h) * L + qrow[x];
      mr[x] = in ? stats[2 * row] : 0.f;
      lr[x] = in ? stats[2 * row + 1] : 1.f;
      qs[x] = (SEG && in) ? seg[(long long)b * L + qrow[x]] : 0;
      rr[x] = 1.f / lr[x];
      dr[x] = rsum[rl];
    }

    // S and dP of each own key tile, once; dS and P_d into shared memory
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int j = wg + 2 * t;
      float sa[32], dpa[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_ss<0, 0>(sa, sdesc(sQ + st + kk * KSTEP_K),
                     sdesc(sK + j * TB + kk * KSTEP_K), kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_ss<0, 0>(dpa, sdesc(sG + st + kk * KSTEP_K),
                     sdesc(sV + j * TB + kk * KSTEP_K), kk > 0);
      wg_commit();
      wg_wait0();
      fence_regs(sa);
      fence_regs(dpa);
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int x = (i >> 1) & 1;
        const int kc = j * TILE + acc_col(i, lane);  // and kc + 1
        float e2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float sv = masked_score<SEG>(
              sa[i + e] * scale, kmask[kc + e], kseg[kc + e], qs[x]);
          e2[e] = qrow[x] < L ? div_row(expf(sv - mr[x]), lr[x], rr[x])
                              : 0.f;
        }
        // probs, P_d and dS of the pair, each converted to bf16 at once
        const __nv_bfloat162 pt = __floats2bfloat162_rn(e2[0], e2[1]);
        const float2 pf = __bfloat1622float2(pt);
        float dp0 = dpa[i], dp1 = dpa[i + 1];
        __nv_bfloat162 pd = pt;
        if (DROP) {
          const uint32_t idx =
              drop_index(b, h, H, L, (uint32_t)qrow[x], (uint32_t)kc);
          const bool k0 = hash_keep_t(idx, seed, thr);
          const bool k1 = hash_keep_t(idx + 1u, seed, thr);
          pd = __floats2bfloat162_rn(k0 ? pf.x * inv : 0.f,
                                     k1 ? pf.y * inv : 0.f);
          // rounded on its own, as the plain version rounds it (an FMA
          // with the subtraction below would skip that rounding)
          dp0 = k0 ? __fmul_rn(dp0, inv32) : 0.f;
          dp1 = k1 ? __fmul_rn(dp1, inv32) : 0.f;
        }
        const __nv_bfloat162 ds = __floats2bfloat162_rn(
            pf.x * (dp0 - dr[x]), pf.y * (dp1 - dr[x]));
        const int rl = warp * 16 + (lane >> 2) + 8 * x;
        const int cl = acc_col(i, lane);
        const uint32_t off = j * TB + swz(rl, cl >> 3) + (cl & 7) * 2;
        *reinterpret_cast<uint32_t*>(pDS + off) = as_u32(ds);
        *reinterpret_cast<uint32_t*>(pPD + off) = as_u32(pd);
      }
    }
    // the warpgroup's own dS and P_d tiles are complete
    fence_async_smem();
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");

    // dV += P_d^T . G, dK += dS^T . Q (depth: the chunk's 64 queries),
    // and the partial dQ = dS . K over the own tiles
    float dqa[32];
    wg_fence();
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int j = wg + 2 * t;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        mma_ss<1, 1>(dva[t], sdesc(sPD + j * TB + kk * KSTEP_MN),
                     sdesc(sG + st + kk * KSTEP_MN), 1);
        mma_ss<1, 1>(dka[t], sdesc(sDS + j * TB + kk * KSTEP_MN),
                     sdesc(sQ + st + kk * KSTEP_MN), 1);
      }
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int j = wg + 2 * t;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_ss<0, 1>(dqa, sdesc(sDS + j * TB + kk * KSTEP_K),
                     sdesc(sK + j * TB + kk * KSTEP_MN), (t | kk) != 0);
    }
    wg_commit();
    wg_wait0();
    fence_regs(dqa);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      fence_regs(dka[t]);
      fence_regs(dva[t]);
    }
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < 32; ++i) xdq[i * 128 + wt] = dqa[i];
    }
    __syncthreads();  // stage c % 2 is free; the partial dQ is there
    if (c + 2 < nqc)
      load_chunk(q, g, ov, b, h, L, H, c + 2, sQ, sG, sO, tid);
    cp_async_commit();
    if (wg == 0) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        if (qrow[x] >= L) continue;
        bf16* dst = dq + (((long long)b * L + qrow[x]) * H + h) * D;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const int i0 = nb * 4 + 2 * x, cc = nb * 8 + 2 * (lane & 3);
          *reinterpret_cast<__nv_bfloat162*>(dst + cc) =
              __floats2bfloat162_rn(
                  (dqa[i0] + xdq[i0 * 128 + wt]) * scale32,
                  (dqa[i0 + 1] + xdq[(i0 + 1) * 128 + wt]) * scale32);
        }
      }
    }
  }

#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int j = wg + 2 * t;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int krow = j * TILE + warp * 16 + (lane >> 2) + 8 * x;
      if (krow >= L) continue;
      const long long off = (((long long)b * L + krow) * H + h) * D;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const int cc = nb * 8 + 2 * (lane & 3);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + cc) =
            __floats2bfloat162_rn(dva[t][nb * 4 + 2 * x],
                                  dva[t][nb * 4 + 2 * x + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dk + off + cc) =
            __floats2bfloat162_rn(dka[t][nb * 4 + 2 * x] * scale32,
                                  dka[t][nb * 4 + 2 * x + 1] * scale32);
      }
    }
  }
}

// ------------------------------------------------------ layout check

// One 64 x 64 x 64 product in each operand form the kernels use, for the
// card tests: a, b [64, 64] bf16 row-major, c [64, 64] fp32.
//   form 0: c = a . b^T  (both K-major: S = Q.K^T, dP = G.V^T)
//   form 1: c = a^T . b  (both MN-major: dV += P_d^T.G, dK += dS^T.Q)
//   form 2: c = a . b    (A K-major, B MN-major: dQ = dS.K)
//   form 3: c = a . b    (A from registers, B MN-major: out = P.V)
__global__ void __launch_bounds__(128)
attn_sm90_mma_check_kernel(const bf16* __restrict__ a,
                           const bf16* __restrict__ b, float* __restrict__ c,
                           int form) {
  __shared__ __align__(1024) unsigned char tiles[2 * TB];
  const uint32_t sA = smem_u32(tiles), sB = sA + TB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  load_tile(a, 0, 0, TILE, 1, 0, sA, tid, 128);
  load_tile(b, 0, 0, TILE, 1, 0, sB, tid, 128);
  cp_async_commit();
  cp_async_wait<0>();
  fence_async_smem();
  __syncthreads();
  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  uint32_t fa[16];
  if (form == 3) {  // a's rows in the m64k16 fragment layout
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = warp * 16 + (lane >> 2) + 8 * (r & 1);
        const int col = kk * 16 + 8 * (r >> 1) + 2 * (lane & 3);
        fa[kk * 4 + r] = pack2(a[row * TILE + col], a[row * TILE + col + 1]);
      }
  }
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (form == 0)
      mma_ss<0, 0>(d, sdesc(sA + kk * KSTEP_K), sdesc(sB + kk * KSTEP_K), 1);
    else if (form == 1)
      mma_ss<1, 1>(d, sdesc(sA + kk * KSTEP_MN), sdesc(sB + kk * KSTEP_MN),
                   1);
    else if (form == 2)
      mma_ss<0, 1>(d, sdesc(sA + kk * KSTEP_K), sdesc(sB + kk * KSTEP_MN),
                   1);
    else
      mma_rs(d, &fa[kk * 4], sdesc(sB + kk * KSTEP_MN), 1);
  }
  wg_commit();
  wg_wait0();
  fence_regs(d);
  fence_regs(fa);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int row = warp * 16 + (lane >> 2) + 8 * ((i >> 1) & 1);
    c[row * TILE + acc_col(i, lane)] = d[i];
  }
}

// ---------------------------------------------------------------- launch

template <bool DROP, bool SEG>
struct Launch {
  static int fwd(const void* q, const void* k, const void* v, const int* mask,
                 const int* seg, void* out, float* stats, float* ov, int B,
                 int L, int H, uint32_t seed, float p, float inv, float scale,
                 cudaStream_t stream) {
    static bool set[MAX_DEVICES] = {};
    auto kern = attn_fwd_sm90_kernel<DROP, SEG>;
    cudaError_t e = allow_dynamic_smem(kern, FWD_SMEM, set);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((L + TILE - 1) / TILE, H, B);
    kern<<<grid, FWD_THREADS, FWD_SMEM, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), mask, seg, static_cast<bf16*>(out),
        stats, ov, L, H, seed, p, inv, scale);
    return (int)cudaGetLastError();
  }
  static int bwd(const void* q, const void* k, const void* v,
                 const int* mask, const int* seg, const void* g,
                 const float* ov, const float* stats, void* dq, void* dk,
                 void* dv, int B, int L, int H, uint32_t seed, float p,
                 float inv, float inv32, float scale, float scale32,
                 cudaStream_t stream) {
    static bool set[MAX_DEVICES] = {};
    auto kern = attn_bwd_sm90_kernel<DROP, SEG>;
    cudaError_t e = allow_dynamic_smem(kern, BWD_SMEM, set);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(H, B);
    kern<<<grid, BWD_THREADS, BWD_SMEM, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), mask, seg, static_cast<const bf16*>(g),
        ov, stats, static_cast<bf16*>(dq),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), L, H, seed, p, inv,
        inv32, scale, scale32);
    return (int)cudaGetLastError();
  }
};

template <typename Fn>
int dispatch(bool drop, bool seg, Fn fn) {
  if (drop) return seg ? fn(Launch<true, true>{}) : fn(Launch<true, false>{});
  return seg ? fn(Launch<false, true>{}) : fn(Launch<false, false>{});
}

bool shape_ok(int B, int L, int H, float p) {
  return B > 0 && B <= 65535 && L > 0 && L <= MAXL && H > 0 && H <= 65535 &&
         p >= 0.f && p < 1.f;
}

}  // namespace cldrd_attn90

// C entry points for ctypes; each returns a cudaError_t (0 on success).
// q/k/v/out [B, L, H, 64] bf16, contiguous, 16-byte aligned; mask and seg
// [B, L] int32 (seg NULL without segments); stats [B, H, L, 2] fp32 and
// ov [B, L, H, 64] fp32 (the backward's residual: the row's max and sum,
// and sum_k keep * probs * v; the forward writes them when not NULL, the
// backward reads them).
extern "C" int attn_fwd_sm90_launch(const void* q, const void* k,
                                    const void* v, const int* mask,
                                    const int* seg, void* out, float* stats,
                                    float* ov, int B, int L, int H, int seed,
                                    float p, float inv, float scale,
                                    void* stream) {
  using namespace cldrd_attn90;
  if (!shape_ok(B, L, H, p) || (stats == nullptr) != (ov == nullptr))
    return (int)cudaErrorInvalidValue;
  return dispatch(p > 0.f, seg != nullptr, [&](auto l) {
    return decltype(l)::fwd(q, k, v, mask, seg, out, stats, ov, B, L, H,
                            (uint32_t)seed, p, inv, scale,
                            (cudaStream_t)stream);
  });
}

// g, dq, dk, dv [B, L, H, 64] bf16 as above; stats and ov the forward's.
extern "C" int attn_bwd_sm90_launch(const void* q, const void* k,
                                    const void* v, const int* mask,
                                    const int* seg, const void* g,
                                    const float* ov, const float* stats,
                                    void* dq, void* dk, void* dv, int B,
                                    int L, int H, int seed, float p,
                                    float inv, float inv32, float scale,
                                    float scale32, void* stream) {
  using namespace cldrd_attn90;
  if (!shape_ok(B, L, H, p) || stats == nullptr || ov == nullptr)
    return (int)cudaErrorInvalidValue;
  return dispatch(p > 0.f, seg != nullptr, [&](auto l) {
    return decltype(l)::bwd(q, k, v, mask, seg, g, ov, stats, dq, dk, dv, B,
                            L, H, (uint32_t)seed, p, inv, inv32, scale,
                            scale32, (cudaStream_t)stream);
  });
}

// the layout check above, for the card tests
extern "C" int attn_sm90_mma_check(const void* a, const void* b, float* c,
                                   int form, void* stream) {
  if (form < 0 || form > 3) return (int)cudaErrorInvalidValue;
  cldrd_attn90::attn_sm90_mma_check_kernel<<<1, 128, 0,
                                             (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), c, form);
  return (int)cudaGetLastError();
}
