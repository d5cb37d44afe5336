// K5 (inference attention) at head_dim 32 on Hopper (sm_90a): the route of
// every bf16 launch with head_dim 32 and L <= 256
// (ops/attention.py::_kernel_route), which is the MiniLM-L6 cross-encoder
// teacher's (B=128, L=256, H=12, D=32; pairs of 39-90 real tokens of 256,
// five launches a teacher batch). fp32, training and rows past 256 keep
// attention.cu.
//
// Replaces the TPU kernel cldrd_tpu/ops/attention.py::_attention_kernel
// (:61). Per (batch row b, head h), in the reference's order:
//   q_s = bf16(q * bf16(1/sqrt(32)))   (bf16(1/sqrt(32)) = 0.1767578125 is
//                                       no power of two, so q is scaled and
//                                       rounded before the product, as the
//                                       reference does; scaling the fp32
//                                       product would round differently)
//   s = q_s . k^T in fp32; keys with mask == 0 score -1e9;
//   probs = exp(s - max) / sum in fp32, rounded to bf16;
//   out = bf16(probs . v) with fp32 accumulation.
//
// Bound on an H100 SXM at the teacher's shape with its pair padding: Q and
// O at all 256 rows plus K and V at the real keys only (a padded key's
// weight is exactly 0), ~62.8 MB, 0.0187 ms at 3.35 TB/s, against ~3.2
// GFLOP (0.003 ms at 989 TFLOP/s): bytes bind, by six. attention.cu's tiled
// forward, which this replaces on that route, ran one block per (64-query
// tile, h, b), streamed K and V twice (max and sum, then P.V) over all 256
// keys through unswizzled WMMA tiles with a block barrier at every step.
//
// Design: read each needed byte once and no other byte.
// - Padded key tiles are skipped. A block owns one (b, h) (grid H x B, four
//   warps). Every warp reads the row's mask (1 KB, all loads issued before
//   use) and ballots it into 16 tiles of 16 keys; a tile with no real key
//   is neither loaded nor multiplied. That is exact whenever the row has a
//   real key: exp(-1e9 - max) is exactly 0 in fp32, so such a key adds
//   exactly 0 to the sum and to P.V, and its probability rounds to bf16 0.
//   A row with no real key keeps every tile: there every score is -1e9 and
//   the reference gives 1/L over its L keys. Inside a kept tile keys are
//   masked one by one (the mask need not be a prefix; the test is != 0):
//   each kept tile's 16 fills (0 for a real key, -1e9 for a masked one,
//   -inf past L: no weight, not even in an all-masked row) sit in shared
//   memory, and a score whose fill is not 0 is replaced by it, whatever
//   the product was.
// - Q, and K and V of the kept tiles, are read from device memory once per
//   (b, h): 16-byte cp.async into 64-byte rows of shared memory, the
//   16-byte chunk index xor-ed with the row's pair index so an ldmatrix's
//   eight rows hit eight bank groups. The mask loads go out first (the
//   key copies wait for them), then each warp's own query rows (row tiles
//   warp, warp + 4, ...), which overlap the rest. One block barrier, after
//   the copies; none in the key loop.
// - The depth order of Q.K^T is permuted so that one 16-byte shared load
//   gives a lane its fragments: lane (g, t) takes dims 8t..8t+7 of query
//   rows g and g + 8, whose four words are the A fragments of depth steps
//   0 (words 0, 1) and 1 (words 2, 3), and the same dims of key g as both
//   steps' B fragments. q is scaled in registers (bf16 product, rounded
//   once).
// - Products are mma.sync m16n8k16 (bf16 in, fp32 accumulate): two depth
//   steps for Q.K^T, four n-tiles of 8 dims for P.V, whose V fragments come
//   by ldmatrix.trans. Up to eight kept tiles (128 keys) a thread holds the
//   16-query tile's whole score row in registers (64 fp32), so the exact
//   max and sum come in one pass with no online rescale, and the
//   probabilities round to bf16 in registers: the score accumulator's
//   layout is P.V's A fragment. With more kept tiles (long pairs, or the
//   all-masked row) the scores are recomputed from shared memory in three
//   sweeps (max, sum, P.V), each with the same bits. Work past the kept
//   tiles is skipped per tile (a warp-uniform branch).
// - O leaves through 16-byte stores: the warp writes its accumulators into
//   the row tile's Q tile, free by then, and reads back 8 contiguous dims
//   of a row a lane.
//
// What binds it (tools/k5_d32_variants.py on an H100 SXM at 700 W, at the
// teacher's shape): about 2.6x the bound, and not the bytes. A block's
// row tiles take two thirds of its cycles (the fp32 softmax costs some 20
// instructions a score, expf half of them) and its prologue the rest (the
// mask, then the copies that wait for it); skipping the padded tiles
// saves 4x.
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attn_common.cuh"  // MASKED
#include "score_tile.cuh"   // allow_dynamic_smem, MAX_DEVICES

namespace cldrd_attn_d32 {

using bf16 = __nv_bfloat16;
using cldrd::allow_dynamic_smem;
using cldrd::MAX_DEVICES;

constexpr int D = 32;                   // head_dim of this route
constexpr int MAXL = 256;               // longest row of this route
constexpr int KT = 16;                  // keys a tile (a P.V depth step)
constexpr int MAX_TILES = MAXL / KT;    // 16
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int CH = 8;                   // kept tiles a sweep holds
constexpr int ROW_B = D * 2;            // bytes of a key or query row
constexpr int TILE_B = KT * ROW_B;      // 1 KB
constexpr unsigned FULL = 0xffffffffu;

// Q, K and V tiles and each kept slot's 16 score fills
__host__ __device__ constexpr int smem_bytes(int L) {
  return ((L + KT - 1) / KT) * (3 * TILE_B + KT * 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `chunk` (0-3) of key row `row` in 64-byte
// rows, the chunk xor-ed with (row / 2) % 4: the eight rows an ldmatrix
// reads at one chunk (two per 128-byte line) fill eight bank groups
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return row * ROW_B + ((chunk ^ ((row >> 1) & 3)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
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

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d[16 x 8] += a[16 x 16] . b[16 x 8], bf16 in, fp32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two bf16 times the bf16 scale, each rounded once to bf16: the fp32
// product of two bf16 values is exact, so this is the bf16 product
__device__ __forceinline__ uint32_t scale2(uint32_t w, float scale) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
  return pack_bf16(f.x * scale, f.y * scale);
}

// e / l from r = 1 / l with one exact correction (attention_sm90.cu's
// div_row): the correctly rounded quotient for e in [0, 1], l in [1, L]
__device__ __forceinline__ float div_row(float e, float l, float r) {
  const float q = e * r;
  return fmaf(fmaf(-q, l, e), r, q);
}

__device__ __forceinline__ uint32_t word(const uint4& u, int w) {
  return w == 0 ? u.x : w == 1 ? u.y : w == 2 ? u.z : u.w;
}

// A lane's shared-memory addresses at slot 0 (a slot adds TILE_B, a
// slot's fills 64): its K row (key g of the slot's first n-tile, chunk t;
// the second n-tile adds 512), its V row for ldmatrix (key mr + 8 (mi & 1),
// chunk mi >> 1; chunks 2 and 3 at address ^ 32), and its four fills
struct Lane {
  uint32_t k, v, fill;
};

// Scores of one sweep: the kept tiles c0 .. c0 + CH - 1 (slots past
// `nkept` are neither read nor written). The m16n8 accumulator's element
// e is row g + 8 * (e >> 1), key 2t + (e & 1) of its 8-key n-tile; `fill`
// holds the slot's 0 / -1e9 / -inf for keys 2t, 2t + 1, 2t + 8, 2t + 9.
__device__ __forceinline__ void sweep_scores(float (&s)[2 * CH][4],
                                             const uint32_t (&qa)[2][4],
                                             const Lane& a, int c0,
                                             int nkept) {
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int slot = c0 + j;
    if (slot >= nkept) break;  // warp-uniform
    const float4 fill = lds16f(a.fill + slot * 64);
#pragma unroll
    for (int hn = 0; hn < 2; ++hn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[2 * j + hn][e] = 0.f;
      // key 8hn + g of the slot, dims 8t..8t+7: both depth steps' B
      const uint4 kb = lds16(a.k + slot * TILE_B + hn * 512);
      mma16816(s[2 * j + hn], qa[0], kb.x, kb.y);
      mma16816(s[2 * j + hn], qa[1], kb.z, kb.w);
      const float f0 = hn ? fill.z : fill.x, f1 = hn ? fill.w : fill.y;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float f = (e & 1) ? f1 : f0;
        s[2 * j + hn][e] = f == 0.f ? s[2 * j + hn][e] : f;
      }
    }
  }
}

__device__ __forceinline__ void sweep_max(const float (&s)[2 * CH][4],
                                          int c0, int nkept, float (&m)[2]) {
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    if (c0 + j >= nkept) break;  // warp-uniform
#pragma unroll
    for (int hn = 0; hn < 2; ++hn)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        m[e >> 1] = fmaxf(m[e >> 1], s[2 * j + hn][e]);
  }
}

// s <- exp(s - max) over the kept slots, summed into l (per thread, in
// key order)
__device__ __forceinline__ void sweep_exp(float (&s)[2 * CH][4], int c0,
                                          int nkept, const float (&m)[2],
                                          float (&l)[2]) {
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    if (c0 + j >= nkept) break;  // warp-uniform
#pragma unroll
    for (int hn = 0; hn < 2; ++hn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[2 * j + hn][e] = expf(s[2 * j + hn][e] - m[e >> 1]);
        l[e >> 1] += s[2 * j + hn][e];
      }
  }
}

// o += P . V over the sweep's kept slots, the probs e / l rounded to bf16
// as P.V's A fragments: slot j takes n-tiles 2j (a0 rows g, a1 rows g + 8)
// and 2j + 1 (a2, a3)
__device__ __forceinline__ void sweep_pv(const float (&s)[2 * CH][4],
                                         float (&o)[D / 8][4], const Lane& a,
                                         int c0, int nkept,
                                         const float (&l)[2],
                                         const float (&rl)[2]) {
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int slot = c0 + j;
    if (slot >= nkept) break;  // warp-uniform
    uint32_t pa[4];
#pragma unroll
    for (int hn = 0; hn < 2; ++hn)
#pragma unroll
      for (int x = 0; x < 2; ++x)
        pa[2 * hn + x] =
            pack_bf16(div_row(s[2 * j + hn][2 * x], l[x], rl[x]),
                      div_row(s[2 * j + hn][2 * x + 1], l[x], rl[x]));
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      uint32_t bv[4];  // keys 0-7 / 8-15 at chunk n, then n + 1
      ldsm_x4_t((a.v + slot * TILE_B) ^ (n << 4), bv);
      mma16816(o[n], pa, bv[0], bv[1]);
      mma16816(o[n + 1], pa, bv[2], bv[3]);
    }
  }
}

// the row sums over a lane quad, and their correctly rounded reciprocals
__device__ __forceinline__ void quad_sum(float (&l)[2], float (&rl)[2]) {
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    l[x] += __shfl_xor_sync(FULL, l[x], 1);
    l[x] += __shfl_xor_sync(FULL, l[x], 2);
    rl[x] = __frcp_rn(l[x]);
  }
}

__device__ __forceinline__ void quad_max(float (&m)[2]) {
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    m[x] = fmaxf(m[x], __shfl_xor_sync(FULL, m[x], 1));
    m[x] = fmaxf(m[x], __shfl_xor_sync(FULL, m[x], 2));
  }
}

__global__ void __launch_bounds__(THREADS, 4)
attn_infer_d32_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const int* __restrict__ mask, bf16* __restrict__ out,
                      int L, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = lane >> 2, t = lane & 3;
  const int ntile = (L + KT - 1) / KT;
  const long long row0 = (long long)b * L;
  const long long stride = (long long)H * D;  // elements between tokens
  const uint32_t sQ = smem_u32(smem), sK = sQ + ntile * TILE_B;
  const uint32_t sV = sK + ntile * TILE_B, sB = sV + ntile * TILE_B;

  // the row's mask first (the key copies wait for it), then this warp's
  // query row tiles (warp + WARPS * i), whose copies need nothing and
  // overlap the rest; rows past L as zeros
  int mv[MAXL / 32];
#pragma unroll
  for (int r = 0; r < MAXL / 32; ++r) {
    const int key = r * 32 + lane;
    mv[r] = key < L ? mask[row0 + key] : 0;
  }
  for (int rt = warp; rt < ntile; rt += WARPS)
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int row = rt * KT + (lane >> 2) + 8 * x, c = lane & 3;
      const bool ok = row < L;
      cp_async16(sQ + swz(row, c),
                 q + (row0 + (ok ? row : 0)) * stride + h * D + c * 8, ok);
    }
  // lane j (< ntile) holds tile j's real keys as 16 bits
  uint32_t real = 0;
#pragma unroll
  for (int r = 0; r < MAXL / 32; ++r) {
    const uint32_t bal = __ballot_sync(FULL, mv[r] != 0);
    if (lane == 2 * r) real = bal & 0xffffu;
    if (lane == 2 * r + 1) real = bal >> 16;
  }
  // kept tiles: those with a real key, or every tile of a row with none
  const bool any = __any_sync(FULL, real != 0);
  const uint32_t kept =
      __ballot_sync(FULL, lane < ntile && (real != 0 || !any));
  const int nkept = __popc(kept);
  // lane s (< nkept) takes the s-th kept tile
  int tile = 0;
  for (int j = 0, c = 0; j < MAX_TILES; ++j)
    if ((kept >> j) & 1u) {
      if (c == lane) tile = j;
      ++c;
    }
  const uint32_t slot_real = __shfl_sync(FULL, real, tile);

  // each kept slot's scores where not the product: 0 for a real key (the
  // product stands), -1e9 for a masked one, -inf past L; laid out so lane
  // (g, t) reads keys 2t, 2t + 1, 2t + 8, 2t + 9 as one 16-byte vector
  for (int slot = warp; slot < MAX_TILES; slot += WARPS) {
    const uint32_t re = __shfl_sync(FULL, slot_real, slot);
    const int tl = __shfl_sync(FULL, tile, slot);
    if (slot < nkept && lane < KT) {
      const float f = tl * KT + lane >= L ? -INFINITY
                      : ((re >> lane) & 1u) ? 0.f
                                            : cldrd_attn::MASKED;
      st_shared_f32(sB + slot * 64 + ((lane & 7) >> 1) * 16 +
                        ((lane & 1) + 2 * (lane >> 3)) * 4,
                    f);
    }
  }

  // K and V of the kept tiles: slot s at rows 16s .. 16s + 15
  for (int base = warp * 32; base < nkept * KT * 4; base += THREADS) {
    const int i = base + lane, slot = i >> 6, row = (i >> 2) & (KT - 1);
    const int c = i & 3;
    const int key = __shfl_sync(FULL, tile, slot) * KT + row;
    const bool ok = key < L;
    const long long off = (row0 + (ok ? key : 0)) * stride + h * D + c * 8;
    cp_async16(sK + swz(slot * KT + row, c), k + off, ok);
    cp_async16(sV + swz(slot * KT + row, c), v + off, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix row addresses
  // swz's xor term is (g / 2) % 4 for rows g and g + 8 of any tile, and
  // (mr / 2) % 4 for ldmatrix's rows
  const int xg = (g >> 1) & 3;
  const Lane a = {sK + g * ROW_B + ((t ^ xg) << 4),
                  sV + (mr + 8 * (mi & 1)) * ROW_B +
                      (((mi >> 1) ^ ((mr >> 1) & 3)) << 4),
                  sB + t * 16};
  for (int rt = warp; rt < ntile; rt += WARPS) {
    // q scaled in bf16 as A fragments: rows g (a0, a2) and g + 8 (a1,
    // a3), dims 8t..8t+7; depth step ks takes words 2ks and 2ks + 1
    const uint32_t qrow = sQ + rt * TILE_B + g * ROW_B;
    const uint4 r0 = lds16(qrow + ((t ^ xg) << 4));
    const uint4 r1 = lds16(qrow + 8 * ROW_B + ((t ^ xg) << 4));
    uint32_t qa[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      qa[ks][0] = scale2(word(r0, 2 * ks), scale);
      qa[ks][1] = scale2(word(r1, 2 * ks), scale);
      qa[ks][2] = scale2(word(r0, 2 * ks + 1), scale);
      qa[ks][3] = scale2(word(r1, 2 * ks + 1), scale);
    }
    float s[2 * CH][4], o[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    // the exact row max (a row lives in a lane quad), the sum of
    // exp(s - max), then P.V
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, rl[2];
    if (nkept <= CH) {  // one sweep: the score row stays in registers
      sweep_scores(s, qa, a, 0, nkept);
      sweep_max(s, 0, nkept, m);
      quad_max(m);
      sweep_exp(s, 0, nkept, m, l);
      quad_sum(l, rl);
      sweep_pv(s, o, a, 0, nkept, l, rl);
    } else {  // past 128 kept keys: the scores recomputed each sweep
      for (int c0 = 0; c0 < nkept; c0 += CH) {
        sweep_scores(s, qa, a, c0, nkept);
        sweep_max(s, c0, nkept, m);
      }
      quad_max(m);
      for (int c0 = 0; c0 < nkept; c0 += CH) {
        sweep_scores(s, qa, a, c0, nkept);
        sweep_exp(s, c0, nkept, m, l);
      }
      quad_sum(l, rl);
      for (int c0 = 0; c0 < nkept; c0 += CH) {
        float unused[2] = {0.f, 0.f};
        sweep_scores(s, qa, a, c0, nkept);
        sweep_exp(s, c0, nkept, m, unused);
        sweep_pv(s, o, a, c0, nkept, l, rl);
      }
    }
    // out through the row tile's Q tile, now free: lane (g, t) writes
    // dims 8n + 2t, +1 of rows g and g + 8 at chunk n, then reads back
    // chunk t (dims 8t..8t+7) of both rows for one 16-byte store each
    __syncwarp();
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        st_shared_u32(qrow + x * 8 * ROW_B + ((n ^ xg) << 4) + t * 4,
                      pack_bf16(o[n][2 * x], o[n][2 * x + 1]));
    __syncwarp();
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int r = rt * KT + g + 8 * x;
      const uint4 row = lds16(qrow + x * 8 * ROW_B + ((t ^ xg) << 4));
      if (r < L)
        *reinterpret_cast<uint4*>(out + (row0 + r) * stride + h * D +
                                  t * 8) = row;
    }
  }
}

}  // namespace cldrd_attn_d32

// C entry point for ctypes; returns a cudaError_t (0 on success).
// q/k/v/out [B, L, H, 32] bf16, contiguous, 16-byte aligned; mask [B, L]
// int32 (!= 0: a real token); scale = bf16(1/sqrt(32)) as a float.
extern "C" int attn_infer_d32_launch(const void* q, const void* k,
                                     const void* v, const int* mask,
                                     void* out, int B, int L, int H,
                                     float scale, void* stream) {
  using namespace cldrd_attn_d32;
  if (B <= 0 || B > 65535 || L <= 0 || L > MAXL || H <= 0)
    return (int)cudaErrorInvalidValue;
  static bool smem_set[MAX_DEVICES] = {};
  const cudaError_t e =
      allow_dynamic_smem(attn_infer_d32_kernel, smem_bytes(MAXL), smem_set);
  if (e != cudaSuccess) return (int)e;
  attn_infer_d32_kernel<<<dim3(H, B), THREADS, smem_bytes(L),
                          (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), mask, static_cast<bf16*>(out), L, H,
      scale);
  return (int)cudaGetLastError();
}

// Blocks of the kernel resident on one SM at rows of L (registers and
// shared memory as built), or -1 on a CUDA error.
extern "C" int attn_infer_d32_blocks_per_sm(int L) {
  using namespace cldrd_attn_d32;
  static bool smem_set[MAX_DEVICES] = {};
  int n = 0;
  if (L <= 0 || L > MAXL ||
      allow_dynamic_smem(attn_infer_d32_kernel, smem_bytes(MAXL),
                         smem_set) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, attn_infer_d32_kernel, THREADS, smem_bytes(L)) != cudaSuccess)
    return -1;
  return n;
}
