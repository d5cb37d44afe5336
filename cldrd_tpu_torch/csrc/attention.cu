// K3/K5: fused attention forward, K4: its backward, for the encoders'
// training and encode paths: the route for fp32, head_dim 32 and rows of
// 256 < L <= 512 (ops/attention.py::_kernel_route). On the main path its
// forward takes the MiniLM-L6 cross-encoder teacher's K5 launches (bf16,
// head_dim 32, B=128, L=256: five a teacher batch, in
// cli.create_training_data, cli.rerank_eval --mode cross and serve's
// rerank stage); bf16 training launches with head_dim 64 and L <= 256
// take attention_sm90.cu, and bf16 head_dim-64 K5 launches take
// attention_infer.cu (L <= 64) or attention_sm90.cu's forward
// (64 < L <= 256).
//
// Replaces the TPU kernels cldrd_tpu/ops/attention.py::
//   _train_fwd_kernel_factory (K3, launched by _train_fwd),
//   _train_bwd_kernel_factory (K4, launched by _train_bwd),
//   _attention_kernel         (K5, launched by _pallas_attention; K5 is
//                              K3's instance with no dropout and no
//                              segments).
// Layout [B, L, H, D] (the JAX package's), D in {32, 64}, L <= 512,
// bf16 or fp32. Per (batch row b, head h), with s = (q * scale) . k^T in
// fp32 (q scaled in the compute dtype):
//   masked keys (mask == 0, or seg_q != seg_k with segments) score -1e9,
//   probs = (exp(s - max) / sum) rounded to the compute dtype,
//   dropout: keep = hash(((b*H + h)*L + q)*L + k, seed) (murmur3-style
//     finalizer, uint32), probs_d = keep ? probs * inv : 0 (inv in the
//     compute dtype), out = probs_d . v with fp32 accumulation.
// Backward: dv = probs_d^T g; dp = (g . v^T) * keep * inv32;
//   ds = probs * (dp - rowsum(dp * probs)) rounded to the compute dtype;
//   dq = (ds . k) * scale, dk = (ds^T . q) * scale (q unscaled).
//
// Bound on an H100 SXM at the passage tower's shape (B=240, H=12, L=256,
// D=64, bf16): the forward moves 377 MB (0.113 ms at 3.35 TB/s) against
// 48.3 GFLOP (0.049 ms at 989 TFLOP/s), the backward 661 MB against
// 120.8 GFLOP, so bytes bind both. The design keeps every [L, L] score,
// probability and dropout mask out of device memory: the dropout bits are
// recomputed from the element index in both directions, and per-row
// softmax statistics (max, sum: 8 bytes a row) are the only residual.
//
// Design (a first version; right before fast):
// - forward: one block per (64-query tile, h, b), 4 warps of 16 query
//   rows; K and V stream through shared memory in 64-key tiles, twice:
//   pass 1 keeps each row's running max and sum, pass 2 forms the probs
//   and accumulates P.V. bf16 products run on the tensor cores (WMMA
//   16x16x16, fp32 accumulation), fp32 ones as plain FMA (no TF32).
// - backward, two kernels, no atomics, so results do not change from run
//   to run: (a) one block per query tile computes rowsum(dp * probs) and
//   dq; (b) one block per 64-key tile walks every query tile and sums dk
//   and dv in registers. Scores are recomputed with the same tile
//   operands as the forward, so the probs are the forward's bit for bit.
#include <math.h>

#include "attn_common.cuh"  // hash_keep, masked_score, MASKED
#include "score_tile.cuh"   // allow_dynamic_smem, MAX_DEVICES

namespace cldrd_attn {

using namespace nvcuda;
using cldrd::allow_dynamic_smem;
using cldrd::MAX_DEVICES;

constexpr int TQ = 64;   // query rows per tile
constexpr int TK = 64;   // key rows per tile
constexpr int NT = 128;  // threads per block: 4 warps x 16 rows
constexpr int SLD = TK + 4;  // fp32 stride of a warp's 16 x 64 tile

template <typename T>
struct Tr;
template <>
struct Tr<float> {
  static constexpr int PAD = 1;  // conflict-free column reads
  static constexpr bool MMA = false;
};
template <>
struct Tr<__nv_bfloat16> {
  static constexpr int PAD = 8;  // WMMA ld: a multiple of 8 elements
  static constexpr bool MMA = true;
};

__device__ __forceinline__ float tof(float x) { return x; }
__device__ __forceinline__ float tof(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T fromf(float x);
template <>
__device__ __forceinline__ float fromf<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 fromf<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__host__ __device__ constexpr int align128(int bytes) {
  return (bytes + 127) / 128 * 128;
}

// rows [l0, l0 + 64) of head h, batch row b of a [B, L, H, D] tensor into
// dst[r * (D + PAD) + d]; rows past L load as zeros; `scale` multiplies in
// the compute dtype when nonzero
template <typename T, int D>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, int b,
                                          int h, int L, int H, int l0,
                                          T* dst, float scale) {
  constexpr int LD = D + Tr<T>::PAD;
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, d = i % D;
    const int l = l0 + r;
    T val = fromf<T>(0.f);
    if (l < L) {
      val = src[(((long long)b * L + l) * H + h) * D + d];
      if (scale != 0.f) val = fromf<T>(tof(val) * scale);
    }
    dst[r * LD + d] = val;
  }
}

// S[16 x 64] = A[16 x D] . B[64 x D]^T for one warp (A rows and B rows
// row-major with stride D + PAD), into Sw[r * SLD + c]
template <typename T, int D>
__device__ __forceinline__ void warp_abt(const T* __restrict__ A,
                                         const T* __restrict__ Bm,
                                         float* Sw) {
  constexpr int LD = D + Tr<T>::PAD;
  if constexpr (Tr<T>::MMA) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[TK / 16];
#pragma unroll
    for (int j = 0; j < TK / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::load_matrix_sync(a, A + kk, LD);
#pragma unroll
      for (int j = 0; j < TK / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> bf;
        wmma::load_matrix_sync(bf, Bm + j * 16 * LD + kk, LD);
        wmma::mma_sync(acc[j], a, bf, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < TK / 16; ++j)
      wmma::store_matrix_sync(Sw + j * 16, acc[j], SLD, wmma::mem_row_major);
  } else {
    const int lane = threadIdx.x % 32;
    float acc[16][2];
#pragma unroll
    for (int r = 0; r < 16; ++r) acc[r][0] = acc[r][1] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float b0 = tof(Bm[lane * LD + d]);
      const float b1 = tof(Bm[(lane + 32) * LD + d]);
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float a = tof(A[r * LD + d]);
        acc[r][0] = fmaf(a, b0, acc[r][0]);
        acc[r][1] = fmaf(a, b1, acc[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      Sw[r * SLD + lane] = acc[r][0];
      Sw[r * SLD + lane + 32] = acc[r][1];
    }
  }
  __syncwarp();
}

// A warp's fp32 accumulator of a [16 x D] output tile
template <typename T, int D>
struct RowAcc;

template <int D>
struct RowAcc<__nv_bfloat16, D> {
  using T = __nv_bfloat16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> f[D / 16];
  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(f[j], 0.0f);
  }
  // += A[16 x 64] (row-major, lda) . Bm[64 x D] (row-major, ldb)
  __device__ void ab(const T* A, int lda, const T* Bm, int ldb) {
#pragma unroll
    for (int kk = 0; kk < 64; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
      wmma::load_matrix_sync(a, A + kk, lda);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bf;
        wmma::load_matrix_sync(bf, Bm + kk * ldb + j * 16, ldb);
        wmma::mma_sync(f[j], a, bf, f[j]);
      }
    }
  }
  // += A^T . Bm, A[64 x 16] row-major (lda) read as its transpose
  __device__ void atb(const T* A, int lda, const T* Bm, int ldb) {
#pragma unroll
    for (int kk = 0; kk < 64; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::col_major> a;
      wmma::load_matrix_sync(a, A + kk * lda, lda);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bf;
        wmma::load_matrix_sync(bf, Bm + kk * ldb + j * 16, ldb);
        wmma::mma_sync(f[j], a, bf, f[j]);
      }
    }
  }
  __device__ void store(float* dst) {  // dst[r * SLD + d]
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      wmma::store_matrix_sync(dst + j * 16, f[j], SLD, wmma::mem_row_major);
    __syncwarp();
  }
};

template <int D>
struct RowAcc<float, D> {
  static constexpr int C = D / 32;  // columns per lane: lane + 32c
  float f[16][C];
  __device__ void zero() {
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) f[r][c] = 0.f;
  }
  __device__ void ab(const float* A, int lda, const float* Bm, int ldb) {
    const int lane = threadIdx.x % 32;
    for (int kk = 0; kk < 64; ++kk) {
      float bv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) bv[c] = Bm[kk * ldb + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float a = A[r * lda + kk];
#pragma unroll
        for (int c = 0; c < C; ++c) f[r][c] = fmaf(a, bv[c], f[r][c]);
      }
    }
  }
  __device__ void atb(const float* A, int lda, const float* Bm, int ldb) {
    const int lane = threadIdx.x % 32;
    for (int kk = 0; kk < 64; ++kk) {
      float bv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) bv[c] = Bm[kk * ldb + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float a = A[kk * lda + r];
#pragma unroll
        for (int c = 0; c < C; ++c) f[r][c] = fmaf(a, bv[c], f[r][c]);
      }
    }
  }
  __device__ void store(float* dst) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) dst[r * SLD + lane + 32 * c] = f[r][c];
    __syncwarp();
  }
};

// key-tile metadata: kmask[i] = mask value (-1 past L), kseg[i] = segment
__device__ __forceinline__ void load_key_meta(const int* __restrict__ mask,
                                              const int* __restrict__ seg,
                                              int b, int L, int k0,
                                              int* kmask, int* kseg) {
  for (int i = threadIdx.x; i < TK; i += NT) {
    const int l = k0 + i;
    kmask[i] = l < L ? (mask[(long long)b * L + l] != 0) : -1;
    kseg[i] = (seg != nullptr && l < L) ? seg[(long long)b * L + l] : 0;
  }
}

// shared memory of one tile [64 x (D + PAD)] of T, 128-byte aligned
template <typename T, int D>
__host__ __device__ constexpr int tile_bytes() {
  return align128(64 * (D + Tr<T>::PAD) * (int)sizeof(T));
}
__host__ __device__ constexpr int warp_f32_bytes() {
  return align128(4 * 16 * SLD * 4);
}
template <typename T>
__host__ __device__ constexpr int ptile_bytes() {  // [64 x (64 + PAD)] of T
  return align128(64 * (TK + Tr<T>::PAD) * (int)sizeof(T));
}
__host__ __device__ constexpr int meta_bytes() {
  return align128(8 * 64 * 4);
}

// ------------------------------------------------------------- forward

template <typename T, int D>
__host__ __device__ constexpr int fwd_smem() {
  return 3 * tile_bytes<T, D>() + warp_f32_bytes() + ptile_bytes<T>() +
         meta_bytes();
}

template <typename T, int D, bool DROP, bool SEG>
__global__ void __launch_bounds__(NT)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const int* __restrict__ mask,
                const int* __restrict__ seg, T* __restrict__ out,
                float* __restrict__ stats, int L, int H, uint32_t seed,
                float p, float inv, float scale) {
  constexpr int LD = D + Tr<T>::PAD;
  constexpr int PLD = TK + Tr<T>::PAD;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = reinterpret_cast<T*>(smem + tile_bytes<T, D>());
  T* Vs = reinterpret_cast<T*>(smem + 2 * tile_bytes<T, D>());
  float* S = reinterpret_cast<float*>(smem + 3 * tile_bytes<T, D>());
  T* P = reinterpret_cast<T*>(smem + 3 * tile_bytes<T, D>() +
                              warp_f32_bytes());
  int* kmask = reinterpret_cast<int*>(smem + 3 * tile_bytes<T, D>() +
                                      warp_f32_bytes() + ptile_bytes<T>());
  int* kseg = kmask + 64;
  int* qseg = kmask + 128;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * TQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* Qw = Qs + warp * 16 * LD;
  float* Sw = S + warp * 16 * SLD;
  T* Pw = P + warp * 16 * PLD;

  load_rows<T, D>(q, b, h, L, H, q0, Qs, scale);
  for (int i = threadIdx.x; i < TQ; i += NT)
    qseg[i] = (SEG && q0 + i < L) ? seg[(long long)b * L + q0 + i] : 0;

  float m[16], l[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  const int nkt = (L + TK - 1) / TK;
  // pass 1: each row's running max and sum
  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();
    load_rows<T, D>(k, b, h, L, H, kt * TK, Ks, 0.f);
    load_key_meta(mask, SEG ? seg : nullptr, b, L, kt * TK, kmask, kseg);
    __syncthreads();
    warp_abt<T, D>(Qw, Ks, Sw);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int qs = qseg[warp * 16 + r];
      const float s0 = masked_score<SEG>(Sw[r * SLD + lane], kmask[lane],
                                         kseg[lane], qs);
      const float s1 = masked_score<SEG>(Sw[r * SLD + lane + 32],
                                         kmask[lane + 32], kseg[lane + 32],
                                         qs);
      const float mn = fmaxf(m[r], warp_max(fmaxf(s0, s1)));
      l[r] = l[r] * expf(m[r] - mn) +
             warp_sum(expf(s0 - mn) + expf(s1 - mn));
      m[r] = mn;
    }
  }
  // pass 2: probs (rounded to T), dropout, P.V
  RowAcc<T, D> o;
  o.zero();
  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();
    load_rows<T, D>(k, b, h, L, H, kt * TK, Ks, 0.f);
    load_rows<T, D>(v, b, h, L, H, kt * TK, Vs, 0.f);
    load_key_meta(mask, SEG ? seg : nullptr, b, L, kt * TK, kmask, kseg);
    __syncthreads();
    warp_abt<T, D>(Qw, Ks, Sw);
#pragma unroll  // m[] and l[] stay in registers
    for (int r = 0; r < 16; ++r) {
      const int qs = qseg[warp * 16 + r];
      const uint32_t qrow = (uint32_t)(q0 + warp * 16 + r);
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        const int c = lane + 32 * c2;
        const float s = masked_score<SEG>(Sw[r * SLD + c], kmask[c],
                                          kseg[c], qs);
        T pt = fromf<T>(expf(s - m[r]) / l[r]);
        if (DROP) {
          const uint32_t idx =
              (((uint32_t)b * (uint32_t)H + (uint32_t)h) * (uint32_t)L +
               qrow) * (uint32_t)L + (uint32_t)(kt * TK + c);
          pt = hash_keep(idx, seed, p) ? fromf<T>(tof(pt) * inv)
                                       : fromf<T>(0.f);
        }
        Pw[r * PLD + c] = pt;
      }
    }
    __syncwarp();
    o.ab(Pw, PLD, Vs, LD);
  }
  o.store(Sw);
  for (int r = 0; r < 16; ++r) {
    const int qrow = q0 + warp * 16 + r;
    if (qrow >= L) continue;
    for (int d = lane; d < D; d += 32)
      out[(((long long)b * L + qrow) * H + h) * D + d] =
          fromf<T>(Sw[r * SLD + d]);
    if (stats != nullptr && lane == 0) {
      const long long row = ((long long)b * H + h) * L + qrow;
      stats[2 * row] = m[r];
      stats[2 * row + 1] = l[r];
    }
  }
}

// ------------------------------------------------- backward (a): dq, rowsum

template <typename T, int D>
__host__ __device__ constexpr int bwd_dq_smem() {
  return 4 * tile_bytes<T, D>() + 2 * warp_f32_bytes() + ptile_bytes<T>() +
         meta_bytes();
}

template <typename T, int D, bool DROP, bool SEG>
__global__ void __launch_bounds__(NT)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ mask,
                   const int* __restrict__ seg, const T* __restrict__ g,
                   const float* __restrict__ stats, T* __restrict__ dq,
                   float* __restrict__ dsum, int L, int H, uint32_t seed,
                   float p, float inv32, float scale, float scale32) {
  constexpr int LD = D + Tr<T>::PAD;
  constexpr int PLD = TK + Tr<T>::PAD;
  constexpr int TB = tile_bytes<T, D>();
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Gs = reinterpret_cast<T*>(smem + TB);
  T* Ks = reinterpret_cast<T*>(smem + 2 * TB);
  T* Vs = reinterpret_cast<T*>(smem + 3 * TB);
  float* S = reinterpret_cast<float*>(smem + 4 * TB);
  float* DP = reinterpret_cast<float*>(smem + 4 * TB + warp_f32_bytes());
  T* P = reinterpret_cast<T*>(smem + 4 * TB + 2 * warp_f32_bytes());
  int* kmask = reinterpret_cast<int*>(smem + 4 * TB + 2 * warp_f32_bytes() +
                                      ptile_bytes<T>());
  int* kseg = kmask + 64;
  int* qseg = kmask + 128;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * TQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* Sw = S + warp * 16 * SLD;
  float* DPw = DP + warp * 16 * SLD;
  T* Pw = P + warp * 16 * PLD;

  load_rows<T, D>(q, b, h, L, H, q0, Qs, scale);
  load_rows<T, D>(g, b, h, L, H, q0, Gs, 0.f);
  for (int i = threadIdx.x; i < TQ; i += NT)
    qseg[i] = (SEG && q0 + i < L) ? seg[(long long)b * L + q0 + i] : 0;
  float m[16], l[16], part[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int qrow = q0 + warp * 16 + r;
    const long long row = ((long long)b * H + h) * L + qrow;
    m[r] = qrow < L ? stats[2 * row] : 0.f;
    l[r] = qrow < L ? stats[2 * row + 1] : 1.f;
    part[r] = 0.f;
  }
  const int nkt = (L + TK - 1) / TK;

  // the probs and masked dp of key tile kt at (row r, column c)
  auto probs_dp = [&](int kt, int r, int c, float& pf, float& dp) {
    const int qs = qseg[warp * 16 + r];
    const float s = masked_score<SEG>(Sw[r * SLD + c], kmask[c], kseg[c],
                                      qs);
    pf = tof(fromf<T>(expf(s - m[r]) / l[r]));
    dp = DPw[r * SLD + c];
    if (DROP) {
      const uint32_t qrow = (uint32_t)(q0 + warp * 16 + r);
      const uint32_t idx =
          (((uint32_t)b * (uint32_t)H + (uint32_t)h) * (uint32_t)L + qrow) *
              (uint32_t)L + (uint32_t)(kt * TK + c);
      dp = hash_keep(idx, seed, p) ? dp * inv32 : 0.f;
    }
  };

  for (int pass = 0; pass < 2; ++pass) {
    RowAcc<T, D> acc;
    acc.zero();
    for (int kt = 0; kt < nkt; ++kt) {
      __syncthreads();
      load_rows<T, D>(k, b, h, L, H, kt * TK, Ks, 0.f);
      load_rows<T, D>(v, b, h, L, H, kt * TK, Vs, 0.f);
      load_key_meta(mask, SEG ? seg : nullptr, b, L, kt * TK, kmask, kseg);
      __syncthreads();
      warp_abt<T, D>(Qs + warp * 16 * LD, Ks, Sw);
      warp_abt<T, D>(Gs + warp * 16 * LD, Vs, DPw);
#pragma unroll  // m[], l[] and part[] stay in registers
      for (int r = 0; r < 16; ++r) {
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2) {
          const int c = lane + 32 * c2;
          float pf, dp;
          probs_dp(kt, r, c, pf, dp);
          if (pass == 0)
            part[r] += dp * pf;
          else
            Pw[r * PLD + c] = fromf<T>(pf * (dp - part[r]));
        }
      }
      if (pass == 1) {
        __syncwarp();
        acc.ab(Pw, PLD, Ks, LD);
      }
    }
    if (pass == 0) {
#pragma unroll
      for (int r = 0; r < 16; ++r) part[r] = warp_sum(part[r]);
    } else {
      acc.store(Sw);
      for (int r = 0; r < 16; ++r) {
        const int qrow = q0 + warp * 16 + r;
        if (qrow >= L) continue;
        for (int d = lane; d < D; d += 32)
          dq[(((long long)b * L + qrow) * H + h) * D + d] =
              fromf<T>(Sw[r * SLD + d] * scale32);
        if (lane == 0) dsum[((long long)b * H + h) * L + qrow] = part[r];
      }
    }
  }
}

// ----------------------------------------------- backward (b): dk and dv

template <typename T, int D>
__host__ __device__ constexpr int bwd_dkv_smem() {
  return 5 * tile_bytes<T, D>() + 2 * warp_f32_bytes() +
         2 * ptile_bytes<T>() + meta_bytes();
}

template <typename T, int D, bool DROP, bool SEG>
__global__ void __launch_bounds__(NT)
attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ mask,
                    const int* __restrict__ seg, const T* __restrict__ g,
                    const float* __restrict__ stats,
                    const float* __restrict__ dsum, T* __restrict__ dk,
                    T* __restrict__ dv, int L, int H, uint32_t seed,
                    float p, float inv, float inv32, float scale,
                    float scale32) {
  constexpr int LD = D + Tr<T>::PAD;
  constexpr int PLD = TK + Tr<T>::PAD;
  constexpr int TB = tile_bytes<T, D>();
  constexpr int PB = ptile_bytes<T>();
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = reinterpret_cast<T*>(smem + TB);
  T* Qs = reinterpret_cast<T*>(smem + 2 * TB);  // scaled, for the scores
  T* Qr = reinterpret_cast<T*>(smem + 3 * TB);  // raw, for dk
  T* Gs = reinterpret_cast<T*>(smem + 4 * TB);
  float* S = reinterpret_cast<float*>(smem + 5 * TB);
  float* DP = reinterpret_cast<float*>(smem + 5 * TB + warp_f32_bytes());
  T* Pd = reinterpret_cast<T*>(smem + 5 * TB + 2 * warp_f32_bytes());
  T* Ds = reinterpret_cast<T*>(smem + 5 * TB + 2 * warp_f32_bytes() + PB);
  int* meta = reinterpret_cast<int*>(smem + 5 * TB + 2 * warp_f32_bytes() +
                                     2 * PB);
  int* kmask = meta;
  int* kseg = meta + 64;
  int* qseg = meta + 128;
  float* qm = reinterpret_cast<float*>(meta + 192);
  float* ql = qm + 64;
  float* qd = qm + 128;

  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * TK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* Sw = S + warp * 16 * SLD;
  float* DPw = DP + warp * 16 * SLD;

  load_rows<T, D>(k, b, h, L, H, k0, Ks, 0.f);
  load_rows<T, D>(v, b, h, L, H, k0, Vs, 0.f);
  load_key_meta(mask, SEG ? seg : nullptr, b, L, k0, kmask, kseg);

  RowAcc<T, D> dva, dka;  // this warp's 16 keys
  dva.zero();
  dka.zero();
  const int nqt = (L + TQ - 1) / TQ;
  for (int qt = 0; qt < nqt; ++qt) {
    const int q0 = qt * TQ;
    __syncthreads();
    load_rows<T, D>(q, b, h, L, H, q0, Qs, scale);
    load_rows<T, D>(q, b, h, L, H, q0, Qr, 0.f);
    load_rows<T, D>(g, b, h, L, H, q0, Gs, 0.f);
    for (int i = threadIdx.x; i < TQ; i += NT) {
      const int qrow = q0 + i;
      const long long row = ((long long)b * H + h) * L + qrow;
      const bool in = qrow < L;
      qseg[i] = (SEG && in) ? seg[(long long)b * L + qrow] : 0;
      qm[i] = in ? stats[2 * row] : 0.f;
      ql[i] = in ? stats[2 * row + 1] : 1.f;
      qd[i] = in ? dsum[row] : 0.f;
    }
    __syncthreads();
    // warp w: query rows 16w.. of this tile against the block's 64 keys,
    // with the forward's tile operands
    warp_abt<T, D>(Qs + warp * 16 * LD, Ks, Sw);
    warp_abt<T, D>(Gs + warp * 16 * LD, Vs, DPw);
    for (int r = 0; r < 16; ++r) {
      const int qi = warp * 16 + r;
      const uint32_t qrow = (uint32_t)(q0 + qi);
      const bool in = (int)qrow < L;
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        const int c = lane + 32 * c2;
        const float s = masked_score<SEG>(Sw[r * SLD + c], kmask[c],
                                          kseg[c], qseg[qi]);
        T pt = fromf<T>(in ? expf(s - qm[qi]) / ql[qi] : 0.f);
        T pd = pt;
        float dp = DPw[r * SLD + c];
        if (DROP) {
          const uint32_t idx =
              (((uint32_t)b * (uint32_t)H + (uint32_t)h) * (uint32_t)L +
               qrow) * (uint32_t)L + (uint32_t)(k0 + c);
          const bool keep = hash_keep(idx, seed, p);
          pd = keep ? fromf<T>(tof(pt) * inv) : fromf<T>(0.f);
          dp = keep ? dp * inv32 : 0.f;
        }
        const float pf = tof(pt);
        Pd[qi * PLD + c] = pd;
        Ds[qi * PLD + c] = fromf<T>(pf * (dp - qd[qi]));
      }
    }
    __syncthreads();
    // warp w: keys 16w..; dv += Pd^T g, dk += Ds^T q
    dva.atb(Pd + warp * 16, PLD, Gs, LD);
    dka.atb(Ds + warp * 16, PLD, Qr, LD);
  }
  for (int which = 0; which < 2; ++which) {
    if (which == 0)
      dva.store(Sw);
    else
      dka.store(Sw);
    for (int r = 0; r < 16; ++r) {
      const int krow = k0 + warp * 16 + r;
      if (krow >= L) continue;
      const long long base = (((long long)b * L + krow) * H + h) * D;
      for (int d = lane; d < D; d += 32) {
        const float x = Sw[r * SLD + d];
        if (which == 0)
          dv[base + d] = fromf<T>(x);
        else
          dk[base + d] = fromf<T>(x * scale32);
      }
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------- launch

template <typename T, int D, bool DROP, bool SEG>
struct Launch {
  static int fwd(const void* q, const void* k, const void* v, const int* mask,
                 const int* seg, void* out, float* stats, int B, int L, int H,
                 uint32_t seed, float p, float inv, float scale,
                 cudaStream_t stream) {
    static bool set[MAX_DEVICES] = {};
    auto kern = attn_fwd_kernel<T, D, DROP, SEG>;
    constexpr int smem = fwd_smem<T, D>();
    cudaError_t e = allow_dynamic_smem(kern, smem, set);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((L + TQ - 1) / TQ, H, B);
    kern<<<grid, NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), mask, seg, static_cast<T*>(out), stats, L,
        H, seed, p, inv, scale);
    return (int)cudaGetLastError();
  }
  static int bwd(const void* q, const void* k, const void* v,
                 const int* mask, const int* seg, const void* g,
                 const float* stats, void* dq, void* dk, void* dv,
                 float* dsum, int B, int L, int H, uint32_t seed, float p,
                 float inv, float inv32, float scale, float scale32,
                 cudaStream_t stream) {
    static bool set_a[MAX_DEVICES] = {}, set_b[MAX_DEVICES] = {};
    auto ka = attn_bwd_dq_kernel<T, D, DROP, SEG>;
    auto kb = attn_bwd_dkv_kernel<T, D, DROP, SEG>;
    constexpr int sa = bwd_dq_smem<T, D>();
    constexpr int sb = bwd_dkv_smem<T, D>();
    cudaError_t e = allow_dynamic_smem(ka, sa, set_a);
    if (e != cudaSuccess) return (int)e;
    e = allow_dynamic_smem(kb, sb, set_b);
    if (e != cudaSuccess) return (int)e;
    const T* qt = static_cast<const T*>(q);
    const T* kt = static_cast<const T*>(k);
    const T* vt = static_cast<const T*>(v);
    const T* gt = static_cast<const T*>(g);
    dim3 grid((L + TQ - 1) / TQ, H, B);
    ka<<<grid, NT, sa, stream>>>(qt, kt, vt, mask, seg, gt, stats,
                                 static_cast<T*>(dq), dsum, L, H, seed, p,
                                 inv32, scale, scale32);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    kb<<<grid, NT, sb, stream>>>(qt, kt, vt, mask, seg, gt, stats, dsum,
                                 static_cast<T*>(dk), static_cast<T*>(dv),
                                 L, H, seed, p, inv, inv32, scale, scale32);
    return (int)cudaGetLastError();
  }
};

template <typename T, int D, template <typename, int, bool, bool> class F>
struct Flags {
  template <typename Fn>
  static int run(bool drop, bool seg, Fn fn) {
    if (drop)
      return seg ? fn(F<T, D, true, true>{}) : fn(F<T, D, true, false>{});
    return seg ? fn(F<T, D, false, true>{}) : fn(F<T, D, false, false>{});
  }
};

// (dtype code, head dim, dropout, segments) -> Launch<...>; dtype codes as
// in score_tile.cuh (0 fp32, 1 bf16)
template <typename Fn>
int dispatch(int dtype, int D, bool drop, bool seg, Fn fn) {
  if (dtype == 1) {
    if (D == 64) return Flags<__nv_bfloat16, 64, Launch>::run(drop, seg, fn);
    if (D == 32) return Flags<__nv_bfloat16, 32, Launch>::run(drop, seg, fn);
  } else if (dtype == 0) {
    if (D == 64) return Flags<float, 64, Launch>::run(drop, seg, fn);
    if (D == 32) return Flags<float, 32, Launch>::run(drop, seg, fn);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace cldrd_attn

// C entry points for ctypes; each returns a cudaError_t (0 on success).
// q/k/v/out [B, L, H, D] contiguous in the dtype; mask and seg [B, L]
// int32 (seg NULL without segments); stats [B, H, L, 2] fp32 or NULL.
extern "C" int attn_fwd_launch(const void* q, const void* k, const void* v,
                               const int* mask, const int* seg, void* out,
                               float* stats, int dtype, int B, int L, int H,
                               int D, int seed, float p, float inv,
                               float scale, void* stream) {
  using namespace cldrd_attn;
  if (B <= 0 || L <= 0 || L > 512 || H <= 0 || p < 0.f || p >= 1.f)
    return (int)cudaErrorInvalidValue;
  return dispatch(dtype, D, p > 0.f, seg != nullptr, [&](auto l) {
    return decltype(l)::fwd(q, k, v, mask, seg, out, stats, B, L, H,
                            (uint32_t)seed, p, inv, scale,
                            (cudaStream_t)stream);
  });
}

// g, dq, dk, dv [B, L, H, D]; stats from attn_fwd_launch; dsum [B, H, L]
// fp32 scratch. Launches the dq kernel, then the dk/dv kernel.
extern "C" int attn_bwd_launch(const void* q, const void* k, const void* v,
                               const int* mask, const int* seg, const void* g,
                               const float* stats, void* dq, void* dk,
                               void* dv, float* dsum, int dtype, int B, int L,
                               int H, int D, int seed, float p, float inv,
                               float inv32, float scale, float scale32,
                               void* stream) {
  using namespace cldrd_attn;
  if (B <= 0 || L <= 0 || L > 512 || H <= 0 || p < 0.f || p >= 1.f)
    return (int)cudaErrorInvalidValue;
  return dispatch(dtype, D, p > 0.f, seg != nullptr, [&](auto l) {
    return decltype(l)::bwd(q, k, v, mask, seg, g, stats, dq, dk, dv, dsum,
                            B, L, H, (uint32_t)seed, p, inv, inv32, scale,
                            scale32, (cudaStream_t)stream);
  });
}
