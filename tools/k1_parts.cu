// Products-only variants of K1's score loop (csrc/extract_topk_sm90.cu),
// for measurement only: nothing in the port builds or calls this file.
// tools/k1_variants.py builds one library per variant and times them at
// K1's main-path shape (B=512 over an int8 store of 8,847,360 x 768 rows).
//
// Each variant computes every score of K1 (bf16 queries resident in
// shared memory as wgmma's B operand, the int8 store's rows widened in
// registers as the register-A operand, fp32 accumulation) and reduces a
// block's scores to one max a thread, written out so that no product is
// dead. There is no selection, hand-over or level 2. Two design choices
// vary:
// - QB, the queries of a block: 64 (K1's choice: a warpgroup takes a
//   whole 128-row bin as two m64n64k16 halves, warpgroups on alternate
//   bins) or 128 (m64n128k16: a warpgroup takes one 64-row half of every
//   bin, so every widened code feeds 128 queries and each super-block is
//   read by B/128 blocks). 128 resident queries take 192 KB at D=768.
// - MODE, how the rows reach the wgmma warps: LDG, they load them with
//   __ldg, two chunks ahead in registers (K1's choice); or a producer warp
//   copies each 64-deep chunk of the step's rows into a 4-stage
//   shared-memory ring, completion counted on a FULL mbarrier a stage and
//   release on an EMPTY one, and the wgmma warps read their 16 bytes a row
//   from the ring. The producer copies with one 2-D TMA copy a stage
//   (TMA), one 64-byte cp.async.bulk a row (BULK), or 16-byte cp.async
//   (CPASYNC).
#include <cuda.h>  // CUtensorMap (types only: the encoder is looked up)
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace k1_parts {

using bf16 = __nv_bfloat16;

constexpr int SUP_ROWS = 2048, BIN = 128, BINS = SUP_ROWS / BIN, KC = 64;
constexpr int STAGES = 4;
// NOWIDEN and NOMMA are LDG with a part taken out (QB=64 only): the codes
// go to the products unwidened (one xor a word), or the products are
// replaced by one addition a fragment. PRODUCTS keeps the products alone:
// fixed A fragments, no loads and no widening.
enum Mode {
  LDG = 0, TMA = 1, BULK = 2, CPASYNC = 3, NOWIDEN = 4, NOMMA = 5,
  PRODUCTS = 6
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}
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

#define P_ACC16(d, o)                                                      \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),           \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7]),       \
      "+f"(d[o + 8]), "+f"(d[o + 9]), "+f"(d[o + 10]), "+f"(d[o + 11]),     \
      "+f"(d[o + 12]), "+f"(d[o + 13]), "+f"(d[o + 14]), "+f"(d[o + 15])

__device__ __forceinline__ void mma_n64(float* d, const uint32_t* a,
                                        uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : P_ACC16(d, 0), P_ACC16(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc)
      : "memory");
}
__device__ __forceinline__ void mma_n128(float* d, const uint32_t* a,
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : P_ACC16(d, 0), P_ACC16(d, 16), P_ACC16(d, 32), P_ACC16(d, 48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc)
      : "memory");
}

// K1's widening: four int8 codes as two bf16x2, exactly
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
// the A fragments of one 64-row half's four k-steps from its two rows'
// 16 codes (K1's permuted depth order): a[s * 4 + reg]
__device__ __forceinline__ void half_to_a(uint4 r0, uint4 r1,
                                          uint32_t* a) {
  const uint32_t w0[4] = {r0.x, r0.y, r0.z, r0.w};
  const uint32_t w1[4] = {r1.x, r1.y, r1.z, r1.w};
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    widen4(w0[s], a[s * 4 + 0], a[s * 4 + 2]);
    widen4(w1[s], a[s * 4 + 1], a[s * 4 + 3]);
  }
}
__device__ __forceinline__ int chunk_position(int l) {
  const int s = l >> 4, r = l & 15;
  return 16 * ((r & 7) >> 1) + 4 * s + (r & 1) + 2 * (r >> 3);
}

// ------------------------------------------------------------ mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::
          "r"(bar)
      : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          bar),
      "r"(bytes)
      : "memory");
}
// waits for the phase of parity `parity` to complete; traps rather than
// hang if it never does
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (long long n = 0; !done; ++n) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (n > (1ll << 22)) __trap();
  }
}
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ----------------------------------------------------------------- kernel

// Rows a step reads: QB=64, two bins (one a warpgroup); QB=128, one bin
// (a 64-row half a warpgroup).
template <int QB>
__host__ __device__ constexpr int step_rows() {
  return QB == 64 ? 2 * BIN : BIN;
}

template <int QB, int MODE>
__global__ void __launch_bounds__(
    MODE == TMA || MODE == BULK || MODE == CPASYNC ? 288 : 256, 1)
parts_kernel(const bf16* __restrict__ q, const int8_t* __restrict__ c,
             float* __restrict__ out, int B, int nsup, int D,
             const __grid_constant__ CUtensorMap tmap) {
  constexpr bool RING = MODE == TMA || MODE == BULK || MODE == CPASYNC;
  constexpr int Q_TILE = QB * 128;
  constexpr int ROWS = step_rows<QB>();
  constexpr int STAGE = ROWS * KC;  // bytes of one ring stage
  constexpr int STEPS_PER_SUP = QB == 64 ? BINS / 2 : BINS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_base = smem_u32(smem_raw);
  const uint32_t base = (raw_base + 1023u) & ~1023u;
  const int NC = D / KC;
  const uint32_t sQ = base;
  const uint32_t sRing = base + NC * Q_TILE;
  const uint32_t sBar = sRing + (RING ? STAGES * STAGE : 0);  // full, empty
  unsigned char* ring_ptr = smem_raw + (sRing - raw_base);

  const int nqc = B / QB;
  const int qc = blockIdx.x % nqc;
  const long long sup = blockIdx.x / nqc;
  const int q0 = qc * QB;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2,
            t = lane & 3;

  for (int i = tid; i < QB * NC * 32; i += blockDim.x) {
    const int r = i / (NC * 32), k = (i / 32) % NC, l = 2 * (i % 32);
    const uint32_t v = *reinterpret_cast<const uint32_t*>(
        q + (long long)(q0 + r) * D + k * KC + chunk_position(l));
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(
                     sQ + k * Q_TILE + swz(r, l >> 3) + 2 * (l & 7)),
                 "r"(v)
                 : "memory");
  }
  if (RING && tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // full: the producer (CPASYNC: each of its lanes)
      mbar_init(sBar + 8 * s, MODE == CPASYNC ? 32 : 1);
      mbar_init(sBar + 8 * (STAGES + s), 8);      // empty: 8 wgmma warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int total = STEPS_PER_SUP * NC;  // (step, chunk) pairs

  if (RING && wg == 2) {  // the producer warp
    const long long r0 = sup * SUP_ROWS;
    for (int n = 0; n < total; ++n) {
      const int s = n % STAGES, st = n / NC, k = n % NC;
      mbar_wait(sBar + 8 * (STAGES + s), ((n / STAGES) & 1) ^ 1);
      if constexpr (MODE == CPASYNC) {
        for (int i = lane; i < ROWS * 4; i += 32) {
          const uint32_t dst = sRing + s * STAGE + (i >> 2) * KC +
                               16 * (i & 3);
          const int8_t* src = c + (r0 + (long long)st * ROWS + (i >> 2)) * D +
                              k * KC + 16 * (i & 3);
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                           dst),
                       "l"(src)
                       : "memory");
        }
        asm volatile(
            "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                sBar + 8 * s)
            : "memory");
      } else {
        if (lane == 0) mbar_expect_tx(sBar + 8 * s, STAGE);
        __syncwarp();
        if constexpr (MODE == TMA) {
          if (lane == 0)
            asm volatile(
                "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
                "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
                    sRing + s * STAGE),
                "l"(reinterpret_cast<uint64_t>(&tmap)), "r"(k * KC),
                "r"((int)(r0 + (long long)st * ROWS)), "r"(sBar + 8 * s)
                : "memory");
        } else {
          for (int r = lane; r < ROWS; r += 32)
            bulk_copy(sRing + s * STAGE + r * KC,
                      c + (r0 + (long long)st * ROWS + r) * D + k * KC, KC,
                      sBar + 8 * s);
        }
      }
    }
    return;
  }

  float best = -INFINITY;
  if constexpr (QB == 64) {
    float acc[2][32];
    uint32_t a[2][32];
    uint4 raw[2][4];
    int f = 0;
    auto fetch = [&](uint4 (&dst)[4]) {
      if (f < total) {
        const int st = f / NC, k = f % NC;
        const long long row0 = sup * SUP_ROWS + (2 * st + wg) * BIN +
                               16 * warp + g;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dst[i] = __ldg(reinterpret_cast<const uint4*>(
              c + (row0 + 64 * (i >> 1) + 8 * (i & 1)) * D + k * KC +
              16 * t));
      }
      ++f;
    };
    if (!RING && MODE != PRODUCTS) {
      fetch(raw[0]);
      fetch(raw[1]);
    }
    if constexpr (MODE == PRODUCTS) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        a[0][i] = a[1][i] = 0x3F803F80u ^ ((tid + i) & 0x00070007u);
    }
    for (int n0 = 0; n0 < total; n0 += 2) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = n0 + j, k = n % NC;
        uint4 cur[4];
        if (RING) {
          const int s = n % STAGES;
          mbar_wait(sBar + 8 * s, (n / STAGES) & 1);
          const uint4* src = reinterpret_cast<const uint4*>(
              ring_ptr + s * STAGE + (wg * BIN + 16 * warp + g) * KC +
              16 * t);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            cur[i] = src[(64 * (i >> 1) + 8 * (i & 1)) * KC / 16];
          __syncwarp();
          if (lane == 0) mbar_arrive(sBar + 8 * (STAGES + s));
          __syncwarp();
        } else if (MODE != PRODUCTS) {
#pragma unroll
          for (int i = 0; i < 4; ++i) cur[i] = raw[j][i];
          fetch(raw[j]);
        }
        if constexpr (MODE == PRODUCTS) {
        } else if constexpr (MODE == NOWIDEN) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t w[4] = {cur[i].x, cur[i].y, cur[i].z, cur[i].w};
#pragma unroll
            for (int s4 = 0; s4 < 4; ++s4) {
              a[j][((i >> 1) * 4 + s4) * 4 + (i & 1)] = w[s4] ^ 0x80808080u;
              a[j][((i >> 1) * 4 + s4) * 4 + 2 + (i & 1)] = w[s4] ^ 0x40404040u;
            }
          }
        } else {
          half_to_a(cur[0], cur[1], &a[j][0]);
          half_to_a(cur[2], cur[3], &a[j][16]);
        }
        wg_fence();
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int s4 = 0; s4 < 4; ++s4) {
            if constexpr (MODE == NOMMA)
              acc[h][s4] += __uint_as_float(a[j][h * 16 + s4 * 4] ^
                                            a[j][h * 16 + s4 * 4 + 3]);
            else
              mma_n64(acc[h], &a[j][h * 16 + s4 * 4],
                      sdesc(sQ + k * Q_TILE + s4 * 32), (k | s4) != 0);
          }
        wg_commit();
        wg_wait<1>();
        fence_regs(a[j ^ 1]);
        if (k == NC - 1) {  // the bin is done: fold its scores
          wg_wait<0>();
          fence_regs(acc[0]);
          fence_regs(acc[1]);
#pragma unroll
          for (int i = 0; i < 32; ++i)
            best = fmaxf(best, fmaxf(acc[0][i], acc[1][i]));
        }
      }
    }
  } else {
    float acc[64];
    uint32_t a[2][16];
    uint4 raw[2][2];
    int f = 0;
    auto fetch = [&](uint4 (&dst)[2]) {
      if (f < total) {
        const int st = f / NC, k = f % NC;
        const long long row0 = sup * SUP_ROWS + st * BIN + 64 * wg +
                               16 * warp + g;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          dst[i] = __ldg(reinterpret_cast<const uint4*>(
              c + (row0 + 8 * i) * D + k * KC + 16 * t));
      }
      ++f;
    };
    if (!RING && MODE != PRODUCTS) {
      fetch(raw[0]);
      fetch(raw[1]);
    }
    if constexpr (MODE == PRODUCTS) {
#pragma unroll
      for (int i = 0; i < 16; ++i)
        a[0][i] = a[1][i] = 0x3F803F80u ^ ((tid + i) & 0x00070007u);
    }
    for (int n0 = 0; n0 < total; n0 += 2) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = n0 + j, k = n % NC;
        uint4 cur[2];
        if (RING) {
          const int s = n % STAGES;
          mbar_wait(sBar + 8 * s, (n / STAGES) & 1);
          const uint4* src = reinterpret_cast<const uint4*>(
              ring_ptr + s * STAGE + (64 * wg + 16 * warp + g) * KC +
              16 * t);
          cur[0] = src[0];
          cur[1] = src[8 * KC / 16];
          __syncwarp();
          if (lane == 0) mbar_arrive(sBar + 8 * (STAGES + s));
          __syncwarp();
        } else if (MODE != PRODUCTS) {
          cur[0] = raw[j][0];
          cur[1] = raw[j][1];
          fetch(raw[j]);
        }
        if constexpr (MODE != PRODUCTS) half_to_a(cur[0], cur[1], a[j]);
        wg_fence();
#pragma unroll
        for (int s4 = 0; s4 < 4; ++s4)
          mma_n128(acc, &a[j][s4 * 4], sdesc(sQ + k * Q_TILE + s4 * 32),
                   (k | s4) != 0);
        wg_commit();
        wg_wait<1>();
        fence_regs(a[j ^ 1]);
        if (k == NC - 1) {
          wg_wait<0>();
          fence_regs(acc);
#pragma unroll
          for (int i = 0; i < 64; ++i) best = fmaxf(best, acc[i]);
        }
      }
    }
  }
  out[(long long)blockIdx.x * 256 + tid] = best;
}

// the store as a 2-D tensor of bytes [N rows, D], a box of one 64-deep
// chunk of a step's rows, no swizzle (rows of 64 bytes, as the wgmma warps
// read them)
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);
int make_map(CUtensorMap* map, const void* c, long long n, int D, int rows) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult qres;
  cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                          cudaEnableDefault, &qres);
  if (e != cudaSuccess || fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)D};
  const cuuint32_t box[2] = {(cuuint32_t)KC, (cuuint32_t)rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = reinterpret_cast<EncodeFn>(fn)(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(c), dims,
      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int QB, int MODE>
int run(const void* q, const void* c, float* out, int B, int nsup, int D,
        cudaStream_t stream) {
  constexpr bool RING = MODE == TMA || MODE == BULK || MODE == CPASYNC;
  auto kern = parts_kernel<QB, MODE>;
  CUtensorMap map = {};
  if (MODE == TMA) {
    const int e = make_map(&map, c, (long long)nsup * SUP_ROWS, D,
                           step_rows<QB>());
    if (e) return e;
  }
  const int smem = 1024 + (D / KC) * QB * 128 +
                   (RING ? STAGES * step_rows<QB>() * KC + 16 * STAGES : 0);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<nsup * (B / QB), RING ? 288 : 256, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const int8_t*>(c), out, B,
      nsup, D, map);
  return (int)cudaGetLastError();
}

}  // namespace k1_parts

// q [B, D] bf16, c [nsup * 2048, D] int8; out [nsup * B / qb * 256] f32.
// qb 64 or 128, mode as Mode; D % 128 == 0, D <= 768.
extern "C" int k1_parts_launch(const void* q, const void* c, float* out,
                               int B, int nsup, int D, int qb, int mode,
                               void* stream) {
  using namespace k1_parts;
  const cudaStream_t s = (cudaStream_t)stream;
  if (B % qb || D % 128 || D > 768) return (int)cudaErrorInvalidValue;
#define K1_PARTS_RUN(QB)                                          \
  switch (mode) {                                                 \
    case LDG: return run<QB, LDG>(q, c, out, B, nsup, D, s);      \
    case TMA: return run<QB, TMA>(q, c, out, B, nsup, D, s);      \
    case BULK: return run<QB, BULK>(q, c, out, B, nsup, D, s);    \
    case CPASYNC: return run<QB, CPASYNC>(q, c, out, B, nsup, D, s); \
  }
  if (qb == 64 && mode == NOWIDEN)
    return run<64, NOWIDEN>(q, c, out, B, nsup, D, s);
  if (qb == 64 && mode == NOMMA)
    return run<64, NOMMA>(q, c, out, B, nsup, D, s);
  if (mode == PRODUCTS)
    return qb == 64 ? run<64, PRODUCTS>(q, c, out, B, nsup, D, s)
                    : run<128, PRODUCTS>(q, c, out, B, nsup, D, s);
  if (qb == 64) K1_PARTS_RUN(64)
  if (qb == 128) K1_PARTS_RUN(128)
  return (int)cudaErrorInvalidValue;
}
