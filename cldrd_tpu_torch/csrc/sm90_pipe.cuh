// Hopper building blocks shared by the two kernels that stream 128-byte
// rows of queries and store rows through a TMA-fed ring of shared memory
// into wgmma: fused_binmax_sm90.cu (K2) and int8_dot_sm90.cu (K7).
//
// - wgmma on operands in 128-byte-swizzled shared memory (descriptors,
//   fence / commit / wait, the bf16 m64n128k16 product);
// - mbarriers (one arrival a warp) and TMA copies of 2-D boxes, with the
//   host-side tensor maps they read;
// - widen4: four int8 codes into two bf16x2, exactly.
#pragma once

#include <cuda.h>  // CUtensorMap (types only: the encoder is looked up)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cldrd_sm90 {

// ------------------------------------------------------------ primitives

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// K-major operand under the 128-byte swizzle: stride byte offset 1024
// (one 8-row atom), layout B128. A row of the atom is 128 bytes whatever
// the element type (64 bf16 values or 128 int8 codes), and a product's
// depth step is 32 bytes in both, so one descriptor serves both
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
// the accumulators are read only after the wait that retires the products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define SM90_ACC16(d, o)                                                   \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),           \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7]),       \
      "+f"(d[o + 8]), "+f"(d[o + 9]), "+f"(d[o + 10]), "+f"(d[o + 11]),     \
      "+f"(d[o + 12]), "+f"(d[o + 13]), "+f"(d[o + 14]), "+f"(d[o + 15])

// d[64 x 128] (+)= A[64 x 16] . B[16 x 128], both K-major in shared
// memory. Accumulator layout (warp w of the warpgroup, lane = 4g + t):
// element i is row 16w + g + 8*((i >> 1) & 1), column 8*(i >> 2) + 2t +
// (i & 1).
__device__ __forceinline__ void mma_n128(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : SM90_ACC16(d, 0), SM90_ACC16(d, 16), SM90_ACC16(d, 32),
        SM90_ACC16(d, 48)
      : "l"(a), "l"(b), "r"(accumulate)
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

// ------------------------------------------------- mbarriers and TMA

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
// one arrival for the warp, made by lane 0 once every lane's shared-memory
// accesses before it are ordered by __syncwarp (barriers count warps)
__device__ __forceinline__ void mbar_arrive_warp(uint32_t bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          bar),
      "r"(bytes)
      : "memory");
}
// waits for the phase of parity `parity` to complete. With TRAP, traps
// rather than hang the card if it never does: the producer's waits. The
// consumers' waits do not trap: ptxas lays any trap out as a block of its
// own ending the thread, which it placed right before the producer's
// code, so the hazard check (ops/_wgmma_check.py), reading the SASS as
// paths, walked from the consumer's in-flight products through the trap
// into the producer's registers. A consumer stuck for good leaves the
// producer waiting on an EMPTY barrier that is never released, and that
// wait traps.
template <bool TRAP>
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
    if (TRAP && n > (1ll << 22)) __trap();
  }
}
// a 2-D box of `map` at (x innermost, y) into shared memory at `dst`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}
// shared memory at `src` into the box of `map` at (x, y), clipped at the
// tensor's edges
__device__ __forceinline__ void tma_store(const CUtensorMap* map, int x,
                                          int y, uint32_t src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group "
      "[%0, {%1, %2}], [%3];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(x), "r"(y), "r"(src)
      : "memory");
}
// `bytes` (a multiple of 16) of device memory at `src` into L2
__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the staging buffers' stores have read shared memory
__device__ __forceinline__ void bulk_wait_read0() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait0() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint32_t a,
                                             uint32_t b, uint32_t c,
                                             uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

// ------------------------------------------------------------------- host

using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);

inline EncodeFn encoder() {
  static EncodeFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &res) == cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeFn>(p);
  }
  return fn;
}

// a row-major [outer, inner] tensor of `type` at `ptr`, row pitch
// `pitch` bytes, in boxes of [box_outer, box_inner] under the 128-byte
// swizzle; reads past the edges give zeros, writes there are dropped
inline int make_map(CUtensorMap* map, CUtensorMapDataType type,
                    const void* ptr, long long inner, long long outer,
                    long long pitch, int box_inner, int box_outer) {
  const EncodeFn fn = encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r =
      fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, estr,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace cldrd_sm90
