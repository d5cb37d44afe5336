// What both attention routes (attention.cu, attention_sm90.cu) share: the
// reference's dropout hash and its masked score, so the two routes keep
// the same bits for the same element.
#pragma once

#include <math.h>
#include <stdint.h>

namespace cldrd_attn {

constexpr float MASKED = -1e9f;

// _hash_keep's mixing: murmur3-style finalizer of (element index ^ seed),
// all uint32 (multiplies wrap, shifts are logical). The constants are the
// reference's int32 -1028477379 (0xC2B2AE3D) and -2048144789 (0x85EBCA6B).
__device__ __forceinline__ uint32_t hash_mix(uint32_t idx, uint32_t seed) {
  uint32_t x = idx ^ seed;
  x *= 0xC2B2AE3Du;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE3Du;
  x ^= x >> 16;
  return x;
}

// _hash_keep: keep when the top 24 bits, as a fraction of 2^24, reach p
__device__ __forceinline__ bool hash_keep(uint32_t idx, uint32_t seed,
                                          float p) {
  return (float)(hash_mix(idx, seed) >> 8) * 5.9604644775390625e-08f >= p;
}

// the same comparison in integers: (x >> 8) * 2^-24 >= p holds exactly
// when (x >> 8) >= keep_threshold(p) = ceil(p * 2^24) (the product is
// exact in fp32, and x >> 8 is an integer), which spares a conversion per
// element
__device__ __forceinline__ uint32_t keep_threshold(float p) {
  return (uint32_t)ceilf(p * 16777216.f);
}
__device__ __forceinline__ bool hash_keep_t(uint32_t idx, uint32_t seed,
                                            uint32_t threshold) {
  return (hash_mix(idx, seed) >> 8) >= threshold;
}

// the element index of (b, h, q, k) as the reference forms it in int32:
// ((b*H + h)*L + q)*L + k, wrapping modulo 2^32
__device__ __forceinline__ uint32_t drop_index(int b, int h, int H, int L,
                                               uint32_t q, uint32_t k) {
  return (((uint32_t)b * (uint32_t)H + (uint32_t)h) * (uint32_t)L + q) *
             (uint32_t)L + k;
}

// the masked fp32 score: -inf past L (contributes nothing), -1e9 where
// the key is masked or in another segment; km is the key's mask value
// (-1 past L), ks and qs the key's and the query's segments
template <bool SEG>
__device__ __forceinline__ float masked_score(float s, int km, int ks,
                                              int qs) {
  if (km < 0) return -INFINITY;
  const bool ok = km != 0 && (!SEG || qs == ks);
  return ok ? s : MASKED;
}

// K5's softmax at head_dim 64, shared by attention_infer.cu (L <= 64) and
// attention_infer_d64.cu (64 < L <= 256), so a row gives the same bits at
// every padded length (a length bucket's store holds the flat store's
// rows): e = 2^((s - max) * log2 e) by ex2.approx, for scores s scaled by
// 2^-3 (or the unscaled difference times 2^-3 log2 e: the same fp32
// value); each thread sums its e 16 keys at a time, (e_2t + e_2t+1) +
// (e_2t+8 + e_2t+9), in key order; each probability is e times the row's
// correctly rounded 1 / sum. ex2_approx is exactly 1 at 0 and +0 at -inf
// or below -150.
constexpr float LOG2E = 1.4426950408889634f;
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace cldrd_attn
