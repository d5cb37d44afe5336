// Selection primitives of the extract kernels (extract_topk.cu,
// extract_topk_sm90.cu): the (value desc, index asc) order, group-wide
// best, and level 2 over a query's buffered candidates.
#pragma once

#include <climits>
#include <math.h>

namespace cldrd {

// better(a, b): larger value, ties to the smaller index
__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

__device__ __forceinline__ float warp_max_f(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// (value desc, index asc) best over aligned groups of G lanes
template <int G>
__device__ __forceinline__ void group_best(float& v, int& i) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// Level 2 over a query's n <= G * PER buffered candidates by an aligned
// group of G lanes (gl: the lane's place in the group): `rounds` rounds of
// best (value desc, position asc), then mask every copy of that position.
// Exhausted rounds re-emit the lowest position among all entries with
// -inf, as the TPU kernel does. Every lane of the group calls
// emit(r, value, position) with round r's pick.
template <int G, int PER, typename Emit>
__device__ __forceinline__ void level2(const float* cv, const int* cp, int n,
                                       int rounds, int gl, Emit emit) {
  float v[PER];
  int p[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int idx = gl + G * j;
    v[j] = idx < n ? cv[idx] : -INFINITY;
    p[j] = idx < n ? cp[idx] : INT_MAX;
  }
  for (int rr = 0; rr < rounds; ++rr) {
    float bv = v[0];
    int bp = p[0];
#pragma unroll
    for (int j = 1; j < PER; ++j)
      if (better(v[j], p[j], bv, bp)) {
        bv = v[j];
        bp = p[j];
      }
    group_best<G>(bv, bp);
    emit(rr, bv, bp);
    // positions may repeat (an exhausted bin re-emits its lowest row):
    // masking by position removes every copy
#pragma unroll
    for (int j = 0; j < PER; ++j)
      if (p[j] == bp) v[j] = -INFINITY;
  }
}

// level 2 by a whole warp over n <= 96 candidates: lane r < rounds
// returns round r's pick
__device__ __forceinline__ void level2_warp(const float* cv, const int* cp,
                                            int n, int rounds, float& out_v,
                                            int& out_p) {
  const int lane = threadIdx.x % 32;
  out_v = -INFINITY;
  out_p = INT_MAX;
  level2<32, 3>(cv, cp, n, rounds, lane, [&](int r, float v, int p) {
    if (lane == r) {
      out_v = v;
      out_p = p;
    }
  });
}

}  // namespace cldrd
