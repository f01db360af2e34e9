// A warp-wide lower_bound over a sorted int32 sequence, shared by the
// edge-balanced kernels (spmv_kernels.cu, operator_kernels.cu).
//
// A block of those kernels owns a fixed range of edges (or of the merged
// sequence of row ends and edges) and finds the rows that start in it by
// searching the [n+1] offsets. A binary search by one thread is ~20
// dependent loads at a million rows; here the 32 lanes probe 32 evenly
// spaced keys at once and narrow the range 32-fold per step, so a million
// rows take 4 dependent loads.
#pragma once

#include <cuda_runtime.h>

namespace etpu {

// First r in [0, n) with key(r) >= v, or n, for a non-decreasing key. Every
// lane of the warp must call it (with the same n and v); every lane gets
// the result.
template <typename Key>
__device__ __forceinline__ int warp_lower_bound_by(Key key, int n, int v) {
  const int lane = threadIdx.x & 31;
  int lo = 0;
  int hi = n;                     // the answer lies in [lo, hi], hi = none
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int p = min(lo + (lane + 1) * step - 1, hi - 1);
    const unsigned hit = __ballot_sync(0xffffffffu, key(p) >= v);
    if (hit == 0) return hi;
    const int k = __ffs(hit) - 1;
    const int pk = __shfl_sync(0xffffffffu, p, k);
    const int pprev = __shfl_sync(0xffffffffu, p, k > 0 ? k - 1 : 0);
    lo = k > 0 ? pprev + 1 : lo;
    hi = pk;                      // key(pk) >= v: the answer is at most pk
    if (lo == hi) return hi;
  }
  const int p = lo + lane;
  const unsigned hit = __ballot_sync(0xffffffffu, p < hi && key(p) >= v);
  return hit ? lo + __ffs(hit) - 1 : hi;
}

// First r in [0, n) with off[r] >= v, or n.
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ off,
                                                int n, int v) {
  return warp_lower_bound_by([off](int p) { return off[p]; }, n, v);
}

// The merge-path split of the sequence that merges the n row ends with the
// edges (Merrill and Garland, SC 2016): row r's end sits at place
// off[r+1] + r, after its own edges and the r row ends before it, so the
// first d places hold the ends of the rows r with off[r+1] + r < d. Returns
// their number; the first d places then hold d minus that many edges.
__device__ __forceinline__ int warp_merge_split(const int* __restrict__ off,
                                                int n, int d) {
  return warp_lower_bound_by([off](int r) { return off[r + 1] + r; }, n, d);
}

}  // namespace etpu
