// The push lists of the sweeps (sssp_kcore_kernels.cu) and of the BFS
// level's push (bfs_kernels.cu). A dense pass over the vertices lists the
// CSR rows of the vertices that must push (the changed distances of an SSSP
// sweep, the peeled vertices of a k-core wave, the frontier of a BFS level)
// as ranges of at most kPushSplit slots, each with a value for its slots (a
// distance, or 0); a push kernel then takes the ranges 32 at a time per warp
// (at most 1,024 slots: a level's slots spread over many warps, a hub's over
// many), a lane per slot and kPushItems slots in flight a lane.
#pragma once

#include <cuda_runtime.h>

namespace etpu {

constexpr int kPushSplit = 32;              // slots per listed range
constexpr int kPushItems = 8;               // slots a lane has in flight
constexpr unsigned kAllLanes = 0xffffffffu;

// Appends [b, e) of each lane with `on` to `ranges` as {first slot, end
// slot, value, 0} pieces of at most kPushSplit slots, at one atomicAdd on
// *listed per warp. Every lane of the warp calls it.
__device__ __forceinline__ void list_row(bool on, int b, int e, int value,
                                         int* listed, int4* ranges) {
  const int lane = threadIdx.x & 31;
  const int nr = on ? (e - b + kPushSplit - 1) / kPushSplit : 0;
  int incl = nr;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int x = __shfl_up_sync(kAllLanes, incl, d);
    if (lane >= d) incl += x;
  }
  int at = 0;
  if (lane == 31 && incl > 0) at = atomicAdd(listed, incl);
  at = __shfl_sync(kAllLanes, at, 31) + incl - nr;
  for (int r = 0; r < nr; ++r) {
    const int q = b + r * kPushSplit;
    ranges[at + r] = make_int4(q, min(q + kPushSplit, e), value, 0);
  }
}

// A warp's 32 listed ranges laid end to end: lane l holds range r0 + l
// (nothing past `listed`); place t < total lies in the range of lane
// owner(t), at slot t + that lane's shift.
struct WarpRanges {
  int incl;                                 // places up to this lane's end
  int shift;                                // this lane's slot - place
  int value;                                // this lane's range's value
  int total;                                // places of the 32 ranges

  __device__ __forceinline__ WarpRanges(const int4* __restrict__ ranges,
                                        long long r0, int listed) {
    const int lane = threadIdx.x & 31;
    int q0 = 0;
    int len = 0;
    value = 0;
    if (r0 + lane < listed) {
      const int4 r = ranges[r0 + lane];
      q0 = r.x;
      len = r.y - r.x;
      value = r.z;
    }
    incl = len;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int x = __shfl_up_sync(kAllLanes, incl, d);
      if (lane >= d) incl += x;
    }
    total = __shfl_sync(kAllLanes, incl, 31);
    shift = q0 - (incl - len);
  }

  // the lane whose range holds place t; every lane calls it
  __device__ __forceinline__ int owner(int t) const {
    int o = 0;                              // the lanes whose ranges end by t
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      if (__shfl_sync(kAllLanes, incl, o + s - 1) <= t) o += s;
    }
    return o;
  }
};

}  // namespace etpu
