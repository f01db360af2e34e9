// The walk to a vertex's first qualifying in-edge, shared by the predecessor
// kernels of BFS (bfs_kernels.cu) and SSSP (sssp_kcore_kernels.cu).
//
// pred[v] is the smallest csc_src[q] over v's real in-edges q (CSC slots
// below n_edges) that qualify, -1 where v is not reached (or is the source)
// or none does. csc_src is sorted within a segment, so the first qualifying
// slot holds the answer and a walk stops there. What qualifies is the `Hit`
// functor's: it names the type of dist (`Dist`) and of the word read per
// slot besides csc_src (`Weight`), and gives
//   reached(dv)                 v takes part (dv finite and above 0);
//   weight(q)                   that word of slot q;
//   qualifies(s, weight, dv)    the in-edge from s qualifies for dist dv;
//   bits(dv) / from_bits(x)     dv as int32 bits and back.
//
// A walk's pace is its chain of dependent loads a step: csc_src (and the
// weight), then the scattered dist[src], then a ballot. Two launches keep a
// hub's walk from setting the pace of the whole pass:
// * the first walk gives each vertex a group of kFirstLanes lanes over at
//   most the first `split` slots of its segment, kHitChunks chunks of
//   kFirstLanes slots in flight a lane. Where it hits, the result is final
//   and written.
//   A vertex whose segment runs past `split` with no hit writes -1 and
//   lists the rest of its segment as ranges of `split` slots {first slot,
//   end slot, v, bits of dist[v]}, one atomicAdd on the count a vertex;
// * the range walk, a persistent grid (the count is known only on the
//   device), gives each listed range a warp, which walks it as the first
//   walk does and folds its first hit into pred[v] with an atomicMin on
//   the word as unsigned: -1 is the largest, so "none" needs no pass of
//   its own, and an integer min gives the same bits in any order. Since
//   csc_src is sorted, a range stops, before its dist gathers, at a step
//   whose first source is not below what pred[v] already holds.
#pragma once

#include <cuda_runtime.h>

namespace etpu {

constexpr int kHitBlock = 256;              // threads per block, both walks
constexpr int kHitChunks = 4;               // chunks a lane has in flight
// lanes a vertex in the first walk: on an H100, 8 took three quarters of
// the time 32 took at rmat18 and gen:rmat20x16 (PERF.md)
constexpr int kFirstLanes = 8;
constexpr int kHitBlocksPerSm = 8;          // the range walk's grid
constexpr unsigned kHitAll = 0xffffffffu;

// The source of the first qualifying slot of [b, e), or -1. Called by the
// G lanes of a group (G a power of two up to 32, the group aligned in its
// warp) with the same arguments. Where `seen` is given, stops at a step
// whose first source is not below *seen as unsigned.
template <int G, class Hit>
__device__ __forceinline__ int first_hit(const Hit& hit,
                                         const int* __restrict__ csc_src,
                                         int b, int e, typename Hit::Dist dv,
                                         const int* seen) {
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);
  const int leader = lane - gl;
  const unsigned group =
      G == 32 ? kHitAll : ((1u << G) - 1) << leader;
  for (int base = b; base < e; base += G * kHitChunks) {   // group-uniform
    int s[kHitChunks];
    typename Hit::Weight wq[kHitChunks];
#pragma unroll
    for (int i = 0; i < kHitChunks; ++i) {
      const int q = base + G * i + gl;
      s[i] = q < e ? csc_src[q] : -1;
      wq[i] = q < e ? hit.weight(q) : typename Hit::Weight();
    }
    if (seen != nullptr) {
      unsigned held = 0;
      if (gl == 0) held = __ldcg(reinterpret_cast<const unsigned*>(seen));
      held = __shfl_sync(group, held, leader);
      const unsigned first = __shfl_sync(group, s[0], leader);
      if (held <= first) return -1;
    }
    bool ok[kHitChunks];
#pragma unroll
    for (int i = 0; i < kHitChunks; ++i) {
      ok[i] = s[i] >= 0 && hit.qualifies(s[i], wq[i], dv);
    }
#pragma unroll
    for (int i = 0; i < kHitChunks; ++i) {
      const unsigned m = __ballot_sync(group, ok[i]);
      if (m) return __shfl_sync(group, s[i], __ffs(m) - 1);
    }
  }
  return -1;
}

// The first walk: a group of kFirstLanes lanes per vertex, kFirstLanes * vp
// threads in all.
template <class Hit>
__device__ __forceinline__ void first_walk(const Hit& hit,
                                           const int* __restrict__ off,
                                           const int* __restrict__ csc_src,
                                           int vp, int n_edges, int split,
                                           int* __restrict__ pred,
                                           int* __restrict__ listed,
                                           int4* __restrict__ ranges) {
  constexpr int G = kFirstLanes;
  const long long t = static_cast<long long>(blockIdx.x) * kHitBlock +
                      threadIdx.x;
  if (t / G >= vp) return;                  // group-uniform
  const int v = static_cast<int>(t / G);
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);
  // the segment's bounds load beside dist[v], not after it: a vertex's
  // walk is a chain of dependent loads
  const int b = off[v];
  const int end = off[v + 1];
  const auto dv = hit.dist[v];
  int best = -1;
  if (Hit::reached(dv)) {
    const int e = min(end, n_edges);        // below b where n_edges is
    best = first_hit<G>(hit, csc_src, b, b + max(0, min(e - b, split)), dv,
                        nullptr);
    if (best < 0 && e - b > split) {
      const int nr = (e - b - 1) / split;     // ceil((e - b - split) / split)
      const unsigned group =
          G == 32 ? kHitAll : ((1u << G) - 1) << (lane - gl);
      int at = 0;
      if (gl == 0) at = atomicAdd(listed, nr);
      at = __shfl_sync(group, at, lane - gl);
      for (int r = gl; r < nr; r += G) {
        const int q = b + split * (r + 1);
        ranges[at + r] = make_int4(q, q + min(e - q, split), v,
                                   Hit::bits(dv));
      }
    }
  }
  if (gl == 0) pred[v] = best;
}

// The range walk: a warp per listed range, over a persistent grid.
template <class Hit>
__device__ __forceinline__ void range_walk(const Hit& hit,
                                           const int* __restrict__ csc_src,
                                           int* pred,
                                           const int* __restrict__ listed,
                                           const int4* __restrict__ ranges) {
  const int n = *listed;                    // written by the first walk
  const long long warps = static_cast<long long>(gridDim.x) * kHitBlock / 32;
  for (long long r = (static_cast<long long>(blockIdx.x) * kHitBlock +
                      threadIdx.x) >> 5;
       r < n; r += warps) {
    const int4 rg = ranges[r];
    const int s = first_hit<32>(hit, csc_src, rg.x, rg.y,
                                Hit::from_bits(rg.w), pred + rg.z);
    if ((threadIdx.x & 31) == 0 && s >= 0) {
      atomicMin(reinterpret_cast<unsigned*>(pred + rg.z),
                static_cast<unsigned>(s));
    }
  }
}

// The two launches on stream `st`: `scratch` (16-byte aligned) holds the
// count, 3 unused words, then room for ep / split + 1 ranges (int4); the
// count is zeroed here. `walk` is the first walk's kernel.
// cudaErrorInvalidValue for a split below 1.
template <class Hit, class Walk, class Ranges>
cudaError_t launch_first_hits(const Hit& hit, Walk walk,
                              Ranges range_kernel, const int* off,
                              const int* csc_src, int vp, int n_edges,
                              int split, int* pred, void* scratch,
                              cudaStream_t st) {
  if (split < 1) return cudaErrorInvalidValue;
  int* listed = static_cast<int*>(scratch);
  int4* ranges = reinterpret_cast<int4*>(listed + 4);
  cudaError_t err = cudaMemsetAsync(listed, 0, sizeof(int), st);
  if (err != cudaSuccess || vp <= 0) return err;
  int dev = 0;
  int sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long threads = static_cast<long long>(vp) * kFirstLanes;
  walk<<<static_cast<int>((threads + kHitBlock - 1) / kHitBlock), kHitBlock,
         0, st>>>(hit, off, csc_src, vp, n_edges, split, pred, listed,
                  ranges);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  range_kernel<<<kHitBlocksPerSm * sms, kHitBlock, 0, st>>>(
      hit, csc_src, pred, listed, ranges);
  return cudaGetLastError();
}

}  // namespace etpu
