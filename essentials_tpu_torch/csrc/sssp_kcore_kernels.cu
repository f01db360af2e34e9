// Hand-written CUDA kernels of the fused SSSP and k-core paths, for Hopper
// (sm_90a).
//
// Built by essentials_tpu_torch/kernels.py with nvcc into the shared library
// of every csrc/*.cu, with a plain C interface, loaded with ctypes. Every
// entry point launches on the stream it is given, allocates nothing, and
// returns cudaGetLastError() so that a refused launch reaches the Python
// wrapper.
//
// Layout contract (essentials_tpu_torch/graph/graph.py), as in
// bfs_kernels.cu: `off` is the graph's [Vp+1] int32 CSR offsets, equal to its
// CSC offsets on a symmetric layout; `col` is the [Ep] int32 column of each
// CSR slot and `csc_src` the [Ep] int32 source of each CSC slot, sorted by
// (dst, src); `w` is the [Ep] float32 weight of each CSR slot (the graph's
// values) for the sweep, of each CSC slot (its csc_values) for the
// predecessors. Edge-axis state arrays are [Ep] int32 of which only the
// positions off[v] (segment starts) are read or written.
//
// The SSSP sweep reads one buffer and writes another (ping-pong). A min
// updated in place would let a vertex see a neighbour's distance of the
// same sweep, and SSSP would converge in other sweeps than the JAX
// package's Jacobi sweeps. It reads the output buffer's old distances (the
// sweep before the input's) and writes only the starts that differ, so the
// buffers never need a copy. The k-core waves update one degree and one
// core buffer in place: a wave marks its whole peel set in one launch
// before the push that reads it.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "first_hit.cuh"
#include "push_list.cuh"
#include "segment_starts.cuh"
#include "warp_search.cuh"

namespace {

constexpr int kBlock = 256;                 // threads per block
constexpr int kWarpsPerBlock = kBlock / 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kInfBits = 0x7f800000;        // float32 +inf as int32 bits

__device__ __forceinline__ long long global_warp() {
  return (static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x) >> 5;
}

// The push lists (push_list.cuh): a dense pass lists the CSR rows of the
// vertices that must push, a push kernel takes them 32 ranges a warp.
using etpu::kPushItems;
using etpu::kPushSplit;
using etpu::list_row;
using etpu::WarpRanges;

// One Bellman-Ford sweep on the edge axis: a dense pass over the vertices,
// then a push from the vertices whose distance changed in the sweep before.
//
// Replaces the JAX package's three Pallas kernels of one sweep
// (essentials_tpu/ops/fused_sssp.py: _k1_fill_addw_kernel :74, the Benes
// router middle cube_router._k2_wbc_kernel :330 / _k2_tfbc_kernel :363, and
// _k3_suffixmin_update_kernel :98). Those relax every edge in every sweep:
// d_{t+1}[v] = min(d_t[v], min over in-edges u -> v of f32(d_t[u] + w)).
// Only the edges out of a vertex u with d_t[u] != d_{t-1}[u] can lower
// anything: for any other u, sweep t already folded f32(d_{t-1}[u] + w) =
// f32(d_t[u] + w) into d_t[v] (with d_{-1} all +inf, sweep 0 pushes from
// the source alone). So each sweep reads only the changed vertices' edges,
// with the same result.
//
// Distances are float32 bit patterns in int32: non-negative floats order as
// their bits do, so the min runs on integers. dist_in holds d_t and
// dist_out d_{t-1} (the ping-pong buffers; +inf before the first sweep) at
// the non-empty starts. Three launches:
// * sssp_sweep_kernel, one thread per vertex v, reads both starts, writes
//   d_t into dist_out where they differ and lists v's CSR row with d_t[v]
//   there; it copies d_t[v] into two [Vp] arrays, best and cur (+inf at
//   an empty segment);
// * sssp_sweep_push_kernel takes each listed slot q of a row u: v = col[q],
//   c = bits(__fadd_rn(d_t[u], w[q])) (nvcc does not contract __fadd_rn,
//   so the bits equal the plain version's and the JAX package's; +inf + w
//   stays +inf), and atomicMin(&best[v], c) where c is below what an L2
//   read of best[v] shows. v is counted by the one atomic whose returned
//   old value is still cur[v] and above c: the first that lowers it. Each
//   warp also counts the slots of the ranges it takes and adds them once
//   at its end (counted in the dense pass instead, an atomic on one word
//   from each of its Vp / 32 warps, they cost 8-14% more device time a
//   sweep at 2^24 vertices on an H100);
// * sssp_sweep_update_kernel, one thread per vertex, writes best[v] into
//   v's start where it is below cur[v].
// The CSR row is u's out-edges, directed or not; on a symmetric layout v's
// row starts where its segment does, so off[v] is v's start. The min is
// exact in any order, so the bits repeat.
//
// scratch: {improved, ranges listed, slots listed, 0}, best [vp4], cur
// [vp4], then the ranges (vp4 = vp rounded up to 4, so the ranges are
// 16-byte aligned); the entry point sets the first three to 0. The slots
// listed are the CSR slots the push read (at most Ep, so an int).
//
// What bounds it: the dense passes read the offsets and, at each non-empty
// start, one 32-byte sector of each buffer, and stream the [Vp] arrays; the
// push reads per listed slot its col and w words and one scattered sector
// of best (a [Vp] array: 4 MB at 2^20 vertices, in the L2). A start's
// sector (the edge axis is [Ep]) is touched only by the dense passes. A
// hub's row is spread over many warps.
__global__ void __launch_bounds__(kBlock)
sssp_sweep_kernel(const int* __restrict__ dist_in, int* __restrict__ dist_out,
                  const int* __restrict__ off, int vp, int* scalars,
                  int* __restrict__ best, int* __restrict__ cur,
                  int4* __restrict__ ranges) {
  const int v = blockIdx.x * kBlock + threadIdx.x;
  bool changed = false;
  int b = 0;
  int e = 0;
  int d = kInfBits;
  if (v < vp) {
    b = off[v];
    e = off[v + 1];
    if (b < e) {
      d = dist_in[b];
      changed = d != dist_out[b];
      if (changed) dist_out[b] = d;
    }
    best[v] = d;
    cur[v] = d;
  }
  list_row(changed, b, e, d, &scalars[1], ranges);
}

__global__ void __launch_bounds__(kBlock)
sssp_sweep_push_kernel(const int* __restrict__ cur, int* best,
                       const int* __restrict__ col,
                       const float* __restrict__ w, int* scalars,
                       const int4* __restrict__ ranges) {
  const int lane = threadIdx.x & 31;
  const int listed = scalars[1];            // written by the dense pass
  const long long step = 32LL * gridDim.x * kWarpsPerBlock;
  int improved = 0;
  int slots = 0;                            // the same on every lane
  for (long long r0 = 32 * global_warp(); r0 < listed; r0 += step) {
    const WarpRanges wr(ranges, r0, listed);
    slots += wr.total;
    for (int t0 = 0; t0 < wr.total; t0 += 32 * kPushItems) {
      int q[kPushItems];
      float du[kPushItems];
#pragma unroll
      for (int i = 0; i < kPushItems; ++i) {
        const int t = t0 + 32 * i + lane;
        const int o = wr.owner(t);
        const int sh = __shfl_sync(kFullMask, wr.shift, o);
        du[i] = __int_as_float(__shfl_sync(kFullMask, wr.value, o));
        q[i] = t < wr.total ? t + sh : -1;
      }
      int v[kPushItems];
      float c[kPushItems];
#pragma unroll
      for (int i = 0; i < kPushItems; ++i) {
        v[i] = q[i] >= 0 ? col[q[i]] : -1;
        c[i] = q[i] >= 0 ? w[q[i]] : 0.0f;
      }
      int seen[kPushItems];
#pragma unroll
      for (int i = 0; i < kPushItems; ++i) {
        seen[i] = v[i] >= 0 ? __ldcg(&best[v[i]]) : 0;
      }
#pragma unroll
      for (int i = 0; i < kPushItems; ++i) {
        const int cand = __float_as_int(__fadd_rn(du[i], c[i]));
        // a stale read is never below best[v]: it only lets an atomic
        // through that finds nothing to lower
        if (v[i] >= 0 && cand < seen[i]) {
          const int old = atomicMin(&best[v[i]], cand);
          if (cand < old && old == cur[v[i]]) ++improved;
        }
      }
    }
  }
  improved = __reduce_add_sync(kFullMask, improved);
  if (lane == 0 && improved > 0) atomicAdd(&scalars[0], improved);
  if (lane == 0 && slots > 0) atomicAdd(&scalars[2], slots);
}

__global__ void __launch_bounds__(kBlock)
sssp_sweep_update_kernel(int* __restrict__ dist_out,
                         const int* __restrict__ off, int vp,
                         const int* __restrict__ best,
                         const int* __restrict__ cur) {
  const int v = blockIdx.x * kBlock + threadIdx.x;
  if (v >= vp) return;
  const int d = best[v];
  if (d < cur[v]) dist_out[off[v]] = d;     // below cur: a non-empty start
}

// Smallest-id shortest-path predecessor: the first walk and the range walk
// of first_hit.cuh.
//
// Replaces the MIN advance of essentials_tpu/algorithms/sssp.py
// predecessors_from_distances (:133), which reaches the cube-chain expand
// (cube_router.apply_cube_chain, :586) and the routed segmented MIN scan
// (scan_kernels._scan_kernel, :124) on the TPU.
//
// pred[v] = min csc_src[q] over real in-edges q < n_edges with
// f32(dist[src] + w[q]) == dist[v] (float compare, __fadd_rn as in the
// sweep, so the edge that set dist[v] qualifies; a zero-weight self-loop
// of v does too); -1 unless dist[v] is finite and above 0 and such an edge
// exists.
// What bounds it: csc_src and w up to each reached vertex's first hit, a
// scattered dist[src] sector per slot read, pred written; once per search.
struct SsspHit {
  using Dist = float;
  using Weight = float;
  const float* __restrict__ dist;
  const float* __restrict__ w;

  // finite and above 0: positive floats below +inf have smaller bits
  __device__ static bool reached(float dv) {
    return dv > 0.0f && __float_as_int(dv) < kInfBits;
  }
  __device__ static int bits(float dv) { return __float_as_int(dv); }
  __device__ static float from_bits(int x) { return __int_as_float(x); }
  __device__ float weight(int q) const { return w[q]; }
  __device__ bool qualifies(int s, float wq, float dv) const {
    return __fadd_rn(dist[s], wq) == dv;
  }
};

__global__ void __launch_bounds__(etpu::kHitBlock)
sssp_predecessors_kernel(SsspHit hit, const int* __restrict__ off,
                         const int* __restrict__ csc_src, int vp,
                         int n_edges, int split, int* __restrict__ pred,
                         int* __restrict__ listed,
                         int4* __restrict__ ranges) {
  etpu::first_walk(hit, off, csc_src, vp, n_edges, split, pred, listed,
                   ranges);
}

__global__ void __launch_bounds__(etpu::kHitBlock)
sssp_predecessors_ranges_kernel(SsspHit hit, const int* __restrict__ csc_src,
                                int* pred, const int* __restrict__ listed,
                                const int4* __restrict__ ranges) {
  etpu::range_walk(hit, csc_src, pred, listed, ranges);
}

// One k-core peel wave on the edge axis, its state updated in place: a pass
// that marks the wave's peel set and lists their CSR rows, then a push from
// those rows that lists the next wave's peel set.
//
// Replaces the JAX package's three Pallas kernels of one wave
// (essentials_tpu/ops/fused_kcore.py: _k1_fill_peel_kernel :78, the router
// middle cube_router._k2_wbc_kernel :330 / _k2_tfbc_kernel :363, and
// _k3_suffixsum_update_kernel :100), and their two scalar outputs. Those pull:
// every survivor counts its peeled in-neighbours, so every wave reads every
// survivor's in-edges. Here only the peeled vertices' edges are read, in the
// wave that peels them: about E edges over a whole run, not a rescan per
// wave; and only the first wave of a level k reads every vertex.
//
// deg holds the remaining degree at each non-empty start, -1 once peeled;
// core the core number there. The k schedule is the JAX package's: a wave
// at k peels every alive vertex of degree below k (core k - 1) and takes
// one from each survivor's degree per peeled in-neighbour; the next wave
// stays at k while a survivor's degree is below it, else k jumps to the
// smallest alive degree + 1. Two kinds of wave give that schedule:
// * a level wave, the first at a new k: kcore_level_wave_kernel, one thread
//   per vertex, folds the alive starts' degrees into the smallest (a block
//   minimum into its slot of block_min, and atomicMin into scalars[4];
//   block_min is the wave's cand_out, which the push alone writes after);
//   kcore_level_peel_kernel, over the same blocks, sets k = that + 1 (IMAX
//   when nothing is alive; block 0 writes it to scalars[3]) and, in the
//   blocks whose own minimum is the smallest (no other block holds a
//   vertex below k), marks each alive start with d < k peeled (deg -1,
//   core k - 1), counts it and lists its CSR row (list_row);
// * a cascade wave, while the wave before listed candidates:
//   kcore_cascade_wave_kernel, one thread per listed vertex, marks it
//   peeled at the k the host passes and lists its row. The list holds
//   exactly the alive vertices of degree below k, so nothing else is read.
// Then kcore_wave_push_kernel loads v = col[q] for each listed slot q of a
// peeled u and, where v is alive (deg[off[v]] >= 0: the pass launch marked
// this wave's peel set before the push started, and a survivor's degree
// stays >= k - 1 >= 0 through it), takes one from deg[off[v]] with
// atomicSub. The one subtraction that returns exactly k takes v below k:
// v joins the next wave's candidate list (a warp-aggregated append), once.
// After the push the list holds every alive vertex of degree below k, the
// next wave's peel set, and is empty exactly when the JAX schedule jumps
// to the next level. On a symmetric layout u's row sits at the positions
// of its segment and v's start is off[v], and the out-edges u -> v are
// exactly the in-edges that v's pull counts, on a directed graph as on an
// undirected one. Integer atomics are exact in any order: the degrees and
// core numbers repeat bit for bit; only the list's order varies.
//
// scalars: {peeled, candidates listed, ranges listed, k, smallest alive
// degree, unused x 3}; the entry points copy kcore_wave_start into them on
// the stream before each wave.
//
// What bounds it: a level wave's two passes read the offsets and one
// 32-byte sector at each non-empty start, the second only in the blocks
// that peel; a cascade reads two offsets and writes two sectors per listed
// vertex; the push reads per peeled slot its col word and two scattered
// sectors, off[v] and v's start.
__global__ void __launch_bounds__(kBlock)
kcore_level_wave_kernel(const int* __restrict__ deg,
                        const int* __restrict__ off, int vp,
                        int* __restrict__ scalars,
                        int* __restrict__ block_min) {
  __shared__ int warp_min[kWarpsPerBlock];
  const int v = blockIdx.x * kBlock + threadIdx.x;
  int alive = INT_MAX;
  if (v < vp) {
    const int b = off[v];
    if (b < off[v + 1]) {
      const int d = deg[b];
      if (d >= 0) alive = d;
    }
  }
  alive = __reduce_min_sync(kFullMask, alive);
  if ((threadIdx.x & 31) == 0) warp_min[threadIdx.x >> 5] = alive;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = warp_min[0];
    for (int i = 1; i < kWarpsPerBlock; ++i) m = min(m, warp_min[i]);
    block_min[blockIdx.x] = m;
    if (m < INT_MAX) atomicMin(&scalars[4], m);
  }
}

__global__ void __launch_bounds__(kBlock)
kcore_level_peel_kernel(int* __restrict__ deg, int* __restrict__ core,
                        const int* __restrict__ off, int vp,
                        int* __restrict__ scalars,
                        const int* __restrict__ block_min,
                        int4* __restrict__ ranges) {
  const int m = scalars[4];                 // written by the pass before
  const int k = m == INT_MAX ? INT_MAX : m + 1;
  if (blockIdx.x == 0 && threadIdx.x == 0) scalars[3] = k;
  if (block_min[blockIdx.x] != m) return;   // block-uniform: none below k
  const int v = blockIdx.x * kBlock + threadIdx.x;
  bool peeled = false;
  int b = 0;
  int e = 0;
  if (v < vp) {
    b = off[v];
    e = off[v + 1];
    if (b < e) {
      const int d = deg[b];
      if (d >= 0 && d < k) {
        peeled = true;
        deg[b] = -1;
        core[b] = k - 1;
      }
    }
  }
  list_row(peeled, b, e, 0, &scalars[2], ranges);
  const int n = __syncthreads_count(peeled);
  if (threadIdx.x == 0 && n > 0) atomicAdd(&scalars[0], n);
}

__global__ void __launch_bounds__(kBlock)
kcore_cascade_wave_kernel(int* __restrict__ deg, int* __restrict__ core,
                          const int* __restrict__ off, int k,
                          const int* __restrict__ cand, int n,
                          int* __restrict__ scalars,
                          int4* __restrict__ ranges) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  int b = 0;
  int e = 0;
  if (i < n) {
    const int v = cand[i];
    b = off[v];
    e = off[v + 1];
    deg[b] = -1;                            // listed: alive, below k
    core[b] = k - 1;
  }
  list_row(i < n, b, e, 0, &scalars[2], ranges);
  if (i == 0) {
    scalars[0] = n;
    scalars[3] = k;
  }
}

__global__ void __launch_bounds__(kBlock)
kcore_wave_push_kernel(int* deg, const int* __restrict__ off,
                       const int* __restrict__ col, int* scalars,
                       const int4* __restrict__ ranges,
                       int* __restrict__ cand) {
  const int lane = threadIdx.x & 31;
  const int listed = scalars[2];            // written by the pass launch
  const int k = scalars[3];
  const long long step = 32LL * gridDim.x * kWarpsPerBlock;
  for (long long r0 = 32 * global_warp(); r0 < listed; r0 += step) {
    const WarpRanges wr(ranges, r0, listed);
    for (int t0 = 0; t0 < wr.total; t0 += 32 * kPushItems) {
      int q[kPushItems];
#pragma unroll
      for (int i = 0; i < kPushItems; ++i) {
        const int t = t0 + 32 * i + lane;
        const int sh = __shfl_sync(kFullMask, wr.shift, wr.owner(t));
        q[i] = t < wr.total ? t + sh : -1;
      }
      int dst[kPushItems];
#pragma unroll
      for (int i = 0; i < kPushItems; ++i) {
        dst[i] = q[i] >= 0 ? col[q[i]] : -1;
      }
      int at[kPushItems];
#pragma unroll
      for (int i = 0; i < kPushItems; ++i) {
        at[i] = dst[i] >= 0 ? off[dst[i]] : -1;
      }
      // a survivor's sign holds through the push, so an L2 read that
      // misses other warps' subtractions still tells alive from peeled
      int alive[kPushItems];
#pragma unroll
      for (int i = 0; i < kPushItems; ++i) {
        alive[i] = at[i] >= 0 ? __ldcg(&deg[at[i]]) : -1;
      }
#pragma unroll
      for (int i = 0; i < kPushItems; ++i) {
        const bool crossed =
            alive[i] >= 0 && atomicSub(&deg[at[i]], 1) == k;
        const unsigned hit = __ballot_sync(kFullMask, crossed);
        if (hit) {                          // warp-uniform
          int base = 0;
          if (lane == 0) base = atomicAdd(&scalars[1], __popc(hit));
          base = __shfl_sync(kFullMask, base, 0);
          if (crossed) cand[base + __popc(hit & ((1u << lane) - 1))] = dst[i];
        }
      }
    }
  }
}

// A wave's scalars before it: {peeled, candidates listed, ranges listed, k,
// smallest alive degree, unused x 3}.
__device__ int kcore_wave_start[8] = {0, 0, 0, 0, INT_MAX, 0, 0, 0};

// Per-vertex values -> the edge axis, in tiles balanced by slots.
//
// Replaces the expansion of essentials_tpu/ops/segment.py
// expand_vertex_to_edges (:77), which k-core's init_deg_exp
// (essentials_tpu/ops/fused_kcore.py :253) calls: a scatter of per-vertex
// differences at the segment starts and a telescoping int32 cumsum over the
// edge axis, scan_kernels.scan_1d (:274) on the TPU. Here every slot is
// written directly, a pure fill:
//   out[p] = vals[v] for off[v] <= p < off[v+1], over [0, n).
// What bounds it: the [n] int32 written (the offsets and vals are read
// once, a word a segment), so each block must write about the same number
// of bytes, whatever the degrees. One launch over tiles of kExpandTile
// places of the merged sequence of segment ends and slots (segment v's end
// at place off[v+1] + v, after its slots, as in spmv_rows): an empty
// segment costs a tile one place, so a run of them cannot crowd a tile,
// and a hub spread over many tiles costs each the same. A block finds its
// own two splits (etpu::warp_merge_split, warps 0 and 1 at once: a fill
// needs no carry, so there is no split kernel and no look-back). Each warp
// then owns a run of the tile's 16-byte vectors of slots, whole rounds of
// 32, and finds the owner of its first slot by a warp-wide search of the
// offsets. Each non-empty segment that starts in the tile marks its start
// slot in shared memory with its index; a round reads a vector of marks a
// lane, and a slot's owner is the last mark at or before it: the nearest
// lane below with a mark (a ballot) or the round before's. So a slot costs
// no search, and each warp store covers 512 contiguous bytes. Which slots
// a vector holds past the tile's edges is masked, so tiles share no word.
constexpr int kExpandItems = 16;            // merge places a thread
constexpr int kExpandTile = kBlock * kExpandItems;
constexpr int kExpandVectors = kExpandTile / 4 + 1;   // that hold its slots

__global__ void __launch_bounds__(kBlock)
expand_segments_kernel(const int* __restrict__ vals,
                       const int* __restrict__ off, int vp, int n,
                       int* __restrict__ out) {
  // from the tile's first vector on, a slot's mark: the index from r0 of
  // the non-empty segment that starts there, else 0
  __shared__ int4 s_mark[kExpandVectors];
  __shared__ int s_split[2];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int places = vp + n;
  const int d0 = blockIdx.x * kExpandTile;
  const int d1 = min(d0 + kExpandTile, places);
  if (wid < 2) {
    const int r = etpu::warp_merge_split(off, vp, wid == 0 ? d0 : d1);
    if (lane == 0) s_split[wid] = r;
  }
  for (int c = tid; c < kExpandVectors; c += kBlock) {
    s_mark[c] = make_int4(0, 0, 0, 0);
  }
  __syncthreads();
  const int r0 = s_split[0];
  const int nr = s_split[1] - r0;           // segments that end in the tile
  const int p0 = max(d0 - r0, 0);           // the tile's slots: [p0, p1)
  const int p1 = min(d1 - s_split[1], n);
  const int qb = p0 & ~3;                   // its first vector's first slot
  const int nvec = p1 > p0 ? (p1 - qb + 3) >> 2 : 0;
  const int per_warp = 32 * ((nvec + kBlock - 1) / kBlock);
  const int c0 = wid * per_warp;            // the warp's vectors: [c0, c1)
  const int c1 = min(c0 + per_warp, nvec);
  int carry = 0;                            // the owner of the slot before
  if (c0 < c1) {                            // warp-uniform
    const int p = max(qb + 4 * c0, p0);     // the warp's first slot
    carry = etpu::warp_lower_bound_by(
        [off, r0](int x) { return off[r0 + 1 + x]; }, nr, p + 1);
  }
  int* const marks = reinterpret_cast<int*>(s_mark);
  for (int i = 1 + tid; i <= nr; i += kBlock) {
    const int b = off[r0 + i];              // segment r0 + i's start
    if (b >= p0 && b < p1 && (i == nr || b < off[r0 + i + 1])) {
      marks[b - qb] = i;
    }
  }
  __syncthreads();
  const int* const v = vals + r0;
  const int last = vp - 1 - r0;             // an owner past it owns no slot
  for (int c = c0 + lane; c - lane < c1; c += 32) {   // warp-uniform
    const int4 m = c < c1 ? s_mark[c] : make_int4(0, 0, 0, 0);
    const int m1 = max(m.x, m.y);
    const int m2 = max(m1, m.z);
    const int m3 = max(m2, m.w);            // the vector's last mark
    const unsigned bal = __ballot_sync(kFullMask, m3 > 0);
    const unsigned below = bal & ((1u << lane) - 1);
    const int from = __shfl_sync(kFullMask, m3, below ? 31 - __clz(below) : 0);
    const int before = below ? from : carry;
    carry = bal ? __shfl_sync(kFullMask, m3, 31 - __clz(bal)) : carry;
    if (c < c1) {
      const int w0 = min(max(before, m.x), last);
      const int w1 = min(max(before, m1), last);
      const int w2 = min(max(before, m2), last);
      const int w3 = min(max(before, m3), last);
      const int x0 = __ldg(v + w0);
      const int x1 = w1 == w0 ? x0 : __ldg(v + w1);
      const int x2 = w2 == w1 ? x1 : __ldg(v + w2);
      const int x3 = w3 == w2 ? x2 : __ldg(v + w3);
      const int q = qb + 4 * c;
      if (q >= p0 && q + 4 <= p1) {
        *reinterpret_cast<int4*>(out + q) = make_int4(x0, x1, x2, x3);
      } else {                              // the tile's or the array's edge
        const int x[4] = {x0, x1, x2, x3};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (q + u >= p0 && q + u < p1) out[q + u] = x[u];
        }
      }
    }
  }
}

// Edge-axis state -> per-vertex values, several segments a thread
// (segment_starts.cuh).
//
// Replaces the routed collapses of essentials_tpu/ops/fused_sssp.py
// collapse_dist_exp (:244) and fused_kcore.py collapse_core_exp (:260):
// permute.apply_plan over off_route_csr.inv_plan (cube_router._pallas_apply
// :385) followed by the "first" fill of scan_kernels._scan_kernel (:124).
// Here the segment start is one load.
//
// out[v] = exp[off[v]] for a non-empty segment, `empty` otherwise;
// out[source] = 0 when source >= 0 (SSSP's source, whose segment may be
// empty). What bounds it: a sector of exp a non-empty segment, the [Vp+1]
// offsets and the [Vp] output; it runs once per search.
struct StartValue {
  int empty_value;
  __device__ int operator()(int x) const { return x; }
  __device__ int empty() const { return empty_value; }
};

__global__ void __launch_bounds__(etpu::kStartsBlock)
collapse_starts_kernel(const int* __restrict__ exp, const int* __restrict__ off,
                       int vp, int empty, int source, int* __restrict__ out) {
  etpu::collapse_segment_starts(exp, off, vp, source, StartValue{empty}, out);
}

int thread_blocks(int vp) { return (vp + kBlock - 1) / kBlock; }

// The push kernels' persistent grid: blocks per SM.
constexpr int kPushBlocksPerSm = 4;

cudaError_t sm_count(int* sms) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

cudaError_t kcore_wave_push(int* deg, const int* off, const int* col,
                            int* scalars, const int4* ranges, int* cand,
                            cudaStream_t s) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  // a persistent grid: how many ranges the pass lists is known only on
  // the device
  kcore_wave_push_kernel<<<kPushBlocksPerSm * sms, kBlock, 0, s>>>(
      deg, off, col, scalars, ranges, cand);
  return cudaGetLastError();
}

int4* kcore_wave_ranges(void* scratch) {
  return reinterpret_cast<int4*>(static_cast<int*>(scratch) + 8);
}

}  // namespace

extern "C" {

// `scratch` (16-byte aligned) holds 4 + 2 * vp4 int32 and then room for
// vp + ceil(ep / etpu_push_split()) int4, vp4 = vp rounded up to 4 (see
// sssp_sweep_kernel); its first three words are set to 0 here and then
// hold {improved, ranges listed, slots listed}. Three launches: the dense
// pass, the push over the ranges it lists, the update of the starts.
int etpu_sssp_sweep(const void* dist_in, void* dist_out, const void* off,
                    const void* col, const void* w, int vp, void* scratch,
                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* scalars = static_cast<int*>(scratch);
  cudaError_t err = cudaMemsetAsync(scalars, 0, 3 * sizeof(int), s);
  if (err != cudaSuccess || vp <= 0) return static_cast<int>(err);
  int sms = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return static_cast<int>(err);
  int* best = scalars + 4;
  int* cur = best + ((vp + 3) & ~3);
  int4* ranges = reinterpret_cast<int4*>(cur + ((vp + 3) & ~3));
  sssp_sweep_kernel<<<thread_blocks(vp), kBlock, 0, s>>>(
      static_cast<const int*>(dist_in), static_cast<int*>(dist_out),
      static_cast<const int*>(off), vp, scalars, best, cur, ranges);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // a persistent grid: how many ranges the pass lists is known only on
  // the device
  sssp_sweep_push_kernel<<<kPushBlocksPerSm * sms, kBlock, 0, s>>>(
      cur, best, static_cast<const int*>(col), static_cast<const float*>(w),
      scalars, ranges);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sssp_sweep_update_kernel<<<thread_blocks(vp), kBlock, 0, s>>>(
      static_cast<int*>(dist_out), static_cast<const int*>(off), vp, best,
      cur);
  return static_cast<int>(cudaGetLastError());
}

// `scratch` as first_hit.cuh's launch_first_hits takes it: room for
// csc_src's slots / split + 1 ranges after 4 words.
int etpu_sssp_predecessors(const void* dist, const void* off,
                           const void* csc_src, const void* w, int vp,
                           int n_edges, int split, void* pred, void* scratch,
                           void* stream) {
  const SsspHit hit = {static_cast<const float*>(dist),
                       static_cast<const float*>(w)};
  return static_cast<int>(etpu::launch_first_hits(
      hit, sssp_predecessors_kernel, sssp_predecessors_ranges_kernel,
      static_cast<const int*>(off), static_cast<const int*>(csc_src), vp,
      n_edges, split, static_cast<int*>(pred), scratch,
      static_cast<cudaStream_t>(stream)));
}

// The k-core waves' scratch (16-byte aligned): kcore_wave_start's 8 words,
// then room for vp + ceil(ep / etpu_push_split()) int4 ranges. Its first 8
// words are set here by a device-to-device copy (no kernel launch) before
// each wave and then hold {peeled, candidates listed, ranges listed, k,
// smallest alive degree}. `cand_out` ([vp] int32) receives the candidates;
// a level wave keeps its block minima there (ceil(vp / kBlock) <= vp
// words) until the push.

// A level wave in place: three launches, the minimum, the peel, the push.
int etpu_kcore_level_wave(void* deg, void* core, const void* off,
                          const void* col, int vp, void* cand_out,
                          void* scratch, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* scalars = static_cast<int*>(scratch);
  cudaError_t err = cudaMemcpyFromSymbolAsync(
      scalars, kcore_wave_start, sizeof(kcore_wave_start), 0,
      cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess || vp <= 0) return static_cast<int>(err);
  int* block_min = static_cast<int*>(cand_out);
  int4* ranges = kcore_wave_ranges(scratch);
  kcore_level_wave_kernel<<<thread_blocks(vp), kBlock, 0, s>>>(
      static_cast<const int*>(deg), static_cast<const int*>(off), vp,
      scalars, block_min);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  kcore_level_peel_kernel<<<thread_blocks(vp), kBlock, 0, s>>>(
      static_cast<int*>(deg), static_cast<int*>(core),
      static_cast<const int*>(off), vp, scalars, block_min, ranges);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(kcore_wave_push(
      static_cast<int*>(deg), static_cast<const int*>(off),
      static_cast<const int*>(col), scalars, ranges,
      static_cast<int*>(cand_out), s));
}

// A cascade wave in place at level k from the n (>= 1) vertices of
// `cand_in`: two launches, the mark, the push.
int etpu_kcore_cascade_wave(void* deg, void* core, const void* off,
                            const void* col, int vp, int k,
                            const void* cand_in, int n, void* cand_out,
                            void* scratch, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* scalars = static_cast<int*>(scratch);
  cudaError_t err = cudaMemcpyFromSymbolAsync(
      scalars, kcore_wave_start, sizeof(kcore_wave_start), 0,
      cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess || n <= 0) return static_cast<int>(err);
  int4* ranges = kcore_wave_ranges(scratch);
  kcore_cascade_wave_kernel<<<thread_blocks(n), kBlock, 0, s>>>(
      static_cast<int*>(deg), static_cast<int*>(core),
      static_cast<const int*>(off), k, static_cast<const int*>(cand_in), n,
      scalars, ranges);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(kcore_wave_push(
      static_cast<int*>(deg), static_cast<const int*>(off),
      static_cast<const int*>(col), scalars, ranges,
      static_cast<int*>(cand_out), s));
}

// Slots per range of the sweeps' push lists; the Python wrapper sizes the
// lists with it and checks it against its own constant.
int etpu_push_split() { return kPushSplit; }

// One launch over ceil((vp + n) / kExpandTile) tiles; the wrapper keeps
// vp + n + kExpandTile within an int.
int etpu_expand_segments(const void* vals, const void* off, int vp, int n,
                         void* out, void* stream) {
  if (n > 0) {
    const int tiles = static_cast<int>(
        (static_cast<long long>(vp) + n + kExpandTile - 1) / kExpandTile);
    expand_segments_kernel<<<tiles, kBlock, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(vals), static_cast<const int*>(off), vp, n,
        static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// Merge places per expand_segments tile; the Python wrapper checks it
// against its own constant.
int etpu_expand_tile() { return kExpandTile; }

int etpu_collapse_starts(const void* exp, const void* off, int vp, int empty,
                         int source, void* out, void* stream) {
  if (vp > 0) {
    collapse_starts_kernel<<<etpu::starts_blocks(vp), etpu::kStartsBlock, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(exp), static_cast<const int*>(off), vp, empty,
        source, static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
