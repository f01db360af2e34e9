// Hand-written CUDA kernels of the fused BFS main path, and the segment fills
// of fused_bfs.py that PageRank `fused` and the 5-pass BFS level use, for
// Hopper (sm_90a). The 5-pass level's route OR is a tile scan
// (operator_kernels.cu, fused_route_or_kernel).
//
// Built by essentials_tpu_torch/kernels.py with nvcc into a shared library
// with a plain C interface and loaded with ctypes. Every entry point launches
// on the stream it is given, allocates nothing (bfs_level and the fill zero
// the scratch they are given with cudaMemsetAsync), and returns the CUDA
// status so that a refused launch reaches the Python wrapper.
//
// Layout contract (essentials_tpu_torch/graph/graph.py): `off` is the graph's
// [Vp+1] int32 CSR offsets, equal to its CSC offsets on a symmetric layout;
// `csc_src` is the [Ep] int32 source of each CSC slot, sorted by (dst, src);
// `col` is the [Ep] int32 column of each CSR slot; `lev` is the [Ep]
// edge-axis level array, of which only the positions off[v] (segment
// starts) are read or written here.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "first_hit.cuh"
#include "push_list.cuh"
#include "segment_starts.cuh"
#include "tile_status.cuh"

namespace {

constexpr int kBlock = 256;                 // threads per block
constexpr int kWarpsPerBlock = kBlock / 32;
constexpr unsigned kFullMask = 0xffffffffu;
using etpu::load_status;
using etpu::nonzero_bytes;
using etpu::publish_status;
using etpu::kPushItems;
using etpu::list_row;
using etpu::WarpRanges;

__device__ __forceinline__ long long global_warp() {
  return (static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x) >> 5;
}

// One BFS level on the edge axis: a pass over the vertices, then a push
// from the frontier or a pull into the unreached vertices, chosen on the
// card from the pass's sums.
//
// Replaces the JAX package's three Pallas kernels of one level
// (essentials_tpu/ops/fused_bfs.py: _k1_fill_eq_kernel :327 or its byte-SWAR
// form :425, the Benes router middle cube_router._k2_wbc_kernel :330 /
// _k2_tfbc_kernel :363, and _k3_suffixor_update_kernel :384 or :451). There
// every level tests every in-edge, through a static permutation, because
// that device's gathers are element-serialized.
//
// For each v with a non-empty segment whose start holds `unreached`: if an
// in-edge u -> v has u's start at `it`, v's start becomes it + 1 and v is
// counted. Four launches, in stream order:
// * bfs_level_kernel, the pass, a thread per vertex: reads each start once,
//   packs the frontier (start == it) and the unreached vertices into two
//   bitmaps of one bit a vertex, and sums the frontier's vertices n_f and
//   out-slots m_f and the unreached vertices' in-slots m_u;
// * bfs_level_list_kernel, where the push runs, lists the frontier's CSR
//   rows as ranges of kPushSplit slots (push_list.cuh), a thread per word
//   of the frontier's bitmap;
// * bfs_level_push_kernel walks the listed ranges through `col`, the
//   frontier's out-neighbours (on a symmetric layout a vertex's CSR row lies
//   at its segment, so these are the vertices whose pull would find it,
//   directed or not), and claims each unreached neighbour v by clearing its
//   bit with atomicAnd: the one thread that cleared it writes it + 1 at
//   off[v] and counts v, so an int8 level needs no byte atomics; a hub's
//   row spreads over many warps, and a short list over as many warps as it
//   has ranges (up to 32 ranges a warp);
// * bfs_level_pull_kernel visits only the unreached vertices (the set bits
//   of their bitmap), 8 lanes a vertex and 4 vertices a warp at once, reads
//   each in-edge's source from csc_src (coalesced) and tests its bit of the
//   frontier, held in shared memory ("shared" tier) or read through the L1
//   ("global" tier, a bitmap larger than a block's shared memory), and
//   leaves a vertex at its first hit.
// Under form kFormDevice the pull runs where m_f * alpha > m_u and n_f *
// beta >= vp (Beamer's direction-optimizing rules: the push reads m_f
// slots, the pull at most m_u, and a small frontier is pushed whatever its
// slots, since the pull's fixed cost is a pass over every unreached word)
// and the push elsewhere; kFormPush and kFormPull force one. The kernels
// of the other form return at once, so each level launches all four and
// reads nothing back. Both read the frontier from the pass's bitmap, made before
// any start is written, so the order of the writes does not matter; BFS
// levels are unique, so push and pull write the same starts and count the
// same vertices.
//
// What bounds it: the pass reads each start once (a 32-byte sector of the
// edge axis a vertex) and the offsets; the push reads the frontier rows'
// `col` and, per slot, a bitmap word (L2) and, per reached vertex, its
// offset and start; the pull reads the unreached segments' csc_src up to
// the first hit.

enum { kFormDevice = 0, kFormPush = 1, kFormPull = 2 };
constexpr int kPullBlock = 1024;            // threads per pull block
constexpr int kPullWarps = kPullBlock / 32;
constexpr int kPullGroup = 8;               // lanes per pulled vertex
constexpr int kPushBlocksPerSm = 4;

constexpr int kLevelScalars = 8;            // the scratch's first words

// scalars: {vertices reached, ranges listed, m_f, m_u, n_f, the form taken
// (kFormPush or kFormPull), 0, 0}; rule: {form, alpha, beta, vp}
struct LevelRule {
  int form;
  int alpha;
  int beta;
  int vp;
};

__device__ __forceinline__ bool level_pulls(const LevelRule& r,
                                            const int* scalars) {
  if (r.form != kFormDevice) return r.form == kFormPull;
  return static_cast<long long>(scalars[2]) * r.alpha > scalars[3] &&
         static_cast<long long>(scalars[4]) * r.beta >= r.vp;
}

// A thread per vertex v < 32 * words (words: the bitmaps' 32-bit words).
template <typename T>
__global__ void __launch_bounds__(kBlock)
bfs_level_kernel(const T* __restrict__ lev, const int* __restrict__ off,
                 int vp, int words, int it, int unreached,
                 unsigned* __restrict__ fbits, unsigned* __restrict__ ubits,
                 int* scalars) {
  __shared__ int s_sum[3][kWarpsPerBlock];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int v = blockIdx.x * kBlock + threadIdx.x;
  int b = 0;
  int e = 0;
  bool front = false;
  bool open = false;
  if (v < vp) {
    b = off[v];
    e = off[v + 1];
    if (b < e) {
      const int l = static_cast<int>(lev[b]);
      front = l == it;
      open = l == unreached;
    }
  }
  const unsigned fw = __ballot_sync(kFullMask, front);
  const unsigned uw = __ballot_sync(kFullMask, open);
  if (lane == 0 && (v >> 5) < words) {
    fbits[v >> 5] = fw;
    ubits[v >> 5] = uw;
  }
  const int mf = __reduce_add_sync(kFullMask, front ? e - b : 0);
  const int mu = __reduce_add_sync(kFullMask, open ? e - b : 0);
  if (lane == 0) {
    s_sum[0][wid] = mf;
    s_sum[1][wid] = mu;
    s_sum[2][wid] = __popc(fw);
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    int t = 0;
    for (int k = 0; k < kWarpsPerBlock; ++k) t += s_sum[threadIdx.x][k];
    if (t) atomicAdd(&scalars[2 + threadIdx.x], t);
  }
}

// A thread per 32-bit word of the frontier's bitmap, each set bit's row in
// turn; the warp lists its lanes' rows together. The first thread writes
// the form the level takes, the first launch to read the pass's whole sums.
__global__ void __launch_bounds__(kBlock)
bfs_level_list_kernel(const int* __restrict__ off, int words, LevelRule rule,
                      const unsigned* __restrict__ fbits, int* scalars,
                      int4* __restrict__ ranges) {
  const bool pulls = level_pulls(rule, scalars);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    scalars[5] = pulls ? kFormPull : kFormPush;
  }
  if (pulls) return;
  const int w = blockIdx.x * kBlock + threadIdx.x;
  unsigned bits = w < words ? fbits[w] : 0u;
  while (__any_sync(kFullMask, bits != 0)) {
    const bool on = bits != 0;
    int b = 0;
    int e = 0;
    if (on) {
      const int v = (w << 5) + __ffs(bits) - 1;
      bits &= bits - 1;
      b = off[v];
      e = off[v + 1];
    }
    list_row(on, b, e, 0, &scalars[1], ranges);
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
bfs_level_push_kernel(T* __restrict__ lev, const int* __restrict__ off,
                      const int* __restrict__ col, int it, LevelRule rule,
                      unsigned* ubits, int* scalars,
                      const int4* __restrict__ ranges) {
  if (level_pulls(rule, scalars)) return;
  const int lane = threadIdx.x & 31;
  const int listed = scalars[1];            // written by the list kernel
  // up to 32 ranges a warp: a short list spreads over as many warps
  const long long warps = static_cast<long long>(gridDim.x) * kWarpsPerBlock;
  const long long per = min(32LL, max(1LL, (listed + warps - 1) / warps));
  int reached = 0;
  for (long long r0 = per * global_warp(); r0 < listed; r0 += per * warps) {
    const WarpRanges wr(ranges, r0, static_cast<int>(min(r0 + per,
                                                         1LL * listed)));
    for (int t0 = 0; t0 < wr.total; t0 += 32 * kPushItems) {
      int v[kPushItems];
#pragma unroll
      for (int i = 0; i < kPushItems; ++i) {
        const int t = t0 + 32 * i + lane;
        const int sh = __shfl_sync(kFullMask, wr.shift, wr.owner(t));
        v[i] = t < wr.total ? __ldcs(col + t + sh) : -1;
      }
      unsigned w[kPushItems];
#pragma unroll
      for (int i = 0; i < kPushItems; ++i) {
        w[i] = v[i] >= 0 ? __ldcg(ubits + (v[i] >> 5)) : 0u;
      }
#pragma unroll
      for (int i = 0; i < kPushItems; ++i) {
        // a stale word only lets an atomic through that finds the bit clear
        const unsigned bit = 1u << (v[i] & 31);
        if ((w[i] & bit) && (atomicAnd(ubits + (v[i] >> 5), ~bit) & bit)) {
          lev[off[v[i]]] = static_cast<T>(it + 1);
          ++reached;
        }
      }
    }
  }
  reached = __reduce_add_sync(kFullMask, reached);
  if (lane == 0 && reached > 0) atomicAdd(&scalars[0], reached);
}

// A warp per 32-bit word of the unreached bitmap (grid-stride); its lanes in
// 4 groups of kPullGroup, group g taking the word's vertices 8g .. 8g + 7 in
// turn.
template <typename T, bool kShared>
__global__ void __launch_bounds__(kPullBlock, 2)
bfs_level_pull_kernel(T* __restrict__ lev, const int* __restrict__ off,
                      const int* __restrict__ csc_src, int words, int it,
                      LevelRule rule, const unsigned* __restrict__ fbits,
                      const unsigned* __restrict__ ubits, int* scalars) {
  extern __shared__ uint4 s_front4[];       // kShared: the frontier's bits
  if (!level_pulls(rule, scalars)) return;
  const unsigned* front = fbits;
  if constexpr (kShared) {
    const uint4* g4 = reinterpret_cast<const uint4*>(fbits);
    for (int i = threadIdx.x; i < words / 4; i += kPullBlock) {
      __pipeline_memcpy_async(s_front4 + i, g4 + i, sizeof(uint4));
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    front = reinterpret_cast<const unsigned*>(s_front4);
  }
  const int lane = threadIdx.x & 31;
  const int g = lane / kPullGroup;
  const int gl = lane % kPullGroup;
  int reached = 0;
  for (int w = blockIdx.x * kPullWarps + (threadIdx.x >> 5); w < words;
       w += gridDim.x * kPullWarps) {           // warp-uniform
    unsigned todo = (ubits[w] >> (kPullGroup * g)) & 0xffu;
    bool busy = false;                      // the group's vertex, uniform
    int b = 0;                              // in the group: its start,
    int q = 0;                              // its next slots and its end
    int e = 0;
    while (true) {
      if (!busy && todo) {
        const int v = (w << 5) + kPullGroup * g + __ffs(todo) - 1;
        todo &= todo - 1;
        b = off[v];
        q = b;
        e = off[v + 1];
        busy = true;
      }
      if (!__any_sync(kFullMask, busy)) break;
      bool hit = false;
      if (busy && q + gl < e) {
        const unsigned u = static_cast<unsigned>(__ldcs(csc_src + q + gl));
        hit = (front[u >> 5] >> (u & 31)) & 1u;
      }
      const unsigned hits =
          (__ballot_sync(kFullMask, hit) >> (kPullGroup * g)) & 0xffu;
      if (busy) {
        if (hits) {
          if (gl == 0) {
            lev[b] = static_cast<T>(it + 1);
            ++reached;
          }
          busy = false;
        } else {
          q += kPullGroup;
          busy = q < e;
        }
      }
    }
  }
  reached = __reduce_add_sync(kFullMask, reached);
  if (lane == 0 && reached > 0) atomicAdd(&scalars[0], reached);
}

// Edge-axis levels -> per-vertex distances, several segments a thread
// (segment_starts.cuh, the body of collapse_starts too).
//
// Replaces the routed collapse in essentials_tpu/ops/fused_bfs.py
// collapse_lev_exp (:706): permute.apply_plan over off_route_csr.inv_plan
// (cube_router K1/K2/K3, :305/:330/:318) followed by the "first" fill of
// scan_kernels._scan_kernel (:124). Here the segment start is one load.
//
// dist[v] = lev[off[v]] widened to int32 when the segment is non-empty and
// the level is below `unreached`, INT_MAX otherwise; dist[source] = 0.
// What bounds it: a sector of lev a non-empty segment, the [Vp+1] offsets
// and the [Vp] output; it runs once per search.
template <typename T>
struct LevelAt {
  int unreached;
  __device__ int operator()(T l) const {
    return l < unreached ? static_cast<int>(l) : INT_MAX;
  }
  __device__ int empty() const { return INT_MAX; }
};

template <typename T>
__global__ void __launch_bounds__(etpu::kStartsBlock)
collapse_levels_kernel(const T* __restrict__ lev, const int* __restrict__ off,
                       int vp, int source, int unreached,
                       int* __restrict__ dist) {
  etpu::collapse_segment_starts(lev, off, vp, source, LevelAt<T>{unreached},
                                dist);
}

// Smallest-id predecessor one level up: the first walk and the range walk
// of first_hit.cuh.
//
// Replaces the MIN advance of essentials_tpu/algorithms/bfs.py
// predecessors_from_distances (:431): the cube-chain expand of dist over the
// edges (cube_router.apply_cube_chain, :586), the routed segmented MIN scan
// (scan_kernels._scan_kernel, :124) and the "first" pick.
//
// pred[v] = min csc_src[q] over real in-edges q < n_edges with
// dist[src] != INT_MAX and dist[src] + 1 == dist[v]; -1 when dist[v] is
// INT_MAX or 0, or when no such edge exists. dist[src] is tested against
// INT_MAX before the add, which would overflow.
// What bounds it: csc_src up to each reached vertex's first hit, a
// scattered dist[src] sector per slot read, pred written; once per search.
struct BfsHit {
  using Dist = int;
  using Weight = int;                       // no word per slot
  const int* __restrict__ dist;

  __device__ static bool reached(int dv) { return dv != INT_MAX && dv > 0; }
  __device__ static int bits(int dv) { return dv; }
  __device__ static int from_bits(int x) { return x; }
  __device__ int weight(int) const { return 0; }
  __device__ bool qualifies(int s, int, int dv) const {
    const int ds = dist[s];
    return ds != INT_MAX && ds + 1 == dv;
  }
};

__global__ void __launch_bounds__(etpu::kHitBlock)
bfs_predecessors_kernel(BfsHit hit, const int* __restrict__ off,
                        const int* __restrict__ csc_src, int vp, int n_edges,
                        int split, int* __restrict__ pred,
                        int* __restrict__ listed, int4* __restrict__ ranges) {
  etpu::first_walk(hit, off, csc_src, vp, n_edges, split, pred, listed,
                   ranges);
}

__global__ void __launch_bounds__(etpu::kHitBlock)
bfs_predecessors_ranges_kernel(BfsHit hit, const int* __restrict__ csc_src,
                               int* pred, const int* __restrict__ listed,
                               const int4* __restrict__ ranges) {
  etpu::range_walk(hit, csc_src, pred, listed, ranges);
}

// ---------------------------------------------------------- segment fills --
//
// Replace the JAX package's segment_broadcast_total (fused_bfs.py:262, body
// _fill_total_kernel :250) and suffix_fill_update (:137, body
// _suffix_fill_update_kernel :67). The Pallas bodies scan right to left
// over a descending grid and carry the nearest segment end from block to
// block in SMEM. Every result is a position, not a sum, so it is exact in
// any order and for any 32-bit type.
//
// A fill position takes S at its segment's END: the first p' >= p with p' =
// n-1 or flags[p'+1] set (the last position always ends a segment, which is
// JAX's carry_start = 1).
//
// The fill is one launch over tiles of kFillTile positions, handed out from
// the far end by an atomic ticket (ticket t takes tile g-1-t, as the JAX
// package's descending grid runs), so a tile's carry lies to its right, in
// tiles that already run. Each thread takes kFillItems consecutive
// positions and reads their flags as one 16-byte word, the next thread's
// first flag by a shuffle; it finds each position's next end within itself
// by a bit scan, then the first end after it by a suffix min over the warp
// (__shfl_down_sync) and over the warps (shared memory): two barriers a
// tile. The tile publishes its first end (or "none") in its 64-bit status
// word at once; positions after its last end take the first end published
// by the tiles after it, which one warp reads 32 at a time and stops at the
// first tile that has one. A tile without an end of its own then publishes
// the end it found, so a segment across many tiles is not walked again by
// each of them (a decoupled look-forward). Each position reads S[end(p)]:
// a segment's positions share one address, so S costs about one sector per
// segment; out (and the update's lev) move by 16-byte vectors.
//
// What bounds them: bytes. The fill reads the flags once and S about once
// per segment, and writes out once (the update also reads lev).

constexpr int kFillItems = 16;              // consecutive positions a thread
constexpr int kFillTile = kBlock * kFillItems;
// a fill tile's status word, bits 32-33: not yet published; no segment end
// in the tile and none found after it yet; the first end at or after the
// tile (bits 0-31)
enum FillState : unsigned { kFillUnset = 0, kFillNone = 1, kFillEnd = 2 };

// out[p] = S[end(p)]; with kUpdate (suffix_fill_update) out[p] = it where
// that value, as int32, is above 0 and lev[p] is INT_MAX, else lev[p], and
// `any` gets 1 if some position changed (one atomic per block). `vec`: out,
// lev and flags are 16-byte aligned.
template <bool kUpdate>
__device__ __forceinline__ void segment_fill(
    const unsigned* __restrict__ s, const unsigned char* __restrict__ flags,
    int n, const int* __restrict__ lev, int it, unsigned* __restrict__ out,
    bool vec, unsigned long long* status, unsigned* ticket, int* any) {
  __shared__ int s_wmin[kWarpsPerBlock];
  __shared__ int s_b, s_need, s_carry;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) {
    s_b = static_cast<int>(gridDim.x - 1 - atomicAdd(ticket, 1u));
  }
  __syncthreads();
  const int b = s_b;
  const long long p0 = static_cast<long long>(b) * kFillTile +
                       static_cast<long long>(tid) * kFillItems;
  const bool whole = vec && p0 + kFillItems <= n;

  // bit j of fm: flags[p0 + j] is set; of em: p0 + j ends a segment (or
  // lies at or past n - 1)
  unsigned fm = 0;
  if (whole) {
    const uint4 w = *reinterpret_cast<const uint4*>(flags + p0);
    fm = nonzero_bytes(w.x) | nonzero_bytes(w.y) << 4 |
         nonzero_bytes(w.z) << 8 | nonzero_bytes(w.w) << 12;
  } else {
    for (int j = 0; j < kFillItems; ++j) {
      if (p0 + j < n && flags[p0 + j] != 0) fm |= 1u << j;
    }
  }
  unsigned next = __shfl_down_sync(kFullMask, fm, 1) & 1u;
  if (lane == 31) {
    const long long q = p0 + kFillItems;
    next = q < n && flags[q] != 0;
  }
  unsigned em = fm >> 1 | next << (kFillItems - 1);
  const long long last = static_cast<long long>(n) - 1;
  if (p0 + kFillItems > last) {
    em |= ~0u << static_cast<int>(max(last - p0, 0ll));
  }
  em &= (1u << kFillItems) - 1u;

  // the first end after this thread within the tile: a suffix min of the
  // threads' first ends
  const int own = em ? static_cast<int>(p0) + __ffs(em) - 1 : INT_MAX;
  int incl = own;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_down_sync(kFullMask, incl, d);
    if (lane + d < 32) incl = min(incl, y);
  }
  int after = __shfl_down_sync(kFullMask, incl, 1);
  if (lane == 31) after = INT_MAX;
  if (lane == 0) s_wmin[warp] = incl;
  if (tid == kBlock - 1) s_need = !(em >> (kFillItems - 1) & 1u);
  __syncthreads();
  int first = INT_MAX;                      // the tile's first end
  for (int i = 0; i < kWarpsPerBlock; ++i) {
    if (i > warp) after = min(after, s_wmin[i]);
    first = min(first, s_wmin[i]);
  }

  // publish the tile's first end, then (one warp) find the first end after
  // the tile where its last position ends no segment
  if (tid == 0) {
    publish_status(status + b, first != INT_MAX ? kFillEnd : kFillNone,
                   static_cast<unsigned>(first));
  }
  if (s_need && warp == 0) {                // never on the last tile
    int found = INT_MAX;
    for (int k = b + 1; found == INT_MAX; k += 32) {   // warp-uniform
      const int t = k + lane;
      unsigned long long st = 0;
      if (t < static_cast<int>(gridDim.x)) {
        while (((st = load_status(status + t)) >> 32) == kFillUnset) {
          __nanosleep(32);
        }
      }
      const unsigned hit = __ballot_sync(kFullMask, (st >> 32) == kFillEnd);
      if (hit) {
        found = __shfl_sync(kFullMask, static_cast<int>(st), __ffs(hit) - 1);
      }
    }
    if (lane == 0) {
      s_carry = found;
      if (first == INT_MAX) {
        publish_status(status + b, kFillEnd, static_cast<unsigned>(found));
      }
    }
  }
  __syncthreads();
  if (after == INT_MAX && s_need) after = s_carry;

  // every position's end, S there, and the stores
  unsigned vals[kFillItems];
  int prev_end = -1;
  unsigned sv = 0;
#pragma unroll
  for (int j = 0; j < kFillItems; ++j) {
    const unsigned rest = em >> j;
    const int e = rest ? static_cast<int>(p0) + j + __ffs(rest) - 1 : after;
    if (e != prev_end && p0 + j < n) {
      sv = __ldg(s + e);
      prev_end = e;
    }
    vals[j] = sv;
  }
  bool newly = false;
  if (kUpdate) {
    int l[kFillItems];
    if (whole) {
      const int4* lq = reinterpret_cast<const int4*>(lev + p0);
#pragma unroll
      for (int q = 0; q < kFillItems / 4; ++q) {
        const int4 w = __ldcs(lq + q);
        l[4 * q] = w.x;
        l[4 * q + 1] = w.y;
        l[4 * q + 2] = w.z;
        l[4 * q + 3] = w.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kFillItems; ++j) {
        l[j] = p0 + j < n ? lev[p0 + j] : 0;
      }
    }
#pragma unroll
    for (int j = 0; j < kFillItems; ++j) {
      const bool nw = static_cast<int>(vals[j]) > 0 && l[j] == INT_MAX &&
                      p0 + j < n;
      vals[j] = static_cast<unsigned>(nw ? it : l[j]);
      newly = newly || nw;
    }
  }
  if (whole) {
    uint4* oq = reinterpret_cast<uint4*>(out + p0);
#pragma unroll
    for (int q = 0; q < kFillItems / 4; ++q) {
      __stcs(oq + q, make_uint4(vals[4 * q], vals[4 * q + 1],
                                vals[4 * q + 2], vals[4 * q + 3]));
    }
  } else {
#pragma unroll
    for (int j = 0; j < kFillItems; ++j) {
      if (p0 + j < n) out[p0 + j] = vals[j];
    }
  }
  if (kUpdate) {
    if (__syncthreads_or(newly) && tid == 0) atomicOr(any, 1);
  }
}

// The two forms under the names of their launch counts
// (chip_smoke.profile matches device kernels to kernels.launches by name).
__global__ void __launch_bounds__(kBlock)
segment_broadcast_total_kernel(const unsigned* __restrict__ s,
                               const unsigned char* __restrict__ flags, int n,
                               unsigned* __restrict__ out, bool vec,
                               unsigned long long* status, unsigned* ticket) {
  segment_fill<false>(s, flags, n, nullptr, 0, out, vec, status, ticket,
                      nullptr);
}

__global__ void __launch_bounds__(kBlock)
suffix_fill_update_kernel(const unsigned* __restrict__ s,
                          const unsigned char* __restrict__ flags, int n,
                          const int* __restrict__ lev, int it,
                          unsigned* __restrict__ out, bool vec,
                          unsigned long long* status, unsigned* ticket,
                          int* any) {
  segment_fill<true>(s, flags, n, lev, it, out, vec, status, ticket, any);
}

int fill_tiles(int n) { return (n + kFillTile - 1) / kFillTile; }

cudaError_t sm_count(int* sms) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

template <typename T, bool kShared>
cudaError_t launch_pull(T* lev, const int* off, const int* csc_src,
                        int words, int it, const LevelRule& rule,
                        const unsigned* fbits, const unsigned* ubits,
                        int* scalars, int sms, cudaStream_t s) {
  const int bytes = kShared ? static_cast<int>(sizeof(unsigned)) * words : 0;
  cudaError_t err = cudaFuncSetAttribute(
      bfs_level_pull_kernel<T, kShared>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bfs_level_pull_kernel<T, kShared>, kPullBlock, bytes);
  }
  if (err != cudaSuccess) return err;
  const int grid = max(1, min(max(per_sm, 1) * sms,
                              (words + kPullWarps - 1) / kPullWarps));
  bfs_level_pull_kernel<T, kShared><<<grid, kPullBlock, bytes, s>>>(
      lev, off, csc_src, words, it, rule, fbits, ubits, scalars);
  return cudaGetLastError();
}

// scratch (int32, 16-byte aligned): the kLevelScalars scalars, the
// frontier's and the unreached vertices' bitmaps of `words` = 4 ceil(vp /
// 128) words each, then room for the listed ranges (int4); the scalars are
// zeroed here.
template <typename T>
int launch_bfs_level(void* lev_, const void* off_, const void* csc_src,
                     const void* col, int vp, int it, int unreached, int form,
                     int alpha, int beta, int shared, void* scratch,
                     void* stream) {
  if (vp <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* lev = static_cast<T*>(lev_);
  const int* off = static_cast<const int*>(off_);
  const int words = 4 * ((vp + 127) / 128);
  int* scalars = static_cast<int*>(scratch);
  unsigned* fbits = reinterpret_cast<unsigned*>(scalars + kLevelScalars);
  unsigned* ubits = fbits + words;
  int4* ranges = reinterpret_cast<int4*>(ubits + words);
  const LevelRule rule = {form, alpha, beta, vp};
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err == cudaSuccess) {
    err = cudaMemsetAsync(scalars, 0, kLevelScalars * sizeof(int), s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  bfs_level_kernel<T><<<(32 * words + kBlock - 1) / kBlock, kBlock, 0, s>>>(
      lev, off, vp, words, it, unreached, fbits, ubits, scalars);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bfs_level_list_kernel<<<(words + kBlock - 1) / kBlock, kBlock, 0, s>>>(
      off, words, rule, fbits, scalars, ranges);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bfs_level_push_kernel<T><<<kPushBlocksPerSm * sms, kBlock, 0, s>>>(
      lev, off, static_cast<const int*>(col), it, rule, ubits, scalars,
      ranges);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int* src = static_cast<const int*>(csc_src);
  err = shared ? launch_pull<T, true>(lev, off, src, words, it, rule, fbits,
                                      ubits, scalars, sms, s)
               : launch_pull<T, false>(lev, off, src, words, it, rule, fbits,
                                       ubits, scalars, sms, s);
  return static_cast<int>(err);
}

template <typename T>
int launch_collapse_levels(const void* lev, const void* off, int vp,
                           int source, int unreached, void* dist,
                           void* stream) {
  if (vp > 0) {
    collapse_levels_kernel<T><<<etpu::starts_blocks(vp), etpu::kStartsBlock,
                                0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(lev), static_cast<const int*>(off), vp, source,
        unreached, static_cast<int*>(dist));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// form: 0 the card's choice per level (pull where m_f * alpha > m_u and
// n_f * beta >= vp), 1 push, 2 pull; shared: 1 to hold the frontier's
// bitmap in shared memory
// (its 16 ceil(vp / 128) bytes must not pass the opt-in limit), 0 to read
// it through the L1. scratch: see launch_bfs_level; the count of reached
// vertices is its first word.
int etpu_bfs_level_i32(void* lev, const void* off, const void* csc_src,
                       const void* col, int vp, int it, int unreached,
                       int form, int alpha, int beta, int shared,
                       void* scratch, void* stream) {
  return launch_bfs_level<int32_t>(lev, off, csc_src, col, vp, it, unreached,
                                   form, alpha, beta, shared, scratch,
                                   stream);
}

int etpu_bfs_level_i8(void* lev, const void* off, const void* csc_src,
                      const void* col, int vp, int it, int unreached,
                      int form, int alpha, int beta, int shared,
                      void* scratch, void* stream) {
  return launch_bfs_level<int8_t>(lev, off, csc_src, col, vp, it, unreached,
                                  form, alpha, beta, shared, scratch, stream);
}

// The scalar words at the head of bfs_level's scratch (the count first).
int etpu_bfs_level_scalars() { return kLevelScalars; }

// Copies the first n of those words (the count, the ranges listed, m_f,
// m_u, n_f, the form taken) to the host array `dst` once the work before on
// `stream` has written them: a level's one read.
int etpu_read_level_scalars(int* dst, const void* scratch, int n,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyAsync(dst, scratch, n * sizeof(int),
                                    cudaMemcpyDeviceToHost, s);
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  return static_cast<int>(err);
}

int etpu_collapse_levels_i32(const void* lev, const void* off, int vp,
                             int source, int unreached, void* dist,
                             void* stream) {
  return launch_collapse_levels<int32_t>(lev, off, vp, source, unreached,
                                         dist, stream);
}

int etpu_collapse_levels_i8(const void* lev, const void* off, int vp,
                            int source, int unreached, void* dist,
                            void* stream) {
  return launch_collapse_levels<int8_t>(lev, off, vp, source, unreached, dist,
                                        stream);
}

// `scratch` as first_hit.cuh's launch_first_hits takes it: room for
// csc_src's slots / split + 1 ranges after 4 words.
int etpu_bfs_predecessors(const void* dist, const void* off,
                          const void* csc_src, int vp, int n_edges, int split,
                          void* pred, void* scratch, void* stream) {
  const BfsHit hit = {static_cast<const int*>(dist)};
  return static_cast<int>(etpu::launch_first_hits(
      hit, bfs_predecessors_kernel, bfs_predecessors_ranges_kernel,
      static_cast<const int*>(off), static_cast<const int*>(csc_src), vp,
      n_edges, split, static_cast<int*>(pred), scratch,
      static_cast<cudaStream_t>(stream)));
}

int etpu_fill_tile() { return kFillTile; }

// segment_broadcast_total (lev == nullptr) or suffix_fill_update, one
// launch. `scratch`: 8 * fill_tiles(n) + 8 bytes, 8-byte aligned: the
// tiles' status words, the ticket, and the update's any-flag (int32, 1 if
// some position changed), all zeroed here on the stream before the launch.
int etpu_segment_fill(const void* s, const void* flags, int n, const void* lev,
                      int it, void* out, void* scratch, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = n > 0 ? fill_tiles(n) : 0;
  auto* status = static_cast<unsigned long long*>(scratch);
  auto* ticket = reinterpret_cast<unsigned*>(status + g);
  const cudaError_t err = cudaMemsetAsync(
      scratch, 0, sizeof(unsigned long long) * g + 2 * sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const bool vec = ((reinterpret_cast<uintptr_t>(flags) |
                       reinterpret_cast<uintptr_t>(out) |
                       reinterpret_cast<uintptr_t>(lev)) & 15u) == 0;
    const auto* sv = static_cast<const unsigned*>(s);
    const auto* f = static_cast<const unsigned char*>(flags);
    auto* o = static_cast<unsigned*>(out);
    if (lev == nullptr) {
      segment_broadcast_total_kernel<<<g, kBlock, 0, st>>>(sv, f, n, o, vec,
                                                           status, ticket);
    } else {
      suffix_fill_update_kernel<<<g, kBlock, 0, st>>>(
          sv, f, n, static_cast<const int*>(lev), it, o, vec, status, ticket,
          reinterpret_cast<int*>(ticket + 1));
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
