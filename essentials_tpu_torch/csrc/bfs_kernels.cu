// Hand-written CUDA kernels of the fused BFS main path, and the segment fills
// and route OR of fused_bfs.py that PageRank `fused` and the 5-pass BFS level
// use, for Hopper (sm_90a).
//
// Built by essentials_tpu_torch/kernels.py with nvcc into a shared library
// with a plain C interface and loaded with ctypes. Every entry point launches
// on the stream it is given, allocates nothing, and returns
// cudaGetLastError() so that a refused launch reaches the Python wrapper.
//
// Layout contract (essentials_tpu_torch/graph/graph.py): `off` is the graph's
// [Vp+1] int32 CSR offsets, equal to its CSC offsets on a symmetric layout;
// `csc_src` is the [Ep] int32 source of each CSC slot, sorted by (dst, src);
// `lev` is the [Ep] edge-axis level array, of which only the positions
// off[v] (segment starts) are read or written here.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kBlock = 256;                 // threads per block
constexpr int kWarpsPerBlock = kBlock / 32;
constexpr unsigned kFullMask = 0xffffffffu;

// One BFS level on the edge axis, with one warp per destination vertex v.
//
// Replaces the JAX package's three Pallas kernels of one level
// (essentials_tpu/ops/fused_bfs.py: _k1_fill_eq_kernel :327 or its byte-SWAR
// form :425, the Benes router middle cube_router._k2_wbc_kernel :330 /
// _k2_tfbc_kernel :363, and _k3_suffixor_update_kernel :384 or :451). There
// the CSR->CSC move is a static permutation because that device's gathers
// are element-serialized; here the source's level is loaded directly through
// csc_src and off.
//
// For each v with a non-empty segment whose start holds `unreached`: if any
// in-edge q in [off[v], off[v+1]) has lev[off[csc_src[q]]] == it, write it+1
// at off[v] and count v. The update is made in place: a concurrent reader
// sees either `unreached` or it+1 at a start, and neither equals `it`, so the
// level reads the same frontier whatever the order of the warps.
//
// What bounds it: each scanned in-edge costs three dependent loads, two of
// them scattered (off[src], then lev[...]), so the level is bound by the
// latency and sector traffic of random gathers, not by bandwidth. The warp
// leaves a vertex at the first 32-edge chunk that holds a frontier source,
// and reached vertices cost two loads. A hub's in-edges run on one warp,
// which leaves the load unbalanced on power-law graphs.
template <typename T>
__global__ void __launch_bounds__(kBlock)
bfs_level_kernel(T* __restrict__ lev, const int* __restrict__ off,
                 const int* __restrict__ csc_src, int vp, int it,
                 int unreached, int* __restrict__ count) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x) >> 5;
  bool newly = false;
  if (warp < vp) {                          // warp-uniform
    const int v = static_cast<int>(warp);
    const int b = off[v];
    const int e = off[v + 1];
    if (b < e && static_cast<int>(lev[b]) == unreached) {
      for (int base = b; base < e; base += 32) {   // warp-uniform bounds
        const int q = base + lane;
        const bool f = q < e && static_cast<int>(lev[off[csc_src[q]]]) == it;
        if (__any_sync(kFullMask, f)) {
          newly = true;
          break;
        }
      }
      if (newly && lane == 0) lev[b] = static_cast<T>(it + 1);
    }
  }
  // only lane 0 of each warp stands for its vertex in the count
  const int n = __syncthreads_count(newly && lane == 0);
  if (threadIdx.x == 0 && n > 0) atomicAdd(count, n);
}

// Edge-axis levels -> per-vertex distances, one thread per vertex.
//
// Replaces the routed collapse in essentials_tpu/ops/fused_bfs.py
// collapse_lev_exp (:706): permute.apply_plan over off_route_csr.inv_plan
// (cube_router K1/K2/K3, :305/:330/:318) followed by the "first" fill of
// scan_kernels._scan_kernel (:124). Here the segment start is one load.
//
// dist[v] = lev[off[v]] widened to int32 when the segment is non-empty and
// the level is below `unreached`, INT_MAX otherwise; dist[source] = 0.
// What bounds it: one strided gather of lev per vertex plus [Vp] int32
// reads and writes; it runs once per search.
template <typename T>
__global__ void __launch_bounds__(kBlock)
collapse_levels_kernel(const T* __restrict__ lev, const int* __restrict__ off,
                       int vp, int source, int unreached,
                       int* __restrict__ dist) {
  const int v = blockIdx.x * kBlock + threadIdx.x;
  if (v >= vp) return;
  const int b = off[v];
  int d = INT_MAX;
  if (b < off[v + 1]) {
    const int l = static_cast<int>(lev[b]);
    if (l < unreached) d = l;
  }
  dist[v] = v == source ? 0 : d;
}

// Smallest-id predecessor one level up, with one warp per vertex v.
//
// Replaces the MIN advance of essentials_tpu/algorithms/bfs.py
// predecessors_from_distances (:431): the cube-chain expand of dist over the
// edges (cube_router.apply_cube_chain, :586), the routed segmented MIN scan
// (scan_kernels._scan_kernel, :124) and the "first" pick.
//
// pred[v] = min csc_src[q] over real in-edges q < n_edges with
// dist[src] != INT_MAX and dist[src] + 1 == dist[v]; -1 when dist[v] is
// INT_MAX or 0, or when no such edge exists. dist[src] is tested against
// INT_MAX before the add, which would overflow. csc_src is sorted within a
// segment, so the lowest qualifying lane of the first chunk that qualifies
// holds the minimum and the warp stops there.
// What bounds it: as bfs_level, scattered dist[src] loads, once per search.
__global__ void __launch_bounds__(kBlock)
bfs_predecessors_kernel(const int* __restrict__ dist,
                        const int* __restrict__ off,
                        const int* __restrict__ csc_src, int vp, int n_edges,
                        int* __restrict__ pred) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x) >> 5;
  if (warp >= vp) return;                   // warp-uniform; no block sync
  const int v = static_cast<int>(warp);
  const int dv = dist[v];
  int best = -1;
  if (dv != INT_MAX && dv > 0) {
    const int b = off[v];
    const int e = min(off[v + 1], n_edges);
    for (int base = b; base < e; base += 32) {     // warp-uniform bounds
      const int q = base + lane;
      int s = 0;
      bool ok = false;
      if (q < e) {
        s = csc_src[q];
        const int ds = dist[s];
        ok = ds != INT_MAX && ds + 1 == dv;
      }
      const unsigned m = __ballot_sync(kFullMask, ok);
      if (m) {
        best = __shfl_sync(kFullMask, s, __ffs(m) - 1);
        break;
      }
    }
  }
  if (lane == 0) pred[v] = best;
}

// ------------------------------------------------- segment fills, route OR --
//
// Replace the JAX package's segment_broadcast_total (fused_bfs.py:262, body
// _fill_total_kernel :250), suffix_fill_update (:137, body
// _suffix_fill_update_kernel :67) and fused_route_or (:603: _k1_eq_kernel
// :173, a cube K2, _k3_segor_kernel :184). The Pallas bodies scan right to
// left over a descending grid (or left to right for the OR) and carry the
// nearest segment end (start) from block to block in SMEM.
//
// Blocks run in no order here, so each is three launches over tiles of
// kFillTile positions, 8 rounds of one position per thread (coalesced):
//   1. each block reduces its tile to the position of its marker nearest to
//      the tile's far side (fill: the first segment end; route: the last
//      frontier hit and the last segment start);
//   2. one block scans those in tile order (marks_carry): for each tile, the
//      nearest marker in the tiles beyond it;
//   3. each block scans its tile round by round from the far side (a
//      shuffle scan per warp, then the warps' totals), completes with the
//      carry, and writes.
// Every result is a position, not a sum, so it is exact for any 32-bit type.
//
// A fill position takes S at its segment's END: the first p' >= p with p' =
// n-1 or flags[p'+1] set (the last position always ends a segment, which is
// JAX's carry_start = 1). The route OR at q is 1 iff the last frontier hit
// at or before q (lev[eid[q']] == it) is at or after q's segment start (the
// last flag at or before q; position 0 always starts one).
//
// What bounds them: bytes. Passes 1 and 3 both read the flags; the fill
// reads S once per position (a segment's positions share one address), the
// route gathers lev through csc_edge_ids once and re-reads the hits it wrote.

constexpr int kFillItems = 8;               // rounds of kBlock positions
constexpr int kFillTile = kBlock * kFillItems;

__device__ __forceinline__ bool is_end(const unsigned char* flags, long long p,
                                       int n) {
  return p == n - 1 || flags[p + 1] != 0;
}

// Inclusive scan of one int per thread over the block in thread order: a
// running max (kForward) or a suffix min. Returns the thread's value and
// sets `total` to the whole block's; `sh` holds kWarpsPerBlock ints and is
// free again when this returns.
template <bool kForward>
__device__ int block_scan(int x, int* sh, int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    if (kForward) {
      const int y = __shfl_up_sync(kFullMask, x, d);
      if (lane >= d) x = max(x, y);
    } else {
      const int y = __shfl_down_sync(kFullMask, x, d);
      if (lane + d < 32) x = min(x, y);
    }
  }
  if (lane == (kForward ? 31 : 0)) sh[warp] = x;   // the warp's total
  __syncthreads();
  int t = kForward ? INT_MIN : INT_MAX;
  for (int w = 0; w < kWarpsPerBlock; ++w) {
    const int s = sh[w];
    if (kForward) {
      if (w < warp) x = max(x, s);
      t = max(t, s);
    } else {
      if (w > warp) x = min(x, s);
      t = min(t, s);
    }
  }
  __syncthreads();
  total = t;
  return x;
}

// Pass 1 of the fill: tile_end[b] = the first segment end in tile b, or
// INT_MAX.
__global__ void __launch_bounds__(kBlock)
fill_tile_ends_kernel(const unsigned char* __restrict__ flags, int n,
                      int* __restrict__ tile_end) {
  __shared__ int sh[kWarpsPerBlock];
  const long long t0 = static_cast<long long>(blockIdx.x) * kFillTile;
  int m = INT_MAX;
  for (int j = 0; j < kFillItems; ++j) {
    const long long p = t0 + j * kBlock + threadIdx.x;
    if (p < n && is_end(flags, p, n)) m = min(m, static_cast<int>(p));
  }
  int total;
  block_scan<false>(m, sh, total);
  if (threadIdx.x == 0) tile_end[blockIdx.x] = total;
}

// Pass 1 of the route OR: z[q] = (lev[eid[q]] == it), and per tile the last
// hit and the last segment start, or -1.
__global__ void __launch_bounds__(kBlock)
route_marks_kernel(const int* __restrict__ lev, const int* __restrict__ eid,
                   const unsigned char* __restrict__ flags, int n, int it,
                   int* __restrict__ z, int* __restrict__ tile_hit,
                   int* __restrict__ tile_start) {
  __shared__ int sh[kWarpsPerBlock];
  const long long t0 = static_cast<long long>(blockIdx.x) * kFillTile;
  int h = -1;
  int s = -1;
  for (int j = 0; j < kFillItems; ++j) {
    const long long p = t0 + j * kBlock + threadIdx.x;
    if (p < n) {
      const bool hit = lev[eid[p]] == it;
      z[p] = hit ? 1 : 0;
      if (hit) h = static_cast<int>(p);
      if (p == 0 || flags[p] != 0) s = static_cast<int>(p);
    }
  }
  int th;
  int ts;
  block_scan<true>(h, sh, th);
  block_scan<true>(s, sh, ts);
  if (threadIdx.x == 0) {
    tile_hit[blockIdx.x] = th;
    tile_start[blockIdx.x] = ts;
  }
}

// Pass 2, one block: out[t] = the max of in[0..t-1] (kForward; -1 for t =
// 0) or the min of in[t+1..g-1] (INT_MAX for the last tile), for `in0` and,
// when given, `in1`.
template <bool kForward>
__global__ void __launch_bounds__(kBlock)
marks_carry_kernel(const int* __restrict__ in0, const int* __restrict__ in1,
                   int* __restrict__ out0, int* __restrict__ out1, int g) {
  __shared__ int sh[kWarpsPerBlock];
  const int ident = kForward ? -1 : INT_MAX;
  const int chunks = (g + kBlock - 1) / kBlock;
  int c0 = ident;
  int c1 = ident;
  for (int c = 0; c < chunks; ++c) {
    const int base = (kForward ? c : chunks - 1 - c) * kBlock;
    const int t = base + threadIdx.x;
    const int src = kForward ? t - 1 : t + 1;     // the exclusive neighbour
    const bool in = src >= 0 && src < g;
    for (int k = 0; k < (in1 != nullptr ? 2 : 1); ++k) {   // block-uniform
      const int* a = k ? in1 : in0;
      int* o = k ? out1 : out0;
      int& carry = k ? c1 : c0;
      int total;
      int x = block_scan<kForward>(in ? a[src] : ident, sh, total);
      x = kForward ? max(x, carry) : min(x, carry);
      carry = kForward ? max(carry, total) : min(carry, total);
      if (t < g) o[t] = x;
    }
  }
}

// Pass 3 of the fill: out[p] = S[end(p)]. With kUpdate (suffix_fill_update)
// out[p] = it where that value, as int32, is above 0 and lev[p] is INT_MAX,
// else lev[p]; `any` gets 1 if some position changed (one atomic per block).
template <bool kUpdate>
__global__ void __launch_bounds__(kBlock)
fill_apply_kernel(const unsigned* __restrict__ s,
                  const unsigned char* __restrict__ flags,
                  const int* __restrict__ next_end, int n,
                  const int* __restrict__ lev, int it,
                  unsigned* __restrict__ out, int* __restrict__ any) {
  __shared__ int sh[kWarpsPerBlock];
  const long long t0 = static_cast<long long>(blockIdx.x) * kFillTile;
  int carry = next_end[blockIdx.x];
  bool newly = false;
  for (int j = kFillItems - 1; j >= 0; --j) {
    const long long p = t0 + j * kBlock + threadIdx.x;
    const int m = p < n && is_end(flags, p, n) ? static_cast<int>(p)
                                               : INT_MAX;
    int total;
    const int e = min(block_scan<false>(m, sh, total), carry);
    carry = min(carry, total);
    if (p < n) {
      const unsigned v = s[e];
      if (kUpdate) {
        const int l = lev[p];
        const bool nw = static_cast<int>(v) > 0 && l == INT_MAX;
        out[p] = static_cast<unsigned>(nw ? it : l);
        newly = newly || nw;
      } else {
        out[p] = v;
      }
    }
  }
  if (kUpdate) {
    if (__syncthreads_or(newly) && threadIdx.x == 0) atomicOr(any, 1);
  }
}

// Pass 3 of the route OR: z[q] (the hits of pass 1) becomes 1 iff the last
// hit at or before q lies at or after the last segment start at or before q.
__global__ void __launch_bounds__(kBlock)
route_or_apply_kernel(const unsigned char* __restrict__ flags, int n,
                      const int* __restrict__ prev_hit,
                      const int* __restrict__ prev_start,
                      int* __restrict__ z) {
  __shared__ int sh[kWarpsPerBlock];
  const long long t0 = static_cast<long long>(blockIdx.x) * kFillTile;
  int ch = prev_hit[blockIdx.x];
  int cs = prev_start[blockIdx.x];
  for (int j = 0; j < kFillItems; ++j) {
    const long long p = t0 + j * kBlock + threadIdx.x;
    const bool in = p < n;
    const int h = in && z[p] != 0 ? static_cast<int>(p) : -1;
    const int st = in && (p == 0 || flags[p] != 0) ? static_cast<int>(p) : -1;
    int th;
    int ts;
    const int hit = max(block_scan<true>(h, sh, th), ch);
    const int start = max(block_scan<true>(st, sh, ts), cs);
    ch = max(ch, th);
    cs = max(cs, ts);
    if (in) z[p] = hit >= start ? 1 : 0;
  }
}

int fill_tiles(int n) { return (n + kFillTile - 1) / kFillTile; }

int warp_blocks(int vp) { return (vp + kWarpsPerBlock - 1) / kWarpsPerBlock; }
int thread_blocks(int vp) { return (vp + kBlock - 1) / kBlock; }

template <typename T>
int launch_bfs_level(void* lev, const void* off, const void* csc_src, int vp,
                     int it, int unreached, void* count, void* stream) {
  if (vp > 0) {
    bfs_level_kernel<T><<<warp_blocks(vp), kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<T*>(lev), static_cast<const int*>(off),
        static_cast<const int*>(csc_src), vp, it, unreached,
        static_cast<int*>(count));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_collapse_levels(const void* lev, const void* off, int vp,
                           int source, int unreached, void* dist,
                           void* stream) {
  if (vp > 0) {
    collapse_levels_kernel<T><<<thread_blocks(vp), kBlock, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(lev), static_cast<const int*>(off), vp, source,
        unreached, static_cast<int*>(dist));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int etpu_bfs_level_i32(void* lev, const void* off, const void* csc_src,
                       int vp, int it, int unreached, void* count,
                       void* stream) {
  return launch_bfs_level<int32_t>(lev, off, csc_src, vp, it, unreached,
                                   count, stream);
}

int etpu_bfs_level_i8(void* lev, const void* off, const void* csc_src, int vp,
                      int it, int unreached, void* count, void* stream) {
  return launch_bfs_level<int8_t>(lev, off, csc_src, vp, it, unreached, count,
                                  stream);
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

int etpu_bfs_predecessors(const void* dist, const void* off,
                          const void* csc_src, int vp, int n_edges, void* pred,
                          void* stream) {
  if (vp > 0) {
    bfs_predecessors_kernel<<<warp_blocks(vp), kBlock, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(dist), static_cast<const int*>(off),
        static_cast<const int*>(csc_src), vp, n_edges,
        static_cast<int*>(pred));
  }
  return static_cast<int>(cudaGetLastError());
}

int etpu_fill_tile() { return kFillTile; }

// segment_broadcast_total (lev == nullptr) or suffix_fill_update. `scratch`
// holds 2 * fill_tiles(n) ints; `any` is zeroed by the caller.
int etpu_segment_fill(const void* s, const void* flags, int n, const void* lev,
                      int it, void* out, void* any, void* scratch,
                      void* stream) {
  if (n > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int g = fill_tiles(n);
    int* tile_end = static_cast<int*>(scratch);
    int* next_end = tile_end + g;
    const unsigned char* f = static_cast<const unsigned char*>(flags);
    fill_tile_ends_kernel<<<g, kBlock, 0, st>>>(f, n, tile_end);
    marks_carry_kernel<false><<<1, kBlock, 0, st>>>(tile_end, nullptr,
                                                    next_end, nullptr, g);
    if (lev == nullptr) {
      fill_apply_kernel<false><<<g, kBlock, 0, st>>>(
          static_cast<const unsigned*>(s), f, next_end, n, nullptr, 0,
          static_cast<unsigned*>(out), nullptr);
    } else {
      fill_apply_kernel<true><<<g, kBlock, 0, st>>>(
          static_cast<const unsigned*>(s), f, next_end, n,
          static_cast<const int*>(lev), it, static_cast<unsigned*>(out),
          static_cast<int*>(any));
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// fused_route_or: `scratch` holds 4 * fill_tiles(n) ints.
int etpu_route_or(const void* lev, const void* eid, const void* flags, int n,
                  int it, void* out, void* scratch, void* stream) {
  if (n > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int g = fill_tiles(n);
    int* tile_hit = static_cast<int*>(scratch);
    int* tile_start = tile_hit + g;
    int* prev_hit = tile_start + g;
    int* prev_start = prev_hit + g;
    const unsigned char* f = static_cast<const unsigned char*>(flags);
    int* z = static_cast<int*>(out);
    route_marks_kernel<<<g, kBlock, 0, st>>>(
        static_cast<const int*>(lev), static_cast<const int*>(eid), f, n, it,
        z, tile_hit, tile_start);
    marks_carry_kernel<true><<<1, kBlock, 0, st>>>(tile_hit, tile_start,
                                                   prev_hit, prev_start, g);
    route_or_apply_kernel<<<g, kBlock, 0, st>>>(f, n, prev_hit, prev_start,
                                                z);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
