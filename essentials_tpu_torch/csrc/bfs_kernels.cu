// Hand-written CUDA kernels of the fused BFS main path, for Hopper (sm_90a).
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

}  // extern "C"
