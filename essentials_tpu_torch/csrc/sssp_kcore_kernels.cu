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
// CSC offsets on a symmetric layout; `csc_src` is the [Ep] int32 source of
// each CSC slot, sorted by (dst, src); `w` is the [Ep] float32 weight of each
// CSC slot (the graph's csc_values). Edge-axis state arrays are [Ep] int32
// of which only the positions off[v] (segment starts) are read or written.
//
// The sweeps read one buffer and write another (ping-pong). A min or a peel
// updated in place would let a vertex see a neighbour's state of the same
// sweep: SSSP would converge in other sweeps than the JAX package's Jacobi
// sweeps, and k-core would miss a neighbour peeled earlier in the sweep.
// Every non-empty start of the output is written in each sweep, so the
// buffers never need a copy.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kBlock = 256;                 // threads per block
constexpr int kWarpsPerBlock = kBlock / 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kInfBits = 0x7f800000;        // float32 +inf as int32 bits

__device__ __forceinline__ long long global_warp() {
  return (static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x) >> 5;
}

// One Bellman-Ford sweep on the edge axis, with one warp per destination v.
//
// Replaces the JAX package's three Pallas kernels of one sweep
// (essentials_tpu/ops/fused_sssp.py: _k1_fill_addw_kernel :74, the Benes
// router middle cube_router._k2_wbc_kernel :330 / _k2_tfbc_kernel :363, and
// _k3_suffixmin_update_kernel :98). There the CSR->CSC move is a static
// permutation because that device's gathers are element-serialized; here the
// source's distance is loaded directly through csc_src and off.
//
// Distances are float32 bit patterns in int32: non-negative floats order as
// their bits do, so the min runs on integers. For v with a non-empty segment:
//   s = min over in-edges q of bits(f32(dist_in[off[csc_src[q]]]) + w[q])
//   dist_out[off[v]] = s < dist_in[off[v]] ? s : dist_in[off[v]]
// and v is counted when s is smaller. The add is __fadd_rn, which nvcc does
// not contract, so the bits equal the plain version's and the JAX package's;
// +inf + w stays +inf.
//
// What bounds it: each in-edge costs a coalesced csc_src and w load and two
// dependent scattered loads (off[src], then dist_in[...]), so a sweep is
// bound by the latency and sector traffic of random gathers. Unlike
// bfs_level it cannot leave a segment early: the min needs every edge. A
// hub's in-edges run on one warp, which leaves the load unbalanced on
// power-law graphs; the loop is unrolled so that a lane keeps several
// gathers in flight.
__global__ void __launch_bounds__(kBlock)
sssp_sweep_kernel(const int* __restrict__ dist_in, int* __restrict__ dist_out,
                  const int* __restrict__ off, const int* __restrict__ csc_src,
                  const float* __restrict__ w, int vp,
                  int* __restrict__ count) {
  const int lane = threadIdx.x & 31;
  const long long warp = global_warp();
  bool improved = false;
  if (warp < vp) {                          // warp-uniform
    const int v = static_cast<int>(warp);
    const int b = off[v];
    const int e = off[v + 1];
    if (b < e) {                            // warp-uniform
      int s = kInfBits;
#pragma unroll 4
      for (int q = b + lane; q < e; q += 32) {
        const float du = __int_as_float(dist_in[off[csc_src[q]]]);
        s = min(s, __float_as_int(__fadd_rn(du, w[q])));
      }
      s = __reduce_min_sync(kFullMask, s);
      const int old = dist_in[b];
      improved = s < old;
      if (lane == 0) dist_out[b] = improved ? s : old;
    }
  }
  // only lane 0 of each warp stands for its vertex in the count
  const int n = __syncthreads_count(improved && lane == 0);
  if (threadIdx.x == 0 && n > 0) atomicAdd(count, n);
}

// Smallest-id shortest-path predecessor, with one warp per vertex v.
//
// Replaces the MIN advance of essentials_tpu/algorithms/sssp.py
// predecessors_from_distances (:133), which reaches the cube-chain expand
// (cube_router.apply_cube_chain, :586) and the routed segmented MIN scan
// (scan_kernels._scan_kernel, :124) on the TPU.
//
// pred[v] = min csc_src[q] over real in-edges q < n_edges with
// f32(dist[src] + w[q]) == dist[v] (float compare, __fadd_rn as in the
// sweep, so the edge that set dist[v] qualifies); -1 unless dist[v] is
// finite and above 0 and such an edge exists. csc_src is sorted within a
// segment, so the lowest qualifying lane of the first chunk that qualifies
// holds the minimum and the warp stops there.
// What bounds it: scattered dist[src] loads, once per search.
__global__ void __launch_bounds__(kBlock)
sssp_predecessors_kernel(const float* __restrict__ dist,
                         const int* __restrict__ off,
                         const int* __restrict__ csc_src,
                         const float* __restrict__ w, int vp, int n_edges,
                         int* __restrict__ pred) {
  const int lane = threadIdx.x & 31;
  const long long warp = global_warp();
  if (warp >= vp) return;                   // warp-uniform; no block sync
  const int v = static_cast<int>(warp);
  const float dv = dist[v];
  int best = -1;
  // finite and above 0: positive floats below +inf have smaller bits
  if (dv > 0.0f && __float_as_int(dv) < kInfBits) {
    const int b = off[v];
    const int e = min(off[v + 1], n_edges);
    for (int base = b; base < e; base += 32) {     // warp-uniform bounds
      const int q = base + lane;
      int s = 0;
      bool ok = false;
      if (q < e) {
        s = csc_src[q];
        ok = __fadd_rn(dist[s], w[q]) == dv;
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

// One k-core peel wave on the edge axis, with one warp per vertex v.
//
// Replaces the JAX package's three Pallas kernels of one wave
// (essentials_tpu/ops/fused_kcore.py: _k1_fill_peel_kernel :78, the router
// middle cube_router._k2_wbc_kernel :330 / _k2_tfbc_kernel :363, and
// _k3_suffixsum_update_kernel :100), and their two scalar outputs.
//
// deg holds the remaining degree at each start, -1 once peeled. For v with a
// non-empty segment and d = deg_in[off[v]]:
//   0 <= d < k (peeled):  deg_out = -1, core_out = k - 1, counted;
//   d >= k (survivor):    deg_out = d - #{in-edges q : 0 <= deg_in[off[
//                         csc_src[q]]] < k}, core_out = core_in, and the
//                         new degree enters the minimum;
//   d < 0 (peeled before): both copied.
// scalars[0] is the number peeled (block count, then one atomicAdd per
// block) and scalars[1] the smallest surviving new degree (block min, then
// one atomicMin per block; INT_MAX when none survives). The entry point
// copies {0, INT_MAX} into them on the stream before the sweep. (A ticket
// that lets the last block finish the scalars instead costs one more
// same-address atomic per block: +0.25 ms per wave on an H100 at RMAT scale
// 20, where a wave runs 131,072 blocks.)
//
// What bounds it: as sssp_sweep, two scattered loads per in-edge, but only
// survivors read their edges, so late waves, where few vertices are left,
// cost little more than the per-vertex loads and the launch.
__global__ void __launch_bounds__(kBlock)
kcore_sweep_kernel(const int* __restrict__ deg_in,
                   const int* __restrict__ core_in, int* __restrict__ deg_out,
                   int* __restrict__ core_out, const int* __restrict__ off,
                   const int* __restrict__ csc_src, int vp, int k,
                   int* __restrict__ scalars) {
  __shared__ int warp_min[kWarpsPerBlock];
  const int lane = threadIdx.x & 31;
  const long long warp = global_warp();
  bool peeled = false;
  int alive = INT_MAX;
  if (warp < vp) {                          // warp-uniform
    const int v = static_cast<int>(warp);
    const int b = off[v];
    const int e = off[v + 1];
    if (b < e) {                            // warp-uniform
      const int d = deg_in[b];
      int d2 = d;
      int c2 = core_in[b];
      if (d >= 0 && d < k) {
        peeled = true;
        d2 = -1;
        c2 = k - 1;
      } else if (d >= 0) {                  // warp-uniform
        int cnt = 0;
#pragma unroll 4
        for (int q = b + lane; q < e; q += 32) {
          const int du = deg_in[off[csc_src[q]]];
          cnt += (du >= 0 && du < k) ? 1 : 0;
        }
        d2 = d - __reduce_add_sync(kFullMask, cnt);
        alive = d2;
      }
      if (lane == 0) {
        deg_out[b] = d2;
        core_out[b] = c2;
      }
    }
  }
  if (lane == 0) warp_min[threadIdx.x >> 5] = alive;
  // the count is also the barrier that publishes warp_min
  const int n = __syncthreads_count(peeled && lane == 0);
  if (threadIdx.x == 0) {
    if (n > 0) atomicAdd(&scalars[0], n);
    int m = warp_min[0];
    for (int i = 1; i < kWarpsPerBlock; ++i) m = min(m, warp_min[i]);
    if (m < INT_MAX) atomicMin(&scalars[1], m);
  }
}

// kcore_sweep's scalars before a wave: {peeled, smallest surviving degree}.
__device__ int kcore_scalars_start[2] = {0, INT_MAX};

// Per-vertex values -> the edge axis, with one warp per segment v.
//
// Replaces the expansion of essentials_tpu/ops/segment.py
// expand_vertex_to_edges (:77), which k-core's init_deg_exp
// (essentials_tpu/ops/fused_kcore.py :253) calls: a scatter of per-vertex
// differences at the segment starts and a telescoping int32 cumsum over the
// edge axis, scan_kernels.scan_1d (:274) on the TPU. Here every slot of v's
// segment is written directly:
//   out[p] = vals[v] for off[v] <= p < min(off[v+1], n).
// What bounds it: [Ep] int32 of coalesced stores; a hub's segment runs on
// one warp. It runs once per k-core run.
__global__ void __launch_bounds__(kBlock)
expand_segments_kernel(const int* __restrict__ vals,
                       const int* __restrict__ off, int vp, int n,
                       int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warp = global_warp();
  if (warp >= vp) return;
  const int v = static_cast<int>(warp);
  const int x = vals[v];
  const int e = min(off[v + 1], n);
  for (int q = off[v] + lane; q < e; q += 32) out[q] = x;
}

// Edge-axis state -> per-vertex values, one thread per vertex.
//
// Replaces the routed collapses of essentials_tpu/ops/fused_sssp.py
// collapse_dist_exp (:244) and fused_kcore.py collapse_core_exp (:260):
// permute.apply_plan over off_route_csr.inv_plan (cube_router._pallas_apply
// :385) followed by the "first" fill of scan_kernels._scan_kernel (:124).
// Here the segment start is one load.
//
// out[v] = exp[off[v]] for a non-empty segment, `empty` otherwise;
// out[source] = 0 when source >= 0 (SSSP's source, whose segment may be
// empty). What bounds it: one strided gather per vertex plus [Vp] int32
// reads and writes; it runs once per search.
__global__ void __launch_bounds__(kBlock)
collapse_starts_kernel(const int* __restrict__ exp, const int* __restrict__ off,
                       int vp, int empty, int source, int* __restrict__ out) {
  const int v = blockIdx.x * kBlock + threadIdx.x;
  if (v >= vp) return;
  const int b = off[v];
  const int x = b < off[v + 1] ? exp[b] : empty;
  out[v] = v == source ? 0 : x;
}

int warp_blocks(int vp) { return (vp + kWarpsPerBlock - 1) / kWarpsPerBlock; }
int thread_blocks(int vp) { return (vp + kBlock - 1) / kBlock; }

}  // namespace

extern "C" {

// `count` ([1] int32) is set to 0 here, then counts the improved vertices.
int etpu_sssp_sweep(const void* dist_in, void* dist_out, const void* off,
                    const void* csc_src, const void* w, int vp, void* count,
                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(count, 0, sizeof(int), s);
  if (vp > 0) {
    sssp_sweep_kernel<<<warp_blocks(vp), kBlock, 0, s>>>(
        static_cast<const int*>(dist_in), static_cast<int*>(dist_out),
        static_cast<const int*>(off), static_cast<const int*>(csc_src),
        static_cast<const float*>(w), vp, static_cast<int*>(count));
  }
  return static_cast<int>(cudaGetLastError());
}

int etpu_sssp_predecessors(const void* dist, const void* off,
                           const void* csc_src, const void* w, int vp,
                           int n_edges, void* pred, void* stream) {
  if (vp > 0) {
    sssp_predecessors_kernel<<<warp_blocks(vp), kBlock, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(dist), static_cast<const int*>(off),
        static_cast<const int*>(csc_src), static_cast<const float*>(w), vp,
        n_edges, static_cast<int*>(pred));
  }
  return static_cast<int>(cudaGetLastError());
}

// `scalars` ([2] int32) is set to {0, INT_MAX} here by a device-to-device
// copy (no kernel launch), then filled.
int etpu_kcore_sweep(const void* deg_in, const void* core_in, void* deg_out,
                     void* core_out, const void* off, const void* csc_src,
                     int vp, int k, void* scalars, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyFromSymbolAsync(
      scalars, kcore_scalars_start, sizeof(kcore_scalars_start), 0,
      cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (vp > 0) {
    kcore_sweep_kernel<<<warp_blocks(vp), kBlock, 0, s>>>(
        static_cast<const int*>(deg_in), static_cast<const int*>(core_in),
        static_cast<int*>(deg_out), static_cast<int*>(core_out),
        static_cast<const int*>(off), static_cast<const int*>(csc_src), vp, k,
        static_cast<int*>(scalars));
  }
  return static_cast<int>(cudaGetLastError());
}

int etpu_expand_segments(const void* vals, const void* off, int vp, int n,
                         void* out, void* stream) {
  if (vp > 0) {
    expand_segments_kernel<<<warp_blocks(vp), kBlock, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(vals), static_cast<const int*>(off), vp, n,
        static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

int etpu_collapse_starts(const void* exp, const void* off, int vp, int empty,
                         int source, void* out, void* stream) {
  if (vp > 0) {
    collapse_starts_kernel<<<thread_blocks(vp), kBlock, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(exp), static_cast<const int*>(off), vp, empty,
        source, static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
