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

// One k-core peel wave on the edge axis: a dense pass over the vertices,
// then a push from the vertices it peels.
//
// Replaces the JAX package's three Pallas kernels of one wave
// (essentials_tpu/ops/fused_kcore.py: _k1_fill_peel_kernel :78, the router
// middle cube_router._k2_wbc_kernel :330 / _k2_tfbc_kernel :363, and
// _k3_suffixsum_update_kernel :100), and their two scalar outputs. Those pull:
// every survivor counts its peeled in-neighbours, so every wave reads every
// survivor's in-edges. Here only the peeled vertices' edges are read, in the
// wave that peels them: about E edges over a whole run, not a rescan per
// wave.
//
// deg holds the remaining degree at each start, -1 once peeled. For v with a
// non-empty segment and d = deg_in[off[v]]:
//   0 <= d < k (peeled):  deg_out = -1, core_out = k - 1, counted;
//   d >= k (survivor):    deg_out = d - #{in-edges q : 0 <= deg_in[off[
//                         csc_src[q]]] < k}, core_out = core_in, and the
//                         new degree enters the minimum;
//   d < 0 (peeled before): both copied.
//
// kcore_sweep_kernel, one thread per vertex, writes every start as if
// nothing fell (a survivor's deg_out = d), counts the peeled (block count,
// one atomicAdd per block), folds the survivors' d into the minimum (block
// min, one atomicMin per block), and appends each peeled vertex's segment
// to a list as ranges of at most kPushSplit slots (one atomicAdd per warp).
// kcore_sweep_push_kernel then takes the ranges 32 at a time per warp (at
// most 1,024 slots: a wave's slots spread over many warps, a hub's over 63),
// a lane per slot and kPushItems slots in flight a lane: it loads u =
// csc_src[q] and, where u survives on deg_in, takes one from
// deg_out[off[u]] with atomicSub. On a symmetric layout
// (each edge u -> v has its v -> u, with multiplicity, as an undirected
// graph has) v's in-neighbours are its out-neighbours, so the subtractions
// are exactly the pull's counts. Each subtraction's result enters the
// minimum: a survivor's last one gives its new degree, the others more, and
// a survivor with none keeps its d, so min(survivors' d, every result) is
// the smallest new degree. Integer atomics are exact in any order: the
// results repeat bit for bit. The push follows the dense pass on the stream,
// so it sees every start written.
//
// scalars: {peeled, smallest surviving degree (INT_MAX when none survives),
// ranges listed, unused}; the entry point copies {0, INT_MAX, 0, 0} into
// them on the stream before the wave.
//
// What bounds it: a [Vp] pass (offsets, and the start's degree and core read
// and written at each vertex: one 32-byte sector each where segments are
// long), then per peeled slot its csc_src word and two scattered sectors,
// off[u] and deg_in / deg_out at u's start.
constexpr int kPushSplit = 32;              // slots per listed range
constexpr int kPushItems = 8;               // slots a lane has in flight

__global__ void __launch_bounds__(kBlock)
kcore_sweep_kernel(const int* __restrict__ deg_in,
                   const int* __restrict__ core_in, int* __restrict__ deg_out,
                   int* __restrict__ core_out, const int* __restrict__ off,
                   int vp, int k, int* __restrict__ scalars,
                   int2* __restrict__ ranges) {
  __shared__ int warp_min[kWarpsPerBlock];
  const int lane = threadIdx.x & 31;
  const int v = blockIdx.x * kBlock + threadIdx.x;
  bool peeled = false;
  int alive = INT_MAX;
  int b = 0;
  int e = 0;
  if (v < vp) {
    b = off[v];
    e = off[v + 1];
    if (b < e) {
      const int d = deg_in[b];
      if (d >= 0 && d < k) {
        peeled = true;
        deg_out[b] = -1;
        core_out[b] = k - 1;
      } else {
        deg_out[b] = d;
        core_out[b] = core_in[b];
        if (d >= 0) alive = d;
      }
    }
  }
  // the peeled segments' ranges, appended at one atomicAdd per warp
  const int nr = peeled ? (e - b + kPushSplit - 1) / kPushSplit : 0;
  int incl = nr;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int x = __shfl_up_sync(kFullMask, incl, d);
    if (lane >= d) incl += x;
  }
  int at = 0;
  if (lane == 31 && incl > 0) at = atomicAdd(&scalars[2], incl);
  at = __shfl_sync(kFullMask, at, 31) + incl - nr;
  for (int r = 0; r < nr; ++r) {
    const int q = b + r * kPushSplit;
    ranges[at + r] = make_int2(q, min(q + kPushSplit, e));
  }
  alive = __reduce_min_sync(kFullMask, alive);
  if (lane == 0) warp_min[threadIdx.x >> 5] = alive;
  // the count is also the barrier that publishes warp_min
  const int n = __syncthreads_count(peeled);
  if (threadIdx.x == 0) {
    if (n > 0) atomicAdd(&scalars[0], n);
    int m = warp_min[0];
    for (int i = 1; i < kWarpsPerBlock; ++i) m = min(m, warp_min[i]);
    if (m < INT_MAX) atomicMin(&scalars[1], m);
  }
}

__global__ void __launch_bounds__(kBlock)
kcore_sweep_push_kernel(const int* __restrict__ deg_in, int* deg_out,
                        const int* __restrict__ off,
                        const int* __restrict__ csc_src, int k,
                        int* scalars, const int2* __restrict__ ranges) {
  const int lane = threadIdx.x & 31;
  const int listed = scalars[2];            // written by the dense pass
  const long long step = 32LL * gridDim.x * kWarpsPerBlock;
  int least = INT_MAX;
  for (long long r0 = 32 * global_warp(); r0 < listed; r0 += step) {
    // lane l holds range r0 + l; its slots are the places [excl, incl) of
    // the warp's 32 ranges laid end to end
    int q0 = 0;
    int len = 0;
    if (r0 + lane < listed) {
      const int2 r = ranges[r0 + lane];
      q0 = r.x;
      len = r.y - r.x;
    }
    int incl = len;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int x = __shfl_up_sync(kFullMask, incl, d);
      if (lane >= d) incl += x;
    }
    const int total = __shfl_sync(kFullMask, incl, 31);
    const int shift = q0 - (incl - len);    // place t of the range: slot
                                            // t + shift
    for (int t0 = 0; t0 < total; t0 += 32 * kPushItems) {
      int q[kPushItems];
#pragma unroll
      for (int u = 0; u < kPushItems; ++u) {
        const int t = t0 + 32 * u + lane;
        int owner = 0;                      // the lanes whose ranges end by t
#pragma unroll
        for (int s = 16; s > 0; s >>= 1) {
          if (__shfl_sync(kFullMask, incl, owner + s - 1) <= t) owner += s;
        }
        const int sh = __shfl_sync(kFullMask, shift, owner);
        q[u] = t < total ? t + sh : -1;
      }
      int src[kPushItems];
#pragma unroll
      for (int u = 0; u < kPushItems; ++u) {
        src[u] = q[u] >= 0 ? csc_src[q[u]] : -1;
      }
      int at[kPushItems];
#pragma unroll
      for (int u = 0; u < kPushItems; ++u) {
        at[u] = src[u] >= 0 ? off[src[u]] : -1;
      }
#pragma unroll
      for (int u = 0; u < kPushItems; ++u) {
        if (at[u] >= 0 && deg_in[at[u]] >= k) {   // u survives this wave
          least = min(least, atomicSub(&deg_out[at[u]], 1) - 1);
        }
      }
    }
  }
  least = __reduce_min_sync(kFullMask, least);
  if (lane == 0 && least < INT_MAX) atomicMin(&scalars[1], least);
}

// kcore_sweep's scalars before a wave: {peeled, smallest surviving degree,
// ranges listed, unused}.
__device__ int kcore_scalars_start[4] = {0, INT_MAX, 0, 0};

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

// `scalars` ([4] int32, 16-byte aligned) is set to {0, INT_MAX, 0, 0} here
// by a device-to-device copy (no kernel launch), then filled; `ranges` holds
// room for vp + ceil(ep / etpu_kcore_push_split()) int2 (8-byte aligned).
// Two launches: the dense pass, then the push over the ranges it lists.
int etpu_kcore_sweep(const void* deg_in, const void* core_in, void* deg_out,
                     void* core_out, const void* off, const void* csc_src,
                     int vp, int k, void* scalars, void* ranges,
                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyFromSymbolAsync(
      scalars, kcore_scalars_start, sizeof(kcore_scalars_start), 0,
      cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess || vp <= 0) return static_cast<int>(err);
  int dev = 0;
  int sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  kcore_sweep_kernel<<<thread_blocks(vp), kBlock, 0, s>>>(
      static_cast<const int*>(deg_in), static_cast<const int*>(core_in),
      static_cast<int*>(deg_out), static_cast<int*>(core_out),
      static_cast<const int*>(off), vp, k, static_cast<int*>(scalars),
      static_cast<int2*>(ranges));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // a persistent grid: how many ranges the pass lists is known only on
  // the device
  kcore_sweep_push_kernel<<<4 * sms, kBlock, 0, s>>>(
      static_cast<const int*>(deg_in), static_cast<int*>(deg_out),
      static_cast<const int*>(off), static_cast<const int*>(csc_src), k,
      static_cast<int*>(scalars), static_cast<const int2*>(ranges));
  return static_cast<int>(cudaGetLastError());
}

// Slots per range of kcore_sweep's push list; the Python wrapper sizes the
// list with it and checks it against its own constant.
int etpu_kcore_push_split() { return kPushSplit; }

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
