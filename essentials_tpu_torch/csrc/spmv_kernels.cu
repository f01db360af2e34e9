// Hand-written CUDA kernels of the SpMV path (y = A x), for Hopper (sm_90a).
//
// Built by essentials_tpu_torch/kernels.py with nvcc, together with every
// other csrc/*.cu, into one shared library with a plain C interface, loaded
// with ctypes. Every entry point launches on the stream it is given,
// allocates nothing (spmv_rows and spmv_slabs zero the scratch they are
// given with cudaMemsetAsync), and returns the CUDA status so that a refused launch
// reaches the Python wrapper.
//
// Layout contract (essentials_tpu_torch/graph/graph.py): `off` is the graph's
// [Vp+1] int32 CSR offsets, `col` the [Ep] int32 destination of each CSR
// edge, `w` the [Ep] float32 weight of each CSR edge (0 on pad edges),
// `flags` the [Ep] byte csr_seg_flags (1 at the first edge of each non-empty
// row), `x` the [Vp] float32 vector. Row r owns the edges [off[r], off[r+1]).
//
// Every product is __fmul_rn and every sum __fadd_rn, so nvcc contracts
// nothing into an FMA: a `mul` message is the same rounded float32 product
// as the plain PyTorch version's and the JAX package's, and only the order
// of the sums differs. No float atomics (the only atomics are the two
// kernels' tickets and hand-off words): each output is summed in a fixed order, so two
// launches on the same inputs give the same bits.

#include <cuda_runtime.h>
#include <atomic>
#include <climits>
#include <cstdint>

#include "tile_status.cuh"
#include "warp_search.cuh"

namespace {

constexpr int kBlock = 256;                 // threads per block
constexpr int kWarpsPerBlock = kBlock / 32;
constexpr int kItems = 16;                  // edges per thread in spmv_slabs
constexpr int kSlab = kBlock * kItems;      // edges per block in spmv_slabs
constexpr int kRowItems = 8;                // merge places per spmv_rows thread
constexpr int kRowTile = kBlock * kRowItems;   // merge places per block
constexpr int kRowQuads = kRowTile / (4 * kBlock);   // col quads a thread
// spmv_rows' preferred shared-memory carveout, in percent of the SM's
// largest: room for the 8.3 KB of each of the 6 blocks an SM holds at 40
// registers a thread, the rest left to L1, which serves the x gathers of
// the hot columns
constexpr int kRowCarveout = 30;
constexpr unsigned kFullMask = 0xffffffffu;
using etpu::bits_of;
using etpu::from_bits;
constexpr int kInfBits = 0x7f800000;        // float32 +inf as int32 bits

enum Msg { kMul = 0, kAdd = 1, kNone = 2 };
// spmv_rows' status word of a block (bits 32-33): not yet published; no row
// leaves the block; the block lies inside the row that leaves it; that row
// starts in the block. Its low 32 bits: the row's partial in the block.
enum Kind : unsigned { kUnset = 0, kNoTail = 1, kInside = 2, kStarts = 3 };
enum Red { kSum = 0, kMin = 1 };

// The message of an edge with x[col] = xv and weight wv: xv * wv, xv + wv
// or xv (wv is not read).
template <int M>
__device__ __forceinline__ float message(float xv, float wv) {
  if constexpr (M == kMul) return __fmul_rn(xv, wv);
  if constexpr (M == kAdd) return __fadd_rn(xv, wv);
  return xv;
}

// The reduction: float32 sum, or the minimum of int32 bit patterns (the
// float32 order for non-negative values, windowed_spmv.py:399-400).
template <int R> struct Op;
template <> struct Op<kSum> {
  using T = float;
  static __device__ __forceinline__ T ident() { return 0.0f; }
  static __device__ __forceinline__ T apply(T a, T b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ T of(float m) { return m; }
};
template <> struct Op<kMin> {
  using T = int;
  static __device__ __forceinline__ T ident() { return kInfBits; }
  static __device__ __forceinline__ T apply(T a, T b) { return min(a, b); }
  static __device__ __forceinline__ T of(float m) { return __float_as_int(m); }
};

// Shared-memory index with one spare word per 32: a thread's kItems
// consecutive items then fall in distinct banks.
__device__ __forceinline__ int sidx(int i) { return i + (i >> 5); }

// The hand-off between neighbouring slabs: status[b] holds, once bit 32 is
// set, the running value of the row that crosses out of slab b (its low 32
// bits). Both sides are atomics, which meet in the L2.
template <typename T>
__device__ __forceinline__ void publish(unsigned long long* status, int b,
                                        T v) {
  atomicExch(status + b, (1ull << 32) | bits_of(v));
}
template <typename T>
__device__ __forceinline__ T wait_for(unsigned long long* status, int b) {
  unsigned long long s;
  while (((s = atomicAdd(status + b, 0ull)) >> 32) == 0) __nanosleep(32);
  return from_bits<T>(static_cast<unsigned>(s));
}

// y = A x balanced by edges, in one launch: one block per slab of kSlab
// CSR edges, each thread kItems consecutive edges; a row that crosses slab
// boundaries is completed by a hand-off from slab to slab.
//
// Replaces the JAX package's windowed pipeline
// (essentials_tpu/ops/windowed_spmv.py windowed_pipeline :454: _k1w_kernel
// :349, the cube_router K2 middle, _k3w_kernel :394 with its cross-slab
// carry) and the vertex-axis routes around it (xc_route, y_route via
// permute.apply_plan :447, whose small plans run permute._pallas_rowgather
// :364). There each 131,072-edge slab windows a compacted x table, places
// it with a per-slab Benes permutation, routes CSC -> CSR, and the
// sequential grid carries a row's running sum from one slab to the next.
// Here a slab loads x[col[p]] directly in CSR order and stores y by vertex.
//
// Block ids come from an atomic ticket, so block b starts only after block
// b-1 has started. Block b covers the edges [lo, hi) = [b*kSlab,
// min((b+1)*kSlab, ep)) and owns the rows r < vp with lo <= off[r] < hi
// (the last block also those with off[r] == ep); it writes y[r] of each
// owned row that ends in the slab (the identity, 0 or INF_BITS, at an empty
// row). Of a row that crosses out of the slab it publishes the partial over
// [off[r], hi) in status[b]. A slab whose first edges continue a row begun
// earlier (the "head") waits for status[b-1] and either completes that row,
// y = running op head, or, when the row also crosses out of it, publishes
// running op (the whole slab). So the sum of a long row is folded in slab
// order, the same bits on every launch, and only a slab that lies inside
// a row waits for another before it publishes; every other slab publishes
// first and waits after. status and the ticket are zeroed by the launch.
//
// Inside a block: the thread's edges are loaded with 128-bit evict-first
// loads (col and w as int4/float4, flags as 16 bytes), so 16 independent x
// gathers are in flight per thread and the streamed arrays leave x in the
// L2; the thread folds its edges serially, a shuffle scan joins the lanes,
// one pass over the 8 warp totals joins the warps, and the inclusive
// segmented scan goes to shared memory, where each owned row reads its value
// at its last edge. Rows come from a warp-wide search of off
// (warp_search.cuh); the scan reads the 1-byte flags, never src_indices.
// What bounds it: bytes, 9 B per edge streamed (col, w, flags) plus one
// scattered 4-byte gather of x per edge (a 32 B L2 sector unless L1 holds
// it), the offsets and y; the work per block is fixed whatever the degrees.
template <int M, int R>
__global__ void __launch_bounds__(kBlock)
spmv_slabs_kernel(const int* __restrict__ off, const int* __restrict__ col,
                  const float* __restrict__ w,
                  const uint8_t* __restrict__ flags,
                  const float* __restrict__ x, int vp, int ep,
                  typename Op<R>::T* __restrict__ y,
                  unsigned long long* status, unsigned* ticket) {
  using T = typename Op<R>::T;
  __shared__ T s_val[kSlab + kSlab / 32];
  __shared__ T s_warp_v[kWarpsPerBlock];
  __shared__ int s_warp_f[kWarpsPerBlock];
  __shared__ int s_b, s_rlo, s_rhi;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  if (tid == 0) s_b = static_cast<int>(atomicAdd(ticket, 1u));
  __syncthreads();
  const int b = s_b;
  const int lo = b * kSlab;
  const int hi = static_cast<int>(
      min(static_cast<long long>(lo) + kSlab, static_cast<long long>(ep)));
  if (wid == 0) {
    const int r = etpu::warp_lower_bound(off, vp, lo);
    if (lane == 0) s_rlo = r;
  } else if (wid == 1) {
    const int r = hi == ep ? vp : etpu::warp_lower_bound(off, vp, hi);
    if (lane == 0) s_rhi = r;
  }

  // 1. the thread's kItems consecutive edges: messages and start flags;
  //    positions past hi are identity segments of their own
  const int base = lo + tid * kItems;
  T m[kItems];
  unsigned fmask = 0;
  if (base + kItems <= hi) {
    int c[kItems];
    float wv[kItems];
    const int4* c4 = reinterpret_cast<const int4*>(col + base);
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) {
      const int4 t = __ldcs(c4 + q);
      c[4 * q] = t.x;
      c[4 * q + 1] = t.y;
      c[4 * q + 2] = t.z;
      c[4 * q + 3] = t.w;
    }
    if constexpr (M != kNone) {
      const float4* w4 = reinterpret_cast<const float4*>(w + base);
#pragma unroll
      for (int q = 0; q < kItems / 4; ++q) {
        const float4 t = __ldcs(w4 + q);
        wv[4 * q] = t.x;
        wv[4 * q + 1] = t.y;
        wv[4 * q + 2] = t.z;
        wv[4 * q + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kItems; ++j) wv[j] = 0.0f;   // not read
    }
    const uint4 f4 = __ldcs(reinterpret_cast<const uint4*>(flags + base));
    const unsigned fw[4] = {f4.x, f4.y, f4.z, f4.w};
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      fmask |= ((fw[j >> 2] >> (8 * (j & 3))) & 0xffu) ? (1u << j) : 0u;
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      m[j] = Op<R>::of(message<M>(__ldg(x + c[j]), wv[j]));
    }
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int p = base + j;
      m[j] = Op<R>::ident();
      if (p < hi) {
        float wp = 0.0f;
        if constexpr (M != kNone) wp = __ldcs(w + p);
        m[j] = Op<R>::of(message<M>(__ldg(x + __ldcs(col + p)), wp));
        if (flags[p]) fmask |= 1u << j;
      } else {
        fmask |= 1u << j;
      }
    }
  }

  // 2. the thread's fold: (value since its last segment start, whether it
  //    saw one); then an inclusive shuffle scan of those pairs in the warp
  //    under (a,fa).(b,fb) = (fb ? b : a op b, fa | fb)
  T v = Op<R>::ident();
  int f = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if ((fmask >> j) & 1u) {
      v = m[j];
      f = 1;
    } else {
      v = Op<R>::apply(v, m[j]);
    }
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T pv = __shfl_up_sync(kFullMask, v, d);
    const int pf = __shfl_up_sync(kFullMask, f, d);
    if (lane >= d) {
      if (!f) v = Op<R>::apply(pv, v);
      f |= pf;
    }
  }
  if (lane == 31) {
    s_warp_v[wid] = v;
    s_warp_f[wid] = f;
  }
  const T ev = __shfl_up_sync(kFullMask, v, 1);
  const int ef = __shfl_up_sync(kFullMask, f, 1);
  __syncthreads();

  // 3. the pair before this thread: the warps before it in order, then the
  //    lanes before it; the inclusive segmented scan goes to shared memory
  T run = Op<R>::ident();
  for (int k = 0; k < wid; ++k) {
    run = s_warp_f[k] ? s_warp_v[k] : Op<R>::apply(run, s_warp_v[k]);
  }
  if (lane > 0) run = ef ? ev : Op<R>::apply(run, ev);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    run = ((fmask >> j) & 1u) ? m[j] : Op<R>::apply(run, m[j]);
    s_val[sidx(tid * kItems + j)] = run;
  }
  __syncthreads();

  // 4. the owned rows that end in the slab: the scan at the last edge
  const int rlo = s_rlo;
  const int rhi = s_rhi;
  for (int r = rlo + tid; r < rhi; r += kBlock) {
    const int s = off[r];
    const int e = off[r + 1];
    if (e <= hi) y[r] = e > s ? s_val[sidx(e - 1 - lo)] : Op<R>::ident();
  }

  // 5. the hand-off: publish first where the value is the slab's own, then
  //    wait for the predecessor where a row crosses in
  if (tid == 0) {
    const int first = min(off[rlo], hi);    // off[vp] == ep >= hi
    const bool head = first > lo;
    const bool starts = first < hi;
    const bool out = hi < ep && off[rhi] != hi;
    const T tail = s_val[sidx(hi - 1 - lo)];
    if (starts && out) publish(status, b, tail);
    if (head) {
      const T prev = wait_for<T>(status, b - 1);
      if (starts) {
        y[rlo - 1] = Op<R>::apply(prev, s_val[sidx(first - 1 - lo)]);
      } else if (out) {
        publish(status, b, Op<R>::apply(prev, tail));
      } else {
        y[rlo - 1] = Op<R>::apply(prev, tail);
      }
    }
  }
}

// y = A x on the CSR rows, balanced by rows and edges together: a merge-path
// partition (Merrill and Garland, "Merge-based parallel sparse matrix-vector
// multiplication", SC 2016) in one launch.
//
// Replaces the JAX package's 7-kernel chain
// (essentials_tpu/ops/fused_spmv.py _pallas_spmv_chain :179: cube_router K1
// :305, three K2 middles, _km_scan_mul_kernel :50, _km_segsum_shift_kernel
// :72, K3 :318) and the "first" fill of scan_kernels._scan_kernel :124 after
// it. There x is expanded over the edges by an int32 telescoping cumsum and
// moved between the CSC and CSR orders by Benes routes, because that
// device's gathers are element-serialized; here the x gathers are direct and
// a row's sum never leaves the chip's registers and shared memory.
//
// y[r] = sum over p in [off[r], off[r+1]) of w[p] * x[col[p]] (M == kMul)
// or x[col[p]] (M == kNone); 0 for an empty row. It reads off, col, w and x
// only (no csr_seg_flags: that is spmv_slabs' input).
//
// What bounds it: 8 B per edge streamed (col, w) and 8 B per row (off, y),
// plus one scattered 4-byte gather of x per edge, a 32 B L2 sector unless
// L1 holds it; at RMAT scale 18-20 the gathers cost more than the stream.
// How the design meets that: the sequence that merges the Vp row ends with
// the Ep edges is cut into tiles of kRowTile places, one block each, so
// every block has the same work whatever the degrees: an empty row costs a
// place, not a warp, and a hub row of 40K edges is spread over 20 blocks
// instead of walked by one warp in 1,250 dependent steps. A block finds its
// tile's rows and edges by a warp-wide merge-path search of off, loads its
// edges' col and w with 128-bit evict-first loads (the streams then leave x
// in the L2), issues all of its x gathers before it stores any message (8
// in flight per thread), and stages the messages and row ends in one shared
// array of kRowTile words (the tile's places). Each thread then walks kRowItems places of the merged
// sequence in order: a message adds to its running sum, a row end writes it.
//
// Fixed order, no float atomics: a thread's sum is its edges in order; the
// threads of a block join by a segmented scan of fixed shape; a row that
// leaves its block is completed by the block that holds its end, which
// folds the partials that the blocks before it published, in a fixed tree,
// then adds its own. Every block publishes, before it waits for anything,
// the partial of the row that leaves it (status word: kStarts when the row
// starts in the block, kInside when the block lies inside the row, kNoTail
// when no row leaves it); block ids come from an atomic ticket, so the
// blocks a block waits for have started, and none of them waits for a
// later one. So two launches on the same inputs give the same bits, and the
// row's completion waits for no chain: the partials of a hub's 20 blocks are
// all published at once and read by one warp.
template <int M>
__global__ void __launch_bounds__(kBlock)
spmv_rows_kernel(const int* __restrict__ off, const int* __restrict__ col,
                 const float* __restrict__ w, const float* __restrict__ x,
                 int vp, int ep, float* __restrict__ y,
                 unsigned long long* status, unsigned* ticket) {
  // the tile's ne messages (float bits) at [0, ne), then its nr row ends
  // (absolute edge offsets) at [ne, ne + nr), then a sentinel
  __shared__ int s_buf[kRowTile + 1];
  __shared__ float s_warp_v[kWarpsPerBlock];
  __shared__ int s_warp_f[kWarpsPerBlock];
  __shared__ float s_head;
  __shared__ int s_b, s_r0, s_r1, s_off0;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  if (tid == 0) s_b = static_cast<int>(atomicAdd(ticket, 1u));
  __syncthreads();
  const int b = s_b;
  const int d0 = b * kRowTile;
  const int d1 = min(d0 + kRowTile, vp + ep);
  if (wid == 0) {
    const int r = etpu::warp_merge_split(off, vp, d0);
    if (lane == 0) {
      s_r0 = r;
      s_off0 = off[r];
    }
  } else if (wid == 1) {
    const int r = etpu::warp_merge_split(off, vp, d1);
    if (lane == 0) s_r1 = r;
  }
  __syncthreads();
  const int r0 = s_r0;
  const int nr = s_r1 - r0;                 // row ends in the tile
  const int e0 = d0 - r0;                   // the tile's edges [e0, e1)
  const int ne = d1 - s_r1 - e0;
  int* const s_end = s_buf + ne;

  // 1. the messages and the row ends to shared memory: col and w by
  //    16-byte quads (the tile's edges span at most 2 kBlock + 1 quads),
  //    then the row ends while those loads fly, then every x gather before
  //    any store
  const int qa = e0 >> 2;
  const int qb = (e0 + ne + 3) >> 2;
  int c[kRowQuads][4];
  float wv[kRowQuads][4];
#pragma unroll
  for (int k = 0; k < kRowQuads; ++k) {
    const int q = qa + tid + k * kBlock;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      c[k][u] = -1;
      wv[k][u] = 0.0f;
    }
    if (q < qb && 4 * q + 4 <= ep) {
      const int4 t = __ldcs(reinterpret_cast<const int4*>(col) + q);
      c[k][0] = t.x;
      c[k][1] = t.y;
      c[k][2] = t.z;
      c[k][3] = t.w;
      if constexpr (M != kNone) {
        const float4 v = __ldcs(reinterpret_cast<const float4*>(w) + q);
        wv[k][0] = v.x;
        wv[k][1] = v.y;
        wv[k][2] = v.z;
        wv[k][3] = v.w;
      }
    } else if (q < qb) {                    // the ragged end of col
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (4 * q + u < ep) {
          c[k][u] = __ldcs(col + 4 * q + u);
          if constexpr (M != kNone) wv[k][u] = __ldcs(w + 4 * q + u);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {           // edges outside the tile
      const int p = 4 * q + u;
      if (p < e0 || p >= e0 + ne) c[k][u] = -1;
    }
  }
  for (int k = tid; k < nr; k += kBlock) s_end[k] = off[r0 + 1 + k];
  if (tid == 0) s_end[nr] = INT_MAX;        // no row end past the tile's
  {
    float xv[kRowQuads][4];
#pragma unroll
    for (int k = 0; k < kRowQuads; ++k) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        xv[k][u] = c[k][u] >= 0 ? __ldg(x + c[k][u]) : 0.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < kRowQuads; ++k) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (c[k][u] >= 0) {
          s_buf[4 * (qa + tid + k * kBlock) + u - e0] =
              __float_as_int(message<M>(xv[k][u], wv[k][u]));
        }
      }
    }
  }
  for (int p = 4 * (qa + kRowQuads * kBlock + tid); p < e0 + ne;
       p += 4 * kBlock) {                   // the last quad, if any
    for (int u = 0; u < 4; ++u) {
      if (p + u >= e0 && p + u < e0 + ne) {
        s_buf[p + u - e0] = __float_as_int(message<M>(
            __ldg(x + col[p + u]), M == kNone ? 0.0f : w[p + u]));
      }
    }
  }
  __syncthreads();

  // 2. the thread's kRowItems places, found by a search of the staged row
  //    ends: the first k whose end lies at or past the thread's diagonal
  const int n = nr + ne;
  const int diag = min(tid * kRowItems, n);
  int lo = max(0, diag - ne);
  int hi = min(diag, nr);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_end[mid] - e0 + mid < diag) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int i = lo;                               // row ends taken
  int j = diag - lo;                        // edges taken
  const int cnt = min(kRowItems, n - diag);
  float acc = 0.0f;                         // the running row's sum
  float head = 0.0f;                        // the thread's first row's part
  int first = -1;                           // that row, from r0
#pragma unroll
  for (int q = 0; q < kRowItems; ++q) {
    if (q < cnt) {
      if (s_end[i] - e0 <= j) {             // row r0 + i ends here
        if (first < 0) {
          first = i;
          head = acc;
        } else {
          y[r0 + i] = acc;                  // wholly inside the thread
        }
        acc = 0.0f;
        ++i;
      } else {
        acc = __fadd_rn(acc, __int_as_float(s_buf[j]));
        ++j;
      }
    }
  }

  // 3. the segmented scan of the threads' (trailing sum, saw an end) pairs,
  //    under (a,fa).(b,fb) = (fb ? b : a + b, fa | fb): a shuffle scan in
  //    each warp, then the warps in order
  float v = acc;
  int f = first >= 0;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float pv = __shfl_up_sync(kFullMask, v, d);
    const int pf = __shfl_up_sync(kFullMask, f, d);
    if (lane >= d) {
      if (!f) v = __fadd_rn(pv, v);
      f |= pf;
    }
  }
  if (lane == 31) {
    s_warp_v[wid] = v;
    s_warp_f[wid] = f;
  }
  const float ev = __shfl_up_sync(kFullMask, v, 1);
  const int ef = __shfl_up_sync(kFullMask, f, 1);
  __syncthreads();
  float run = 0.0f;                         // the running row before the thread
  for (int k = 0; k < wid; ++k) {
    run = s_warp_f[k] ? s_warp_v[k] : __fadd_rn(run, s_warp_v[k]);
  }
  if (lane > 0) run = ef ? ev : __fadd_rn(run, ev);
  const bool has_head = e0 > s_off0;        // row r0 began before the tile
  if (first >= 0) {
    const float val = __fadd_rn(run, head);
    if (first == 0 && has_head) {
      s_head = val;                         // completed after the look-back
    } else {
      y[r0 + first] = val;
    }
  }

  // 4. publish the partial of the row that leaves the tile, then complete
  //    the row that entered it
  if (tid == 0) {
    float tail = 0.0f;
    for (int k = 0; k < kWarpsPerBlock; ++k) {
      tail = s_warp_f[k] ? s_warp_v[k] : __fadd_rn(tail, s_warp_v[k]);
    }
    const int r1 = r0 + nr;
    const int start = nr > 0 ? s_end[nr - 1] : s_off0;   // off[r1]
    const unsigned kind = r1 < vp && e0 + ne > start
                              ? (start >= e0 ? kStarts : kInside)
                              : kNoTail;
    atomicExch(status + b,
               (static_cast<unsigned long long>(kind) << 32) |
                   __float_as_uint(tail));
  }
  __syncthreads();
  if (wid == 0 && has_head && nr > 0) {
    float prefix = 0.0f;
    for (int k = b - 1; k >= 0; k -= 32) {
      const int p = k - lane;               // lane l reads block k - l
      unsigned long long s = 0;
      if (p >= 0) {
        while (((s = atomicAdd(status + p, 0ull)) >> 32) == kUnset) {
          __nanosleep(32);
        }
      }
      const unsigned starts =
          __ballot_sync(kFullMask, (s >> 32) == kStarts);
      const int last = starts ? __ffs(starts) - 1 : 31;
      float part = lane <= last && p >= 0
                       ? __uint_as_float(static_cast<unsigned>(s))
                       : 0.0f;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {    // every lane: the same bits
        part = __fadd_rn(part, __shfl_xor_sync(kFullMask, part, d));
      }
      prefix = k == b - 1 ? part : __fadd_rn(part, prefix);
      if (starts) break;
    }
    if (lane == 0) y[r0] = __fadd_rn(prefix, s_head);
  }
}

int slabs(int ep) { return (ep + kSlab - 1) / kSlab; }
int row_tiles(int vp, int ep) { return (vp + ep + kRowTile - 1) / kRowTile; }

// Sets spmv_rows_kernel<M>'s carveout hint once on each device (the first
// 64) rather than on every product: the hint depends on the kernel alone.
template <int M>
cudaError_t rows_carveout() {
  static std::atomic<unsigned long long> done{0};   // bit d: set on device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(spmv_rows_kernel<M>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             kRowCarveout);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

// scratch: [row_tiles] 64-bit status words, then the 32-bit ticket; zeroed
// here on the stream, before the launch.
template <int M>
int launch_rows(const void* off, const void* col, const void* w,
                const void* x, int vp, int ep, void* y, void* scratch,
                void* stream) {
  if (vp > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int g = row_tiles(vp, ep);
    auto* status = static_cast<unsigned long long*>(scratch);
    cudaError_t err = rows_carveout<M>();
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaMemsetAsync(
        scratch, 0, sizeof(unsigned long long) * g + sizeof(unsigned), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    spmv_rows_kernel<M><<<g, kBlock, 0, s>>>(
        static_cast<const int*>(off), static_cast<const int*>(col),
        static_cast<const float*>(w), static_cast<const float*>(x), vp, ep,
        static_cast<float*>(y), status,
        reinterpret_cast<unsigned*>(status + g));
  }
  return static_cast<int>(cudaGetLastError());
}

// scratch: [slabs(ep)] 64-bit hand-off words, then the 32-bit ticket;
// zeroed here on the stream, before the launch.
template <int M, int R>
int launch_slabs(const void* off, const void* col, const void* w,
                 const void* flags, const void* x, int vp, int ep, void* y,
                 void* scratch, void* stream) {
  using T = typename Op<R>::T;
  if (ep > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int g = slabs(ep);
    auto* status = static_cast<unsigned long long*>(scratch);
    const cudaError_t err = cudaMemsetAsync(
        scratch, 0, sizeof(unsigned long long) * g + sizeof(unsigned), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    spmv_slabs_kernel<M, R><<<g, kBlock, 0, s>>>(
        static_cast<const int*>(off), static_cast<const int*>(col),
        static_cast<const float*>(w), static_cast<const uint8_t*>(flags),
        static_cast<const float*>(x), vp, ep, static_cast<T*>(y), status,
        reinterpret_cast<unsigned*>(status + g));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Edges per block of spmv_slabs; the Python wrapper sizes the scratch with
// it and checks it against its own constant.
int etpu_spmv_slab_edges() { return kSlab; }

// Merge places per spmv_rows block; the Python wrapper sizes the scratch
// with it and checks it against its own constant.
int etpu_spmv_row_tile() { return kRowTile; }

// col and w must be 16-byte aligned (w may be null under "none"); scratch
// holds 8 * row_tiles + 4 bytes, 8-byte aligned.
int etpu_spmv_rows_mul(const void* off, const void* col, const void* w,
                       const void* x, int vp, int ep, void* y, void* scratch,
                       void* stream) {
  return launch_rows<kMul>(off, col, w, x, vp, ep, y, scratch, stream);
}

int etpu_spmv_rows_none(const void* off, const void* col, const void* w,
                        const void* x, int vp, int ep, void* y,
                        void* scratch, void* stream) {
  return launch_rows<kNone>(off, col, w, x, vp, ep, y, scratch, stream);
}

// col, w and flags must be 16-byte aligned; scratch holds 8 * slabs + 4
// bytes, 8-byte aligned.
#define ETPU_SLABS(NAME, M, R)                                               \
  int NAME(const void* off, const void* col, const void* w,                  \
           const void* flags, const void* x, int vp, int ep, void* y,        \
           void* scratch, void* stream) {                                    \
    return launch_slabs<M, R>(off, col, w, flags, x, vp, ep, y, scratch,     \
                              stream);                                       \
  }

ETPU_SLABS(etpu_spmv_slabs_mul_sum, kMul, kSum)
ETPU_SLABS(etpu_spmv_slabs_add_sum, kAdd, kSum)
ETPU_SLABS(etpu_spmv_slabs_none_sum, kNone, kSum)
ETPU_SLABS(etpu_spmv_slabs_mul_min, kMul, kMin)
ETPU_SLABS(etpu_spmv_slabs_add_min, kAdd, kMin)
ETPU_SLABS(etpu_spmv_slabs_none_min, kNone, kMin)
#undef ETPU_SLABS

}  // extern "C"
