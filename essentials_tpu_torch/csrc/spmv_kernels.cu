// Hand-written CUDA kernels of the SpMV path (y = A x), for Hopper (sm_90a).
//
// Built by essentials_tpu_torch/kernels.py with nvcc, together with every
// other csrc/*.cu, into one shared library with a plain C interface, loaded
// with ctypes. Every entry point launches on the stream it is given,
// allocates nothing, and returns cudaGetLastError() so that a refused launch
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
// of the sums differs. No float atomics: each output is summed in a fixed
// order, so two launches on the same inputs give the same bits.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kBlock = 256;                 // threads per block
constexpr int kWarpsPerBlock = kBlock / 32;
constexpr int kItems = 8;                   // edges per thread in spmv_slabs
constexpr int kSlab = kBlock * kItems;      // edges per block in spmv_slabs
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kInfBits = 0x7f800000;        // float32 +inf as int32 bits

enum Msg { kMul = 0, kAdd = 1, kNone = 2 };
enum Red { kSum = 0, kMin = 1 };

// The message of edge p: x[col[p]] * w[p], x[col[p]] + w[p] or x[col[p]].
template <int M>
__device__ __forceinline__ float message(float xv, const float* __restrict__ w,
                                         int p) {
  if constexpr (M == kMul) return __fmul_rn(xv, w[p]);
  if constexpr (M == kAdd) return __fadd_rn(xv, w[p]);
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

// y = A x with one warp per CSR row.
//
// Replaces the JAX package's 7-kernel chain
// (essentials_tpu/ops/fused_spmv.py _pallas_spmv_chain :179: cube_router K1
// :305, three K2 middles, _km_scan_mul_kernel :50, _km_segsum_shift_kernel
// :72, K3 :318) and the "first" fill of scan_kernels._scan_kernel :124 after
// it. There x is expanded over the edges by an int32 telescoping cumsum and
// moved between the CSC and CSR orders by Benes routes, because that
// device's gathers are element-serialized; here each lane loads x[col[p]]
// directly and the row's sum never leaves registers.
//
// y[r] = sum over p in [off[r], off[r+1]) of w[p] * x[col[p]] (M == kMul)
// or x[col[p]] (M == kNone); 0 for an empty row. The lanes stride the row
// with coalesced loads of col and w; the 32 partial sums meet in a
// fixed-order xor butterfly and lane 0 stores.
// What bounds it: 8 B per edge streamed (col, w) plus one scattered 4 B
// gather of x per edge, so bytes and gather latency; a hub row runs on one
// warp, which leaves power-law graphs unbalanced (spmv_slabs is the
// edge-balanced form).
template <int M>
__global__ void __launch_bounds__(kBlock)
spmv_rows_kernel(const int* __restrict__ off, const int* __restrict__ col,
                 const float* __restrict__ w, const float* __restrict__ x,
                 int vp, float* __restrict__ y) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x) >> 5;
  if (warp >= vp) return;                   // warp-uniform
  const int r = static_cast<int>(warp);
  const int b = off[r];
  const int e = off[r + 1];
  float acc = 0.0f;
  for (int p = b + lane; p < e; p += 32) {
    acc = __fadd_rn(acc, message<M>(x[col[p]], w, p));
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    acc = __fadd_rn(acc, __shfl_xor_sync(kFullMask, acc, s));
  }
  if (lane == 0) y[r] = acc;
}

// Shared-memory index with one spare word per 32: a thread's kItems
// consecutive items then fall in distinct banks.
__device__ __forceinline__ int sidx(int i) { return i + (i >> 5); }

// First r in [0, n) with off[r] >= v, or n.
__device__ int lower_bound(const int* __restrict__ off, int n, int v) {
  int lo = 0;
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (off[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// One slab of kSlab edges per block: messages, a block-wide segmented scan,
// and the rows that start in the slab.
//
// Replaces the JAX package's windowed pipeline
// (essentials_tpu/ops/windowed_spmv.py windowed_pipeline :454: _k1w_kernel
// :349, the cube_router K2 middle, _k3w_kernel :394) and the vertex-axis
// routes around it (xc_route, y_route via permute.apply_plan :447, whose
// small plans run permute._pallas_rowgather :364). There each 131,072-edge
// slab windows a compacted x table, places it with a per-slab Benes
// permutation and routes CSC -> CSR; here the slab loads x[col[p]] directly
// in CSR order and stores y by vertex, so there are no plans. The TPU's
// sequential grid carried a row's running sum from one slab to the next;
// blocks here run in no order, so a row that crosses a slab boundary leaves
// partials that spmv_slab_carry folds.
//
// Block b covers the edges [lo, hi) = [b*kSlab, min((b+1)*kSlab, ep)) and
// owns the rows r < vp with lo <= off[r] < hi (the last block also those
// with off[r] == ep). Outputs, T = float (sum) or int bits (min):
//   y[r], owned row r:  the row's reduction when it ends in the slab; the
//                       identity when it is empty; its partial over
//                       [off[r], hi) when it crosses out of the slab;
//   head[b]:            the partial over [lo, first row start in the slab),
//                       i.e. the part of a row begun in an earlier slab (the
//                       whole slab when no row starts in it); the identity
//                       when a row starts at lo;
//   carry_row[b]:       the owned row that crosses out of the slab, or -1.
// The scan reads the 1-byte flags, never the 4-byte src_indices; the rows
// come from two binary searches in off.
// What bounds it: the same 8 B per edge plus the x gather, and 1 B of flags;
// the work per block is fixed whatever the degrees, at the price of a
// shared-memory scan and the owned-row loop (a slab with many empty rows
// loops over all of them).
template <int M, int R>
__global__ void __launch_bounds__(kBlock)
spmv_slabs_kernel(const int* __restrict__ off, const int* __restrict__ col,
                  const float* __restrict__ w,
                  const uint8_t* __restrict__ flags,
                  const float* __restrict__ x, int vp, int ep,
                  typename Op<R>::T* __restrict__ y,
                  typename Op<R>::T* __restrict__ head,
                  int* __restrict__ carry_row) {
  using T = typename Op<R>::T;
  __shared__ T s_val[kSlab + kSlab / 32];
  __shared__ uint8_t s_flag[kSlab + kSlab / 32];
  __shared__ T s_warp_v[kWarpsPerBlock];
  __shared__ int s_warp_f[kWarpsPerBlock];
  __shared__ int s_rows[2];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int lo = blockIdx.x * kSlab;
  const int hi = min(lo + kSlab, ep);

  if (tid == 0) {
    s_rows[0] = lower_bound(off, vp, lo);
    carry_row[blockIdx.x] = -1;             // overwritten below if a row crosses
  } else if (tid == 1) {
    s_rows[1] = hi == ep ? vp : lower_bound(off, vp, hi);
  }

  // 1. messages, loaded striped (coalesced) into shared memory; positions
  //    past hi are identity segments of their own and are never read back
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int k = i * kBlock + tid;
    const int p = lo + k;
    T v = Op<R>::ident();
    uint8_t f = 1;
    if (p < hi) {
      v = Op<R>::of(message<M>(x[col[p]], w, p));
      f = flags[p];
    }
    s_val[sidx(k)] = v;
    s_flag[sidx(k)] = f;
  }
  __syncthreads();

  // 2. each thread reduces its kItems consecutive edges: (value since the
  //    last segment start, whether it saw one)
  const int base = tid * kItems;
  T v = Op<R>::ident();
  int f = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const T m = s_val[sidx(base + j)];
    if (s_flag[sidx(base + j)]) {
      v = m;
      f = 1;
    } else {
      v = Op<R>::apply(v, m);
    }
  }

  // 3. block-wide exclusive scan of the (value, flag) pairs under the
  //    segmented operator (a,fa).(b,fb) = (fb ? b : a op b, fa | fb):
  //    a shuffle scan in each warp, then the warp totals in order
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
  T ev = __shfl_up_sync(kFullMask, v, 1);
  int ef = __shfl_up_sync(kFullMask, f, 1);
  __syncthreads();
  T wv = Op<R>::ident();
  for (int k = 0; k < wid; ++k) {
    wv = s_warp_f[k] ? s_warp_v[k] : Op<R>::apply(wv, s_warp_v[k]);
  }
  T run;
  if (lane == 0) {
    run = wv;
  } else {
    run = ef ? ev : Op<R>::apply(wv, ev);
  }

  // 4. the inclusive segmented scan, written back over the messages
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int k = sidx(base + j);
    const T m = s_val[k];
    run = s_flag[k] ? m : Op<R>::apply(run, m);
    s_val[k] = run;
  }
  __syncthreads();

  // 5. the owned rows: a row's reduction is the scan at its last edge
  const int rlo = s_rows[0];
  const int rhi = s_rows[1];
  for (int r = rlo + tid; r < rhi; r += kBlock) {
    const int s = off[r];
    const int e = off[r + 1];
    T out = Op<R>::ident();
    if (e > hi) {                           // crosses out: a partial
      out = s_val[sidx(hi - 1 - lo)];
      carry_row[blockIdx.x] = r;
    } else if (e > s) {
      out = s_val[sidx(e - 1 - lo)];
    }
    y[r] = out;
  }
  if (tid == 0) {
    const int first = min(off[rlo], hi);    // off[vp] == ep >= hi
    head[blockIdx.x] = first > lo ? s_val[sidx(first - 1 - lo)]
                                  : Op<R>::ident();
  }
}

// Folds the partials of the rows that cross slab boundaries, one thread per
// slab b with carry_row[b] = r >= 0: y[r] = y[r] op head[b+1] op head[b+2]
// ... over every later slab that starts before the row's end off[r+1], in
// slab order, so the result is the same on every launch. A row may span
// any number of slabs.
//
// Replaces the cross-slab carry of _k3w_kernel (windowed_spmv.py :394,
// the SMEM carry_v/carry_f that its sequential grid passes on).
// What bounds it: [G] reads and one dependent chain per crossing row, as
// long as the row's slab count; it is small next to spmv_slabs.
template <int R>
__global__ void __launch_bounds__(kBlock)
spmv_slab_carry_kernel(const int* __restrict__ off,
                       const typename Op<R>::T* __restrict__ head,
                       const int* __restrict__ carry_row, int g,
                       typename Op<R>::T* __restrict__ y) {
  using T = typename Op<R>::T;
  const int b = blockIdx.x * kBlock + threadIdx.x;
  if (b >= g) return;
  const int r = carry_row[b];
  if (r < 0) return;
  const long long e = off[r + 1];
  T v = y[r];
  for (int b2 = b + 1; b2 < g && static_cast<long long>(b2) * kSlab < e;
       ++b2) {
    v = Op<R>::apply(v, head[b2]);
  }
  y[r] = v;
}

int warp_blocks(int n) { return (n + kWarpsPerBlock - 1) / kWarpsPerBlock; }
int thread_blocks(int n) { return (n + kBlock - 1) / kBlock; }
int slabs(int ep) { return (ep + kSlab - 1) / kSlab; }

template <int M>
int launch_rows(const void* off, const void* col, const void* w,
                const void* x, int vp, void* y, void* stream) {
  if (vp > 0) {
    spmv_rows_kernel<M><<<warp_blocks(vp), kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(off), static_cast<const int*>(col),
        static_cast<const float*>(w), static_cast<const float*>(x), vp,
        static_cast<float*>(y));
  }
  return static_cast<int>(cudaGetLastError());
}

template <int M, int R>
int launch_slabs(const void* off, const void* col, const void* w,
                 const void* flags, const void* x, int vp, int ep, void* y,
                 void* head, void* carry_row, void* stream) {
  using T = typename Op<R>::T;
  if (ep > 0) {
    spmv_slabs_kernel<M, R><<<slabs(ep), kBlock, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(off), static_cast<const int*>(col),
        static_cast<const float*>(w), static_cast<const uint8_t*>(flags),
        static_cast<const float*>(x), vp, ep, static_cast<T*>(y),
        static_cast<T*>(head), static_cast<int*>(carry_row));
  }
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int launch_carry(const void* off, const void* head, const void* carry_row,
                 int g, void* y, void* stream) {
  using T = typename Op<R>::T;
  if (g > 0) {
    spmv_slab_carry_kernel<R><<<thread_blocks(g), kBlock, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(off), static_cast<const T*>(head),
        static_cast<const int*>(carry_row), g, static_cast<T*>(y));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Edges per block of spmv_slabs; the Python wrapper sizes head and
// carry_row with it and checks it against its own constant.
int etpu_spmv_slab_edges() { return kSlab; }

int etpu_spmv_rows_mul(const void* off, const void* col, const void* w,
                       const void* x, int vp, void* y, void* stream) {
  return launch_rows<kMul>(off, col, w, x, vp, y, stream);
}

int etpu_spmv_rows_none(const void* off, const void* col, const void* w,
                        const void* x, int vp, void* y, void* stream) {
  return launch_rows<kNone>(off, col, w, x, vp, y, stream);
}

#define ETPU_SLABS(NAME, M, R)                                               \
  int NAME(const void* off, const void* col, const void* w,                  \
           const void* flags, const void* x, int vp, int ep, void* y,        \
           void* head, void* carry_row, void* stream) {                      \
    return launch_slabs<M, R>(off, col, w, flags, x, vp, ep, y, head,        \
                              carry_row, stream);                            \
  }

ETPU_SLABS(etpu_spmv_slabs_mul_sum, kMul, kSum)
ETPU_SLABS(etpu_spmv_slabs_add_sum, kAdd, kSum)
ETPU_SLABS(etpu_spmv_slabs_none_sum, kNone, kSum)
ETPU_SLABS(etpu_spmv_slabs_mul_min, kMul, kMin)
ETPU_SLABS(etpu_spmv_slabs_add_min, kAdd, kMin)
ETPU_SLABS(etpu_spmv_slabs_none_min, kNone, kMin)
#undef ETPU_SLABS

int etpu_spmv_slab_carry_sum(const void* off, const void* head,
                             const void* carry_row, int g, void* y,
                             void* stream) {
  return launch_carry<kSum>(off, head, carry_row, g, y, stream);
}

int etpu_spmv_slab_carry_min(const void* off, const void* head,
                             const void* carry_row, int g, void* y,
                             void* stream) {
  return launch_carry<kMin>(off, head, carry_row, g, y, stream);
}

}  // extern "C"
