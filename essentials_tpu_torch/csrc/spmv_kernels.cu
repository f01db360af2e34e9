// Hand-written CUDA kernels of the SpMV path (y = A x), for Hopper (sm_90a).
//
// Built by essentials_tpu_torch/kernels.py with nvcc, together with every
// other csrc/*.cu, into one shared library with a plain C interface, loaded
// with ctypes. Every entry point launches on the stream it is given,
// allocates nothing (spmv_slabs zeroes the scratch it is given with
// cudaMemsetAsync), and returns the CUDA status so that a refused launch
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
// of the sums differs. No float atomics (spmv_slabs' only atomics are its
// ticket and hand-off words): each output is summed in a fixed order, so two
// launches on the same inputs give the same bits.

#include <cuda_runtime.h>
#include <cstdint>

#include "warp_search.cuh"

namespace {

constexpr int kBlock = 256;                 // threads per block
constexpr int kWarpsPerBlock = kBlock / 32;
constexpr int kItems = 16;                  // edges per thread in spmv_slabs
constexpr int kSlab = kBlock * kItems;      // edges per block in spmv_slabs
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kInfBits = 0x7f800000;        // float32 +inf as int32 bits

enum Msg { kMul = 0, kAdd = 1, kNone = 2 };
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
    acc = __fadd_rn(acc, message<M>(x[col[p]], M == kNone ? 0.0f : w[p]));
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

// A value's 32 bits, and back (float sums travel as their bits).
__device__ __forceinline__ unsigned bits_of(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ unsigned bits_of(int v) {
  return static_cast<unsigned>(v);
}
template <typename T> __device__ __forceinline__ T from_bits(unsigned b);
template <> __device__ __forceinline__ float from_bits<float>(unsigned b) {
  return __uint_as_float(b);
}
template <> __device__ __forceinline__ int from_bits<int>(unsigned b) {
  return static_cast<int>(b);
}

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

int warp_blocks(int n) { return (n + kWarpsPerBlock - 1) / kWarpsPerBlock; }
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

int etpu_spmv_rows_mul(const void* off, const void* col, const void* w,
                       const void* x, int vp, void* y, void* stream) {
  return launch_rows<kMul>(off, col, w, x, vp, y, stream);
}

int etpu_spmv_rows_none(const void* off, const void* col, const void* w,
                        const void* x, int vp, void* y, void* stream) {
  return launch_rows<kNone>(off, col, w, x, vp, y, stream);
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
