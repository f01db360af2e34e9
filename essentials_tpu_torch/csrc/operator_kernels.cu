// Hand-written CUDA kernels of the operator layer (scan, gather, segment
// reduce, segment min/max, advance count), for Hopper (sm_90a).
//
// Built by essentials_tpu_torch/kernels.py with nvcc into the shared library
// of every csrc/*.cu, with a plain C interface, loaded with ctypes. Every
// entry point launches on the stream it is given, allocates nothing (the
// wrapper passes outputs and scratch), and returns cudaGetLastError() so that
// a refused launch reaches the Python wrapper.
//
// Layout contract (essentials_tpu_torch/graph/graph.py): offsets are [S+1]
// int32 and sorted, segment s is [off[s], off[s+1]); `csc_src` is the [Ep]
// int32 source of each CSC slot. The only atomics on data are
// advance_count's int32 additions, which are exact in any order, so every
// result, float sums included, is the same bit for bit on every run.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "warp_search.cuh"

namespace {

constexpr int kBlock = 256;                 // threads per block
constexpr int kWarpsPerBlock = kBlock / 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kScanItems = 8;               // consecutive elements per thread
constexpr int kScanTile = kBlock * kScanItems;   // elements per scan block

// Operation codes shared with kernels.py (SCAN_OPS, REDUCE_OPS).
enum { kAdd = 0, kMin = 1, kMax = 2, kFirst = 3, kOr = 3, kAnd = 4 };

__device__ __forceinline__ long long global_warp() {
  return (static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x) >> 5;
}

// The binary operations on int32 (add wraps around, as the TPU's int32 does)
// and float32 (__fadd_rn, which nvcc does not contract into an FMA).
template <int OP> struct Op;
template <> struct Op<kAdd> {
  __device__ static int apply(int a, int b) {
    return static_cast<int>(static_cast<unsigned>(a) +
                            static_cast<unsigned>(b));
  }
  __device__ static float apply(float a, float b) { return __fadd_rn(a, b); }
};
template <> struct Op<kMin> {
  __device__ static int apply(int a, int b) { return min(a, b); }
  __device__ static float apply(float a, float b) { return b < a ? b : a; }
};
template <> struct Op<kMax> {
  __device__ static int apply(int a, int b) { return max(a, b); }
  __device__ static float apply(float a, float b) { return b > a ? b : a; }
};
template <> struct Op<kFirst> {             // keep the older value
  __device__ static int apply(int a, int) { return a; }
  __device__ static float apply(float a, float) { return a; }
};

// ------------------------------------------------------------------ scan --
//
// Inclusive scan, optionally segmented by start flags. Replaces the JAX
// package's scan_kernels.scan_1d (:274) and segmented_scan_1d (:296), whose
// one Pallas body _scan_kernel (:124) streams [1024, 128] blocks in order
// and carries the running value across its sequential grid in SMEM.
//
// Blocks run in no order here, so the carry becomes three passes:
//   1. scan_tiles: each block scans its tile of kScanTile elements alone
//      (a serial scan of 8 consecutive elements per thread, a warp scan of
//      the threads' totals with shuffles, then the warps' totals in warp
//      order) and writes the tile's total pair and its first flagged
//      position;
//   2. scan_totals: one block scans the tile totals in tile order;
//   3. scan_fixup: each element before its tile's first flag takes the
//      running value of the tiles before it.
// Elements are (value, flag) pairs under the associative operator of
// scan_kernels.py:15-17, (v1,f1)·(v2,f2) = (f2 ? v2 : op(v1,v2), f1|f2);
// position 0 always starts a segment. The order of every float addition is
// fixed by n alone, without atomics or look-back, so a float scan repeats
// bit for bit. No identity is needed: a pair with nothing before it is
// left alone.
//
// What bounds it: bytes. Pass 1 reads x (and flags) and writes the output
// once; pass 3 reads and writes the output again; passes 2 and 3 touch one
// total per 2,048 elements. So 2-3 x the least traffic (one read and one
// write); tiles are staged through shared memory so that loads and stores
// are coalesced.

template <typename T>
struct ScanShared {
  T v[kScanTile];
  unsigned char f[kScanTile];
  T warp_v[kWarpsPerBlock];
  int warp_f[kWarpsPerBlock];
  int first;                  // first flagged offset in the tile
  T total_v;                  // the tile's total pair
  int total_f;
};

// Scans positions [base, base + kScanTile) of x that lie below n into out
// (x and out may be the same array), after the carry pair when has_carry.
// Positions at or past n count as flagged. On return (after a barrier) the
// tile's total pair and first flagged offset are in sh.
template <typename T, int OP>
__device__ void scan_tile(const T* x, const unsigned char* flags, T* out,
                          long long base, long long n, bool has_carry,
                          T carry_v, bool carry_f, ScanShared<T>& sh) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) sh.first = kScanTile;
  for (int j = 0; j < kScanItems; ++j) {    // coalesced loads
    const int k = j * kBlock + tid;
    const long long p = base + k;
    if (p < n) {
      sh.v[k] = x[p];
      sh.f[k] = (p == 0 || (flags != nullptr && flags[p] != 0)) ? 1 : 0;
    } else {
      sh.v[k] = T(0);
      sh.f[k] = 1;
    }
  }
  __syncthreads();

  T v[kScanItems];
  bool f[kScanItems];
  int my_first = kScanTile;
  for (int j = 0; j < kScanItems; ++j) {
    const int k = tid * kScanItems + j;
    v[j] = sh.v[k];
    f[j] = sh.f[k] != 0;
    if (f[j] && my_first == kScanTile) my_first = k;
  }
  for (int j = 1; j < kScanItems; ++j) {    // serial scan of 8 elements
    if (!f[j]) v[j] = Op<OP>::apply(v[j - 1], v[j]);
    f[j] = f[j] || f[j - 1];
  }
  // inclusive warp scan of the threads' totals
  T av = v[kScanItems - 1];
  int af = f[kScanItems - 1] ? 1 : 0;
  for (int d = 1; d < 32; d <<= 1) {
    const T pv = __shfl_up_sync(kFullMask, av, d);
    const int pf = __shfl_up_sync(kFullMask, af, d);
    if (lane >= d) {
      if (!af) av = Op<OP>::apply(pv, av);
      af |= pf;
    }
  }
  const T ev = __shfl_up_sync(kFullMask, av, 1);  // exclusive within warp
  const int ef = __shfl_up_sync(kFullMask, af, 1);
  if (lane == 31) {
    sh.warp_v[warp] = av;
    sh.warp_f[warp] = af;
  }
  atomicMin(&sh.first, my_first);           // shared memory, order-free
  __syncthreads();

  // the pair of everything before this warp: the carry, then warps in order
  bool wh = has_carry;
  T wv = carry_v;
  int wf = carry_f ? 1 : 0;
  for (int i = 0; i < warp; ++i) {
    if (!wh) {
      wv = sh.warp_v[i];
      wf = sh.warp_f[i];
      wh = true;
    } else {
      wv = sh.warp_f[i] ? sh.warp_v[i] : Op<OP>::apply(wv, sh.warp_v[i]);
      wf |= sh.warp_f[i];
    }
  }
  // the pair of everything before this thread
  bool th = wh;
  T tv = wv;
  int tf = wf;
  if (lane > 0) {
    if (!wh) {
      tv = ev;
      tf = ef;
      th = true;
    } else {
      tv = ef ? ev : Op<OP>::apply(wv, ev);
      tf = wf | ef;
    }
  }
  if (th) {
    for (int j = 0; j < kScanItems; ++j) {
      if (!f[j]) v[j] = Op<OP>::apply(tv, v[j]);
    }
  }
  // every read of sh.v happened before the last barrier
  for (int j = 0; j < kScanItems; ++j) sh.v[tid * kScanItems + j] = v[j];
  if (tid == kBlock - 1) {
    sh.total_v = v[kScanItems - 1];
    sh.total_f = (f[kScanItems - 1] ? 1 : 0) | tf;
  }
  __syncthreads();
  for (int j = 0; j < kScanItems; ++j) {    // coalesced stores
    const int k = j * kBlock + tid;
    const long long p = base + k;
    if (p < n) out[p] = sh.v[k];
  }
  __syncthreads();
}

template <typename T, int OP>
__global__ void __launch_bounds__(kBlock)
scan_tiles_kernel(const T* __restrict__ x,
                  const unsigned char* __restrict__ flags, T* __restrict__ out,
                  T* __restrict__ total_v, unsigned char* __restrict__ total_f,
                  int* __restrict__ first, long long n) {
  __shared__ ScanShared<T> sh;
  scan_tile<T, OP>(x, flags, out,
                   static_cast<long long>(blockIdx.x) * kScanTile, n, false,
                   T(0), false, sh);
  if (threadIdx.x == 0) {
    total_v[blockIdx.x] = sh.total_v;
    total_f[blockIdx.x] = static_cast<unsigned char>(sh.total_f);
    first[blockIdx.x] = sh.first;
  }
}

// One block: the inclusive scan of the tiles' total pairs, in place, tile
// of totals after tile of totals with the carry between them.
template <typename T, int OP>
__global__ void __launch_bounds__(kBlock)
scan_totals_kernel(T* total_v, const unsigned char* total_f, long long g) {
  __shared__ ScanShared<T> sh;
  bool has = false;
  T cv = T(0);
  bool cf = false;
  for (long long base = 0; base < g; base += kScanTile) {
    scan_tile<T, OP>(total_v, total_f, total_v, base, g, has, cv, cf, sh);
    cv = sh.total_v;
    cf = sh.total_f != 0;
    has = true;
    __syncthreads();                        // before sh is written again
  }
}

template <typename T, int OP>
__global__ void __launch_bounds__(kBlock)
scan_fixup_kernel(T* __restrict__ out, const T* __restrict__ total_v,
                  const int* __restrict__ first, long long n) {
  const long long p = static_cast<long long>(blockIdx.x) * kBlock +
                      threadIdx.x + kScanTile;       // tile 0 needs nothing
  if (p >= n) return;
  const long long b = p / kScanTile;
  if (p - b * kScanTile < first[b]) out[p] = Op<OP>::apply(total_v[b - 1],
                                                           out[p]);
}

template <typename T, int OP>
int scan_launch(const void* x, const void* flags, void* out, void* total_v,
                void* total_f, void* first, long long n, cudaStream_t s) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const long long g = (n + kScanTile - 1) / kScanTile;
  scan_tiles_kernel<T, OP><<<static_cast<unsigned>(g), kBlock, 0, s>>>(
      static_cast<const T*>(x), static_cast<const unsigned char*>(flags),
      static_cast<T*>(out), static_cast<T*>(total_v),
      static_cast<unsigned char*>(total_f), static_cast<int*>(first), n);
  if (g > 1) {
    scan_totals_kernel<T, OP><<<1, kBlock, 0, s>>>(
        static_cast<T*>(total_v), static_cast<const unsigned char*>(total_f),
        g);
    const long long rest = n - kScanTile;
    scan_fixup_kernel<T, OP><<<static_cast<unsigned>((rest + kBlock - 1) /
                                                     kBlock),
                               kBlock, 0, s>>>(
        static_cast<T*>(out), static_cast<const T*>(total_v),
        static_cast<const int*>(first), n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int scan_dispatch(const void* x, const void* flags, void* out, void* total_v,
                  void* total_f, void* first, long long n, int op,
                  cudaStream_t s) {
  switch (op) {
    case kAdd: return scan_launch<T, kAdd>(x, flags, out, total_v, total_f,
                                           first, n, s);
    case kMin: return scan_launch<T, kMin>(x, flags, out, total_v, total_f,
                                           first, n, s);
    case kMax: return scan_launch<T, kMax>(x, flags, out, total_v, total_f,
                                           first, n, s);
    case kFirst: return scan_launch<T, kFirst>(x, flags, out, total_v,
                                               total_f, first, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ------------------------------------------------------- gather_payloads --
//
// out_k[p] = in_k[idx[p]] for 1-4 payloads of 32-bit words (floats and
// bools travel as bits). Replaces the TPU's static-permutation movers:
// cube_router._pallas_apply (:385) through apply_cube_plan (:464) and
// permute.apply_plan(_multi) (:447, :462), cube_router.apply_cube_chain
// (:586) and permute._pallas_rowgather (:364). The TPU cannot gather at
// speed and routes through Benes networks; here advance loads each source's
// payloads straight into CSC order through csc_src and each destination's
// through csc_dst, neighbor_reduce through col_indices.
//
// What bounds it: idx and the outputs stream (4 + 4 NP bytes per slot);
// each gathered record costs one 32-byte L2 sector (an HBM sector where the
// payload does not fit the 50 MB L2), whatever its width up to 32 bytes. So
// NP separate 4-byte gathers cost NP sectors per slot, and a random index
// makes them the larger part.
// The design: templated on NP (no runtime branch on it); each thread takes
// kGatherItems = 4 consecutive slots, loads their indices with one 128-bit
// evict-first load, issues all 4 NP gathers before it stores, and stores
// each output with one 128-bit evict-first store, so the streams leave the
// payloads in the L2. A slot range that ends inside a thread's four (n % 4)
// and an idx that is not 16-byte aligned (a view at an odd offset) take the
// scalar path of the same kernel. Where NP >= 2 and the payloads are short
// against n (the [Vp] payloads and [Ep] indices of advance, SSSP and
// color), the wrapper asks for packing: gather_payloads_pack_kernel first
// interleaves the payloads, up to the shortest one's length, into records
// of 8 bytes (NP = 2) or 16 bytes (NP = 3, 4), and the gather then loads
// one record, one sector, per slot instead of NP.

constexpr int kGatherItems = 4;             // output slots per thread

// A packed record of NP words: 8 or 16 bytes, so one record lies in one
// 32-byte sector. NP = 1 is never packed.
template <int NP> struct Record { using T = int4; };
template <> struct Record<1> { using T = int; };
template <> struct Record<2> { using T = int2; };

struct Gather {
  const int* in[4];
  int* out[4];
};

template <int NP>
__device__ __forceinline__ void unpack(const typename Record<NP>::T& r,
                                       int* v) {
  if constexpr (NP == 2) {
    v[0] = r.x;
    v[1] = r.y;
  } else if constexpr (NP >= 3) {
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    if constexpr (NP == 4) v[3] = r.w;
  }
}

// rec[v] = (in_0[v], ..., in_{NP-1}[v]) for v < len (a 16-byte record's
// unused fourth word is 0).
template <int NP>
__global__ void __launch_bounds__(kBlock)
gather_payloads_pack_kernel(Gather g, int len,
                            typename Record<NP>::T* __restrict__ rec) {
  const int v = blockIdx.x * kBlock + threadIdx.x;
  if (v >= len) return;
  if constexpr (NP == 2) {
    rec[v] = make_int2(g.in[0][v], g.in[1][v]);
  } else if constexpr (NP >= 3) {
    rec[v] = make_int4(g.in[0][v], g.in[1][v], g.in[2][v],
                       NP == 4 ? g.in[3][v] : 0);
  }
}

template <int NP, bool kPacked>
__global__ void __launch_bounds__(kBlock)
gather_payloads_kernel(const int* __restrict__ idx, long long n, Gather g,
                       const typename Record<NP>::T* __restrict__ rec,
                       int idx_aligned) {
  const long long base =
      (static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x) *
      kGatherItems;
  if (base >= n) return;
  if (base + kGatherItems > n) {            // the ragged end: scalar
    for (long long p = base; p < n; ++p) {
      const int j = idx[p];
      int v[NP];
      if constexpr (kPacked) {
        unpack<NP>(rec[j], v);
      } else {
#pragma unroll
        for (int k = 0; k < NP; ++k) v[k] = g.in[k][j];
      }
#pragma unroll
      for (int k = 0; k < NP; ++k) g.out[k][p] = v[k];
    }
    return;
  }
  int j[kGatherItems];
  if (idx_aligned) {
    const int4 t = __ldcs(reinterpret_cast<const int4*>(idx + base));
    j[0] = t.x;
    j[1] = t.y;
    j[2] = t.z;
    j[3] = t.w;
  } else {                                  // a view at an odd offset
#pragma unroll
    for (int u = 0; u < kGatherItems; ++u) j[u] = __ldcs(idx + base + u);
  }
  int v[kGatherItems][NP];
  if constexpr (kPacked) {
    typename Record<NP>::T r[kGatherItems];
#pragma unroll
    for (int u = 0; u < kGatherItems; ++u) r[u] = __ldg(rec + j[u]);
#pragma unroll
    for (int u = 0; u < kGatherItems; ++u) unpack<NP>(r[u], v[u]);
  } else {
#pragma unroll
    for (int u = 0; u < kGatherItems; ++u) {
#pragma unroll
      for (int k = 0; k < NP; ++k) v[u][k] = __ldg(g.in[k] + j[u]);
    }
  }
#pragma unroll
  for (int k = 0; k < NP; ++k) {            // out_k is 16-byte aligned
    __stcs(reinterpret_cast<int4*>(g.out[k] + base),
           make_int4(v[0][k], v[1][k], v[2][k], v[3][k]));
  }
}

template <int NP>
int gather_launch(const int* idx, long long n, const Gather& g, void* rec,
                  int len, cudaStream_t s) {
  using R = typename Record<NP>::T;
  const long long threads = (n + kGatherItems - 1) / kGatherItems;
  const unsigned grid = static_cast<unsigned>((threads + kBlock - 1) / kBlock);
  const int aligned = (reinterpret_cast<uintptr_t>(idx) & 15) == 0;
  if constexpr (NP >= 2) {
    if (rec != nullptr) {
      if (len > 0) {
        gather_payloads_pack_kernel<NP><<<(len + kBlock - 1) / kBlock,
                                          kBlock, 0, s>>>(
            g, len, static_cast<R*>(rec));
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
      }
      gather_payloads_kernel<NP, true><<<grid, kBlock, 0, s>>>(
          idx, n, g, static_cast<const R*>(rec), aligned);
      return static_cast<int>(cudaGetLastError());
    }
  }
  gather_payloads_kernel<NP, false><<<grid, kBlock, 0, s>>>(idx, n, g,
                                                            nullptr, aligned);
  return static_cast<int>(cudaGetLastError());
}

// -------------------------------------------------------- segment_reduce --
//
// out[s] = the reduction of vals[off[s] .. off[s+1]) with the identity at an
// empty segment, one warp per segment. Replaces segment.combine_by_offsets
// (:97) and combine_by_offsets_routed (:287), whose TPU kernels are
// segmented_scan_1d (:296) and the routed end-of-segment pick (the cube
// route of the prefix back through the offsets). Here the segment is
// reduced where it lies.
// SUM, MIN, MAX on int32 (the sum wraps around) and float32. Each lane
// folds its strided elements in order and the warp folds the lanes by a
// fixed shuffle tree, so a float sum (__fadd_rn) repeats bit for bit; its
// order differs from the JAX package's scan, so float sums agree with it to
// a tolerance. MIN and MAX are exact. OR and AND read each value as a truth
// value (nonzero) and write 0 or 1 bytes.
// What bounds it: bytes, one coalesced read of vals and one read of the
// offsets. A hub's segment runs on one warp.

template <typename T, int OP>
__global__ void __launch_bounds__(kBlock)
segment_reduce_kernel(const T* __restrict__ vals, const int* __restrict__ off,
                      int nseg, T ident, T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warp = global_warp();
  if (warp >= nseg) return;                 // warp-uniform
  const int s = static_cast<int>(warp);
  const int b = off[s];
  const int e = off[s + 1];
  T acc = ident;
  for (int q = b + lane; q < e; q += 32) acc = Op<OP>::apply(acc, vals[q]);
  for (int d = 16; d > 0; d >>= 1) {
    acc = Op<OP>::apply(acc, __shfl_down_sync(kFullMask, acc, d));
  }
  if (lane == 0) out[s] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
segment_any_all_kernel(const T* __restrict__ vals,
                       const int* __restrict__ off, int nseg, int all,
                       unsigned char* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warp = global_warp();
  if (warp >= nseg) return;
  const int s = static_cast<int>(warp);
  const int b = off[s];
  const int e = off[s + 1];
  bool hit = false;             // OR: some value is set; AND: some is not
  for (int q = b + lane; q < e && !hit; q += 32) {
    hit = all ? (vals[q] == T(0)) : (vals[q] != T(0));
  }
  hit = __any_sync(kFullMask, hit);
  if (lane == 0) out[s] = (all ? !hit : hit) ? 1 : 0;
}

template <typename T>
int segment_reduce_launch(const void* vals, const void* off, int nseg, int op,
                          T ident, void* out, cudaStream_t s) {
  if (nseg <= 0) return static_cast<int>(cudaGetLastError());
  const unsigned blocks = (static_cast<unsigned>(nseg) + kWarpsPerBlock - 1) /
                          kWarpsPerBlock;
  const T* v = static_cast<const T*>(vals);
  const int* o = static_cast<const int*>(off);
  switch (op) {
    case kAdd:
      segment_reduce_kernel<T, kAdd><<<blocks, kBlock, 0, s>>>(
          v, o, nseg, ident, static_cast<T*>(out));
      break;
    case kMin:
      segment_reduce_kernel<T, kMin><<<blocks, kBlock, 0, s>>>(
          v, o, nseg, ident, static_cast<T*>(out));
      break;
    case kMax:
      segment_reduce_kernel<T, kMax><<<blocks, kBlock, 0, s>>>(
          v, o, nseg, ident, static_cast<T*>(out));
      break;
    case kOr:
    case kAnd:
      segment_any_all_kernel<T><<<blocks, kBlock, 0, s>>>(
          v, o, nseg, op == kAnd ? 1 : 0, static_cast<unsigned char*>(out));
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// -------------------------------------------------------- segment_minmax --
//
// For each segment s and each of np <= 8 int32 payloads k: max[k][s] and
// min[k][s] over the ACTIVE positions q of [off[s], off[s+1]) (active[q] !=
// 0), with INT_MIN / INT_MAX where the segment is empty or has no active
// position; one warp per segment. Replaces the JAX package's
// scan_kernels.segmented_minmax_1d (:224), two inclusive segmented scans
// (MAX, MIN) over active elements with a carry across its sequential grid,
// whose caller segment.combine_minmax_multi (:351) then routes each
// segment's last value back to the vertex axis. Here each segment is reduced
// where it lies, as segment_reduce does for combine_by_offsets.
// Each lane strides over the segment, reads active[q] once and, only where it
// is set, the np payloads, folding them into 2 np registers; the warp folds
// the lanes with __reduce_max_sync / __reduce_min_sync, which are exact and
// independent of order, so the result repeats bit for bit.
// What bounds it: bytes, the active flags (one byte per position) and, at
// active positions, 4 np bytes of payloads, all coalesced, plus the offsets
// and the 8 np bytes per segment written. A hub's segment runs on one warp.

struct Payloads {
  const int* p[8];
};

template <int NP>
__global__ void __launch_bounds__(kBlock)
segment_minmax_kernel(Payloads in, const unsigned char* __restrict__ active,
                      const int* __restrict__ off, int nseg,
                      int* __restrict__ mx, int* __restrict__ mn) {
  const int lane = threadIdx.x & 31;
  const long long warp = global_warp();
  if (warp >= nseg) return;                 // warp-uniform
  const int s = static_cast<int>(warp);
  const int b = off[s];
  const int e = off[s + 1];
  int hi[NP], lo[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    hi[k] = INT_MIN;
    lo[k] = INT_MAX;
  }
  for (int q = b + lane; q < e; q += 32) {
    if (active[q] == 0) continue;
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const int v = __ldg(in.p[k] + q);
      hi[k] = max(hi[k], v);
      lo[k] = min(lo[k], v);
    }
  }
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    hi[k] = __reduce_max_sync(kFullMask, hi[k]);
    lo[k] = __reduce_min_sync(kFullMask, lo[k]);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      mx[static_cast<long long>(k) * nseg + s] = hi[k];
      mn[static_cast<long long>(k) * nseg + s] = lo[k];
    }
  }
}

template <int NP>
void segment_minmax_launch(const Payloads& in, const unsigned char* active,
                           const int* off, int nseg, int* mx, int* mn,
                           cudaStream_t s) {
  const unsigned blocks = (static_cast<unsigned>(nseg) + kWarpsPerBlock - 1) /
                          kWarpsPerBlock;
  segment_minmax_kernel<NP><<<blocks, kBlock, 0, s>>>(in, active, off, nseg,
                                                      mx, mn);
}

// --------------------------------------------------------- advance_count --
//
// out[v] = the number of in-edges q of v (CSC slots off[v] .. off[v+1])
// whose source is in the frontier, frontier[csc_src[q]] != 0. Replaces
// advance.advance_count (:175): on the TPU the 7-kernel chain
// cube_router.apply_cube_chain_n (:754) (expand over the CSR offsets route,
// the CSR->CSC route, the prefix back through the inverse CSC offsets route)
// and the "first" segmented_scan after it. BFS's dense tier takes out > 0.
//
// One C call, three steps on the stream: out is zeroed (cudaMemsetAsync);
// advance_count_pack_kernel packs the [Vp] byte frontier into Vp/8 bytes of
// bits (128 KiB at Vp = 2^20) and, with one warp per chunk boundary, finds
// the first row of every chunk; advance_count_kernel counts. The counting
// grid is one 1,024-thread block per SM, each walking chunks of
// kCountChunk CSC slots (16 per thread, loaded with 128-bit evict-first
// loads; the next chunk's slots and row bounds are in flight while this one
// is counted), so the work is balanced by edges whatever the degrees. Each
// slot's test is a bit of the packed frontier: in the "shared" tier the
// block first copies the whole bitmap into shared memory with asynchronous
// copies, so a test is a shared-memory load and not a scattered 32-byte L2
// sector; in the "global" tier (a bitmap larger than the block's shared
// memory, or a caller's cap) the bits are read from the packed global copy,
// which the L1 caches. The hits of a chunk become a bit array and a prefix
// of its popcounts in shared memory; each row overlapping the chunk counts
// its hits in O(1) and stores them, or adds them with an int32 atomicAdd
// (exact and order-free) where the row crosses a chunk boundary.
// What bounds it: bytes, csc_src streamed once (4 B per slot), the
// offsets read once, the frontier read once and the counts written once.

constexpr int kCountBlock = 1024;
constexpr int kCountItems = 16;
constexpr int kCountChunk = kCountBlock * kCountItems;   // slots per chunk
constexpr int kChunkWords = kCountChunk / 32;

// Blocks [0, pack_blocks) pack the frontier, one 32-bit word per thread;
// the blocks after them find bounds[c] = the first row r with off[r] >=
// c * kCountChunk for each chunk c < nchunks, one warp each, and bounds[
// nchunks] = vp.
__global__ void __launch_bounds__(kBlock)
advance_count_pack_kernel(const unsigned char* __restrict__ frontier,
                          int vp, unsigned* __restrict__ bits,
                          int pack_blocks, const int* __restrict__ off,
                          int nchunks, int* __restrict__ bounds) {
  if (static_cast<int>(blockIdx.x) >= pack_blocks) {
    const int c = (static_cast<int>(blockIdx.x) - pack_blocks) *
                  kWarpsPerBlock + (threadIdx.x >> 5);
    if (c > nchunks) return;                  // warp-uniform
    const int r = c == nchunks ? vp
                               : etpu::warp_lower_bound(off, vp,
                                                        c * kCountChunk);
    if ((threadIdx.x & 31) == 0) bounds[c] = r;
    return;
  }
  const long long w = static_cast<long long>(blockIdx.x) * kBlock +
                      threadIdx.x;
  const long long v0 = w * 32;
  if (v0 >= vp) return;
  unsigned word = 0;
  if (v0 + 32 <= vp &&
      (reinterpret_cast<uintptr_t>(frontier) & 15) == 0) {
    const uint4* p = reinterpret_cast<const uint4*>(frontier + v0);
    const uint4 a = __ldcs(p);
    const uint4 b = __ldcs(p + 1);
    const unsigned part[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      // one bit per nonzero byte: the four bytes' low bits gathered into
      // bits 28-31 by one multiply
      const unsigned ones = __vcmpne4(part[k], 0u) & 0x01010101u;
      word |= ((ones * 0x10204080u) >> 28) << (4 * k);
    }
  } else {
    for (int i = 0; i < 32 && v0 + i < vp; ++i) {
      if (frontier[v0 + i]) word |= 1u << i;
    }
  }
  bits[w] = word;
}

// The kCountItems CSC sources of one thread's slots [p, p + 16), 0 past hi.
__device__ __forceinline__ void load_sources(const int* __restrict__ src,
                                             long long p, long long hi,
                                             int (&s)[kCountItems]) {
  if (p + kCountItems <= hi && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int4* s4 = reinterpret_cast<const int4*>(src + p);
#pragma unroll
    for (int q = 0; q < kCountItems / 4; ++q) {
      const int4 t = __ldcs(s4 + q);
      s[4 * q] = t.x;
      s[4 * q + 1] = t.y;
      s[4 * q + 2] = t.z;
      s[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kCountItems; ++j) {
      s[j] = p + j < hi ? __ldcs(src + p + j) : 0;
    }
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kCountBlock, 1)
advance_count_kernel(const unsigned* __restrict__ bits, int words4,
                     const int* __restrict__ off,
                     const int* __restrict__ src,
                     const int* __restrict__ bounds, int vp, int ep,
                     int nchunks, int* __restrict__ out) {
  extern __shared__ uint4 s_bits4[];          // kShared: the packed frontier
  __shared__ unsigned short s_hit[kCountBlock];   // 16 hit bits per thread
  __shared__ int s_pre[kChunkWords + 1];      // hits before each word; total
  __shared__ int s_warp[kCountBlock / 32];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  if constexpr (kShared) {
    const uint4* g4 = reinterpret_cast<const uint4*>(bits);
    for (int i = tid; i < words4; i += kCountBlock) {
      __pipeline_memcpy_async(s_bits4 + i, g4 + i, sizeof(uint4));
    }
    __pipeline_commit();
  }
  const unsigned* fb =
      kShared ? reinterpret_cast<const unsigned*>(s_bits4) : bits;
  int s[kCountItems];
  int c = blockIdx.x;
  load_sources(src, static_cast<long long>(c) * kCountChunk +
               tid * kCountItems, ep, s);
  int rlo = bounds[c];
  int rhi = bounds[c + 1];
  if constexpr (kShared) __pipeline_wait_prior(0);
  __syncthreads();                            // the bitmap is in place

  for (; c < nchunks; c += gridDim.x) {
    const int lo = c * kCountChunk;
    const int hi = static_cast<int>(min(static_cast<long long>(lo) +
                                        kCountChunk,
                                        static_cast<long long>(ep)));
    // this thread's hits, then the next chunk's sources in flight
    unsigned h = 0;
#pragma unroll
    for (int j = 0; j < kCountItems; ++j) {
      const unsigned v = static_cast<unsigned>(s[j]);
      if (lo + tid * kCountItems + j < hi) {
        h |= ((fb[v >> 5] >> (v & 31)) & 1u) << j;
      }
    }
    const int next = c + gridDim.x;
    int next_rlo = 0;
    int next_rhi = 0;
    if (next < nchunks) {
      load_sources(src, static_cast<long long>(next) * kCountChunk +
                   tid * kCountItems, ep, s);
      next_rlo = bounds[next];
      next_rhi = bounds[next + 1];
    }
    s_hit[tid] = static_cast<unsigned short>(h);
    __syncthreads();

    // the chunk's hit words and the exclusive prefix of their popcounts
    int pc = 0;
    if (tid < kChunkWords) {
      pc = __popc(s_hit[2 * tid] | (static_cast<unsigned>(s_hit[2 * tid + 1])
                                    << 16));
    }
    int incl = pc;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(kFullMask, incl, d);
      if (lane >= d) incl += t;
    }
    if (lane == 31) s_warp[wid] = incl;
    __syncthreads();
    if (tid < kChunkWords) {
      int before = 0;
      for (int k = 0; k < wid; ++k) before += s_warp[k];
      s_pre[tid] = before + incl - pc;
      if (tid == kChunkWords - 1) s_pre[kChunkWords] = before + incl;
    }
    __syncthreads();

    // hits in the chunk's slots [lo, lo + i)
    auto hits_before = [&](int i) {
      const int k = i >> 5;
      const int r = i & 31;
      int n = s_pre[k];
      if (r) {
        const unsigned word = s_hit[2 * k] |
                              (static_cast<unsigned>(s_hit[2 * k + 1]) << 16);
        n += __popc(word & ((1u << r) - 1u));
      }
      return n;
    };
    for (int r = rlo + tid; r < rhi; r += kCountBlock) {
      const int b = off[r];
      const int e = off[r + 1];
      const int n = hits_before(min(e, hi) - lo) - hits_before(b - lo);
      if (n == 0) continue;                   // out was zeroed
      if (e <= hi) out[r] = n; else atomicAdd(out + r, n);
    }
    if (tid == 0) {                           // a row begun before lo
      const int first = min(off[rlo], hi);    // off[vp] == ep >= hi
      if (first > lo) {
        const int n = hits_before(first - lo);
        if (n) atomicAdd(out + rlo - 1, n);
      }
    }
    rlo = next_rlo;
    rhi = next_rhi;
    __syncthreads();                          // before s_hit is written again
  }
}

// bits: the packed frontier, 16 * words4 bytes, then nchunks + 1 ints of
// chunk bounds.
int count_launch(const void* frontier, const void* off, const void* src,
                 int vp, int ep, void* bits, int shared, void* out,
                 cudaStream_t s) {
  if (vp <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(int) * vp, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nw = (vp + 31) / 32;
  const int words4 = (nw + 3) / 4;
  const int nchunks = ep > 0 ? (ep + kCountChunk - 1) / kCountChunk : 0;
  const int pack_blocks = (nw + kBlock - 1) / kBlock;
  int* bounds = static_cast<int*>(bits) + 4 * words4;
  advance_count_pack_kernel<<<pack_blocks + nchunks / kWarpsPerBlock + 1,
                              kBlock, 0, s>>>(
      static_cast<const unsigned char*>(frontier), vp,
      static_cast<unsigned*>(bits), pack_blocks,
      static_cast<const int*>(off), nchunks, bounds);
  if (ep <= 0) return static_cast<int>(cudaGetLastError());
  int dev = 0;
  int sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int grid = min(nchunks, sms);
  const auto* b = static_cast<const unsigned*>(bits);
  const int* o = static_cast<const int*>(off);
  const int* q = static_cast<const int*>(src);
  int* cnt = static_cast<int*>(out);
  if (shared) {
    const int bytes = static_cast<int>(sizeof(uint4)) * words4;
    err = cudaFuncSetAttribute(advance_count_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    advance_count_kernel<true><<<grid, kCountBlock, bytes, s>>>(
        b, words4, o, q, bounds, vp, ep, nchunks, cnt);
  } else {
    advance_count_kernel<false><<<grid, kCountBlock, 0, s>>>(
        b, words4, o, q, bounds, vp, ep, nchunks, cnt);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Scratch (from the wrapper): total_v [G] of the element type, total_f [G]
// uint8, first [G] int32, G = ceil(n / 2048). `flags` may be null.
int etpu_scan_i32(const void* x, const void* flags, void* out, void* total_v,
                  void* total_f, void* first, long long n, int op,
                  void* stream) {
  return scan_dispatch<int>(x, flags, out, total_v, total_f, first, n, op,
                            static_cast<cudaStream_t>(stream));
}

int etpu_scan_f32(const void* x, const void* flags, void* out, void* total_v,
                  void* total_f, void* first, long long n, int op,
                  void* stream) {
  return scan_dispatch<float>(x, flags, out, total_v, total_f, first, n, op,
                              static_cast<cudaStream_t>(stream));
}

int etpu_scan_tile() { return kScanTile; }

// Payloads beyond the np-th may be null; the outputs must be 16-byte
// aligned. rec: null, or scratch of len packed records (8 bytes each for
// np = 2, 16 for np = 3-4, aligned to its size) to pack the payloads' first
// len words into and gather from; every index must then be below len.
int etpu_gather_payloads(const void* idx, long long n, const void* in0,
                         const void* in1, const void* in2, const void* in3,
                         void* out0, void* out1, void* out2, void* out3,
                         int np, void* rec, int len, void* stream) {
  if (np < 1 || np > 4) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const Gather g = {{static_cast<const int*>(in0),
                     static_cast<const int*>(in1),
                     static_cast<const int*>(in2),
                     static_cast<const int*>(in3)},
                    {static_cast<int*>(out0), static_cast<int*>(out1),
                     static_cast<int*>(out2), static_cast<int*>(out3)}};
  const int* ix = static_cast<const int*>(idx);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (np) {
    case 1: return gather_launch<1>(ix, n, g, nullptr, 0, s);
    case 2: return gather_launch<2>(ix, n, g, rec, len, s);
    case 3: return gather_launch<3>(ix, n, g, rec, len, s);
    default: return gather_launch<4>(ix, n, g, rec, len, s);
  }
}

// op: 0 sum, 1 min, 2 max (out of the value type), 3 or, 4 and (uint8 out).
int etpu_segment_reduce_i32(const void* vals, const void* off, int nseg,
                            int op, int ident, void* out, void* stream) {
  return segment_reduce_launch<int>(vals, off, nseg, op, ident, out,
                                    static_cast<cudaStream_t>(stream));
}

int etpu_segment_reduce_f32(const void* vals, const void* off, int nseg,
                            int op, float ident, void* out, void* stream) {
  return segment_reduce_launch<float>(vals, off, nseg, op, ident, out,
                                      static_cast<cudaStream_t>(stream));
}

// p0..p7: the np payloads, [n] int32 each (those beyond the np-th may be
// null); active [n] uint8; mx, mn [np, nseg] int32.
int etpu_segment_minmax(const void* p0, const void* p1, const void* p2,
                        const void* p3, const void* p4, const void* p5,
                        const void* p6, const void* p7, int np,
                        const void* active, const void* off, int nseg,
                        void* mx, void* mn, void* stream) {
  if (np < 1 || np > 8) return static_cast<int>(cudaErrorInvalidValue);
  if (nseg > 0) {
    const Payloads in = {{static_cast<const int*>(p0),
                          static_cast<const int*>(p1),
                          static_cast<const int*>(p2),
                          static_cast<const int*>(p3),
                          static_cast<const int*>(p4),
                          static_cast<const int*>(p5),
                          static_cast<const int*>(p6),
                          static_cast<const int*>(p7)}};
    const unsigned char* a = static_cast<const unsigned char*>(active);
    const int* o = static_cast<const int*>(off);
    int* hi = static_cast<int*>(mx);
    int* lo = static_cast<int*>(mn);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (np) {
      case 1: segment_minmax_launch<1>(in, a, o, nseg, hi, lo, s); break;
      case 2: segment_minmax_launch<2>(in, a, o, nseg, hi, lo, s); break;
      case 3: segment_minmax_launch<3>(in, a, o, nseg, hi, lo, s); break;
      case 4: segment_minmax_launch<4>(in, a, o, nseg, hi, lo, s); break;
      case 5: segment_minmax_launch<5>(in, a, o, nseg, hi, lo, s); break;
      case 6: segment_minmax_launch<6>(in, a, o, nseg, hi, lo, s); break;
      case 7: segment_minmax_launch<7>(in, a, o, nseg, hi, lo, s); break;
      default: segment_minmax_launch<8>(in, a, o, nseg, hi, lo, s); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// bits: 16 * ceil(ceil(vp / 32) / 4) bytes of scratch, 16-byte aligned,
// then 4 * (ceil(ep / kCountChunk) + 1) bytes;
// shared: 1 for the shared-memory tier (its bytes must not pass
// etpu_advance_count_shared_bytes()), 0 for the global tier.
int etpu_advance_count(const void* frontier, const void* off,
                       const void* csc_src, int vp, int ep, void* bits,
                       int shared, void* out, void* stream) {
  return count_launch(frontier, off, csc_src, vp, ep, bits, shared, out,
                      static_cast<cudaStream_t>(stream));
}

// Slots per advance_count chunk (ADVANCE_CHUNK in kernels.py).
int etpu_advance_count_chunk() { return kCountChunk; }

// The most bitmap bytes the shared-memory tier can hold on the current
// device: the opt-in shared memory of a block less the kernel's static
// shared memory; -1 on a CUDA error.
int etpu_advance_count_shared_bytes() {
  int dev = 0;
  int optin = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, advance_count_kernel<true>) !=
          cudaSuccess) {
    return -1;
  }
  return optin - static_cast<int>(attr.sharedSizeBytes);
}

}  // extern "C"
