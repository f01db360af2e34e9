// Hand-written CUDA kernels of the operator layer (scan, gather, segment
// reduce, segment min/max, advance count), for Hopper (sm_90a).
//
// Built by essentials_tpu_torch/kernels.py with nvcc into the shared library
// of every csrc/*.cu, with a plain C interface, loaded with ctypes. Every
// entry point launches on the stream it is given, allocates nothing (the
// wrapper passes outputs and scratch; scan, segment_reduce and
// segment_minmax zero their status words with cudaMemsetAsync), and returns
// the CUDA status so that a refused launch reaches the Python wrapper.
//
// Layout contract (essentials_tpu_torch/graph/graph.py): offsets are [S+1]
// int32 and sorted, segment s is [off[s], off[s+1]); `csc_src` is the [Ep]
// int32 source of each CSC slot. The only atomics on data are
// advance_count's int32 additions and segment_minmax's int32 max and min,
// which are exact in any order (the tickets and status words only order
// tiles), so every result, float sums included, is the same bit for bit on
// every run.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <type_traits>

#include "tile_status.cuh"
#include "warp_search.cuh"

namespace {

constexpr int kBlock = 256;                 // threads per block
constexpr int kWarpsPerBlock = kBlock / 32;
constexpr unsigned kFullMask = 0xffffffffu;
using etpu::bits_of;
using etpu::from_bits;
using etpu::load_status;
using etpu::nonzero_bytes;
using etpu::publish_status;

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
// Inclusive scan, optionally segmented by start flags, in one launch.
// Replaces the JAX package's scan_kernels.scan_1d (:274) and
// segmented_scan_1d (:296), whose one Pallas body _scan_kernel (:124)
// streams [1024, 128] blocks in order and carries the running value across
// its sequential grid in SMEM.
//
// Elements are (value, flag) pairs under the associative operator of
// scan_kernels.py:15-17, (v1,f1)·(v2,f2) = (f2 ? v2 : op(v1,v2), f1|f2);
// position 0 always starts a segment. No identity is needed: a pair with
// nothing before it is left alone.
//
// Tiles of kScanTile elements, one block each; tile ids come from an atomic
// ticket, so a tile waits only on tiles that already run, and the launch
// cannot deadlock. Within a tile each thread loads its kScanItems
// consecutive elements with 16-byte loads (its flags as 4-byte words),
// scans them serially, and the block joins its threads by a shuffle scan
// per warp and one pass over the warps' totals. The tile then publishes its
// aggregate pair in its 64-bit status word (state in bits 32-33, the
// value's bits below) at once, before it waits for anything; the last tile
// of each group of kScanGroup tiles also publishes the group's aggregate
// (a fixed tree over its tiles' words) in the group's word. A tile's carry
// is folded from the words before it back to the nearest "complete" one:
// the 32 tiles before it by warp 0, waiting only for the words before the
// nearest complete one; then the rest of its group, then the groups before
// it, by the whole block, kBlock words at a time. So a tile reads at most
// kScanGroup + g / kScanGroup words, g tiles. A word is complete
//   - at once where its tile (group) holds a start flag: its aggregate does
//     not depend on anything before it (tile 0 always holds one);
//   - under int32 add (wrap-around), min, max and first, which are exact
//     in any order, also once a tile knows its carry and publishes its
//     inclusive prefix in its word: a decoupled look-back;
//   - under float32 add by its flags alone: no prefix is published, and the
//     carry is folded from aggregates by fixed trees, so the order of every
//     float addition is set by n and the flags, and a float scan repeats
//     bit for bit.
//
// What bounds it: bytes, x and the flags read once and the output written
// once (8-9 bytes an element); the status words stay in the L2.
//
// The tile body, scan_tile, takes its elements from a load functor:
// PlainLoad reads x (scan_kernel); RouteLoad computes (lev[eid[p]] == it)
// as it loads, so that fused_route_or_kernel is the segmented int32 max of
// those 0/1 values (an OR) in the same one launch.

constexpr int kScanItems = 8;               // consecutive elements per thread
constexpr int kScanTile = kBlock * kScanItems;   // elements per tile
constexpr int kScanGroup = kBlock;          // tiles per group word
// a word's state, bits 32-33: not yet published; an aggregate with no start
// flag; complete (no later tile needs anything before it: an aggregate with
// a flag, or an inclusive prefix)
enum ScanState : unsigned { kScanUnset = 0, kScanPartial = 1,
                            kScanComplete = 2 };

// bit j: byte j of the kItems bytes at f (4-byte aligned) is not 0
template <int kItems>
__device__ __forceinline__ unsigned flag_bits(const unsigned char* f) {
  unsigned m = 0;
#pragma unroll
  for (int q = 0; q < kItems / 4; ++q) {
    m |= nonzero_bytes(__ldcs(reinterpret_cast<const unsigned*>(f) + q))
         << (4 * q);
  }
  return m;
}

// (h, v) = (ov older than v) then (h, v), for pairs that may hold nothing
// and hold no start flag
template <typename T, int OP>
__device__ __forceinline__ void fold_older(bool& h, T& v, bool oh, T ov) {
  if (oh) {
    v = h ? Op<OP>::apply(ov, v) : ov;
    h = true;
  }
}

// (h, v, f) = (h, v, f) then the newer pair (nv, nf)
template <typename T, int OP>
__device__ __forceinline__ void append(bool& h, T& v, int& f, T nv, int nf) {
  v = h && !nf ? Op<OP>::apply(v, nv) : nv;
  f |= nf;
  h = true;
}

// Folds the lanes' pairs (h, v) into lane 0's, lanes 0..31 from the newest
// to the oldest, the older in front, by a fixed tree: lane l takes l+1,
// then l+2..l+3, then l+4..l+7, ...
template <typename T, int OP>
__device__ __forceinline__ void warp_fold_older(bool& h, T& v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T ov = __shfl_down_sync(kFullMask, v, d);
    const int oh = __shfl_down_sync(kFullMask, static_cast<int>(h), d);
    if (lane + d < 32) fold_older<T, OP>(h, v, oh != 0, ov);
  }
}

template <typename T>
struct ScanShared {
  T wv[kWarpsPerBlock];                     // the warps' pairs
  int wf[kWarpsPerBlock];
  T gv[kWarpsPerBlock];                     // the warps' parts of a group
  int gf[kWarpsPerBlock];
  int stop[kWarpsPerBlock];
  long long b;
  int head;                                 // the tile's first element starts
  int found;                                // warp 0 met a complete word
  T carry;
};

// The whole block folds the words w[k], w[k-1], ..., w[lo], kBlock at a
// time (thread t reads w[k - t]), back to the nearest complete one into
// thread 0's (ch, cv), the older in front: a fixed tree per window and the
// windows from near to far. Returns (to every thread) whether it met a
// complete word.
template <typename T, int OP>
__device__ bool block_look_back(const unsigned long long* w, long long k,
                                long long lo, bool& ch, T& cv,
                                ScanShared<T>& sh) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (;; k -= kBlock) {
    const long long p = k - tid;
    unsigned long long s = 0;
    if (p >= lo) {
      while (((s = load_status(w + p)) >> 32) == kScanUnset) {
        __nanosleep(32);
      }
    }
    const unsigned done = __ballot_sync(
        kFullMask, p >= lo && (s >> 32) == kScanComplete);
    if (lane == 0) sh.stop[warp] = done ? warp * 32 + __ffs(done) - 1 : kBlock;
    __syncthreads();
    int stop = kBlock;
    for (int i = 0; i < kWarpsPerBlock; ++i) stop = min(stop, sh.stop[i]);
    bool h = p >= lo && tid <= stop;
    T v = from_bits<T>(static_cast<unsigned>(s));
    warp_fold_older<T, OP>(h, v);
    if (lane == 0) {
      sh.wv[warp] = v;
      sh.wf[warp] = h;
    }
    __syncthreads();
    if (tid == 0) {                         // the warps, oldest first
      bool wh = false;
      T wv = T(0);
      for (int i = kWarpsPerBlock - 1; i >= 0; --i) {
        if (sh.wf[i]) {
          wv = wh ? Op<OP>::apply(wv, sh.wv[i]) : sh.wv[i];
          wh = true;
        }
      }
      fold_older<T, OP>(ch, cv, wh, wv);    // the window is older
    }
    if (stop < kBlock) return true;
    if (k - kBlock < lo) return false;
  }
}

// The elements of scan: x[p], a thread's kScanItems at p0 by 16-byte loads
// that evict first (read once).
template <typename T>
struct PlainLoad {
  const T* __restrict__ x;
  __device__ T at(long long p) const { return x[p]; }
  __device__ void whole(long long p0, T (&v)[kScanItems]) const {
    const uint4* xq = reinterpret_cast<const uint4*>(x + p0);
#pragma unroll
    for (int q = 0; q < kScanItems / 4; ++q) {
      const uint4 w = __ldcs(xq + q);
      v[4 * q] = from_bits<T>(w.x);
      v[4 * q + 1] = from_bits<T>(w.y);
      v[4 * q + 2] = from_bits<T>(w.z);
      v[4 * q + 3] = from_bits<T>(w.w);
    }
  }
};

// The elements of fused_route_or: 1 where lev[eid[p]] == it, else 0. A
// thread's ids arrive by 16-byte loads, then all its lev gathers are issued
// before any is compared, so that each thread has kScanItems in flight.
// (Tiles of 16 a thread took 11-19% more device time at rmat18's and
// gen:rmat20x16's largest BFS levels: chip_ab.py's fill group, NVIDIA H100
// 80GB HBM3, 700 W.)
struct RouteLoad {
  const int* __restrict__ lev;
  const int* __restrict__ eid;
  int it;
  __device__ int at(long long p) const { return __ldg(lev + eid[p]) == it; }
  __device__ void whole(long long p0, int (&v)[kScanItems]) const {
    int e[kScanItems];
    const uint4* q4 = reinterpret_cast<const uint4*>(eid + p0);
#pragma unroll
    for (int q = 0; q < kScanItems / 4; ++q) {
      const uint4 w = __ldcs(q4 + q);
      e[4 * q] = static_cast<int>(w.x);
      e[4 * q + 1] = static_cast<int>(w.y);
      e[4 * q + 2] = static_cast<int>(w.z);
      e[4 * q + 3] = static_cast<int>(w.w);
    }
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) v[j] = __ldg(lev + e[j]);
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) v[j] = v[j] == it;
  }
};

// One tile of kScanTile elements taken from `ld`. kPrefix: publish
// inclusive prefixes (every op but float add). `vec`: ld's vector loads,
// out and flags are aligned for whole-thread vectors. status: the tiles'
// words; group: the groups' words.
template <typename T, int OP, bool kPrefix, typename Load>
__device__ __forceinline__ void scan_tile(
    const Load& ld, const unsigned char* __restrict__ flags,
    T* __restrict__ out, long long n, bool vec, unsigned long long* status,
    unsigned long long* group, unsigned* ticket) {
  __shared__ ScanShared<T> sh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) sh.b = atomicAdd(ticket, 1u);
  __syncthreads();
  const long long b = sh.b;
  const long long p0 = b * kScanTile + static_cast<long long>(tid) * kScanItems;
  const bool whole = vec && p0 + kScanItems <= n;

  // 1. load; bit j of fm: element j starts a segment (or lies past n)
  T v[kScanItems];
  unsigned fm = 0;
  if (whole) {
    ld.whole(p0, v);
    if (flags != nullptr) fm = flag_bits<kScanItems>(flags + p0);
  } else {
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      const long long p = p0 + j;
      if (p < n) {
        v[j] = ld.at(p);
        if (flags != nullptr && flags[p] != 0) fm |= 1u << j;
      } else {
        v[j] = T(0);
        fm |= 1u << j;
      }
    }
  }
  if (p0 == 0) fm |= 1u;

  // 2. the thread's serial scan, then an inclusive shuffle scan of the
  //    threads' total pairs within the warp
#pragma unroll
  for (int j = 1; j < kScanItems; ++j) {
    if (!(fm >> j & 1u)) v[j] = Op<OP>::apply(v[j - 1], v[j]);
  }
  T av = v[kScanItems - 1];
  int af = fm != 0;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T pv = __shfl_up_sync(kFullMask, av, d);
    const int pf = __shfl_up_sync(kFullMask, af, d);
    if (lane >= d) {
      if (!af) av = Op<OP>::apply(pv, av);
      af |= pf;
    }
  }
  const T ev = __shfl_up_sync(kFullMask, av, 1);   // exclusive within warp
  const int ef = __shfl_up_sync(kFullMask, af, 1);
  if (lane == 31) {
    sh.wv[warp] = av;
    sh.wf[warp] = af;
  }
  if (tid == 0) sh.head = fm & 1u;
  __syncthreads();

  // 3. the pair of everything before this thread within the tile, and
  //    (thread 0) the tile's aggregate, published at once
  bool th = false;
  T tv = T(0);
  int tf = 0;
  for (int i = 0; i < warp; ++i) append<T, OP>(th, tv, tf, sh.wv[i], sh.wf[i]);
  if (lane > 0) append<T, OP>(th, tv, tf, ev, ef);
  T agg = T(0);
  int agg_f = 0;
  if (tid == 0) {
    bool h = false;
    for (int i = 0; i < kWarpsPerBlock; ++i) {
      append<T, OP>(h, agg, agg_f, sh.wv[i], sh.wf[i]);
    }
    publish_status(status + b, agg_f ? kScanComplete : kScanPartial,
                   bits_of(agg));
  }

  // 4. the last tile of a group publishes the group's pair: its tiles'
  //    words (complete ones as flagged pairs) by a fixed tree, the older in
  //    front (block-uniform)
  if (b % kScanGroup == kScanGroup - 1) {
    unsigned long long s;
    while (((s = load_status(status + b - tid)) >> 32) == kScanUnset) {
      __nanosleep(32);
    }
    T gv = from_bits<T>(static_cast<unsigned>(s));
    int gf = (s >> 32) == kScanComplete;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {      // lane l takes l+1, l+2..l+3, ...
      const T ov = __shfl_down_sync(kFullMask, gv, d);
      const int of = __shfl_down_sync(kFullMask, gf, d);
      if (lane + d < 32) {
        if (!gf) gv = Op<OP>::apply(ov, gv);
        gf |= of;
      }
    }
    if (lane == 0) {
      sh.gv[warp] = gv;
      sh.gf[warp] = gf;
    }
    __syncthreads();
    if (tid == 0) {                         // the warps, oldest first
      bool h = false;
      T v = T(0);
      int f = 0;
      for (int i = kWarpsPerBlock - 1; i >= 0; --i) {
        append<T, OP>(h, v, f, sh.gv[i], sh.gf[i]);
      }
      publish_status(group + b / kScanGroup,
                     f ? kScanComplete : kScanPartial, bits_of(v));
    }
  }

  // 5. the carry, where the tile's first element starts no segment
  //    (block-uniform): warp 0 folds the tiles b-1 .. b-32 of its group,
  //    one a lane, waiting only for the words before the nearest complete
  //    one; then the block the rest of its group and the groups before it
  bool ch = false;
  T cv = T(0);
  if (b > 0 && !sh.head) {
    const long long first = b / kScanGroup * kScanGroup;   // of b's group
    if (warp == 0) {
      const long long p = b - 1 - lane;
      const bool in = p >= first;
      unsigned long long s = in ? load_status(status + p) : 0;
      unsigned c;                           // the lanes with a complete word
      int stop;                             // the first of them
      while (true) {
        const unsigned st = in ? static_cast<unsigned>(s >> 32)
                               : kScanPartial;
        c = __ballot_sync(kFullMask, st == kScanComplete);
        const unsigned known = __ballot_sync(kFullMask, st != kScanUnset);
        stop = c ? __ffs(c) - 1 : 31;
        const unsigned need = stop == 31 ? kFullMask : (2u << stop) - 1u;
        if ((known & need) == need) break;  // warp-uniform
        __nanosleep(32);
        if (in && st == kScanUnset) s = load_status(status + p);
      }
      bool h = in && lane <= stop;
      T w = from_bits<T>(static_cast<unsigned>(s));
      warp_fold_older<T, OP>(h, w);
      if (lane == 0) {
        ch = h;
        cv = w;
        sh.found = c != 0;
      }
    }
    __syncthreads();
    bool found = sh.found;
    if (!found && b - 33 >= first) {
      found = block_look_back<T, OP>(status, b - 33, first, ch, cv, sh);
    }
    if (!found) {                           // never in group 0: tile 0 is
      block_look_back<T, OP>(group, b / kScanGroup - 1, 0, ch, cv, sh);
    }
    if (tid == 0) {
      sh.carry = cv;
      if (kPrefix && !agg_f) {
        publish_status(status + b, kScanComplete,
                       bits_of(Op<OP>::apply(cv, agg)));
      }
    }
    __syncthreads();
    ch = true;
    cv = sh.carry;
  }

  // 6. the carry in front of the thread's prefix where nothing in the tile
  //    before the thread starts a segment, then the thread's elements up to
  //    its first start
  if (ch && !tf) {
    tv = th ? Op<OP>::apply(cv, tv) : cv;
    th = true;
  }
  if (th) {
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      if (fm & ((2u << j) - 1u)) break;     // a start at or before j
      v[j] = Op<OP>::apply(tv, v[j]);
    }
  }
  if (whole) {
    uint4* oq = reinterpret_cast<uint4*>(out + p0);
#pragma unroll
    for (int q = 0; q < kScanItems / 4; ++q) {
      __stcs(oq + q, make_uint4(bits_of(v[4 * q]), bits_of(v[4 * q + 1]),
                                bits_of(v[4 * q + 2]), bits_of(v[4 * q + 3])));
    }
  } else {
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      if (p0 + j < n) out[p0 + j] = v[j];
    }
  }
}

template <typename T, int OP, bool kPrefix>
__global__ void __launch_bounds__(kBlock)
scan_kernel(const T* __restrict__ x, const unsigned char* __restrict__ flags,
            T* __restrict__ out, long long n, bool vec,
            unsigned long long* status, unsigned long long* group,
            unsigned* ticket) {
  scan_tile<T, OP, kPrefix>(PlainLoad<T>{x}, flags, out, n, vec, status,
                            group, ticket);
}

// The route OR of fused_bfs.py: the segmented OR of (lev[eid[p]] == it),
// i.e. scan's int32 max over those 0/1 values, one launch.
//
// Replaces the JAX package's essentials_tpu/ops/fused_bfs.py
// fused_route_or (:603): the compare fused into the first cube kernel
// (_k1_eq_kernel :173), the Benes middle, and the segmented OR fused into
// the last (_k3_segor_kernel :184). Here the move is a gather through
// csc_edge_ids, done as the tile loads. What bounds it: the streamed ids,
// flags and output (9 bytes a position) and one L2 sector a lev gather.
__global__ void __launch_bounds__(kBlock)
fused_route_or_kernel(const int* __restrict__ lev,
                      const int* __restrict__ eid,
                      const unsigned char* __restrict__ flags, int it,
                      int* __restrict__ out, long long n, bool vec,
                      unsigned long long* status, unsigned long long* group,
                      unsigned* ticket) {
  scan_tile<int, kMax, true>(RouteLoad{lev, eid, it}, flags, out, n, vec,
                             status, group, ticket);
}

long long scan_tiles(long long n) { return (n + kScanTile - 1) / kScanTile; }
long long scan_groups(long long g) { return (g + kScanGroup - 1) / kScanGroup; }

// Zeroes the status words of g tiles, then their groups' words, then the
// ticket, at `scratch` on the stream.
cudaError_t zero_scan_scratch(void* scratch, long long g, cudaStream_t s) {
  return cudaMemsetAsync(
      scratch, 0,
      sizeof(unsigned long long) * (g + scan_groups(g)) + sizeof(unsigned),
      s);
}

template <typename T, int OP>
int scan_launch(const void* x, const void* flags, void* out, void* scratch,
                long long n, cudaStream_t s) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const long long g = scan_tiles(n);
  auto* status = static_cast<unsigned long long*>(scratch);
  const cudaError_t err = zero_scan_scratch(scratch, g, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(out) |
                     reinterpret_cast<uintptr_t>(flags)) & 15u) == 0;
  constexpr bool kPrefix = !(std::is_same<T, float>::value && OP == kAdd);
  scan_kernel<T, OP, kPrefix><<<static_cast<unsigned>(g), kBlock, 0, s>>>(
      static_cast<const T*>(x), static_cast<const unsigned char*>(flags),
      static_cast<T*>(out), n, vec, status, status + g,
      reinterpret_cast<unsigned*>(status + g + scan_groups(g)));
  return static_cast<int>(cudaGetLastError());
}

int route_or_launch(const int* lev, const int* eid, const unsigned char* f,
                    long long n, int it, int* out, void* scratch,
                    cudaStream_t s) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const long long g = scan_tiles(n);
  auto* status = static_cast<unsigned long long*>(scratch);
  const cudaError_t err = zero_scan_scratch(scratch, g, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = ((reinterpret_cast<uintptr_t>(eid) |
                     reinterpret_cast<uintptr_t>(out)) & 15u) == 0 &&
                   (reinterpret_cast<uintptr_t>(f) & 3u) == 0;
  fused_route_or_kernel<<<static_cast<unsigned>(g), kBlock, 0, s>>>(
      lev, eid, f, it, out, n, vec, status, status + g,
      reinterpret_cast<unsigned*>(status + g + scan_groups(g)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int scan_dispatch(const void* x, const void* flags, void* out, void* scratch,
                  long long n, int op, cudaStream_t s) {
  switch (op) {
    case kAdd: return scan_launch<T, kAdd>(x, flags, out, scratch, n, s);
    case kMin: return scan_launch<T, kMin>(x, flags, out, scratch, n, s);
    case kMax: return scan_launch<T, kMax>(x, flags, out, scratch, n, s);
    case kFirst: return scan_launch<T, kFirst>(x, flags, out, scratch, n, s);
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

// -------------------------------------------------------- segment_minmax --
//
// For each segment s and each of np <= 8 int32 payloads k: max[k][s] and
// min[k][s] over the ACTIVE positions q of [off[s], off[s+1]) (active[q] !=
// 0), with INT_MIN / INT_MAX where the segment is empty or has no active
// position. Replaces the JAX package's scan_kernels.segmented_minmax_1d
// (:224), two inclusive segmented scans (MAX, MIN) over active elements
// with a carry across its sequential grid, whose caller
// segment.combine_minmax_multi (:351) then routes each segment's last value
// back to the vertex axis.
//
// Balanced by slots, not by segments: the merged sequence of the segment
// ends and the slots [off[0], off[S]) (segment s's end at place off[s+1] -
// off[0] + s, after its slots) is cut into tiles of kMmTile places, one
// block each. A hub of 64K slots spans 32 tiles, and a run of empty
// segments costs what as many slots cost. The merge-path split of every
// tile boundary (etpu::warp_lower_bound_by, as in spmv_rows: five
// dependent loads at a million segments) is found first, by
// segment_split_kernel, a warp per boundary, all at once: in the
// tile's own block it would be the longest wait of the tile. Block ids come
// from an atomic ticket. What limits the tiles is the chain of waits each
// runs through (ticket, splits, flags, payloads, publish, look-back), so
// the design keeps many tiles per SM: a block stages the active bytes by
// 16-byte words, then the payloads by 16-byte asynchronous copies
// (cp.async: all in flight together, no registers), up to 4 payloads at
// once (two passes at 8, so that four blocks fit an SM's shared memory),
// skipping a vector whose 4 slots are all inactive; no load waits on a
// flag. A pointer at any 4-byte offset is taken: each payload keeps its
// own 16-byte grid in shared memory, and a vector that would leave the
// array is read element by element. Each thread walks kMmItems places in
// order, folding a slot into 2 np running values and writing each segment
// that lies wholly inside its places. A segment that crosses threads is
// completed in shared memory, by int atomicMax / atomicMin into the words
// of the thread that holds its end (the next thread with an end, from a
// ballot per warp). A segment that leaves the tile is completed by the
// tile that holds its end, from the partials the tiles before it publish
// (a look-back, as in spmv_rows): every tile publishes, before it waits,
// the partial of the segment that leaves it, each value in a 64-bit word
// that is its own flag, so that no fence waits on the tile's stores.
// Max and min are exact and independent of order, so the result repeats
// bit for bit.
// What bounds it: bytes; the active flags (one byte a slot), the payloads
// (4 np bytes a slot, where its vector holds an active slot), the offsets,
// and 8 np bytes written per segment.

constexpr int kMmItems = 8;                         // merge places a thread
constexpr int kMmTile = kBlock * kMmItems;          // merge places a block
constexpr int kMmVectors = kMmTile / 4 + 2;         // a payload's vectors, most
constexpr int kMmStride =                           // a payload's staged words
    4 * (kMmVectors + (kMmVectors + 7) / 8);
constexpr int kMmVals = 16;                         // words of a partial
static_assert(kMmTile / 16 + 2 <= kBlock, "one active word a thread");
// the payloads staged at once: all of them up to 4, else half
template <int NP> constexpr int kMmPasses = NP > 4 ? 2 : 1;
template <int NP>
constexpr int kMmPer = (NP + kMmPasses<NP> - 1) / kMmPasses<NP>;

// A tile's partial words: each of the 2 np values of the partial it
// publishes in bits 0-31 of a 64-bit word, and in bits 32-33 what the tile
// is: not yet published; no segment leaves it; it lies inside the segment
// that leaves it; that segment starts in it. A word is its own flag, so
// publishing needs no fence.
enum MmKind : unsigned { kMmUnset = 0, kMmNoTail = 1, kMmInside = 2,
                         kMmStarts = 3 };

// The staged word of a payload's element x of its tile's 16-byte grid (x =
// its shift + the tile slot): a 16-byte pad after every 8 vectors, so that
// the threads' slots, about 8 apart, fall in different banks.
__device__ __forceinline__ int mm_word(int x) { return x + ((x >> 5) << 2); }

template <int NP>
constexpr int minmax_shared_bytes() {
  return static_cast<int>(sizeof(int)) *
             (kMmPer<NP> * kMmStride + kMmTile + 1) +
         kMmTile;
}

struct Payloads {
  const int* p[8];
};

// The look-back of the merge-path tiles (segment_minmax, segment_reduce):
// warp 0 of tile b folds the partials that the tiles before it published
// for the segment that enters it, back to the tile where that segment
// starts. Tile k published NV values in the 64-bit words at words + k *
// kStride, each with the tile's kind (MmKind) in its high half. Lane l reads
// tile k - l, 32 tiles a step; fold(v, bits, take, newest) folds value v of
// the lanes that take part into the caller's running value (newest: the step
// of the 32 tiles just before b), every lane alike, by a fixed tree where
// the order matters.
template <int NV, int kStride, typename Fold>
__device__ __forceinline__ void tile_look_back(const unsigned long long* words,
                                               int b, Fold fold) {
  const int lane = threadIdx.x & 31;
  for (int k = b - 1; k >= 0; k -= 32) {
    const int p = k - lane;                 // lane l reads tile k - l
    const unsigned long long* const w =
        words + static_cast<long long>(max(p, 0)) * kStride;
    unsigned long long st = 0;
    if (p >= 0) {
      while (((st = load_status(w)) >> 32) == kMmUnset) __nanosleep(32);
    }
    const unsigned starts = __ballot_sync(kFullMask, (st >> 32) == kMmStarts);
    const int last = starts ? __ffs(starts) - 1 : 31;
    const bool take = lane <= last && p >= 0;
    unsigned long long x[NV] = {};          // all in flight at once
    bool ready = !take;
    while (!ready) {
#pragma unroll
      for (int v = 0; v < NV; ++v) x[v] = load_status(w + v);
      ready = true;
#pragma unroll
      for (int v = 0; v < NV; ++v) ready &= (x[v] >> 32) != kMmUnset;
      if (!ready) __nanosleep(32);
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      fold(v, static_cast<unsigned>(x[v]), take, k == b - 1);
    }
    if (starts) break;
  }
}

// splits[b] = (the segment ends before place b * kTile, the first slot of
// the segment after them), for b in [0, tiles]; a warp per boundary. The
// first launch of segment_minmax and of segment_reduce.
template <int kTile>
__global__ void __launch_bounds__(kBlock)
segment_split_kernel(const int* __restrict__ off, int nseg, int tiles,
                     int2* __restrict__ splits) {
  const long long b = global_warp();
  if (b > tiles) return;                    // warp-uniform
  const int base = off[0];
  const int d = static_cast<int>(min(b * kTile, 1LL * INT_MAX));
  const int r = etpu::warp_lower_bound_by(
      [off, base](int x) { return off[x + 1] - base + x; }, nseg, d);
  if ((threadIdx.x & 31) == 0) splits[b] = make_int2(r, off[r]);
}

template <int NP>
__global__ void __launch_bounds__(kBlock)
segment_minmax_kernel(Payloads in, const unsigned char* __restrict__ active,
                      long long n, const int* __restrict__ off, int nseg,
                      const int2* __restrict__ splits,
                      int* __restrict__ mx, int* __restrict__ mn,
                      unsigned long long* words, unsigned* ticket) {
  static_assert(2 * NP * kBlock <= kMmPer<NP> * kMmStride,
                "the threads' sums fit the staged payloads");
  // a pass's payloads [kMmPer][kMmStride] (then the threads' sums [kBlock]
  // [2 NP]), the tile's segment ends as tile slots and a sentinel, the
  // active bytes
  extern __shared__ int4 s_mem[];
  int* const s_pay = reinterpret_cast<int*>(s_mem);
  int* const s_end = s_pay + kMmPer<NP> * kMmStride;
  unsigned char* const s_act =
      reinterpret_cast<unsigned char*>(s_end + kMmTile + 1);
  __shared__ int s_out[2 * NP];             // the partial leaving the tile
  __shared__ unsigned s_ball[kWarpsPerBlock];
  __shared__ int s_b, s_base, s_total, s_r0, s_r1, s_off0, s_head;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  if (tid == 0) {
    const int b = static_cast<int>(atomicAdd(ticket, 1u));
    const int2 first = splits[b];
    s_b = b;
    s_r0 = first.x;
    s_off0 = first.y;
    s_r1 = splits[b + 1].x;
    s_base = off[0];
    s_total = nseg + (off[nseg] - off[0]);
  }
  __syncthreads();
  const int b = s_b;
  const int base = s_base;
  const int d0 = b * kMmTile;
  if (d0 >= s_total) return;                // past the last place: no tile
                                            // waits for a later one
  const int d1 = min(d0 + kMmTile, s_total);
  const int r0 = s_r0;
  const int nr = s_r1 - r0;                 // segment ends in the tile
  const int ne = d1 - s_r1 - (d0 - r0);     // its slots: [eb, eb + ne)
  const int eb = base + d0 - r0;

  // 1. the ends and the active bytes, then the payloads' active vectors
  for (int i = tid; i < nr; i += kBlock) s_end[i] = off[r0 + 1 + i] - eb;
  if (tid == 0) s_end[nr] = INT_MAX;        // no end past the tile's
  {
    const uintptr_t lo = reinterpret_cast<uintptr_t>(active);
    const uintptr_t hi = lo + static_cast<uintptr_t>(n);
    const uintptr_t a0 = lo + static_cast<uintptr_t>(eb);
    const int words =
        ne > 0 ? static_cast<int>(((a0 + ne - 1) >> 4) - (a0 >> 4)) + 1 : 0;
    if (tid < words) {
      const uintptr_t w = (a0 & ~uintptr_t{15}) + 16 * uintptr_t(tid);
      unsigned v[4] = {0u, 0u, 0u, 0u};
      if (w >= lo && w + 16 <= hi) {
        const uint4 t = __ldcs(reinterpret_cast<const uint4*>(w));
        v[0] = t.x;
        v[1] = t.y;
        v[2] = t.z;
        v[3] = t.w;
      } else {                              // the array's ragged ends
        for (int u = 0; u < 16; ++u) {
          if (w + u >= lo && w + u < hi) {
            v[u >> 2] |= static_cast<unsigned>(
                             *reinterpret_cast<const unsigned char*>(w + u))
                         << (8 * (u & 3));
          }
        }
      }
      const long long l0 =
          static_cast<long long>(w) - static_cast<long long>(a0);
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const long long l = l0 + u;
        if (l >= 0 && l < ne) {
          s_act[l] = static_cast<unsigned char>(v[u >> 2] >> (8 * (u & 3)));
        }
      }
    }
  }
  __syncthreads();
  // 2. the thread's kMmItems places, found by a search of the staged ends:
  //    the first i whose end lies at or past the thread's diagonal
  const int places = nr + ne;
  const int diag = min(tid * kMmItems, places);
  int lo = max(0, diag - ne);
  int hi = min(diag, nr);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_end[mid] + mid < diag) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int cnt = min(kMmItems, places - diag);
  int run_hi[NP], run_lo[NP], head_hi[NP], head_lo[NP];
  int first = -1;                           // the thread's first end, from r0

  // 3. the payloads in passes of kMmPer (shared memory for kMmPer of them
  //    lets twice the blocks run at 8 payloads): stage the pass's vectors
  //    that hold an active slot, then walk the thread's places, folding a
  //    slot into 2 kMmPer running values and writing each segment that
  //    lies wholly inside the places
#pragma unroll
  for (int pass = 0; pass < kMmPasses<NP>; ++pass) {
    constexpr int kPer = kMmPer<NP>;
    int shift[kPer];                        // the tile's first slot in its
    if (pass > 0) __syncthreads();          // payload's 16-byte grid
#pragma unroll
    for (int kk = 0; kk < kPer; ++kk) {
      const int k = pass * kPer + kk;
      if (k >= NP) break;
      const uintptr_t lo_a = reinterpret_cast<uintptr_t>(in.p[k]);
      const uintptr_t hi_a = lo_a + 4 * static_cast<uintptr_t>(n);
      const uintptr_t a0 = lo_a + 4 * static_cast<uintptr_t>(eb);
      const uintptr_t q0 = a0 & ~uintptr_t{15};
      shift[kk] = static_cast<int>(a0 - q0) >> 2;
      const int vectors = ne > 0 ? (shift[kk] + ne + 3) >> 2 : 0;
      int* const s = s_pay + kk * kMmStride;
      for (int c = tid; c < vectors; c += kBlock) {
        const int l0 = 4 * c - shift[kk];   // the vector's first tile slot
        bool take = false;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int l = l0 + u;
          take = take || (l >= 0 && l < ne && s_act[l] != 0);
        }
        if (!take) continue;
        const uintptr_t w = q0 + 16 * uintptr_t(c);
        int* const dst = s + mm_word(4 * c);
        if (w >= lo_a && w + 16 <= hi_a) {
          __pipeline_memcpy_async(dst, reinterpret_cast<const int*>(w), 16);
        } else {                            // the array's ragged ends
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const uintptr_t x = w + 4 * u;
            if (x >= lo_a && x < hi_a) {
              dst[u] = *reinterpret_cast<const int*>(x);
            }
          }
        }
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kPer; ++kk) {
      const int k = pass * kPer + kk;
      if (k >= NP) break;
      run_hi[k] = head_hi[k] = INT_MIN;
      run_lo[k] = head_lo[k] = INT_MAX;
    }
    int i = lo;                             // ends taken
    int j = diag - lo;                      // slots taken
    bool seen = false;                      // an end taken in this pass
#pragma unroll
    for (int q = 0; q < kMmItems; ++q) {
      if (q < cnt) {
        if (s_end[i] <= j) {                // segment r0 + i ends here
          if (!seen) {
            seen = true;
            first = i;
#pragma unroll
            for (int kk = 0; kk < kPer; ++kk) {
              const int k = pass * kPer + kk;
              if (k < NP) {
                head_hi[k] = run_hi[k];
                head_lo[k] = run_lo[k];
              }
            }
          } else {                          // wholly inside the thread
            const long long sg = r0 + i;
#pragma unroll
            for (int kk = 0; kk < kPer; ++kk) {
              const int k = pass * kPer + kk;
              if (k < NP) {
                mx[k * static_cast<long long>(nseg) + sg] = run_hi[k];
                mn[k * static_cast<long long>(nseg) + sg] = run_lo[k];
              }
            }
          }
#pragma unroll
          for (int kk = 0; kk < kPer; ++kk) {
            const int k = pass * kPer + kk;
            if (k < NP) {
              run_hi[k] = INT_MIN;
              run_lo[k] = INT_MAX;
            }
          }
          ++i;
        } else {
          if (s_act[j] != 0) {
#pragma unroll
            for (int kk = 0; kk < kPer; ++kk) {
              const int k = pass * kPer + kk;
              if (k < NP) {
                const int x = s_pay[kk * kMmStride + mm_word(shift[kk] + j)];
                run_hi[k] = max(run_hi[k], x);
                run_lo[k] = min(run_lo[k], x);
              }
            }
          }
          ++j;
        }
      }
    }
  }

  // 4. the segments across threads: each thread's first segment gets its
  //    head part in the thread's words, and every thread folds its trailing
  //    part into the next thread that holds an end, or into the partial
  //    leaving the tile
  const unsigned ball = __ballot_sync(kFullMask, first >= 0);
  if (lane == 0) s_ball[wid] = ball;
  if (first == 0) s_head = tid;
  if (tid < 2 * NP) s_out[tid] = tid < NP ? INT_MIN : INT_MAX;
  __syncthreads();                          // the payloads are read
  int* const acc = s_pay;                   // [kBlock][2 NP]
  if (first >= 0) {
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      acc[tid * 2 * NP + k] = head_hi[k];
      acc[tid * 2 * NP + NP + k] = head_lo[k];
    }
  }
  __syncthreads();
  {
    const unsigned later =
        lane == 31 ? 0u : s_ball[wid] & (kFullMask << (lane + 1));
    int nxt = later ? (wid << 5) + __ffs(later) - 1 : -1;
    for (int w = wid + 1; nxt < 0 && w < kWarpsPerBlock; ++w) {
      if (s_ball[w]) nxt = (w << 5) + __ffs(s_ball[w]) - 1;
    }
    int* const dst = nxt >= 0 ? acc + nxt * 2 * NP : s_out;
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      if (run_hi[k] != INT_MIN) atomicMax(dst + k, run_hi[k]);
      if (run_lo[k] != INT_MAX) atomicMin(dst + NP + k, run_lo[k]);
    }
  }
  __syncthreads();
  const bool has_head = eb > s_off0;        // segment r0 began before the tile
  if (first >= 0 && !(first == 0 && has_head)) {
    const long long s = r0 + first;
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      mx[k * static_cast<long long>(nseg) + s] = acc[tid * 2 * NP + k];
      mn[k * static_cast<long long>(nseg) + s] = acc[tid * 2 * NP + NP + k];
    }
  }

  // 5. publish the partial of the segment that leaves the tile, then
  //    complete the segment that entered it
  if (wid == 0) {
    const int r1 = r0 + nr;
    const int start = nr > 0 ? s_end[nr - 1] + eb : s_off0;   // off[r1]
    const unsigned kind = r1 < nseg && eb + ne > start
                              ? (start >= eb ? kMmStarts : kMmInside)
                              : kMmNoTail;
    if (lane < 2 * NP) {
      publish_status(words + static_cast<long long>(b) * kMmVals + lane,
                     kind, static_cast<unsigned>(s_out[lane]));
    }
  }
  if (wid == 0 && has_head && nr > 0) {
    int pre[2 * NP];
#pragma unroll
    for (int v = 0; v < 2 * NP; ++v) pre[v] = v < NP ? INT_MIN : INT_MAX;
    tile_look_back<2 * NP, kMmVals>(
        words, b, [&](int v, unsigned bits, bool take, bool) {
          const int val = static_cast<int>(bits);
          if (v < NP) {
            pre[v] = max(pre[v],
                         __reduce_max_sync(kFullMask, take ? val : INT_MIN));
          } else {
            pre[v] = min(pre[v],
                         __reduce_min_sync(kFullMask, take ? val : INT_MAX));
          }
        });
    if (lane == 0) {
      const int* const h = acc + s_head * 2 * NP;
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        mx[k * static_cast<long long>(nseg) + r0] = max(pre[k], h[k]);
        mn[k * static_cast<long long>(nseg) + r0] = min(pre[NP + k], h[NP + k]);
      }
    }
  }
}

int minmax_tiles(int nseg, long long n) {
  return static_cast<int>((nseg + n + kMmTile - 1) / kMmTile);
}

// scratch: [tiles][kMmVals] 64-bit partial words, the 32-bit ticket (in a
// 64-bit word), then [tiles + 1] int2 splits; the words and the ticket are
// zeroed here on the stream, then the splits are found, then the tiles
// run.
template <int NP>
cudaError_t segment_minmax_launch(const Payloads& in,
                                  const unsigned char* active, long long n,
                                  const int* off, int nseg, int* mx, int* mn,
                                  void* scratch, cudaStream_t s) {
  const int tiles = minmax_tiles(nseg, n);
  auto* words = static_cast<unsigned long long*>(scratch);
  auto* ticket = reinterpret_cast<unsigned*>(words + tiles * kMmVals);
  auto* splits = reinterpret_cast<int2*>(words + tiles * kMmVals + 1);
  constexpr int bytes = minmax_shared_bytes<NP>();
  cudaError_t err = cudaFuncSetAttribute(
      segment_minmax_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(segment_minmax_kernel<NP>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess) {
    err = cudaMemsetAsync(
        scratch, 0, sizeof(unsigned long long) * (tiles * kMmVals + 1), s);
  }
  if (err != cudaSuccess) return err;
  segment_split_kernel<kMmTile><<<(tiles + kWarpsPerBlock) / kWarpsPerBlock,
                                  kBlock, 0, s>>>(off, nseg, tiles, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  segment_minmax_kernel<NP><<<tiles, kBlock, bytes, s>>>(
      in, active, n, off, nseg, splits, mx, mn, words, ticket);
  return cudaGetLastError();
}

// -------------------------------------------------------- segment_reduce --
//
// out[s] = the reduction of vals[off[s] .. off[s+1]) under SUM, MIN or MAX
// on int32 (the sum wraps around) or float32, with the identity at an empty
// segment; OR and AND read each value as a truth value (nonzero) and write
// 0 or 1 bytes: they are MAX and MIN over the truth values. Replaces
// segment.combine_by_offsets (:97) and combine_by_offsets_routed (:287),
// whose TPU kernels are segmented_scan_1d (:296) and the routed
// end-of-segment pick (the cube route of the prefix back through the
// offsets). Here the segment is reduced where it lies.
//
// Balanced by slots, not by segments, as segment_minmax is: the merged
// sequence of the segment ends and the slots [off[0], off[S]) is cut into
// tiles of kRdTile places, one block each, whose splits
// segment_split_kernel finds first. A hub of 64K slots spans 16 tiles, and
// a run of empty segments costs what as many places cost. The tiles hold
// 4,096 places (16 a thread), twice segment_minmax's: each tile is a
// latency-bound chain (ticket, splits, loads, look-back), and fewer tiles
// make fewer chains (PERF.md, section 6). A block stages
// its slots of vals by 16-byte evict-first loads (any 4-byte offset: the
// tile keeps vals' own 16-byte grid in shared memory, and a vector that
// would leave the array is read element by element), then each thread
// walks its kRdItems places in order, folding a slot into its running
// value and writing each segment that lies wholly inside its places. A
// segment that crosses threads is completed by a segmented scan of the
// threads' (trailing value, saw an end) pairs, a shuffle scan in each warp
// and the warps in order; a segment that leaves the tile by the tile that
// holds its end, from the partials the tiles before it publish
// (tile_look_back, one self-flagged word a tile). Every fold follows the
// places and fixed trees, and the only atomics are the ticket and the
// status words, so a float sum (__fadd_rn) repeats bit for bit; its order
// differs from the JAX package's scan, so float sums agree with it to a
// tolerance. The other reductions are exact in any order.
//
// What bounds it: bytes, vals and the offsets read once (4 bytes a slot and
// a segment) and out written once; nothing is gathered.

constexpr int kRdItems = 16;                        // merge places a thread
constexpr int kRdTile = kBlock * kRdItems;          // merge places a block
constexpr int kRdVec = kRdTile / 4 + 2;             // vals' vectors, most
constexpr int kRdStride = 4 * (kRdVec + (kRdVec + 7) / 8);   // staged words
constexpr int kRdVectors = (kRdVec + kBlock - 1) / kBlock;   // a thread's

template <typename T, int OP, bool kTruth>
__global__ void __launch_bounds__(kBlock)
segment_reduce_kernel(const T* __restrict__ vals, long long n,
                      const int* __restrict__ off, int nseg,
                      const int2* __restrict__ splits, T ident,
                      void* __restrict__ out_, unsigned long long* words,
                      unsigned* ticket) {
  // OR and AND fold int truth values (0 or 1) by MAX and MIN
  using U = std::conditional_t<kTruth, int, T>;
  using Out = std::conditional_t<kTruth, unsigned char, T>;
  Out* const out = static_cast<Out*>(out_);
  __shared__ int s_val[kRdStride];          // the tile's slots, staged
  __shared__ int s_end[kRdTile + 1];        // its segment ends, tile slots
  __shared__ U s_warp_v[kWarpsPerBlock];
  __shared__ int s_warp_f[kWarpsPerBlock];
  __shared__ U s_head;
  __shared__ int s_b, s_base, s_total, s_r0, s_r1, s_off0;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const U id = kTruth ? static_cast<U>(ident != T(0)) : static_cast<U>(ident);
  if (tid == 0) {
    const int b = static_cast<int>(atomicAdd(ticket, 1u));
    const int2 first = splits[b];
    s_b = b;
    s_r0 = first.x;
    s_off0 = first.y;
    s_r1 = splits[b + 1].x;
    s_base = off[0];
    s_total = nseg + (off[nseg] - off[0]);
  }
  __syncthreads();
  const int b = s_b;
  const int d0 = b * kRdTile;
  if (d0 >= s_total) return;                // past the last place: no tile
                                            // waits for a later one
  const int d1 = min(d0 + kRdTile, s_total);
  const int r0 = s_r0;
  const int nr = s_r1 - r0;                 // segment ends in the tile
  const int ne = d1 - s_r1 - (d0 - r0);     // its slots: [eb, eb + ne)
  const int eb = s_base + d0 - r0;

  // 1. the slots' vectors (all loads in flight before any store), then the
  //    segment ends
  const uintptr_t lo_a = reinterpret_cast<uintptr_t>(vals);
  const uintptr_t hi_a = lo_a + 4 * static_cast<uintptr_t>(n);
  const uintptr_t a0 = lo_a + 4 * static_cast<uintptr_t>(eb);
  const uintptr_t q0 = a0 & ~uintptr_t{15};
  const int shift = static_cast<int>(a0 - q0) >> 2;
  const int vectors = ne > 0 ? (shift + ne + 3) >> 2 : 0;
  {
    int4 x[kRdVectors];
#pragma unroll
    for (int k = 0; k < kRdVectors; ++k) {
      const int c = tid + k * kBlock;
      const uintptr_t w = q0 + 16 * uintptr_t(c);
      x[k] = make_int4(0, 0, 0, 0);
      if (c < vectors) {
        if (w >= lo_a && w + 16 <= hi_a) {
          x[k] = __ldcs(reinterpret_cast<const int4*>(w));
        } else {                            // the array's ragged ends
          int* const e = reinterpret_cast<int*>(&x[k]);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const uintptr_t a = w + 4 * u;
            if (a >= lo_a && a < hi_a) {
              e[u] = *reinterpret_cast<const int*>(a);
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kRdVectors; ++k) {
      const int c = tid + k * kBlock;
      if (c < vectors) {
        int* const dst = s_val + mm_word(4 * c);
        dst[0] = x[k].x;
        dst[1] = x[k].y;
        dst[2] = x[k].z;
        dst[3] = x[k].w;
      }
    }
  }
  for (int i = tid; i < nr; i += kBlock) s_end[i] = off[r0 + 1 + i] - eb;
  if (tid == 0) s_end[nr] = INT_MAX;        // no end past the tile's
  __syncthreads();

  // 2. the thread's kRdItems places, found by a search of the staged ends:
  //    the first i whose end lies at or past the thread's diagonal
  const int places = nr + ne;
  const int diag = min(tid * kRdItems, places);
  int lo = max(0, diag - ne);
  int hi = min(diag, nr);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_end[mid] + mid < diag) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int i = lo;                               // ends taken
  int j = diag - lo;                        // slots taken
  const int cnt = min(kRdItems, places - diag);
  U acc = id;                               // the running segment's value
  U head = id;                              // the thread's first segment's
  int first = -1;                           // that segment, from r0
#pragma unroll
  for (int q = 0; q < kRdItems; ++q) {
    if (q < cnt) {
      if (s_end[i] <= j) {                  // segment r0 + i ends here
        if (first < 0) {
          first = i;
          head = acc;
        } else {                            // wholly inside the thread
          out[r0 + i] = static_cast<Out>(acc);
        }
        acc = id;
        ++i;
      } else {
        const T x = from_bits<T>(static_cast<unsigned>(
            s_val[mm_word(shift + j)]));
        acc = Op<OP>::apply(acc, kTruth ? static_cast<U>(x != T(0))
                                        : static_cast<U>(x));
        ++j;
      }
    }
  }

  // 3. the segmented scan of the threads' (trailing value, saw an end)
  //    pairs, under (a,fa).(b,fb) = (fb ? b : a op b, fa | fb): a shuffle
  //    scan in each warp, then the warps in order
  U v = acc;
  int f = first >= 0;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const U pv = __shfl_up_sync(kFullMask, v, d);
    const int pf = __shfl_up_sync(kFullMask, f, d);
    if (lane >= d) {
      if (!f) v = Op<OP>::apply(pv, v);
      f |= pf;
    }
  }
  if (lane == 31) {
    s_warp_v[wid] = v;
    s_warp_f[wid] = f;
  }
  const U ev = __shfl_up_sync(kFullMask, v, 1);
  const int ef = __shfl_up_sync(kFullMask, f, 1);
  __syncthreads();
  U run = id;                               // the running segment before
  for (int k = 0; k < wid; ++k) {           // the thread
    run = s_warp_f[k] ? s_warp_v[k] : Op<OP>::apply(run, s_warp_v[k]);
  }
  if (lane > 0) run = ef ? ev : Op<OP>::apply(run, ev);
  const bool has_head = eb > s_off0;        // segment r0 began before the tile
  if (first >= 0) {
    const U val = Op<OP>::apply(run, head);
    if (first == 0 && has_head) {
      s_head = val;                         // completed after the look-back
    } else {
      out[r0 + first] = static_cast<Out>(val);
    }
  }

  // 4. publish the partial of the segment that leaves the tile, then
  //    complete the segment that entered it
  if (tid == 0) {
    U tail = id;
    for (int k = 0; k < kWarpsPerBlock; ++k) {
      tail = s_warp_f[k] ? s_warp_v[k] : Op<OP>::apply(tail, s_warp_v[k]);
    }
    const int r1 = r0 + nr;
    const int start = nr > 0 ? s_end[nr - 1] + eb : s_off0;   // off[r1]
    const unsigned kind = r1 < nseg && eb + ne > start
                              ? (start >= eb ? kMmStarts : kMmInside)
                              : kMmNoTail;
    publish_status(words + b, kind, bits_of(tail));
  }
  __syncthreads();
  if (wid == 0 && has_head && nr > 0) {
    U prefix = id;
    tile_look_back<1, 1>(words, b, [&](int, unsigned x, bool take,
                                       bool newest) {
      U part = take ? from_bits<U>(x) : id;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {    // every lane: the same bits
        part = Op<OP>::apply(part, __shfl_xor_sync(kFullMask, part, d));
      }
      prefix = newest ? part : Op<OP>::apply(part, prefix);
    });
    if (lane == 0) out[r0] = static_cast<Out>(Op<OP>::apply(prefix, s_head));
  }
}

// scratch: [tiles] 64-bit status words, the 32-bit ticket (in a 64-bit
// word), then [tiles + 1] int2 splits; the words and the ticket are zeroed
// here on the stream, then the splits are found, then the tiles run.
template <typename T, int OP, bool kTruth>
cudaError_t reduce_tiles(const T* vals, long long n, const int* off,
                         int nseg, T ident, void* out, void* scratch,
                         cudaStream_t s) {
  const int tiles = static_cast<int>((nseg + n + kRdTile - 1) / kRdTile);
  auto* words = static_cast<unsigned long long*>(scratch);
  auto* ticket = reinterpret_cast<unsigned*>(words + tiles);
  auto* splits = reinterpret_cast<int2*>(words + tiles + 1);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, sizeof(unsigned long long) * (tiles + 1), s);
  if (err != cudaSuccess) return err;
  segment_split_kernel<kRdTile><<<(tiles + kWarpsPerBlock) / kWarpsPerBlock,
                                  kBlock, 0, s>>>(off, nseg, tiles, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  segment_reduce_kernel<T, OP, kTruth><<<tiles, kBlock, 0, s>>>(
      vals, n, off, nseg, splits, ident, out, words, ticket);
  return cudaGetLastError();
}

template <typename T>
int segment_reduce_launch(const void* vals, long long n, const void* off,
                          int nseg, int op, T ident, void* out, void* scratch,
                          cudaStream_t s) {
  if (nseg <= 0) return static_cast<int>(cudaGetLastError());
  const T* v = static_cast<const T*>(vals);
  const int* o = static_cast<const int*>(off);
  cudaError_t err;
  switch (op) {
    case kAdd:
      err = reduce_tiles<T, kAdd, false>(v, n, o, nseg, ident, out, scratch,
                                         s);
      break;
    case kMin:
      err = reduce_tiles<T, kMin, false>(v, n, o, nseg, ident, out, scratch,
                                         s);
      break;
    case kMax:
      err = reduce_tiles<T, kMax, false>(v, n, o, nseg, ident, out, scratch,
                                         s);
      break;
    case kOr:
      err = reduce_tiles<T, kMax, true>(v, n, o, nseg, ident, out, scratch,
                                        s);
      break;
    case kAnd:
      err = reduce_tiles<T, kMin, true>(v, n, o, nseg, ident, out, scratch,
                                        s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
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

// scratch: 8 * (g + ceil(g / etpu_scan_group())) + 4 bytes, 8-byte aligned,
// g = ceil(n / etpu_scan_tile()) (the tiles' status words, the groups',
// then the ticket), zeroed here on the stream before the launch. `flags`
// may be null.
int etpu_scan_i32(const void* x, const void* flags, void* out, void* scratch,
                  long long n, int op, void* stream) {
  return scan_dispatch<int>(x, flags, out, scratch, n, op,
                            static_cast<cudaStream_t>(stream));
}

int etpu_scan_f32(const void* x, const void* flags, void* out, void* scratch,
                  long long n, int op, void* stream) {
  return scan_dispatch<float>(x, flags, out, scratch, n, op,
                              static_cast<cudaStream_t>(stream));
}

int etpu_scan_tile() { return kScanTile; }

// fused_route_or: lev [>= max id + 1] and eid, out [n] int32, flags [n]
// uint8 (flags[0] is not read); scratch as scan's over n elements, zeroed
// here on the stream before the one launch.
int etpu_route_or(const void* lev, const void* eid, const void* flags, int n,
                  int it, void* out, void* scratch, void* stream) {
  return route_or_launch(
      static_cast<const int*>(lev), static_cast<const int*>(eid),
      static_cast<const unsigned char*>(flags), n, it, static_cast<int*>(out),
      scratch, static_cast<cudaStream_t>(stream));
}

int etpu_scan_group() { return kScanGroup; }

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

// op: 0 sum, 1 min, 2 max (out of the value type), 3 or, 4 and (uint8 out;
// ident 0 or 1). vals [n] at any 4-byte offset; off [nseg+1], sorted, within
// [0, n], nseg + n below 2^31; scratch: 16 * (ceil((nseg + n) /
// etpu_reduce_tile()) + 1) bytes, 8-byte aligned. Two launches: the tiles'
// splits, then the tiles.
int etpu_segment_reduce_i32(const void* vals, long long n, const void* off,
                            int nseg, int op, int ident, void* out,
                            void* scratch, void* stream) {
  return segment_reduce_launch<int>(vals, n, off, nseg, op, ident, out,
                                    scratch,
                                    static_cast<cudaStream_t>(stream));
}

int etpu_segment_reduce_f32(const void* vals, long long n, const void* off,
                            int nseg, int op, float ident, void* out,
                            void* scratch, void* stream) {
  return segment_reduce_launch<float>(vals, n, off, nseg, op, ident, out,
                                      scratch,
                                      static_cast<cudaStream_t>(stream));
}

// p0..p7: the np payloads, [n] int32 each at any 4-byte offset (those
// beyond the np-th may be null); active [n] uint8 at any offset; off
// [nseg+1], sorted, within [0, n], nseg + n below 2^31; mx, mn [np, nseg]
// int32; scratch: 136 * ceil((nseg + n) / etpu_minmax_tile()) + 16 bytes,
// 8-byte aligned. Two launches: the tiles' splits, then the tiles.
int etpu_segment_minmax(const void* p0, const void* p1, const void* p2,
                        const void* p3, const void* p4, const void* p5,
                        const void* p6, const void* p7, int np,
                        const void* active, long long n, const void* off,
                        int nseg, void* mx, void* mn, void* scratch,
                        void* stream) {
  if (np < 1 || np > 8) return static_cast<int>(cudaErrorInvalidValue);
  if (nseg <= 0) return static_cast<int>(cudaGetLastError());
  const Payloads in = {{static_cast<const int*>(p0),
                        static_cast<const int*>(p1),
                        static_cast<const int*>(p2),
                        static_cast<const int*>(p3),
                        static_cast<const int*>(p4),
                        static_cast<const int*>(p5),
                        static_cast<const int*>(p6),
                        static_cast<const int*>(p7)}};
  const auto* a = static_cast<const unsigned char*>(active);
  const int* o = static_cast<const int*>(off);
  int* hi = static_cast<int*>(mx);
  int* lo = static_cast<int*>(mn);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (np) {
    case 1: err = segment_minmax_launch<1>(in, a, n, o, nseg, hi, lo,
                                           scratch, s); break;
    case 2: err = segment_minmax_launch<2>(in, a, n, o, nseg, hi, lo,
                                           scratch, s); break;
    case 3: err = segment_minmax_launch<3>(in, a, n, o, nseg, hi, lo,
                                           scratch, s); break;
    case 4: err = segment_minmax_launch<4>(in, a, n, o, nseg, hi, lo,
                                           scratch, s); break;
    case 5: err = segment_minmax_launch<5>(in, a, n, o, nseg, hi, lo,
                                           scratch, s); break;
    case 6: err = segment_minmax_launch<6>(in, a, n, o, nseg, hi, lo,
                                           scratch, s); break;
    case 7: err = segment_minmax_launch<7>(in, a, n, o, nseg, hi, lo,
                                           scratch, s); break;
    default: err = segment_minmax_launch<8>(in, a, n, o, nseg, hi, lo,
                                            scratch, s); break;
  }
  return static_cast<int>(err);
}

// Merge places per segment_minmax tile; the Python wrapper sizes the
// scratch with it and checks it against its own constant.
int etpu_minmax_tile() { return kMmTile; }

// Merge places per segment_reduce tile (REDUCE_TILE in kernels.py).
int etpu_reduce_tile() { return kRdTile; }

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
