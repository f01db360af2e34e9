// Hand-written CUDA kernel of triangle counting and the intersection
// operator, for Hopper (sm_90a).
//
// Built by essentials_tpu_torch/kernels.py with nvcc into the shared library
// of every csrc/*.cu, with a plain C interface, loaded with ctypes. The entry
// point launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError() so that a refused launch reaches the Python wrapper.
//
// Layout contract (essentials_tpu_torch/ops/bitmap_intersect.py): `bitmap`
// is [rows, words] 32-bit words, bit c & 31 of word c >> 5 of row u set iff
// c is in u's set; `words` is a multiple of 4 and the rows are 16-byte
// aligned. The last row is all zero, so a pad pair that points at it counts 0.

#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kBlock = 256;                 // threads per block
constexpr int kWarpsPerBlock = kBlock / 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kListWords = 256;             // B[u] words a warp lists at once
constexpr int kScanLoads = 4;               // 16-byte loads a lane has in
                                            // flight while it scans B[u]
constexpr int kStepWords = 32 * 4;          // words one load of a warp lists
constexpr int kGatherItems = 4;             // B[v] words a lane has in flight

// What one warp keeps in shared memory: the listed non-zero words of B[u]
// (index and value), the pairs of the group that shares u (row v and the
// lane that holds the pair), and each lane's pair count; with the witness
// also a count per listed word of its lowest bit's witnesses. Shared memory
// is kept small: what it leaves of the SM's 256 KB is L1, which catches
// repeated sectors of hub rows B[v].
struct WarpList {
  int idx[kListWords];
  unsigned val[kListWords];
  int v[32];
  int lane[32];
  int cnt[32];
};

struct WarpListWitness : WarpList {
  int low[kListWords];
};

template <bool kWitness>
using List = std::conditional_t<kWitness, WarpListWitness, WarpList>;

// The group's pairs against the listed words: item t = j * n + k is pair j
// and listed word k (neighbouring lanes read neighbouring words of one row
// B[v_j], which share sectors where B[u]'s words are close), cnt +=
// popcount(B[v_j][idx_k] & val_k). With a witness array, the lowest bit of
// val_k is counted in shared memory over the group's pairs and added to
// the witness once per listed word; other bits (a word of B[u] with
// several) take one atomicAdd each. Every lane calls it with the same n
// and np.
template <bool kWitness>
__device__ __forceinline__ void intersect_listed(
    List<kWitness>& s, int n, int np, const unsigned* __restrict__ bitmap,
    int words, int* __restrict__ wit) {
  const int lane = threadIdx.x & 31;
  __syncwarp();                             // the list and the group are set
  const int total = n * np;
  for (int t0 = 0; t0 < total; t0 += 32 * kGatherItems) {
    unsigned x[kGatherItems];
    int k[kGatherItems];
    int j[kGatherItems];
#pragma unroll
    for (int i = 0; i < kGatherItems; ++i) {
      const int t = t0 + 32 * i + lane;
      j[i] = t < total ? t / n : -1;
      k[i] = t < total ? t - j[i] * n : 0;
      x[i] = t < total
          ? bitmap[static_cast<long long>(s.v[j[i]]) * words + s.idx[k[i]]]
          : 0u;
    }
#pragma unroll
    for (int i = 0; i < kGatherItems; ++i) {
      const unsigned val = s.val[k[i]];
      const unsigned w = x[i] & val;
      if (w != 0) {
        atomicAdd(&s.cnt[s.lane[j[i]]], __popc(w));
        if constexpr (kWitness) {
          const unsigned low = val & (0u - val);
          if (w & low) atomicAdd(&s.low[k[i]], 1);
          const int base = s.idx[k[i]] * 32;
          unsigned b = w & ~low;
          while (b != 0) {
            atomicAdd(&wit[base + __ffs(b) - 1], 1);
            b &= b - 1;
          }
        }
      }
    }
  }
  if constexpr (kWitness) {
    __syncwarp();
    for (int k = lane; k < n; k += 32) {
      const int c = s.low[k];
      if (c != 0) atomicAdd(&wit[s.idx[k] * 32 + __ffs(s.val[k]) - 1], c);
    }
  }
  __syncwarp();                             // the list may be overwritten
}

// Per pair e = (u, v): cnt[e] = popcount(B[u] & B[v]); with a witness array,
// wit[c] += 1 for every set bit c of B[u] & B[v].
//
// Replaces the JAX package's bitmap_intersect._kernel (bitmap_intersect.py
// :60-114, entry bitmap_intersect_counts :118), which streams B[v] rows
// through a DMA ring, reloads B[u] only when u changes (the pairs come
// sorted by u), popcounts with SWAR and accumulates the witness bits into a
// [32, R, 128] VMEM block across its sequential grid.
//
// That streams all of B[v] for every pair, although only the words where
// B[u] is non-zero can hold a common bit: at gen:rmat17x16 a row is 4,096
// words and B[u] has about 20 non-zero ones. Here each warp takes 32
// consecutive pairs (a hub u's pairs spread over many warps) and groups
// those that share u, in any order (__match_any_sync). For each group it
// scans B[u] once, in 16-byte streaming loads (evict-first: the B[v]
// rows, hubs' rows, are the ones worth keeping in the L2), and lists B[u]'s
// non-zero words in shared memory; then it gathers only those words of
// each pair's B[v], one 32-byte sector a word, a lane per (pair, word).
// When the list could overflow (a row with more than kListWords - 128
// non-zero words listed so far) it is consumed and refilled, so a row of
// any width works. Counts are folded by shared-memory atomics per pair, the
// witness per listed word over the group's pairs (intersect_listed), then
// by device atomics (blocks run in no order).
//
// What bounds it: the bytes of each distinct u row, read once by the warps
// that share it (neighbouring warps read a split group's row from the L2),
// plus one sector of B[v] per non-zero word of B[u] and pair, most of them
// L2 hits on hub rows.
template <bool kWitness>
__global__ void __launch_bounds__(kBlock)
bitmap_intersect_counts_kernel(const int* __restrict__ eu,
                               const int* __restrict__ ev,
                               const unsigned* __restrict__ bitmap, int words,
                               int ne, int* __restrict__ cnt,
                               int* __restrict__ wit) {
  __shared__ List<kWitness> lists[kWarpsPerBlock];
  List<kWitness>& s = lists[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const long long e = static_cast<long long>(blockIdx.x) * kBlock
      + threadIdx.x;
  const bool real = e < ne;
  const int u = real ? eu[e] : -1;
  const int v = real ? ev[e] : 0;
  s.cnt[lane] = 0;
  const unsigned lt = (1u << lane) - 1;
  const int words4 = words / 4;
  // the groups of this warp's pairs that share u; the pads' group is
  // skipped
  const unsigned group = __match_any_sync(kFullMask, u);
  unsigned todo = __ballot_sync(kFullMask, real && (group & lt) == 0);
  while (todo != 0) {
    const int leader = __ffs(todo) - 1;
    todo &= todo - 1;
    const unsigned members = __shfl_sync(kFullMask, group, leader);
    const int gu = __shfl_sync(kFullMask, u, leader);
    if (members >> lane & 1) {
      const int j = __popc(members & lt);
      s.v[j] = v;
      s.lane[j] = lane;
    }
    const int np = __popc(members);
    const uint4* row = reinterpret_cast<const uint4*>(
        bitmap + static_cast<long long>(gu) * words);
    int n = 0;
    for (int k0 = 0; k0 < words4; k0 += 32 * kScanLoads) {
      uint4 a[kScanLoads];
#pragma unroll
      for (int i = 0; i < kScanLoads; ++i) {
        const int k = k0 + 32 * i + lane;
        a[i] = k < words4 ? __ldcs(row + k) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int i = 0; i < kScanLoads; ++i) {
        const unsigned w[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
        if (__ballot_sync(kFullMask, (w[0] | w[1] | w[2] | w[3]) != 0) == 0) {
          continue;                         // warp-uniform: nothing to list
        }
        if (n > kListWords - kStepWords) {  // warp-uniform
          intersect_listed<kWitness>(s, n, np, bitmap, words, wit);
          n = 0;
        }
        const int k = 4 * (k0 + 32 * i + lane);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const unsigned m = __ballot_sync(kFullMask, w[q] != 0);
          if (w[q] != 0) {
            const int at = n + __popc(m & lt);
            s.idx[at] = k + q;
            s.val[at] = w[q];
            if constexpr (kWitness) s.low[at] = 0;
          }
          n += __popc(m);
        }
      }
    }
    if (n > 0) intersect_listed<kWitness>(s, n, np, bitmap, words, wit);
    __syncwarp();                           // the group's slots are read
  }
  __syncwarp();
  if (real) cnt[e] = s.cnt[lane];
}

}  // namespace

extern "C" {

// `words` int32 words per row (a multiple of 4); `wit` nullptr for no
// witness, else [words * 32] int32 zeroed by the caller.
int etpu_bitmap_intersect(const void* eu, const void* ev, const void* bitmap,
                          int words, int ne, void* cnt, void* wit,
                          void* stream) {
  if (ne > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int blocks = (ne + kBlock - 1) / kBlock;
    const int* u = static_cast<const int*>(eu);
    const int* v = static_cast<const int*>(ev);
    const unsigned* b = static_cast<const unsigned*>(bitmap);
    int* c = static_cast<int*>(cnt);
    int* w = static_cast<int*>(wit);
    if (w != nullptr) {
      bitmap_intersect_counts_kernel<true><<<blocks, kBlock, 0, st>>>(
          u, v, b, words, ne, c, w);
    } else {
      bitmap_intersect_counts_kernel<false><<<blocks, kBlock, 0, st>>>(
          u, v, b, words, ne, c, w);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
