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

namespace {

constexpr int kBlock = 256;                 // threads per block
constexpr int kWarpsPerBlock = kBlock / 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kPairsPerBlock = 16;          // consecutive pairs per block
// The shared-memory path takes u rows of at most kSharedRowBytes: a launch
// may hold 48 KiB of shared memory without opting in, and the kernel's own
// static warp_sum takes kStaticSharedBytes of it, so the dynamic row gets the
// rest (a row of exactly 48 KiB, 12,288 words, is read from device memory).
constexpr int kStaticSharedBytes = 2 * kWarpsPerBlock * sizeof(int);
constexpr int kSharedRowBytes = 48 * 1024 - kStaticSharedBytes;

// Per pair e = (u, v): cnt[e] = popcount(B[u] & B[v]); with a witness array,
// wit[c] += 1 for every set bit c of B[u] & B[v].
//
// Replaces the JAX package's bitmap_intersect._kernel (bitmap_intersect.py
// :60-114, entry bitmap_intersect_counts :118), which streams B[v] rows
// through a DMA ring, reloads B[u] only when u changes (the pairs come
// sorted by u), popcounts with SWAR and accumulates the witness bits into a
// [32, R, 128] VMEM block across its sequential grid.
//
// Here a block takes kPairsPerBlock consecutive pairs. B[u] is copied into
// shared memory when u changes (kSharedU, rows of at most kSharedRowBytes;
// wider rows are read from device memory, where consecutive pairs of one u
// hit the L2), then the block streams B[v] in 16-byte loads, one uint4 per
// thread per step: AND, __popc, a warp sum and the warps' sums (double
// buffered, so one barrier per pair). Blocks run in no order, so the
// witness histogram is per vertex in device memory, one atomicAdd per set
// bit, that is one per (pair, common element): a triangle at a hub meets
// every other block's atomics on the same word.
//
// What bounds it: bytes, V/8 per pair for B[v] at HBM rate when the bitmap
// exceeds the L2 (at rmat17 a row is 16 KiB and the bitmap 2.1 GB). A sorted
// merge over adjacency lists would read only the two lists; that is a
// redesign, not a port.
template <bool kSharedU, bool kWitness>
__global__ void __launch_bounds__(kBlock)
bitmap_intersect_counts_kernel(const int* __restrict__ eu,
                               const int* __restrict__ ev,
                               const uint4* __restrict__ bitmap, int words4,
                               int ne, int* __restrict__ cnt,
                               int* __restrict__ wit) {
  extern __shared__ uint4 urow[];
  __shared__ int warp_sum[2][kWarpsPerBlock];
  static_assert(sizeof(warp_sum) == kStaticSharedBytes,
                "kSharedRowBytes must leave room for warp_sum");
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int e0 = blockIdx.x * kPairsPerBlock;
  const int e1 = min(e0 + kPairsPerBlock, ne);
  int cur_u = -1;
  for (int e = e0; e < e1; ++e) {
    const int u = eu[e];                    // block-uniform
    const uint4* bu = bitmap + static_cast<long long>(u) * words4;
    const uint4* bv = bitmap + static_cast<long long>(ev[e]) * words4;
    if (kSharedU && u != cur_u) {
      __syncthreads();                      // the old row is read
      for (int k = tid; k < words4; k += kBlock) urow[k] = bu[k];
      __syncthreads();
      cur_u = u;
    }
    int c = 0;
    for (int k = tid; k < words4; k += kBlock) {
      const uint4 a = kSharedU ? urow[k] : bu[k];
      const uint4 b = bv[k];
      const unsigned w[4] = {a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        c += __popc(w[q]);
        if (kWitness) {
          unsigned x = w[q];
          while (x != 0) {
            atomicAdd(&wit[(4 * k + q) * 32 + __ffs(x) - 1], 1);
            x &= x - 1;
          }
        }
      }
    }
    c = __reduce_add_sync(kFullMask, c);
    if (lane == 0) warp_sum[e & 1][warp] = c;
    __syncthreads();
    if (tid == 0) {
      int s = 0;
      for (int w = 0; w < kWarpsPerBlock; ++w) s += warp_sum[e & 1][w];
      cnt[e] = s;
    }
  }
}

template <bool kSharedU>
void launch(const int* eu, const int* ev, const uint4* bitmap, int words4,
            int ne, int* cnt, int* wit, cudaStream_t st) {
  const int blocks = (ne + kPairsPerBlock - 1) / kPairsPerBlock;
  const size_t smem = kSharedU ? static_cast<size_t>(words4) * 16 : 0;
  if (wit != nullptr) {
    bitmap_intersect_counts_kernel<kSharedU, true>
        <<<blocks, kBlock, smem, st>>>(eu, ev, bitmap, words4, ne, cnt, wit);
  } else {
    bitmap_intersect_counts_kernel<kSharedU, false>
        <<<blocks, kBlock, smem, st>>>(eu, ev, bitmap, words4, ne, cnt, wit);
  }
}

}  // namespace

extern "C" {

// `words` int32 words per row (a multiple of 4); `wit` nullptr for no
// witness, else [words * 32] int32 zeroed by the caller.
int etpu_bitmap_intersect(const void* eu, const void* ev, const void* bitmap,
                          int words, int ne, void* cnt, void* wit,
                          void* stream) {
  if (ne > 0) {
    const int words4 = words / 4;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* u = static_cast<const int*>(eu);
    const int* v = static_cast<const int*>(ev);
    const uint4* b = static_cast<const uint4*>(bitmap);
    int* c = static_cast<int*>(cnt);
    int* w = static_cast<int*>(wit);
    if (static_cast<long long>(words) * 4 <= kSharedRowBytes) {
      launch<true>(u, v, b, words4, ne, c, w, st);
    } else {
      launch<false>(u, v, b, words4, ne, c, w, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
