// Per-segment values read at the segment starts of an edge-axis array,
// several segments a thread: the body of collapse_starts
// (sssp_kcore_kernels.cu) and of collapse_levels (bfs_kernels.cu, the same
// function over int8 or int32 levels).
//
// out[v] = at(x[off[v]]) for a non-empty segment v (off[v] < off[v+1]),
// at.empty() for an empty one, and 0 at v == source (none where source
// < 0). `At` is a functor: `int operator()(T) const` and
// `int empty() const`.
//
// Each thread takes kStartsPerThread consecutive segments: their offsets
// by 16-byte loads (element by element where off is not 16-byte aligned or
// the run passes vp), then every gather of x issued before any is used, so
// that each thread has that many in flight, then the results by 16-byte
// stores. A gather costs a 32-byte sector wherever segments are longer
// than 8 slots, so what bounds it is that sector a non-empty segment, the
// [vp+1] offsets and the [vp] output; the gathers' latency is what a
// thread with one start would wait on, hence several. Four a thread, 128
// threads a block: eight a thread took 5% more device time at
// gen:rmat20x16 and 256 threads a block the same (chip_ab.py's starts
// group, NVIDIA H100 80GB HBM3, 700 W).
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace etpu {

constexpr int kStartsPerThread = 4;         // consecutive segments a thread
constexpr int kStartsBlock = 128;           // threads a block
static_assert(kStartsPerThread % 4 == 0, "whole 16-byte vectors a thread");

__host__ __device__ constexpr int starts_blocks(int vp) {
  return static_cast<int>(
      (static_cast<long long>(vp) + kStartsBlock * kStartsPerThread - 1) /
      (kStartsBlock * kStartsPerThread));
}

template <typename T, typename At>
__device__ __forceinline__ void collapse_segment_starts(
    const T* __restrict__ x, const int* __restrict__ off, int vp, int source,
    At at, int* __restrict__ out) {
  constexpr int C = kStartsPerThread;
  const long long v0 =
      (static_cast<long long>(blockIdx.x) * kStartsBlock + threadIdx.x) * C;
  if (v0 >= vp) return;
  const bool whole = v0 + C <= vp;
  int b[C + 1];
  if (whole && (reinterpret_cast<uintptr_t>(off) & 15) == 0) {
#pragma unroll
    for (int k = 0; k < C; k += 4) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(off + v0 + k));
      b[k] = q.x;
      b[k + 1] = q.y;
      b[k + 2] = q.z;
      b[k + 3] = q.w;
    }
    b[C] = __ldg(off + v0 + C);
  } else {
#pragma unroll
    for (int k = 0; k <= C; ++k) b[k] = v0 + k <= vp ? __ldg(off + v0 + k) : 0;
  }
  T y[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {             // all gathers in flight at once
    y[k] = v0 + k < vp && b[k] < b[k + 1] ? __ldg(x + b[k]) : T{};
  }
  int r[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    r[k] = b[k] < b[k + 1] ? at(y[k]) : at.empty();
    if (v0 + k == source) r[k] = 0;
  }
  if (whole && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
#pragma unroll
    for (int k = 0; k < C; k += 4) {
      *reinterpret_cast<int4*>(out + v0 + k) =
          make_int4(r[k], r[k + 1], r[k + 2], r[k + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      if (v0 + k < vp) out[v0 + k] = r[k];
    }
  }
}

}  // namespace etpu
