// The pieces of the single-pass tile scans (scan in operator_kernels.cu,
// the segment fills in bfs_kernels.cu) and of spmv_kernels.cu's hand-offs:
// a 32-bit value and its bits, the start flags of 4 bytes at once, and the
// 64-bit status word that one block publishes with one atomic (its state
// in the high half, a value's bits in the low half) and others load.
#pragma once

#include <cuda_runtime.h>

namespace etpu {

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

// bit k: byte k of w is not 0
__device__ __forceinline__ unsigned nonzero_bytes(unsigned w) {
  const unsigned h = (((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) & 0x80808080u;
  return (h >> 7 | h >> 14 | h >> 21 | h >> 28) & 0xfu;
}

// A status word as the L2 holds it now (a relaxed load at device scope: no
// stale copy from L1, and the state and value arrive together).
__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void publish_status(unsigned long long* p,
                                               unsigned state, unsigned v) {
  atomicExch(p, static_cast<unsigned long long>(state) << 32 | v);
}

}  // namespace etpu
