// Mask-tile helpers shared by the port's stream compactions (alloc_dest,
// compact_indices): each thread of a tile reads VEC consecutive 0/1 mask
// bytes, with one 16-byte load where it can.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define VEC 16                        // mask bytes per thread

// Byte k (0..15) of a 16-byte vector; k is a constant after unrolling.
__device__ __forceinline__ unsigned byte_at(const uint4& v, int k) {
  const unsigned w = k < 4 ? v.x : k < 8 ? v.y : k < 12 ? v.z : v.w;
  return (w >> (8 * (k & 3))) & 0xffu;
}

// This thread's 16 mask bytes from ``i`` (zero past ``n``): one 16-byte
// load where the whole vector is in range and aligned.
__device__ __forceinline__ uint4 load_mask16(const uint8_t* __restrict__ m,
                                             int64_t i, int64_t n) {
  if (i + VEC <= n && (((uintptr_t)(m + i)) & 15) == 0)
    return *reinterpret_cast<const uint4*>(m + i);
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    if (i + k < n) w[k >> 2] |= (unsigned)(m[i + k] != 0) << (8 * (k & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// How many of this thread's VEC items from ``i`` lie below ``n``.
__device__ __forceinline__ int in_range(int64_t n, int64_t i) {
  const int64_t rem = n - i;
  return rem <= 0 ? 0 : rem >= VEC ? VEC : (int)rem;
}

// Set bytes of a 0/1 byte vector.
__device__ __forceinline__ int count16(const uint4& v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}
