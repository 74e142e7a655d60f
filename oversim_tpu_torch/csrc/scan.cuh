// Block-wide exclusive prefix sum shared by the port's CUDA kernels.
#pragma once

#include <cuda_runtime.h>

// Exclusive scan of one int per thread across the whole block
// (blockDim.x a multiple of 32, at most 1024).  ``warp_sums`` is a
// __shared__ int[32]; ``*total`` receives the block total.  Every thread
// of the block must call it (it synchronises).
__device__ __forceinline__ int block_excl_scan(int v, int* warp_sums,
                                               int* total) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int s = lane < nw ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < nw) warp_sums[lane] = s;
  }
  __syncthreads();
  const int before = wid > 0 ? warp_sums[wid - 1] : 0;
  *total = warp_sums[nw - 1];
  __syncthreads();
  return before + x - v;
}
