// Prefix sums shared by the port's CUDA kernels: a block-wide exclusive
// scan, and the tile step of a multi-block single-pass scan.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

// ---- multi-block exclusive scan: single-pass decoupled look-back --------
//
// A kernel that scans across blocks gives each block one tile.  The tile
// id comes from an atomic counter, in the order the blocks start
// (``scan_tile_id``): blocks run in no order on the card, and a block
// only ever waits on tiles with smaller ids, whose blocks have therefore
// started and are resident, so the waits always end.  Each tile
// publishes one 64-bit status word — flag in the high half, count in the
// low half, so the two can never be seen apart — first with its own
// total (SCAN_AGGREGATE) as soon as it has it, then with its inclusive
// prefix (SCAN_PREFIX).  ``scan_tile_prefix`` finds a tile's exclusive
// prefix with one warp that reads the 32 preceding words at a time,
// waits until all of them are published, and adds totals back to the
// nearest inclusive prefix.  The counter and the status words must be
// zero when the kernel starts: the caller clears them with one memset.
// Counts are non-negative and their sum fits in an int.

#define SCAN_AGGREGATE 1ull
#define SCAN_PREFIX 2ull

// This block's tile id (every thread of the block must call it, once).
__device__ __forceinline__ int scan_tile_id(int* counter) {
  __shared__ int tile;
  if (threadIdx.x == 0) tile = atomicAdd(counter, 1);
  __syncthreads();
  return tile;
}

__device__ __forceinline__ void scan_publish(unsigned long long* status,
                                             int tile,
                                             unsigned long long flag,
                                             int value) {
  __threadfence();
  *(volatile unsigned long long*)(status + tile) =
      (flag << 32) | (unsigned)value;
}

// The exclusive prefix of ``tile`` whose own total is ``total``; also
// publishes the tile's status.  Every thread of the block must call it
// with the same values (it synchronises); all receive the prefix.
__device__ __forceinline__ int scan_tile_prefix(unsigned long long* status,
                                                int tile, int total) {
  __shared__ int prefix;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int excl = 0;
    if (tile > 0) {
      if (lane == 0) scan_publish(status, tile, SCAN_AGGREGATE, total);
      for (int look = tile - 1 - lane;; look -= 32) {
        unsigned long long w;
        do {
          w = look >= 0 ? *(volatile unsigned long long*)(status + look)
                        : SCAN_PREFIX << 32;
        } while (__any_sync(0xffffffffu, (w >> 32) == 0));
        // lane k reads tile (tile - 1 - k): the first lane holding an
        // inclusive prefix is the nearest such tile
        const unsigned done =
            __ballot_sync(0xffffffffu, (w >> 32) == SCAN_PREFIX);
        const int last = done ? __ffs(done) - 1 : 31;
        int v = lane <= last ? (int)(unsigned)w : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        excl += v;
        if (done) break;
      }
    }
    if (lane == 0) {
      scan_publish(status, tile, SCAN_PREFIX, excl + total);
      prefix = excl;
    }
  }
  __syncthreads();
  return prefix;
}
