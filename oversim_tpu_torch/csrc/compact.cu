// compact_indices: lane k receives vals[i] of the k-th set mask bit (index
// order); lanes past the set count hold the sentinel; set bits past cap
// are dropped; count receives the TRUE number of set bits.
//
// Replaces the TPU kernel oversim_tpu/kernels/outbox.py:_compact_kernel,
// a serial counting walk with the counter in SMEM.  Here ONE block runs
// the walk as a stream compaction: per chunk of blockDim * ITEMS mask
// bits every thread counts its ITEMS bits, a block-wide exclusive scan
// (scan.cuh) gives each thread its first lane, and the thread writes its
// set bits' values in order.  Deterministic by construction.  Bound:
// launch latency and the serial chunk loop of one block (8 chunks at
// m = 65,536) — the bytes (mask [m], vals [m], lanes [cap]) are well under
// a megabyte; a multi-block decoupled scan is the later fix, shared with
// alloc_dest.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

#define ITEMS 8

__global__ void compact_kernel(const uint8_t* __restrict__ mask,
                               const int32_t* __restrict__ vals,
                               int32_t* __restrict__ lanes,
                               int32_t* __restrict__ count, int m, int cap,
                               int sentinel) {
  __shared__ int warp_sums[32];
  const int step = blockDim.x * ITEMS;
  int total = 0;
  int carry = 0;
  for (int base = 0; base < m; base += step) {
    const int start = base + threadIdx.x * ITEMS;
    int c = 0;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      int i = start + k;
      if (i < m && mask[i]) ++c;
    }
    int wpos = carry + block_excl_scan(c, warp_sums, &total);
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      int i = start + k;
      if (i < m && mask[i]) {
        if (wpos < cap) lanes[wpos] = vals[i];
        ++wpos;
      }
    }
    carry += total;
  }
  for (int k = (carry < cap ? carry : cap) + threadIdx.x; k < cap;
       k += blockDim.x)
    lanes[k] = sentinel;
  if (threadIdx.x == 0) count[0] = carry;
}

extern "C" int compact_indices(const uint8_t* mask, const int32_t* vals,
                               int32_t* lanes, int32_t* count, int m, int cap,
                               int sentinel, void* stream_ptr) {
  if (cap < 1 || m < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  compact_kernel<<<1, 1024, 0, stream>>>(mask, vals, lanes, count, m, cap,
                                         sentinel);
  return (int)cudaGetLastError();
}
