// alloc_dest: the j-th wanted outbox message takes the j-th free pool
// slot (both in index order); unwanted messages and wanted ones past the
// free supply get the sentinel p; overflow = max(wanted - free, 0).
//
// Replaces the TPU kernel oversim_tpu/kernels/outbox.py:_dest_kernel,
// two serial counting passes with the free list in VMEM.  Here ONE block
// runs the same two passes as chunked block-wide exclusive scans
// (stream compaction): pass 1 compacts the free-slot list into
// ``fslot``, pass 2 ranks the wanted messages and reads their slot.
// Deterministic by construction.  Bound: launch latency and the serial
// chunk loop of a single block — the bytes (valid [P], want [Q], dest
// [Q]) are about a megabyte at N = 10,000, well under a microsecond of
// memory time; a multi-block decoupled scan is the later fix.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

#define ITEMS 8

__global__ void alloc_dest_kernel(const uint8_t* __restrict__ valid,
                                  const uint8_t* __restrict__ want,
                                  int32_t* __restrict__ dest,
                                  int32_t* __restrict__ overflow,
                                  int32_t* __restrict__ fslot, int p, int q) {
  __shared__ int warp_sums[32];
  const int step = blockDim.x * ITEMS;
  int total = 0;
  int carry = 0;
  for (int base = 0; base < p; base += step) {
    const int start = base + threadIdx.x * ITEMS;
    int c = 0;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      int i = start + k;
      if (i < p && !valid[i]) ++c;
    }
    int wpos = carry + block_excl_scan(c, warp_sums, &total);
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      int i = start + k;
      if (i < p && !valid[i]) fslot[wpos++] = i;
    }
    carry += total;
  }
  const int n_free = carry;
  __syncthreads();
  carry = 0;
  for (int base = 0; base < q; base += step) {
    const int start = base + threadIdx.x * ITEMS;
    int c = 0;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      int j = start + k;
      if (j < q && want[j]) ++c;
    }
    int wpos = carry + block_excl_scan(c, warp_sums, &total);
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      int j = start + k;
      if (j < q) {
        if (want[j]) {
          dest[j] = wpos < n_free ? fslot[wpos] : p;
          ++wpos;
        } else {
          dest[j] = p;
        }
      }
    }
    carry += total;
  }
  if (threadIdx.x == 0) overflow[0] = carry > n_free ? carry - n_free : 0;
}

// scratch: int32[p] (the compacted free-slot list)
extern "C" int alloc_dest(const uint8_t* valid, const uint8_t* want,
                          int32_t* dest, int32_t* overflow, int32_t* scratch,
                          int p, int q, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  alloc_dest_kernel<<<1, 1024, 0, stream>>>(valid, want, dest, overflow,
                                            scratch, p, q);
  return (int)cudaGetLastError();
}
