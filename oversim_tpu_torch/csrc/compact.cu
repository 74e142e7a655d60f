// compact_indices: lane k receives vals[i] of the k-th set mask bit (index
// order); lanes past the set count hold the sentinel; set bits past cap
// are dropped; count receives the TRUE number of set bits.
//
// Replaces the TPU kernel oversim_tpu/kernels/outbox.py:_compact_kernel,
// a serial counting walk with the counter in SMEM.  Here it is a
// multi-block stream compaction, the one free_slots runs for alloc_dest
// (outbox.cu): one tile of COMPACT_TILE mask bytes per block, each thread
// reading its 16 bytes with one 16-byte load (mask16.cuh), a block-wide
// exclusive scan of the set counts, and the tile's first lane from the
// decoupled look-back scan of scan.cuh.  Each set byte writes its value
// to its lane below cap.  The last tile, which learns the total from its
// look-back, writes count and fills lanes [min(total, cap), cap) with the
// sentinel (16-byte stores where aligned); no other block writes there,
// since set bits land below min(total, cap).  Deterministic by
// construction.  Bound: at the sparse path's shape (m = 65,536, cap =
// 8,192) the bytes (mask [m], the set bits' vals, lanes [cap]) take
// 0.03 us at the HBM rate; what is left is a memset, one launch and the
// look-back chain of 16 tiles (one block walking 8 chunks in series took
// 18.4 us there).
//
// Scratch (int32 words; the wrapper allocates it, the kernel allocates
// nothing), with T(m) = max(1, ceil(m / COMPACT_TILE)):
//   words = 2 + 2 * T(m)
//   [0] the tile counter, [1] pad, then T(m) 64-bit tile status words,
//   all zeroed by one memset.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mask16.cuh"
#include "scan.cuh"

#ifndef COMPACT_THREADS
#define COMPACT_THREADS 256
#endif
#define COMPACT_TILE (COMPACT_THREADS * VEC)   // 4,096 mask bytes per tile

// out[from, to) = value by every thread of the block: 16-byte stores over
// the aligned middle, 4-byte stores at the ends.
__device__ __forceinline__ void fill_i32(int32_t* __restrict__ out, int from,
                                         int to, int value) {
  int a = from, b = from;
  if ((((uintptr_t)out) & 15) == 0) {
    a = min((from + 3) & ~3, to);
    b = a + ((to - a) & ~3);
  }
  const int4 v4 = make_int4(value, value, value, value);
  for (int k = a + 4 * threadIdx.x; k < b; k += 4 * blockDim.x)
    *reinterpret_cast<int4*>(out + k) = v4;
  for (int k = from + threadIdx.x; k < a; k += blockDim.x) out[k] = value;
  for (int k = b + threadIdx.x; k < to; k += blockDim.x) out[k] = value;
}

__global__ void __launch_bounds__(COMPACT_THREADS)
    compact_kernel(const uint8_t* __restrict__ mask,
                   const int32_t* __restrict__ vals,
                   int32_t* __restrict__ lanes, int32_t* __restrict__ count,
                   int* tile_counter, unsigned long long* status, int m,
                   int cap, int sentinel, int tiles) {
  __shared__ int warp_sums[32];
  const int tile = scan_tile_id(tile_counter);
  const int64_t i0 = (int64_t)tile * COMPACT_TILE + threadIdx.x * VEC;
  const uint4 v = load_mask16(mask, i0, m);
  int total;
  const int off = block_excl_scan(count16(v), warp_sums, &total);
  const int first = scan_tile_prefix(status, tile, total);
  int pos = first + off;
  if (pos < cap) {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      if (byte_at(v, k)) {
        if (pos < cap) lanes[pos] = vals[i0 + k];
        ++pos;
      }
  }
  if (tile == tiles - 1) {
    const int n_set = first + total;
    if (threadIdx.x == 0) count[0] = n_set;
    fill_i32(lanes, min(n_set, cap), cap, sentinel);
  }
}

static int tiles_of(int x) {
  return x > 0 ? (x + COMPACT_TILE - 1) / COMPACT_TILE : 1;
}

// scratch: int32[2 + 2 * T(m)], see the head comment.
extern "C" int compact_indices(const uint8_t* mask, const int32_t* vals,
                               int32_t* lanes, int32_t* count,
                               int32_t* scratch, int m, int cap,
                               int sentinel, void* stream_ptr) {
  if (cap < 1 || m < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int tiles = tiles_of(m);
  cudaMemsetAsync(scratch, 0, sizeof(int32_t) * (2 + 2 * tiles), stream);
  compact_kernel<<<tiles, COMPACT_THREADS, 0, stream>>>(
      mask, vals, lanes, count, scratch,
      (unsigned long long*)(scratch + 2), m, cap, sentinel, tiles);
  return (int)cudaGetLastError();
}
