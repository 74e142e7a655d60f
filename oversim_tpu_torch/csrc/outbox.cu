// alloc_dest: the j-th wanted outbox message takes the j-th free pool
// slot (both in index order); unwanted messages and wanted ones past the
// free supply get the sentinel p; overflow = max(wanted - free, 0).
//
// Replaces the TPU kernel oversim_tpu/kernels/outbox.py:_dest_kernel,
// two serial counting passes with the free list in VMEM.  On the card
// the two passes are two multi-block stream compactions, one tile of
// TILE mask bytes per block, each thread reading its 16 bytes with one
// 16-byte load (mask16.cuh):
//   free_slots   counts the free slots of each tile (valid == 0), finds
//                the tile's first rank with the decoupled look-back scan
//                of scan.cuh, writes the tile's free slots into fslot and
//                (last tile) n_free;
//   rank_wanted  ranks the wanted messages the same way, writes dest
//                (fslot[rank] or p) and (last tile) the overflow, as
//                int64 so the caller needs no conversion.
// Deterministic by construction.  Bound: at the main paths' shapes (P =
// 80,000 / Q = 320,000 and P = 524,288 / Q = 2,097,152) the bytes (valid
// [P], want [Q], dest [Q] i32) take 0.5-3.3 us at the HBM rate; what is
// left is two launches, a memset and the look-back chain (each tile
// waits for the tiles before it to publish), so the kernel is bound by
// launch and look-back latency, not by bytes (one block running both
// passes chunk after chunk took 0.3-1.9 ms there).
//
// Scratch (int32 words; the wrapper allocates it, the kernels allocate
// nothing), with T(x) = max(1, ceil(x / 4096)):
//   words = 4 + 2 * (T(p) + T(q)) + p
//   [0] free_slots' tile counter, [1] rank_wanted's, [2] n_free, [3] pad,
//   then T(p) and T(q) 64-bit tile status words (zeroed together with
//   the counters by one memset), then fslot[p].

#include <cuda_runtime.h>
#include <stdint.h>

#include "mask16.cuh"
#include "scan.cuh"

#define TILE_THREADS 256
#define TILE (TILE_THREADS * VEC)     // 4,096 mask bytes per tile

__global__ void __launch_bounds__(TILE_THREADS)
    free_slots(const uint8_t* __restrict__ valid, int32_t* __restrict__ fslot,
               int32_t* __restrict__ n_free, int* tile_counter,
               unsigned long long* status, int p, int tiles) {
  __shared__ int warp_sums[32];
  const int tile = scan_tile_id(tile_counter);
  const int64_t i0 = (int64_t)tile * TILE + threadIdx.x * VEC;
  const int here = in_range(p, i0);
  const uint4 v = load_mask16(valid, i0, p);
  int total;
  const int off = block_excl_scan(here - count16(v), warp_sums, &total);
  const int first = scan_tile_prefix(status, tile, total);
  int pos = first + off;
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    if (k < here && !byte_at(v, k)) fslot[pos++] = (int32_t)(i0 + k);
  if (tile == tiles - 1 && threadIdx.x == 0) n_free[0] = first + total;
}

__global__ void __launch_bounds__(TILE_THREADS)
    rank_wanted(const uint8_t* __restrict__ want,
                const int32_t* __restrict__ fslot,
                const int32_t* __restrict__ n_free_ptr,
                int32_t* __restrict__ dest, int64_t* __restrict__ overflow,
                int* tile_counter, unsigned long long* status, int p, int q,
                int tiles) {
  __shared__ int warp_sums[32];
  const int tile = scan_tile_id(tile_counter);
  const int64_t i0 = (int64_t)tile * TILE + threadIdx.x * VEC;
  const int here = in_range(q, i0);
  const uint4 v = load_mask16(want, i0, q);
  int total;
  const int off = block_excl_scan(count16(v), warp_sums, &total);
  const int first = scan_tile_prefix(status, tile, total);
  const int n_free = n_free_ptr[0];
  int rank = first + off;
  int d[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    d[k] = p;
    if (byte_at(v, k)) {
      if (rank < n_free) d[k] = fslot[rank];
      ++rank;
    }
  }
  if (here == VEC && (((uintptr_t)(dest + i0)) & 15) == 0) {
    int4* out = reinterpret_cast<int4*>(dest + i0);
#pragma unroll
    for (int k = 0; k < VEC / 4; ++k)
      out[k] = make_int4(d[4 * k], d[4 * k + 1], d[4 * k + 2], d[4 * k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      if (k < here) dest[i0 + k] = d[k];
  }
  if (tile == tiles - 1 && threadIdx.x == 0) {
    const int64_t wanted = (int64_t)first + total;
    overflow[0] = wanted > n_free ? wanted - n_free : 0;
  }
}

static int tiles_of(int x) { return x > 0 ? (x + TILE - 1) / TILE : 1; }

// overflow: one int64; scratch: int32[4 + 2 * (T(p) + T(q)) + p], see
// the head comment.
extern "C" int alloc_dest(const uint8_t* valid, const uint8_t* want,
                          int32_t* dest, int64_t* overflow, int32_t* scratch,
                          int p, int q, void* stream_ptr) {
  if (p < 0 || q < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int t1 = tiles_of(p), t2 = tiles_of(q);
  unsigned long long* status1 = (unsigned long long*)(scratch + 4);
  unsigned long long* status2 = status1 + t1;
  int32_t* fslot = (int32_t*)(status2 + t2);
  cudaMemsetAsync(scratch, 0, sizeof(int32_t) * (4 + 2 * (t1 + t2)),
                  stream);
  free_slots<<<t1, TILE_THREADS, 0, stream>>>(valid, fslot, scratch + 2,
                                              scratch, status1, p, t1);
  rank_wanted<<<t2, TILE_THREADS, 0, stream>>>(want, fslot, scratch + 2,
                                               dest, overflow, scratch + 1,
                                               status2, p, q, t2);
  return (int)cudaGetLastError();
}
