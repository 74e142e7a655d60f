// inbox_select_gather: each destination's R earliest due messages, by
// (t_deliver, pool index), plus the gather of their [W] payload rows.
// inbox_select: the same selection without the gather (the sparse tick,
// which gathers only its compacted lanes' rows).
//
// Replaces the TPU kernel oversim_tpu/kernels/inbox.py:_inbox_kernel
// (gather mode, and select-only mode for inbox_select), which walks the pool serially and insertion-sorts each
// message into its destination's R-entry register row.  A serial walk
// does not fit a GPU, so the same table is built in parallel:
//   (a) count the due messages of every destination (atomicAdd);
//   (b) one-block exclusive scan of the counts → bucket offsets;
//   (c) scatter the due pool indices into their destination's bucket
//       (arrival order inside a bucket is arbitrary);
//   (d) one thread per destination insertion-sorts its bucket into a
//       private R-entry list by the UNIQUE key (t_deliver, index), so the
//       result does not depend on (c)'s order; writes the inbox row and
//       the delivered flags (an evicted entry is simply never written);
//   (e) one thread per gathered word copies blk[max(ix, 0), c]
//       (inbox_select_gather only).
// The TPU select-only walk stops at the highest due index (occupancy);
// here (a) and (c) read every slot once anyway, so there is no early out.
// Bound: memory — the [P] masks and times are read once and the
// [N, R, W] rows written once (tens of MB at N = 10,000); (e) is the
// bulk and is fully coalesced.  Launch latency dominates at small P.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

#define MAX_R 32
#define SCAN_ITEMS 8

__global__ void count_due(const uint8_t* __restrict__ due,
                          const int32_t* __restrict__ dst,
                          int32_t* __restrict__ cnt, int p) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < p && due[i]) atomicAdd(&cnt[dst[i]], 1);
}

__global__ void scan_counts(const int32_t* __restrict__ cnt,
                            int32_t* __restrict__ off, int n) {
  __shared__ int warp_sums[32];
  int carry = 0;
  int total = 0;
  const int step = blockDim.x * SCAN_ITEMS;
  for (int base = 0; base < n; base += step) {
    const int start = base + threadIdx.x * SCAN_ITEMS;
    int local = 0;
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      int i = start + k;
      if (i < n) local += cnt[i];
    }
    int w = carry + block_excl_scan(local, warp_sums, &total);
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      int i = start + k;
      if (i < n) {
        off[i] = w;
        w += cnt[i];
      }
    }
    carry += total;
  }
  if (threadIdx.x == 0) off[n] = carry;
}

__global__ void fill_buckets(const uint8_t* __restrict__ due,
                             const int32_t* __restrict__ dst,
                             const int32_t* __restrict__ off,
                             int32_t* __restrict__ cur,
                             int32_t* __restrict__ bucket, int p) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < p && due[i]) {
    int d = dst[i];
    int pos = atomicAdd(&cur[d], 1);
    bucket[off[d] + pos] = i;
  }
}

__global__ void select_rows(const int64_t* __restrict__ t,
                            const int32_t* __restrict__ off,
                            const int32_t* __restrict__ bucket,
                            int32_t* __restrict__ inbox,
                            uint8_t* __restrict__ delivered, int n, int r) {
  int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= n) return;
  int64_t kt[MAX_R];
  int32_t ki[MAX_R];
  int cnt = 0;
  const int end = off[d + 1];
  for (int j = off[d]; j < end; ++j) {
    const int32_t i = bucket[j];
    const int64_t ti = t[i];
    if (cnt == r &&
        !(ti < kt[r - 1] || (ti == kt[r - 1] && i < ki[r - 1])))
      continue;
    int pos = cnt < r ? cnt : r - 1;
    while (pos > 0 &&
           (ti < kt[pos - 1] || (ti == kt[pos - 1] && i < ki[pos - 1]))) {
      kt[pos] = kt[pos - 1];
      ki[pos] = ki[pos - 1];
      --pos;
    }
    kt[pos] = ti;
    ki[pos] = i;
    if (cnt < r) ++cnt;
  }
  for (int k = 0; k < r; ++k) {
    if (k < cnt) {
      inbox[(int64_t)d * r + k] = ki[k];
      delivered[ki[k]] = 1;
    } else {
      inbox[(int64_t)d * r + k] = -1;
    }
  }
}

__global__ void gather_rows(const int32_t* __restrict__ inbox,
                            const int32_t* __restrict__ blk,
                            int32_t* __restrict__ gblk, int64_t total,
                            int w) {
  int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  int64_t row = e / w;
  int c = (int)(e - row * w);
  int32_t ix = inbox[row];
  gblk[e] = blk[(int64_t)(ix > 0 ? ix : 0) * w + c];
}

// Steps (a)-(d).  scratch: int32[3 * n + 1 + p] (cnt[n], off[n + 1],
// cur[n], bucket[p]).
static int launch_select(const uint8_t* due, const int32_t* dst,
                         const int64_t* t, int32_t* inbox,
                         uint8_t* delivered, int32_t* scratch, int n, int r,
                         int p, cudaStream_t stream) {
  if (r < 1 || r > MAX_R || n < 1) return (int)cudaErrorInvalidValue;
  int32_t* cnt = scratch;
  int32_t* off = cnt + n;
  int32_t* cur = off + n + 1;
  int32_t* bucket = cur + n;
  cudaMemsetAsync(cnt, 0, sizeof(int32_t) * n, stream);
  cudaMemsetAsync(cur, 0, sizeof(int32_t) * n, stream);
  cudaMemsetAsync(delivered, 0, p, stream);
  const int tb = 256;
  if (p > 0) count_due<<<(p + tb - 1) / tb, tb, 0, stream>>>(due, dst, cnt, p);
  scan_counts<<<1, 1024, 0, stream>>>(cnt, off, n);
  if (p > 0)
    fill_buckets<<<(p + tb - 1) / tb, tb, 0, stream>>>(due, dst, off, cur,
                                                       bucket, p);
  select_rows<<<(n + 127) / 128, 128, 0, stream>>>(t, off, bucket, inbox,
                                                   delivered, n, r);
  return (int)cudaGetLastError();
}

extern "C" int inbox_select(const uint8_t* due, const int32_t* dst,
                            const int64_t* t, int32_t* inbox,
                            uint8_t* delivered, int32_t* scratch, int n,
                            int r, int p, void* stream_ptr) {
  return launch_select(due, dst, t, inbox, delivered, scratch, n, r, p,
                       (cudaStream_t)stream_ptr);
}

extern "C" int inbox_select_gather(const uint8_t* due, const int32_t* dst,
                                   const int64_t* t, const int32_t* blk,
                                   int32_t* inbox, uint8_t* delivered,
                                   int32_t* gblk, int32_t* scratch, int n,
                                   int r, int p, int w, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int code = launch_select(due, dst, t, inbox, delivered, scratch, n, r, p,
                           stream);
  if (code != 0) return code;
  const int tb = 256;
  const int64_t total = (int64_t)n * r * w;
  if (total > 0)
    gather_rows<<<(unsigned)((total + tb - 1) / tb), tb, 0, stream>>>(
        inbox, blk, gblk, total, w);
  return (int)cudaGetLastError();
}
