// inbox_select_gather: each destination's R earliest due messages, by
// (t_deliver, pool index), plus the gather of their [W] payload rows.
// inbox_select: the same selection without the gather (the sparse tick,
// which gathers only its compacted lanes' rows).
//
// Replaces the TPU kernel oversim_tpu/kernels/inbox.py:_inbox_kernel
// (gather mode, and select-only mode for inbox_select), which walks the
// pool serially and insertion-sorts each message into its destination's
// R-entry register row.  A serial walk does not fit a GPU, so the same
// table is built in parallel, in one memset and four kernels:
//   (a) count_due: count the due messages of every destination
//       (atomicAdd) and clear the delivered flags;
//   (b) scan_counts: exclusive scan of the counts into bucket offsets,
//       across blocks (the decoupled look-back scan of scan.cuh);
//   (c) fill_buckets: scatter the due pool indices into their
//       destination's bucket (arrival order inside a bucket is
//       arbitrary);
//   (d) select_rows, one grid of as many blocks as the card holds, in
//       three grid-strided parts: entries past a destination's count
//       get -1; each due message of a bucket of at most 32 takes its
//       rank among its bucket's keys and writes itself if the rank is
//       below R; a larger bucket goes to a warp, which keeps the R
//       smallest keys seen so far, one per lane, and folds the bucket in
//       32 candidates at a time (candidates not below the current R-th
//       key drop out at once; otherwise every entry takes its rank among
//       the list and the candidates by shuffles and is written to that
//       place in shared memory); above BIG_BUCKET the block's 8 warps
//       split the bucket and their sorted lists are merged by rank
//       (binary search), so a hot destination is read by 256 threads.
//       No per-thread arrays, so nothing goes to local memory.  The key
//       (t_deliver, index) is UNIQUE, so the result does not depend on
//       (c)'s order.  Sets the chosen messages' flags;
//   (e) gather_rows (inbox_select_gather, and alone as inbox_gather):
//       gblk[d, k, :] = blk[max(inbox[d, k], 0), :] in flat output space,
//       each thread writing 4 consecutive words of gblk with one 16-byte
//       store; it finds its row and column with one 32-bit division,
//       reads the inbox entry of each row it touches (two at most for W
//       >= 4) and makes 4-byte loads from blk, whose rows of W words are
//       not 16-byte aligned.  Row 0, which every empty entry reads, stays
//       in cache.
// The TPU select-only walk stops at the highest due index (occupancy);
// here (a) and (c) read every slot once anyway, so there is no early out.
// Bound: at the paths' shapes the bytes (the [P] masks and times read
// once, the [N, R] table and for (e) the [N, R, W] rows written once)
// take 2-8 us at the HBM rate; (a)-(d) are bound by their launches and
// the scan's look-back chain, (e) by its bytes, three quarters of which
// are the [N, R, W] writes (coalesced 16-byte stores).
//
// Scratch (int32 words; the wrapper allocates it, the kernels allocate
// nothing), with n4 = round_up(n + 1, 4) and T = ceil(n / 1024):
//   words = 3 * n4 + 4 * (T + 1) + p
//   cnt[n4], cur[n4] (fill cursors), the scan's tile counter and pad
//   (4 words), its T 64-bit tile status words (in 4 T words) — all
//   zeroed by the one memset — then off[n4] (off[n] = due total) and
//   bucket[p].

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

#define MAX_R 32
#define SCAN_THREADS 256
#define SCAN_VEC 4                              // counts per thread
#define SCAN_TILE (SCAN_THREADS * SCAN_VEC)     // 1,024 counts per tile
#define SEL_THREADS 256
#define SEL_WARPS (SEL_THREADS / 32)
#define SEL_UNROLL 4                 // candidates per lane in flight
#define SEL_STEP (32 * SEL_UNROLL)   // bucket entries per warp step
#define SMALL_BUCKET MAX_R           // up to here: each message ranks itself
#define BIG_BUCKET 512               // above here: the whole block
// the empty key, after every real key
#define T_NONE ((int64_t)0x7fffffffffffffffLL)
#define I_NONE ((int32_t)0x7fffffff)
#define GATHER_THREADS 256
#define GATHER_WORDS 4               // gblk words per thread: one int4

__global__ void count_due(const uint8_t* __restrict__ due,
                          const int32_t* __restrict__ dst,
                          int32_t* __restrict__ cnt,
                          uint8_t* __restrict__ delivered, int p) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < p) {
    delivered[i] = 0;
    if (due[i]) atomicAdd(&cnt[dst[i]], 1);
  }
}

// cnt is zero from n up to a multiple of 4, so a thread's 4 counts are
// one 16-byte load.
__global__ void __launch_bounds__(SCAN_THREADS)
    scan_counts(const int32_t* __restrict__ cnt, int32_t* __restrict__ off,
                int* tile_counter, unsigned long long* status, int n,
                int tiles) {
  __shared__ int warp_sums[32];
  const int tile = scan_tile_id(tile_counter);
  const int i0 = tile * SCAN_TILE + threadIdx.x * SCAN_VEC;
  int4 c = make_int4(0, 0, 0, 0);
  if (i0 < n) c = *reinterpret_cast<const int4*>(cnt + i0);
  int total;
  const int excl = block_excl_scan(c.x + c.y + c.z + c.w, warp_sums, &total);
  const int first = scan_tile_prefix(status, tile, total);
  const int o = first + excl;
  const int4 out = make_int4(o, o + c.x, o + c.x + c.y, o + c.x + c.y + c.z);
  if (i0 + SCAN_VEC <= n) {
    *reinterpret_cast<int4*>(off + i0) = out;
  } else if (i0 < n) {
    off[i0] = out.x;
    if (i0 + 1 < n) off[i0 + 1] = out.y;
    if (i0 + 2 < n) off[i0 + 2] = out.z;
  }
  if (tile == tiles - 1 && threadIdx.x == 0) off[n] = first + total;
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

__device__ __forceinline__ bool key_less(int64_t ta, int32_t ia, int64_t tb,
                                         int32_t ib) {
  return ta < tb || (ta == tb && ia < ib);
}

// Fold one candidate per lane (ci == I_NONE: none) into the warp's list:
// lane k < have holds the k-th smallest key so far, the other lanes the
// empty key.  ``s_t``/``s_i``: this warp's 32 shared entries.
__device__ __forceinline__ void warp_merge(int64_t ct, int32_t ci, int r,
                                           int64_t* s_t, int32_t* s_i,
                                           int64_t& top_t, int32_t& top_i,
                                           int& have) {
  const unsigned all = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  bool keep = ci != I_NONE;
  if (have == r) {
    const int64_t rt = __shfl_sync(all, top_t, r - 1);
    const int32_t ri = __shfl_sync(all, top_i, r - 1);
    keep = keep && key_less(ct, ci, rt, ri);
  }
  const unsigned kept = __ballot_sync(all, keep);
  if (!kept) return;
  if (!keep) {
    ct = T_NONE;
    ci = I_NONE;
  }
  // rank in the union: list entries and kept candidates below the key
  // (lanes past the last list entry and the last kept candidate hold
  // empty keys only)
  const unsigned held = have == 32 ? 0xffffffffu : (1u << have) - 1u;
  const int span = 32 - __clz(kept | held);
  int rank_c = 0;
  int rank_top = lane;
#pragma unroll 4
  for (int s = 0; s < span; ++s) {
    const int64_t ot = __shfl_sync(all, top_t, s);
    const int32_t oi = __shfl_sync(all, top_i, s);
    const int64_t nt = __shfl_sync(all, ct, s);
    const int32_t ni = __shfl_sync(all, ci, s);
    rank_c += key_less(ot, oi, ct, ci) + key_less(nt, ni, ct, ci);
    rank_top += key_less(nt, ni, top_t, top_i);
  }
  __syncwarp();
  if (keep && rank_c < r) {
    s_t[rank_c] = ct;
    s_i[rank_c] = ci;
  }
  if (lane < have && rank_top < r) {
    s_t[rank_top] = top_t;
    s_i[rank_top] = top_i;
  }
  __syncwarp();
  have = min(r, have + __popc(kept));
  top_t = lane < have ? s_t[lane] : T_NONE;
  top_i = lane < have ? s_i[lane] : I_NONE;
}

// Fold bucket entries [begin, end) into the warp's list: SEL_STEP
// consecutive entries per step (SEL_UNROLL loads per lane in flight),
// then ``stride`` entries on.
__device__ __forceinline__ void warp_fold(const int64_t* __restrict__ t,
                                          const int32_t* __restrict__ bucket,
                                          int begin, int end, int stride,
                                          int r, int64_t* s_t, int32_t* s_i,
                                          int64_t& top_t, int32_t& top_i,
                                          int& have) {
  const int lane = threadIdx.x & 31;
  for (int j0 = begin; j0 < end; j0 += stride) {
    int32_t ci[SEL_UNROLL];
    int64_t ct[SEL_UNROLL];
#pragma unroll
    for (int u = 0; u < SEL_UNROLL; ++u) {
      const int j = j0 + u * 32 + lane;
      ci[u] = j < end ? bucket[j] : I_NONE;
    }
#pragma unroll
    for (int u = 0; u < SEL_UNROLL; ++u)
      ct[u] = ci[u] != I_NONE ? t[ci[u]] : T_NONE;
#pragma unroll
    for (int u = 0; u < SEL_UNROLL; ++u)
      warp_merge(ct[u], ci[u], r, s_t, s_i, top_t, top_i, have);
  }
}

// The block's list of merged entries, sorted with empty keys last: the
// number of its entries below (mt, mi), by binary search.
__device__ __forceinline__ int count_below(const int64_t* s_t,
                                           const int32_t* s_i, int64_t mt,
                                           int32_t mi) {
  int lo = 0, hi = 32;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key_less(s_t[mid], s_i[mid], mt, mi))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// One grid of SEL_THREADS-thread blocks, each part grid-strided:
//   (1) entry k of row d is -1 where d has at most k due messages;
//   (2) every due message of a bucket of at most SMALL_BUCKET takes its
//       rank among its bucket's keys (and writes itself if it is < r);
//   (3) each block takes groups of SEL_THREADS destinations and selects
//       the larger buckets: a warp each up to BIG_BUCKET, above it the
//       block's 8 warps together, whose sorted lists are merged by rank.
// r <= SMALL_BUCKET, so rows of larger buckets are full.
__global__ void __launch_bounds__(SEL_THREADS)
    select_rows(const uint8_t* __restrict__ due,
                const int32_t* __restrict__ dst,
                const int64_t* __restrict__ t,
                const int32_t* __restrict__ off,
                const int32_t* __restrict__ bucket,
                int32_t* __restrict__ inbox,
                uint8_t* __restrict__ delivered, int n, int r, int p) {
  __shared__ int64_t s_t[SEL_THREADS];
  __shared__ int32_t s_i[SEL_THREADS];
  __shared__ int32_t s_mid[SEL_THREADS];
  __shared__ int32_t s_big[SEL_THREADS];
  __shared__ int s_n_mid, s_n_big;
  const int64_t stride = (int64_t)gridDim.x * SEL_THREADS;
  const int64_t tid = (int64_t)blockIdx.x * SEL_THREADS + threadIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int64_t e = tid; e < (int64_t)n * r; e += stride) {
    const int d = (int)(e / r);
    if (e - (int64_t)d * r >= off[d + 1] - off[d]) inbox[e] = -1;
  }

  for (int64_t i = tid; i < p; i += stride) {
    if (!due[i]) continue;
    const int d = dst[i];
    const int b = off[d], c = off[d + 1] - b;
    if (c > SMALL_BUCKET) continue;
    const int64_t ti = t[i];
    int rank = 0;
#pragma unroll 4
    for (int k = 0; k < c; ++k) {
      const int32_t o = bucket[b + k];
      rank += key_less(t[o], o, ti, (int32_t)i);
    }
    if (rank < r) {
      inbox[(int64_t)d * r + rank] = (int32_t)i;
      delivered[i] = 1;
    }
  }

  for (int g0 = blockIdx.x * SEL_THREADS; g0 < n;
       g0 += gridDim.x * SEL_THREADS) {
    const int d = g0 + threadIdx.x;
    const int c = d < n ? off[d + 1] - off[d] : 0;
    __syncthreads();  // the lists of the previous group are consumed
    if (threadIdx.x == 0) s_n_mid = s_n_big = 0;
    __syncthreads();
    if (c > BIG_BUCKET)
      s_big[atomicAdd(&s_n_big, 1)] = d;
    else if (c > SMALL_BUCKET)
      s_mid[atomicAdd(&s_n_mid, 1)] = d;
    __syncthreads();
    for (int k = warp; k < s_n_mid; k += SEL_WARPS) {
      const int dd = s_mid[k];
      int64_t top_t = T_NONE;
      int32_t top_i = I_NONE;
      int have = 0;
      warp_fold(t, bucket, off[dd], off[dd + 1], SEL_STEP, r,
                s_t + warp * 32, s_i + warp * 32, top_t, top_i, have);
      if (lane < r) {
        inbox[(int64_t)dd * r + lane] = top_i;
        delivered[top_i] = 1;
      }
    }
    for (int k = 0; k < s_n_big; ++k) {
      const int dd = s_big[k];
      int64_t top_t = T_NONE;
      int32_t top_i = I_NONE;
      int have = 0;
      __syncthreads();  // the shared lists are free
      warp_fold(t, bucket, off[dd] + warp * SEL_STEP, off[dd + 1],
                SEL_WARPS * SEL_STEP, r, s_t + warp * 32, s_i + warp * 32,
                top_t, top_i, have);
      __syncwarp();
      s_t[threadIdx.x] = top_t;
      s_i[threadIdx.x] = top_i;
      __syncthreads();
      // entry lane of warp's list: its rank among the 8 sorted lists
      if (top_i != I_NONE) {
        int rank = lane;
        for (int w = 0; w < SEL_WARPS; ++w)
          if (w != warp)
            rank += count_below(s_t + w * 32, s_i + w * 32, top_t, top_i);
        if (rank < r) {
          inbox[(int64_t)dd * r + rank] = top_i;
          delivered[top_i] = 1;
        }
      }
    }
  }
}

// gblk words [e0, e0 + 4) of ``total`` (< 2^31): word e is column e % w
// of gathered row e / w; a thread's words may span several rows where w
// is below 4.
__global__ void __launch_bounds__(GATHER_THREADS)
    gather_rows(const int32_t* __restrict__ inbox,
                const int32_t* __restrict__ blk, int32_t* __restrict__ gblk,
                unsigned total, unsigned w) {
  const unsigned e0 =
      GATHER_WORDS * (blockIdx.x * GATHER_THREADS + threadIdx.x);
  if (e0 >= total) return;
  unsigned row = e0 / w;
  unsigned col = e0 - row * w;
  const int32_t* src = blk + (size_t)max(inbox[row], 0) * w;
  int32_t v[GATHER_WORDS];
#pragma unroll
  for (int j = 0; j < GATHER_WORDS; ++j) {
    const bool here = e0 + j < total;
    if (col == w) {
      ++row;
      col = 0;
      if (here) src = blk + (size_t)max(inbox[row], 0) * w;
    }
    v[j] = here ? src[col] : 0;
    ++col;
  }
  if (e0 + GATHER_WORDS <= total && (((uintptr_t)(gblk + e0)) & 15) == 0) {
    *reinterpret_cast<int4*>(gblk + e0) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < GATHER_WORDS; ++j)
      if (e0 + j < total) gblk[e0 + j] = v[j];
  }
}

// select_rows' grid: as many blocks as the card holds at once, fewer
// where the work is smaller (the card's numbers are read once).
static int select_grid(int n, int r, int p) {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, select_rows,
                                                  SEL_THREADS, 0);
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int64_t work = max((int64_t)n * r, (int64_t)p);
  const int64_t need = (work + SEL_THREADS - 1) / SEL_THREADS;
  return (int)(need < resident ? (need > 0 ? need : 1) : resident);
}

// Steps (a)-(d): one memset and four kernels.  scratch: see the head
// comment.
static int launch_select(const uint8_t* due, const int32_t* dst,
                         const int64_t* t, int32_t* inbox,
                         uint8_t* delivered, int32_t* scratch, int n, int r,
                         int p, cudaStream_t stream) {
  if (r < 1 || r > MAX_R || n < 1 || p < 0) return (int)cudaErrorInvalidValue;
  const int n4 = (n + 4) & ~3;
  const int tiles = (n + SCAN_TILE - 1) / SCAN_TILE;
  int32_t* cnt = scratch;
  int32_t* cur = cnt + n4;
  int* tile_counter = cur + n4;
  unsigned long long* status = (unsigned long long*)(tile_counter + 4);
  int32_t* off = tile_counter + 4 * (tiles + 1);
  int32_t* bucket = off + n4;
  cudaMemsetAsync(cnt, 0, sizeof(int32_t) * (2 * n4 + 4 * (tiles + 1)),
                  stream);
  const int tb = 256;
  if (p > 0)
    count_due<<<(p + tb - 1) / tb, tb, 0, stream>>>(due, dst, cnt, delivered,
                                                    p);
  scan_counts<<<tiles, SCAN_THREADS, 0, stream>>>(cnt, off, tile_counter,
                                                  status, n, tiles);
  if (p > 0)
    fill_buckets<<<(p + tb - 1) / tb, tb, 0, stream>>>(due, dst, off, cur,
                                                       bucket, p);
  select_rows<<<select_grid(n, r, p), SEL_THREADS, 0, stream>>>(
      due, dst, t, off, bucket, inbox, delivered, n, r, p);
  return (int)cudaGetLastError();
}

extern "C" int inbox_select(const uint8_t* due, const int32_t* dst,
                            const int64_t* t, int32_t* inbox,
                            uint8_t* delivered, int32_t* scratch, int n,
                            int r, int p, void* stream_ptr) {
  return launch_select(due, dst, t, inbox, delivered, scratch, n, r, p,
                       (cudaStream_t)stream_ptr);
}

// Step (e): one kernel.
static int launch_gather(const int32_t* inbox, const int32_t* blk,
                         int32_t* gblk, int n, int r, int w,
                         cudaStream_t stream) {
  const int64_t total = (int64_t)n * r * w;
  if (n < 0 || r < 1 || w < 1 || total >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  const int64_t words = GATHER_THREADS * GATHER_WORDS;
  if (total > 0)
    gather_rows<<<(unsigned)((total + words - 1) / words), GATHER_THREADS, 0,
                  stream>>>(inbox, blk, gblk, (unsigned)total, (unsigned)w);
  return (int)cudaGetLastError();
}

extern "C" int inbox_gather(const int32_t* inbox, const int32_t* blk,
                            int32_t* gblk, int n, int r, int w,
                            void* stream_ptr) {
  return launch_gather(inbox, blk, gblk, n, r, w, (cudaStream_t)stream_ptr);
}

extern "C" int inbox_select_gather(const uint8_t* due, const int32_t* dst,
                                   const int64_t* t, const int32_t* blk,
                                   int32_t* inbox, uint8_t* delivered,
                                   int32_t* gblk, int32_t* scratch, int n,
                                   int r, int p, int w, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (w < 1 || (int64_t)n * r * w >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  const int code = launch_select(due, dst, t, inbox, delivered, scratch, n,
                                 r, p, stream);
  if (code != 0) return code;
  return launch_gather(inbox, blk, gblk, n, r, w, stream);
}
