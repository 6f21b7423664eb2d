// Single-row rank-and-select, with the inverse scatter fused in, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_match_kernel` in src/repro/kernels/match.py:97
// (wrapper `match_ranks`, :117) and, in the fused entry point, the XLA
// inverse scatter and count that `ops.match_tasks` runs after it
// (src/repro/kernels/ops.py:43-56).
//
// Over one row avail[W] (bool, int8 or int32 flags, 0 or 1) and a count n:
//   rank[i] = (avail[0] + ... + avail[i]) - 1                     (int32)
//   lane i is selected when avail[i] > 0 and rank[i] < n.
// Entry points:
//   ranks  (fused = 0): out[i] = rank[i] for a selected lane, else -1;
//                       int32[W].
//   tasks  (fused = 1): n is clamped to [0, max_tasks]; every selected lane
//                       writes its position i to out[rank[i]], the tail
//                       [placed, max_tasks) is -1, *placed = number of
//                       selected lanes; int32[max_tasks] and int32[1].
// n is passed by value, or read from an int32 on the device (n_ptr != 0):
// never from the host after a copy.
//
// What bounds it on an H100: at the serving path's shapes, launch latency.
// The bytes are few: the ranks entry point reads W lanes and writes 4W
// bytes; the tasks entry point needs only the lanes up to the n-th free one
// and writes 4 * max_tasks + 4 bytes (about 52 kB at W = 49,984,
// max_tasks = 512 if every lane is read: 0.016 us at 3.35 TB/s).
//
// Design.  The TPU kernel walks the row's blocks in grid order and carries
// the running count in SMEM from one block to the next.  On Hopper one block
// walking a 50k-lane row alone is latency-bound (the batched kernel in
// match.cu takes about 40 us for [1, 50000]), so here the row is split into
// tiles of kTile lanes, one block each, joined by a single-pass decoupled
// look-back scan:
//   1. each block loads its tile (8 consecutive lanes per thread, one
//      vector load where aligned), scans it (warp shuffles, then a scan of
//      the warp totals) and publishes its aggregate;
//   2. warp 0 then looks back over the earlier tiles' status words, 32 at a
//      time, summing aggregates until it meets a tile that has published
//      its inclusive prefix, and publishes its own;
//   3. every thread ranks its lanes from that prefix and writes.
// Early exit: the look-back stops as soon as the sum it has gathered
// reaches n, because no lane of this tile or any later one can then be
// selected; such a tile publishes that lower bound (which is >= n) as its
// prefix and ranks nothing.  A published prefix is therefore exact when it
// is below n, and at least n otherwise, which is all that later tiles and
// `placed` = min(n, prefix of the last tile) need.  With 0/1 flags the
// selected ranks are exactly 0 .. placed-1, so the last tile alone fills
// the tail [placed, max_tasks) with -1 and no write races another.
//
// Status words are 64-bit: epoch (30 bits) | flag (2 bits) | value (32
// bits), written and read as single relaxed GPU-scope accesses, so flag and
// value always arrive together.  Each launch takes a new epoch from the
// wrapper, and a word of an older epoch reads as "not yet published", so
// the scratch is never cleared between launches (the wrapper zeroes it once
// when it is allocated and when the epoch wraps).  Tiles wait only on tiles
// of lower index, which the hardware dispatches first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                  // consecutive lanes per thread
constexpr int kTile = kThreads * kItems;   // 2048 lanes per block
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kFlagAggregate = 1u;
constexpr unsigned kFlagPrefix = 2u;

__device__ __forceinline__ unsigned long long pack(unsigned epoch, unsigned flag,
                                                   int value) {
  return (static_cast<unsigned long long>(epoch) << 34) |
         (static_cast<unsigned long long>(flag) << 32) |
         static_cast<unsigned int>(value);
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// kItems lanes from `first`, as int32 (bool as uint8, int8 sign-extended);
// lanes at or past w read as 0.
template <typename T>
__device__ __forceinline__ void load_items(const T* __restrict__ a, int first,
                                           int w, bool vec_ok, int (&v)[kItems]) {
  if (vec_ok && first + kItems <= w) {
    if constexpr (sizeof(T) == 1) {
      const uint2 raw = *reinterpret_cast<const uint2*>(a + first);
      const T* b = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < kItems; ++k) v[k] = static_cast<int>(b[k]);
    } else {
      const int4* p = reinterpret_cast<const int4*>(a + first);
      const int4 r0 = p[0], r1 = p[1];
      v[0] = r0.x; v[1] = r0.y; v[2] = r0.z; v[3] = r0.w;
      v[4] = r1.x; v[5] = r1.y; v[6] = r1.z; v[7] = r1.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = first + k;
      v[k] = i < w ? static_cast<int>(a[i]) : 0;
    }
  }
}

__device__ __forceinline__ void store_items(int* __restrict__ out, int first,
                                            int w, bool vec_ok,
                                            const int (&r)[kItems]) {
  if (vec_ok && first + kItems <= w) {
    int4* p = reinterpret_cast<int4*>(out + first);
    p[0] = make_int4(r[0], r[1], r[2], r[3]);
    p[1] = make_int4(r[4], r[5], r[6], r[7]);
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (first + k < w) out[first + k] = r[k];
  }
}

__device__ __forceinline__ int warp_inclusive_scan(int x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += up;
  }
  return x;
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(kFull, x, d);
  return x;
}

template <typename T, bool kFused>
__global__ void __launch_bounds__(kThreads)
match_single_kernel(const T* __restrict__ avail, int w,
                    const int* __restrict__ n_ptr, int n_val, int max_tasks,
                    int* __restrict__ out, int* __restrict__ placed,
                    unsigned long long* __restrict__ status, unsigned epoch) {
  __shared__ int warp_scan[kWarps];
  __shared__ int tile_excl;
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int n = n_ptr != nullptr ? *n_ptr : n_val;
  if (kFused) n = min(n, max_tasks);
  n = max(n, 0);

  // 1. this tile's lanes, their per-thread sums and the tile's scan
  const int first = tile * kTile + threadIdx.x * kItems;
  const bool in_vec = reinterpret_cast<uintptr_t>(avail) % (sizeof(T) == 1 ? 8 : 16) == 0;
  int v[kItems];
  load_items(avail, first, w, in_vec, v);
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) sum += v[k];
  const int incl = warp_inclusive_scan(sum, lane);
  if (lane == 31) warp_scan[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int t = lane < kWarps ? warp_scan[lane] : 0;
    t = warp_inclusive_scan(t, lane);
    if (lane < kWarps) warp_scan[lane] = t;
  }
  __syncthreads();
  const int aggregate = warp_scan[kWarps - 1];
  const int thread_excl = (warp == 0 ? 0 : warp_scan[warp - 1]) + incl - sum;

  // 2. decoupled look-back (warp 0): the sum over earlier tiles, or a lower
  // bound of it that already reaches n
  if (warp == 0) {
    int excl = 0;
    if (tile > 0) {
      if (lane == 0) store_status(&status[tile], pack(epoch, kFlagAggregate, aggregate));
      int look = tile - 1;  // the nearest tile of the current window
      while (excl < n) {
        const int j = look - lane;
        unsigned long long s;
        unsigned flag;
        do {
          s = j >= 0 ? load_status(&status[j]) : pack(epoch, kFlagPrefix, 0);
          flag = (s >> 34) == epoch ? static_cast<unsigned>(s >> 32) & 3u : 0u;
        } while (__any_sync(kFull, flag == 0u));
        const unsigned prefix_lanes = __ballot_sync(kFull, flag == kFlagPrefix);
        // lanes up to the nearest published prefix contribute
        const int stop = prefix_lanes ? __ffs(prefix_lanes) - 1 : 31;
        excl += warp_sum(lane <= stop ? static_cast<int>(static_cast<unsigned>(s)) : 0);
        if (prefix_lanes) break;
        look -= 32;
      }
    }
    if (lane == 0) {
      store_status(&status[tile], pack(epoch, kFlagPrefix, excl + aggregate));
      tile_excl = excl;
    }
  }
  __syncthreads();
  const int excl = tile_excl;

  // 3. rank the lanes and write
  int running = excl + thread_excl;  // lanes before `first`
  if (!kFused) {
    int r[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      running += v[k];
      const int rank = running - 1;
      r[k] = (excl < n && v[k] > 0 && rank < n) ? rank : -1;
    }
    const bool out_vec = reinterpret_cast<uintptr_t>(out) % 16 == 0;
    store_items(out, first, w, out_vec, r);
  } else {
    if (excl < n) {
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        running += v[k];
        const int rank = running - 1;
        if (v[k] > 0 && rank < n) out[rank] = first + k;
      }
    }
    if (tile == static_cast<int>(gridDim.x) - 1) {
      const int p = min(n, excl + aggregate);
      if (threadIdx.x == 0) *placed = p;
      for (int i = p + threadIdx.x; i < max_tasks; i += kThreads) out[i] = -1;
    }
  }
}

template <typename T>
void launch(bool fused, const void* avail, int w, const int* n_ptr, int n_val,
            int max_tasks, int* out, int* placed, unsigned long long* status,
            unsigned epoch, cudaStream_t stream) {
  const int tiles = (w + kTile - 1) / kTile;
  const T* a = static_cast<const T*>(avail);
  if (fused)
    match_single_kernel<T, true><<<tiles, kThreads, 0, stream>>>(
        a, w, n_ptr, n_val, max_tasks, out, placed, status, epoch);
  else
    match_single_kernel<T, false><<<tiles, kThreads, 0, stream>>>(
        a, w, n_ptr, n_val, max_tasks, out, placed, status, epoch);
}

}  // namespace

// Lanes per tile: the wrapper sizes the status scratch as ceil(w / this).
extern "C" int match_single_tile_lanes() { return kTile; }

// dtype: 0 = bool (read as uint8), 1 = int8, 2 = int32.  n_ptr: an int32 on
// the device, or null to use n_val.  fused: 0 = ranks into out[w], 1 =
// assignment into out[max_tasks] and the count into *placed.  status: at
// least ceil(w / kTile) 64-bit words, zeroed before the first launch;
// epoch: 1 .. 2^30 - 1, a new one per launch.  Requires w >= 1.  Launches
// on `stream` without synchronising and returns cudaGetLastError() (0 = the
// launch was accepted).
extern "C" int match_single_launch(const void* avail, int dtype, int w,
                                   const void* n_ptr, int n_val, int max_tasks,
                                   int fused, void* out, void* placed,
                                   void* status, unsigned epoch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* np = static_cast<const int*>(n_ptr);
  int* o = static_cast<int*>(out);
  int* p = static_cast<int*>(placed);
  unsigned long long* st = static_cast<unsigned long long*>(status);
  switch (dtype) {
    case 0: launch<uint8_t>(fused != 0, avail, w, np, n_val, max_tasks, o, p, st, epoch, s); break;
    case 1: launch<int8_t>(fused != 0, avail, w, np, n_val, max_tasks, o, p, st, epoch, s); break;
    case 2: launch<int32_t>(fused != 0, avail, w, np, n_val, max_tasks, o, p, st, epoch, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
