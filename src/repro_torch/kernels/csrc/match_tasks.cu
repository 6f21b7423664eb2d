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
// walking a 50k-lane row alone is latency-bound (about 40 us for one
// 50,000-lane row on an H100), so here the row is split into tiles of kTile
// lanes, one block each, joined by a single-pass decoupled look-back scan
// (lookback.cuh):
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
// Status words (lookback.cuh) carry an epoch: each launch takes a new one
// from the wrapper, so the scratch is never cleared between launches.

#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = kThreads * kItems;   // 2048 lanes per block
constexpr int kWarps = kThreads / 32;

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
  int v[kItems];
  load_items(avail, first, w, vec_aligned(avail), v);
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) sum += v[k];
  int aggregate;
  const int thread_excl = block_exclusive_scan<kWarps>(sum, lane, warp, warp_scan, aggregate);

  // 2. decoupled look-back (warp 0): the sum over earlier tiles, or a lower
  // bound of it that already reaches n
  if (warp == 0) {
    const int excl = lookback(status, tile, aggregate, n, epoch, lane);
    if (lane == 0) tile_excl = excl;
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
    store_items(out, first, w, vec_aligned(out), r);
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
