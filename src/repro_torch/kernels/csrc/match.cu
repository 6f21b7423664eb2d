// Rank-and-select over the rows of an availability matrix, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_match_kernel_batched` in
// src/repro/kernels/match.py:31 (wrapper `match_ranks_batched`, :56).
//
// For each row g of avail[G, W] (bool, int8 or int32) and n = n_tasks[g]:
//   rank[i]   = (avail[g, 0] + ... + avail[g, i]) - 1          (int32)
//   out[g, i] = rank[i]  where avail[g, i] > 0 and rank[i] < n, else -1.
// Availability values are flags (0/1, or at least non-negative): the early
// exit below relies on the running sum never falling.
//
// What bounds it on an H100: bytes.  It reads each input lane once and
// writes one int32 per lane, G*W*(sizeof(T) + 4) + 4*G bytes, with one add
// per lane.  At the shapes it serves (bool input):
//   [8, 49984]  (megha borrow)     1,999,392 B -> 0.60 us at 3.35 TB/s
//   [8, 6248]   (megha internal)     249,952 B -> 0.075 us
//   [1, 50000]  (oracle)             250,004 B -> 0.075 us
//   [50000, 64] (sparrow/eagle pick) 16,200,000 B -> 4.8 us
//
// Design.  The TPU kernel walks each row's tiles in grid order and carries
// the running count in SMEM from one grid step to the next; Hopper runs
// blocks in no order, so nothing carries between them, and a row per block
// would leave most of the 132 SMs idle at G = 8 or G = 1.  The wrapper picks
// one of two designs by row width:
//   wide rows (W > kNarrowLanes): each row is split into tiles of kTile
//     lanes, one block each, on a grid (tiles, G), so the blocks of a row
//     are dispatched in tile order.  A block loads its tile (8 consecutive
//     lanes per thread, one vector load where aligned), scans it, and joins
//     the row's earlier tiles through the single-pass decoupled look-back
//     of lookback.cuh over the row's own status words (laid out [G, tiles],
//     epoch-tagged, so no memset between launches).  Once the gathered
//     prefix reaches n, the tile writes -1 over its whole tile (an early
//     exit per row).  Ranks go out as int4 stores.
//   narrow rows (W <= kNarrowLanes = 256): one warp per floor(256 / W)
//     whole rows, read as one run of lanes, 8 consecutive a thread (so at
//     R = 64 every lane of the warp holds flags, four rows at once).  One
//     segmented warp scan, cut at each row start, gives the ranks: no
//     look-back, no scratch.
// Both read bool (as uint8), int8 or int32 directly and mask the ragged
// edge themselves: no padded copy of the input.
//
// kTile is 2,048 lanes: on an H100 it beat 1,024 at both megha shapes
// (PERF.md, "Tile size").

#include "lookback.cuh"

namespace {

constexpr int kTile = 2048;                // lanes per block of a wide row
constexpr int kThreads = kTile / kItems;
constexpr int kWarps = kThreads / 32;
static_assert(kTile % (32 * kItems) == 0 && kThreads <= 1024,
              "a wide tile is whole warps of kItems lanes, at most 1024 threads");
constexpr int kNarrowLanes = 32 * kItems;  // widest row of the narrow design
constexpr int kNarrowWarps = 8;            // warps per narrow block
constexpr int kMaxGridY = 65535;           // rows per wide launch

template <typename T>
__global__ void __launch_bounds__(kThreads)
match_batched_wide_kernel(const T* __restrict__ avail,
                          const int* __restrict__ n_tasks,
                          int* __restrict__ out, int w,
                          unsigned long long* __restrict__ status,
                          unsigned epoch) {
  __shared__ int warp_scan[kWarps];
  __shared__ int tile_excl;
  const int tile = blockIdx.x;
  const size_t g = blockIdx.y;
  const T* row = avail + g * w;
  int* orow = out + g * w;
  const int n = n_tasks[g];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // this tile's lanes, their per-thread sums and the tile's scan
  const int first = tile * kTile + threadIdx.x * kItems;
  int v[kItems];
  load_items(row, first, w, vec_aligned(row), v);
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) sum += v[k];
  int aggregate;
  const int thread_excl = block_exclusive_scan<kWarps>(sum, lane, warp, warp_scan, aggregate);

  // the sum over the row's earlier tiles, or a lower bound that reaches n
  if (warp == 0) {
    const int excl = lookback(status + g * gridDim.x, tile, aggregate, n, epoch, lane);
    if (lane == 0) tile_excl = excl;
  }
  __syncthreads();
  const int excl = tile_excl;

  int running = excl + thread_excl;  // lanes before `first`
  int r[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    running += v[k];
    const int rank = running - 1;
    r[k] = (excl < n && v[k] > 0 && rank < n) ? rank : -1;
  }
  store_items(orow, first, w, vec_aligned(orow), r);
}

template <typename T>
__global__ void __launch_bounds__(kNarrowWarps * 32)
match_batched_narrow_kernel(const T* __restrict__ avail,
                            const int* __restrict__ n_tasks,
                            int* __restrict__ out, int g_rows, int w) {
  const int lane = threadIdx.x & 31;
  const int rows_per_warp = kNarrowLanes / w;
  const int g0 = (blockIdx.x * kNarrowWarps + (threadIdx.x >> 5)) * rows_per_warp;
  if (g0 >= g_rows) return;  // the whole warp: its shuffles stay full
  // this warp's rows as one run of `span` lanes, 8 consecutive a thread
  const int span = min(rows_per_warp, g_rows - g0) * w;
  const size_t base = static_cast<size_t>(g0) * w;
  const int first = lane * kItems;
  int v[kItems];
  load_items(avail + base, first, span, vec_aligned(avail + base), v);

  // the thread's sum since its last row start, and whether it holds one
  int col = first % w;
  int seg = 0;
  bool start = false;
#pragma unroll
  for (int k = 0, c = col; k < kItems; ++k, c = c + 1 == w ? 0 : c + 1) {
    if (c == 0) { seg = 0; start = true; }
    seg += v[k];
  }
  // segmented inclusive scan over the warp: a row start cuts the sum off
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(kFull, seg, d);
    const bool up_start = __shfl_up_sync(kFull, start, d);
    if (lane >= d) {
      if (!start) seg += up;
      start = start || up_start;
    }
  }
  int running = __shfl_up_sync(kFull, seg, 1);  // the row's lanes before `first`
  if (lane == 0) running = 0;

  int row = first / w;
  int r[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (col == 0) running = 0;
    running += v[k];
    const int rank = running - 1;
    r[k] = (first + k < span && v[k] > 0 && rank < __ldg(&n_tasks[g0 + row])) ? rank : -1;
    if (++col == w) { col = 0; ++row; }
  }
  store_items(out + base, first, span, vec_aligned(out + base), r);
}

template <typename T>
void launch_wide(const void* avail, const int* n_tasks, int* out, int g, int w,
                 unsigned long long* status, unsigned epoch, cudaStream_t stream) {
  const int tiles = (w + kTile - 1) / kTile;
  const T* a = static_cast<const T*>(avail);
  for (int g0 = 0; g0 < g; g0 += kMaxGridY) {
    const dim3 grid(tiles, g - g0 < kMaxGridY ? g - g0 : kMaxGridY);
    const size_t off = static_cast<size_t>(g0) * w;
    match_batched_wide_kernel<T><<<grid, kThreads, 0, stream>>>(
        a + off, n_tasks + g0, out + off, w,
        status + static_cast<size_t>(g0) * tiles, epoch);
  }
}

template <typename T>
void launch_narrow(const void* avail, const int* n_tasks, int* out, int g, int w,
                   cudaStream_t stream) {
  const int rows_per_block = kNarrowWarps * (kNarrowLanes / w);
  const int blocks = (g + rows_per_block - 1) / rows_per_block;
  match_batched_narrow_kernel<T><<<blocks, kNarrowWarps * 32, 0, stream>>>(
      static_cast<const T*>(avail), n_tasks, out, g, w);
}

}  // namespace

// Lanes per block of a wide row (the wrapper sizes the status words by it).
extern "C" int match_batched_tile_lanes() { return kTile; }

// Both entry points: dtype 0 = bool (read as uint8), 1 = int8, 2 = int32;
// avail [g, w] and out [g, w] contiguous, n_tasks int32[g], all on the
// device; g, w >= 1.  They launch on `stream` without synchronising and
// return cudaGetLastError() (0 = the launch was accepted).
//
// Wide design.  status: at least g * ceil(w / kTile) 64-bit words, zeroed
// before the first launch; epoch: 1 .. 2^30 - 1, a new one per launch.
extern "C" int match_batched_wide_launch(const void* avail, int dtype,
                                         const void* n_tasks, void* out, int g,
                                         int w, void* status, unsigned epoch,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* n = static_cast<const int*>(n_tasks);
  int* o = static_cast<int*>(out);
  unsigned long long* st = static_cast<unsigned long long*>(status);
  switch (dtype) {
    case 0: launch_wide<uint8_t>(avail, n, o, g, w, st, epoch, s); break;
    case 1: launch_wide<int8_t>(avail, n, o, g, w, st, epoch, s); break;
    case 2: launch_wide<int32_t>(avail, n, o, g, w, st, epoch, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Narrow design: w <= kNarrowLanes (256), else cudaErrorInvalidValue.
extern "C" int match_batched_narrow_launch(const void* avail, int dtype,
                                           const void* n_tasks, void* out,
                                           int g, int w, void* stream) {
  if (w > kNarrowLanes) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* n = static_cast<const int*>(n_tasks);
  int* o = static_cast<int*>(out);
  switch (dtype) {
    case 0: launch_narrow<uint8_t>(avail, n, o, g, w, s); break;
    case 1: launch_narrow<int8_t>(avail, n, o, g, w, s); break;
    case 2: launch_narrow<int32_t>(avail, n, o, g, w, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
