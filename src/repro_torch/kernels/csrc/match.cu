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
// per lane.  At the main path's shapes (bool input):
//   [8, 49984] (megha borrow)    1,999,392 B -> 0.60 us at 3.35 TB/s
//   [8, 6248]  (megha internal)    249,952 B -> 0.075 us
//   [1, 49984] (oracle)            249,924 B -> 0.075 us
//
// Design.  The TPU kernel walks each row's tiles in grid order and carries
// the running count in SMEM from one grid step to the next; Hopper runs
// blocks in no order, so nothing carries between them.  Here one block owns
// one row and walks it in tiles of kTile lanes: each thread sums kItems
// consecutive lanes, a warp scan (__shfl_up_sync) and a scan of the warp
// totals in shared memory give every thread its exclusive prefix, and the
// row's running count stays in a register.  Once that count reaches n no
// later lane can be taken, so the rest of the row is written as -1 without
// scanning.  The kernel reads bool (as uint8), int8 or int32 directly and
// masks the ragged edge itself: no padded copy of the input.
//
// Later work: a row per block leaves most SMs idle at G = 8 or G = 1.
// Splitting a wide row across blocks with a decoupled look-back scan (and
// wider, vectorised loads) is the route to the byte bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kItems = 8;                  // consecutive lanes per thread
constexpr int kTile = kThreads * kItems;   // lanes per step of the row loop
constexpr int kWarps = kThreads / 32;
static_assert(kWarps <= 32, "one warp scans the warp totals");

template <typename T>
__global__ void __launch_bounds__(kThreads)
match_ranks_batched_kernel(const T* __restrict__ avail,
                           const int* __restrict__ n_tasks,
                           int* __restrict__ out, int w) {
  __shared__ int warp_scan[kWarps];
  const int g = blockIdx.x;
  const T* row = avail + static_cast<size_t>(g) * w;
  int* orow = out + static_cast<size_t>(g) * w;
  const int n = n_tasks[g];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int carry = 0;  // sum over lanes [0, base): the same value in every thread

  for (int base = 0; base < w; base += kTile) {
    if (carry >= n) {
      // every free lane from here on has rank >= carry >= n
      for (int i = base + threadIdx.x; i < w; i += kThreads) orow[i] = -1;
      return;
    }
    const int first = base + threadIdx.x * kItems;
    int v[kItems];
    int sum = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = first + k;
      v[k] = i < w ? static_cast<int>(row[i]) : 0;
      sum += v[k];
    }
    // inclusive scan of the per-thread sums within each warp
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += up;
    }
    if (lane == 31) warp_scan[warp] = incl;
    __syncthreads();
    // one warp turns the warp totals into their inclusive scan
    if (warp == 0) {
      int t = lane < kWarps ? warp_scan[lane] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, t, d);
        if (lane >= d) t += up;
      }
      if (lane < kWarps) warp_scan[lane] = t;
    }
    __syncthreads();
    const int warp_excl = warp == 0 ? 0 : warp_scan[warp - 1];
    const int tile_sum = warp_scan[kWarps - 1];
    int running = carry + warp_excl + (incl - sum);  // lanes before `first`
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = first + k;
      running += v[k];
      if (i < w) {
        const int rank = running - 1;
        orow[i] = (v[k] > 0 && rank < n) ? rank : -1;
      }
    }
    carry += tile_sum;
    __syncthreads();  // warp_scan is rewritten by the next tile
  }
}

template <typename T>
void launch(const void* avail, const void* n_tasks, void* out, int g, int w,
            cudaStream_t stream) {
  match_ranks_batched_kernel<T><<<g, kThreads, 0, stream>>>(
      static_cast<const T*>(avail), static_cast<const int*>(n_tasks),
      static_cast<int*>(out), w);
}

}  // namespace

// dtype: 0 = bool (read as uint8), 1 = int8, 2 = int32.  Launches on
// `stream` without synchronising and returns cudaGetLastError() (0 = the
// launch was accepted).
extern "C" int match_ranks_batched_launch(const void* avail, int dtype,
                                          const void* n_tasks, void* out,
                                          int g, int w, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: launch<uint8_t>(avail, n_tasks, out, g, w, s); break;
    case 1: launch<int8_t>(avail, n_tasks, out, g, w, s); break;
    case 2: launch<int32_t>(avail, n_tasks, out, g, w, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
