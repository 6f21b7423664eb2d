// Pieces shared by the rank-and-select kernels (match.cu, match_tasks.cu):
// the 64-bit status words of the decoupled look-back, the vectorised lane
// loads and rank stores, and the warp scans.
//
// A status word is epoch (30 bits) | flag (2 bits) | value (32 bits),
// written and read as one relaxed GPU-scope access, so flag and value always
// arrive together.  A word whose epoch is not the launch's own reads as "not
// yet published"; the wrapper zeroes the words once and when the epoch
// wraps, never between launches.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kItems = 8;  // consecutive lanes per thread
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

// Whether kItems lanes of T starting at an address can be loaded as one
// vector (8 bytes of 1-byte lanes, or 2 x 16 bytes of int32).
template <typename T>
__device__ __forceinline__ bool vec_aligned(const T* p) {
  return reinterpret_cast<uintptr_t>(p) % (sizeof(T) == 1 ? 8 : 16) == 0;
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

// The exclusive prefix of each thread's `sum` within a block of kWarps
// warps, and the block's total in `aggregate`: a warp scan, then one warp
// scans the warp totals in `warp_scan` (shared, kWarps ints).
template <int kWarps>
__device__ __forceinline__ int block_exclusive_scan(int sum, int lane, int warp,
                                                    int* warp_scan, int& aggregate) {
  static_assert(kWarps <= 32, "one warp scans the warp totals");
  const int incl = warp_inclusive_scan(sum, lane);
  if (lane == 31) warp_scan[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int t = lane < kWarps ? warp_scan[lane] : 0;
    t = warp_inclusive_scan(t, lane);
    if (lane < kWarps) warp_scan[lane] = t;
  }
  __syncthreads();
  aggregate = warp_scan[kWarps - 1];
  return (warp == 0 ? 0 : warp_scan[warp - 1]) + incl - sum;
}

// The decoupled look-back of tile `tile` over status[0 .. tile], run by
// one whole warp.  It publishes the tile's aggregate, then reads the earlier
// tiles' words 32 at a time, summing aggregates until it meets a tile that
// has published its inclusive prefix, and publishes its own prefix.  It
// stops early once the sum reaches n: values are non-negative, so no lane
// of this tile or a later one can then be selected, and the tile publishes
// that lower bound (>= n) as its prefix.  A published prefix is therefore
// exact when it is below n, and at least n otherwise.  Returns the sum over
// the earlier tiles (or that lower bound) to every lane.  Tiles wait only on
// tiles of lower index, which the hardware dispatches first.
__device__ __forceinline__ int lookback(unsigned long long* __restrict__ status,
                                        int tile, int aggregate, int n,
                                        unsigned epoch, int lane) {
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
  if (lane == 0) store_status(&status[tile], pack(epoch, kFlagPrefix, excl + aggregate));
  return excl;
}

}  // namespace
