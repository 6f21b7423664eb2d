// Passes over the reservation queues of the sparrow and eagle rules, for
// Hopper (sm_90a).
//
// These kernels replace no TPU kernel.  The JAX package leaves the queue
// passes of src/repro/simx/sparrow.py (compact_queues, the active mask,
// queue_head_pick) and src/repro/simx/faults.py (jobs_with_reservation) to
// XLA, which fuses their element-wise chains into a few loops.  Eager
// PyTorch ran each link of those chains as a pass of its own over the whole
// queue, about thirty a round; here each entry point is one pass.
//
// The queues are resq int32[P, W, R]: P points, W workers, R slots, entries
// in [0, J], the job id J meaning empty.  Every result depends only on the
// entry's own row and on its point's job table int32[P, J + 1]:
//   queue_compact: an entry lives where job < J and table[p, job] > 0; the
//     live entries slide to the front of their row in order, the rest of the
//     row is J, and fill[p, w] is the row's live count.
//   queue_scan: active[p, w, i] = job < J && table[p, job] > 0 && row_mask[p, w]
//     (row_mask optional); has_res[p, j] = 1 where an entry of point p on a
//     worker not dead[p, w] (dead optional) holds job j < J.  The caller
//     zeroes has_res.
//   queue_head: head[p, w] = resq[p, w, i] at the first lane i of the row
//     whose rank (ranks int32[P, W, R], the n = 1 pick's output) is 0, else J.
//
// What bounds them on an H100: bytes.  Each reads the queue (or the ranks)
// once and writes one value per entry (queue_head one per row).  At the
// benchmark's [16, 50000, 40] (128,000,000 B of queue), at 3.35 TB/s:
//   queue_compact  128.0 MB in, 128.0 + 3.2 MB out   77.4 us
//   queue_scan     128.0 MB in,  32.0 MB out          47.8 us
//   queue_head     128.0 MB in (ranks) + 3.2 MB (the picked entries),
//                  3.2 MB out                         40.1 us
//
// Design.  A group of G lanes (8, 16 or 32, dividing the warp) holds one row
// in registers, lane k of the group the slots k, k + G, ..., at most
// kMaxItems of them (so R <= 8 G <= 256).  The wrapper's launch picks the G
// that wastes the fewest lanes on R (R = 40: G = 8, five slots a lane, four
// rows a warp).  Within the group, __ballot_sync and __popc give each live
// entry its place among the live entries before it, so compaction keeps the
// order with no scan through memory.  A block's rows all belong to one point
// (grid (blocks, P)), so it stages the point's table in shared memory once:
// no per-entry gather from device memory.  has_res is gathered in a bitmap
// in shared memory, each bit tested before it is set (a job seen again costs
// no atomic), and leaves the block as one byte store per job it holds: no
// per-entry write to device memory.  Each warp loads kTrips row sets before
// it uses any, to keep enough bytes in flight.  A table too large for 48 KB
// of shared memory is read from device memory instead (through L1), and
// has_res is then written per entry, each byte tested first.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxItems = 8;               // slots a lane holds
constexpr int kMaxLanes = 32 * kMaxItems;  // widest row: 256
constexpr int kTrips = 2;                  // row sets a warp loads at once
constexpr int kBlocksPerSm = 8;            // 2,048 threads an SM
constexpr int kSmemLimit = 48 * 1024;      // without an opt-in
constexpr int kMaxGridY = 65535;

// The lanes of this thread's group of G within its warp.
template <int G>
struct Group {
  int sub;         // lane within the group
  int idx;         // group within the warp
  unsigned mask;   // the group's lanes in a warp ballot
  unsigned below;  // the group's lanes below this one
  __device__ Group() {
    const int lane = threadIdx.x & 31;
    sub = lane % G;
    idx = lane / G;
    mask = G == 32 ? kFull : ((1u << (G % 32)) - 1u) << (idx * G);
    below = mask & ((1u << lane) - 1u);
  }
};

// The row sets of one warp: set s is rows [s * 32 / G, (s + 1) * 32 / G) of
// the block's point, and warp k of the point's warps takes the sets k, k + n,
// k + 2n, ... (n the point's warps), kTrips of them a trip.
struct Walk {
  int first, step, sets;
  __device__ Walk(int w, int rows_per_set) {
    first = blockIdx.x * kWarps + (threadIdx.x >> 5);
    step = gridDim.x * kWarps;
    sets = (w + rows_per_set - 1) / rows_per_set;
  }
};

// Loads a row's slots into registers: v[k] = src[row, k * G + sub], or
// `none` past the row's end or for a row past w.
template <int G>
__device__ __forceinline__ void load_row(const int* __restrict__ src, int row, bool ok,
                                         int r, int items, int sub, int none,
                                         int (&v)[kMaxItems]) {
  const int* in = src + static_cast<size_t>(row) * r;
#pragma unroll
  for (int k = 0; k < kMaxItems; ++k) {
    const int slot = k * G + sub;
    v[k] = (k < items && ok && slot < r) ? __ldg(in + slot) : none;
  }
}

// The point's table: staged in shared memory (its entries 0 .. j - 1; entry
// j is never looked up, as every lookup first tests job < j), or read where
// it lies.
template <bool kSmem>
__device__ __forceinline__ const int* stage_table(const int* __restrict__ table, int j,
                                                  int* smem) {
  if (!kSmem) return table;
  for (int i = threadIdx.x; i < j; i += kThreads) smem[i] = table[i];
  return smem;
}

template <int G, bool kSmem>
__global__ void __launch_bounds__(kThreads)
queue_compact_kernel(const int* __restrict__ resq, const int* __restrict__ table,
                     int* __restrict__ out, int* __restrict__ fill, int* __restrict__ pad,
                     int w, int r, int j, int items) {
  extern __shared__ int smem[];
  const size_t p = blockIdx.y;
  resq += p * w * r;
  out += p * w * r;
  fill += p * w;
  const int* tab = stage_table<kSmem>(table + p * (j + 1), j, smem);
  if (pad != nullptr && blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) *pad = j;
  __syncthreads();

  const Group<G> g;
  const Walk walk(w, 32 / G);
  for (int s = walk.first; s < walk.sets; s += kTrips * walk.step) {
    int v[kTrips][kMaxItems];
#pragma unroll
    for (int t = 0; t < kTrips; ++t) {
      const int row = (s + t * walk.step) * (32 / G) + g.idx;
      load_row<G>(resq, row, row < w, r, items, g.sub, j, v[t]);
    }
#pragma unroll
    for (int t = 0; t < kTrips; ++t) {
      const int row = (s + t * walk.step) * (32 / G) + g.idx;
      const bool ok = row < w;
      int* o = out + static_cast<size_t>(row) * r;
      int base = 0;  // live entries of the row before this slot group
#pragma unroll
      for (int k = 0; k < kMaxItems; ++k) {
        if (k < items) {
          const int job = v[t][k];
          const bool live = static_cast<unsigned>(job) < static_cast<unsigned>(j) &&
                            tab[job] > 0;
          const unsigned m = __ballot_sync(kFull, live) & g.mask;
          if (live) o[base + __popc(m & g.below)] = job;
          base += __popc(m);
        }
      }
#pragma unroll
      for (int k = 0; k < kMaxItems; ++k) {
        const int slot = k * G + g.sub;
        if (k < items && ok && slot < r && slot >= base) o[slot] = j;
      }
      if (ok && g.sub == 0) fill[row] = base;
    }
  }
}

template <int G, bool kSmem>
__global__ void __launch_bounds__(kThreads)
queue_scan_kernel(const int* __restrict__ resq, const int* __restrict__ table,
                  const uint8_t* __restrict__ row_mask, const uint8_t* __restrict__ dead,
                  uint8_t* __restrict__ active, uint8_t* __restrict__ has_res,
                  int w, int r, int j, int items) {
  extern __shared__ int smem[];
  const size_t p = blockIdx.y;
  resq += p * w * r;
  active += p * w * r;
  has_res += p * j;
  if (row_mask != nullptr) row_mask += p * w;
  if (dead != nullptr) dead += p * w;
  const int* tab = stage_table<kSmem>(table + p * (j + 1), j, smem);
  const int words = (j + 31) / 32;
  unsigned* bits = reinterpret_cast<unsigned*>(smem + (kSmem ? j : 0));
  if (kSmem) {
    for (int i = threadIdx.x; i < words; i += kThreads) bits[i] = 0u;
  }
  __syncthreads();

  const Group<G> g;
  const Walk walk(w, 32 / G);
  for (int s = walk.first; s < walk.sets; s += kTrips * walk.step) {
    int v[kTrips][kMaxItems];
#pragma unroll
    for (int t = 0; t < kTrips; ++t) {
      const int row = (s + t * walk.step) * (32 / G) + g.idx;
      load_row<G>(resq, row, row < w, r, items, g.sub, j, v[t]);
    }
#pragma unroll
    for (int t = 0; t < kTrips; ++t) {
      const int row = (s + t * walk.step) * (32 / G) + g.idx;
      if (row >= w) continue;
      const bool on = row_mask == nullptr || row_mask[row] != 0;
      const bool alive = dead == nullptr || dead[row] == 0;
      uint8_t* a = active + static_cast<size_t>(row) * r;
#pragma unroll
      for (int k = 0; k < kMaxItems; ++k) {
        const int slot = k * G + g.sub;
        if (k < items && slot < r) {
          const int job = v[t][k];
          const bool held = static_cast<unsigned>(job) < static_cast<unsigned>(j);
          a[slot] = held && on && tab[job] > 0;
          if (held && alive) {
            if (kSmem) {
              const unsigned bit = 1u << (job & 31);
              if ((bits[job >> 5] & bit) == 0u) atomicOr(&bits[job >> 5], bit);
            } else if (has_res[job] == 0) {
              has_res[job] = 1;
            }
          }
        }
      }
    }
  }
  if (kSmem) {
    __syncthreads();
    for (int i = threadIdx.x; i < j; i += kThreads) {
      if ((bits[i >> 5] >> (i & 31)) & 1u) has_res[i] = 1;
    }
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads)
queue_head_kernel(const int* __restrict__ resq, const int* __restrict__ ranks,
                  int* __restrict__ head, int w, int r, int j, int items) {
  const size_t p = blockIdx.y;
  resq += p * w * r;
  ranks += p * w * r;
  head += p * w;

  const Group<G> g;
  const Walk walk(w, 32 / G);
  for (int s = walk.first; s < walk.sets; s += kTrips * walk.step) {
    int v[kTrips][kMaxItems];
#pragma unroll
    for (int t = 0; t < kTrips; ++t) {
      const int row = (s + t * walk.step) * (32 / G) + g.idx;
      load_row<G>(ranks, row, row < w, r, items, g.sub, -1, v[t]);
    }
#pragma unroll
    for (int t = 0; t < kTrips; ++t) {
      const int row = (s + t * walk.step) * (32 / G) + g.idx;
      int first = -1;  // the row's first slot of rank 0
#pragma unroll
      for (int k = 0; k < kMaxItems; ++k) {
        if (k < items) {
          const unsigned m = (__ballot_sync(kFull, v[t][k] == 0) & g.mask) >> (g.idx * G);
          if (first < 0 && m != 0u) first = k * G + __ffs(m) - 1;
        }
      }
      if (row < w && g.sub == 0) {
        head[row] = first < 0 ? j : __ldg(resq + static_cast<size_t>(row) * r + first);
      }
    }
  }
}

// Lanes a row takes, and slots a lane: the G of 8, 16, 32 that wastes the
// fewest lanes on r (the wider on a tie).
void plan(int r, int& group, int& items) {
  group = 32;
  items = (r + 31) / 32;
  int waste = items * 32 - r;
  const int narrower[2] = {16, 8};
  for (int gw : narrower) {
    const int n = (r + gw - 1) / gw;
    if (n <= kMaxItems && n * gw - r < waste) {
      group = gw;
      items = n;
      waste = n * gw - r;
    }
  }
}

// Blocks a point: enough for kBlocksPerSm a multiprocessor over all points,
// and none without a row.
int blocks_per_point(int p, int w, int group) {
  static int sms_of[64] = {};  // by device, read once
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess && dev >= 0 && dev < 64) {
    if (sms_of[dev] == 0) cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount, dev);
    if (sms_of[dev] > 0) sms = sms_of[dev];
  }
  const int rows_per_block = kWarps * (32 / group);
  const int want = (sms * kBlocksPerSm + p - 1) / p;
  const int need = (w + rows_per_block - 1) / rows_per_block;
  return want < need ? (want > 0 ? want : 1) : (need > 0 ? need : 1);
}

// Runs `launch(grid, first point)` over the points in chunks of kMaxGridY.
template <typename F>
int over_points(int p, int bx, F launch) {
  for (int p0 = 0; p0 < p; p0 += kMaxGridY) {
    launch(dim3(bx, p - p0 < kMaxGridY ? p - p0 : kMaxGridY), static_cast<size_t>(p0));
  }
  return static_cast<int>(cudaGetLastError());
}

template <int G, bool kSmem>
void compact(const int* resq, const int* table, int* out, int* fill, int* pad, int p,
             int w, int r, int j, int items, size_t smem, cudaStream_t s) {
  over_points(p, blocks_per_point(p, w, G), [&](dim3 grid, size_t p0) {
    queue_compact_kernel<G, kSmem><<<grid, kThreads, smem, s>>>(
        resq + p0 * w * r, table + p0 * (j + 1), out + p0 * w * r, fill + p0 * w,
        p0 == 0 ? pad : nullptr, w, r, j, items);
  });
}

template <int G, bool kSmem>
void scan(const int* resq, const int* table, const uint8_t* row_mask, const uint8_t* dead,
          uint8_t* active, uint8_t* has_res, int p, int w, int r, int j, int items,
          size_t smem, cudaStream_t s) {
  over_points(p, blocks_per_point(p, w, G), [&](dim3 grid, size_t p0) {
    queue_scan_kernel<G, kSmem><<<grid, kThreads, smem, s>>>(
        resq + p0 * w * r, table + p0 * (j + 1),
        row_mask == nullptr ? nullptr : row_mask + p0 * w,
        dead == nullptr ? nullptr : dead + p0 * w, active + p0 * w * r,
        has_res + p0 * j, w, r, j, items);
  });
}

template <int G>
void head(const int* resq, const int* ranks, int* out, int p, int w, int r, int j,
          int items, cudaStream_t s) {
  over_points(p, blocks_per_point(p, w, G), [&](dim3 grid, size_t p0) {
    queue_head_kernel<G><<<grid, kThreads, 0, s>>>(resq + p0 * w * r, ranks + p0 * w * r,
                                                  out + p0 * w, w, r, j, items);
  });
}

bool bad_shape(int p, int w, int r, int j) {
  return p < 1 || w < 1 || r < 1 || r > kMaxLanes || j < 0;
}

}  // namespace

// The widest row the kernels take (the wrapper checks that it agrees).
extern "C" int queue_max_lanes() { return kMaxLanes; }

// All three: resq int32[p, w, r] contiguous, entries in [0, j]; every other
// array contiguous in the layout named; all on the device; p, w >= 1,
// 1 <= r <= 256, j >= 0, else cudaErrorInvalidValue.  They launch on
// `stream` without synchronising and return cudaGetLastError() (0 = the
// launches were accepted).
//
// table int32[p, j + 1]; out int32[p, w, r]; fill int32[p, w]; pad: one
// int32 set to j (the pad slot after `out`), or null.
extern "C" int queue_compact_launch(const void* resq, const void* table, void* out,
                                    void* fill, void* pad, int p, int w, int r, int j,
                                    void* stream) {
  if (bad_shape(p, w, r, j)) return static_cast<int>(cudaErrorInvalidValue);
  int group, items;
  plan(r, group, items);
  const size_t smem = static_cast<size_t>(j) * sizeof(int);
  const bool staged = smem <= kSmemLimit;
  const int* q = static_cast<const int*>(resq);
  const int* tb = static_cast<const int*>(table);
  int* o = static_cast<int*>(out);
  int* f = static_cast<int*>(fill);
  int* pd = static_cast<int*>(pad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = staged ? smem : 0;
  switch (group * 2 + staged) {
    case 16: compact<8, false>(q, tb, o, f, pd, p, w, r, j, items, sm, s); break;
    case 17: compact<8, true>(q, tb, o, f, pd, p, w, r, j, items, sm, s); break;
    case 32: compact<16, false>(q, tb, o, f, pd, p, w, r, j, items, sm, s); break;
    case 33: compact<16, true>(q, tb, o, f, pd, p, w, r, j, items, sm, s); break;
    case 64: compact<32, false>(q, tb, o, f, pd, p, w, r, j, items, sm, s); break;
    default: compact<32, true>(q, tb, o, f, pd, p, w, r, j, items, sm, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// table int32[p, j + 1]; row_mask, dead: uint8[p, w] or null; active
// uint8[p, w, r]; has_res uint8[p, j], zeroed.
extern "C" int queue_scan_launch(const void* resq, const void* table, const void* row_mask,
                                 const void* dead, void* active, void* has_res, int p,
                                 int w, int r, int j, void* stream) {
  if (bad_shape(p, w, r, j)) return static_cast<int>(cudaErrorInvalidValue);
  int group, items;
  plan(r, group, items);
  const size_t smem = (static_cast<size_t>(j) + (j + 31) / 32) * sizeof(int);
  const bool staged = smem <= kSmemLimit;
  const int* q = static_cast<const int*>(resq);
  const int* tb = static_cast<const int*>(table);
  const uint8_t* rm = static_cast<const uint8_t*>(row_mask);
  const uint8_t* dd = static_cast<const uint8_t*>(dead);
  uint8_t* a = static_cast<uint8_t*>(active);
  uint8_t* h = static_cast<uint8_t*>(has_res);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = staged ? smem : 0;
  switch (group * 2 + staged) {
    case 16: scan<8, false>(q, tb, rm, dd, a, h, p, w, r, j, items, sm, s); break;
    case 17: scan<8, true>(q, tb, rm, dd, a, h, p, w, r, j, items, sm, s); break;
    case 32: scan<16, false>(q, tb, rm, dd, a, h, p, w, r, j, items, sm, s); break;
    case 33: scan<16, true>(q, tb, rm, dd, a, h, p, w, r, j, items, sm, s); break;
    case 64: scan<32, false>(q, tb, rm, dd, a, h, p, w, r, j, items, sm, s); break;
    default: scan<32, true>(q, tb, rm, dd, a, h, p, w, r, j, items, sm, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// ranks int32[p, w, r]; out int32[p, w].
extern "C" int queue_head_launch(const void* resq, const void* ranks, void* out, int p,
                                 int w, int r, int j, void* stream) {
  if (bad_shape(p, w, r, j)) return static_cast<int>(cudaErrorInvalidValue);
  int group, items;
  plan(r, group, items);
  const int* q = static_cast<const int*>(resq);
  const int* rk = static_cast<const int*>(ranks);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 8: head<8>(q, rk, o, p, w, r, j, items, s); break;
    case 16: head<16>(q, rk, o, p, w, r, j, items, s); break;
    default: head<32>(q, rk, o, p, w, r, j, items, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
