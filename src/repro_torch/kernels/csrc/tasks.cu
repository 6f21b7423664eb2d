// One pass over the task axis of the sparrow and eagle rules, for Hopper
// (sm_90a).
//
// This kernel replaces no TPU kernel.  The JAX package leaves the chain to
// XLA, which fuses it: the per-job counts `unfinished_jobs` and `pending`
// and late binding's pending ranks and slot table in src/repro/simx/sparrow.py
// (`unfinished_jobs`, `late_bind`) and src/repro/simx/eagle.py.  Eager
// PyTorch ran that chain as about thirty passes over [B, T] a round, three of
// them scatter_adds in which every warp's 32 atomics hit one job's counter.
//
// Over rows b of task_finish float32[B, T], with submit float32 and job
// int32 each one row shared by every b or one row per b, and t float32[B]:
//   unfinished[b, j] = #{i : job[b, i] == j, task_finish[b, i] > t[b]}
//   pending[b, j]    = #{i : job[b, i] == j, isinf(task_finish[b, i]),
//                             submit[b, i] <= t[b]}
//   plist[b, 0 .. n_b) = the pending tasks of row b in ascending order, n_b
//                        the row's pending total; entries from n_b on are
//                        not written.
// Both tables are int32[B, J + 1] (job values in [0, J]; the last slot the
// pad job).  Without submit only `unfinished` is computed.  Counts are
// integer sums, so they are exact in any order of the atomics.
//
// What bounds it on an H100: bytes.  It reads task_finish once and submit
// once (8 bytes a task; a shared job row stays in L2) and writes 4 bytes a
// pending task.  At the Sparrow cell's [48, 480000]: 184.3 MB in, 55 us at
// 3.35 TB/s, and up to 92.2 MB out (82 us with every task pending).
//
// Design.  A block takes a tile of kTile consecutive tasks of one row (grid
// (tiles, B), so a row's tiles are dispatched in order), each thread
// kItemsT consecutive tasks, loaded as float4 / int4 where the row is
// aligned.
//   Counts: each thread walks its tasks carrying a run count while the job
//   stays the same.  A run that starts and ends inside the thread is added
//   with one atomic (jobs shorter than a thread's tasks).  The thread's last
//   run is joined with the runs of the lanes after it that continue the same
//   job by a segmented warp scan; the lane that ends such a run adds it, with
//   the next lane's first run where that continues the job too.  So a job run
//   costs one atomic per warp it touches, not one per task, and a count of 0
//   costs none.  Nothing here assumes an order of the jobs.
//   List: a stream compaction of the pending mask along the row, the block's
//   scan joined to the row's earlier tiles by the single-pass decoupled
//   look-back of lookback.cuh (epoch-tagged status words, [B, tiles]).  Each
//   pending task writes its own slot only: nothing is written for a task that
//   is not pending, so there is no pad slot and no contended write.
// The wrapper zeroes the tables with one memset before the launch.

#include "lookback.cuh"

namespace {

constexpr int kThreadsT = 256;
constexpr int kItemsT = 16;                    // consecutive tasks a thread
constexpr int kTile = kThreadsT * kItemsT;     // 4,096 tasks a block
constexpr int kWarpsT = kThreadsT / 32;
constexpr int kMaxGridYT = 65535;              // rows per launch
static_assert(kItemsT % 4 == 0 && kItemsT <= 32, "float4 loads; a 32-bit mask of tasks");

__device__ __forceinline__ void add_run(int* __restrict__ unfinished,
                                        int* __restrict__ pending, int j, int u, int p) {
  if (j < 0) return;  // tasks past the row's end
  if (u) atomicAdd(unfinished + j, u);
  if (p) atomicAdd(pending + j, p);
}

template <bool kPending>
__global__ void __launch_bounds__(kThreadsT)
task_scan_kernel(const float* __restrict__ task_finish, const float* __restrict__ submit,
                 size_t submit_stride, const int* __restrict__ job, size_t job_stride,
                 const float* __restrict__ t, int n_tasks, int n_table, int row0,
                 int* __restrict__ unfinished, int* __restrict__ pending,
                 int* __restrict__ plist, unsigned long long* __restrict__ status,
                 unsigned epoch) {
  __shared__ int warp_scan[kWarpsT];
  __shared__ int tile_excl;
  const int tile = blockIdx.x;
  const size_t b = static_cast<size_t>(row0) + blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float tb = t[b];
  const float* fin = task_finish + b * n_tasks;
  const float* sub = kPending ? submit + b * submit_stride : nullptr;
  const int* jr = job + b * job_stride;
  int* unf = unfinished + b * n_table;
  int* pnd = kPending ? pending + b * n_table : nullptr;

  // 1. this thread's tasks: job, and the two flags as bit masks
  const int first = tile * kTile + threadIdx.x * kItemsT;
  int jobs[kItemsT];
  unsigned umask = 0u, pmask = 0u;
  const bool whole = first + kItemsT <= n_tasks;
  const bool vec = whole && (reinterpret_cast<uintptr_t>(fin) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(jr) % 16 == 0) &&
                   (!kPending || reinterpret_cast<uintptr_t>(sub) % 16 == 0);
  if (vec) {
#pragma unroll
    for (int q = 0; q < kItemsT / 4; ++q) {
      const float4 f = __ldcs(reinterpret_cast<const float4*>(fin + first) + q);
      const int4 jv = __ldg(reinterpret_cast<const int4*>(jr + first) + q);
      const float fv[4] = {f.x, f.y, f.z, f.w};
      jobs[4 * q] = jv.x; jobs[4 * q + 1] = jv.y; jobs[4 * q + 2] = jv.z; jobs[4 * q + 3] = jv.w;
      float sv[4] = {0.f, 0.f, 0.f, 0.f};
      if (kPending) {
        const float4 s = __ldcs(reinterpret_cast<const float4*>(sub + first) + q);
        sv[0] = s.x; sv[1] = s.y; sv[2] = s.z; sv[3] = s.w;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = 4 * q + k;
        umask |= static_cast<unsigned>(fv[k] > tb) << i;
        if (kPending) pmask |= static_cast<unsigned>(isinf(fv[k]) && sv[k] <= tb) << i;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItemsT; ++k) {
      const int i = first + k;
      jobs[k] = -1;
      if (i < n_tasks) {
        const float f = fin[i];
        jobs[k] = jr[i];
        umask |= static_cast<unsigned>(f > tb) << k;
        if (kPending) pmask |= static_cast<unsigned>(isinf(f) && sub[i] <= tb) << k;
      }
    }
  }

  // 2. per-job counts: runs of one job within the thread, then across lanes
  int hj = jobs[0], hu = 0, hp = 0;  // the thread's first run, while not `single`
  int cj = jobs[0], cu = 0, cp = 0;  // the run being walked; at the end, the last
  bool single = true;                // one run covers every task of the thread
#pragma unroll
  for (int k = 0; k < kItemsT; ++k) {
    if (jobs[k] != cj) {
      if (single) {
        hj = cj; hu = cu; hp = cp;
        single = false;
      } else {
        add_run(unf, pnd, cj, cu, cp);  // a run inside the thread
      }
      cj = jobs[k]; cu = 0; cp = 0;
    }
    cu += static_cast<int>((umask >> k) & 1u);
    if (kPending) cp += static_cast<int>((pmask >> k) & 1u);
  }
  if (single) hj = cj;
  // the last runs of the lanes, scanned in segments: a lane starts a new
  // segment unless all its tasks continue the job of the lane before it
  const int prev_cj = __shfl_up_sync(kFull, cj, 1);
  const bool joins_prev = lane > 0 && hj == prev_cj;
  const bool start = !single || !joins_prev;
  int su = cu, sp = cp;
  bool seg = start;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up_u = __shfl_up_sync(kFull, su, d);
    const int up_p = __shfl_up_sync(kFull, sp, d);
    const bool up_seg = __shfl_up_sync(kFull, seg, d);
    if (lane >= d) {
      if (!seg) { su += up_u; sp += up_p; }
      seg = seg || up_seg;
    }
  }
  // the lane that ends a segment adds it, with the next lane's first run
  // where that lane has several runs and its first continues this job
  const bool next_start = __shfl_down_sync(kFull, start, 1);
  const bool next_single = __shfl_down_sync(kFull, single, 1);
  const int next_hj = __shfl_down_sync(kFull, hj, 1);
  const int next_hu = __shfl_down_sync(kFull, hu, 1);
  const int next_hp = __shfl_down_sync(kFull, hp, 1);
  if (lane == 31 || next_start) {
    const bool merge = lane < 31 && !next_single && next_hj == cj;
    add_run(unf, pnd, cj, su + (merge ? next_hu : 0), sp + (merge ? next_hp : 0));
  }
  // a first run that the lane before did not take
  if (!single && !joins_prev) add_run(unf, pnd, hj, hu, hp);

  if (!kPending) return;

  // 3. the pending list: this thread's place among the row's pending tasks
  int aggregate;
  const int thread_excl =
      block_exclusive_scan<kWarpsT>(__popc(pmask), lane, warp, warp_scan, aggregate);
  if (warp == 0) {
    const int excl = lookback(status + b * gridDim.x, tile, aggregate, 0x7fffffff, epoch, lane);
    if (lane == 0) tile_excl = excl;
  }
  __syncthreads();
  int pos = tile_excl + thread_excl;
  int* out = plist + b * n_tasks;
#pragma unroll
  for (int k = 0; k < kItemsT; ++k)
    if ((pmask >> k) & 1u) out[pos++] = first + k;
}

}  // namespace

// Tasks per block: the wrapper sizes the status words as rows x ceil(T / this).
extern "C" int task_scan_tile() { return kTile; }

// task_finish float32[rows, n_tasks]; t float32[rows]; job int32, row b at
// job + b * job_stride (0: one shared row); counts int32[2, rows, n_jobs + 1]
// (unfinished, then pending), zeroed here.  With submit null only the
// unfinished table ([1, rows, n_jobs + 1]) is computed and plist and status
// are not used; otherwise submit float32 (row b at submit + b *
// submit_stride), plist int32[rows, n_tasks], status at least rows x
// ceil(n_tasks / kTile) 64-bit words zeroed before their first launch, and
// epoch 1 .. 2^30 - 1, a new one per launch.  Requires rows, n_tasks >= 1.
// Launches on `stream` without synchronising and returns cudaGetLastError()
// (0 = the launch was accepted).
extern "C" int task_scan_launch(const void* task_finish, const void* submit,
                                long long submit_stride, const void* job,
                                long long job_stride, const void* t, int rows,
                                int n_tasks, int n_jobs, void* counts, void* plist,
                                void* status, unsigned epoch, void* stream) {
  if (rows < 1 || n_tasks < 1 || n_jobs < 0 || submit_stride < 0 || job_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool with_pending = submit != nullptr;
  const int n_table = n_jobs + 1;
  int* unf = static_cast<int*>(counts);
  int* pnd = unf + static_cast<size_t>(rows) * n_table;
  const size_t table_bytes =
      (with_pending ? 2 : 1) * static_cast<size_t>(rows) * n_table * sizeof(int);
  cudaError_t err = cudaMemsetAsync(counts, 0, table_bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n_tasks + kTile - 1) / kTile;
  const float* tf = static_cast<const float*>(task_finish);
  const float* sb = static_cast<const float*>(submit);
  const int* jb = static_cast<const int*>(job);
  const float* tt = static_cast<const float*>(t);
  int* pl = static_cast<int*>(plist);
  unsigned long long* st = static_cast<unsigned long long*>(status);
  for (int row0 = 0; row0 < rows; row0 += kMaxGridYT) {
    const dim3 grid(tiles, rows - row0 < kMaxGridYT ? rows - row0 : kMaxGridYT);
    if (with_pending)
      task_scan_kernel<true><<<grid, kThreadsT, 0, s>>>(
          tf, sb, submit_stride, jb, job_stride, tt, n_tasks, n_table, row0, unf, pnd, pl, st,
          epoch);
    else
      task_scan_kernel<false><<<grid, kThreadsT, 0, s>>>(
          tf, nullptr, 0, jb, job_stride, tt, n_tasks, n_table, row0, unf, nullptr, nullptr,
          nullptr, 0u);
  }
  return static_cast<int>(cudaGetLastError());
}
