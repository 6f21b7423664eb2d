// P² streaming-quantile absorb for Hopper (sm_90a).
//
// Not a port of a TPU kernel: it replaces the reference's in-jit
// `lax.scan` of `sketch_update` over one segment's job delays
// (`sketch_absorb`, src/repro/simx/telemetry.py:440-452, called by the
// streaming engine at src/repro/simx/stream.py:618).  In PyTorch that scan
// is about 80 small ops per observation, one launch each (the plain
// version, `repro_torch.simx.telemetry.sketch_absorb`); this kernel is one
// launch per absorb.
//
// State (Jain & Chlamtac's P², one 5-marker cell per target quantile):
//   q[Q][5]    marker heights           float32
//   n[Q][5]    marker positions         float32 (integers, 1-based)
//   npd[Q][5]  desired positions        float32
//   dn[Q][5]   desired increments       float32 (read only)
//   buf[5]     warm-up buffer           float32 (the first 5 observations)
//   count      observations absorbed    int32
// Input: values[N] float32 and mask[N] (bool as uint8): values[i] is
// observed iff mask[i], in index order.
//
// Lanes: L independent sketches absorb L rows of values at once (the
// sharded steady state's one sketch per offered load).  Every array above
// then carries a leading [L] axis, contiguous, and lane l reads row l of
// values and mask and writes sketch l.  A single sketch is L = 1.
//
// What bounds it on an H100: latency.  The recursion is sequential in the
// observations (each update reads the markers the previous one wrote),
// so the work is one dependent chain of one update per valid value, each
// a few dozen float operations with three divides per interior marker;
// bytes (5 N + ~0.5 kB of state) and operations are far below a
// microsecond.  So the chain must not wait on memory: the block first
// stages the valid values of a tile in shared memory with coalesced loads
// (a warp ballot keeps them in index order and drops the masked ones),
// and only then walks them.
//
// Design: one warp per block, each block a group of up to 32 target
// quantiles of one sketch lane, on a (ceil(Q / 32), L) grid: blockIdx.y is
// the lane, so the lanes' chains run side by side on separate SMs (the
// cells are independent apart from the lane's shared warm-up buffer,
// which every walking thread keeps in registers alike; the lane's block 0
// writes it back).  Per tile of kTile values the warp compacts the valid
// ones into shared memory; each thread with a quantile loads its cell into
// registers once, walks the staged values in order, and writes its cell
// back once at the end.  With `cycles` set, thread 0 of sketch lane 0's
// block 0 adds up the SM cycles of its walks (clock64), the dependent
// chain alone, and writes them there: what the chain of this run's data
// costs, with no launch and no global load in it.
//
// Numerics: the plain version is the reference's compiled arithmetic,
// where XLA contracts the two `qi + m * y` updates into fused multiply-adds
// and rounds every other operation on its own.  Here those two updates are
// `__fmaf_rn` and every other add, multiply and divide is an `_rn`
// intrinsic, which nvcc never contracts, so the kernel repeats that
// arithmetic operation for operation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kTile = 2048;  // values staged in shared memory at a time

__device__ __forceinline__ void sort5(float (&v)[5]) {
  // insertion sort: stable, ascending (equal values keep their order)
  #pragma unroll
  for (int i = 1; i < 5; ++i) {
    #pragma unroll
    for (int j = i; j > 0; --j) {
      if (v[j] < v[j - 1]) {
        float t = v[j];
        v[j] = v[j - 1];
        v[j - 1] = t;
      }
    }
  }
}

// One observation x into one cell (q, n, npd, dn) and the warm-up buffer.
__device__ __forceinline__ void p2_update(float x, float (&q)[5], float (&n)[5],
                                          float (&npd)[5], const float (&dn)[5],
                                          float (&buf)[5], int& cnt) {
  if (cnt < 5) {
    // warm-up: fill the buffer; the 5th observation bootstraps the
    // markers from the sorted buffer (positions stay at 1..5)
    #pragma unroll
    for (int j = 0; j < 5; ++j) {
      if (j == cnt) buf[j] = x;
    }
    if (cnt == 4) {
      float s[5] = {buf[0], buf[1], buf[2], buf[3], buf[4]};
      sort5(s);
      #pragma unroll
      for (int j = 0; j < 5; ++j) q[j] = s[j];
    }
    ++cnt;
    return;
  }
  // new extremes
  q[0] = fminf(q[0], x);
  q[4] = fmaxf(q[4], x);
  // cell index k in [0, 3]: number of markers <= x, less one, clipped
  int le = 0;
  #pragma unroll
  for (int j = 0; j < 5; ++j) le += (q[j] <= x) ? 1 : 0;
  const int k = min(max(le - 1, 0), 3);
  #pragma unroll
  for (int j = 0; j < 5; ++j) {
    if (j > k) n[j] = __fadd_rn(n[j], 1.0f);
    npd[j] = __fadd_rn(npd[j], dn[j]);
  }
  // the interior markers in order: marker i's move sees i - 1's update
  #pragma unroll
  for (int m = 1; m <= 3; ++m) {
    const float qi = q[m], qu = q[m + 1], ql = q[m - 1];
    const float ni = n[m], nu = n[m + 1], nl = n[m - 1];
    const float d = __fsub_rn(npd[m], ni);
    const float gap_up = __fsub_rn(nu, ni);
    const float gap_dn = __fsub_rn(nl, ni);
    const float move = (d >= 1.0f && gap_up > 1.0f) ? 1.0f
                       : ((d <= -1.0f && gap_dn < -1.0f) ? -1.0f : 0.0f);
    if (move == 0.0f) continue;
    // parabolic prediction: qi + move / (nu - nl) * (a + b)
    const float a = __fdiv_rn(__fmul_rn(__fadd_rn(__fsub_rn(ni, nl), move), __fsub_rn(qu, qi)),
                              __fsub_rn(nu, ni));
    const float b = __fdiv_rn(__fmul_rn(__fsub_rn(__fsub_rn(nu, ni), move), __fsub_rn(qi, ql)),
                              __fsub_rn(ni, nl));
    const float q_par = __fmaf_rn(__fdiv_rn(move, __fsub_rn(nu, nl)), __fadd_rn(a, b), qi);
    // linear fallback: qi + move * slope toward the neighbour
    const float slope = (move >= 0.0f) ? __fdiv_rn(__fsub_rn(qu, qi), __fsub_rn(nu, ni))
                                       : __fdiv_rn(__fsub_rn(ql, qi), __fsub_rn(nl, ni));
    const float q_lin = __fmaf_rn(move, slope, qi);
    q[m] = (ql < q_par && q_par < qu) ? q_par : q_lin;
    n[m] = __fadd_rn(ni, move);
  }
  ++cnt;
}

__global__ void __launch_bounds__(kWarp) p2_absorb_kernel(
    const float* __restrict__ values, const uint8_t* __restrict__ mask, int n_values,
    float* __restrict__ q_g, float* __restrict__ n_g, float* __restrict__ npd_g,
    const float* __restrict__ dn_g, float* __restrict__ buf_g, int* __restrict__ count_g,
    int n_quantiles, long long* __restrict__ cycles) {
  __shared__ float staged[kTile];
  const int lane = threadIdx.x;
  const int r = blockIdx.x * kWarp + lane;
  const bool walks = r < n_quantiles;
  // this block's sketch lane: its row of values and its cells
  const long long sk = blockIdx.y;
  values += sk * n_values;
  mask += sk * n_values;
  q_g += sk * n_quantiles * 5;
  n_g += sk * n_quantiles * 5;
  npd_g += sk * n_quantiles * 5;
  dn_g += sk * n_quantiles * 5;
  buf_g += sk * 5;
  count_g += sk;
  float q[5], n[5], npd[5], dn[5], buf[5];
  #pragma unroll
  for (int j = 0; j < 5; ++j) {
    q[j] = walks ? q_g[r * 5 + j] : 0.0f;
    n[j] = walks ? n_g[r * 5 + j] : 0.0f;
    npd[j] = walks ? npd_g[r * 5 + j] : 0.0f;
    dn[j] = walks ? dn_g[r * 5 + j] : 0.0f;
    buf[j] = buf_g[j];
  }
  int cnt = *count_g;
  long long walk_cycles = 0;
  const unsigned below = (1u << lane) - 1u;

  for (int base = 0; base < n_values; base += kTile) {
    const int end = min(base + kTile, n_values);
    // stage the tile's valid values in index order
    int staged_n = 0;
    for (int i = base + lane; i - lane < end; i += kWarp) {
      const bool ok = i < end && mask[i];
      const float v = ok ? values[i] : 0.0f;
      const unsigned ballot = __ballot_sync(0xffffffffu, ok);
      if (ok) staged[staged_n + __popc(ballot & below)] = v;
      staged_n += __popc(ballot);
    }
    __syncwarp();
    if (walks) {
      const long long t0 = clock64();
      for (int i = 0; i < staged_n; ++i) p2_update(staged[i], q, n, npd, dn, buf, cnt);
      walk_cycles += clock64() - t0;
    }
    __syncwarp();  // the next tile overwrites the staged values
  }

  if (walks) {
    #pragma unroll
    for (int j = 0; j < 5; ++j) {
      q_g[r * 5 + j] = q[j];
      n_g[r * 5 + j] = n[j];
      npd_g[r * 5 + j] = npd[j];
    }
  }
  if (r == 0) {
    #pragma unroll
    for (int j = 0; j < 5; ++j) buf_g[j] = buf[j];
    *count_g = cnt;
    if (cycles != nullptr && sk == 0) *cycles = walk_cycles;
  }
}

// The SM clock against the global timer: one thread spins `spin` cycles
// and writes [cycles, nanoseconds] (turns `cycles` above into time).
__global__ void p2_clock_kernel(long long spin, long long* out) {
  unsigned long long g0, g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  const long long t0 = clock64();
  long long t1 = t0;
  while (t1 - t0 < spin) t1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  out[0] = t1 - t0;
  out[1] = static_cast<long long>(g1 - g0);
}

}  // namespace

extern "C" {

// Absorb each lane's values[l][0, n_values) (where mask) into sketch l in
// place, for n_lanes lanes, on `stream`; with `cycles` non-null, also
// write lane 0's walk's SM cycles there.  Returns the launch's cudaError_t
// (0 on success).
int p2_absorb_launch(const float* values, const uint8_t* mask, int n_values, float* q,
                     float* n, float* npd, const float* dn, float* buf, int* count,
                     int n_quantiles, int n_lanes, long long* cycles, void* stream) {
  if (n_quantiles < 1 || n_values < 0 || n_lanes < 1 || n_lanes > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n_quantiles + kWarp - 1) / kWarp, n_lanes);
  p2_absorb_kernel<<<grid, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      values, mask, n_values, q, n, npd, dn, buf, count, n_quantiles, cycles);
  return static_cast<int>(cudaGetLastError());
}

// Spin `spin` SM cycles on one thread and write [cycles, nanoseconds] to
// out[0:2] (device memory), on `stream`.
int p2_clock_launch(long long spin, long long* out, void* stream) {
  p2_clock_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(spin, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
