// Hopper (sm_90a) kernel for segment_select, the per-segment smallest-take
// selection of sequential Poisson sampling (paper §A.3; Neighbor Sampling
// takes exactly min(k, d_s) in-edges of each seed s).
//
// It replaces the TPU kernels of repro/kernels/frontier:
//   frontier.py select_kernel       (serial: a 31-step bisection of the
//                                    threshold per segment, then one
//                                    include pass)
//   parallel.py select_sort_kernel  (one tiled (slot, key) sort plus a rank
//                                    filter)
// Both are held to one contract: include[e] iff (key[e], e) ranks below
// take[s] within its segment s, ties broken by arrival order. Segment s
// occupies [seg_start[s], seg_start[s + 1]) of the edge buffer (the last one
// ends at E), the expand_seed_edges layout; masked entries lie only past the
// live prefix n_live.
//
// What bounds it on this card: bytes and latency. Each segment reads its keys
// once and writes one flag per edge; the 31 bisection counts run over keys
// held in registers, so the arithmetic is a few ballots per key. The TPU
// kernel walked the segments in grid order with the keys in VMEM; here every
// segment is independent and gets a warp: a lane holds up to 8 keys in
// registers (segments of up to 256 edges, almost all of them at fanout 10),
// the threshold T (the take-th smallest key, over the keys' monotone int32
// view) is found by 31 ballot counts, and one pass includes the keys below T
// and ranks the ties at T in arrival order with ballot prefixes. Longer
// segments (the graph's power-law tail) are listed by the warp pass and
// handled by a second launch, one block per segment, with block-wide counts
// and an ordered block scan for the ties. A segment holding no more than take
// masked-in edges (a truncated expansion included) takes all of them; a take
// of 0 selects nothing. The result is deterministic and equals the plain
// version bit for bit.
//
// Work is bounded by the live count read on the device; the output is cleared
// over its full length first. Launches on the given stream, synchronises
// nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPerLane = 8;
constexpr int kShortMax = 32 * kPerLane;  // longest segment a warp takes
constexpr int kGridCap = 132 * 16;
constexpr int kLongBlocks = 132 * 2;

__device__ __forceinline__ int live_count(const int* n_live, int cap) {
  if (n_live == nullptr) return cap;
  int n = *n_live;
  return n < 0 ? 0 : (n < cap ? n : cap);
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__device__ __forceinline__ int clip(int x, int hi) {
  return x < 0 ? 0 : (x > hi ? hi : x);
}

// Edge range [lo, hi) of segment s, clipped to the buffer and the live prefix.
__device__ __forceinline__ void seg_range(const int* seg_start, long s, int S,
                                          int E, int n, int* lo, int* hi) {
  const int a = clip(seg_start[s], E);
  int b = s + 1 < S ? clip(seg_start[s + 1], E) : E;
  if (b > n) b = n;
  *lo = a < b ? a : b;
  *hi = b;
}

// Sum of one int per thread over the block; every thread gets the total.
__device__ int block_sum(int v) {
  __shared__ int part[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  int t = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += part[w];
  __syncthreads();
  return t;
}

// Exclusive scan of one int per thread over the block; *total gets the sum.
__device__ int block_exclusive_scan(int v, int* total) {
  __shared__ int sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? sums[w] : 0;
    all += sums[w];
  }
  __syncthreads();
  *total = all;
  return before + x - v;
}

// One warp per segment of at most kShortMax edges; longer ones are listed.
__global__ void select_warp(const float* keys, const uint8_t* mask, int E,
                            const int* n_live, const int* seg_start,
                            const int* take, int S, uint8_t* include,
                            int* long_list, int* long_count) {
  const int n = live_count(n_live, E);
  const int lane = threadIdx.x & 31;
  const long nwarps = ((long)gridDim.x * blockDim.x) >> 5;
  for (long s = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5; s < S;
       s += nwarps) {
    int lo, hi;
    seg_range(seg_start, s, S, E, n, &lo, &hi);
    const int t = take[s];
    const int len = hi - lo;
    if (t <= 0 || len <= 0) continue;
    if (len > kShortMax) {
      if (lane == 0) long_list[atomicAdd(long_count, 1)] = (int)s;
      continue;
    }
    const int chunks = (len + 31) >> 5;
    int u[kPerLane];
    bool v[kPerLane];
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int e = lo + j * 32 + lane;
      v[j] = j < chunks && e < hi && mask[e];
      u[j] = v[j] ? __float_as_int(keys[e]) : 0;
      if (j < chunks) cnt += __popc(__ballot_sync(kFull, v[j]));
    }
    if (cnt <= t) {  // the segment holds no more than take: all of it
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int e = lo + j * 32 + lane;
        if (j < chunks && e < hi) include[e] = v[j] ? 1 : 0;
      }
      continue;
    }
    // smallest T with count(u <= T) >= t, from the top bit down
    int T = 0;
    for (int b = 30; b >= 0; --b) {
      const int cand = T + ((1 << b) - 1);
      int c = 0;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j)
        if (j < chunks) c += __popc(__ballot_sync(kFull, v[j] && u[j] <= cand));
      if (c < t) T += 1 << b;
    }
    int below = 0;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      if (j < chunks) below += __popc(__ballot_sync(kFull, v[j] && u[j] < T));
    const int budget = t - below;  // ties at T still to take
    int carry = 0;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      if (j >= chunks) continue;
      const int e = lo + j * 32 + lane;
      const bool lt = v[j] && u[j] < T;
      const bool eq = v[j] && u[j] == T;
      const unsigned em = __ballot_sync(kFull, eq);
      const int rank = carry + __popc(em & lanemask_lt());
      if (e < hi) include[e] = (lt || (eq && rank < budget)) ? 1 : 0;
      carry += __popc(em);
    }
  }
}

// One block per listed long segment; the keys are read from memory (L2) on
// each of the bisection's passes.
__global__ void select_block(const float* keys, const uint8_t* mask, int E,
                             const int* n_live, const int* seg_start,
                             const int* take, int S, const int* long_list,
                             const int* long_count, uint8_t* include) {
  const int n = live_count(n_live, E);
  const int n_long = *long_count;
  for (int i = blockIdx.x; i < n_long; i += gridDim.x) {
    const int s = long_list[i];
    int lo, hi;
    seg_range(seg_start, s, S, E, n, &lo, &hi);
    const int t = take[s];
    int c = 0;
    for (int e = lo + threadIdx.x; e < hi; e += kThreads) c += mask[e] ? 1 : 0;
    if (block_sum(c) <= t) {
      for (int e = lo + threadIdx.x; e < hi; e += kThreads)
        include[e] = mask[e] ? 1 : 0;
      continue;
    }
    int T = 0;
    for (int b = 30; b >= 0; --b) {
      const int cand = T + ((1 << b) - 1);
      c = 0;
      for (int e = lo + threadIdx.x; e < hi; e += kThreads)
        c += (mask[e] && __float_as_int(keys[e]) <= cand) ? 1 : 0;
      if (block_sum(c) < t) T += 1 << b;
    }
    c = 0;
    for (int e = lo + threadIdx.x; e < hi; e += kThreads)
      c += (mask[e] && __float_as_int(keys[e]) < T) ? 1 : 0;
    const int budget = t - block_sum(c);
    int carry = 0;
    for (int base = lo; base < hi; base += kThreads) {
      const int e = base + threadIdx.x;
      const bool valid = e < hi && mask[e];
      const int u = valid ? __float_as_int(keys[e]) : 0;
      const bool lt = valid && u < T;
      const bool eq = valid && u == T;
      int tot;
      const int rank = carry + block_exclusive_scan(eq ? 1 : 0, &tot);
      if (e < hi) include[e] = (lt || (eq && rank < budget)) ? 1 : 0;
      carry += tot;
    }
  }
}

}  // namespace

extern "C" int frontier_segment_select(const float* keys, const uint8_t* mask,
                                       int E, const int* n_live,
                                       const int* seg_start, const int* take,
                                       int S, uint8_t* include, int* long_list,
                                       int* long_count, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(long_count, 0, sizeof(int), st);
  if (err == cudaSuccess && E > 0) err = cudaMemsetAsync(include, 0, E, st);
  if (err != cudaSuccess) return (int)err;
  if (E > 0 && S > 0) {
    long blocks = ((long)S * 32 + kThreads - 1) / kThreads;
    if (blocks > kGridCap) blocks = kGridCap;
    select_warp<<<(int)blocks, kThreads, 0, st>>>(
        keys, mask, E, n_live, seg_start, take, S, include, long_list,
        long_count);
    select_block<<<kLongBlocks, kThreads, 0, st>>>(
        keys, mask, E, n_live, seg_start, take, S, long_list, long_count,
        include);
  }
  return (int)cudaGetLastError();
}
