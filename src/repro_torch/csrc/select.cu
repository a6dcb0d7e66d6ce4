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
// handled by a second launch, one block per segment: up to kStage keys are
// staged in shared memory once, as 32-bit order keys with masked entries
// marked, and a radix select of 4 passes of 8-bit digits (shared
// histograms, a block scan of the bins) finds the threshold, where a
// bisection would re-read the keys from L2 31 times; an ordered block scan
// ranks the ties. A segment longer than kStage runs the same passes over
// memory. A segment holding no more than take masked-in edges (a truncated
// expansion included) takes all of them; a take of 0 selects nothing. The
// result is deterministic and equals the plain version bit for bit.
//
// Two launches a call and nothing else: no memset (the kernels write every
// flag, the zeros before the first segment and past the live prefix
// included) and no allocation (the long-segment list and its epoch-tagged
// count live in the caller's per-stream scratch). Work is bounded by the
// live count read on the device. Launches on the given stream, synchronises
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
constexpr int kLongBlocks = 132 * 4;
constexpr int kRadix = 256;             // bins a radix-select pass
constexpr int kStage = 10240;           // keys a block stages (40 KB)
static_assert(kRadix == kThreads, "one bin a thread");

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

// Zeros bytes [a, b) of p: the threads tid, tid + nthreads, ... of the
// caller share the work, 16-byte stores from the first 16-byte boundary.
__device__ __forceinline__ void zero_bytes(uint8_t* p, long a, long b,
                                           long tid, long nthreads) {
  if (a >= b) return;
  long a16 = a + (long)((16 - ((uintptr_t)(p + a) & 15)) & 15);
  if (a16 > b) a16 = b;
  const long b16 = a16 + ((b - a16) & ~15L);
  if (tid < a16 - a) p[a + tid] = 0;
  for (long i = a16 + 16 * tid; i < b16; i += 16 * nthreads)
    *(uint4*)(p + i) = make_uint4(0u, 0u, 0u, 0u);
  if (tid < b - b16) p[b16 + tid] = 0;
}

// (epoch << 32) | count words: a word of an earlier epoch reads as 0.
__device__ __forceinline__ int tagged_count(const unsigned long long* w,
                                            unsigned epoch) {
  const unsigned long long v = *(volatile const unsigned long long*)w;
  return (unsigned)(v >> 32) == epoch ? (int)(unsigned)v : 0;
}

// Takes the next index of a tagged count: a word of an earlier epoch is
// first raised to (epoch, 0). Epochs rise call by call on a stream, so
// once one thread raised it, a later raise changes nothing.
__device__ __forceinline__ int tagged_next(unsigned long long* w,
                                           unsigned epoch) {
  const unsigned long long base = (unsigned long long)epoch << 32;
  if (*(volatile unsigned long long*)w < base) atomicMax(w, base);
  return (int)(unsigned)atomicAdd(w, 1ull);
}

// One segment [lo, hi) of at most 32 P edges with 0 < t, by one warp:
// lane l holds the keys of edges lo + 32 j + l (j < P) in registers. The
// threshold T, the smallest value with count(u <= T) >= t over the keys'
// int32 view u, is built bit by bit from the top as a bisection would,
// with two shortcuts that leave it as it is: the bits that every key >= 0
// shares are T's without a count (T is the t-th smallest key, and a
// negative key counts below every candidate), so only the bits where the
// keys differ take a count; and once a single key is left between the
// counts below and above the bits still open, T is that key. Random keys
// take about log2(len) counts instead of 31, all keys tied none. One pass
// then includes the keys below T and ranks the ties at T in arrival order
// with ballot prefixes.
template <int P>
__device__ __forceinline__ void select_short(const float* keys,
                                             const uint8_t* mask, int lo,
                                             int hi, int t, uint8_t* include,
                                             int lane) {
  const int chunks = (hi - lo + 31) >> 5;
  int u[P];
  bool v[P];
  int cnt = 0, negc = 0;
  unsigned all = 0xffffffffu, any = 0u;  // AND and OR of the keys >= 0
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int e = lo + j * 32 + lane;
    v[j] = j < chunks && e < hi && mask[e];
    u[j] = v[j] ? __float_as_int(keys[e]) : 0;
    if (j < chunks) {
      cnt += __popc(__ballot_sync(kFull, v[j]));
      negc += __popc(__ballot_sync(kFull, v[j] && u[j] < 0));
    }
    if (v[j] && u[j] >= 0) {
      all &= (unsigned)u[j];
      any |= (unsigned)u[j];
    }
  }
  if (cnt <= t) {  // the segment holds no more than take: all of it
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int e = lo + j * 32 + lane;
      if (j < chunks && e < hi) include[e] = v[j] ? 1 : 0;
    }
    return;
  }
  int T = 0;
  if (negc < t) {  // else T = 0: the negative keys alone reach t
    // here at least two keys are >= 0, so `all` and `any` are theirs
    all = __reduce_and_sync(kFull, all);
    any = __reduce_or_sync(kFull, any);
    unsigned open = (all ^ any) & 0x7fffffffu;  // bits the keys differ in
    T = (int)(all & ~open & 0x7fffffffu);
    int below = negc, upper = cnt;   // counts of u < T and up to its range
    while (open) {
      const int b = 31 - __clz(open);
      open &= ~(1u << b);
      const int low = (1 << b) - 1;
      const int cand = (T & ~(low | (1 << b))) | low;
      int c = 0;
#pragma unroll
      for (int j = 0; j < P; ++j)
        if (j < chunks) c += __popc(__ballot_sync(kFull, v[j] && u[j] <= cand));
      if (c < t) {
        T |= 1 << b;
        below = c;
      } else {
        upper = c;
      }
      if (upper - below == 1) {      // one key in T's range: T is it
        const int first = T & ~low, top = first | low;
        bool found = false;
#pragma unroll
        for (int j = 0; j < P; ++j) {
          if (j < chunks) {
            const unsigned m =
                __ballot_sync(kFull, v[j] && u[j] >= first && u[j] <= top);
            if (m && !found) {
              T = __shfl_sync(kFull, u[j], __ffs(m) - 1);
              found = true;
            }
          }
        }
        break;
      }
    }
  }
  int below = 0;
#pragma unroll
  for (int j = 0; j < P; ++j)
    if (j < chunks) below += __popc(__ballot_sync(kFull, v[j] && u[j] < T));
  const int budget = t - below;  // ties at T still to take
  int carry = 0;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if (j < chunks) {
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

// Segments in batches of 32 per warp, strided over the grid's warps (the
// live seeds' segments come first, the padded empty ones after, so each
// batch holds its share of both): lane l reads the range and take of its
// segment, all in one round trip (an empty segment costs no round trip of
// its own), writes the zeros of a take of 0 and lists a segment longer
// than kShortMax (a tagged count and a list in the caller's scratch); then
// the warp selects each short segment of the batch in turn. Every flag of
// the output is written here or by select_block: the segments' own, and
// zeros before the first segment and past the live prefix.
__global__ void select_warp(const float* keys, const uint8_t* mask, int E,
                            const int* n_live, const int* seg_start,
                            const int* take, int S, uint8_t* include,
                            unsigned long long* long_count, int* long_list,
                            unsigned epoch) {
  const int n = live_count(n_live, E);
  const long tid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long nthreads = (long)gridDim.x * blockDim.x;
  const int head = S > 0 ? min(clip(seg_start[0], E), n) : n;
  zero_bytes(include, 0, head, tid, nthreads);
  zero_bytes(include, n, E, tid, nthreads);
  const int lane = threadIdx.x & 31;
  const long nwarps = nthreads >> 5;
  for (long s0 = 0; s0 < S; s0 += 32 * nwarps) {
    const long s = s0 + lane * nwarps + (tid >> 5);
    int lo = 0, hi = 0, t = 0;
    if (s < S) {
      seg_range(seg_start, s, S, E, n, &lo, &hi);
      t = take[s];
    }
    if (hi > lo && t <= 0)   // a take of 0 selects nothing
      for (int e = lo; e < hi; ++e) include[e] = 0;
    if (hi - lo > kShortMax && t > 0)
      long_list[tagged_next(long_count, epoch)] = (int)s;
    unsigned work = __ballot_sync(kFull, hi > lo && t > 0 &&
                                             hi - lo <= kShortMax);
    while (work) {
      const int l = __ffs(work) - 1;
      work &= work - 1;
      const int slo = __shfl_sync(kFull, lo, l);
      const int shi = __shfl_sync(kFull, hi, l);
      const int st = __shfl_sync(kFull, t, l);
      // registers fitted to the length: most segments hold a few dozen
      if (shi - slo <= 64)
        select_short<2>(keys, mask, slo, shi, st, include, lane);
      else if (shi - slo <= 128)
        select_short<4>(keys, mask, slo, shi, st, include, lane);
      else
        select_short<kPerLane>(keys, mask, slo, shi, st, include, lane);
    }
  }
}

// The 32-bit order key of a masked-in edge's float key: the int32 view u
// (monotone for keys >= 0), with u < 0 as 0 and u >= 0 as u + 1, so that
// the take-th smallest order key Tp gives the bisection's threshold: T =
// Tp - 1 when Tp >= 1, with the keys below T those below Tp; Tp = 0 (the
// negative keys alone reach take) gives T = 0, the negative keys below
// it and no tie taken. kMasked marks a masked entry: above every order
// key, it is never counted.
constexpr unsigned kMasked = 0xffffffffu;

__device__ __forceinline__ unsigned order_key(const float* keys,
                                              const uint8_t* mask, int e) {
  if (!mask[e]) return kMasked;
  const int u = __float_as_int(keys[e]);
  return u < 0 ? 0u : (unsigned)u + 1u;
}

// One block per listed segment (longer than kShortMax). A segment of up to
// kStage edges stages its order keys in shared memory once; a longer one
// reads them from memory on each pass. The threshold Tp is found by a
// radix select of 4 passes of 8-bit digits (a shared histogram of the
// keys under the digits chosen so far, then a block scan of its 256 bins
// finds the digit holding the remaining rank), not by 31 bisection passes;
// one ordered pass then includes the keys below Tp and ranks the ties at
// Tp in arrival order with a block scan.
__global__ void __launch_bounds__(kThreads)
select_block(const float* keys, const uint8_t* mask, int E,
             const int* n_live, const int* seg_start, const int* take,
             int S, const unsigned long long* long_count,
             const int* long_list, unsigned epoch, uint8_t* include) {
  __shared__ unsigned s_key[kStage];
  __shared__ int s_hist[kRadix];
  __shared__ int s_digit, s_below;
  const int n = live_count(n_live, E);
  const int n_long = tagged_count(long_count, epoch);
  for (int i = blockIdx.x; i < n_long; i += gridDim.x) {
    __syncthreads();   // the previous segment's staged keys are consumed
    const int s = long_list[i];
    int lo, hi;
    seg_range(seg_start, s, S, E, n, &lo, &hi);
    const int t = take[s], len = hi - lo;
    const bool staged = len <= kStage;
    auto key_at = [&](int j) -> unsigned {
      return staged ? s_key[j] : order_key(keys, mask, lo + j);
    };
    int c = 0;
    for (int j = threadIdx.x; j < len; j += kThreads) {
      const unsigned k = order_key(keys, mask, lo + j);
      if (staged) s_key[j] = k;
      c += k != kMasked;
    }
    if (block_sum(c) <= t) {  // no more than take: every masked-in edge
      for (int j = threadIdx.x; j < len; j += kThreads)
        include[lo + j] = key_at(j) != kMasked;
      continue;
    }
    unsigned prefix = 0;
    int want = t;  // rank of Tp among the keys under the prefix
    for (int shift = 24; shift >= 0; shift -= 8) {
      s_hist[threadIdx.x] = 0;
      __syncthreads();
      for (int j = threadIdx.x; j < len; j += kThreads) {
        const unsigned k = key_at(j);
        if (k != kMasked && (shift == 24 || (k >> (shift + 8)) == prefix))
          atomicAdd(&s_hist[(k >> shift) & (kRadix - 1)], 1);
      }
      __syncthreads();
      const int v = s_hist[threadIdx.x];
      int total;
      const int excl = block_exclusive_scan(v, &total);
      if (excl < want && excl + v >= want) {
        s_digit = threadIdx.x;
        s_below = excl;
      }
      __syncthreads();
      prefix = (prefix << 8) | (unsigned)s_digit;
      want -= s_below;
      __syncthreads();   // s_digit and s_below are read before the next pass
    }
    // Tp >= 1: below Tp, then `want` of the ties at Tp; Tp = 0: the
    // negative keys alone (the tie budget t - their count is <= 0)
    const unsigned Tp = prefix;
    const int budget = Tp >= 1 ? want : 0;
    int carry = 0;
    for (int base = 0; base < len; base += kThreads) {
      const int j = base + threadIdx.x;
      const unsigned k = j < len ? key_at(j) : kMasked;
      const bool lt = Tp >= 1 ? k < Tp : k == 0;
      const bool eq = k == Tp && Tp >= 1;
      int tot;
      const int rank = carry + block_exclusive_scan(eq ? 1 : 0, &tot);
      if (j < len) include[lo + j] = (lt || (eq && rank < budget)) ? 1 : 0;
      carry += tot;
    }
  }
}

}  // namespace

// long_count: one (epoch << 32) | count word; long_list: S ints. Both
// from the caller's per-stream scratch, never cleared: the count carries
// this call's epoch, and list entries past it are never read.
extern "C" int frontier_segment_select(const float* keys, const uint8_t* mask,
                                       int E, const int* n_live,
                                       const int* seg_start, const int* take,
                                       int S, uint8_t* include,
                                       unsigned long long* long_count,
                                       int* long_list, unsigned epoch,
                                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (E <= 0) return (int)cudaGetLastError();
  // a warp a segment, and at least a thread a 16 x 16 bytes of the flags
  long blocks = ((long)S * 32 + kThreads - 1) / kThreads;
  const long fill = ((long)E / 256 + kThreads - 1) / kThreads;
  if (blocks < fill) blocks = fill;
  if (blocks > kGridCap) blocks = kGridCap;
  if (blocks < 1) blocks = 1;
  select_warp<<<(int)blocks, kThreads, 0, st>>>(
      keys, mask, E, n_live, seg_start, take, S, include, long_count,
      long_list, epoch);
  if (S > 0)
    select_block<<<kLongBlocks, kThreads, 0, st>>>(
        keys, mask, E, n_live, seg_start, take, S, long_count, long_list,
        epoch, include);
  return (int)cudaGetLastError();
}
