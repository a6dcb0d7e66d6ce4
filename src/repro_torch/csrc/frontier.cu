// Hopper (sm_90a) kernels for the frontier primitives of the sampled-block
// epilogue (build_block): compact, compact_perm and hash_dedup.
//
// They replace the TPU kernels of repro/kernels/frontier:
//   compact      <- frontier.py compact_kernel, parallel.py compact_tiles_kernel
//   compact_perm <- frontier.py perm_kernel, parallel.py sort_packed_kernel and
//                   sort_pairs_kernel
//   hash_dedup   <- frontier.py dedup_kernel + lookup_kernel, parallel.py
//                   dedup_tiles_kernel + dedup_merge_kernel +
//                   lookup_batched_kernel
//
// What bounds them on this card: all three are integer data motion with no
// arithmetic to speak of. At layer 2 of the serving path (9.4 M edge slots,
// ~0.87 M live) they are bound by bytes at 3.35 TB/s, most of them the
// outputs the contract defines over the whole cap (compact's sel and
// emask, compact_perm's perm, hash_dedup's slots); at layers 0 and 1
// (10^4 - 10^5 live elements) by the launches and the host's enqueue. The
// TPU kernels ran one grid step over a VMEM-resident buffer; here the work
// is spread over thread blocks, and what a TPU grid carried from step to
// step (a running count, a sort's digit offsets) is carried between tiles
// in one pass by a decoupled look-back over epoch-tagged status words. So
// compact is one launch, compact_perm an upsweep and one launch a digit
// pass of the shared single-pass radix sort, hash_dedup 7 launches around
// that sort. Their scratch (status words, histograms, tickets, the hash
// table, the sort's buffers) is cached per stream by the wrappers and
// never cleared between calls: each call tags what it writes with its own
// epoch, and a word of an earlier call reads as empty.
//
// Work is bounded by the real count, not the cap: every kernel reads the
// live length from device memory (n_live, or a count an earlier kernel
// wrote) and stops there; only the outputs the contract defines at the cap
// (sel and emask of compact, perm and slots past the live prefix, new past
// num_new) are written over their full length. No launch is sized by a host
// read of a device value.
//
// Every exported function launches on the given stream, synchronises
// nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kGridCap = 132 * 8;  // grid-stride loops: 8 blocks per SM

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

inline int grid_for(long n, int per_block) {
  long g = (n + per_block - 1) / per_block;
  if (g < 1) g = 1;
  return (int)(g < kGridCap ? g : kGridCap);
}

#define GRID_STRIDE(i, n)                                              \
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < (n); \
       i += (long)gridDim.x * blockDim.x)

// Exclusive scan of one int per thread over a block of kBlock threads;
// *total gets the block's sum. Ends with a barrier, so it can be called
// again right away.
template <int kBlock>
__device__ int block_exclusive_scan(int v, int* total) {
  static_assert(kBlock % 32 == 0 && kBlock <= 1024, "block size");
  __shared__ int warp_sums[kBlock / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kBlock / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kBlock / 32) warp_sums[lane] = s;
  }
  __syncthreads();
  const int before = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[kBlock / 32 - 1];
  __syncthreads();
  return before + x - v;
}

// ---------------------------------------------------------------------------
// compact: sel[c] = index of the c-th set flag (0 past the end), emask, num.
// One launch, one pass over the live flags: a chained scan with decoupled
// look-back (Merrill and Garland, "Single-pass Parallel Prefix Scan with
// Decoupled Look-back", 2016) over tiles of 16,384 flags. Chosen over a
// cooperative launch with grid.sync(): that would cap the grid at what is
// resident and make every block wait for the slowest, where here a tile
// waits only for the prefix of the tiles before it.
//
//  * Each block takes its tile from an atomic ticket, so tile t is only
//    ever waited on by blocks that took their tickets after a running
//    block took t: no block order is assumed and no wait can deadlock.
//  * A tile counts its set flags (16-byte loads, one 32-bit mask a
//    thread) and publishes the count twice: as its aggregate word, and as
//    its status word, which it then walks back from over its
//    predecessors' status words, 32 at a time by one warp, until it meets
//    an inclusive prefix, and upgrades to its own inclusive prefix. A word
//    is one 64-bit store: epoch (30 bits) | flag (aggregate or prefix) |
//    count (32 bits). The wrapper passes a new epoch every call (a call
//    counter), so the words of earlier calls read as not ready and no
//    memset runs between calls; it zeroes the words once when the counter
//    wraps. The ticket word is tagged the same way: epoch (high half) |
//    count (low half). A block that finds an earlier epoch's ticket
//    raises it to (epoch, 0) with atomicMax before it takes a number, so
//    the ticket needs no reset by the call before, and a call whose
//    launch failed leaves nothing behind.
//  * The tile then ranks its flags (a block scan of the per-thread
//    counts; each thread's flags are contiguous, so ranks keep arrival
//    order) and writes sel and emask = 1 at its ranks below cap, a warp
//    writing one thread's flags at a time so that each store covers
//    consecutive ranks.
//  * The blocks past the last live tile fill the tail with sel = 0,
//    emask = 0: the slots [min(n_live, cap), cap) at once (they are past
//    every set flag), then, once every live tile's aggregate word is in
//    and their sum gives num, the slots [num, min(n_live, cap)). The
//    aggregates come right after each tile's count, so the fill does not
//    wait for the chain of prefixes. Every tile is owned by a running
//    block by then, so the wait ends. The first fill block writes num.
//
// So one device operation per call, and the work is bounded by the live
// count read on the device. What bounds it: reading the live flags (1
// byte each) and writing sel and emask over the whole cap (5 bytes a
// slot), ~14 us at the layer-2 edge compaction's 9.4 M slots; at the
// serving path's smaller sizes, the launch itself.
// ---------------------------------------------------------------------------

constexpr int kCThreads = 512;
constexpr int kCompactItems = 32;                        // flags a thread
constexpr int kCompactTile = kCThreads * kCompactItems;  // flags a tile
constexpr int kFillSlots = 16384;     // cap slots per fill block
constexpr int kFillBlocksMax = 528;   // 4 a SM
constexpr unsigned long long kAggregate = 1, kPrefix = 2;

// Fill blocks of a call: a function of cap alone, so the host sizes the
// grid with it and the device finds the same number.
__host__ __device__ inline int compact_fill_blocks(int cap) {
  const long f = ((long)cap + kFillSlots - 1) / kFillSlots;
  return f < 1 ? 1 : (f > kFillBlocksMax ? kFillBlocksMax : (int)f);
}

__device__ __forceinline__ unsigned long long status_word(
    unsigned epoch, unsigned long long flag, int count) {
  return ((unsigned long long)epoch << 34) | (flag << 32) | (unsigned)count;
}

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// This epoch's flag in a word (0: not ready, or an earlier call's).
__device__ __forceinline__ unsigned status_flag(unsigned long long w,
                                                unsigned epoch) {
  return (w >> 34) == epoch ? (unsigned)(w >> 32) & 3u : 0u;
}

// Warp 0 of tile t (t > 0), after the tile's status word holds its
// aggregate: look back to the nearest inclusive prefix and publish the
// tile's own; returns the exclusive prefix (to every lane).
__device__ int compact_lookback(unsigned long long* status, int t, int agg,
                                unsigned epoch) {
  const int lane = threadIdx.x & 31;
  int excl = 0;
  for (int end = t;; end -= 32) {       // window: tiles end - 1 .. end - 32
    const int idx = end - 1 - lane;
    unsigned long long w = 0;
    unsigned flag;
    for (;;) {
      w = idx >= 0 ? ld_relaxed(status + idx)
                   : status_word(epoch, kPrefix, 0);
      flag = status_flag(w, epoch);
      if (__all_sync(kFull, flag != 0)) break;
      __nanosleep(32);
    }
    const unsigned prefixes = __ballot_sync(kFull, flag == kPrefix);
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    int c = lane <= stop ? (int)(unsigned)w : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(kFull, c, o);
    excl += c;
    if (prefixes) break;
  }
  if (lane == 0)
    st_relaxed(status + t, status_word(epoch, kPrefix, excl + agg));
  return excl;
}

// Warp 0 of a fill block: the sum of the live tiles' aggregate words,
// waiting for each (to every lane).
__device__ int compact_total(const unsigned long long* aggs, int tiles,
                             unsigned epoch) {
  const int lane = threadIdx.x & 31;
  int c = 0;
  for (int t = lane; t < tiles; t += 32) {
    unsigned long long w;
    while (status_flag(w = ld_relaxed(aggs + t), epoch) == 0)
      __nanosleep(64);
    c += (int)(unsigned)w;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(kFull, c, o);
  return c;
}

// sel = 0, emask = 0 over the slots [lo, hi), block `rank` of `ranks`
// taking every ranks-th run of 4 * kCThreads slots (16-byte stores of
// sel, 4-byte of emask where both are aligned).
__device__ void compact_zero(int* sel, uint8_t* emask, long lo, long hi,
                             int rank, int ranks) {
  if (lo >= hi) return;
  const long first = (long)rank * kCThreads + threadIdx.x;
  const long stride = (long)ranks * kCThreads;
  const bool vec = ((uintptr_t)sel & 15) == 0 && ((uintptr_t)emask & 3) == 0;
  long a = hi, b = hi;                   // the aligned middle [a, b)
  if (vec) {
    a = (lo + 3) & ~3L;
    b = hi & ~3L;
    if (a > b) a = b = hi;
  }
  for (long c = lo + first; c < a; c += stride) {
    sel[c] = 0;
    emask[c] = 0;
  }
  for (long q = a / 4 + first; q < b / 4; q += stride) {
    reinterpret_cast<int4*>(sel)[q] = make_int4(0, 0, 0, 0);
    reinterpret_cast<uint32_t*>(emask)[q] = 0;
  }
  for (long c = b + first; c < hi; c += stride) {
    sel[c] = 0;
    emask[c] = 0;
  }
}

// This thread's kCompactItems flags from e0 on, as a mask (bit i: flag
// e0 + i set and e0 + i < n).
__device__ __forceinline__ unsigned compact_bits(const uint8_t* flags,
                                                 long e0, int n) {
  unsigned bits = 0;
  if (e0 + kCompactItems <= n && ((uintptr_t)flags & 15) == 0) {
    const uint4* v = reinterpret_cast<const uint4*>(flags + e0);
    const uint4 x = __ldg(v), y = __ldg(v + 1);
    const unsigned words[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      const unsigned m = __vcmpne4(words[w], 0u);   // 0xff a set byte
#pragma unroll
      for (int k = 0; k < 4; ++k)
        bits |= ((m >> (8 * k + 7)) & 1u) << (4 * w + k);
    }
  } else {
    for (int i = 0; i < kCompactItems; ++i) {
      const long e = e0 + i;
      if (e < n && flags[e]) bits |= 1u << i;
    }
  }
  return bits;
}

// scratch: the ticket, then `tiles` status words, then `tiles` aggregate
// words (tiles = the grid's tile count, ceil(E / kCompactTile)).
__global__ void __launch_bounds__(kCThreads)
compact_kernel(const uint8_t* __restrict__ flags, int E,
               const int* __restrict__ n_live, int cap,
               int* __restrict__ sel, uint8_t* __restrict__ emask,
               int* __restrict__ num, unsigned long long* scratch, int tiles,
               unsigned epoch) {
  __shared__ int s_tile, s_excl;
  unsigned long long* status = scratch + 1;
  unsigned long long* aggs = status + tiles;
  const int n = live_count(n_live, E);
  const int live_tiles = (int)(((long)n + kCompactTile - 1) / kCompactTile);
  if (threadIdx.x == 0) {
    // epochs rise call by call on a stream, so once one block has raised
    // the ticket to this epoch, a later raise changes nothing
    const unsigned long long base = (unsigned long long)epoch << 32;
    if (ld_relaxed(scratch) < base) atomicMax(scratch, base);
    s_tile = (int)(unsigned)atomicAdd(scratch, 1ull);
  }
  __syncthreads();
  const int t = s_tile;

  if (t >= live_tiles) {                  // a fill block
    const int rank = t - live_tiles, ranks = compact_fill_blocks(cap);
    if (rank >= ranks) return;
    const long live_end = n < cap ? n : cap;
    compact_zero(sel, emask, live_end, cap, rank, ranks);
    if (threadIdx.x < 32) {
      const int total = compact_total(aggs, live_tiles, epoch);
      if (threadIdx.x == 0) {
        s_excl = total;
        if (rank == 0) *num = total;
      }
    }
    __syncthreads();
    compact_zero(sel, emask, s_excl < cap ? s_excl : cap, live_end, rank,
                 ranks);
    return;
  }

  const long e0 = (long)t * kCompactTile + (long)threadIdx.x * kCompactItems;
  const unsigned bits = compact_bits(flags, e0, n);
  int agg;
  const int before = block_exclusive_scan<kCThreads>(__popc(bits), &agg);
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) {
      st_relaxed(aggs + t, status_word(epoch, kAggregate, agg));
      st_relaxed(status + t, status_word(epoch, t == 0 ? kPrefix : kAggregate,
                                         agg));
    }
    const int excl = t == 0 ? 0 : compact_lookback(status, t, agg, epoch);
    if (threadIdx.x == 0) s_excl = excl;
  }
  __syncthreads();
  // the warp writes each lane's flags in turn, lane i taking flag i: the
  // ranks of one lane's flags are contiguous, so each store is coalesced
  const int lane = threadIdx.x & 31;
  const unsigned lt = lanemask_lt();
  const int rank0 = s_excl + before;
  for (int src = 0; src < 32; ++src) {
    const unsigned b = __shfl_sync(kFull, bits, src);
    const int r = __shfl_sync(kFull, rank0, src) + __popc(b & lt);
    if ((b >> lane) & 1u && r < cap) {
      sel[r] = (int)(e0 - (long)(lane - src) * kCompactItems + lane);
      emask[r] = 1;
    }
  }
}

// p[i] = f(i) over [lo, hi) by the threads first, first + stride, ...,
// 16-byte streaming stores where p is aligned (these are the cap-wide
// tails of the outputs: evict-first, so they do not push the working set
// out of L2).
template <class F>
__device__ void fill_ints(int* p, long lo, long hi, long first, long stride,
                          F f) {
  if (lo >= hi) return;
  long a = (lo + 3) & ~3L, b = hi & ~3L;     // the aligned middle [a, b)
  if (((uintptr_t)p & 15) != 0 || a > b) a = b = hi;
  for (long c = lo + first; c < a; c += stride) __stcs(p + c, f(c));
  for (long q = a / 4 + first; q < b / 4; q += stride)
    __stcs(reinterpret_cast<int4*>(p) + q,
           make_int4(f(4 * q), f(4 * q + 1), f(4 * q + 2), f(4 * q + 3)));
  for (long c = b + first; c < hi; c += stride) __stcs(p + c, f(c));
}

// ---------------------------------------------------------------------------
// The shared radix sort: a stable LSD sort of (key, value) pairs of int32
// with 8-bit digits, in single-pass form (Adinets and Merrill, "Onesweep: A
// Faster Least Significant Digit Radix Sort for GPUs", 2022). compact_perm
// and hash_dedup both run on it.
//
//  * An upsweep counts the digits of every pass in one read of the keys:
//    each block counts its range in shared memory and adds each non-zero
//    bin into the pass's global row (hist), so the digit totals of every
//    pass are known before the first pass starts. hash_dedup folds this
//    into its insert launch.
//  * Each digit pass is one launch of a persistent grid. A block takes a
//    tile of kSortTile keys by ticket, so tiles follow input order, and
//    ranks its keys stably in shared memory: each warp owns a contiguous
//    run of the tile and ranks it item by item, equal digits among the
//    lanes found with 8 ballots, so a key's rank follows its index.
//    The block publishes its per-digit counts (status words, epoch-tagged
//    as compact's are), stages its keys in shared memory grouped by digit,
//    then looks back over its predecessors' words for its digit, one
//    thread a digit, kLookback words a step, until it meets inclusive
//    prefixes, and publishes its own. Each key's position is the digit's
//    base (a scan of the pass's totals) + the tile's prefix + its rank in
//    the tile; the staged keys go out in tile order, so each digit's run
//    is one contiguous store.
//  * The last pass writes the caller's outputs directly (perm, or `new`
//    and the table's slot values), and its tickets past the last tile
//    fill the outputs' tails, as compact's fill blocks do. No launch is a
//    memset: the digit totals and status words carry the call's epoch (a
//    word of an earlier call reads as zero), the pass tickets are reset by
//    the call's first launch (the upsweep, or hash_dedup's insert), and
//    every launch reads its counts (n_live, or what an earlier launch
//    wrote) on the device.
//
// So a sort of P passes is 1 + P launches, and each pass reads and writes
// its keys once. A pass's grid is the blocks the card holds at once, each
// taking tickets until none is left, so no block is launched for keys past
// the live count. What sets a pass's time on this card is a tile's latency
// (its loads, its ranking, the look-back), at every size: the launches at
// the serving path's layers 0 and 1, the look-back's chain over ~200
// tiles at layer 2.
// ---------------------------------------------------------------------------

constexpr int kDigitBits = 8;
constexpr int kRadix = 1 << kDigitBits;
constexpr int kMaxPasses = 4;                  // 32-bit keys
constexpr int kSThreads = 256;                 // thread d owns digit d
constexpr int kSItems = 16;                    // keys a thread
constexpr int kSWarps = kSThreads / 32;
constexpr int kWarpKeys = 32 * kSItems;
constexpr int kSortTile = kSThreads * kSItems;  // keys a tile
constexpr int kFillChunk = 16384;               // tail slots a fill ticket
static_assert(kRadix == kSThreads, "one digit per thread");

// (epoch << 32) | count words: a word of an earlier epoch reads as 0.
__device__ __forceinline__ unsigned tagged_count(
    const unsigned long long* w, unsigned epoch) {
  const unsigned long long v = ld_relaxed(w);
  return (unsigned)(v >> 32) == epoch ? (unsigned)v : 0u;
}

// Raises a tagged word of an earlier epoch to (epoch, 0). Epochs rise call
// by call on a stream, so once one block raised it, a later raise changes
// nothing; a thread's later atomics to the word apply after its raise.
__device__ __forceinline__ void tagged_raise(unsigned long long* w,
                                             unsigned epoch) {
  const unsigned long long base = (unsigned long long)epoch << 32;
  if (ld_relaxed(w) < base) atomicMax(w, base);
}

// Thread d of a block adds its shared count of digit d for each of the
// first `passes` passes into the global digit totals: the raises' reads
// issue together, and the adds wait on nothing.
__device__ __forceinline__ void flush_hist(unsigned long long* hist,
                                           const int (*s_hist)[kRadix],
                                           int passes, unsigned epoch) {
  const int d = threadIdx.x;
  const unsigned long long base = (unsigned long long)epoch << 32;
  unsigned long long old[kMaxPasses];
#pragma unroll
  for (int p = 0; p < kMaxPasses; ++p)
    old[p] = p < passes && s_hist[p][d] ? ld_relaxed(hist + p * kRadix + d)
                                        : base;
#pragma unroll
  for (int p = 0; p < kMaxPasses; ++p) {
    if (p < passes && s_hist[p][d]) {
      if (old[p] < base) atomicMax(hist + p * kRadix + d, base);
      atomicAdd(hist + p * kRadix + d, (unsigned long long)s_hist[p][d]);
    }
  }
}

// The words of one sort, carved from the caller's tensor of them: at fixed
// offsets the digit totals [kMaxPasses][kRadix], a ticket a pass (a plain
// count, reset by the call's first launch), and hash_dedup's count and
// largest value of new values, the totals, count and value (epoch << 32) |
// count; then the status words [passes][tiles][kRadix]. Every tagged word
// of the tensor is one of these two kinds, whatever E an earlier call had,
// so a word of an earlier epoch can only read as not ready. (A tensor
// shared with raw data could hold an earlier call's raw int that reads as
// this epoch's word.)
struct SortScratch {
  unsigned long long* hist;
  unsigned long long* tickets;
  unsigned long long* count;
  unsigned long long* max;
  unsigned long long* status;
  int tiles;
};

constexpr int kSortHeader = kMaxPasses * kRadix + kMaxPasses + 2;

__host__ __device__ inline int sort_tiles(int E) {
  const long t = ((long)E + kSortTile - 1) / kSortTile;
  return t < 1 ? 1 : (int)t;
}

__host__ inline long long sort_words(int E, int passes) {
  return kSortHeader + (long long)passes * sort_tiles(E) * kRadix;
}

__host__ inline SortScratch carve_sort(unsigned long long* w, int E) {
  SortScratch sc;
  sc.hist = w;
  sc.tickets = w + kMaxPasses * kRadix;
  sc.count = sc.tickets + kMaxPasses;
  sc.max = sc.count + 1;
  sc.status = w + kSortHeader;
  sc.tiles = sort_tiles(E);
  return sc;
}

__device__ __forceinline__ int digit_of(int key, int shift) {
  return (int)(((unsigned)key >> shift) & (kRadix - 1));
}

// status words a digit's thread reads a step (8 measured faster on this
// card than 16 and 32, whose reads crowd L2 when ~200 tiles look back)
constexpr int kLookback = 8;

// Thread d of tile t (t > 0), after the tile's word for digit d holds its
// count: the sum of digit d over tiles 0 .. t-1, read back from the
// nearest inclusive prefix, kLookback words a step (the neighbouring
// digits' threads read neighbouring words); publishes the inclusive prefix
// of tile t. Every tile publishes its counts before it looks back, so when
// all tiles of a pass start together, tile t meets a prefix after about
// t / (2 kLookback) steps.
__device__ int digit_lookback(unsigned long long* status, int t, int d,
                              int count, unsigned epoch) {
  int excl = 0;
  for (int p = t - 1;; p -= kLookback) {
    unsigned long long w[kLookback];
#pragma unroll
    for (int k = 0; k < kLookback; ++k)
      w[k] = p - k >= 0 ? ld_relaxed(status + (long)(p - k) * kRadix + d)
                        : status_word(epoch, kPrefix, 0);
    bool done = false;
#pragma unroll
    for (int k = 0; k < kLookback; ++k) {
      while (status_flag(w[k], epoch) == 0) {
        __nanosleep(32);
        w[k] = ld_relaxed(status + (long)(p - k) * kRadix + d);
      }
      excl += (int)(unsigned)w[k];
      if (status_flag(w[k], epoch) == kPrefix) {
        done = true;
        break;
      }
    }
    if (done) break;
  }
  st_relaxed(status + (long)t * kRadix + d,
             status_word(epoch, kPrefix, excl + count));
  return excl;
}

// What one pass reads and writes. Input: the pairs (keys_in, vals_in), or
// on compact_perm's first pass (raw) the raw keys and flags, keyed valid ?
// clamp(key) + 1 : num_keys + 1 with the index as value. Output: the pairs
// (keys_out, vals_out), or on the last pass compact_perm's perm, or with
// dedup hash_dedup's new values and slot values. (The modes are flags: a
// pointer of an empty tensor is null.)
struct PassIO {
  bool raw;
  const int* keys_in;
  const int* vals_in;
  const int* raw_keys;
  const uint8_t* raw_valid;
  int num_keys;
  int* keys_out;
  int* vals_out;
  bool dedup;      // the last pass writes hash_dedup's outputs, not perm
  int* perm;       // compact_perm's last pass: perm over [0, E)
  int E;
  int* new_out;    // hash_dedup's last pass
  int* tvals;
  int S;
  int new_cap;
  int* num_new;
  uint8_t* overflow;
};

__device__ __forceinline__ int perm_key(int k, bool valid, int num_keys) {
  k = k < -1 ? -1 : (k > num_keys - 1 ? num_keys - 1 : k);
  return valid ? k + 1 : num_keys + 1;
}

// One digit pass over n keys: n is n_live (compact_perm), or with
// `counted` the count hash_dedup's insert wrote (sc.count); its largest
// new value (sc.max) then also says which passes have work: those above
// its highest set bit end at once, and the last with work writes the
// outputs.
__global__ void __launch_bounds__(kSThreads, 2)
sort_pass(PassIO io, SortScratch sc, int pass, int passes,
          const int* n_live, bool counted, unsigned epoch) {
  __shared__ int s_keys[kSortTile];
  __shared__ int s_vals[kSortTile];
  __shared__ int s_wcnt[kSWarps][kRadix];
  __shared__ int s_start[kRadix];   // tile-local start of each digit
  __shared__ int s_off[kRadix];     // global position - tile-local position
  __shared__ int s_tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  int np = passes;
  if (counted) {
    const unsigned m = tagged_count(sc.max, epoch);
    const int bits = 32 - __clz(m);
    np = bits <= kDigitBits ? 1 : (bits + kDigitBits - 1) / kDigitBits;
    if (pass >= np) return;
  }
  const bool last = pass == np - 1;
  const int shift = pass * kDigitBits;
  const int n = counted ? (int)tagged_count(sc.count, epoch)
                        : live_count(n_live, io.E);
  const int live_tiles = (int)(((long)n + kSortTile - 1) / kSortTile);
  long fill_lo = 0, fill_hi = 0;
  if (last && !io.dedup) {
    fill_lo = n;
    fill_hi = io.E;
  } else if (last) {
    fill_lo = n < io.new_cap ? n : io.new_cap;
    fill_hi = io.new_cap;
  }
  const int fill_units =
      last ? (int)(fill_hi > fill_lo
                       ? (fill_hi - fill_lo + kFillChunk - 1) / kFillChunk
                       : 1)
           : 0;
  if (tid == 0) s_tile = (int)atomicAdd(sc.tickets + pass, 1ull);
  // the digit's base: an exclusive scan of the pass's digit totals
  int base_d;
  {
    int total;
    base_d = block_exclusive_scan<kSThreads>(
        (int)tagged_count(sc.hist + pass * kRadix + tid, epoch), &total);
  }
  unsigned long long* status = sc.status + (long)pass * sc.tiles * kRadix;
  const unsigned lt = lanemask_lt();

  for (;;) {                          // s_tile: this round's ticket
    const int t = s_tile;
    if (t >= live_tiles + fill_units) break;
    __syncthreads();                  // every thread has read s_tile
    int next = 0;                     // the next round's, in flight
    if (tid == 0) next = (int)atomicAdd(sc.tickets + pass, 1ull);

    if (t >= live_tiles) {            // a fill ticket: the outputs' tails
      const long lo = fill_lo + (long)(t - live_tiles) * kFillChunk;
      const long hi = lo + kFillChunk < fill_hi ? lo + kFillChunk : fill_hi;
      if (!io.dedup) {
        fill_ints(io.perm, lo, hi, tid, kSThreads,
                  [](long i) { return (int)i; });
      } else {
        fill_ints(io.new_out, lo, hi, tid, kSThreads,
                  [](long) { return -1; });
        if (t == live_tiles && tid == 0) {
          *io.num_new = n;
          *io.overflow = n > io.new_cap ? 1 : 0;
        }
      }
      if (tid == 0) s_tile = next;
      __syncthreads();
      continue;
    }

    // load: lane l's item i is key l + 32 i of its warp's run
    const long t0 = (long)t * kSortTile;
    const int tn = n - t0 < kSortTile ? (int)(n - t0) : kSortTile;
    int key[kSItems], val[kSItems], rank[kSItems];
    const long e0 = t0 + warp * kWarpKeys + lane;
    const int live = tn - warp * kWarpKeys - lane;  // item i live: 32 i < live
    if (io.raw) {             // every load first, then the key transform
      uint8_t ok[kSItems];
#pragma unroll
      for (int i = 0; i < kSItems; ++i) {
        key[i] = 32 * i < live ? io.raw_keys[e0 + 32 * i] : 0;
        ok[i] = 32 * i < live ? io.raw_valid[e0 + 32 * i] : 0;
      }
#pragma unroll
      for (int i = 0; i < kSItems; ++i) {
        key[i] = perm_key(key[i], ok[i], io.num_keys);
        val[i] = (int)(e0 + 32 * i);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kSItems; ++i) {
        key[i] = 32 * i < live ? io.keys_in[e0 + 32 * i] : 0;
        val[i] = 32 * i < live ? io.vals_in[e0 + 32 * i] : 0;
      }
    }
    // rank within the warp's run, item by item, lanes in order
#pragma unroll
    for (int j = 0; j < kRadix / 32; ++j) s_wcnt[warp][lane + 32 * j] = 0;
    __syncwarp();
    // (a digit's lanes in a round: 8 ballots, one a digit bit; the lowest
    // of them adds their number to the warp's counter and gets the count
    // before; a warp's shared-memory atomics apply in issue order, so a
    // key's rank follows its index; the ballots of every round go first,
    // so the atomics issue back to back)
    unsigned peers[kSItems];
#pragma unroll
    for (int i = 0; i < kSItems; ++i) {
      const int d = digit_of(key[i], shift);
      unsigned m = __ballot_sync(kFull, 32 * i < live);
#pragma unroll
      for (int b = 0; b < kDigitBits; ++b) {
        const unsigned on = __ballot_sync(kFull, (d >> b) & 1);
        m &= (d >> b) & 1 ? on : ~on;
      }
      peers[i] = m;
    }
#pragma unroll
    for (int i = 0; i < kSItems; ++i) {
      rank[i] = 0;
      if (32 * i < live && (peers[i] & lt) == 0)
        rank[i] = atomicAdd(&s_wcnt[warp][digit_of(key[i], shift)],
                            __popc(peers[i]));
    }
#pragma unroll
    for (int i = 0; i < kSItems; ++i) {
      const int leader = 32 * i < live ? __ffs(peers[i]) - 1 : lane;
      rank[i] = __shfl_sync(kFull, rank[i], leader) + __popc(peers[i] & lt);
    }
    __syncthreads();
    // thread d: digit d's count in each warp -> prefix over warps
    int count = 0;
#pragma unroll
    for (int w = 0; w < kSWarps; ++w) {
      const int c = s_wcnt[w][tid];
      s_wcnt[w][tid] = count;
      count += c;
    }
    st_relaxed(status + (long)t * kRadix + tid,
               status_word(epoch, t == 0 ? kPrefix : kAggregate, count));
    {
      int total;
      s_start[tid] = block_exclusive_scan<kSThreads>(count, &total);
    }
    __syncthreads();
    // stage the keys in shared memory, grouped by digit
#pragma unroll
    for (int i = 0; i < kSItems; ++i) {
      if (32 * i < live) {
        const int d = digit_of(key[i], shift);
        const int pos = s_start[d] + s_wcnt[warp][d] + rank[i];
        s_keys[pos] = key[i];
        s_vals[pos] = val[i];
      }
    }
    const int excl =
        t == 0 ? 0 : digit_lookback(status, t, tid, count, epoch);
    s_off[tid] = base_d + excl - s_start[tid];
    __syncthreads();
    // write out in tile order: each digit's run is one contiguous store
    for (int j = tid; j < tn; j += kSThreads) {
      const int k = s_keys[j], v = s_vals[j];
      const int g = s_off[digit_of(k, shift)] + j;
      if (!last) {
        io.keys_out[g] = k;
        io.vals_out[g] = v;
      } else if (!io.dedup) {
        io.perm[g] = v;
      } else if (g < io.new_cap) {  // hash_dedup: k a new value, v its slot
        io.new_out[g] = k;
        io.tvals[v] = io.S + g;
      } else {
        io.tvals[v] = -1;           // dropped on overflow
      }
    }
    if (tid == 0) s_tile = next;
    __syncthreads();
  }
}

// Resident blocks of sort_pass on the card: the persistent grid.
int sort_grid(int work) {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sort_pass,
                                                  kSThreads, 0);
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  return work < resident ? (work < 1 ? 1 : work) : resident;
}

// ---------------------------------------------------------------------------
// compact_perm: perm = stable argsort of valid ? key + 1 : K + 1 over the
// live prefix, the entries past it last in index order. An upsweep (the
// key transform folded in) and P = ceil(bits(K + 1) / 8) passes: 3 launches
// at K = 22,272, 4 at 470,656 and 1,083,008. The first pass reads the raw
// keys and flags, the last writes perm over the live prefix while its
// fill tickets write the identity past it.
// What bounds it: the bytes bound at layer 2 of the serving path (9.4 M
// slots, 0.87 M live) is ~13 us, 38 of its 42 MB the perm write over the
// whole cap (streamed by the last pass's fill tickets while its tiles
// sort); the passes themselves take longer, each set by a tile's latency
// and the look-back's chain (see the sort's notes). At layers 0 and 1, a
// pass of a few tiles is one tile's latency, and the launches.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kSThreads)
perm_upsweep(const int* keys, const uint8_t* valid, int E, const int* n_live,
             int num_keys, int passes, SortScratch sc, unsigned epoch) {
  __shared__ int s_hist[kMaxPasses][kRadix];
  if (blockIdx.x == 0 && threadIdx.x < kMaxPasses)
    sc.tickets[threadIdx.x] = 0;      // the passes' tickets, launches later
  const int n = live_count(n_live, E);
  // a block counts one contiguous range of at least a tile
  long per = ((long)n + gridDim.x - 1) / gridDim.x;
  per = per < kSortTile ? kSortTile : per;
  const long lo = (long)blockIdx.x * per;
  if (lo >= n) return;
  const long hi = lo + per < n ? lo + per : n;
  for (int p = 0; p < kMaxPasses; ++p) s_hist[p][threadIdx.x] = 0;
  __syncthreads();
  for (long e = lo + threadIdx.x; e < hi; e += kSThreads) {
    const int k = perm_key(keys[e], valid[e], num_keys);
    for (int p = 0; p < passes; ++p)
      atomicAdd(&s_hist[p][digit_of(k, p * kDigitBits)], 1);
  }
  __syncthreads();
  flush_hist(sc.hist, s_hist, passes, epoch);
}

// ---------------------------------------------------------------------------
// hash_dedup: an open-addressing table (linear probing from home_slot,
// 64-bit CAS inserts) whose part in use is a power of two >= 1.5 (S + n),
// so a probe always ends at a slot of an earlier call. A slot is (epoch <<
// 32) | key; a slot of an earlier epoch is empty, so the table is cached
// per stream and never cleared (zeroed once when the epoch counter wraps).
//   1. seeds: each seed claims its slot, value = its index;
//   2. insert: a repeated seed's slot takes its smallest index (any copy
//      may have claimed it); each live value that claims a slot is new;
//      it is appended,
//      with its slot as payload, to a list (one atomic a block a round),
//      and its four digits are counted for the sort (the upsweep, folded
//      in); the launch records the list's length and largest value, and
//      resets the passes' tickets;
//   3. the list is sorted by the shared radix sort (four launches; passes
//      above the largest value's highest bit end at once): the last pass
//      with work writes new[j] and the slot's value S + j for j < new_cap
//      (-1 past it: dropped on overflow), the -1 tail of new, num_new and
//      overflow;
//   4. lookup: one probe per live value reads its slot's value into slots;
//      slots past the live prefix are -1.
// 7 launches a call, 6 with no seeds; a warm call allocates
// only its four outputs.
// What bounds it: the bytes bound at layer 2 is ~14 us, 38 of its 46 MB
// the slots write over the whole edge cap (streamed, so that it does not
// evict the table from L2); the time goes to the ~1.3 M probes and CAS
// inserts of seeds and values, and to the sort's passes. At layers 0 and
// 1, the launches and the passes' tile latency.
// ---------------------------------------------------------------------------

// Slots of the table for S seeds and E values: a power of two >= 1.5 (S +
// E), so at most 2/3 full. (2 (S + E) at layer 2 is a 48 MB table, which
// the 50 MB L2 does not keep; 1.5 is 24 MB.)
__host__ __device__ inline long dedup_table_cap(int S, int E) {
  const long n = (long)S + E;
  const long need = n + (n + 1) / 2;
  long p = 8;
  while (p < need) p <<= 1;
  return p;
}


struct Table {
  unsigned long long* keys;
  int* vals;
  unsigned mask;
};

__device__ __forceinline__ Table live_table(unsigned long long* keys,
                                            int* vals, int S, int n,
                                            long table_cap) {
  long p = dedup_table_cap(S, n);
  if (p > table_cap) p = table_cap;
  return Table{keys, vals, (unsigned)(p - 1)};
}

// The home slot of v: its bits above the table's width folded twice onto
// the low ones. Vertex ids are dense, so an id below the table's size keeps
// its own slot: the seeds (mostly the previous layer's ascending new
// values) are inserted in address order, and the values' probes fall into
// the few MB of slots that the ids span, which stay in L2. (A mixing hash
// scatters both over the whole table, so that nearly every probe of a
// call misses L2 and waits on device memory.)
__device__ __forceinline__ unsigned home_slot(int v, unsigned mask) {
  const unsigned u = (unsigned)v;
  const int b = __popc(mask);               // log2 of the table's size
  return (u ^ (u >> b) ^ (2 * b < 32 ? u >> (2 * b) : 0u)) & mask;
}

// Returns the slot holding v, starting from w, the word its home slot held
// when read; *claimed tells whether this call put v there.
__device__ unsigned probe_insert(const Table& tb, int v, unsigned long long w,
                                 unsigned epoch, bool* claimed) {
  const unsigned long long mine =
      ((unsigned long long)epoch << 32) | (unsigned)v;
  unsigned slot = home_slot(v, tb.mask);
  for (;;) {
    for (;;) {
      if ((unsigned)(w >> 32) == epoch) {
        if (w == mine) {
          *claimed = false;
          return slot;
        }
        break;                        // another key's: probe on
      }
      const unsigned long long prev = atomicCAS(tb.keys + slot, w, mine);
      if (prev == w) {
        *claimed = true;
        return slot;
      }
      w = prev;
    }
    slot = (slot + 1) & tb.mask;
    w = ld_relaxed(tb.keys + slot);
  }
}

__device__ int probe_find(const Table& tb, int v, unsigned epoch) {
  const unsigned long long mine =
      ((unsigned long long)epoch << 32) | (unsigned)v;
  unsigned slot = home_slot(v, tb.mask);
  for (;;) {
    const unsigned long long w = tb.keys[slot];
    if (w == mine) return (int)slot;
    if ((unsigned)(w >> 32) != epoch) return -1;
    slot = (slot + 1) & tb.mask;
  }
}

// The seeds and the values are inserted up to kIItems a thread a round:
// the values and their home slots' words are read for all of them first,
// so that a round costs one wait on memory, not one a value. Fewer a
// thread when there are few, so that every block of the grid has work.
constexpr int kIItems = 8;
constexpr int kIRound = kSThreads * kIItems;
// The insert's grid: 4 blocks a SM. Each block adds its digit counts for
// four passes into the global totals once, so more blocks cost more
// contended atomics than they hide latency.
constexpr int kInsertGrid = 132 * 4;

__device__ __forceinline__ int items_a_thread(long n) {
  const long threads = (long)gridDim.x * kSThreads;
  const long k = (n + threads - 1) / threads;
  return k < 1 ? 1 : (k > kIItems ? kIItems : (int)k);
}

__global__ void __launch_bounds__(kSThreads)
dedup_seeds(const int* seeds, int S, int E, const int* n_live,
            unsigned long long* tkeys, int* tvals, long table_cap,
            unsigned epoch) {
  const Table tb =
      live_table(tkeys, tvals, S, live_count(n_live, E), table_cap);
  const int items = items_a_thread(S);
  const long round = (long)kSThreads * items;
  for (long b0 = blockIdx.x * round; b0 < S; b0 += gridDim.x * round) {
    int s[kIItems];
    unsigned long long w[kIItems];
#pragma unroll
    for (int i = 0; i < kIItems; ++i) {
      const long idx = b0 + i * kSThreads + threadIdx.x;
      s[i] = i < items && idx < S ? seeds[idx] : -1;
    }
#pragma unroll
    for (int i = 0; i < kIItems; ++i)
      w[i] = s[i] >= 0 ? ld_relaxed(tb.keys + home_slot(s[i], tb.mask)) : 0;
#pragma unroll
    for (int i = 0; i < kIItems; ++i) {
      if (s[i] < 0) continue;
      bool claimed;
      const unsigned slot = probe_insert(tb, s[i], w[i], epoch, &claimed);
      if (claimed) tb.vals[slot] = (int)(b0 + i * kSThreads + threadIdx.x);
    }
  }
}

__global__ void __launch_bounds__(kSThreads)
dedup_insert(const int* values, const uint8_t* vmask, int E,
             const int* n_live, const int* seeds, int S,
             unsigned long long* tkeys, int* tvals, long table_cap,
             int* list_v, int* list_s, SortScratch sc, unsigned epoch) {
  __shared__ int s_hist[kMaxPasses][kRadix];
  __shared__ int s_v[kIRound], s_s[kIRound];  // a round's claims, in order
  __shared__ int s_max, s_first;
  if (blockIdx.x == 0 && threadIdx.x < kMaxPasses)
    sc.tickets[threadIdx.x] = 0;      // the passes' tickets, launches later
  const int n = live_count(n_live, E);
  const Table tb = live_table(tkeys, tvals, S, n, table_cap);
  // A seed value that repeats maps to its first index, as in the plain
  // version (a stable order) and the reference's serial kernel: in
  // dedup_seeds any copy may have claimed the slot, and its store is
  // complete now, so the smallest index of the copies wins here. (A
  // batch of requests may repeat a vertex; the slots on a seed's probe
  // path were taken before it, so the find cannot stop early while values
  // are inserted.)
  for (long i = (long)blockIdx.x * kSThreads + threadIdx.x; i < S;
       i += (long)gridDim.x * kSThreads) {
    const int v = seeds[i];
    if (v < 0) continue;
    const int slot = probe_find(tb, v, epoch);
    if (tb.vals[slot] > (int)i) atomicMin(tb.vals + slot, (int)i);
  }
  for (int p = 0; p < kMaxPasses; ++p) s_hist[p][threadIdx.x] = 0;
  if (threadIdx.x == 0) {
    s_max = -1;
    tagged_raise(sc.count, epoch);    // once a block; the adds then return
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  int vmax = -1;
  const int items = items_a_thread(n);
  const long round = (long)kSThreads * items;
  for (long b0 = blockIdx.x * round; b0 < n; b0 += gridDim.x * round) {
    int v[kIItems];
    unsigned long long w[kIItems];
#pragma unroll
    for (int i = 0; i < kIItems; ++i) {
      const long e = b0 + i * kSThreads + threadIdx.x;
      v[i] = i < items && e < n && vmask[e] ? values[e] : -1;
    }
#pragma unroll
    for (int i = 0; i < kIItems; ++i)
      w[i] = v[i] >= 0 ? ld_relaxed(tb.keys + home_slot(v[i], tb.mask)) : 0;
    unsigned slot[kIItems];
    unsigned claimed = 0;             // bit i: item i is new
#pragma unroll
    for (int i = 0; i < kIItems; ++i) {
      bool c = false;
      slot[i] = v[i] >= 0 ? probe_insert(tb, v[i], w[i], epoch, &c) : 0;
      claimed |= (unsigned)c << i;
    }
    int total;
    int at = block_exclusive_scan<kSThreads>(__popc(claimed), &total);
    if (total == 0) continue;
#pragma unroll
    for (int i = 0; i < kIItems; ++i) {
      if (claimed >> i & 1) {
        s_v[at] = v[i];
        s_s[at] = (int)slot[i];
        ++at;
        for (int p = 0; p < kMaxPasses; ++p)
          atomicAdd(&s_hist[p][digit_of(v[i], p * kDigitBits)], 1);
        vmax = v[i] > vmax ? v[i] : vmax;
      }
    }
    if (threadIdx.x == 0)
      s_first = (int)(unsigned)atomicAdd(sc.count, (unsigned long long)total);
    __syncthreads();
    for (int j = threadIdx.x; j < total; j += kSThreads) {
      list_v[s_first + j] = s_v[j];
      list_s[s_first + j] = s_s[j];
    }
    __syncthreads();                  // s_v, s_s, s_first: the next round's
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    vmax = max(vmax, __shfl_xor_sync(kFull, vmax, o));
  if (lane == 0 && vmax >= 0) atomicMax(&s_max, vmax);
  __syncthreads();
  if (threadIdx.x == 0 && s_max >= 0)
    atomicMax(sc.max, ((unsigned long long)epoch << 32) | (unsigned)s_max);
  flush_hist(sc.hist, s_hist, kMaxPasses, epoch);
}

// slots: one probe per value of the live prefix, then -1 past it (16-byte
// streaming stores).
__global__ void dedup_lookup(const int* values, const uint8_t* vmask, int E,
                             const int* n_live, int S,
                             unsigned long long* tkeys, int* tvals,
                             long table_cap, int* slots, unsigned epoch) {
  const int n = live_count(n_live, E);
  const Table tb = live_table(tkeys, tvals, S, n, table_cap);
  GRID_STRIDE(e, n) {
    int out = -1;
    if (vmask[e]) {
      const int v = values[e];
      if (v >= 0) {
        const int s = probe_find(tb, v, epoch);
        if (s >= 0) out = tb.vals[s];
      }
    }
    __stcs(slots + e, out);
  }
  fill_ints(slots, n, E, (long)blockIdx.x * blockDim.x + threadIdx.x,
            (long)gridDim.x * blockDim.x, [](long) { return -1; });
}
}  // namespace

// compact: one launch of tiles(E) + compact_fill_blocks(cap) blocks.
// scratch: 1 + 2 * tiles(E) words, zero or left by earlier calls on this
// stream with lower epochs (1 <= epoch < 2^30, rising call by call; see
// the compact section).
extern "C" int frontier_compact(const uint8_t* flags, int E,
                                const int* n_live, int cap, int* sel,
                                uint8_t* emask, int* num,
                                unsigned long long* scratch, unsigned epoch,
                                void* stream) {
  if (E < 0 || cap < 0 || epoch == 0 || epoch >= (1u << 30))
    return (int)cudaErrorInvalidValue;
  const int tiles = (int)(((long)E + kCompactTile - 1) / kCompactTile);
  compact_kernel<<<tiles + compact_fill_blocks(cap), kCThreads, 0,
                   (cudaStream_t)stream>>>(flags, E, n_live, cap, sel, emask,
                                           num, scratch, tiles, epoch);
  return (int)cudaGetLastError();
}

// Flags a tile; kernels/frontier/ops.py's _COMPACT_TILE must equal it (a
// card test checks).
extern "C" int frontier_compact_tile() { return kCompactTile; }


namespace {
inline bool bad_epoch(unsigned epoch) {
  return epoch == 0 || epoch >= (1u << 30);
}
}  // namespace

// compact_perm: 1 + passes launches (passes = ceil(bits(num_keys + 1) /
// 8), kernels/frontier/ops.py's _perm_passes). sorts: sort_words(E,
// passes) tagged words, zero or left by earlier calls on this stream with
// lower epochs (1 <= epoch < 2^30, rising call by call); lists: 2 E words
// of any content.
extern "C" int frontier_compact_perm(const int* keys, const uint8_t* valid,
                                     int E, const int* n_live, int num_keys,
                                     int passes, int* perm,
                                     unsigned long long* sorts,
                                     long long sort_cap, int* lists,
                                     long long list_cap, unsigned epoch,
                                     void* stream) {
  if (E < 0 || num_keys < 0 || num_keys > 0x7ffffffd || passes < 1 ||
      passes > kMaxPasses || bad_epoch(epoch) ||
      sort_cap < sort_words(E, passes) || list_cap < 4LL * E)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const SortScratch sc = carve_sort(sorts, E);
  int* ka = lists;
  int* va = ka + E;
  int* kb = va + E;
  int* vb = kb + E;
  perm_upsweep<<<grid_for(E, kSortTile), kSThreads, 0, st>>>(
      keys, valid, E, n_live, num_keys, passes, sc, epoch);
  const int grid = sort_grid(sc.tiles + (E + kFillChunk - 1) / kFillChunk);
  for (int p = 0; p < passes; ++p) {
    PassIO io = {};
    io.E = E;
    io.num_keys = num_keys;
    if (p == 0) {
      io.raw = true;
      io.raw_keys = keys;
      io.raw_valid = valid;
    } else {
      io.keys_in = p % 2 ? ka : kb;
      io.vals_in = p % 2 ? va : vb;
    }
    if (p == passes - 1) {
      io.perm = perm;
    } else {
      io.keys_out = p % 2 ? kb : ka;
      io.vals_out = p % 2 ? vb : va;
    }
    sort_pass<<<grid, kSThreads, 0, st>>>(io, sc, p, passes, n_live, false,
                                          epoch);
  }
  return (int)cudaGetLastError();
}

// hash_dedup: 7 launches (6 with S = 0). sorts: sort_words(E, 4) tagged
// words and table: dedup_table_cap(S, E) table slots, both zero or left by
// earlier calls on this stream with lower epochs; lists: the table's
// values and two lists of (value, slot), dedup_table_cap(S, E) + 4 E ints
// of any content.
extern "C" int frontier_hash_dedup(const int* values, const uint8_t* vmask,
                                   int E, const int* n_live, const int* seeds,
                                   int S, int new_cap, int* new_out,
                                   int* slots, int* num_new,
                                   uint8_t* overflow,
                                   unsigned long long* sorts,
                                   long long sort_cap,
                                   unsigned long long* tkeys,
                                   long long table_cap_given, int* lists,
                                   long long list_cap, unsigned epoch,
                                   void* stream) {
  const long table_cap = dedup_table_cap(S, E);
  if (E < 0 || S < 0 || new_cap < 0 || bad_epoch(epoch) ||
      sort_cap < sort_words(E, kMaxPasses) || table_cap_given < table_cap ||
      list_cap < table_cap + 4LL * E)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const SortScratch sc = carve_sort(sorts, E);
  int* tvals = lists;
  int* va = tvals + table_cap;     // the list: new values, their slots
  int* sa = va + E;
  int* vb = sa + E;
  int* sb = vb + E;
  if (S > 0)
    dedup_seeds<<<grid_for(S, kSThreads), kSThreads, 0, st>>>(
        seeds, S, E, n_live, tkeys, tvals, table_cap, epoch);
  const int insert_grid = grid_for(E, kSThreads);
  dedup_insert<<<insert_grid < kInsertGrid ? insert_grid : kInsertGrid,
                 kSThreads, 0, st>>>(
      values, vmask, E, n_live, seeds, S, tkeys, tvals, table_cap, va, sa,
      sc, epoch);
  const int grid =
      sort_grid(sc.tiles + (new_cap + kFillChunk - 1) / kFillChunk + 1);
  for (int p = 0; p < kMaxPasses; ++p) {
    PassIO io = {};
    io.E = E;
    io.keys_in = p % 2 ? vb : va;
    io.vals_in = p % 2 ? sb : sa;
    io.keys_out = p % 2 ? va : vb;
    io.vals_out = p % 2 ? sa : sb;
    io.dedup = true;
    io.new_out = new_out;
    io.tvals = tvals;
    io.S = S;
    io.new_cap = new_cap;
    io.num_new = num_new;
    io.overflow = overflow;
    sort_pass<<<grid, kSThreads, 0, st>>>(io, sc, p, kMaxPasses, n_live, true,
                                          epoch);
  }
  dedup_lookup<<<grid_for(E, kThreads), kThreads, 0, st>>>(
      values, vmask, E, n_live, S, tkeys, tvals, table_cap, slots, epoch);
  return (int)cudaGetLastError();
}

// Keys a sort tile and bits a digit; kernels/frontier/ops.py's _SORT_TILE
// and _DIGIT_BITS must equal them (a card test checks).
extern "C" int frontier_sort_tile() { return kSortTile; }
extern "C" int frontier_digit_bits() { return kDigitBits; }
