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
// arithmetic to speak of, so they are bound by bytes (device memory at
// 3.35 TB/s) and, at the serving path's sizes (10^4 - 10^6 live elements),
// by launch and synchronisation latency. The TPU kernels ran one grid step
// over a VMEM-resident buffer; here the work is spread over thread blocks.
// compact carries its running count between tiles in one pass (a chained
// scan with decoupled look-back, one launch); the radix sort's digit
// offsets and hash_dedup's counts are separate passes over small arrays
// of per-tile counts.
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
constexpr int kWarps = kThreads / 32;
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

// Exclusive scan of a[0, n) in place by one block of 1024 threads;
// *total_out gets the sum.
__device__ void scan_inplace(int* a, int n, int* total_out) {
  int carry = 0;
  for (int base = 0; base < n; base += 1024) {
    const int i = base + threadIdx.x;
    const int v = i < n ? a[i] : 0;
    int tot;
    const int ex = block_exclusive_scan<1024>(v, &tot);
    if (i < n) a[i] = carry + ex;
    carry += tot;
  }
  if (threadIdx.x == 0 && total_out != nullptr) *total_out = carry;
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

// ---------------------------------------------------------------------------
// LSD radix sort of (key, value) pairs over [0, n) with 8-bit digits, used by
// compact_perm (key = src_slot + 1, value = index) and by hash_dedup (keys
// only: the collected new values). Each pass: per-tile digit histogram
// (digit-major, so one scan per digit row gives every tile's offset), one
// block per digit scans its row, then each tile scatters stably: within a
// round of 256 elements a warp ranks equal digits with __match_any_sync, warps
// are ordered by a shared per-digit prefix, rounds run in order. An atomic
// counting sort would not be stable: its placement order is the atomics'.
// ---------------------------------------------------------------------------

constexpr int kRadixBits = 8;
constexpr int kRadix = 1 << kRadixBits;  // == kThreads: thread t owns digit t
constexpr int kRadixItems = 8;
constexpr int kRadixTile = kThreads * kRadixItems;
static_assert(kRadix == kThreads, "one digit per thread");

__global__ void radix_hist(const int* keys, int E, const int* n_live,
                           int shift, int* hist, int tiles_cap) {
  const int n = live_count(n_live, E);
  const long base = (long)blockIdx.x * kRadixTile;
  if (base >= n) return;
  __shared__ int s_hist[kRadix];
  s_hist[threadIdx.x] = 0;
  __syncthreads();
  for (int i = 0; i < kRadixItems; ++i) {
    const long e = base + (long)i * kThreads + threadIdx.x;
    if (e < n)
      atomicAdd(&s_hist[((unsigned)keys[e] >> shift) & (kRadix - 1)], 1);
  }
  __syncthreads();
  hist[(long)threadIdx.x * tiles_cap + blockIdx.x] = s_hist[threadIdx.x];
}

__global__ void radix_scan(int* hist, int E, const int* n_live, int tiles_cap,
                           int* totals) {
  const int n = live_count(n_live, E);
  scan_inplace(hist + (long)blockIdx.x * tiles_cap,
               (n + kRadixTile - 1) / kRadixTile, totals + blockIdx.x);
}

__global__ void radix_scatter(const int* keys_in, const int* vals_in, int E,
                              const int* n_live, int shift, const int* hist,
                              int tiles_cap, const int* totals, int* keys_out,
                              int* vals_out) {
  const int n = live_count(n_live, E);
  const long base = (long)blockIdx.x * kRadixTile;
  if (base >= n) return;
  __shared__ int s_base[kRadix];
  __shared__ int s_run[kRadix];
  __shared__ int s_cnt[kWarps][kRadix];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  {
    int tot;
    const int ex = block_exclusive_scan<kThreads>(totals[tid], &tot);
    s_base[tid] = ex + hist[(long)tid * tiles_cap + blockIdx.x];
    s_run[tid] = 0;
  }
  for (int w = 0; w < kWarps; ++w) s_cnt[w][tid] = 0;
  __syncthreads();
  const unsigned lt = lanemask_lt();
  for (int i = 0; i < kRadixItems; ++i) {
    const long e = base + (long)i * kThreads + tid;
    const bool active = e < n;
    const int key = active ? keys_in[e] : 0;
    const int val = (active && vals_in != nullptr) ? vals_in[e] : 0;
    // inactive lanes get a digit no other lane has
    const int d = active ? (int)(((unsigned)key >> shift) & (kRadix - 1))
                         : kRadix + lane;
    const unsigned peers = __match_any_sync(kFull, d);
    const int rank = __popc(peers & lt);
    if (active && rank == 0) s_cnt[warp][d] = __popc(peers);
    __syncthreads();
    {  // thread tid: prefix of digit tid over warps, after earlier rounds
      int acc = s_run[tid];
      for (int w = 0; w < kWarps; ++w) {
        const int c = s_cnt[w][tid];
        s_cnt[w][tid] = acc;
        acc += c;
      }
      s_run[tid] = acc;
    }
    __syncthreads();
    if (active) {
      const int pos = s_base[d] + s_cnt[warp][d] + rank;
      keys_out[pos] = key;
      if (vals_out != nullptr) vals_out[pos] = val;
    }
    __syncthreads();
    for (int w = 0; w < kWarps; ++w) s_cnt[w][tid] = 0;
    __syncthreads();
  }
}

// Sorts the first *n_live (at most E) pairs by the low `bits` bits of the
// key; returns 0 if the result is in (ka, va), 1 if in (kb, vb). The value
// buffers may be null (keys only).
int radix_sort(int* ka, int* va, int* kb, int* vb, int E, const int* n_live,
               int bits, int* hist, int* totals, cudaStream_t st) {
  int tiles_cap = (E + kRadixTile - 1) / kRadixTile;
  if (tiles_cap < 1) tiles_cap = 1;
  int cur = 0;
  for (int shift = 0; shift < bits; shift += kRadixBits) {
    int* kin = cur ? kb : ka;
    int* vin = cur ? vb : va;
    int* kout = cur ? ka : kb;
    int* vout = cur ? va : vb;
    radix_hist<<<tiles_cap, kThreads, 0, st>>>(kin, E, n_live, shift, hist,
                                               tiles_cap);
    radix_scan<<<kRadix, 1024, 0, st>>>(hist, E, n_live, tiles_cap, totals);
    radix_scatter<<<tiles_cap, kThreads, 0, st>>>(
        kin, vin, E, n_live, shift, hist, tiles_cap, totals, kout, vout);
    cur ^= 1;
  }
  return cur;
}

// ---------------------------------------------------------------------------
// compact_perm: perm = stable argsort of eff = valid ? key + 1 : K + 1.
// ---------------------------------------------------------------------------

__global__ void perm_prep(const int* keys, const uint8_t* valid, int E,
                          const int* n_live, int num_keys, int* key_out,
                          int* val_out) {
  const int n = live_count(n_live, E);
  GRID_STRIDE(i, n) {
    int k = keys[i];
    k = k < -1 ? -1 : (k > num_keys - 1 ? num_keys - 1 : k);
    key_out[i] = valid[i] ? k + 1 : num_keys + 1;
    val_out[i] = (int)i;
  }
}

__global__ void perm_finish(const int* vals, int E, const int* n_live,
                            int* perm) {
  const int n = live_count(n_live, E);
  // entries past the live prefix are invalid: last, in index order
  GRID_STRIDE(i, E) { perm[i] = i < n ? vals[i] : (int)i; }
}

// ---------------------------------------------------------------------------
// hash_dedup: an open-addressing table (linear probing, atomicCAS inserts)
// sized to a power of two >= 2 (S + n), so a probe always ends at an empty
// slot. Seeds go in first (value = seed index), so a value equal to a seed
// is never new; each value whose insert claims a slot is appended to a list
// with an atomic counter (the exact count of distinct new values). The list
// is radix-sorted (its order is the atomics', the sorted set is not), the
// smallest new_cap values become `new`, and their slots S + j are written
// back into the table; one probe per value then reads its slot. A dropped
// value keeps slot -1.
// ---------------------------------------------------------------------------

constexpr int kEmpty = -1;

__device__ __forceinline__ unsigned hash32(unsigned x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// meta[0] = table mask, meta[1] = distinct new values, meta[2] = live values
__global__ void dedup_setup(int E, const int* n_live, int S, int table_cap,
                            int* meta) {
  const int n = live_count(n_live, E);
  const long need = 2L * ((long)S + n);
  long p = 8;
  while (p < need) p <<= 1;
  if (p > table_cap) p = table_cap;
  meta[0] = (int)(p - 1);
  meta[1] = 0;
  meta[2] = n;
}

__global__ void dedup_clear(const int* meta, int* tbl_keys) {
  const long size = (long)meta[0] + 1;
  GRID_STRIDE(i, size) { tbl_keys[i] = kEmpty; }
}

// Returns the slot holding v; *claimed tells whether this call put it there.
__device__ unsigned probe_insert(int* tbl_keys, unsigned mask, int v,
                                 bool* claimed) {
  unsigned slot = hash32((unsigned)v) & mask;
  while (true) {
    const int k = __ldcg(tbl_keys + slot);
    if (k == v) {
      *claimed = false;
      return slot;
    }
    if (k == kEmpty) {
      const int prev = atomicCAS(tbl_keys + slot, kEmpty, v);
      if (prev == kEmpty || prev == v) {
        *claimed = prev == kEmpty;
        return slot;
      }
    }
    slot = (slot + 1) & mask;
  }
}

__device__ int probe_find(const int* tbl_keys, unsigned mask, int v) {
  unsigned slot = hash32((unsigned)v) & mask;
  while (true) {
    const int k = tbl_keys[slot];
    if (k == v) return (int)slot;
    if (k == kEmpty) return -1;
    slot = (slot + 1) & mask;
  }
}

__global__ void dedup_insert_seeds(const int* seeds, int S, const int* meta,
                                   int* tbl_keys, int* tbl_vals) {
  const unsigned mask = (unsigned)meta[0];
  GRID_STRIDE(i, S) {
    const int s = seeds[i];
    if (s < 0) continue;
    bool claimed;
    const unsigned slot = probe_insert(tbl_keys, mask, s, &claimed);
    if (claimed) tbl_vals[slot] = (int)i;
  }
}

__global__ void dedup_insert_values(const int* values, const uint8_t* vmask,
                                    int* meta, int* tbl_keys, int* tbl_vals,
                                    int* raw) {
  const unsigned mask = (unsigned)meta[0];
  const int n = meta[2];
  GRID_STRIDE(e, n) {
    const int v = values[e];
    if (!vmask[e] || v < 0) continue;
    bool claimed;
    const unsigned slot = probe_insert(tbl_keys, mask, v, &claimed);
    if (claimed) {
      tbl_vals[slot] = -1;
      raw[atomicAdd(meta + 1, 1)] = v;
    }
  }
}

__global__ void dedup_assign(const int* sorted, int S, int new_cap,
                             const int* meta, const int* tbl_keys,
                             int* tbl_vals, int* new_out, int* num_new,
                             uint8_t* overflow) {
  const unsigned mask = (unsigned)meta[0];
  const int cnt = meta[1];
  const int m = cnt < new_cap ? cnt : new_cap;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *num_new = cnt;
    *overflow = cnt > new_cap ? 1 : 0;
  }
  GRID_STRIDE(j, new_cap) {
    if (j < m) {
      const int v = sorted[j];
      new_out[j] = v;
      tbl_vals[probe_find(tbl_keys, mask, v)] = S + (int)j;
    } else {
      new_out[j] = -1;
    }
  }
}

__global__ void dedup_lookup(const int* values, const uint8_t* vmask, int E,
                             const int* meta, const int* tbl_keys,
                             const int* tbl_vals, int* slots) {
  const unsigned mask = (unsigned)meta[0];
  const int n = meta[2];
  GRID_STRIDE(e, E) {
    int out = -1;
    if (e < n) {
      const int v = values[e];
      if (vmask[e] && v >= 0) {
        const int s = probe_find(tbl_keys, mask, v);
        if (s >= 0) out = tbl_vals[s];
      }
    }
    slots[e] = out;
  }
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

extern "C" int frontier_compact_perm(const int* keys, const uint8_t* valid,
                                     int E, const int* n_live, int num_keys,
                                     int bits, int* perm, int* ka, int* va,
                                     int* kb, int* vb, int* hist, int* totals,
                                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  perm_prep<<<grid_for(E, kThreads), kThreads, 0, st>>>(keys, valid, E, n_live,
                                                        num_keys, ka, va);
  const int cur = radix_sort(ka, va, kb, vb, E, n_live, bits, hist, totals, st);
  perm_finish<<<grid_for(E, kThreads), kThreads, 0, st>>>(cur ? vb : va, E,
                                                          n_live, perm);
  return (int)cudaGetLastError();
}

extern "C" int frontier_hash_dedup(const int* values, const uint8_t* vmask,
                                   int E, const int* n_live, const int* seeds,
                                   int S, int new_cap, int table_cap,
                                   int* tbl_keys, int* tbl_vals, int* raw_a,
                                   int* raw_b, int* hist, int* totals,
                                   int* meta, int* new_out, int* slots,
                                   int* num_new, uint8_t* overflow,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dedup_setup<<<1, 1, 0, st>>>(E, n_live, S, table_cap, meta);
  dedup_clear<<<grid_for(table_cap, kThreads), kThreads, 0, st>>>(meta,
                                                                  tbl_keys);
  if (S > 0)
    dedup_insert_seeds<<<grid_for(S, kThreads), kThreads, 0, st>>>(
        seeds, S, meta, tbl_keys, tbl_vals);
  if (E > 0)
    dedup_insert_values<<<grid_for(E, kThreads), kThreads, 0, st>>>(
        values, vmask, meta, tbl_keys, tbl_vals, raw_a);
  // the new values are vertex ids in [0, 2^31): 31 key bits
  const int cur = radix_sort(raw_a, nullptr, raw_b, nullptr, E, meta + 1, 31,
                             hist, totals, st);
  dedup_assign<<<grid_for(new_cap, kThreads), kThreads, 0, st>>>(
      cur ? raw_b : raw_a, S, new_cap, meta, tbl_keys, tbl_vals, new_out,
      num_new, overflow);
  dedup_lookup<<<grid_for(E, kThreads), kThreads, 0, st>>>(
      values, vmask, E, meta, tbl_keys, tbl_vals, slots);
  return (int)cudaGetLastError();
}
