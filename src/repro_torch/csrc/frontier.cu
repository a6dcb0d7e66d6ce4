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
// over a VMEM-resident buffer; here the work is spread over thread blocks,
// and every cross-block dependency (a running count, a digit offset) is a
// separate pass over a small array of per-tile counts instead of a carry
// between sequential grid steps.
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
// Three passes over tiles of 4096 flags: per-tile counts (ballot/popc), one
// scan of the tile counts, then each tile writes its set indices at their
// ranks, in order (ballot prefix within a warp, warp prefix within a round,
// rounds in order), so the output keeps arrival order by construction.
// ---------------------------------------------------------------------------

constexpr int kCompactItems = 16;
constexpr int kCompactTile = kThreads * kCompactItems;

__global__ void compact_count(const uint8_t* flags, int E, const int* n_live,
                              int* tile_counts) {
  const int n = live_count(n_live, E);
  const long base = (long)blockIdx.x * kCompactTile;
  if (base >= n) return;
  int c = 0;
  for (int i = 0; i < kCompactItems; ++i) {
    const long e = base + (long)i * kThreads + threadIdx.x;
    c += (e < n && flags[e]) ? 1 : 0;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(kFull, c, o);
  __shared__ int s[kWarps];
  if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int w = 0; w < kWarps; ++w) t += s[w];
    tile_counts[blockIdx.x] = t;
  }
}

__global__ void compact_scan(int* tile_counts, int E, const int* n_live,
                             int* num) {
  const int n = live_count(n_live, E);
  scan_inplace(tile_counts, (n + kCompactTile - 1) / kCompactTile, num);
}

__global__ void compact_scatter(const uint8_t* flags, int E,
                                const int* n_live, const int* tile_offsets,
                                int cap, int* sel) {
  const int n = live_count(n_live, E);
  const long base = (long)blockIdx.x * kCompactTile;
  if (base >= n) return;
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = lanemask_lt();
  int running = tile_offsets[blockIdx.x];
  for (int i = 0; i < kCompactItems; ++i) {
    const long e = base + (long)i * kThreads + threadIdx.x;
    const bool f = e < n && flags[e];
    const unsigned b = __ballot_sync(kFull, f);
    if (lane == 0) s_warp[warp] = __popc(b);
    __syncthreads();
    int before = 0, round_total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_warp[w];
      before += w < warp ? c : 0;
      round_total += c;
    }
    if (f) {
      const int rank = running + before + __popc(b & lt);
      if (rank < cap) sel[rank] = (int)e;
    }
    running += round_total;
    __syncthreads();
  }
}

__global__ void compact_fill(int cap, const int* num, int* sel,
                             uint8_t* emask) {
  const int m = *num < cap ? *num : cap;
  GRID_STRIDE(c, cap) {
    if (c >= m) sel[c] = 0;
    emask[c] = c < m ? 1 : 0;
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

extern "C" int frontier_compact(const uint8_t* flags, int E,
                                const int* n_live, int cap, int* sel,
                                uint8_t* emask, int* num, int* tile_counts,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int tiles = (E + kCompactTile - 1) / kCompactTile;
  if (tiles > 0)
    compact_count<<<tiles, kThreads, 0, st>>>(flags, E, n_live, tile_counts);
  compact_scan<<<1, 1024, 0, st>>>(tile_counts, E, n_live, num);
  if (tiles > 0)
    compact_scatter<<<tiles, kThreads, 0, st>>>(flags, E, n_live, tile_counts,
                                                cap, sel);
  if (cap > 0)
    compact_fill<<<grid_for(cap, kThreads), kThreads, 0, st>>>(cap, num, sel,
                                                               emask);
  return (int)cudaGetLastError();
}

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
