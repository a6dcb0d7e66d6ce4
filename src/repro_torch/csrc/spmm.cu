// Hopper (sm_90a) kernels for the graph ops of a sampled block:
//
//   spmm_rows: the weighted SpMM (ops.aggregate): out[s] = sum over edges e
//     with dst[e] = s and mask[e] of w[e] * h[src[e]], for every one of the S
//     output rows. The aggregate's backward for h is the same kernel with
//     the roles swapped (the transposed SpMM), reading the edges through the
//     block's src_perm (edge i of the sweep is edge perm[i]) so that its
//     "dst", the edges' src_slot, is sorted too.
//   scatter_rows: the same kernel with the edge's own value row and no
//     weight, out[s] = sum over edges e with dst[e] = s and mask[e] of
//     values[e] (ops.scatter_edges, the backward of ops.gather_dst and the
//     inner segment sum of the edge_softmax backward). Through src_perm, with
//     the edges' src_slot as "dst", it is the backward of ops.gather_src:
//     each source row sums its edges' gradient rows in a fixed order, where
//     an index_put_ with accumulate would add them atomically, in an order
//     that changes from run to run.
//   gather_dst_rows: out[e] = rows[dst[e]] for the live, masked-in edges and
//     0 for every other edge (ops.gather_dst), the destination half of the
//     SDDMM that is the aggregate's gradient for the edge weights.
//
// spmm_rows and scatter_rows replace the TPU kernel
// repro/kernels/spmm/spmm.py _spmm_kernel (spmm_sorted, and
// scatter_sorted_block, its per-edge-value form), which multiplies a
// one-hot edges-to-rows matrix on the MXU over row-block-aligned chunks
// (prepare_chunks) because scatters are slow there. That layout is not
// carried over: on this card a gather-reduce over the sorted segments fits
// better. The sampler's valid edges are a dst-sorted prefix of length n_live
// (compact keeps the segment order of expand_seed_edges).
//
// The forward SpMM (no perm) is one launch, spmm_forward_kernel, with no
// offsets pass and no scratch: a group of lanes fitted to the width (half a
// warp up to 64 columns, a float4 a lane up to 128, two up to 256) takes a
// chunk of 32 (or 16) consecutive live edges, loads their keys and indices
// and those of the next 32 edges coalesced into registers (one edge a
// lane, one round trip) and sums the rows that start in the chunk in edge
// order, two edges' value loads in flight. The rows past the last live key
// (most of the output at the deepest layer, where the rows are the
// previous layer's vertex cap) are zeroed by one flat float4 fill, the
// empty rows between keys by the group that finds them. A row of more
// than kHeavyEdges edges is queued in shared memory and summed by the
// whole block once its groups are done. At most 64 registers a thread
// (32 warps an SM).
//
// The transposed form (through perm) and scatter_rows keep three kernels:
//
//   row_offsets: one pass over the live prefix writes row_start[r], the
//     index of the first edge whose key (dst, or in the transposed call the
//     key of edge perm[i]) is >= r, for r = 0 .. num_rows. Each edge reads
//     its key and its predecessor's once (through perm when it is given)
//     and writes the offsets of the rows between them, a wide gap with the
//     help of its whole block; rows up to the first key and past the last
//     one are written by a grid-stride sweep, so a long run of empty rows
//     costs no thread more than its share. n_live is read on the device.
//     Keys of -1 (sources an overflowing dedup dropped) sort first and
//     match no row; keys >= num_rows match none either.
//   row sums: one warp per output row reads its two offsets and sums the
//     row's edges in edge order: each edge's index (perm, mask, src, w) is
//     loaded once per warp, by one lane of a batch of 32 and shuffled to the
//     others, and its value row (up to 256 floats, 8 a lane, as two float4
//     where the width and alignment allow) is gathered coalesced, 4 edges'
//     loads in flight; wider rows take more passes. Rows with no edge only
//     write zeros. The kernel keeps few registers, so that many warps hide
//     the latency of rows that are mostly short or empty.
//   heavy sums: a row of more than 128 edges (a popular source in the
//     transposed call holds thousands) would stall one warp for its whole
//     sequential sum and set the kernel's tail; the row sums list it
//     instead (a device counter: the list's order varies, each row's sum
//     does not), and a block of 8 warps per listed row sums it, 32 columns
//     a warp, from edge indices staged 1024 at a time in shared memory,
//     64 edges' loads in flight per warp.
//
// No sum is atomic: the result is deterministic, and each product is
// rounded before it is added, in edge order, as in the plain version, so
// only the order of the sums can differ from it (the earlier version of
// this file, which searched each row's range with two binary searches per
// warp and column slice, gives the same bits).
//
// What bounds them: bytes. The forward kernel reads each live edge's key
// and indices once (13 bytes) and its value row, and writes the output
// once. The offsets pass reads each live key once (4
// bytes, 8 through perm) and writes 4 (num_rows + 1) bytes; the sums read
// two offsets a row, each live edge's indices (5 to 13 bytes) and one value
// row (F floats), and write num_rows x F floats. The arithmetic is 1-2
// flops per gathered float, far below the card's ratio of flops to bytes.
// A width below 256 leaves lanes of the warp idle (F = 1 for an
// edge_softmax with one head). A heavy row is bound by its sequential sum's
// latency instead: 64 edges a round trip per warp. The forward kernel's
// gathers of random source rows at the deepest layer miss the L2 more
// often than the bound assumes (it counts each distinct row once).
//
// gather_dst_rows replaces repro/kernels/spmm/spmm.py _gather_kernel
// (gather_rows_sorted, via gather_dst_block), which multiplies a one-hot
// rows-to-edges matrix on the MXU. Here it is a plain row copy: one warp per
// (edge, 128-column slice), coalesced over the columns as in spmm_rows. It
// is bound by bytes (E x F floats written, one row read per live edge). A
// masked, out-of-range or -1 row index reads nothing: torch would wrap a
// negative index to the last row.
//
// Launches on the given stream, synchronises nothing, returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlice = 128;             // columns per warp (gather_dst_rows)
constexpr int kPerLane = kSlice / 32;
constexpr int kRowCols = 256;           // columns per warp and pass (sums)
constexpr int kHeavyEdges = 128;        // longer rows: heavy_sums_kernel
constexpr int kGapSerial = 32;          // wider gaps: filled by the block
constexpr int kChunk = 1024;            // edge indices a heavy block stages
constexpr int kDeep = 64;               // value loads in flight, heavy warp
constexpr long kGridCap = 132 * 64;
constexpr long kForwardGridCap = 132 * 16;

__device__ __forceinline__ int live_count(const int* n_live, int E) {
  if (n_live == nullptr) return E;
  const int n = *n_live;
  return n < 0 ? 0 : (n < E ? n : E);
}

// Key of edge i of the sweep: key[i], or key[perm[i]] in the transposed call.
__device__ __forceinline__ int key_at(const int* key, const int* perm,
                                      int i) {
  return key[perm != nullptr ? perm[i] : i];
}

// row_start[r] = #{i < n : key(i) < r} for r = 0 .. num_rows, over the
// sorted live prefix. Index j < num_rows + 1 of the grid-stride sweep is a
// row: 0 up to the first key, n past the last; index num_rows + 1 + i, for
// i in [1, n), is a boundary between edges i - 1 and i, which writes i for
// the rows r with key(i - 1) < r <= key(i) (clamped to [0, num_rows]). A
// boundary thread writes a gap of up to kGapSerial rows itself; a wider gap
// (the slots of a block's sources can jump by hundreds of thousands) goes
// on a queue in shared memory that the whole block then fills.
__global__ void row_offsets_kernel(const int* key, const int* perm, int E,
                                   const int* n_live, int num_rows,
                                   int* row_start) {
  __shared__ int q_lo[kThreads], q_hi[kThreads], q_val[kThreads];
  __shared__ int q_n;
  const int n = live_count(n_live, E);
  const int first = n > 0 ? key_at(key, perm, 0) : 0;
  const int last = n > 0 ? key_at(key, perm, n - 1) : -1;
  const long rows = (long)num_rows + 1;
  const long items = rows + (n > 1 ? n - 1 : 0);
  // block-uniform trip count: the queue's barriers need every thread
  for (long base = (long)blockIdx.x * blockDim.x; base < items;
       base += (long)gridDim.x * blockDim.x) {
    if (threadIdx.x == 0) q_n = 0;
    __syncthreads();
    const long j = base + threadIdx.x;
    if (j < rows) {
      const int r = (int)j;
      if (n == 0 || r <= first) row_start[r] = 0;
      else if (r > last) row_start[r] = n;
    } else if (j < items) {
      const int i = (int)(j - rows) + 1;
      const int lo = max(key_at(key, perm, i - 1) + 1, 0);
      const int hi = min(key_at(key, perm, i), num_rows);
      if (hi - lo < kGapSerial) {
        for (int r = lo; r <= hi; ++r) row_start[r] = i;
      } else {
        const int q = atomicAdd(&q_n, 1);
        q_lo[q] = lo;
        q_hi[q] = hi;
        q_val[q] = i;
      }
    }
    __syncthreads();
    for (int q = 0; q < q_n; ++q)
      for (int r = q_lo[q] + threadIdx.x; r <= q_hi[q]; r += blockDim.x)
        row_start[r] = q_val[q];
    __syncthreads();   // the queue is read before the next round resets it
  }
}

// One warp per output row: the row's edges row_start[row] ..
// row_start[row + 1] - 1 in edge order, up to 256 columns a pass (wider rows
// take more passes). kVec: the lane's columns are c0 + 4 lane + {0..3} and
// c0 + 128 + 4 lane + {0..3}, read as two float4 (F % 4 == 0, 16-byte
// aligned rows); else c0 + lane + 32 k. A row of more than kHeavyEdges
// edges is left to heavy_sums_kernel: its index goes on the heavy list.
// kEdgeValues: the value row of edge e is h[e] itself, unweighted
// (scatter_rows); otherwise w[e] * h[src[e]] (spmm_rows).
template <bool kEdgeValues, bool kVec>
__global__ void row_sums_kernel(const int* row_start, const int* src,
                                const float* w, const uint8_t* mask,
                                const int* perm, const float* h, int T, int F,
                                int S, float* out, int* heavy_count,
                                int* heavy_rows) {
  const int passes = (F + kRowCols - 1) / kRowCols;
  const long items = (long)S * passes;
  const long nwarps = ((long)gridDim.x * blockDim.x) >> 5;
  const int lane = threadIdx.x & 31;
  for (long it = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       it < items; it += nwarps) {
    const int row = (int)(it / passes);
    const int c0 = (int)(it % passes) * kRowCols;
    const int lo = row_start[row], hi = row_start[row + 1];
    if (hi - lo > kHeavyEdges) {
      if (c0 == 0 && lane == 0) heavy_rows[atomicAdd(heavy_count, 1)] = row;
      continue;
    }
    int col[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      col[k] = kVec ? c0 + 128 * (k / 4) + 4 * lane + k % 4
                    : c0 + lane + 32 * k;
    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.f;
    for (int base = lo; base < hi; base += 32) {
      // lane l loads the indices of edge base + l
      int e = 0, ok = 0;
      float we = 0.f;
      if (base + lane < hi) {
        e = perm != nullptr ? perm[base + lane] : base + lane;
        ok = mask[e];
        if (!kEdgeValues && ok) {
          int sv = src[e];
          if (sv < 0) sv += T;  // the plain version's negative-index wrap
          we = w[e];
          e = sv;               // the value row to read
        }
      }
      // four edges at a time, their loads in flight together; a masked
      // or missing edge adds 0, which leaves the sum's bits as they are
      // (it starts at +0 and is never -0)
      const int cnt = min(32, hi - base);
      for (int j0 = 0; j0 < cnt; j0 += 4) {
        float x[4][8], wj[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = (j0 + u) & 31;
          const bool use = __shfl_sync(0xffffffffu, ok, j) && j0 + u < cnt;
          const float* vr = h + (long)__shfl_sync(0xffffffffu, e, j) * F;
          wj[u] = __shfl_sync(0xffffffffu, we, j);
          if (kVec) {
#pragma unroll
            for (int k = 0; k < 8; k += 4) {
              float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
              if (use && col[k] < F) q = __ldg((const float4*)(vr + col[k]));
              x[u][k] = q.x;
              x[u][k + 1] = q.y;
              x[u][k + 2] = q.z;
              x[u][k + 3] = q.w;
            }
          } else {
#pragma unroll
            for (int k = 0; k < 8; ++k)
              x[u][k] = use && col[k] < F ? __ldg(vr + col[k]) : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int k = 0; k < 8; ++k)
            acc[k] = __fadd_rn(
                acc[k], kEdgeValues ? x[u][k] : __fmul_rn(x[u][k], wj[u]));
      }
    }
    float* o = out + (long)row * F;
    if (kVec) {
#pragma unroll
      for (int k = 0; k < 8; k += 4)
        if (col[k] < F)
          *(float4*)(o + col[k]) =
              make_float4(acc[k], acc[k + 1], acc[k + 2], acc[k + 3]);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (col[k] < F) o[col[k]] = acc[k];
    }
  }
}

// The rows of more than kHeavyEdges edges (a popular source in the
// transposed call holds thousands), one block of 8 warps per row: warp w
// sums columns 32 w + lane (+ 256 per pass) over the row's edges in edge
// order, as row_sums_kernel does. The block stages the indices of
// kChunk edges at a time in shared memory, and each warp keeps kDeep
// edges' value loads in flight, where a light warp keeps 4.
template <bool kEdgeValues>
__global__ void heavy_sums_kernel(const int* row_start, const int* src,
                                  const float* w, const uint8_t* mask,
                                  const int* perm, const float* h, int T,
                                  int F, float* out, const int* heavy_count,
                                  const int* heavy_rows) {
  __shared__ int s_e[kChunk];
  __shared__ float s_w[kChunk];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_heavy = *heavy_count;
  for (int item = blockIdx.x; item < n_heavy; item += gridDim.x) {
    const int row = heavy_rows[item];
    const int lo = row_start[row], hi = row_start[row + 1];
    for (int c0 = 0; c0 < F; c0 += kThreads) {
      const int c = c0 + 32 * warp + lane;
      float acc = 0.f;
      for (int base = lo; base < hi; base += kChunk) {
        const int cnt = min(kChunk, hi - base);
        __syncthreads();   // the previous chunk is consumed
        for (int j = threadIdx.x; j < cnt; j += kThreads) {
          int e = perm != nullptr ? perm[base + j] : base + j;
          float we = 0.f;
          if (!mask[e]) {
            e = -1;            // masked: skipped
          } else if (!kEdgeValues) {
            int sv = src[e];
            if (sv < 0) sv += T;
            we = w[e];
            e = sv;
          }
          s_e[j] = e;
          s_w[j] = we;
        }
        __syncthreads();
        if (c0 + 32 * warp >= F) continue;   // no column of this warp
        for (int j0 = 0; j0 < cnt; j0 += kDeep) {
          float x[kDeep];
#pragma unroll
          for (int u = 0; u < kDeep; ++u) {
            const int e = j0 + u < cnt ? s_e[j0 + u] : -1;
            x[u] = e >= 0 && c < F ? __ldg(h + (long)e * F + c) : 0.f;
          }
#pragma unroll
          for (int u = 0; u < kDeep; ++u) {
            if (kEdgeValues) {
              acc = __fadd_rn(acc, x[u]);
            } else {
              const float we = j0 + u < cnt ? s_w[j0 + u] : 0.f;
              acc = __fadd_rn(acc, __fmul_rn(x[u], we));
            }
          }
        }
      }
      if (c < F) out[(long)row * F + c] = acc;
    }
  }
}

// ---- the forward SpMM (dst-sorted, unpermuted, weighted) -------------------

// Zeros floats [a, b) of p: the threads tid, tid + nthreads, ... of the
// caller share the work, float4 stores from the first 16-byte boundary,
// marked streaming (evict first), so that the gathered rows keep the L2.
__device__ __forceinline__ void zero_floats(float* p, long a, long b, long tid,
                                            long nthreads) {
  if (a >= b) return;
  long a4 = a + (long)(((16 - ((uintptr_t)(p + a) & 15)) & 15) >> 2);
  if (a4 > b) a4 = b;
  const long b4 = a4 + ((b - a4) & ~3L);
  if (tid < a4 - a) __stcs(p + a + tid, 0.f);
  for (long i = a4 + 4 * tid; i < b4; i += 4 * nthreads)
    __stcs((float4*)(p + i), make_float4(0.f, 0.f, 0.f, 0.f));
  if (tid < b - b4) __stcs(p + b4 + tid, 0.f);
}

// A group of G lanes (a warp, or half of one at G = 16) and its columns:
// unit v of group lane gl holds columns c0 + 4 (gl + G v) .. + 3 (kVec, a
// float4) or c0 + gl + G v.
template <int G, int V, bool kVec>
struct Cols {
  static constexpr int kUnit = kVec ? 4 : 1;
  static constexpr int kPass = G * V * kUnit;   // columns a pass
  int col[V];
  __device__ Cols(int c0, int gl) {
#pragma unroll
    for (int v = 0; v < V; ++v) col[v] = c0 + kUnit * (gl + G * v);
  }
  __device__ void load(float* x, const float* row, int F, bool use) const {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (kVec) {
        float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
        if (use && col[v] < F) q = __ldg((const float4*)(row + col[v]));
        x[4 * v] = q.x;
        x[4 * v + 1] = q.y;
        x[4 * v + 2] = q.z;
        x[4 * v + 3] = q.w;
      } else {
        x[v] = use && col[v] < F ? __ldg(row + col[v]) : 0.f;
      }
    }
  }
  __device__ void store(float* row, const float* acc, int F) const {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (col[v] >= F) continue;
      if (kVec)
        __stcs((float4*)(row + col[v]),
               make_float4(acc[4 * v], acc[4 * v + 1], acc[4 * v + 2],
                           acc[4 * v + 3]));
      else
        __stcs(row + col[v], acc[v]);
    }
  }
};

// One edge of a window of G consecutive edges, held by group lane gl for
// edge wbase + gl: its key (dst; INT_MAX past the live prefix), its value
// row (the source, wrapped as the plain version's index is; -1 for a
// masked edge, which loads nothing) and its weight (0 when masked).
struct Edge {
  int key, row;
  float w;
};

__device__ __forceinline__ Edge load_edge(const int* dst, const int* src,
                                          const float* w,
                                          const uint8_t* mask, int i, int n,
                                          int T) {
  Edge x{INT_MAX, -1, 0.f};
  if (i < n) {
    const int k = dst[i], s = src[i];
    const float we = w[i];
    x.key = k;
    if (mask[i]) {
      x.row = s < 0 ? s + T : s;  // the plain version's negative-index wrap
      x.w = we;
    }
  }
  return x;
}

// The group sums edges [lo, hi) of two consecutive windows (edge j of the
// pair is lane j of window a for j < G, lane j - G of window b after) in
// edge order, U edges' loads in flight. An edge whose bit is set in
// `starts` (window a only) opens the row of its key, and the row before it
// (cur_row, if any) is stored first. A masked edge adds 0 * 0: the sum
// starts at +0 and is never -0, so that leaves its bits as they are.
// (No `break` in the unrolled loops: x must stay in registers.)
template <int G, int V, int U, bool kVec>
__device__ __forceinline__ void sum_edges(
    const Cols<G, V, kVec>& cols, unsigned gmask, int lo, int hi,
    unsigned starts, const Edge& a, const Edge& b, const float* h, int F,
    float* out, float* acc, int* cur_row) {
  constexpr int kX = V * Cols<G, V, kVec>::kUnit;
  for (int j0 = lo; j0 < hi; j0 += U) {
    float x[U][kX];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u;
      int r = __shfl_sync(gmask, j < G ? a.row : b.row, j & (G - 1), G);
      if (j >= hi) r = -1;
      cols.load(x[u], h + (long)(r < 0 ? 0 : r) * F, F, r >= 0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u;
      const float wj = __shfl_sync(gmask, j < G ? a.w : b.w, j & (G - 1), G);
      if (j < hi) {
        if (j < G && ((starts >> j) & 1u)) {
          if (*cur_row >= 0) cols.store(out + (long)*cur_row * F, acc, F);
#pragma unroll
          for (int k = 0; k < kX; ++k) acc[k] = 0.f;
          *cur_row = __shfl_sync(gmask, a.key, j, G);
        }
#pragma unroll
        for (int k = 0; k < kX; ++k)
          acc[k] = __fadd_rn(acc[k], __fmul_rn(x[u][k], wj));
      }
    }
  }
}

// The forward SpMM in one launch, with no offsets pass. Every thread first
// zeroes its share of the rows past the last live key (one flat fill: at
// the deepest layer most of the output's rows are padding). Then a group
// of G lanes takes a chunk of C consecutive live edges (grid-stride over
// chunks; C = G, or G / 2 where two float4 a lane leave room for fewer
// edges in flight, to keep the group's chain of round trips short) and
// owns the rows that start in it: an edge starts a row where its key
// differs from its predecessor's (the rows between the two keys are empty,
// and the same group zeroes them; keys of -1 and keys >= S start no row).
// The group loads the indices of 2 G edges from the chunk's start
// together, coalesced, two edges a lane, and sums its rows' edges in edge
// order, the chunk's last row run on as far as those edges reach, U edges'
// value rows in flight at a time. A last row that runs further follows on
// window by window, unless it holds more than kHeavyEdges edges: then it
// goes on a queue in shared memory (if the queue has room), and the whole
// block sums it once its groups are done, 8 warps over the columns and
// kForwardDeep edges in flight each. Outputs are stored streaming.
constexpr int kHeavyQueue = 64;
constexpr int kForwardDeep = 16;

template <int G, int C, int V, int U, bool kVec>
__global__ void __launch_bounds__(kThreads, 4)
spmm_forward_kernel(const int* __restrict__ dst, const int* __restrict__ src,
                    const float* __restrict__ w,
                    const uint8_t* __restrict__ mask, int E,
                    const int* __restrict__ n_live,
                    const float* __restrict__ h, int T, int F, int S,
                    float* __restrict__ out) {
  static_assert(C == G || 2 * C == G, "a chunk of G or G / 2 edges");
  __shared__ int q_row[kHeavyQueue], q_lo[kHeavyQueue];
  __shared__ int q_n;
  __shared__ int s_e[kChunk];
  __shared__ float s_w[kChunk];
  __shared__ int s_end;
  if (threadIdx.x == 0) q_n = 0;
  __syncthreads();
  const int n = live_count(n_live, E);
  const long tid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long nthreads = (long)gridDim.x * blockDim.x;
  const int last_key = n > 0 ? dst[n - 1] : -1;
  const int tail = min(max(last_key + 1, 0), S);
  zero_floats(out, (long)tail * F, (long)S * F, tid, nthreads);

  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);
  const unsigned shift = lane & ~(G - 1);
  const unsigned gmask =
      G == 32 ? 0xffffffffu : (((1u << G) - 1u) << shift);
  const unsigned own = C == 32 ? 0xffffffffu : (1u << C) - 1u;
  const long chunks = ((long)n + C - 1) / C;
  for (long c = tid / G; c < chunks; c += nthreads / G) {
    const int base = (int)(c * C);
    const Edge a = load_edge(dst, src, w, mask, base + gl, n, T);
    const Edge b = load_edge(dst, src, w, mask, base + G + gl, n, T);
    int prev = __shfl_up_sync(gmask, a.key, 1, G);
    if (gl == 0) prev = base > 0 ? dst[base - 1] : -1;
    const bool in = base + gl < n;
    const bool term = !in || a.key != prev;  // ends the row before the edge
    const bool valid = in && term && a.key >= 0 && a.key < S;
    // empty rows between the predecessor's key and this one (the chunk's
    // own edges)
    const int gap_lo = max(prev + 1, 0), gap_hi = min(a.key, S);
    unsigned gaps = (__ballot_sync(gmask, in && term && gap_lo < gap_hi)
                     & gmask) >> shift & own;
    while (gaps) {
      const int l = __ffs(gaps) - 1;
      gaps &= gaps - 1;
      zero_floats(out, (long)__shfl_sync(gmask, gap_lo, l, G) * F,
                  (long)__shfl_sync(gmask, gap_hi, l, G) * F, gl, G);
    }
    const unsigned starts =
        (__ballot_sync(gmask, valid) & gmask) >> shift & own;
    if (starts == 0) continue;
    const unsigned terms = (__ballot_sync(gmask, term) & gmask) >> shift;
    const int first = __ffs(starts) - 1;
    const int last = 31 - __clz(starts);
    // the chunk's rows end at the first terminator after its last start
    // (the next chunk's first row, a key >= S, the live prefix's end)
    const unsigned after = last == 31 ? 0u : terms & ~((2u << last) - 1u);
    const int limit = after ? __ffs(after) - 1 : G;
    // the last row runs on into window b while its keys are K
    const int K = __shfl_sync(gmask, a.key, last, G);
    const unsigned ends = (__ballot_sync(gmask, b.key != K) & gmask) >> shift;
    const int hi1 = limit < G ? 0 : (ends ? __ffs(ends) - 1 : G);
    const bool runs_on = hi1 == G;   // past window b too
    bool queued = false;
    if (runs_on) {
      const int probe = base + last + kHeavyEdges;
      if (probe < n && dst[probe] == K) {   // heavy: for the block
        int q = kHeavyQueue;
        if (gl == 0) {
          q = atomicAdd(&q_n, 1);
          if (q < kHeavyQueue) {
            q_row[q] = K;
            q_lo[q] = base + last;
          }
        }
        queued = __shfl_sync(gmask, q, 0, G) < kHeavyQueue;
      }
    }
    const int span_end = queued ? last : (limit < G ? limit : G + hi1);

    for (int c0 = 0; c0 < F; c0 += Cols<G, V, kVec>::kPass) {
      const Cols<G, V, kVec> cols(c0, gl);
      float acc[V * Cols<G, V, kVec>::kUnit];
#pragma unroll
      for (int k = 0; k < V * Cols<G, V, kVec>::kUnit; ++k) acc[k] = 0.f;
      int cur_row = -1;
      sum_edges<G, V, U, kVec>(cols, gmask, first, span_end, starts, a, b,
                               h, F, out, acc, &cur_row);
      // a long row that is not queued: window by window
      for (int wb = base + 2 * G; runs_on && !queued && wb < n; wb += G) {
        const Edge e = load_edge(dst, src, w, mask, wb + gl, n, T);
        const unsigned e_ends =
            (__ballot_sync(gmask, e.key != K) & gmask) >> shift;
        const int hi = e_ends ? __ffs(e_ends) - 1 : G;
        sum_edges<G, V, U, kVec>(cols, gmask, 0, hi, 0u, e, e, h, F, out,
                                 acc, &cur_row);
        if (hi < G) break;
      }
      if (cur_row >= 0) cols.store(out + (long)cur_row * F, acc, F);
    }
  }

  // the queued heavy rows, each by the whole block: warp wp sums columns
  // c0 + 32 wp + lane over the row's edges in edge order, from edge
  // indices staged kChunk at a time; the row ends at the first key that
  // differs from its own (or at the live prefix's end)
  __syncthreads();
  const int n_heavy = min(q_n, kHeavyQueue);
  const int wp = threadIdx.x >> 5;
  for (int q = 0; q < n_heavy; ++q) {
    const int row = q_row[q], lo = q_lo[q];
    for (int c0 = 0; c0 < F; c0 += kThreads) {
      const int col = c0 + 32 * wp + lane;
      float acc = 0.f;
      for (int base = lo; ; base += kChunk) {
        __syncthreads();   // the previous chunk is consumed
        if (threadIdx.x == 0) s_end = kChunk;
        __syncthreads();
        for (int j = threadIdx.x; j < kChunk; j += kThreads) {
          const Edge e = load_edge(dst, src, w, mask, base + j, n, T);
          if (e.key != row) atomicMin(&s_end, j);
          s_e[j] = e.row;
          s_w[j] = e.w;
        }
        __syncthreads();
        const int cnt = s_end;
        if (c0 + 32 * wp < F) {
          for (int j0 = 0; j0 < cnt; j0 += kForwardDeep) {
            float x[kForwardDeep];
#pragma unroll
            for (int u = 0; u < kForwardDeep; ++u) {
              const int r = j0 + u < cnt ? s_e[j0 + u] : -1;
              x[u] = r >= 0 && col < F ? __ldg(h + (long)r * F + col) : 0.f;
            }
#pragma unroll
            for (int u = 0; u < kForwardDeep; ++u)
              if (j0 + u < cnt)
                acc = __fadd_rn(acc, __fmul_rn(x[u], s_w[j0 + u]));
          }
        }
        if (cnt < kChunk) break;
      }
      if (col < F) __stcs(out + (long)row * F + col, acc);
    }
  }
}

__global__ void gather_rows_kernel(const int* dst, const uint8_t* mask, int E,
                                   const int* n_live, const float* rows, int S,
                                   int F, float* out) {
  int n = E;
  if (n_live != nullptr) {
    n = *n_live;
    n = n < 0 ? 0 : (n < E ? n : E);
  }
  const int slices = (F + kSlice - 1) / kSlice;
  const long items = (long)E * slices;
  const long nwarps = ((long)gridDim.x * blockDim.x) >> 5;
  const int lane = threadIdx.x & 31;
  for (long it = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       it < items; it += nwarps) {
    const long e = it / slices;
    const int c0 = (int)(it % slices) * kSlice + lane;
    int r = -1;
    if (e < n && mask[e]) r = dst[e];
    const float* src = (r >= 0 && r < S) ? rows + (long)r * F : nullptr;
    float* o = out + e * F;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int c = c0 + 32 * k;
      if (c < F) o[c] = src != nullptr ? src[c] : 0.f;
    }
  }
}

}  // namespace

static int grid_for(long threads) {
  long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > kGridCap) blocks = kGridCap;
  if (blocks < 1) blocks = 1;
  return (int)blocks;
}

static void launch_offsets(const int* key, const int* perm, int E,
                           const int* n_live, int num_rows, int* row_start,
                           cudaStream_t stream) {
  row_offsets_kernel<<<grid_for((long)num_rows + 2 + E), kThreads, 0,
                       stream>>>(key, perm, E, n_live, num_rows, row_start);
}

// The offsets pass, then the row sums, then the heavy rows. scratch: 2
// (num_rows + 1) + 1 int32: the offsets, the heavy-row count, the heavy
// rows. kVec when every value row starts 16-byte aligned.
template <bool kEdgeValues>
static int segment_sums(const int* key, const int* src, const float* w,
                        const uint8_t* mask, const int* perm, int E,
                        const int* n_live, const float* h, int T, int F,
                        int S, int* scratch, float* out,
                        cudaStream_t stream) {
  int* row_start = scratch;
  int* heavy_count = scratch + S + 1;
  int* heavy_rows = heavy_count + 1;
  cudaError_t err = cudaMemsetAsync(heavy_count, 0, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  launch_offsets(key, perm, E, n_live, S, row_start, stream);
  const int grid = grid_for((long)S * ((F + kRowCols - 1) / kRowCols) * 32);
  if (F % 4 == 0 && ((uintptr_t)h & 15) == 0)
    row_sums_kernel<kEdgeValues, true><<<grid, kThreads, 0, stream>>>(
        row_start, src, w, mask, perm, h, T, F, S, out, heavy_count,
        heavy_rows);
  else
    row_sums_kernel<kEdgeValues, false><<<grid, kThreads, 0, stream>>>(
        row_start, src, w, mask, perm, h, T, F, S, out, heavy_count,
        heavy_rows);
  heavy_sums_kernel<kEdgeValues><<<2 * 132, kThreads, 0, stream>>>(
      row_start, src, w, mask, perm, h, T, F, out, heavy_count, heavy_rows);
  return (int)cudaGetLastError();
}

// The offsets pass alone (the card tests hold it against a sorted search).
extern "C" int spmm_row_offsets(const int* key, const int* perm, int E,
                                const int* n_live, int num_rows,
                                int* row_start, void* stream) {
  launch_offsets(key, perm, E, n_live, num_rows, row_start,
                 (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

template <int G, int C, int V, int U, bool kVec>
static void launch_forward(const int* dst, const int* src, const float* w,
                           const uint8_t* mask, int E, const int* n_live,
                           const float* h, int T, int F, int S, float* out,
                           cudaStream_t stream) {
  // a group per C-edge chunk of the buffer (the live count is on the
  // device), at least a thread per 16 float4s of the output, capped
  const long per_block = (long)C * (kThreads / G);
  const long chunk_blocks = ((long)E + per_block - 1) / per_block;
  const long fill_blocks = ((long)S * F / 64 + kThreads - 1) / kThreads;
  long blocks = chunk_blocks > fill_blocks ? chunk_blocks : fill_blocks;
  blocks = blocks < 1 ? 1 : (blocks > kForwardGridCap ? kForwardGridCap
                                                      : blocks);
  spmm_forward_kernel<G, C, V, U, kVec>
      <<<(int)blocks, kThreads, 0, stream>>>(dst, src, w, mask, E, n_live, h,
                                             T, F, S, out);
}

// The forward SpMM: lanes fitted to the width (half a warp a row up to 64
// columns, a float4 a lane up to 128, two up to 256 and more passes past
// it); where a lane holds two float4, a group takes chunks of 16 edges.
// Two edges' loads in flight a group: at the deepest layer's shape the
// gathers of random source rows ran slower with 1, 3, 4, 8 or 16 on the
// card (tools/spmm_forward_sweep.py times the variants).
static int spmm_forward(const int* dst, const int* src, const float* w,
                        const uint8_t* mask, int E, const int* n_live,
                        const float* h, int T, int F, int S, float* out,
                        cudaStream_t st) {
  const bool vec = F % 4 == 0 && (((uintptr_t)h | (uintptr_t)out) & 15) == 0;
  if (vec && F <= 64)
    launch_forward<16, 16, 1, 2, true>(dst, src, w, mask, E, n_live, h, T, F,
                                       S, out, st);
  else if (vec && F <= 128)
    launch_forward<32, 32, 1, 2, true>(dst, src, w, mask, E, n_live, h, T, F,
                                       S, out, st);
  else if (vec)
    launch_forward<32, 16, 2, 2, true>(dst, src, w, mask, E, n_live, h, T, F,
                                       S, out, st);
  else if (F <= 64)
    launch_forward<32, 32, 2, 2, false>(dst, src, w, mask, E, n_live, h, T,
                                        F, S, out, st);
  else
    launch_forward<32, 16, 8, 2, false>(dst, src, w, mask, E, n_live, h, T,
                                        F, S, out, st);
  return (int)cudaGetLastError();
}

// perm == nullptr: the forward kernel (one launch, no scratch); through a
// perm (the transposed SpMM): the offsets pass and the row sums.
extern "C" int spmm_rows(const int* dst, const int* src, const float* w,
                         const uint8_t* mask, const int* perm, int E,
                         const int* n_live, const float* h, int T, int F,
                         int S, int* scratch, float* out, void* stream) {
  if (perm == nullptr)
    return spmm_forward(dst, src, w, mask, E, n_live, h, T, F, S, out,
                        (cudaStream_t)stream);
  return segment_sums<false>(dst, src, w, mask, perm, E, n_live, h, T, F, S,
                             scratch, out, (cudaStream_t)stream);
}

// values: (E, F), one row per edge in the edges' own order (perm only
// changes the order in which each output row reads its edges).
extern "C" int scatter_rows(const int* dst, const uint8_t* mask,
                            const int* perm, int E, const int* n_live,
                            const float* values, int F, int S,
                            int* scratch, float* out, void* stream) {
  return segment_sums<true>(dst, nullptr, nullptr, mask, perm, E, n_live,
                            values, E, F, S, scratch, out,
                            (cudaStream_t)stream);
}

extern "C" int gather_dst_rows(const int* dst, const uint8_t* mask, int E,
                               const int* n_live, const float* rows, int S,
                               int F, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long items = (long)E * ((F + kSlice - 1) / kSlice);
  long blocks = (items * 32 + kThreads - 1) / kThreads;
  if (blocks > kGridCap) blocks = kGridCap;
  if (blocks < 1) blocks = 1;
  gather_rows_kernel<<<(int)blocks, kThreads, 0, st>>>(dst, mask, E, n_live,
                                                       rows, S, F, out);
  return (int)cudaGetLastError();
}
