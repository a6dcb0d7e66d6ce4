// Hopper (sm_90a) kernel for GATv2's attention normalisation (ops.edge_softmax):
//
//   edge_softmax: alpha[e, h] = exp(l[e, h] - m[r, h]) / max(s[r, h], 1e-9)
//     for each masked-in edge e of destination row r = dst[e], where m is the
//     exact max of the row's logits and s = sum exp(l - m) over them; 0 for a
//     masked edge, an edge at or past n_live and an edge whose dst is outside
//     [0, S).
//
// Replaces the TPU kernel repro/kernels/edge_softmax/edge_softmax.py
// _stats_kernel together with the normalisation of its wrapper
// (edge_softmax/ops.py edge_softmax_block). The TPU kernel scatters the logits
// into row-block-aligned chunks and finds each chunk's per-row max with a
// masked (edges, heads, rows) reduce and the denominators with one-hot
// matmuls, rescaling a running (m, s) from chunk to chunk, because the MXU is
// its only fast reduction. None of that is carried over. The sampler's valid
// edges are a dst-sorted prefix of length n_live (the layout the SpMM kernels
// of spmm.cu read), and the output is indexed by edge, so the kernel works
// only in proportion to the live edges: a row with no edge costs nothing.
//
// Every row's sum of exponentials is accumulated in double and rounded once
// to float, as the plain version's is: a float sum of a long row drops its
// smallest terms (about 5e-5 of a 50,000-edge row's sum in edge order), and
// in double the order of the terms no longer moves the rounded result. So
// each path below sums in the order that suits it and still gives the plain
// version's coefficients (to the last bit, but for a sum that falls within
// ~1e-16 of a float rounding boundary). Each order is fixed, no sum is
// atomic: two calls give the same bits. The max is exact. expf and the
// division are the IEEE ones (__fdiv_rn), not the fast intrinsics.
//
// One launch. Each warp takes chunks of 32 consecutive live edges and owns
// the rows that start in them: a row starts where the key changes (found by
// ballot, no search). For a chunk it loads the dst slots and masks of its
// 32 edges and the next 32 (one a lane) and copies the logits of those 64
// edges into shared memory (cp.async, kStage floats at most), all in one
// round trip, coalesced; while these are in flight it stores a few float4
// of the fill.
//
//   fill: everything past the live prefix, [n_live H, E H), is zero: one
//     flat float4 streaming fill (scalars at its unaligned ends), grid-
//     strided, kFillPer float4 a lane between the warp's chunks so that the
//     stores run while its loads wait, the rest after its last chunk.
//   rows: a row that ends inside the stage takes the flat path: a group of
//     lanes, one a head, takes each row's max, then the warp turns every
//     staged logit of the rows into expf(l - m) in place, packed 32 entries
//     a step over the rows' (edge, head) span; the groups sum each row's
//     exponentials; the warp writes every coefficient, again packed and
//     coalesced. So the costly per-entry work (expf, the division) keeps
//     every lane busy whatever the row lengths. A row that runs past the
//     stage (the chunk's last row, or any row where the stage holds fewer
//     edges at many heads) is swept by the warp from memory, one head a
//     lane, three times (max, sum, the coefficients). A row of more than
//     kLongEdges edges would stall a warp and set the kernel's tail: it goes
//     on a queue in shared memory and the whole block takes it once its
//     warps are done, each thread one head of every G-th edge (each step
//     one flat coalesced run of the row's entries), in the same three
//     sweeps; the first finds the row's end, and the threads' maxima and
//     sums are folded per head in thread order. An edge whose dst is
//     outside [0, S) gets its zeros from the warp whose chunk holds it.
//
// n_live is read on the device. What bounds it: bytes. It writes E x H
// floats (most of them the fill: at the deepest layer the edge cap is ~11x
// the live edges) and reads the live logits, dst slots and mask once. The
// fill alone runs near the card's write rate; the live chunks are short
// dependent chains (a round trip, then the per-entry work), so the fill's
// stores go out while a warp's loads wait. tools/edge_softmax_sweep.py
// splits its time and times versions of this file against each other.
//
// Launches on the given stream, synchronises nothing, returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;        // edges whose rows a warp owns (a key a lane)
constexpr int kWindow = 64;       // edges a warp stages: its chunk, the next 32
constexpr int kStage = 512;       // floats a warp stages in shared memory
constexpr int kLongEdges = 128;   // longer rows: by the whole block
constexpr int kQueue = 64;        // long rows a block queues
constexpr int kU = 4;             // logits a lane loads at a time in a sweep
constexpr int kFillPer = 4;       // float4 of the fill a lane stores a chunk
constexpr long kBlocksMax = 132 * 4;  // 4 an SM: 64 registers a thread
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoKey = INT_MIN;   // key of an edge past the live prefix

__device__ __forceinline__ int live_count(const int* n_live, int E) {
  if (n_live == nullptr) return E;
  const int n = *n_live;
  return n < 0 ? 0 : (n < E ? n : E);
}

// The fill [a, b) of out: its 16-byte aligned interior in float4 stores,
// streaming (evict first), grid-strided (lane l of warp gw of W stores
// float4 32 gw + l, then 32 (gw + W) + l, ...: the warps sweep the fill
// together), a few at a time between the warp's chunks; the scalars at
// the unaligned ends go to warp 0.
struct Fill {
  float4* p;
  long i, f4, stride;   // this lane's next float4 of p[0, f4)
  __device__ Fill(float* out, long a, long b, long gw, long W, int lane) {
    long a4 = a + (long)(((16 - ((uintptr_t)(out + a) & 15)) & 15) >> 2);
    if (a4 > b) a4 = b;
    const long b4 = a4 + ((b - a4) & ~3L);
    if (gw == 0 && lane < a4 - a) __stcs(out + a + lane, 0.f);
    if (gw == 0 && lane < b - b4) __stcs(out + b4 + lane, 0.f);
    p = (float4*)(out + a4);
    f4 = (b4 - a4) >> 2;
    stride = 32 * W;
    i = 32 * gw + lane;
  }
  __device__ void store(int per) {
    for (int k = 0; k < per && i < f4; ++k, i += stride)
      __stcs(p + i, make_float4(0.f, 0.f, 0.f, 0.f));
  }
  __device__ void rest() {
    for (; i < f4; i += stride) __stcs(p + i, make_float4(0.f, 0.f, 0.f, 0.f));
  }
};

// cp.async of one float (or 4, 16-byte aligned) from global to shared
// memory, no register holding it; stage_wait() waits for all of the
// thread's copies.
__device__ __forceinline__ void stage_async(float* smem, const float* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void stage_async16(float* smem, const float* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Edge of entry t of a warp's staged (edges, H) logits (t < 64 H + 32,
// H <= 128): t / H by one float product with inv_h = 1 / H (its rounding
// error, under 2^-24 t, stays below the 0.5 / H by which t + 0.5 misses a
// multiple of H; exact for every such t and H).
__device__ __forceinline__ int entry_edge(int t, float inv_h) {
  return (int)(((float)t + 0.5f) * inv_h);
}

// Logit of edge e at head h, -inf where the edge is masked.
__device__ __forceinline__ float logit_at(const float* __restrict__ logits,
                                          const uint8_t* __restrict__ mask,
                                          int e, int H, int h) {
  return mask[e] ? __ldg(logits + (long)e * H + h) : -INFINITY;
}

// One row swept by a whole warp from memory, in edge order: lane l takes
// heads l + 32 r, r < R. hi < 0: the end is not known; the row runs while
// the key is K, and the first sweep finds its end (every lane reads the same
// keys, so the loop is uniform).
template <int R>
__device__ void warp_row(const int* __restrict__ dst,
                         const uint8_t* __restrict__ mask,
                         const float* __restrict__ logits, int n, int H, int K,
                         int lo, int hi, int lane, float* __restrict__ out) {
  constexpr int U = R >= kU ? 1 : kU / R;
  float m[R], den[R];
  double s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    s[r] = 0.0;
  }
  const bool find_end = hi < 0;
  for (int e0 = lo; find_end || e0 < hi; e0 += U) {
    float x[U][R];
    int end = INT_MAX;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u;
      const bool in = find_end ? e < n && __ldg(dst + e) == K : e < hi;
      if (!in) end = min(end, e);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int h = lane + 32 * r;
        x[u][r] = in && h < H ? logit_at(logits, mask, e, H, h) : -INFINITY;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int r = 0; r < R; ++r) m[r] = fmaxf(m[r], x[u][r]);
    if (find_end && end != INT_MAX) {
      hi = end;
      break;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (m[r] == -INFINITY) m[r] = 0.f;   // every edge of the row is masked
  for (int e0 = lo; e0 < hi; e0 += U) {
    float x[U][R];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int h = lane + 32 * r;
        x[u][r] = e0 + u < hi && h < H ? logit_at(logits, mask, e0 + u, H, h)
                                       : -INFINITY;
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int r = 0; r < R; ++r)
        s[r] += (double)expf(x[u][r] - m[r]);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) den[r] = fmaxf((float)s[r], 1e-9f);
  for (int e0 = lo; e0 < hi; e0 += U) {
    float x[U][R];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int h = lane + 32 * r;
        x[u][r] = e0 + u < hi && h < H ? logit_at(logits, mask, e0 + u, H, h)
                                       : -INFINITY;
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int h = lane + 32 * r;
        if (e0 + u < hi && h < H)
          out[(long)(e0 + u) * H + h] =
              __fdiv_rn(expf(x[u][r] - m[r]), den[r]);
      }
  }
}

// The rows of a chunk that end inside the warp's stage (edges base + j,
// j < cst, masked ones staged as -inf): rows 0 .. nflat - 1 of the chunk,
// starting at the set bits of `flat` (lane j of them ends its row at
// my_hi) and covering the staged edges [j0, j1). Group g of the warp (hp
// lanes, lane gl of it head gl) takes rows g, g + 32 / hp, ...; `rows`
// holds each row's staged edges, `stat` a row's max, then its
// denominator, at row * H + head.
__device__ void flat_rows(float* stage, float* stat, int2* rows, int my_hi,
                          unsigned flat, int nflat, int j0, int j1, int H,
                          int hp, float inv_h, int lane, long base_entry,
                          float* __restrict__ out) {
  const int gl = lane & (hp - 1), groups = 32 / hp;
  // the flat row of staged edge `lane` (edges 32 .. 63 are the last row's)
  const int my_row =
      __popc(flat & (lane == 31 ? kFull : (2u << lane) - 1u)) - 1;
  if ((flat >> lane) & 1u) rows[my_row] = make_int2(lane, my_hi);
  __syncwarp();
  // each row's max
  for (int idx = lane / hp; idx - lane / hp < nflat; idx += groups) {
    if (idx >= nflat || gl >= H) continue;
    const int2 r = rows[idx];
    float m = -INFINITY;
    for (int j = r.x; j < r.y; ++j) m = fmaxf(m, stage[j * H + gl]);
    stat[idx * H + gl] = m == -INFINITY ? 0.f : m;
  }
  __syncwarp();
  // every entry's exponential, in place, 32 entries a step
  for (int t0 = j0 * H; t0 < j1 * H; t0 += 32) {
    const int t = t0 + lane;
    const int j = entry_edge(t, inv_h);
    const int row = __shfl_sync(kFull, my_row, j & 31);
    if (t < j1 * H)
      stage[t] = expf(stage[t] - stat[(j < 32 ? row : nflat - 1) * H +
                                      t - j * H]);
  }
  __syncwarp();
  // each row's sum of exponentials
  for (int idx = lane / hp; idx - lane / hp < nflat; idx += groups) {
    if (idx >= nflat || gl >= H) continue;
    const int2 r = rows[idx];
    double s = 0.0;
    for (int j = r.x; j < r.y; ++j) s += (double)stage[j * H + gl];
    stat[idx * H + gl] = fmaxf((float)s, 1e-9f);
  }
  __syncwarp();
  // every coefficient, 32 entries a step, coalesced
  for (int t0 = j0 * H; t0 < j1 * H; t0 += 32) {
    const int t = t0 + lane;
    const int j = entry_edge(t, inv_h);
    const int row = __shfl_sync(kFull, my_row, j & 31);
    if (t < j1 * H)
      out[base_entry + t] = __fdiv_rn(
          stage[t], stat[(j < 32 ? row : nflat - 1) * H + t - j * H]);
  }
}

// A long row (more than kLongEdges edges, key K, from edge lo) by the whole
// block: thread t takes head t % H of the edges lo + t / H + G k, G =
// kThreads / H edges a step (the threads past G H idle), so that each step
// reads and writes one flat coalesced run of the row's entries. The first
// sweep finds the row's end; each thread's max and sum are folded per head,
// in thread order, through part_m / part_s; hm, hs: each head's max and
// denominator. Every thread of the block calls.
__device__ void block_row(const int* __restrict__ dst,
                          const uint8_t* __restrict__ mask,
                          const float* __restrict__ logits, int n, int H,
                          int K, int lo, float* part_m, double* part_s,
                          float* hm, float* hs, int* s_hi,
                          float* __restrict__ out) {
  constexpr int U = 2 * kU;
  const int G = kThreads / H;
  const int t = threadIdx.x;
  const bool on = t < G * H;
  const int h = on ? t % H : 0, first = lo + (on ? t / H : 0);
  float m = -INFINITY;
  for (int e0 = first; on; e0 += G * U) {
    float x[U];
    int end = INT_MAX;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + G * u;
      const bool in = e < n && __ldg(dst + e) == K;
      if (!in) end = min(end, e);
      x[u] = in ? logit_at(logits, mask, e, H, h) : -INFINITY;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) m = fmaxf(m, x[u]);
    if (end != INT_MAX) {
      if (h == 0) atomicMin(s_hi, end);
      break;
    }
  }
  part_m[t] = m;
  __syncthreads();
  const int hi = *s_hi;
  if (t < H) {
    float v = -INFINITY;
    for (int i = 0; i < G; ++i) v = fmaxf(v, part_m[i * H + t]);
    hm[t] = v == -INFINITY ? 0.f : v;   // every edge of the row is masked
  }
  __syncthreads();
  const float mh = hm[h];
  double s = 0.0;
  for (int e0 = first; on && e0 < hi; e0 += G * U) {
    float x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + G * u;
      x[u] = e < hi ? logit_at(logits, mask, e, H, h) : -INFINITY;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) s += (double)expf(x[u] - mh);
  }
  part_s[t] = s;
  __syncthreads();
  if (t < H) {
    double v = 0.0;
    for (int i = 0; i < G; ++i) v += part_s[i * H + t];
    hs[t] = fmaxf((float)v, 1e-9f);
  }
  __syncthreads();
  const float dh = hs[h];
  for (int e0 = first; on && e0 < hi; e0 += G * U) {
    float x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + G * u;
      x[u] = e < hi ? logit_at(logits, mask, e, H, h) : -INFINITY;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + G * u;
      if (e < hi) out[(long)e * H + h] = __fdiv_rn(expf(x[u] - mh), dh);
    }
  }
  if (t == 0) *s_hi = INT_MAX;   // for the next row
  __syncthreads();
}

// Every warp takes chunks gw, gw + W, ... of the live prefix and its slice
// of the fill, a few float4 of it while each chunk's loads are in flight.
// R: heads a lane holds in warp_row (1 for H <= 32, else 2 or 4); hp: the
// lanes a flat-path group gives a row (the power of two >= H, for R = 1).
template <int R>
__global__ void __launch_bounds__(kThreads, 4)
edge_softmax_kernel(const int* __restrict__ dst,
                    const uint8_t* __restrict__ mask, int E,
                    const int* __restrict__ n_live,
                    const float* __restrict__ logits, int H, int hp, int S,
                    float* __restrict__ out) {
  __shared__ __align__(16) float s_stage[kWarps][kStage];
  __shared__ float s_stat[kWarps][kStage];
  __shared__ int2 s_rows[kWarps][32];
  __shared__ double s_part[kThreads];
  __shared__ int s_qlo[kQueue], s_qkey[kQueue];
  __shared__ int s_qn, s_hi;
  if (threadIdx.x == 0) {
    s_qn = 0;
    s_hi = INT_MAX;
  }
  __syncthreads();
  const int n = live_count(n_live, E);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long gw = (long)blockIdx.x * kWarps + w;
  const long warps = (long)gridDim.x * kWarps;
  Fill fill(out, (long)n * H, (long)E * H, gw, warps, lane);
  const float inv_h = 1.f / H;
  float* stage = s_stage[w];
  // edges the stage holds (the flat path runs where R = 1)
  const int cs = R == 1 ? min(kWindow, kStage / H) : 0;
  for (long c = gw; c * kChunk < n; c += warps) {
    const int base = (int)(c * kChunk);
    const int cst = min(cs, n - base);
    __syncwarp();   // the previous chunk is done with the stage
    const float* chunk = logits + (long)base * H;
    const int cnt = cst * H, n4 = ((uintptr_t)chunk & 15) == 0 ? cnt >> 2 : 0;
    for (int v = lane; v < n4; v += 32)
      stage_async16(stage + 4 * v, chunk + 4 * v);
    for (int t = 4 * n4 + lane; t < cnt; t += 32)
      stage_async(stage + t, chunk + t);
    const int ea = base + lane, eb = base + kChunk + lane;
    const int ka = ea < n ? __ldg(dst + ea) : kNoKey;
    const int kb = eb < n ? __ldg(dst + eb) : kNoKey;
    const bool ma = ea < n && mask[ea], mb = eb < n && mask[eb];
    int prev = __shfl_up_sync(kFull, ka, 1);
    if (lane == 0) prev = base > 0 ? __ldg(dst + base - 1) : kNoKey;
    fill.store(kFillPer);   // while the loads are in flight
    const unsigned mbits_a = __ballot_sync(kFull, ma);
    const unsigned mbits_b = __ballot_sync(kFull, mb);
    const bool in = ea < n;
    const bool valid = in && ka >= 0 && ka < S;
    const unsigned bad = __ballot_sync(kFull, in && !valid);
    const unsigned starts = __ballot_sync(kFull, valid && ka != prev);
    // a row ends before each of these edges
    const unsigned terms = __ballot_sync(kFull, !in || ka != prev);
    for (unsigned b = bad; b; b &= b - 1) {
      const long e = base + __ffs(b) - 1;
      for (int h = lane; h < H; h += 32) out[e * H + h] = 0.f;
    }
    stage_wait();   // before any continue: the next chunk reuses the stage
    if (starts == 0) continue;
    // the chunk's last row may run on into the next 32 edges, or further
    const int last = 31 - __clz(starts);
    const int K_last = __shfl_sync(kFull, ka, last);
    const unsigned ends = __ballot_sync(kFull, kb != K_last);
    const unsigned after_last = last == 31 ? 0u : terms & (~0u << (last + 1));
    const int hi_last = after_last ? __ffs(after_last) - 1
                        : ends ? kChunk + __ffs(ends) - 1 : -1;
    // the rows that end inside the stage: a prefix of the chunk's rows
    int my_hi = -1;
    if ((starts >> lane) & 1u) {
      const unsigned after = lane == 31 ? 0u : terms & (~0u << (lane + 1));
      my_hi = after ? __ffs(after) - 1 : hi_last;
    }
    const unsigned flat =
        __ballot_sync(kFull, my_hi >= 0 && my_hi <= cst) & starts;
    __syncwarp();   // the stage is written
    if (flat) {
      // the masked staged edges' logits become -inf
      const unsigned in_a = cst >= 32 ? kFull : (1u << cst) - 1u;
      const unsigned in_b = cst >= 64 ? kFull : (1u << max(cst - 32, 0)) - 1u;
      for (unsigned b = ~mbits_a & in_a; b; b &= b - 1)
        for (int h = lane; h < H; h += 32)
          stage[(__ffs(b) - 1) * H + h] = -INFINITY;
      for (unsigned b = ~mbits_b & in_b; b; b &= b - 1)
        for (int h = lane; h < H; h += 32)
          stage[(31 + __ffs(b)) * H + h] = -INFINITY;
      __syncwarp();
      const int j1 = __shfl_sync(kFull, my_hi, 31 - __clz(flat));
      flat_rows(stage, s_stat[w], s_rows[w], my_hi, flat, __popc(flat),
                __ffs(flat) - 1, j1, H, hp, inv_h, lane, (long)base * H, out);
    }
    // the others, one by one, by the warp from memory (or the block)
    for (unsigned st = starts & ~flat; st; st &= st - 1) {
      const int i = __ffs(st) - 1;
      const int K = __shfl_sync(kFull, ka, i);
      const int hi_i = __shfl_sync(kFull, my_hi, i);
      const int lo = base + i;
      if (hi_i < 0 && lo + kLongEdges < n &&
          __ldg(dst + lo + kLongEdges) == K) {
        int q = kQueue;
        if (lane == 0) {
          q = atomicAdd(&s_qn, 1);
          if (q < kQueue) {
            s_qlo[q] = lo;
            s_qkey[q] = K;
          }
        }
        if (__shfl_sync(kFull, q, 0) < kQueue) continue;   // the block's
      }
      warp_row<R>(dst, mask, logits, n, H, K, lo, hi_i < 0 ? -1 : base + hi_i,
                  lane, out);
    }
  }

  fill.rest();

  // the queued long rows, each by the whole block
  __syncthreads();
  const int nq = min(s_qn, kQueue);
  for (int q = 0; q < nq; ++q)
    block_row(dst, mask, logits, n, H, s_qkey[q], s_qlo[q], s_stage[0],
              s_part, s_stat[0], s_stat[0] + 128, &s_hi, out);
}

template <int R>
void launch(const int* dst, const uint8_t* mask, int E, const int* n_live,
            const float* logits, int H, int hp, int S, float* alpha,
            cudaStream_t stream) {
  // a chunk a warp (sized for n = E), capped at 4 blocks an SM
  const long per_block = (long)kWarps * kChunk;
  long blocks = ((long)E + per_block - 1) / per_block;
  blocks = blocks < 1 ? 1 : (blocks > kBlocksMax ? kBlocksMax : blocks);
  edge_softmax_kernel<R><<<(int)blocks, kThreads, 0, stream>>>(
      dst, mask, E, n_live, logits, H, hp, S, alpha);
}

}  // namespace

extern "C" int edge_softmax(const int* dst, const uint8_t* mask, int E,
                            const int* n_live, const float* logits, int H,
                            int S, float* alpha, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (H < 1) return (int)cudaGetLastError();   // nothing to write
  if (H <= 32) {
    int hp = 1;
    while (hp < H) hp <<= 1;
    launch<1>(dst, mask, E, n_live, logits, H, hp, S, alpha, st);
  } else if (H <= 64) {
    launch<2>(dst, mask, E, n_live, logits, H, 32, S, alpha, st);
  } else {
    launch<4>(dst, mask, E, n_live, logits, H, 32, S, alpha, st);
  }
  return (int)cudaGetLastError();
}
