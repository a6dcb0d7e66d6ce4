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
// of spmm.cu read), so one thread per (row, head) finds its row's edge range
// (a binary search for the first edge, then a scan while dst stays the row:
// rows hold a handful of edges) and sweeps it three times, in edge order:
// the exact max, the sum of expf(l - m), then the coefficients. The max is
// exact, so a row sitting far below another row's logits does not underflow
// (the trap the TPU kernel's per-row max avoids too). No atomics: every run
// gives the same floats. expf and the division are IEEE-accurate, not the
// fast intrinsics. Threads of one row take neighbouring heads, so each edge's
// H logits are read by neighbouring threads (coalesced).
//
// The same launch also walks every (edge, head) entry once and writes 0 where
// no row covers the edge: the padded edges past n_live, about 10x the live
// ones in a sampled block, are most of the output.
//
// What bounds it: bytes. It writes E x H floats and reads the live logits,
// the live dst slots and the mask (the three sweeps re-read a row's logits
// from L1/L2); its arithmetic is a few operations per live logit.
//
// Launches on the given stream, synchronises nothing, returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long kGridCap = 132 * 64;

__device__ __forceinline__ int first_of_row(const int* dst, int n, int row) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (dst[mid] < row)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void edge_softmax_kernel(const int* dst, const uint8_t* mask,
                                    int E, const int* n_live,
                                    const float* logits, int H, int S,
                                    float* alpha) {
  int n = E;
  if (n_live != nullptr) {
    n = *n_live;
    n = n < 0 ? 0 : (n < E ? n : E);
  }
  const long row_items = (long)S * H;
  const long items = row_items + (long)E * H;
  const long stride = (long)gridDim.x * blockDim.x;
  for (long it = (long)blockIdx.x * blockDim.x + threadIdx.x; it < items;
       it += stride) {
    if (it >= row_items) {
      // (edge, head) entries that no row covers get 0
      const long j = it - row_items;
      const long e = j / H;
      if (e >= n) {
        alpha[j] = 0.f;
      } else {
        const int d = dst[e];
        if (d < 0 || d >= S) alpha[j] = 0.f;
      }
      continue;
    }
    const int row = (int)(it / H);
    const int h = (int)(it % H);
    const int lo = first_of_row(dst, n, row);
    int hi = lo;
    while (hi < n && dst[hi] == row) ++hi;
    if (hi == lo) continue;
    float m = -INFINITY;
    for (int e = lo; e < hi; ++e)
      if (mask[e]) m = fmaxf(m, logits[(long)e * H + h]);
    if (m == -INFINITY) m = 0.f;  // every edge of the row is masked
    float s = 0.f;
    for (int e = lo; e < hi; ++e)
      if (mask[e]) s = __fadd_rn(s, expf(logits[(long)e * H + h] - m));
    const float den = fmaxf(s, 1e-9f);
    for (int e = lo; e < hi; ++e) {
      const long j = (long)e * H + h;
      alpha[j] = mask[e] ? __fdiv_rn(expf(logits[j] - m), den) : 0.f;
    }
  }
}

}  // namespace

extern "C" int edge_softmax(const int* dst, const uint8_t* mask, int E,
                            const int* n_live, const float* logits, int H,
                            int S, float* alpha, void* stream) {
  const long items = ((long)S + E) * H;
  long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > kGridCap) blocks = kGridCap;
  if (blocks < 1) blocks = 1;
  edge_softmax_kernel<<<(int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      dst, mask, E, n_live, logits, H, S, alpha);
  return (int)cudaGetLastError();
}
