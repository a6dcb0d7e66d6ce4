// Hopper (sm_90a) kernels for the graph ops of a sampled block:
//
//   spmm_rows: the weighted SpMM (ops.aggregate): out[s] = sum over edges e
//     with dst[e] = s and mask[e] of w[e] * h[src[e]], for every one of the S
//     output rows. The aggregate's backward for h is the same kernel with
//     the roles swapped (the transposed SpMM), reading the edges through the
//     block's src_perm (edge i of the sweep is edge perm[i]) so that its
//     "dst", the edges' src_slot, is sorted too.
//   gather_dst_rows: out[e] = rows[dst[e]] for the live, masked-in edges and
//     0 for every other edge (ops.gather_dst), the destination half of the
//     SDDMM that is the aggregate's gradient for the edge weights.
//
// spmm_rows replaces the TPU kernel repro/kernels/spmm/spmm.py _spmm_kernel
// (spmm_sorted), which multiplies a one-hot edges-to-rows matrix on the MXU
// over row-block-aligned chunks (prepare_chunks) because scatters are slow
// there. That layout is not carried over: on this card a gather-reduce over
// the sorted segments fits better. The sampler's valid edges are a
// dst-sorted prefix of length n_live (compact keeps the segment order of
// expand_seed_edges), so each output row finds its edge range with one binary
// search, and one warp per (row, 128-column slice) gathers h[src] rows
// (coalesced: lane l reads columns l, l+32, l+64, l+96), scales them and sums
// them in fp32 registers, in edge order. No atomics: the result is
// deterministic, and each product is rounded before it is added, as in the
// plain version, so only the order of the sums can differ from it.
//
// What bounds it: bytes. Each edge reads one row of h (F floats) and the
// output writes S x F floats; the arithmetic is 2 flops per gathered float,
// far below the card's ratio of flops to bytes. Rows past the real seeds
// have empty ranges and only write zeros. An edge whose dst is -1 (in the
// transposed call: a source dropped by an overflowing dedup, which sorts
// first) matches no row.
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
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlice = 128;             // columns per warp
constexpr int kPerLane = kSlice / 32;
constexpr long kGridCap = 132 * 64;

// Edge i of the sweep: i itself, or perm[i] in the transposed call.
__device__ __forceinline__ int edge_at(const int* perm, int i) {
  return perm != nullptr ? perm[i] : i;
}

__device__ __forceinline__ int lower_bound(const int* a, const int* perm,
                                           int lo, int hi, int x) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[edge_at(perm, mid)] < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void spmm_rows_kernel(const int* dst, const int* src,
                                 const float* w, const uint8_t* mask,
                                 const int* perm, int E, const int* n_live,
                                 const float* h, int T, int F, int S,
                                 float* out) {
  int n = E;
  if (n_live != nullptr) {
    n = *n_live;
    n = n < 0 ? 0 : (n < E ? n : E);
  }
  const int slices = (F + kSlice - 1) / kSlice;
  const long items = (long)S * slices;
  const long nwarps = ((long)gridDim.x * blockDim.x) >> 5;
  const int lane = threadIdx.x & 31;
  for (long it = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       it < items; it += nwarps) {
    const int row = (int)(it / slices);
    const int c0 = (int)(it % slices) * kSlice + lane;
    const int lo = lower_bound(dst, perm, 0, n, row);
    const int hi = lower_bound(dst, perm, lo, n, row + 1);
    float acc[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) acc[k] = 0.f;
    for (int i = lo; i < hi; ++i) {
      const int e = edge_at(perm, i);
      if (!mask[e]) continue;
      int s = src[e];
      if (s < 0) s += T;  // the plain version's negative-index wrap
      const float we = w[e];
      const float* hr = h + (long)s * F;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int c = c0 + 32 * k;
        if (c < F) acc[k] = __fadd_rn(acc[k], __fmul_rn(hr[c], we));
      }
    }
    float* o = out + (long)row * F;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int c = c0 + 32 * k;
      if (c < F) o[c] = acc[k];
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

extern "C" int spmm_rows(const int* dst, const int* src, const float* w,
                         const uint8_t* mask, const int* perm, int E,
                         const int* n_live, const float* h, int T, int F,
                         int S, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long items = (long)S * ((F + kSlice - 1) / kSlice);
  long blocks = (items * 32 + kThreads - 1) / kThreads;
  if (blocks > kGridCap) blocks = kGridCap;
  if (blocks < 1) blocks = 1;
  spmm_rows_kernel<<<(int)blocks, kThreads, 0, st>>>(
      dst, src, w, mask, perm, E, n_live, h, T, F, S, out);
  return (int)cudaGetLastError();
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
