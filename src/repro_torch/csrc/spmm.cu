// Hopper (sm_90a) kernel for the weighted SpMM forward of a sampled block
// (ops.aggregate): out[s] = sum over edges e with dst[e] = s and mask[e] of
// w[e] * h[src[e]], for every one of the S output rows.
//
// It replaces the TPU kernel repro/kernels/spmm/spmm.py _spmm_kernel
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
// have empty ranges and only write zeros.
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

__device__ __forceinline__ int lower_bound(const int* a, int lo, int hi,
                                           int x) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void spmm_rows_kernel(const int* dst, const int* src,
                                 const float* w, const uint8_t* mask, int E,
                                 const int* n_live, const float* h, int T,
                                 int F, int S, float* out) {
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
    const int lo = lower_bound(dst, 0, n, row);
    const int hi = lower_bound(dst, lo, n, row + 1);
    float acc[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) acc[k] = 0.f;
    for (int e = lo; e < hi; ++e) {
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

}  // namespace

extern "C" int spmm_rows(const int* dst, const int* src, const float* w,
                         const uint8_t* mask, int E, const int* n_live,
                         const float* h, int T, int F, int S, float* out,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long items = (long)S * ((F + kSlice - 1) / kSlice);
  long blocks = (items * 32 + kThreads - 1) / kThreads;
  if (blocks > kGridCap) blocks = kGridCap;
  if (blocks < 1) blocks = 1;
  spmm_rows_kernel<<<(int)blocks, kThreads, 0, st>>>(dst, src, w, mask, E,
                                                     n_live, h, T, F, S, out);
  return (int)cudaGetLastError();
}
