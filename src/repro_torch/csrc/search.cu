// Hopper (sm_90a) kernel for the inverse-CDF draw of LADIES
// (masked_cdf_draw): for each u, the first index i with cdf[i] >= u
// (searchsorted 'left' over a non-decreasing CDF), clipped into [0, C-1].
//
// Replaces the TPU kernels src/repro/kernels/frontier/frontier.py:303
// search_kernel (a serial per-draw binary search over a VMEM CDF) and
// src/repro/kernels/frontier/parallel.py:503 batched_search_kernel (all
// draws bisecting in lockstep). The CDF itself is formed outside the
// kernel by the shared plain glue (kernels/frontier/ref.py::
// normalized_cdf), so the kernel and the plain version search the same
// floats.
//
// Bound: the function reads u (4n bytes), writes the draws (4n bytes) and
// needs at most ceil(log2(C + 1)) dependent 4-byte reads of the CDF per
// draw: ~1 MB for LADIES's 10,240 draws over a 9.4 M-entry layer-2 CDF,
// a third of a microsecond at 3.35 TB/s. It is bound by the latency of
// those dependent reads, not by bytes: the design is one thread per draw,
// a binary search through the read-only path (__ldg), with the CDF (at
// most 37.7 MB on the paper's path) resident in the 50 MB L2 after the
// first levels. The midpoint is lo + (hi - lo) / 2, so C near 2^31 cannot
// overflow. Staging the top levels of the search tree in shared memory is
// left for later.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void cdf_search_kernel(const float* __restrict__ cdf, int C,
                                  const float* __restrict__ u, int n,
                                  int32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float t = __ldg(u + i);
  int lo = 0, hi = C;
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (__ldg(cdf + mid) >= t) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  out[i] = lo < C - 1 ? lo : C - 1;   // lo >= 0 by construction
}

}  // namespace

// cdf float32[C] (C >= 1), u float32[n] (n >= 0), out int32[n]; launches
// on `stream`, returns cudaGetLastError(). n = 0 launches nothing.
extern "C" int frontier_cdf_search(const float* cdf, int C, const float* u,
                                   int n, int32_t* out, void* stream) {
  if (C < 1 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    cdf_search_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(cdf, C, u, n,
                                                             out);
  }
  return static_cast<int>(cudaGetLastError());
}
