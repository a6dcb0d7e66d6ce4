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
// needs ceil(log2(C + 1)) dependent 4-byte reads of the CDF per draw: ~1 MB
// for LADIES's 10,240 draws over a 9.4 M-entry layer-2 CDF, a third of a
// microsecond at 3.35 TB/s. What bounds it is the chain of dependent
// reads: a binary search, one thread per draw, waits on 24 memory round
// trips in a row at that size.
//
// Design: a G-ary search, a group of kG = 8 lanes per draw. Each round
// splits the candidate interval [lo, hi) into G chunks of `step` =
// ceil(len / G) entries; lane j reads the last entry of chunk j (at lo +
// (j + 1) * step - 1; a lane past hi - 1 counts as reached without a
// read), and one __ballot_sync picks the first chunk whose last entry
// reaches u. The next interval is that chunk without its last entry, so
// it holds at most step - 1 entries: ceil(log_G(C + 1)) rounds, 8 at C =
// 9.4 M, each one memory round trip with G loads in flight. The lanes'
// entries of the first two rounds (G, then G per first-round chunk: 72
// values) are the same for every draw: each block stages them in shared
// memory once, so a draw's first two rounds read no device memory. 4
// draws a warp, 32 a block: LADIES's 10,240 draws are 320 blocks, one
// wave. Why 8 lanes and not 32: a round's G probes lie in G different
// 32-byte sectors until the interval is short, so a draw moves ~G
// sectors a round through L2, and at 10,240 draws that traffic, not the
// chain of round trips, sets the time; for the same reason the staging
// saved nothing measurable at 8 lanes (PERF.md, section 6).
//
// Positions are unsigned 32-bit: lo, hi <= C < 2^31 and a probe, at most
// lo + G * ceil(len / G) - 1, is below hi + G, so C near 2^31 cannot
// overflow. A NaN u reaches no entry and ends at C, clipped to C - 1, as
// searchsorted's C is. ref.py::cdf_search runs the same rounds on
// tensors.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kG = 8;                           // lanes per draw
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPerBlock = kWarps * (32 / kG);   // draws a block
constexpr int kStaged = kG + kG * kG;           // two rounds' entries
constexpr unsigned kFull = 0xffffffffu;
static_assert(32 % kG == 0 && kG < 32, "lanes per draw divide a warp");

// Lane j's probe in the interval [lo, hi) (hi > lo): its position, and
// whether it lies inside (a lane past the end counts as reached).
__device__ __forceinline__ bool probe(unsigned lo, unsigned hi, unsigned j,
                                      unsigned* p) {
  const unsigned step = (hi - lo + kG - 1) / kG;
  *p = lo + (j + 1) * step - 1;
  return *p < hi;
}

// The interval after lane k's chunk was picked (see the header).
__device__ __forceinline__ void pick(unsigned* lo, unsigned* hi, unsigned k) {
  const unsigned step = (*hi - *lo + kG - 1) / kG;
  const unsigned end = *lo + (k + 1) * step - 1;
  *lo += k * step;
  *hi = end < *hi ? end : *hi;
}

__global__ void __launch_bounds__(kThreads)
cdf_search_kernel(const float* __restrict__ cdf, int C,
                  const float* __restrict__ u, int n,
                  int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const unsigned j = lane % kG;                // lane within its group
  const int shift = lane - (int)j;             // the group's first lane

  // staged[j]: round 0's lane j; staged[kG + k * kG + j]: round 1's lane
  // j after round 0 picked chunk k
  __shared__ float staged[kStaged];
  for (int i = threadIdx.x; i < kStaged; i += kThreads) {
    unsigned l = 0, h = (unsigned)C, p;
    if (i >= kG) pick(&l, &h, (unsigned)(i - kG) / kG);
    if (l < h && probe(l, h, (unsigned)i % kG, &p)) staged[i] = __ldg(cdf + p);
  }
  __syncthreads();

  const int d = blockIdx.x * kPerBlock + threadIdx.x / kG;
  if (blockIdx.x * kPerBlock + (int)(threadIdx.x & ~31) / kG >= n) return;
  const float t = d < n ? __ldg(u + d) : 0.0f;
  unsigned lo = 0, hi = d < n ? (unsigned)C : 0u;   // past n: nothing
  int rounds = 0;                                   // ref.py::search_rounds
  for (unsigned len = (unsigned)C; len > 0; len = (len + kG - 1) / kG - 1)
    ++rounds;
  for (int round = 0, node = 0; round < rounds; ++round) {
    unsigned p;
    bool reached = true;
    if (lo < hi && probe(lo, hi, j, &p)) {
      const float v = round < 2
                          ? staged[round == 0 ? j : kG + node * kG + j]
                          : __ldg(cdf + p);
      reached = v >= t;
    }
    const unsigned b = __ballot_sync(kFull, reached);
    const unsigned g = (b >> shift) & ((1u << kG) - 1u);
    if (lo < hi) {
      if (g == 0) {
        lo = hi;                                    // no entry reaches u
      } else {
        node = __ffs(g) - 1;
        pick(&lo, &hi, node);
      }
    }
  }
  if (j == 0 && d < n) out[d] = (int32_t)(lo < (unsigned)C - 1 ? lo : C - 1);
}

}  // namespace

// Lanes per draw; ref.py's SEARCH_G must equal it (a card test checks).
extern "C" int frontier_search_group() { return kG; }

// cdf float32[C] (C >= 1), u float32[n] (n >= 0), out int32[n]; launches
// on `stream`, returns cudaGetLastError(). n = 0 launches nothing.
extern "C" int frontier_cdf_search(const float* cdf, int C, const float* u,
                                   int n, int32_t* out, void* stream) {
  if (C < 1 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const int blocks = (n + kPerBlock - 1) / kPerBlock;
    cdf_search_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(cdf, C, u, n,
                                                             out);
  }
  return static_cast<int>(cudaGetLastError());
}
