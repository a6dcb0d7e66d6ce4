// Hopper (sm_90a) kernel for causal GQA attention, forward (B9):
//
//   o[b, i, h] = sum_j softmax_j(s[i, j]) v[b, j, h / G], s[i, j] =
//     cap(scale * q[b, i, h] . k[b, j, h / G]) where query i sees key j
//     (j <= i when causal, i - j < window with a window), else -1e30;
//     cap(s) = tanh(s / c) c with a softcap c. G = Hq / Hkv.
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py
// _flash_kernel and computes what its oracle (flash_attention/ref.py
// attention_ref) computes: the scale multiplies the scores, not q; masked
// scores are -1e30, so a query that sees no key at all averages every v, as
// the oracle's softmax over equal scores does; keys past Sk and queries past
// Sq are masked here, not padded (the TPU wrapper pads K with zero keys,
// which a non-causal call then weights).
//
// Design. One block of 256 threads per (64-query tile, query head, batch
// row), the longest causal tiles first. The block stages its Q tile in shared
// memory once, transposed, then walks the key tiles of 64 keys that any of
// its queries can see (the causal and window bounds prune the rest, so a
// local layer touches O(window) keys), with an online softmax: each thread
// owns 4 query rows and 4 keys of the 64 x 64 score tile (4 x 4 FMAs per
// head-dim step from two float4 shared-memory reads), reduces the row max
// and sum across the 16 threads of its row with warp shuffles, writes its
// probabilities to shared memory and accumulates p V into 4 x (hd / 16)
// fp32 registers. Everything is fp32 FMA on the CUDA cores; bf16 inputs are
// widened as they are staged and the output is rounded once. A tile with a
// query that sees no key (only with a window and Sq >= Sk + window) walks
// every key tile, so that query gets the oracle's mean of v.
//
// What bounds it: operations. 4 hd FLOP per visible (query, key) pair and
// head; at gemma2-2b's 32k prefill that is 4.4e12 FLOP a global layer, 66 ms
// at the card's 67 TFLOP/s fp32, against 0.54 GB of q, k, v and o (0.16 ms).
// This first version runs on the CUDA cores (fp32 FMA), not the tensor cores
// (wgmma, TMA and bf16 operands are later work). Shared memory per block:
// 4 (hd (64 + 4) + 64 (64 + 4)) + 4 hd 64 bytes, 222,208 at hd 256.
//
// Launches on the given stream, synchronises nothing, returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;       // queries per block
constexpr int kBK = 64;       // keys per tile
constexpr int kPad = 4;       // row padding of the transposed tiles (floats)
constexpr int kThreads = 256;
constexpr float kMasked = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_ss, q_sh;  // strides in elements (batch, seq, head)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int Sq, Sk, Hq, Hkv;
  int causal, has_window;
  long long window;
  int has_softcap;
  float softcap, scale;
  int vec;  // q, k, v rows aligned for load4
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
// 4 consecutive elements, widened to float (16-byte aligned for float,
// 8-byte for bfloat16: the wrapper sets Params::vec only then)
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg((const float4*)p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* p2 = (const __nv_bfloat162*)p;
  const float2 a = __bfloat1622float2(p2[0]);
  const float2 b = __bfloat1622float2(p2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

constexpr int smem_bytes(int hd) {
  return 4 * (hd * (kBQ + kPad) + hd * (kBK + kPad) + kBK * hd +
              kBK * (kBQ + kPad));
}

// Stage rows r0.. of a (rows, HD) matrix transposed into T_s[HD][64 + pad]
// (rows at or past n read as 0). Vector path: lanes pair up on a row (each
// pair reads one 32-byte sector) and 16 pairs take 16 consecutive rows, so
// the transposed stores of a warp hit 32 distinct banks; all of a thread's
// loads of a batch are in flight before its stores.
template <typename T, int HD>
__device__ __forceinline__ void stage_transposed(const T* x, long long ss,
                                                 int r0, int n, float* t_s,
                                                 int tid, bool vec) {
  constexpr int kN = 64 * HD / 4 / kThreads;   // float4 per thread: HD / 16
  constexpr int kBatch = kN % 4 == 0 ? 4 : kN;
  if (vec) {
#pragma unroll
    for (int c = 0; c < kN; c += kBatch) {
      float4 reg[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = tid + (c + u) * kThreads;
        const int j = (i >> 1) & 63, d = (((i >> 7) << 1) | (i & 1)) * 4;
        reg[u] = r0 + j < n ? load4(x + (r0 + j) * ss + d)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = tid + (c + u) * kThreads;
        const int j = (i >> 1) & 63, d = (((i >> 7) << 1) | (i & 1)) * 4;
        t_s[(d + 0) * (64 + kPad) + j] = reg[u].x;
        t_s[(d + 1) * (64 + kPad) + j] = reg[u].y;
        t_s[(d + 2) * (64 + kPad) + j] = reg[u].z;
        t_s[(d + 3) * (64 + kPad) + j] = reg[u].w;
      }
    }
  } else {
    for (int i = tid; i < 64 * HD; i += kThreads) {
      const int j = i / HD, d = i % HD;
      t_s[d * (64 + kPad) + j] = r0 + j < n ? load(x + (r0 + j) * ss + d)
                                            : 0.f;
    }
  }
}

// Stage rows r0.. of a (rows, HD) matrix as they are into v_s[64][HD].
template <typename T, int HD>
__device__ __forceinline__ void stage_rows(const T* x, long long ss, int r0,
                                           int n, float* v_s, int tid,
                                           bool vec) {
  constexpr int kV4 = HD / 4;
  constexpr int kN = 64 * kV4 / kThreads;
  constexpr int kBatch = kN % 4 == 0 ? 4 : kN;
  if (vec) {
#pragma unroll
    for (int c = 0; c < kN; c += kBatch) {
      float4 reg[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = tid + (c + u) * kThreads;
        const int j = i / kV4, d = (i % kV4) * 4;
        reg[u] = r0 + j < n ? load4(x + (r0 + j) * ss + d)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = tid + (c + u) * kThreads;
        *(float4*)&v_s[(i / kV4) * HD + (i % kV4) * 4] = reg[u];
      }
    }
  } else {
    for (int i = tid; i < 64 * HD; i += kThreads) {
      const int j = i / HD, d = i % HD;
      v_s[j * HD + d] = r0 + j < n ? load(x + (r0 + j) * ss + d) : 0.f;
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd(Params p) {
  constexpr int CPT = HD / 16;            // output columns per thread
  constexpr bool kVec = HD % 64 == 0;     // float4 columns tx*4 + 64 c
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                             // [HD][kBQ + kPad]
  float* Kt = Qt + HD * (kBQ + kPad);           // [HD][kBK + kPad]
  float* Vs = Kt + HD * (kBK + kPad);           // [kBK][HD]
  float* Pt = Vs + kBK * HD;                    // [kBK][kBQ + kPad]

  const int nqb = (p.Sq + kBQ - 1) / kBQ;
  const int q0 = (nqb - 1 - (int)blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* q = (const T*)p.q + b * p.q_sb + h * p.q_sh;
  const T* k = (const T*)p.k + b * p.k_sb + hk * p.k_sh;
  const T* v = (const T*)p.v + b * p.v_sb + hk * p.v_sh;

  stage_transposed<T, HD>(q, p.q_ss, q0, p.Sq, Qt, tid, p.vec);

  // the key tiles the block walks: the union of its queries' visible
  // ranges [lo_i, hi_i]; lo_i and (when causal) hi_i grow with i
  const long long q_last = min(q0 + kBQ, p.Sq) - 1;
  const long long lo_first =
      p.has_window ? max(0LL, (long long)q0 - p.window + 1) : 0;
  const long long lo_last =
      p.has_window ? max(0LL, q_last - p.window + 1) : 0;
  const long long hi_last =
      p.causal ? min(q_last, (long long)p.Sk - 1) : (long long)p.Sk - 1;
  const int nkb = (p.Sk + kBK - 1) / kBK;
  int kb_begin = 0, kb_end = nkb;
  // a query that sees no key satisfies lo_i > hi_i, which holds for the
  // last query whenever it holds for any (lo_i > Sk - 1 is monotone in i)
  if (lo_last <= hi_last) {
    kb_begin = (int)(lo_first / kBK);
    kb_end = (int)(hi_last / kBK) + 1;
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();  // the previous tile's Kt, Vs and Pt are consumed
    stage_transposed<T, HD>(k, p.k_ss, k0, p.Sk, Kt, tid, p.vec);
    stage_rows<T, HD>(v, p.v_ss, k0, p.Sk, Vs, tid, p.vec);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *(const float4*)&Qt[d * (kBQ + kPad) + ty * 4];
      const float4 c = *(const float4*)&Kt[d * (kBK + kPad) + tx * 4];
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qi = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long kj = k0 + tx * 4 + j;
        float x = s[i][j] * p.scale;
        if (p.has_softcap) x = tanhf(x / p.softcap) * p.softcap;
        bool seen = true;
        if (p.causal) seen = seen && kj <= qi;
        if (p.has_window) seen = seen && qi - kj < p.window;
        x = seen ? x : kMasked;
        x = kj < p.Sk ? x : -INFINITY;   // no such key: weight 0
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *(float4*)&Pt[(tx * 4 + j) * (kBQ + kPad) + ty * 4] =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 pp = *(const float4*)&Pt[j * (kBQ + kPad) + ty * 4];
      const float pv[4] = {pp.x, pp.y, pp.z, pp.w};
      if constexpr (kVec) {
#pragma unroll
        for (int c4 = 0; c4 < HD / 64; ++c4) {
          const float4 vv = *(const float4*)&Vs[j * HD + c4 * 64 + tx * 4];
          const float vw[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][c4 * 4 + e] = fmaf(pv[i], vw[e], acc[i][c4 * 4 + e]);
        }
      } else {
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float vv = Vs[j * HD + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
  }

  T* o = (T*)p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= p.Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = kVec ? (c / 4) * 64 + tx * 4 + c % 4 : tx + 16 * c;
      store(o + qi * p.o_ss + col, acc[i][c] * inv);
    }
  }
}

template <typename T, int HD>
int launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int bytes = smem_bytes(HD);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.Hq, B);
  flash_fwd<T, HD><<<grid, kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, int B, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(p, B, stream);
    case 32: return launch<T, 32>(p, B, stream);
    case 64: return launch<T, 64>(p, B, stream);
    case 80: return launch<T, 80>(p, B, stream);
    case 128: return launch<T, 128>(p, B, stream);
    case 256: return launch<T, 256>(p, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. strides: (batch, seq, head) of q, k, v, o in
// elements; the head dimension is contiguous. vec: every row of q, k and v
// starts 16-byte aligned (float) or 8-byte aligned (bfloat16).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int Sq,
    int Sk, int Hq, int Hkv, int hd, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int causal, int has_window,
    long long window, int has_softcap, float softcap, float scale, int dtype,
    int vec, void* stream) {
  if (B <= 0 || Sq <= 0) return (int)cudaSuccess;
  Params p{q,    k,    v,    o,    q_sb,   q_ss,       q_sh,   k_sb,
           k_ss, k_sh, v_sb, v_ss, v_sh,   o_sb,       o_ss,   o_sh,
           Sq,   Sk,   Hq,   Hkv,  causal, has_window, window, has_softcap,
           softcap, scale, vec};
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1 ? dispatch<__nv_bfloat16>(p, B, hd, s)
                    : dispatch<float>(p, B, hd, s);
}
