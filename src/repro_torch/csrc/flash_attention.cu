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
// Design. One block per (64-query tile, query head, batch row), the longest
// causal tiles first; each of its warps owns 16 query rows, as
// FlashAttention-2 lays them out. The block stages its Q tile in shared
// memory once, then walks the key tiles of 64 keys that any of its queries
// can see (the causal and window bounds prune the rest, so a local layer
// touches O(window) keys). At hd 256 the block has two groups of 4 warps:
// group i takes keys [32 i, 32 i + 32) of every tile with an online softmax
// of its own, and the two (max, sum, O) are merged once at the end; one
// block then fills the SM's shared memory, and a second warp on each
// scheduler hides the latencies that one alone would wait on. K and V have
// one buffer each and arrive by 16-byte cp.async.cg copies, staggered: K of
// the next tile loads during this tile's softmax and P V, V of the next tile
// during its Q K^T. A q, k or v whose rows are not 16-byte aligned (a view
// one element off) is staged element by element instead.
//
// Both products run on the tensor cores, mma.sync m16n8k8 with TF32
// operands and fp32 accumulators, in 3xTF32: each fp32 operand x splits
// into big = tf32(x) and small = tf32(x - big) (cvt.rna), and a product
// a b is accumulated as a_small b_big + a_big b_small, then a_big b_big,
// the small terms first (CUTLASS's OpMultiplyAddFastF32 does the same).
// The dropped a_small b_small term is ~2^-22 of a b, so the sums stay near
// fp32. bf16 inputs widen exactly into TF32 (their small part is 0): Q K^T
// then takes one product, and P V two (P is fp32, V exact).
//
// S = Q K^T leaves each thread the scores of rows g and g + 8 (g = lane /
// 4) at keys 2t and 2t + 1 (t = lane % 4) of every 8-key column block. The
// online softmax (row max, rescale, row sum) runs on those registers,
// reduced across the 4 lanes of a row with __shfl_xor_sync. The P V product
// wants P as its A operand, whose layout holds keys t and t + 4, not 2t and
// 2t + 1; a sum over keys does not care about their order, so the kernel
// keeps P in registers and reads V's key rows in the matching permuted
// order (A's k index t stands for key 2t, t + 4 for key 2t + 1; V's B
// operand loads rows 2t and 2t + 1). Nothing round-trips through shared
// memory, and no shuffles move P. fp32 Q and K fragments come in by
// ldmatrix (four 8 x 4 blocks an instruction), the rest by 32-bit loads.
// Rows of the shared tiles are padded by 16 bytes, which makes every
// fragment load (Q and K at row g, column t; V at rows 2t and 2t + 1,
// column g) free of bank conflicts.
//
// What bounds it: operations. 4 hd FLOP per visible (query, key) pair and
// head; at gemma2-2b's 32k prefill that is 4.4e12 FLOP a global layer, 26.7
// ms at 3xTF32's 165 TFLOP/s (the card's 495 TF32 TFLOP/s dense over three
// products), against 0.54 GB of q, k, v and o (0.16 ms at 3.35 TB/s).
// Shared memory per block, fp32 (bf16 halves it): the Q, K and V tiles of
// 64 rows, 3 x 64 x 4 (hd + 4) bytes: hd 16 15,360; 32 27,648; 64 52,224;
// 80 64,512; 128 101,376; 256 199,680. The O accumulator takes hd / 2
// registers a thread (128 at hd 256).
//
// Launches on the given stream, synchronises nothing, returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;       // queries per block: 4 warps of 16 rows
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
  int vec;  // bit 0: q's rows 16-byte aligned; bit 1: k's and v's
};

template <int HD>
struct Shape {
  // keys per tile: 32 at hd <= 64 (four blocks fit an SM), else 64
  static constexpr int BK = HD <= 64 ? 32 : 64;
  // groups of 4 warps per block; group i takes keys [i KG, (i + 1) KG) of
  // every tile. Two at hd 256, where one block fills the SM's shared
  // memory and one warp per scheduler would idle on each dependency
  static constexpr int G = HD >= 256 ? 2 : 1;
  static constexpr int KG = BK / G;
  static constexpr int kThreads = 128 * G;
};

// row stride of a shared tile in elements: 16 bytes of padding
template <typename T, int HD>
__host__ __device__ constexpr int ld() { return HD + 16 / (int)sizeof(T); }

template <typename T, int HD>
constexpr int smem_bytes() {   // the Q, K and V tiles
  return (int)sizeof(T) * ld<T, HD>() * (kBQ + 2 * Shape<HD>::BK);
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x = big + small + O(2^-22 x), both TF32
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

// Four 8 x 4 fp32 blocks of shared memory, each row 16 bytes at the
// address lane (lane % 8) of lane group lane / 8 passes: lane l receives
// element (l / 4, l % 4) of block i in r[i], the layout of an mma operand
__device__ __forceinline__ void ldmatrix4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a b, m16n8k8, TF32 operands, fp32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage rows r0 .. r0 + rows - 1 of a (n, HD) matrix (row stride ss) into
// the shared tile s; rows at or past n read as 0. vec: 16-byte cp.async
// copies (rows past n zero-filled by a source size of 0), to be waited
// for; else element by element, done when it returns.
template <typename T, int HD>
__device__ __forceinline__ void stage(T* s, const T* g, long long ss, int r0,
                                      int n, int rows, int tid, bool vec) {
  constexpr int kLd = ld<T, HD>();
  constexpr int kThreads = Shape<HD>::kThreads;
  if (vec) {
    constexpr int kPer = 16 / (int)sizeof(T);   // elements per copy
    constexpr int kC = HD / kPer;               // copies per row
    for (int i = tid; i < rows * kC; i += kThreads) {
      const int r = i / kC, c = (i % kC) * kPer;
      const bool in = r0 + r < n;
      cp_async16(s + r * kLd + c, in ? g + (long long)(r0 + r) * ss + c : g,
                 in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < rows * HD; i += kThreads) {
      const int r = i / HD, c = i % HD;
      s[r * kLd + c] = r0 + r < n ? g[(long long)(r0 + r) * ss + c]
                                  : zero<T>();
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(Shape<HD>::kThreads, 1)
    flash_fwd(Params p) {
  constexpr int BK = Shape<HD>::BK, KG = Shape<HD>::KG;
  constexpr int kLd = ld<T, HD>();
  constexpr int NS = KG / 8;    // 8-key column blocks of a warp's scores
  constexpr int NO = HD / 8;    // 8-column blocks of the output
  constexpr bool kSplit = sizeof(T) == 4;   // bf16 has no small part
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = (T*)smem_raw;                     // [kBQ][kLd]
  T* Ks = Qs + kBQ * kLd;                   // [BK][kLd]
  T* Vs = Ks + BK * kLd;                    // [BK][kLd]

  const int nqb = (p.Sq + kBQ - 1) / kBQ;
  const int q0 = (nqb - 1 - (int)blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int tid = threadIdx.x, lane = tid & 31;
  const int wr = ((tid >> 5) & 3) * 16;     // the warp's first query row
  const int kg = (tid >> 7) * KG;           // its group's first key of a tile
  const int g = lane >> 2, t = lane & 3;
  const T* q = (const T*)p.q + b * p.q_sb + h * p.q_sh;
  const T* k = (const T*)p.k + b * p.k_sb + hk * p.k_sh;
  const T* v = (const T*)p.v + b * p.v_sb + hk * p.v_sh;
  const bool vec_q = p.vec & 1, vec_kv = p.vec & 2;
  // a window wider than any distance between a query and a key is none
  const int win = (int)min(p.window, (long long)p.Sq + p.Sk + 1);
  const float inv_cap = 1.f / p.softcap;
  constexpr float kLog2e = 1.4426950408889634f;

  // the key tiles the block walks: the union of its queries' visible
  // ranges [lo_i, hi_i]; lo_i and (when causal) hi_i grow with i
  const int q_last = min(q0 + kBQ, p.Sq) - 1;
  const int lo_first = p.has_window ? max(0, q0 - win + 1) : 0;
  const int lo_last = p.has_window ? max(0, q_last - win + 1) : 0;
  const int hi_last = p.causal ? min(q_last, p.Sk - 1) : p.Sk - 1;
  const int nkb = (p.Sk + BK - 1) / BK;
  int kb_begin = 0, kb_end = nkb;
  // a query that sees no key satisfies lo_i > hi_i, which holds for the
  // last query whenever it holds for any (lo_i > Sk - 1 is monotone in i);
  // such a block walks every key tile, so that query gets the mean of v
  if (lo_last <= hi_last) {
    kb_begin = lo_first / BK;
    kb_end = hi_last / BK + 1;
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  // K and V have one buffer each, their copies staggered: K of the next
  // tile loads while this tile's softmax and P V run, V of the next tile
  // while its Q K^T runs (commit order Q + K, V, K, V, ...)
  if (kb_begin < kb_end) {
    stage<T, HD>(Qs, q, p.q_ss, q0, p.Sq, kBQ, tid, vec_q);
    stage<T, HD>(Ks, k, p.k_ss, kb_begin * BK, p.Sk, BK, tid, vec_kv);
    cp_async_commit();
    stage<T, HD>(Vs, v, p.v_ss, kb_begin * BK, p.Sk, BK, tid, vec_kv);
    cp_async_commit();
  }

  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int k0 = kb * BK;
    const bool more = kb + 1 < kb_end;
    cp_async_wait<1>();   // this tile's K (its V may be in flight)
    __syncthreads();
    const T* Kt = Ks + kg * kLd;   // the group's KG keys
    const T* Vt = Vs + kg * kLd;
    const int kw = k0 + kg;        // their first key

    // S = Q K^T for the warp's 16 rows and the group's KG keys
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 4
    for (int d0 = 0; d0 < HD; d0 += 8) {
      uint32_t a_big[4], a_small[4];
      if constexpr (kSplit) {
        // Q rows wr + 0..7 / 8..15 at columns d0 / d0 + 4: a0 .. a3
        uint32_t qa[4];
        ldmatrix4(qa, Qs + (wr + (lane & 7) + 8 * ((lane >> 3) & 1)) * kLd +
                          d0 + 4 * (lane >> 4));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split(__uint_as_float(qa[e]), a_big[e], a_small[e]);
      } else {
        const T* qr = Qs + (wr + g) * kLd + d0 + t;
        a_big[0] = __float_as_uint(widen(qr[0]));
        a_big[1] = __float_as_uint(widen(qr[8 * kLd]));
        a_big[2] = __float_as_uint(widen(qr[4]));
        a_big[3] = __float_as_uint(widen(qr[8 * kLd + 4]));
      }
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        // keys 8 j + g and 8 (j + 1) + g at columns d0 + t, d0 + t + 4
        float kv[4];
        if constexpr (kSplit) {
          uint32_t kr[4];
          ldmatrix4(kr, Kt + (8 * j + (lane & 7) + 8 * (lane >> 4)) * kLd +
                            d0 + 4 * ((lane >> 3) & 1));
#pragma unroll
          for (int e = 0; e < 4; ++e) kv[e] = __uint_as_float(kr[e]);
        } else {
          const T* kr = Kt + (8 * j + g) * kLd + d0 + t;
          kv[0] = widen(kr[0]);
          kv[1] = widen(kr[4]);
          kv[2] = widen(kr[8 * kLd]);
          kv[3] = widen(kr[8 * kLd + 4]);
        }
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          uint32_t b_big[2], b_small[2];
          if constexpr (kSplit) {
            split(kv[2 * jj], b_big[0], b_small[0]);
            split(kv[2 * jj + 1], b_big[1], b_small[1]);
            mma(s[j + jj], a_small, b_big);
            mma(s[j + jj], a_big, b_small);
          } else {
            b_big[0] = __float_as_uint(kv[2 * jj]);
            b_big[1] = __float_as_uint(kv[2 * jj + 1]);
          }
          mma(s[j + jj], a_big, b_big);
        }
      }
    }
    __syncthreads();   // every warp is done with K
    if (more) {
      stage<T, HD>(Ks, k, p.k_ss, k0 + BK, p.Sk, BK, tid, vec_kv);
      cp_async_commit();
    }

    // a tile every query of the block sees whole needs no mask
    const bool whole = kw + KG <= p.Sk && (!p.causal || kw + KG - 1 <= q0) &&
                       (!p.has_window || q_last - kw < win);
    // online softmax over rows g (r = 0) and g + 8 (r = 1)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + wr + g + 8 * r;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kj = kw + 8 * j + 2 * t + e;
          float x = s[j][2 * r + e] * p.scale;
          if (p.has_softcap) x = tanhf(x * inv_cap) * p.softcap;
          if (!whole) {
            bool seen = true;
            if (p.causal) seen = seen && kj <= qi;
            if (p.has_window) seen = seen && qi - kj < win;
            x = seen ? x : kMasked;
            x = kj < p.Sk ? x : -INFINITY;   // no such key: weight 0
          }
          s[j][2 * r + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      // -inf: none of the group's keys so far exists (its share of the
      // last tile lies past Sk); it keeps no weight. exp(x - m) as
      // exp2((x - m) log2e): exactly 1 where x = m (also at -1e30)
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[j][2 * r + e];
          const float pe =
              x == -INFINITY ? 0.f : exp2f((x - m_new) * kLog2e);
          s[j][2 * r + e] = pe;
          sum += pe;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
    }

    if (more) cp_async_wait<1>();   // this tile's V (the next K in flight)
    else cp_async_wait<0>();
    __syncthreads();
    // O += P V: A's k index t is key 2t, t + 4 is key 2t + 1
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      uint32_t a_big[4], a_small[4];
      split(s[j][0], a_big[0], a_small[0]);   // row g,     key 2t
      split(s[j][2], a_big[1], a_small[1]);   // row g + 8, key 2t
      split(s[j][1], a_big[2], a_small[2]);   // row g,     key 2t + 1
      split(s[j][3], a_big[3], a_small[3]);   // row g + 8, key 2t + 1
      const T* vr = Vt + (8 * j + 2 * t) * kLd + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const float vv[2] = {widen(vr[8 * n]), widen(vr[kLd + 8 * n])};
        uint32_t b_big[2], b_small[2];
        if constexpr (kSplit) {
          split(vv[0], b_big[0], b_small[0]);
          split(vv[1], b_big[1], b_small[1]);
        } else {
          b_big[0] = __float_as_uint(vv[0]);
          b_big[1] = __float_as_uint(vv[1]);
        }
        mma(o[n], a_small, b_big);
        if constexpr (kSplit) mma(o[n], a_big, b_small);
        mma(o[n], a_big, b_big);
      }
    }
    __syncthreads();   // every warp is done with V
    if (more) {
      stage<T, HD>(Vs, v, p.v_ss, k0 + BK, p.Sk, BK, tid, vec_kv);
      cp_async_commit();
    }
  }

  if constexpr (Shape<HD>::G == 2) {
    static_assert((4 + 4 * NO) * 128 * 4 <= 2 * BK * kLd * (int)sizeof(T),
                  "the hand-over fits in the K and V buffers");
    // the second group hands its rows' (m, l, o) to the first through the
    // K and V buffers, [value][thread] so that each store is conflict-free
    float* x = (float*)Ks;
    const int i = tid & 127;
    if (tid >= 128) {
      x[i] = m[0];
      x[128 + i] = m[1];
      x[256 + i] = l[0];
      x[384 + i] = l[1];
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[(4 + 4 * n + e) * 128 + i] = o[n][e];
    }
    __syncthreads();
    if (tid >= 128) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mb = x[128 * r + i], lb = x[256 + 128 * r + i];
      const float mm = fmaxf(m[r], mb);
      const float ca = m[r] == -INFINITY ? 0.f : expf(m[r] - mm);
      const float cb = mb == -INFINITY ? 0.f : expf(mb - mm);
      l[r] = l[r] * ca + lb * cb;
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e)
          o[n][e] = o[n][e] * ca + x[(4 + 4 * n + e) * 128 + i] * cb;
    }
  }

  T* out = (T*)p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + wr + g + 8 * r;
    if (qi >= p.Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* orow = out + qi * p.o_ss + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      store(orow + 8 * n, o[n][2 * r] * inv);
      store(orow + 8 * n + 1, o[n][2 * r + 1] * inv);
    }
  }
}

template <typename T, int HD>
int launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<T, HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.Hq, B);
  flash_fwd<T, HD><<<grid, Shape<HD>::kThreads, bytes, stream>>>(p);
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
// elements; the head dimension is contiguous. vec: bit 0 when every row of q
// starts 16-byte aligned, bit 1 when every row of k and v does.
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
