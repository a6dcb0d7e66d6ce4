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
// Design: two launches on the caller's stream.
//
// 1. flash_prologue reads k and v through their strides, at any alignment,
//    and writes them once into head-major scratch that the wrapper
//    allocates: K as [B][Hkv][part][Sk][hd] and V transposed,
//    [B][Hkv][part][hd][Skp] (Skp = Sk rounded up to 8, the pad zero).
//    Every row starts 16-byte aligned, so the Tensor Memory Accelerator
//    (TMA) can describe it. For fp32 the parts are the 3xTF32 split, big =
//    tf32(x) and small = tf32(x - big) (cvt.rna; a value that rounds to inf
//    keeps its truncation as big), made once per element instead of once per
//    query tile that reads it; bf16 has one part, the value. The tensor
//    cores take TF32 operands only K-major, so V, the B operand of P V, is
//    stored transposed; for fp32 the 8 keys of each k-step are stored in the
//    order 0 2 4 6 1 3 5 7, the order in which P's accumulator layout hands
//    them to the A operand (below). q is read by the main kernel itself:
//    each query row belongs to one block, which splits it once.
//
// 2. flash_fwd, warp-specialised, launched as the prologue's programmatic
//    dependent (its blocks start, and stage q, while the prologue ends; the
//    producer waits on griddepcontrol before its first copy): one block per
//    (BQ-query tile, query head, batch row), the longest causal tiles first
//    (across all heads when a head has fewer tiles than the card has SMs),
//    of one producer warpgroup
//    and C consumer warpgroups of 64 query rows each (BQ = 64 C). One
//    thread of the producer starts every copy of K and V as TMA boxes
//    (cp.async.bulk.tensor, 3-D over the scratch: {row elements, rows,
//    plane}) signalled to mbarriers by transaction bytes, into a ring of NS
//    slabs that holds, per key tile of BK keys, NC = hd / DC slabs of K (BK
//    keys x DC head dims) and then NC slabs of V^T (DC dims x BK keys).
//    Each slab has a full barrier (its bytes arrived) and an empty one
//    (every consumer warp is done with it), so the producer runs NS slabs
//    ahead of the products. The producer gives back registers
//    (setmaxnreg.dec); it walks the same key tiles as the consumers: the
//    ones that any query of the block can see, so a local layer touches
//    O(window) keys. Shared tiles are stored with a 128-, 64- or 32-byte
//    swizzle (the widest that divides a row of Q and K; V^T's rows of BK
//    keys always take 128), as TMA writes them (and the consumers write Q's
//    rows), which wgmma's shared-memory descriptors read back without bank
//    conflicts; a k-step advances the descriptor's start by 32 bytes within
//    the swizzle atom.
//
//    Each consumer warpgroup first stages its 64 rows of q (split for
//    fp32), then multiplies with wgmma.mma_async, fp32 accumulators in
//    registers. S = Q K^T takes Q and K from shared memory (m64nBKk8 TF32,
//    or m64nBKk16 bf16); fp32 runs 3xTF32 in the order small big, big
//    small, big big at each k-step (CUTLASS's OpMultiplyAddFastF32 does the
//    same), so the sums stay near fp32 (the dropped small small term is
//    ~2^-22 of a product). The online softmax runs on the accumulator
//    registers, in log2 units (scores times log2 e, so that each weight is
//    one ex2): each thread holds rows g and g + 8 (g = lane / 4) of its
//    warp's 16 at keys 8j + 2t and 8j + 2t + 1 (t = lane % 4), reduced
//    across the 4 lanes of a row by shuffles; a tile that every query of
//    the warpgroup sees whole skips the masks. O += P V then takes P from
//    registers as wgmma's A operand (m64nDCk8): P splits there into big and
//    small TF32
//    (fp32) or hi and lo bf16 (bf16: P = hi + lo to ~2^-17, two m64nDCk16
//    products with exact V, so the weights keep fp32's precision). A TF32
//    A fragment holds keys t and t + 4 of a k-step where the accumulator
//    holds 2t and 2t + 1; a sum over keys does not care about their order,
//    so V^T's keys are stored permuted to match (bf16's k16 fragment equals
//    the accumulator's layout). Nothing round-trips through shared memory.
//    fp32 accumulates each slab's P V from zero and adds it to O in
//    registers (O = alpha O + P V, rounded to nearest): chained inside the
//    tensor cores over a 32k-key row, O drifted 1.4e-4 from the plain
//    version on gemma2-2b's inputs (6.7e-6 so). bf16 accumulates in O and
//    rescales it only where a row's maximum moved. Two consumer warpgroups
//    take turns to start Q K^T (named barriers), so that one's softmax
//    runs while the other's products do.
//
// Plan per (dtype, hd): C consumer warpgroups, BK keys a tile, DC head dims
// a slab, NS slabs in the ring; shared memory = 1024 (alignment) + Q (BQ hd
// parts) + NS slabs (BK DC parts) + 256 (barriers), in bytes; the wrapper's
// ops.PLANS mirrors it.
//
//   fp32  hd 16: C 2, BK 64, DC 16,  NS 4:  16,384 + 4 x  8,192 =  50,432
//         hd 32: C 2, BK 64, DC 32,  NS 4:  32,768 + 4 x 16,384 =  99,584
//         hd 64: C 2, BK 64, DC 64,  NS 4:  65,536 + 4 x 32,768 = 197,888
//         hd 80: C 2, BK 64, DC 80,  NS 3:  81,920 + 3 x 40,960 = 206,080
//         hd 128: C 2, BK 64, DC 64, NS 3: 131,072 + 3 x 32,768 = 230,656
//         hd 256: C 1, BK 64, DC 64, NS 3: 131,072 + 3 x 32,768 = 230,656
//   bf16  hd 16: C 2, BK 64, DC 16,  NS 4:   4,096 + 4 x  2,048 =  13,568
//         hd 32: C 2, BK 64, DC 32,  NS 4:   8,192 + 4 x  4,096 =  25,856
//         hd 64: C 2, BK 64, DC 64,  NS 4:  16,384 + 4 x  8,192 =  50,432
//         hd 80: C 2, BK 64, DC 80,  NS 4:  20,480 + 4 x 10,240 =  62,720
//         hd 128: C 2, BK 64, DC 128, NS 4: 32,768 + 4 x 16,384 =  99,584
//         hd 256: C 2, BK 64, DC 256, NS 4: 65,536 + 4 x 32,768 = 197,888
//
// At hd 256 in fp32 Q's two parts alone take 128 KB, so one consumer
// warpgroup runs there and K and V stream in 64-dim slabs; the O
// accumulator takes hd / 2 registers a thread (128 at hd 256).
//
// What bounds it: operations. 4 hd FLOP per visible (query, key) pair and
// head; at gemma2-2b's 32k prefill that is 4.4e12 FLOP a global layer, 26.7
// ms at 3xTF32's 165 TFLOP/s (the card's 495 TF32 TFLOP/s dense over three
// products), against 0.54 GB of q, k, v and o (0.16 ms at 3.35 TB/s). What
// holds it off that bound is the softmax's instructions: ~30 a score (with
// gemma2's tanh) against 0.375 tensor cycles of an SM a score at hd 64,
// 1.5 at hd 256; two warpgroups hide part of them behind each other's
// products, one (hd 256 in fp32) cannot. tools/flash_sweep.py's
// no_softmax and half_bytes variants split the time (PERF.md's B9
// findings).
//
// Launches on the given stream, synchronises nothing, returns
// cudaGetLastError() (or 1000 + libcuda's error when a tensor map
// cannot be encoded).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace {

// masked scores, -1e30, in log2 units
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked2 = -1e30f * kLog2e;

// ---------------------------------------------------------------- the plan

template <typename T, int HD> struct Plan;
#define FLASH_PLAN(T_, HD_, C_, BK_, DC_, NS_)                        \
  template <> struct Plan<T_, HD_> {                                  \
    static constexpr int C = C_, BK = BK_, DC = DC_, NS = NS_;        \
  };
FLASH_PLAN(float, 16, 2, 64, 16, 4)
FLASH_PLAN(float, 32, 2, 64, 32, 4)
FLASH_PLAN(float, 64, 2, 64, 64, 4)
FLASH_PLAN(float, 80, 2, 64, 80, 3)
FLASH_PLAN(float, 128, 2, 64, 64, 3)
FLASH_PLAN(float, 256, 1, 64, 64, 3)
FLASH_PLAN(__nv_bfloat16, 16, 2, 64, 16, 4)
FLASH_PLAN(__nv_bfloat16, 32, 2, 64, 32, 4)
FLASH_PLAN(__nv_bfloat16, 64, 2, 64, 64, 4)
FLASH_PLAN(__nv_bfloat16, 80, 2, 64, 80, 4)
FLASH_PLAN(__nv_bfloat16, 128, 2, 64, 128, 4)
FLASH_PLAN(__nv_bfloat16, 256, 2, 64, 256, 4)
#undef FLASH_PLAN

// the widest swizzle (bytes) that divides a row of row_bytes
constexpr int swizzle_for(int row_bytes) {
  return row_bytes % 128 == 0 ? 128 : row_bytes % 64 == 0 ? 64 : 32;
}

template <typename T, int HD> struct Geo {
  static constexpr int C = Plan<T, HD>::C, BK = Plan<T, HD>::BK;
  static constexpr int DC = Plan<T, HD>::DC, NS = Plan<T, HD>::NS;
  static constexpr int BQ = 64 * C, NC = HD / DC;
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int E = (int)sizeof(T), PARTS = kF32 ? 2 : 1;
  static constexpr int KD = 32 / E;              // elements of a k-step
  static constexpr int SW = swizzle_for(HD * E); // Q and K rows
  static constexpr int W = SW / E;               // elements a box row
  static constexpr int WV = 128 / E;             // V^T's box row (keys)
  static constexpr int Q_PART = BQ * HD * E;
  static constexpr int Q_BYTES = Q_PART * PARTS;
  static constexpr int SLAB_PART = BK * DC * E;
  static constexpr int SLAB = SLAB_PART * PARTS;
  static constexpr int SMEM = 1024 + Q_BYTES + NS * SLAB + 256;
  static constexpr int kThreads = 128 * (C + 1);
  static_assert(HD % DC == 0 && DC % W == 0 && DC % 8 == 0, "slabs");
  static_assert(BK % WV == 0 && BK % 16 == 0 && BK <= 256, "key tiles");
  static_assert((BK * SW) % 1024 == 0 && (BQ * SW) % 1024 == 0 &&
                    (64 * SW) % 1024 == 0 && (DC * 128) % 1024 == 0 &&
                    SLAB_PART % 1024 == 0 && Q_PART % 1024 == 0,
                "every swizzle atom starts 1024-byte aligned");
  static_assert(SMEM <= 232448, "one block fits the SM's shared memory");
  static_assert(2 * NS <= 32, "the barriers fit their 256 bytes");
};

struct Params {
  const void* q;
  void* o;
  long long q_sb, q_ss, q_sh;
  long long o_sb, o_ss, o_sh;
  int Sq, Sk, Hq, Hkv;
  int causal, has_window;
  long long window;
  int has_softcap;
  float softcap, scale;
};

// ------------------------------------------------------- PTX: the copies

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
// one 3-D TMA box {c0, c1, c2} of the tensor map into shared memory at
// dst, its bytes counted on the barrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}
// named barriers among the consumer warpgroups (0 is __syncthreads')
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ------------------------------------------------------- PTX: wgmma

// a shared-memory matrix descriptor: K-major, rows of `sw` bytes swizzled
// by `sw` (128, 64 or 32), 8-row groups 8 sw bytes apart
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, int sw) {
  const uint64_t layout = sw == 128 ? 1 : sw == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)((8 * sw) >> 4) << 32) | (layout << 62);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator registers across the start
// of a wgmma or its wait (CUTLASS's warpgroup_fence_operand)
template <int N>
__device__ __forceinline__ void fence_regs(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&x)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(x[i][j])::"memory");
}

// accumulator register lists, 8 at a time
#define FA_R0 "%0, %1, %2, %3, %4, %5, %6, %7"
#define FA_R1 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define FA_R2 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define FA_R3 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define FA_R4 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define FA_R5 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define FA_R6 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define FA_R7 ", %56, %57, %58, %59, %60, %61, %62, %63"
#define FA_R8 ", %64, %65, %66, %67, %68, %69, %70, %71"
#define FA_R9 ", %72, %73, %74, %75, %76, %77, %78, %79"
#define FA_R10 ", %80, %81, %82, %83, %84, %85, %86, %87"
#define FA_R11 ", %88, %89, %90, %91, %92, %93, %94, %95"
#define FA_R12 ", %96, %97, %98, %99, %100, %101, %102, %103"
#define FA_R13 ", %104, %105, %106, %107, %108, %109, %110, %111"
#define FA_R14 ", %112, %113, %114, %115, %116, %117, %118, %119"
#define FA_R15 ", %120, %121, %122, %123, %124, %125, %126, %127"
#define FA_ACC8 FA_R0
#define FA_ACC16 FA_R0 FA_R1
#define FA_ACC32 FA_R0 FA_R1 FA_R2 FA_R3
#define FA_ACC40 FA_ACC32 FA_R4
#define FA_ACC64 FA_ACC32 FA_R4 FA_R5 FA_R6 FA_R7
#define FA_ACC128 \
  FA_ACC64 FA_R8 FA_R9 FA_R10 FA_R11 FA_R12 FA_R13 FA_R14 FA_R15

#define FA_O8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define FA_OUT8 FA_O8(0)
#define FA_OUT16 FA_O8(0), FA_O8(8)
#define FA_OUT32 FA_OUT16, FA_O8(16), FA_O8(24)
#define FA_OUT40 FA_OUT32, FA_O8(32)
#define FA_OUT64 FA_OUT32, FA_O8(32), FA_O8(40), FA_O8(48), FA_O8(56)
#define FA_OUT128                                                      \
  FA_OUT64, FA_O8(64), FA_O8(72), FA_O8(80), FA_O8(88), FA_O8(96),     \
      FA_O8(104), FA_O8(112), FA_O8(120)

template <int N> struct Mma;

// d += a b, A and B from shared memory (descriptors), m64nNk8 TF32 or
// m64nNk16 bf16, both K-major (Q K^T: N = BK)
#define FA_SS(N, ACC, OUTS, IA, IB, IS)                                      \
  static __device__ __forceinline__ void ss_tf32(float (&d)[N / 2],          \
                                                 uint64_t a, uint64_t b) {   \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " IS ", 0;\n"             \
                 "wgmma.mma_async.sync.aligned.m64n" #N                      \
                 "k8.f32.tf32.tf32 {" ACC "}, " IA ", " IB ", p, 1, 1;\n}\n" \
                 : OUTS                                                      \
                 : "l"(a), "l"(b), "r"(1));                                  \
  }                                                                          \
  static __device__ __forceinline__ void ss_bf16(float (&d)[N / 2],          \
                                                 uint64_t a, uint64_t b) {   \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " IS ", 0;\n"             \
                 "wgmma.mma_async.sync.aligned.m64n" #N                      \
                 "k16.f32.bf16.bf16 {" ACC "}, " IA ", " IB                  \
                 ", p, 1, 1, 0, 0;\n}\n"                                     \
                 : OUTS                                                      \
                 : "l"(a), "l"(b), "r"(1));                                  \
  }
// d += a b, A from registers (four 32-bit registers a thread), B from
// shared memory (P V: N = DC)
#define FA_RS(N, ACC, OUTS, A0, A1, A2, A3, IB, IS)                          \
  static __device__ __forceinline__ void rs_tf32(                            \
      float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {               \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " IS ", 0;\n"             \
                 "wgmma.mma_async.sync.aligned.m64n" #N                      \
                 "k8.f32.tf32.tf32 {" ACC "}, {" A0 ", " A1 ", " A2 ", " A3  \
                 "}, " IB ", p, 1, 1;\n}\n"                                  \
                 : OUTS                                                      \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),       \
                   "r"(1));                                                  \
  }                                                                          \
  static __device__ __forceinline__ void rs_bf16(                            \
      float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {               \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " IS ", 0;\n"             \
                 "wgmma.mma_async.sync.aligned.m64n" #N                      \
                 "k16.f32.bf16.bf16 {" ACC "}, {" A0 ", " A1 ", " A2 ", " A3 \
                 "}, " IB ", p, 1, 1, 0;\n}\n"                               \
                 : OUTS                                                      \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),       \
                   "r"(1));                                                  \
  }

template <> struct Mma<16> {
  FA_RS(16, FA_ACC8, FA_OUT8, "%8", "%9", "%10", "%11", "%12", "%13")
};
template <> struct Mma<32> {
  FA_RS(32, FA_ACC16, FA_OUT16, "%16", "%17", "%18", "%19", "%20", "%21")
};
template <> struct Mma<64> {
  FA_SS(64, FA_ACC32, FA_OUT32, "%32", "%33", "%34")
  FA_RS(64, FA_ACC32, FA_OUT32, "%32", "%33", "%34", "%35", "%36", "%37")
};
template <> struct Mma<80> {
  FA_RS(80, FA_ACC40, FA_OUT40, "%40", "%41", "%42", "%43", "%44", "%45")
};
template <> struct Mma<128> {
  FA_RS(128, FA_ACC64, FA_OUT64, "%64", "%65", "%66", "%67", "%68", "%69")
};
template <> struct Mma<256> {
  FA_RS(256, FA_ACC128, FA_OUT128, "%128", "%129", "%130", "%131", "%132",
        "%133")
};

// ------------------------------------------------------- numbers

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x = big + small + O(2^-22 x), both TF32; a finite x that rounds to inf
// keeps its truncation as big
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  if (isinf(__uint_as_float(big)) && !isinf(x))
    big = __float_as_uint(x) & 0xFFFFE000u;
  small = isinf(x) ? 0u : tf32(x - __uint_as_float(big));
}
// the same for a weight p in [0, 1], which cannot overflow
__device__ __forceinline__ void split_p(float x, uint32_t& big,
                                        uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}
__device__ __forceinline__ float ex2(float x) {   // 2^x within 2 ulp
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}
// x = hi + lo + O(2^-17 x), both bf16, packed for a bf16x2 pair
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// the byte offset of a 16-byte chunk in a swizzle atom (rows of sw bytes,
// 1024-byte aligned), as TMA and wgmma place it: the chunk index XOR the
// row within 8 rows
template <int SW>
__device__ __forceinline__ uint32_t swizzled(uint32_t off) {
  return off ^ ((off >> 3) & (uint32_t)((SW - 1) & ~15));
}

// ------------------------------------------------------- the prologue

struct Prologue {
  const void* k;
  const void* v;
  void* ks;       // K's scratch
  void* vts;      // V^T's
  long long k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int B, Sk, Hkv, Skp;
};

// position p of a k-step of V^T holds key perm(p): the order of a TF32 A
// fragment's k index (t, t + 4) against the accumulator's keys (2t, 2t + 1)
__device__ __forceinline__ int vt_key(int pos, bool permute) {
  if (!permute) return pos;
  const int p = pos & 7;
  return (pos & ~7) | (p < 4 ? 2 * p : 2 * (p - 4) + 1);
}

// four consecutive values into the scratch's parts (16- or 8-byte stores)
__device__ __forceinline__ void put4(float* dst, long long part,
                                     const float (&x)[4]) {
  uint32_t big[4], small[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) split(x[i], big[i], small[i]);
  *reinterpret_cast<uint4*>(dst) = make_uint4(big[0], big[1], big[2], big[3]);
  *reinterpret_cast<uint4*>(dst + part) =
      make_uint4(small[0], small[1], small[2], small[3]);
}
__device__ __forceinline__ void put4(__nv_bfloat16* dst, long long,
                                     const __nv_bfloat16 (&x)[4]) {
  uint2 u;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = x[i];
  *reinterpret_cast<uint2*>(dst) = u;
}

// blockIdx.y 0: k, four consecutive elements of a row a thread, read in
// order; 1: v, transposed through shared memory 32 keys x 32 dims at a time,
// four positions of a V^T row a thread
template <typename T, int HD>
__global__ void __launch_bounds__(256) flash_prologue(Prologue p) {
  constexpr int PARTS = sizeof(T) == 4 ? 2 : 1;
  const int S = p.Sk, H = p.Hkv;
  // the main kernel may start (its blocks stage q) while this one runs;
  // it waits for this grid's writes before its first copy of the scratch
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (blockIdx.y == 0) {
    const T* src = (const T*)p.k;
    T* dst = (T*)p.ks;
    const long long part = (long long)S * HD;
    const int quads = p.B * S * H * (HD / 4);
    for (int i = blockIdx.x * 256 + threadIdx.x; i < quads;
         i += gridDim.x * 256) {
      const int d = (i % (HD / 4)) * 4;
      int r = i / (HD / 4);   // (b, s, h) in reading order
      const int h = r % H;
      r /= H;
      const int s = r % S, b = r / S;
      const T* in = src + b * p.k_sb + s * p.k_ss + h * p.k_sh + d;
      T x[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = in[j];
      put4(dst + ((long long)(b * H + h) * PARTS * S + s) * HD + d, part, x);
    }
    return;
  }
  __shared__ T tile[32][33];
  const T* src = (const T*)p.v;
  T* dst = (T*)p.vts;
  const int Skp = p.Skp;
  constexpr int ndt = (HD + 31) / 32;
  const int nkt = (Skp + 31) / 32;
  const int tiles = p.B * H * nkt * ndt;
  const long long part = (long long)HD * Skp;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int wd = threadIdx.x >> 3, wq = (threadIdx.x & 7) * 4;
  for (int i = blockIdx.x; i < tiles; i += gridDim.x) {
    const int dt = i % ndt;
    int r = i / ndt;
    const int kt = r % nkt;
    r /= nkt;
    const int h = r % H, b = r / H;
    const int k0 = kt * 32, d0 = dt * 32;
    const T* vb = src + b * p.v_sb + h * p.v_sh;
    __syncthreads();
#pragma unroll
    for (int m = 0; m < 4; ++m) {   // keys k0 + ty + 8m, dims d0 + tx
      const int key = k0 + ty + 8 * m, d = d0 + tx;
      tile[ty + 8 * m][tx] =
          key < S && d < HD ? vb[key * p.v_ss + d] : T(0.f);
    }
    __syncthreads();
    // dim d0 + wd, positions k0 + wq .. + 3
    const int d = d0 + wd, pos = k0 + wq;
    if (d < HD && pos < Skp) {
      T x[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = tile[vt_key(wq + j, PARTS == 2)][wd];
      put4(dst + ((long long)(b * H + h) * PARTS * HD + d) * Skp + pos, part,
           x);
    }
  }
}

// ------------------------------------------------------- the main kernel

template <typename T, int HD>
__global__ void __launch_bounds__(Geo<T, HD>::kThreads, 1)
    flash_fwd(const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, Params p) {
  using G = Geo<T, HD>;
  constexpr int BQ = G::BQ, BK = G::BK, DC = G::DC, NC = G::NC, NS = G::NS;
  constexpr int SW = G::SW, KD = G::KD;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);
  const uint32_t sQ = base, sRing = base + G::Q_BYTES;
  // barriers: slab s full at s, empty at NS + s
  const uint32_t sBar = sRing + NS * G::SLAB;
  auto full = [&](int s) { return sBar + 8u * s; };
  auto empty = [&](int s) { return sBar + 8u * (NS + s); };

  // blocks run longest causal tile first: within each (head, batch) when
  // a head has many tiles; across all of them, tile by tile, when it has
  // fewer tiles than the card has SMs (a short prompt would otherwise
  // leave long tiles for last)
  const int nqb = (p.Sq + BQ - 1) / BQ;
  int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  if (nqb < 132) {
    const int hb = gridDim.y * gridDim.z;
    const int lin = blockIdx.x + nqb * (blockIdx.y + gridDim.y * blockIdx.z);
    tile = lin / hb;
    h = lin % hb % gridDim.y;
    b = lin % hb / gridDim.y;
  }
  const int q0 = (nqb - 1 - tile) * BQ;
  const int hk = h / (p.Hq / p.Hkv);
  // a window wider than any distance between a query and a key is none
  const int win = (int)min(p.window, (long long)p.Sq + p.Sk + 1);

  // the key tiles the block walks: the union of its queries' visible
  // ranges [lo_i, hi_i]; lo_i and (when causal) hi_i grow with i. A query
  // that sees no key satisfies lo_i > hi_i, which holds for the last query
  // whenever it holds for any; such a block walks every key tile, so that
  // query gets the mean of v
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  const int lo_first = p.has_window ? max(0, q0 - win + 1) : 0;
  const int lo_last = p.has_window ? max(0, q_last - win + 1) : 0;
  const int hi_last = p.causal ? min(q_last, p.Sk - 1) : p.Sk - 1;
  const int nkb = (p.Sk + BK - 1) / BK;
  int kb_begin = 0, kb_end = nkb;
  if (lo_last <= hi_last) {
    kb_begin = lo_first / BK;
    kb_end = hi_last / BK + 1;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * G::C);   // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------- producer: one thread starts every TMA box
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      const int kplane = (b * p.Hkv + hk) * G::PARTS;
      int slab = 0, phase = 0;
      // the prologue's scratch is complete and visible
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      for (int kb = kb_begin; kb < kb_end; ++kb) {
        for (int kv = 0; kv < 2; ++kv) {
          for (int c = 0; c < NC; ++c) {
            mbar_wait(empty(slab), phase ^ 1);
            mbar_expect_tx(full(slab), G::SLAB);
            const uint32_t dst = sRing + slab * G::SLAB;
            for (int part = 0; part < G::PARTS; ++part) {
              if (kv == 0) {   // K: BK keys x DC dims, boxes of W dims
                for (int j = 0; j < DC / G::W; ++j)
                  tma_load(dst + part * G::SLAB_PART + j * BK * SW, &tk,
                           c * DC + j * G::W, kb * BK, kplane + part,
                           full(slab));
              } else {         // V^T: DC dims x BK keys, boxes of WV keys
                for (int j = 0; j < BK / G::WV; ++j)
                  tma_load(dst + part * G::SLAB_PART + j * DC * 128, &tv,
                           kb * BK + j * G::WV, c * DC, kplane + part,
                           full(slab));
              }
            }
            if (++slab == NS) {
              slab = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
    return;
  }

  // ---------------- consumers: warpgroup w owns query rows 64 w .. + 63
  if constexpr (G::C == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int w = wg - 1;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qw = q0 + 64 * w;                 // the warpgroup's first row
  const int row0 = qw + 16 * warp + g;        // this thread's rows: + 0, + 8
  const int qw_last = min(qw + 63, p.Sq - 1);
  // scores in log2 units: s scale log2e, or tanh(s scale / c) c log2e
  const float c_mul = p.has_softcap ? p.scale / p.softcap
                                    : p.scale * kLog2e;
  const float c_cap = p.softcap * kLog2e;

  // the warpgroup's 64 rows of q, split, into Q's swizzled rows (rows past
  // Sq are 0); then the async proxy (wgmma) may read them
  {
    const T* qb = (const T*)p.q + b * p.q_sb + h * p.q_sh;
    for (int i = tid; i < 64 * HD; i += 128) {
      const int r = i / HD, d = i - r * HD;
      const int qi = qw + r;
      const T x = qi < p.Sq ? qb[(long long)qi * p.q_ss + d] : T(0.f);
      const uint32_t off = swizzled<SW>((d * G::E / SW) * (BQ * SW) +
                                        (64 * w + r) * SW + (d * G::E) % SW);
      if constexpr (G::kF32) {
        uint32_t big, small;
        split(x, big, small);
        *reinterpret_cast<uint32_t*>(sm + off) = big;
        *reinterpret_cast<uint32_t*>(sm + G::Q_PART + off) = small;
      } else {
        *reinterpret_cast<T*>(sm + off) = x;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(3 + w, 128);
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[NC][DC / 2];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < DC / 2; ++e) o[c][e] = 0.f;

  // Q's descriptors start at the warpgroup's 64 rows of each part
  const uint32_t qrow = sQ + 64 * w * SW;
  int slab = 0, phase = 0;
  // a warp is done with a slab
  auto release = [&](int done) {
    if (lane == 0) mbar_arrive(empty(done));
  };
  // two warpgroups take turns to start S = Q K^T (named barrier 1 + w is
  // w's turn; the second lets the first begin), so that one's softmax
  // runs while the other's products keep the tensor cores busy
  if constexpr (G::C == 2)
    if (w == 1) named_arrive(1, 256);

  // the second warpgroup of the last tile, past the last query (only a
  // second one can be): it takes its turns and frees each slab once it
  // has arrived, and multiplies nothing (short prompts' longest tiles are
  // such tiles). Not compiled for one warpgroup, whose registers are full
  if constexpr (G::C == 2)
    if (qw >= p.Sq) {
      for (int kb = kb_begin; kb < kb_end; ++kb) {
        named_sync(1 + w, 256);
        for (int c = 0; c < 2 * NC; ++c) {
          mbar_wait(full(slab), phase);
          release(slab);
          if (c + 1 == NC && kb + 1 < kb_end) named_arrive(2 - w, 256);
          if (++slab == NS) {
            slab = 0;
            phase ^= 1;
          }
        }
      }
      return;
    }

  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int k0 = kb * BK;
    // ---- S = Q K^T over NC slabs of DC dims
    float s[BK / 2];
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) s[e] = 0.f;
    int prev = -1;
    if constexpr (G::C == 2) named_sync(1 + w, 256);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      mbar_wait(full(slab), phase);
      const uint32_t ks = sRing + slab * G::SLAB;
      fence_regs(s);
      wg_fence();
#pragma unroll
      for (int i = 0; i < DC / KD; ++i) {
        const int dq = (c * DC + i * KD) * G::E;   // byte within Q's row
        const int dk = i * KD * G::E;              // within the slab's
        const uint32_t qa = qrow + (dq / SW) * (BQ * SW) + dq % SW;
        const uint32_t ka = ks + (dk / SW) * (BK * SW) + dk % SW;
        if constexpr (G::kF32) {
          const uint64_t q_big = make_desc(qa, SW);
          const uint64_t q_small = make_desc(qa + G::Q_PART, SW);
          const uint64_t k_big = make_desc(ka, SW);
          const uint64_t k_small = make_desc(ka + G::SLAB_PART, SW);
          Mma<BK>::ss_tf32(s, q_small, k_big);
          Mma<BK>::ss_tf32(s, q_big, k_small);
          Mma<BK>::ss_tf32(s, q_big, k_big);
        } else {
          Mma<BK>::ss_bf16(s, make_desc(qa, SW), make_desc(ka, SW));
        }
      }
      wg_commit();
      fence_regs(s);
      if (prev >= 0) {
        wg_wait<1>();
        release(prev);
      }
      prev = slab;
      if (++slab == NS) {
        slab = 0;
        phase ^= 1;
      }
    }
    if constexpr (G::C == 2)
      if (w == 0 || kb + 1 < kb_end) named_arrive(2 - w, 256);
    wg_wait<0>();
    fence_regs(s);
    release(prev);

    // ---- online softmax over rows row0 (r = 0) and row0 + 8 (r = 1)
    // a tile every query of the warpgroup sees whole needs no mask
    const bool whole = k0 + BK <= p.Sk && (!p.causal || k0 + BK - 1 <= qw) &&
                       (!p.has_window || qw_last - k0 < win);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = row0 + 8 * r;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[4 * j + 2 * r + e] * c_mul;
          if (p.has_softcap) x = tanhf(x) * c_cap;
          if (!whole) {
            const int kj = k0 + 8 * j + 2 * t + e;
            bool seen = true;
            if (p.causal) seen = seen && kj <= qi;
            if (p.has_window) seen = seen && qi - kj < win;
            x = seen ? x : kMasked2;
            x = kj < p.Sk ? x : -INFINITY;   // no such key: weight 0
          }
          s[4 * j + 2 * r + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      // 2^(x - m): exactly 1 where x = m (also at the masked score); m =
      // -inf: no key of the row exists yet, and 2^(-inf - 0) = 0
      alpha[r] = m_new == -INFINITY ? 1.f : ex2(m[r] - m_new);
      const float m_sub = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pe = ex2(s[4 * j + 2 * r + e] - m_sub);
          s[4 * j + 2 * r + e] = pe;
          sum += pe;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[r] = l[r] * alpha[r] + sum;
      m[r] = m_new;
    }
    // bf16: O is rescaled only where a row's maximum moved (a warp at a
    // time); fp32 rescales it as it adds the tile's P V (below)
    if constexpr (!G::kF32)
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int n = 0; n < DC / 8; ++n) {
            o[c][4 * n] *= alpha[0];
            o[c][4 * n + 1] *= alpha[0];
            o[c][4 * n + 2] *= alpha[1];
            o[c][4 * n + 3] *= alpha[1];
          }
      }

    // ---- P as wgmma's A operand, split in registers
    constexpr int NK = BK / KD;   // k-steps of P V
    uint32_t pa[NK][4], pb[NK][4];   // fp32: small, big; bf16: lo, hi
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      if constexpr (G::kF32) {
        // A's k index t is key 2t, t + 4 is key 2t + 1 (V^T permuted)
        split_p(s[4 * i + 0], pb[i][0], pa[i][0]);   // row g,     key 2t
        split_p(s[4 * i + 2], pb[i][1], pa[i][1]);   // row g + 8, key 2t
        split_p(s[4 * i + 1], pb[i][2], pa[i][2]);   // row g,     key 2t + 1
        split_p(s[4 * i + 3], pb[i][3], pa[i][3]);   // row g + 8, key 2t + 1
      } else {
        // keys 16i + 2t, + 1 (rows g, g + 8), then 16i + 8 + 2t, + 1
        split_bf16(s[8 * i + 0], s[8 * i + 1], pb[i][0], pa[i][0]);
        split_bf16(s[8 * i + 2], s[8 * i + 3], pb[i][1], pa[i][1]);
        split_bf16(s[8 * i + 4], s[8 * i + 5], pb[i][2], pa[i][2]);
        split_bf16(s[8 * i + 6], s[8 * i + 7], pb[i][3], pa[i][3]);
      }
    }

    // ---- O += P V over NC slabs of DC dims. fp32: each slab's products
    // start from zero in `acc` and O = alpha O + acc in registers, rounded
    // to nearest, so that no sum inside the tensor cores runs longer than
    // one tile's 3 BK / 8 steps (O's own chain over a 32k-key row, 12k
    // steps, drifted 1.4e-4 from the plain version on gemma2-2b's inputs)
    if constexpr (G::kF32) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        mbar_wait(full(slab), phase);
        const uint32_t vs = sRing + slab * G::SLAB;
        float acc[DC / 2];
#pragma unroll
        for (int e = 0; e < DC / 2; ++e) acc[e] = 0.f;
        fence_regs(acc);
        fence_regs(pa);
        fence_regs(pb);
        wg_fence();
#pragma unroll
        for (int i = 0; i < NK; ++i) {
          const int dv = i * 32;   // bytes of keys into V^T's rows
          const uint32_t va = vs + (dv / 128) * (DC * 128) + dv % 128;
          const uint64_t v_big = make_desc(va, 128);
          const uint64_t v_small = make_desc(va + G::SLAB_PART, 128);
          Mma<DC>::rs_tf32(acc, pa[i], v_big);
          Mma<DC>::rs_tf32(acc, pb[i], v_small);
          Mma<DC>::rs_tf32(acc, pb[i], v_big);
        }
        wg_commit();
        wg_wait<0>();
        fence_regs(acc);
        release(slab);
#pragma unroll
        for (int n = 0; n < DC / 8; ++n) {
          o[c][4 * n] = fmaf(o[c][4 * n], alpha[0], acc[4 * n]);
          o[c][4 * n + 1] = fmaf(o[c][4 * n + 1], alpha[0], acc[4 * n + 1]);
          o[c][4 * n + 2] = fmaf(o[c][4 * n + 2], alpha[1], acc[4 * n + 2]);
          o[c][4 * n + 3] = fmaf(o[c][4 * n + 3], alpha[1], acc[4 * n + 3]);
        }
        if (++slab == NS) {
          slab = 0;
          phase ^= 1;
        }
      }
      fence_regs(pa);
      fence_regs(pb);
      continue;
    }
    // bf16: the products accumulate in O
    prev = -1;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      mbar_wait(full(slab), phase);
      const uint32_t vs = sRing + slab * G::SLAB;
      fence_regs(o[c]);
      fence_regs(pa);
      fence_regs(pb);
      wg_fence();
#pragma unroll
      for (int i = 0; i < NK; ++i) {
        const int dv = i * 32;   // bytes of keys into V^T's rows
        const uint32_t va = vs + (dv / 128) * (DC * 128) + dv % 128;
        const uint64_t v = make_desc(va, 128);
        Mma<DC>::rs_bf16(o[c], pa[i], v);
        Mma<DC>::rs_bf16(o[c], pb[i], v);
      }
      wg_commit();
      fence_regs(o[c]);
      if (prev >= 0) {
        wg_wait<1>();
        release(prev);
      }
      prev = slab;
      if (++slab == NS) {
        slab = 0;
        phase ^= 1;
      }
    }
    wg_wait<0>();
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(o[c]);
    fence_regs(pa);
    fence_regs(pb);
    release(prev);
  }

  T* out = (T*)p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= p.Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* orow = out + qi * p.o_ss + 2 * t;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int n = 0; n < DC / 8; ++n)
        store2(orow + c * DC + 8 * n, o[c][4 * n + 2 * r] * inv,
               o[c][4 * n + 2 * r + 1] * inv);
  }
}

// ------------------------------------------------------- host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the libcuda that the process has loaded
// (the library is built without linking libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (lib != nullptr)
      fn = (EncodeTiled)dlsym(lib, "cuTensorMapEncodeTiled");
  }
  return fn;
}

// a 3-D map over rows of `inner` elements (pitch inner elements), `rows`
// rows a plane: boxes of {box_inner, box_rows, 1}, swizzled by `sw` bytes;
// out-of-range elements read as zero
int encode(CUtensorMap* map, bool f32, void* ptr, long long inner,
           long long rows, long long planes, int box_inner, int box_rows,
           int sw) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return 1000 + (int)CUDA_ERROR_NOT_FOUND;
  const long long e = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)(inner * e),
                                 (cuuint64_t)(inner * rows * e)};
  const cuuint32_t box[3] = {(cuuint32_t)box_inner, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUtensorMapSwizzle swz = sw == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : sw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(
      map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, ptr, dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;
}

struct Call {
  void* scratch[2];   // K, V^T
  int B, Sq, Sk, Hq, Hkv, Skp;
};

template <typename T, int HD>
int launch(const Call& a, const Params& p, cudaStream_t stream) {
  using G = Geo<T, HD>;
  CUtensorMap tk, tv;
  int err;
  if ((err = encode(&tk, G::kF32, a.scratch[0], HD, a.Sk,
                    (long long)a.B * a.Hkv * G::PARTS, G::W, G::BK, G::SW)))
    return err;
  if ((err = encode(&tv, G::kF32, a.scratch[1], a.Skp, HD,
                    (long long)a.B * a.Hkv * G::PARTS, G::WV, G::DC, 128)))
    return err;
  // the shared-memory attribute once per device
  static unsigned long long set_on = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (!(set_on >> dev & 1)) {
    e = cudaFuncSetAttribute(flash_fwd<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             G::SMEM);
    if (e != cudaSuccess) return (int)e;
    set_on |= 1ULL << dev;
  }
  // launched as the prologue's programmatic dependent (griddepcontrol)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.Sq + G::BQ - 1) / G::BQ, a.Hq, a.B);
  cfg.blockDim = dim3(G::kThreads);
  cfg.dynamicSmemBytes = G::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, flash_fwd<T, HD>, tk, tv, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Call& a, const Params& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(a, p, stream);
    case 32: return launch<T, 32>(a, p, stream);
    case 64: return launch<T, 64>(a, p, stream);
    case 80: return launch<T, 80>(a, p, stream);
    case 128: return launch<T, 128>(a, p, stream);
    case 256: return launch<T, 256>(a, p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int prologue(const Prologue& pr, int hd, dim3 grid, cudaStream_t stream) {
  switch (hd) {
    case 16: flash_prologue<T, 16><<<grid, 256, 0, stream>>>(pr); break;
    case 32: flash_prologue<T, 32><<<grid, 256, 0, stream>>>(pr); break;
    case 64: flash_prologue<T, 64><<<grid, 256, 0, stream>>>(pr); break;
    case 80: flash_prologue<T, 80><<<grid, 256, 0, stream>>>(pr); break;
    case 128: flash_prologue<T, 128><<<grid, 256, 0, stream>>>(pr); break;
    case 256: flash_prologue<T, 256><<<grid, 256, 0, stream>>>(pr); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T, int HD>
void plan_of(int* out) {
  using G = Geo<T, HD>;
  const int v[] = {G::C, G::BK, G::DC, G::NS, G::SW, G::SMEM};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
}

}  // namespace

// The tile plan of (hd, dtype) as the kernel holds it: C, BK, DC, NS, the
// swizzle of Q's and K's rows in bytes, the dynamic shared memory of a
// block. Returns 0, or cudaErrorInvalidValue for a head dimension not built.
extern "C" int flash_attention_plan(int hd, int dtype, int* out) {
  const bool bf = dtype == 1;
  switch (hd) {
#define FLASH_PLAN_OF(HD_)                                                \
  case HD_:                                                               \
    bf ? plan_of<__nv_bfloat16, HD_>(out) : plan_of<float, HD_>(out);     \
    return 0;
    FLASH_PLAN_OF(16)
    FLASH_PLAN_OF(32)
    FLASH_PLAN_OF(64)
    FLASH_PLAN_OF(80)
    FLASH_PLAN_OF(128)
    FLASH_PLAN_OF(256)
#undef FLASH_PLAN_OF
    default: return (int)cudaErrorInvalidValue;
  }
}

// ptrs: q, k, v, o and the scratch, one 16-byte aligned buffer holding K
// [B][Hkv][parts][Sk][hd] at 0 and V^T [B][Hkv][parts][hd][Skp] at byte
// off_vt (Skp = Sk rounded up to 8; parts 2 for fp32, 1 for bf16), as
// ops.scratch_layout lays them out. args: B, Sq, Sk, Hq, Hkv, hd; the
// (batch, seq, head) strides of q, k, v and o in elements (the head
// dimension contiguous, o contiguous); causal, has_window, window,
// has_softcap, dtype (0 float32, 1 bfloat16), off_vt.
extern "C" int flash_attention_fwd(void* const* ptrs, const long long* args,
                                   float softcap, float scale,
                                   void* stream) {
  const void *q = ptrs[0], *k = ptrs[1], *v = ptrs[2];
  void* o = ptrs[3];
  char* scratch = (char*)ptrs[4];
  const int B = (int)args[0], Sq = (int)args[1], Sk = (int)args[2];
  const int Hq = (int)args[3], Hkv = (int)args[4], hd = (int)args[5];
  const long long *qst = args + 6, *kst = args + 9, *vst = args + 12,
                  *ost = args + 15;
  const int causal = (int)args[18], has_window = (int)args[19];
  const long long window = args[20];
  const int has_softcap = (int)args[21], dtype = (int)args[22];
  if (B <= 0 || Sq <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (Sk <= 0) {   // no key: the output is 0, as the oracle's empty sum
    cudaMemsetAsync(o, 0, (size_t)B * Sq * Hq * hd * (dtype == 1 ? 2 : 4),
                    st);
    return (int)cudaGetLastError();
  }
  const int Skp = (Sk + 7) / 8 * 8;
  void* ks = scratch;
  void* vts = scratch + args[23];
  const Prologue pr{k,      v,      ks,     vts,    kst[0], kst[1], kst[2],
                    vst[0], vst[1], vst[2], B,      Sk,     Hkv,    Skp};
  const int quads = B * Sk * Hkv * (hd / 4);
  const int tiles = B * Hkv * ((Skp + 31) / 32) * ((hd + 31) / 32);
  const dim3 grid(min(max((quads + 255) / 256, tiles), 132 * 16), 2);
  int err = dtype == 1 ? prologue<__nv_bfloat16>(pr, hd, grid, st)
                       : prologue<float>(pr, hd, grid, st);
  if (err) return err;
  const Params p{q,      o,      qst[0], qst[1], qst[2], ost[0],
                 ost[1], ost[2], Sq,     Sk,     Hq,     Hkv,
                 causal, has_window, window, has_softcap, softcap, scale};
  const Call a{{ks, vts}, B, Sq, Sk, Hq, Hkv, Skp};
  return dtype == 1 ? dispatch<__nv_bfloat16>(a, p, hd, st)
                    : dispatch<float>(a, p, hd, st);
}
