// The flash-attention fold designed for Hopper (sm_90a): wgmma, TMA loads
// completing on mbarriers, a producer warp and two consumer warpgroups.
// Shared by flash_attention.cu (B1) and flash_attention_step.cu (B2).
//
// Replaces: netsdb_tpu/ops/pallas_kernels.py::_fold_block (:45), the fold
// that the reference's two Pallas kernels, _flash_kernel (:114, B1) and
// _flash_carry_kernel (:248, B2), share "so their numerics cannot
// diverge". Here too one templated kernel serves both: kCarry = false
// starts the carry at (0, 0, NEG_INF) and writes acc / max(l, 1e-30);
// kCarry = true reads the f32 carry (acc, l, m) and writes it back.
//
// Numerics (the reference's): q is pre-scaled by scale * log2(e) and
// rounded to the input type; the online softmax carries (m, l, acc) in
// f32 in the exp2 domain; bf16 rounds P to bf16 before P.V; in causal
// mode only key tiles that cross the diagonal, or the ragged last tile,
// are masked, and there a masked logit gives p = 0 exactly, so a row
// with no live key keeps its carry bit for bit.
//
// What bounds it. At B1's path shape (causal, B 2, H 8, S 4096, D 128)
// the products are 4 B H S(S+1)/2 D = 68.7 GFLOP: 0.0695 ms in bf16 at
// 989 TFLOP/s, 0.417 ms in f32 as three-pass TF32 at 495 TFLOP/s (3x the
// products), against 0.04 ms for q, k, v and o in f32 at 3.35 TB/s:
// compute-bound in both types. B2's chain (bh 16, four 4096-key chunks,
// q last) is 7.0x B1's products. Only wgmma reaches the tensor cores'
// full rate, and only if its operands arrive without the issuing warps
// spending instructions on them, so the design is:
//
// - One block of three warpgroups per (b*h, 128-row query tile),
//   heaviest causal tiles first across all (b*h). Warp 0 of warpgroup 0
//   is the producer: it loads Q once and streams K and V tiles through a
//   ring of stages with TMA (cp.async.bulk.tensor), each stage with a
//   "full" and an "empty" mbarrier for K and for V, so the next K lands
//   while P.V runs and the next V while S is computed. The producer
//   warpgroup gives registers back (setmaxnreg 40) and the two consumer
//   warpgroups take them (232); each consumer owns 64 query rows.
// - S = Q K^T and O += P V run on wgmma. S and O stay in wgmma's
//   accumulator fragments: a thread holds rows g and g+8 of its warp's
//   16, so a row's max and sum need only shuffles among four lanes. P
//   goes from S's registers straight into P.V's A operand.
// - Tiles are TMA boxes of 128-byte rows, 128-byte swizzled, which is
//   the layout wgmma's descriptors read without bank conflicts. A head
//   dim up to 64 runs as 64 columns, up to 128 as 128; rows and columns
//   past the tensor come back as zeros from TMA's own fill.
// - bf16: 96 keys a tile, two stages; Q 32 KB + 2 x (K 24 KB + V
//   24 KB) = 128 KB of shared memory at D 128. S is an SS wgmma (K as
//   stored is the K-major B operand); P is rounded to bf16 in registers
//   and P.V is an RS wgmma that reads V as stored, MN-major, through
//   the transpose bit. A thread then holds S (48 floats), O (64) and P
//   (24 words): with 128 keys (64 + 64 + 32) ptxas ran out of registers
//   and serialised the wgmmas, each waited for before the next, and 64
//   keys left the softmax's fixed costs less amortised (PERF.md).
// - f32: three-pass TF32, x = hi + lo with hi = x rounded to tf32 and lo
//   = x - hi (read as tf32), a.b ~ lo.hi + hi.lo + hi.hi. The dropped
//   terms are about 2^-22 of the product, so the fold keeps f32's
//   accuracy where one pass (2^-11) would not: the reference asks for
//   Precision.HIGHEST. tf32 wgmma takes only K-major operands, so a
//   memory-bound pre-pass (split_kv_kernel) writes K's hi and lo and
//   V^T's hi and lo into scratch that the wrapper allocates, once a
//   launch; V^T's keys are permuted within each group of eight so that
//   S's accumulator layout is P.V's A layout as it stands (a lane holds
//   keys 2t, 2t+1 of each 8 in S and wants t, t+4 in A). Q's split is
//   done in shared memory by the consumers. 32 keys a tile, one stage
//   of K and one of V: Q (hi, lo) 128 KB + K 32 KB + V^T 32 KB = 192 KB
//   at D 128, so the inner loop does no integer work. P.V runs in
//   products of 64 columns, so O's partial sums fit beside O.
// - The tensor core rounds its f32 sums toward zero, so a long chain of
//   products into one accumulator drifts (the earlier mma.sync fold read
//   6x the plain version's error against f64 with all keys in one chain,
//   PERF.md). A chain here runs kTf32Chain 8-deep steps (three passes
//   each) from zero and is then added in f32, rounding to nearest; each
//   tile's P.V is its own chain, added as acc = acc * corr + P.V as the
//   reference writes it. Measured at B1's and B2's path shapes
//   (kernel_ab.py --tf32-chain), the error against f64 grows with the
//   chain (16 steps passes the plain version's by more than 4x in B2's
//   chain) while the time between depths moves by no more than between
//   two sweeps, so chains are 2 steps.
// - bf16 keeps the tensor cores fed while a consumer runs its softmax:
//   the next tile's S is issued with this tile's P.V, and its softmax
//   runs while P.V is in flight; the two consumers issue their products
//   in turns (ping-pong on two named barriers), so one's softmax runs
//   beside the other's products; and the softmax runs on the
//   special-function unit's ex2 alone, without exp2f's range handling,
//   and skips rescaling acc when no row's max moved. f32's products are
//   three times as long as its softmax and run in plain order.
// - The role branch and the consumer's index come from a shuffle, so the
//   compiler sees them uniform in each warp: a wgmma on a path it thinks
//   divergent, or with descriptors it cannot keep in uniform registers,
//   is serialised.

// Left to later work: a persistent grid (one block an SM walking over
// tiles, so one tile's epilogue overlaps the next one's loads), the f32
// split done by the producer side instead of a pre-pass, and for B2 a
// kernel that keeps the carry in registers across chunks.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace netsdb_fold {

constexpr int kConsumers = 2;                // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kBlockQ = 64 * kConsumers;     // query rows per block
constexpr int kMaxD = 128;                   // largest head dimension
constexpr float kNegInf = -1e30f;            // the reference's NEG_INF
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// 8-deep tf32 steps in one accumulator chain before it is added in f32
constexpr int kTf32Chain = 2;

// Per input type: keys per tile, stages of the K/V ring, elements in a
// 128-byte row (one swizzle span: the width of a TMA box), and the parts
// each K and V tile has (hi and lo for f32).
template <typename T>
struct Cfg;
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int kBlockK = 96, kStages = 2, kW = 64, kParts = 1;
};
template <>
struct Cfg<float> {
  static constexpr int kBlockK = 32, kStages = 1, kW = 32, kParts = 2;
};

// Shared memory in bytes, every tile on a 1024-byte boundary (the span
// of the 128-byte swizzle). A tile of R rows is DP / kW column blocks of
// R rows x 128 bytes.
template <typename T, int DP>
struct Smem {
  using C = Cfg<T>;
  static constexpr int kQ = kBlockQ * DP * static_cast<int>(sizeof(T));
  static constexpr int kK = C::kBlockK * DP * static_cast<int>(sizeof(T));
  static constexpr int kV = kK;
  static constexpr int q = 0;                            // Q: hi, then lo
  static constexpr int k = q + C::kParts * kQ;           // [stage][part]
  static constexpr int v = k + C::kStages * C::kParts * kK;
  static constexpr int bars = v + C::kStages * C::kParts * kV;
  static constexpr int bytes = bars + 8 * (1 + 4 * C::kStages) + 1024;
};

// One launch's operands. B1 sets s_q = s_k, zero offsets, o; B2 sets the
// carry (acc (bh, s_q, d), l and m (bh, s_q)). The tensor maps are 4-d:
// (columns, rows, b*h, part); Q's and bf16's K and V have one part.
struct FoldParams {
  CUtensorMap tq, tk, tv;
  void* o;
  float* acc;
  float* l;
  float* m;
  int bh, s_q, s_k, d;
  float qscale;
  int q_off, k_off, causal;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and TMA

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
// wait until the barrier's phase with this parity has completed; a wait
// of seconds can only be a fault, and traps rather than hang the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1LL << 34)) __trap();
  }
}

// one box of a 4-d tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma

// a shared-memory matrix descriptor for a 128-byte-swizzled operand:
// `lbo` and `sbo` in bytes (K-major: sbo = 1024 between 8-row groups;
// MN-major: lbo between 64-element atoms along MN, sbo = 1024 between
// 8-row groups along K)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are still running
template <int N = 0>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of an accumulator
// across the asynchronous products that own it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define NETSDB_R0 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define NETSDB_R16 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define NETSDB_R32 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
#define NETSDB_R48 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define NETSDB_ACC16 "{" NETSDB_R0 "}"
#define NETSDB_ACC32 "{" NETSDB_R0 ", " NETSDB_R16 "}"
#define NETSDB_ACC48 "{" NETSDB_R0 ", " NETSDB_R16 ", " NETSDB_R32 "}"
#define NETSDB_ACC64 "{" NETSDB_R0 ", " NETSDB_R16 ", " NETSDB_R32 ", " NETSDB_R48 "}"
#define NETSDB_D8(p)                                                   \
  "+f"((p)[0]), "+f"((p)[1]), "+f"((p)[2]), "+f"((p)[3]), "+f"((p)[4]), \
      "+f"((p)[5]), "+f"((p)[6]), "+f"((p)[7])
#define NETSDB_D16(p) NETSDB_D8(p), NETSDB_D8((p) + 8)
#define NETSDB_D32(p) NETSDB_D16(p), NETSDB_D16((p) + 16)
#define NETSDB_D48(p) NETSDB_D32(p), NETSDB_D16((p) + 32)
#define NETSDB_D64(p) NETSDB_D32(p), NETSDB_D32((p) + 32)

// d (64 x 96) (+)= a (64 x 16, shared) . b (16 x 96, shared, K-major)
__device__ __forceinline__ void wgmma_ss_bf16(float (&d)[48], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 " NETSDB_ACC48
      ", %48, %49, p, 1, 1, 0, 0;\n}\n"
      : NETSDB_D48(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x N) (+)= a (64 x 16, registers) . b (16 x N, shared, MN-major)
template <int NF>
__device__ __forceinline__ void wgmma_rs_bf16(float (&d)[NF],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  if constexpr (NF == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " NETSDB_ACC64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : NETSDB_D64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  } else {
    static_assert(NF == 32, "P.V runs 64 or 128 columns");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " NETSDB_ACC32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : NETSDB_D32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
}

// d (64 x 32) (+)= a (64 x 8, shared) . b (8 x 32, shared), tf32
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[16], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " NETSDB_ACC16
      ", %16, %17, p, 1, 1;\n}\n"
      : NETSDB_D16(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64) (+)= a (64 x 8, registers) . b (8 x 64, shared), tf32
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " NETSDB_ACC32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : NETSDB_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// ---- numbers

// x = hi + lo: hi is x rounded to tf32 (to nearest, ties away from zero,
// as cvt.rna does, on the integer units), lo = x - hi, which the tensor
// core reads to tf32 by dropping its low 13 bits (an error of 2^-22 of x
// at most).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// 2^x on the special-function unit alone, as exp2f computes it for
// results of 2^-126 and up; exp2f adds a range check and two multiplies
// for results below, which this flushes to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats as bf16x2, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store_out(float* o, float x) { *o = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* o, float x) {
  *o = __float2bfloat16(x);
}

// The f32 pre-pass: K's and V^T's tf32 hi and lo, zero past d and s_k.
// k and v are (bh, s_k, ld); khi and klo (bh, s_k, dp); vhi and vlo
// (bh, dp, s_kp), keys permuted within each group of 8: position L < 4
// holds key 2L, position L >= 4 key 2(L - 4) + 1. One block per (32
// keys, b*h).
__global__ void __launch_bounds__(256)
split_kv_kernel(const float* __restrict__ k, const float* __restrict__ v,
                float* khi, float* klo, float* vhi, float* vlo, int s_k,
                int d, int ld, int dp, int s_kp) {
  __shared__ float tile[32][kMaxD + 1];
  const int bh = blockIdx.y, key0 = blockIdx.x * 32;
  const size_t src = static_cast<size_t>(bh) * s_k * ld;
  for (int i = threadIdx.x; i < 32 * dp; i += blockDim.x) {
    const int r = i / dp, c = i % dp, key = key0 + r;
    const bool in = key < s_k && c < d;
    const size_t at = src + static_cast<size_t>(key) * ld + c;
    tile[r][c] = in ? v[at] : 0.f;
    if (key < s_k) {
      uint32_t hi, lo;
      split_tf32(in ? k[at] : 0.f, hi, lo);
      const size_t o = (static_cast<size_t>(bh) * s_k + key) * dp + c;
      khi[o] = __uint_as_float(hi);
      klo[o] = __uint_as_float(lo);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < dp * 32; i += blockDim.x) {
    const int c = i / 32, j = i % 32;
    if (key0 + j >= s_kp) continue;
    const int pos = j & 7;
    const int r = (j & ~7) + (pos < 4 ? 2 * pos : 2 * (pos - 4) + 1);
    uint32_t hi, lo;
    split_tf32(tile[r][c], hi, lo);
    const size_t o = (static_cast<size_t>(bh) * dp + c) * s_kp + key0 + j;
    vhi[o] = __uint_as_float(hi);
    vlo[o] = __uint_as_float(lo);
  }
}

// ---- the fold

// The online softmax update of one tile for a thread's two rows (h = 0,
// 1: the accumulator entries j with bit 1 of j equal to h): S in s
// becomes P, (m, l) move on, and corr is the factor that scales acc. l
// is a lane's partial sum over its keys. kMasked: the tile holds masked
// logits (NEG_INF), which give p = 0 exactly.
template <bool kMasked, int SF>
__device__ __forceinline__ void online_softmax(float (&s)[SF],
                                               float (&m_r)[2],
                                               float (&l_r)[2],
                                               float (&corr)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < SF; ++j)
      if (((j >> 1) & 1) == h) mx = fmaxf(mx, s[j]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_r[h], mx);
    corr[h] = ex2(m_r[h] - m_new);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < SF; ++j) {
      if (((j >> 1) & 1) != h) continue;
      // exp2(NEG_INF - m_new) is 0 once m_new is real; a row whose carry
      // is still empty needs the explicit 0
      const float x = s[j];
      const float pv = kMasked && x <= kNegInf ? 0.f : ex2(x - m_new);
      rs += pv;
      s[j] = pv;
    }
    l_r[h] = l_r[h] * corr[h] + rs;
    m_r[h] = m_new;
  }
}

// One (b*h, 128-row query tile) block: fold every live key tile of the
// chunk into the carry. DP is the head dim padded to 64 or 128.
template <typename T, int DP, bool kCarry>
__global__ void __launch_bounds__(kThreads, 1)
fold_kernel(const __grid_constant__ FoldParams p) {
  using C = Cfg<T>;
  using L = Smem<T, DP>;
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int BK = C::kBlockK, NS = C::kStages, W = C::kW;
  constexpr int SF = BK / 2;  // S's accumulator floats a thread
  constexpr int OF = DP / 2;  // O's
  // f32: O's columns one P.V product covers; a thread's partial sums for
  // all 128 would push it to spilling
  constexpr int PN = 64;

  // heaviest query tiles first, across all (b*h)
  const int n_qt = (p.s_q + kBlockQ - 1) / kBlockQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / p.bh;
  const int bh = static_cast<int>(blockIdx.x) % p.bh;
  const int q0 = qt * kBlockQ;

  // causal: key tiles wholly past this tile's last query are skipped
  int n_kt = (p.s_k + BK - 1) / BK;
  if (p.causal) {
    const int q_last = p.q_off + min(q0 + kBlockQ, p.s_q) - 1;
    n_kt = q_last < p.k_off ? 0 : min(n_kt, (q_last - p.k_off) / BK + 1);
  }
  // a chunk wholly in the future: the carry stays exactly as it is
  if (kCarry && n_kt == 0) return;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* const sbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bar_q = base + L::bars;
  auto full_k = [&](int s) { return bar_q + 8 * (1 + s); };
  auto full_v = [&](int s) { return bar_q + 8 * (1 + NS + s); };
  auto empty_k = [&](int s) { return bar_q + 8 * (1 + 2 * NS + s); };
  auto empty_v = [&](int s) { return bar_q + 8 * (1 + 3 * NS + s); };
  auto k_tile = [&](int s, int part) {
    return base + L::k + (s * C::kParts + part) * L::kK;
  };
  auto v_tile = [&](int s, int part) {
    return base + L::v + (s * C::kParts + part) * L::kV;
  };

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 4 * kConsumers);  // lane 0 of each warp
      mbar_init(empty_v(s), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the role by warpgroup, uniform in each warp (the header's note)
  if (__shfl_sync(0xffffffffu, threadIdx.x >> 7, 0) == 0) {
    // ---- producer warpgroup: warp 0 streams the tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, L::kQ);
      for (int cb = 0; cb < DP / W; ++cb)
        tma_load(base + L::q + cb * kBlockQ * 128, &p.tq, bar_q, cb * W, q0,
                 bh, 0);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % NS, phase = (kt / NS) & 1;
        mbar_wait(empty_k(s), phase ^ 1);
        mbar_expect_tx(full_k(s), C::kParts * L::kK);
        for (int part = 0; part < C::kParts; ++part)
          for (int cb = 0; cb < DP / W; ++cb)
            tma_load(k_tile(s, part) + cb * BK * 128, &p.tk, full_k(s),
                     cb * W, kt * BK, bh, part);
        mbar_wait(empty_v(s), phase ^ 1);
        mbar_expect_tx(full_v(s), C::kParts * L::kV);
        for (int part = 0; part < C::kParts; ++part) {
          if constexpr (kBf16) {
            // V as stored: rows of keys, DP / W column blocks
            for (int cb = 0; cb < DP / W; ++cb)
              tma_load(v_tile(s, part) + cb * BK * 128, &p.tv, full_v(s),
                       cb * W, kt * BK, bh, part);
          } else {
            // V^T: DP rows of this tile's 32 keys
            tma_load(v_tile(s, part), &p.tv, full_v(s), kt * BK, 0, bh, part);
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int ct = threadIdx.x - 128;
    const int wg = __shfl_sync(0xffffffffu, ct >> 7, 0);  // its 64 rows
    const int warp = (ct >> 5) & 3, lane = ct & 31;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = wg * 64 + warp * 16 + g;    // and row0 + 8, in the tile

    // Q, pre-scaled by scale*log2(e) and rounded to T (f32: split into
    // hi, in place, and lo) in this consumer's rows of each column block
    mbar_wait(bar_q, 0);
    {
      constexpr int kVecs = (DP / W) * 64 * 128 / 16;  // 16-byte vectors
      for (int i = ct & 127; i < kVecs; i += 128) {
        const int cb = i / 512, at = i % 512;
        uint4* vec = reinterpret_cast<uint4*>(
            sbase + L::q + cb * kBlockQ * 128 + wg * 64 * 128) + at;
        uint4 x = *vec;
        if constexpr (kBf16) {
          __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 f = __bfloat1622float2(h[j]);
            h[j] = __floats2bfloat162_rn(f.x * p.qscale, f.y * p.qscale);
          }
          *vec = x;
        } else {
          uint4 lo;
          uint32_t* xs = reinterpret_cast<uint32_t*>(&x);
          uint32_t* ls = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            split_tf32(__uint_as_float(xs[j]) * p.qscale, xs[j], ls[j]);
          *vec = x;
          *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(vec) +
                                    L::kQ) = lo;
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    }

    // the carry of rows row0 and row0 + 8; l is kept per lane (a partial
    // sum over its keys) and summed over the four lanes at the end
    float o[OF], m_r[2], l_r[2];
    const size_t rows = static_cast<size_t>(bh) * p.s_q;  // first carry row
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + row0 + 8 * h;
      const bool live = kCarry && row < p.s_q;
      m_r[h] = live ? p.m[rows + row] : kNegInf;
      l_r[h] = live && t == 0 ? p.l[rows + row] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < OF; ++j) {
      const int row = q0 + row0 + 8 * ((j >> 1) & 1);
      const int col = 8 * (j >> 2) + 2 * t + (j & 1);
      o[j] = kCarry && row < p.s_q && col < p.d
                 ? p.acc[(rows + row) * p.d + col]
                 : 0.f;
    }

    // descriptors: Q's rows of this consumer; K-major tiles step 32
    // bytes (16 bf16 or 8 tf32 values) a k-step within a 128-byte row
    const uint32_t q_at = base + L::q + wg * 64 * 128;
    auto q_desc = [&](int part, int ks) {
      return sw128_desc(q_at + part * L::kQ + (ks / 4) * kBlockQ * 128 +
                            (ks % 4) * 32,
                        16, 1024);
    };
    auto k_desc = [&](int s, int part, int ks) {
      return sw128_desc(k_tile(s, part) + (ks / 4) * BK * 128 + (ks % 4) * 32,
                        16, 1024);
    };

    float s_acc[SF];
#pragma unroll
    for (int j = 0; j < SF; ++j) s_acc[j] = 0.f;
    auto release = [&](uint32_t empty) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty);
    };

    // Tile kt's S in s_acc becomes P: the mask, then the online softmax.
    // Only tiles that cross the diagonal (causal) and the ragged last tile
    // mask.
    float corr[2];
    auto softmax = [&](int kt) {
      const int k0 = kt * BK;
      const bool masked =
          (p.causal && p.k_off + k0 + BK - 1 > p.q_off + q0) ||
          k0 + BK > p.s_k;
      if (masked) {
#pragma unroll
        for (int j = 0; j < SF; ++j) {
          const int kc = k0 + 8 * (j >> 2) + 2 * t + (j & 1);
          const int qp = p.q_off + q0 + row0 + 8 * ((j >> 1) & 1);
          if (kc >= p.s_k || (p.causal && p.k_off + kc > qp))
            s_acc[j] = kNegInf;
        }
        online_softmax<true>(s_acc, m_r, l_r, corr);
      } else {
        online_softmax<false>(s_acc, m_r, l_r, corr);
      }
    };

    if constexpr (kBf16) {
      // The next tile's S is issued with this tile's P.V, and its softmax
      // runs while P.V is in flight; acc is scaled by a tile's corr just
      // before the tile's P.V is issued, and P is rounded into one set of
      // A registers once the last P.V has landed. The
      // two consumers issue their products in turns (ping-pong): each
      // waits on its own named barrier (3, 4) and then frees the other's,
      // so one's softmax runs beside the other's products.
      auto turn_wait = [&] {
        asm volatile("bar.sync %0, 256;\n" ::"r"(3 + wg) : "memory");
      };
      auto turn_pass = [&] {
        asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - wg) : "memory");
      };
      auto issue_s = [&](int kt) {
#pragma unroll
        for (int ks = 0; ks < DP / 16; ++ks)
          wgmma_ss_bf16(s_acc, q_desc(0, ks), k_desc(kt % NS, 0, ks), ks > 0);
        wgmma_commit();
      };
      auto issue_pv = [&](int kt, const uint32_t (&a)[BK / 16][4]) {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs_bf16(o, a[kk],
                        sw128_desc(v_tile(kt % NS, 0) + kk * 16 * 128,
                                   BK * 128, 1024),
                        1);
        wgmma_commit();
      };
      // P rounded to bf16 in P.V's A layout
      auto to_a = [&](uint32_t (&a)[BK / 16][4]) {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          a[kk][0] = pack_bf16(s_acc[8 * kk], s_acc[8 * kk + 1]);
          a[kk][1] = pack_bf16(s_acc[8 * kk + 2], s_acc[8 * kk + 3]);
          a[kk][2] = pack_bf16(s_acc[8 * kk + 4], s_acc[8 * kk + 5]);
          a[kk][3] = pack_bf16(s_acc[8 * kk + 6], s_acc[8 * kk + 7]);
        }
      };
      // a warp whose rows all kept their max has nothing to scale
      auto scale_o = [&] {
        if (!__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f))
          return;
#pragma unroll
        for (int j = 0; j < OF; ++j) o[j] *= corr[(j >> 1) & 1];
      };

      if (wg == 1) turn_pass();  // consumer 0 goes first
      uint32_t a[BK / 16][4];
      mbar_wait(full_k(0), 0);
      turn_wait();
      fence_regs(s_acc);
      wgmma_fence();
      issue_s(0);
      turn_pass();
      wgmma_wait();
      fence_regs(s_acc);
      release(empty_k(0));
      softmax(0);
      to_a(a);
      for (int kt = 1; kt < n_kt; ++kt) {
        mbar_wait(full_k(kt % NS), (kt / NS) & 1);
        mbar_wait(full_v((kt - 1) % NS), ((kt - 1) / NS) & 1);
        turn_wait();
        fence_regs(s_acc);
        wgmma_fence();
        issue_s(kt);
        scale_o();  // by the last tile's corr, before its P.V
        fence_regs(o);
        wgmma_fence();
        issue_pv(kt - 1, a);
        turn_pass();
        wgmma_wait<1>();  // S has landed; P.V may still run
        fence_regs(s_acc);
        release(empty_k(kt % NS));
        softmax(kt);
        wgmma_wait();
        fence_regs(o);
        release(empty_v((kt - 1) % NS));
        to_a(a);
      }
      const int last = n_kt - 1;
      mbar_wait(full_v(last % NS), (last / NS) & 1);
      turn_wait();
      scale_o();
      fence_regs(o);
      wgmma_fence();
      issue_pv(last, a);
      if (wg == 0) turn_pass();  // consumer 1's last turn; 0 has none left
      wgmma_wait();
      fence_regs(o);
      release(empty_v(last % NS));
    } else {
      // partial sums of S's chains and of O's columns in one P.V product
      float s_part[SF], o_part[PN / 2];
#pragma unroll
      for (int j = 0; j < SF; ++j) s_part[j] = 0.f;
#pragma unroll
      for (int j = 0; j < PN / 2; ++j) o_part[j] = 0.f;
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % NS, phase = (kt / NS) & 1;

        // S = Q K^T for this consumer's 64 rows, in the exp2 domain: three
        // passes per 8-deep step, the small terms first; chains of
        // kTf32Chain steps from zero, the first into S, the rest added in
        // f32
        mbar_wait(full_k(s), phase);
        constexpr int KS = DP / 8;
        constexpr int CH = kTf32Chain < KS ? kTf32Chain : KS;
        auto chain = [&](float(&dst)[SF], int c0) {
          fence_regs(dst);
          wgmma_fence();
#pragma unroll
          for (int ks = c0; ks < c0 + CH; ++ks) {
            wgmma_ss_tf32(dst, q_desc(1, ks), k_desc(s, 0, ks), ks > c0);
            wgmma_ss_tf32(dst, q_desc(0, ks), k_desc(s, 1, ks), 1);
            wgmma_ss_tf32(dst, q_desc(0, ks), k_desc(s, 0, ks), 1);
          }
          wgmma_commit();
          wgmma_wait();
          fence_regs(dst);
        };
        chain(s_acc, 0);
#pragma unroll
        for (int c0 = CH; c0 < KS; c0 += CH) {
          chain(s_part, c0);
#pragma unroll
          for (int j = 0; j < SF; ++j) s_acc[j] += s_part[j];
        }
        release(empty_k(s));
        softmax(kt);

        // acc = acc * corr + P V. P's hi/lo in the A layout: keys t, t+4
        // of each 8 are S's 2t, 2t+1, as V^T's keys were permuted
        uint32_t p_hi[BK / 8][4], p_lo[BK / 8][4];
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk) {
          split_tf32(s_acc[4 * kk], p_hi[kk][0], p_lo[kk][0]);
          split_tf32(s_acc[4 * kk + 2], p_hi[kk][1], p_lo[kk][1]);
          split_tf32(s_acc[4 * kk + 1], p_hi[kk][2], p_lo[kk][2]);
          split_tf32(s_acc[4 * kk + 3], p_hi[kk][3], p_lo[kk][3]);
        }
        mbar_wait(full_v(s), phase);
        constexpr int KV = BK / 8;
        constexpr int CV = kTf32Chain < KV ? kTf32Chain : KV;
#pragma unroll
        for (int c = 0; c < DP; c += PN) {  // V^T's rows c.. c + PN
#pragma unroll
          for (int c0 = 0; c0 < KV; c0 += CV) {
            fence_regs(o_part);
            wgmma_fence();
#pragma unroll
            for (int kk = c0; kk < c0 + CV; ++kk) {
              const uint32_t vh = v_tile(s, 0) + c * 128 + kk * 32;
              const uint32_t vl = v_tile(s, 1) + c * 128 + kk * 32;
              wgmma_rs_tf32(o_part, p_lo[kk], sw128_desc(vh, 16, 1024),
                            kk > c0);
              wgmma_rs_tf32(o_part, p_hi[kk], sw128_desc(vl, 16, 1024), 1);
              wgmma_rs_tf32(o_part, p_hi[kk], sw128_desc(vh, 16, 1024), 1);
            }
            wgmma_commit();
            wgmma_wait();
            fence_regs(o_part);
#pragma unroll
            for (int j = 0; j < PN / 2; ++j) {
              float& x = o[c / 2 + j];
              x = c0 == 0 ? fmaf(x, corr[(j >> 1) & 1], o_part[j])
                          : x + o_part[j];
            }
          }
        }
        release(empty_v(s));
      }
    }

    float l_sum[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_sum[h] = l_r[h];
      l_sum[h] += __shfl_xor_sync(0xffffffffu, l_sum[h], 1);
      l_sum[h] += __shfl_xor_sync(0xffffffffu, l_sum[h], 2);
      const int row = q0 + row0 + 8 * h;
      if (kCarry && t == 0 && row < p.s_q) {
        p.m[rows + row] = m_r[h];
        p.l[rows + row] = l_sum[h];
      }
    }
#pragma unroll
    for (int j = 0; j < OF; ++j) {
      const int h = (j >> 1) & 1;
      const int row = q0 + row0 + 8 * h;
      const int col = 8 * (j >> 2) + 2 * t + (j & 1);
      if (row >= p.s_q || col >= p.d) continue;
      if constexpr (kCarry)
        p.acc[(rows + row) * p.d + col] = o[j];
      else
        store_out(static_cast<T*>(p.o) + (rows + row) * p.d + col,
                  o[j] / fmaxf(l_sum[h], 1e-30f));
    }
  }
}

// ---- host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found once through the runtime
// (the build links no libcuda); a host call that neither allocates nor
// synchronises, so a launch inside a captured graph bakes its maps in
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                            &found);
#endif
    return found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// a 4-d map (cols, rows, b*h, parts) over row-major parts, 128-byte
// swizzled boxes of (box_cols, box_rows); `ld` is the row pitch in
// elements and must make rows of whole 16 bytes
inline bool make_map(CUtensorMap* map, const void* ptr, bool bf16, int cols,
                     int ld, int rows, int bh, int parts, int box_cols,
                     int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t elem = bf16 ? 2 : 4;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(bh),
                              static_cast<cuuint64_t>(parts)};
  const cuuint64_t pitch = static_cast<cuuint64_t>(ld) * elem;
  const cuuint64_t strides[3] = {pitch, pitch * rows, pitch * rows * bh};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  return encode(map,
                bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                4, const_cast<void*>(ptr), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline int round_up(int x, int to) { return (x + to - 1) / to * to; }

// Bytes of f32 scratch a launch needs: K's hi and lo (bh, s_k, dp) and
// V^T's hi and lo (bh, dp, s_kp), dp = d and s_kp = s_k rounded up to 8.
// bf16 needs none.
inline long long scratch_bytes(int bh, int s_k, int d, int is_bf16) {
  if (is_bf16) return 0;
  const long long dp = round_up(d, 8), s_kp = round_up(s_k, 8);
  return 4LL * 2 * bh * (s_k * dp + dp * s_kp);
}

// One launch's operands: q (bh, s_q, ld_q), k and v (bh, s_k, ld_kv).
struct Launch {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* acc;
  float* l;
  float* m;
  void* scratch;
  long long scratch_bytes;
  int bh, s_q, s_k, d, ld_q, ld_kv;
  float qscale;
  int q_off, k_off, causal;
};

template <typename T, int DP, bool kCarry>
int launch(const Launch& a, cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  using C = Cfg<T>;
  FoldParams p{};
  p.o = a.o;
  p.acc = a.acc;
  p.l = a.l;
  p.m = a.m;
  p.bh = a.bh;
  p.s_q = a.s_q;
  p.s_k = a.s_k;
  p.d = a.d;
  p.qscale = a.qscale;
  p.q_off = a.q_off;
  p.k_off = a.k_off;
  p.causal = a.causal;
  bool ok = make_map(&p.tq, a.q, kBf16, a.ld_q, a.ld_q, a.s_q, a.bh, 1, C::kW,
                     kBlockQ);
  if constexpr (kBf16) {
    ok = ok &&
         make_map(&p.tk, a.k, true, a.ld_kv, a.ld_kv, a.s_k, a.bh, 1, C::kW,
                  C::kBlockK) &&
         make_map(&p.tv, a.v, true, a.ld_kv, a.ld_kv, a.s_k, a.bh, 1, C::kW,
                  C::kBlockK);
  } else {
    const int dp = round_up(a.d, 8), s_kp = round_up(a.s_k, 8);
    float* khi = static_cast<float*>(a.scratch);
    float* vhi = khi + 2LL * a.bh * a.s_k * dp;
    ok = ok &&
         make_map(&p.tk, khi, false, dp, dp, a.s_k, a.bh, 2, C::kW,
                  C::kBlockK) &&
         make_map(&p.tv, vhi, false, s_kp, s_kp, dp, a.bh, 2, C::kBlockK, DP);
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    // a chunk wholly in the queries' future needs no split: every block
    // returns before it reads anything
    const bool future = a.causal && a.q_off + a.s_q - 1 < a.k_off;
    if (!future) {
      split_kv_kernel<<<dim3((s_kp + 31) / 32, a.bh), 256, 0, stream>>>(
          static_cast<const float*>(a.k), static_cast<const float*>(a.v), khi,
          khi + 1LL * a.bh * a.s_k * dp, vhi, vhi + 1LL * a.bh * dp * s_kp,
          a.s_k, a.d, a.ld_kv, dp, s_kp);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = Smem<T, DP>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      fold_kernel<T, DP, kCarry>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (a.s_q + kBlockQ - 1) / kBlockQ;
  fold_kernel<T, DP, kCarry>
      <<<dim3(static_cast<unsigned>(n_qt) * static_cast<unsigned>(a.bh)),
         kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Checks a launch's sizes and launches the fold for f32 or bf16 operands;
// returns a cudaError_t (0 on success).
template <bool kCarry>
int dispatch(const Launch& a, int is_bf16, cudaStream_t stream) {
  const int per16 = is_bf16 ? 8 : 4;  // elements in 16 bytes
  const bool aligned =
      reinterpret_cast<uintptr_t>(a.q) % 16 == 0 && a.ld_q % per16 == 0 &&
      a.ld_q >= a.d &&
      (!is_bf16 || (reinterpret_cast<uintptr_t>(a.k) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(a.v) % 16 == 0 &&
                    a.ld_kv % per16 == 0)) &&
      a.ld_kv >= a.d;
  if (a.d < 1 || a.d > kMaxD || a.s_q < 1 || a.s_k < 1 || a.bh < 1 ||
      !aligned || a.scratch_bytes < scratch_bytes(a.bh, a.s_k, a.d, is_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    return a.d <= 64 ? launch<__nv_bfloat16, 64, kCarry>(a, stream)
                     : launch<__nv_bfloat16, 128, kCarry>(a, stream);
  return a.d <= 64 ? launch<float, 64, kCarry>(a, stream)
                   : launch<float, 128, kCarry>(a, stream);
}

}  // namespace netsdb_fold
