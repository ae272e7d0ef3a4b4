// The flash-attention fold on Hopper's tensor cores (sm_90a, mma.sync),
// shared by flash_attention.cu (B1) and flash_attention_step.cu (B2).
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
// Products on the tensor cores through mma.sync (the FA2 shape):
// - bf16: mma.m16n8k16, bf16 in, f32 accumulate.
// - f32: mma.m16n8k8.tf32 in three passes. x = hi + lo with hi = x
//   rounded to tf32 and lo = x - hi, read as tf32; a.b ~ lo.hi + hi.lo +
//   hi.hi. The dropped terms are about 2^-22 of the product, so the fold
//   keeps f32's accuracy where one pass (2^-11) would not: the reference
//   asks for Precision.HIGHEST. The tensor core rounds its f32 sums
//   toward zero, so one long accumulator chain drifts (with all passes
//   and all keys in one chain B1 read 6x the plain version's error
//   against f64, PERF.md): each 8-deep product starts from zero and is
//   added to S, or to the tile's P.V, in f32.
//
// Design. One block of 4 warps per (b*h, 64-row query tile), heaviest
// causal tiles first; each warp owns 16 query rows and the whole 64-key
// tile, so a row's max and sum need only shuffles among the 4 lanes of
// its mma group. The score tile S (16 x 64 a warp, 8 n-tiles) and the
// accumulator (16 x D, D/8 n-tiles) stay in the mma C layout in
// registers. Shared memory holds Q, K and V as tiles of the input type,
// rows padded by 16 bytes so fragment reads do not collide on banks:
// f32 at D = 128: (64 + 64 + 64) x 132 x 4 B = 101,376 B, two blocks an
// SM; bf16: 52,224 B. K and V are fetched with cp.async (16-byte
// copies, zero-filled past s_k and past d): V of a tile lands while S is
// computed, and the next tile's K while P.V runs. bf16 reads fragments
// with ldmatrix (.trans for V) and keeps Q's fragments in registers;
// f32 reads 32-bit words and splits each into hi/lo as it is loaded,
// on the integer units (Q's hi and lo together would be 128 registers a
// thread; splitting K and V once a block would need 2x their shared
// memory).
// - P as the A operand of P.V, f32: the C layout of m16n8 gives a lane
//   keys 2t, 2t+1 of each 8-key group, the A layout of m16n8k8 wants
//   t, t+4. The fold relabels keys within the group (logical t <-
//   physical 2t, t+4 <- 2t+1) and reads V's rows in the same order, so
//   P never leaves its registers. bf16 packs C into A as FA2 does.
// - Any head dim 1 <= d <= 128: tiles are padded to 64 or 128 columns
//   (zero-filled) and k-steps wholly past d are skipped. Any s_q, s_k
//   and offsets: rows past the end are zero-filled and masked.
//
// Bound at B1's path shape (causal, B 2, H 8, S 4096, D 128): 4 B H
// S(S+1)/2 D = 68.7 GFLOP. f32 on the CUDA cores: 1.026 ms at the H100
// SXM's 67 TFLOP/s. Three-pass TF32 is 3x the products at 495 TFLOP/s:
// 0.416 ms. bf16 at 989 TFLOP/s: 0.0695 ms. q, k, v and o are 134 MB in
// f32 (0.04 ms at 3.35 TB/s): compute-bound in both types. B2's chain
// (bh 16, four 4096-key chunks, q last) is 7.0x B1's products.
//
// Left to later work: wgmma (the only path to the full tensor-core
// rate), TMA loads with mbarriers, warp specialisation (a producer warp
// feeding consumer warpgroups), and for f32 a split done once a block.
// mma.sync is kept because one fragment layout serves both types and
// the f32 split happens in registers; tf32 wgmma would need V
// transposed in shared memory (K-major B).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace netsdb_fold {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockQ = 16 * kWarps;  // query rows per block, 16 a warp
constexpr int kBlockK = 64;           // keys per tile
constexpr int kMaxD = 128;            // largest head dimension handled
constexpr float kNegInf = -1e30f;     // the reference's NEG_INF

// One launch's operands. B1 sets s_q = s_k, zero offsets, o; B2 sets the
// carry (acc (bh, s_q, d), l and m (bh, s_q)).
struct FoldParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* acc;
  float* l;
  float* m;
  int bh, s_q, s_k, d;
  float qscale;
  int q_off, k_off, causal;
  int vec;  // k and v rows allow 16-byte cp.async copies
};

// kPad: shared row padding in elements (16 bytes), so that fragment
// reads do not collide on banks (a row stride of 4 words mod 32);
// kVec: elements in a 16-byte copy
template <typename T>
struct Tile;
template <>
struct Tile<float> {
  static constexpr int kPad = 4, kVec = 4;
};
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int kPad = 8, kVec = 8;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// x = hi + lo: hi is x rounded to tf32 (to nearest, ties away from zero,
// as cvt.rna does, but on the integer units: the conversion unit runs at
// a quarter of their rate), lo = x - hi, which the tensor core reads to
// tf32 by dropping its low 13 bits (an error of 2^-22 of x at most).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c = a.b from a zero accumulator
__device__ __forceinline__ void mma_tf32_zero(float (&c)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// c = a.b in three tf32 passes from a zero accumulator, the small terms
// first. The tensor core rounds its f32 sums toward zero, so a long chain
// of passes into one accumulator drifts (PERF.md): each product
// starts from zero and the caller adds it in f32, rounding to nearest.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           uint32_t b0_hi, uint32_t b1_hi,
                                           uint32_t b0_lo, uint32_t b1_lo) {
  mma_tf32_zero(c, a_lo, b0_hi, b1_hi);
  mma_tf32(c, a_hi, b0_lo, b1_lo);
  mma_tf32(c, a_hi, b0_hi, b1_hi);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as bf16x2, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One (b*h, 64-row query tile) block: fold every live key tile of the
// chunk into the carry. DP is the head dim padded to 64 or 128.
template <typename T, int DP, bool kCarry>
__global__ void __launch_bounds__(kThreads, 2)
fold_kernel(const FoldParams p) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int LD = DP + Tile<T>::kPad;  // shared row stride, elements
  constexpr int NT = kBlockK / 8;         // 8-key n-tiles of S
  constexpr int DT = DP / 8;              // 8-column n-tiles of acc

  // heaviest query tiles first, across all (b*h)
  const int n_qt = (p.s_q + kBlockQ - 1) / kBlockQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / p.bh;
  const int bh = static_cast<int>(blockIdx.x) % p.bh;
  const int q0 = qt * kBlockQ;
  const int d = p.d;

  // causal: key tiles wholly past this tile's last query are skipped
  int n_kt = (p.s_k + kBlockK - 1) / kBlockK;
  if (p.causal) {
    const int q_last = p.q_off + min(q0 + kBlockQ, p.s_q) - 1;
    n_kt = q_last < p.k_off ? 0
                            : min(n_kt, (q_last - p.k_off) / kBlockK + 1);
  }
  // a chunk wholly in the future: the carry stays exactly as it is
  if (kCarry && n_kt == 0) return;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // kBlockQ x LD
  T* Ks = Qs + kBlockQ * LD;               // kBlockK x LD
  T* Vs = Ks + kBlockK * LD;               // kBlockK x LD

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma group and lane within it
  const T* q = static_cast<const T*>(p.q) + static_cast<size_t>(bh) * p.s_q * d;
  const T* k = static_cast<const T*>(p.k) + static_cast<size_t>(bh) * p.s_k * d;
  const T* v = static_cast<const T*>(p.v) + static_cast<size_t>(bh) * p.s_k * d;

  // a 64-key tile of k or v, zero past s_k and past d
  auto load_tile = [&](T* dst, const T* src, int k0) {
    if (p.vec) {
      constexpr int kChunks = DP / Tile<T>::kVec;
      for (int i = tid; i < kBlockK * kChunks; i += kThreads) {
        const int r = i / kChunks, c = (i % kChunks) * Tile<T>::kVec;
        const bool ok = k0 + r < p.s_k && c < d;
        cp_async16(dst + r * LD + c,
                   ok ? src + static_cast<size_t>(k0 + r) * d + c : src,
                   ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < kBlockK * DP; i += kThreads) {
        const int r = i / DP, c = i % DP;
        dst[r * LD + c] = k0 + r < p.s_k && c < d
                              ? src[static_cast<size_t>(k0 + r) * d + c]
                              : from_float<T>(0.f);
      }
    }
  };

  if (n_kt > 0) load_tile(Ks, k, 0);
  cp_async_commit();

  // the query tile, pre-scaled by scale*log2(e) and rounded to T
  for (int i = tid; i < kBlockQ * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    float x = 0.f;
    if (q0 + r < p.s_q && c < d)
      x = to_float(q[static_cast<size_t>(q0 + r) * d + c]) * p.qscale;
    Qs[r * LD + c] = from_float<T>(x);
  }

  // the carry of rows g and g+8 of this warp's 16; l is kept per lane
  // (a partial sum over its keys) and summed over the group at the end
  float acc[DT][4], m_r[2], l_r[2];
  const size_t rows = static_cast<size_t>(bh) * p.s_q;  // first carry row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + 8 * h;
    const bool live = kCarry && row < p.s_q;
    m_r[h] = live ? p.m[rows + row] : kNegInf;
    l_r[h] = live && t == 0 ? p.l[rows + row] : 0.f;
#pragma unroll
    for (int nt = 0; nt < DT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = nt * 8 + 2 * t + j;
        acc[nt][2 * h + j] =
            live && col < d ? p.acc[(rows + row) * d + col] : 0.f;
      }
  }

  __syncthreads();  // Qs stored
  // bf16: Q's A fragments stay in registers for the whole chunk
  uint32_t qf[kBf16 ? DP / 16 : 1][4];
  if constexpr (kBf16) {
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks)
      ldmatrix_x4(qf[ks], Qs + (warp * 16 + ((lane >> 3) & 1) * 8 +
                                (lane & 7)) * LD +
                               ks * 16 + (lane >> 4) * 8);
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the last tile's V
    load_tile(Vs, v, k0);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's K has landed
    __syncthreads();

    // S = Q K^T for this warp's 16 rows, in the exp2 domain
    float s[NT][4];
    if constexpr (kBf16) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {
        if (ks * 16 >= d) break;
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b[4];
          ldmatrix_x4(b, Ks + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                             ks * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], qf[ks], b[0], b[1]);
          mma_bf16(s[2 * np + 1], qf[ks], b[2], b[3]);
        }
      }
    } else {
      const float* qw = reinterpret_cast<const float*>(Qs) +
                        (warp * 16 + g) * LD + t;
#pragma unroll
      for (int ks = 0; ks < DP / 8; ++ks) {
        if (ks * 8 >= d) break;
        uint32_t a_hi[4], a_lo[4];
        split_tf32(qw[ks * 8], a_hi[0], a_lo[0]);
        split_tf32(qw[8 * LD + ks * 8], a_hi[1], a_lo[1]);
        split_tf32(qw[ks * 8 + 4], a_hi[2], a_lo[2]);
        split_tf32(qw[8 * LD + ks * 8 + 4], a_hi[3], a_lo[3]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float* kr = reinterpret_cast<const float*>(Ks) +
                            (nt * 8 + g) * LD + ks * 8 + t;
          uint32_t b0_hi, b0_lo, b1_hi, b1_lo;
          split_tf32(kr[0], b0_hi, b0_lo);
          split_tf32(kr[4], b1_hi, b1_lo);
          float part[4];
          mma_3xtf32(part, a_hi, a_lo, b0_hi, b1_hi, b0_lo, b1_lo);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            s[nt][i] = ks == 0 ? part[i] : s[nt][i] + part[i];
        }
      }
    }

    __syncthreads();  // every warp is done with this tile's K
    if (kt + 1 < n_kt) load_tile(Ks, k, k0 + kBlockK);
    cp_async_commit();

    // only tiles that cross the diagonal (causal) and the ragged last
    // tile mask; a masked logit contributes p = 0 below
    const bool masked =
        (p.causal && p.k_off + k0 + kBlockK - 1 > p.q_off + q0) ||
        k0 + kBlockK > p.s_k;
    if (masked) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kc = k0 + nt * 8 + 2 * t + (i & 1);
          const int qp = p.q_off + q0 + warp * 16 + g + 8 * (i >> 1);
          if (kc >= p.s_k || (p.causal && p.k_off + kc > qp))
            s[nt][i] = kNegInf;
        }
    }

    // online softmax update of (m, l, acc); P stays in s. f32 applies
    // the correction to acc as it adds this tile's P.V
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[h], mx);
      corr[h] = exp2f(m_r[h] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          // exp2(NEG_INF - m_new) is 0 once m_new is real; a row whose
          // carry is still empty needs the explicit 0
          const float x = s[nt][2 * h + j];
          const float pv = masked && x <= kNegInf ? 0.f : exp2f(x - m_new);
          rs += pv;
          s[nt][2 * h + j] = pv;
        }
      l_r[h] = l_r[h] * corr[h] + rs;
      if constexpr (kBf16) {
#pragma unroll
        for (int nt = 0; nt < DT; ++nt) {
          acc[nt][2 * h] *= corr[h];
          acc[nt][2 * h + 1] *= corr[h];
        }
      }
      m_r[h] = m_new;
    }

    cp_async_wait<1>();  // this tile's V has landed
    __syncthreads();

    // acc += P V
    if constexpr (kBf16) {
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < DT / 2; ++np) {
          if (np * 16 >= d) break;
          uint32_t b[4];
          ldmatrix_x4_trans(
              b, Vs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                     np * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * np], a, b[0], b[1]);
          mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
        }
      }
    } else {
      // P's hi/lo in the A layout, keys relabelled within each 8-key
      // group: logical t <- physical 2t, t+4 <- 2t+1 (see the note)
      uint32_t p_hi[NT][4], p_lo[NT][4];
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        split_tf32(s[kk][0], p_hi[kk][0], p_lo[kk][0]);
        split_tf32(s[kk][2], p_hi[kk][1], p_lo[kk][1]);
        split_tf32(s[kk][1], p_hi[kk][2], p_lo[kk][2]);
        split_tf32(s[kk][3], p_hi[kk][3], p_lo[kk][3]);
      }
#pragma unroll
      for (int nt = 0; nt < DT; ++nt) {
        if (nt * 8 >= d) break;
        // this tile's P.V for 8 columns, 8 keys a product, summed in f32;
        // then acc = acc * corr + P.V as the reference writes it
        float pv[4];
#pragma unroll
        for (int kk = 0; kk < NT; ++kk) {
          const float* vr = reinterpret_cast<const float*>(Vs) +
                            (kk * 8 + 2 * t) * LD + nt * 8 + g;
          uint32_t b0_hi, b0_lo, b1_hi, b1_lo;
          split_tf32(vr[0], b0_hi, b0_lo);
          split_tf32(vr[LD], b1_hi, b1_lo);
          float part[4];
          mma_3xtf32(part, p_hi[kk], p_lo[kk], b0_hi, b1_hi, b0_lo, b1_lo);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            pv[i] = kk == 0 ? part[i] : pv[i] + part[i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[nt][i] = fmaf(acc[nt][i], corr[i >> 1], pv[i]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + 8 * h;
    float l_sum = l_r[h];
    l_sum += __shfl_xor_sync(0xffffffffu, l_sum, 1);
    l_sum += __shfl_xor_sync(0xffffffffu, l_sum, 2);
    if (row >= p.s_q) continue;
    if constexpr (kCarry) {
      if (t == 0) {
        p.m[rows + row] = m_r[h];
        p.l[rows + row] = l_sum;
      }
    }
    const float den = fmaxf(l_sum, 1e-30f);
#pragma unroll
    for (int nt = 0; nt < DT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = nt * 8 + 2 * t + j;
        if (col >= d) continue;
        const float x = acc[nt][2 * h + j];
        if constexpr (kCarry)
          p.acc[(rows + row) * d + col] = x;
        else
          static_cast<T*>(p.o)[(rows + row) * d + col] = from_float<T>(x / den);
      }
  }
}

template <typename T, int DP, bool kCarry>
int launch(const FoldParams& p, cudaStream_t stream) {
  const size_t smem = sizeof(T) * static_cast<size_t>(kBlockQ + 2 * kBlockK) *
                      (DP + Tile<T>::kPad);
  cudaError_t err = cudaFuncSetAttribute(
      fold_kernel<T, DP, kCarry>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (p.s_q + kBlockQ - 1) / kBlockQ;
  fold_kernel<T, DP, kCarry>
      <<<dim3(static_cast<unsigned>(n_qt) * static_cast<unsigned>(p.bh)),
         kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Launches the fold for f32 or bf16 operands; returns cudaGetLastError().
template <bool kCarry>
int dispatch(FoldParams p, int is_bf16, cudaStream_t stream) {
  const int vec = is_bf16 ? Tile<__nv_bfloat16>::kVec : Tile<float>::kVec;
  p.vec = p.d % vec == 0 && reinterpret_cast<uintptr_t>(p.k) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(p.v) % 16 == 0;
  if (is_bf16)
    return p.d <= 64 ? launch<__nv_bfloat16, 64, kCarry>(p, stream)
                     : launch<__nv_bfloat16, 128, kCarry>(p, stream);
  return p.d <= 64 ? launch<float, 64, kCarry>(p, stream)
                   : launch<float, 128, kCarry>(p, stream);
}

}  // namespace netsdb_fold
