// A float32 matrix product on Hopper's tensor cores (sm_90a): three-pass
// TF32 on wgmma, fed by TMA from a producer warp.
//
// Replaces no Pallas kernel: the reference leaves its products to XLA at
// Precision.HIGHEST (netsdb_tpu/ops/common.py mxu_dot, hi_einsum). It was
// added because cuBLAS, with TF32 off as Precision.HIGHEST asks, runs f32
// products as SIMT SGEMMs on the CUDA cores, at about 51 TFLOP/s, 77% of
// their 67: the FF cell's two products took 86% of its busy card time and
// the transformer layer's four 54% (PERF.md, the f32 product route).
//
// What bounds it. C = A B as three-pass TF32: with p = hi + lo (hi = p
// rounded to tf32, lo = p - hi) and q = hi + mid + lo2 (three tf32 parts
// that sum to q exactly, split_q_exact), p.q ~ lo.hi + hi.lo2 + hi.mid +
// hi.hi. The three passes of the scheme (lo.hi + hi.lo + hi.hi, 3 x 2MNK
// operations at the tensor cores' 495 TFLOP/s, 165 TFLOP/s of f32 work)
// take the fourth, hi.lo2, because tf32 holds 11 of f32's 24 significant
// bits: two parts of q leave one bit out, and a product with an operand
// that is exact in tf32 (a one-hot row picking a table row) would no
// longer return the f32 it picks. So 4 x 2MNK operations, 124 TFLOP/s of
// f32 work at the peak. At the cells' shapes (M, N, K of 16384 x 4096 x
// 1024 and the like) the operands and the output take 0.05-0.3 ms at 3.35
// TB/s: compute-bound. The dropped term lo.(mid + lo2) and lo's rounding
// to tf32 are about 2^-22 of a product, so the sums keep f32's accuracy
// where one tf32 pass (2^-11) would not.
//
// The design. The fold of flash_fold_wgmma.cuh (B1, B2) proved each part
// on this card; this kernel reuses its helpers (mbarriers, TMA, wgmma
// descriptors, split_tf32, the tensor-map encoder):
//
// - The kernel computes D = P Q: P (R x K) is the larger operand, read
//   raw by TMA and split in registers; Q (K x C) the smaller, split
//   once a launch by a memory-bound pre-pass (split_q_kernel) into hi,
//   mid and lo2 laid out K-major, the only layout tf32 wgmma reads from
//   shared memory, in scratch of 12 C K bytes that the wrapper allocates.
//   So no scratch is the size of an activation. When Q is the left factor, the
//   wrapper passes P = B^T and D is stored transposed: C = (B^T A^T)^T.
// - P is wgmma's A operand, from registers, so it may lie K-major (rows of
//   K) or R-major (K rows of R): TMA copies either as it lies into
//   128-byte-swizzled boxes, and each thread loads its fragment with plain
//   shared-memory loads that the swizzle keeps free of bank conflicts. The
//   order of k inside each group of 32 (K-major: a thread's eight k are
//   adjacent, two 16-byte loads) or of 8 (R-major: the four threads of a
//   row read k rows of distinct swizzle phases) is the pre-pass's
//   permutation of Q's k, so P needs none.
// - One block of three warpgroups per 128 x 128 tile of D, column tiles
//   fastest so the blocks on the card at once share P's rows in L2. Warp 0
//   is the producer: it streams P's and Q's (hi, mid, lo2) 32-deep k-tiles
//   through three stages (64 KB each) with TMA, each stage with a "full"
//   and an "empty" mbarrier. Each consumer owns 64 rows x 128 columns.
// - The tensor core rounds its f32 sums toward zero, so a long chain of
//   products into one accumulator drifts (the fold's note). Each k-tile's
//   sixteen products (four 8-deep steps, four passes each, the small
//   terms first) run from zero into a partial sum, which is added to the
//   accumulator in f32, rounding to nearest. At K = 4096 that reads a
//   quarter of cuBLAS's SGEMM error against f64 (PERF.md). Q's hi keeps
//   q's binade and its parts are summed smallest first, so a picked row
//   sums to q inside the tensor core's 24-bit window: exactly.
// - Registers: ptxas compiles every thread to the launch's 168 (the fold's
//   setmaxnreg raises a consumer's budget at run time, not the compiler's:
//   this kernel spilled with it), so a thread holds the accumulator and
//   the partial (64 + 64 floats), two steps' fragments (hi and lo, 16) and
//   half a k-tile of P (8). A step is one commit group: the next step's
//   fragment is split while this one's products run, and a fragment is
//   written again only after wgmma.wait_group 1 says its products are
//   done. While one consumer adds its partial and loads its next k-tile,
//   the other's products keep the tensor cores busy.
//
// Left to later work: a persistent grid (one tile's stores overlapping the
// next one's loads), Q shared by a cluster's blocks through TMA multicast,
// and the pre-pass folded into the producer side.

#include "flash_fold_wgmma.cuh"

namespace netsdb_gemm {

using netsdb_fold::fence_regs;
using netsdb_fold::mbar_arrive;
using netsdb_fold::mbar_expect_tx;
using netsdb_fold::mbar_init;
using netsdb_fold::mbar_wait;
using netsdb_fold::smem_u32;
using netsdb_fold::split_tf32;
using netsdb_fold::sw128_desc;
using netsdb_fold::tma_load;
using netsdb_fold::wgmma_commit;
using netsdb_fold::wgmma_fence;
using netsdb_fold::wgmma_wait;

constexpr int kConsumers = 2;               // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kBM = 64 * kConsumers;        // P rows (D rows) a block
constexpr int kBN = 128;                    // Q columns (D columns) a block
constexpr int kBK = 32;                     // k a stage: one 128-byte row
constexpr int kStages = 3;

struct Smem {
  static constexpr int kP = kBM * kBK * 4;  // P's k-tile, 16 KB
  static constexpr int kQ = kBN * kBK * 4;  // Q's, each of hi, mid, lo2
  static constexpr int kParts = 3;
  static constexpr int kStage = kP + kParts * kQ;
  static constexpr int bars = kStages * kStage;
  static constexpr int bytes = bars + 8 * 2 * kStages + 1024;
};

struct Params {
  CUtensorMap tp;  // P raw: K-major (K, R) or R-major (R, K), fastest first
  CUtensorMap tq;  // Q split: (Kp, C, 1, part), parts hi, mid, lo2
  float* out;
  long long ldo;   // out's row pitch, elements
  int rows, cols;  // R, C
  int k, n_ct;     // K, column tiles
  int trans_out;   // D[r][c] goes to out[c * ldo + r]
};

// d (64 x 128) (+)= a (64 x 8, registers) . b (8 x 128, shared), tf32
__device__ __forceinline__ void wgmma_rs_tf32_n128(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " NETSDB_ACC64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : NETSDB_D64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// The k that position `pos` (0..31) of a split k-tile of Q holds, so that
// wgmma's step s = pos / 8, slot j = pos % 8 meets what a thread loaded of
// P. A thread (row g, lane t of its quad) holds slots t and t + 4 of each
// step. K-major P: its eight k are 8t .. 8t + 7, slot t of step s being
// 8t + 2s and slot t + 4 being 8t + 2s + 1. R-major P: slot t of step s is
// 8s + 2t and slot t + 4 is 8s + 2t + 1.
__device__ __forceinline__ int q_position_k(int pos, int p_rmajor) {
  const int s = pos >> 3, j = pos & 7;
  return p_rmajor ? 8 * s + 2 * (j & 3) + (j >> 2)
                  : 8 * (j & 3) + 2 * s + (j >> 2);
}

// q as three tf32 values that sum to it exactly: hi = q rounded to tf32
// (split_tf32), or cut to tf32 where rounding would carry it into the next
// binade, so hi has q's exponent; then the remainder r = q - hi (at most
// 13 significant bits) split the same way into mid and lo2 (at most one
// bit). Every bit of hi, mid and lo2 lies within q's 24.
__device__ __forceinline__ void split_q_exact(float q, uint32_t& hi,
                                              uint32_t& mid, uint32_t& lo2) {
  uint32_t r;
  split_tf32(q, hi, r);
  if ((hi ^ __float_as_uint(q)) & 0x7f800000u) {
    hi = __float_as_uint(q) & 0xffffe000u;
    r = __float_as_uint(q - __uint_as_float(hi));
  }
  split_tf32(__uint_as_float(r), mid, lo2);
}

// The pre-pass: Q (K x C, element (k, c) at q[k * sk + c * sc]) to its tf32
// hi, mid and lo2 (split_q_exact), each (C, Kp) with Kp = K rounded up to
// 32, k permuted within each 32 by q_position_k and zero past K. One block
// per 32 x 32 tile, read along whichever of Q's dimensions is contiguous.
__global__ void __launch_bounds__(256)
split_q_kernel(const float* __restrict__ q, long long sk, long long sc, int k,
               int cols, int kp, int p_rmajor, float* __restrict__ qs) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  for (int i = threadIdx.x; i < 32 * 32; i += blockDim.x) {
    const int kk = sk == 1 ? i & 31 : i >> 5;
    const int cc = sk == 1 ? i >> 5 : i & 31;
    const int kr = k0 + kk, c = c0 + cc;
    tile[kk][cc] = kr < k && c < cols ? q[kr * sk + c * sc] : 0.f;
  }
  __syncthreads();
  const size_t part = static_cast<size_t>(cols) * kp;
  for (int i = threadIdx.x; i < 32 * 32; i += blockDim.x) {
    const int pos = i & 31, c = c0 + (i >> 5);
    if (c >= cols) continue;
    uint32_t hi, mid, lo2;
    split_q_exact(tile[q_position_k(pos, p_rmajor)][i >> 5], hi, mid, lo2);
    const size_t at = static_cast<size_t>(c) * kp + k0 + pos;
    qs[at] = __uint_as_float(hi);
    qs[part + at] = __uint_as_float(mid);
    qs[2 * part + at] = __uint_as_float(lo2);
  }
}

template <bool kRMajor>
__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(const __grid_constant__ Params p) {
  const int ct = static_cast<int>(blockIdx.x) % p.n_ct;
  const int rt = static_cast<int>(blockIdx.x) / p.n_ct;
  const int r0 = rt * kBM, c0 = ct * kBN;
  const int n_kt = (p.k + kBK - 1) / kBK;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const unsigned char* const sbase = smem_raw + (base - smem_u32(smem_raw));
  auto full = [&](int s) { return base + Smem::bars + 8 * s; };
  auto empty = [&](int s) { return base + Smem::bars + 8 * (kStages + s); };
  auto p_tile = [&](int s) { return base + s * Smem::kStage; };
  auto q_tile = [&](int s, int part) {
    return base + s * Smem::kStage + Smem::kP + part * Smem::kQ;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * kConsumers);  // lane 0 of each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the role by warpgroup, uniform in each warp (the fold's note)
  if (__shfl_sync(0xffffffffu, threadIdx.x >> 7, 0) == 0) {
    // ---- producer warpgroup: thread 0 streams the k-tiles
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages, phase = (kt / kStages) & 1;
        mbar_wait(empty(s), phase ^ 1);
        mbar_expect_tx(full(s), Smem::kStage);
        if (kRMajor) {
          // 32 k rows of 32 P rows a box, four boxes along R
          for (int b = 0; b < kBM / 32; ++b)
            tma_load(p_tile(s) + b * 32 * 128, &p.tp, full(s), r0 + 32 * b,
                     kt * kBK, 0, 0);
        } else {
          tma_load(p_tile(s), &p.tp, full(s), kt * kBK, r0, 0, 0);
        }
        for (int part = 0; part < Smem::kParts; ++part)
          tma_load(q_tile(s, part), &p.tq, full(s), kt * kBK, c0, 0, part);
      }
    }
    return;
  }

  // ---- consumer warpgroups
  const int ctid = threadIdx.x - 128;
  const int wg = __shfl_sync(0xffffffffu, ctid >> 7, 0);  // its 64 rows
  const int warp = (ctid >> 5) & 3, lane = ctid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row = wg * 64 + warp * 16 + g;  // and row + 8, in the block

  // raw[h][i]: the thread's k 4 half + i of row row + 8h in a k-tile
  // (the thread's eight k, q_position_k's order), half 0 for steps 0 and 1
  // and half 1 for steps 2 and 3: step s takes i = 2 (s % 2) for slot t
  // and i + 1 for slot t + 4
  float raw[2][4];
  auto load_half = [&](int s, int half) {
    const unsigned char* tile = sbase + s * Smem::kStage;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      if constexpr (kRMajor) {
        // box r / 32 holds 32 k rows of 128 bytes; r's word in a row is
        // r % 4 of 16-byte chunk (r % 32) / 4, swizzled by the k row
        const unsigned char* box = tile + (r >> 5) * 32 * 128 + (r & 3) * 4;
        const int chunk = (r & 31) >> 2;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kk = 8 * (2 * half + (i >> 1)) + 2 * t + (i & 1);
          raw[h][i] = *reinterpret_cast<const float*>(
              box + kk * 128 + ((chunk ^ (kk & 7)) << 4));
        }
      } else {
        // row r's k 8t + 4 half .. + 3: chunk 2t + half, swizzled by r
        const float4 v = *reinterpret_cast<const float4*>(
            tile + r * 128 + (((2 * t + half) ^ (r & 7)) << 4));
        raw[h][0] = v.x;
        raw[h][1] = v.y;
        raw[h][2] = v.z;
        raw[h][3] = v.w;
      }
    }
  };

  // two steps' fragments in turn, tf32 hi and lo: a[0] row g slot t, a[1]
  // row g + 8 slot t, a[2] row g slot t + 4, a[3] row g + 8 slot t + 4
  uint32_t a_hi[2][4], a_lo[2][4];
  auto split_step = [&](int ks) {
    const int b = ks & 1, i = 2 * b;
    split_tf32(raw[0][i], a_hi[b][0], a_lo[b][0]);
    split_tf32(raw[1][i], a_hi[b][1], a_lo[b][1]);
    split_tf32(raw[0][i + 1], a_hi[b][2], a_lo[b][2]);
    split_tf32(raw[1][i + 1], a_hi[b][3], a_lo[b][3]);
  };
  float acc[64], part[64];
  // step ks of stage s into part, from zero at step 0: the small terms
  // first, one commit group a step
  auto issue_step = [&](int s, int ks) {
    const int b = ks & 1;
    const uint64_t qh = sw128_desc(q_tile(s, 0) + ks * 32, 16, 1024);
    const uint64_t qm = sw128_desc(q_tile(s, 1) + ks * 32, 16, 1024);
    const uint64_t ql = sw128_desc(q_tile(s, 2) + ks * 32, 16, 1024);
    wgmma_fence();
    wgmma_rs_tf32_n128(part, a_lo[b], qh, ks > 0);
    wgmma_rs_tf32_n128(part, a_hi[b], ql, 1);
    wgmma_rs_tf32_n128(part, a_hi[b], qm, 1);
    wgmma_rs_tf32_n128(part, a_hi[b], qh, 1);
    wgmma_commit();
  };

#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % kStages;
    mbar_wait(full(s), (kt / kStages) & 1);
    load_half(s, 0);
    fence_regs(part);
    split_step(0);
    issue_step(s, 0);
    split_step(1);
    issue_step(s, 1);
    load_half(s, 1);
    // a step's fragment registers are written again once its products
    // have run: at most one step in flight
    wgmma_wait<1>();
    split_step(2);
    issue_step(s, 2);
    wgmma_wait<1>();
    split_step(3);
    issue_step(s, 3);
    wgmma_wait();
    fence_regs(part);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] += part[j];
  }

  // D's rows row, row + 8 and columns 8i + 2t, 8i + 2t + 1 of each 8
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    const int r = r0 + row + 8 * ((j >> 1) & 1);
    const int c = c0 + 8 * (j >> 2) + 2 * t + (j & 1);
    if (r >= p.rows || c >= p.cols) continue;
    const long long at = p.trans_out ? c * p.ldo + r : r * p.ldo + c;
    p.out[at] = acc[j];
  }
}

inline int round_up(int x, int to) { return (x + to - 1) / to * to; }

// Bytes of f32 scratch a launch needs: Q's hi, mid and lo2, (C, Kp) each.
inline long long scratch_bytes(int cols, int k) {
  return 4LL * Smem::kParts * cols * round_up(k, kBK);
}

}  // namespace netsdb_gemm

// D = P Q for P (rows x k) and Q (k x cols), on `stream`; returns a
// cudaError_t (0 on success). P: K-major (p_rmajor 0, element (r, k) at
// p[r * ldp + k]) or R-major (1, at p[k * ldp + r]); TMA reads it, so p is
// 16-byte aligned and ldp a multiple of 4. Q: element (k, c) at
// q[k * sk + c * sc], any strides. D: out[r * ldo + c], or out[c * ldo +
// r] with trans_out. `scratch` holds netsdb_gemm::scratch_bytes(cols, k).
extern "C" int netsdb_gemm_tf32x3(const void* p, long long ldp, int p_rmajor,
                                  const void* q, long long sk, long long sc,
                                  void* scratch, long long scratch_bytes,
                                  void* out, long long ldo, int trans_out,
                                  int rows, int cols, int k, void* stream) {
  using namespace netsdb_gemm;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int extent = p_rmajor ? rows : k;  // along P's contiguous dimension
  if (rows < 1 || cols < 1 || k < 1 || ldp < extent || ldp % 4 != 0 ||
      ldp > (1LL << 31) || reinterpret_cast<uintptr_t>(p) % 16 != 0 ||
      scratch_bytes < netsdb_gemm::scratch_bytes(cols, k))
    return static_cast<int>(cudaErrorInvalidValue);
  const int kp = round_up(k, kBK);
  float* qs = static_cast<float*>(scratch);
  split_q_kernel<<<dim3(kp / 32, (cols + 31) / 32), 256, 0, st>>>(
      static_cast<const float*>(q), sk, sc, k, cols, kp, p_rmajor, qs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  Params prm{};
  prm.out = static_cast<float*>(out);
  prm.ldo = ldo;
  prm.rows = rows;
  prm.cols = cols;
  prm.k = k;
  prm.n_ct = (cols + kBN - 1) / kBN;
  prm.trans_out = trans_out;
  const int ld = static_cast<int>(ldp);
  const bool ok =
      (p_rmajor ? netsdb_fold::make_map(&prm.tp, p, false, rows, ld, k, 1, 1,
                                        32, 32)
                : netsdb_fold::make_map(&prm.tp, p, false, k, ld, rows, 1, 1,
                                        kBK, kBM)) &&
      netsdb_fold::make_map(&prm.tq, qs, false, kp, kp, cols, 1, Smem::kParts,
                            kBK, kBN);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = p_rmajor ? gemm_kernel<true> : gemm_kernel<false>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Smem::bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>((rows + kBM - 1) / kBM) * prm.n_ct;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreads, Smem::bytes, st>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* netsdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
