// Ring-attention step for NVIDIA Hopper (sm_90a), CUDA C++: fold one
// arriving k/v chunk into a running flash-attention carry.
//
// Replaces: netsdb_tpu/ops/pallas_kernels.py::flash_attention_step (the
// Pallas TPU kernel _flash_carry_kernel and its shared fold _fold_block).
//
// q is (B*H, s_q, D) and k, v are (B*H, s_k, D), row-major, contiguous,
// f32 or bf16, D <= 128. The carry is f32: acc (B*H, s_q, D) and l, m
// (B*H, s_q), in the exp2 domain like the flash forward's. It is updated
// IN PLACE and never initialised or normalised here: the caller starts
// from (0, 0, NEG_INF) and finishes with acc / max(l, tiny). Positions are
// global: query row r sits at q_offset + r and key c at k_offset + c, so a
// ring position folds chunks from anywhere in the sequence. q is
// pre-scaled by scale * log2(e) and rounded to the input type inside the
// kernel, as the reference's _prescale_q does before every step.
//
// Design: the flash forward's (flash_attention.cu), with the carry read
// and written instead of initialised and normalised. One thread block per
// (b*h, 64-row query tile), 256 threads, each owning 4 query rows x 4 key
// columns of the score tile and 4 rows x 8 columns (strided by 16) of the
// accumulator; K and V tiles staged in shared memory. The reference shares
// one fold (_fold_block) between its two kernels; here the fold is B1's,
// repeated: the same fold moved into a shared header cost B1 16% at its
// path's shape (PERF.md), so B1's source stays as it was. A block loads
// its carry rows into registers, loops over the chunk's 64-key tiles and
// writes the rows back; no other block touches those rows, so updating
// in place is race-free. In causal mode a key tile wholly after the query
// tile's last position is skipped, and only tiles that cross the
// diagonal, or the ragged last tile, are masked; a masked logit
// contributes p = 0 exactly. A chunk wholly in the tile's future
// therefore exits before reading anything and leaves the carry
// bit-identical; so does any row whose keys are all masked. Offsets need
// not be tile-aligned, and s_q, s_k need not be multiples of 64.
//
// Bound at chip_smoke.py's phase-2 chain (bh 16, four chunks of s 4096,
// D 128, causal, q at the last position: three past chunks and the
// diagonal one): 4*16*4096^2*128*3.5 = 481 GFLOP, in f32 without TF32
// about 7.2 ms on the H100 SXM's 67 TFLOP/s CUDA cores (bf16 on the
// 989 TFLOP/s tensor cores would be 0.49 ms). Bytes: q once, four k/v
// chunks, the carry read and written four times, about 0.6 GB or
// 0.17 ms at 3.35 TB/s, so the fold is compute-bound.
//
// What this simple design leaves on the table: the same as the flash
// forward's (no tensor cores, so bf16 runs at the f32 CUDA-core rate; no
// TMA or cp.async overlap of the next tile's load with this tile's math;
// no warp specialisation), plus one read and one write of the f32 carry
// per step, which a fused multi-chunk kernel would keep in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBlockQ = 64;    // query rows per thread block
constexpr int kBlockK = 64;    // keys per tile
constexpr int kMaxD = 128;     // largest head dimension handled
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr int kAccCols = kMaxD / 16;
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Round a float to T's precision (identity for float).
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float row_max16(float x) {
  // the 16 lanes of a row group are lanes 0-15 or 16-31 of one warp
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_step_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, float* __restrict__ acc_g,
                  float* __restrict__ l_g, float* __restrict__ m_g, int s_q,
                  int s_k, int d, float qscale, int q_off, int k_off,
                  int causal, int n_qt) {
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x % n_qt);
  const int bh = static_cast<int>(blockIdx.x / n_qt);
  const int q0 = qt * kBlockQ;

  // causal: key tiles wholly past this tile's last query are skipped
  const int q_last = q_off + min(q0 + kBlockQ, s_q) - 1;
  int n_kt = (s_k + kBlockK - 1) / kBlockK;
  if (causal)
    n_kt = q_last < k_off ? 0 : min(n_kt, (q_last - k_off) / kBlockK + 1);
  if (n_kt == 0) return;  // the whole block's rows stay exactly as they are

  extern __shared__ float smem[];
  const int ld = d + 1;                 // padded row stride of Qs and Ks
  float* Qs = smem;                     // kBlockQ x ld
  float* Ks = Qs + kBlockQ * ld;        // kBlockK x ld
  float* Vs = Ks + kBlockK * ld;        // kBlockK x d
  float* Ps = Vs + kBlockK * d;         // kBlockQ x (kBlockK + 1)
  constexpr int ldp = kBlockK + 1;

  const int tid = threadIdx.x;
  const int rg = tid >> 4;  // owns query rows rg*4 .. rg*4+3
  const int cl = tid & 15;  // owns key / carry columns cl + 16*j
  const size_t rows = static_cast<size_t>(bh) * s_q;  // first carry row
  const size_t q_base = rows * d;
  const size_t k_base = static_cast<size_t>(bh) * s_k * d;

  // the query tile, pre-scaled by scale*log2(e) and rounded to T
  for (int i = tid; i < kBlockQ * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    const int row = q0 + r;
    const float x =
        row < s_q ? to_float(q[q_base + static_cast<size_t>(row) * d + c])
                  : 0.f;
    Qs[r * ld + c] = round_to<T>(x * qscale);
  }

  // this thread's carry rows
  float m[4], l[4], acc[4][kAccCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    const bool live = row < s_q;
    m[i] = live ? m_g[rows + row] : kNegInf;
    l[i] = live ? l_g[rows + row] : 0.f;
#pragma unroll
    for (int j = 0; j < kAccCols; ++j) {
      const int c = cl + 16 * j;
      acc[i][j] = live && c < d ? acc_g[(rows + row) * d + c] : 0.f;
    }
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // Qs written; last tile's readers of Ks/Vs/Ps done
    for (int i = tid; i < kBlockK * d; i += kThreads) {
      const int r = i / d, c = i - r * d;
      const int row = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (row < s_k) {
        const size_t g = k_base + static_cast<size_t>(row) * d + c;
        kx = to_float(k[g]);
        vx = to_float(v[g]);
      }
      Ks[r * ld + c] = kx;
      Vs[r * d + c] = vx;
    }
    __syncthreads();

    // scores of this thread's 4 x 4 patch, already in the exp2 domain
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < d; ++dd) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(rg * 4 + i) * ld + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(cl + 16 * j) * ld + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qa[i], kb[j], sc[i][j]);
    }

    // only tiles that cross the diagonal (causal) and the ragged last
    // tile mask; a masked logit contributes p = 0 below
    const bool masked = (causal && k_off + k0 + kBlockK - 1 > q_off + q0) ||
                        k0 + kBlockK > s_k;
    if (masked) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qp = q_off + q0 + rg * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kc = k0 + cl + 16 * j;
          if (kc >= s_k || (causal && k_off + kc > qp)) sc[i][j] = kNegInf;
        }
      }
    }

    // online softmax update of (m, l, acc); P goes to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(sc[i][0], sc[i][1]), fmaxf(sc[i][2], sc[i][3]));
      mx = row_max16(mx);
      const float m_new = fmaxf(m[i], mx);
      const float corr = exp2f(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // exp2(NEG_INF - m_new) is 0 once m_new is real; a row whose
        // carry is still empty needs the explicit 0
        const float p =
            masked && sc[i][j] <= kNegInf ? 0.f : exp2f(sc[i][j] - m_new);
        rs += p;
        Ps[(rg * 4 + i) * ldp + cl + 16 * j] = round_to<T>(p);
      }
      l[i] = l[i] * corr + row_sum16(rs);
#pragma unroll
      for (int j = 0; j < kAccCols; ++j) acc[i][j] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

    // acc += P . V over this tile's keys
#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ps[(rg * 4 + i) * ldp + kk];
#pragma unroll
      for (int j = 0; j < kAccCols; ++j) {
        const int c = cl + 16 * j;
        if (c < d) {
          const float vb = Vs[kk * d + c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pa[i], vb, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    if (row >= s_q) continue;
    if (cl == 0) {
      m_g[rows + row] = m[i];
      l_g[rows + row] = l[i];
    }
#pragma unroll
    for (int j = 0; j < kAccCols; ++j) {
      const int c = cl + 16 * j;
      if (c < d) acc_g[(rows + row) * d + c] = acc[i][j];
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* acc, void* l,
           void* m, int bh, int s_q, int s_k, int d, float qscale,
           int q_off, int k_off, int causal, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kBlockQ + kBlockK) * (d + 1) +
                       static_cast<size_t>(kBlockK) * d +
                       static_cast<size_t>(kBlockQ) * (kBlockK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_step_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (s_q + kBlockQ - 1) / kBlockQ;
  flash_step_kernel<T><<<dim3(static_cast<unsigned>(n_qt * bh)), kThreads,
                         smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(acc),
      static_cast<float*>(l), static_cast<float*>(m), s_q, s_k, d, qscale,
      q_off, k_off, causal, n_qt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// The caller checks shapes, types and contiguity; d must be <= 128.
extern "C" int netsdb_flash_attention_step(const void* q, const void* k,
                                           const void* v, void* acc,
                                           void* l, void* m, int bh,
                                           int s_q, int s_k, int d,
                                           float qscale, int q_off,
                                           int k_off, int causal,
                                           int is_bf16, void* stream) {
  if (d < 1 || d > kMaxD || s_q < 1 || s_k < 1 || bh < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(q, k, v, acc, l, m, bh, s_q, s_k,
                                         d, qscale, q_off, k_off, causal, st)
                 : launch<float>(q, k, v, acc, l, m, bh, s_q, s_k, d, qscale,
                                 q_off, k_off, causal, st);
}

extern "C" const char* netsdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
