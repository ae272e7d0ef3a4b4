// Flash-attention forward for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces: netsdb_tpu/ops/pallas_kernels.py::flash_attention (the Pallas
// TPU kernel _flash_kernel and its shared fold _fold_block).
//
// Computes o = softmax(q k^T * scale [causal mask]) v for q, k, v, o of
// shape (B*H, S, D), row-major and contiguous, f32 or bf16, D <= 128. Like
// the reference it never writes the S x S score matrix to device memory:
// the online softmax keeps f32 running (m, l, acc) per query row in
// registers, in the exp2 domain, with q pre-scaled by scale * log2(e) and
// rounded to the input type before the product (the reference's
// _prescale_q). bf16 inputs are loaded as bf16, multiplied and summed in
// f32, and P is rounded to bf16 before the P.V product, as the reference
// does. f32 inputs run as f32 FMAs on the CUDA cores, never TF32.
//
// Design: one thread block per (b*h, 64-row query tile); a loop over
// 64-key tiles takes the place of the TPU's sequential k grid axis. K and
// V tiles are staged in shared memory (rows padded by one float so column
// reads do not collide on banks). 256 threads: each owns 4 query rows x 4
// key columns of the score tile and 4 rows x 8 columns (strided by 16) of
// the output accumulator; a row's max and sum are reduced across its 16
// threads with warp shuffles. In causal mode key tiles wholly above the
// diagonal are never visited and only the diagonal tile is masked; a
// ragged S is handled by masking keys past S and not storing query rows
// past S. Query tiles are scheduled heaviest first so causal blocks
// balance across the SMs.
//
// Bound at the transformer path's shape (causal, B=2, H=8, S=4096, D=128):
// 4*B*H*S*S*D/2 = 68.7 GFLOP. In f32 without TF32 that is bound by the
// FP32 CUDA cores: about 1.0 ms at the 67 TFLOP/s data-sheet rate of the
// H100 SXM (1.35 ms at 51 TFLOP/s for the PCIe card). In bf16 the tensor
// cores would bound it at about 0.07 ms (989 TFLOP/s). q, k, v and o are
// 134 MB in f32, about 0.04 ms at 3.35 TB/s, so the work is compute-bound.
//
// What this simple design leaves on the table: it issues no tensor-core
// instructions (no wgmma, so bf16 runs at the f32 CUDA-core rate), loads
// tiles with plain loads instead of TMA or cp.async (no overlap of the
// next tile's load with this tile's math), reads two shared-memory
// operands per two FMAs in the score product, and has no warp
// specialisation. Those are later work.

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

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
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
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int s, int d,
                 float qscale, int causal, int n_qt) {
  extern __shared__ float smem[];
  const int ld = d + 1;                 // padded row stride of Qs and Ks
  float* Qs = smem;                     // kBlockQ x ld
  float* Ks = Qs + kBlockQ * ld;        // kBlockK x ld
  float* Vs = Ks + kBlockK * ld;        // kBlockK x d
  float* Ps = Vs + kBlockK * d;         // kBlockQ x (kBlockK + 1)
  constexpr int ldp = kBlockK + 1;

  const int tid = threadIdx.x;
  const int rg = tid >> 4;  // owns query rows rg*4 .. rg*4+3
  const int cl = tid & 15;  // owns key / output columns cl + 16*j
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x % n_qt);
  const int bh = static_cast<int>(blockIdx.x / n_qt);
  const int q0 = qt * kBlockQ;
  const size_t base = static_cast<size_t>(bh) * s * d;

  // the query tile, pre-scaled by scale*log2(e) and rounded to T
  for (int i = tid; i < kBlockQ * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    const int row = q0 + r;
    const float x =
        row < s ? to_float(q[base + static_cast<size_t>(row) * d + c]) : 0.f;
    Qs[r * ld + c] = round_to<T>(x * qscale);
  }

  float m[4], l[4], acc[4][kAccCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kAccCols; ++j) acc[i][j] = 0.f;
  }

  // causal: keys past this tile's last query row are all masked
  const int k_end = causal ? min(s, q0 + kBlockQ) : s;
  const int n_kt = (k_end + kBlockK - 1) / kBlockK;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // Qs written; last tile's readers of Ks/Vs/Ps done
    for (int i = tid; i < kBlockK * d; i += kThreads) {
      const int r = i / d, c = i - r * d;
      const int row = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (row < s) {
        const size_t g = base + static_cast<size_t>(row) * d + c;
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

    // only the diagonal tile (causal) and the ragged last tile mask
    if ((causal && k0 + kBlockK - 1 > q0) || k0 + kBlockK > s) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qp = q0 + rg * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kp = k0 + cl + 16 * j;
          if (kp >= s || (causal && kp > qp)) sc[i][j] = kNegInf;
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
        const float p = exp2f(sc[i][j] - m_new);
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
    if (row >= s) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kAccCols; ++j) {
      const int c = cl + 16 * j;
      if (c < d) store(&o[base + static_cast<size_t>(row) * d + c],
                       acc[i][j] / den);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int s, int d, float qscale, int causal, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kBlockQ + kBlockK) * (d + 1) +
                       static_cast<size_t>(kBlockK) * d +
                       static_cast<size_t>(kBlockQ) * (kBlockK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (s + kBlockQ - 1) / kBlockQ;
  flash_fwd_kernel<T><<<dim3(static_cast<unsigned>(n_qt * bh)), kThreads,
                        smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s, d, qscale, causal,
      n_qt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// The caller checks shapes, types and contiguity; d must be <= 128.
extern "C" int netsdb_flash_attention_fwd(const void* q, const void* k,
                                          const void* v, void* o, int bh,
                                          int s, int d, float qscale,
                                          int causal, int is_bf16,
                                          void* stream) {
  if (d < 1 || d > kMaxD || s < 1 || bh < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(q, k, v, o, bh, s, d, qscale,
                                         causal, st)
                 : launch<float>(q, k, v, o, bh, s, d, qscale, causal, st);
}

extern "C" const char* netsdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
