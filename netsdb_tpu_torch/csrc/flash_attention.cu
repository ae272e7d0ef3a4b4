// Flash-attention forward for NVIDIA Hopper (sm_90a), CUDA C++, on the
// tensor cores.
//
// Replaces: netsdb_tpu/ops/pallas_kernels.py:135 flash_attention (the
// Pallas TPU kernel _flash_kernel :114 and its fold _fold_block :45).
//
// Computes o = softmax(q k^T * scale [causal mask]) v for q, k, v, o of
// shape (B*H, S, D), row-major and contiguous, f32 or bf16, D <= 128,
// never writing the S x S score matrix to device memory. The fold is
// flash_fold_mma.cuh's, shared with the ring step (flash_attention_step.cu)
// as the reference shares _fold_block: here with the carry started at
// (0, 0, NEG_INF) in registers and o = acc / max(l, 1e-30) written at the
// end. Products run on the tensor cores through mma.sync: bf16 natively,
// f32 as three-pass TF32, which keeps f32's accuracy (the header's note).
//
// Bound at the transformer path's shape (causal, B 2, H 8, S 4096,
// D 128): 68.7 GFLOP. f32: 1.026 ms on the H100 SXM's 67 TFLOP/s CUDA
// cores, 0.416 ms as three-pass TF32 on its 495 TFLOP/s tensor cores
// (the route this kernel takes). bf16: 0.0695 ms at 989 TFLOP/s. 134 MB
// of q, k, v and o in f32 take 0.04 ms at 3.35 TB/s: compute-bound.
// What the design leaves to later work is in the header's note.

#include "flash_fold_mma.cuh"

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// The caller checks shapes, types and contiguity; d must be <= 128.
extern "C" int netsdb_flash_attention_fwd(const void* q, const void* k,
                                          const void* v, void* o, int bh,
                                          int s, int d, float qscale,
                                          int causal, int is_bf16,
                                          void* stream) {
  if (d < 1 || d > netsdb_fold::kMaxD || s < 1 || bh < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  netsdb_fold::FoldParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.bh = bh;
  p.s_q = s;
  p.s_k = s;
  p.d = d;
  p.qscale = qscale;
  p.causal = causal;
  return netsdb_fold::dispatch<false>(p, is_bf16,
                                      static_cast<cudaStream_t>(stream));
}

extern "C" const char* netsdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
