// Flash-attention forward for NVIDIA Hopper (sm_90a), CUDA C++, on wgmma
// and TMA.
//
// Replaces: netsdb_tpu/ops/pallas_kernels.py:135 flash_attention (the
// Pallas TPU kernel _flash_kernel :114 and its fold _fold_block :45).
//
// Computes o = softmax(q k^T * scale [causal mask]) v for q, k, v, o of
// shape (B*H, S, D), row-major, f32 or bf16, D <= 128, never writing the
// S x S score matrix to device memory. The fold is flash_fold_wgmma.cuh's,
// shared with the ring step (flash_attention_step.cu) as the reference
// shares _fold_block: here with the carry started at (0, 0, NEG_INF) in
// registers and o = acc / max(l, 1e-30) written at the end. Products run
// on wgmma, fed by TMA from a producer warp: bf16 natively, f32 as
// three-pass TF32, which keeps f32's accuracy (the header's note).
//
// Bound at the transformer path's shape (causal, B 2, H 8, S 4096,
// D 128): 68.7 GFLOP. f32: 0.417 ms as three-pass TF32 on the H100 SXM's
// 495 TFLOP/s tensor cores (1.026 ms on its 67 TFLOP/s CUDA cores). bf16:
// 0.0695 ms at 989 TFLOP/s. 134 MB of q, k, v and o in f32 take 0.04 ms
// at 3.35 TB/s, and f32's split of K and V into scratch another 0.06 ms:
// compute-bound. The header says what the design does about it and what
// it leaves to later work.

#include "flash_fold_wgmma.cuh"

// Launches on `stream` and returns a cudaError_t (0 on success). q has
// rows of ld_q elements and k, v of ld_kv (>= d). TMA loads q, and in
// bf16 k and v too: those need 16-byte-aligned bases and rows of whole
// 16 bytes (the wrapper pads). f32 needs `scratch` of
// netsdb_fold::scratch_bytes(bh, s, d, 0) bytes for the split of k and v;
// bf16 none.
extern "C" int netsdb_flash_attention_fwd(const void* q, const void* k,
                                          const void* v, void* o,
                                          void* scratch,
                                          long long scratch_bytes, int bh,
                                          int s, int d, int ld_q, int ld_kv,
                                          float qscale, int causal,
                                          int is_bf16, void* stream) {
  netsdb_fold::Launch a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.scratch = scratch;
  a.scratch_bytes = scratch_bytes;
  a.bh = bh;
  a.s_q = s;
  a.s_k = s;
  a.d = d;
  a.ld_q = ld_q;
  a.ld_kv = ld_kv;
  a.qscale = qscale;
  a.causal = causal;
  return netsdb_fold::dispatch<false>(a, is_bf16,
                                      static_cast<cudaStream_t>(stream));
}

extern "C" const char* netsdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
