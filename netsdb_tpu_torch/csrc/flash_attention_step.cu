// Ring-attention step for NVIDIA Hopper (sm_90a), CUDA C++, on the tensor
// cores: fold one arriving k/v chunk into a running flash-attention carry.
//
// Replaces: netsdb_tpu/ops/pallas_kernels.py:286 flash_attention_step
// (the Pallas TPU kernel _flash_carry_kernel :248 and its fold
// _fold_block :45).
//
// q is (B*H, s_q, D) and k, v are (B*H, s_k, D), row-major, contiguous,
// f32 or bf16, D <= 128. The carry is f32: acc (B*H, s_q, D) and l, m
// (B*H, s_q), in the exp2 domain. It is updated IN PLACE and never
// initialised or normalised here: the caller starts from (0, 0, NEG_INF)
// and finishes with acc / max(l, tiny). Positions are global: query row
// r sits at q_offset + r and key c at k_offset + c, so a ring position
// folds chunks from anywhere in the sequence; offsets need not be
// tile-aligned, nor s_q and s_k multiples of 64. q is pre-scaled by
// scale * log2(e) and rounded to the input type inside the kernel, as
// the reference's _prescale_q does before every step.
//
// The fold is flash_fold_mma.cuh's, shared with flash_attention.cu as the
// reference shares _fold_block, with the carry read into registers and
// written back: each block owns its 64 carry rows, so updating in place
// is race-free. A block whose query tile precedes the whole chunk
// returns before reading anything, and a row whose keys are all masked
// gets p = 0 and a correction of exactly 1, so both leave the carry
// bit-identical.
//
// Bound at chip_smoke.py's phase-2 chain (bh 16, four chunks of s 4096,
// D 128, causal, q at the last position: three past chunks and the
// diagonal one): 4*16*4096^2*128*3.5 = 481 GFLOP. f32: 7.18 ms on the
// H100 SXM's 67 TFLOP/s CUDA cores, 2.92 ms as three-pass TF32 on its
// 495 TFLOP/s tensor cores (the route this kernel takes); bf16 0.49 ms at
// 989 TFLOP/s. Bytes: q once, four k/v chunks, the carry read and
// written four times, about 0.6 GB or 0.17 ms at 3.35 TB/s:
// compute-bound. Left to later work, beyond the header's list: one read
// and one write of the f32 carry per step, which a kernel folding
// several chunks would keep in registers.

#include "flash_fold_mma.cuh"

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// The caller checks shapes, types and contiguity; d must be <= 128.
extern "C" int netsdb_flash_attention_step(const void* q, const void* k,
                                           const void* v, void* acc,
                                           void* l, void* m, int bh,
                                           int s_q, int s_k, int d,
                                           float qscale, int q_off,
                                           int k_off, int causal,
                                           int is_bf16, void* stream) {
  if (d < 1 || d > netsdb_fold::kMaxD || s_q < 1 || s_k < 1 || bh < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  netsdb_fold::FoldParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.acc = static_cast<float*>(acc);
  p.l = static_cast<float*>(l);
  p.m = static_cast<float*>(m);
  p.bh = bh;
  p.s_q = s_q;
  p.s_k = s_k;
  p.d = d;
  p.qscale = qscale;
  p.q_off = q_off;
  p.k_off = k_off;
  p.causal = causal;
  return netsdb_fold::dispatch<true>(p, is_bf16,
                                     static_cast<cudaStream_t>(stream));
}

extern "C" const char* netsdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
