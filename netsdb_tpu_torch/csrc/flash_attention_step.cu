// Ring-attention step for NVIDIA Hopper (sm_90a), CUDA C++, on wgmma and
// TMA: fold one arriving k/v chunk into a running flash-attention carry.
//
// Replaces: netsdb_tpu/ops/pallas_kernels.py:286 flash_attention_step
// (the Pallas TPU kernel _flash_carry_kernel :248 and its fold
// _fold_block :45).
//
// q is (B*H, s_q, D) and k, v are (B*H, s_k, D), row-major,
// f32 or bf16, D <= 128. The carry is f32: acc (B*H, s_q, D) and l, m
// (B*H, s_q), in the exp2 domain. It is updated IN PLACE and never
// initialised or normalised here: the caller starts from (0, 0, NEG_INF)
// and finishes with acc / max(l, tiny). Positions are global: query row
// r sits at q_offset + r and key c at k_offset + c, so a ring position
// folds chunks from anywhere in the sequence; offsets need not be
// tile-aligned, nor s_q and s_k multiples of the tiles. q is pre-scaled by
// scale * log2(e) and rounded to the input type inside the kernel, as
// the reference's _prescale_q does before every step.
//
// The fold is flash_fold_wgmma.cuh's, shared with flash_attention.cu as
// the reference shares _fold_block, with the carry read into registers
// and written back: each block owns its 128 carry rows, so updating in
// place is race-free. A block whose query tile precedes the whole chunk
// returns before reading anything (and a chunk wholly in the future gets
// no f32 split), and a row whose keys are all masked gets p = 0 and a
// correction of exactly 1, so both leave the carry bit-identical.
//
// Bound at chip_smoke.py's phase-2 chain (bh 16, four chunks of s 4096,
// D 128, causal, q at the last position: three past chunks and the
// diagonal one): 4*16*4096^2*128*3.5 = 481 GFLOP. f32: 2.92 ms as
// three-pass TF32 on the H100 SXM's 495 TFLOP/s tensor cores (7.18 ms on
// its 67 TFLOP/s CUDA cores); bf16 0.49 ms at 989 TFLOP/s. Bytes: q once,
// four k/v chunks, the carry read and written four times, about 0.6 GB
// or 0.17 ms at 3.35 TB/s, and f32's split of each chunk into scratch:
// compute-bound. Left to later work, beyond the header's list: one read
// and one write of the f32 carry per step, which a kernel folding
// several chunks would keep in registers.

#include "flash_fold_wgmma.cuh"

// Launches on `stream` and returns a cudaError_t (0 on success). q has
// rows of ld_q elements and k, v of ld_kv (>= d); the carry is
// contiguous. TMA loads q, and in bf16 k and v too: those need
// 16-byte-aligned bases and rows of whole 16 bytes (the wrapper pads).
// f32 needs `scratch` of netsdb_fold::scratch_bytes(bh, s_k, d, 0) bytes
// for the split of k and v; bf16 none.
extern "C" int netsdb_flash_attention_step(
    const void* q, const void* k, const void* v, void* acc, void* l, void* m,
    void* scratch, long long scratch_bytes, int bh, int s_q, int s_k, int d,
    int ld_q, int ld_kv, float qscale, int q_off, int k_off, int causal,
    int is_bf16, void* stream) {
  netsdb_fold::Launch a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.acc = static_cast<float*>(acc);
  a.l = static_cast<float*>(l);
  a.m = static_cast<float*>(m);
  a.scratch = scratch;
  a.scratch_bytes = scratch_bytes;
  a.bh = bh;
  a.s_q = s_q;
  a.s_k = s_k;
  a.d = d;
  a.ld_q = ld_q;
  a.ld_kv = ld_kv;
  a.qscale = qscale;
  a.q_off = q_off;
  a.k_off = k_off;
  a.causal = causal;
  return netsdb_fold::dispatch<true>(a, is_bf16,
                                     static_cast<cudaStream_t>(stream));
}

extern "C" const char* netsdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
