"""Hand-written CUDA kernels and their plain PyTorch versions.

=========================  ==============================================
wrapper                    replaces (``netsdb_tpu/ops/pallas_kernels.py``)
=========================  ==============================================
``flash_attention``        ``flash_attention`` (B1),
                           source ``csrc/flash_attention.cu``
``flash_attention_step``   ``flash_attention_step`` (B2, the ring step),
                           source ``csrc/flash_attention_step.cu``
``gemm_tf32x3``            none: the reference leaves its float32
                           products to XLA at ``Precision.HIGHEST``;
                           source ``csrc/gemm_tf32x3.cu``
=========================  ==============================================

All three are built by :mod:`netsdb_tpu_torch.ops.cuda_build`. The two
attention kernels instantiate one fold, ``csrc/flash_fold_wgmma.cuh``,
as the reference's two kernels share ``_fold_block``: B2's is B1's with
the carry read and written. The fold is compute-bound on this card and
is built for its tensor cores: a producer warp streams Q, K and V tiles
with TMA through a ring of stages guarded by mbarriers, and two consumer
warpgroups run the products on ``wgmma`` with S and the output held in
its register fragments. bf16 runs natively; float32 runs as three-pass
TF32, which keeps float32's accuracy, on K and V split once a launch
into scratch the wrapper allocates (:func:`split_scratch_bytes`). TMA
takes rows of whole 16 bytes from 16-byte-aligned bases: an operand
without them is copied, zero-padded, by :func:`tma_operand`. On a CUDA
tensor a wrapper launches its kernel or raises; on a CPU tensor it runs
its plain version, which repeats the reference kernel's blocking and
exp2-domain online-softmax carry in plain PyTorch. Each wrapper counts
its kernel launches in ``<wrapper>.launches``; :func:`kernel_launches`
is the registry's ``kernels`` section of them.

``gemm_tf32x3`` is a float32 matrix product as three-pass TF32 on the
same tensor cores, built from the fold's helpers: tf32 products of the
operands' parts (:func:`split_tf32`, and :func:`split_q_exact` for the
operand split once a launch) for each float32 one, which keeps float32's
accuracy where cuBLAS, with TF32 off, runs SIMT SGEMMs on the CUDA cores.
``ops.common.tf32x3_route`` decides which products take it.

Gradients: neither Pallas kernel of the reference has a backward (JAX
differentiates the attention it calls). :class:`FlashAttentionFunction`
is B1's autograd node: its forward is the wrapper (one launch on the
card), its backward recomputes :func:`flash_attention_plain` on the
saved q, k, v and differentiates that. B2 writes its carry in place and
refuses operands that require grad (the reference trains nothing
sequence-parallel).
"""

from __future__ import annotations

import ctypes
import functools
import math
import warnings
from typing import NamedTuple, Optional, Tuple

import torch

from netsdb_tpu_torch.ops.common import full_f32_precision, on_sm90

NEG_INF = -1e30
_LOG2E = 1.4426950408889634  # the softmax runs in the exp2 domain
_MAX_D = 128                 # the CUDA kernel's largest head dimension


def resolve_blocks(s: int, block_q: Optional[int],
                   block_k: Optional[int]) -> Tuple[int, int]:
    """The reference's block policy: 1024 by default, cut to
    gcd(block, S); an explicit block that gets cut warns, and a result
    under 8 raises ``ValueError``. The CUDA kernel tiles internally, but
    keeps these checks so both packages accept the same calls."""
    explicit_q, explicit_k = block_q is not None, block_k is not None
    block_q = block_q if explicit_q else 1024
    block_k = block_k if explicit_k else 1024
    gq, gk = math.gcd(min(block_q, s), s), math.gcd(min(block_k, s), s)
    changed = [f"block_q {block_q}->{gq}"] if explicit_q and gq != block_q else []
    if explicit_k and gk != block_k:
        changed.append(f"block_k {block_k}->{gk}")
    if changed:
        warnings.warn(
            f"flash_attention: explicitly requested block size does not "
            f"divide seq {s}; falling back ({', '.join(changed)})",
            stacklevel=3)
    if gq < 8 or gk < 8:
        raise ValueError(
            f"seq {s} shares no usable block size with requested blocks "
            f"(gcd gives {gq}, {gk}; need >= 8 sublanes)")
    return gq, gk


def _prescale_q(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q * (scale * log2 e) in f32 (f64 for f64), rounded back to q's
    dtype — the reference's ``_prescale_q``; bf16 rounds here, before the
    product."""
    wide = q if q.dtype == torch.float64 else q.float()
    return (wide * (scale * _LOG2E)).to(q.dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, scale: Optional[float] = None,
                          block_q: int = 1024,
                          block_k: int = 1024) -> torch.Tensor:
    """Plain PyTorch flash attention with the reference kernel's blocking:
    for each (q-block, k-block) pair the f32 carry (m, l, acc) folds the
    block in the exp2 domain; fully masked causal blocks are skipped and
    only diagonal blocks are masked. bf16 inputs multiply exactly in f32
    and round P to bf16 before P·V, as the reference does; float64 inputs
    keep a float64 carry (the gradient checks use them). Blocks must
    divide S (:func:`resolve_blocks` gives such blocks). Differentiable:
    B1's backward runs through it."""
    b, h, s, d = q.shape
    if s % block_q or s % block_k:
        raise ValueError(f"blocks ({block_q}, {block_k}) must divide seq {s}")
    scale = scale if scale is not None else d ** -0.5
    full_f32_precision()
    bh = b * h
    carry = torch.float64 if q.dtype == torch.float64 else torch.float32
    qf = _prescale_q(q.reshape(bh, s, d), scale).to(carry)
    kf = k.reshape(bh, s, d).to(carry)
    vf = v.reshape(bh, s, d).to(carry)
    round_p = v.dtype == torch.bfloat16
    dev = q.device
    out = torch.empty((bh, s, d), dtype=q.dtype, device=dev)
    for q_start in range(0, s, block_q):
        qb = qf[:, q_start:q_start + block_q]
        m = torch.full((bh, block_q, 1), NEG_INF, dtype=carry, device=dev)
        l = torch.zeros((bh, block_q, 1), dtype=carry, device=dev)
        acc = torch.zeros((bh, block_q, d), dtype=carry, device=dev)
        for k_start in range(0, s, block_k):
            if causal and q_start + block_q - 1 < k_start:
                break  # this and every later k-block is fully masked
            logits = qb @ kf[:, k_start:k_start + block_k].transpose(1, 2)
            if causal and q_start < k_start + block_k - 1:  # diagonal
                q_pos = q_start + torch.arange(block_q, device=dev)[:, None]
                k_pos = k_start + torch.arange(block_k, device=dev)[None, :]
                logits = torch.where(q_pos >= k_pos, logits,
                                     torch.full((), NEG_INF, device=dev))
            m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
            p = torch.exp2(logits - m_new)
            correction = torch.exp2(m - m_new)
            l = l * correction + p.sum(-1, keepdim=True)
            pv = p.to(torch.bfloat16).float() if round_p else p
            acc = acc * correction + pv @ vf[:, k_start:k_start + block_k]
            m = m_new
        out[:, q_start:q_start + block_q] = (
            acc / l.clamp_min(1e-30)).to(q.dtype)
    return out.reshape(b, h, s, d)


def _check_cuda_operands(q, k, v) -> None:
    if q.dim() != 4:
        raise ValueError(f"flash_attention wants (B, H, S, D); got {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != q shape "
                             f"{tuple(q.shape)}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if q.shape[-1] > _MAX_D:
        raise ValueError(f"flash_attention kernel takes head dim <= "
                         f"{_MAX_D}, got {q.shape[-1]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention kernel needs contiguous "
                             f"{name}")


# each library's entry point: (symbol, argtypes)
_ENTRY = {
    "flash_attention": ("netsdb_flash_attention_fwd",
                        [ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                        + [ctypes.c_int] * 5
                        + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]),
    "flash_attention_step": ("netsdb_flash_attention_step",
                             [ctypes.c_void_p] * 7 + [ctypes.c_longlong]
                             + [ctypes.c_int] * 6
                             + [ctypes.c_float] + [ctypes.c_int] * 4
                             + [ctypes.c_void_p]),
    "gemm_tf32x3": ("netsdb_gemm_tf32x3",
                    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                     ctypes.c_void_p, ctypes.c_longlong,
                     ctypes.c_void_p, ctypes.c_longlong]
                    + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
}


def tma_pitch(d: int, itemsize: int) -> int:
    """The row length, in elements, of an operand the kernels load with
    TMA: ``d`` rounded up to whole 16 bytes."""
    per = 16 // itemsize
    return -(-d // per) * per


def tma_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` (contiguous, rows of length ``t.shape[-1]``) as TMA takes it:
    itself when its rows are whole 16 bytes and it starts on a 16-byte
    boundary, else a copy whose last dimension is zero-padded to
    :func:`tma_pitch`."""
    d = t.shape[-1]
    ld = tma_pitch(d, t.element_size())
    if ld == d and t.data_ptr() % 16 == 0:
        return t
    out = t.new_zeros((*t.shape[:-1], ld))
    out[..., :d] = t
    return out


def split_scratch_bytes(bh: int, s_k: int, d: int) -> int:
    """Bytes of the float32 scratch a launch splits k and v into: the
    tf32 hi and lo of k (bh, s_k, dp) and of v transposed (bh, dp, s_kp),
    with dp and s_kp = d and s_k rounded up to 8 (the kernel's
    ``netsdb_fold::scratch_bytes``)."""
    dp, s_kp = -(-d // 8) * 8, -(-s_k // 8) * 8
    return 4 * 2 * bh * (s_k * dp + dp * s_kp)


def _kernel_operands(q, k, v):
    """(q, k, v, scratch) as the kernel takes them: q through
    :func:`tma_operand`, and k and v too in bf16 (with an empty scratch);
    float32 k and v are read by the split, which takes any row length,
    into a scratch of :func:`split_scratch_bytes`."""
    q = tma_operand(q)
    if k.dtype == torch.bfloat16:
        return (q, tma_operand(k), tma_operand(v),
                k.new_empty(0, dtype=torch.uint8))
    bh = k.numel() // (k.shape[-2] * k.shape[-1])
    scratch = torch.empty(split_scratch_bytes(bh, k.shape[-2], k.shape[-1]),
                          dtype=torch.uint8, device=k.device)
    return q, k, v, scratch


@functools.lru_cache(maxsize=None)
def _kernel(name: str):
    """The entry point of ``csrc/<name>.cu``, built and loaded on first
    use, with its library's error-string function."""
    from netsdb_tpu_torch.ops import cuda_build

    lib = cuda_build.load(name)
    symbol, argtypes = _ENTRY[name]
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    lib.netsdb_cuda_error_string.argtypes = [ctypes.c_int]
    lib.netsdb_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.netsdb_cuda_error_string


def _require_sm90(name: str, device: torch.device) -> None:
    if not on_sm90(device):
        raise RuntimeError(
            f"{name} kernel is built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(device)} is sm_"
            f"{''.join(map(str, torch.cuda.get_device_capability(device)))}")


def _raise_on_error(name: str, rc: int, error_string) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{error_string(rc).decode()} (cuda error {rc})")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None) -> torch.Tensor:
    """Fused attention: q/k/v (B, H, S, D) → (B, H, S, D) in q's dtype,
    never writing the (S, S) score matrix to device memory.

    CUDA tensors (float32 or bfloat16, contiguous, D <= 128, on an
    sm_90 card) run the hand-written kernel on the current stream, and
    any other CUDA operands raise; CPU tensors run
    :func:`flash_attention_plain`. Under grad mode, CUDA operands that
    require grad go through :class:`FlashAttentionFunction`, whose
    forward is this launch. ``flash_attention.launches`` counts kernel
    launches."""
    b, h, s, d = q.shape
    block_q, block_k = resolve_blocks(s, block_q, block_k)
    scale = scale if scale is not None else d ** -0.5
    if q.device.type == "cuda" and _needs_grad(q, k, v):
        return FlashAttentionFunction.apply(q, k, v, causal, scale,
                                            block_q, block_k)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, scale, block_q, block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    _check_cuda_operands(q, k, v)
    _require_sm90("flash_attention", q.device)
    fn, error_string = _kernel("flash_attention")
    out = torch.empty_like(q)
    qt, kt, vt, scratch = _kernel_operands(q, k, v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), out.data_ptr(),
                scratch.data_ptr(), scratch.numel(),
                b * h, s, d, qt.shape[-1], kt.shape[-1], scale * _LOG2E,
                int(causal), int(q.dtype == torch.bfloat16), stream)
    _raise_on_error("flash_attention", rc, error_string)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class FlashAttentionFunction(torch.autograd.Function):
    """B1 under autograd: ``apply(q, k, v, causal, scale, block_q,
    block_k)`` with the blocks :func:`resolve_blocks` gives.

    The forward is :func:`flash_attention` (one kernel launch on the card;
    the plain version on CPU tensors, which is how the CPU tests reach
    this node) and saves q, k and v. The backward recomputes
    :func:`flash_attention_plain` with the same blocks on detached copies
    and returns ``torch.autograd.grad`` of it: there is no backward
    kernel, so it costs the plain forward again and holds its per-block
    probabilities until the gradients are taken."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_q, block_k):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, scale, block_q, block_k)
        return flash_attention(q, k, v, causal, scale, block_q, block_k)

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in saved]
            out = flash_attention_plain(*leaves, *ctx.args)
            grads = torch.autograd.grad(out, leaves, grad_out)
        return (*grads, None, None, None, None)


# ------------------------------------------------------- ring-step kernel

def flash_attention_step_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, acc: torch.Tensor,
                               l: torch.Tensor, m: torch.Tensor,
                               q_offset: int, k_offset: int,
                               causal: bool = True,
                               scale: Optional[float] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Plain PyTorch ring step with the reference kernel's k blocking,
    gcd(1024, s_k): each k-block in order folds into the f32 carry in
    the exp2 domain, with global positions ``q_offset + row`` and
    ``k_offset + col``. Returns new (acc, l, m) and leaves its inputs
    alone. Rows are independent, so all query rows fold at once: a
    block that the reference skips as fully masked for a query block
    changes none of that block's rows here either, since a masked logit
    contributes p = 0 exactly. (The reference's masked logits give
    exp2(NEG_INF - NEG_INF) = 1 in a row whose carry is still empty; the
    ring never meets that case, and here such a row keeps its empty
    carry.) bf16 inputs multiply exactly in f32 and round P to bf16
    before P·V."""
    bh, s_q, d = q.shape
    s_k = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    full_f32_precision()
    block_k = math.gcd(1024, s_k)
    qf = _prescale_q(q, scale).float()
    kf, vf = k.float(), v.float()
    round_p = v.dtype == torch.bfloat16
    q_pos = q_offset + torch.arange(s_q, device=q.device)[:, None]
    for k_start in range(0, s_k, block_k):
        if causal and q_offset + s_q - 1 < k_offset + k_start:
            break  # this and every later block is masked for every row
        logits = qf @ kf[:, k_start:k_start + block_k].transpose(1, 2)
        if causal:
            k_pos = k_offset + k_start + torch.arange(
                block_k, device=q.device)[None, :]
            live = q_pos >= k_pos
            logits = torch.where(live, logits,
                                 torch.full((), NEG_INF, device=q.device))
        m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
        p = torch.exp2(logits - m_new)
        if causal:
            p = torch.where(live, p, torch.zeros((), device=q.device))
        correction = torch.exp2(m - m_new)
        l = l * correction + p.sum(-1, keepdim=True)
        pv = p.to(torch.bfloat16).float() if round_p else p
        acc = acc * correction + pv @ vf[:, k_start:k_start + block_k]
        m = m_new
    return acc, l, m


def _check_step_operands(q, k, v, acc, l, m) -> None:
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError(f"flash_attention_step wants q (bh, s_q, d) and "
                         f"k, v (bh, s_k, d); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    bh, s_q, d = q.shape
    if v.shape != k.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do "
                         f"not fit q {tuple(q.shape)}")
    for name, t, shape in (("acc", acc, (bh, s_q, d)),
                           ("l", l, (bh, s_q, 1)), ("m", m, (bh, s_q, 1))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"carry {name} must be float32 {shape}; got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")


def flash_attention_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         acc: torch.Tensor, l: torch.Tensor, m: torch.Tensor,
                         q_offset: int, k_offset: int, causal: bool = True,
                         scale: Optional[float] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Fold one k/v chunk into a running flash-attention carry — the
    ring-attention step.

    q (bh, s_q, d); k, v (bh, s_k, d); the carry acc (bh, s_q, d) and
    l, m (bh, s_q, 1) is float32, starts at (0, 0, NEG_INF) and is
    finished with ``acc / max(l, 1e-30)`` after the last chunk.
    ``q_offset`` and ``k_offset`` are the global positions of the first
    query row and the first key. The carry is CONSUMED: it is updated in
    place and returned; q, k and v are only read.

    CUDA tensors (q, k, v float32 or bfloat16, everything contiguous,
    d <= 128, on an sm_90 card) run the hand-written kernel on the
    current stream, and any other CUDA operands raise; CPU tensors run
    :func:`flash_attention_step_plain`. ``flash_attention_step.launches``
    counts kernel launches. Operands that require grad under grad mode
    raise ``RuntimeError``: the carry is written in place, and this step
    has no autograd node (sequence-parallel training, ROADMAP.md A4 part 3)."""
    if _needs_grad(q, k, v, acc, l, m):
        raise RuntimeError(
            "flash_attention_step (B2) writes its carry in place and has "
            "no autograd node; sequence-parallel training is not ported "
            "(ROADMAP.md A4 part 3)")
    _check_step_operands(q, k, v, acc, l, m)
    bh, s_q, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    if q.device.type == "cpu":
        new = flash_attention_step_plain(q, k, v, acc, l, m, q_offset,
                                         k_offset, causal, scale)
        for carry, value in zip((acc, l, m), new):
            carry.copy_(value)
        return acc, l, m
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_step runs on cuda or cpu, not "
                         f"{q.device}")
    for name, t in (("k", k), ("v", v), ("acc", acc), ("l", l), ("m", m)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v), ("acc", acc), ("l", l),
                    ("m", m)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_step kernel needs "
                             f"contiguous {name}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention_step kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    if d > _MAX_D:
        raise ValueError(f"flash_attention_step kernel takes head dim <= "
                         f"{_MAX_D}, got {d}")
    _require_sm90("flash_attention_step", q.device)
    fn, error_string = _kernel("flash_attention_step")
    qt, kt, vt, scratch = _kernel_operands(q, k, v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), acc.data_ptr(),
                l.data_ptr(), m.data_ptr(),
                scratch.data_ptr(), scratch.numel(),
                bh, s_q, k.shape[1], d, qt.shape[-1], kt.shape[-1],
                scale * _LOG2E, int(q_offset), int(k_offset), int(causal),
                int(q.dtype == torch.bfloat16), stream)
    _raise_on_error("flash_attention_step", rc, error_string)
    flash_attention_step.launches += 1
    return acc, l, m


flash_attention_step.launches = 0


# ------------------------------------------------ float32 matrix product

def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of float32 ``x``, bit for bit as the kernels' ``split_tf32``
    (``csrc/flash_fold_wgmma.cuh``): hi is x rounded to tf32, to nearest
    with ties away from zero as ``cvt.rna`` rounds (half of the 13 dropped
    mantissa bits added, then cleared), and lo = x - hi, exact in f32."""
    hi = ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    return hi, x - hi


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """Float32 ``x`` as the tensor core reads an f32 register as tf32: its
    13 low mantissa bits dropped."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def split_q_exact(x: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(hi, mid, lo2) of float32 ``x``: three tf32 values that sum to x
    exactly, bit for bit as ``csrc/gemm_tf32x3.cu``'s ``split_q_exact``.
    hi is :func:`split_tf32`'s, or x cut to tf32 where rounding would
    carry it into the next binade, so that hi keeps x's exponent; mid and
    lo2 are :func:`split_tf32` of the remainder x - hi."""
    hi, _ = split_tf32(x)
    carried = ((hi.view(torch.int32) ^ x.view(torch.int32))
               & 0x7F800000) != 0
    hi = torch.where(carried, tf32_truncate(x), hi)
    mid, lo2 = split_tf32(x - hi)
    return hi, mid, lo2


def gemm_tf32x3_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for float32 a (m, k) and b (k, n) as the kernel computes
    it: the operand the kernel splits once (Q, the smaller, as
    :func:`gemm_layout` picks it) into hi + mid + lo2 by
    :func:`split_q_exact`, the other (P) into hi + lo by
    :func:`split_tf32` with lo read as tf32 (:func:`tf32_truncate`); then
    lo·hi + hi·lo2 + hi·mid + hi·hi, the small terms first, each product
    in float32 with TF32 off. The kernel adds in another order, in 32-deep
    chains, so the two agree to float32 rounding, not bit for bit."""
    full_f32_precision()
    q_left = b.numel() > a.numel()
    p_hi, p_lo = split_tf32(b if q_left else a)
    q_hi, q_mid, q_lo2 = split_q_exact(a if q_left else b)

    def mul(p, q):
        return q @ p if q_left else p @ q

    small = (mul(tf32_truncate(p_lo), q_hi) + mul(p_hi, q_lo2)
             + mul(p_hi, q_mid))
    return small + mul(p_hi, q_hi)


class GemmLayout(NamedTuple):
    """How the kernel takes C = a @ b: it computes D = P Q, with Q the
    smaller operand (split into scratch by its pre-pass, read at any
    strides) and P the other, read as it lies by TMA: K-major (element
    (r, k) at ``p + r ldp + k``) or R-major (``p + k ldp + r``). When Q is
    a, P is bᵀ and D = Cᵀ, stored transposed."""
    p: torch.Tensor       # the operand P is a view of
    ldp: int
    p_rmajor: bool
    q: torch.Tensor       # the operand Q is a view of
    q_strides: Tuple[int, int]  # Q's element (k, c) at k sk + c sc
    transposed: bool
    rows: int             # R
    cols: int             # C


def gemm_layout(a: torch.Tensor, b: torch.Tensor) -> Optional[GemmLayout]:
    """The kernel's :class:`GemmLayout` for 2-D ``a @ b``, or None when the
    operand read by TMA has no unit stride, a row pitch that is no whole
    16 bytes, or a base off a 16-byte boundary."""
    (m, k), n = a.shape, b.shape[1]
    transposed = b.numel() > a.numel()
    if transposed:
        p, (p_ks, p_rs), q, qs, rows, cols = (
            b, b.stride(), a, a.stride()[::-1], n, m)
    else:
        p, (p_rs, p_ks), q, qs, rows, cols = (
            a, a.stride(), b, b.stride(), m, n)
    if p.data_ptr() % 16:
        return None
    if p_ks == 1 and p_rs % 4 == 0 and p_rs >= k:
        ldp, rmajor = p_rs, False
    elif p_rs == 1 and p_ks % 4 == 0 and p_ks >= rows:
        ldp, rmajor = p_ks, True
    else:
        return None
    return GemmLayout(p, ldp, rmajor, q, tuple(qs), transposed, rows, cols)


def gemm_scratch_bytes(cols: int, k: int) -> int:
    """Bytes of the float32 scratch Q is split into: hi, mid and lo2,
    (cols, k rounded up to 32) each (the kernel's
    ``netsdb_gemm::scratch_bytes``)."""
    return 4 * 3 * cols * (-(-k // 32) * 32)


def gemm_tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = a @ b for float32 a (m, k) and b (k, n), as three-pass TF32.

    CUDA tensors on an sm_90 card run the hand-written kernel on the
    current stream: a pre-pass splits the smaller operand into scratch of
    :func:`gemm_scratch_bytes` (freed when this returns), then the GEMM
    reads the other as it lies (:func:`gemm_layout`; other strides
    raise). CPU tensors run :func:`gemm_tf32x3_plain`. Operands that
    require grad under grad mode raise on the card: the kernel has no
    autograd node. ``gemm_tf32x3.launches`` counts kernel launches (the
    pre-pass and the GEMM of one product count once)."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm_tf32x3 wants a (m, k) and b (k, n); got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"gemm_tf32x3 takes float32, got {a.dtype} and "
                        f"{b.dtype}")
    if b.device != a.device:
        raise ValueError(f"b on {b.device}, a on {a.device}")
    if a.device.type == "cpu":
        return gemm_tf32x3_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"gemm_tf32x3 runs on cuda or cpu, not {a.device}")
    if _needs_grad(a, b):
        raise RuntimeError("gemm_tf32x3 has no autograd node; products "
                           "that require grad stay on cuBLAS")
    _require_sm90("gemm_tf32x3", a.device)
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if not (m and n and k):
        return out.zero_()
    lay = gemm_layout(a, b)
    if lay is None:
        raise ValueError(
            f"gemm_tf32x3 reads its larger operand with TMA, which needs a "
            f"unit stride, a row pitch of whole 16 bytes and a 16-byte-"
            f"aligned base; got a {tuple(a.shape)} strides {a.stride()}, "
            f"b {tuple(b.shape)} strides {b.stride()}")
    fn, error_string = _kernel("gemm_tf32x3")
    scratch = torch.empty(gemm_scratch_bytes(lay.cols, k) // 4,
                          dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(lay.p.data_ptr(), lay.ldp, int(lay.p_rmajor),
                lay.q.data_ptr(), *lay.q_strides,
                scratch.data_ptr(), 4 * scratch.numel(),
                out.data_ptr(), n, int(lay.transposed),
                lay.rows, lay.cols, k, stream)
    _raise_on_error("gemm_tf32x3", rc, error_string)
    gemm_tf32x3.launches += 1
    return out


gemm_tf32x3.launches = 0


def kernel_launches():
    """``{wrapper name: launches}`` — the registry's ``kernels`` section,
    so a daemon's launch counts reach its clients through COLLECT_STATS."""
    return {"flash_attention": flash_attention.launches,
            "flash_attention_step": flash_attention_step.launches,
            "gemm_tf32x3": gemm_tf32x3.launches}


def _register_collector() -> None:
    from netsdb_tpu_torch.obs import REGISTRY

    REGISTRY.register_collector("kernels", kernel_launches)


_register_collector()
