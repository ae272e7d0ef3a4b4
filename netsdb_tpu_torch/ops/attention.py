"""Attention ops — counterpart of ``netsdb_tpu/ops/attention.py``.

Layouts follow the reference: q/k/v are (batch, heads, seq, head_dim),
B H S D; a packed projection is (B, S, 3E). The fused kernel is
:func:`netsdb_tpu_torch.ops.cuda_kernels.flash_attention`.
"""

from __future__ import annotations

from typing import Optional

import torch

from netsdb_tpu_torch.ops.common import full_f32_precision, hi_einsum
from netsdb_tpu_torch.ops.cuda_kernels import flash_attention

NEG_INF = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True,
              scale: Optional[float] = None) -> torch.Tensor:
    """Plain softmax attention (the formulation the others must match)."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    logits = hi_einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        s_q, s_k = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((s_q, s_k), dtype=torch.bool,
                          device=q.device).tril(diagonal=s_k - s_q)
        logits = torch.where(mask, logits,
                             torch.full((), NEG_INF, dtype=logits.dtype,
                                        device=q.device))
    probs = torch.softmax(logits, dim=-1)
    return hi_einsum("bhqk,bhkd->bhqd", probs, v)


def _block_attn(q, k, v, carry_num, carry_den, carry_max, mask):
    """One online-softmax step of the naive ring fold: combine the
    running (num, den, max) with a new k/v block. Natural ``exp``; q
    arrives pre-multiplied by the softmax scale."""
    logits = hi_einsum("bhqd,bhkd->bhqk", q, k)
    logits = torch.where(mask, logits,
                         torch.full((), NEG_INF, dtype=logits.dtype,
                                    device=logits.device))
    new_max = torch.maximum(carry_max, logits.amax(-1, keepdim=True))
    correction = torch.exp(carry_max - new_max)
    p = torch.exp(logits - new_max)
    new_den = carry_den * correction + p.sum(-1, keepdim=True)
    new_num = carry_num * correction + hi_einsum("bhqk,bhkd->bhqd", p, v)
    return new_num, new_den, new_max


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        block_size: int, causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Attention with k/v taken in blocks through the online softmax —
    O(block) memory in the sequence dim."""
    b, h, s, d = q.shape
    if s % block_size != 0:
        raise ValueError(f"seq {s} not divisible by block {block_size}")
    scale = scale if scale is not None else d ** -0.5
    full_f32_precision()
    q = q * scale
    num = torch.zeros_like(q)
    den = torch.zeros((b, h, s, 1), dtype=q.dtype, device=q.device)
    mx = torch.full((b, h, s, 1), NEG_INF, dtype=q.dtype, device=q.device)
    q_pos = torch.arange(s, device=q.device)[:, None]
    for start in range(0, s, block_size):
        k_i = k[:, :, start:start + block_size]
        v_i = v[:, :, start:start + block_size]
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k_i)
        if causal:
            k_pos = start + torch.arange(block_size, device=q.device)[None, :]
            logits = torch.where(q_pos >= k_pos, logits,
                                 torch.full((), NEG_INF, dtype=logits.dtype,
                                            device=q.device))
        new_max = torch.maximum(mx, logits.amax(-1, keepdim=True))
        correction = torch.exp(mx - new_max)
        p = torch.exp(logits - new_max)
        den = den * correction + p.sum(-1, keepdim=True)
        num = num * correction + torch.einsum("bhqk,bhkd->bhqd", p, v_i)
        mx = new_max
    return num / den.clamp_min(1e-30)


def split_qkv_heads(qkv: torch.Tensor, num_heads: int):
    """Packed (B,S,3E) projection → q/k/v (B,H,S,D): split into thirds,
    then the head reshape/transpose — the reference's layout."""
    b, s, f = qkv.shape
    d = f // 3 // num_heads

    def heads(t):
        return t.reshape(b, s, num_heads, d).transpose(1, 2)

    q, k, v = qkv.chunk(3, dim=-1)
    return heads(q), heads(k), heads(v)


def merge_heads(out: torch.Tensor) -> torch.Tensor:
    """(B,H,S,D) → (B,S,E), the inverse of :func:`split_qkv_heads`."""
    b, h, s, d = out.shape
    return out.transpose(1, 2).reshape(b, s, h * d)


def qkv_project(x: torch.Tensor, w_qkv: torch.Tensor, num_heads: int):
    """x (B,S,E) → q/k/v (B,H,S,D)."""
    return split_qkv_heads(hi_einsum("bse,ef->bsf", x, w_qkv), num_heads)


def merge_project(out: torch.Tensor, w_out: torch.Tensor) -> torch.Tensor:
    """(B,H,S,D) attention output → (B,S,E) through the out projection."""
    return hi_einsum("bse,ef->bsf", merge_heads(out), w_out)


def auto_impl(device: torch.device, block_size: Optional[int]) -> str:
    """The implementation ``attention_dispatch`` picks when none is
    asked for. CUDA tensors always take 'flash', the hand-written kernel,
    which masks a ragged sequence itself and raises on operands or a card
    it cannot take; the reference's extra rule (a whole number of
    256-blocks) is its TPU's tiling limit and does not apply here. CPU
    tensors take 'blockwise' when a block_size is given, else 'full', as
    the reference does off its TPU."""
    if device.type == "cuda":
        return "flash"
    return "blockwise" if block_size else "full"


def attention_dispatch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool = True, scale: Optional[float] = None,
                       impl: Optional[str] = None,
                       block_size: Optional[int] = None) -> torch.Tensor:
    """Run 'full', 'blockwise' or 'flash' (the CUDA kernel) attention;
    ``impl=None`` picks one with :func:`auto_impl`. Under grad mode,
    CUDA operands that require grad reach the kernel through its
    autograd node (``cuda_kernels.FlashAttentionFunction``); every other
    call launches it as it is."""
    s = q.shape[2]
    if impl is None:
        impl = auto_impl(q.device, block_size)
    if impl == "flash":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if block_size:
            return flash_attention(q, k, v, causal=causal, scale=scale,
                                   block_q=block_size, block_k=block_size)
        return flash_attention(q, k, v, causal=causal, scale=scale)
    if impl == "blockwise":
        return blockwise_attention(q, k, v, block_size or min(256, s),
                                   causal, scale)
    if impl == "full":
        return attention(q, k, v, causal, scale)
    raise ValueError(f"unknown attention impl {impl!r}")


def mha_forward(x: torch.Tensor, w_qkv: torch.Tensor, w_out: torch.Tensor,
                num_heads: int, causal: bool = True,
                block_size: Optional[int] = None,
                impl: Optional[str] = None) -> torch.Tensor:
    """Multi-head attention layer: x (B,S,E), w_qkv (E,3E), w_out (E,E)."""
    q, k, v = qkv_project(x, w_qkv, num_heads)
    out = attention_dispatch(q, k, v, causal=causal, impl=impl,
                             block_size=block_size)
    return merge_project(out, w_out)
