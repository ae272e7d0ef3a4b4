"""Hand-written CUDA kernels and their plain PyTorch versions.

=========================  ==============================================
wrapper                    replaces (``netsdb_tpu/ops/pallas_kernels.py``)
=========================  ==============================================
``flash_attention``        ``flash_attention`` (B1),
                           source ``csrc/flash_attention.cu``
``flash_attention_step``   ``flash_attention_step`` (B2, the ring step),
                           source ``csrc/flash_attention_step.cu``
=========================  ==============================================

Both are built by :mod:`netsdb_tpu_torch.ops.cuda_build` and
instantiate one fold, ``csrc/flash_fold_mma.cuh``, as the reference's
two kernels share ``_fold_block``: B2's is B1's with the carry read and
written. The fold runs its products on the tensor cores (``mma.sync``):
bf16 natively, float32 as three-pass TF32, which keeps float32's
accuracy. On a CUDA tensor a wrapper
launches its kernel or raises; on a CPU tensor it runs its plain
version, which repeats the reference kernel's blocking and exp2-domain
online-softmax carry in plain PyTorch. Each wrapper counts its kernel
launches in ``<wrapper>.launches``; :func:`kernel_launches` is the
registry's ``kernels`` section of them.

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
from typing import Optional, Tuple

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
                        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                        + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]),
    "flash_attention_step": ("netsdb_flash_attention_step",
                             [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                             + [ctypes.c_float] + [ctypes.c_int] * 4
                             + [ctypes.c_void_p]),
}


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
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b * h, s, d, scale * _LOG2E, int(causal),
                int(q.dtype == torch.bfloat16), stream)
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
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), acc.data_ptr(),
                l.data_ptr(), m.data_ptr(), bh, s_q, k.shape[1], d,
                scale * _LOG2E, int(q_offset), int(k_offset), int(causal),
                int(q.dtype == torch.bfloat16), stream)
    _raise_on_error("flash_attention_step", rc, error_string)
    flash_attention_step.launches += 1
    return acc, l, m


flash_attention_step.launches = 0


def kernel_launches():
    """``{wrapper name: launches}`` — the registry's ``kernels`` section,
    so a daemon's launch counts reach its clients through COLLECT_STATS."""
    return {"flash_attention": flash_attention.launches,
            "flash_attention_step": flash_attention_step.launches}


def _register_collector() -> None:
    from netsdb_tpu_torch.obs import REGISTRY

    REGISTRY.register_collector("kernels", kernel_launches)


_register_collector()
