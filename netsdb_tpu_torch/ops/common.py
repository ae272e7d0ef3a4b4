"""Shared op helpers: dtype policy and padding-mask maintenance.

Counterpart of ``netsdb_tpu/ops/common.py``. Invariant kept by every op
in this package: a ``BlockedTensor``'s padded margin is ZERO. Ops whose
elementwise function does not map 0 to 0 (sigmoid, exp, softmax)
re-mask their output; masked reductions use neutral fills.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Iterator, List, Optional

import torch

from netsdb_tpu_torch.core.blocked import BlockedTensor, as_torch_dtype


def on_sm90(device=None) -> bool:
    """True when ``device`` (default: the current CUDA device) is a
    Hopper card — the counterpart of the reference's ``on_tpu()``, which
    gates the hand-written kernels."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda" or not torch.cuda.is_available():
        return False
    return torch.cuda.get_device_capability(dev) == (9, 0)


_deferred: "contextvars.ContextVar[Optional[List[Callable[[], None]]]]" = \
    contextvars.ContextVar("netsdb_torch_deferred_checks", default=None)


def defer_check(check: Callable[[], None]) -> bool:
    """Hand a host-syncing validity check (``check()`` raises when the
    values it reads are bad) to the compiled program being built, which
    runs it after the program ran (and after every replay); True when it
    was deferred. Outside a program build this returns False and the
    caller runs ``check()`` at once. An op that defers must keep its own
    kernels in bounds for bad values (clamp), since they run before the
    check."""
    pending = _deferred.get()
    if pending is None:
        return False
    pending.append(check)
    return True


@contextlib.contextmanager
def deferring() -> Iterator[List[Callable[[], None]]]:
    """Collect the checks :func:`defer_check` is handed in this context."""
    pending: List[Callable[[], None]] = []
    token = _deferred.set(pending)
    try:
        yield pending
    finally:
        _deferred.reset(token)


def full_f32_precision() -> None:
    """Pin f32 matrix products to full f32 — TF32 off for cuBLAS and
    cuDNN, matmul precision "highest" — the reference's
    ``Precision.HIGHEST``. Called by every f32 product in this package,
    since these are process-wide switches a caller may have flipped."""
    if torch.get_float32_matmul_precision() != "highest":
        torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def mxu_dot(a: torch.Tensor, b: torch.Tensor,
            compute_dtype: Optional[str] = None,
            accum_dtype=torch.float32) -> torch.Tensor:
    """``a @ b`` contracting a's last dim with b's first, output in
    ``accum_dtype`` (f32 unless the caller overrides it).

    ``compute_dtype=None`` means full input-dtype accuracy: f32 inputs
    run as true f32 products. ``compute_dtype="bfloat16"`` is the
    reduced-precision opt-in: inputs are rounded to bf16 and the card
    accumulates in f32 inside the product."""
    accum = as_torch_dtype(accum_dtype) or torch.float32
    if compute_dtype is not None:
        cd = as_torch_dtype(compute_dtype)
        out = torch.matmul(a.to(cd), b.to(cd))
    else:
        full_f32_precision()
        out = torch.matmul(a, b)
    return out.to(accum)


def hi_einsum(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` at full f32 precision (the reference's
    ``jnp.einsum(..., precision=HIGHEST)``)."""
    full_f32_precision()
    return torch.einsum(eq, *operands)


def remask(t: BlockedTensor) -> BlockedTensor:
    """Zero the padded margin (needed after non-zero-preserving ops).
    Placed data is masked per position (``parallel/placed_ops``)."""
    if not t.meta.is_padded:
        return t
    from netsdb_tpu_torch.parallel import placed_ops

    return t.with_data(placed_ops.elementwise(
        torch.mul, t.data, t.mask(t.data.dtype), op="remask"))


def neutral_fill(t: BlockedTensor, fill: float) -> torch.Tensor:
    """Padded data with the margin replaced by ``fill`` (for max/softmax
    reductions where zero is not neutral)."""
    if not t.meta.is_padded:
        return t.data
    from netsdb_tpu_torch.parallel import placed_ops

    return placed_ops.elementwise(
        lambda d, m: torch.where(m, d, torch.full((), fill, dtype=d.dtype,
                                                  device=d.device)),
        t.data, t.mask(torch.bool), op="neutral_fill")
