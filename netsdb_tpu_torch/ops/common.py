"""Shared op helpers: dtype policy and padding-mask maintenance.

Counterpart of ``netsdb_tpu/ops/common.py``. Invariant kept by every op
in this package: a ``BlockedTensor``'s padded margin is ZERO. Ops whose
elementwise function does not map 0 to 0 (sigmoid, exp, softmax)
re-mask their output; masked reductions use neutral fills.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
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


#: The smallest float32 product, in multiply-adds (m n k), that runs on
#: the three-pass TF32 kernel: on an H100, at 2^30 it lost to cuBLAS's
#: SGEMM on a skinny shape (65536 x 128 x 128), at 2^31 it took 0.59-0.94
#: of the SGEMM's time on every shape tried (PERF.md, the crossover).
TF32X3_MIN_MACS = 1 << 31


def _as_rows(a: torch.Tensor) -> Optional[torch.Tensor]:
    """``a`` (..., K) as one (rows, K) matrix without a copy, or None
    when its leading dimensions do not fold into one."""
    if a.dim() < 2:
        return None
    lead = [(n, s) for n, s in zip(a.shape[:-1], a.stride()[:-1]) if n != 1]
    if any(s0 != s1 * n1 for (_, s0), (n1, s1) in zip(lead, lead[1:])):
        return None
    return a.view(-1, a.shape[-1])


def tf32x3_route(a: torch.Tensor, b: torch.Tensor,
                 compute_dtype: Optional[str] = None,
                 out_dtype=torch.float32, matrix: bool = True
                 ) -> Optional[str]:
    """Where the product ``a @ b`` (a (..., K), b (K, N)) runs: None when
    the three-pass TF32 kernel (``cuda_kernels.gemm_tf32x3``) takes it,
    else why cuBLAS (or the CPU) keeps it. The kernel takes a product on
    an sm_90 card whose operands and output are float32 at full precision
    (``compute_dtype`` None), with no operand requiring grad under grad
    mode, that folds into one 2-D product with strides the kernel reads,
    of at least :data:`TF32X3_MIN_MACS` multiply-adds. ``matrix=False``
    says the operands are no such product (an einsum of another form).
    Counts the float32 full-precision products it routes on an sm_90 card
    in the registry: ``matmul.tf32x3`` those the kernel takes,
    ``matmul.cublas_f32`` those left on cuBLAS (a captured graph's replay
    repeats neither count)."""
    if not (on_sm90(a.device) and b.device == a.device):
        return "not on an sm_90 card"
    if compute_dtype is not None:
        return "reduced-precision compute"
    if not a.dtype == b.dtype == as_torch_dtype(out_dtype) == torch.float32:
        return "not float32"
    from netsdb_tpu_torch import obs
    from netsdb_tpu_torch.ops.cuda_kernels import gemm_layout

    rows = _as_rows(a)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        why = "an operand requires grad"
    elif not matrix or rows is None or b.dim() != 2 \
            or a.shape[-1] != b.shape[0]:
        why = "not one 2-D product"
    elif rows.shape[0] * a.shape[-1] * b.shape[1] < TF32X3_MIN_MACS:
        why = "below the crossover"
    elif gemm_layout(rows, b) is None:
        why = "strides the kernel does not read"
    else:
        obs.REGISTRY.counter("matmul.tf32x3").inc()
        return None
    obs.REGISTRY.counter("matmul.cublas_f32").inc()
    return why


def _tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` on the kernel, for a product :func:`tf32x3_route` took."""
    from netsdb_tpu_torch.ops.cuda_kernels import gemm_tf32x3

    out = gemm_tf32x3(_as_rows(a), b)
    return out.view(*a.shape[:-1], b.shape[1])


def mxu_dot(a: torch.Tensor, b: torch.Tensor,
            compute_dtype: Optional[str] = None,
            accum_dtype=torch.float32) -> torch.Tensor:
    """``a @ b`` contracting a's last dim with b's first, output in
    ``accum_dtype`` (f32 unless the caller overrides it).

    ``compute_dtype=None`` means full input-dtype accuracy: f32 inputs
    run as true f32 products, on the three-pass TF32 kernel where
    :func:`tf32x3_route` sends them. ``compute_dtype="bfloat16"`` is the
    reduced-precision opt-in: inputs are rounded to bf16 and the card
    accumulates in f32 inside the product."""
    accum = as_torch_dtype(accum_dtype) or torch.float32
    if compute_dtype is not None:
        cd = as_torch_dtype(compute_dtype)
        out = torch.matmul(a.to(cd), b.to(cd))
    else:
        full_f32_precision()
        out = (_tf32x3(a, b) if tf32x3_route(a, b, None, accum) is None
               else torch.matmul(a, b))
    return out.to(accum)


@functools.lru_cache(maxsize=None)
def _is_weight_product(eq: str) -> bool:
    """True for an equation ``<lead>k,kn-><lead>n``: the left operand's
    last dimension against a matrix (``bse,ef->bsf``)."""
    ins, _, out = eq.replace(" ", "").partition("->")
    left, _, right = ins.partition(",")
    return (len(right) == 2 and len(left) >= 2 and left[-1] == right[0]
            and out == left[:-1] + right[1]
            and len(set(left + right[1])) == len(left) + 1)


def hi_einsum(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` at full f32 precision (the reference's
    ``jnp.einsum(..., precision=HIGHEST)``); a product of the left
    operand's last dimension with a matrix runs on the three-pass TF32
    kernel where :func:`tf32x3_route` sends it."""
    full_f32_precision()
    if len(operands) == 2 and tf32x3_route(
            *operands, matrix=_is_weight_product(eq)) is None:
        return _tf32x3(*operands)
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
