"""The precisions the references run in.

``"f64"`` is the reference proper. ``"f32"`` is float32 with TF32 off,
the precision the configurations state. ``"tf32"`` is the control: the
same products with TF32 on, the next precision below. On a CUDA card it
is cuBLAS's own TF32; on the CPU, which has none, each operand of a
product is rounded to TF32's 10-bit mantissa before an f32 product.
"""

from __future__ import annotations

import contextlib

import torch

MODES = ("f64", "f32", "tf32")


def check_mode(mode: str) -> str:
    if mode not in MODES:
        raise ValueError(f"precision mode must be one of {MODES}, got "
                         f"{mode!r}")
    return mode


def dtype_of(mode: str) -> torch.dtype:
    return torch.float64 if check_mode(mode) == "f64" else torch.float32


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to the nearest TF32 value: 10 mantissa
    bits, ties away from zero, as the tensor cores' conversion does."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


@contextlib.contextmanager
def products(mode: str):
    """Sets the process's float32 product switches for ``mode`` and
    restores them on exit."""
    check_mode(mode)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    tf32 = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def mm(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """``a @ b`` in ``mode`` (call inside :func:`products`)."""
    if mode == "tf32" and a.device.type == "cpu":
        return round_tf32(a) @ round_tf32(b)
    return a @ b
