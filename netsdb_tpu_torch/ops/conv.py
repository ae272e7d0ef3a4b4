"""Conv2D — both reference execution modes; counterpart of
``netsdb_tpu/ops/conv.py``.

Mode 1, "UDF-encapsulated" (``src/conv2d_proj/headers/Conv2DSelect.h``):
one conv per tensor, here ``F.conv2d`` (cuDNN on the card). Mode 2,
"memory fusion" (``src/conv2d_memory_fusion``): conv as a matmul over
the patch matrix, here ``F.unfold`` and one product. Layouts: images
NCHW, kernels OIHW.

Three rules keep both modes equal to the reference:

- SAME padding under stride is asymmetric (``_pad_pair``), which
  ``F.conv2d`` and ``F.unfold`` cannot express, so both pad with
  ``F.pad`` first and convolve VALID;
- f32 runs with TF32 off in cuDNN and cuBLAS (``full_f32_precision``,
  the reference's ``Precision.HIGHEST``);
- ``compute_dtype="bfloat16"`` rounds the inputs to bf16 and returns f32.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from netsdb_tpu_torch.core.blocked import as_torch_dtype
from netsdb_tpu_torch.ops.common import full_f32_precision, mxu_dot

Padding = Union[str, Tuple[int, int]]


def _pad_pair(padding: Padding, k: int, in_size: int,
              stride: int) -> Tuple[int, int]:
    if padding == "SAME":
        # stride-aware SAME: output ceil(in/s) positions
        total = max((-(-in_size // stride) - 1) * stride + k - in_size, 0)
        return (total // 2, total - total // 2)
    if padding == "VALID":
        return (0, 0)
    return tuple(padding)


def _padded(images: torch.Tensor, kh: int, kw: int, stride,
            padding: Padding) -> torch.Tensor:
    ph = _pad_pair(padding, kh, images.shape[2], stride[0])
    pw = _pad_pair(padding, kw, images.shape[3], stride[1])
    if ph == (0, 0) and pw == (0, 0):
        return images
    return F.pad(images, (pw[0], pw[1], ph[0], ph[1]))


def activate(out: torch.Tensor, activation: Optional[str]) -> torch.Tensor:
    """``relu``, ``sigmoid`` or None (identity)."""
    if activation == "relu":
        return torch.relu(out)
    if activation == "sigmoid":
        return torch.sigmoid(out)
    return out


def conv2d_direct(images: torch.Tensor, kernels: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  stride: Tuple[int, int] = (1, 1),
                  padding: Padding = "VALID",
                  activation: Optional[str] = None,
                  compute_dtype: Optional[str] = None) -> torch.Tensor:
    """Reference mode 1 (``Conv2DSelect::computeConvOpATen``): images
    (N, C, H, W), kernels (O, I, KH, KW), bias (O,) → f32 (N, O, OH, OW)."""
    if compute_dtype is not None:
        cd = as_torch_dtype(compute_dtype)
        images, kernels = images.to(cd), kernels.to(cd)
    else:
        full_f32_precision()
    x = _padded(images, kernels.shape[2], kernels.shape[3], stride, padding)
    out = F.conv2d(x, kernels, stride=tuple(stride)).float()
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return activate(out, activation)


def im2col(images: torch.Tensor, kh: int, kw: int,
           stride: Tuple[int, int] = (1, 1), padding: Padding = "VALID"
           ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Patch matrix (N*OH*OW, C*KH*KW), feature order (C, KH, KW) — the
    ``ImageToChunks`` → ``ImageBlockToMatrix`` rewrite, as KH*KW strided
    slices stacked. Returns (matrix, (OH, OW))."""
    n, c = images.shape[:2]
    sh, sw = stride
    x = _padded(images, kh, kw, stride, padding)
    oh = (x.shape[2] - kh) // sh + 1
    ow = (x.shape[3] - kw) // sw + 1
    cols = torch.stack(
        [x[:, :, di:di + (oh - 1) * sh + 1:sh, dj:dj + (ow - 1) * sw + 1:sw]
         for di in range(kh) for dj in range(kw)],
        dim=2)  # (N, C, KH*KW, OH, OW)
    mat = cols.permute(0, 3, 4, 1, 2).reshape(n * oh * ow, c * kh * kw)
    return mat, (oh, ow)


def conv2d_im2col(images: torch.Tensor, kernels: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  stride: Tuple[int, int] = (1, 1),
                  padding: Padding = "VALID",
                  activation: Optional[str] = None,
                  block_shape: Tuple[int, int] = (256, 256),
                  compute_dtype: Optional[str] = None) -> torch.Tensor:
    """Reference mode 2: patches + one product + fold back to NCHW
    (``PipelinedConv2dMemFuseTest.cc:137-299`` as one function).
    ``F.unfold`` gives (N, C*KH*KW, OH*OW) in the feature order of the
    reference's ``conv_general_dilated_patches``, so the kernel matrix
    (O, C*KH*KW) contracts it straight into (N, O, OH*OW), with no
    permute. ``block_shape`` is accepted for symmetry with the staged
    pipeline, as in the reference: the contraction (C*KH*KW) is too
    short to block."""
    n = images.shape[0]
    o, i, kh, kw = kernels.shape
    kmat = kernels.reshape(o, i * kh * kw)
    if compute_dtype is not None:
        cd = as_torch_dtype(compute_dtype)
        images, kmat = images.to(cd), kmat.to(cd)
    x = _padded(images, kh, kw, stride, padding)
    oh = (x.shape[2] - kh) // stride[0] + 1
    ow = (x.shape[3] - kw) // stride[1] + 1
    patches = F.unfold(x, (kh, kw), stride=tuple(stride))
    out = mxu_dot(kmat, patches, compute_dtype)  # (N, O, OH*OW), f32
    if bias is not None:
        out = out + bias[None, :, None]
    return activate(out, activation).reshape(n, o, oh, ow)
