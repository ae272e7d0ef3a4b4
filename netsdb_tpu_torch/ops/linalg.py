"""The linear-algebra op set of the LA DSL — counterpart of
``netsdb_tpu/ops/linalg.py``.

One function per ``LASilly*`` UDF of the reference and per PDML
production:

    + - * '* %*% ^T ^-1  max min rowMax rowMin rowSum colMax colMin colSum
    duplicateRow duplicateCol  zeros ones identity

In the reference each op is a join or an aggregation over blocks; here
each is one torch op on the padded tensor, masked where zero padding is
not neutral (max and min fill the margin with ∓inf, and rows or columns
that are all padding read 0 again). Every f32 product and the inverse run
with TF32 off. The constructors (``identity``, ``zeros``, ``ones``) put
their tensor on ``device``: CUDA unless the caller asks for another, and
an error where there is no card.
"""

from __future__ import annotations

import torch

from netsdb_tpu_torch.config import resolve_device
from netsdb_tpu_torch.core.blocked import BlockMeta, BlockedTensor
from netsdb_tpu_torch.ops.common import (defer_check, full_f32_precision,
                                        neutral_fill)
# re-exported: the DSL's products
from netsdb_tpu_torch.ops.matmul import matmul, matmul_t, t_matmul  # noqa: F401


def _aligned(a: BlockedTensor, b: BlockedTensor) -> None:
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    if a.meta.block_shape != b.meta.block_shape:
        raise ValueError(f"block mismatch {a.meta.block_shape} vs "
                         f"{b.meta.block_shape}; reblock first")


def add(a: BlockedTensor, b: BlockedTensor) -> BlockedTensor:
    """A + B — ref ``LASillyAddJoin.h``."""
    _aligned(a, b)
    return a.with_data(a.data + b.data)


def subtract(a: BlockedTensor, b: BlockedTensor) -> BlockedTensor:
    """A - B — ref ``LASillySubstractJoin.h``."""
    _aligned(a, b)
    return a.with_data(a.data - b.data)


def scale_multiply(a: BlockedTensor, b: BlockedTensor) -> BlockedTensor:
    """Elementwise A * B (the DSL's ``*``) — ref
    ``LASillyScaleMultiplyJoin.h``."""
    _aligned(a, b)
    return a.with_data(a.data * b.data)


def scalar_multiply(a: BlockedTensor, s: float) -> BlockedTensor:
    return a.with_data(a.data * s)


def transpose(a: BlockedTensor) -> BlockedTensor:
    """Aᵀ — ref ``LASillyTransposeSelection.h`` (swaps block indices).
    The data is a transposed view: the margin stays zero and a product
    that transposes it back reads the original memory."""
    meta = BlockMeta(a.shape[::-1], a.meta.block_shape[::-1])
    return BlockedTensor(a.data.t(), meta)


def max_element(a: BlockedTensor) -> torch.Tensor:
    """Global max, a 0-d tensor — ref ``LASillyMaxElementAggregate.h``."""
    return neutral_fill(a, float("-inf")).amax()


def min_element(a: BlockedTensor) -> torch.Tensor:
    """Global min — ref ``LASillyMinElementAggregate.h``."""
    return neutral_fill(a, float("inf")).amin()


def _reduce(a: BlockedTensor, fn, fill: float, dim: int) -> BlockedTensor:
    """``fn`` along ``dim`` over the data with the margin set to ``fill``;
    the result's pure-padding entries read 0 (the margin invariant)."""
    data = neutral_fill(a, fill) if fill != 0.0 else a.data
    r = fn(data, dim=dim, keepdim=True)
    keep = 1 - dim  # the axis that survives
    if a.meta.is_padded:
        live = torch.arange(a.meta.padded_shape[keep],
                            device=r.device) < a.shape[keep]
        r = torch.where(live.reshape(r.shape), r,
                        torch.zeros((), dtype=r.dtype, device=r.device))
    shape, block = [1, 1], [1, 1]
    shape[keep], block[keep] = a.shape[keep], a.meta.block_shape[keep]
    return BlockedTensor(r.to(a.data.dtype), BlockMeta(tuple(shape),
                                                       tuple(block)))


def row_max(a: BlockedTensor) -> BlockedTensor:
    """Per-row max → (n, 1) — ref ``LASillyRowMaxAggregate.h``."""
    return _reduce(a, torch.amax, float("-inf"), 1)


def row_min(a: BlockedTensor) -> BlockedTensor:
    return _reduce(a, torch.amin, float("inf"), 1)


def row_sum(a: BlockedTensor) -> BlockedTensor:
    """Per-row sum → (n, 1) — ref ``LASillyRowSumAggregate``."""
    return _reduce(a, torch.sum, 0.0, 1)


def col_max(a: BlockedTensor) -> BlockedTensor:
    """Per-column max → (1, m) — ref ``LASillyColMaxAggregate.h``."""
    return _reduce(a, torch.amax, float("-inf"), 0)


def col_min(a: BlockedTensor) -> BlockedTensor:
    return _reduce(a, torch.amin, float("inf"), 0)


def col_sum(a: BlockedTensor) -> BlockedTensor:
    """Per-column sum → (1, m) — ref ``LASillyColSumAggregate``."""
    return _reduce(a, torch.sum, 0.0, 0)


def duplicate_row(v: BlockedTensor, n_rows: int,
                  block_rows: int) -> BlockedTensor:
    """Tile a (1, m) row vector to (n_rows, m) — ref
    ``LASillyDuplicateRowMultiSelection.h``."""
    row = v.to_dense().reshape(1, -1)
    return BlockedTensor.from_dense(row.expand(n_rows, row.shape[1]),
                                    (block_rows, v.meta.block_shape[1]),
                                    dtype=v.dtype, device=v.device)


def duplicate_col(v: BlockedTensor, n_cols: int,
                  block_cols: int) -> BlockedTensor:
    """Tile an (n, 1) column vector to (n, n_cols) — ref
    ``LASillyDuplicateColMultiSelection.h``."""
    col = v.to_dense().reshape(-1, 1)
    return BlockedTensor.from_dense(col.expand(col.shape[0], n_cols),
                                    (v.meta.block_shape[0], block_cols),
                                    dtype=v.dtype, device=v.device)


def identity(n: int, block: int, dtype=torch.float32,
             device=None) -> BlockedTensor:
    """identity(n, block) — the DSL's ``identity``."""
    device = resolve_device(device)
    return BlockedTensor.from_dense(torch.eye(n, dtype=dtype, device=device),
                                    (block, block), dtype=dtype,
                                    device=device)


def zeros(rows: int, cols: int, brows: int, bcols: int, dtype=torch.float32,
          device=None) -> BlockedTensor:
    return BlockedTensor.zeros((rows, cols), (brows, bcols), dtype,
                               device=resolve_device(device))


def ones(rows: int, cols: int, brows: int, bcols: int, dtype=torch.float32,
         device=None) -> BlockedTensor:
    device = resolve_device(device)
    return BlockedTensor.from_dense(
        torch.ones((rows, cols), dtype=dtype, device=device), (brows, bcols),
        dtype=dtype, device=device)


def inverse(a: BlockedTensor) -> BlockedTensor:
    """A⁻¹ (the DSL's ``^-1``) of the dense logical matrix in f32, under
    any blocking (the reference's Eigen inverse takes one block; the JAX
    package inverts the dense matrix too)."""
    if a.shape[0] != a.shape[1]:
        raise ValueError(f"inverse of non-square {a.shape}")
    full_f32_precision()
    # inv_ex reports a singular matrix in ``info`` without a host sync,
    # so a compiled program can hold it (its check runs after the program)
    inv, info = torch.linalg.inv_ex(a.to_dense().float())

    def check():
        if info != 0:
            raise torch.linalg.LinAlgError(
                f"linalg.inv: The diagonal element {int(info)} is zero, the "
                f"inversion could not be completed because the input "
                f"matrix is singular.")

    if not defer_check(check):
        check()
    return BlockedTensor.from_dense(inv.to(a.dtype), a.meta.block_shape,
                                    dtype=a.dtype, device=a.device)
