"""Row and column sums and the transpose — the part of
``netsdb_tpu/ops/linalg.py`` that the FF ops and the embedding matmul
need (the rest of the LA DSL op set is ROADMAP.md A5)."""

from __future__ import annotations

import torch

from netsdb_tpu_torch.core.blocked import BlockMeta, BlockedTensor


def row_sum(a: BlockedTensor) -> BlockedTensor:
    """Per-row sum → (n,1) — ref ``LASillyRowSumAggregate``."""
    r = a.data.sum(dim=1, keepdim=True)
    # rows that are pure padding read 0 (the margin invariant)
    if a.meta.is_padded:
        rows = torch.arange(a.meta.padded_shape[0],
                            device=r.device)[:, None] < a.shape[0]
        r = torch.where(rows, r, torch.zeros((), dtype=r.dtype,
                                             device=r.device))
    return BlockedTensor(r.to(a.data.dtype),
                         BlockMeta((a.shape[0], 1), (a.meta.block_shape[0], 1)))


def col_sum(a: BlockedTensor) -> BlockedTensor:
    """Per-column sum → (1,m) — ref ``LASillyColSumAggregate``."""
    r = a.data.sum(dim=0, keepdim=True)
    if a.meta.is_padded:
        cols = torch.arange(a.meta.padded_shape[1],
                            device=r.device)[None, :] < a.shape[1]
        r = torch.where(cols, r, torch.zeros((), dtype=r.dtype,
                                             device=r.device))
    return BlockedTensor(r.to(a.data.dtype),
                         BlockMeta((1, a.shape[1]), (1, a.meta.block_shape[1])))


def transpose(a: BlockedTensor) -> BlockedTensor:
    """Aᵀ — ref ``LASillyTransposeSelection.h`` (swaps block indices).
    The data is a transposed view: the margin stays zero and a product
    that transposes it back reads the original memory."""
    meta = BlockMeta(a.shape[::-1], a.meta.block_shape[::-1])
    return BlockedTensor(a.data.t(), meta)
