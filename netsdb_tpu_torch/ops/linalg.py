"""Row and column sums — the part of ``netsdb_tpu/ops/linalg.py`` that
the FF ops need (the rest of the LA DSL op set is ROADMAP.md A5)."""

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
