"""Embedding lookup — the word2vec workload family; counterpart of
``netsdb_tpu/ops/embedding.py``.

The reference expresses a lookup as a blocked matmul of one-hot input
rows against the weight matrix (``src/word2vec/source/Word2Vec.cc:19-80``:
``FFTransposeMult`` → ``FFAggMatrix``), plus the segment-combined sparse
variant ``EmbeddingLookupSparse``/``EmbeddingSegment``. Both are kept:
the matmul form is what the relational planner produces (cuBLAS at full
f32, so a one-hot product picks rows exactly), the gather form is what a
serving loop should run (``index_select``; the sparse form adds the rows
of a segment with ``index_add_``). A table placed with its rows sharded
looks up per position (``parallel/placed_ops.take_rows``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from netsdb_tpu_torch.core.blocked import BlockedTensor, as_torch_dtype
from netsdb_tpu_torch.ops.common import defer_check
from netsdb_tpu_torch.ops.linalg import transpose
from netsdb_tpu_torch.ops.matmul import matmul_t
from netsdb_tpu_torch.parallel import placed_ops


def _ids(ids, device, bound: int, what: str) -> torch.Tensor:
    """Integer ids (numpy or torch) as an int64 tensor on ``device``,
    each in [0, bound): an id out of range raises here, where on the card
    the gather or scatter would stop the process with a device assert."""
    if isinstance(ids, torch.Tensor):
        idx = ids.to(device=device, dtype=torch.int64)
    else:
        idx = torch.as_tensor(np.asarray(ids), dtype=torch.int64,
                              device=device)
    if idx.numel():
        lo, hi = torch.aminmax(idx)

        def check():
            if lo < 0 or hi >= bound:
                raise IndexError(f"{what} must lie in [0, {bound}), got "
                                 f"[{int(lo)}, {int(hi)}]")

        if defer_check(check):
            # inside a compiled program the check runs after it: keep the
            # gather in bounds until then
            idx = idx.clamp(0, bound - 1)
        else:
            check()
    return idx


def one_hot_matrix(ids, vocab: int, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    """(batch, vocab) one-hot rows — the generated input sets of the
    reference word2vec test. Built where ``ids`` lie unless ``device``
    is given."""
    if device is None and isinstance(ids, torch.Tensor):
        device = ids.device
    return F.one_hot(_ids(ids, device, vocab, "ids"),
                     vocab).to(as_torch_dtype(dtype))


def embedding_matmul(weights: BlockedTensor, onehot: BlockedTensor,
                     compute_dtype: Optional[str] = None) -> BlockedTensor:
    """Lookup as a blocked matmul of the one-hot rows with the transposed
    table (reference Word2Vec.cc path). ``weights``: (vocab x dim)
    blocked; ``onehot``: (batch x vocab) blocked. Result: (batch x dim)."""
    return matmul_t(onehot, transpose(weights), compute_dtype)


def _rows(weights: BlockedTensor, idx: torch.Tensor,
          op: str) -> torch.Tensor:
    """The table's logical rows ``idx`` (its padded columns cut off)."""
    rows = placed_ops.take_rows(weights.data, idx, op)
    dim = weights.shape[1]
    return rows if rows.shape[1] == dim else rows[:, :dim].contiguous()


def embedding_lookup(weights: BlockedTensor, ids) -> torch.Tensor:
    """Gather path: rows of the (vocab x dim) table by id, numerically
    identical to the one-hot matmul. Returns logical (ids..., dim): the
    padded columns are sliced off."""
    idx = _ids(ids, weights.device, weights.shape[0], "ids")
    return _rows(weights, idx.reshape(-1), "embedding_lookup").reshape(
        *idx.shape, weights.shape[1])


def embedding_lookup_sparse(weights: BlockedTensor, ids, segment_ids,
                            num_segments: int,
                            combiner: str = "mean") -> torch.Tensor:
    """Segment-combined sparse lookup — reference
    ``EmbeddingLookupSparse.h``/``EmbeddingSegment.h`` (the bag-of-words
    front end). ``ids`` and ``segment_ids`` are (nnz,); returns
    (num_segments, dim). An empty segment reads 0 under every combiner
    (its count is clamped at 1, as in the reference)."""
    if combiner not in ("sum", "mean", "sqrtn"):
        raise ValueError(combiner)
    rows = _rows(weights, _ids(ids, weights.device, weights.shape[0], "ids"),
                 "embedding_lookup_sparse")  # (nnz, dim)
    seg = _ids(segment_ids, rows.device, num_segments, "segment_ids")
    summed = torch.zeros((num_segments, weights.shape[1]), dtype=rows.dtype,
                         device=rows.device).index_add_(0, seg, rows)
    if combiner == "sum":
        return summed
    counts = torch.zeros(num_segments, dtype=rows.dtype,
                         device=rows.device).index_add_(
        0, seg, torch.ones_like(seg, dtype=rows.dtype)).clamp_(min=1.0)
    if combiner == "mean":
        return summed / counts[:, None]
    return summed / counts.sqrt()[:, None]
