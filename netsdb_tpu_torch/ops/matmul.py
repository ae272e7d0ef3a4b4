"""Blocked matmul — counterpart of ``netsdb_tpu/ops/matmul.py``.

netsDB computes C = A·Bᵀ as a join of blocks on the contraction index
plus an aggregation of the block products; on one card the whole
join + aggregate is one dense product on the padded tensors. Zero
padding is safe under contraction, so nothing is masked here; the output
metadata keeps the logical shape. Operands whose data is placed over a
mesh multiply by the rule of ``parallel/placed_ops`` (per position, the
position-order psum, or a counted gather).
``matmul(distributed=True)`` runs the contraction through SUMMA over the
visible positions (``parallel/summa.summa_matmul_resident``).
"""

from __future__ import annotations

from typing import Optional

import torch

from netsdb_tpu_torch.core.blocked import (BlockMeta, BlockedTensor,
                                           as_torch_dtype)
from netsdb_tpu_torch.ops.common import mxu_dot
from netsdb_tpu_torch.parallel import placed_ops


def _contract(ad, bd, a_pad_k, b_pad_k, k, compute_dtype, accum_dtype=None,
              op="matmul"):
    # align contraction extents when block granularities differ
    if a_pad_k != b_pad_k:
        ad = ad[:, :k]
        bd = bd[:k, :]
    accum = accum_dtype or torch.float32
    return placed_ops.matmul(
        ad, bd, lambda x, y: mxu_dot(x, y, compute_dtype), op=op,
        out_dtype=as_torch_dtype(accum))


def matmul(a: BlockedTensor, b: BlockedTensor,
           compute_dtype: Optional[str] = None,
           accum_dtype: Optional[str] = None,
           distributed: Optional[bool] = None) -> BlockedTensor:
    """C = A·B (reference ``FFInputLayerJoin`` + ``FFAggMatrix``).
    ``accum_dtype`` sets the output dtype (default f32).

    ``distributed=True`` routes the contraction through the SUMMA panel
    engine over the visible positions of A's device type (A's rows split,
    B's contraction panels broadcast per step, C tiles accumulated in
    order) when there are at least 2 and the product is f32 (a caller
    asking for reduced-precision compute or a non-f32 accumulator keeps
    the one-device product, as in the reference; ``summa.single_position``
    counts a request with fewer than 2 positions). None means False: the
    port has no process-wide configuration for the knob to come from."""
    (m, ka), (kb, n) = a.shape, b.shape
    if ka != kb:
        raise ValueError(f"matmul contraction mismatch {a.shape} x {b.shape}")
    if distributed and compute_dtype is None and accum_dtype is None:
        from netsdb_tpu_torch import obs
        from netsdb_tpu_torch.parallel import summa
        from netsdb_tpu_torch.parallel.mesh import visible_devices

        ad = placed_ops.whole(a.data, "matmul(distributed)",
                              "SUMMA takes whole operands")
        devices = list(visible_devices(ad.device.type))
        if len(devices) >= 2:
            bd = placed_ops.whole(b.data, "matmul(distributed)",
                                  "SUMMA takes whole operands")
            out = summa.summa_matmul_resident(ad[:m, :ka], bd[:kb, :n],
                                              devices=devices)
            meta = BlockMeta((m, n), (a.meta.block_shape[0],
                                      b.meta.block_shape[1]))
            pad = (0, meta.padded_shape[1] - n, 0, meta.padded_shape[0] - m)
            if any(pad):
                out = torch.nn.functional.pad(out, pad)
            return BlockedTensor(out, meta)
        obs.REGISTRY.counter("summa.single_position").inc()
    out = _contract(a.data, b.data, a.meta.padded_shape[1],
                    b.meta.padded_shape[0], ka, compute_dtype, accum_dtype)
    meta = BlockMeta((m, n), (a.meta.block_shape[0], b.meta.block_shape[1]))
    return BlockedTensor(out, meta)


def matmul_t(a: BlockedTensor, b: BlockedTensor,
             compute_dtype: Optional[str] = None,
             accum_dtype: Optional[str] = None) -> BlockedTensor:
    """C = A·Bᵀ (reference ``FFTransposeMult``)."""
    (m, ka), (n, kb) = a.shape, b.shape
    if ka != kb:
        raise ValueError(f"matmul_t contraction mismatch {a.shape} x {b.shape}")
    out = _contract(a.data, b.data.t(), a.meta.padded_shape[1],
                    b.meta.padded_shape[1], ka, compute_dtype, accum_dtype,
                    op="matmul_t")
    meta = BlockMeta((m, n), (a.meta.block_shape[0], b.meta.block_shape[0]))
    return BlockedTensor(out, meta)


def t_matmul(a: BlockedTensor, b: BlockedTensor,
             compute_dtype: Optional[str] = None) -> BlockedTensor:
    """C = Aᵀ·B (the LA DSL's ``'*``, reference
    ``LASillyTransposeMultiply1Join.h``): A's transpose is a view, which
    the product reads as it lies.

    It contracts over the rows of a tall matrix (the Gram matrix's
    200 000), so float32 operands are multiplied in float64 and the
    result rounded to float32: an f32 sum of that many products is off by
    up to about 1 on entries of 2e5, which misses the reference test's
    atol of 2e-4 on entries near 0 (measured on an H100, PERF.md §6).
    ``compute_dtype`` keeps its meaning (bf16 operands, f32 sums)."""
    (ka, m), (kb, n) = a.shape, b.shape
    if ka != kb:
        raise ValueError(f"t_matmul contraction mismatch {a.shape} x "
                         f"{b.shape}")
    ad = placed_ops.whole(a.data, "t_matmul")
    bd = placed_ops.whole(b.data, "t_matmul")
    if compute_dtype is None and ad.dtype == torch.float32:
        wide = ad.double()
        ad, bd = wide, (wide if b is a else bd.double())
    out = _contract(ad.t(), bd, a.meta.padded_shape[0],
                    b.meta.padded_shape[0], ka, compute_dtype, op="t_matmul")
    meta = BlockMeta((m, n), (a.meta.block_shape[1], b.meta.block_shape[1]))
    return BlockedTensor(out, meta)


def gram(x: BlockedTensor,
         compute_dtype: Optional[str] = None) -> BlockedTensor:
    """Xᵀ·X, the reference's headline self-learning task."""
    return t_matmul(x, x, compute_dtype)
