"""NN elementwise ops — the FF UDF family; counterpart of
``netsdb_tpu/ops/nn.py``.

All ops keep the zero-margin invariant (``ops.common``). Layout follows
the reference's FF inference: activations are (features x batch).
Dropout draws from a caller-owned ``torch.Generator`` where the
reference takes a ``jax.random`` key. Placed data runs by the rule of
``parallel/placed_ops`` (per position where the layouts allow it); a
softmax needs its axis whole at each position.
"""

from __future__ import annotations

from typing import Optional

import torch

from netsdb_tpu_torch.core.blocked import BlockedTensor
from netsdb_tpu_torch.ops import linalg
from netsdb_tpu_torch.ops.common import neutral_fill, remask
from netsdb_tpu_torch.parallel import placed_ops


def _broadcast_bias(x: BlockedTensor, bias: BlockedTensor):
    """Bias (n,) or (n,1) to broadcast along x's columns, on padded data
    (a placed bias stays placed: the ops below add it per position)."""
    b = bias.data
    if b.ndim == 1:
        b = placed_ops.whole(b, "bias", "a 1-d bias is reshaped whole")
        b = b[:, None]
    if b.shape[0] != x.data.shape[0]:
        raise ValueError(
            f"bias rows {b.shape[0]} != x padded rows {x.data.shape[0]} "
            f"(bias must share x's row blocking)")
    return b


def _biased(act, x: BlockedTensor, bias: BlockedTensor, op: str):
    """``act(x + bias)`` by the placed-op rule; the sum is in the
    activation's dtype (a f32 bias must not promote a bf16 activation
    chain back to f32)."""
    return placed_ops.elementwise(lambda d, b: act(d + b.to(d.dtype)),
                                  x.data, _broadcast_bias(x, bias), op=op)


def relu(x: BlockedTensor) -> BlockedTensor:
    """max(x, 0); relu(0) = 0 keeps the margin."""
    return x.with_data(placed_ops.elementwise(torch.relu, x.data,
                                              op="relu"))


def bias_relu(x: BlockedTensor, bias: BlockedTensor,
              dropout_rate: float = 0.0,
              generator: Optional[torch.Generator] = None) -> BlockedTensor:
    """relu(x + bias) with optional inverted dropout — reference
    ``FFReluBiasSum``."""
    if dropout_rate > 0.0 and generator is None:
        raise ValueError("dropout requires a torch.Generator")

    def act(z):
        y = torch.relu(z)
        if dropout_rate > 0.0:
            keep = torch.rand(y.shape, generator=generator,
                              device=y.device) < (1.0 - dropout_rate)
            y = torch.where(keep, y / (1.0 - dropout_rate),
                            torch.zeros((), dtype=y.dtype, device=y.device))
        return y

    # the bias broadcasts into padded batch columns: re-mask
    return remask(x.with_data(_biased(act, x, bias, "bias_relu")))


def bias_sigmoid(x: BlockedTensor, bias: BlockedTensor) -> BlockedTensor:
    """sigmoid(x + bias) — reference ``FFTransposeBiasSumSigmoid``."""
    return remask(x.with_data(_biased(torch.sigmoid, x, bias,
                                      "bias_sigmoid")))


def bias_exp(x: BlockedTensor, bias: BlockedTensor) -> BlockedTensor:
    """exp(x + bias) — reference ``FFTransposeBiasSum`` (the softmax
    numerator stage); exp(0) = 1, so the margin is re-masked."""
    return remask(x.with_data(_biased(torch.exp, x, bias, "bias_exp")))


def row_sum(x: BlockedTensor) -> BlockedTensor:
    """Per-row sum → (n, 1) — reference ``FFRowAggregate``; the LA op
    set's ``row_sum``."""
    return linalg.row_sum(x)


def col_sum(x: BlockedTensor) -> BlockedTensor:
    """Per-column sum → (1, m); the LA op set's ``col_sum``."""
    return linalg.col_sum(x)


def _masked_softmax(x: BlockedTensor, z, axis: int) -> BlockedTensor:
    filled = neutral_fill(x.with_data(z), float("-inf"))

    def soft(f):
        # softmax along a contiguous last axis: each slice's reductions
        # then run in one order whatever the other axis's width or the
        # thread count, so a pool shard's batch columns equal a whole
        # batch's bit for bit (the CPU's reduction over a strided axis
        # depends on both)
        y = torch.softmax(f.movedim(axis, -1).contiguous(),
                          dim=-1).movedim(-1, axis).contiguous()
        # rows/cols that are ALL padding give NaN (softmax of all -inf)
        return torch.nan_to_num(y, nan=0.0, posinf=0.0,
                                neginf=0.0).to(x.data.dtype)

    y = placed_ops.elementwise(soft, filled, op="softmax",
                               whole_dims=(axis,))
    return remask(x.with_data(y))


def softmax(x: BlockedTensor, axis: int = 0) -> BlockedTensor:
    """Masked softmax along ``axis`` — reference ``FFOutputLayer``."""
    return _masked_softmax(x, x.data, axis)


def ff_output_layer(y: BlockedTensor, bias: BlockedTensor,
                    axis: int = 0) -> BlockedTensor:
    """exp(y+b) normalised along ``axis`` — the reference inference
    tail (``FFTransposeBiasSum`` → ``FFRowAggregate`` →
    ``FFOutputLayer``) as one op, in the max-subtracted stable form."""
    return _masked_softmax(y, _biased(lambda t: t, y, bias, "bias_add"),
                           axis)
