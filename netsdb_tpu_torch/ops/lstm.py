"""LSTM cell — the reference's recurrent workload; counterpart of
``netsdb_tpu/ops/lstm.py``.

The reference expresses one cell as a computation DAG over
``FFMatrixBlock`` sets: 8 blocked matmuls (x and h against the 4 gate
weights), gate fusion ``LSTMThreeWaySum`` (gate = act(xW + hU + b)) and
the state update ``LSTMTwoSum``/``LSTMHiddenState`` (c' = f⊙c + i⊙g,
h' = o⊙tanh c'). Here one cell is 8 cuBLAS products plus the elementwise
chain, and a sequence is a Python loop over steps where the JAX package
runs ``lax.scan``.

Layout follows the reference: activations are (features x batch); W_* is
(hidden x input), U_* (hidden x hidden), biases (hidden x 1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from netsdb_tpu_torch.core.blocked import (BlockedTensor, BlockMeta,
                                           as_torch_dtype)
from netsdb_tpu_torch.ops.common import remask
from netsdb_tpu_torch.ops.matmul import matmul


@dataclasses.dataclass
class LSTMParams:
    """The 12 weight sets the reference LSTMTest creates
    (w_{i,f,c,o}, u_{i,f,c,o}, b_{i,f,c,o})."""

    w_i: BlockedTensor
    w_f: BlockedTensor
    w_c: BlockedTensor
    w_o: BlockedTensor
    u_i: BlockedTensor
    u_f: BlockedTensor
    u_c: BlockedTensor
    u_o: BlockedTensor
    b_i: BlockedTensor
    b_f: BlockedTensor
    b_c: BlockedTensor
    b_o: BlockedTensor


def three_way_sum(wx: BlockedTensor, uh: BlockedTensor, b: BlockedTensor,
                  activation: str) -> torch.Tensor:
    """gate = act(wx + uh + b) — reference ``LSTMThreeWaySum`` join."""
    z = wx.data + uh.data + (b.data if b.data.ndim == 2 else b.data[:, None])
    if activation == "sigmoid":
        return torch.sigmoid(z)
    if activation == "tanh":
        return torch.tanh(z)
    raise ValueError(activation)


def lstm_cell(params: LSTMParams, x: BlockedTensor, h: BlockedTensor,
              c: BlockedTensor, compute_dtype: Optional[str] = None
              ) -> Tuple[BlockedTensor, BlockedTensor]:
    """One cell step → (h', c'); x is (input x batch), h and c (hidden x
    batch). The biases broadcast into the padded batch columns (g =
    tanh(b_c) ≠ 0 times i = sigmoid(b_i) ≠ 0), so both states are
    re-masked: the margin would otherwise compound across steps. Under
    ``compute_dtype`` x and h are rounded once for their four products
    (the same values each product's own cast would give)."""
    hx = h
    if compute_dtype is not None:
        cd = as_torch_dtype(compute_dtype)
        x, hx = (t.with_data(t.data.to(cd)) for t in (x, h))

    def mm(w, v):
        return matmul(w, v, compute_dtype)

    i = three_way_sum(mm(params.w_i, x), mm(params.u_i, hx), params.b_i,
                      "sigmoid")
    f = three_way_sum(mm(params.w_f, x), mm(params.u_f, hx), params.b_f,
                      "sigmoid")
    g = three_way_sum(mm(params.w_c, x), mm(params.u_c, hx), params.b_c,
                      "tanh")
    o = three_way_sum(mm(params.w_o, x), mm(params.u_o, hx), params.b_o,
                      "sigmoid")
    c_new = f * c.data + i * g  # reference LSTMTwoSum + LSTMHiddenState
    h_new = o * torch.tanh(c_new)
    return (remask(h.with_data(h_new.to(h.data.dtype))),
            remask(c.with_data(c_new.to(c.data.dtype))))


def lstm_unroll(params: LSTMParams, xs: torch.Tensor, h0: BlockedTensor,
                c0: BlockedTensor, compute_dtype: Optional[str] = None):
    """Run the cell over a sequence. ``xs``: (T, input_padded,
    batch_padded) sharing x's blocking. Returns (h_T, c_T, hs) with hs
    (T, hidden_padded, batch_padded), the stacked output of the
    reference's scan. Under ``compute_dtype`` the gate weights and xs are
    rounded once for the whole sequence, as XLA hoists the casts out of
    the reference's scan; the biases stay f32."""
    if compute_dtype is not None:
        cd = as_torch_dtype(compute_dtype)
        xs = xs.to(cd)
        params = dataclasses.replace(params, **{
            f.name: getattr(params, f.name).with_data(
                getattr(params, f.name).data.to(cd))
            for f in dataclasses.fields(params) if f.name[0] in "wu"})
    x_meta = BlockMeta(
        (params.w_i.shape[1], h0.shape[1]),
        (params.w_i.meta.block_shape[1], h0.meta.block_shape[1]))
    h, c, hs = h0, c0, []
    for x_t in xs:
        h, c = lstm_cell(params, BlockedTensor(x_t, x_meta), h, c,
                         compute_dtype)
        hs.append(h.data)
    return h, c, torch.stack(hs)
