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
(hidden x input), U_* (hidden x hidden), biases (hidden x 1). Placed
weights and states run by the rule of ``parallel/placed_ops``: each
product and each elementwise step per position where the layouts allow
it, a counted gather where they do not (row-sharded ``w_*`` against
column-sharded states meet in the gate sums).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from netsdb_tpu_torch.core.blocked import (BlockedTensor, BlockMeta,
                                           as_torch_dtype)
from netsdb_tpu_torch.ops.common import remask
from netsdb_tpu_torch.ops.matmul import matmul
from netsdb_tpu_torch.parallel import placed_ops

_ACT = {"sigmoid": torch.sigmoid, "tanh": torch.tanh}


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
    if activation not in _ACT:
        raise ValueError(activation)
    act = _ACT[activation]
    bd = b.data if b.data.ndim == 2 else placed_ops.whole(
        b.data, "three_way_sum")[:, None]
    return placed_ops.elementwise(lambda x, u, c: act(x + u + c), wx.data,
                                  uh.data, bd, op="three_way_sum")


def _cast(t: BlockedTensor, dtype) -> BlockedTensor:
    return t.with_data(placed_ops.elementwise(lambda d: d.to(dtype), t.data,
                                              op="cast"))


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
        x, hx = _cast(x, cd), _cast(h, cd)

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
    # reference LSTMTwoSum + LSTMHiddenState
    c_new = placed_ops.elementwise(lambda ff, cc, ii, gg: ff * cc + ii * gg,
                                   f, c.data, i, g, op="lstm_two_sum")
    h_new = placed_ops.elementwise(lambda oo, cn: oo * torch.tanh(cn), o,
                                   c_new, op="lstm_hidden_state")
    return (remask(_cast(h.with_data(h_new), h.data.dtype)),
            remask(_cast(c.with_data(c_new), c.data.dtype)))


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
            f.name: _cast(getattr(params, f.name), cd)
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
