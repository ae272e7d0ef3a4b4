"""Mixture-of-experts layer — counterpart of ``netsdb_tpu/models/moe.py``,
on one device or expert-parallel over a mesh axis.

Top-1 switch routing with a capacity limit in the dispatch/combine
formulation: dispatch (tokens → expert slots) and combine (expert
outputs → tokens) are one-hot tensors, so the experts run as batched
products (f32, TF32 off: the reference's ``Precision.HIGHEST``). A token
past its expert's capacity is dropped (its output row is 0). The GELU is
the tanh approximation, ``jax.nn.gelu``'s default.

Over a mesh (``moe_forward(mesh=...)``, the reference's sharding
constraint of the expert dimension on ``expert_axis``) routing runs
once, the dispatch, ``w_up`` and ``w_down`` are split by expert over the
axis, each position runs its experts' two products, and the combine sums
the positions' partials in position order. A token has one non-zero
term in the combine (and a slot one in the dispatch), so the split
changes no sum; only the batched products run over fewer experts.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from netsdb_tpu_torch.config import resolve_device
from netsdb_tpu_torch.ops.common import full_f32_precision, hi_einsum
from netsdb_tpu_torch.parallel.mesh import move, position_sum


@dataclasses.dataclass
class MoEParams:
    w_gate: torch.Tensor  # (d, n_experts)
    w_up: torch.Tensor    # (n_experts, d, hidden)
    w_down: torch.Tensor  # (n_experts, hidden, d)


def init_moe_params(d: int, hidden: int, n_experts: int, seed: int = 0,
                    device=None) -> MoEParams:
    """The reference's draws (numpy's generator, the same order and
    scaling), on ``device`` (CUDA unless asked)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)

    def put(shape, scale):
        a = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return a.to(device) * scale

    return MoEParams(w_gate=put((d, n_experts), d ** -0.5),
                     w_up=put((n_experts, d, hidden), d ** -0.5),
                     w_down=put((n_experts, hidden, d), hidden ** -0.5))


class Routing(NamedTuple):
    expert: torch.Tensor    # (tokens,) chosen expert
    gate: torch.Tensor      # (tokens,) its probability
    position: torch.Tensor  # (tokens,) place in the expert's queue
    keep: torch.Tensor      # (tokens,) position < capacity
    capacity: int


def capacity_of(tokens: int, n_experts: int, capacity_factor: float) -> int:
    return max(1, int(capacity_factor * tokens / n_experts))


def route(params: MoEParams, x: torch.Tensor,
          capacity_factor: float = 2.0) -> Routing:
    """Top-1 routing: each token's expert (the first on a tie), its gate
    and its place in the expert's queue, in token order."""
    tokens = x.shape[0]
    n_experts = params.w_gate.shape[1]
    capacity = capacity_of(tokens, n_experts, capacity_factor)
    probs = torch.softmax(hi_einsum("td,de->te", x, params.w_gate), dim=-1)
    expert = torch.argmax(probs, dim=-1)
    gate = probs.amax(dim=-1)
    onehot = F.one_hot(expert, n_experts).to(torch.int32)
    position = (torch.cumsum(onehot, dim=0) * onehot - 1).amax(dim=-1)
    return Routing(expert, gate, position, position < capacity, capacity)


def moe_forward(params: MoEParams, x: torch.Tensor,
                capacity_factor: float = 2.0, mesh=None,
                expert_axis: str = "model") -> torch.Tensor:
    """x (tokens, d) → (tokens, d). With ``mesh``, the experts are split
    over ``expert_axis`` (whose size must divide the expert count); the
    result is on x's device either way."""
    n_experts = params.w_gate.shape[1]
    if mesh is not None and n_experts % mesh.shape[expert_axis]:
        raise ValueError(
            f"{n_experts} experts do not split over {expert_axis}="
            f"{mesh.shape[expert_axis]} positions")
    r = route(params, x, capacity_factor)
    # a position past capacity one-hots to a zero row in the reference;
    # F.one_hot refuses it, so clamp and let ``keep`` zero the row
    slot = F.one_hot(r.position.clamp(0, r.capacity - 1),
                     r.capacity).to(x.dtype)
    dispatch = (F.one_hot(r.expert, n_experts).to(x.dtype)[:, :, None]
                * slot[:, None, :])
    dispatch = dispatch * r.keep.to(x.dtype)[:, None, None]
    combine = dispatch * r.gate.to(x.dtype)[:, None, None]
    if mesh is None:
        return _experts(dispatch, combine, x, params.w_up, params.w_down)
    group = mesh.axis_groups(expert_axis)[0]
    per = n_experts // len(group)
    parts = []
    for i, pos in enumerate(group):
        dev, e = mesh.devices[pos], slice(i * per, (i + 1) * per)
        parts.append(_experts(*(move(t, dev) for t in (
            dispatch[:, e], combine[:, e], x, params.w_up[e],
            params.w_down[e]))))
    return position_sum(parts, x.device)


def _experts(dispatch, combine, x, w_up, w_down) -> torch.Tensor:
    """The experts' products for the experts of ``w_up``/``w_down`` (the
    matching slice of dispatch and combine): (tokens, d)."""
    expert_in = hi_einsum("tec,td->ecd", dispatch, x)
    h = F.gelu(hi_einsum("ecd,edh->ech", expert_in, w_up),
               approximate="tanh")
    expert_out = hi_einsum("ech,ehd->ecd", h, w_down)
    return hi_einsum("tec,ecd->td", combine, expert_out)


def moe_forward_dense_oracle(params: MoEParams, x: torch.Tensor,
                             capacity_factor: float = 2.0) -> torch.Tensor:
    """Token by token in a Python loop — the routing and capacity
    semantics spelled out, for tests."""
    tokens = x.shape[0]
    n_experts = params.w_gate.shape[1]
    capacity = capacity_of(tokens, n_experts, capacity_factor)
    full_f32_precision()
    probs = torch.softmax(x @ params.w_gate, dim=-1)
    out = torch.zeros_like(x)
    counts = np.zeros(n_experts, np.int64)
    for t in range(tokens):
        e = int(probs[t].argmax())
        counts[e] += 1
        if counts[e] > capacity:  # dropped: past the expert's capacity
            continue
        h = F.gelu(x[t] @ params.w_up[e], approximate="tanh")
        out[t] = probs[t, e] * (h @ params.w_down[e])
    return out
