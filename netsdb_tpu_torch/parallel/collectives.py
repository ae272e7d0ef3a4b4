"""Explicit collective matmuls over a mesh — counterpart of
``netsdb_tpu/parallel/collectives.py``.

The reference runs each local product under ``shard_map`` and lets one
``psum``, ``psum_scatter``, ``all_gather`` or ``all_to_all`` combine the
positions. Here the positions' tensors are at hand (one process drives
every position, :mod:`netsdb_tpu_torch.parallel.mesh`), so each
collective is the explicit function of them: the reduction sums the
partial products in position order, the gather concatenates, the
all-to-all splits and concatenates. The local products are
``torch.matmul`` in full f32 (TF32 off), as the reference's
``Precision.HIGHEST`` ``dot_general`` is.

- reference hash-repartition shuffle + combiners → :func:`matmul_psum`
  and :func:`matmul_psum_scatter` (contraction-sharded partial products
  reduced over the axis);
- reference broadcast join → :func:`matmul_allgather` (gather the small
  side, compute locally).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from netsdb_tpu_torch.ops.common import full_f32_precision
from netsdb_tpu_torch.parallel.mesh import (Mesh, ShardedTensor, as_sharded,
                                            group_shards, move,
                                            position_all_to_all,
                                            position_gather, position_sum)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    full_f32_precision()
    return torch.matmul(a.float(), b.float())


def _assemble(mesh: Mesh, per_position, spec, shape) -> ShardedTensor:
    shards = np.empty(mesh.devices.shape, dtype=object)
    for idx, t in per_position.items():
        shards[idx] = t
    return ShardedTensor(shards, mesh, spec, shape)


def _replicated(values: List[torch.Tensor], group) -> dict:
    """One copy per distinct device of the group, shared by its
    positions."""
    by_dev: dict = {}
    out = {}
    for p, t in zip(group, values):
        out[p] = by_dev.setdefault(t.device, t)
    return out


def matmul_psum(a, b, mesh: Mesh, axis: str = "model") -> ShardedTensor:
    """C = A·B with the CONTRACTION dim sharded over ``axis``: each
    position multiplies its k-slice, then the partial products are
    summed in position order (the reference's one ``psum``). Output
    replicated."""
    a = as_sharded(a, mesh, (None, axis))
    b = as_sharded(b, mesh, (axis, None))
    out = {}
    for group in mesh.axis_groups(axis):
        parts = [_dot(x, y) for x, y in zip(group_shards(a, group),
                                            group_shards(b, group))]
        total = position_sum(parts)
        out.update(_replicated([move(total, mesh.devices[p])
                                for p in group], group))
    return _assemble(mesh, out, (None, None), (a.shape[0], b.shape[1]))


def matmul_psum_scatter(a, b, mesh: Mesh,
                        axis: str = "model") -> ShardedTensor:
    """Same contraction sharding, but the reduction scatters: position
    ``i`` keeps row tile ``i`` of C, summed over the positions' partials
    in position order (the reference's ``psum_scatter``)."""
    a = as_sharded(a, mesh, (None, axis))
    b = as_sharded(b, mesh, (axis, None))
    out = {}
    for group in mesh.axis_groups(axis):
        parts = [_dot(x, y) for x, y in zip(group_shards(a, group),
                                            group_shards(b, group))]
        n = len(group)
        if parts[0].shape[0] % n:
            raise ValueError(f"rows {parts[0].shape[0]} do not scatter over "
                             f"{axis}={n}")
        tiles = [torch.chunk(p, n, dim=0) for p in parts]
        for j, pos in enumerate(group):
            out[pos] = position_sum([tiles[i][j] for i in range(n)],
                                    mesh.devices[pos])
    return _assemble(mesh, out, (axis, None), (a.shape[0], b.shape[1]))


def matmul_allgather(a, b, mesh: Mesh, axis: str = "model") -> ShardedTensor:
    """C = A·B with A row-sharded and B small: B's row blocks are
    gathered at every position (the broadcast join's replicated hash
    table), each position multiplies its rows, and C stays row-sharded.
    One gather of the small side, no reduction."""
    a = as_sharded(a, mesh, (axis, None))
    b = as_sharded(b, mesh, (axis, None))
    out = {}
    for group in mesh.axis_groups(axis):
        blocks = group_shards(b, group)
        full = {}
        for pos, x in zip(group, group_shards(a, group)):
            dev = mesh.devices[pos]
            if dev not in full:
                full[dev] = position_gather(blocks, 0, dev)
            out[pos] = _dot(x, full[dev])
    return _assemble(mesh, out, (axis, None), (a.shape[0], b.shape[1]))


def all_to_all_resharding(x, mesh: Mesh, axis: str, from_dim: int,
                          to_dim: int) -> ShardedTensor:
    """Re-shard ``x`` from ``from_dim`` to ``to_dim`` over ``axis`` with
    one all-to-all: the primitive under Ulysses and the analogue of the
    reference's full-shuffle repartition."""
    in_spec = [None] * len(x.shape)
    in_spec[from_dim] = axis
    out_spec = [None] * len(x.shape)
    out_spec[to_dim] = axis
    x = as_sharded(x, mesh, tuple(in_spec))
    out = {}
    for group in mesh.axis_groups(axis):
        moved = position_all_to_all(group_shards(x, group), to_dim,
                                    from_dim)
        out.update(zip(group, moved))
    return _assemble(mesh, out, tuple(out_spec), x.shape)
