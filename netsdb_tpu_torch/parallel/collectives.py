"""Explicit collective matmuls over a mesh — counterpart of
``netsdb_tpu/parallel/collectives.py``.

The reference runs each local product under ``shard_map`` and lets one
``psum``, ``psum_scatter``, ``all_gather`` or ``all_to_all`` combine the
positions. Here a process holds its own positions' tensors
(:mod:`netsdb_tpu_torch.parallel.mesh`), so each collective is the
explicit function of them: the reduction sums the partial products in
position order, the gather concatenates, the all-to-all splits and
concatenates. Positions another process owns come through the mesh's
collectives (every owning process runs the same call), and each process
keeps its own positions of the output. The local products are
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


def _local_groups(mesh: Mesh, axis: str):
    """The axis groups holding a position of this process, each with its
    positions' owners."""
    for group in mesh.axis_groups(axis):
        owners = [int(mesh.owners[p]) for p in group]
        if mesh.rank in owners:
            yield group, owners


def _local_dots(a: ShardedTensor, b: ShardedTensor, group) -> list:
    return [None if x is None else _dot(x, y)
            for x, y in zip(group_shards(a, group), group_shards(b, group))]


def matmul_psum(a, b, mesh: Mesh, axis: str = "model") -> ShardedTensor:
    """C = A·B with the CONTRACTION dim sharded over ``axis``: each
    position multiplies its k-slice, then the partial products are
    summed in position order (the reference's one ``psum``). Output
    replicated."""
    a = as_sharded(a, mesh, (None, axis))
    b = as_sharded(b, mesh, (axis, None))
    out = {}
    for group, owners in _local_groups(mesh, axis):
        total = position_sum(_local_dots(a, b, group), owners=owners)
        mine = [p for p in group if mesh.is_local(p)]
        out.update(_replicated([move(total, mesh.devices[p])
                                for p in mine], mine))
    return _assemble(mesh, out, (None, None), (a.shape[0], b.shape[1]))


def matmul_psum_scatter(a, b, mesh: Mesh,
                        axis: str = "model") -> ShardedTensor:
    """Same contraction sharding, but the reduction scatters: position
    ``i`` keeps row tile ``i`` of C, summed over the positions' partials
    in position order (the reference's ``psum_scatter``)."""
    a = as_sharded(a, mesh, (None, axis))
    b = as_sharded(b, mesh, (axis, None))
    out = {}
    for group, owners in _local_groups(mesh, axis):
        parts = _local_dots(a, b, group)
        n = len(group)
        if a.shape[0] % n:
            raise ValueError(f"rows {a.shape[0]} do not scatter over "
                             f"{axis}={n}")
        tiles = [None if p is None else torch.chunk(p, n, dim=0)
                 for p in parts]
        for j, pos in enumerate(group):
            # every owner takes part in each tile's sum (SPMD)
            total = position_sum([None if t is None else t[j]
                                  for t in tiles],
                                 mesh.devices[pos] if mesh.is_local(pos)
                                 else None, owners=owners)
            if mesh.is_local(pos):
                out[pos] = total
    return _assemble(mesh, out, (axis, None), (a.shape[0], b.shape[1]))


def matmul_allgather(a, b, mesh: Mesh, axis: str = "model") -> ShardedTensor:
    """C = A·B with A row-sharded and B small: B's row blocks are
    gathered at every position (the broadcast join's replicated hash
    table), each position multiplies its rows, and C stays row-sharded.
    One gather of the small side, no reduction."""
    a = as_sharded(a, mesh, (axis, None))
    b = as_sharded(b, mesh, (axis, None))
    out = {}
    for group, owners in _local_groups(mesh, axis):
        blocks = group_shards(b, group)
        full = {}
        for pos, x in zip(group, group_shards(a, group)):
            if x is None:
                continue
            dev = mesh.devices[pos]
            if dev not in full:
                full[dev] = position_gather(blocks, 0, dev, owners)
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
    for group, owners in _local_groups(mesh, axis):
        moved = position_all_to_all(group_shards(x, group), to_dim,
                                    from_dim, owners)
        out.update((p, t) for p, t in zip(group, moved) if t is not None)
    return _assemble(mesh, out, tuple(out_spec), x.shape)
