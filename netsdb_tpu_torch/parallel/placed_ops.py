"""The rule for ops over placed tensors — what GSPMD decides in the
reference when a jitted body runs over sharded ``jax.Array`` s.

A :class:`~netsdb_tpu_torch.parallel.mesh.ShardedTensor` holds one tensor
per mesh position, and one process drives every position. An op given
placed operands (on the padded data of ``BlockedTensor`` s, or plain
tensors) runs by this rule, the one place the port decides it:

1. **per position** where every output tile can be computed from one
   position's tiles: the sharded operands share one mesh and agree on
   every dimension they shard; a whole operand (a plain tensor, or a
   replicated value) is cut to each position's region. Examples: a
   row-sharded A times a replicated B, an elementwise op over operands
   laid out alike, a replicated bias. The output keeps that layout.
   ``whole_dims`` names dimensions the op reduces along (a softmax):
   they must not be sharded.
2. **psum** for a product whose contraction dimension both sides shard
   alike: each position multiplies its slices, and the partials are
   summed in position order, ``((p0 + p1) + p2) + ...``
   (``mesh.position_sum``), so the result's bits do not depend on the
   devices. The result is replicated over the contraction axes.
3. anything else is **gathered** onto the first position
   (``mesh.gather_placed``: logged with the op and the layouts as its
   reason, counted in ``mesh.fallbacks``) and computed there; the output
   is a plain tensor on that position's device.

Positions of one physical device that hold the same output region share
one result (computed once), as ``ShardedTensor.from_dense`` shares
blocks. Over a mesh whose positions several processes own, each process
computes its own positions (SPMD), the psum gathers the partials of the
other processes first (so every process sums the same terms in the same
order), and a gather is the collective ``ShardedTensor.gather_global``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from netsdb_tpu_torch.core.blocked import BlockMeta, BlockedTensor
from netsdb_tpu_torch.parallel.mesh import (Mesh, ShardedTensor, _axes_of,
                                            gather_placed, move,
                                            position_sum, region_of)


def layout(x: Any) -> str:
    """An operand's layout, for a gather's reason."""
    if isinstance(x, ShardedTensor):
        return x.layout()
    if isinstance(x, torch.Tensor):
        return f"whole{tuple(x.shape)}"
    return type(x).__name__


def _held_whole(x: ShardedTensor) -> bool:
    return all(x.parts(d) == 1 for d in range(x.ndim))


def whole(x: Any, op: str, why: str = "the op runs on one device") -> Any:
    """``x`` as one tensor: a plain tensor as it is, a value held whole at
    every position as its first shard (nothing moves), anything else
    gathered and counted."""
    if not isinstance(x, ShardedTensor):
        return x
    if _held_whole(x):
        return x.first()
    return gather_placed(x, op, f"{x.layout()}: {why}")


def _gather_all(xs: Sequence[Any], op: str, why: str) -> List[Any]:
    """Every operand as one tensor on the first position; the reason
    names all the operands' layouts."""
    reason = f"{why}: " + " x ".join(layout(x) for x in xs)
    return [x if not isinstance(x, ShardedTensor) else
            x.first() if _held_whole(x) else gather_placed(x, op, reason)
            for x in xs]


def _common_mesh(xs: Sequence[Any]) -> Optional[Mesh]:
    meshes = {id(x.mesh): x.mesh for x in xs if isinstance(x, ShardedTensor)}
    return next(iter(meshes.values())) if len(meshes) == 1 else None


def _tensor_shape(x: Any) -> Optional[Tuple[int, ...]]:
    if isinstance(x, (torch.Tensor, ShardedTensor)):
        return tuple(x.shape)
    return None


def _elementwise_spec(xs: Sequence[Any], shape: Tuple[int, ...],
                      whole_dims: Sequence[int]) -> Optional[Tuple]:
    """The output spec of an elementwise op by rule 1, or None."""
    nd = len(shape)
    spec: List[Any] = [None] * nd
    for x in xs:
        if not isinstance(x, ShardedTensor):
            continue
        off = nd - x.ndim
        for d, entry in enumerate(x.spec):
            if entry is None or x.shape[d] == 1:
                continue
            o = d + off
            if spec[o] is not None and spec[o] != entry:
                return None
            spec[o] = entry
    used = [a for e in spec for a in _axes_of(e)]
    if len(used) != len(set(used)):
        return None
    if any(spec[d % nd] is not None for d in whole_dims):
        return None
    return tuple(spec)


def _cut(x: Any, idx, region: Tuple[slice, ...], out_ndim: int,
         device: torch.device) -> Any:
    """Operand ``x``'s block for the output ``region`` at position
    ``idx`` (broadcast dimensions of size 1 stay whole)."""
    if isinstance(x, ShardedTensor):
        local, spec, shape = x.shards[idx], x.spec, x.shape
    elif isinstance(x, torch.Tensor):
        local, spec, shape = x, (None,) * x.ndim, tuple(x.shape)
    else:
        return x
    off = out_ndim - len(shape)
    cut = tuple(slice(None) if (shape[d] == 1 or spec[d] is not None)
                else region[d + off] for d in range(len(shape)))
    if any(c != slice(None) for c in cut):
        local = local[cut]
    return move(local, device)


def _own_block(x: Any, idx, region, out_ndim, device) -> Any:
    """A product's operand at position ``idx``: its own shard whole (a
    row block of A, a column block of B), or a whole tensor moved."""
    if isinstance(x, ShardedTensor):
        return x.shards[idx]
    return move(x, device)


def _assemble(mesh: Mesh, fn: Callable, xs: Sequence[Any], spec: Tuple,
              shape: Tuple[int, ...], take: Callable = _cut
              ) -> ShardedTensor:
    shards = np.empty(mesh.devices.shape, dtype=object)
    made: Dict[tuple, torch.Tensor] = {}
    for idx in mesh.local_positions():
        dev = mesh.devices[idx]
        region = region_of(mesh, spec, shape, idx)
        key = (dev, tuple((s.start, s.stop) for s in region))
        if key not in made:
            made[key] = fn(*(take(x, idx, region, len(shape), dev)
                             for x in xs))
        shards[idx] = made[key]
    return ShardedTensor(shards, mesh, spec, shape)


def elementwise(fn: Callable, *xs: Any, op: str,
                whole_dims: Sequence[int] = ()) -> Any:
    """``fn(*xs)`` by the rule: per position (rule 1) when the operands'
    layouts allow it, else on the gathered operands (rule 3). ``fn`` maps
    blocks to a block of the broadcast shape; ``whole_dims`` are the
    dimensions it reduces along."""
    if not any(isinstance(x, ShardedTensor) for x in xs):
        return fn(*xs)
    mesh = _common_mesh(xs)
    shape = tuple(torch.broadcast_shapes(
        *(s for s in map(_tensor_shape, xs) if s is not None)))
    spec = (_elementwise_spec(xs, shape, whole_dims)
            if mesh is not None else None)
    if spec is None:
        why = ("operands on different meshes" if mesh is None else
               "operands shard a dimension differently, or a reduced one")
        return fn(*_gather_all(xs, op, why))
    return _assemble(mesh, fn, xs, spec, shape)


def _part_index(mesh: Mesh, entry: Any, idx) -> int:
    pos = dict(zip(mesh.axis_names, idx))
    part = 0
    for a in _axes_of(entry):
        part = part * mesh.shape[a] + pos[a]
    return part


def matmul(a: Any, b: Any, fn: Callable, op: str,
           out_dtype: Optional[torch.dtype] = None) -> Any:
    """``C = fn(A, B)`` for a 2-d product ``A (m, k) @ B (k, n)`` by the
    rule: per position when neither side shards the contraction (the
    output is laid out (A's rows, B's columns)); the position-order psum
    when one side shards it and the other shards it alike or holds it
    whole (then cut to each position's slice); a counted gather
    otherwise. ``fn`` returns a block's product (its partial, under the
    psum); ``out_dtype`` is the output's dtype, applied after the sum."""
    def cast(t):
        return t if out_dtype is None or t.dtype == out_dtype \
            else t.to(out_dtype)

    if not (isinstance(a, ShardedTensor) or isinstance(b, ShardedTensor)):
        return cast(fn(a, b))
    mesh = _common_mesh((a, b))
    (a0, ak) = a.spec if isinstance(a, ShardedTensor) else (None, None)
    (bk, b1) = b.spec if isinstance(b, ShardedTensor) else (None, None)
    kentry = ak if ak is not None else bk
    rows, cols, k = _axes_of(a0), _axes_of(b1), _axes_of(kentry)
    ok = (mesh is not None and ak in (None, kentry) and bk in (None, kentry)
          and not set(rows) & set(cols)
          and not (set(rows) | set(cols)) & set(k))
    if not ok:
        why = ("operands on different meshes" if mesh is None else
               "the contraction is sharded differently on the two sides, "
               "or on an axis the output uses")
        ad, bd = _gather_all((a, b), op, why)
        return cast(fn(ad, bd))
    shape = (a.shape[0], b.shape[1])
    if not k:
        return _assemble(mesh, lambda x, y: cast(fn(x, y)), (a, b),
                         (a0, b1), shape, take=_own_block)
    # rule 2: partials per position (a side that holds the contraction
    # whole is cut to the position's slice), summed over the contraction
    # axes in position order; positions differing only there share a sum
    kshape = a.shape[1]
    partial: Dict[Any, torch.Tensor] = {}
    groups: Dict[tuple, List] = {}
    for idx in mesh.positions():
        key = tuple(i for n, i in zip(mesh.axis_names, idx) if n not in k)
        groups.setdefault(key, []).append(idx)
        if not mesh.is_local(idx):
            partial[idx] = None
            continue
        dev = mesh.devices[idx]
        ks = region_of(mesh, (kentry,), (kshape,), idx)[0]
        xa = a.shards[idx] if isinstance(a, ShardedTensor) else a
        yb = b.shards[idx] if isinstance(b, ShardedTensor) else b
        pkey = (dev, id(xa), id(yb), ks.start)
        if pkey not in partial:
            x = xa if ak is not None else xa[:, ks]
            y = yb if bk is not None else yb[ks]
            partial[pkey] = fn(move(x, dev), move(y, dev))
        partial[idx] = partial[pkey]
    shards = np.empty(mesh.devices.shape, dtype=object)
    sums: Dict[tuple, torch.Tensor] = {}  # groups of replicas share one
    for group in groups.values():
        group.sort(key=lambda i: _part_index(mesh, kentry, i))
        owners = [int(mesh.owners[i]) for i in group]
        if mesh.rank not in owners:
            continue
        parts = [partial[i] for i in group]
        skey = tuple(id(t) for t in parts)
        if skey not in sums:
            sums[skey] = cast(position_sum(parts, owners=owners))
        for i in group:
            if not mesh.is_local(i):
                continue
            dev = mesh.devices[i]
            shards[i] = sums.setdefault(skey + (dev,),
                                        move(sums[skey], dev))
    return ShardedTensor(shards, mesh, (a0, b1), shape)


def _rows_only(x: ShardedTensor) -> bool:
    return all(e is None for e in x.spec[1:])


def take_rows(table: Any, idx: torch.Tensor, op: str) -> torch.Tensor:
    """``table.index_select(0, idx)`` by the rule: a table whose rows
    are sharded (the other dimensions whole) picks, at each position,
    the ids that fall in its rows (0 elsewhere) and the picks are summed
    in position order — one non-zero term per id, so the sum is exact.
    The result is on the first position's device. Any other layout
    gathers (counted)."""
    if not isinstance(table, ShardedTensor):
        return table.index_select(0, idx)
    if not _rows_only(table) or table.mesh.spans_processes:
        return whole(table, op, "the rows are not the only sharded "
                     "dimension").index_select(0, idx)
    if table.spec[0] is None:
        return table.first().index_select(0, idx.to(table.device))
    return take_rows_of_blocks([table.shards[p]
                                for p in table.distinct_positions()], idx)


def take_rows_of_blocks(blocks: Sequence[torch.Tensor],
                        idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of the row blocks' concatenation, on the first
    block's device: each block picks the ids in its rows (0 elsewhere)
    and the picks are summed in block order (one non-zero term per id)."""
    dev, start, parts = blocks[0].device, 0, []
    for b in blocks:
        ids = move(idx, b.device) - start
        mine = (ids >= 0) & (ids < b.shape[0])
        picked = b.index_select(0, ids.clamp(0, b.shape[0] - 1))
        parts.append(torch.where(mine.view(-1, *([1] * (b.ndim - 1))),
                                 picked, picked.new_zeros(())))
        start += b.shape[0]
    return position_sum(parts, dev)


def local_view(t: BlockedTensor, idx) -> Optional[BlockedTensor]:
    """Position ``idx``'s block of a placed BlockedTensor as a
    BlockedTensor of its own: the logical extent that falls in the
    position's region (padding rows past the logical end stay margin), a
    sharded dimension blocked as one block; None when the region holds
    no logical element. A value that is not placed is returned as it
    is."""
    d = t.data
    if not isinstance(d, ShardedTensor):
        return t
    shape, block = [], []
    for dim, sl in enumerate(d.region(idx)):
        if d.spec[dim] is None:
            shape.append(t.meta.shape[dim])
            block.append(t.meta.block_shape[dim])
            continue
        logical = min(max(t.meta.shape[dim] - sl.start, 0),
                      sl.stop - sl.start)
        if logical == 0:
            return None
        shape.append(logical)
        block.append(sl.stop - sl.start)
    return BlockedTensor(d.shards[idx], BlockMeta(tuple(shape),
                                                  tuple(block)))


def row_blocks(t: BlockedTensor, op: str) -> List[torch.Tensor]:
    """The logical rows of a (rows x cols) BlockedTensor as blocks in row
    order, for a driver that works row block by row block: one block per
    distinct row block of a row-sharded placement, on its position's
    device (the padding rows and columns cut off; a block of padding
    only is left out), or the whole logical tensor as one block (a
    one-device value; any other placed layout is gathered, counted)."""
    d = t.data
    if not isinstance(d, ShardedTensor) or d.spec[0] is None \
            or not _rows_only(d) or d.mesh.spans_processes:
        if isinstance(d, ShardedTensor):
            t = t.with_data(whole(d, op, "the rows are not the only "
                                  "sharded dimension"))
        return [t.to_dense()]
    views = (local_view(t, p) for p in d.distinct_positions())
    return [v.to_dense() for v in views if v is not None]


def dense(t: Any) -> torch.Tensor:
    """The logical value of a BlockedTensor, a sharded value or a tensor
    as one tensor on its first position's device: the caller's explicit
    read of a result (``ShardedTensor.to_dense``), not logged — an op
    that gathers calls ``mesh.gather_placed``."""
    data = t.data if isinstance(t, BlockedTensor) else t
    if isinstance(data, ShardedTensor):
        data = data.to_dense()
    if isinstance(t, BlockedTensor):
        data = data[tuple(slice(0, s) for s in t.shape)]
    return data


def host_array(t: Any) -> np.ndarray:
    """:func:`dense` read to the host."""
    return dense(t).detach().cpu().numpy()
