"""Helpers shared by the model families: set creation, input dtype and
the SGD step of their ``train_step``, on one device or over placed
params and inputs (:func:`sgd_step`)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch

from netsdb_tpu_torch.core.blocked import BlockedTensor
from netsdb_tpu_torch.ops.common import full_f32_precision
from netsdb_tpu_torch.parallel import placed_ops
from netsdb_tpu_torch.parallel.mesh import (Mesh, ShardedTensor, as_sharded,
                                            move, position_sum)


def as_f32(x):
    """A tensor as f32 where it lies; anything else as an f32 array."""
    return x.float() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def create_sets(client, db: str, sets: Iterable[str],
                placements: Optional[Mapping[str, object]] = None,
                type_name: str = "tensor") -> None:
    """Create ``db`` and its ``sets``, each with its placement from
    ``placements`` (set name → Placement): a placed set stores its
    tensors over the placement's mesh, and the model's DAG runs over them
    by the placed-op rule (``parallel/placed_ops``)."""
    client.create_database(db)
    for s in sets:
        client.create_set(db, s, type_name=type_name,
                          placement=(placements or {}).get(s))


def _tensor_of(value, what: str) -> torch.Tensor:
    """The tensor a parameter or an input holds; an inference tensor (a
    set written by a DAG: the executor runs under
    ``torch.inference_mode()``) cannot be saved for backward."""
    t = value.data if isinstance(value, BlockedTensor) else value
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"train_step: {what} is a {type(t).__name__}, "
                        f"not a tensor")
    if t.is_inference():
        raise ValueError(
            f"train_step: {what} is an inference tensor (a set written by "
            f"a DAG); train on params loaded with send_matrix or "
            f"load_weights and read back with params_from_store, or pass "
            f"a clone()")
    return t


def sgd_step(loss_fn: Callable, params, lr: float, *args):
    """One step of plain SGD, the reference's ``jax.value_and_grad``
    followed by ``tree_map(lambda p, g: p - lr * g)``: ``loss_fn(params,
    *args)`` is differentiated by autograd with respect to every field of
    the ``params`` dataclass (the whole padded data of a BlockedTensor,
    or a tensor), with f32 products at full precision. Returns ``(new
    params, loss)``, both fresh and detached; a field the loss does not
    read keeps its value (its gradient is zero).

    Placed params or inputs (a ``ShardedTensor`` in a field or argument)
    take :func:`_placed_sgd_step`."""
    if _has_placed(params, args):
        return _placed_sgd_step(loss_fn, params, lr, args)
    grads, loss = _grads(loss_fn, params, args, 1.0)
    return _updated(params, grads, lr), loss


def _updated(params, grads, lr: float, base=None):
    """``params`` after one SGD step with ``grads`` (one per field, None
    where the loss does not read it: the field keeps its value); the
    fields' values are ``base`` (name → tensor) where given."""
    new = {}
    for f, g in zip(dataclasses.fields(params), grads):
        old = getattr(params, f.name)
        t = base[f.name] if base is not None else (
            old.data if isinstance(old, BlockedTensor) else old)
        t = t.detach() - lr * g if g is not None else t.detach().clone()
        new[f.name] = old.with_data(t) if isinstance(old, BlockedTensor) \
            else t
    return dataclasses.replace(params, **new)


# --- the step over placed params and inputs --------------------------------

def _placed_data(v: Any) -> Optional[ShardedTensor]:
    d = v.data if isinstance(v, BlockedTensor) else v
    return d if isinstance(d, ShardedTensor) else None


def _has_placed(params, args) -> bool:
    return any(_placed_data(getattr(params, f.name)) is not None
               for f in dataclasses.fields(params)) or any(
        _placed_data(a) is not None for a in args)


def rows_like(y, x: BlockedTensor) -> Any:
    """Per-row values ``y`` (batch,) laid out like the rows of ``x``
    (batch x ...): a 1-d BlockedTensor with x's row blocking, placed with
    x's row spec when x is placed (a data-parallel step then gives each
    position its own rows' values)."""
    xd = _placed_data(x)
    y = y if isinstance(y, torch.Tensor) else torch.as_tensor(
        np.asarray(y, np.float32))
    yb = BlockedTensor.from_dense(y.float(), (x.meta.block_shape[0],),
                                  device=x.device)
    if xd is None:
        return yb
    return yb.with_data(as_sharded(yb.data, xd.mesh, (xd.spec[0],)))


def _data_parallel(params, args) -> Optional[Tuple[Mesh, Any]]:
    """(mesh, batch entry) when every param is whole (a plain tensor or a
    value held whole at every position) and every placed argument is a
    BlockedTensor that splits at most one dimension, those that split one
    all over one mesh and one entry (the batch); else None."""
    for f in dataclasses.fields(params):
        d = _placed_data(getattr(params, f.name))
        if d is not None and any(d.parts(i) > 1 for i in range(d.ndim)):
            return None
    found = set()
    for a in args:
        d = _placed_data(a)
        if d is None:
            continue
        entries = [d.spec[i] for i in range(d.ndim) if d.parts(i) > 1]
        if not isinstance(a, BlockedTensor) or len(entries) > 1:
            return None
        if entries:
            found.add((id(d.mesh), entries[0]))
            mesh = d.mesh
    if len(found) != 1:
        return None
    return mesh, next(iter(found))[1]


def _whole_value(v: Any, op: str, why: str) -> Any:
    if isinstance(v, BlockedTensor):
        return v.with_data(placed_ops.whole(v.data, op, why))
    return placed_ops.whole(v, op, why)


def _replace_like(old: Any, new: Any) -> Any:
    """``new`` (one device) laid out as ``old`` was: a placed value is
    placed again over its mesh and spec (one copy per device, the same
    bits everywhere)."""
    d = _placed_data(old)
    if d is None:
        return new
    data = new.data if isinstance(new, BlockedTensor) else new
    placed = as_sharded(data, d.mesh, d.spec)
    return new.with_data(placed) if isinstance(new, BlockedTensor) \
        else placed


def _placed_sgd_step(loss_fn: Callable, params, lr: float, args):
    """:func:`sgd_step` over placed params or inputs.

    Data-parallel (every param whole, the inputs sharded over one batch
    entry): each distinct batch block runs forward and backward on its
    own position with a local copy of the params, its loss weighted by
    its share of the logical batch (the one-device loss is a mean over
    the batch); the gradients are summed in position order, one SGD
    update is applied on the first position and the new params are
    placed again, so every replica holds the same bits. Any other layout
    gathers the placed params and inputs onto the first position
    (counted), runs the one-device step, and places the new params back
    in their layouts."""
    names = [f.name for f in dataclasses.fields(params)]
    dp = _data_parallel(params, args)
    if dp is None:
        why = ("train_step runs the one-device step (the layouts are not "
               "data-parallel: a param split, or an input split other "
               "than by one batch dimension)")
        flat = dataclasses.replace(params, **{
            n: _whole_value(getattr(params, n), "train_step", why)
            for n in names})
        new, loss = sgd_step(loss_fn, flat, lr, *(
            _whole_value(a, "train_step", why) for a in args))
        return dataclasses.replace(new, **{
            n: _replace_like(getattr(params, n), getattr(new, n))
            for n in names}), loss
    mesh, entry = dp
    first = next(_placed_data(a) for a in args
                 if _placed_data(a) is not None
                 and entry in _placed_data(a).spec)
    bdim = first.spec.index(entry)
    total = next(a for a in args if _placed_data(a) is first).meta.shape[bdim]
    grads, losses = [], []
    for idx in first.distinct_positions():
        local = [placed_ops.local_view(a, idx)
                 if _placed_data(a) is not None else a for a in args]
        if any(v is None for v in local):
            continue  # a block of padding rows only
        dev = mesh.devices[idx]
        rows = next(v for v, a in zip(local, args)
                    if _placed_data(a) is first).meta.shape[bdim]
        mine = dataclasses.replace(params, **{
            n: _on_position(getattr(params, n), idx, dev) for n in names})
        g, loss = _grads(loss_fn, mine, local, rows / total)
        grads.append(g)
        losses.append(loss)
    dev0 = mesh.devices.flat[0]
    pos0 = next(iter(mesh.positions()))
    base, summed = {}, []
    for i, n in enumerate(names):
        mine = _on_position(getattr(params, n), pos0, dev0)
        base[n] = mine.data if isinstance(mine, BlockedTensor) else mine
        present = [g[i] for g in grads if g[i] is not None]
        summed.append(position_sum(present, dev0) if present else None)
    new = _updated(params, summed, lr, base)
    return dataclasses.replace(params, **{
        n: _replace_like(getattr(params, n), getattr(new, n))
        for n in names}), position_sum(losses, dev0)


def _on_position(v: Any, idx, device) -> Any:
    """A whole param's copy at position ``idx``: a replicated value's
    shard there, a plain tensor moved there."""
    d = _placed_data(v)
    t = d.shards[idx] if d is not None else (
        v.data if isinstance(v, BlockedTensor) else v)
    t = move(t, device)
    return v.with_data(t) if isinstance(v, BlockedTensor) else t


def _grads(loss_fn: Callable, params, args: List[Any],
           weight: float) -> Tuple[List[Optional[torch.Tensor]],
                                   torch.Tensor]:
    """The gradients of ``weight * loss_fn(params, *args)`` with respect
    to every field of ``params``, and that weighted loss (detached)."""
    leaves = {f.name: _tensor_of(getattr(params, f.name),
                                 f"params.{f.name}").detach().requires_grad_()
              for f in dataclasses.fields(params)}
    for i, a in enumerate(args):
        if isinstance(a, (BlockedTensor, torch.Tensor)):
            _tensor_of(a, f"argument {i + 1}")
    full_f32_precision()

    def wrap(name, data):
        old = getattr(params, name)
        return old.with_data(data) if isinstance(old, BlockedTensor) else data

    with torch.inference_mode(False), torch.enable_grad():
        trainable = dataclasses.replace(
            params, **{n: wrap(n, leaf) for n, leaf in leaves.items()})
        loss = loss_fn(trainable, *args)
        if weight != 1.0:
            loss = loss * weight
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    return list(grads), loss.detach()
