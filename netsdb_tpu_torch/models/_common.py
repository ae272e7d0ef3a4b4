"""Helpers shared by the model families: set creation, input dtype and
the SGD step of their ``train_step``."""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Mapping, Optional

import numpy as np
import torch

from netsdb_tpu_torch.core.blocked import BlockedTensor
from netsdb_tpu_torch.ops.common import full_f32_precision


def as_f32(x):
    """A tensor as f32 where it lies; anything else as an f32 array."""
    return x.float() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def create_sets(client, db: str, sets: Iterable[str],
                placements: Optional[Mapping[str, object]] = None,
                type_name: str = "tensor") -> None:
    """Create ``db`` and its ``sets``. The ops of these models take
    tensors on one device, so a placed set raises before anything is
    created."""
    sets = list(sets)
    placed = [s for s in sets if (placements or {}).get(s) is not None]
    if placed:
        raise NotImplementedError(
            f"placed sets {placed} of database {db!r}: these models run on "
            f"one device; multi-device placement is ROADMAP.md A4 part 3")
    client.create_database(db)
    for s in sets:
        client.create_set(db, s, type_name=type_name)


def _tensor_of(value, what: str) -> torch.Tensor:
    """The tensor a parameter or an input holds; an inference tensor (a
    set written by a DAG: the executor runs under
    ``torch.inference_mode()``) cannot be saved for backward."""
    t = value.data if isinstance(value, BlockedTensor) else value
    if not isinstance(t, torch.Tensor):
        raise NotImplementedError(
            f"train_step: {what} is a {type(t).__name__}; training runs on "
            f"tensors of one device (placed sets are ROADMAP.md A4 part 3)")
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
    read keeps its value (its gradient is zero)."""
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
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    new = {n: wrap(n, leaf.detach() - lr * g if g is not None
                   else leaf.detach().clone())
           for (n, leaf), g in zip(leaves.items(), grads)}
    return dataclasses.replace(params, **new), loss.detach()
