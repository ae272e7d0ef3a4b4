"""Pipeline parallelism — the GPipe fill-drain schedule over a mesh
axis; counterpart of ``netsdb_tpu/parallel/pipeline.py``.

Stage i's slice of every parameter leaf lives on position i of the
``pp`` axis. The schedule runs ``n_micro + n_stages - 1`` steps: at step
t stage i works on microbatch t - i (when there is one) and hands its
activation to position i + 1 (the reference's ``ppermute``); the last
stage collects the outputs, which are then copied to every position
(the reference's closing ``psum``, whose other terms are zeros). The
reference's devices compute masked steps too; here only the steps that
carry a microbatch run, so each microbatch meets the same stage ops as a
sequential loop on one position and the output equals that loop's bit
for bit. Groups of positions along the other axes would compute the
same replicated result, so the first group runs it.
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch

from netsdb_tpu_torch.parallel import placed_ops
from netsdb_tpu_torch.parallel.mesh import Mesh, ShardedTensor, move


def _leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _stage(tree: Any, i: int, device: torch.device) -> Any:
    """Stage ``i``'s slice of every leaf, on ``device``."""
    if isinstance(tree, dict):
        return {k: _stage(v, i, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_stage(v, i, device) for v in tree)
    return move(placed_ops.whole(tree, "pipeline_apply",
                                 "stage slices are cut from a whole "
                                 "leaf")[i], device)


def pipeline_apply(stage_fn: Callable, stacked_params: Any,
                   xs: torch.Tensor, mesh: Mesh,
                   axis: str = "pp") -> ShardedTensor:
    """Run ``n_stages`` sequential stages over ``n_micro`` microbatches.

    ``stage_fn(params, x) -> y`` applies ONE stage (x and y of one
    shape). ``stacked_params`` is a nested dict, list or tuple of tensors
    whose leading dimension is the number of stages, the size of
    ``axis``. ``xs`` is (n_micro, ...). Returns the (n_micro, ...)
    outputs replicated over ``mesh``."""
    n_stages = mesh.shape[axis]
    for leaf in _leaves(stacked_params):
        dim = leaf.shape[0] if len(getattr(leaf, "shape", ())) else None
        if dim != n_stages:
            raise ValueError(f"stacked params leading dim {dim} != "
                             f"pipeline stages {n_stages}")
    group = mesh.axis_groups(axis)[0]
    devs = [mesh.devices[p] for p in group]
    params = [_stage(stacked_params, i, devs[i]) for i in range(n_stages)]
    n_micro = xs.shape[0]
    buf: List[Any] = [None] * n_stages  # the activation each stage holds
    outs: List[Any] = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        handed: List[Any] = [None] * n_stages
        for i in range(n_stages):
            m = t - i
            if not 0 <= m < n_micro:
                continue
            y = stage_fn(params[i], move(xs[m], devs[0]) if i == 0
                         else buf[i])
            if i == n_stages - 1:
                outs[m] = y
            else:
                handed[i + 1] = move(y, devs[i + 1])
        buf = handed
    out = torch.stack(outs)
    return ShardedTensor.from_dense(out, mesh, (None,) * out.ndim)
