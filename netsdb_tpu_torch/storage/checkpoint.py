"""Checkpoints — the port's ``netsdb_tpu/storage/checkpoint.py``: the
step layout, parameter snapshots and whole-store snapshots.

The reference's "checkpoint" is storage-level: weight sets flushed to
disk survive a restart and the catalog persists the metadata
(``storage/store.py`` ``flush``/``load_set``). On top of that this
module keeps numbered snapshots under one root, ``root/step_<n>``:

* :func:`save`/:func:`restore` snapshot a parameter tree (``FFParams``,
  dicts, lists, tuples) in the reference's own format when orbax is
  absent — one ``leaves.npz`` holding one array per leaf
  (``leaf_<i>``) and ``treedef.json`` with the leaf count — so a
  snapshot the port writes, the reference restores. Leaves are visited
  in the reference's pytree order: dict keys sorted, sequences and
  dataclass fields in order, a ``BlockedTensor``'s padded data as its
  one leaf, ``None`` as no leaf. A placed tensor (a ``ShardedTensor``)
  is saved as its logical array; :func:`restore` takes the blocking
  and the placement from the caller's template and puts every leaf on
  the template leaf's device (or ``device``).
* :func:`dumps_store`/:func:`save_store_bytes`/:func:`load_store` carry
  the serve layer's whole-store snapshot (follower resync): one pickle
  blob, because sets hold host objects that are not numeric trees.

TRUST BOUNDARY: :func:`load_store`/:func:`loads_store` execute pickle —
the serve protocol's codec-1 boundary; the RESYNC_FOLLOWER handler
therefore requires ``allow_pickle`` on the follower daemon."""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d+)$")


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step}")


def list_steps(root: str) -> list:
    """All checkpointed steps under ``root``, ascending."""
    if not os.path.isdir(root):
        return []
    steps = []
    for name in os.listdir(root):
        m = _STEP_RE.match(name)
        if m and os.path.isdir(os.path.join(root, name)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(root: str) -> Optional[int]:
    steps = list_steps(root)
    return steps[-1] if steps else None


# --- parameter trees ---------------------------------------------------

def _flatten(tree: Any) -> Tuple[List[Any], Callable[..., Any]]:
    """(leaves, rebuild): the leaves in the reference's pytree order and
    ``rebuild(leaves, device)``, which rebuilds ``tree``'s structure from
    new leaves (each takes its template leaf's blocking, placement and
    dtype, and its device unless ``device`` is given)."""
    from netsdb_tpu_torch.core.blocked import BlockedTensor

    if tree is None:
        return [], lambda leaves, device: None
    if isinstance(tree, BlockedTensor):
        meta, data = tree.meta, tree.data
        return [data], lambda leaves, device: BlockedTensor(
            _like(leaves[0], data, device), meta)
    if isinstance(tree, dict):
        keys = sorted(tree)
        return _flatten_seq([tree[k] for k in keys],
                            lambda vals: dict(zip(keys, vals)))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(tree)]
        cls = type(tree)
        return _flatten_seq([getattr(tree, n) for n in names],
                            lambda vals: cls(**dict(zip(names, vals))))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = type(tree)
        return _flatten_seq(list(tree), lambda vals: cls(*vals))
    if isinstance(tree, (list, tuple)):
        kind = type(tree)
        return _flatten_seq(list(tree), lambda vals: kind(vals))
    return [tree], lambda leaves, device: _like(leaves[0], tree, device)


def _flatten_seq(children: List[Any], make: Callable[[List[Any]], Any]):
    leaves: List[Any] = []
    rebuilds = []
    for child in children:
        cl, rb = _flatten(child)
        rebuilds.append((len(leaves), len(cl), rb))
        leaves.extend(cl)

    def rebuild(new: List[Any], device) -> Any:
        return make([rb(new[start:start + n], device)
                     for start, n, rb in rebuilds])

    return leaves, rebuild


def _host_leaf(leaf: Any) -> np.ndarray:
    """A leaf as the host array the snapshot stores (a placed tensor as
    its logical array; bf16, which numpy lacks, as float32)."""
    from netsdb_tpu_torch.parallel.mesh import ShardedTensor

    if isinstance(leaf, ShardedTensor):
        leaf = leaf.to_dense()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def _like(value: np.ndarray, template: Any, device=None) -> Any:
    """``value`` shaped as ``template``: a tensor of its dtype on its
    device (or the restore's ``device``), placed as it is placed."""
    from netsdb_tpu_torch.parallel.mesh import ShardedTensor

    if isinstance(template, ShardedTensor):
        dense = torch.as_tensor(np.asarray(value)).to(
            template.dtype).to(template.device)
        return ShardedTensor.from_dense(dense, template.mesh, template.spec)
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(np.array(value)).to(
            dtype=template.dtype, device=device or template.device)
    if isinstance(template, np.ndarray):
        return np.asarray(value, dtype=template.dtype)
    return value


def save(root: str, tree: Any, step: int) -> str:
    """Snapshot ``tree`` as ``root/step_<step>`` (the reference's
    orbax-less format; an existing snapshot of the same step is
    overwritten, as a retrying training loop needs). Returns the step
    directory."""
    path = _step_dir(root, step)
    os.makedirs(path, exist_ok=True)
    leaves, _ = _flatten(tree)
    np.savez(os.path.join(path, "leaves.npz"),
             **{f"leaf_{i}": _host_leaf(x) for i, x in enumerate(leaves)})
    with open(os.path.join(path, "treedef.json"), "w") as f:
        json.dump({"n_leaves": len(leaves)}, f)
    return path


def restore(root: str, target: Any, step: Optional[int] = None,
            device=None) -> Any:
    """Restore into the structure of ``target`` (a template tree with
    the right shapes, as in the reference). ``step`` defaults to the
    latest; ``device`` overrides the template leaves' devices."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    path = _step_dir(root, step)
    npz = os.path.join(path, "leaves.npz")
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    if not os.path.exists(npz):
        raise FileNotFoundError(
            f"checkpoint at {path} is not in the leaves.npz format (an "
            f"orbax checkpoint of the reference): the port reads only "
            f"leaves.npz")
    leaves_t, rebuild = _flatten(target)
    with open(os.path.join(path, "treedef.json")) as f:
        n_saved = json.load(f)["n_leaves"]
    if n_saved != len(leaves_t):
        raise ValueError(f"checkpoint has {n_saved} leaves, target "
                         f"expects {len(leaves_t)}")
    with np.load(npz) as data:
        leaves = [data[f"leaf_{i}"] for i in range(n_saved)]
    return rebuild(leaves,
                   torch.device(device) if device is not None else None)


# --- whole-store snapshots (follower resync) ---------------------------
# The serve layer's fault-tolerance path: when a follower daemon is
# evicted, the leader snapshots its store and the follower rebuilds from
# the snapshot before it is readmitted — the same step-dir convention as
# parameter checkpoints, but the payload is one opaque pickle.

_STORE_FILE = "store.pkl"


def dumps_store(snapshot: Any) -> bytes:
    """Snapshot → one pickle blob: the leader pickles ONCE, writes the
    blob locally (:func:`save_store_bytes`) and streams it to the
    follower in bounded frames — no shared filesystem. The snapshot
    holds host values only (``ServeController._snapshot_state``)."""
    import pickle

    return pickle.dumps(snapshot, protocol=pickle.HIGHEST_PROTOCOL)


def loads_store(blob) -> Any:
    """Inverse of :func:`dumps_store`; any bytes-like buffer."""
    import pickle

    return pickle.loads(blob)


def save_store_bytes(root: str, blob, step: int) -> str:
    """Persist an already-pickled snapshot blob as ``root/step_<step>``,
    atomically (written to a temporary file, then renamed). Returns the
    step directory."""
    path = _step_dir(root, step)
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, _STORE_FILE)
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, final)
    return path


def save_store(root: str, snapshot: Any, step: int) -> str:
    """Persist ``snapshot`` (any picklable object) as
    ``root/step_<step>``."""
    return save_store_bytes(root, dumps_store(snapshot), step)


def prune_steps(root: str, keep: int = 1) -> list:
    """Delete all but the newest ``keep`` step directories under
    ``root``; returns the removed step numbers."""
    import shutil

    steps = list_steps(root)
    victims = steps[:-keep] if keep > 0 else steps
    for s in victims:
        shutil.rmtree(_step_dir(root, s), ignore_errors=True)
    return victims


_META_FILE = "meta.json"


def save_meta(root: str, step: int, meta: dict) -> str:
    """A small JSON sidecar beside a snapshot step (the serve layer
    records the mutation-log offset the snapshot captured), written
    atomically."""
    path = _step_dir(root, step)
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, _META_FILE)
    tmp = final + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(meta, f)
    os.replace(tmp, final)
    return final


def load_meta(root: str, step: Optional[int] = None) -> Optional[dict]:
    """A :func:`save_meta` sidecar (``step`` defaults to the latest);
    None when the step has none."""
    if step is None:
        step = latest_step(root)
        if step is None:
            return None
    final = os.path.join(_step_dir(root, step), _META_FILE)
    try:
        with open(final, "r", encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def load_store(root: str, step: Optional[int] = None) -> Any:
    """Load a :func:`save_store` snapshot; ``step`` defaults to the
    latest under ``root``. Raises FileNotFoundError when absent."""
    import pickle

    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no store snapshots under {root}")
    final = os.path.join(_step_dir(root, step), _STORE_FILE)
    if not os.path.exists(final):
        raise FileNotFoundError(f"no store snapshot at {final}")
    with open(final, "rb") as f:
        return pickle.load(f)
