"""Declarative set placement — counterpart of
``netsdb_tpu/parallel/placement.py``.

Distribution is a property of the set: ``Client.create_set(placement=...)``
records a :class:`Placement` (mesh axes + one spec entry per tensor
dimension), and every tensor stored into the set is placed with it, so
the query executor sees values already sharded over the mesh. A
placement is data, not device handles: it lives in the catalog as JSON
(``to_meta``) and materialises the same :class:`~netsdb_tpu_torch.
parallel.mesh.Mesh` for equal axes and devices (``mesh()``, cached).

Degraded-hardware rule, as in the reference: if the process has fewer
device positions than the declared mesh, the placement collapses to a
trivial mesh of size 1 on every axis. Data stays correct; parallelism
degrades.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from netsdb_tpu_torch.core.blocked import BlockedTensor
from netsdb_tpu_torch.parallel.mesh import (Mesh, ShardedTensor, as_sharded,
                                            cached_mesh, shard_blocked,
                                            visible_devices)


def _canon_axis(entry: Any) -> Any:
    """Spec entry → hashable canonical form (None | str | tuple[str])."""
    if entry is None or isinstance(entry, str):
        return entry
    return tuple(entry)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Mesh axes + per-dimension spec for one set.

    ``axes``: ((name, size), ...) — size 0 means "all remaining device
    positions on this axis". ``spec``: one entry per tensor dimension:
    ``None`` (replicated), an axis name, or a tuple of axis names.
    """

    axes: Tuple[Tuple[str, int], ...]
    spec: Tuple[Any, ...]

    # --- constructors -------------------------------------------------
    @staticmethod
    def data_parallel(ndim: int = 1, n_devices: int = 0,
                      axis: str = "data") -> "Placement":
        """Rows over ``axis``, everything else replicated."""
        return Placement(((axis, n_devices),),
                         (axis,) + (None,) * (ndim - 1))

    @staticmethod
    def replicated(ndim: int = 2, n_devices: int = 0,
                   axis: str = "data") -> "Placement":
        """A whole copy at every position (model weights)."""
        return Placement(((axis, n_devices),), (None,) * ndim)

    # --- catalog round-trip -------------------------------------------
    def to_meta(self) -> Dict[str, Any]:
        spec = [list(s) if isinstance(s, tuple) else s for s in self.spec]
        return {"axes": [list(a) for a in self.axes], "spec": spec}

    @staticmethod
    def from_meta(meta: Optional[Dict[str, Any]]) -> Optional["Placement"]:
        if not meta:
            return None
        axes = tuple((str(n), int(s)) for n, s in meta["axes"])
        spec = tuple(_canon_axis(s) for s in meta["spec"])
        return Placement(axes, spec)

    # --- materialisation ----------------------------------------------
    def resolved_axes(self, n_devices: Optional[int] = None
                      ) -> Tuple[Tuple[str, int], ...]:
        """Axis sizes with 0 resolved to "the remaining positions", and
        every axis collapsed to 1 when the process cannot supply enough
        positions (the degraded-hardware rule). ``n_devices`` defaults
        to the number of visible positions."""
        n = n_devices if n_devices is not None else len(visible_devices())
        fixed = math.prod(s for _, s in self.axes if s > 0)
        free = sum(1 for _, s in self.axes if s == 0)
        if free > 1:
            raise ValueError(
                f"placement axes {self.axes}: at most one axis may have "
                f"size 0 (= all remaining devices); {free} do")
        remaining = n // fixed if fixed <= n else 0
        out = tuple((name, max(1, remaining) if size == 0 else size)
                    for name, size in self.axes)
        if math.prod(s for _, s in out) > n:
            return tuple((name, 1) for name, _ in self.axes)
        return out

    def mesh(self, devices: Optional[Sequence[torch.device]] = None) -> Mesh:
        """The mesh over ``devices`` (default: the visible positions)."""
        devices = tuple(devices if devices is not None else visible_devices())
        return cached_mesh(self.resolved_axes(len(devices)), devices)

    def axis_size(self, devices: Optional[Sequence[torch.device]] = None
                  ) -> int:
        """Total number of shards along the sharded dimensions."""
        mesh = self.mesh(devices)
        total = 1
        for entry in self.spec:
            if entry is None:
                continue
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                total *= mesh.shape[ax]
        return total

    def label(self) -> str:
        """Human form, e.g. ``mesh[sp=4]:P(None,sp,None)``."""
        ax = ",".join(f"{n}={s}" for n, s in self.axes)
        sp = ",".join("None" if s is None else str(s) for s in self.spec)
        return f"mesh[{ax}]:P({sp})"

    # --- data placement ----------------------------------------------
    def apply(self, value: Any) -> Any:
        """Place a stored value on this placement's mesh, built over the
        visible positions of the value's device type. Tensors become
        :class:`ShardedTensor`s; a ``BlockedTensor`` keeps its blocks
        and gets sharded data (a dimension its padded shape cannot
        divide stays replicated); other host objects are stored as they
        are."""
        if type(value).__name__ == "ColumnTable":
            # row-sharded relations are relational/sharded.py
            raise NotImplementedError(
                "placing a relational ColumnTable (row-sharded relations) "
                "is not ported yet: ROADMAP.md A4")
        if isinstance(value, BlockedTensor):
            return shard_blocked(value, self.mesh(
                visible_devices(value.device.type)), self.spec)
        if isinstance(value, (torch.Tensor, ShardedTensor)):
            return as_sharded(value, self.mesh(
                visible_devices(value.device.type)), self.spec)
        return value
