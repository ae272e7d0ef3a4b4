"""Declarative set placement — counterpart of
``netsdb_tpu/parallel/placement.py``.

Distribution is a property of the set: ``Client.create_set(placement=...)``
records a :class:`Placement` (mesh axes + one spec entry per tensor
dimension), and every tensor stored into the set is placed with it, so
the query executor sees values already sharded over the mesh. A
placement is data, not device handles: it lives in the catalog as JSON
(``to_meta``) and materialises the same :class:`~netsdb_tpu_torch.
parallel.mesh.Mesh` for equal axes and devices (``mesh()``, cached).

A relation set's placement lays its table out row by row
(:func:`shard_table`): fact tables row-sharded, dimensions replicated.
:func:`local_tables` gives each position's block, :func:`gather_table`
the whole relation again.

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

    def mesh_label(self, device_type: str = "cuda") -> str:
        """The label plus the resolved mesh over the visible positions of
        ``device_type`` (its shape and devices): two layouts of one
        placement over different position sets label apart."""
        mesh = self.mesh(visible_devices(device_type))
        devs = ",".join(str(d) for d in mesh.devices.flat)
        return f"{self.label()}{dict(mesh.shape)}[{devs}]"

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
        divide stays replicated); a ``ColumnTable`` gets row-sharded (or
        replicated) columns (:func:`shard_table`); other host objects
        are stored as they are."""
        from netsdb_tpu_torch.relational.table import ColumnTable

        if isinstance(value, ColumnTable):
            return shard_table(value, self)
        if isinstance(value, BlockedTensor):
            return shard_blocked(value, self.mesh(
                visible_devices(value.device.type)), self.spec)
        if isinstance(value, (torch.Tensor, ShardedTensor)):
            return as_sharded(value, self.mesh(
                visible_devices(value.device.type)), self.spec)
        return value


def shard_table(table, placement: Placement, keep_stats: bool = False):
    """A ``ColumnTable`` laid out by a 1-d placement over the mesh of the
    visible positions of its device type (:func:`lay_out_table`). The
    planner's statistics are those of the padded columns, as in the
    reference (``keep_stats`` carries the source table's instead: a chunk
    of a paged relation, whose statistics are the relation's)."""
    if len(placement.spec) != 1:
        raise ValueError(f"table placement needs a 1-d spec (rows); got "
                         f"{placement.spec}")
    if is_placed_table(table):
        table = gather_table(table, strip=True)
    mesh = placement.mesh(visible_devices(table.device.type))
    out = lay_out_table(table, mesh, placement.spec, keep_stats)
    out.__dict__["_placement"] = placement
    return out


def lay_out_table(table, mesh: Mesh, spec, keep_stats: bool = False):
    """``table`` over ``mesh`` by a 1-d row ``spec``: the rows are padded
    to the shard granularity with invalid rows (a sharded dimension
    divides the position count), and every column and the validity mask
    become :class:`ShardedTensor` s — row blocks over a sharded axis, a
    whole copy (one per physical device) when replicated. The padding
    rows are False in the mask, so every fold's ``_fold_mask`` turns them
    into -1 keys and 0 measures."""
    from netsdb_tpu_torch.relational.stats import analyze_table
    from netsdb_tpu_torch.relational.table import _STATS_ATTR, ColumnTable

    spec = tuple(spec)
    n = table.num_rows
    entry = spec[0]
    div = (1 if entry is None else math.prod(
        mesh.shape[a] for a in (entry if isinstance(entry, tuple)
                                else (entry,))))
    pad = (-n) % div
    cols = {}
    for name, col in table.cols.items():
        if pad:
            col = torch.cat([col, col.new_zeros((pad,) + col.shape[1:])])
        cols[name] = col
    valid = table.mask()
    if pad:
        valid = torch.cat([valid, valid.new_zeros((pad,))])
    padded = ColumnTable(cols, table.dicts, valid)
    stats = (dict(table.__dict__.get(_STATS_ATTR) or {}) if keep_stats
             else dict(analyze_table(padded)))
    out = ColumnTable({k: as_sharded(c, mesh, spec)
                       for k, c in cols.items()}, table.dicts,
                      as_sharded(valid, mesh, spec))
    out.__dict__[_STATS_ATTR] = stats
    out.__dict__["_source_rows"] = n
    return out


def is_placed_table(value: Any) -> bool:
    """True for a ``ColumnTable`` whose columns are laid out over a mesh
    (:func:`shard_table`)."""
    from netsdb_tpu_torch.relational.table import ColumnTable

    return (isinstance(value, ColumnTable) and bool(value.cols)
            and isinstance(next(iter(value.cols.values())), ShardedTensor))


def table_layout(table) -> Tuple[Mesh, Tuple[Any, ...]]:
    """The mesh and the row spec of a placed table."""
    first = next(iter(table.cols.values()))
    return first.mesh, first.spec


def local_tables(table, rowid: bool = False) -> list:
    """The placed table's block at each position, in position order: a
    ``ColumnTable`` of the position's tensors (its rows, or a whole copy
    when replicated). ``rowid`` adds a ``_rowid`` column of GLOBAL row
    numbers where the table has none (folds arbitrate ties on them)."""
    from netsdb_tpu_torch.relational.table import ColumnTable

    first = next(iter(table.cols.values()))
    mesh = first.mesh
    out = []
    for idx in mesh.positions():
        cols = {k: c.shards[idx] for k, c in table.cols.items()}
        valid = table.valid.shards[idx] if table.valid is not None else None
        if rowid and "_rowid" not in cols:
            start = first.region(idx)[0].start
            n = first.local_shape[0]
            cols["_rowid"] = torch.arange(
                start, start + n, dtype=torch.int32,
                device=mesh.devices[idx])
        out.append(ColumnTable(cols, table.dicts, valid))
    return out


def row_tables(table) -> list:
    """A relation's rows as tables in row order, for a driver that works
    block by block: one per distinct row block of a placed table (each
    position's, on its device; positions that hold a replica are left
    out, and a replicated table gives one), or the table itself."""
    if not is_placed_table(table):
        return [table]
    first = next(iter(table.cols.values()))
    local = dict(zip(first.mesh.positions(), local_tables(table)))
    return [local[idx] for idx in first.distinct_positions()]


def gather_table(table, strip: bool = False):
    """A placed table gathered into one ``ColumnTable`` on its first
    position's device (row blocks concatenated in position order), the
    padding rows kept and masked invalid — or cut off with ``strip``
    (the relation as it was sent; its statistics are then collected
    anew)."""
    from netsdb_tpu_torch.relational.table import _STATS_ATTR, ColumnTable

    cols = {k: c.to_dense() for k, c in table.cols.items()}
    valid = table.valid.to_dense() if table.valid is not None else None
    rows = table.__dict__.get("_source_rows")
    if strip and rows is not None:
        cols = {k: c[:rows] for k, c in cols.items()}
        valid = valid[:rows] if valid is not None else None
        if valid is not None and bool(valid.all()):
            valid = None
        return ColumnTable(cols, table.dicts, valid)
    out = ColumnTable(cols, table.dicts, valid)
    stats = table.__dict__.get(_STATS_ATTR)
    if stats is not None:
        out.__dict__[_STATS_ATTR] = dict(stats)
    return out
