"""Collective-step resharding — counterpart of
``netsdb_tpu/parallel/reshard.py``: move a placed set between layouts
without a host round-trip.

Per *Memory-efficient array redistribution* (arxiv 2112.01075), a layout
change decomposes into a bounded sequence of collective steps. The
planner (:func:`plan_steps`) covers the lattice a 1-axis mesh needs:

* same spec → no steps;
* sharded → replicated → one ``all_gather``;
* replicated → sharded → one ``local_slice`` (no communication);
* sharded(dim i) → sharded(dim j) over the same axis → one
  ``all_to_all`` (shard-sized messages);
* anything else (other meshes, several axes) → ``all_gather`` then a
  device-to-device ``replace``.

:func:`execute_steps` runs a value through a schedule over the mesh
positions' tensors (:mod:`netsdb_tpu_torch.parallel.mesh`'s
collectives) and ends on exactly the layout a fresh placement gives.
:func:`reshard_set` applies it to a set: a memory set's items move and
the declared placement swaps (``SetStore.set_placement``, the commit
step: no write version moves); a paged set's DEVICE-CACHED blocks move
from the old layout's cache key to the new one's, so the warm requery
under the new layout reads no page. :func:`reshard_summa_layout` moves a
paged tensor set's cached SUMMA blocks between the 1-d and the grid
layout.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from netsdb_tpu_torch import obs
from netsdb_tpu_torch.parallel.mesh import (ShardedTensor, as_sharded, move,
                                            normalize_spec,
                                            position_all_to_all,
                                            position_gather, visible_devices)

for _name in ("reshard.plans", "reshard.steps", "reshard.blocks_moved",
              "reshard.bytes_moved"):
    obs.REGISTRY.counter(_name)


@dataclasses.dataclass(frozen=True)
class Step:
    """One collective step of a reshard schedule. ``kind``:
    ``all_gather`` | ``local_slice`` | ``all_to_all`` | ``replace``;
    ``dim``/``dim_to`` are tensor dims, ``axis`` the mesh axis, ``peak``
    the per-device transient bytes relative to one shard (1: shard-sized
    messages; the axis size: a full replica; 0: a full replica over an
    axis the planner was not given the size of)."""

    kind: str
    dim: int = 0
    dim_to: int = 0
    axis: str = ""
    peak: int = 1

    def label(self) -> str:
        if self.kind == "all_to_all":
            return f"all_to_all[{self.axis}:{self.dim}->{self.dim_to}]"
        if self.kind in ("all_gather", "local_slice"):
            return f"{self.kind}[{self.axis}:{self.dim}]"
        return self.kind


def _axis_name(entry) -> str:
    return entry if isinstance(entry, str) else "+".join(entry)


def _sharded_dims(spec: Tuple, ndim: int) -> List[Tuple[int, Any]]:
    return [(i, spec[i]) for i in range(ndim)
            if i < len(spec) and spec[i] is not None]


def plan_steps(src_spec: Tuple, dst_spec: Tuple, ndim: int,
               same_mesh: bool = True,
               axis_sizes: Optional[Dict[str, int]] = None) -> List[Step]:
    """The minimal collective-step schedule turning ``src_spec`` into
    ``dst_spec`` over ``ndim``-rank values (missing trailing entries are
    replicated). ``same_mesh`` False forces the gather → replace
    fallback; ``axis_sizes`` resolves the gathers' ``peak``."""
    norm = lambda sp: tuple((tuple(sp or ())[i] if i < len(sp or ())  # noqa: E731
                             else None) for i in range(ndim))
    s, d = norm(src_spec), norm(dst_spec)
    if s == d and same_mesh:
        return []
    ssh, dsh = _sharded_dims(s, ndim), _sharded_dims(d, ndim)
    if same_mesh and len(ssh) == 1 and len(dsh) == 1 \
            and ssh[0][1] == dsh[0][1] and ssh[0][0] != dsh[0][0]:
        return [Step("all_to_all", dim=ssh[0][0], dim_to=dsh[0][0],
                     axis=_axis_name(ssh[0][1]), peak=1)]
    steps: List[Step] = []
    for i, axis in ssh:
        a = _axis_name(axis)
        steps.append(Step("all_gather", dim=i, axis=a,
                          peak=(axis_sizes or {}).get(a, 0)))
    if dsh:
        if same_mesh and len(dsh) == 1:
            i, axis = dsh[0]
            steps.append(Step("local_slice", dim=i, axis=_axis_name(axis),
                              peak=1))
        else:
            steps.append(Step("replace", peak=1))
    elif not same_mesh:
        steps.append(Step("replace", peak=1))
    return steps


# --------------------------------------------------------- step execution

def _with_spec(x: ShardedTensor, dim: int, entry) -> Tuple[Any, ...]:
    spec = list(x.spec)
    spec[dim] = entry
    return tuple(spec)


def _replicated_over(x: ShardedTensor, dim: int, axis: str) -> ShardedTensor:
    """The all-gather of ``dim`` over ``axis``: every position of a group
    gets the group's blocks concatenated in position order (one copy per
    device, shared by its positions)."""
    mesh = x.mesh
    shards = np.empty(mesh.devices.shape, dtype=object)
    for group in mesh.axis_groups(axis):
        blocks = [x.shards[p] for p in group]
        per_dev: Dict[torch.device, torch.Tensor] = {}
        for p in group:
            dev = mesh.devices[p]
            if dev not in per_dev:
                per_dev[dev] = position_gather(blocks, dim, dev)
            shards[p] = per_dev[dev]
    return ShardedTensor(shards, mesh, _with_spec(x, dim, None), x.shape)


def _sliced_over(x: ShardedTensor, dim: int, axis: str, mesh) -> ShardedTensor:
    """The local slice: each position keeps its block of ``dim`` over
    ``axis`` from the whole copy it holds (no communication)."""
    if x.mesh is not mesh:
        # the whole copy onto the destination's positions first
        x = as_sharded(x.to_dense(), mesh, x.spec)
    spec = _with_spec(x, dim, axis)
    out = ShardedTensor.__new__(ShardedTensor)
    out.mesh, out.spec, out.shape = mesh, normalize_spec(spec, x.ndim), \
        x.shape
    shards = np.empty(mesh.devices.shape, dtype=object)
    for idx in mesh.positions():
        region = out.region(idx)
        shards[idx] = x.shards[idx][tuple(
            r if d == dim else slice(None)
            for d, r in enumerate(region))].contiguous()
    out.shards = shards
    return out


def _all_to_all(x: ShardedTensor, dim: int, dim_to: int,
                axis: str) -> ShardedTensor:
    mesh = x.mesh
    shards = np.empty(mesh.devices.shape, dtype=object)
    for group in mesh.axis_groups(axis):
        moved = position_all_to_all([x.shards[p] for p in group], dim_to,
                                    dim)
        for p, t in zip(group, moved):
            shards[p] = t
    spec = list(x.spec)
    spec[dim], spec[dim_to] = None, spec[dim]
    return ShardedTensor(shards, mesh, tuple(spec), x.shape)


def _dst_spec(placement, ndim: int) -> Tuple[Any, ...]:
    if placement is None:
        return (None,) * ndim
    spec = tuple(placement.spec)[:ndim]
    return spec + (None,) * (ndim - len(spec))


def _mesh_of(placement, device_type: str):
    return placement.mesh(visible_devices(device_type))


def execute_steps(x, steps: List[Step], src_placement, dst_placement):
    """Run one value (a ``ShardedTensor`` or a tensor) through a
    schedule, device to device, ending on exactly the layout a fresh
    placement by ``dst_placement`` gives (a final re-place fires when a
    step's result is not already that layout)."""
    dev_type = x.device.type
    dst_mesh = (_mesh_of(dst_placement, dev_type)
                if dst_placement is not None else None)
    if not isinstance(x, ShardedTensor) and src_placement is not None:
        x = as_sharded(x, _mesh_of(src_placement, dev_type),
                       _dst_spec(src_placement, x.dim()))
    for step in steps:
        if not isinstance(x, ShardedTensor):
            break  # an unplaced source: the final re-place moves it
        if step.kind == "all_gather":
            x = _replicated_over(x, step.dim, step.axis)
        elif step.kind == "local_slice":
            size = dst_mesh.shape[step.axis]
            if x.shape[step.dim] % size:
                x = x.to_dense()  # ragged: the re-place below moves it
            else:
                x = _sliced_over(x, step.dim, step.axis, dst_mesh)
        elif step.kind == "all_to_all":
            x = _all_to_all(x, step.dim, step.dim_to, step.axis)
        else:  # replace: one device-to-device re-place
            x = as_sharded(x.to_dense(), dst_mesh,
                           _dst_spec(dst_placement, x.ndim))
        obs.REGISTRY.counter("reshard.steps").inc()
        obs.operators.op_add("reshard.steps")
    if dst_placement is None:
        return x.to_dense() if isinstance(x, ShardedTensor) else x
    spec = normalize_spec(_dst_spec(dst_placement, len(x.shape)),
                          len(x.shape))
    if isinstance(x, ShardedTensor) and x.mesh is dst_mesh \
            and x.spec == spec:
        return x
    return as_sharded(x, dst_mesh, spec)


def move_table(table, steps: List[Step], src_placement, dst_placement):
    """A ``ColumnTable`` through a schedule — every column and the
    validity mask, column by column. An unplaced table is laid out by
    the destination placement (rows padded as a fresh placement pads
    them); a placed one keeps its padded rows, masked invalid."""
    from netsdb_tpu_torch.parallel.placement import (is_placed_table,
                                                     shard_table)
    from netsdb_tpu_torch.relational.table import _STATS_ATTR, ColumnTable

    if not is_placed_table(table) or any(s.kind == "replace"
                                         for s in steps):
        if dst_placement is None:
            from netsdb_tpu_torch.parallel.placement import gather_table
            return gather_table(table) if is_placed_table(table) else table
        return shard_table(table, dst_placement, keep_stats=True)
    cols = {k: execute_steps(v, steps, src_placement, dst_placement)
            for k, v in table.cols.items()}
    valid = (execute_steps(table.valid, steps, src_placement,
                           dst_placement)
             if table.valid is not None else None)
    out = ColumnTable(cols, dict(table.dicts), valid)
    for attr in (_STATS_ATTR, "_source_rows"):
        if attr in table.__dict__:
            out.__dict__[attr] = table.__dict__[attr]
    return out


# ------------------------------------------------------ the set primitive

@dataclasses.dataclass
class ReshardReport:
    """What one reshard did: the steps planned, the blocks moved device
    to device, the bytes that never touched the host arena."""

    steps: List[Step]
    blocks_moved: int = 0
    bytes_moved: int = 0
    items_moved: int = 0
    elapsed_s: float = 0.0

    def labels(self) -> List[str]:
        return [s.label() for s in self.steps]


def _axis_sizes(placement, device_type: str) -> Optional[Dict[str, int]]:
    if placement is None:
        return None
    return {n: int(s) for n, s in
            _mesh_of(placement, device_type).shape.items()}


def _same_mesh(src, dst, device_type: str) -> bool:
    if src is None or dst is None:
        return False
    return _mesh_of(src, device_type) is _mesh_of(dst, device_type)


def _schedule(src, dst, ndim: int, device_type: str) -> List[Step]:
    return plan_steps(_dst_spec(src, ndim), _dst_spec(dst, ndim), ndim,
                      same_mesh=_same_mesh(src, dst, device_type),
                      axis_sizes=_axis_sizes(src, device_type))


def _move_cached(cache, scope: str, keys, ranges, mover,
                 report: ReshardReport) -> None:
    """Move the blocks cached under each ``(src_key, dst_key)`` of
    ``keys`` through ``mover``. Every source entry is read first, then
    the old layout's entries are dropped through the dirty-range path (a
    scope-wide epoch bump, so a racing install of the old layout is
    refused) and each moved block installs under its new key, one at a
    time."""
    from netsdb_tpu_torch.storage.devcache import _value_nbytes

    moves = []
    for src_key, dst_key in keys:
        _epoch, covered = cache.plan_ranges(src_key, ranges)
        if covered:
            moves.append((dst_key, covered))
    if not moves:
        return
    lo = min(r[0] for _, cov in moves for r in cov)
    hi = max(r[1] for _, cov in moves for r in cov)
    cache.invalidate_range(scope, lo, hi)
    epoch = cache.scope_epoch(scope)
    for dst_key, covered in moves:
        for rng in ranges:
            val = covered.get((int(rng[0]), int(rng[1])))
            if val is None:
                continue
            moved = mover(val)
            if cache.install_block(dst_key, rng, moved, epoch=epoch):
                report.blocks_moved += 1
                report.bytes_moved += _value_nbytes(moved)


def _cache_on(cache) -> bool:
    return cache is not None and cache.enabled and cache.partial


def _reshard_paged_tensor(store, ident, pm, src, dst,
                          report: ReshardReport) -> None:
    """A paged TENSOR set's cached rows-mode ("trows") and reduce-mode
    ("treduce") blocks move from the old placement's key to the new
    one's; their 2-d element runs the schedule, the bookkeeping scalars
    ride along. SUMMA blocks move through :func:`reshard_summa_layout`."""
    ps = store.page_store()
    report.steps = _schedule(src, dst, 2, store.device.type)
    cache = store.device_cache()
    if not _cache_on(cache):
        return
    cfg = store.config
    scope = str(ident)
    src_l = src.label() if src is not None else None
    dst_l = dst.label() if dst is not None else None

    def mover(val):
        out = []
        for el in (val if isinstance(val, tuple) else (val,)):
            if getattr(el, "ndim", None) == 2:
                el = execute_steps(el, report.steps, src, dst)
            out.append(el)
        return tuple(out) if isinstance(val, tuple) else out[0]

    bases = [(scope, kind, ps.meta(pm.name)[1][0], cfg.shape_bucketing,
              cfg.bucket_density) for kind in ("trows", "treduce")]
    _move_cached(cache, scope, [(b + (src_l,), b + (dst_l,)) for b in bases],
                 ps.block_ranges(pm.name), mover, report)


def _finish(report: ReshardReport, t0: float) -> ReshardReport:
    report.elapsed_s = time.perf_counter() - t0
    n = report.blocks_moved or report.items_moved
    obs.REGISTRY.counter("reshard.blocks_moved").inc(n)
    obs.REGISTRY.counter("reshard.bytes_moved").inc(report.bytes_moved)
    obs.operators.op_add("reshard.blocks_moved", n)
    return report


def reshard_set(store, ident, dst_placement,
                kind: str = "tables") -> ReshardReport:
    """Move set ``ident`` from its placement to ``dst_placement`` through
    collective steps.

    * memory sets: every item's tensors (a table's columns and mask, a
      blocked tensor's data) run the schedule device to device;
    * paged relations: the blocks cached under the old layout's key
      (``PagedColumns.partial_base_key(kind, placement=...)``) move to the
      new layout's key, so the warm requery reads no page; blocks that
      were not cached stream cold next time, as always;
    * paged tensor sets: the cached weight-stream blocks move likewise.

    Then the store commits the new placement (``set_placement``): no
    write version moves. Callers serialise it against concurrent streams
    of the set, like any other mutation."""
    from netsdb_tpu_torch.core.blocked import BlockedTensor
    from netsdb_tpu_torch.relational.outofcore import PagedColumns
    from netsdb_tpu_torch.relational.table import ColumnTable

    t0 = time.perf_counter()
    src = store.placement_of(ident)
    dev_type = store.device.type
    report = ReshardReport(steps=[])
    obs.REGISTRY.counter("reshard.plans").inc()
    if store.storage_of(ident) == "paged":
        items = store.get_items(ident)
        pc = next((i for i in items if isinstance(i, PagedColumns)), None)
        if pc is None:
            pm = next((i for i in items
                       if type(i).__name__ == "_PagedMatrix"), None)
            if pm is None:
                raise ValueError(f"reshard_set: {ident} holds no paged "
                                 f"relation or matrix")
            _reshard_paged_tensor(store, ident, pm, src, dst_placement,
                                  report)
            store.set_placement(ident, dst_placement)
            return _finish(report, t0)
        report.steps = _schedule(src, dst_placement, 1, dev_type)
        cache = pc.devcache
        if _cache_on(cache) and pc.cache_scope is not None:
            _move_cached(
                cache, pc.cache_scope,
                [(pc.partial_base_key(kind, placement=src),
                  pc.partial_base_key(kind, placement=dst_placement))],
                pc.block_ranges(),
                lambda blk: move_table(blk, report.steps, src,
                                       dst_placement), report)
        store.set_placement(ident, dst_placement)
        return _finish(report, t0)
    moved_items = []
    for item in store.get_items(ident):
        if isinstance(item, ColumnTable):
            steps = _schedule(src, dst_placement, 1, dev_type)
            report.steps = report.steps or steps
            moved_items.append(move_table(item, steps, src, dst_placement))
            report.items_moved += 1
        elif isinstance(item, BlockedTensor):
            steps = _schedule(src, dst_placement, item.data.ndim, dev_type)
            report.steps = report.steps or steps
            moved_items.append(item.with_data(
                execute_steps(item.data, steps, src, dst_placement)))
            report.items_moved += 1
        elif isinstance(item, (torch.Tensor, ShardedTensor)):
            steps = _schedule(src, dst_placement, item.ndim, dev_type)
            report.steps = report.steps or steps
            moved_items.append(execute_steps(item, steps, src,
                                             dst_placement))
            report.items_moved += 1
        else:  # host records: nothing on a device
            moved_items.append(item)
    store.set_placement(ident, dst_placement, items=moved_items)
    return _finish(report, t0)


def reshard_summa_layout(store, ident, src_devices, dst_devices,
                         src_grid: Optional[Tuple[int, int]] = None,
                         dst_grid: Optional[Tuple[int, int]] = None,
                         axis: str = "data") -> ReshardReport:
    """Move a paged TENSOR set's cached SUMMA blocks between layouts —
    the 1-d row-dealt mesh (``*_grid`` None) and ``pr x pc`` grids —
    without re-staging: each block is made whole on one device (grid
    tiles concatenated), then split into the destination's grid-column
    tiles or kept whole, and placed on the destination owner(s), under
    the destination label. Both layouts need the same participant count
    (the contraction padding derives from it)."""
    from netsdb_tpu_torch.parallel import summa as _summa
    from netsdb_tpu_torch.plan import staging

    t0 = time.perf_counter()
    report = ReshardReport(steps=[Step("replace", peak=1)])
    obs.REGISTRY.counter("reshard.plans").inc()
    items = store.get_items(ident)
    pm = next((i for i in items if type(i).__name__ == "_PagedMatrix"),
              None)
    if pm is None:
        raise ValueError(f"reshard_summa_layout: {ident} holds no paged "
                         f"matrix")
    src_devices, dst_devices = list(src_devices), list(dst_devices)
    n_src = (src_grid[0] * src_grid[1] if src_grid is not None
             else len(src_devices))
    n_dst = (dst_grid[0] * dst_grid[1] if dst_grid is not None
             else len(dst_devices))
    if n_src != n_dst:
        raise ValueError(f"summa layout move needs equal participant "
                         f"counts (k padding), got {n_src} -> {n_dst}")
    src_devices, dst_devices = src_devices[:n_src], dst_devices[:n_dst]

    def label(devices, grid):
        return (_summa.grid_label(devices, *grid) if grid is not None
                else _summa.mesh_label(axis, devices))

    cache = store.device_cache()
    if not _cache_on(cache):
        report.elapsed_s = time.perf_counter() - t0
        return report
    ps = store.page_store()
    cfg = store.config
    rb = ps.meta(pm.name)[1][0]
    bucket = staging.pad_rows_target(rb, cfg.shape_bucketing,
                                     density=cfg.bucket_density)
    scope = str(ident)

    def mover(val):
        i, nrows, payload = val
        if isinstance(payload, tuple):
            anchor = (dst_devices[(i % dst_grid[0]) * dst_grid[1]]
                      if dst_grid is not None else dst_devices[i % n_dst])
            full = torch.cat([move(t, anchor) for t in payload], dim=1)
        else:
            full = payload
        if dst_grid is not None:
            pr, pc = dst_grid
            r = i % pr
            apc = full.shape[1] // pc
            out = tuple(move(full[:, c * apc:(c + 1) * apc].contiguous(),
                             dst_devices[r * pc + c]) for c in range(pc))
        else:
            out = move(full, dst_devices[i % n_dst])
        obs.REGISTRY.counter("reshard.steps").inc()
        return i, nrows, out

    base = (scope, _summa.CACHE_KIND, bucket)
    _move_cached(cache, scope, [(base + (label(src_devices, src_grid),),
                                 base + (label(dst_devices, dst_grid),))],
                 ps.block_ranges(pm.name), mover, report)
    return _finish(report, t0)
