"""Mesh-distributed relational execution — counterpart of
``netsdb_tpu/relational/sharded.py``.

The reference scales a query by partitioning its fact table over the
workers and running the same pipeline on each partition, with two data
movements (SURVEY §2.6): local pre-aggregation plus a shuffle of the
partial aggregates, and a broadcast join of the small sides. Under JAX
the partial aggregates meet in one ``psum`` that XLA inserts; here the
positions' partials are at hand (one process drives every position,
:mod:`netsdb_tpu_torch.parallel.mesh`) and are combined explicitly, in
position order.

Two layers, as in the reference:

- the kernel layer: :func:`sharded_query` (a per-position kernel whose
  fixed-shape partials are combined over the axis — summed by default,
  ``torch.minimum``/``torch.maximum`` where the reference passes
  ``pmin``/``pmax``), :func:`sharded_key_marks` and :func:`probe_marks`
  (the two halves of a distributed semi-join), consumed by
  :mod:`netsdb_tpu_torch.relational.shuffle`;
- the query layer: :func:`fold_sharded` and the ten ``sharded_qXX``
  wrappers run a suite query's ONE ``relational/folds.py`` FoldSpec —
  the same the paged path streams — over the mesh: the fact rows are
  row-sharded with GLOBAL ``_rowid`` s (q02 breaks cost ties on them),
  the dimensions replicated, a step runs on each position's rows and the
  result is finalized once (:func:`run_fold_placed`).

A fold that declares ``state_merge`` starts every position from its
``init`` and merges the positions' final states in position order.
Another threads its state through the positions in order, each
position's rows one chunk — the paged stream's own discipline, right for
every fold (two-pass Q17 included); for an additive state it gives the
same bits as summing per-position partials in position order.

Row padding: a sharded axis must divide the position count, so fact
columns are padded and a validity mask rides along; ``_fold_mask`` turns
the padding rows into -1 keys and 0 measures in every step.

The set API drives the same code: a placed relation set
(``Client.create_set(placement=...)`` + ``send_table``) holds a placed
table, and the executor runs a sink's fold over it through
:func:`run_fold_placed`.
"""

from __future__ import annotations

import collections
import hashlib
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from netsdb_tpu_torch import obs
from netsdb_tpu_torch.parallel.mesh import Mesh, move
from netsdb_tpu_torch.parallel.placement import (gather_table,
                                                 is_placed_table,
                                                 lay_out_table, local_tables,
                                                 table_layout)
from netsdb_tpu_torch.relational import kernels as K
from netsdb_tpu_torch.relational.table import ColumnTable


def shard_fact_columns(cols: Dict[str, torch.Tensor], n_shards: int
                       ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Pad each column to a multiple of ``n_shards`` and return the
    validity mask (False on padding rows) — the dispatcher's round-robin
    row partitioning with the remainder handled by masking."""
    first = next(iter(cols.values()))
    n = first.shape[0]
    padded = -(-n // n_shards) * n_shards
    out = {}
    for name, c in cols.items():
        pad = padded - n
        out[name] = (torch.cat([c, c.new_zeros((pad,) + c.shape[1:])])
                     if pad else c)
    valid = torch.arange(padded, device=first.device) < n
    return out, valid


def _tree_map(fn: Callable, x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, ColumnTable):
        return ColumnTable({k: fn(v) for k, v in x.cols.items()}, x.dicts,
                           None if x.valid is None else fn(x.valid))
    if isinstance(x, (tuple, list)) and not hasattr(x, "_fields"):
        return type(x)(_tree_map(fn, v) for v in x)
    return x


def _tree_combine(fn: Callable, a: Any, b: Any) -> Any:
    if isinstance(a, dict):
        return {k: _tree_combine(fn, a[k], b[k]) for k in a}
    if isinstance(a, (tuple, list)):
        return type(a)(_tree_combine(fn, x, y) for x, y in zip(a, b))
    return fn(a, move(b, a.device))


def _combine_positions(parts: Sequence[Any], combine: Callable,
                       device: torch.device) -> Any:
    """Left fold of the positions' partial pytrees in position order, on
    ``device``."""
    acc = _tree_map(lambda t: move(t, device), parts[0])
    for p in parts[1:]:
        acc = _tree_combine(combine, acc, p)
    return acc


def _rows_over(x: torch.Tensor, mesh: Mesh, axis: str) -> List[torch.Tensor]:
    """``x`` (a multiple of the axis size long) split into contiguous row
    blocks, block ``i`` on the ``i``-th position of the axis."""
    devices = [mesh.devices[p] for p in mesh.axis_groups(axis)[0]]
    n = len(devices)
    return [move(b, d) for b, d in zip(torch.chunk(x, n), devices)]


def sharded_query(local_kernel: Callable[..., Any], mesh: Mesh, axis: str,
                  fact: Dict[str, torch.Tensor],
                  replicated: Sequence[torch.Tensor] = (),
                  combine: Optional[Callable] = None) -> Any:
    """Run ``local_kernel(valid, fact_cols, *replicated)`` on each
    position's rows and combine its fixed-shape partial aggregates over
    ``axis`` in position order (``combine(a, b)``, default ``torch.add``;
    pass ``torch.minimum``/``torch.maximum`` for min/max merges). The
    result may be a pytree (e.g. ``(sums, counts)``); each leaf is
    combined. Returned on the first position's device."""
    n_shards = mesh.shape[axis]
    fact_p, valid = shard_fact_columns(fact, n_shards)
    combine = combine or torch.add
    blocks = {k: _rows_over(v, mesh, axis) for k, v in fact_p.items()}
    vblocks = _rows_over(valid, mesh, axis)
    group = mesh.axis_groups(axis)[0]
    partials = []
    for i, p in enumerate(group):
        dev = mesh.devices[p]
        cols = {k: b[i] for k, b in blocks.items()}
        rep = [move(r, dev) for r in replicated]
        partials.append(local_kernel(vblocks[i], cols, *rep))
    return _combine_positions(partials, combine, mesh.devices[group[0]])


def sharded_key_marks(mesh: Mesh, axis: str, key_col: torch.Tensor,
                      n_keys: int,
                      row_mask: Optional[torch.Tensor] = None,
                      extra_cols: Optional[Dict[str, torch.Tensor]] = None,
                      mask_fn: Optional[Callable] = None) -> torch.Tensor:
    """0/1 existence marks per key, summed over the positions — the
    build half of a distributed semi/anti-join (Q04's late-order set,
    Q22's has-orders set). ``mask_fn(valid, cols)`` may narrow which rows
    mark (cols include ``key`` plus ``extra_cols``)."""
    fact = {"key": key_col}
    if row_mask is not None:
        fact["row_mask"] = row_mask
    fact.update(extra_cols or {})

    def local(valid, c):
        m = valid if row_mask is None else (valid & c["row_mask"])
        if mask_fn is not None:
            m = m & mask_fn(valid, c)
        return K.segment_count(c["key"], n_keys, m).clamp(max=1)

    return sharded_query(local, mesh, axis, fact)


def probe_marks(marks: torch.Tensor, keys: torch.Tensor,
                n_keys: int) -> torch.Tensor:
    """Per-row membership against a merged mark table (the probe half;
    out-of-space keys are non-members)."""
    in_space = (keys >= 0) & (keys < n_keys)
    return in_space & (K.take(marks, keys.clamp(0, n_keys - 1)) > 0)


# ------------------------------------------------- folds over placed rows

_fallback_mu = threading.Lock()
_fallbacks: "collections.OrderedDict[str, Dict[str, Any]]" = \
    collections.OrderedDict()


def fallback_log() -> List[Dict[str, Any]]:
    """Every node that ran a placed relation on one position instead of
    the reference's distributed path, with the reason and its runs."""
    with _fallback_mu:
        return [{"node": k, **v} for k, v in _fallbacks.items()]


def note_fallback(node_label: str, reason: str) -> None:
    """Log one run of ``node_label`` on one position, with its reason."""
    with _fallback_mu:
        ent = _fallbacks.setdefault(node_label, {"reason": reason,
                                                 "runs": 0})
        ent["runs"] += 1
        while len(_fallbacks) > 256:
            _fallbacks.popitem(last=False)
    obs.REGISTRY.counter("mesh.fallbacks").inc()


def moved(x: Any, device: torch.device) -> Any:
    """A state pytree (tensors, tables, tuples, dicts) on ``device``."""
    return _tree_map(lambda t: move(t, device), x)


def gathered(values: Sequence[Any]) -> Tuple[Any, ...]:
    """The values with every placed table made whole on its first
    position: a replicated one gives that position's copy (no data
    moves), a row-sharded one is all-gathered (``mesh.all_gathers``)."""
    out = []
    for v in values:
        if isinstance(v, tuple):
            out.append(gathered(v))
        elif is_placed_table(v):
            if table_layout(v)[1][0] is not None:
                obs.REGISTRY.counter("mesh.all_gathers").inc()
            out.append(gather_table(v))
        else:
            out.append(v)
    return tuple(out)


def position_residents(resident: Sequence[Any], mesh: Mesh
                       ) -> List[Tuple[Any, ...]]:
    """Each position's view of a fold's resident inputs: a replicated
    placed table gives the position's own copy, a row-sharded one is
    all-gathered once per device (the broadcast the reference's XLA
    inserts for a sharded build side), other values are moved to the
    position's device."""
    per_pos: List[List[Any]] = [[] for _ in range(mesh.size)]
    for r in resident:
        if is_placed_table(r):
            _, spec = table_layout(r)
            if spec[0] is None:
                for i, t in enumerate(local_tables(r)):
                    per_pos[i].append(t)
                continue
            obs.REGISTRY.counter("mesh.all_gathers").inc()
            whole = gather_table(r)
            by_dev: Dict[torch.device, ColumnTable] = {}
            for i, dev in enumerate(mesh.devices.flat):
                if dev not in by_dev:
                    by_dev[dev] = whole.to(dev)
                per_pos[i].append(by_dev[dev])
            continue
        for i, dev in enumerate(mesh.devices.flat):
            per_pos[i].append(moved(r, dev))
    return [tuple(p) for p in per_pos]


def step_placed(step: Callable, state: Any, chunk, views) -> Any:
    """One placed chunk through a fold's step: each position's rows in
    position order, the state carried from position to position (a
    replicated chunk is one position's copy)."""
    obs.REGISTRY.counter("mesh.placed_chunks").inc()
    locs = local_tables(chunk)
    if table_layout(chunk)[1][0] is None:  # replicated: one copy is all
        locs = locs[:1]
    for loc, r in zip(locs, views):
        state = step(moved(state, loc.device), loc, *r)
    return state


def run_fold_placed(fold, src, resident: Sequence[Any] = ()) -> Any:
    """A FoldSpec over a placed table ``src`` (row-sharded or replicated
    columns): each position's rows are one step's chunk, with global
    ``_rowid`` s; the residents are laid out per position
    (:func:`position_residents`). A single-pass fold with ``state_merge``
    runs every position from ``init`` and merges the final states in
    position order; any other threads its state through the positions in
    order. ``finalize`` runs once, on the first position's device."""
    mesh, spec = table_layout(src)
    locs = local_tables(src, rowid=True)
    res = position_residents(resident, mesh)
    if spec[0] is None:  # a replicated source: one copy is the relation
        locs, res = locs[:1], res[:1]
    dev0 = mesh.devices.flat[0]
    obs.REGISTRY.counter("mesh.placed_folds").inc()
    obs.operators.op_add("positions", len(locs))
    if fold.state_merge is not None and len(fold.passes) == 1:
        init, step = fold.passes[0]
        states = [step(init(None, loc, *r), loc, *r)
                  for loc, r in zip(locs, res)]
        state = _combine_positions(states, fold.state_merge, dev0)
    else:
        state = None
        for init, step in fold.passes:
            state = init(state, locs[0], *res[0])
            for loc, r in zip(locs, res):
                state = step(moved(state, loc.device), loc, *r)
        state = moved(state, dev0)
    return fold.finalize(state, locs[0], *res[0])


def _placed_from_locals(outs: List[ColumnTable], mesh: Mesh, spec
                        ) -> ColumnTable:
    """Per-position tables (one row block each) as one placed table."""
    from netsdb_tpu_torch.parallel.mesh import ShardedTensor

    def sharded(blocks):
        shards = np.empty(mesh.devices.shape, dtype=object)
        for idx, b in zip(mesh.positions(), blocks):
            shards[idx] = b
        rows = sum(b.shape[0] for b in blocks) if spec[0] is not None \
            else blocks[0].shape[0]
        return ShardedTensor(shards, mesh, spec,
                             (rows,) + tuple(blocks[0].shape[1:]))

    first = outs[0]
    valid = sharded([o.mask() for o in outs])
    return ColumnTable({k: sharded([o.cols[k] for o in outs])
                        for k in first.cols}, first.dicts, valid)


def dispatch_placed(node, in_vals: List[Any], device, eval_node) -> Any:
    """A plan node over placed relations, as the reference's GSPMD runs
    it distributed:

    - a node with a ``fold`` over a placed source runs
      :func:`run_fold_placed`;
    - a ``Partition`` on a column is the row shuffle (its ``evaluate``);
    - a node declared ``rowwise`` over a row-sharded first input (the
      other placed inputs replicated) runs its ``fn`` on each position's
      rows and gives a placed table of the same layout;
    - any other node gets its placed inputs gathered onto the first
      position, a fallback counted with its reason (:func:`fallback_log`,
      ``mesh.fallbacks``) where a row-sharded input had to move."""
    from netsdb_tpu_torch.plan.computations import Partition
    from netsdb_tpu_torch.plan.fold import flatten_resident

    label = getattr(node, "label", node.op_kind)
    fold, src = getattr(node, "fold", None), getattr(node, "fold_src", 0)
    if fold is not None and len(in_vals) > src \
            and is_placed_table(in_vals[src]):
        resident = flatten_resident(tuple(
            v for i, v in enumerate(in_vals) if i != src))
        return run_fold_placed(fold, in_vals[src], resident)
    if isinstance(node, Partition) and isinstance(node.key_fn, str):
        return eval_node(node, in_vals, device)
    fn = getattr(node, "fn", None)
    first = in_vals[0] if in_vals else None
    if (getattr(node, "rowwise", False) and fn is not None
            and is_placed_table(first)
            and table_layout(first)[1][0] is not None
            and all(not is_placed_table(v) or table_layout(v)[1][0] is None
                    for v in in_vals[1:])):
        mesh, spec = table_layout(first)
        views = position_residents(in_vals[1:], mesh)
        outs = [fn(loc, *r) for loc, r in zip(local_tables(first), views)]
        if all(isinstance(o, ColumnTable) for o in outs):
            obs.REGISTRY.counter("mesh.rowwise_nodes").inc()
            return _placed_from_locals(outs, mesh, spec)
        raise TypeError(f"rowwise node {label!r} over a placed relation "
                        f"must give a ColumnTable per position")
    if any(is_placed_table(v) and table_layout(v)[1][0] is not None
           for v in flatten_resident(tuple(in_vals))):
        note_fallback(label, "not a fold, a column Partition or a rowwise "
                         "node: its row-sharded input was gathered onto "
                         "the first position")
    return eval_node(node, list(gathered(in_vals)), device)


# ---------------------------------------------------- the query cores

#: built folds, one per equivalent build (query, parameters, row counts,
#: key spaces and dictionary contents): fold builders bake dictionary
#: codes and LUTs into their closures, so two datasets that differ only
#: in their encoding never share one
_FOLD_JIT: Dict[tuple, Any] = {}
_fold_lock = threading.Lock()


def fold_sharded(qname: str, tables: Dict[str, ColumnTable], mesh: Mesh,
                 axis: str = "data", **params):
    """Run one suite query's fold distributed over ``(mesh, axis)``: fact
    rows sharded, dimensions replicated (the broadcast join), the output
    the fold's finalize tuple — elementwise the resident engine's suite
    outputs."""
    from netsdb_tpu_torch.relational.dag import _QUERY_TABLES
    from netsdb_tpu_torch.relational.folds import SUITE_FOLDS
    from netsdb_tpu_torch.relational.stats import analyze_table

    names = _QUERY_TABLES[qname]
    fact, builder = SUITE_FOLDS[qname]
    cap = {n: analyze_table(tables[n]) for n in names}
    dicts = {n: tables[n].dicts for n in names}
    nrows = {n: tables[n].num_rows for n in names}
    dict_tag = hashlib.blake2s(repr(sorted(
        (n, c, tuple(d)) for n in names
        for c, d in tables[n].dicts.items())).encode()).hexdigest()[:12]
    key = (qname, repr(sorted(params.items())),
           tuple(sorted(nrows.items())),
           tuple(sorted((n, c, s.key_space)
                        for n, cs in cap.items() for c, s in cs.items())),
           dict_tag)
    with _fold_lock:
        fold = _FOLD_JIT.get(key)
        if fold is None:
            fold = builder(cap, dicts, nrows, **params)
            if len(_FOLD_JIT) > 64:
                _FOLD_JIT.clear()  # unbounded-growth guard
            _FOLD_JIT[key] = fold
    placed = {n: lay_out_table(tables[n], mesh,
                               (axis,) if n == fact else (None,))
              for n in names}
    resident = tuple(placed[n] for n in names if n != fact)
    return run_fold_placed(fold, placed[fact], resident)


def _wrap(qname: str):
    def runner(tables, mesh: Mesh, axis: str = "data", **params):
        return fold_sharded(qname, tables, mesh, axis, **params)

    runner.__name__ = f"sharded_{qname}"
    runner.__doc__ = (
        f"{qname} distributed over a mesh through ``fold_sharded`` — the "
        f"same fold as the paged path (``relational.folds.fold_{qname}``).")
    return runner


sharded_q01 = _wrap("q01")
sharded_q02 = _wrap("q02")
sharded_q03 = _wrap("q03")
sharded_q04 = _wrap("q04")
sharded_q06 = _wrap("q06")
sharded_q12 = _wrap("q12")
sharded_q13 = _wrap("q13")
sharded_q14 = _wrap("q14")
sharded_q17 = _wrap("q17")
sharded_q22 = _wrap("q22")

__all__ = ["shard_fact_columns", "sharded_query", "sharded_key_marks",
           "probe_marks", "run_fold_placed", "fold_sharded",
           "dispatch_placed", "fallback_log",
           ] + [f"sharded_{q}" for q in (
               "q01", "q02", "q03", "q04", "q06", "q12", "q13", "q14",
               "q17", "q22")]
