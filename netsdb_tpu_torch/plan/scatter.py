"""Scatter-gather decomposition of a Computation DAG over sharded sets —
the port's ``netsdb_tpu/plan/scatter.py``.

The reference's master never runs a pipeline itself: it cuts the plan
into stages, schedules each on the workers holding the set's partitions
and merges bounded aggregation state at the master
(``QuerySchedulerServer.cc:216-330``). This module is that analysis for
the serve layer's worker pool: given a sink DAG and a predicate "is this
set partitioned?", it recognises the shapes that can be pushed and
returns a :class:`ScatterSpec` the coordinator (``serve/shard.py``) runs:

* ``fold_state`` — ``Scan(sharded) → [rowwise chain] → Apply(fold)``
  where the single-pass fold declares ``state_merge``: every shard folds
  its local pages to the bounded partial state through its own executor,
  the coordinator merges the states in slot order and runs ``finalize``
  once (the q01/q06 family).
* ``group_partial`` — ``Scan(sharded) → {Filter|Flatten|rowwise
  Apply}* → Aggregate(key, value, combine)``: shards return partial group
  dicts, the coordinator merges them with the node's ``combine``.
* ``shuffle_join`` — ``Join(Scan(sharded), Scan(sharded), fold with
  probe_key/build_key/merge)``: every shard hash-partitions both local
  sides by the join key and ships bucket *j* to slot *j*, then folds its
  own bucket; the coordinator merges the outputs with the fold's
  ``merge``. Keys co-locate whole.
* ``tensor_chain`` — a layer chain (FF or conv inference) whose one
  sharded leaf is the batch-partitioned input set, every other input
  scanning sets mirrored on each daemon (the weights). Each shard runs
  the whole chain over its rows as one program; the coordinator
  concatenates the per-slot outputs along the batch axis in slot order.
  The sink opts in with its ``scatter_gather`` declaration
  (``{"axis", "block", "mode"}``, set by ``models/serving.py``).
* ``multi_fold`` (:class:`MultiScatterSpec`) — N ``fold_state`` sinks
  over one sharded set, shipped as one combined tuple-state fold.

Anything else touching a sharded set is refused typed. Shards are always
visited in slot order and every merge is a left fold over that order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from netsdb_tpu_torch.plan.computations import (Aggregate, Apply,
                                                Computation, Filter, Join,
                                                MultiApply, ScanSet,
                                                WriteSet)
from netsdb_tpu_torch.plan.fold import FoldSpec


@dataclasses.dataclass
class ScatterSpec:
    """One sink's scatter decomposition (see the module docstring)."""

    #: "fold_state" | "group_partial" | "shuffle_join" | "tensor_chain"
    kind: str
    sink: WriteSet
    node: Computation
    #: sharded (db, set) leaves the spec scans, sorted
    scan_sets: Tuple[Tuple[str, str], ...]
    fold: Optional[FoldSpec] = None
    #: shuffle_join: (db, set) of the probe and build sides
    probe: Optional[Tuple[str, str]] = None
    build: Optional[Tuple[str, str]] = None
    #: tensor_chain: the sink's ``scatter_gather`` declaration
    gather: Optional[dict] = None


@dataclasses.dataclass
class MultiScatterSpec:
    """N ``fold_state`` sinks over ONE sharded scan set: one subplan per
    shard whose tuple-state fold runs every component's (pre-chain +
    step) over each chunk, and one merge and finalize at the
    coordinator."""

    kind: str  # "multi_fold"
    components: Tuple[ScatterSpec, ...]
    scan_sets: Tuple[Tuple[str, str], ...]


def _rowwise_chain_ok(node: Computation) -> bool:
    """Nodes that decompose by rows: a chain of them between the sharded
    scan and the aggregating node ships to the shards unchanged."""
    if isinstance(node, (Filter, MultiApply)):
        return True
    return isinstance(node, Apply) and getattr(node, "rowwise", False) \
        and node.fold is None


def _scan_leaf(node: Computation) -> Optional[ScanSet]:
    """Follow a pure rowwise chain down to its scan (None otherwise)."""
    while not isinstance(node, ScanSet):
        if not _rowwise_chain_ok(node) or len(node.inputs) != 1:
            return None
        node = node.inputs[0]
    return node


def _subtree_touches_sharded(node: Computation,
                             is_sharded: Callable[[str, str], bool]) -> bool:
    seen, stack = set(), [node]
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        if isinstance(n, ScanSet) and is_sharded(n.db, n.set_name):
            return True
        stack.extend(n.inputs)
    return False


def _tensor_chain_leaf(node: Computation,
                       is_sharded: Callable[[str, str], bool]
                       ) -> Optional[ScanSet]:
    """Follow the batch spine to its sharded scan: every chain node has
    exactly one input whose subtree touches a sharded set; the other
    inputs scan only mirrored sets. None when the spine forks or ends."""
    cur = node
    while not isinstance(cur, ScanSet):
        spine = [i for i in cur.inputs
                 if _subtree_touches_sharded(i, is_sharded)]
        if len(spine) != 1:
            return None
        cur = spine[0]
    return cur if is_sharded(cur.db, cur.set_name) else None


def sharded_scan_sets(sinks, is_sharded: Callable[[str, str], bool]
                      ) -> List[Tuple[str, str]]:
    """Every sharded (db, set) the sinks' DAG scans, sorted."""
    out, seen, stack = set(), set(), list(sinks)
    while stack:
        node = stack.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        if isinstance(node, ScanSet) and is_sharded(node.db,
                                                    node.set_name):
            out.add((node.db, node.set_name))
        stack.extend(node.inputs)
    return sorted(out)


def analyze_sinks(sinks, is_sharded: Callable[[str, str], bool]):
    """The scatter decomposition of ``sinks`` (a :class:`ScatterSpec`, or
    a :class:`MultiScatterSpec` for several fold sinks), or None when the
    DAG touches no sharded set (the local path runs) or touches one in a
    shape that cannot be pushed (the caller refuses typed: a sharded
    set's pages live only on its shards)."""
    touched = sharded_scan_sets(sinks, is_sharded)
    if not touched:
        return None
    if len(sinks) != 1:
        return analyze_multi_sinks(sinks, is_sharded, touched)
    sink = sinks[0]
    if not isinstance(sink, WriteSet):
        return None
    node = sink.inputs[0]

    if isinstance(node, Join) and node.fold is not None \
            and node.fold.probe_key and node.fold.build_key \
            and node.fold.merge is not None \
            and len(node.fold.passes) == 1:
        probe_in = node.inputs[node.fold_src]
        build_in = node.inputs[1 - node.fold_src]
        if isinstance(probe_in, ScanSet) and isinstance(build_in, ScanSet) \
                and is_sharded(probe_in.db, probe_in.set_name) \
                and is_sharded(build_in.db, build_in.set_name):
            return ScatterSpec(
                kind="shuffle_join", sink=sink, node=node,
                scan_sets=tuple(touched), fold=node.fold,
                probe=(probe_in.db, probe_in.set_name),
                build=(build_in.db, build_in.set_name))

    if isinstance(node, Apply) and node.fold is not None \
            and node.fold.state_merge is not None \
            and len(node.fold.passes) == 1:
        scan = _scan_leaf(node.inputs[0])
        if scan is not None and is_sharded(scan.db, scan.set_name):
            return ScatterSpec(kind="fold_state", sink=sink, node=node,
                               scan_sets=tuple(touched), fold=node.fold)

    if isinstance(node, Aggregate) and node.fn is None \
            and node.combine is not None:
        scan = _scan_leaf(node.inputs[0])
        if scan is not None and is_sharded(scan.db, scan.set_name):
            return ScatterSpec(kind="group_partial", sink=sink,
                               node=node, scan_sets=tuple(touched))

    gather = getattr(sink, "scatter_gather", None)
    if gather is not None and len(touched) == 1 \
            and _tensor_chain_leaf(node, is_sharded) is not None:
        return ScatterSpec(kind="tensor_chain", sink=sink, node=node,
                           scan_sets=tuple(touched), gather=dict(gather))
    return None


def _bakeable_prechain(node: Computation) -> Optional[List[Apply]]:
    """The rowwise Apply chain between a fold's stream input and its scan,
    scan→fold order (what the combined multi-sink fold bakes into its
    steps); None when anything else sits on it, ``[]`` when the input is
    the scan."""
    chain: List[Apply] = []
    cur = node
    while not isinstance(cur, ScanSet):
        if not (isinstance(cur, Apply)
                and getattr(cur, "rowwise", False)
                and cur.fn is not None
                and getattr(cur, "traceable", True)
                and cur.fold is None and len(cur.inputs) == 1):
            return None
        chain.append(cur)
        cur = cur.inputs[0]
    chain.reverse()
    return chain


def analyze_multi_sinks(sinks, is_sharded: Callable[[str, str], bool],
                        touched: List[Tuple[str, str]]
                        ) -> Optional[MultiScatterSpec]:
    """Every sink must be a pushable ``fold_state`` over the same single
    sharded set, with a pre-chain the combined fold can bake; None
    otherwise."""
    if len(sinks) < 2 or len(touched) != 1:
        return None
    comps: List[ScatterSpec] = []
    for s in sinks:
        spec = analyze_sinks([s], is_sharded)
        if spec is None or spec.kind != "fold_state" \
                or spec.scan_sets != tuple(touched) \
                or len(spec.node.inputs) != 1 \
                or spec.fold.probe_key is not None \
                or spec.fold.build_key is not None \
                or _bakeable_prechain(spec.node.inputs[0]) is None:
            return None
        comps.append(spec)
    return MultiScatterSpec(kind="multi_fold", components=tuple(comps),
                            scan_sets=tuple(touched))


# --- shard-side sinks ----------------------------------------------------

def _state_finalize(state, src, *resident):
    """The partial sink's finalize: the fold state itself."""
    del src, resident
    return state


def _max_node_id(root: Computation) -> int:
    out, seen, stack = root.node_id, set(), [root]
    while stack:
        node = stack.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        out = max(out, node.node_id)
        stack.extend(node.inputs)
    return out


def partial_sink(spec: ScatterSpec) -> WriteSet:
    """The sink a shard runs for a ``fold_state``, ``group_partial`` or
    ``tensor_chain`` spec: the same plan, a fold's finalize replaced by
    the state-returning stub under a distinct label.

    The new nodes take ids above the decoded DAG's largest: the original
    nodes carry the client's process-local ids, and a coordinator id
    colliding with one would corrupt the id-keyed topo sort."""
    node = spec.node
    if spec.kind in ("group_partial", "tensor_chain"):
        sink = WriteSet(node, spec.sink.db, "__scatter_partial__")
        sink.node_id = _max_node_id(node) + 1
        sink.output_name = f"{sink.op_kind}_{sink.node_id}"
        return sink
    fold = spec.fold
    pf = FoldSpec(fold.passes, _state_finalize,
                  probe_columns=fold.probe_columns)
    partial = Apply(node.inputs[0], fold=pf,
                    label=f"{node.label}::partial",
                    traceable=node.traceable)
    partial.node_id = _max_node_id(node.inputs[0]) + 1
    partial.output_name = f"{partial.op_kind}_{partial.node_id}"
    # the fusion mapper's marker: a scatter partial fold is the shard's
    # one program, a region even with nothing local to graft
    partial.scatter_partial = True
    sink = WriteSet(partial, spec.sink.db, "__scatter_partial__")
    sink.node_id = partial.node_id + 1
    sink.output_name = f"{sink.op_kind}_{sink.node_id}"
    return sink


def _combined_fold(comps: Tuple[ScatterSpec, ...]) -> FoldSpec:
    """ONE FoldSpec whose state is the tuple of the components' states:
    each chunk runs every component's (baked pre-chain + step),
    ``state_merge`` is componentwise, finalize returns the tuple."""
    from netsdb_tpu_torch.plan import fusion as _fusion

    wrapped = []
    for c in comps:
        chain = _bakeable_prechain(c.node.inputs[0]) or []
        f = c.fold
        if chain:
            f = _fusion.wrap_fold_prechain(f, [a.fn for a in chain])
        wrapped.append(f)
    folds = tuple(wrapped)

    def init(prev, src, *resident):
        del prev
        return tuple(f.passes[0][0](None, src, *resident) for f in folds)

    def step(state, chunk, *resident):
        return tuple(f.passes[0][1](state[i], chunk, *resident)
                     for i, f in enumerate(folds))

    def state_merge(a, b):
        return tuple(c.fold.state_merge(a[i], b[i])
                     for i, c in enumerate(comps))

    return FoldSpec(((init, step),), _state_finalize,
                    state_merge=state_merge)


def multi_partial_sink(mspec: MultiScatterSpec) -> WriteSet:
    """The ONE sink a shard runs for a ``multi_fold`` spec: ``Scan(shared
    set) → Apply(combined tuple-state fold) → partial write``, all fresh
    nodes; the combined label keeps its programs apart from each
    component's own."""
    db, set_name = mspec.scan_sets[0]
    scan = ScanSet(db, set_name)
    label = "multi::" + "+".join(
        (getattr(c.node, "label", "") or c.node.op_kind)
        for c in mspec.components) + "::partial"
    partial = Apply(scan, fold=_combined_fold(mspec.components),
                    label=label,
                    traceable=all(getattr(c.node, "traceable", True)
                                  for c in mspec.components))
    partial.scatter_partial = True
    return WriteSet(partial, mspec.components[0].sink.db,
                    "__scatter_partial__")


# --- coordinator-side merges ---------------------------------------------

class SchemaProxy:
    """What a scatterable fold's ``finalize`` may read of its source: the
    dictionaries and the total row count, never pages (the coordinator
    holds none)."""

    __slots__ = ("dicts", "num_rows")

    def __init__(self, dicts: Dict[str, list], num_rows: int):
        self.dicts = dict(dicts)
        self.num_rows = int(num_rows)


def merge_fold_states(fold: FoldSpec, states: List[Any],
                      dicts: Dict[str, list], num_rows: int) -> Any:
    """Left-fold the per-slot states in slot order, then finalize over the
    schema proxy: one canonical merge order."""
    merged = states[0]
    for s in states[1:]:
        merged = fold.state_merge(merged, s)
    return fold.finalize(merged, SchemaProxy(dicts, num_rows))


class MultiFoldMerge:
    """The merge and finalize of a ``multi_fold`` coordinator: tuple
    states merge componentwise and each component's ``finalize`` runs over
    the shared schema proxy (FoldSpec's ``state_merge``/``finalize``
    surface)."""

    def __init__(self, components: Tuple[ScatterSpec, ...]):
        self.components = tuple(components)
        self.state_merge = self._state_merge

    def _state_merge(self, a, b):
        return tuple(c.fold.state_merge(a[i], b[i])
                     for i, c in enumerate(self.components))

    def finalize(self, merged, src):
        return tuple(c.fold.finalize(merged[i], src)
                     for i, c in enumerate(self.components))


def merge_fold_states_compiled(fold, states: List[Any],
                               dicts: Dict[str, list], num_rows: int,
                               job_name: str, label: str,
                               traceable: bool = True) -> Any:
    """:func:`merge_fold_states` as ONE program
    (``fusion.compile_scatter_merge``) when the fold and the states can
    run as one; the eager left fold otherwise, a counted fallback
    (``fusion.fallbacks``). Both follow the same slot order."""
    from netsdb_tpu_torch.plan import executor as _executor
    from netsdb_tpu_torch.plan import fusion

    if traceable and getattr(fold, "state_merge", None) is not None \
            and _executor._program_safe_values(states):
        try:
            prog = fusion.compile_scatter_merge(
                fold, len(states), SchemaProxy(dicts, num_rows),
                job_name, label)
            return prog(tuple(states))
        except Exception as e:  # noqa: BLE001 — counted fallback
            fusion.fallback("scatter merge+finalize fell back eager: "
                            f"{type(e).__name__}: {e}")
    return merge_fold_states(fold, states, dicts, num_rows)


def merge_group_dicts(node: Aggregate, parts: List[dict]) -> dict:
    """Per-slot group dicts merged with the Aggregate's ``combine`` (slot
    order; the first occurrence seeds the key)."""
    out: dict = {}
    for part in parts:
        for k, v in part.items():
            out[k] = node.combine(out[k], v) if k in out else v
    return out


def merge_join_outputs(fold: FoldSpec, parts: List[Any]) -> Any:
    """Per-slot shuffle-join outputs merged with the fold's ``merge``."""
    merged = parts[0]
    for p in parts[1:]:
        merged = fold.merge(merged, p)
    return merged


def merge_tensor_chain(gather: dict, parts: List[Any], device=None) -> Any:
    """The per-slot outputs in slot order, which is ingest order (range
    slices are contiguous and ascending), so the result equals a
    single-daemon run byte for byte: every output element comes from one
    shard's rows, never summed across shards.

    ``mode="concat"`` (default) concatenates dense arrays along ``axis``
    and re-blocks with ``block`` when declared; ``mode="items"`` chains
    per-slot item lists (conv2d: one output per input image). ``device``
    is where the assembled tensor lives (default: where the parts are)."""
    if gather.get("mode") == "items":
        out: List[Any] = []
        for p in parts:
            out.extend(p)
        return out
    ts = [p if isinstance(p, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(p)) for p in parts]
    dense = torch.cat(ts, dim=int(gather.get("axis", 0)))
    if device is not None:
        dense = dense.to(device)
    block = gather.get("block")
    if block:
        from netsdb_tpu_torch.plan.executor import _reblock

        return _reblock(dense, tuple(block))
    return dense
