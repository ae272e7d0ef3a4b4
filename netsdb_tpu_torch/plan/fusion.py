"""Fusion-aware plan compilation — the cost-driven region mapper;
counterpart of ``netsdb_tpu/plan/fusion.py``, with the same regions,
fingerprints and counters.

It partitions a :class:`~netsdb_tpu_torch.plan.planner.LogicalPlan` that
touches paged sets into **fusion regions** and hands the executor a
:class:`RegionMap` to run region by region:

* **spine regions** — maximal topo-contiguous runs of traceable,
  resident-valued nodes. The executor runs each as ONE program of its
  compiled-program cache (``region::`` keys; one CUDA graph on the card)
  instead of one program per node. Topo-contiguity makes a region convex:
  every external input precedes it and every external consumer follows
  it, so running region by region only reorders the per-node schedule.
* **graft regions** — a streamed fold (or paged-tensor stream) node plus
  the traceable work fused into its loop: the upstream ``rowwise`` Apply
  chain runs inside the per-chunk step (:func:`wrap_fold_prechain`), and
  the downstream single-consumer traceable chain runs as one epilogue
  program over the fold's merged output (:func:`compose_chain`).

The cost feed is the :class:`~netsdb_tpu_torch.obs.operators.
OperatorLedger`: per-(job, node-label) mean wall time against the device
estimate (their gap is the dispatch overhead fusion removes), staged
bytes and builds per execution (a label that rebuilds chronically stays
out of regions). Labels the ledger has not seen get a static estimate;
``fusion_cost_source="static"`` forces it. Decisions are counted
(``fusion.regions_formed``, ``fusion.nodes_fused``, ``fusion.splits``,
``fusion.fallbacks``, ``fusion.cost_estimates``), a fused node carries its
region id in the EXPLAIN tree, and each region's builds tick
``executor.compile_stats()["region_traces"]``.

Two mappers share the machinery (``config.fusion_mapper``): ``"optimal"``
(default) partitions each maximal fusable run exactly by dynamic
programming over its contiguous segmentations, splitting a run whose
staged-bytes estimate exceeds ``fusion_stage_budget_bytes``; ``"greedy"``
fuses each whole run or nothing. ``config.plan_fusion=False`` takes the
per-node paths (the same ``fold::``/``eager::`` keys as without the
mapper).

The mapper also owns the **scatter boundary**: a shard-side partial fold
(a ``scatter_partial`` node shipped by ``plan/scatter.py``) forms an
anchor-only region under the optimal mapper even with nothing to graft,
and :func:`compile_scatter_merge` runs the coordinator's merge and
finalize as one program of the executor's cache; both tick
``fusion.distributed_regions``.

Both knobs are also advisor **arms**: fusion on/off
(:func:`~netsdb_tpu_torch.learning.advisor.fusion_candidates`) and the
mapper, optimal against greedy as the rollback arm
(:func:`~netsdb_tpu_torch.learning.advisor.mapper_candidates`), so the
``learning/`` bandit A/Bs each decision per job the way it learns
placements (``learning.ab_bench.bench_fusion_ab``, ``bench_mapper_ab``).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from netsdb_tpu_torch import obs
from netsdb_tpu_torch.plan.computations import (Aggregate, Apply,
                                                Computation, Join, ScanSet,
                                                WriteSet)
from netsdb_tpu_torch.plan.planner import LogicalPlan

# ------------------------------------------------------------------
# value-kind classification (the static mirror of dispatch)
# ------------------------------------------------------------------

#: value kinds a node's output can statically be — the mapper's
#: abstraction of what the executor's dispatch decides from runtime
#: types. "tensor" = program-safe resident value (ColumnTable /
#: BlockedTensor / array); everything else is a fusion barrier.
K_TENSOR = "tensor"
K_PAGED_REL = "paged_rel"
K_PAGED_TENSOR = "paged_tensor"
K_PAGED_OBJ = "paged_obj"
K_HOST = "host"
K_GATHER = "gather"  # passthrough tuple possibly carrying paged handles
#: a paged relation seen THROUGH a single-consumer chain of declared
#: ``rowwise`` Apply nodes — still streamable: a downstream fold can
#: graft the chain into its per-chunk step instead of forcing the
#: demote-to-host-table path
K_ROWWISE_PAGED = "rowwise_paged"


def classify_values(plan: LogicalPlan, scan_values: Dict[int, Any],
                    consumers: Optional[Dict[int, List[Computation]]]
                    = None) -> Dict[int, str]:
    """node_id → value kind, propagated topo-forward from the scan
    values the executor already fetched. Deliberately conservative:
    a kind the rules cannot prove lands on ``K_HOST`` (the node simply
    stays on today's per-node path — misclassification can only LOSE a
    fusion opportunity, never fuse an unsafe node; the executor's
    runtime program-safety check is the second net)."""
    import numpy as _np
    import torch

    from netsdb_tpu_torch.core.blocked import BlockedTensor
    from netsdb_tpu_torch.parallel.mesh import ShardedTensor
    from netsdb_tpu_torch.relational.table import ColumnTable

    if consumers is None:
        consumers = plan.consumers()
    kinds: Dict[int, str] = {}
    for node in plan.topo:
        if isinstance(node, ScanSet):
            v = scan_values.get(node.node_id)
            # late imports only where needed: PagedColumns/PagedTensor
            # live in heavier modules
            tname = type(v).__name__
            if tname == "PagedColumns":
                kinds[node.node_id] = K_PAGED_REL
            elif tname == "PagedTensor":
                kinds[node.node_id] = K_PAGED_TENSOR
            elif tname == "PagedObjects":
                kinds[node.node_id] = K_PAGED_OBJ
            elif isinstance(v, (ColumnTable, BlockedTensor, torch.Tensor,
                                ShardedTensor)):
                kinds[node.node_id] = K_TENSOR
            elif isinstance(v, _np.ndarray):
                kinds[node.node_id] = K_TENSOR
            else:
                kinds[node.node_id] = K_HOST
            continue
        in_kinds = [kinds.get(i.node_id, K_HOST) for i in node.inputs]
        if isinstance(node, WriteSet):
            kinds[node.node_id] = in_kinds[0] if in_kinds else K_HOST
            continue
        if getattr(node, "passthrough", False):
            kinds[node.node_id] = (
                K_GATHER if any(k != K_TENSOR for k in in_kinds)
                else K_TENSOR)
            continue
        fold = getattr(node, "fold", None)
        src = getattr(node, "fold_src", 0)
        if (fold is not None and len(in_kinds) > src
                and in_kinds[src] in (K_PAGED_REL, K_ROWWISE_PAGED)):
            kinds[node.node_id] = K_TENSOR  # fold output: table/array
            continue
        if (isinstance(node, Apply)
                and getattr(node, "rowwise", False)
                and node.fn is not None
                and getattr(node, "traceable", True)
                and in_kinds
                and in_kinds[0] in (K_PAGED_REL, K_ROWWISE_PAGED)
                and len(consumers.get(node.node_id, ())) == 1):
            # a declared row-decomposable transform over a (possibly
            # already-chained) paged stream stays STREAMABLE — a
            # downstream fold grafts the chain into its chunk step
            kinds[node.node_id] = K_ROWWISE_PAGED
            continue
        if any(k == K_PAGED_TENSOR for k in in_kinds):
            # tensor stream (or an error at dispatch) — output is the
            # assembled tensor either way
            kinds[node.node_id] = K_TENSOR
            continue
        if any(k in (K_PAGED_REL, K_PAGED_OBJ, K_GATHER,
                     K_ROWWISE_PAGED) for k in in_kinds):
            # dispatch demotes paged relations to host tables before
            # evaluating — output may be a table, but the node itself
            # cannot join a region (it needs the demote)
            kinds[node.node_id] = K_TENSOR if getattr(node, "fn", None) \
                is not None else K_HOST
            continue
        fn = getattr(node, "fn", None)
        if fn is not None and getattr(node, "traceable", True) \
                and all(k == K_TENSOR for k in in_kinds):
            kinds[node.node_id] = K_TENSOR
            continue
        if isinstance(node, Join) and node.fn is None \
                and node.on is not None:
            kinds[node.node_id] = K_TENSOR  # device equijoin → table
            continue
        kinds[node.node_id] = K_HOST
    return kinds


# ------------------------------------------------------------------
# cost model
# ------------------------------------------------------------------

#: static per-node dispatch overhead assumed for labels the ledger has
#: never seen (one python dispatch of a node, conservative for CPU and
#: card alike)
STATIC_DISPATCH_S = 50e-6
#: a ledger label whose mean traces-per-execution exceeds this keeps
#: its nodes OUT of regions: chronic retracing would recompile the
#: whole fused program instead of one operator
RETRACE_RATE_CAP = 1.5
#: static per-node staged-bytes estimate for labels the ledger has
#: never seen — conservative enough that budget pressure with a cold
#: ledger still splits a long run rather than over-packing device memory
STATIC_STAGED_BYTES = 4 * 1024 * 1024


class CostModel:
    """Per-node cost estimates over the :class:`OperatorLedger` feed.

    ``source="ledger"`` (default) reads the bounded per-(job,
    kind:label) ledger rows — mean wall vs device-estimate seconds
    (their gap ≈ dispatch/interpreter overhead, the quantity fusion
    recovers) and mean retraces per execution.  Unseen labels fall
    back to the static estimate; ``source="static"`` forces the
    fallback for every node (cold processes, tests)."""

    def __init__(self, job_name: str, source: str = "ledger"):
        self.source = source
        self._rows: Dict[str, Dict[str, float]] = {}
        if source == "ledger":
            # per-job read, NOT a whole-ledger snapshot: this runs on
            # every streamed execution
            self._rows = obs.operators.LEDGER.job_rows(job_name)

    def _row(self, node: Computation) -> Optional[Dict[str, float]]:
        label = getattr(node, "label", "") or ""
        kind = getattr(node, "op_kind", "?")
        return self._rows.get(f"{kind}:{label}")

    def dispatch_overhead_s(self, node: Computation) -> float:
        """Estimated per-execution overhead fusing this node deletes."""
        obs.REGISTRY.counter("fusion.cost_estimates").inc()
        row = self._row(node)
        if row and row.get("count"):
            n = row["count"]
            gap = (row.get("wall_s", 0.0)
                   - row.get("device_est_s", 0.0)) / n
            # the measured gap, floored by the static dispatch cost —
            # a ledger mean can be noisy-low, never truly zero
            return max(gap, STATIC_DISPATCH_S)
        return STATIC_DISPATCH_S

    def retrace_rate(self, node: Computation) -> float:
        """Mean program builds per execution (0.0 when unseen — a cold
        label is not evidence of churn)."""
        row = self._row(node)
        if row and row.get("count"):
            return row.get("traces", 0.0) / row["count"]
        return 0.0

    def staged_bytes(self, node: Computation) -> float:
        """Mean bytes one execution of this node's label holds on
        device: the ledger's per-label ``stage.bytes`` (streamed
        chunk uploads) plus ``bytes_in`` (resident input surface),
        per execution.  Cold labels fall back to the static per-node
        estimate, mirroring :meth:`dispatch_overhead_s`."""
        row = self._row(node)
        if row and row.get("count"):
            b = (row.get("stage.bytes", 0.0)
                 + row.get("bytes_in", 0.0)) / row["count"]
            if b > 0:
                return b
        return float(STATIC_STAGED_BYTES)

    def region_profitable(self, nodes: Sequence[Computation]) -> bool:
        """Fuse when the summed dispatch saving is positive and no
        member label retraces chronically."""
        if any(self.retrace_rate(n) > RETRACE_RATE_CAP for n in nodes):
            return False
        saving = sum(self.dispatch_overhead_s(n) for n in nodes)
        # fusing N nodes keeps 1 dispatch of the N
        return saving > STATIC_DISPATCH_S


# ------------------------------------------------------------------
# regions
# ------------------------------------------------------------------

@dataclasses.dataclass
class Region:
    """One fusion unit. ``kind="spine"``: ``node_ids`` compile as one
    program. ``kind="graft"``: ``anchor`` is the streaming fold node,
    ``pre_ids`` the rowwise chunk transforms fused into its step,
    ``post_ids`` the downstream chain fused into its epilogue."""

    rid: int
    kind: str  # "spine" | "graft"
    node_ids: Tuple[int, ...]  # topo order, anchor included for grafts
    fingerprint: str
    anchor: Optional[int] = None
    pre_ids: Tuple[int, ...] = ()
    post_ids: Tuple[int, ...] = ()
    #: the paged ScanSet feeding a fused pre-chain (the executor
    #: substitutes its stream handle for the chain's skipped output)
    stream_src: Optional[int] = None


class RegionMap:
    """The mapper's verdict for one plan execution."""

    def __init__(self, regions: List[Region]):
        self.regions = regions
        #: node_id → region, for every node any region covers
        self.by_node: Dict[int, Region] = {}
        #: node ids whose evaluation is subsumed by their region (the
        #: executor's topo loop skips them): spine non-trigger nodes,
        #: graft pre/post chains — NOT the graft anchor (it still
        #: dispatches, with the region woven into its fold)
        self.fused_away: set = set()
        #: spine regions keyed by their FIRST node (the trigger)
        self.spine_at: Dict[int, Region] = {}
        for r in regions:
            for nid in r.node_ids:
                self.by_node[nid] = r
            if r.kind == "spine":
                self.spine_at[r.node_ids[0]] = r
                self.fused_away.update(r.node_ids[1:])
            else:
                self.fused_away.update(r.pre_ids)
                self.fused_away.update(r.post_ids)

    def region_of(self, node_id: int) -> Optional[int]:
        r = self.by_node.get(node_id)
        return r.rid if r is not None else None


def _fingerprint(plan: LogicalPlan, node_ids: Sequence[int]) -> str:
    """Structural digest of a region: canonical (topo-renumbered)
    atoms of its nodes — two builds of the same DAG fingerprint
    identically, two regions differing in any label do not."""
    names = {n.node_id: f"n{i}" for i, n in enumerate(plan.topo)}
    sel = set(node_ids)
    atoms = []
    for n in plan.topo:
        if n.node_id not in sel:
            continue
        ins = ",".join(names[i.node_id] for i in n.inputs)
        label = getattr(n, "label", "") or getattr(n, "op_kind", "?")
        atoms.append(f"{names[n.node_id]}={n.op_kind}({ins};{label})")
    return hashlib.blake2s("|".join(atoms).encode()).hexdigest()[:12]


def map_regions(plan: LogicalPlan, scan_values: Dict[int, Any],
                config=None, job_name: str = "job",
                traceable: Optional[Callable[[Computation], bool]] = None,
                consumers: Optional[Dict[int, List[Computation]]] = None
                ) -> RegionMap:
    """Partition ``plan`` into fusion regions (see module docstring).

    ``traceable`` is the executor's ``_is_traceable`` predicate
    (injected to keep this module import-light).  Counters:
    ``fusion.regions_formed`` and ``fusion.nodes_fused`` tick per call
    — an always-on mapper over a busy process shows its activity on the
    scrape."""
    if traceable is None:
        traceable = lambda n: getattr(n, "traceable", True)  # noqa: E731
    min_region = max(2, int(getattr(config, "fusion_min_region", 2)))
    source = getattr(config, "fusion_cost_source", "ledger")
    mapper = getattr(config, "fusion_mapper", "optimal")
    budget = int(getattr(config, "fusion_stage_budget_bytes", 0) or 0)
    cost = CostModel(job_name, source=source)
    if consumers is None:
        consumers = plan.consumers()
    kinds = classify_values(plan, scan_values, consumers)

    regions: List[Region] = []
    rid = 0
    graft_covered: set = set()

    # --- graft regions FIRST: streamed folds + their fusable
    # neighbors (the fold-centric fusion gets priority over spines —
    # a chain absorbed into the fold's compiled loop must not be
    # claimed by a spine region instead) ---------------------------
    for node in plan.topo:
        fold = getattr(node, "fold", None)
        src = getattr(node, "fold_src", 0)
        in_kinds = [kinds.get(i.node_id, K_HOST) for i in node.inputs]
        anchored = (fold is not None and len(in_kinds) > src
                    and in_kinds[src] in (K_PAGED_REL,
                                          K_ROWWISE_PAGED))
        tensor_anchored = (getattr(node, "tensor_fold", None) is not None
                           and any(k == K_PAGED_TENSOR
                                   for k in in_kinds))
        if not (anchored or tensor_anchored):
            continue

        # upstream: rowwise Apply chain between the paged scan and the
        # fold's stream input — fused into the per-chunk step. Only
        # when the fold cannot take the grace-hash path (the grace
        # partitioner reads RAW key columns off the stream, a chunk
        # transform upstream of it would be unsound).
        pre: List[Computation] = []
        stream_src: Optional[int] = None
        if anchored and fold.probe_key is None \
                and fold.build_key is None:
            cur = node.inputs[src]
            while (isinstance(cur, Apply)
                   and getattr(cur, "rowwise", False)
                   and cur.fn is not None and traceable(cur)
                   and getattr(cur, "fold", None) is None
                   and len(consumers.get(cur.node_id, ())) == 1
                   and cur.node_id not in graft_covered):
                pre.append(cur)
                cur = cur.inputs[0]
            if pre and kinds.get(cur.node_id) == K_PAGED_REL \
                    and isinstance(cur, ScanSet):
                stream_src = cur.node_id
            else:
                pre = []  # chain must bottom out at the paged scan
        pre.reverse()  # scan → fold order

        # downstream: single-consumer traceable 1-input chain — fused
        # into one compiled epilogue over the fold's merged output
        post: List[Computation] = []
        cur_id = node.node_id
        while True:
            outs = consumers.get(cur_id, ())
            if len(outs) != 1:
                break
            nxt = outs[0]
            if not isinstance(nxt, (Apply, Aggregate)) \
                    or getattr(nxt, "fn", None) is None \
                    or not traceable(nxt) \
                    or getattr(nxt, "fold", None) is not None \
                    or getattr(nxt, "tensor_fold", None) is not None \
                    or nxt.node_id in graft_covered:
                break
            post.append(nxt)
            cur_id = nxt.node_id
        if not pre and not post:
            if mapper == "optimal" and getattr(node, "scatter_partial",
                                               False):
                # a shard-side scatter partial fold with nothing local to
                # graft is still the shard's one program: an anchor-only
                # region, so the per-shard EXPLAIN carries its region id
                ids = (node.node_id,)
                regions.append(Region(rid, "graft", ids,
                                      _fingerprint(plan, ids),
                                      anchor=node.node_id))
                graft_covered.update(ids)
                rid += 1
                obs.REGISTRY.counter("fusion.distributed_regions").inc()
            continue
        members = pre + [node] + post
        if not cost.region_profitable(members):
            continue
        ids = tuple(n.node_id for n in members)
        regions.append(Region(
            rid, "graft", ids, _fingerprint(plan, ids),
            anchor=node.node_id,
            pre_ids=tuple(n.node_id for n in pre),
            post_ids=tuple(n.node_id for n in post),
            stream_src=stream_src))
        graft_covered.update(ids)
        rid += 1
        if getattr(node, "scatter_partial", False):
            # the shard's partial fold with its grafted chains
            obs.REGISTRY.counter("fusion.distributed_regions").inc()

    # --- spine regions over the remainder: maximal topo-contiguous
    # traceable resident runs ---------------------------------------
    def spine_eligible(node: Computation) -> bool:
        if node.node_id in graft_covered:
            return False
        if not isinstance(node, (Apply, Join, Aggregate)):
            return False
        if getattr(node, "fn", None) is None or not traceable(node):
            return False
        if getattr(node, "passthrough", False):
            return False
        # a node the dispatch would stream or demote stays out (fold
        # anchors fail the all-tensor input check by construction)
        in_kinds = [kinds.get(i.node_id, K_HOST) for i in node.inputs]
        if any(k != K_TENSOR for k in in_kinds):
            return False
        return kinds.get(node.node_id) == K_TENSOR

    run: List[Computation] = []

    def flush_run():
        nonlocal rid
        if mapper == "greedy":
            # the greedy mapper: fuse the whole run or nothing
            if len(run) >= min_region and cost.region_profitable(run):
                ids = tuple(n.node_id for n in run)
                regions.append(Region(rid, "spine", ids,
                                      _fingerprint(plan, ids)))
                rid += 1
            run.clear()
            return
        for seg in _optimal_segments(run, cost, min_region, budget):
            ids = tuple(n.node_id for n in seg)
            regions.append(Region(rid, "spine", ids,
                                  _fingerprint(plan, ids)))
            rid += 1
        run.clear()

    for node in plan.topo:
        if spine_eligible(node):
            run.append(node)
        else:
            flush_run()
    flush_run()

    if regions:
        obs.REGISTRY.counter("fusion.regions_formed").inc(len(regions))
        obs.REGISTRY.counter("fusion.nodes_fused").inc(
            sum(len(r.node_ids) for r in regions))
    return RegionMap(regions)


def _optimal_segments(run: List[Computation], cost: CostModel,
                      min_region: int,
                      budget: int) -> List[List[Computation]]:
    """Exact minimum-cost partition of ONE maximal fusable run into
    fused segments (the ``fusion_mapper="optimal"`` spine planner).

    The runs the mapper accumulates are topo-contiguous and convex, so
    the region lattice over a run is exactly its set of contiguous
    segmentations — and minimum-cost segmentation is solved EXACTLY by
    an O(n²) DP, not a heuristic: state ``i`` is the best plan for the
    run's first ``i`` nodes; a node either stays per-node (cost: its
    measured dispatch overhead) or closes a fused segment (cost: ONE
    dispatch).  A segment is admissible when it meets the min-region
    floor, is profitable, contains no chronic retracer, and its
    staged-bytes estimate fits ``fusion_stage_budget_bytes``.  Ties on
    modeled cost break toward more fused nodes, then fewer segments —
    with no budget pressure an admissible run therefore fuses WHOLE,
    reproducing the greedy mapper's regions (and program keys) exactly.
    Under pressure the DP splits at the cheapest admissible edges
    instead of abandoning the run per-node; ``fusion.splits`` counts
    the extra seams of runs that were fusable whole but for the
    budget."""
    n = len(run)
    if n == 0:
        return []
    over = [cost.dispatch_overhead_s(x) for x in run]
    veto = [cost.retrace_rate(x) > RETRACE_RATE_CAP for x in run]
    staged = [cost.staged_bytes(x) for x in run]
    p_over, p_staged, p_veto = [0.0], [0.0], [0]
    for i in range(n):
        p_over.append(p_over[-1] + over[i])
        p_staged.append(p_staged[-1] + staged[i])
        p_veto.append(p_veto[-1] + (1 if veto[i] else 0))

    def admissible(j: int, i: int) -> bool:
        """run[j:i] as one fused segment?"""
        if i - j < min_region or p_veto[i] - p_veto[j]:
            return False
        if p_over[i] - p_over[j] <= STATIC_DISPATCH_S:
            return False  # fusing must beat the one kept dispatch
        return not budget or p_staged[i] - p_staged[j] <= budget

    # best[i] = (cost, -nodes_fused, segments) for run[:i]
    best: List[Tuple[float, int, List[Tuple[int, int]]]] = [(0.0, 0, [])]
    for i in range(1, n + 1):
        c, f, segs = best[i - 1]
        cand = (c + over[i - 1], f, segs)  # run[i-1] stays per-node
        for j in range(i - min_region, -1, -1):
            if not admissible(j, i):
                continue
            cj, fj, sj = best[j]
            t = (cj + STATIC_DISPATCH_S, fj - (i - j), sj + [(j, i)])
            if (t[0], t[1], len(t[2])) < (cand[0], cand[1],
                                          len(cand[2])):
                cand = t
        best.append(cand)
    chosen = best[n][2]
    if budget and len(chosen) > 1 and not p_veto[n] \
            and n >= min_region and p_over[n] > STATIC_DISPATCH_S \
            and p_staged[n] > budget:
        # the run was fusable whole but for the byte budget: it SPLIT
        # at the cheapest edges instead of falling back per-node
        obs.REGISTRY.counter("fusion.splits").inc(len(chosen) - 1)
    return [run[j:i] for j, i in chosen]


# ------------------------------------------------------------------
# the scatter boundary (used by plan/scatter.py and serve/shard.py)
# ------------------------------------------------------------------

def compile_scatter_merge(fold, nslots: int, src, job_name: str,
                          label: str) -> Callable:
    """ONE program for a scatter-gather ``fold_state`` coordinator: the
    left fold of the N shards' partial states through
    ``fold.state_merge`` and ``fold.finalize`` over the merged state (on
    the card, one CUDA graph per signature).

    ``src`` (the coordinator's ``SchemaProxy``) is closed over, and
    ``finalize`` may read only ``src.dicts`` and ``src.num_rows``, so the
    key carries the reference's digest of exactly that surface: another
    dictionary or row count is another program. Callers fall back to the
    eager merge (a counted :func:`fallback`) when the states or the fold
    cannot run as a program."""
    from netsdb_tpu_torch.plan import executor as _executor

    dicts = getattr(src, "dicts", None) or {}
    src_fp = hashlib.blake2s(repr(
        (sorted((k, tuple(v)) for k, v in dicts.items()),
         int(getattr(src, "num_rows", 0) or 0))).encode()
    ).hexdigest()[:12]
    key = (f"region::{job_name}::scatter::{label}::merge"
           f"::k{int(nslots)}::{src_fp}")

    def merge_finalize(states):
        merged = states[0]
        for s in states[1:]:
            merged = fold.state_merge(merged, s)
        return fold.finalize(merged, src)

    obs.REGISTRY.counter("fusion.distributed_regions").inc()
    prog = _executor._cached_program(key, region=f"{job_name}:scatter")
    return _executor._bound(prog, merge_finalize,
                            [fold.state_merge, fold.finalize])


# ------------------------------------------------------------------
# graft helpers (used by the executor)
# ------------------------------------------------------------------

def wrap_fold_prechain(fold, pre_fns: Sequence[Callable]):
    """A :class:`~netsdb_tpu_torch.plan.fold.FoldSpec` whose every pass
    step applies ``pre_fns`` (scan→fold order) to the chunk BEFORE the
    original step — the chunk is transformed and reduced in one
    compiled program.  Only the STEPS are wrapped: ``init`` and
    ``finalize`` still receive the raw scan handle as ``src``, which
    is why the ``rowwise`` declaration requires schema/dict
    preservation (see ``Apply`` in plan/computations.py) — a fold
    reading ``src.dicts`` must observe the same surface either way.
    The caller must key the wrapped step's program differently from
    the bare fold's (the executor appends the region fingerprint)."""
    fns = tuple(pre_fns)

    def wrap(step):
        def fused_step(state, chunk, *resident):
            c = chunk
            for f in fns:
                c = f(c)
            return step(state, c, *resident)
        return fused_step

    passes = tuple((init, wrap(step)) for init, step in fold.passes)
    return dataclasses.replace(fold, passes=passes)


def compose_chain(fns: Sequence[Callable]) -> Callable:
    """``fns`` applied left-to-right as one callable (the epilogue
    body handed to ``_cached_program``)."""
    fseq = tuple(fns)

    def chain(x):
        for f in fseq:
            x = f(x)
        return x

    return chain


def fallback(reason: str) -> None:
    """Tick the runtime-fallback counter (a region abandoned at
    execution time — values a program cannot take, a capture that
    cannot run) and annotate the active trace."""
    obs.REGISTRY.counter("fusion.fallbacks").inc()
    tr = obs.current_trace()
    if tr is not None:
        tr.add("fusion.fallbacks")
        tr.annotate("fusion.fallback", reason)
