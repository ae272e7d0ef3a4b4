"""Per-operator plan profiling — EXPLAIN ANALYZE for the executor;
counterpart of ``netsdb_tpu/obs/operators.py``.

The executor installs an :class:`OperatorRecorder` for one execution
(:func:`recording`) when the query is traced or an
:func:`explain_capture` is active; a ``contextvars.ContextVar`` names
the node evaluating (:func:`current_op`), so the layers below (program
builds in the compiled-program cache, chunk loops) tick its counters
with :func:`op_add` and no plumbing. Without a recorder :func:`op_add`
is one context-variable read.

The finished tree (node id = topo position, stable across rebuilds of a
plan) goes to the active query trace's ``operators`` section, to an
active :func:`explain_capture` (``Client.execute_computations(...,
explain=True)``), and into the bounded per-(job, node-label)
:class:`OperatorLedger` — the cost feed of the fusion mapper
(``plan/fusion.CostModel``). Times are ``time.perf_counter`` on the
host: on the card a node's wall time covers its launches, not its
kernels (a program's kernels run after the host returns).
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

from netsdb_tpu_torch.obs import metrics as _metrics


class OpRecord:
    """One plan node's measured execution: inclusive wall time plus
    the counters the instrumented layers tick while it is the current
    op (device-estimate seconds, chunks/blocks, staged bytes/waits,
    devcache hits/misses, program builds). Thread-safe adds — staging
    workers report into the consumer's record."""

    __slots__ = ("op_id", "kind", "label", "atom", "inputs", "wall_s",
                 "rows_in", "rows_out", "fused", "region", "_mu",
                 "_counters")

    def __init__(self, op_id: int, kind: str, label: str, atom: str,
                 inputs: List[int]):
        self.op_id = op_id
        self.kind = kind
        self.label = label
        self.atom = atom
        self.inputs = list(inputs)
        self.wall_s = 0.0
        self.rows_in: Optional[int] = None
        self.rows_out: Optional[int] = None
        self.fused = False
        #: fusion region id (plan/fusion.py) this node compiled into,
        #: None outside any region — the explain tree renders region
        #: membership and boundaries from this
        self.region: Optional[int] = None
        self._mu = threading.Lock()
        self._counters: Dict[str, float] = {}

    def add(self, counter: str, n: float = 1) -> None:
        with self._mu:
            self._counters[counter] = self._counters.get(counter, 0) + n

    def as_dict(self) -> Dict[str, Any]:
        with self._mu:
            counters = dict(self._counters)
        out: Dict[str, Any] = {
            "id": self.op_id, "kind": self.kind, "label": self.label,
            "atom": self.atom, "inputs": list(self.inputs),
            "wall_s": self.wall_s,
            "device_est_s": counters.get("device_est_s", 0.0)
            + counters.get("stage.wait_s", 0.0),
        }
        if self.rows_in is not None:
            out["rows_in"] = self.rows_in
        if self.rows_out is not None:
            out["rows_out"] = self.rows_out
        if self.fused:
            out["fused"] = True
        if self.region is not None:
            out["region"] = self.region
        if counters:
            out["counters"] = counters
        return out


def rows_of(value) -> Optional[int]:
    """Best-effort row/item count of a node value, metadata-only —
    ColumnTables report rows, host lists/tuples/dicts their length
    (for a dict of grouped partials that is the group count), arrays
    their leading dim; opaque values (paged handles mid-stream) report
    None rather than forcing a materialization."""
    num_rows = getattr(value, "num_rows", None)
    if num_rows is not None:
        try:
            return int(num_rows)
        except (TypeError, ValueError):
            return None
    if isinstance(value, (list, tuple, dict)):
        return len(value)
    shape = getattr(value, "shape", None)
    if shape:
        return int(shape[0])
    return None


def bytes_of(value) -> Optional[int]:
    """Metadata-only byte size of array-shaped values (the executor's
    rows/bytes in-out record); None for host-object values (sizing
    them would iterate + pickle the very data the explain path must
    not touch)."""
    cols = getattr(value, "cols", None)
    if cols is not None:
        try:
            return int(sum(int(getattr(v, "nbytes", 0))
                           for v in cols.values()))
        except (TypeError, ValueError):
            return None
    nbytes = getattr(value, "nbytes", None)
    if nbytes is not None:
        try:
            return int(nbytes)
        except (TypeError, ValueError):
            return None
    data = getattr(value, "data", None)  # BlockedTensor
    if data is not None:
        return bytes_of(data)
    return None


class OperatorRecorder:
    """Per-execution operator tree: the executor opens one around a
    plan run, enters :meth:`op` per node, and :meth:`finish` emits the
    plain-dict tree + feeds the cross-query ledger."""

    def __init__(self, job_name: str, mode: str = "streamed"):
        self.job_name = job_name
        self.mode = mode
        self._mu = threading.Lock()
        self._nodes: Dict[int, OpRecord] = {}
        self._next = 0
        self._t0 = time.perf_counter()

    def reserve(self, count: int) -> int:
        """Allocate a contiguous op-id block for one plan component —
        an auto-split job (``execute_computations`` recursing per
        component) records every component into ONE tree without id
        collisions. Deterministic: split order is deterministic, so a
        re-run reserves identically (the explain-stability
        contract)."""
        with self._mu:
            base = self._next
            self._next += int(count)
            return base

    @staticmethod
    def _label_of(node: Any) -> str:
        """CANONICAL node label: the declared ``label`` when one
        exists, else ``db:set`` for scans/writes — never the default
        ``output_name``, whose embedded process-global node id would
        make two builds of the same DAG produce different trees (the
        explain-stability contract: a cold run and a devcache-warm
        re-run of one plan must be shape-identical)."""
        label = getattr(node, "label", "") or ""
        if label:
            return label
        db = getattr(node, "db", None)
        set_name = getattr(node, "set_name", None)
        if db and set_name:
            return f"{db}:{set_name}"
        return getattr(node, "op_kind", "?").lower()

    def node(self, op_id: int, node: Any,
             inputs: List[int]) -> OpRecord:
        """Get-or-create the record for topo position ``op_id``."""
        with self._mu:
            rec = self._nodes.get(op_id)
            if rec is None:
                rec = self._nodes[op_id] = OpRecord(
                    op_id, getattr(node, "op_kind", "?"),
                    self._label_of(node),
                    node.plan_atom() if hasattr(node, "plan_atom")
                    else "", inputs)
            return rec

    @contextlib.contextmanager
    def op(self, op_id: int, node: Any, inputs: List[int],
           in_vals: Optional[List[Any]] = None) -> Iterator[OpRecord]:
        """Time one node's evaluation inclusively and install it as the
        current op for the dynamic extent — staging/devcache/jit ticks
        attribute here. Nodes evaluate sequentially in the topo loop,
        so the per-node walls SUM to within the executor span (the
        EXPLAIN ANALYZE invariant the tests pin)."""
        rec = self.node(op_id, node, inputs)
        if in_vals:
            rows = [rows_of(v) for v in in_vals]
            known = [r for r in rows if r is not None]
            if known:
                rec.rows_in = int(sum(known))
            nb = [bytes_of(v) for v in in_vals]
            nb_known = [b for b in nb if b is not None]
            if nb_known:
                rec.add("bytes_in", int(sum(nb_known)))
        token = _current_op.set(rec)
        t0 = time.perf_counter()
        try:
            yield rec
        finally:
            rec.wall_s += time.perf_counter() - t0
            _current_op.reset(token)

    def mark_fused(self, topo: List[Any], wall_s: float,
                   device_est_s: float) -> None:
        """Whole-plan path: every node ran inside ONE program (a CUDA
        graph on the card), so per-node times do not exist — record the
        tree SHAPE (the plan still explains) with each node marked
        ``fused`` and a synthetic root carrying the program's measured
        time."""
        base = self.reserve(len(topo) + 1)
        self.mode = "whole_plan_jit" if base == 0 else "mixed"
        pos = {n.node_id: base + i for i, n in enumerate(topo)}
        for n in topo:
            rec = self.node(pos[n.node_id], n,
                            [pos[x.node_id] for x in n.inputs])
            rec.fused = True
        root = self.node(base + len(topo), _FusedRoot(),
                         [pos[n.node_id] for n in topo])
        root.wall_s = wall_s
        root.add("device_est_s", device_est_s)

    def tree(self) -> Dict[str, Any]:
        with self._mu:
            nodes = [self._nodes[k].as_dict()
                     for k in sorted(self._nodes)]
        total = sum(n["wall_s"] for n in nodes)
        return {"job": self.job_name, "mode": self.mode,
                "nodes": nodes, "total_wall_s": total}

    def finish(self) -> Dict[str, Any]:
        """Emit the tree: attach to the active query trace (the
        profile's ``operators`` section), deposit into an active
        :func:`explain_capture`, and aggregate every node into the
        bounded per-(job, label) ledger."""
        from netsdb_tpu_torch.obs.trace import current_trace

        tree = self.tree()
        tr = current_trace()
        if tr is not None:
            tr.attach_section("operators", tree)
        holder = _capture_var.get()
        if holder is not None:
            holder["operators"] = tree
        for n in tree["nodes"]:
            LEDGER.add(self.job_name, f"{n['kind']}:{n['label']}", n)
        return tree


class _FusedRoot:
    """Synthetic node standing for the one program of a whole-plan
    execution."""

    op_kind = "WholePlanJit"
    label = "whole_plan_jit"

    def plan_atom(self) -> str:
        return "whole_plan <= PROGRAM(<all nodes in one program>)"


class OperatorLedger:
    """Bounded cross-query aggregate: (job, node-label) → summed
    wall/device/chunk/trace counters + execution count. The registry's
    ``operators`` section — the per-node cost model feed (a mean cost
    per executed operator, queryable without tracing every request).
    Overflow beyond ``max_keys`` lands in one bucket so a label-
    fabricating client cannot grow daemon memory."""

    #: the per-node numeric fields worth aggregating across queries
    FIELDS = ("wall_s", "device_est_s")
    COUNTER_FIELDS = ("chunks", "blocks", "traces", "devcache.hits",
                      "devcache.misses", "stage.wait_s", "stage.bytes",
                      "bytes_in")

    def __init__(self, max_keys: int = 2048):
        self._mu = threading.Lock()
        self._max = int(max_keys)
        self._rows: Dict[Tuple[str, str], Dict[str, float]] = {}

    def add(self, job: str, label: str, node: Dict[str, Any]) -> None:
        key = (str(job), str(label))
        with self._mu:
            row = self._rows.get(key)
            if row is None:
                if len(self._rows) >= self._max:
                    key = ("overflow", "*")
                    row = self._rows.setdefault(key, {})
                    _metrics.REGISTRY.counter(
                        "obs.operators_overflow").inc()
                else:
                    row = self._rows[key] = {}
            row["count"] = row.get("count", 0) + 1
            for f in self.FIELDS:
                row[f] = row.get(f, 0.0) + float(node.get(f) or 0.0)
            counters = node.get("counters") or {}
            for f in self.COUNTER_FIELDS:
                v = counters.get(f)
                if v:
                    row[f] = row.get(f, 0.0) + float(v)

    def snapshot(self) -> Dict[str, Dict[str, Dict[str, float]]]:
        """{job: {label: {field: total}}} — the registry section."""
        with self._mu:
            out: Dict[str, Dict[str, Dict[str, float]]] = {}
            for (job, label), row in self._rows.items():
                out.setdefault(job, {})[label] = dict(row)
            return out

    def job_rows(self, job: str) -> Dict[str, Dict[str, float]]:
        """ONE job's {label: {field: total}} rows — the fusion cost
        model's per-execution read (copying only the queried job's
        rows keeps the contended section O(labels-of-one-job), not
        O(whole ledger), on the serve hot path)."""
        job = str(job)
        with self._mu:
            return {label: dict(row)
                    for (j, label), row in self._rows.items()
                    if j == job}

    def reset(self) -> None:
        with self._mu:
            self._rows.clear()


#: process ledger, exported as the registry's "operators" section
LEDGER = OperatorLedger()
_metrics.REGISTRY.register_collector("operators", LEDGER.snapshot)

_current_op: "contextvars.ContextVar[Optional[OpRecord]]" = \
    contextvars.ContextVar("netsdb_torch_obs_op", default=None)
_current_rec: "contextvars.ContextVar[Optional[OperatorRecorder]]" = \
    contextvars.ContextVar("netsdb_torch_obs_oprec", default=None)
_capture_var: "contextvars.ContextVar[Optional[Dict[str, Any]]]" = \
    contextvars.ContextVar("netsdb_torch_obs_explain", default=None)


def current_op() -> Optional[OpRecord]:
    """The node currently evaluating (None outside a recorded
    execution) — what staging streams capture on the consumer
    thread."""
    return _current_op.get()


def current_recorder() -> Optional[OperatorRecorder]:
    return _current_rec.get()


def op_add(counter: str, n: float = 1) -> None:
    """Tick a counter on the current operator (no-op without one —
    one context-var read on the unrecorded fast path)."""
    rec = _current_op.get()
    if rec is not None:
        rec.add(counter, n)


def should_record(config=None) -> bool:
    """True when this execution wants an operator tree: an explicit
    ``explain=True`` capture is active (always honored), or the query
    is traced AND ``config.obs_explain`` is on."""
    if _capture_var.get() is not None:
        return True
    if config is not None and not getattr(config, "obs_explain", True):
        return False
    from netsdb_tpu_torch.obs.trace import current_trace

    return current_trace() is not None


@contextlib.contextmanager
def recording(job_name: str, config=None,
              force: bool = False) -> Iterator[Optional[OperatorRecorder]]:
    """Install an :class:`OperatorRecorder` for one execution when
    :func:`should_record` says so (or ``force``); finish it on exit.
    Yields None — and records nothing — otherwise, or when a recorder
    is already active (a recursive ``execute_computations`` auto-split
    joins the outer recording rather than shadowing it)."""
    if _current_rec.get() is not None or not (
            force or should_record(config)):
        yield None
        return
    rec = OperatorRecorder(job_name)
    token = _current_rec.set(rec)
    try:
        yield rec
    finally:
        _current_rec.reset(token)
        rec.finish()


@contextlib.contextmanager
def explain_capture() -> Iterator[Dict[str, Any]]:
    """Force-record the next execution in this context and hand its
    tree back in ``holder["operators"]`` —
    ``Client.execute_computations(..., explain=True)`` wraps the job in
    this."""
    holder: Dict[str, Any] = {"operators": None}
    token = _capture_var.set(holder)
    try:
        yield holder
    finally:
        _capture_var.reset(token)


# ---------------------------------------------------------------------
# rendering — the classic EXPLAIN ANALYZE tree (cli `obs --explain`)
# ---------------------------------------------------------------------

def render_tree(tree: Dict[str, Any],
                total_s: Optional[float] = None) -> str:
    """Text rendering of one operator tree, sinks at the root, inputs
    indented below — per node: kind/label, wall ms, % of the plan
    total (or of ``total_s`` when the caller passes the profile's
    total), rows in/out and the interesting counters."""
    nodes = {n["id"]: n for n in tree.get("nodes") or []}
    if not nodes:
        return "(no operator profile)"
    consumed = set()
    for n in nodes.values():
        consumed.update(n.get("inputs") or ())
    roots = [i for i in sorted(nodes) if i not in consumed]
    denom = total_s if total_s else (tree.get("total_wall_s") or 0.0)
    lines = [f"EXPLAIN ANALYZE  job={tree.get('job')} "
             f"mode={tree.get('mode')} "
             f"total={1e3 * (tree.get('total_wall_s') or 0.0):.2f}ms"]

    def fmt(n: Dict[str, Any]) -> str:
        wall = n.get("wall_s") or 0.0
        pct = (100.0 * wall / denom) if denom else 0.0
        bits = [f"{n.get('kind')}[{n.get('label')}]",
                f"wall={1e3 * wall:.2f}ms ({pct:.1f}%)"]
        dev = n.get("device_est_s") or 0.0
        if dev:
            bits.append(f"device≈{1e3 * dev:.2f}ms")
        if n.get("rows_in") is not None:
            bits.append(f"rows_in={n['rows_in']}")
        if n.get("rows_out") is not None:
            bits.append(f"rows_out={n['rows_out']}")
        if n.get("region") is not None:
            # fusion region membership (plan/fusion.py): every node of
            # region rN ran as ONE program
            bits.append(f"region=r{n['region']}"
                        + ("" if n.get("fused") else "*"))
        elif n.get("fused"):
            bits.append("fused")
        c = n.get("counters") or {}
        keep = {k: v for k, v in c.items()
                if k in ("chunks", "blocks", "pairs", "traces",
                         "region_nodes", "devcache.hits",
                         "devcache.misses", "stage.chunks",
                         "stage.bytes")}
        if keep:
            bits.append(" ".join(f"{k}={int(v)}" for k, v in
                                 sorted(keep.items())))
        return "  ".join(bits)

    def walk(op_id: int, depth: int, seen: set,
             parent_region=None) -> None:
        n = nodes.get(op_id)
        if n is None:
            return
        marker = "-> " if depth else ""
        region = n.get("region")
        if depth and region != parent_region:
            # fusion-region boundary: the edge crosses out of (or
            # into) a fused program — the materialization point
            marker = "=> " if region is None else f"┆r{region} "
        lines.append(f"{'  ' * depth}{marker}{fmt(n)}")
        if op_id in seen:  # shared subgraph: print once per parent,
            return         # recurse once
        seen.add(op_id)
        for i in n.get("inputs") or ():
            walk(i, depth + 1, seen, region)

    seen: set = set()
    for r in roots:
        walk(r, 0, seen)
    return "\n".join(lines)


def render_shard_forest(shard_ops: Optional[Dict[str, Any]],
                        total_s: Optional[float] = None) -> str:
    """Text rendering of a scatter-gather query's per-shard EXPLAIN
    forest (``shard_operators``): each member's subplan tree rendered by
    the same :func:`render_tree` the coordinator tree gets, so region
    ids, boundary markers and the streaming-anchor annotation read alike
    across the distributed tree. Members sort by address."""
    if not shard_ops:
        return "(no shard operator forest)"
    parts = []
    for addr in sorted(shard_ops):
        tree = shard_ops[addr] or {}
        parts.append(f"-- shard {addr}")
        parts.append(render_tree(tree, total_s))
    return "\n".join(parts)
