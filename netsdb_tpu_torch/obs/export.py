"""OpenMetrics / Prometheus text exposition of the registry — the
port's ``netsdb_tpu/obs/export.py``.

``GET_METRICS format=openmetrics`` turns one registry snapshot (with the
per-(client, set) attribution ledger) into the Prometheus text format::

    # HELP netsdb_serve_requests_total frames dispatched ...
    # TYPE netsdb_serve_requests_total counter
    netsdb_serve_requests_total 1042
    netsdb_attrib_staged_bytes_total{client="tenant-a",set="d:lineitem"} 83886080

* **Stable names.** Every exported family maps to a catalogued registry
  metric (:data:`CATALOG`, the reference's catalogue, name for name and
  help text for help text, so both packages export the same bytes for
  the same snapshot). An uncatalogued instrument is skipped and counted
  (``obs.export.uncatalogued``).
* **Types.** Counters export as ``*_total`` counter families, gauges as
  gauges, registry histograms as ``summary`` families (``_sum`` and
  ``_count`` exact, ``quantile`` lines from the bounded sample ring).
* **Labels.** The attribution ledger exports per-``client``/``set``
  sample lines under ``netsdb_attrib_*`` families; follower sections
  (a later slice's daemons) ride a ``follower`` label.

:func:`parse_openmetrics` is the in-repo grammar check that the tests
run over every scrape: names, label syntax, sample grammar and values."""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Tuple

from netsdb_tpu_torch.obs import metrics as _metrics

#: metric families of the attribution ledger (obs/attrib.py accounts
#: these per (client, scope); they are not registry instruments, so
#: they are catalogued here explicitly)
ATTRIB_METRICS = (
    "requests", "staged_bytes", "staged_chunks", "devcache.hits",
    "devcache.misses", "devcache.installs", "devcache.partial_hits",
    "executor.chunks",
)


#: counters the port mints that the reference does not (its float32
#: product route, its follower resync and applied log, the in-process
#: mesh, the shuffle and the single-position SUMMA): catalogued so the
#: scrape exports them
PORT_ONLY_COUNTERS = (
    ("matmul.cublas_f32", "float32 products on an sm_90 card left on "
                          "cuBLAS (ops/common.tf32x3_route)"),
    ("matmul.tf32x3", "float32 products on an sm_90 card sent to the "
                      "three-pass TF32 kernel"),
    ("mesh.all_gathers", "row-sharded relations all-gathered for a "
                         "non-rowwise node"),
    ("mesh.fallbacks", "placed operands gathered by an op with no "
                       "placed rule (parallel/mesh.gather_log)"),
    ("mesh.placed_chunks", "relation chunks run per mesh position"),
    ("mesh.placed_folds", "folds run per mesh position"),
    ("mesh.rowwise_nodes", "rowwise plan nodes run per mesh position"),
    ("serve.applied_compactions", "follower applied-log compactions into "
                                  "a new base snapshot"),
    ("serve.applied_frames_restored", "applied-log frames replayed on a "
                                      "follower's restart"),
    ("serve.follower_evictions", "followers evicted by the leader"),
    ("serve.follower_readmits", "evicted followers readmitted"),
    ("serve.remirrored_retries", "cached retries of a mirrored frame "
                                 "mirrored again"),
    ("serve.resync.frames_replayed", "frames replayed by log resyncs"),
    ("serve.resync.log_replays", "follower resyncs by log replay"),
    ("serve.resync.snapshot_bytes", "bytes shipped by snapshot resyncs"),
    ("serve.resync.snapshots", "follower resyncs by snapshot"),
    ("shuffle.repartitions", "hash repartitions of a relation"),
    ("summa.single_position", "streamed matmuls that ran on one "
                              "position (no SUMMA grid)"),
)


def _catalog() -> Dict[str, Tuple[str, str]]:
    """name → (type, help) for every exported metric."""
    counters = (
        ("serve.requests", "workload frames dispatched (outcome time; "
                           "OBS frames excluded)"),
        ("serve.requests_ok", "workload frames answered without an ERR"),
        ("serve.idem.memory_hits", "idempotent retries answered from "
                                   "the in-memory reply cache"),
        ("serve.idem.persist_hits", "idempotent retries answered from "
                                    "the persisted sqlite cache"),
        ("serve.client.retries", "client-side request retries"),
        ("serve.client.hedges_issued", "hedged reads issued"),
        ("serve.client.hedges_won", "hedged reads won by the hedge"),
        ("serve.client.traces_shipped", "client trace profiles shipped "
                                        "via PUT_TRACE"),
        ("serve.client.trace_ship_failures", "PUT_TRACE ship failures "
                                             "(best-effort, counted)"),
        ("serve.client.trace_ship_dropped", "client trace profiles "
                                            "dropped on a full ship "
                                            "queue"),
        ("serve.client.placement_refreshes", "placement-map re-fetches "
                                             "after a stale-map "
                                             "rejection"),
        ("serve.client.routed_ingests", "logical ingests routed "
                                        "directly to owning shards"),
        ("serve.mirror_dropped", "queued mirror frames dropped by an "
                                 "abort-closed follower link"),
        ("ha.terms", "HA term adoptions (promotions plus higher-term "
                     "observations)"),
        ("ha.promotions", "follower-to-leader promotions won after the "
                          "election window"),
        ("ha.stragglers_rejected", "stale-term frames from a deposed "
                                   "leader rejected with a typed "
                                   "NotLeader"),
        ("mutlog.appended_bytes", "bytes appended to the durable "
                                  "mutation log (mirror frames, token "
                                  "aliases, handoff spill)"),
        ("shard.scatter_queries", "queries executed scatter-gather "
                                  "across the shard pool by this "
                                  "coordinator"),
        ("shard.subplans", "pushed subplans executed over this "
                           "daemon's local pages"),
        ("shard.partials_merged", "per-slot partial results merged by "
                                  "the coordinator (all-or-nothing)"),
        ("shard.shuffle_parts", "distributed-shuffle buckets received "
                                "from peer shards"),
        ("shard.shuffle_bytes", "bytes received over the distributed "
                                "shuffle (out-of-band v3 segments)"),
        ("shard.epoch_rejects", "frames rejected for a stale placement "
                                "epoch (typed PlacementStale)"),
        ("shard.handoff_batches", "ingest batches buffered for a "
                                  "degraded shard slot at the leader"),
        ("shard.handoff_drained", "buffered handoff batches shipped to "
                                  "a readmitted shard (its own pages "
                                  "only)"),
        ("shard.evictions", "shard daemons degraded out of the pool "
                            "(slots flip to handoff, epochs bump)"),
        ("shard.readmits", "shard daemons readmitted after a "
                           "shard-scoped resync"),
        ("shard.analyze_fanouts", "ANALYZE_SET requests fanned out "
                                  "over a partitioned set's slots and "
                                  "merged (rows sum, min/max envelope, "
                                  "dict union)"),
        ("models.deploys", "model-as-blocked-sets deployments over a "
                           "serving pool (weights mirrored to every "
                           "member)"),
        ("models.batches_scored", "scoring frames executed over the "
                                  "serving pool"),
        ("models.rows_scored", "batch rows scored over the serving "
                               "pool (the rows/s headline numerator)"),
        ("sched.feedback_reseeds", "lane weight/quota reseeds applied "
                                   "from the attribution + operator "
                                   "ledgers (sched_feedback)"),
        ("sched.shed_events", "heaviest-lane quota halvings applied "
                              "by SLO burn-rate load shedding "
                              "(sched_slo_shed)"),
        ("devcache.lookups", "device block cache lookups (hits+misses)"),
        ("devcache.hits", "device block cache hits"),
        ("devcache.misses", "device block cache misses"),
        ("devcache.installs", "complete runs installed into the device "
                              "cache"),
        ("devcache.evictions", "device cache LRU evictions"),
        ("devcache.invalidations", "device cache entries dropped by "
                                   "write-path invalidation"),
        ("devcache.partial_hits", "individual device-resident blocks "
                                  "served by range-stitched streams "
                                  "(partial-run caching)"),
        ("devcache.stitched_ranges", "contiguous cached ranges "
                                     "stitched into staged streams"),
        ("devcache.dirty_invalidations", "block entries dropped by "
                                         "dirty-RANGE invalidation "
                                         "(intersecting a written row "
                                         "range)"),
        ("summa.rounds", "SUMMA round programs dispatched over the "
                         "mesh (one per N-block batch)"),
        ("summa.panel_bcasts", "B panels broadcast over the mesh axis "
                               "by SUMMA steps"),
        ("summa.panel_bytes", "bytes moved by SUMMA panel broadcasts "
                              "(interconnect, not host transfers)"),
        ("summa.staged_bytes", "operand bytes staged host->device by "
                               "SUMMA runs (sum over participants; "
                               "~1/N of operand bytes per host)"),
        ("summa.grid_rounds", "2-d grid SUMMA round programs "
                              "dispatched (one per pr-block batch)"),
        ("summa.grid_steps", "dual-broadcast steps executed by 2-d "
                             "grid SUMMA rounds (pr*pc per round)"),
        ("summa.grid_panel_bcasts", "A and B slices broadcast over the "
                                    "grid axes (2 per grid step)"),
        ("summa.grid_staged_bytes", "operand bytes staged host->device "
                                    "by 2-d grid SUMMA runs (~1/(pr*pc) "
                                    "of each operand per device)"),
        ("reshard.plans", "collective-step reshard schedules planned"),
        ("reshard.steps", "collective steps executed by reshards "
                          "(all_gather / all_to_all / local_slice / "
                          "replace)"),
        ("reshard.blocks_moved", "device-resident blocks moved between "
                                 "layouts device-to-device (zero arena "
                                 "reads)"),
        ("reshard.bytes_moved", "bytes moved between layouts without a "
                                "host round-trip"),
        ("staging.chunks", "chunks staged host->device"),
        ("staging.bytes", "bytes staged host->device (accounted "
                          "streams)"),
        ("obs.traces.client", "completed client-origin query traces"),
        ("obs.traces.server", "completed server-origin query traces"),
        ("obs.traces.local", "completed local-origin query traces"),
        ("obs.traces.bench", "completed bench-origin query traces"),
        ("obs.qid_sampled_out", "requests that skipped tracing under "
                                "1-in-N qid sampling"),
        ("obs.slow_queries", "profiles persisted to the slowlog ring"),
        ("obs.slowlog_errors", "slowlog persistence failures (counted, "
                               "never fatal)"),
        ("obs.put_trace.merged", "PUT_TRACE sections merged into a "
                                 "ringed profile"),
        ("obs.put_trace.unmatched", "PUT_TRACE sections whose qid never "
                                    "ringed"),
        ("obs.operators_overflow", "operator-ledger rows folded into "
                                   "the overflow bucket"),
        ("obs.export.uncatalogued", "registry instruments skipped by "
                                    "the OpenMetrics exporter for "
                                    "missing a catalog entry"),
        ("attrib.overflow", "attribution rows folded into the overflow "
                            "bucket"),
        ("sched.admits", "jobs granted an admission slot by the query "
                         "scheduler"),
        ("sched.quota_rejects", "jobs refused because their lane's "
                                "queue quota was full (typed "
                                "LaneSaturated)"),
        ("sched.timeouts", "jobs refused after waiting out the "
                           "admission timeout (typed AdmissionFull)"),
        ("sched.aged_grants", "admissions granted by the "
                              "anti-starvation aging rule instead of "
                              "lane weights"),
        ("sched.coalesce_hits", "EXECUTE frames coalesced behind an "
                                "identical in-flight execution"),
        ("sched.coalesce_late_hits", "EXECUTE frames served from the "
                                     "completed-fingerprint retention "
                                     "window just after their leader "
                                     "finished"),
        ("sched.coalesce_failures", "coalesced waiters aborted by a "
                                    "failed or overlong leader "
                                    "(typed CoalesceAborted)"),
        ("sched.affinity_hits", "queries that waited behind a cold "
                                "hot-set installer and woke into the "
                                "warm device cache"),
        ("sched.affinity_installs", "cold-set installer executions "
                                    "registered by the affinity gate"),
        ("fusion.regions_formed", "fusion regions formed by the plan "
                                  "mapper (plan/fusion.py)"),
        ("fusion.nodes_fused", "plan nodes compiled inside a fusion "
                               "region"),
        ("fusion.fallbacks", "fusion regions abandoned at execution "
                             "time (non-jit-safe values) — the nodes "
                             "ran per-node instead"),
        ("fusion.cost_estimates", "per-node cost-model estimates "
                                  "computed by the fusion mapper"),
        ("fusion.splits", "fusion regions split at their cheapest "
                          "edge because the single-region staged-"
                          "bytes estimate exceeded "
                          "fusion_stage_budget_bytes"),
        ("fusion.distributed_regions", "fusion regions compiled "
                                       "across the scatter boundary "
                                       "(per-shard partial-fold "
                                       "programs + coordinator "
                                       "merge+finalize programs)"),
        ("slo.breaches", "SLO objective breach transitions"),
        ("slo.recoveries", "SLO objective recovery transitions"),
        ("analysis.violations", "runtime lock-order cycles detected "
                                "by the lockdep witness"),
        ("rebalance.moves", "shard slot moves committed by the live "
                            "rebalancer (epoch-bumped, "
                            "count-verified)"),
        ("rebalance.bytes_moved", "partition bytes shipped by "
                                  "committed rebalance moves"),
        ("rebalance.aborts", "rebalance moves unwound before their "
                             "epoch commit (peer death, count "
                             "mismatch, source shrank)"),
        ("rebalance.skew_checks", "skew-detector passes run on the "
                                  "sched-feedback / pool-health "
                                  "cadence"),
        ("rebalance.advisor_commits", "rebalance moves kept by the "
                                      "placement-advisor arm after a "
                                      "measured throughput win"),
        ("session.opened", "interactive decode sessions opened "
                           "(SESSION_OPEN accepted; idempotent "
                           "re-opens excluded)"),
        ("session.closed", "interactive decode sessions closed "
                           "(explicit SESSION_CLOSE; TTL expiry "
                           "counts under session.evicted)"),
        ("session.evicted", "per-session state entries evicted from "
                            "the device cache (TTL expiry or LRU "
                            "pressure; spilled to the arena first)"),
        ("session.decode_steps", "decode steps applied to session "
                                 "state (one per session per batch "
                                 "dispatch)"),
        ("session.batch_occupancy", "summed batch occupancy across "
                                    "decode dispatches (divide by "
                                    "batches for mean coalescing)"),
        ("session.budget_spills", "advanced state layers larger than "
                                  "the whole device-cache budget, "
                                  "written straight to the arena "
                                  "instead of resident"),
        ("session.spill_errors", "session state spill callbacks that "
                                 "failed (state copy missed, cache "
                                 "unharmed)"),
        ("session.spill_push_errors", "dirty-state pushes to the "
                                      "session's home daemon that "
                                      "failed (re-marked, retried "
                                      "next housekeeping tick)"),
    )
    gauges = (
        ("placement.epoch", "the placement map's global epoch (bumps "
                            "on every membership change and "
                            "committed slot move)"),
        ("analysis.lock_edges", "distinct lock-rank acquisition-order "
                                "edges observed by the witness"),
        ("analysis.callgraph_edges", "resolved call edges in the "
                                     "interprocedural lint rules' "
                                     "project call graph"),
        ("analysis.race_findings", "static shared-state race findings "
                                   "on the last lint run"),
        ("analysis.witness_uncovered_edges", "static lock-order edges "
                                             "the runtime witness has "
                                             "never exercised "
                                             "(untested concurrency)"),
        ("sched.queue_depth", "requests currently queued across all "
                              "scheduler lanes"),
        ("devcache.pinned_bytes", "bytes of head blocks currently "
                                  "pinned against LRU eviction "
                                  "(device_cache_pin_bytes)"),
        ("session.resident_bytes", "bytes of per-session decode state "
                                   "currently resident in the device "
                                   "cache"),
        ("dedup.page_bytes", "unique model weight-page bytes resident "
                             "after cross-model deduplication "
                             "(compare against the per-model "
                             "attribution sum)"),
    )
    hists = (
        ("sched.queue_wait_s", "seconds a job waited in its scheduler "
                               "lane before admission (the "
                               "retry_after_s hint's feed)"),
        ("serve.request_s", "server-side frame latency seconds "
                            "(time-to-first-frame for streams)"),
        ("serve.client.read_latency_s", "client-observed read latency "
                                        "seconds (the hedge trigger "
                                        "feed)"),
        ("staging.wait_s", "consumer seconds blocked on a staged "
                           "host->device upload"),
    )
    out: Dict[str, Tuple[str, str]] = {}
    for name, help_ in counters + PORT_ONLY_COUNTERS:
        out[name] = ("counter", help_)
    for name, help_ in gauges:
        out[name] = ("gauge", help_)
    for name, help_ in hists:
        out[name] = ("histogram", help_)
    for name in ATTRIB_METRICS:
        out[f"attrib.{name}"] = (
            "counter", f"per-(client, set) attributed {name}")
    return out


#: the metric catalog
CATALOG = _catalog()

_QUANTILES = (0.5, 0.95, 0.99)


def metric_name(raw: str, suffix: str = "") -> str:
    """Registry name → Prometheus family name: ``netsdb_`` prefix,
    dots/dashes to underscores, counter families get ``_total``."""
    return "netsdb_" + re.sub(r"[^a-zA-Z0-9_:]", "_", raw) + suffix


def _escape_label(v: str) -> str:
    return str(v).replace("\\", r"\\").replace("\"", r"\"") \
        .replace("\n", r"\n")


def _labels(pairs: Dict[str, str]) -> str:
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"'
                     for k, v in sorted(pairs.items()))
    return "{" + inner + "}"


def _fmt(v: Any) -> str:
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class _Writer:
    """Accumulates one exposition: families declared once (# HELP/
    # TYPE), samples appended under them in declaration order."""

    def __init__(self):
        self._order: List[str] = []
        self._fams: Dict[str, Dict[str, Any]] = {}

    def family(self, fam: str, typ: str, help_: str) -> None:
        if fam not in self._fams:
            self._order.append(fam)
            self._fams[fam] = {"type": typ, "help": help_,
                               "samples": []}

    def sample(self, fam: str, name: str, labels: Dict[str, str],
               value: Any) -> None:
        self._fams[fam]["samples"].append(
            f"{name}{_labels(labels)} {_fmt(value)}")

    def render(self) -> str:
        lines: List[str] = []
        for fam in self._order:
            info = self._fams[fam]
            lines.append(f"# HELP {fam} {info['help']}")
            lines.append(f"# TYPE {fam} {info['type']}")
            lines.extend(info["samples"])
        return "\n".join(lines) + "\n"


def _emit_numeric(w: _Writer, snapshot: Dict[str, Any],
                  labels: Dict[str, str], skipped: List[str]) -> None:
    """Counters + gauges + histogram summaries of one registry
    snapshot (``MetricsRegistry.snapshot()`` shape) under ``labels``."""
    for name, value in sorted((snapshot.get("counters") or {}).items()):
        cat = CATALOG.get(name)
        if cat is None or cat[0] != "counter":
            skipped.append(name)
            continue
        fam = metric_name(name, "_total")
        w.family(fam, "counter", cat[1])
        w.sample(fam, fam, labels, value)
    for name, value in sorted((snapshot.get("gauges") or {}).items()):
        cat = CATALOG.get(name)
        if cat is None or cat[0] != "gauge":
            skipped.append(name)
            continue
        fam = metric_name(name)
        w.family(fam, "gauge", cat[1])
        w.sample(fam, fam, labels, value)
    for name, h in sorted((snapshot.get("histograms") or {}).items()):
        cat = CATALOG.get(name)
        if cat is None or cat[0] != "histogram":
            skipped.append(name)
            continue
        fam = metric_name(name)
        w.family(fam, "summary", cat[1])
        for q in _QUANTILES:
            qv = h.get(f"p{int(q * 100)}")
            if qv is not None:
                w.sample(fam, fam, {**labels, "quantile": str(q)}, qv)
        w.sample(fam, fam + "_sum", labels, h.get("total") or 0.0)
        w.sample(fam, fam + "_count", labels, h.get("count") or 0)


def _emit_attribution(w: _Writer, attribution: Dict[str, Any],
                      labels: Dict[str, str],
                      skipped: List[str]) -> None:
    """The per-(client, set) ledger as labelled counter families."""
    for client, scopes in sorted((attribution or {}).items()):
        if not isinstance(scopes, dict):
            continue
        for scope, metrics in sorted(scopes.items()):
            for name, value in sorted((metrics or {}).items()):
                cat = CATALOG.get(f"attrib.{name}")
                if cat is None:
                    skipped.append(f"attrib.{name}")
                    continue
                fam = metric_name(f"attrib.{name}", "_total")
                w.family(fam, "counter", cat[1])
                w.sample(fam, fam,
                         {**labels, "client": client, "set": scope},
                         value)


def to_openmetrics(snapshot: Dict[str, Any],
                   followers: Optional[Dict[str, Dict[str, Any]]] = None
                   ) -> str:
    """One Prometheus text exposition from a local registry snapshot
    (``MetricsRegistry.snapshot()`` — the COLLECT_STATS "metrics"
    shape) plus optional follower snapshots (addr → same shape),
    merged under a ``follower`` label. Only catalogued names are
    emitted; skipped instruments tick ``obs.export.uncatalogued``."""
    w = _Writer()
    skipped: List[str] = []
    _emit_numeric(w, snapshot, {}, skipped)
    _emit_attribution(w, snapshot.get("attribution") or {}, {}, skipped)
    for addr, fsnap in sorted((followers or {}).items()):
        if not isinstance(fsnap, dict) or "error" in fsnap:
            continue
        labels = {"follower": str(addr)}
        _emit_numeric(w, fsnap, labels, skipped)
        _emit_attribution(w, fsnap.get("attribution") or {}, labels,
                          skipped)
    if skipped:
        _metrics.REGISTRY.counter("obs.export.uncatalogued").inc(
            len(skipped))
    return w.render()


# ---------------------------------------------------------------------
# the in-repo Prometheus text-format parser (the acceptance oracle)
# ---------------------------------------------------------------------

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(\{.*\})?\s+"
    r"([+-]?(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][+-]?[0-9]+)?"
    r"|[+-]?Inf|NaN)"
    r"(?:\s+(-?[0-9]+))?$")
_TYPES = {"counter", "gauge", "summary", "histogram", "untyped"}
#: sample-name suffixes each family type may emit beyond the bare name
_SUFFIXES = dict(summary=("_sum", "_count"),
                 histogram=("_sum", "_count", "_bucket"),
                 counter=(), gauge=(), untyped=())


def parse_openmetrics(text: str) -> Dict[str, Dict[str, Any]]:
    """Strict-enough Prometheus text-format parse: validates family
    declarations, metric/label naming, sample grammar and the
    type/suffix contract; raises ``ValueError`` (with line number) on
    any violation. Returns {family: {"type", "help", "samples":
    [(name, labels, value)]}} — what the acceptance tests assert
    over."""
    fams: Dict[str, Dict[str, Any]] = {}

    def fam_of(sample_name: str) -> Optional[str]:
        if sample_name in fams:
            return sample_name
        for fam, info in fams.items():
            if sample_name.startswith(fam) and \
                    sample_name[len(fam):] in _SUFFIXES[info["type"]]:
                return fam
        return None

    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            parts = line[len("# HELP "):].split(" ", 1)
            if not parts or not _NAME_RE.match(parts[0]):
                raise ValueError(f"line {i}: bad HELP name: {line!r}")
            fams.setdefault(parts[0], {"type": "untyped", "help": "",
                                       "samples": []})
            fams[parts[0]]["help"] = parts[1] if len(parts) > 1 else ""
            continue
        if line.startswith("# TYPE "):
            parts = line[len("# TYPE "):].split()
            if len(parts) != 2 or not _NAME_RE.match(parts[0]):
                raise ValueError(f"line {i}: bad TYPE line: {line!r}")
            if parts[1] not in _TYPES:
                raise ValueError(f"line {i}: unknown type {parts[1]!r}")
            fams.setdefault(parts[0], {"type": parts[1], "help": "",
                                       "samples": []})
            fams[parts[0]]["type"] = parts[1]
            continue
        if line.startswith("#"):
            continue  # free comment
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {i}: bad sample line: {line!r}")
        name, labelstr, value = m.group(1), m.group(2), m.group(3)
        labels: Dict[str, str] = {}
        if labelstr:
            body = labelstr[1:-1].rstrip(",")
            if body:
                consumed = 0
                for lm in _LABEL_RE.finditer(body):
                    labels[lm.group(1)] = lm.group(2)
                    consumed = lm.end()
                rest = body[consumed:].strip(", ")
                if rest:
                    raise ValueError(
                        f"line {i}: bad label syntax near {rest!r}")
        fam = fam_of(name)
        if fam is None:
            raise ValueError(
                f"line {i}: sample {name!r} has no declared family "
                f"(or an illegal suffix for its family type)")
        info = fams[fam]
        if info["type"] == "counter" and name == fam \
                and not fam.endswith("_total"):
            raise ValueError(
                f"line {i}: counter family {fam!r} must end in _total")
        fams[fam]["samples"].append((name, labels, float(value)))
    return fams
