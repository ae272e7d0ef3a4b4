"""The port's observability parts (``netsdb_tpu_torch/obs/``) against the
reference's (``netsdb_tpu/obs/``): the same records, ledgers, trees and
renderings from the same inputs — ``OpRecord``, ``OperatorRecorder``
(``node``, ``op``, ``mark_fused``, ``tree``, ``finish``),
``OperatorLedger`` (``add``, ``snapshot``, ``job_rows``, ``reset``, the
overflow bucket), ``rows_of``/``bytes_of`` over equivalent values,
``recording``/``explain_capture``/``current_recorder``/``op_add`` and
``render_tree`` — plus the registry's counters and collectors and the
trace's spans. All of it is host Python: results must be equal (times,
which differ, are set by hand)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from netsdb_tpu import obs as jobs
from netsdb_tpu.core.blocked import BlockedTensor as JBlocked
from netsdb_tpu.relational.table import ColumnTable as JTable
from netsdb_tpu_torch import obs
from netsdb_tpu_torch.core.blocked import BlockedTensor
from netsdb_tpu_torch.obs.metrics import MetricsRegistry
from netsdb_tpu_torch.plan.computations import Apply, ScanSet, WriteSet
from netsdb_tpu_torch.relational.table import ColumnTable

OPS = {"ref": jobs.operators, "port": obs.operators}


class _Node:
    def __init__(self, kind, label="", db=None, set_name=None):
        self.op_kind = kind
        self.label = label
        self.db = db
        self.set_name = set_name

    def plan_atom(self):
        return f"{self.op_kind}({self.label})"


COUNTER_SETS = [
    {},
    {"chunks": 3, "traces": 1},
    {"device_est_s": 0.5, "stage.wait_s": 0.25, "devcache.hits": 2},
    {"blocks": 4, "stage.bytes": 4096, "bytes_in": 128, "pairs": 2}]


@pytest.mark.parametrize("counters", COUNTER_SETS)
def test_op_record_as_dict_matches_the_reference(counters):
    out = {}
    for key, ops in OPS.items():
        rec = ops.OpRecord(3, "Apply", "f", "atom", [1, 2])
        rec.wall_s = 0.125
        rec.rows_in, rec.rows_out = 10, 4
        rec.fused, rec.region = True, 2
        for k, v in counters.items():
            rec.add(k, v)
        out[key] = rec.as_dict()
    assert out["port"] == out["ref"]


def _values(ref):
    if ref:
        return [JTable({"a": np.arange(5, dtype=np.int32)}, {}),
                JBlocked.from_dense(jnp.ones((5, 3), jnp.float32), (2, 2)),
                jnp.ones((7, 2), jnp.float32), [1, 2, 3], {"x": 1}, (1, 2),
                object()]
    return [ColumnTable({"a": torch.arange(5, dtype=torch.int32)}),
            BlockedTensor.from_dense(torch.ones(5, 3), (2, 2),
                                     device="cpu"),
            torch.ones(7, 2), [1, 2, 3], {"x": 1}, (1, 2), object()]


@pytest.mark.parametrize("i", range(7))
def test_rows_and_bytes_of_match_the_reference(i):
    j, p = _values(True)[i], _values(False)[i]
    assert obs.operators.rows_of(p) == jobs.operators.rows_of(j)
    assert obs.operators.bytes_of(p) == jobs.operators.bytes_of(j)


def _record(ops):
    """One execution: two scans, a timed node, a fused pair."""
    rec = ops.OperatorRecorder("job-x")
    base = rec.reserve(5)
    for i, node in enumerate([_Node("Scan", db="d", set_name="a"),
                              _Node("Scan", db="d", set_name="b")]):
        rec.node(base + i, node, [])
    with rec.op(base + 2, _Node("Join", "mm"), [0, 1],
                [np.ones((3, 2)), [1, 2]]) as opr:
        ops.op_add("chunks", 2)  # the current op: this node
        opr.add("traces", 1)
        opr.rows_out = 3
    for j, kind in ((3, "Apply"), (4, "Write")):
        r = rec.node(base + j, _Node(kind, f"n{j}"), [base + j - 1])
        r.fused, r.region = True, 0
    for r in rec._nodes.values():
        r.wall_s = 0.001 * (r.op_id + 1)
    return rec


def test_recorder_tree_matches_the_reference():
    trees = {k: _record(ops).tree() for k, ops in OPS.items()}
    assert trees["port"] == trees["ref"]
    assert trees["port"]["nodes"][2]["rows_in"] == 5  # 3 rows + a 2-list


def test_mark_fused_tree_matches_the_reference():
    trees = {}
    for key, ops in OPS.items():
        rec = ops.OperatorRecorder("job-f")
        topo = [_Node("Scan", db="d", set_name="x"), _Node("Apply", "f"),
                _Node("Write", db="d", set_name="y")]
        for n in topo:
            n.inputs = []
        topo[1].inputs, topo[2].inputs = [topo[0]], [topo[1]]
        for i, n in enumerate(topo):
            n.node_id = 100 + i
        rec.mark_fused(topo, 0.5, 0.25)
        tree = rec.tree()
        for n in tree["nodes"]:
            n.pop("atom")  # the synthetic root's text names its program
        trees[key] = tree
    assert trees["port"] == trees["ref"]
    assert trees["port"]["mode"] == "whole_plan_jit"


def test_ledger_matches_the_reference():
    out = {}
    for key, ops in OPS.items():
        led = ops.OperatorLedger(max_keys=3)
        for job, label, node in (
                ("j1", "Apply:a", {"wall_s": 1.0, "device_est_s": 0.5,
                                   "counters": {"chunks": 2, "traces": 1}}),
                ("j1", "Apply:a", {"wall_s": 2.0, "counters": {
                    "stage.bytes": 10, "bytes_in": 4}}),
                ("j1", "Join:b", {"wall_s": 0.5}),
                ("j2", "Apply:c", {"wall_s": 0.25}),
                ("j2", "Apply:d", {"wall_s": 0.125})):  # overflows
            led.add(job, label, node)
        out[key] = (led.snapshot(), led.job_rows("j1"), led.job_rows("x"))
        led.reset()
        out[key] += (led.snapshot(),)
    assert out["port"] == out["ref"]
    assert "overflow" in out["port"][0]


def test_finish_feeds_the_ledger_and_the_capture():
    before = obs.operators.LEDGER.job_rows("job-x")
    with obs.operators.explain_capture() as holder:
        tree = _record(obs.operators).finish()
    assert holder["operators"] == tree
    after = obs.operators.LEDGER.job_rows("job-x")
    assert after["Join:mm"]["count"] == \
        before.get("Join:mm", {}).get("count", 0) + 1
    assert obs.REGISTRY.snapshot()["operators"]["job-x"]["Join:mm"] == \
        after["Join:mm"]


def test_recording_installs_one_recorder_and_nests():
    assert obs.operators.current_recorder() is None
    with obs.operators.recording("j") as none:
        assert none is None  # nobody asked: no trace, no capture
    with obs.operators.explain_capture() as holder:
        with obs.operators.recording("j") as rec:
            assert obs.operators.current_recorder() is rec
            with obs.operators.recording("j") as inner:
                assert inner is None  # an auto-split joins the outer tree
            with rec.op(0, _Node("Apply", "f"), []):
                obs.operators.op_add("chunks", 5)
                assert obs.operators.current_op().label == "f"
        assert obs.operators.current_recorder() is None
    assert holder["operators"]["nodes"][0]["counters"] == {"chunks": 5}
    obs.operators.op_add("chunks")  # no current op: nothing happens


@pytest.mark.parametrize("traced,explain", [(True, True), (True, False),
                                            (False, True), (False, False)])
def test_should_record_matches_the_reference(traced, explain):
    class Cfg:
        obs_explain = explain

    got = {}
    for key, (ops, mod) in {"ref": (jobs.operators, jobs),
                            "port": (obs.operators, obs)}.items():
        if traced:
            with mod.trace() as tr:
                assert tr is not None
                got[key] = ops.should_record(Cfg())
        else:
            got[key] = ops.should_record(Cfg())
    assert got["port"] == got["ref"] == (traced and explain)


TREES = [
    {"job": "a", "mode": "eager", "total_wall_s": 0.01, "nodes": [
        {"id": 0, "kind": "Scan", "label": "d:x", "inputs": [],
         "wall_s": 0.0, "rows_out": 5},
        {"id": 1, "kind": "Apply", "label": "f", "inputs": [0],
         "wall_s": 0.01, "device_est_s": 0.002, "rows_in": 5,
         "rows_out": 5, "counters": {"chunks": 3, "traces": 1,
                                     "other": 9}}]},
    {"job": "b", "mode": "streamed", "total_wall_s": 0.02, "nodes": [
        {"id": 0, "kind": "Scan", "label": "d:x", "inputs": [],
         "wall_s": 0.0},
        {"id": 1, "kind": "Apply", "label": "sp0", "inputs": [0],
         "wall_s": 0.0, "fused": True, "region": 0},
        {"id": 2, "kind": "Apply", "label": "sp1", "inputs": [1],
         "wall_s": 0.02, "region": 0, "counters": {"region_nodes": 2}},
        {"id": 3, "kind": "Join", "label": "j", "inputs": [2, 2],
         "wall_s": 0.0, "region": 1, "fused": True}]},
    {"job": "c", "mode": "whole_plan_jit", "total_wall_s": 0.0,
     "nodes": []}]


@pytest.mark.parametrize("i", range(len(TREES)))
def test_render_tree_matches_the_reference(i):
    assert obs.operators.render_tree(TREES[i]) == \
        jobs.operators.render_tree(TREES[i])
    assert obs.operators.render_tree(TREES[i], total_s=0.05) == \
        jobs.operators.render_tree(TREES[i], total_s=0.05)


def test_registry_counters_and_collectors():
    reg = MetricsRegistry()
    reg.counter("a").inc()
    reg.counter("a").inc(2)
    reg.register_collector("ok", lambda: {"x": 1})
    reg.register_collector("bad", lambda: 1 / 0)
    snap = reg.snapshot()
    assert snap["counters"] == {"a": 3}
    assert snap["ok"] == {"x": 1}
    assert snap["bad"]["error"].startswith("ZeroDivisionError")
    assert reg.counter("a") is reg.counter("a")


def test_trace_spans_counters_and_sections():
    assert obs.current_trace() is None
    with obs.span("nothing"):  # no trace: a no-op
        obs.add("x")
    with obs.trace(qid="q1") as tr:
        with obs.trace() as inner:
            assert inner is None
        with obs.span("outer", "executor") as sp:
            sp.counters["chunks"] = 2
            with obs.span("inner"):
                obs.add("executor.traces")
                obs.add("executor.traces", 2)
        tr.annotate("note", "v")
        tr.attach_section("operators", {"job": "x"})
    prof = tr.profile_dict
    assert prof["qid"] == "q1" and prof["total_s"] > 0
    assert prof["counters"] == {"executor.traces": 3}
    assert [(s["name"], s["depth"]) for s in prof["spans"]] == \
        [("outer", 0), ("inner", 1)]
    assert prof["spans"][0]["counters"] == {"chunks": 2}
    assert prof["meta"] == {"note": "v"} and prof["operators"] == {"job": "x"}


def test_a_traced_query_carries_its_operator_tree(tmp_path):
    from netsdb_tpu_torch import Client
    from netsdb_tpu_torch.config import Configuration

    c = Client(Configuration(root_dir=str(tmp_path)), device="cpu")
    c.create_database("d")
    c.create_set("d", "m")
    c.send_matrix("d", "m", np.ones((4, 4), np.float32), (2, 2))
    sink = WriteSet(Apply(ScanSet("d", "m"), lambda t: t, label="id"),
                    "d", "out")
    with obs.trace() as tr:
        c.execute_computations(sink, job_name="traced")
    prof = tr.profile_dict
    assert prof["operators"]["job"] == "traced"
    names = {s["name"] for s in prof["spans"]}
    assert {"planner.plan", "executor.whole_plan_jit",
            "executor.materialize"} <= names
