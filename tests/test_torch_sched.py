"""The port's query scheduler (``serve/sched/``) against the reference's:
the cases of the reference's ``tests/test_sched.py`` that need no daemon
pool. Each scripted sequence runs through both packages' ``LaneScheduler``,
``CoalesceTable`` and ``AffinityGate``, and the grant orders, typed
rejections and counters must be the same; then the daemon cases: N
identical cold EXECUTEs run once, a lane quota rejection crosses the wire
typed, the client honours ``retry_after_s``, lane hints and client
identities key the lanes. Every daemon listens on port 0 and is shut
down in ``finally``; every wait is bounded."""

import threading
import time
import types

import numpy as np
import pytest

from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.serve.client import (LaneSaturatedError,
                                           RemoteClient, RetryPolicy)
from netsdb_tpu_torch.serve.protocol import MsgType
from netsdb_tpu_torch.serve.server import ServeController

TIMEOUT = 60.0


def _pkg(name):
    """One package's scheduler classes, errors and registry."""
    if name == "ref":
        from netsdb_tpu import obs
        from netsdb_tpu.serve import errors
        from netsdb_tpu.serve.sched import feedback
        from netsdb_tpu.serve.sched.coalesce import CoalesceTable
        from netsdb_tpu.serve.sched.policy import AffinityGate
        from netsdb_tpu.serve.sched.queue import LaneScheduler
    else:
        from netsdb_tpu_torch import obs
        from netsdb_tpu_torch.serve import errors
        from netsdb_tpu_torch.serve.sched import feedback
        from netsdb_tpu_torch.serve.sched.coalesce import CoalesceTable
        from netsdb_tpu_torch.serve.sched.policy import AffinityGate
        from netsdb_tpu_torch.serve.sched.queue import LaneScheduler
    return types.SimpleNamespace(
        LaneScheduler=LaneScheduler, CoalesceTable=CoalesceTable,
        AffinityGate=AffinityGate, errors=errors, feedback=feedback,
        counter=lambda n: obs.REGISTRY.counter(n).value)


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    return _pkg(request.param)


def _wait_for(pred, timeout_s=15.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


def _grant_order(sched, jobs, timeout_s=10.0):
    """Park ``jobs`` (lane names) behind one occupant, in order, then
    release it and record the grant order (slots=1: one at a time)."""
    occupant = sched.acquire("occupant", timeout_s)
    order = []
    order_mu = threading.Lock()

    def worker(lane):
        t = sched.acquire(lane, timeout_s)
        with order_mu:
            order.append(lane)
        sched.release(t)

    threads = []
    for lane in jobs:
        th = threading.Thread(target=worker, args=(lane,))
        th.start()
        threads.append(th)
        assert _wait_for(
            lambda n=len(threads): sched.snapshot()["queued"] == n)
    sched.release(occupant)
    for th in threads:
        th.join(timeout=timeout_s)
    return order


def _both(script):
    """``script(pkg)`` under the reference and the port; equal results."""
    ref, port = script(_pkg("ref")), script(_pkg("port"))
    assert port == ref
    return port


def test_weighted_deficit_shares_grants_by_weight():
    def script(p):
        sched = p.LaneScheduler(slots=1, lanes={"hi": 3.0, "lo": 1.0},
                                aging_every=0)
        return _grant_order(sched, ["lo", "lo"] + ["hi"] * 6)

    assert _both(script) == ["hi", "lo", "hi", "hi", "hi", "lo", "hi",
                             "hi"]


def test_aging_bounds_starvation_deterministically():
    def script(p):
        sched = p.LaneScheduler(slots=1, lanes={"hi": 1000.0, "lo": 1.0},
                                aging_every=3)
        for _ in range(5):  # burn lo's deficit share
            sched.release(sched.acquire("lo", 5.0))
        aged0 = p.counter("sched.aged_grants")
        order = _grant_order(sched, ["lo"] + ["hi"] * 9)
        return order, p.counter("sched.aged_grants") - aged0

    order, aged = _both(script)
    assert order.index("lo") < 3 and aged > 0


def test_lane_quota_rejects_typed_with_depth(pkg):
    sched = pkg.LaneScheduler(slots=1, quota=2)
    occupant = sched.acquire("t", 5.0)
    threads = [threading.Thread(
        target=lambda: sched.release(sched.acquire("t", 10.0)))
        for _ in range(2)]
    for th in threads:
        th.start()
    assert _wait_for(lambda: sched.snapshot()["queued"] == 2)
    rejects0 = pkg.counter("sched.quota_rejects")
    with pytest.raises(pkg.errors.LaneSaturated) as ei:
        sched.acquire("t", 1.0)
    assert ei.value.retryable
    assert (ei.value.lane, ei.value.queue_depth) == ("t", 2)
    assert pkg.counter("sched.quota_rejects") == rejects0 + 1
    sched.release(occupant)
    sched.release(sched.acquire("other", 5.0))
    for th in threads:
        th.join(timeout=10)


def test_admission_timeout_carries_lane_wait_hint(pkg):
    sched = pkg.LaneScheduler(slots=1)
    sched.release(sched.acquire("a", 5.0))  # seeds the wait histogram
    occupant = sched.acquire("a", 5.0)
    with pytest.raises(pkg.errors.AdmissionFull) as ei:
        sched.acquire("a", 0.05)
    assert ei.value.retryable and ei.value.lane == "a"
    assert ei.value.retry_after_s is not None
    assert ei.value.retry_after_s >= 0.0
    sched.release(occupant)


def test_new_lane_joins_at_current_virtual_time():
    def script(p):
        sched = p.LaneScheduler(slots=1)
        for _ in range(6):
            sched.release(sched.acquire("a", 5.0))
        sched.release(sched.acquire("b", 5.0))
        lanes = sched.snapshot()["lanes"]
        return lanes["a"]["served"], lanes["b"]["served"]

    assert _both(script) == (6, pytest.approx(7.0))


def test_feedback_reseed_applies_to_scheduler(pkg):
    sched = pkg.LaneScheduler(slots=1, lanes={"vip": 9.0}, quota=4)
    sched.reseed({"light": 4.0, "vip": 0.1}, {"light": 16, "vip": 1})
    assert sched._quota_for_locked("light") == 16
    assert sched._quota_for_locked("other") == 4
    assert sched._weights["vip"] == 9.0
    assert "vip" not in sched._lane_quotas
    t = sched.acquire("light", timeout_s=1.0)
    assert sched.snapshot()["lanes"]["light"]["weight"] == 4.0
    sched.release(t)


def test_feedback_formula_equals_the_reference():
    ops = {"job": {"apply": {"wall_s": 2.0, "chunks": 1000.0}}}
    attrib = {
        "light": {"d:a": {"requests": 100.0, "executor.chunks": 100.0}},
        "mid": {"d:a": {"requests": 100.0, "executor.chunks": 1000.0}},
        "heavy": {"d:a": {"requests": 100.0,
                          "executor.chunks": 100000.0}},
        "sparse": {"d:a": {"requests": 2.0, "executor.chunks": 1e9}},
    }

    def script(p):
        fb = p.feedback
        return (fb.sec_per_chunk(ops), fb.sec_per_chunk({}),
                fb.seed_lanes(attrib, ops, base_quota=8),
                fb.seed_lanes(attrib, ops, base_quota=8,
                              reserved={"heavy"}))

    spc, default, (weights, quotas), (w2, q2) = _both(script)
    assert spc == pytest.approx(0.002)
    assert weights == {"light": 4.0, "mid": 1.0, "heavy": 0.25}
    assert quotas == {"light": 32, "mid": 8, "heavy": 2}
    assert "heavy" not in w2 and "heavy" not in q2


# --- coalescing -------------------------------------------------------

def test_coalesce_table_single_flight_fans_out(pkg):
    ct = pkg.CoalesceTable()
    gate = threading.Event()
    calls = []

    def leader_fn():
        calls.append("leader")
        gate.wait(10)
        return {"answer": 41}

    def never_runs():
        calls.append("waiter-ran")
        return {"answer": -1}

    hits0 = pkg.counter("sched.coalesce_hits")
    results = [None] * 4

    def run(i, fn):
        results[i] = ct.run("k", fn, 10.0)

    threads = [threading.Thread(target=run, args=(0, leader_fn))]
    threads[0].start()
    assert _wait_for(lambda: "k" in ct._inflight)
    for i in (1, 2, 3):
        threads.append(threading.Thread(target=run, args=(i, never_runs)))
        threads[-1].start()
    assert _wait_for(lambda: ct.waiters("k") == 3)
    gate.set()
    for th in threads:
        th.join(timeout=10)
    assert calls == ["leader"]
    assert all(r == {"answer": 41} for r in results)
    assert pkg.counter("sched.coalesce_hits") == hits0 + 3


def test_coalesce_leader_failure_aborts_waiters_typed(pkg):
    ct = pkg.CoalesceTable()
    gate = threading.Event()

    def failing_leader():
        gate.wait(10)
        raise RuntimeError("leader died mid-run")

    errs = {}

    def leader():
        try:
            ct.run("k", failing_leader, 10.0)
        except RuntimeError as e:
            errs["leader"] = e

    def waiter():
        try:
            ct.run("k", failing_leader, 10.0)
        except pkg.errors.CoalesceAborted as e:
            errs["waiter"] = e

    t1 = threading.Thread(target=leader)
    t1.start()
    assert _wait_for(lambda: "k" in ct._inflight)
    t2 = threading.Thread(target=waiter)
    t2.start()
    assert _wait_for(lambda: ct.waiters("k") == 1)
    gate.set()
    t1.join(timeout=10)
    t2.join(timeout=10)
    assert "leader" in errs and errs["waiter"].retryable
    assert "leader died mid-run" in str(errs["waiter"])
    assert "k" not in ct._inflight


def test_coalesce_over_age_flight_is_not_rejoined(pkg):
    ct = pkg.CoalesceTable()
    gate = threading.Event()
    out = {}
    t = threading.Thread(target=lambda: out.setdefault(
        "leader", ct.run("k", lambda: gate.wait(10) and "leader", 0.05)))
    t.start()
    assert _wait_for(lambda: "k" in ct._inflight)
    time.sleep(0.1)
    hits0 = pkg.counter("sched.coalesce_hits")
    assert ct.run("k", lambda: "solo", 0.05) == "solo"
    assert pkg.counter("sched.coalesce_hits") == hits0
    gate.set()
    t.join(timeout=10)
    assert out["leader"] == "leader"


def test_coalesce_late_hits_ttl_and_size_bound():
    def script(p):
        out = []
        ct = p.CoalesceTable(done_ttl_s=5.0, done_max=8)
        calls = []

        def fn():
            calls.append(1)
            return {"answer": 41}

        late0 = p.counter("sched.coalesce_late_hits")
        out += [ct.run("k", fn, 10.0), ct.done_entries(),
                ct.run("k", fn, 10.0), len(calls),
                p.counter("sched.coalesce_late_hits") - late0]
        ct = p.CoalesceTable(done_ttl_s=0.05, done_max=8)
        n = []
        out.append(ct.run("k", lambda: n.append(1) or len(n), 10.0))
        time.sleep(0.08)
        out.append(ct.run("k", lambda: n.append(1) or len(n), 10.0))
        ct = p.CoalesceTable(done_ttl_s=30.0, done_max=3)
        for i in range(6):
            ct.run(f"k{i}", lambda i=i: i, 10.0)
        out += [ct.done_entries(), ct.run("k5", lambda: -1, 10.0),
                ct.run("k0", lambda: -1, 10.0)]
        ct = p.CoalesceTable()
        out += [ct.run("k", lambda: 1, 10.0), ct.done_entries()]
        return out

    assert _both(script) == [{"answer": 41}, 1, {"answer": 41}, 1, 1,
                             1, 2, 3, 5, -1, 1, 0]


# --- policy inputs and the affinity gate ------------------------------

def test_frame_fingerprint_is_canonical():
    from netsdb_tpu_torch.serve.sched import frame_fingerprint

    p1 = {"plan": "x <= SCAN('d', 's')", "job_name": "j",
          "materialize": True}
    p3 = dict(p1, job_name="OTHER")
    f1 = frame_fingerprint(MsgType.EXECUTE_PLAN, p1)
    assert f1 is not None
    assert f1 == frame_fingerprint(MsgType.EXECUTE_PLAN, dict(p1))
    assert f1 != frame_fingerprint(MsgType.EXECUTE_PLAN, p3)
    assert f1 != frame_fingerprint(MsgType.EXECUTE_COMPUTATIONS, p1)
    # DAGs with closures fingerprint through the port's own pickler
    from netsdb_tpu_torch.plan.computations import Apply, ScanSet, WriteSet

    k = 3
    sink = WriteSet(Apply(ScanSet("d", "in"), lambda x: x * k), "d", "o")
    assert frame_fingerprint(MsgType.EXECUTE_COMPUTATIONS,
                             {"sinks": [sink]}) is not None


def test_sets_touched_from_dag_and_plan_text():
    from netsdb_tpu.plan import computations as rc
    from netsdb_tpu.serve.protocol import MsgType as RefMsgType
    from netsdb_tpu.serve.sched import sets_touched as ref_sets_touched
    from netsdb_tpu_torch.plan import computations as pc
    from netsdb_tpu_torch.serve.sched import sets_touched

    sink = pc.WriteSet(pc.Apply(pc.ScanSet("d", "in"), lambda x: x,
                                traceable=False), "d", "out")
    ref_sink = rc.WriteSet(rc.Apply(rc.ScanSet("d", "in"), lambda x: x,
                                    traceable=False), "d", "out")
    got = sets_touched(MsgType.EXECUTE_COMPUTATIONS, {"sinks": [sink]})
    assert got == ref_sets_touched(RefMsgType.EXECUTE_COMPUTATIONS,
                                   {"sinks": [ref_sink]}) \
        == frozenset({"d:in"})
    plan = "a <= SCAN('db1', 'left')\nb <= SCAN('db1', 'right')\n"
    assert sets_touched(MsgType.EXECUTE_PLAN, {"plan": plan}) \
        == ref_sets_touched(RefMsgType.EXECUTE_PLAN, {"plan": plan}) \
        == frozenset({"db1:left", "db1:right"})
    assert sets_touched(MsgType.EXECUTE_PLAN, {"plan": 42}) == frozenset()


def test_affinity_gate_single_installer_siblings_wait(pkg):
    warm = set()
    gate = pkg.AffinityGate(lambda s: s in warm, wait_s=10.0)
    installs0 = pkg.counter("sched.affinity_installs")
    hits0 = pkg.counter("sched.affinity_hits")
    inside, finish = threading.Event(), threading.Event()
    order = []

    def installer():
        with gate.admit(["d:x"]):
            order.append("installer-in")
            inside.set()
            finish.wait(10)
            warm.add("d:x")
        order.append("installer-out")

    def sibling():
        with gate.admit(["d:x"]):
            order.append("sibling-in")

    t1 = threading.Thread(target=installer)
    t1.start()
    assert inside.wait(10)
    t2 = threading.Thread(target=sibling)
    t2.start()
    time.sleep(0.1)
    assert order == ["installer-in"]
    finish.set()
    t1.join(timeout=10)
    t2.join(timeout=10)
    assert order.index("sibling-in") > order.index("installer-in")
    assert pkg.counter("sched.affinity_installs") == installs0 + 1
    assert pkg.counter("sched.affinity_hits") == hits0 + 1
    with gate.admit(["d:x"]):
        pass
    assert pkg.counter("sched.affinity_installs") == installs0 + 1


def test_affinity_gate_overlapping_cold_sets_share_one_installer(pkg):
    warm = set()
    gate = pkg.AffinityGate(lambda s: s in warm, wait_s=10.0)
    inside, finish = threading.Event(), threading.Event()
    order = []

    def installer():
        with gate.admit(["d:a", "d:b"]):
            inside.set()
            finish.wait(10)
            warm.update(("d:a", "d:b"))
        order.append("installer-out")

    def overlapping():
        with gate.admit(["d:a"]):
            order.append("overlap-in")

    hits0 = pkg.counter("sched.affinity_hits")
    t1 = threading.Thread(target=installer)
    t1.start()
    assert inside.wait(10)
    t2 = threading.Thread(target=overlapping)
    t2.start()
    time.sleep(0.1)
    assert order == []
    finish.set()
    t1.join(timeout=10)
    t2.join(timeout=10)
    assert set(order) == {"installer-out", "overlap-in"}
    assert pkg.counter("sched.affinity_hits") == hits0 + 1


def test_feedback_and_shedding_raise_naming_a8():
    """Feedback and SLO shedding were ported with the observability part
    of A8 and are accepted; pin auto-sizing and the rebalance cadence
    belong to the daemon pool and raise naming A7 part 2."""
    from netsdb_tpu_torch.serve.sched import QueryScheduler

    s = QueryScheduler(slots=1, feedback=True, slo_source=lambda: ())
    assert s.feedback_enabled and s.shed_enabled
    for kw in (dict(pin_auto=lambda: None), dict(rebalance_cb=lambda: None)):
        with pytest.raises(NotImplementedError, match="A7 part 2"):
            QueryScheduler(slots=1, **kw)


def _populate_ledgers(o):
    """The reference test's ledgers: a light and a 500x heavier client."""
    o.attrib.LEDGER.reset()
    for _ in range(20):
        o.attrib.account("requests", 1, scope="d:a", client="lightc")
        o.attrib.account("executor.chunks", 1, scope="d:a", client="lightc")
        o.attrib.account("requests", 1, scope="d:a", client="heavyc")
        o.attrib.account("executor.chunks", 500, scope="d:a",
                         client="heavyc")
    o.operators.LEDGER.add("j", "apply:x",
                           {"wall_s": 1.0, "counters": {"chunks": 1000}})


def test_feedback_loop_end_to_end():
    """``sched_feedback`` wires the ledgers into the live lane weights:
    the same ledgers give the same weights and quotas on both packages,
    the reseed is counted, and the light client out-weighs the heavy."""
    from netsdb_tpu import obs as ref_obs
    from netsdb_tpu.serve.sched import QueryScheduler as RefScheduler
    from netsdb_tpu_torch import obs
    from netsdb_tpu_torch.serve.sched import QueryScheduler

    out = {}
    for side, o, cls in (("ref", ref_obs, RefScheduler),
                         ("port", obs, QueryScheduler)):
        _populate_ledgers(o)
        sched = cls(slots=2, quota=10, feedback=True, feedback_every=4)
        before = o.REGISTRY.counter("sched.feedback_reseeds").value
        weights, quotas = sched.refresh_feedback()
        assert o.REGISTRY.counter("sched.feedback_reseeds").value == \
            before + 1
        out[side] = (weights, quotas)
        o.attrib.LEDGER.reset()
    assert out["port"] == out["ref"]
    weights, quotas = out["port"]
    assert weights["lightc"] > weights["heavyc"]
    assert quotas["lightc"] > quotas["heavyc"]


def test_slo_shedding_halves_the_heaviest_lane_until_recovery():
    """A breached objective halves the heaviest lane's quota once (the
    same lane on both packages); recovery lifts it."""
    from netsdb_tpu.serve.sched import QueryScheduler as RefScheduler
    from netsdb_tpu_torch.serve.sched import QueryScheduler

    out = {}
    for side, cls in (("ref", RefScheduler), ("port", QueryScheduler)):
        breached = ["availability"]
        sched = cls(slots=1, quota=8, slo_source=lambda: breached)
        for lane, n in (("a", 1), ("b", 3)):
            for _ in range(n):
                sched.release(sched.acquire(lane, timeout_s=5.0))
        shed = sched.refresh_shed()
        again = sched.refresh_shed()  # one shed at a time
        quota = sched.lanes._quota_for_locked(shed)
        breached.clear()
        sched.refresh_shed()
        out[side] = (shed, again, quota, sched.lanes.shed_lanes(),
                     sched.lanes._quota_for_locked(shed))
    assert out["port"] == out["ref"]
    shed, again, quota, after, restored = out["port"]
    assert shed is not None and again is None
    assert quota < restored and after == []


# --- through a daemon ---------------------------------------------------

def _lineitem_table(rows, seed=0):
    import torch

    from netsdb_tpu_torch.relational.table import ColumnTable

    rng = np.random.default_rng(seed)
    cols = {
        "l_shipdate": rng.integers(19920101, 19981231, rows,
                                   dtype=np.int32),
        "l_returnflag": rng.integers(0, 3, rows, dtype=np.int32),
        "l_linestatus": rng.integers(0, 2, rows, dtype=np.int32),
        "l_quantity": rng.integers(1, 51, rows,
                                   dtype=np.int32).astype(np.float32),
        "l_extendedprice": rng.uniform(1000, 100000,
                                       rows).astype(np.float32),
        "l_discount": rng.uniform(0, 0.1, rows).astype(np.float32),
        "l_tax": rng.uniform(0, 0.08, rows).astype(np.float32),
    }
    return ColumnTable({k: torch.from_numpy(v) for k, v in cols.items()},
                       {"l_returnflag": ["A", "N", "R"],
                        "l_linestatus": ["F", "O"]})


def test_n_identical_cold_executes_run_exactly_once(tmp_path):
    """N=8 concurrent byte-identical EXECUTEs over one cold paged set
    produce exactly one execution: one job, ``sched.coalesce_hits`` up
    by N-1, and every client gets the same summaries."""
    from netsdb_tpu_torch import obs
    from netsdb_tpu_torch.relational import dag as rdag

    cfg = Configuration(root_dir=str(tmp_path / "srv"),
                        page_size_bytes=16384 * 4,
                        page_pool_bytes=1 << 20,
                        device_cache_bytes=64 << 20)
    ctl = ServeController(cfg, port=0, max_jobs=8, device="cpu")
    ctl.start()
    try:
        addr = ctl.advertise_addr
        boot = RemoteClient(addr, timeout=TIMEOUT)
        boot.create_database("d")
        boot.create_set("d", "lineitem", type_name="table",
                        storage="paged")
        boot.send_table("d", "lineitem", _lineitem_table(60_000))
        boot.close()
        sink = rdag.q01_sink("d")
        orig = ctl.handlers[MsgType.EXECUTE_COMPUTATIONS]
        release = threading.Event()

        def gated(p):
            release.wait(30)
            return orig(p)

        ctl.handlers[MsgType.EXECUTE_COMPUTATIONS] = gated
        hits = lambda: obs.REGISTRY.counter("sched.coalesce_hits").value
        hits0 = hits()
        n = 8
        results, errors = [None] * n, [None] * n

        def worker(i):
            c = RemoteClient(addr, timeout=TIMEOUT,
                             client_id=f"tenant-{i}")
            try:
                results[i] = c.execute_computations(
                    sink, job_name="q01-coalesce", fetch_results=False)
            except Exception as e:  # noqa: BLE001 — asserted below
                errors[i] = e
            finally:
                c.close()

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        assert _wait_for(lambda: hits() - hits0 == n - 1)
        release.set()
        for t in threads:
            t.join(timeout=120)
        assert errors == [None] * n
        assert all(r == results[0] for r in results) and results[0]
        runs = [j for j in ctl._jobs.values()
                if j["name"] == "q01-coalesce"]
        assert len(runs) == 1 and runs[0]["status"] == "done"
    finally:
        ctl.shutdown()


def test_lane_quota_rejection_crosses_wire_typed(tmp_path):
    from netsdb_tpu_torch.plan.computations import Apply, ScanSet, WriteSet

    cfg = Configuration(root_dir=str(tmp_path / "q"),
                        sched_lane_quota=1, sched_coalesce=False)
    ctl = ServeController(cfg, port=0, max_jobs=1, device="cpu",
                          admission_timeout_s=10.0)
    ctl.start()
    try:
        addr = ctl.advertise_addr
        boot = RemoteClient(addr, timeout=TIMEOUT)
        boot.create_database("d")
        boot.create_set("d", "in", type_name="object")
        boot.send_data("d", "in", [1, 2, 3])
        boot.close()

        def slow(x):
            time.sleep(2.0)
            return x

        def sink(tag):
            return WriteSet(Apply(ScanSet("d", "in"), slow,
                                  traceable=False), "d", tag)

        def fire(tag):
            c = RemoteClient(addr, timeout=TIMEOUT,
                             retry=RetryPolicy(max_attempts=1))
            try:
                c.execute_computations(sink(tag), job_name=f"job-{tag}",
                                       fetch_results=False)
            finally:
                c.close()

        t_run = threading.Thread(target=fire, args=("a",))
        t_run.start()
        assert _wait_for(lambda: any(
            j["status"] == "running" for j in list(ctl._jobs.values())))
        t_q = threading.Thread(target=fire, args=("b",))
        t_q.start()
        assert _wait_for(
            lambda: ctl.sched.lanes.snapshot()["queued"] == 1)
        c = RemoteClient(addr, timeout=TIMEOUT,
                         retry=RetryPolicy(max_attempts=1))
        with pytest.raises(LaneSaturatedError) as ei:
            c.execute_computations(sink("c"), job_name="job-c",
                                   fetch_results=False)
        c.close()
        assert ei.value.retryable
        assert (ei.value.queue_depth, ei.value.lane) == (1, "default")
        t_run.join(timeout=30)
        t_q.join(timeout=30)
    finally:
        ctl.shutdown()


def test_client_backoff_honors_server_retry_after_hint(tmp_path):
    ctl = ServeController(Configuration(root_dir=str(tmp_path / "h")),
                          port=0, device="cpu")
    ctl.start()
    try:
        c = RemoteClient(ctl.advertise_addr, timeout=TIMEOUT,
                         retry=RetryPolicy(max_attempts=3,
                                           base_delay_s=0.001,
                                           max_delay_s=0.002))
        calls = {"n": 0}

        def attempt(io_timeout):
            calls["n"] += 1
            if calls["n"] == 1:
                e = LaneSaturatedError("LaneSaturated", "quota full")
                e.retry_after_s = 0.25
                raise e
            return "ok"

        t0 = time.perf_counter()
        assert c._retry_driver(attempt) == "ok" and calls["n"] == 2
        dt = time.perf_counter() - t0
        assert 0.2 <= dt < 1.0, dt
        c.close()
    finally:
        ctl.shutdown()


def test_lane_hint_and_client_identity_key_lanes(tmp_path):
    from netsdb_tpu_torch.plan.computations import Apply, ScanSet, WriteSet

    ctl = ServeController(Configuration(root_dir=str(tmp_path / "l")),
                          port=0, device="cpu")
    ctl.start()
    try:
        addr = ctl.advertise_addr
        boot = RemoteClient(addr, timeout=TIMEOUT)
        boot.create_database("d")
        boot.create_set("d", "in", type_name="object")
        boot.send_data("d", "in", [1])
        boot.close()
        sink = WriteSet(Apply(ScanSet("d", "in"), lambda x: x,
                              traceable=False), "d", "out")
        c1 = RemoteClient(addr, timeout=TIMEOUT, client_id="tenant-a",
                          lane="gold")
        c1.execute_computations(sink, job_name="hinted",
                                fetch_results=False)
        c1.close()
        c2 = RemoteClient(addr, timeout=TIMEOUT, client_id="tenant-b")
        c2.execute_computations(sink, job_name="fallback",
                                fetch_results=False)
        c2.close()
        lanes = {j["name"]: j["lane"] for j in ctl._jobs.values()}
        assert lanes["hinted"] == "gold"
        assert lanes["fallback"] == "tenant-b"
        snap = ctl.sched.lanes.snapshot()["lanes"]
        assert "gold" in snap and "tenant-b" in snap
    finally:
        ctl.shutdown()
