"""The port's query traces (``obs/trace.py``) and ``StageTimer``
(``utils/profiling.py``) against the reference's, on the CPU: the same
operations on both packages give profile dicts with the same fields,
spans, depths, counters, sections and meta — timings aside (start
offsets, durations and totals are replaced by None before comparing,
and where a test plants a duration it checks it exactly). Then the
ring's capacity, ``find`` and pending sections, the exact 1-in-N qid
sampling, ``record`` and ``backdate``, the host/device split clamped to
the total, the kill switch, counters added from another thread, the
timer's bound, the staged stream's counters and the port's
``DeviceClock``."""

import contextlib
import threading
import time
import types

import numpy as np
import pytest

from netsdb_tpu import obs as ref_obs
from netsdb_tpu.utils.profiling import StageTimer as RefStageTimer
from netsdb_tpu_torch import obs
from netsdb_tpu_torch.utils.profiling import StageTimer

TIMING_KEYS = ("start_s", "duration_s", "total_s")


def _pkg(name):
    if name == "ref":
        return types.SimpleNamespace(obs=ref_obs, StageTimer=RefStageTimer)
    return types.SimpleNamespace(obs=obs, StageTimer=StageTimer)


def _both(script):
    """``script(pkg)`` under the reference and the port; equal results."""
    ref, port = script(_pkg("ref")), script(_pkg("port"))
    assert port == ref
    return port


def _untimed(prof):
    """A profile with its timings replaced by None (the host/device split
    kept as its keys)."""
    out = {k: (None if k in TIMING_KEYS else v) for k, v in prof.items()}
    out["spans"] = [{k: (None if k in TIMING_KEYS else v)
                     for k, v in s.items()} for s in prof.get("spans", [])]
    if "host_device" in out:
        out["host_device"] = sorted(out["host_device"])
    return out


def test_trace_spans_nesting_counters_and_ring():
    def script(p):
        ring = p.obs.TraceRing(capacity=8)
        with p.obs.trace("q-abc", origin="client", ring=ring) as tr:
            assert p.obs.current_trace() is tr
            with p.obs.span("outer", "x"):
                time.sleep(0.002)
                with p.obs.span("inner", "y") as sp:
                    sp.counters["n"] = 3
            p.obs.add("bytes", 100)
            p.obs.add("bytes", 28)
        assert p.obs.current_trace() is None
        (prof,) = ring.last()
        assert prof["total_s"] >= 0.002
        names = {s["name"]: s for s in prof["spans"]}
        assert names["outer"]["duration_s"] >= names["inner"]["duration_s"]
        return _untimed(prof)

    prof = _both(script)
    assert prof["qid"] == "q-abc" and prof["origin"] == "client"
    assert [(s["name"], s["depth"]) for s in prof["spans"]] == \
        [("outer", 0), ("inner", 1)]
    assert prof["spans"][1]["counters"] == {"n": 3}
    assert prof["counters"] == {"bytes": 128}


def test_span_and_add_are_noops_without_a_trace():
    for p in (_pkg("ref"), _pkg("port")):
        with p.obs.span("free", "x") as sp:
            assert sp is None
        p.obs.add("nothing")  # must not raise
        assert p.obs.current_trace() is None


def test_nested_trace_joins_outer():
    def script(p):
        ring = p.obs.TraceRing()
        with p.obs.trace("outer-q", ring=ring) as tr:
            with p.obs.trace("inner-q", ring=ring) as inner:
                assert inner is None  # no shadowing
                with p.obs.span("work", "x"):
                    pass
            assert p.obs.current_trace() is tr
        return [_untimed(pr) for pr in ring.last()]

    (prof,) = _both(script)
    assert prof["qid"] == "outer-q"
    assert [s["name"] for s in prof["spans"]] == ["work"]


def test_trace_ring_capacity_and_find():
    def script(p):
        ring = p.obs.TraceRing(capacity=3)
        for i in range(7):
            ring.push({"qid": f"q{i}"})
        return (len(ring), [pr["qid"] for pr in ring.last()],
                [pr["qid"] for pr in ring.last(2)], ring.find("q6"),
                ring.find("q0"))

    n, last, last2, found, gone = _both(script)
    assert n == 3 and last == ["q4", "q5", "q6"] and last2 == ["q5", "q6"]
    assert found == [{"qid": "q6"}] and gone == []


def test_trace_ring_merge_section():
    def script(p):
        ring = p.obs.TraceRing(4)
        ring.push({"qid": "a", "total_s": 1.0})
        hit = ring.merge_section("a", "client", {"spans": []})
        miss = ring.merge_section("missing", "client", {})
        return hit, miss, ring.find("a")

    hit, miss, (prof,) = _both(script)
    assert hit and not miss and prof["client"] == {"spans": []}


def test_trace_ring_pending_section_survives_reply_before_push():
    """A client section that arrives before its profile is pushed waits
    (bounded, oldest evicted) and folds in at the push."""
    def script(p):
        ring = p.obs.TraceRing(8, pending_capacity=2)
        out = [ring.merge_section("early", "client", {"spans": [1]})]
        ring.push({"qid": "early", "total_s": 1.0})
        out.append(ring.find("early")[0].get("client"))
        ring.push({"qid": "early", "total_s": 2.0})
        out.append("client" in ring.find("early")[1])
        for i in range(4):
            ring.merge_section(f"p{i}", "client", {"i": i})
        ring.push({"qid": "p0", "total_s": 1.0})
        out.append("client" in ring.find("p0")[0])
        ring.push({"qid": "p3", "total_s": 1.0})
        out.append(ring.find("p3")[0]["client"])
        return out

    assert _both(script) == [False, {"spans": [1]}, False, False, {"i": 3}]


def test_disable_switch_stops_trace_creation():
    for p in (_pkg("ref"), _pkg("port")):
        ring = p.obs.TraceRing()
        p.obs.set_enabled(False)
        try:
            assert not p.obs.enabled()
            with p.obs.trace("q-off", ring=ring) as tr:
                assert tr is None
                with p.obs.span("x") as sp:
                    assert sp is None
            assert p.obs.sample_qid(1) is None
        finally:
            p.obs.set_enabled(True)
        assert len(ring) == 0 and p.obs.enabled()


def test_trace_record_backdate_and_cross_thread_counters():
    def script(p):
        tr = p.obs.QueryTrace("qt", "server")
        tr.backdate(0.5)
        tr.record("decode", 0.005, "serve", start_s=0.0, n=2)

        def worker():
            tr.add("stage.chunks", 2)

        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        prof = tr.finish()
        # the back-dated half second is in the total
        assert prof["total_s"] >= 0.5
        assert prof["spans"][0]["start_s"] == 0.0
        assert prof["spans"][0]["duration_s"] == pytest.approx(0.005)
        return _untimed(prof)

    prof = _both(script)
    assert prof["spans"][0]["name"] == "decode"
    assert prof["spans"][0]["counters"] == {"n": 2}
    assert prof["counters"] == {"stage.chunks": 2}


def test_cross_thread_counters_sum_exactly():
    tr = obs.QueryTrace("qx", "server")

    def work():
        for _ in range(500):
            tr.add("stage.chunks")

    ts = [threading.Thread(target=work) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
        assert not t.is_alive()
    assert tr.finish()["counters"]["stage.chunks"] == 4000


def test_profile_host_device_split_and_meta():
    def script(p):
        tr = p.obs.QueryTrace("q1", origin="server")
        tr.backdate(1.0)  # a 1 s query, without sleeping for one
        tr.record("step", 0.5, "executor")
        tr.add("device.est_s", 0.2)
        tr.add("stage.wait_s", 0.1)
        tr.annotate("device_profile", "/prof/q1")
        tr.attach_section("operators", {"job": "j"})
        prof = tr.finish()
        hd = prof["host_device"]
        assert hd["device_est_s"] == pytest.approx(0.3)
        assert hd["host_s"] == pytest.approx(prof["total_s"] - 0.3)
        return _untimed(prof)

    prof = _both(script)
    assert prof["meta"] == {"device_profile": "/prof/q1"}
    assert prof["operators"] == {"job": "j"}


def test_profile_device_estimate_clamped_to_total():
    for p in (_pkg("ref"), _pkg("port")):
        tr = p.obs.QueryTrace("q2")
        tr.add("device.est_s", 10_000.0)  # an over-estimate
        prof = tr.finish()
        assert prof["host_device"]["device_est_s"] == prof["total_s"]
        assert prof["host_device"]["host_s"] == 0.0


def test_sample_qid_every_query_at_one():
    for p in (_pkg("ref"), _pkg("port")):
        assert all(p.obs.sample_qid(1) for _ in range(5))
        assert all(p.obs.sample_qid(0) for _ in range(2))  # <= 1: always


def test_qid_sampler_exact_one_in_n():
    """Deterministic round-robin: exactly 1 in n, the same pattern on
    both sides, fresh ids each time; the skipped ones are counted."""
    def script(p):
        s = p.obs.QidSampler()
        before = p.obs.REGISTRY.counter("obs.qid_sampled_out").value
        got = [s.sample(8) for _ in range(32)]
        minted = [q for q in got if q]
        assert len(set(minted)) == len(minted)
        return ([q is not None for q in got],
                p.obs.REGISTRY.counter("obs.qid_sampled_out").value
                - before)

    hits, skipped = _both(script)
    assert sum(hits) == 4 and skipped == 28
    assert [i for i, h in enumerate(hits) if h] == [7, 15, 23, 31]


def test_two_samplers_keep_their_own_phase():
    a, b = obs.QidSampler(), obs.QidSampler()
    got = [(a.sample(4), b.sample(4)) for _ in range(8)]
    assert sum(1 for qa, _ in got if qa) == 2
    assert sum(1 for _, qb in got if qb) == 2


def test_stage_timer_bounded_samples_exact_count():
    def script(p):
        t = p.StageTimer(max_samples=16)
        for _ in range(200):
            with t.span("hot"):
                pass
        s = t.summary()
        assert t.sample_count("hot") <= 16
        assert s["hot"]["total_s"] >= 0
        out = (s["hot"]["count"], sorted(s["hot"]), t.sample_count("hot"))
        t.reset()
        return out + (t.summary(),)

    count, keys, kept, after = _both(script)
    assert count == 200 and kept == 16 and after == {}
    assert {"count", "total_s", "mean_s", "max_s", "p99_s"} <= set(keys)


def test_stage_timer_summary_mean_is_total_over_count():
    t = StageTimer()
    for _ in range(2):
        with t.span("plan"):
            time.sleep(0.01)
    s = t.summary()
    assert s["plan"]["count"] == 2 and s["plan"]["total_s"] >= 0.02
    assert s["plan"]["mean_s"] == pytest.approx(s["plan"]["total_s"] / 2)
    assert obs.REGISTRY.snapshot()["stages"] is not None


def test_staged_stream_reports_into_active_trace(tmp_path):
    """A staged stream under a trace counts its chunks and bytes on the
    trace, the same numbers on both sides for the same pages."""
    from netsdb_tpu.config import Configuration as RefConfiguration
    from netsdb_tpu.relational.outofcore import PagedColumns as RefPC
    from netsdb_tpu.storage.paged import PagedTensorStore as RefStore
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.relational.outofcore import PagedColumns
    from netsdb_tpu_torch.storage.paged import PagedTensorStore

    rng = np.random.default_rng(0)
    cols = {"k": rng.integers(0, 8, 5000, dtype=np.int32),
            "v": rng.standard_normal(5000).astype(np.float32)}
    out = {}
    for side, cfg, Store, PC, o, kw in (
            ("ref", RefConfiguration, RefStore, RefPC, ref_obs, {}),
            ("port", Configuration, PagedTensorStore, PagedColumns, obs,
             {"device": "cpu"})):
        store = Store(cfg(root_dir=str(tmp_path / side)),
                      pool_bytes=8 << 20)
        try:
            pc = PC.ingest(store, "t", cols, row_block=1024, **kw)
            ring = o.TraceRing()
            with o.trace("q-staged", ring=ring):
                with contextlib.closing(pc.stream()) as chunks:
                    n = sum(1 for _ in chunks)
            (prof,) = ring.last()
            out[side] = (n, prof["counters"]["stage.chunks"],
                         prof["counters"]["stage.bytes"] > 0)
        finally:
            store.close()
    assert out["port"][0] == out["port"][1] and out["port"][2]
    assert out["port"][:2] == out["ref"][:2]


def test_device_clock_on_the_cpu_is_the_wall_around_each_step():
    """Without a trace the clock does nothing; under one it adds the
    summed wall time of its steps to ``device.est_s`` and to the span."""
    clock = obs.DeviceClock("cpu")
    assert clock.start() is None
    clock.commit()
    ring = obs.TraceRing()
    with obs.trace("q-dev", ring=ring) as tr:
        with obs.span("loop", "executor") as sp:
            clock = obs.DeviceClock("cpu")
            for _ in range(3):
                mark = clock.start()
                time.sleep(0.01)
                clock.stop(mark)
            clock.commit(sp)
    (prof,) = ring.last()
    assert tr.profile_dict is prof
    dev = prof["counters"]["device.est_s"]
    assert 0.03 <= dev <= prof["total_s"]
    assert prof["spans"][0]["counters"]["device_est_s"] == dev
    assert prof["host_device"]["device_est_s"] == pytest.approx(dev)


def test_trace_counts_finished_traces_by_origin():
    before = obs.REGISTRY.counter("obs.traces.local").value
    with obs.trace(ring=obs.TraceRing()):
        pass
    assert obs.REGISTRY.counter("obs.traces.local").value == before + 1
