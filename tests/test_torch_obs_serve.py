"""The served daemon's observability on the CPU: the reference's
``tests/test_obs_serve.py`` cases that need no ``cli.py``, run against
port daemons in this process (``port=0``, ``device="cpu"``, shut down in
``finally``) — a leader and its follower merging the follower's
sections, and the hedge estimator among them — then the port's own: a
``torch.profiler`` device profile per traced query, a two-daemon shard
pool whose leader merges its worker's trace sections by query id, the
scheduler's feedback through the daemon, and the reference's
``RemoteClient`` reading the port daemon's GET_TRACE, HEALTH and
GET_METRICS (codec 0) with the keys a reference daemon answers with.

Acceptance shape: one warm served EXECUTE yields a GET_TRACE profile
whose spans cover client send -> server decode -> executor chunk loop
-> device-cache hit, the client's top-level spans summing to within
20% of the measured wall time."""

import json
import os
import time

import numpy as np
import pytest
import torch

from netsdb_tpu_torch import obs
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.obs.export import parse_openmetrics
from netsdb_tpu_torch.relational import dag as rdag
from netsdb_tpu_torch.relational.table import ColumnTable
from netsdb_tpu_torch.serve.client import RemoteClient, RetryPolicy
from netsdb_tpu_torch.serve.protocol import MsgType
from netsdb_tpu_torch.serve.server import OBS_FRAMES, ServeController

TIMEOUT = 60.0
PAGED = {"page_size_bytes": 1 << 16, "page_pool_bytes": 1 << 20}


def _remote(addr, **kw):
    kw.setdefault("retry", RetryPolicy(max_attempts=1))
    kw.setdefault("timeout", TIMEOUT)
    return RemoteClient(addr, **kw)


def _li_table(n, seed=0):
    rng = np.random.default_rng(seed)
    cols = {
        "l_shipdate": rng.integers(19940101, 19950101, n, dtype=np.int32),
        "l_discount": np.full(n, 0.06, np.float32),
        "l_quantity": np.full(n, 10.0, np.float32),
        "l_extendedprice": rng.uniform(1000, 2000, n).astype(np.float32),
    }
    return ColumnTable({k: torch.from_numpy(v) for k, v in cols.items()}, {})


def _load_lineitem(c, n=20_000, seed=0):
    c.create_database("d")
    c.create_set("d", "lineitem", type_name="table", storage="paged")
    c.send_table("d", "lineitem", _li_table(n, seed))


def _execute_q06(c):
    c.execute_computations(rdag.q06_sink("d"), job_name="q06",
                           fetch_results=False)


def _daemon(tmp_path, name="obs", **cfg):
    ctl = ServeController(Configuration(root_dir=str(tmp_path / name),
                                        **{**PAGED, **cfg}),
                          port=0, device="cpu")
    ctl.start()
    return ctl


@pytest.fixture()
def daemon(tmp_path):
    ctl = _daemon(tmp_path)
    try:
        yield ctl, ctl.advertise_addr
    finally:
        ctl.shutdown()


def _wait_for(pred, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


def test_warm_execute_trace_covers_the_whole_path(daemon):
    ctl, addr = daemon
    c = _remote(addr)
    _load_lineitem(c)
    _execute_q06(c)  # cold: installs into the device cache

    seen = {p["qid"] for p in obs.DEFAULT_RING.last()}
    t0 = time.perf_counter()
    _execute_q06(c)  # warm: the profile under test
    wall = time.perf_counter() - t0

    client_profs = [p for p in obs.DEFAULT_RING.last()
                    if p["origin"] == "client" and p["qid"] not in seen]
    assert len(client_profs) == 1
    cp = client_profs[0]
    assert {"client.send", "client.wait"} <= {s["name"]
                                              for s in cp["spans"]}
    span_sum = sum(s["duration_s"] for s in cp["spans"] if s["depth"] == 0)
    assert 0.8 * wall <= span_sum <= wall * 1.05, (span_sum, wall)

    reply = c.get_trace(qid=cp["qid"])
    assert reply["enabled"] and "followers" not in reply
    (sp,) = reply["profiles"]
    assert sp["origin"] == "server"
    names = {s["name"]: s for s in sp["spans"]}
    assert "server.decode" in names and names["server.decode"]["start_s"] == 0
    assert "server.dispatch:EXECUTE_COMPUTATIONS" in names
    assert names["executor.fold_stream"]["counters"]["chunks"] >= 1
    assert sp["counters"]["devcache.hits"] >= 1
    assert sp["counters"].get("stage.cached_runs", 0) >= 1
    server_sum = sum(s["duration_s"] for s in sp["spans"]
                     if s["depth"] == 0)
    assert server_sum <= sp["total_s"] * 1.05
    c.close()


def test_get_trace_last_n_and_ring_bound(tmp_path):
    ctl = _daemon(tmp_path, obs_trace_ring=2)
    try:
        c = _remote(ctl.advertise_addr)
        _load_lineitem(c, n=2_000)
        for _ in range(3):
            _execute_q06(c)
        assert _wait_for(lambda: len(ctl.trace_ring) == 2)
        reply = c.get_trace(last=2)
        assert len(reply["profiles"]) == 2
        assert all(p["origin"] == "server" for p in reply["profiles"])
        assert len(c.get_trace()["profiles"]) == 2  # the ring's bound
        c.close()
    finally:
        ctl.shutdown()


def test_collect_stats_metrics_section_and_stable_shapes(daemon):
    ctl, addr = daemon
    c = _remote(addr)
    _load_lineitem(c, n=2_000)
    _execute_q06(c)
    _execute_q06(c)
    st = c.collect_stats()
    assert {"hits", "misses", "installs", "evictions", "invalidations",
            "rejected"} <= set(st["device_cache"])
    from netsdb_tpu_torch.plan.executor import compile_stats

    m = st["metrics"]
    assert {"counters", "gauges", "histograms", "compile", "staging",
            "attribution", "operators", "sched"} <= set(m)
    assert set(m["compile"]) == set(compile_stats())
    assert m["staging"] == {"active_stagers": 0}
    assert m["counters"]["devcache.hits"] >= 1
    assert m["counters"]["devcache.lookups"] >= 2
    assert m["counters"]["staging.chunks"] >= 1
    assert m["counters"]["staging.bytes"] > 0
    c.close()


def test_obs_disable_switch(tmp_path):
    ctl = _daemon(tmp_path, "off", obs_enabled=False)
    try:
        c = _remote(ctl.advertise_addr)
        _load_lineitem(c, n=2_000)
        _execute_q06(c)
        reply = c.get_trace()
        assert reply["enabled"] is False and reply["profiles"] == []
        c.close()
    finally:
        ctl.shutdown()


def test_put_trace_merges_client_section_and_host_device_split(daemon):
    ctl, addr = daemon
    c = _remote(addr, client_id="tenant-a")
    _load_lineitem(c)
    _execute_q06(c)
    _execute_q06(c)
    (cp,) = [p for p in obs.DEFAULT_RING.last(3)
             if p["origin"] == "client"][-1:]
    assert c.flush_traces(10.0)
    (sp,) = c.get_trace(qid=cp["qid"])["profiles"]
    client_sec = sp.get("client")
    assert client_sec is not None and client_sec["qid"] == sp["qid"]
    assert {"client.send", "client.wait"} <= {s["name"] for s in
                                              client_sec["spans"]}
    assert sp["meta"]["client"] == "tenant-a"
    hd = sp["host_device"]
    assert hd["device_est_s"] > 0 and sp["counters"]["device.est_s"] > 0
    assert hd["device_est_s"] + hd["host_s"] == pytest.approx(sp["total_s"])
    assert obs.REGISTRY.counter("serve.client.traces_shipped").value >= 1
    c.close()


def test_put_trace_unmatched_qid_is_counted_not_an_error(daemon):
    ctl, addr = daemon
    c = _remote(addr)
    before = obs.REGISTRY.counter("obs.put_trace.unmatched").value
    out = c._request(MsgType.PUT_TRACE,
                     {"qid": "nope", "profile": {"qid": "nope",
                                                 "spans": []}})
    assert out == {"merged": False, "slowlog_merged": False}
    assert obs.REGISTRY.counter("obs.put_trace.unmatched").value == \
        before + 1
    c.close()


def test_obs_frames_do_not_feed_request_slis(daemon):
    ctl, addr = daemon
    c = _remote(addr)
    _load_lineitem(c, n=500)
    assert OBS_FRAMES == {MsgType.PING, MsgType.COLLECT_STATS,
                          MsgType.GET_TRACE, MsgType.PUT_TRACE,
                          MsgType.HEALTH, MsgType.GET_METRICS}

    def settled():
        deadline, prev = time.monotonic() + 5.0, None
        while True:
            cur = (obs.REGISTRY.counter("serve.requests").value,
                   obs.REGISTRY.counter("serve.requests_ok").value,
                   obs.REGISTRY.histogram("serve.request_s").count)
            if cur == prev or time.monotonic() > deadline:
                return cur
            prev = cur
            time.sleep(0.05)

    req0, ok0, h0 = settled()
    c.ping()
    c.health()
    c.collect_stats()
    c.get_trace(last=1)
    c.get_metrics()
    c._request(MsgType.PUT_TRACE, {"qid": "x", "profile": {"qid": "x"}})
    assert settled() == (req0, ok0, h0)
    _execute_q06(c)
    req1, ok1, _ = settled()
    assert req1 - req0 >= 1 and req1 - req0 == ok1 - ok0
    c.close()


def test_trace_sampling_mints_one_in_n(daemon):
    ctl, addr = daemon
    c = _remote(addr, trace_sample=4)
    _load_lineitem(c, n=2_000)
    before = {p["qid"] for p in ctl.trace_ring.last()}
    sampled0 = obs.REGISTRY.counter("obs.qid_sampled_out").value
    for _ in range(8):
        _execute_q06(c)

    def new():
        return [p for p in ctl.trace_ring.last()
                if p["qid"] not in before and p["origin"] == "server"]

    _wait_for(lambda: len(new()) >= 2)
    assert len(new()) == 2
    assert obs.REGISTRY.counter("obs.qid_sampled_out").value - sampled0 == 6
    c.close()


def test_trace_sample_must_be_at_least_one():
    with pytest.raises(ValueError, match="obs_trace_sample"):
        Configuration(obs_trace_sample=0)


def test_health_frame_objectives_events_and_slowlog_summary(daemon):
    ctl, addr = daemon
    c = _remote(addr)
    _load_lineitem(c, n=2_000)
    _execute_q06(c)
    h = c.health()
    objs = {o["name"]: o for o in h["objectives"]}
    assert {"availability", "request_p99_s", "devcache_hit_rate",
            "staging_wait_fraction"} <= set(objs)
    assert 0.0 < objs["availability"]["value"] <= 1.0
    for o in objs.values():
        assert o["windows"]
        for w in o["windows"].values():
            assert {"value", "burn_rate", "scope"} <= set(w)
    assert isinstance(h["events"], list)
    assert h["slowlog"]["entries"] == 0 and h["slowlog"]["threshold_s"] == 5.0
    assert h["followers_status"] is None
    c.close()


def test_slow_query_log_persists_across_daemon_restart(tmp_path):
    ctl = _daemon(tmp_path, "slow", obs_slow_query_s=1e-6)
    try:
        c = _remote(ctl.advertise_addr)
        _load_lineitem(c, n=2_000)
        _execute_q06(c)
        reply = c.get_trace(slow=True)
        profs = reply["profiles"]
        assert profs and profs[-1]["spans"]
        assert profs[-1]["slowlog_file"].startswith("slow-")
        qid = profs[-1]["qid"]
        assert reply["slowlog"]["entries"] >= 1
        assert c.flush_traces(10.0)
        slow = c.get_trace(slow=True, qid=qid)["profiles"]
        assert slow and slow[-1].get("client"), slow
        c.close()
    finally:
        ctl.shutdown()
    ctl2 = _daemon(tmp_path, "slow", obs_slow_query_s=1e-6)
    try:
        c = _remote(ctl2.advertise_addr)
        reply = c.get_trace(slow=True, qid=qid)
        assert [p["qid"] for p in reply["profiles"]] == [qid]
        c.close()
    finally:
        ctl2.shutdown()


def test_slowlog_holds_at_most_its_bound(tmp_path):
    ctl = _daemon(tmp_path, "bound", obs_slow_query_s=1e-6,
                  obs_slowlog_entries=2)
    try:
        c = _remote(ctl.advertise_addr)
        _load_lineitem(c, n=2_000)
        for _ in range(4):
            _execute_q06(c)

        def settled():  # the 4th trace logged and the oldest two pruned
            summary = ctl.slowlog.summary()
            return summary["entries"] == 2 and (
                summary["newest"] or "").startswith("slow-000000000004-")

        assert _wait_for(settled)
        assert len(os.listdir(ctl.slowlog.dir)) == 2
        assert len(c.get_trace(slow=True)["profiles"]) == 2
        c.close()
    finally:
        ctl.shutdown()


def test_attribution_survives_collect_stats_round_trip(daemon):
    ctl, addr = daemon
    obs.attrib.LEDGER.reset()
    c = _remote(addr, client_id="tenant-b")
    _load_lineitem(c)
    _execute_q06(c)
    _execute_q06(c)
    per_set = c.collect_stats()["metrics"]["attribution"]["tenant-b"]
    mine = per_set["d:lineitem"]
    assert mine["staged_bytes"] > 0 and mine["staged_chunks"] >= 1
    assert mine["executor.chunks"] >= 1
    assert mine.get("devcache.hits", 0) >= 1
    assert mine.get("devcache.installs", 0) >= 1
    assert "d:lineitem" in {s for s, m in per_set.items()
                            if m.get("requests")}
    c.close()


def test_anonymous_traffic_stays_complete_under_anon(daemon):
    ctl, addr = daemon
    obs.attrib.LEDGER.reset()
    c = _remote(addr)
    _load_lineitem(c, n=2_000)
    _execute_q06(c)
    snap = obs.attrib.LEDGER.snapshot()
    assert snap["anon"].get("d:lineitem", {}).get("requests", 0) >= 1
    c.close()


def test_device_profile_directory_written_by_torch_profiler(tmp_path):
    prof_dir = tmp_path / "profiles"
    ctl = _daemon(tmp_path, "prof", obs_device_profile_dir=str(prof_dir))
    try:
        c = _remote(ctl.advertise_addr)
        _load_lineitem(c, n=2_000)
        _execute_q06(c)
        (cp,) = [p for p in obs.DEFAULT_RING.last(1)
                 if p["origin"] == "client"]
        (sp,) = c.get_trace(qid=cp["qid"])["profiles"]
        meta = sp["meta"]
        assert "device_profile_error" not in meta, meta
        assert meta["device_profile"] == str(prof_dir / cp["qid"])
        path = os.path.join(meta["device_profile"], "trace.json")
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        assert events  # the CPU activity of the query
        c.close()
    finally:
        ctl.shutdown()


def test_shard_pool_leader_merges_worker_sections_by_qid(tmp_path):
    from netsdb_tpu_torch.workloads.serve_bench import (scaleout_q01_sink,
                                                        scaleout_table)

    w = ServeController(Configuration(root_dir=str(tmp_path / "w0"),
                                      page_size_bytes=64 * 1024),
                        port=0, device="cpu")
    w.start()
    lead = None
    try:
        lead = ServeController(Configuration(root_dir=str(tmp_path / "ld"),
                                             page_size_bytes=64 * 1024),
                               port=0, device="cpu",
                               workers=[w.advertise_addr],
                               heartbeat_interval_s=60.0)
        lead.start()
        c = _remote(lead.advertise_addr)
        c.create_database("d")
        c.create_set("d", "lineitem", type_name="table", storage="paged",
                     placement="range")
        c.send_table("d", "lineitem", scaleout_table(6000))
        c.execute_computations(scaleout_q01_sink("d"), job_name="sq01",
                               fetch_results=False)
        (cp,) = [p for p in obs.DEFAULT_RING.last(1)
                 if p["origin"] == "client"]
        reply = c.get_trace(qid=cp["qid"])
        (prof,) = reply["profiles"]
        assert w.advertise_addr in reply["shards"]
        sections = prof["shards"][w.advertise_addr]
        assert sections and all(s["qid"] == cp["qid"] for s in sections)
        assert any(sp["name"] == "server.shard.subplan"
                   for s in sections for sp in s["spans"])
        assert w.trace_ring.find(cp["qid"])
        h = c.health()
        assert w.advertise_addr in h["shards"]
        assert h["shards"][w.advertise_addr]["objectives"]
        c.close()
    finally:
        if lead is not None:
            lead.shutdown()
        w.shutdown()


def test_sched_feedback_reseeds_lanes_through_the_daemon(tmp_path):
    obs.attrib.LEDGER.reset()
    ctl = _daemon(tmp_path, "fb", sched_feedback=True,
                  sched_feedback_every=2, sched_slo_shed=True)
    try:
        assert ctl.sched.feedback_enabled and ctl.sched.shed_enabled
        before = obs.REGISTRY.counter("sched.feedback_reseeds").value
        clients = [_remote(ctl.advertise_addr, client_id=cid)
                   for cid in ("light", "heavy")]
        _load_lineitem(clients[0], n=2_000)
        for _ in range(6):
            for c in clients:
                _execute_q06(c)
        assert _wait_for(lambda: obs.REGISTRY.counter(
            "sched.feedback_reseeds").value > before)
        lanes = ctl.sched.snapshot()["lanes"]
        assert {"light", "heavy"} <= set(lanes)
        for c in clients:
            c.close()
    finally:
        ctl.shutdown()


def test_reference_client_reads_the_port_daemons_obs_frames(tmp_path):
    """The reference's wire client, on codec 0, reads the port daemon's
    GET_TRACE, HEALTH and GET_METRICS: every key a reference daemon puts
    in those replies is there."""
    from netsdb_tpu.config import Configuration as RefConfiguration
    from netsdb_tpu.serve.client import RemoteClient as RefClient
    from netsdb_tpu.serve.client import RetryPolicy as RefRetry
    from netsdb_tpu.serve.server import ServeController as RefServe

    def replies(addr, run_query):
        rc = RefClient(addr, retry=RefRetry(max_attempts=1),
                       timeout=TIMEOUT)
        try:
            run_query(addr)
            return (rc.get_trace(last=1), rc.health(), rc.get_metrics(),
                    rc.get_metrics(format="openmetrics"))
        finally:
            rc.close()

    def port_query(addr):
        c = _remote(addr)
        _load_lineitem(c, n=2_000)
        _execute_q06(c)
        c.close()

    def ref_query(addr):
        from netsdb_tpu.relational import dag as jdag
        from netsdb_tpu.relational.table import ColumnTable as JTable

        c = RefClient(addr, retry=RefRetry(max_attempts=1), timeout=TIMEOUT)
        c.create_database("d")
        c.create_set("d", "lineitem", type_name="table", storage="paged")
        c.send_table("d", "lineitem", JTable(
            {k: v.numpy() for k, v in _li_table(2_000).cols.items()}, {}))
        c.execute_computations(jdag.q06_sink("d"), job_name="q06",
                               fetch_results=False)
        c.close()

    ctl = _daemon(tmp_path, "port")
    try:
        port = replies(ctl.advertise_addr, port_query)
    finally:
        ctl.shutdown()
    rctl = RefServe(RefConfiguration(root_dir=str(tmp_path / "ref"),
                                     **PAGED), port=0)
    rport = rctl.start()
    try:
        ref = replies(f"127.0.0.1:{rport}", ref_query)
    finally:
        rctl.shutdown()
    (ptrace, phealth, pmetrics, ptext), (rtrace, rhealth, rmetrics, rtext) = \
        port, ref
    assert set(rtrace) <= set(ptrace)
    assert set(rtrace["profiles"][0]) <= set(ptrace["profiles"][0])
    assert set(rhealth) - {"followers"} <= set(phealth)
    assert [o["name"] for o in rhealth["objectives"]] == \
        [o["name"] for o in phealth["objectives"]]
    assert set(rhealth["objectives"][0]) == set(phealth["objectives"][0])
    assert set(rhealth["slowlog"]) == set(phealth["slowlog"])
    assert set(rmetrics) <= set(pmetrics)
    assert set(rmetrics["history"]) == set(pmetrics["history"])
    assert set(rmetrics["deltas"]) == set(pmetrics["deltas"])
    assert ptext["format"] == rtext["format"] == "openmetrics"
    parse_openmetrics(ptext["text"])


# --- followers: the merged sections and the hedge estimator ------------

def _pair(tmp_path, **leader_kw):
    fctl = _daemon(tmp_path, name="f")
    try:
        mctl = ServeController(
            Configuration(root_dir=str(tmp_path / "m"), **PAGED), port=0,
            device="cpu", followers=[fctl.advertise_addr], **leader_kw)
        mctl.start()
    except BaseException:
        fctl.shutdown()
        raise
    return mctl, fctl


def test_mirrored_pair_merged_stats_and_qid_across_the_hop(tmp_path):
    """COLLECT_STATS through a leader carries its follower's sections (a
    mirrored write's device-cache invalidation on the follower shows from
    the leader), and the query id survives the mirror hop: the leader's
    GET_TRACE profile carries the follower's under the same qid."""
    mctl, fctl = _pair(tmp_path)
    faddr = fctl.advertise_addr
    try:
        c = _remote(mctl.advertise_addr)
        _load_lineitem(c, n=800)
        _execute_q06(c)
        _execute_q06(c)
        assert fctl.library.store.device_cache().stats()["installs"] >= 1
        reply = c.get_trace(last=1)
        (prof,) = reply["profiles"]
        assert prof["origin"] == "server"
        assert faddr in reply["followers"]
        fsections = prof.get("followers") or {}
        assert faddr in fsections, prof
        assert all(fp["qid"] == prof["qid"] for fp in fsections[faddr])
        assert fctl.trace_ring.find(prof["qid"])
        c.send_table("d", "lineitem", _li_table(800, 7))
        st = c.collect_stats()
        assert faddr in st["followers"]
        fdc = st["followers"][faddr]["device_cache"]
        assert fdc["invalidations"] >= 1
        assert fdc == fctl.library.store.device_cache().stats()
        assert "metrics" in st["followers"][faddr]
        assert st["mirror"]["active"] == [faddr]
        c.close()
    finally:
        mctl.shutdown()
        fctl.shutdown()


def test_health_and_attribution_merge_across_leader_follower(tmp_path):
    mctl, fctl = _pair(tmp_path)
    faddr = fctl.advertise_addr
    try:
        c = _remote(mctl.advertise_addr, client_id="tenant-c")
        _load_lineitem(c, n=800)
        _execute_q06(c)
        h = c.health()
        assert h["followers_status"]["active"] == [faddr]
        fh = h["followers"][faddr]
        assert {"availability", "request_p99_s"} <= {
            o["name"] for o in fh["objectives"]}
        assert "slowlog" in fh
        fattr = c.collect_stats()["followers"][faddr]["metrics"][
            "attribution"]
        assert "tenant-c" in fattr
        c.close()
    finally:
        mctl.shutdown()
        fctl.shutdown()


def test_health_fanout_best_effort_never_evicts_degraded_follower(
        tmp_path):
    """A follower whose HEALTH and COLLECT_STATS hang past the leader's
    fan-out deadline is reported with an error entry and never evicted
    by a read (liveness is the heartbeat loop's, configured away)."""
    mctl, fctl = _pair(tmp_path, heartbeat_interval_s=3600.0,
                       frame_timeout_s=1.0)
    faddr = fctl.advertise_addr
    try:
        c = _remote(mctl.advertise_addr)
        c.create_database("d")  # dials the follower link
        assert faddr in mctl.follower_status()["active"]

        def wedged(p):
            time.sleep(3.0)
            return MsgType.OK, {}

        fctl.handlers[MsgType.HEALTH] = wedged
        fctl.handlers[MsgType.COLLECT_STATS] = wedged
        h = c.health()
        assert "error" in h["followers"][faddr]
        st = c.collect_stats()
        assert "error" in st["followers"][faddr]
        status = mctl.follower_status()
        assert faddr in status["active"] and faddr not in status["degraded"]
        c.close()
    finally:
        mctl.shutdown()
        fctl.shutdown()


def test_get_metrics_merges_follower_samples(tmp_path):
    """GET_METRICS through a leader: the structured reply carries the
    follower's snapshot under ``followers``, and the OpenMetrics text
    its samples under a ``follower`` label."""
    mctl, fctl = _pair(tmp_path)
    faddr = fctl.advertise_addr
    try:
        c = _remote(mctl.advertise_addr)
        _load_lineitem(c, n=800)
        _execute_q06(c)
        m = c.get_metrics()
        assert "counters" in m["followers"][faddr]["metrics"]
        text = c.get_metrics(format="openmetrics")["text"]
        fams = parse_openmetrics(text)
        labelled = [lab for fam in fams.values()
                    for _name, lab, _v in fam["samples"]
                    if lab.get("follower") == faddr]
        assert labelled, "no follower-labelled sample"
        c.close()
    finally:
        mctl.shutdown()
        fctl.shutdown()


def test_hedge_estimator_backed_by_shared_histogram(daemon):
    """``hedge_delay_s`` quantiles over the client's bounded histogram,
    whose every observation also lands in the registry histogram that
    COLLECT_STATS ships."""
    ctl, addr = daemon
    before = obs.REGISTRY.histogram("serve.client.read_latency_s").count
    c = _remote(addr, replicas=[addr])
    assert c.hedge_delay_s() == pytest.approx(0.05)
    for i in range(20):
        c._observe_read_latency(0.001 * (i + 1))
    assert c.read_latency_stats()["count"] == 20
    assert c.hedge_delay_s() == c._read_hist.quantile(0.99)
    assert 0.015 <= c.hedge_delay_s() <= 0.020
    shared = obs.REGISTRY.histogram("serve.client.read_latency_s")
    assert shared.count - before == 20
    c._hedge_delay_s = 0.3
    assert c.hedge_delay_s() == 0.3
    c.close()


def test_hedged_read_observes_latency_through_histogram(daemon):
    ctl, addr = daemon
    c = _remote(addr, replicas=[addr], hedge_delay_s=5.0)
    _load_lineitem(c, n=500)
    assert c.set_exists("d", "lineitem")  # an idempotent, hedged read
    assert c._read_hist.count >= 1
    assert c.read_latency_stats()["count"] == c._read_hist.count
    c.close()
