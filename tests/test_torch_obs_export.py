"""The port's continuous telemetry against the reference's, on the CPU:
the telemetry history (``obs/history.py``) — its bound and its rates
under one fake clock, equal on both sides; its thread's clean start and
stop — and the OpenMetrics export (``obs/export.py``): one snapshot
renders to byte-equal text on both sides, each side's parser accepts
the other's text and rejects the same malformed inputs, and only
catalogued names are exported. Then GET_METRICS over the wire from a
port daemon, both forms, and the history thread joined at shutdown."""

import time
import types

import numpy as np
import pytest
import torch

from netsdb_tpu import obs as ref_obs
from netsdb_tpu.obs import export as ref_export
from netsdb_tpu.obs import history as ref_history
from netsdb_tpu.obs.metrics import MetricsRegistry as RefRegistry
from netsdb_tpu_torch import obs
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.obs import export, history
from netsdb_tpu_torch.obs.metrics import MetricsRegistry
from netsdb_tpu_torch.relational import dag as rdag
from netsdb_tpu_torch.relational.table import ColumnTable
from netsdb_tpu_torch.serve.client import RemoteClient, RetryPolicy
from netsdb_tpu_torch.serve.server import ServeController


def _pkg(name):
    if name == "ref":
        return types.SimpleNamespace(obs=ref_obs, export=ref_export,
                                     history=ref_history,
                                     Registry=RefRegistry)
    return types.SimpleNamespace(obs=obs, export=export, history=history,
                                 Registry=MetricsRegistry)


def _both(script):
    ref, port = script(_pkg("ref")), script(_pkg("port"))
    assert port == ref
    return port


# ------------------------------------------------------------ history
def test_history_ring_is_bounded_and_numeric_only():
    def script(p):
        reg = p.Registry()
        reg.counter("serve.requests").inc(5)
        reg.histogram("serve.request_s").observe(0.25)
        hist = p.history.TelemetryHistory(registry=reg, capacity=4,
                                          interval_s=0, clock=lambda: 7.0)
        for _ in range(20):
            hist.observe()
        summary = hist.summary()
        return summary, reg.numeric_snapshot()

    summary, snap = _both(script)
    assert summary["readings"] == 4 and summary["capacity"] == 4
    assert snap["counters"]["serve.requests"] == 5
    assert snap["hists"]["serve.request_s"] == (1, 0.25)
    assert "histograms" not in snap and "attribution" not in snap


def test_history_deltas_derive_rates():
    def script(p):
        reg = p.Registry()
        clock = [100.0]
        hist = p.history.TelemetryHistory(registry=reg, capacity=16,
                                          interval_s=0,
                                          clock=lambda: clock[0])
        assert hist.deltas() == {}
        reg.counter("serve.requests").inc(10)
        reg.counter("serve.requests_ok").inc(10)
        hist.observe()
        clock[0] += 10.0
        reg.counter("serve.requests").inc(40)
        reg.counter("serve.requests_ok").inc(30)
        reg.counter("staging.bytes").inc(20_000_000)
        reg.counter("devcache.hits").inc(3)
        reg.counter("devcache.lookups").inc(4)
        hist.observe()
        clock[0] += 50.0
        reg.counter("serve.requests").inc(5)
        hist.observe()
        return hist.deltas(), hist.deltas(window_s=30.0), \
            hist.deltas(window_s=1.0), hist.summary()

    whole, windowed, too_short, summary = _both(script)
    assert whole["dt_s"] == pytest.approx(60.0)
    assert windowed == {}  # only the newest reading lies inside 30 s
    assert too_short == {}
    assert summary["span_s"] == pytest.approx(60.0)

    def script2(p):
        reg = p.Registry()
        clock = [0.0]
        hist = p.history.TelemetryHistory(registry=reg, capacity=16,
                                          interval_s=0,
                                          clock=lambda: clock[0])
        reg.counter("serve.requests").inc(10)
        reg.counter("serve.requests_ok").inc(10)
        hist.observe()
        clock[0] += 10.0
        reg.counter("serve.requests").inc(40)
        reg.counter("serve.requests_ok").inc(30)
        reg.counter("staging.bytes").inc(20_000_000)
        reg.counter("devcache.hits").inc(3)
        reg.counter("devcache.lookups").inc(4)
        hist.observe()
        return hist.deltas()

    d = _both(script2)
    assert d["dt_s"] == pytest.approx(10.0)
    assert d["rates"]["serve.requests"] == pytest.approx(4.0)
    assert d["derived"]["qps"] == pytest.approx(4.0)
    assert d["derived"]["staged_mb_s"] == pytest.approx(2.0)
    assert d["derived"]["devcache_hit_rate"] == pytest.approx(0.75)
    assert d["derived"]["availability"] == pytest.approx(0.75)


def test_history_thread_starts_and_stops_cleanly():
    reg = MetricsRegistry()
    hist = history.TelemetryHistory(registry=reg, capacity=8,
                                    interval_s=0.05)
    hist.start()
    assert hist.running
    deadline = time.monotonic() + 5.0
    while hist.summary()["readings"] < 3:
        assert time.monotonic() < deadline, "no snapshots taken"
        time.sleep(0.02)
    hist.stop()
    assert not hist.running
    n = hist.summary()["readings"]
    time.sleep(0.15)
    assert hist.summary()["readings"] == n  # really stopped
    hist.stop()  # idempotent


def test_history_interval_zero_disables_thread():
    for p in (_pkg("ref"), _pkg("port")):
        hist = p.history.TelemetryHistory(registry=p.Registry(),
                                          interval_s=0)
        hist.start()
        assert not hist.running
        assert hist.summary()["readings"] == 0


# ----------------------------------------------------------- exporter
def _snapshot_with_traffic(p):
    reg = p.Registry()
    reg.counter("serve.requests").inc(12)
    reg.counter("serve.requests_ok").inc(11)
    reg.counter("staging.bytes").inc(1 << 20)
    reg.counter("devcache.hits").inc(7)
    reg.gauge("sched.queue_depth").set(2.5)
    reg.histogram("serve.request_s").observe(0.1)
    reg.histogram("serve.request_s").observe(0.3)
    reg.histogram("staging.wait_s").observe(1e-7)
    snap = reg.snapshot()
    snap["attribution"] = {
        "tenant-a": {"d:lineitem": {"requests": 7, "staged_bytes": 4096,
                                    "devcache.hits": 2}},
        "anon": {"*": {"requests": 5}},
        "q\"uote\\d": {"d:x": {"executor.chunks": 1.5}},
    }
    return snap


def test_openmetrics_is_byte_equal_to_the_reference():
    def script(p):
        snap = _snapshot_with_traffic(p)
        return (p.export.to_openmetrics(snap),
                p.export.to_openmetrics(snap, followers={
                    "127.0.0.1:9001": _snapshot_with_traffic(p),
                    "127.0.0.1:9002": {"error": "down"}}))

    plain, with_followers = _both(script)
    assert "netsdb_serve_requests_total 12\n" in plain
    assert 'follower="127.0.0.1:9001"' in with_followers
    assert "9002" not in with_followers


def test_openmetrics_parses_under_the_grammar_with_labels():
    text = export.to_openmetrics(_snapshot_with_traffic(_pkg("port")))
    fams = export.parse_openmetrics(text)
    assert fams == ref_export.parse_openmetrics(text)
    reqs = fams["netsdb_serve_requests_total"]
    assert reqs["type"] == "counter" and reqs["samples"][0][2] == 12.0
    lat = fams["netsdb_serve_request_s"]
    assert lat["type"] == "summary"
    names = {n for n, _l, _v in lat["samples"]}
    assert {"netsdb_serve_request_s_sum",
            "netsdb_serve_request_s_count"} <= names
    quantiles = {lab.get("quantile") for _n, lab, _v in lat["samples"]
                 if "quantile" in lab}
    assert {"0.5", "0.95", "0.99"} <= quantiles
    att = fams["netsdb_attrib_requests_total"]
    rows = {(lab.get("client"), lab.get("set")): v
            for _n, lab, v in att["samples"]}
    assert rows[("tenant-a", "d:lineitem")] == 7.0
    assert rows[("anon", "*")] == 5.0


def test_exporter_emits_only_catalogued_names():
    def script(p):
        reg = p.Registry()
        reg.counter("serve.requests").inc()
        reg.counter("rogue.uncatalogued_thing").inc()
        reg.gauge("rogue.gauge").set(1)
        before = p.obs.REGISTRY.counter("obs.export.uncatalogued").value
        text = p.export.to_openmetrics(reg.snapshot())
        return text, p.obs.REGISTRY.counter(
            "obs.export.uncatalogued").value - before

    text, skipped = _both(script)
    assert "rogue" not in text and skipped == 2
    for fam in export.parse_openmetrics(text):
        raw = fam[len("netsdb_"):]
        raw = raw[:-len("_total")] if raw.endswith("_total") else raw
        assert any(raw == k.replace(".", "_").replace("-", "_")
                   for k in export.CATALOG), fam


def test_catalog_and_attrib_families_equal_the_reference():
    assert export.CATALOG == ref_export.CATALOG
    assert export.ATTRIB_METRICS == ref_export.ATTRIB_METRICS
    for name in export.ATTRIB_METRICS:
        assert f"attrib.{name}" in export.CATALOG
    for v in (0, 3, 2.5, 1e20, -0.0, float("inf"), float("-inf"),
              float("nan"), 1e-7, 123456789012345.0):
        assert export._fmt(v) == ref_export._fmt(v)
    assert export.metric_name("a.b-c", "_total") == \
        ref_export.metric_name("a.b-c", "_total")


def test_parsers_accept_each_others_text():
    for writer, reader in ((export, ref_export), (ref_export, export)):
        text = writer.to_openmetrics(_snapshot_with_traffic(_pkg("port")))
        assert reader.parse_openmetrics(text) == \
            writer.parse_openmetrics(text)


@pytest.mark.parametrize("bad", [
    "# TYPE netsdb_x bogus_type\n",
    "netsdb_orphan_sample 1\n",                       # no family
    "# TYPE netsdb_a counter\nnetsdb_a{open 1\n",     # torn labels
    "# TYPE netsdb_a counter\nnetsdb_a notanumber\n",
    "# TYPE netsdb_c counter\nnetsdb_c_bucket 1\n",   # bad suffix
    "# TYPE netsdb_c counter\nnetsdb_c 1\n",          # counter without _total
    "# HELP 1bad name\n",
    "# TYPE netsdb_a_total counter\nnetsdb_a_total{x=\"1\" y} 1\n",
])
def test_parser_rejects_grammar_violations(bad):
    for p in (_pkg("ref"), _pkg("port")):
        with pytest.raises(ValueError):
            p.export.parse_openmetrics(bad)


# -------------------------------------------------------- serve layer
def _li_table(n, seed=0):
    rng = np.random.default_rng(seed)
    cols = {
        "l_shipdate": rng.integers(19940101, 19950101, n, dtype=np.int32),
        "l_discount": np.full(n, 0.06, np.float32),
        "l_quantity": np.full(n, 10.0, np.float32),
        "l_extendedprice": rng.uniform(1000, 2000, n).astype(np.float32),
    }
    return ColumnTable({k: torch.from_numpy(v) for k, v in cols.items()}, {})


def test_get_metrics_over_the_wire_and_clean_daemon_stop(tmp_path):
    ctl = ServeController(
        Configuration(root_dir=str(tmp_path / "gm"),
                      page_size_bytes=1 << 16, page_pool_bytes=1 << 20,
                      obs_history_interval_s=0.1),
        port=0, device="cpu")
    ctl.start()
    assert ctl.history.running
    try:
        c = RemoteClient(ctl.advertise_addr, client_id="tenant-x",
                         retry=RetryPolicy(max_attempts=1), timeout=60)
        c.create_database("d")
        c.create_set("d", "lineitem", type_name="table", storage="paged")
        c.send_table("d", "lineitem", _li_table(6_000))
        c.execute_computations(rdag.q06_sink("d"), job_name="q06",
                               fetch_results=False)
        m = c.get_metrics(window_s=60.0)
        assert m["history"]["readings"] >= 1
        assert {"metrics", "history", "deltas"} <= set(m)
        assert m["metrics"]["counters"]["serve.requests"] >= 4
        text = c.get_metrics(format="openmetrics")["text"]
        fams = export.parse_openmetrics(text)
        assert fams == ref_export.parse_openmetrics(text)
        att = fams["netsdb_attrib_requests_total"]
        assert any(lab.get("client") == "tenant-x"
                   and lab.get("set") == "d:lineitem"
                   for _n, lab, _v in att["samples"])
        c.close()
    finally:
        ctl.shutdown()
    assert not ctl.history.running  # joined at shutdown


def test_history_length_below_two_starts_no_thread(tmp_path):
    ctl = ServeController(
        Configuration(root_dir=str(tmp_path / "h"), obs_history_len=1,
                      obs_history_interval_s=0.05),
        port=0, device="cpu")
    ctl.start()
    try:
        assert not ctl.history.running
    finally:
        ctl.shutdown()
