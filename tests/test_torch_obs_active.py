"""The port's active observability against the reference's, on the CPU:
the SLO engine (``obs/slo.py``), the slow-query log (``obs/slowlog.py``)
and the per-(client, set) attribution ledger (``obs/attrib.py``).

Each scripted sequence runs on both packages — the SLO engine over each
package's own registry under one fake monotonic clock, with the events'
display timestamp (``wall_now``) patched to 0 on both sides — and the
results must be equal: ``evaluate()`` and ``events()`` exactly, burn
rates and ratios within 1e-12. The slow-query log's file names, bound,
restart continuity and ``merge_section`` are compared on disk; the
ledger's sums are exact, under threads too."""

import json
import math
import os
import threading
import types

import pytest

from netsdb_tpu import obs as ref_obs
from netsdb_tpu.obs import attrib as ref_attrib
from netsdb_tpu.obs import slo as ref_slo
from netsdb_tpu.obs import slowlog as ref_slowlog
from netsdb_tpu.obs.metrics import MetricsRegistry as RefRegistry
from netsdb_tpu_torch import obs
from netsdb_tpu_torch.obs import attrib, slo, slowlog
from netsdb_tpu_torch.obs.metrics import MetricsRegistry


def _pkg(name):
    if name == "ref":
        return types.SimpleNamespace(obs=ref_obs, slo=ref_slo,
                                     slowlog=ref_slowlog, attrib=ref_attrib,
                                     Registry=RefRegistry)
    return types.SimpleNamespace(obs=obs, slo=slo, slowlog=slowlog,
                                 attrib=attrib, Registry=MetricsRegistry)


def _close(a, b, tol=1e-12) -> bool:
    """Equal structures, floats within ``tol``."""
    if isinstance(a, dict) and isinstance(b, dict):
        return set(a) == set(b) and all(_close(a[k], b[k], tol) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y, tol)
                                        for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float):
        return a == b or math.isclose(a, b, rel_tol=tol, abs_tol=tol)
    return a == b


@pytest.fixture(autouse=True)
def _fixed_wall(monkeypatch):
    """The events' display timestamp, fixed on both sides."""
    import netsdb_tpu.utils.timing as rt
    import netsdb_tpu_torch.utils.timing as pt

    monkeypatch.setattr(rt, "wall_now", lambda: 0.0)
    monkeypatch.setattr(pt, "wall_now", lambda: 0.0)


def _both(script):
    ref, port = script(_pkg("ref")), script(_pkg("port"))
    assert _close(port, ref), (port, ref)
    return port


# ------------------------------------------------------------ SLO engine
class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _ratio_engine(p, reg, clock, target=0.9, windows=(60.0, 600.0)):
    return p.slo.SLOEngine(
        registry=reg, clock=clock, windows=windows,
        objectives=[p.slo.Objective(name="avail", kind="ratio_min",
                                    target=target, good="ok", total="all")])


def test_objective_validation():
    for p in (_pkg("ref"), _pkg("port")):
        with pytest.raises(ValueError):
            p.slo.Objective(name="x", kind="nonsense", target=1.0)
        with pytest.raises(ValueError):
            p.slo.Objective(name="x", kind="ratio_min", target=0.9, good="a")
        with pytest.raises(ValueError):
            p.slo.Objective(name="x", kind="quantile_max", target=0.9)


def test_ratio_min_all_time_fallback_then_windowed():
    def script(p):
        reg, clock = p.Registry(), _Clock()
        eng = _ratio_engine(p, reg, clock)
        out = [eng.evaluate()]
        reg.counter("ok").inc(99)
        reg.counter("all").inc(100)
        clock.advance(1.0)
        out.append(eng.evaluate())
        clock.advance(30.0)
        reg.counter("ok").inc(25)
        reg.counter("all").inc(50)
        clock.advance(1.0)
        out.append(eng.evaluate())
        return out, eng.events()

    (none, fallback, burn), events = _both(script)
    assert none[0]["value"] is None and not none[0]["breached"]
    assert fallback[0]["value"] == pytest.approx(0.99)
    w60 = burn[0]["windows"]["60s"]
    assert w60["scope"] == "window" and w60["value"] < 0.9
    assert burn[0]["breached"]
    assert w60["burn_rate"] == pytest.approx((1 - w60["value"]) / 0.1)
    assert [e["event"] for e in events] == ["breach"]


def test_breach_events_fire_on_transitions_only():
    def script(p):
        reg, clock = p.Registry(), _Clock()
        eng = _ratio_engine(p, reg, clock)
        reg.counter("ok").inc(1)
        reg.counter("all").inc(10)
        for _ in range(2):
            clock.advance(1.0)
            eng.evaluate()
        first = (eng.events(), reg.counter("slo.breaches").value)
        reg.counter("ok").inc(100_000)
        reg.counter("all").inc(100_000)
        clock.advance(700.0)
        eng.evaluate()
        clock.advance(1.0)
        eng.evaluate()
        return first, eng.events(), reg.counter("slo.recoveries").value

    (evs, breaches), evs2, recoveries = _both(script)
    assert len(evs) == 1 and evs[0]["objective"] == "avail"
    assert evs[0]["event"] == "breach" and breaches == 1
    assert [e["event"] for e in evs2] == ["breach", "recovery"]
    assert recoveries == 1


def test_quantile_objective_reads_histogram_ring():
    def script(p):
        reg = p.Registry()
        eng = p.slo.SLOEngine(
            registry=reg, clock=_Clock(),
            objectives=[p.slo.Objective(name="p99", kind="quantile_max",
                                        target=0.1, hist="lat",
                                        quantile=0.99)])
        for _ in range(100):
            reg.histogram("lat").observe(0.01)
        good = eng.evaluate()
        for _ in range(100):
            reg.histogram("lat").observe(0.5)
        return good, eng.evaluate()

    (good,), (bad,) = _both(script)
    assert good["value"] == pytest.approx(0.01) and not good["breached"]
    assert bad["breached"] and bad["worst_burn_rate"] == pytest.approx(5.0)


def test_rate_objective_total_seconds_per_wall_second():
    def script(p):
        reg, clock = p.Registry(), _Clock()
        eng = p.slo.SLOEngine(
            registry=reg, clock=clock, windows=(60.0,),
            objectives=[p.slo.Objective(name="waitfrac", kind="rate_max",
                                        target=0.25, hist="wait")])
        out = [eng.evaluate()]
        for _ in range(30):
            reg.histogram("wait").observe(0.1)
        clock.advance(30.0)
        out.append(eng.evaluate())
        for _ in range(100):
            reg.histogram("wait").observe(0.1)
        clock.advance(10.0)
        out.append(eng.evaluate())
        return out

    (empty,), (ok,), (bad,) = _both(script)
    assert empty["value"] is None
    assert ok["value"] == pytest.approx(0.1, rel=0.01) and not ok["breached"]
    assert bad["breached"]


def test_default_objectives_shape():
    def script(p):
        objs = p.slo.default_objectives()
        out = p.slo.SLOEngine(registry=p.Registry(), clock=_Clock(),
                              objectives=objs).evaluate()
        json.dumps(out)
        return [(o.name, o.kind, o.target, o.good, o.total, o.hist,
                 o.quantile, o.description) for o in objs], out

    objs, out = _both(script)
    assert {"availability", "request_p99_s", "devcache_hit_rate",
            "staging_wait_fraction"} <= {o[0] for o in objs}
    for res in out:
        assert {"value", "windows", "worst_burn_rate", "breached", "kind",
                "target", "description"} <= set(res)


def test_slo_breach_requires_all_windows_to_agree():
    def script(p):
        reg, clock = p.Registry(), _Clock()
        eng = _ratio_engine(p, reg, clock)
        reg.counter("ok").inc(1000)
        reg.counter("all").inc(1000)
        clock.advance(545.0)
        eng.observe()
        reg.counter("all").inc(10)
        clock.advance(6.0)
        burst = eng.evaluate()
        quiet_events = eng.events()
        for _ in range(12):
            reg.counter("all").inc(100)
            clock.advance(60.0)
            out = eng.evaluate()
        return burst, quiet_events, out, eng.events(), \
            eng.breached_objectives(evaluate=False)

    (burst,), quiet, (sustained,), events, breached = _both(script)
    assert burst["windows"]["60s"]["value"] < 0.9
    assert burst["windows"]["600s"]["value"] > 0.9
    assert not burst["breached"] and burst["value"] < 0.9 and quiet == []
    assert sustained["breached"] and breached == ["avail"]
    assert [e["event"] for e in events] == ["breach"]


def test_slo_rate_breach_requires_all_windows_to_agree():
    def script(p):
        reg, clock = p.Registry(), _Clock()
        eng = p.slo.SLOEngine(
            registry=reg, clock=clock, windows=(60.0, 600.0),
            objectives=[p.slo.Objective(name="waitfrac", kind="rate_max",
                                        target=0.25, hist="wait")])
        for _ in range(200):
            reg.histogram("wait").observe(1.0)
        clock.advance(100.0)
        eng.observe()
        clock.advance(440.0)
        eng.observe()
        clock.advance(60.0)
        quiet = eng.evaluate()
        for _ in range(200):
            reg.histogram("wait").observe(1.0)
        clock.advance(30.0)
        return quiet, eng.evaluate()

    (quiet,), (both,) = _both(script)
    assert quiet["windows"]["600s"]["value"] > 0.25
    assert quiet["windows"]["60s"]["value"] == 0.0 and not quiet["breached"]
    assert both["breached"]


# --------------------------------------------------------------- slowlog
def _profile(qid, total):
    return {"qid": qid, "origin": "server", "total_s": total,
            "spans": [], "counters": {}}


def test_slowlog_threshold_and_bound(tmp_path):
    def script(p):
        log = p.slowlog.SlowQueryLog(str(tmp_path / p.obs.__name__),
                                     capacity=3, threshold_s=1.0)
        skipped = [log.maybe_record(_profile("fast", 0.5)),
                   log.maybe_record(_profile("nototal", None))]
        for i in range(5):
            assert log.maybe_record(_profile(f"slow{i}", 2.0 + i))
        summary = log.summary()
        summary.pop("dir")
        return skipped, log.entries(), summary, sorted(os.listdir(log.dir))

    skipped, entries, summary, names = _both(script)
    assert skipped == [None, None]
    assert [e["qid"] for e in entries] == ["slow2", "slow3", "slow4"]
    assert names == ["slow-000000000003-slow2.json",
                     "slow-000000000004-slow3.json",
                     "slow-000000000005-slow4.json"]
    assert summary["entries"] == 3


def test_slowlog_survives_restart_with_continuing_seq(tmp_path):
    def script(p):
        root = str(tmp_path / p.obs.__name__)
        log = p.slowlog.SlowQueryLog(root, capacity=10, threshold_s=1.0)
        log.record(_profile("a", 2.0))
        log.record(_profile("b", 2.0))
        log2 = p.slowlog.SlowQueryLog(root, capacity=10, threshold_s=1.0)
        before = [e["qid"] for e in log2.entries()]
        log2.record(_profile("c", 2.0))
        return before, [e["qid"] for e in log2.entries()], \
            sorted(os.listdir(log2.dir))

    before, after, names = _both(script)
    assert before == ["a", "b"] and after == ["a", "b", "c"]
    assert [int(n.split("-")[1]) for n in names] == [1, 2, 3]


def test_slowlog_disabled_and_unserializable_never_fatal(tmp_path):
    def script(p):
        root = tmp_path / p.obs.__name__
        off = p.slowlog.SlowQueryLog(str(root / "off"), capacity=4,
                                     threshold_s=None)
        disabled = off.maybe_record(_profile("x", 100.0))
        log = p.slowlog.SlowQueryLog(str(root / "on"), capacity=4,
                                     threshold_s=1.0)
        prof = _profile("y", 2.0)
        prof["weird"] = object()
        kept = log.record(prof) is not None
        with open(os.path.join(log.dir, "slow-999999999999-zz.json"),
                  "w") as f:
            f.write("{not json")
        return disabled, kept, [e["qid"] for e in log.entries()]

    assert _both(script) == (None, True, ["y"])


def test_slowlog_merge_section_rewrites_persisted_entry(tmp_path):
    def script(p):
        log = p.slowlog.SlowQueryLog(str(tmp_path / p.obs.__name__),
                                     capacity=4, threshold_s=1.0)
        log.record(_profile("q1", 2.0))
        log.record(_profile("q2", 3.0))
        hit = log.merge_section("q1", "client", {"spans": [{"name": "s"}]})
        miss = log.merge_section("absent", "client", {})
        return hit, miss, log.entries()

    hit, miss, entries = _both(script)
    by_qid = {e["qid"]: e for e in entries}
    assert hit and not miss
    assert by_qid["q1"]["client"] == {"spans": [{"name": "s"}]}
    assert "client" not in by_qid["q2"]


def test_slowlog_unwritable_directory_returns_none(tmp_path):
    """A log whose directory went away (a file took its place) loses the
    entry and returns None on both sides; the query is never failed."""
    def script(p):
        log = p.slowlog.SlowQueryLog(str(tmp_path / p.obs.__name__),
                                     capacity=2, threshold_s=1.0)
        os.rmdir(log.dir)
        with open(log.dir, "w") as f:
            f.write("not a directory")
        return log.record(_profile("q", 2.0)), log.entries(), \
            log.summary()["entries"]

    assert _both(script) == (None, [], 0)


# ------------------------------------------------------------ attribution
def test_ledger_context_var_and_anon():
    def script(p):
        led = p.attrib.ResourceLedger()
        assert p.attrib.current_client() is None
        with p.attrib.client_context("tenant-a"):
            assert p.attrib.current_client() == "tenant-a"
            led.add("staged_bytes", 100, scope="d:s")
            with p.attrib.client_context(None):  # keeps the outer one
                assert p.attrib.current_client() == "tenant-a"
        assert p.attrib.current_client() is None
        led.add("staged_bytes", 7, scope="d:s")
        led.add("requests", 1)
        return led.snapshot()

    snap = _both(script)
    assert snap == {"tenant-a": {"d:s": {"staged_bytes": 100}},
                    "anon": {"d:s": {"staged_bytes": 7},
                             "*": {"requests": 1}}}


def test_ledger_totals_and_reset():
    def script(p):
        led = p.attrib.ResourceLedger()
        led.add("chunks", 2, scope="d:a", client="t")
        led.add("chunks", 3, scope="d:b", client="t")
        led.add("chunks", 9, scope="d:a", client="other")
        totals = led.totals("t")
        led.reset()
        return totals, led.snapshot()

    assert _both(script) == ({"chunks": 5}, {})


def test_ledger_bounded_overflow_bucket():
    def script(p):
        led = p.attrib.ResourceLedger(max_keys=4)
        before = p.obs.REGISTRY.counter("attrib.overflow").value
        for i in range(10):
            led.add("m", 1, scope=f"d:s{i}", client="attacker")
        return led.snapshot(), \
            p.obs.REGISTRY.counter("attrib.overflow").value - before

    snap, overflowed = _both(script)
    assert sum(len(v) for v in snap.values()) == 5
    assert snap["overflow"]["*"]["m"] == 6 and overflowed == 6


def test_ledger_thread_safety_sums_exact():
    led = attrib.ResourceLedger()

    def work(cid):
        with attrib.client_context(cid):
            for _ in range(1000):
                led.add("n", 1, scope="d:s")

    ts = [threading.Thread(target=work, args=(f"c{i}",)) for i in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
        assert not t.is_alive()
    snap = led.snapshot()
    assert [snap[f"c{i}"]["d:s"]["n"] for i in range(8)] == [1000] * 8


def test_process_ledger_is_the_registry_attribution_section():
    obs.attrib.account("requests", 2, scope="d:x", client="reg-probe")
    try:
        snap = obs.REGISTRY.snapshot()["attribution"]
        assert snap["reg-probe"]["d:x"]["requests"] == 2
    finally:
        obs.attrib.LEDGER.reset()
