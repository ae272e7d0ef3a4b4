"""The port's lock-order witness (``netsdb_tpu_torch/utils/locks.py``)
against the reference's (``netsdb_tpu/utils/locks.py``): the counterparts
of ``tests/test_lock_witness.py``, each scripted acquisition sequence run
over both packages' locks with the reports held equal (edges, dropped
edges, acquisitions, suppressed read cycles, violation cycles), and the
witness armed around an in-process daemon with a follower, a pool with
a live session move and a streamed paged fold, where no cycle may show.

The reference's witness that ``tests/conftest.py`` installs for the
session is left alone: the port's locks are other classes and report to
the port's witness only."""

import threading

import numpy as np
import pytest

from netsdb_tpu.utils import locks as ref_locks
from netsdb_tpu_torch.utils import locks
from netsdb_tpu_torch.utils.locks import (LockOrderViolation, RWLock,
                                          TrackedLock, TrackedRLock,
                                          witness_scope)

PACKAGES = {"reference": ref_locks, "port": locks}


def _norm(rep):
    """The parts of a report that the same script must reproduce."""
    return {"edges": rep["edges"], "dropped_edges": rep["dropped_edges"],
            "acquisitions": rep["acquisitions"],
            "read_cycles_suppressed": rep["read_cycles_suppressed"],
            "cycles": [v["cycle"] for v in rep["violations"]]}


def _both(script, **scope):
    """Run ``script(locks_module)`` under a fresh witness of each package;
    the port's report, asserted equal to the reference's."""
    reps = {}
    for name, mod in PACKAGES.items():
        with mod.witness_scope(**scope) as w:
            script(mod)
            reps[name] = w.report()
    assert _norm(reps["port"]) == _norm(reps["reference"])
    return reps["port"]


def _in_thread(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join()


def test_two_thread_ab_ba_cycle_detected_and_sites_named():
    def script(L):
        a, b = L.TrackedLock("fixture.A"), L.TrackedLock("fixture.B")

        def order_ab():
            with a:
                with b:
                    pass

        def order_ba():
            with b:
                with a:
                    pass

        _in_thread(order_ab)
        _in_thread(order_ba)

    rep = _both(script)
    assert len(rep["violations"]) == 1
    v = rep["violations"][0]
    assert v["cycle"][0] == v["cycle"][-1]
    assert set(v["cycle"]) == {"fixture.A", "fixture.B"}
    assert all("test_torch_lock_witness.py" in site
               for site in v["sites"].values())
    assert any("test_torch_lock_witness.py" in site
               for site in v["reverse_sites"].values())


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_raise_mode_names_both_sites(pkg):
    L = PACKAGES[pkg]
    with L.witness_scope(raise_on_cycle=True):
        c, d = L.TrackedLock("fixture.C"), L.TrackedLock("fixture.D")
        with c:
            with d:
                pass
        with pytest.raises(L.LockOrderViolation) as ei:
            with d:
                with c:
                    pass
        msg = str(ei.value)
        assert "fixture.C" in msg and "fixture.D" in msg
        assert msg.count("test_torch_lock_witness.py") >= 2


def test_raise_mode_leaves_flagged_locks_usable():
    with witness_scope(raise_on_cycle=True):
        c, d = TrackedLock("fixture.U1"), TrackedLock("fixture.U2")
        with c:
            with d:
                pass
        with pytest.raises(LockOrderViolation):
            with d:
                with c:
                    pass
        assert not c.locked() and not d.locked()
        with c:
            pass

        store = TrackedRLock("fixture.U3")
        rw = RWLock(name="fixture.U4")
        with store:
            with rw.read():
                pass
        with pytest.raises(LockOrderViolation):
            with rw.write():
                with store:
                    pass
        assert not store.locked()
        with rw.write():  # the flagged RWLock is not wedged
            pass
        with rw.read():
            pass


def test_consistent_order_records_edges_no_violations():
    def script(L):
        a, b = L.TrackedLock("fixture.A"), L.TrackedLock("fixture.B")
        for _ in range(3):
            with a:
                with b:
                    pass

    rep = _both(script)
    assert rep["violations"] == []
    assert rep["edges"] == 1


def test_same_rank_reentrancy_records_no_self_edge():
    edges = {}

    def script(L):
        r = L.TrackedRLock("fixture.R")
        with r:
            with r:
                pass
        rw, rw2 = L.RWLock(), L.RWLock()
        with rw.read():
            with rw2.read():
                pass
        edges[L.__name__] = dict(L.witness().edges)

    rep = _both(script, raise_on_cycle=True)
    assert rep["violations"] == []
    for e in edges.values():
        assert ("fixture.R", "fixture.R") not in e
        assert ("RWLock", "RWLock") not in e


def test_read_read_rwlock_cycle_suppressed():
    def script(L):
        store = L.TrackedRLock("fixture.rrstore")
        rw = L.RWLock(name="fixture.rrlock")

        def ingest():
            with store:
                with rw.read():
                    pass

        def iterate_then_reenter():
            with rw.read():
                with store:
                    pass

        _in_thread(ingest)
        _in_thread(iterate_then_reenter)

    rep = _both(script, raise_on_cycle=True)
    assert rep["violations"] == []
    assert rep["read_cycles_suppressed"] == 1


def test_rwlock_participates_in_ordering():
    def script(L):
        store = L.TrackedRLock("fixture.store")
        rw = L.RWLock(name="fixture.rw")

        def good():
            with store:
                with rw.read():
                    pass

        def bad():
            with rw.write():
                with store:
                    pass

        _in_thread(good)
        _in_thread(bad)

    assert len(_both(script)["violations"]) == 1


def test_edge_registry_bounded():
    def script(L):
        outer = L.TrackedLock("fixture.outer")
        for k in range(10):
            with outer:
                with L.TrackedLock(f"fixture.i{k}"):
                    pass

    rep = _both(script, max_edges=4)
    assert rep["edges"] == 4
    assert rep["dropped_edges"] == 6


def test_tracked_primitives_behave_like_threading():
    lk = TrackedLock("fixture.plain")
    assert lk.acquire(blocking=False)
    assert lk.locked()
    assert not lk.acquire(blocking=False)
    lk.release()
    assert not lk.locked()
    rlk = TrackedRLock("fixture.re")
    with rlk:
        assert rlk.acquire(blocking=False)
        rlk.release()
        assert rlk.locked()
    assert not rlk.locked()


def test_disabled_witness_is_inert():
    prev = locks.witness()
    locks.disable_witness()
    try:
        a, b = TrackedLock("fixture.off.A"), TrackedLock("fixture.off.B")
        with a:
            with b:
                pass
        with b:
            with a:
                pass
        assert locks.witness() is None
    finally:
        locks._WITNESS = prev


def test_config_knob_enables_witness(tmp_path):
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.storage.store import SetStore

    prev = locks.witness()
    locks.disable_witness()
    try:
        SetStore(Configuration(root_dir=str(tmp_path / "off")))
        assert locks.witness() is None  # default stays off
        SetStore(Configuration(root_dir=str(tmp_path / "on"),
                               lock_witness=True))
        assert locks.witness() is not None
    finally:
        locks.disable_witness()
        locks._WITNESS = prev


def test_witness_exports_obs_metrics():
    from netsdb_tpu_torch.obs.metrics import registry

    with witness_scope() as w:
        a, b = TrackedLock("fixture.M1"), TrackedLock("fixture.M2")
        before = registry().counter("analysis.violations").value
        with a:
            with b:
                pass
        with b:
            with a:
                pass
        assert registry().counter("analysis.violations").value \
            == before + 1
        assert locks._witness_stats()["violations"] == 1
        assert registry().gauge("analysis.lock_edges").value \
            == w.report()["edges"]


def test_dump_and_export_edges_match_the_reference(tmp_path):
    import json

    def script(L):
        a, b = L.TrackedLock("fixture.D1"), L.TrackedLock("fixture.D2")
        rw = L.RWLock(name="fixture.D3")
        with a:
            with b:
                with rw.read():
                    pass

    got = {}
    for name, mod in PACKAGES.items():
        with mod.witness_scope() as w:
            script(mod)
            w.dump(str(tmp_path / f"{name}.json"))
            got[name] = ([(e["held"], e["acquired"], e["modes"])
                          for e in w.export_edges()],
                         json.loads((tmp_path / f"{name}.json").read_text()))
    assert got["port"][0] == got["reference"][0]
    for key in ("acquisitions", "dropped_edges", "violations"):
        assert got["port"][1][key] == got["reference"][1][key]
    assert len(got["port"][1]["edges"]) == 3


def test_daemon_pool_and_paged_fold_under_the_witness(tmp_path):
    """The witness in raise mode around the port's concurrent paths: a
    daemon built with ``lock_witness=True`` mirroring to a follower, a
    pool leader moving a live decode session between its workers, and a
    streamed fold over a paged set. Edges are recorded; no cycle."""
    from netsdb_tpu_torch.client import Client
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.models.decode import deploy_decode_model
    from netsdb_tpu_torch.serve.client import RemoteClient
    from netsdb_tpu_torch.serve.protocol import MsgType
    from netsdb_tpu_torch.serve.server import ServeController

    prev = locks.witness()
    daemons = []
    try:
        with witness_scope(raise_on_cycle=True) as w:
            def start(name, **kw):
                d = ServeController(Configuration(
                    root_dir=str(tmp_path / name), lock_witness=True),
                    port=0, device="cpu", heartbeat_interval_s=0.1,
                    heartbeat_timeout_s=0.5, heartbeat_misses=2, **kw)
                d.start()
                daemons.append(d)
                return d

            # the witness_scope's witness stays installed: enable_witness
            # keeps an installed one
            follower = start("f")
            lead = start("lead", followers=[follower.advertise_addr])
            c = RemoteClient(lead.advertise_addr, timeout=60.0)
            c.create_database("d")
            c.create_set("d", "rows")
            c.send_data("d", "rows", [{"k": i} for i in range(50)])
            assert len(list(follower.library.get_set_iterator(
                "d", "rows"))) == 50
            c.close()

            workers = [start(f"w{i}") for i in range(2)]
            pool = start("pool", workers=[x.advertise_addr
                                          for x in workers])
            pc = RemoteClient(pool.advertise_addr, timeout=60.0)
            deploy_decode_model(pc, "lm", kind="lstm", hidden=16, seed=0)
            h = pc.open_session("lm", kind="lstm")
            x = np.ones(16, np.float32)
            h.generate(x)
            dst = next(x_.advertise_addr for x_ in workers
                       if x_.advertise_addr != h.owner)
            pc._request(MsgType.SESSION_OPEN,
                        {"op": "move", "sid": h.sid, "to": dst})
            h.generate(x)
            assert h.steps == 2 and h.owner == dst
            h.close()
            pc.close()

            lc = Client(Configuration(root_dir=str(tmp_path / "paged"),
                                      page_size_bytes=4096,
                                      page_pool_bytes=16384),
                        device="cpu")
            lc.create_database("p")
            lc.create_set("p", "w", storage="paged")
            m = np.random.default_rng(0).standard_normal(
                (256, 32)).astype(np.float32)
            lc.send_matrix("p", "w", m)
            y = lc.paged_matmul("p", "w", np.ones((32, 4), np.float32))
            np.testing.assert_allclose(y.numpy(), m @ np.ones((32, 4)),
                                       rtol=1e-5, atol=1e-4)
            rep = w.report()
        assert rep["violations"] == []
        assert rep["edges"] > 0 and rep["acquisitions"] > 0
    finally:
        for d in daemons:
            d.shutdown()
        locks._WITNESS = prev
