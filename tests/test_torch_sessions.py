"""Decode sessions through the port's daemon, on the CPU — the one-daemon
cases of the reference's ``tests/test_sessions.py``: the batcher, open /
generate / close with its counters, byte equality of batched and solo
runs with one step program, no arena read on warm steps, TTL expiry
under pressure, two fine-tuned models sharing pages exactly, and an
oversized state layer spilling without loss. The batcher cases run
through both packages' ``DecodeBatcher``. Sessions on pool workers and
live moves are ``tests/test_torch_sessions_pool.py``'s. Every daemon
listens on port 0 and is shut down in ``finally``; every wait is
bounded."""

import contextlib
import threading
import time

import numpy as np
import pytest

from netsdb_tpu_torch import obs
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.models import decode as decode_mod
from netsdb_tpu_torch.models.decode import deploy_decode_model
from netsdb_tpu_torch.serve.client import (RemoteClient, RemoteError,
                                           SessionUnknownError)
from netsdb_tpu_torch.serve.protocol import (CODEC_PICKLE, IDEMPOTENCY_KEY,
                                             MsgType)
from netsdb_tpu_torch.serve.server import ServeController

HID = 64
TIMEOUT = 60.0


def _counter(name):
    return obs.REGISTRY.counter(name).value


def _gauge(name):
    return obs.REGISTRY.gauge(name).value


def _x(i, step):
    return np.random.default_rng(1000 * i + step).standard_normal(
        HID).astype(np.float32)


def _solo_outputs(library, db, kind, xs):
    """The unbatched twin: a fresh runtime, one session, the same xs."""
    rt = decode_mod.DecodeRuntime(library)
    rt.register_model(db, kind)
    st = rt.init_state(db)
    outs = []
    for x in xs:
        new, ys = rt.step_batch(db, [st], [x])
        st = new[0]
        outs.append(np.asarray(ys[0]))
    return outs


@contextlib.contextmanager
def _daemon(tmp_path, **cfg_kw):
    ctl = ServeController(Configuration(root_dir=str(tmp_path / "d0"),
                                        **cfg_kw), port=0, device="cpu")
    ctl.start()
    try:
        yield ctl
    finally:
        ctl.shutdown()


def _remote(ctl):
    return RemoteClient(ctl.advertise_addr, timeout=TIMEOUT)


# --- DecodeBatcher (no daemon), both packages ---------------------------

@pytest.fixture(params=["ref", "port"])
def batcher_cls(request):
    if request.param == "ref":
        from netsdb_tpu.serve.sched.sessions import DecodeBatcher
    else:
        from netsdb_tpu_torch.serve.sched.sessions import DecodeBatcher
    return DecodeBatcher


def test_batcher_coalesces_concurrent_sessions(batcher_cls):
    def run(db, reqs):
        time.sleep(0.005)
        return [r * 10 for r in reqs]

    b = batcher_cls(run, max_batch=8, window_s=0.05)
    results = {}
    barrier = threading.Barrier(4)

    def worker(i):
        barrier.wait()
        results[i] = b.submit("m", f"s{i}", i)

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10)
    assert results == {i: i * 10 for i in range(4)}
    snap = b.snapshot()
    assert snap["coalesced"] == 4 and snap["pending"] == 0
    assert snap["max_occupancy"] >= 2


def test_batcher_never_double_steps_one_session(batcher_cls):
    sizes = []

    def run(db, reqs):
        sizes.append(len(reqs))
        time.sleep(0.005)
        return list(reqs)

    b = batcher_cls(run, max_batch=8, window_s=0.03)
    barrier = threading.Barrier(2)
    done = []

    def worker(v):
        barrier.wait()
        done.append(b.submit("m", "same-sid", v))

    ts = [threading.Thread(target=worker, args=(v,)) for v in (1, 2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10)
    assert sorted(done) == [1, 2]
    assert sizes == [1, 1]


def test_batcher_failure_fans_out_typed(batcher_cls):
    def run(db, reqs):
        raise RuntimeError("device fault")

    b = batcher_cls(run, max_batch=4, window_s=0.001)
    with pytest.raises(RuntimeError, match="device fault"):
        b.submit("m", "s1", 1)
    assert b.snapshot()["pending"] == 0


def test_batcher_leader_handoff_no_lost_wakeup(batcher_cls):
    release, first_running = threading.Event(), threading.Event()

    def run(db, reqs):
        first_running.set()
        release.wait(5)
        return list(reqs)

    b = batcher_cls(run, max_batch=1, window_s=0.001)
    out = {}

    def submit(sid):
        out[sid] = b.submit("m", sid, sid)

    t1 = threading.Thread(target=submit, args=("a",))
    t1.start()
    assert first_running.wait(5)
    t2 = threading.Thread(target=submit, args=("b",))
    t2.start()
    time.sleep(0.02)
    release.set()
    t1.join(timeout=10)
    t2.join(timeout=10)
    assert not t1.is_alive() and not t2.is_alive()
    assert out == {"a": "a", "b": "b"}


# --- one daemon: open / generate / close --------------------------------

def test_open_generate_close_counters_and_solo_byte_equality(tmp_path):
    with _daemon(tmp_path) as ctl:
        c = _remote(ctl)
        try:
            deploy_decode_model(c, "m1", kind="lstm", hidden=HID, seed=3)
            opened0 = _counter("session.opened")
            closed0 = _counter("session.closed")
            steps0 = _counter("session.decode_steps")
            h = c.open_session("m1", kind="lstm")
            assert h.spec == {"kind": "lstm", "hidden": HID, "heads": 4,
                              "kv_max": 64}
            xs = [_x(0, s) for s in range(5)]
            got = [h.generate(x) for x in xs]
            assert h.steps == 5
            want = _solo_outputs(ctl.library, "m1", "lstm", xs)
            for g, w in zip(got, want):
                assert np.asarray(g).tobytes() == w.tobytes()
            assert _counter("session.opened") == opened0 + 1
            assert _counter("session.decode_steps") == steps0 + 5
            assert _gauge("session.resident_bytes") > 0
            stats = c.collect_stats()["sessions"]
            assert stats["open"] == 1 and stats["sessions"][0]["steps"] == 5
            assert h.close()
            assert _counter("session.closed") == closed0 + 1
            assert ctl.sessions.table.count() == 0
            with pytest.raises(SessionUnknownError):
                c._request(MsgType.GENERATE,
                           {"db": "m1", "set": h.sid, "sid": h.sid,
                            "x": xs[0]}, codec=CODEC_PICKLE)
        finally:
            c.close()


def test_retried_step_is_not_applied_twice(tmp_path):
    """A step retried under its idempotency token replays the first
    reply: the state advances once."""
    with _daemon(tmp_path) as ctl:
        c = _remote(ctl)
        try:
            deploy_decode_model(c, "m1", kind="lstm", hidden=HID, seed=8)
            h = c.open_session("m1", kind="lstm")
            step = {"db": "m1", "set": h.sid, "sid": h.sid, "x": _x(0, 0),
                    IDEMPOTENCY_KEY: "step-1"}
            r1 = c._request(MsgType.GENERATE, dict(step), codec=CODEC_PICKLE)
            r2 = c._request(MsgType.GENERATE, dict(step), codec=CODEC_PICKLE)
            assert r1["steps"] == r2["steps"] == 1
            assert np.asarray(r1["y"]).tobytes() == \
                np.asarray(r2["y"]).tobytes()
            assert ctl.sessions.table.steps(h.sid) == 1
            h.close()
        finally:
            c.close()


@pytest.mark.parametrize("kind,steps", [("lstm", 4),
                                        ("transformer_layer", 70)])
def test_concurrent_sessions_one_program_byte_equal(tmp_path, kind, steps):
    """8 concurrent sessions on one model: batches coalesce, the run
    builds one step program (1..8 rows share bucket 8), and every
    session's stream is byte-equal to its solo twin (the layer's ring
    of 64 wraps once)."""
    decode_mod.clear_decode_programs()
    with _daemon(tmp_path) as ctl:
        c = _remote(ctl)
        clients = []
        try:
            deploy_decode_model(c, "m1", kind=kind, hidden=HID, seed=5)
            n_sessions = 8
            clients = [_remote(ctl) for _ in range(n_sessions)]
            handles = [clients[i].open_session("m1", kind=kind)
                       for i in range(n_sessions)]
            outs = {i: [] for i in range(n_sessions)}
            errors = []
            barrier = threading.Barrier(n_sessions)

            def drive(i):
                try:
                    barrier.wait()
                    for s in range(steps):
                        outs[i].append(np.asarray(
                            handles[i].generate(_x(i, s))))
                except Exception as e:  # noqa: BLE001 — surfaced below
                    errors.append((i, e))

            ts = [threading.Thread(target=drive, args=(i,))
                  for i in range(n_sessions)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=120)
            assert errors == []
            assert decode_mod.decode_stats()["traces"] == 1
            assert ctl.sessions.batcher.snapshot()["max_occupancy"] >= 2
            for i in range(n_sessions):
                want = _solo_outputs(ctl.library, "m1", kind,
                                     [_x(i, s) for s in range(steps)])
                for g, w in zip(outs[i], want):
                    assert g.tobytes() == w.tobytes()
            assert decode_mod.decode_stats()["traces"] == 1
            for h in handles:
                assert h.close()
        finally:
            for cc in clients:
                cc.close()
            c.close()


def test_warm_decode_steps_never_read_the_arena(tmp_path):
    with _daemon(tmp_path) as ctl:
        c = _remote(ctl)
        try:
            deploy_decode_model(c, "m1", kind="lstm", hidden=HID, seed=7)
            h = c.open_session("m1", kind="lstm")
            for s in range(6):
                h.generate(_x(0, s))
            assert ctl.sessions.arena.stats()["reads"] == 0
            h.close()
        finally:
            c.close()


def test_ttl_expiry_under_pressure_races_live_decode(tmp_path):
    """Shrunk TTL and a tiny device-cache budget: the state expires and
    thrashes out between steps of a live decode loop. Every eviction
    spills to the arena, every next step revives, and the outputs stay
    byte-equal to the solo run that never lost residency."""
    with _daemon(tmp_path, session_ttl_s=0.25,
                 device_cache_bytes=4096) as ctl:
        c = _remote(ctl)
        try:
            deploy_decode_model(c, "m1", kind="lstm", hidden=HID, seed=11)
            evicted0 = _counter("session.evicted")
            h = c.open_session("m1", kind="lstm")
            xs = [_x(0, s) for s in range(4)]
            got = []
            for x in xs:
                got.append(np.asarray(h.generate(x)))
                time.sleep(0.45)  # outlive the TTL between steps
            assert ctl.sessions.arena.stats()["reads"] > 0
            assert _counter("session.evicted") > evicted0
            want = _solo_outputs(ctl.library, "m1", "lstm", xs)
            for g, w in zip(got, want):
                assert g.tobytes() == w.tobytes()
            assert h.steps == len(xs)
            h.close()
        finally:
            c.close()


def test_dedup_two_finetuned_models_share_pages_exactly(tmp_path):
    with _daemon(tmp_path, model_dedup=True) as ctl:
        c = _remote(ctl)
        try:
            deploy_decode_model(c, "ma", kind="lstm", hidden=HID,
                                seed=21, base_seed=77, finetune_frac=0.25)
            deploy_decode_model(c, "mb", kind="lstm", hidden=HID,
                                seed=22, base_seed=77, finetune_frac=0.25)
            ha = c.open_session("ma", kind="lstm")
            hb = c.open_session("mb", kind="lstm")
            rep = ctl.sessions.runtime.residency_report()
            assert rep["models"] == 2
            unique = rep["unique_page_bytes"]
            assert unique < 0.8 * rep["total_page_bytes"], rep
            assert abs(sum(rep["charged_by_model"].values()) - unique) \
                <= len(rep["charged_by_model"])
            assert _gauge("dedup.page_bytes") == unique
            assert c.collect_stats()["sessions"]["residency"][
                "unique_page_bytes"] == unique
            ya = np.asarray(ha.generate(_x(0, 0)))
            yb = np.asarray(hb.generate(_x(0, 0)))
            assert ya.tobytes() != yb.tobytes()
            ha.close()
            hb.close()
        finally:
            c.close()


def test_oversized_state_layer_spills_to_arena_not_lost(tmp_path):
    with _daemon(tmp_path, device_cache_bytes=200) as ctl:
        c = _remote(ctl)
        try:
            deploy_decode_model(c, "m1", kind="lstm", hidden=HID, seed=19)
            spills0 = _counter("session.budget_spills")
            h = c.open_session("m1", kind="lstm")
            xs = [_x(0, s) for s in range(3)]
            got = [np.asarray(h.generate(x)) for x in xs]
            assert h.steps == 3
            assert _counter("session.budget_spills") > spills0
            assert ctl.sessions.arena.steps(h.sid, "m1") == 3
            want = _solo_outputs(ctl.library, "m1", "lstm", xs)
            for g, w in zip(got, want):
                assert g.tobytes() == w.tobytes()
            h.close()
        finally:
            c.close()


def test_oversized_session_state_and_pool_ops_are_refused(tmp_path):
    """An oversized state is refused; the pool ops, ported with sessions
    on workers, answer on one daemon: ``move``/``handoff`` of an unknown
    session raise ``SessionUnknown``, ``spill`` merges state into the
    arena, ``adopt`` takes a session over, and ``forget_owner`` drops the
    shipped-weights record of a member."""
    with _daemon(tmp_path, session_state_bytes=256) as ctl:
        c = _remote(ctl)
        try:
            deploy_decode_model(c, "m1", kind="lstm", hidden=HID, seed=1)
            with pytest.raises(RemoteError, match="session_state_bytes"):
                c.open_session("m1", kind="lstm")
            for op in ("move", "handoff"):
                with pytest.raises(SessionUnknownError, match="unknown"):
                    c._request(MsgType.SESSION_OPEN,
                               {"op": op, "sid": "s", "db": "m1",
                                "to": ctl.advertise_addr})
            rep = c._request(MsgType.SESSION_OPEN,
                             {"op": "spill", "sid": "s", "db": "m1",
                              "state": {"layers": {}, "steps": 2}},
                             codec=CODEC_PICKLE)
            assert rep["steps"] == 2
            rep = c._request(MsgType.SESSION_OPEN,
                             {"op": "adopt", "sid": "s2", "db": "m1",
                              "kind": "lstm"}, codec=CODEC_PICKLE)
            assert rep == {"sid": "s2", "owner": ctl.advertise_addr,
                           "steps": 0}
            with ctl.sessions._shipped_mu:
                ctl.sessions._shipped.add(("127.0.0.1:1", "m1"))
            ctl.sessions.forget_owner("127.0.0.1:1")
            assert not ctl.sessions._shipped
        finally:
            c.close()
