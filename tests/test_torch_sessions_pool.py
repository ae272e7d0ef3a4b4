"""Decode sessions on pool workers, on the CPU: the port's counterparts of
the pool cases of ``tests/test_sessions.py`` (its lines 421-693) — a
leader killed mid-decode, a worker that owns a session dying after its
state was pushed home, an oversized state layer, the shipped-weights
record dropped on a degrade, a retry under one token after a live move,
a promotion that must not rewind a worker-owned session, and a live move
under a running decode loop — plus the sid-hash placement held equal to
the reference's owner index and the live moves held bit-equal to a solo
session that never moved.

Every daemon listens on port 0 (``device="cpu"``) and is shut down in
``finally``; heartbeats are 0.1 s and the election window 0.35 s."""

import contextlib
import hashlib
import threading
import time

import numpy as np
import pytest

from netsdb_tpu.config import Configuration as JConfiguration
from netsdb_tpu.serve.server import ServeController as JServe
from netsdb_tpu_torch import obs
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.models import decode as decode_mod
from netsdb_tpu_torch.models.decode import deploy_decode_model
from netsdb_tpu_torch.serve import ha as ha_mod
from netsdb_tpu_torch.serve.client import RemoteClient, RetryPolicy
from netsdb_tpu_torch.serve.protocol import (CODEC_PICKLE, IDEMPOTENCY_KEY,
                                             MsgType)
from netsdb_tpu_torch.serve.server import ServeController

FAILOVER = RetryPolicy(max_attempts=80, base_delay_s=0.05, max_delay_s=0.25)
ELECTION_S = 0.35
TIMEOUT = 60.0
_DAEMON_KW = dict(heartbeat_interval_s=0.1, heartbeat_timeout_s=0.5,
                  heartbeat_misses=2, mirror_ack_timeout_s=5.0,
                  resync_grace_s=2.0)
HID = 64


def _counter(name):
    return obs.REGISTRY.counter(name).value


def _wait_for(pred, timeout_s=15.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


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


def _remote(addr, **kw):
    return RemoteClient(addr, timeout=TIMEOUT, **kw)


@contextlib.contextmanager
def _pool(tmp_path, n_workers=0, n_followers=0, arm=False, **cfg_kw):
    daemons = []
    try:
        def start(name, **kw):
            d = ServeController(
                Configuration(root_dir=str(tmp_path / name), **cfg_kw),
                port=0, device="cpu", **dict(_DAEMON_KW, **kw))
            d.start()
            daemons.append(d)
            return d

        workers = [start(f"w{i}") for i in range(n_workers)]
        followers = [start(f"f{i}") for i in range(n_followers)]
        leader = start("leader",
                       followers=[f.advertise_addr for f in followers],
                       workers=[w.advertise_addr for w in workers])
        if arm:
            peers = [leader.advertise_addr] + [f.advertise_addr
                                               for f in followers]
            for d in [leader] + followers:
                d.arm_ha(peers, election_timeout_s=ELECTION_S)
        yield leader, followers, workers
    finally:
        for d in daemons:
            d.shutdown()


# --- placement by sid hash, held to the reference's ----------------------

@pytest.mark.parametrize("n_live", [1, 2, 3, 5])
def test_sid_hash_owner_equals_the_reference(tmp_path, n_live):
    """Both packages' ``_pick_owner`` over the same live member list name
    the same owner for every sid (sha1 of the sid over the sorted live
    workers)."""
    rng = np.random.default_rng(n_live)
    live = [f"10.1.{int(rng.integers(0, 9))}.{i}:{7000 + i}"
            for i in range(n_live)]
    port = ServeController(Configuration(root_dir=str(tmp_path / "p")),
                           port=0, device="cpu", workers=list(live))
    ref = JServe(JConfiguration(root_dir=str(tmp_path / "r")), port=0,
                 workers=list(live))
    try:
        for k in range(64):
            sid = hashlib.md5(str(rng.integers(0, 1 << 30)).encode()) \
                .hexdigest()
            got = port.sessions._pick_owner(sid)
            assert got == ref.sessions._pick_owner(sid)
            h = int(hashlib.sha1(sid.encode()).hexdigest(), 16)
            assert got == sorted(live)[h % len(live)]
    finally:
        port.shutdown()
        ref.shutdown()


# --- the reference's pool cases ------------------------------------------

@pytest.mark.chaos
def test_leader_kill_mid_decode_resumes_exact_steps(tmp_path):
    with _pool(tmp_path, n_followers=1, arm=True) as (leader, followers, _):
        follower = followers[0]
        c = _remote(leader.advertise_addr,
                    failover=[follower.advertise_addr], retry=FAILOVER)
        try:
            deploy_decode_model(c, "m1", kind="lstm", hidden=HID, seed=13)
            h = c.open_session("m1", kind="lstm")
            xs = [_x(0, s) for s in range(10)]
            got, steps_seen = [], []
            done = threading.Event()

            def drive():
                for x in xs:
                    got.append(np.asarray(h.generate(x, deadline_s=60.0)))
                    steps_seen.append(h.steps)
                done.set()

            t = threading.Thread(target=drive)
            t.start()
            assert _wait_for(lambda: len(got) >= 2)
            leader.shutdown()  # kill mid-decode
            t.join(timeout=120)
            assert not t.is_alive() and done.is_set()
            assert _wait_for(lambda: follower._ha.role == ha_mod.LEADER)
            assert steps_seen == list(range(1, len(xs) + 1))
            assert follower.sessions.table.steps(h.sid) == len(xs)
            want = _solo_outputs(follower.library, "m1", "lstm", xs)
            for g, w in zip(got, want):
                assert g.tobytes() == w.tobytes()
        finally:
            c.close()


@pytest.mark.chaos
def test_owner_shard_death_revives_from_pushed_spill(tmp_path):
    with _pool(tmp_path, n_workers=1, session_ttl_s=0.4) \
            as (leader, _, workers):
        worker = workers[0]
        c = _remote(leader.advertise_addr, retry=FAILOVER)
        try:
            deploy_decode_model(c, "m1", kind="lstm", hidden=HID, seed=15)
            h = c.open_session("m1", kind="lstm")
            assert h.owner == worker.advertise_addr
            pre = 3
            xs = [_x(0, s) for s in range(pre + 3)]
            got = [np.asarray(h.generate(xs[s], deadline_s=60.0))
                   for s in range(pre)]
            # idle past the TTL: the worker spills, housekeeping pushes
            # the state home to the leader's arena
            assert _wait_for(
                lambda: leader.sessions.arena.steps(h.sid, "m1") == pre,
                timeout_s=20.0), leader.sessions.arena.stats()
            worker.shutdown()
            for s in range(pre, len(xs)):
                got.append(np.asarray(h.generate(xs[s], deadline_s=60.0)))
            assert h.steps == len(xs)
            assert h.owner == leader.advertise_addr
            assert h.moves >= 1
            assert leader.sessions.table.get(h.sid)["owner"] == \
                leader.advertise_addr
            want = _solo_outputs(leader.library, "m1", "lstm", xs)
            for g, w in zip(got, want):
                assert g.tobytes() == w.tobytes()
            h.close()
        finally:
            c.close()


def test_oversized_state_layer_on_a_worker_spills_not_lost(tmp_path):
    """A worker whose device cache cannot hold one state layer saves the
    advanced state to its arena each step (counted): the session keeps
    decoding bit-equal instead of losing its state."""
    with _pool(tmp_path, n_workers=1, device_cache_bytes=200) \
            as (leader, _, workers):
        c = _remote(leader.advertise_addr)
        try:
            deploy_decode_model(c, "m1", kind="lstm", hidden=HID, seed=19)
            spills0 = _counter("session.budget_spills")
            h = c.open_session("m1", kind="lstm")
            assert h.owner == workers[0].advertise_addr
            xs = [_x(0, s) for s in range(3)]
            got = [np.asarray(h.generate(x)) for x in xs]
            assert h.steps == 3
            assert _counter("session.budget_spills") > spills0
            assert workers[0].sessions.arena.steps(h.sid, "m1") == 3
            want = _solo_outputs(leader.library, "m1", "lstm", xs)
            for g, w in zip(got, want):
                assert g.tobytes() == w.tobytes()
            h.close()
        finally:
            c.close()


def test_degrade_invalidates_shipped_weights_record(tmp_path):
    with _pool(tmp_path, n_workers=1) as (leader, _, workers):
        worker = workers[0]
        c = _remote(leader.advertise_addr)
        try:
            deploy_decode_model(c, "m1", kind="lstm", hidden=HID, seed=23)
            h = c.open_session("m1", kind="lstm")
            assert h.owner == worker.advertise_addr
            with leader.sessions._shipped_mu:
                assert (worker.advertise_addr, "m1") in \
                    leader.sessions._shipped
            leader.shards.degrade(worker.advertise_addr, "test kill")
            with leader.sessions._shipped_mu:
                assert (worker.advertise_addr, "m1") not in \
                    leader.sessions._shipped
            h.close()
        finally:
            c.close()


@pytest.mark.chaos
def test_retry_same_token_after_live_move_never_double_applies(tmp_path):
    with _pool(tmp_path, n_workers=2) as (leader, _, workers):
        c = _remote(leader.advertise_addr)
        clients = [c]
        try:
            deploy_decode_model(c, "m1", kind="lstm", hidden=HID, seed=25)
            h = c.open_session("m1", kind="lstm")
            src = h.owner
            dst = next(w.advertise_addr for w in workers
                       if w.advertise_addr != src)
            xs = [_x(0, 0), _x(0, 1)]
            step1 = {"db": "m1", "set": h.sid, "sid": h.sid, "x": xs[0],
                     IDEMPOTENCY_KEY: "step-1-token-fixed"}
            cs = _remote(src)
            clients.append(cs)
            rep1 = cs._request(MsgType.GENERATE, dict(step1),
                               codec=CODEC_PICKLE)
            assert rep1["steps"] == 1
            # the reply is lost; the session moves live to dst
            c._request(MsgType.SESSION_OPEN,
                       {"op": "move", "sid": h.sid, "to": dst})
            cd = _remote(dst)
            clients.append(cd)
            rep2 = cd._request(MsgType.GENERATE, dict(step1),
                               codec=CODEC_PICKLE)
            assert rep2["steps"] == 1, \
                "retry under one token double-advanced the state"
            assert np.asarray(rep2["y"]).tobytes() == \
                np.asarray(rep1["y"]).tobytes()
            rep3 = cd._request(MsgType.GENERATE,
                               {"db": "m1", "set": h.sid, "sid": h.sid,
                                "x": xs[1],
                                IDEMPOTENCY_KEY: "step-2-token-fixed"},
                               codec=CODEC_PICKLE)
            assert rep3["steps"] == 2
            want = _solo_outputs(leader.library, "m1", "lstm", xs)
            assert np.asarray(rep1["y"]).tobytes() == want[0].tobytes()
            assert np.asarray(rep3["y"]).tobytes() == want[1].tobytes()
            h.close()
        finally:
            for cc in clients:
                cc.close()


@pytest.mark.chaos
def test_promotion_never_rewinds_worker_owned_session(tmp_path):
    with _pool(tmp_path, n_workers=1, n_followers=1, arm=True) \
            as (leader, followers, workers):
        worker, follower = workers[0], followers[0]
        c = _remote(leader.advertise_addr,
                    failover=[follower.advertise_addr], retry=FAILOVER)
        try:
            deploy_decode_model(c, "m1", kind="lstm", hidden=HID, seed=27)
            h = c.open_session("m1", kind="lstm")
            assert h.owner == worker.advertise_addr
            pre = 3
            xs = [_x(0, s) for s in range(pre + 3)]
            got = [np.asarray(h.generate(xs[s], deadline_s=60.0))
                   for s in range(pre)]
            # the worker's TTL expiry now: it spills and pushes home, and
            # the leader mirrors the merge to the follower
            worker.library.store.device_cache().session_sweep(
                now=time.monotonic() + 1e9)
            assert _wait_for(
                lambda: follower.sessions.arena.steps(h.sid, "m1") == pre,
                timeout_s=20.0), follower.sessions.arena.stats()
            # the follower still holds its replayed step-0 resident state
            assert follower.library.store.device_cache() \
                .session_entries() > 0
            worker.shutdown()
            leader.shutdown()
            assert _wait_for(lambda: follower._ha.role == ha_mod.LEADER,
                             timeout_s=30.0)
            for s in range(pre, len(xs)):
                got.append(np.asarray(h.generate(xs[s], deadline_s=60.0)))
            # the steps continue from the pushed spill: no rewind
            assert h.steps == len(xs)
            assert follower.sessions.table.steps(h.sid) == len(xs)
            want = _solo_outputs(follower.library, "m1", "lstm", xs)
            for g, w in zip(got, want):
                assert g.tobytes() == w.tobytes()
        finally:
            c.close()


@pytest.mark.chaos
@pytest.mark.parametrize("kind", ["lstm", "transformer_layer"])
def test_live_session_move_zero_failed_requests(tmp_path, kind):
    """A live session moves between pool members while a decode loop
    drives it: in-flight steps bounce with the typed retryable
    SessionMoved and land at the target — zero failed requests, steps
    sequential, every output bit-equal to a solo session that never
    moved."""
    with _pool(tmp_path, n_workers=2) as (leader, _, workers):
        c = _remote(leader.advertise_addr, retry=FAILOVER)
        try:
            deploy_decode_model(c, "m1", kind=kind, hidden=HID, seed=17)
            h = c.open_session("m1", kind=kind)
            src = h.owner
            dst = next(w.advertise_addr for w in workers
                       if w.advertise_addr != src)
            xs = [_x(0, s) for s in range(12)]
            got, errors = [], []
            moved = threading.Event()

            def drive():
                try:
                    for s, x in enumerate(xs):
                        got.append(np.asarray(h.generate(x,
                                                         deadline_s=60.0)))
                        if s == 3:
                            moved.set()
                except Exception as e:  # noqa: BLE001 — the gate: none
                    errors.append(e)

            t = threading.Thread(target=drive)
            t.start()
            assert moved.wait(30)
            c._request(MsgType.SESSION_OPEN,
                       {"op": "move", "sid": h.sid, "to": dst})
            t.join(timeout=120)
            assert not t.is_alive()
            assert errors == [], errors
            assert len(got) == len(xs) and h.steps == len(xs)
            assert h.owner == dst
            want = _solo_outputs(leader.library, "m1", kind, xs)
            for g, w in zip(got, want):
                assert g.tobytes() == w.tobytes()
            h.close()
        finally:
            c.close()
