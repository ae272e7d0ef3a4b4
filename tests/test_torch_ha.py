"""HA through the port's daemons — the cases of the reference's
``tests/test_serve_ha.py`` (the abort-closed link is in
``tests/test_torch_followers.py``), in this process with shrunk windows
(election 0.35 s, heartbeats 0.1 s): a leader kill promotes a follower
within the election window with no acknowledged write lost or doubled,
the succession ladder climbs twice, a deposed leader's straggler is
fenced (typed ``NotLeader`` naming both terms), a coalesce waiter's
token survives the failover (TOKEN_ALIAS), the handoff buffer drains
from its spill across a leader restart, and routed ingest into a sharded
pool survives a failover. Then the port's own: ``HAState`` decides as
the reference's on the same calls, and a deposed leader restarted on its
root steps down and refuses writes typed."""

import contextlib
import threading
import time

import pytest

from netsdb_tpu_torch import obs
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.serve import ha as ha_mod
from netsdb_tpu_torch.serve.client import RemoteClient, RetryPolicy
from netsdb_tpu_torch.serve.errors import NotLeader, NotLeaderError, \
    RetryableRemoteError
from netsdb_tpu_torch.serve.protocol import (CODEC_PICKLE, IDEMPOTENCY_KEY,
                                             MsgType)
from netsdb_tpu_torch.serve.server import ServeController
from netsdb_tpu_torch.storage.store import SetIdentifier
from netsdb_tpu_torch.workloads.serve_bench import scaleout_table

FAST = RetryPolicy(max_attempts=5, base_delay_s=0.01, max_delay_s=0.1)
#: rides out a full election window plus the NotLeader ping-pong
#: against the dead leader
FAILOVER = RetryPolicy(max_attempts=80, base_delay_s=0.05, max_delay_s=0.25)
ELECTION_S = 0.35
TIMEOUT = 30.0

_DAEMON_KW = dict(heartbeat_interval_s=0.1, heartbeat_timeout_s=0.5,
                  heartbeat_misses=2, mirror_ack_timeout_s=5.0,
                  resync_grace_s=2.0)


def _counter(name: str) -> int:
    return obs.REGISTRY.counter(name).value


def _wait_for(pred, timeout_s=15.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


def _content(ctl, db, s):
    return sorted(r["i"] for r in ctl.library.get_set_iterator(db, s))


def _local_rows(ctl, db, set_name) -> int:
    items = ctl.library.store.get_items(SetIdentifier(db, set_name))
    return sum(int(getattr(it, "num_rows", 0) or 0) for it in items)


def _controller(root, cfg=None, **kw):
    ctl = ServeController(Configuration(root_dir=str(root), **(cfg or {})),
                          port=0, device="cpu", **dict(_DAEMON_KW, **kw))
    ctl.start()
    return ctl


@contextlib.contextmanager
def ha_pool(tmp_path, n_followers=1, n_workers=0, arm=True,
            storage_kwargs=None, leader_kwargs=None):
    """A leader mirroring to ``n_followers`` followers, over
    ``n_workers`` shard workers, HA armed over [leader] + followers.
    Yields ``(leader, followers, workers)``; shutdown is idempotent, so a
    test may kill any of them."""
    daemons = []
    try:
        workers = [_controller(tmp_path / f"w{i}", storage_kwargs)
                   for i in range(n_workers)]
        daemons += workers
        followers = [_controller(tmp_path / f"f{i}", storage_kwargs)
                     for i in range(n_followers)]
        daemons += followers
        leader = _controller(
            tmp_path / "leader", storage_kwargs,
            followers=[f.advertise_addr for f in followers],
            workers=[w.advertise_addr for w in workers],
            **(leader_kwargs or {}))
        daemons.append(leader)
        if arm:
            peers = [leader.advertise_addr] + [f.advertise_addr
                                               for f in followers]
            for d in [leader] + followers:
                d.arm_ha(peers, election_timeout_s=ELECTION_S)
        yield leader, followers, workers
    finally:
        for d in daemons:
            d.shutdown()


def test_mirror_dropped_surfaces_in_collect_stats(tmp_path):
    with ha_pool(tmp_path, arm=False) as (leader, followers, _):
        c = RemoteClient(leader.advertise_addr, retry=FAST, timeout=TIMEOUT)
        mirror = c.collect_stats().get("mirror")
        assert isinstance(mirror, dict)
        assert mirror["mirror_dropped"] == _counter("serve.mirror_dropped")
        assert leader.follower_status()["mirror_dropped"] == \
            _counter("serve.mirror_dropped")
        c.close()


def _retrying(fn, deadline_s=30.0):
    deadline = time.monotonic() + deadline_s
    while True:
        try:
            return fn()
        except RetryableRemoteError:
            assert time.monotonic() < deadline
            time.sleep(0.05)


def test_leader_kill_mid_ingest_promotes_with_exact_totals(tmp_path):
    """The leader dies while a client streams table batches: the
    follower promotes (term 2), the client fails over, and every batch
    lands exactly once."""
    with ha_pool(tmp_path) as (leader, followers, _):
        follower = followers[0]
        c = RemoteClient(leader.advertise_addr,
                         failover=[follower.advertise_addr],
                         retry=FAILOVER, timeout=TIMEOUT)
        c.create_database("d")
        c.create_set("d", "t", type_name="table")
        batches, rows_each = 6, 1000
        done = []

        def ingest():
            for i in range(batches):
                _retrying(lambda: c.send_table(
                    "d", "t", scaleout_table(rows_each, seed=i),
                    append=True))
                done.append(i)

        promos0 = _counter("ha.promotions")
        t = threading.Thread(target=ingest)
        t.start()
        assert _wait_for(lambda: len(done) >= 2)
        leader.shutdown()  # the kill, mid-stream
        t.join(timeout=90)
        assert not t.is_alive() and len(done) == batches
        assert _wait_for(lambda: follower._ha.role == ha_mod.LEADER)
        assert follower._ha.term == 2
        assert _counter("ha.promotions") == promos0 + 1
        assert _local_rows(follower, "d", "t") == batches * rows_each
        assert c.ping()["ha"]["role"] == ha_mod.LEADER
        assert c.failovers >= 1
        c.close()


def test_double_failover_climbs_the_succession_ladder(tmp_path):
    """peers [L, F1, F2]: killing L promotes F1 (term 2) while F2 adopts
    it; killing F1 promotes F2 (term 3); every write lands once."""
    with ha_pool(tmp_path, n_followers=2) as (leader, followers, _):
        f1, f2 = followers
        c = RemoteClient(leader.advertise_addr,
                         failover=[f1.advertise_addr, f2.advertise_addr],
                         retry=FAILOVER, timeout=TIMEOUT)
        c.create_database("d")
        c.create_set("d", "s", type_name="object")

        def send_batch(base):
            _retrying(lambda: c.send_data(
                "d", "s", [{"i": base + k} for k in range(10)]))

        send_batch(0)
        leader.shutdown()
        assert _wait_for(lambda: f1._ha.role == ha_mod.LEADER)
        assert f1._ha.term == 2
        assert f2._ha.role == ha_mod.FOLLOWER
        send_batch(100)
        assert _wait_for(lambda: f2._ha.leader_addr == f1.advertise_addr)
        f1.shutdown()
        assert _wait_for(lambda: f2._ha.role == ha_mod.LEADER)
        assert f2._ha.term == 3
        send_batch(200)
        want = sorted(list(range(0, 10)) + list(range(100, 110))
                      + list(range(200, 210)))
        assert _content(f2, "d", "s") == want
        c.close()


def test_deposed_leader_straggler_is_fenced_not_applied(tmp_path):
    """The old leader, unaware it was deposed, mirrors a client write at
    its stale term: the new leader refuses it typed, naming both terms;
    it never applies there; the old leader steps down."""
    with ha_pool(tmp_path) as (leader, followers, _):
        follower = followers[0]
        c = RemoteClient(leader.advertise_addr, retry=FAST, timeout=TIMEOUT)
        c.create_database("d")
        c.create_set("d", "s", type_name="object")
        c.send_data("d", "s", [{"i": 1}])
        assert _content(follower, "d", "s") == [1]
        follower._promote_self()  # scripted, not raced
        assert follower._ha.role == ha_mod.LEADER
        assert follower._ha.term == 2
        assert leader._ha.role == ha_mod.LEADER  # the stale belief
        fenced0 = _counter("ha.stragglers_rejected")
        straggler = RemoteClient(leader.advertise_addr,
                                 retry=RetryPolicy(max_attempts=1),
                                 timeout=TIMEOUT)
        with pytest.raises(NotLeaderError) as ei:
            straggler.send_data("d", "s", [{"i": 2}])
        assert ei.value.retryable
        assert "term 1" in str(ei.value) and "term 2" in str(ei.value)
        assert _counter("ha.stragglers_rejected") == fenced0 + 1
        assert _content(follower, "d", "s") == [1]
        assert _wait_for(lambda: leader._ha.role == ha_mod.FOLLOWER)
        assert leader._ha.term == 2
        straggler.close()
        c.close()


def test_coalesce_waiter_token_survives_failover_no_reexecute(tmp_path):
    """A coalesce waiter's token is aliased on the follower to its
    flight's (TOKEN_ALIAS), so its retry against the promoted follower
    is answered from the cache instead of running the job again."""
    with ha_pool(tmp_path) as (leader, followers, _):
        follower = followers[0]
        calls = {"leader": 0, "follower": 0}
        gate = threading.Event()

        def stub_for(name, ctl):
            def stub(p):
                calls[name] += 1
                if name == "leader":
                    gate.wait(15)  # hold the flight open for the waiter
                return MsgType.OK, {"ran": name}
            ctl.handlers[MsgType.EXECUTE_COMPUTATIONS] = stub

        stub_for("leader", leader)
        stub_for("follower", follower)
        payload = {"job_name": "alias-regress", "sinks": ["stub"]}
        replies = {}

        def run(tag, token):
            cli = RemoteClient(leader.advertise_addr, retry=FAST,
                               timeout=TIMEOUT)
            try:
                replies[tag] = cli._request(
                    MsgType.EXECUTE_COMPUTATIONS,
                    dict(payload, **{IDEMPOTENCY_KEY: token}),
                    codec=CODEC_PICKLE)
            finally:
                cli.close()

        hits0 = _counter("sched.coalesce_hits")
        ta = threading.Thread(target=run, args=("A", "tok-flight"))
        ta.start()
        assert _wait_for(lambda: calls["leader"] == 1)
        tb = threading.Thread(target=run, args=("B", "tok-waiter"))
        tb.start()
        assert _wait_for(lambda: _counter("sched.coalesce_hits")
                         == hits0 + 1)
        gate.set()
        ta.join(timeout=30)
        tb.join(timeout=30)
        assert calls["leader"] == 1
        assert replies["A"] == replies["B"] == {"ran": "leader"}
        assert _wait_for(lambda: "tok-waiter" in follower._idem._done)
        leader.shutdown()
        assert _wait_for(lambda: follower._ha.role == ha_mod.LEADER)
        retry = RemoteClient(follower.advertise_addr, retry=FAST,
                             timeout=TIMEOUT)
        reply = retry._request(
            MsgType.EXECUTE_COMPUTATIONS,
            dict(payload, **{IDEMPOTENCY_KEY: "tok-waiter"}),
            codec=CODEC_PICKLE)
        assert reply == {"ran": "follower"}  # the mirrored flight's
        assert calls["follower"] == 1  # the mirror only, never re-run
        retry.close()


def test_handoff_buffer_replays_after_leader_restart(tmp_path):
    """``ha_mutlog``: ingest buffered for a degraded shard spills; the
    leader restarts (on another port) and drains exactly that batch to
    the readmitted shard."""
    kw = {"ha_mutlog": True}
    with ha_pool(tmp_path, n_followers=0, n_workers=1, arm=False,
                 storage_kwargs=kw,
                 leader_kwargs={"heartbeat_interval_s": 60.0}) \
            as (leader, _, workers):
        w0 = workers[0]
        w0_addr = w0.advertise_addr
        c = RemoteClient(leader.advertise_addr, timeout=TIMEOUT)
        c.create_database("d")
        c.create_set("d", "t", type_name="table", placement="range")
        c.send_table("d", "t", scaleout_table(3000))
        w0_rows = _local_rows(w0, "d", "t")
        assert w0_rows == 1500
        leader._evict_shard(w0_addr, "test eviction")
        c._placement_entry("d", "t", refresh=True)
        c.send_table("d", "t", scaleout_table(3000, seed=2), append=True)
        assert leader.shards.handoff_pending(w0_addr) == 1
        assert _local_rows(w0, "d", "t") == w0_rows
        c.close()
        leader.shutdown()

        drained0 = _counter("shard.handoff_drained")
        leader2 = _controller(tmp_path / "leader", kw, workers=[w0_addr],
                              heartbeat_interval_s=60.0)
        try:
            assert leader2.shards.handoff_pending(w0_addr) == 1
            assert leader2.shards.is_degraded(w0_addr)
            entry = leader2.placement.entry("d", "t")
            assert entry is not None
            assert leader2.advertise_addr in {sl["addr"]
                                              for sl in entry["slots"]}
            assert leader2._try_readmit_shard(w0_addr)
            assert _counter("shard.handoff_drained") == drained0 + 1
            assert leader2.shards.handoff_pending(w0_addr) == 0
            assert _local_rows(w0, "d", "t") == w0_rows + 1500
            assert leader2.shards.load_spill() == 0
        finally:
            leader2.shutdown()


def test_sharded_pool_failover_routed_ingest_exact_totals(tmp_path):
    """Leader, HA follower and 2 shard workers; the leader dies mid
    routed ingest: the follower promotes with the dead leader's slot
    rebound to itself, and every batch lands once over the pool."""
    with ha_pool(tmp_path, n_followers=1, n_workers=2) \
            as (leader, followers, workers):
        follower = followers[0]
        c = RemoteClient(leader.advertise_addr,
                         failover=[follower.advertise_addr],
                         retry=FAILOVER, timeout=TIMEOUT)
        c.create_database("d")
        c.create_set("d", "t", type_name="table", placement="range")
        assert _wait_for(lambda: (follower._ha.placement_wire() or {})
                         .get("sets", {}))
        batches, rows_each = 5, 3000
        done = []

        def ingest():
            for i in range(batches):
                _retrying(lambda: c.send_table(
                    "d", "t", scaleout_table(rows_each, seed=i),
                    append=True), deadline_s=40.0)
                done.append(i)

        t = threading.Thread(target=ingest)
        t.start()
        assert _wait_for(lambda: len(done) >= 1)
        leader.shutdown()
        t.join(timeout=120)
        assert not t.is_alive() and len(done) == batches
        assert _wait_for(lambda: follower._ha.role == ha_mod.LEADER)
        addrs = {sl["addr"] for sl in
                 follower.placement.entry("d", "t")["slots"]}
        assert leader.advertise_addr not in addrs
        assert follower.advertise_addr in addrs
        total = sum(_local_rows(d, "d", "t") for d in [follower] + workers)
        assert total == batches * rows_each
        c.close()


# --- the port's own ----------------------------------------------------

def test_ha_state_decides_as_the_reference(tmp_path):
    """The same calls on both packages' ``HAState``: roles, terms, the
    persisted term across a restart, adoption and the typed refusals."""
    from netsdb_tpu.serve import ha as ref_ha
    from netsdb_tpu.serve.errors import NotLeader as RefNotLeader

    peers = ["a:1", "b:2", "c:3"]

    def script(mod, exc, root):
        out = []
        b = mod.HAState("b:2", peers, state_dir=str(root))
        out.append((b.role, b.term, b.leader_addr, b.earlier_peers(),
                    b.later_peers()))
        for call in (lambda: b.check_client_write(),
                     lambda: b.observe_term(1),
                     lambda: b.observe_term(0)):
            try:
                call()
                out.append("ok")
            except exc as e:
                out.append(("refused", e.term, e.leader_addr))
        out.append(b.promote())
        out.append(b.snapshot())
        try:
            b.adopt_leader("a:1", 1)
            out.append("adopted")
        except exc as e:
            out.append(("refused", e.term, e.leader_addr))
        b.observe_term(5)
        out.append(b.snapshot())
        b2 = mod.HAState("b:2", peers, state_dir=str(root))  # a restart
        out.append(b2.snapshot())
        b2.adopt_leader("c:3", 5)
        b2.step_down(7, "c:3")
        out.append(b2.snapshot())
        with pytest.raises(ValueError):
            mod.HAState("z:9", peers)
        return out

    assert script(ha_mod, NotLeader, tmp_path / "port") == \
        script(ref_ha, RefNotLeader, tmp_path / "ref")


def test_restarted_deposed_leader_steps_down_and_refuses_writes(tmp_path):
    """A leader killed after a failover and restarted on its root (and
    port) with its followers and HA peers: it comes back at its
    persisted term 1 believing it leads; its first client write is
    fenced by the follower it mirrors to, so it steps down to term 2
    and the client gets a typed ``NotLeader`` naming the new leader and
    term 2 — and the write never reaches the new leader. A second write
    is refused before anything applies."""
    with ha_pool(tmp_path) as (leader, followers, _):
        follower = followers[0]
        peers = [leader.advertise_addr, follower.advertise_addr]
        port = leader.port
        c = RemoteClient(leader.advertise_addr, retry=FAST, timeout=TIMEOUT)
        c.create_database("d")
        c.close()
        leader.shutdown()
        assert _wait_for(lambda: follower._ha.role == ha_mod.LEADER)
        back = ServeController(
            Configuration(root_dir=str(tmp_path / "leader")), port=port,
            device="cpu", followers=[follower.advertise_addr],
            ha_peers=peers, **_DAEMON_KW)
        back.start()
        try:
            assert back._ha.term == 1 and back._ha.role == ha_mod.LEADER
            w = RemoteClient(back.advertise_addr,
                             retry=RetryPolicy(max_attempts=1),
                             timeout=TIMEOUT)
            for _ in range(2):
                with pytest.raises(NotLeaderError) as ei:
                    w.create_database("stale")
                assert ei.value.leader_addr == follower.advertise_addr
                assert ei.value.term == 2
            assert back._ha.role == ha_mod.FOLLOWER
            assert back._ha.term == 2
            assert "stale" not in follower.library.catalog.list_databases()
            w.close()
        finally:
            back.shutdown()


def test_cli_config_and_facade_take_the_replication_options(tmp_path,
                                                            monkeypatch):
    """``--followers``/``--ha-peers`` reach ``run_daemon``;
    ``Configuration.ha_election_timeout_s`` is the armed window unless
    ``arm_ha`` is given one; ``Client(address=, replicas=)`` hedges."""
    from netsdb_tpu_torch import Client
    from netsdb_tpu_torch.serve import server as server_mod

    seen = {}
    monkeypatch.setattr(server_mod, "run_daemon",
                        lambda cfg, **kw: seen.update(kw) or 0)
    assert server_mod.main(["--port", "0", "--device", "cpu",
                            "--followers", "a:1, b:2",
                            "--ha-peers", "x:1,a:1,b:2"]) == 0
    assert seen["followers"] == ["a:1", "b:2"]
    assert seen["ha_peers"] == ["x:1", "a:1", "b:2"]
    assert seen["workers"] is None
    ctl = ServeController(Configuration(root_dir=str(tmp_path / "d"),
                                        ha_election_timeout_s=0.5),
                          port=0, device="cpu")
    ctl.start()
    try:
        ctl.arm_ha([ctl.advertise_addr, "127.0.0.1:1"])
        assert ctl._ha_monitor.election_timeout_s == 0.5
        assert ctl._ha.role == ha_mod.LEADER and ctl._ha.term == 1
        c = Client(address=ctl.advertise_addr,
                   replicas=[ctl.advertise_addr])
        assert c._replicas == [ctl.advertise_addr]
        assert c.ping()["ha"]["role"] == ha_mod.LEADER
        c.close()
    finally:
        ctl.shutdown()
