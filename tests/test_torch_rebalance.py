"""Live shard rebalancing on the CPU: the port's counterparts of
``tests/test_rebalance.py``'s 10 tests, and the pinned formulas held
equal to the reference's.

The skew detector's formulas and the byte-bounded planner run in both
packages on the same snapshots (made from a numpy seed) and must agree
exactly. The live cases run over port pools in one process
(``device="cpu"``, the leader and its workers on ``port=0``): a pool
grown under an 80/20 read mix with zero failed requests and exact row
totals and checksums, the write seal and its TTL, a destination or a
source dying mid-move, a leader restarted mid-campaign, and the
advisor's commit or revert under a plain ``measure``. Every daemon is
shut down in ``finally``."""

import threading
import time

import numpy as np
import pytest

from netsdb_tpu.serve import placement as JPL
from netsdb_tpu.serve import rebalance as JRB
from netsdb_tpu_torch import obs
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.serve import placement as PL
from netsdb_tpu_torch.serve import rebalance as RB
from netsdb_tpu_torch.serve.client import (RemoteClient, RetryPolicy,
                                           ShardUnavailableError)
from netsdb_tpu_torch.serve.server import ServeController
from netsdb_tpu_torch.workloads.serve_bench import (_scale_rows,
                                                    scaleout_q01_sink,
                                                    scaleout_table)

from test_torch_scaleout import TIMEOUT, _local_rows, pool

pytestmark = pytest.mark.chaos


def _counter(name: str) -> int:
    return obs.REGISTRY.counter(name).value


def _checksum(t) -> int:
    return int(np.asarray(t["l_price"], dtype=np.int64).sum())


def _entry(ctl, db="d", s="hot"):
    e = ctl.placement.entry(db, s)
    assert e is not None
    return e


def _q01(c, tag):
    """The integer Q01 over the pool's hot and cold sets, as rows."""
    out = []
    for name in ("hot", "cold"):
        c.execute_computations(scaleout_q01_sink("d", lineitem_set=name),
                               job_name=f"q01-{tag}-{name}",
                               fetch_results=False)
        out.append(_scale_rows(c, "d", "scale_q01_out"))
    return out


def _remote(addr, **kw):
    return RemoteClient(addr, timeout=TIMEOUT, **kw)


def _worker(tmp_path, name, **kw):
    w = ServeController(Configuration(root_dir=str(tmp_path / name), **kw),
                        port=0, device="cpu")
    w.start()
    return w


# --- the pinned formulas, held to the reference's ------------------------

def _random_pool(seed: int):
    """A pool snapshot from a numpy seed: members, placement entries with
    live and handoff slots, an attribution snapshot and partition sizes,
    the same objects for both packages (the slot states are strings)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 6))
    members = [f"10.0.0.{i}:{8000 + i}" for i in range(n)]
    entries, sizes = {}, {}
    for k in range(int(rng.integers(1, 5))):
        owners = rng.permutation(members)[:int(rng.integers(1, n + 1))]
        slots = [{"addr": str(a),
                  "state": PL.HANDOFF if rng.random() < 0.15 else PL.LIVE}
                 for a in owners]
        entries[("d", f"s{k}")] = {"slots": slots}
        for a in owners:
            sizes[(str(a), f"d:s{k}")] = int(rng.integers(0, 1 << 20))
    snap = {}
    for c in ("anon", "client-a", "client-b"):
        snap[c] = {f"d:s{k}": {
            "requests": int(rng.integers(0, 50)),
            "executor.chunks": int(rng.integers(0, 80)),
            "staged_bytes": int(rng.integers(0, 8 << 20))}
            for k in range(len(entries)) if rng.random() < 0.8}
        snap[c]["*"] = {"requests": int(rng.integers(0, 100))}
    return members, entries, sizes, snap


@pytest.mark.parametrize("seed", range(6))
def test_pinned_formulas_equal_the_reference(seed):
    assert (RB.REQUEST_WEIGHT, RB.CHUNK_WEIGHT, RB.BYTE_WEIGHT,
            RB.MIN_WINDOW_HEAT, RB.SETTLE_RATIO, RB.SEAL_TTL_S,
            RB.MOVE_LOG, RB.HEAT_METRICS) == (
        JRB.REQUEST_WEIGHT, JRB.CHUNK_WEIGHT, JRB.BYTE_WEIGHT,
        JRB.MIN_WINDOW_HEAT, JRB.SETTLE_RATIO, JRB.SEAL_TTL_S,
        JRB.MOVE_LOG, JRB.HEAT_METRICS)
    assert (PL.LIVE, PL.HANDOFF) == (JPL.LIVE, JPL.HANDOFF)
    members, entries, sizes, snap = _random_pool(seed)
    heats = RB.set_heats(snap)
    assert heats == JRB.set_heats(snap)
    member_heat = RB.addr_heats(entries, heats, members)
    assert member_heat == JRB.addr_heats(entries, heats, members)
    assert RB.skew_ratio(member_heat) == JRB.skew_ratio(member_heat)
    for cap in (0, 1, 1 << 19, 1 << 22):
        assert RB.plan_moves(entries, heats, sizes, members, cap) == \
            JRB.plan_moves(entries, heats, sizes, members, cap)
    # no heat signal at all: both fall back to balancing slot counts
    assert RB.plan_moves(entries, {}, sizes, members, 0) == \
        JRB.plan_moves(entries, {}, sizes, members, 0)


@pytest.mark.parametrize("seed", range(3))
def test_skew_detector_equals_the_reference(seed):
    members, entries, _sizes, snap = _random_pool(seed)
    rng = np.random.default_rng(100 + seed)
    det = RB.SkewDetector(ratio=1.5, windows=2)
    jdet = JRB.SkewDetector(ratio=1.5, windows=2)
    cum = RB.set_heats(snap)
    for _ in range(8):
        cum = {s: v + float(rng.integers(0, 3)) * float(rng.random() * 40)
               for s, v in cum.items()}
        assert det.observe(cum, entries, members) == \
            jdet.observe(cum, entries, members)
        assert det.streak == jdet.streak


# --- the reference's formula units, on the port --------------------------

def test_set_heats_pinned_formula():
    snap = {
        "client-a": {
            "d:hot": {"requests": 4, "executor.chunks": 8,
                      "staged_bytes": 2 << 20},
            "*": {"requests": 100},  # unattributable: never placed
        },
        "client-b": {"d:hot": {"requests": 1},
                     "d:cold": {"staged_bytes": 1 << 20}},
    }
    heats = RB.set_heats(snap)
    assert heats["d:hot"] == pytest.approx(
        4 * RB.REQUEST_WEIGHT + 8 * RB.CHUNK_WEIGHT
        + (2 << 20) * RB.BYTE_WEIGHT + 1)
    assert heats["d:cold"] == pytest.approx(1.0)
    assert "*" not in heats


def test_addr_heats_live_only_and_fresh_member_zero():
    entries = {("d", "hot"): {"slots": [
        {"addr": "a:1", "state": PL.LIVE},
        {"addr": "b:2", "state": PL.LIVE},
        {"addr": "c:3", "state": PL.HANDOFF},  # degraded: no share
    ]}}
    out = RB.addr_heats(entries, {"d:hot": 9.0}, ["a:1", "b:2", "c:3", "d:4"])
    assert out == {"a:1": 3.0, "b:2": 3.0, "c:3": 0.0, "d:4": 0.0}
    assert RB.skew_ratio({}) == 1.0
    assert RB.skew_ratio({"a": 0.0, "b": 0.0}) == 1.0
    assert RB.skew_ratio(out) == pytest.approx(3.0 / 1.5)


def test_plan_moves_strict_improvement_and_byte_cap():
    members = ["a:1", "b:2", "c:3", "d:4", "e:5"]
    entries = {
        ("d", "hot"): {"slots": [
            {"addr": m, "state": PL.LIVE} for m in members[:4]]},
        ("d", "cold"): {"slots": [
            {"addr": m, "state": PL.LIVE} for m in members[:4]]},
    }
    heats = {"d:hot": 80.0, "d:cold": 8.0}
    sizes = {(m, "d:hot"): 1000 for m in members[:4]}
    plan = RB.plan_moves(entries, heats, sizes, members, 0)
    assert plan and plan[0]["set"] == "hot" and plan[0]["dst"] == "e:5"
    one = {("d", "hot"): entries[("d", "hot")]}
    assert RB.plan_moves(one, {"d:hot": 80.0}, sizes, members, 0) == []
    assert len(RB.plan_moves(entries, heats, sizes, members, 10)) == 1
    idle = RB.plan_moves(entries, {}, {}, members, 0)
    assert idle and idle[0]["dst"] == "e:5"


def test_plan_moves_respects_one_slot_per_member():
    members = ["a:1", "b:2"]
    entries = {("d", "t"): {"slots": [
        {"addr": "a:1", "state": PL.LIVE},
        {"addr": "b:2", "state": PL.LIVE}]}}
    assert RB.plan_moves(entries, {"d:t": 50.0},
                         {("a:1", "d:t"): 10}, members, 0) == []


def test_skew_detector_streak_and_idle_reset():
    members = ["a:1", "b:2"]
    entries = {("d", "t"): {"slots": [{"addr": "a:1", "state": PL.LIVE}]}}
    det = RB.SkewDetector(ratio=1.5, windows=2)
    ratio, sustained = det.observe({"d:t": 100.0}, entries, members)
    assert ratio == pytest.approx(2.0) and not sustained
    assert det.streak == 1
    # an idle window (delta below MIN_WINDOW_HEAT) resets the streak
    ratio, sustained = det.observe({"d:t": 101.0}, entries, members)
    assert not sustained and det.streak == 0
    cum = 101.0
    for _ in range(2):
        cum += 100.0
        ratio, sustained = det.observe({"d:t": cum}, entries, members)
    assert sustained and det.streak == 0


# --- seal and tombstone fencing ------------------------------------------

def test_seal_blocks_routed_writes_and_expires(tmp_path):
    with pool(tmp_path, n_workers=1) as (leader, workers, addr):
        c = _remote(addr, retry=RetryPolicy(max_attempts=1))
        try:
            c.create_database("d")
            c.create_set("d", "t", type_name="table", placement="range")
            c.send_table("d", "t", scaleout_table(200))
            for d in (leader, workers[0]):
                RB.handle_reshard(d, {"op": "seal", "db": "d", "set": "t"})
            assert RB.sealed(leader, "d", "t")
            with pytest.raises(ShardUnavailableError):
                c.send_table("d", "t", scaleout_table(100, seed=3),
                             append=True)
            # reads keep serving under the seal
            assert c.get_table_streamed("d", "t").num_rows == 200
            for d in (leader, workers[0]):
                RB.handle_reshard(d, {"op": "unseal", "db": "d", "set": "t"})
            assert not RB.sealed(leader, "d", "t")
            # a seal left by a dead leader heals itself: TTL expiry
            with leader._shard_mu:
                leader._reshard_seals[("d", "t")] = time.monotonic() + 0.05
            assert RB.sealed(leader, "d", "t")
            time.sleep(0.06)
            assert not RB.sealed(leader, "d", "t")
            c.send_table("d", "t", scaleout_table(100, seed=3), append=True)
            assert c.get_table_streamed("d", "t").num_rows == 300
        finally:
            c.close()


def test_seal_waits_for_a_write_past_its_placement_check(tmp_path):
    """A write that passed its placement check before the seal lands
    before the seal counts the source's rows: the move's tail then
    carries it, and a committed move can never drop an acknowledged
    batch. (Without the per-set write gate the seal answered the count
    without the in-flight batch, which landed after the tail was pulled
    and was dropped with the source.)"""
    d = ServeController(Configuration(root_dir=str(tmp_path / "w")),
                        port=0, device="cpu")
    try:
        d.library.create_database("d")
        d.library.create_set("d", "t", type_name="table")
        d.library.send_table("d", "t", scaleout_table(100))
        entered, release = threading.Event(), threading.Event()
        real = d.library.send_table

        def slow_send_table(*a, **kw):
            entered.set()  # past the placement check, mid-apply
            release.wait(30)
            return real(*a, **kw)

        d.library.send_table = slow_send_table
        writer = threading.Thread(target=d._on_send_data, args=(
            {"db": "d", "set": "t", "items": scaleout_table(40, seed=5),
             "as_table": True, "append": True},))
        writer.start()
        assert entered.wait(30)
        sealed = {}
        sealer = threading.Thread(target=lambda: sealed.update(
            RB.handle_reshard(d, {"op": "seal", "db": "d", "set": "t"})))
        sealer.start()
        time.sleep(0.2)
        assert sealer.is_alive(), "the seal did not wait for the write"
        release.set()
        writer.join(30)
        sealer.join(30)
        assert sealed["rows"] == 140
        assert RB.sealed(d, "d", "t")
    finally:
        release.set()
        d.shutdown()


# --- pool growth under live traffic --------------------------------------

def test_pool_growth_rebalances_with_zero_downtime(tmp_path):
    """Three daemons under a live 80/20 read mix; a fourth registers
    mid-run and the forced campaign moves slots onto it. Zero failed
    requests, the moved slot serves from its new owner, totals and
    checksums exact with the writes made after the campaign, and the
    integer Q01 over the pool byte-equal before and after."""
    kw = {"rebalance": True}
    hot = scaleout_table(20_000, seed=1)
    cold = scaleout_table(2_000, seed=2)
    with pool(tmp_path, n_workers=2, storage_kwargs=kw) \
            as (leader, workers, addr):
        c = _remote(addr)
        w3 = None
        try:
            c.create_database("d")
            c.create_set("d", "hot", type_name="table", placement="range")
            c.create_set("d", "cold", type_name="table", placement="range")
            c.send_table("d", "hot", hot)
            c.send_table("d", "cold", cold)
            q01_before = _q01(c, "before")
            epoch0 = leader.placement.to_wire()["epoch"]
            moves0 = _counter("rebalance.moves")
            stop = threading.Event()
            failures = []

            def load():
                lc = _remote(addr)
                n = 0
                try:
                    while not stop.is_set():
                        name = "hot" if n % 5 else "cold"
                        try:
                            t = lc.get_table_streamed("d", name)
                            want = 20_000 if name == "hot" else 2_000
                            if t.num_rows < want:
                                failures.append(f"{name} rows {t.num_rows}")
                        except Exception as e:  # noqa: BLE001 — any
                            failures.append(repr(e))  # escape fails it
                        n += 1
                finally:
                    lc.close()

            threads = [threading.Thread(target=load, daemon=True)
                       for _ in range(3)]
            for t in threads:
                t.start()
            time.sleep(0.3)
            w3 = _worker(tmp_path, "w3", **kw)
            res = c.add_worker(w3.advertise_addr)
            committed = [m for m in (res["moves"] or []) if m.get("ok")]
            assert committed, res
            # the integer Q01 over the pool is byte-equal after the campaign
            assert _q01(c, "after") == q01_before
            c.send_table("d", "hot", scaleout_table(1_000, seed=4),
                         append=True)
            time.sleep(0.3)
            stop.set()
            for t in threads:
                t.join(timeout=60)
            assert failures == [], failures[:5]
            owned = [sl for e in (_entry(leader, "d", m["set"])
                                  for m in committed)
                     for sl in e["slots"] if sl["addr"] == w3.advertise_addr]
            assert owned and all(sl["state"] == PL.LIVE for sl in owned)
            assert _local_rows(w3, "d", committed[0]["set"]) > 0
            assert leader.placement.to_wire()["epoch"] > epoch0
            assert _counter("rebalance.moves") >= moves0 + len(committed)
            back = c.get_table_streamed("d", "hot")
            assert back.num_rows == 21_000
            assert _checksum(back) == _checksum(hot) + _checksum(
                scaleout_table(1_000, seed=4))
            backc = c.get_table_streamed("d", "cold")
            assert backc.num_rows == 2_000
            assert _checksum(backc) == _checksum(cold)
            view = c.placement_view()
            assert view["status"]["moves"]
            assert any(m["addr"] == w3.advertise_addr and m["slots"] >= 1
                       for m in view["members"])
            assert c.rebalance_status()["moves"] == view["status"]["moves"]
        finally:
            if w3 is not None:
                w3.shutdown()
            c.close()


# --- a member dying mid-move ---------------------------------------------

def test_dst_death_mid_reshard_aborts_typed(tmp_path):
    kw = {"rebalance": True}
    hot = scaleout_table(8_000, seed=1)
    with pool(tmp_path, n_workers=2, storage_kwargs=kw) \
            as (leader, workers, addr):
        c = _remote(addr)
        try:
            c.create_database("d")
            c.create_set("d", "hot", type_name="table", placement="range")
            c.send_table("d", "hot", hot)
            w3 = _worker(tmp_path, "w3", **kw)
            w3_addr = w3.advertise_addr
            c.add_worker(w3_addr, campaign=False)
            w3.shutdown()  # dies between registration and the campaign
            aborts0 = _counter("rebalance.aborts")
            src = _entry(leader)["slots"][0]["addr"]
            res = leader.rebalancer.run_moves([{
                "db": "d", "set": "hot", "slot": 0,
                "src": src, "dst": w3_addr, "nbytes": 0}])
            assert len(res) == 1 and res[0]["ok"] is False
            assert res[0]["error"]
            assert _counter("rebalance.aborts") == aborts0 + 1
            assert _entry(leader)["slots"][0]["addr"] == src
            assert leader.shards.is_degraded(w3_addr)
            c.send_table("d", "hot", scaleout_table(1_000, seed=5),
                         append=True)
            back = c.get_table_streamed("d", "hot")
            assert back.num_rows == 9_000
            assert _checksum(back) == _checksum(hot) + _checksum(
                scaleout_table(1_000, seed=5))
        finally:
            c.close()


def test_src_death_mid_reshard_rolls_handoff(tmp_path):
    kw = {"rebalance": True}
    with pool(tmp_path, n_workers=2, storage_kwargs=kw) \
            as (leader, workers, addr):
        c = _remote(addr)
        w3 = _worker(tmp_path, "w3", **kw)
        try:
            c.create_database("d")
            c.create_set("d", "hot", type_name="table", placement="range")
            c.send_table("d", "hot", scaleout_table(8_000, seed=1))
            w3_addr = w3.advertise_addr
            c.add_worker(w3_addr, campaign=False)
            victim = workers[0]
            victim_addr = victim.advertise_addr
            slot = next(i for i, sl in enumerate(_entry(leader)["slots"])
                        if sl["addr"] == victim_addr)
            victim_rows = _local_rows(victim, "d", "hot")
            assert victim_rows > 0
            epoch0 = _entry(leader)["epoch"]
            aborts0 = _counter("rebalance.aborts")
            victim.shutdown()  # dies holding a live slot
            leader.shards.drop_client(victim_addr)
            res = leader.rebalancer.run_moves([{
                "db": "d", "set": "hot", "slot": slot,
                "src": victim_addr, "dst": w3_addr, "nbytes": 0}])
            assert res[0]["ok"] is False
            assert _counter("rebalance.aborts") == aborts0 + 1
            e = _entry(leader)
            assert e["epoch"] > epoch0
            assert e["slots"][slot]["addr"] == victim_addr
            assert e["slots"][slot]["state"] == PL.HANDOFF
            assert leader.shards.is_degraded(victim_addr)
            # nothing reached the destination: its prepare never ran
            assert not w3.library.set_exists("d", "hot")
            assert _local_rows(victim, "d", "hot") == victim_rows
        finally:
            w3.shutdown()
            c.close()


# --- a leader restarted mid-campaign -------------------------------------

def test_leader_restart_mid_campaign_reconciles(tmp_path):
    """A move commits (epoch bumped, map persisted) but the leader dies
    before the drop leg: the restarted leader reloads the post-move map
    and its prune reconcile retires the source's copy, tombstoned."""
    kw = {"ha_mutlog": True, "rebalance": True}
    daemons = []
    try:
        workers = [_worker(tmp_path, f"w{i}", **kw) for i in range(2)]
        daemons += workers
        leader = ServeController(
            Configuration(root_dir=str(tmp_path / "leader"), **kw),
            port=0, device="cpu",
            workers=[w.advertise_addr for w in workers])
        leader.start()
        daemons.append(leader)
        c = _remote(leader.advertise_addr)
        c.create_database("d")
        c.create_set("d", "hot", type_name="table", placement="range")
        c.send_table("d", "hot", scaleout_table(8_000, seed=1))
        w3 = _worker(tmp_path, "w3", **kw)
        daemons.append(w3)
        c.add_worker(w3.advertise_addr, campaign=False)
        c.close()

        real_op = leader.rebalancer._op

        def crashing_op(addr, payload):  # the drop leg never runs
            if payload.get("op") == "drop":
                return {}
            return real_op(addr, payload)

        leader.rebalancer._op = crashing_op
        victim = workers[0]
        slot = next(i for i, sl in enumerate(_entry(leader)["slots"])
                    if sl["addr"] == victim.advertise_addr)
        res = leader.rebalancer.run_moves([{
            "db": "d", "set": "hot", "slot": slot,
            "src": victim.advertise_addr, "dst": w3.advertise_addr,
            "nbytes": 0}])
        assert res[0]["ok"] is True
        moved_rows = _local_rows(w3, "d", "hot")
        assert moved_rows > 0
        assert _local_rows(victim, "d", "hot") == moved_rows
        leader.shutdown()

        leader2 = ServeController(
            Configuration(root_dir=str(tmp_path / "leader"), **kw),
            port=0, device="cpu",
            workers=[w.advertise_addr for w in workers]
            + [w3.advertise_addr])
        leader2.start()
        daemons.append(leader2)
        assert _entry(leader2)["slots"][slot]["addr"] == w3.advertise_addr
        assert _local_rows(victim, "d", "hot") == 0
        assert RB.tombstoned(victim, "d", "hot")
        assert _local_rows(w3, "d", "hot") == moved_rows
    finally:
        for d in daemons:
            d.shutdown()


# --- the advisor's commit or revert --------------------------------------

def test_advisor_commit_and_revert(tmp_path):
    """``Rebalancer.advise`` with a plain ``measure``: one that improves
    commits the campaign (``rebalance.advisor_commits`` ticks), one that
    regresses reverts every move to the pre-campaign ownership."""
    kw = {"rebalance": True}
    with pool(tmp_path, n_workers=2, storage_kwargs=kw) \
            as (leader, workers, addr):
        c = _remote(addr)
        w3 = _worker(tmp_path, "w3", **kw)
        try:
            c.create_database("d")
            c.create_set("d", "hot", type_name="table", placement="range")
            c.create_set("d", "cold", type_name="table", placement="range")
            c.send_table("d", "hot", scaleout_table(6_000, seed=1))
            c.send_table("d", "cold", scaleout_table(600, seed=2))
            w3_addr = w3.advertise_addr
            c.add_worker(w3_addr, campaign=False)
            commits0 = _counter("rebalance.advisor_commits")
            seq = iter([1.0, 2.0])  # after > before: commit
            out = leader.rebalancer.advise(lambda: next(seq))
            assert out["decision"] == "commit", out
            assert _counter("rebalance.advisor_commits") > commits0
            assert any(sl["addr"] == w3_addr
                       for sl in _entry(leader)["slots"])
            # revert: one concrete move, then a regressing measure
            e = _entry(leader, "d", "cold")
            slot_c, src_c = next(
                (i, sl["addr"]) for i, sl in enumerate(e["slots"])
                if sl["addr"] != w3_addr)
            plan = [{"db": "d", "set": "cold", "slot": slot_c,
                     "src": src_c, "dst": w3_addr, "nbytes": 0}]
            leader.rebalancer.check = \
                lambda force=False: leader.rebalancer.run_moves(plan)
            seq = iter([2.0, 1.0])
            out = leader.rebalancer.advise(lambda: next(seq))
            assert out["decision"] == "revert", out
            assert _entry(leader, "d", "cold")["slots"][slot_c]["addr"] \
                == src_c
            assert c.get_table_streamed("d", "hot").num_rows == 6_000
            assert c.get_table_streamed("d", "cold").num_rows == 600
        finally:
            w3.shutdown()
            c.close()


# --- pin auto-sizing on the feedback cadence ----------------------------

def test_pin_auto_sizes_the_device_cache_from_the_ledger(tmp_path):
    """``device_cache_pin_auto``: the daemon's pass sets the device
    cache's pin budget to ``feedback.pin_budget`` over the attribution
    ledger (marked ``pin_auto`` in the cache's stats, as the reference's
    cache marks it), and the scheduler runs it on its feedback cadence."""
    from netsdb_tpu.storage.devcache import DeviceBlockCache as JCache
    from netsdb_tpu_torch.serve.sched import feedback

    ctl = ServeController(Configuration(
        root_dir=str(tmp_path / "d"), device_cache_pin_auto=True,
        device_cache_bytes=8 << 20, sched_feedback_every=2),
        port=0, device="cpu")
    ctl.start()
    try:
        cache = ctl.library.store.device_cache()
        assert cache.stats()["pin_auto"] is False
        obs.attrib.account("staged_bytes", 6 << 20, scope="pin:hot",
                           client="pin-test")
        ctl._refresh_pin_auto()
        want = feedback.pin_budget(obs.attrib.LEDGER.snapshot(),
                                   cache.budget_bytes)
        st = cache.stats()
        assert st["pin_auto"] is True and st["pin_budget_bytes"] == want
        ref = JCache(8 << 20, partial=True)
        ref.set_pin_budget(want, auto=True)
        rst = ref.stats()
        assert (rst["pin_auto"], rst["pin_budget_bytes"]) == \
            (st["pin_auto"], st["pin_budget_bytes"])
        # the scheduler's cadence drives the same pass
        cache.set_pin_budget(0)
        assert cache.stats()["pin_auto"] is False
        c = _remote(ctl.advertise_addr)
        try:
            c.create_database("p")
            c.create_set("p", "t", type_name="table")
            c.send_table("p", "t", scaleout_table(64))
            for _ in range(4):
                c.execute_computations(scaleout_q01_sink(
                    "p", lineitem_set="t"), job_name="pin",
                    fetch_results=False)
        finally:
            c.close()
        deadline = time.monotonic() + 10
        while not cache.stats()["pin_auto"] and time.monotonic() < deadline:
            time.sleep(0.02)
        assert cache.stats()["pin_auto"] is True
    finally:
        ctl.shutdown()
