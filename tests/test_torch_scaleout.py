"""The shard pool on the CPU: the port's counterparts of
``tests/test_scaleout.py``'s 21 tests, each pool a leader and 2 workers
in one process (``device="cpu"``), and the port's results held against a
solo port daemon and against the reference's pool on the same data —
the integer Q01 and the shuffle join byte for byte, the float Q01 with
ints exact and floats within rtol 1e-5, group partials equal.

Every daemon listens on port 0 and is shut down in ``finally``; every
client has a socket timeout and every wait is bounded."""

import contextlib
import threading

import numpy as np
import pytest
import torch

from netsdb_tpu.config import Configuration as JConfiguration
from netsdb_tpu.relational.table import ColumnTable as JTable
from netsdb_tpu.serve.client import RemoteClient as JRemote
from netsdb_tpu.serve.server import ServeController as JServe
from netsdb_tpu.workloads import serve_bench as jsb
from netsdb_tpu_torch import obs
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.relational.table import ColumnTable
from netsdb_tpu_torch.serve import placement as PL
from netsdb_tpu_torch.serve import shard as SH
from netsdb_tpu_torch.serve.client import (PlacementStaleError,
                                           RemoteClient, RetryPolicy,
                                           ShardUnavailableError)
from netsdb_tpu_torch.serve.errors import PlacementStale, RemoteError
from netsdb_tpu_torch.serve.protocol import (CODEC_PICKLE, IDEMPOTENCY_KEY,
                                             PLACEMENT_EPOCH_KEY,
                                             SHARD_SLOT_KEY, MsgType)
from netsdb_tpu_torch.serve.server import ServeController
from netsdb_tpu_torch.storage.store import SetIdentifier
from netsdb_tpu_torch.workloads.serve_bench import (_scale_rows,
                                                    scaleout_join_sink,
                                                    scaleout_q01_sink,
                                                    scaleout_table)

TIMEOUT = 60.0
PAGED = {"page_size_bytes": 64 * 1024}


def _counter(name: str) -> int:
    return obs.REGISTRY.counter(name).value


@contextlib.contextmanager
def pool(tmp_path, n_workers=2, leader_kwargs=None, storage_kwargs=None,
         tag="p"):
    """A port leader and ``n_workers`` shard workers in this process;
    yields (leader, workers, leader address)."""
    daemons = []
    try:
        workers = []
        for i in range(n_workers):
            w = ServeController(
                Configuration(root_dir=str(tmp_path / f"{tag}w{i}"),
                              **(storage_kwargs or {})),
                port=0, device="cpu")
            w.start()
            daemons.append(w)
            workers.append(w)
        leader = ServeController(
            Configuration(root_dir=str(tmp_path / f"{tag}leader"),
                          **(storage_kwargs or {})),
            port=0, device="cpu", workers=[w.advertise_addr for w in workers],
            **(leader_kwargs or {}))
        leader.start()
        daemons.append(leader)
        yield leader, workers, leader.advertise_addr
    finally:
        for d in daemons:
            d.shutdown()


@contextlib.contextmanager
def solo(tmp_path, name="solo", storage_kwargs=None):
    ctl = ServeController(Configuration(root_dir=str(tmp_path / name),
                                        **(storage_kwargs or {})),
                          port=0, device="cpu")
    ctl.start()
    try:
        yield ctl, ctl.advertise_addr
    finally:
        ctl.shutdown()


@contextlib.contextmanager
def ref_pool(tmp_path, n_workers=2, storage_kwargs=None):
    """The reference's pool of the same shape (its own tests' fixture)."""
    daemons = []
    try:
        workers = []
        for i in range(n_workers):
            w = JServe(JConfiguration(root_dir=str(tmp_path / f"rw{i}"),
                                      **(storage_kwargs or {})), port=0)
            w.start()
            daemons.append(w)
            workers.append(w)
        leader = JServe(JConfiguration(root_dir=str(tmp_path / "rleader"),
                                       **(storage_kwargs or {})), port=0,
                        workers=[f"127.0.0.1:{w.port}" for w in workers])
        leader.start()
        daemons.append(leader)
        yield f"127.0.0.1:{leader.port}"
    finally:
        for d in daemons:
            d.shutdown()


def _remote(addr, **kw):
    return RemoteClient(addr, timeout=TIMEOUT, **kw)


def _local_rows(ctl, db, set_name) -> int:
    return sum(int(getattr(it, "num_rows", 0) or 0)
               for it in ctl.library.store.get_items(
                   SetIdentifier(db, set_name)))


def _jtable(t: ColumnTable) -> JTable:
    return JTable({k: v.numpy() for k, v in t.cols.items()}, dict(t.dicts),
                  None)


# --- placement map and routing ------------------------------------------

def test_placement_map_basics():
    m = PL.PlacementMap()
    e = m.create("d", "t", ["a:1", "b:2", "c:3"], mode="hash", key="k")
    assert e["epoch"] == 1 and len(e["slots"]) == 3
    assert m.entry("d", "t")["mode"] == "hash"
    assert m.degrade_addr("b:2") == [("d", "t")]
    e2 = m.entry("d", "t")
    assert e2["epoch"] == 2 and e2["slots"][1]["state"] == PL.HANDOFF
    assert e2["slots"][0]["state"] == PL.LIVE
    m.readmit_addr("b:2")
    e3 = m.entry("d", "t")
    assert e3["epoch"] == 3
    assert all(s["state"] == PL.LIVE for s in e3["slots"])
    assert PL.PlacementMap.entry_from_wire(m.to_wire(), "d", "t")[
        "epoch"] == 3


def test_routing_deterministic_and_complete():
    assert PL.range_slices(10, 4) == [(0, 2), (2, 5), (5, 7), (7, 10)]
    keys = np.arange(1000, dtype=np.int32)
    a = PL.hash_slot_ids(keys, 4)
    assert np.array_equal(a, PL.hash_slot_ids(keys, 4))
    assert set(np.unique(a)) <= {0, 1, 2, 3}
    entry = {"mode": "hash", "key": "k",
             "slots": [{"addr": "x", "state": "live"}] * 3}
    t = ColumnTable({"k": torch.from_numpy(keys),
                     "v": torch.from_numpy(keys * 2)}, {}, None)
    parts = PL.split_table(t, entry)
    assert sum(p.num_rows for _, p in parts) == 1000
    seen = {}
    for slot, p in parts:
        for k in p["k"].numpy():
            assert seen.setdefault(int(k), slot) == slot


def test_hash_split_missing_key_refused():
    entry = {"mode": "hash", "key": "k",
             "slots": [{"addr": "x", "state": "live"}] * 2}
    t = ColumnTable({"other": torch.arange(10, dtype=torch.int32)}, {}, None)
    with pytest.raises(ValueError, match="declares key"):
        PL.split_table(t, entry)


# --- handshake and routed ingest -----------------------------------------

def test_handshake_ships_placement_only_when_sharded(tmp_path):
    with pool(tmp_path, n_workers=1) as (_leader, _ws, addr):
        c0 = _remote(addr)
        assert c0.placement_map() is None
        c0.create_database("d")
        c0.create_set("d", "plain", type_name="table")
        assert c0.placement_map() is None
        c0.create_set("d", "t", type_name="table", placement="range")
        assert "d:t" in c0.placement_map()["sets"]
        c1 = _remote(addr)  # a fresh client learns the map in HELLO
        wire = c1.placement_map()
        assert wire is not None and "d:t" in wire["sets"]
        assert len(wire["sets"]["d:t"]["slots"]) == 2
        assert c1.placement_view()["sets"][0]["set"] == "t"
        c0.close()
        c1.close()


def test_routed_table_ingest_spreads_and_scans_back(tmp_path):
    rows = 9000
    table = scaleout_table(rows)
    with pool(tmp_path) as (leader, workers, addr):
        c = _remote(addr)
        c.create_database("d")
        c.create_set("d", "t", type_name="table", placement="range")
        before = _counter("serve.client.routed_ingests")
        assert c.send_table("d", "t", table).num_rows == rows
        assert _counter("serve.client.routed_ingests") == before + 1
        for d in [leader] + workers:
            assert _local_rows(d, "d", "t") == 3000
        back = c.get_table_streamed("d", "t")
        assert back.num_rows == rows
        assert np.array_equal(back["l_price"].numpy(),
                              table["l_price"].numpy())
        view = c.placement_view()
        assert [sl["nbytes"] > 0 for sl in view["sets"][0]["slots"]] == \
            [True] * 3
        c.close()


def test_hash_ingest_copartitions_keys_on_the_reference_slots(tmp_path):
    rng = np.random.default_rng(3)
    cols = {"k": rng.integers(0, 40, 2000, dtype=np.int32),
            "v": rng.integers(0, 9, 2000, dtype=np.int32)}
    t = ColumnTable({k: torch.from_numpy(v) for k, v in cols.items()}, {},
                    None)
    from netsdb_tpu.serve import placement as JPL

    ref_slot = JPL.hash_slot_ids(cols["k"], 3)
    with pool(tmp_path) as (leader, workers, addr):
        c = _remote(addr)
        c.create_database("d")
        c.create_set("d", "t", type_name="table",
                     placement={"shard": "hash", "key": "k"})
        c.send_table("d", "t", t)
        for i, d in enumerate([leader] + workers):
            for it in d.library.store.get_items(SetIdentifier("d", "t")):
                keys = it["k"].numpy()
                # each key on the slot the reference's hash gives it
                want = set(cols["k"][ref_slot == i].tolist())
                assert set(keys.tolist()) == want
        assert sum(_local_rows(d, "d", "t")
                   for d in [leader] + workers) == 2000
        c.close()


# --- scatter-gather ---------------------------------------------------------

def _load_q01(client, table, sharded=True, paged=True):
    client.create_database("d")
    kw = {"placement": "range"} if sharded else {}
    if paged:
        kw["storage"] = "paged"
    client.create_set("d", "lineitem", type_name="table", **kw)
    client.send_table("d", "lineitem", table)


def test_scatter_fold_state_byte_equal(tmp_path):
    """The integer Q01 fold over a sharded paged set: the 3-daemon result
    equals a solo port daemon's and the reference pool's byte for byte."""
    table = scaleout_table(12000)
    with pool(tmp_path, storage_kwargs=PAGED) as (_l, _ws, addr):
        c = _remote(addr)
        _load_q01(c, table)
        before = _counter("shard.scatter_queries")
        c.execute_computations(scaleout_q01_sink("d"), job_name="sq01",
                               fetch_results=False)
        assert _counter("shard.scatter_queries") == before + 1
        got = _scale_rows(c, "d", "scale_q01_out")
        c.close()
    with solo(tmp_path, storage_kwargs=PAGED) as (_ctl, saddr):
        sc = _remote(saddr)
        _load_q01(sc, table, sharded=False)
        sc.execute_computations(scaleout_q01_sink("d"), job_name="sq01s",
                                fetch_results=False)
        want = _scale_rows(sc, "d", "scale_q01_out")
        sc.close()
    with ref_pool(tmp_path, storage_kwargs=PAGED) as raddr:
        rc = JRemote(raddr)
        rc.create_database("d")
        rc.create_set("d", "lineitem", type_name="table", storage="paged",
                      placement="range")
        rc.send_table("d", "lineitem", _jtable(table))
        rc.execute_computations(jsb.scaleout_q01_sink("d"), job_name="rq",
                                fetch_results=False)
        ref = jsb._scale_rows(rc, "d", "scale_q01_out")
        rc.close()
    assert got == want == ref and len(got) == 6


def test_real_q01_scatter_matches_allclose(tmp_path):
    """The float Q01 sink scatters too (its fold declares state_merge):
    ints exact, floats within rtol 1e-5 of the solo port daemon and of the
    reference pool (sums reassociate across the merge)."""
    from netsdb_tpu.relational import dag as jdag
    from netsdb_tpu_torch.relational import dag

    rows = 8000
    rng = np.random.default_rng(0)
    cols = {
        "l_shipdate": rng.integers(19920101, 19981231, rows, dtype=np.int32),
        "l_returnflag": rng.integers(0, 3, rows, dtype=np.int32),
        "l_linestatus": rng.integers(0, 2, rows, dtype=np.int32),
        "l_quantity": rng.integers(1, 51, rows,
                                   dtype=np.int32).astype(np.float32),
        "l_extendedprice": rng.uniform(1000, 100000, rows).astype(np.float32),
        "l_discount": rng.uniform(0, 0.1, rows).astype(np.float32),
        "l_tax": rng.uniform(0, 0.08, rows).astype(np.float32),
    }
    dicts = {"l_returnflag": ["A", "N", "R"], "l_linestatus": ["F", "O"]}
    table = ColumnTable({k: torch.from_numpy(v) for k, v in cols.items()},
                        dicts, None)

    def run(addr, sharded):
        c = _remote(addr)
        c.create_database("d")
        kw = {"placement": "range"} if sharded else {}
        c.create_set("d", "lineitem", type_name="table", **kw)
        c.send_table("d", "lineitem", table)
        c.execute_computations(dag.q01_sink("d"), job_name="q01f",
                               fetch_results=False)
        out = c.get_table("d", "q01_out")
        c.close()
        return {k: v.numpy()[out.valid.numpy()] for k, v in out.cols.items()}

    with pool(tmp_path) as (_l, _w, addr):
        got = run(addr, True)
    with solo(tmp_path) as (_ctl, saddr):
        want = run(saddr, False)
    with ref_pool(tmp_path) as raddr:
        rc = JRemote(raddr)
        rc.create_database("d")
        rc.create_set("d", "lineitem", type_name="table", placement="range")
        rc.send_table("d", "lineitem", JTable(cols, dicts))
        rc.execute_computations(jdag.q01_sink("d"), job_name="rq01",
                                fetch_results=False)
        rt = rc.get_table("d", "q01_out")
        ok = np.asarray(rt.mask())
        ref = {k: np.asarray(v)[ok] for k, v in rt.cols.items()}
        rc.close()
    assert sorted(got) == sorted(want) == sorted(ref)
    for name in want:
        for other in (want, ref):
            if got[name].dtype.kind in "iu":
                assert np.array_equal(got[name], other[name]), name
            else:
                assert np.allclose(got[name], other[name], rtol=1e-5), name


def test_group_partial_aggregate_equality(tmp_path):
    from netsdb_tpu.plan import computations as JC
    from netsdb_tpu_torch.plan import computations as C

    items = [{"k": i % 7, "v": i % 11} for i in range(600)]

    def sink(mod):
        node = mod.Aggregate(
            mod.Filter(mod.ScanSet("d", "objs"), lambda r: r["v"] > 2,
                       label="v>2"),
            key=lambda r: r["k"], value=lambda r: r["v"],
            combine=lambda a, b: a + b, label="sumv")
        return mod.WriteSet(node, "d", "g_out")

    def run(c, mod, sharded):
        c.create_database("d")
        kw = {"placement": "hash"} if sharded else {}
        c.create_set("d", "objs", type_name="object", **kw)
        c.send_data("d", "objs", items)
        res = c.execute_computations(sink(mod), job_name="grp")
        c.close()
        return dict(next(iter(res.values())))

    with pool(tmp_path) as (_l, _w, addr):
        got = run(_remote(addr), C, True)
    with solo(tmp_path) as (_ctl, saddr):
        want = run(_remote(saddr), C, False)
    with ref_pool(tmp_path) as raddr:
        ref = run(JRemote(raddr), JC, True)
    assert got == want == ref


def test_shuffle_join_byte_equal(tmp_path):
    key_space = 300
    rng = np.random.default_rng(1)
    li = {"l_orderkey": rng.integers(0, key_space, 8000, dtype=np.int32),
          "l_price": rng.integers(1, 100, 8000, dtype=np.int32)}
    orders = {"o_orderkey": np.arange(key_space, dtype=np.int32)}

    def tables(cls, conv):
        return (cls({k: conv(v) for k, v in li.items()}, {}, None),
                cls({k: conv(v) for k, v in orders.items()}, {}, None))

    def run(c, sink, rows_fn, sharded, tbls):
        c.create_database("d")
        kw = {"placement": "hash"} if sharded else {}
        c.create_set("d", "lineitem", type_name="table", **kw)
        c.create_set("d", "orders", type_name="table", **kw)
        c.send_table("d", "lineitem", tbls[0])
        c.send_table("d", "orders", tbls[1])
        c.execute_computations(sink, job_name="sjoin", fetch_results=False)
        rows = rows_fn(c, "d", "scale_join_out")
        c.close()
        return rows

    port_tables = tables(ColumnTable, torch.from_numpy)
    parts_before = _counter("shard.shuffle_parts")
    with pool(tmp_path) as (_l, _w, addr):
        got = run(_remote(addr), scaleout_join_sink("d", key_space),
                  _scale_rows, True, port_tables)
    # 3 slots x 2 sides x 2 peers = 12 buckets crossed the wire
    assert _counter("shard.shuffle_parts") == parts_before + 12
    with solo(tmp_path) as (_ctl, saddr):
        want = run(_remote(saddr), scaleout_join_sink("d", key_space),
                   _scale_rows, False, port_tables)
    with ref_pool(tmp_path) as raddr:
        ref = run(JRemote(raddr), jsb.scaleout_join_sink("d", key_space),
                  jsb._scale_rows, True, tables(JTable, lambda v: v))
    assert got == want == ref and len(got) == key_space


def test_unsupported_shape_refused_typed(tmp_path):
    from netsdb_tpu_torch.plan.computations import Apply, ScanSet, WriteSet

    with pool(tmp_path, n_workers=1) as (_l, _w, addr):
        c = _remote(addr, retry=RetryPolicy(max_attempts=1))
        c.create_database("d")
        c.create_set("d", "t", type_name="table", placement="range")
        c.send_table("d", "t", scaleout_table(200))
        sink = WriteSet(Apply(ScanSet("d", "t"), fn=lambda t: t,
                              label="whole"), "d", "out")
        with pytest.raises(RemoteError) as ei:
            c.execute_computations(sink, job_name="bad",
                                   fetch_results=False)
        assert not ei.value.retryable
        assert "scatter-gather cannot push" in str(ei.value)
        c.close()


def test_scatter_explain_annotates_shards(tmp_path):
    with pool(tmp_path, n_workers=1, storage_kwargs=PAGED) \
            as (leader, workers, addr):
        c = _remote(addr)
        _load_q01(c, scaleout_table(2000))
        results, shard_ops = leader.shards.scatter_execute(
            [scaleout_q01_sink("d")], "explain-job", explain=True)
        assert results
        assert set(shard_ops) == {leader.advertise_addr,
                                  workers[0].advertise_addr}
        for addr_key, tree in shard_ops.items():
            assert tree["shard"] == addr_key
            assert all(n["shard"] == addr_key for n in tree["nodes"])
        # over the wire too: the coordinator's own tree and the forest
        _res, ops = c.execute_computations(scaleout_q01_sink("d"),
                                           job_name="ex", explain=True,
                                           fetch_results=False)
        assert ops["shard"] == leader.advertise_addr
        c.close()


# --- epochs, eviction, handoff, readmit ----------------------------------

def test_stale_epoch_rejected_typed(tmp_path):
    with pool(tmp_path, n_workers=1) as (_leader, _w, addr):
        c = _remote(addr, retry=RetryPolicy(max_attempts=1))
        c.create_database("d")
        c.create_set("d", "t", type_name="table", placement="range")
        before = _counter("shard.epoch_rejects")
        with pytest.raises(PlacementStaleError) as ei:
            c._request(MsgType.SEND_DATA,
                       {"db": "d", "set": "t",
                        "items": ColumnTable(
                            {"x": torch.arange(4, dtype=torch.int32)}, {},
                            None),
                        "as_table": True, "date_cols": [], "append": True,
                        PLACEMENT_EPOCH_KEY: 999, SHARD_SLOT_KEY: 0,
                        IDEMPOTENCY_KEY: "tok-stale"},
                       codec=CODEC_PICKLE)
        assert ei.value.retryable
        assert ei.value.epoch == 1  # the receiver's epoch rides
        assert _counter("shard.epoch_rejects") > before
        with pytest.raises(PlacementStaleError):
            c._request(MsgType.SEND_DATA,
                       {"db": "d", "set": "t", "items": [1],
                        IDEMPOTENCY_KEY: "tok-unrouted"},
                       codec=CODEC_PICKLE)
        c.close()


def test_stale_client_reroutes_after_eviction(tmp_path):
    """A client on an epoch-1 map keeps working after an eviction: stale
    slots refuse typed, the retry re-reads the map and re-routes; with the
    current map the degraded slot's partition lands in the leader's
    handoff buffer and drains (only its own batch) at readmit."""
    with pool(tmp_path, leader_kwargs={"heartbeat_interval_s": 60.0}) \
            as (leader, workers, addr):
        c = _remote(addr)
        c.create_database("d")
        c.create_set("d", "t", type_name="table", placement="range")
        c.send_table("d", "t", scaleout_table(3000))
        w0 = workers[0].advertise_addr
        assert c.placement_map()["sets"]["d:t"]["epoch"] == 1
        leader._evict_shard(w0, "test eviction")
        assert leader.placement.entry("d", "t")["epoch"] == 2
        assert workers[1].shard_registration("d", "t")["epoch"] == 2
        rejects = _counter("shard.epoch_rejects")
        refreshes = _counter("serve.client.placement_refreshes")
        c.send_table("d", "t", scaleout_table(3000, seed=1), append=True)
        assert _counter("shard.epoch_rejects") > rejects
        assert _counter("serve.client.placement_refreshes") > refreshes
        assert sum(_local_rows(d, "d", "t")
                   for d in [leader] + workers) == 6000
        handoffs = _counter("shard.handoff_batches")
        w0_rows = _local_rows(workers[0], "d", "t")
        c.send_table("d", "t", scaleout_table(3000, seed=2), append=True)
        assert _counter("shard.handoff_batches") == handoffs + 1
        assert leader.shards.handoff_pending(w0) == 1
        assert _local_rows(workers[0], "d", "t") == w0_rows
        drained = _counter("shard.handoff_drained")
        assert leader._try_readmit_shard(w0)
        assert _counter("shard.handoff_drained") == drained + 1
        assert leader.shards.handoff_pending(w0) == 0
        assert _local_rows(workers[0], "d", "t") == w0_rows + 1000
        assert sum(_local_rows(d, "d", "t")
                   for d in [leader] + workers) == 9000
        c.close()


def test_scatter_refused_while_slot_degraded_then_recovers(tmp_path):
    with pool(tmp_path, n_workers=1, storage_kwargs=PAGED,
              leader_kwargs={"heartbeat_interval_s": 60.0}) \
            as (leader, workers, addr):
        c = _remote(addr, retry=RetryPolicy(max_attempts=1))
        _load_q01(c, scaleout_table(3000))
        sink = scaleout_q01_sink("d")
        c.execute_computations(sink, job_name="pre", fetch_results=False)
        want = _scale_rows(c, "d", "scale_q01_out")
        leader._evict_shard(workers[0].advertise_addr, "test eviction")
        with pytest.raises(ShardUnavailableError) as ei:
            c.execute_computations(sink, job_name="during",
                                   fetch_results=False)
        assert ei.value.retryable
        assert c.health()["pool"]["degraded"]
        assert leader._try_readmit_shard(workers[0].advertise_addr)
        c.execute_computations(sink, job_name="after", fetch_results=False)
        assert _scale_rows(c, "d", "scale_q01_out") == want
        c.close()


def test_shard_death_mid_scatter_never_partial(tmp_path):
    """A shard dying mid scatter-gather: one typed retryable error,
    partials discarded (the output keeps its previous content), the shard
    evicted (an epoch bump), and after readmit the full result again."""
    with pool(tmp_path, storage_kwargs=PAGED,
              leader_kwargs={"heartbeat_interval_s": 60.0,
                             "mirror_ack_timeout_s": 15.0}) \
            as (leader, workers, addr):
        c = _remote(addr, retry=RetryPolicy(max_attempts=1))
        _load_q01(c, scaleout_table(3000))
        sink = scaleout_q01_sink("d")
        c.execute_computations(sink, job_name="pre", fetch_results=False)
        want = _scale_rows(c, "d", "scale_q01_out")
        w0 = workers[0]
        original = w0.handlers[MsgType.SUBPLAN]

        def dying(p):
            raise BrokenPipeError("injected shard death")

        w0.handlers[MsgType.SUBPLAN] = dying
        epoch_before = leader.placement.entry("d", "lineitem")["epoch"]
        with pytest.raises(ShardUnavailableError) as ei:
            c.execute_computations(sink, job_name="mid",
                                   fetch_results=False)
        assert ei.value.retryable
        assert "partials discarded" in str(ei.value)
        assert _scale_rows(c, "d", "scale_q01_out") == want
        assert leader.placement.entry("d", "lineitem")["epoch"] \
            > epoch_before
        w0.handlers[MsgType.SUBPLAN] = original
        assert leader._try_readmit_shard(w0.advertise_addr)
        c.execute_computations(sink, job_name="post", fetch_results=False)
        assert _scale_rows(c, "d", "scale_q01_out") == want
        c.close()


def test_subplan_epoch_guard_rejects_cross_epoch_merge(tmp_path):
    with pool(tmp_path, n_workers=1) as (_leader, workers, addr):
        c = _remote(addr)
        c.create_database("d")
        c.create_set("d", "t", type_name="table", placement="range")
        c.send_table("d", "t", scaleout_table(200))
        with pytest.raises(PlacementStale):
            SH.check_epochs(workers[0], {"d:t": 999})
        SH.check_epochs(workers[0], {"d:t": 1})
        c.close()


# --- the default paths stay as they were --------------------------------

def test_plain_daemon_paths_untouched(tmp_path):
    with solo(tmp_path) as (ctl, addr):
        c = _remote(addr)
        assert c.placement_map() is None
        assert len(ctl.placement) == 0
        c.create_database("d")
        c.create_set("d", "t", type_name="table")
        c.send_table("d", "t", scaleout_table(500))
        assert not ctl.is_sharded("d", "t")
        assert _local_rows(ctl, "d", "t") == 500
        before = _counter("shard.scatter_queries")
        c.execute_computations(scaleout_q01_sink("d", lineitem_set="t"),
                               job_name="plain", fetch_results=False)
        assert _counter("shard.scatter_queries") == before
        assert "shards" not in c.collect_stats()
        c.close()


def test_ddl_refused_while_slot_degraded_and_purge_on_remove(tmp_path):
    with pool(tmp_path, n_workers=1,
              leader_kwargs={"heartbeat_interval_s": 60.0}) \
            as (leader, workers, addr):
        c = _remote(addr, retry=RetryPolicy(max_attempts=1))
        c.create_database("d")
        c.create_set("d", "t", type_name="table", placement="range")
        c.send_table("d", "t", scaleout_table(1000))
        w_addr = workers[0].advertise_addr
        leader._evict_shard(w_addr, "test eviction")
        with pytest.raises(ShardUnavailableError):
            c.clear_set("d", "t")
        with pytest.raises(ShardUnavailableError):
            c.send_table("d", "t", scaleout_table(100))  # replace = clear
        with pytest.raises(ShardUnavailableError):
            c.create_set("d", "t2", type_name="table", placement="range")
        c._refresh_placement()
        c.send_table("d", "t", scaleout_table(1000, seed=1), append=True)
        assert leader.shards.handoff_pending(w_addr) == 1
        assert leader.shards._handoff_bytes > 0
        assert leader._try_readmit_shard(w_addr)
        c.remove_set("d", "t")
        assert leader.shards._handoff_bytes == 0
        assert not leader.is_sharded("d", "t")
        c.close()


def test_placement_mirror_alias_is_default(tmp_path):
    with pool(tmp_path, n_workers=1) as (leader, _w, addr):
        c = _remote(addr)
        c.create_database("d")
        c.create_set("d", "m", type_name="table", placement="mirror")
        assert not leader.is_sharded("d", "m")
        c.send_table("d", "m", scaleout_table(300))
        assert _local_rows(leader, "d", "m") == 300
        c.close()


def test_concurrent_scatter_queries(tmp_path):
    with pool(tmp_path, n_workers=1, storage_kwargs=PAGED) \
            as (_l, _w, addr):
        c = _remote(addr)
        _load_q01(c, scaleout_table(2000))
        sinks = [(scaleout_q01_sink("d", cutoff=19960101,
                                    output_set="out_a"), "qa"),
                 (scaleout_q01_sink("d", cutoff=19990101,
                                    output_set="out_b"), "qb")]
        errs = []

        def run(sink, name):
            cc = _remote(addr)
            try:
                cc.execute_computations(sink, job_name=name,
                                        fetch_results=False)
            except Exception as e:  # noqa: BLE001 — surfaced below
                errs.append(e)
            finally:
                cc.close()

        threads = [threading.Thread(target=run, args=a) for a in sinks]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads) and not errs
        assert _scale_rows(c, "d", "out_a") != _scale_rows(c, "d", "out_b")
        c.close()


# --- daemons of one process with the same set names ----------------------

def test_two_daemons_same_set_names_never_share_a_variant(tmp_path):
    """Two daemons in one process hold the same set names and versions but
    other rows: each answers from its own rows, the program cache keeps a
    variant per daemon (the set's program scope names its store), and a
    write to one daemon's set drops only that daemon's variant."""
    from netsdb_tpu_torch.plan import executor as pex

    tables = [scaleout_table(3000, seed=s) for s in (11, 12)]
    pex.clear_compiled_cache()
    with solo(tmp_path, "a") as (a, aaddr), solo(tmp_path, "b") as (b, baddr):
        clients = [_remote(aaddr), _remote(baddr)]
        for c, t in zip(clients, tables):
            c.create_database("d")
            c.create_set("d", "lineitem", type_name="table")
            c.send_table("d", "lineitem", t)
        assert a.library.store.version_of(SetIdentifier("d", "lineitem")) \
            == b.library.store.version_of(SetIdentifier("d", "lineitem"))
        got = []
        for _round in range(2):
            for c in clients:
                c.execute_computations(scaleout_q01_sink("d"),
                                       job_name="same", fetch_results=False)
                got.append(_scale_rows(c, "d", "scale_q01_out"))
        with solo(tmp_path, "oracle") as (_o, oaddr):
            oc = _remote(oaddr)
            want = []
            for i, t in enumerate(tables):
                oc.create_database("d")
                oc.create_set("d", f"l{i}", type_name="table")
                oc.send_table("d", f"l{i}", t)
                oc.execute_computations(
                    scaleout_q01_sink("d", lineitem_set=f"l{i}",
                                      output_set=f"o{i}"),
                    job_name=f"o{i}", fetch_results=False)
                want.append(_scale_rows(oc, "d", f"o{i}"))
            oc.close()
        assert got == want + want and want[0] != want[1]
        prog = next(p for p in pex.cached_programs()
                    if p.key.startswith("same::"))
        assert prog.variants() == 2
        # a write to b's set drops b's variant and keeps a's
        clients[1].send_table("d", "lineitem", tables[1])
        assert prog.variants() == 1
        for c, w in zip(clients, want):
            c.execute_computations(scaleout_q01_sink("d"), job_name="same",
                                   fetch_results=False)
            assert _scale_rows(c, "d", "scale_q01_out") == w
        for c in clients:
            c.close()


def test_pool_stats_and_health_fan_out(tmp_path):
    with pool(tmp_path, leader_kwargs={"heartbeat_interval_s": 60.0}) \
            as (leader, workers, addr):
        c = _remote(addr)
        stats = c.collect_stats()
        assert sorted(stats["shards"]) == sorted(w.advertise_addr
                                                 for w in workers)
        assert all("sets" in s for s in stats["shards"].values())
        health = c.health()
        assert health["pool"]["workers"] == [w.advertise_addr
                                             for w in workers]
        assert sorted(health["shards"]) == sorted(stats["shards"])
        c.close()
