"""The port's daemon and its thin client against the reference's local
``Client`` on the same seeded inputs, on the CPU: the one-daemon cases
of the reference's ``tests/test_serve.py`` and of
``tests/test_serve_restart_and_hedge.py:21-95``.

Every daemon listens on port 0 and is shut down in ``finally`` (the
subprocess daemon is killed there); every client has a socket timeout;
no wait is unbounded."""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from netsdb_tpu_torch import Client
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.models.ff import FFModel
from netsdb_tpu_torch.serve.client import RemoteClient, RemoteError
from netsdb_tpu_torch.serve.protocol import (CODEC_PICKLE, IDEMPOTENCY_KEY,
                                             MsgType)
from netsdb_tpu_torch.serve.server import ServeController, _IdempotencyCache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 60.0


def _daemon(tmp_path, name="served", **kw):
    ctl = ServeController(Configuration(root_dir=str(tmp_path / name)),
                          port=0, device="cpu", **kw)
    ctl.start()
    return ctl


@pytest.fixture()
def server(tmp_path):
    ctl = _daemon(tmp_path)
    try:
        yield ctl, ctl.advertise_addr
    finally:
        ctl.shutdown()


def _remote(addr, **kw):
    return RemoteClient(addr, timeout=TIMEOUT, **kw)


def test_hello_ping_and_stats(server):
    _, addr = server
    c = _remote(addr)
    try:
        assert c.ping()["uptime"] >= 0
        stats = c.collect_stats()
        assert {"cache", "device_cache", "metrics", "sessions",
                "serve"} <= set(stats)
        assert "kernels" in stats["metrics"]
        assert c.health()["sessions_open"] == 0
    finally:
        c.close()


def test_client_address_dispatch(server):
    """Client(address=...) returns the thin RPC client — same facade."""
    _, addr = server
    c = Client(address=addr)
    try:
        assert isinstance(c, RemoteClient)
        c.create_database("dispatch")
        c.create_set("dispatch", "s")
        assert c.set_exists("dispatch", "s")
    finally:
        c.close()


def test_matrix_roundtrip(server):
    _, addr = server
    c = _remote(addr)
    try:
        c.create_database("db")
        c.create_set("db", "m")
        a = np.arange(30, dtype=np.float32).reshape(5, 6)
        c.send_matrix("db", "m", a, (4, 4))
        back = c.get_tensor("db", "m")
        np.testing.assert_array_equal(back.to_dense(), a)
        assert back.shape == (5, 6) and back.block_shape == (4, 4)
    finally:
        c.close()


def test_object_roundtrip_and_errors(server):
    ctl, addr = server
    c = _remote(addr)
    try:
        c.create_database("db")
        c.create_set("db", "objs")
        items = [{"k": i, "v": ("x", i)} for i in range(7)]
        c.send_data("db", "objs", items)
        assert list(c.get_set_iterator("db", "objs")) == items
        # server-side errors cross the wire with their message
        with pytest.raises(RemoteError, match="unknown set"):
            c.get_tensor("db", "missing")
        with pytest.raises(RemoteError, match="does not exist"):
            c.create_set("nodb", "s")
        # out-of-slice frames raise typed, naming their item (GET_TRACE
        # is answered since the observability slice, HA_STATE since the
        # replication slice: an unarmed daemon says so; RESHARD, shipped
        # type sources and add_worker since the daemon-pool slice)
        assert c._request(MsgType.GET_TRACE, {})["enabled"] is True
        assert c._request(MsgType.HA_STATE, {}) == {"armed": False}
        # LOCAL_SHARDS (the SPMD follower's read) answers with this
        # daemon's blocks of a one-item set, here the whole matrix
        c.create_set("db", "one")
        c.send_matrix("db", "one", np.eye(3, dtype=np.float32), (2, 2))
        rep = c._request(MsgType.LOCAL_SHARDS, {"db": "db", "set": "one"})
        assert rep["shapes"] == {"data": [4, 4]}
        (blk,) = rep["leaves"]["data"]
        assert blk["idx"] == [[0, 4], [0, 4]]
        np.testing.assert_array_equal(np.asarray(blk["data"])[:3, :3],
                                      np.eye(3, dtype=np.float32))
        with pytest.raises(RemoteError, match="shard assembly expects 1"):
            c._request(MsgType.LOCAL_SHARDS, {"db": "db", "set": "objs"})
        status = c._request(MsgType.RESHARD, {"op": "status"},
                            codec=CODEC_PICKLE)
        assert status["enabled"] is False and status["moves"] == []
        c.register_type("T", "m:f", source="x = 1")
        assert ctl.library.catalog.get_type_source("T") == "x = 1"
        grown = c.add_worker("127.0.0.1:1", campaign=False)
        assert grown == {"workers": ["127.0.0.1:1"], "moves": None}
    finally:
        c.close()


def test_auth_token(tmp_path):
    ctl = _daemon(tmp_path, token="sekrit")
    try:
        with pytest.raises(RemoteError, match="bad token"):
            _remote(ctl.advertise_addr, token="wrong")
        c = _remote(ctl.advertise_addr, token="sekrit")
        assert c.ping()["uptime"] >= 0
        c.close()
        c = Client(address=ctl.advertise_addr, token="sekrit")
        assert isinstance(c, RemoteClient) and c.ping()["uptime"] >= 0
        c.close()
    finally:
        ctl.shutdown()


def test_pickle_refused_when_disabled(tmp_path):
    ctl = _daemon(tmp_path, allow_pickle=False)
    try:
        c = _remote(ctl.advertise_addr)
        c.create_database("db")
        c.create_set("db", "objs")
        with pytest.raises(RemoteError, match="pickled frame refused") as e:
            c.send_data("db", "objs", [1, 2, 3])
        assert not e.value.retryable and c.last_attempts == 1
        c.close()
    finally:
        ctl.shutdown()


def test_pool_topologies_raise_naming_their_item(tmp_path):
    """Followers, HA peers, replicas and failover lists are taken since
    the replication slice (a daemon with followers or HA peers builds
    without dialling anyone); rebalancing and type-source shipping since
    the daemon-pool slice: ``add_worker``, ``rebalance_status`` and a
    shipped source each answer."""
    cfg = Configuration(root_dir=str(tmp_path / "x"))
    for kw in (dict(followers=["127.0.0.1:1"]),
               dict(workers=["a:1"], followers=["b:1"]),
               dict(ha_peers=["a:1"])):
        ctl = ServeController(cfg, port=0, device="cpu", **kw)
        assert ctl._follower_addrs == kw.get("followers", [])
        assert ctl._ha_peers == kw.get("ha_peers", [])
        ctl.shutdown()
    ctl = ServeController(cfg, port=0, device="cpu")
    ctl.start()
    try:
        c = RemoteClient(ctl.advertise_addr, replicas=["a:1"],
                         failover=["a:1"], hedge_delay_s=0.1, timeout=30)
        assert c.hedge_delay_s() == 0.1
        assert c.add_worker("a:1", campaign=False)["workers"] == ["a:1"]
        assert c.rebalance_status()["running"] is False
        c.register_type("T", "m:f", source="x=1")
        assert ctl.library.catalog.get_type_source("T") == "x=1"
        c.close()
    finally:
        ctl.shutdown()


@pytest.mark.parametrize("knob,value", [
    ("heartbeat_interval_s", 0.1), ("heartbeat_timeout_s", 0.5),
    ("heartbeat_misses", 5), ("resync_grace_s", 1.0),
    ("resync_timeout_s", 10.0)])
def test_follower_link_knobs_raise_naming_their_item(tmp_path, knob, value):
    """The follower links' knobs, refused until the replication slice,
    are taken now and land where the health and resync paths read
    them."""
    cfg = Configuration(root_dir=str(tmp_path / "x"))
    ctl = ServeController(cfg, port=0, device="cpu", **{knob: value})
    try:
        assert getattr(ctl, knob) == value
    finally:
        ctl.shutdown()


def test_repeated_remote_requests_trace_once(tmp_path):
    """The daemon unpickles each request's DAG anew; a repeated FF
    request and a repeated paged Q01 (built anew each time, so the
    scheduler cannot coalesce them) each build their programs once."""
    from netsdb_tpu_torch.plan import executor as pex
    from netsdb_tpu_torch.relational import bench as rbench
    from netsdb_tpu_torch.relational import dag
    from netsdb_tpu_torch.relational.table import ColumnTable

    cols, dicts = rbench.generate_host(sf=0.005, seed=4)["lineitem"]
    ctl = ServeController(Configuration(root_dir=str(tmp_path / "tr"),
                                        page_size_bytes=64 << 10),
                          port=0, device="cpu")
    ctl.start()
    c = None
    try:
        c = _remote(ctl.advertise_addr)
        c.create_database("d")
        c.create_set("d", "lineitem", type_name="table", storage="paged")
        c.send_table("d", "lineitem", ColumnTable.from_columns(
            cols, dicts, device="cpu"))
        model, _ = _load_ff(FFModel, c)
        sink = model.build_inference_dag()
        for run in (lambda: c.execute_computations(dag.q01_sink("d"),
                                                   job_name="q01-twice"),
                    lambda: c.execute_computations(sink,
                                                   job_name="ff-twice")):
            run()
            traces = pex.compile_stats()["traces"]
            first = run()
            assert pex.compile_stats()["traces"] == traces
            assert _leaves_equal(run(), first)
    finally:
        if c is not None:
            c.close()
        ctl.shutdown()


def _leaves_equal(a, b) -> bool:
    import torch

    from netsdb_tpu_torch.relational.table import ColumnTable

    (va,), (vb,) = a.values(), b.values()
    if isinstance(va, list):
        (va,), (vb,) = va, vb
    if isinstance(va, ColumnTable):
        return all(torch.equal(va.cols[k], vb.cols[k]) for k in va.cols)
    return np.array_equal(va.to_dense(), vb.to_dense())


def _ff_arrays():
    rng = np.random.default_rng(3)
    feat, hid, lab = 32, 48, 8
    w1 = (rng.standard_normal((hid, feat)) * 0.1).astype(np.float32)
    b1 = (rng.standard_normal((hid,)) * 0.1).astype(np.float32)
    wo = (rng.standard_normal((lab, hid)) * 0.1).astype(np.float32)
    bo = (rng.standard_normal((lab,)) * 0.1).astype(np.float32)
    x = rng.standard_normal((24, feat)).astype(np.float32)
    return w1, b1, wo, bo, x


def _load_ff(model_cls, client, db="ffd", block=(16, 16)):
    w1, b1, wo, bo, x = _ff_arrays()
    model = model_cls(db=db, block=block)
    model.setup(client)
    model.load_weights(client, w1, b1, wo, bo)
    model.load_inputs(client, x)
    return model, (w1, b1, wo, bo, x)


def test_remote_ff_inference_matches_the_reference(server, tmp_path):
    """The FFTest scenario through the port's daemon equals the
    reference's in-process library path."""
    from netsdb_tpu.client import Client as RefClient
    from netsdb_tpu.config import Configuration as RefConfig
    from netsdb_tpu.models.ff import FFModel as RefFF
    from netsdb_tpu.plan.executor import clear_compiled_cache

    _, addr = server
    remote = _remote(addr)
    try:
        model, _ = _load_ff(FFModel, remote)
        results = remote.execute_computations(model.build_inference_dag(),
                                              job_name="ff-rpc")
        got = next(iter(results.values())).to_dense()
        clear_compiled_cache()
        local = RefClient(RefConfig(root_dir=str(tmp_path / "ref")))
        ref_model, _ = _load_ff(RefFF, local)
        want = np.asarray(ref_model.inference(local).to_dense())
        np.testing.assert_allclose(got, want, atol=1e-5)
        jobs = remote.list_jobs()
        assert any(j["name"] == "ff-rpc" and j["status"] == "done"
                   for j in jobs)
        # explain=True round-trips the operator tree
        _, tree = remote.execute_computations(
            model.build_inference_dag(), job_name="ff-explain",
            explain=True)
        assert tree is not None
    finally:
        remote.close()


def test_remote_transformer_layer_matches_the_reference(server, tmp_path):
    """The transformer layer executed through the port's daemon equals
    the reference's in-process forward (1e-4 on the CPU)."""
    from netsdb_tpu.client import Client as RefClient
    from netsdb_tpu.config import Configuration as RefConfig
    from netsdb_tpu.models.transformer import TransformerLayerModel as RefL
    from netsdb_tpu.plan.executor import clear_compiled_cache
    from netsdb_tpu_torch.models.transformer import TransformerLayerModel

    _, addr = server
    x = np.random.default_rng(1).standard_normal((2, 64, 64)).astype(
        np.float32)
    remote = _remote(addr)
    try:
        pm = TransformerLayerModel(num_heads=4)
        pm.setup(remote)
        pm.load_random_weights(remote, embed=64, seed=0)
        pm.load_inputs(remote, x)
        (got,) = pm.serve_forward(remote)
        clear_compiled_cache()
        local = RefClient(RefConfig(root_dir=str(tmp_path / "ref")))
        jm = RefL(num_heads=4)
        jm.setup(local)
        jm.load_random_weights(local, embed=64, seed=0)
        jm.load_inputs(local, x)
        want = np.asarray(jm.serve_forward(local))
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                                   atol=1e-4)
    finally:
        remote.close()


def test_remote_tpch_bench_matches_the_reference(server, tmp_path):
    """tpchBench through the daemon: nested customers loaded once
    daemon-side, selection and flatten executed remotely, results equal
    the reference's in-process run exactly."""
    from netsdb_tpu.client import Client as RefClient
    from netsdb_tpu.config import Configuration as RefConfig
    from netsdb_tpu.plan.executor import clear_compiled_cache
    from netsdb_tpu.workloads import tpch_bench as RTB
    from netsdb_tpu_torch.workloads import tpch_bench as TB

    _, addr = server
    remote = _remote(addr)
    try:
        TB.load(remote, TB.generate(num_customers=30, seed=11), db="tb")
        remote.execute_computations(
            TB.customer_int_selection(db="tb", threshold=10),
            TB.flatten_triples(db="tb"), job_name="tpchbench-rpc")
        sel = list(remote.get_set_iterator("tb", "selected_int"))
        flat = list(remote.get_set_iterator("tb", "triples"))
        assert sel and flat
        clear_compiled_cache()
        local = RefClient(RefConfig(root_dir=str(tmp_path / "ref")))
        RTB.load(local, RTB.generate(num_customers=30, seed=11), db="tb")
        local.execute_computations(
            RTB.customer_int_selection(db="tb", threshold=10),
            RTB.flatten_triples(db="tb"), job_name="tpchbench-local")
        want_sel = list(local.get_set_iterator("tb", "selected_int"))
        want_flat = list(local.get_set_iterator("tb", "triples"))
        assert [c.custKey for c in sel] == [c.custKey for c in want_sel]
        assert [(t.customerName, t.supplierName, t.partKey)
                for t in flat] == \
            [(t.customerName, t.supplierName, t.partKey)
             for t in want_flat]
    finally:
        remote.close()


def test_execute_plan_text_no_pickle(tmp_path):
    """The TCAP path: plan text and an entry-point registry with the
    pickle codec off end to end."""
    ctl = _daemon(tmp_path, allow_pickle=False)
    try:
        c = _remote(ctl.advertise_addr)
        c.create_database("db")
        c.create_set("db", "m")
        a = np.arange(12, dtype=np.float32).reshape(3, 4)
        c.send_matrix("db", "m", a, (2, 2))
        c.register_type("Transpose", "netsdb_tpu_torch.ops.linalg:transpose")
        plan = "\n".join(["in <= SCAN('db', 'm')",
                          "t <= APPLY(in, 'transpose')",
                          "out <= OUTPUT(t, 'db', 'mt')"])
        for registry in ({"transpose": "netsdb_tpu_torch.ops.linalg:"
                                       "transpose"},
                         {"transpose": "Transpose"}):
            results = c.execute_plan(plan, registry, job_name="plan-job")
            got = next(iter(results.values())).to_dense()
            np.testing.assert_array_equal(got, a.T)
        c.close()
    finally:
        ctl.shutdown()


def test_concurrent_clients_shared_weights(server):
    """N threads, one resident model: private input and output sets,
    shared weight sets. Every result matches its numpy oracle."""
    _, addr = server
    setup = _remote(addr)
    model, (w1, b1, wo, bo, _) = _load_ff(FFModel, setup, db="shared")
    setup.close()
    errs = []

    def one_client(i):
        try:
            c = _remote(addr)
            rng = np.random.default_rng(100 + i)
            x = rng.standard_normal((16, w1.shape[1])).astype(np.float32)
            c.create_set("shared", f"in_{i}")
            c.create_set("shared", f"out_{i}")
            c.send_matrix("shared", f"in_{i}", x, (16, 16))
            sink = model.build_inference_dag(input_set=f"in_{i}",
                                             output_set=f"out_{i}")
            for _ in range(3):
                res = c.execute_computations(sink, job_name=f"client{i}")
            got = next(iter(res.values())).to_dense()
            h = np.maximum(w1 @ x.T + b1[:, None], 0)
            logits = wo @ h + bo[:, None]
            e = np.exp(logits - logits.max(axis=0, keepdims=True))
            np.testing.assert_allclose(got, e / e.sum(axis=0, keepdims=True),
                                       atol=1e-5)
            c.close()
        except Exception as e:  # surfaced in the main thread
            errs.append((i, e))

    threads = [threading.Thread(target=one_client, args=(i,))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs


def test_weights_stay_resident_across_sessions(server):
    _, addr = server
    c1 = _remote(addr)
    c1.create_database("persist")
    c1.create_set("persist", "w")
    a = np.ones((8, 8), np.float32) * 7
    c1.send_matrix("persist", "w", a, (4, 4))
    c1.close()
    c2 = _remote(addr)
    try:
        np.testing.assert_array_equal(
            c2.get_tensor("persist", "w").to_dense(), a)
    finally:
        c2.close()


def _read_line(proc, timeout_s):
    """The child's first stdout line, waiting at most ``timeout_s``."""
    out = []
    t = threading.Thread(target=lambda: out.append(proc.stdout.readline()),
                         daemon=True)
    t.start()
    t.join(timeout_s)
    return out[0] if out else ""


def test_two_process_integration(tmp_path):
    """A real daemon process on the CPU and two client threads running
    inference against weights loaded once."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "netsdb_tpu_torch.serve.server", "--port",
         "0", "--root", str(tmp_path / "proc"), "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = _read_line(proc, 120)
        assert line.startswith("serving on "), (line, proc.poll())
        addr = line.split()[-1]
        setup = _remote(addr)
        model, (w1, b1, wo, bo, _) = _load_ff(FFModel, setup, db="p")
        errs, done = [], []

        def client(i):
            try:
                c = _remote(addr)
                x = np.random.default_rng(i).standard_normal(
                    (16, w1.shape[1])).astype(np.float32)
                c.create_set("p", f"in{i}")
                c.create_set("p", f"out{i}")
                c.send_matrix("p", f"in{i}", x, (16, 16))
                sink = model.build_inference_dag(input_set=f"in{i}",
                                                 output_set=f"out{i}")
                for _ in range(2):
                    res = c.execute_computations(sink, job_name=f"p{i}")
                got = next(iter(res.values())).to_dense()
                h = np.maximum(w1 @ x.T + b1[:, None], 0)
                lg = wo @ h + bo[:, None]
                e = np.exp(lg - lg.max(axis=0, keepdims=True))
                np.testing.assert_allclose(
                    got, e / e.sum(axis=0, keepdims=True), atol=1e-5)
                done.append(i)
                c.close()
            except Exception as e:  # surfaced below
                errs.append((i, e))

        ts = [threading.Thread(target=client, args=(i,)) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not errs and sorted(done) == [0, 1], errs
        assert setup.ping()["jobs_done"] >= 4
        assert setup.collect_stats()["serve"]["pid"] == proc.pid
        setup.shutdown_server()
        proc.wait(timeout=30)
        assert proc.returncode == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_mutation_not_double_applied_across_restart(tmp_path):
    """A client retrying a completed mutation across a daemon restart
    gets the cached reply (persisted under root_dir), not a
    re-execution."""
    cfg = Configuration(root_dir=str(tmp_path / "restart"))
    ctl = ServeController(cfg, port=0, device="cpu")
    ctl.start()
    payload = {"db": "d", "set": "s", "items": [1, 2, 3],
               IDEMPOTENCY_KEY: "restart-retry-token"}
    try:
        rc = _remote(ctl.advertise_addr)
        rc.create_database("d")
        rc.create_set("d", "s", type_name="object")
        reply1 = rc._request(MsgType.SEND_DATA, dict(payload),
                             codec=CODEC_PICKLE)
        assert list(rc.get_set_iterator("d", "s")) == [1, 2, 3]
        rc.close()
    finally:
        ctl.shutdown()
    ctl2 = ServeController(cfg, port=0, device="cpu")
    ctl2.start()
    try:
        rc2 = _remote(ctl2.advertise_addr)
        rc2.create_database("d")
        rc2.create_set("d", "s", type_name="object")
        reply2 = rc2._request(MsgType.SEND_DATA, dict(payload),
                              codec=CODEC_PICKLE)
        assert reply2 == reply1
        assert ctl2._idem.persist_hits == 1
        assert list(rc2.get_set_iterator("d", "s")) == []
        rc2.close()
    finally:
        ctl2.shutdown()


def test_idempotency_cache_prunes_to_capacity(tmp_path):
    path = str(tmp_path / "idem.sqlite")
    cache = _IdempotencyCache(capacity=3, persist_path=path)
    for i in range(6):
        assert cache.claim(f"tok{i}", wait_s=0.1) is None
        cache.finish(f"tok{i}", (MsgType.OK, {"i": i}, 0))
    cache.prune()
    cache.close()
    fresh = _IdempotencyCache(capacity=3, persist_path=path)
    assert fresh.claim("tok5", wait_s=0.1) == (MsgType.OK, {"i": 5}, 0)
    assert fresh.persist_hits == 1
    assert fresh.claim("tok0", wait_s=0.1) is None  # pruned: re-execute
    fresh.abort("tok0")
    fresh.close()


def test_unpicklable_reply_stays_memory_only(tmp_path):
    cache = _IdempotencyCache(capacity=4,
                              persist_path=str(tmp_path / "i.sqlite"))
    assert cache.claim("t", wait_s=0.1) is None
    cache.finish("t", (MsgType.OK, {"mv": memoryview(b"x")}, 0))
    assert cache.claim("t", wait_s=0.1)[0] == MsgType.OK
    cache.close()
    fresh = _IdempotencyCache(capacity=4,
                              persist_path=str(tmp_path / "i.sqlite"))
    assert fresh.claim("t", wait_s=0.1) is None  # not persisted
    fresh.abort("t")
    fresh.close()


def test_duplicate_in_flight_request_waits_then_replays(server):
    """A retry arriving while its original still runs waits for it and
    gets the same reply: the handler runs once."""
    ctl, addr = server
    c = _remote(addr)
    c.create_database("d")
    c.create_set("d", "s", type_name="object")
    calls = []
    orig = ctl.handlers[MsgType.SEND_DATA]

    def slow(p):
        calls.append(1)
        time.sleep(0.3)
        return orig(p)

    ctl.handlers[MsgType.SEND_DATA] = slow
    payload = {"db": "d", "set": "s", "items": [7], IDEMPOTENCY_KEY: "dup"}
    replies = []

    def send():
        cc = _remote(addr)
        replies.append(cc._request(MsgType.SEND_DATA, dict(payload),
                                   codec=CODEC_PICKLE))
        cc.close()

    ts = [threading.Thread(target=send) for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert len(replies) == 2 and replies[0] == replies[1]
    assert len(calls) == 1
    assert list(c.get_set_iterator("d", "s")) == [7]
    c.close()


def test_remote_client_has_the_reference_facade():
    """Every public method of the reference's ``RemoteClient`` and
    ``SessionHandle`` exists on the port's (the pool's and A8's raise)."""
    from netsdb_tpu.serve import client as ref_client
    from netsdb_tpu_torch.serve import client as port_client

    for cls in ("RemoteClient", "SessionHandle", "RetryPolicy",
                "RemoteTensor", "RemoteTableInfo", "RemoteIdent"):
        ref_names = {n for n in dir(getattr(ref_client, cls))
                     if not n.startswith("_")}
        ours = {n for n in dir(getattr(port_client, cls))
                if not n.startswith("_")}
        assert ref_names <= ours, (cls, ref_names - ours)
    import netsdb_tpu.serve as ref_serve
    import netsdb_tpu_torch.serve as serve

    assert serve.__all__ == ref_serve.__all__


def test_analyze_set_and_paged_matmul_match_the_reference(server, client,
                                                          tmp_path):
    """ANALYZE_SET ships the summaries the reference's does for the same
    rows; PAGED_MATMUL streams a paged matrix daemon-side."""
    _, addr = server
    rows = [{"k": i % 5, "name": f"n{i % 3}", "v": float(i)}
            for i in range(50)]
    c = _remote(addr)
    try:
        c.create_database("d")
        c.create_set("d", "t", type_name="table")
        info = c.send_table("d", "t", rows)
        client.create_database("d")
        client.create_set("d", "t", type_name="table")
        client.send_table("d", "t", rows)
        got, want = c.analyze_set("d", "t"), client.analyze_set("d", "t")
        assert info.num_rows == got["num_rows"] == want["num_rows"] == 50
        assert got["dicts"] == {k: list(v) for k, v in want["dicts"].items()}
        def facts(stats):
            return {k: (int(s.n_rows), int(s.min_val), int(s.max_val),
                        int(s.n_distinct)) for k, s in stats.items()}

        assert facts(got["stats"]) == facts(want["stats"])
        a = np.random.default_rng(4).standard_normal((64, 32)).astype(
            np.float32)
        rhs = np.random.default_rng(5).standard_normal((32, 8)).astype(
            np.float32)
        c.create_set("d", "pm", storage="paged")
        c.send_matrix("d", "pm", a, (16, 16))
        np.testing.assert_allclose(c.paged_matmul("d", "pm", rhs), a @ rhs,
                                   rtol=1e-5, atol=1e-5)
    finally:
        c.close()


def test_flush_load_dedup_and_shared_mapping_through_the_daemon(tmp_path):
    """FLUSH_DATA then LOAD_SET in a restarted daemon over the same root;
    DEDUP_RESIDENT pools two weight sets and reads stay bit-equal;
    ADD_SHARED_MAPPING makes a set read another's storage."""
    cfg = Configuration(root_dir=str(tmp_path / "persist"))
    a = np.random.default_rng(6).standard_normal((64, 64)).astype(
        np.float32)
    b = a.copy()
    b[:16, :16] += 1.0  # 1 of 16 blocks differs
    ctl = ServeController(cfg, port=0, device="cpu")
    ctl.start()
    try:
        c = _remote(ctl.advertise_addr)
        c.create_database("d")
        c.create_set("d", "p", persistence="persistent")
        c.send_matrix("d", "p", a, (16, 16))
        c.flush_data()
        for name, m in (("wa", a), ("wb", b)):
            c.create_set("d", name)
            c.send_matrix("d", name, m, (16, 16))
        report = c.dedup_resident([("d", "wa"), ("d", "wb")])
        assert (report["total_blocks"], report["unique_blocks"]) == (32, 17)
        np.testing.assert_array_equal(c.get_tensor("d", "wb").to_dense(), b)
        c.create_set("d", "alias")
        c.add_shared_mapping("d", "alias", "d", "wa")
        np.testing.assert_array_equal(c.get_tensor("d", "alias").to_dense(),
                                      a)
        c.close()
    finally:
        ctl.shutdown()
    ctl2 = ServeController(cfg, port=0, device="cpu")
    ctl2.start()
    try:
        c2 = Client(address=ctl2.advertise_addr, token=None)
        c2.load_set("d", "p")  # the flushed set, back from root_dir
        np.testing.assert_array_equal(c2.get_tensor("d", "p").to_dense(), a)
        c2.close()
    finally:
        ctl2.shutdown()


def test_daemon_defaults_to_cuda_and_never_falls_back(tmp_path):
    import torch

    cfg = Configuration(root_dir=str(tmp_path / "cuda"))
    if torch.cuda.is_available():
        ctl = ServeController(cfg, port=0)
        try:
            assert ctl.device.type == "cuda" and ctl.device.index is not None
        finally:
            ctl.shutdown()
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServeController(cfg, port=0)
    ctl = ServeController(cfg, port=0, device="cpu")
    try:
        assert ctl.device.type == "cpu"
    finally:
        ctl.shutdown()
