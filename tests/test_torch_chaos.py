"""Fault injection through the port's daemon — the contract of the
reference's ``tests/test_serve_chaos.py``, case by case, against a port
daemon in this process (``port=0``, ``device="cpu"``), plus the port's
parity with the reference's injector: one seed gives one fault sequence
in both packages, and each action gives on the port's wire the typed
error it gives on the reference's.

Every fault is seeded or scripted. The contract: a request either
succeeds after typed retries or raises a typed error — never an untyped
exception, never a doubled mutation — and a killed follower reattaches
through a resync and holds the leader's store."""

import threading
import time

import numpy as np
import pytest

from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.serve.chaos import ChaosInjector
from netsdb_tpu_torch.serve.client import RemoteClient, RetryPolicy
from netsdb_tpu_torch.serve.errors import (
    AdmissionFullError,
    CorruptFrameError,
    DeadlineExceededError,
    FollowerDegradedError,
    RemoteError,
    RetryableRemoteError,
)
from netsdb_tpu_torch.serve.protocol import CODEC_PICKLE, MsgType
from netsdb_tpu_torch.serve.server import ServeController

FAST = RetryPolicy(max_attempts=5, base_delay_s=0.01, max_delay_s=0.1)
TIMEOUT = 60.0


def _daemon(root, **kw):
    ctl = ServeController(Configuration(root_dir=str(root)), port=0,
                          device="cpu", **kw)
    ctl.start()
    return ctl


@pytest.fixture()
def server(tmp_path):
    chaos = ChaosInjector()
    ctl = _daemon(tmp_path / "srv", chaos=chaos)
    try:
        yield ctl, ctl.advertise_addr, chaos
    finally:
        ctl.shutdown()


def _content(ctl, db, s):
    return sorted(r["i"] for r in ctl.library.get_set_iterator(db, s))


def _objects(c):
    c.create_database("d")
    c.create_set("d", "s", type_name="object")


# --- parity with the reference's injector ------------------------------

@pytest.mark.parametrize("seed,rates", [
    (0, dict(drop=0.2)),
    (4242, dict(drop=0.10, truncate=0.05, max_faults=4)),
    (1234, dict(drop=0.12, corrupt=0.08, max_faults=6)),
    (7, dict(drop=0.1, delay=0.1, corrupt=0.1, truncate=0.1))])
def test_same_seed_gives_the_reference_fault_sequence(seed, rates):
    """The seeded decisions and the scripted FIFO with its type filter
    consume the same frames in the same order in both packages."""
    from netsdb_tpu.serve.chaos import ChaosInjector as RefInjector

    ours, ref = ChaosInjector(seed=seed, **rates), RefInjector(seed=seed,
                                                              **rates)
    for inj in (ours, ref):
        inj.arm("corrupt_seg", types=[MsgType.SEND_MATRIX])
        inj.arm("kill", where="recv")
    types = [int(MsgType.PING), int(MsgType.SEND_DATA),
             int(MsgType.SEND_MATRIX), None]
    for i in range(200):
        where = "recv" if i % 7 == 3 else "send"
        typ = types[i % len(types)] if where == "send" else None
        assert ours._next(where, typ) == ref._next(where, typ), i
    assert ours.faults == ref.faults and ours.faults


def test_unknown_action_is_refused_like_the_reference():
    from netsdb_tpu.serve.chaos import ChaosInjector as RefInjector

    for inj in (ChaosInjector(), RefInjector()):
        with pytest.raises(ValueError, match="unknown chaos action"):
            inj.arm("explode")


def _send_matrix_outcome(pkg, root, action, **kw):
    """One send_matrix, retries off, through a client whose request
    frame gets ``action``: the error's class name, or "ok". ``pkg``
    holds one package's controller, client, retry policy, injector and
    configuration classes."""
    ctl_cls, client_cls, retry_cls, chaos_cls, cfg_cls = pkg
    ctl = ctl_cls(cfg_cls(root_dir=str(root)), port=0, **kw)
    port = ctl.start()
    chaos = chaos_cls()
    c = client_cls(f"127.0.0.1:{port}", retry=retry_cls(max_attempts=1),
                   chaos=chaos, timeout=TIMEOUT)
    try:
        c.create_database("d")
        c.create_set("d", "w")
        chaos.arm(action, types=[MsgType.SEND_MATRIX], delay_s=0.05)
        try:
            c.send_matrix("d", "w", np.ones((64, 64), np.float32), (32, 32))
            return "ok"
        except Exception as e:  # noqa: BLE001 — the class is the verdict
            assert isinstance(e, RemoteError) or \
                type(e).__module__.startswith("netsdb_tpu."), e
            return type(e).__name__
    finally:
        c.close()
        ctl.shutdown()


@pytest.mark.parametrize("action", ["drop", "kill", "delay", "corrupt",
                                    "corrupt_seg", "truncate"])
def test_each_action_types_the_reference_error(action, tmp_path):
    """A send_matrix whose request frame is faulted, with retries off:
    the port client against the port daemon raises the same typed error
    (by class name) as the reference's client against the reference's
    daemon — ConnectionLost for drop/kill/truncate, CorruptFrame for
    corrupt and corrupt_seg (the segment checksum), none for delay."""
    from netsdb_tpu.config import Configuration as RefConfiguration
    from netsdb_tpu.serve.chaos import ChaosInjector as RefInjector
    from netsdb_tpu.serve.client import RemoteClient as RefClient
    from netsdb_tpu.serve.client import RetryPolicy as RefRetry
    from netsdb_tpu.serve.server import ServeController as RefController

    ours = _send_matrix_outcome(
        (ServeController, RemoteClient, RetryPolicy, ChaosInjector,
         Configuration), tmp_path / "port", action, device="cpu")
    ref = _send_matrix_outcome(
        (RefController, RefClient, RefRetry, RefInjector, RefConfiguration),
        tmp_path / "ref", action)
    assert ours == ref
    assert ours == {"delay": "ok", "corrupt": "CorruptFrameError",
                    "corrupt_seg": "CorruptFrameError"}.get(
                        action, "ConnectionLostError")


# --- typed taxonomy ----------------------------------------------------

def test_fatal_errors_are_not_retried(server):
    ctl, addr, _ = server
    c = RemoteClient(addr, retry=FAST, timeout=TIMEOUT)
    with pytest.raises(RemoteError) as ei:
        c.get_tensor("nodb", "nothing")
    assert not ei.value.retryable
    assert not isinstance(ei.value, RetryableRemoteError)
    assert c.last_attempts == 1
    c.close()


def test_dropped_request_frame_is_retried(server):
    ctl, addr, _ = server
    chaos = ChaosInjector()
    c = RemoteClient(addr, retry=FAST, chaos=chaos, timeout=TIMEOUT)
    _objects(c)
    chaos.arm("drop")
    c.send_data("d", "s", [{"i": 1}])
    assert c.last_attempts >= 2 and c.total_retries >= 1
    # a dropped request frame times out (or loses its connection)
    assert sum(c.retries_by_error.values()) == c.total_retries
    assert set(c.retries_by_error) <= {"RemoteTimeoutError",
                                      "ConnectionLostError"}
    assert _content(ctl, "d", "s") == [1]
    c.close()


def test_dropped_reply_is_deduplicated_by_idempotency_token(server):
    """The server applied the mutation and the reply died on the wire:
    the retry carries the same token and is answered from the cache."""
    ctl, addr, srv_chaos = server
    c = RemoteClient(addr, retry=FAST, timeout=TIMEOUT)
    _objects(c)
    srv_chaos.arm("drop")
    c.send_data("d", "s", [{"i": 7}])
    assert c.last_attempts >= 2
    assert _content(ctl, "d", "s") == [7]
    c.close()


def test_truncated_reply_is_retried_and_deduplicated(server):
    ctl, addr, srv_chaos = server
    c = RemoteClient(addr, retry=FAST, timeout=TIMEOUT)
    _objects(c)
    srv_chaos.arm("truncate")
    c.send_data("d", "s", [{"i": 3}])
    assert _content(ctl, "d", "s") == [3]
    c.close()


def test_corrupt_request_frame_is_typed_and_retried(server):
    ctl, addr, _ = server
    chaos = ChaosInjector()
    c = RemoteClient(addr, retry=FAST, chaos=chaos, timeout=TIMEOUT)
    _objects(c)
    chaos.arm("corrupt")
    c.send_data("d", "s", [{"i": 9}])
    assert c.last_attempts >= 2
    assert _content(ctl, "d", "s") == [9]
    c.close()


def test_corrupt_request_without_retries_raises_typed(server):
    ctl, addr, _ = server
    chaos = ChaosInjector()
    c = RemoteClient(addr, retry=RetryPolicy(max_attempts=1), chaos=chaos,
                     timeout=TIMEOUT)
    _objects(c)
    chaos.arm("corrupt")
    with pytest.raises(CorruptFrameError):
        c.send_data("d", "s", [{"i": 1}])
    assert _content(ctl, "d", "s") == []  # never executed
    c.close()


def test_delayed_reply_times_out_then_retry_succeeds(server):
    ctl, addr, srv_chaos = server
    c = RemoteClient(addr, timeout=0.3, retry=FAST)
    assert c.ping()["uptime"] >= 0
    srv_chaos.arm("delay", delay_s=1.0)
    assert c.ping()["uptime"] >= 0
    assert c.last_attempts >= 2
    c.close()


def test_per_request_deadline_is_enforced(server):
    ctl, addr, srv_chaos = server
    c = RemoteClient(addr, retry=RetryPolicy(
        max_attempts=10, base_delay_s=0.2, jitter=0.0, deadline_s=0.3))
    assert c.ping()["uptime"] >= 0
    for _ in range(4):
        srv_chaos.arm("drop")
    t0 = time.monotonic()
    with pytest.raises(DeadlineExceededError):
        c.ping()
    assert time.monotonic() - t0 < 2.0
    c.close()


def test_deadline_bounds_a_hung_attempt(server):
    ctl, addr, srv_chaos = server
    c = RemoteClient(addr, retry=RetryPolicy(max_attempts=5,
                                             base_delay_s=0.05, jitter=0.0,
                                             deadline_s=0.4))
    assert c.ping()["uptime"] >= 0
    srv_chaos.arm("delay", delay_s=5.0)
    t0 = time.monotonic()
    with pytest.raises(DeadlineExceededError):
        c.ping()
    assert time.monotonic() - t0 < 2.0
    c.close()


def test_admission_queue_full_is_typed_retryable(tmp_path):
    """One slot held by a slow job: the second job is refused with the
    typed retryable AdmissionFull instead of wedging a thread."""
    from netsdb_tpu_torch.plan.computations import Apply, ScanSet, WriteSet

    ctl = _daemon(tmp_path / "adm", max_jobs=1, admission_timeout_s=0.05)
    addr = ctl.advertise_addr
    try:
        boot = RemoteClient(addr, timeout=TIMEOUT)
        _objects(boot)
        boot.send_data("d", "s", [1, 2, 3])
        boot.close()

        def slow(x):
            time.sleep(1.0)
            return x

        def sink(tag):
            return WriteSet(Apply(ScanSet("d", "s"), slow,
                                  traceable=False), "d", tag)

        hog = RemoteClient(addr, timeout=TIMEOUT)
        t = threading.Thread(target=lambda: hog.execute_computations(
            sink("out_a"), job_name="hog", fetch_results=False))
        t.start()
        time.sleep(0.3)
        c = RemoteClient(addr, retry=RetryPolicy(max_attempts=2,
                                                 base_delay_s=0.01),
                         timeout=TIMEOUT)
        with pytest.raises(AdmissionFullError) as ei:
            c.execute_computations(sink("out_b"), job_name="refused",
                                   fetch_results=False)
        assert ei.value.retryable
        c.close()
        t.join(timeout=30)
        hog.close()
    finally:
        ctl.shutdown()


def test_seeded_chaos_storm_converges(tmp_path):
    """Seeded drops, truncations and corruptions both ways, the fault
    budget capped: every set ends with exactly its one batch."""
    srv_chaos = ChaosInjector(seed=4242, drop=0.10, truncate=0.05,
                              max_faults=4)
    cli_chaos = ChaosInjector(seed=1234, drop=0.12, corrupt=0.08,
                              max_faults=6)
    ctl = _daemon(tmp_path / "storm", chaos=srv_chaos)
    try:
        c = RemoteClient(ctl.advertise_addr,
                         retry=RetryPolicy(max_attempts=10, base_delay_s=0.01,
                                           max_delay_s=0.05),
                         chaos=cli_chaos, timeout=TIMEOUT)
        c.create_database("d")
        for i in range(12):
            c.create_set("d", f"k{i}", type_name="object")
            c.send_data("d", f"k{i}", [{"i": i}])
        for i in range(12):
            assert _content(ctl, "d", f"k{i}") == [i], f"set k{i} diverged"
        assert cli_chaos.faults or srv_chaos.faults
        c.close()
    finally:
        ctl.shutdown()


def test_explicit_duplicate_token_replays_cached_reply(server):
    ctl, addr, _ = server
    c1 = RemoteClient(addr, timeout=TIMEOUT)
    _objects(c1)
    payload = {"db": "d", "set": "s", "items": [{"i": 5}],
               "__idem__": "tok-explicit-1"}
    r1 = c1._request(MsgType.SEND_DATA, payload, codec=CODEC_PICKLE)
    c2 = RemoteClient(addr, timeout=TIMEOUT)
    r2 = c2._request(MsgType.SEND_DATA, payload, codec=CODEC_PICKLE)
    assert r1 == r2
    assert _content(ctl, "d", "s") == [5]
    c1.close()
    c2.close()


def test_store_snapshot_roundtrip(tmp_path):
    from netsdb_tpu_torch.storage import checkpoint

    snap = {"databases": ["d"], "types": [],
            "sets": [{"db": "d", "set": "s", "kind": "objects",
                      "type_name": "object", "persistence": "transient",
                      "items": [{"i": 1}, {"i": 2}]},
                     {"db": "d", "set": "w", "kind": "tensor",
                      "type_name": "tensor", "persistence": "transient",
                      "dense": np.arange(6, dtype=np.float32).reshape(2, 3),
                      "block_shape": [2, 2]}]}
    root = str(tmp_path / "snaps")
    checkpoint.save_store(root, snap, 1)
    checkpoint.save_store(root, snap, 2)
    assert checkpoint.list_steps(root) == [1, 2]
    back = checkpoint.load_store(root)
    assert back["databases"] == ["d"]
    np.testing.assert_array_equal(back["sets"][1]["dense"],
                                  snap["sets"][1]["dense"])


# --- out-of-band segments and pipelined ingest -------------------------

def test_corrupt_oob_segment_is_detected_and_retried(server):
    ctl, addr, _ = server
    chaos = ChaosInjector()
    c = RemoteClient(addr, retry=FAST, chaos=chaos, timeout=TIMEOUT)
    c.create_database("d")
    c.create_set("d", "w")
    a = np.arange(64 * 64, dtype=np.float32).reshape(64, 64)
    chaos.arm("corrupt_seg", types=[MsgType.SEND_MATRIX])
    c.send_matrix("d", "w", a, (32, 32))
    assert c.last_attempts >= 2
    assert any(f[0] == "corrupt_seg" for f in chaos.faults)
    np.testing.assert_array_equal(
        ctl.library.get_tensor("d", "w").to_dense().numpy(), a)
    c.close()


def test_corrupt_oob_reply_segment_is_typed_and_retried(server):
    ctl, addr, srv_chaos = server
    c = RemoteClient(addr, retry=FAST, timeout=TIMEOUT)
    c.create_database("d")
    c.create_set("d", "w")
    a = np.random.default_rng(0).standard_normal((128, 128)).astype(
        np.float32)
    c.send_matrix("d", "w", a, (64, 64))
    srv_chaos.arm("corrupt_seg", types=[MsgType.OK])
    t = c.get_tensor("d", "w")
    assert c.last_attempts >= 2
    np.testing.assert_array_equal(t.to_dense(), a)
    c.close()


def test_truncate_inside_oob_segment_is_retried_exactly_once(server):
    ctl, addr, _ = server
    chaos = ChaosInjector()
    c = RemoteClient(addr, retry=FAST, chaos=chaos, timeout=TIMEOUT)
    c.create_database("d")
    c.create_set("d", "w")
    a = np.ones((256, 256), np.float32) * 3
    chaos.arm("truncate", types=[MsgType.SEND_MATRIX])
    c.send_matrix("d", "w", a, (64, 64))
    assert c.last_attempts >= 2
    np.testing.assert_array_equal(
        ctl.library.get_tensor("d", "w").to_dense().numpy(), a)
    c.close()


@pytest.mark.parametrize("action,n,pad", [("drop", 400, 256),
                                          ("corrupt", 300, 200)])
def test_faulted_mid_pipeline_chunk_applies_once(server, action, n, pad):
    """A chunk dropped or corrupted mid-pipeline tears the conversation
    down; the client re-streams the whole ingest under its one token and
    the set holds one copy (the reference's two mid-pipeline cases)."""
    ctl, addr, _ = server
    chaos = ChaosInjector()
    c = RemoteClient(addr, retry=FAST, chaos=chaos, timeout=TIMEOUT)
    _objects(c)
    items = [{"i": i, "pad": "x" * pad} for i in range(n)]
    chaos.arm(action, types=[MsgType.BULK_CHUNK])
    c.send_data("d", "s", items, pipeline=True, chunk_bytes=4 << 10)
    assert c.last_attempts >= 2
    assert _content(ctl, "d", "s") == list(range(n))
    c.close()


def test_truncated_commit_restreams_exactly_once(server):
    ctl, addr, _ = server
    chaos = ChaosInjector()
    c = RemoteClient(addr, retry=FAST, chaos=chaos, timeout=TIMEOUT)
    _objects(c)
    chaos.arm("truncate", types=[MsgType.BULK_COMMIT])
    c.send_data("d", "s", [{"i": i} for i in range(200)], pipeline=True,
                chunk_bytes=1 << 10)
    assert c.last_attempts >= 2
    assert _content(ctl, "d", "s") == list(range(200))
    c.close()


def test_bulk_duplicate_token_replays_cached_reply(server):
    import pickle

    from netsdb_tpu_torch.serve.protocol import IDEMPOTENCY_KEY

    ctl, addr, _ = server
    c1 = RemoteClient(addr, timeout=TIMEOUT)
    _objects(c1)
    items = [{"i": i} for i in range(50)]
    begin = {"op": int(MsgType.SEND_DATA),
             "meta": {"db": "d", "set": "s", "mode": "items"},
             IDEMPOTENCY_KEY: "tok-bulk-dup-1"}

    def chunks():
        blob = pickle.dumps(items, protocol=pickle.HIGHEST_PROTOCOL)
        yield {"n": len(items), "blob": np.frombuffer(blob, np.uint8)}

    replies = []
    for cl in (c1, RemoteClient(addr, timeout=TIMEOUT)):
        s = cl._dial()
        try:
            replies.append(cl._bulk_once(s, begin, chunks))
        finally:
            s.close()
        cl.close()
    assert replies[0] == replies[1]
    assert _content(ctl, "d", "s") == list(range(50))


# --- follower kill / hang mid-mirror -----------------------------------

@pytest.fixture()
def cluster(tmp_path):
    """Leader and follower with test-speed heartbeats, and an injector
    on the leader→follower mirror frames."""
    fchaos = ChaosInjector()
    fctl = _daemon(tmp_path / "f")
    mctl = _daemon(tmp_path / "m", followers=[fctl.advertise_addr],
                   follower_chaos=fchaos, heartbeat_interval_s=0.1,
                   heartbeat_timeout_s=0.5, heartbeat_misses=2,
                   mirror_ack_timeout_s=0.5, resync_grace_s=2.0)
    try:
        yield mctl, fctl, mctl.advertise_addr, fchaos
    finally:
        mctl.shutdown()
        fctl.shutdown()


def _wait_reattached(mctl, timeout_s=20.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        st = mctl.follower_status()
        if st["active"] and not st["degraded"]:
            return
        time.sleep(0.05)
    raise AssertionError(
        f"follower never reattached: {mctl.follower_status()}")


def test_follower_killed_mid_mirror_recovers_via_resync(cluster):
    mctl, fctl, addr, fchaos = cluster
    c = RemoteClient(addr, retry=FAST, timeout=TIMEOUT)
    _objects(c)
    fchaos.arm("kill")
    c.send_data("d", "s", [{"i": 1}])  # the mirror dies; local applies
    assert c.last_attempts >= 2  # the first attempt: FollowerDegraded
    assert _content(mctl, "d", "s") == [1]
    assert any(f[0] == "kill" for f in fchaos.faults)
    _wait_reattached(mctl)
    assert _content(fctl, "d", "s") == [1]
    c.send_data("d", "s", [{"i": 2}])
    assert _content(mctl, "d", "s") == _content(fctl, "d", "s") == [1, 2]
    c.close()


def test_follower_hang_mid_mirror_is_bounded_and_recovers(cluster):
    mctl, fctl, addr, fchaos = cluster
    c = RemoteClient(addr, retry=FAST, timeout=TIMEOUT)
    _objects(c)
    fchaos.arm("delay", delay_s=3.0)  # past mirror_ack_timeout_s
    t0 = time.monotonic()
    c.send_data("d", "s", [{"i": 1}])
    assert time.monotonic() - t0 < 2.5
    assert _content(mctl, "d", "s") == [1]
    _wait_reattached(mctl)
    assert _content(mctl, "d", "s") == _content(fctl, "d", "s") == [1]
    c.close()


def test_mirror_forwards_idempotency_token_to_followers(cluster):
    mctl, fctl, addr, _ = cluster
    c = RemoteClient(addr, timeout=TIMEOUT)
    _objects(c)
    payload = {"db": "d", "set": "s", "items": [{"i": 1}],
               "__idem__": "tok-fwd-1"}
    c._request(MsgType.SEND_DATA, payload, codec=CODEC_PICKLE)
    assert "tok-fwd-1" in fctl._idem._done
    fc = RemoteClient(fctl.advertise_addr, timeout=TIMEOUT)
    fc._request(MsgType.SEND_DATA, payload, codec=CODEC_PICKLE)
    assert _content(fctl, "d", "s") == [1]
    c.close()
    fc.close()


def test_paged_set_survives_resync(tmp_path):
    """A paged relation on the leader re-pages on the resynced follower
    (the host chunk table re-ingested), and later frames on it do not
    evict the follower again."""
    from netsdb_tpu_torch.relational.outofcore import PagedColumns
    from netsdb_tpu_torch.storage.store import SetIdentifier

    cfg = dict(page_size_bytes=4096, page_pool_bytes=16384)
    fctl = ServeController(Configuration(root_dir=str(tmp_path / "f"),
                                         **cfg), port=0, device="cpu")
    fctl.start()
    fchaos = ChaosInjector()
    mctl = ServeController(
        Configuration(root_dir=str(tmp_path / "m"), **cfg), port=0,
        device="cpu", followers=[fctl.advertise_addr], follower_chaos=fchaos,
        heartbeat_interval_s=0.1, heartbeat_timeout_s=0.5,
        heartbeat_misses=2, mirror_ack_timeout_s=1.0)
    mctl.start()
    try:
        c = RemoteClient(mctl.advertise_addr, retry=FAST, timeout=TIMEOUT)
        c.create_database("d")
        c.create_set("d", "pg", type_name="table", storage="paged")
        c.send_table("d", "pg", [{"a": i, "b": float(i) * 0.5}
                                 for i in range(600)])
        fchaos.arm("kill")
        c.create_set("d", "other", type_name="object")  # the mirror dies
        _wait_reattached(mctl)

        def rows_of(ctl):
            items = ctl.library.store.get_items(SetIdentifier("d", "pg"))
            assert len(items) == 1 and isinstance(items[0], PagedColumns)
            t = items[0].to_host_table()
            return sorted(zip(np.asarray(t.cols["a"]).tolist(),
                              np.asarray(t.cols["b"]).tolist()))

        mt, ft = rows_of(mctl), rows_of(fctl)
        assert mt == ft and len(mt) == 600
        c.send_table("d", "pg", [{"a": 600, "b": 300.0}], append=True)
        time.sleep(0.5)
        assert not mctl.follower_status()["degraded"]
        assert rows_of(mctl) == rows_of(fctl)
        c.close()
    finally:
        mctl.shutdown()
        fctl.shutdown()


def test_typed_error_surfaces_without_retries(cluster):
    mctl, fctl, addr, fchaos = cluster
    c = RemoteClient(addr, retry=RetryPolicy(max_attempts=1),
                     timeout=TIMEOUT)
    _objects(c)
    fchaos.arm("kill")
    with pytest.raises(FollowerDegradedError) as ei:
        c.send_data("d", "s", [{"i": 4}])
    assert ei.value.retryable
    assert _content(mctl, "d", "s") == [4]
    _wait_reattached(mctl)
    assert _content(fctl, "d", "s") == [4]
    c.close()
