"""Followers and mirroring through the port's daemons, in this process
(``port=0``, ``device="cpu"``, every daemon shut down in ``finally``):
the reference's ``tests/test_serve_follower_concurrency.py`` — a leader
and its follower converge under conflicting writers, and a dead
follower is evicted while the leader keeps serving — then the port's
resync cases: a snapshot streamed over RESYNC_FOLLOWER and a
mutation-log replay each leave the follower's store equal to the
leader's, set kind by set kind; a follower's applied log compacts
within its bound, so a restart on its root replays only its tail; and a
FF request and a transformer-layer
request run through a port leader and its follower, each output equal
to the reference daemon's for the same seeded inputs."""

import threading
import time

import numpy as np
import pytest
import torch

from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.serve.chaos import ChaosInjector
from netsdb_tpu_torch.serve.client import RemoteClient, RetryPolicy
from netsdb_tpu_torch.serve.server import ServeController

TIMEOUT = 60.0
FAST = RetryPolicy(max_attempts=5, base_delay_s=0.01, max_delay_s=0.1)
LINKS = dict(heartbeat_interval_s=0.1, heartbeat_timeout_s=0.5,
             heartbeat_misses=2, mirror_ack_timeout_s=2.0,
             resync_grace_s=5.0)
PAGED = dict(page_size_bytes=4096, page_pool_bytes=16384)


def _daemon(root, cfg=None, **kw):
    ctl = ServeController(Configuration(root_dir=str(root), **(cfg or {})),
                          port=0, device="cpu", **kw)
    ctl.start()
    return ctl


@pytest.fixture()
def master_follower(tmp_path):
    fctl = _daemon(tmp_path / "f")
    mctl = _daemon(tmp_path / "m", followers=[fctl.advertise_addr])
    try:
        yield mctl, fctl, mctl.advertise_addr
    finally:
        mctl.shutdown()
        fctl.shutdown()


def _remote(addr, **kw):
    kw.setdefault("timeout", TIMEOUT)
    return RemoteClient(addr, **kw)


def _wait_for(pred, timeout_s=20.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def _wait_reattached(mctl, timeout_s=20.0):
    assert _wait_for(lambda: mctl.follower_status()["active"]
                     and not mctl.follower_status()["degraded"],
                     timeout_s), mctl.follower_status()


# --- convergence under concurrency (the reference's four cases) --------

def test_conflicting_mutations_converge(master_follower):
    """Threads race SEND_DATA and CLEAR_SET on one set: leader and
    follower end with the same content (per-set ordering)."""
    mctl, fctl, addr = master_follower
    boot = _remote(addr)
    boot.create_database("d")
    boot.create_set("d", "hot", type_name="object")
    boot.close()
    errors = []

    def hammer(tag):
        try:
            c = _remote(addr)
            for i in range(10):
                c.send_data("d", "hot", [{"tag": tag, "i": i}])
                if i % 4 == 3:
                    c.clear_set("d", "hot")
            c.close()
        except Exception as e:  # pragma: no cover - surfaced below
            errors.append(f"{tag}: {e!r}")

    threads = [threading.Thread(target=hammer, args=(t,)) for t in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors

    def content(ctl):
        return sorted((r["tag"], r["i"]) for r in
                      ctl.library.get_set_iterator("d", "hot"))

    assert content(mctl) == content(fctl)


def test_disjoint_sets_mutate_concurrently_and_converge(master_follower):
    mctl, fctl, addr = master_follower
    boot = _remote(addr)
    boot.create_database("d")
    for t in range(4):
        boot.create_set("d", f"s{t}", type_name="object")
    boot.close()
    errors = []

    def hammer(tag):
        try:
            c = _remote(addr)
            for i in range(12):
                c.send_data("d", f"s{tag}", [i * 10 + tag])
            c.close()
        except Exception as e:  # pragma: no cover
            errors.append(f"{tag}: {e!r}")

    threads = [threading.Thread(target=hammer, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    for t in range(4):
        m = list(mctl.library.get_set_iterator("d", f"s{t}"))
        f = list(fctl.library.get_set_iterator("d", f"s{t}"))
        assert m == f and len(m) == 12


def test_jobs_and_mutations_interleave_correctly(master_follower):
    """EXECUTE (exclusive order) racing SEND (shared order) on the set
    it scans: every job sees a prefix of the sends, never a torn mix,
    and the stores end equal."""
    from netsdb_tpu_torch.plan.computations import Aggregate, ScanSet, \
        WriteSet

    mctl, fctl, addr = master_follower
    boot = _remote(addr)
    boot.create_database("d")
    boot.create_set("d", "nums", type_name="object")
    boot.close()
    errors, sums = [], []

    def sender():
        try:
            c = _remote(addr)
            for i in range(1, 21):
                c.send_data("d", "nums", [i])
            c.close()
        except Exception as e:  # pragma: no cover
            errors.append(repr(e))

    def runner():
        try:
            c = _remote(addr)
            for j in range(6):
                sink = WriteSet(
                    Aggregate(ScanSet("d", "nums"), key=lambda _x: 0,
                              value=lambda x: x,
                              combine=lambda a, b: a + b,
                              label=f"sum{j}"), "d", f"out{j}")
                c.execute_computations(sink, job_name=f"job{j}",
                                       fetch_results=False)
                items = dict(c.get_set_iterator("d", f"out{j}"))
                sums.append(items.get(0, 0))
            c.close()
        except Exception as e:  # pragma: no cover
            errors.append(repr(e))

    ts = [threading.Thread(target=sender), threading.Thread(target=runner)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not errors, errors
    valid = {n * (n + 1) // 2 for n in range(21)}
    assert all(s in valid for s in sums), (sums, valid)
    assert sorted(mctl.library.get_set_iterator("d", "nums")) == \
        sorted(fctl.library.get_set_iterator("d", "nums")) == \
        list(range(1, 21))
    for j in range(6):  # each job's output mirrored alike
        assert dict(mctl.library.get_set_iterator("d", f"out{j}")) == \
            dict(fctl.library.get_set_iterator("d", f"out{j}"))


def test_dead_follower_is_evicted_and_leader_keeps_serving(tmp_path):
    fctl = _daemon(tmp_path / "f")
    mctl = _daemon(tmp_path / "m", followers=[fctl.advertise_addr],
                   heartbeat_interval_s=0.1, heartbeat_timeout_s=0.3,
                   heartbeat_misses=2, mirror_ack_timeout_s=2.0)
    try:
        c = _remote(mctl.advertise_addr,
                    retry=RetryPolicy(max_attempts=5, base_delay_s=0.02))
        c.create_database("d")
        c.create_set("d", "s", type_name="object")
        c.send_data("d", "s", [{"i": 0}])
        assert [r["i"] for r in fctl.library.get_set_iterator("d", "s")] \
            == [0]
        fctl.shutdown()
        assert _wait_for(lambda: mctl.follower_status()["degraded"])
        status = mctl.follower_status()
        assert status["degraded"] and not status["active"], status
        c.send_data("d", "s", [{"i": 1}])
        assert sorted(r["i"] for r in c.get_set_iterator("d", "s")) == [0, 1]
        assert c.ping()["followers"]["degraded"]
        c.close()
    finally:
        mctl.shutdown()
        fctl.shutdown()


# --- resync: snapshot and log replay -----------------------------------

def _state(ctl) -> dict:
    """Every set of a daemon as host values, by kind (what "the same
    store" means): tensors and tables by their bytes, paged relations
    by their host table, paged matrices by their arena blocks."""
    from netsdb_tpu_torch.core.blocked import BlockedTensor
    from netsdb_tpu_torch.parallel.mesh import ShardedTensor
    from netsdb_tpu_torch.relational.outofcore import PagedColumns
    from netsdb_tpu_torch.relational.table import ColumnTable
    from netsdb_tpu_torch.storage.paged import PagedObjects
    from netsdb_tpu_torch.storage.store import _PagedMatrix

    store = ctl.library.store
    out = {}
    for ident in store.list_sets():
        items = store.get_items(ident)
        vals = []
        for it in items:
            if isinstance(it, BlockedTensor):
                vals.append(("bt", it.meta, it.data.numpy().tobytes()))
            elif isinstance(it, PagedColumns):
                t = it.to_host_table()
                vals.append(("pc", {k: np.asarray(v).tobytes()
                                    for k, v in t.cols.items()}))
            elif isinstance(it, ColumnTable):
                vals.append(("ct", {k: v.numpy().tobytes()
                                    for k, v in it.cols.items()},
                             {k: list(v) for k, v in it.dicts.items()}))
            elif isinstance(it, PagedObjects):
                vals.append(("po", list(it)))
            elif isinstance(it, _PagedMatrix):
                ps = store.page_store()
                vals.append(("pm", [b.tobytes() for _, b in
                                    ps.stream_blocks(it.name, prefetch=0)]))
            elif isinstance(it, torch.Tensor):
                vals.append(("t", it.numpy().tobytes()))
            elif isinstance(it, ShardedTensor):
                vals.append(("st", it.spec, it.mesh.shape,
                             it.to_dense().numpy().tobytes()))
            else:
                vals.append(("o", it))
        out[str(ident)] = (store.storage_of(ident), vals)
    return out


def _fill(c, rng, tag=0):
    """One set of each kind the snapshot handles."""
    c.create_database("d")
    c.create_set("d", "objs", type_name="object")
    c.send_data("d", "objs", [{"i": i, "t": tag} for i in range(5)])
    c.create_set("d", "w")
    c.send_matrix("d", "w", rng.standard_normal((20, 12)).astype(
        np.float32), (8, 8))
    c.create_set("d", "tab", type_name="table")
    c.send_table("d", "tab", [{"a": i, "b": float(i) / 3}
                              for i in range(40)])
    c.create_set("d", "pt", type_name="table", storage="paged")
    c.send_table("d", "pt", [{"a": i, "s": f"k{i % 3}"}
                             for i in range(300)])
    c.create_set("d", "pm", storage="paged")
    c.send_matrix("d", "pm", rng.standard_normal((100, 16)).astype(
        np.float32))
    c.create_set("d", "po", type_name="object", storage="paged")
    c.send_data("d", "po", [{"r": i} for i in range(30)])
    # a placed one-tensor set (the layer's input: a trivial placement)
    from netsdb_tpu_torch.models.transformer import TransformerLayerModel

    layer = TransformerLayerModel(db="lay", num_heads=2)
    layer.setup(c)
    layer.load_inputs(c, rng.standard_normal((2, 4, 8)).astype(np.float32))


def test_snapshot_resync_leaves_the_follower_store_equal(tmp_path):
    """A follower evicted with every kind of set on the leader (objects,
    a blocked matrix, a table, a paged relation, a paged matrix, paged
    records) comes back by a snapshot streamed over RESYNC_FOLLOWER and
    holds the leader's store, set by set and byte by byte."""
    fctl = _daemon(tmp_path / "f", PAGED)
    mctl = _daemon(tmp_path / "m", PAGED, followers=[fctl.advertise_addr],
                   **LINKS)
    try:
        c = _remote(mctl.advertise_addr, retry=FAST)
        _fill(c, np.random.default_rng(0))
        assert _state(mctl) == _state(fctl)
        mctl._evict_follower(fctl.advertise_addr, "test eviction")
        # mutations go on while it is away: the resync must carry them
        c.send_data("d", "objs", [{"i": 99, "t": 1}])
        c.send_matrix("d", "pm", np.ones((30, 16), np.float32))
        _wait_reattached(mctl)
        assert mctl.last_resync["mode"] == "snapshot"
        assert fctl.last_resync_mode == "wire"
        assert mctl.last_resync["bytes"] > 0
        assert _state(mctl) == _state(fctl)
        assert len(_state(fctl)) == 11
        c.close()
    finally:
        mctl.shutdown()
        fctl.shutdown()


def test_log_replay_resync_leaves_the_follower_store_equal(tmp_path):
    """``ha_mutlog``: a follower killed mid-mirror resumes by replaying
    only the frames after its last ack — the frames it missed, the
    failed one included, each under its token — and ends equal."""
    fchaos = ChaosInjector()
    fctl = _daemon(tmp_path / "f", PAGED)
    mctl = _daemon(tmp_path / "m", dict(PAGED, ha_mutlog=True),
                   followers=[fctl.advertise_addr], follower_chaos=fchaos,
                   **LINKS)
    try:
        c = _remote(mctl.advertise_addr, retry=FAST)
        _fill(c, np.random.default_rng(1))
        off = mctl.mutlog.last_offset()
        fchaos.arm("kill")
        c.send_data("d", "objs", [{"i": 50, "t": 2}])  # the mirror dies
        assert c.last_attempts >= 2
        _wait_reattached(mctl)
        assert mctl.last_resync["mode"] == "log"
        assert mctl.last_resync["frames"] >= 1
        # the failed frame, and its retry's re-mirror when that came
        # first (both under one token: the follower applies it once)
        assert 0 < mctl.last_resync["bytes"] <= \
            mctl.mutlog.last_offset() - off
        assert fctl.last_resync_mode is None  # no snapshot was streamed
        assert _state(mctl) == _state(fctl)
        # a second outage resumes from the new offset
        mctl._evict_follower(fctl.advertise_addr, "again")
        c.send_table("d", "pt", [{"a": 1000, "s": "k0"}], append=True)
        _wait_reattached(mctl)
        assert mctl.last_resync["mode"] == "log"
        assert mctl.last_resync["frames"] == 1
        assert _state(mctl) == _state(fctl)
        c.close()
    finally:
        mctl.shutdown()
        fctl.shutdown()


def test_log_replay_of_an_applied_frame_dedupes(tmp_path):
    """A follower that applied a frame whose ack was lost replays it
    under the same token: it dedupes, never applies twice."""
    fchaos = ChaosInjector()
    fctl = _daemon(tmp_path / "f", chaos=fchaos)
    mctl = _daemon(tmp_path / "m", dict(ha_mutlog=True),
                   followers=[fctl.advertise_addr], **LINKS)
    try:
        c = _remote(mctl.advertise_addr, retry=FAST)
        c.create_database("d")
        c.create_set("d", "s", type_name="object")
        fchaos.arm("drop")  # the follower applies, its ack dies
        c.send_data("d", "s", [{"i": 1}])
        _wait_reattached(mctl)
        assert mctl.last_resync["mode"] == "log"
        for ctl in (mctl, fctl):
            assert [r["i"] for r in ctl.library.get_set_iterator("d", "s")] \
                == [1]
        c.close()
    finally:
        mctl.shutdown()
        fctl.shutdown()


# --- served requests through a leader and its follower -----------------

def test_ff_and_layer_requests_through_leader_and_follower_match_the_reference(
        tmp_path):
    """A FF request and a transformer-layer request through a port
    leader: the leader's output and its follower's (read from the
    follower directly) equal the reference daemon's for the same seeded
    inputs (FF 1e-5, the layer 1e-4, the limits of the one-daemon
    parity tests), and equal each other exactly."""
    from netsdb_tpu.config import Configuration as RefConfig
    from netsdb_tpu.models.ff import FFModel as RefFF
    from netsdb_tpu.models.transformer import TransformerLayerModel as RefL
    from netsdb_tpu.plan.executor import clear_compiled_cache
    from netsdb_tpu.serve.client import RemoteClient as RefRemote
    from netsdb_tpu.serve.server import ServeController as RefController
    from netsdb_tpu_torch.models.ff import FFModel
    from netsdb_tpu_torch.models.transformer import TransformerLayerModel

    rng = np.random.default_rng(3)
    feat, hid, lab = 32, 48, 8
    w1 = (rng.standard_normal((hid, feat)) * 0.1).astype(np.float32)
    b1 = (rng.standard_normal((hid,)) * 0.1).astype(np.float32)
    wo = (rng.standard_normal((lab, hid)) * 0.1).astype(np.float32)
    bo = (rng.standard_normal((lab,)) * 0.1).astype(np.float32)
    x = rng.standard_normal((24, feat)).astype(np.float32)
    xl = rng.standard_normal((2, 64, 64)).astype(np.float32)

    def run(model_cls, layer_cls, client):
        ff = model_cls(db="ffd", block=(16, 16))
        ff.setup(client)
        ff.load_weights(client, w1, b1, wo, bo)
        ff.load_inputs(client, x)
        (ident, _), = client.execute_computations(
            ff.build_inference_dag(), job_name="ff").items()
        layer = layer_cls(num_heads=4)
        layer.setup(client)
        layer.load_random_weights(client, embed=64, seed=0)
        layer.load_inputs(client, xl)
        layer.serve_forward(client)
        return ident, layer.db

    fctl = _daemon(tmp_path / "f")
    mctl = _daemon(tmp_path / "m", followers=[fctl.advertise_addr])
    clear_compiled_cache()
    ref = RefController(RefConfig(root_dir=str(tmp_path / "ref")), port=0)
    ref_port = ref.start()
    try:
        c = _remote(mctl.advertise_addr)
        ident, ldb = run(FFModel, TransformerLayerModel, c)
        rc = RefRemote(f"127.0.0.1:{ref_port}", timeout=TIMEOUT)
        rident, rldb = run(RefFF, RefL, rc)
        want_ff = rc.get_tensor(*rident).to_dense()
        want_y = np.asarray(list(rc.get_set_iterator(rldb, "y"))[0])
        rc.close()
        outs = []
        for ctl in (mctl, fctl):
            cc = _remote(ctl.advertise_addr)
            got_ff = cc.get_tensor(*ident).to_dense()
            (got_y,) = list(cc.get_set_iterator(ldb, "y"))
            cc.close()
            np.testing.assert_allclose(got_ff, want_ff, atol=1e-5)
            np.testing.assert_allclose(np.asarray(got_y), want_y,
                                       rtol=1e-4, atol=1e-4)
            outs.append((got_ff.tobytes(), np.asarray(got_y).tobytes()))
        assert outs[0] == outs[1]  # the follower ran the same job
        c.close()
    finally:
        ref.shutdown()
        mctl.shutdown()
        fctl.shutdown()


def test_abort_closed_link_counts_dropped_frames():
    """``close(abort=True)`` with frames still queued: each frame behind
    the one in flight fails fast and ticks ``serve.mirror_dropped``; a
    submit after close refuses without counting."""
    from netsdb_tpu_torch import obs
    from netsdb_tpu_torch.serve.protocol import CODEC_PICKLE, MsgType
    from netsdb_tpu_torch.serve.server import _FollowerLink

    class _Gate:
        def __init__(self):
            self.release = threading.Event()
            self.calls = 0

        def _request(self, typ, payload, codec):
            self.calls += 1
            self.release.wait(10)
            return {"ok": True}

        def _force_close(self):
            self.release.set()

        def close(self):
            pass

    def dropped():
        return obs.REGISTRY.counter("serve.mirror_dropped").value

    gate = _Gate()
    link = _FollowerLink("gate:1", gate)
    r1 = link.submit(MsgType.SEND_DATA, {"i": 1}, CODEC_PICKLE)
    assert _wait_for(lambda: gate.calls == 1)
    r2 = link.submit(MsgType.SEND_DATA, {"i": 2}, CODEC_PICKLE)
    r3 = link.submit(MsgType.SEND_DATA, {"i": 3}, CODEC_PICKLE)
    d0 = dropped()
    link.close(abort=True)
    assert r1["done"].wait(5) and "reply" in r1
    assert r2["done"].wait(5) and r3["done"].wait(5)
    assert dropped() == d0 + 2
    assert "not forwarded" in r2["error"] and "not forwarded" in r3["error"]
    r4 = link.submit(MsgType.SEND_DATA, {"i": 4}, CODEC_PICKLE)
    assert r4["done"].is_set() and "closed" in r4["error"]
    assert dropped() == d0 + 2


# --- the follower's half of the mutation log ---------------------------

def _restart(ctl, cfg):
    """The same daemon again, on its root and port (a process restart;
    the old one is shut down first)."""
    root, port = ctl.config.root_dir, ctl.port
    ctl.shutdown()
    back = ServeController(Configuration(root_dir=root, **cfg), port=port,
                           device="cpu")
    back.start()
    return back


def _job(c):
    from netsdb_tpu_torch.plan.computations import Aggregate, ScanSet, \
        WriteSet

    c.execute_computations(WriteSet(
        Aggregate(ScanSet("d", "objs"), key=lambda r: r["t"],
                  value=lambda r: r["i"], combine=lambda a, b: a + b,
                  label="by_t"), "d", "sums"), job_name="sums",
        fetch_results=False)


@pytest.mark.parametrize("same_root", [True, False])
def test_restarted_follower_resumes_from_what_it_holds(tmp_path, same_root):
    """``ha_mutlog`` on both sides. A follower that dies and comes back
    on its root rebuilds its store from its applied log before it
    serves, reports the leader-log position it holds in its handshake,
    and is readmitted by log replay from there; one that comes back on
    an empty root holds nothing and is readmitted by a snapshot. Either
    way it ends with the leader's store — including a job's output."""
    cfg = dict(PAGED, ha_mutlog=True)
    fctl = _daemon(tmp_path / "f", cfg)
    faddr = fctl.advertise_addr
    mctl = _daemon(tmp_path / "m", cfg, followers=[faddr], **LINKS)
    try:
        c = _remote(mctl.advertise_addr, retry=FAST)
        _fill(c, np.random.default_rng(2))
        _job(c)
        assert _state(mctl) == _state(fctl)
        held = fctl._applied_pos
        assert held and held[0] == mctl._mutlog_id
        if same_root:
            fctl = _restart(fctl, cfg)
            # rebuilt before it served a frame, at the position it held
            assert fctl._applied_pos == held
            assert _state(fctl) == _state(mctl)
        else:
            port = fctl.port
            fctl.shutdown()
            fctl = ServeController(
                Configuration(root_dir=str(tmp_path / "empty"), **cfg),
                port=port, device="cpu")
            fctl.start()
            assert fctl._applied_pos is None and _state(fctl) == {}
        # writes while the leader has not noticed yet: its mirror fails,
        # the follower is evicted, the client's retry is answered
        c.send_data("d", "objs", [{"i": 7, "t": 3}])
        _job(c)
        _wait_reattached(mctl)
        want = "log" if same_root else "snapshot"
        assert _wait_for(lambda: (mctl.last_resync or {}).get("mode")
                         == want and mctl.follower_status()["active"])
        assert _state(mctl) == _state(fctl)
        c.close()
    finally:
        mctl.shutdown()
        fctl.shutdown()


@pytest.mark.parametrize("bound", ["frames", "bytes"])
def test_restart_replays_no_more_than_the_applied_log_bound(tmp_path, bound):
    """A follower's applied log compacts once it passes its bound (a
    frame count, or more bytes than both a floor and its base snapshot):
    its own store becomes the log's base and the log restarts empty. A
    restart on its root loads that base and replays no more than the
    bound, ends equal to the leader, and is readmitted by log replay."""
    cfg = dict(PAGED, ha_mutlog=True)
    fctl = _daemon(tmp_path / "f", cfg)
    if bound == "frames":
        fctl.applied_log_max_frames = 4
    else:
        fctl.applied_log_max_bytes = 1  # the base snapshot's size rules
    mctl = _daemon(tmp_path / "m", cfg, followers=[fctl.advertise_addr],
                   **LINKS)
    try:
        c = _remote(mctl.advertise_addr, retry=FAST)
        _fill(c, np.random.default_rng(3))
        for t in range(6):
            c.send_data("d", "objs", [{"i": 100 + t, "t": t}])
        _job(c)
        assert _state(mctl) == _state(fctl)
        comp = fctl.last_applied_compaction
        assert comp is not None and comp["snapshot_bytes"] > 0
        cap_frames = fctl.applied_log_max_frames
        cap_bytes = max(fctl.applied_log_max_bytes,
                        fctl._applied_base_bytes)
        assert fctl._applied_frames < cap_frames
        assert fctl._applied_log.last_offset() <= cap_bytes
        held = fctl._applied_pos
        fctl = _restart(fctl, cfg)
        r = fctl.last_applied_restore
        assert r["snapshot_bytes"] > 0
        assert r["frames"] < cap_frames and r["log_bytes"] <= cap_bytes
        assert fctl._applied_pos == held
        assert _state(fctl) == _state(mctl)
        c.send_data("d", "objs", [{"i": 7, "t": 3}])
        _wait_reattached(mctl)
        assert _wait_for(lambda: (mctl.last_resync or {}).get("mode")
                         == "log" and mctl.follower_status()["active"])
        assert _state(mctl) == _state(fctl)
        c.close()
    finally:
        mctl.shutdown()
        fctl.shutdown()


def test_a_crash_inside_a_compaction_applies_nothing_twice(tmp_path):
    """A follower that died after its compaction renamed the new base in
    but before it emptied the log restarts on that base alone: the
    records logged on the old base are skipped, so no frame applies
    twice."""
    cfg = dict(ha_mutlog=True)
    fctl = _daemon(tmp_path / "f", cfg)
    mctl = _daemon(tmp_path / "m", cfg, followers=[fctl.advertise_addr],
                   **LINKS)
    try:
        c = _remote(mctl.advertise_addr, retry=FAST)
        c.create_database("d")
        c.create_set("d", "s", type_name="object")
        c.send_data("d", "s", [{"i": 1}])
        fctl._applied_log.truncate = lambda: None  # dies before emptying
        fctl.applied_log_max_frames = 1
        c.send_data("d", "s", [{"i": 2}])
        assert fctl.last_applied_compaction is not None
        assert fctl._applied_log.last_offset() > 0  # the old records stay
        fctl = _restart(fctl, dict(cfg))
        assert fctl.last_applied_restore["frames"] == 0
        assert sorted(r["i"] for r in fctl.library.get_set_iterator(
            "d", "s")) == [1, 2]
        c.send_data("d", "s", [{"i": 3}])
        _wait_reattached(mctl)
        assert _wait_for(lambda: (mctl.last_resync or {}).get("mode")
                         == "log" and mctl.follower_status()["active"])
        assert _state(mctl) == _state(fctl)
        c.close()
    finally:
        mctl.shutdown()
        fctl.shutdown()


def test_an_open_decode_session_defers_the_compaction(tmp_path):
    """A snapshot holds sets, not decode sessions: while a mirrored
    session is open on the follower its applied log grows past its
    bound uncompacted, and it compacts once the session closes."""
    from netsdb_tpu_torch.models.decode import deploy_decode_model

    cfg = dict(ha_mutlog=True)
    fctl = _daemon(tmp_path / "f", cfg)
    fctl.applied_log_max_frames = 1
    mctl = _daemon(tmp_path / "m", cfg, followers=[fctl.advertise_addr],
                   **LINKS)
    try:
        c = _remote(mctl.advertise_addr, retry=FAST)
        deploy_decode_model(c, "m1", kind="lstm", hidden=16, seed=3)
        before = fctl.last_applied_compaction
        assert before is not None and fctl._applied_frames == 0
        h = c.open_session("m1", kind="lstm")
        for step in range(2):
            h.generate(np.random.default_rng(step).standard_normal(
                16).astype(np.float32))
        assert fctl.last_applied_compaction is before
        assert fctl._applied_frames == 3
        assert h.close()
        assert fctl.last_applied_compaction is not before
        assert fctl._applied_frames == 0
        assert _state(fctl) == _state(mctl)
        c.close()
    finally:
        mctl.shutdown()
        fctl.shutdown()


def test_a_follower_restarted_without_its_log_is_never_replayed(tmp_path):
    """The leader keeps a mutation log but the follower does not: after
    a restart it holds nothing, and the offset it acked as another
    process is not trusted — it is readmitted by a snapshot."""
    fctl = _daemon(tmp_path / "f")
    mctl = _daemon(tmp_path / "m", dict(ha_mutlog=True),
                   followers=[fctl.advertise_addr], **LINKS)
    try:
        c = _remote(mctl.advertise_addr, retry=FAST)
        c.create_database("d")
        c.create_set("d", "s", type_name="object")
        c.send_data("d", "s", [{"i": 1}])
        fctl = _restart(fctl, {})
        c.send_data("d", "s", [{"i": 2}])
        _wait_reattached(mctl)
        assert _wait_for(lambda: (mctl.last_resync or {}).get("mode")
                         == "snapshot")
        assert sorted(r["i"] for r in fctl.library.get_set_iterator(
            "d", "s")) == [1, 2]
        c.close()
    finally:
        mctl.shutdown()
        fctl.shutdown()


@pytest.mark.parametrize("bulk", [False, True])
def test_retried_mutation_remirrors_to_a_follower_that_missed_it(tmp_path,
                                                                  bulk):
    """A leader applied a frame its follower never got (a deposed
    leader's last frame): the client's retry, answered from the cache,
    is mirrored again — a bulk conversation streams again for it — the
    follower applies it once, and a further retry dedupes everywhere."""
    from netsdb_tpu_torch.serve.protocol import CODEC_PICKLE, MsgType

    fctl = _daemon(tmp_path / "f")
    mctl = _daemon(tmp_path / "m", followers=[fctl.advertise_addr])
    try:
        c = _remote(mctl.advertise_addr)
        c.create_database("d")
        c.create_set("d", "s", type_name="object")
        items = [{"i": i} for i in range(100 if bulk else 1)]

        def send():
            if bulk:
                c._bulk_request(MsgType.SEND_DATA, {"db": "d", "set": "s",
                                                    "mode": "items"},
                                c._item_chunks(items, 1024),
                                token="tok-missed")
            else:
                c._request(MsgType.SEND_DATA,
                           {"db": "d", "set": "s", "items": items,
                            "__idem__": "tok-missed"}, codec=CODEC_PICKLE)

        followers, mctl._follower_addrs = mctl._follower_addrs, []
        send()
        mctl._follower_addrs = followers
        assert list(fctl.library.get_set_iterator("d", "s")) == []
        for _ in range(2):
            send()
            for ctl in (mctl, fctl):
                assert [r["i"] for r in
                        ctl.library.get_set_iterator("d", "s")] == \
                    list(range(len(items)))
        c.close()
    finally:
        mctl.shutdown()
        fctl.shutdown()
