"""The v3 data plane through the port's daemon — the one-daemon cases of
the reference's ``tests/test_serve_dataplane.py``: out-of-band tensor
framing (one vectored send, no copies, checksummed segments, writable
arrays on receive), the typed refusal of another wire version, and the
windowed pipelined ingest, held to the reference's local ``Client`` on
the same inputs; then the replication slice's cases: a follower resync
streamed over the wire between disjoint roots, and hedged reads and
streams over a replica. Every daemon listens on port 0 and is shut down
in ``finally``; every client has a socket timeout."""

import socket
import struct

import numpy as np
import pytest
import torch

from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.serve import client as client_mod
from netsdb_tpu_torch.serve import protocol
from netsdb_tpu_torch.serve.client import RemoteClient, RemoteError
from netsdb_tpu_torch.serve.protocol import (CODEC_MSGPACK_OOB, MsgType,
                                             OOB_MIN_BYTES, PROTO_VERSION,
                                             recv_frame, send_frame)
from netsdb_tpu_torch.serve.server import ServeController

TIMEOUT = 60.0


@pytest.fixture()
def daemon(tmp_path):
    ctl = ServeController(Configuration(root_dir=str(tmp_path / "d")),
                          port=0, device="cpu")
    ctl.start()
    rc = None
    try:
        rc = RemoteClient(ctl.advertise_addr, timeout=TIMEOUT)
        yield ctl, rc
    finally:
        if rc is not None:
            rc.close()
        ctl.shutdown()


class _FakeSock:
    def __init__(self):
        self.sendmsg_calls = []
        self.sendall_calls = 0

    def sendmsg(self, buffers):
        bufs = [bytes(b) for b in buffers]
        self.sendmsg_calls.append(bufs)
        return sum(len(b) for b in bufs)

    def sendall(self, data):
        self.sendall_calls += 1


def test_send_frame_is_one_vectored_send_for_small_frames():
    s = _FakeSock()
    send_frame(s, MsgType.PING, {"x": 1})
    assert s.sendall_calls == 0 and len(s.sendmsg_calls) == 1
    magic, codec, typ, body_len = struct.unpack("!HBIQ",
                                                s.sendmsg_calls[0][0])
    assert (magic, codec, typ) == (protocol.MAGIC, protocol.CODEC_MSGPACK,
                                   int(MsgType.PING))
    assert sum(len(b) for b in s.sendmsg_calls[0][1:]) == body_len


def test_big_arrays_ride_out_of_band_without_copies():
    from netsdb_tpu.serve.protocol import send_frame as ref_send_frame

    a = np.arange(64 * 64, dtype=np.float32).reshape(64, 64)
    s, r = _FakeSock(), _FakeSock()
    send_frame(s, MsgType.SEND_MATRIX, {"tensor": {"data": a}})
    ref_send_frame(r, MsgType.SEND_MATRIX, {"tensor": {"data": a}})
    assert s.sendmsg_calls == r.sendmsg_calls  # the reference's bytes
    parts = s.sendmsg_calls[0]
    _, codec, _, body_len = struct.unpack("!HBIQ", parts[0])
    assert codec == CODEC_MSGPACK_OOB
    assert body_len < a.nbytes // 4
    assert parts[-1] == bytes(memoryview(a).cast("B"))


def test_oob_segment_checksum_guards_decode():
    body, segments = protocol.encode_body_oob(
        {"t": np.ones(OOB_MIN_BYTES, np.uint8)})
    assert len(segments) == 1
    crc = protocol.segment_checksum(segments[0])
    out = protocol.decode_body(body, CODEC_MSGPACK_OOB, False,
                               segments=[(bytearray(segments[0]), crc)])
    np.testing.assert_array_equal(out["t"], np.ones(OOB_MIN_BYTES, np.uint8))
    bad = bytearray(segments[0])
    bad[10] ^= 0xFF
    with pytest.raises(ValueError, match="checksum"):
        protocol.decode_body(body, CODEC_MSGPACK_OOB, False,
                             segments=[(bad, crc)])


def test_segment_checksum_catches_single_bit_flips():
    rng = np.random.default_rng(3)
    for size in (1, 7, 8, 9, 1000, 4097):
        data = bytearray(rng.integers(0, 256, size=size,
                                      dtype=np.uint8).tobytes())
        c0 = protocol.segment_checksum(memoryview(data))
        for _ in range(16):
            i = int(rng.integers(0, size))
            bit = 1 << int(rng.integers(0, 8))
            data[i] ^= bit
            assert protocol.segment_checksum(memoryview(data)) != c0
            data[i] ^= bit


def test_decoded_tensors_are_writable(daemon):
    ctl, rc = daemon
    rc.create_database("d")
    rc.create_set("d", "big")
    rc.create_set("d", "small")
    big = np.random.default_rng(1).standard_normal((128, 96)).astype(
        np.float32)
    small = np.arange(6, dtype=np.float32).reshape(2, 3)
    rc.send_matrix("d", "big", big, (64, 64))
    rc.send_matrix("d", "small", small, (2, 2))
    for name, want in (("big", big), ("small", small)):
        got = rc.get_tensor("d", name).to_dense()
        np.testing.assert_array_equal(got, want)
        got[0, 0] = -42.0
        assert got[0, 0] == -42.0
    chunked = rc.get_tensor_chunked("d", "big",
                                    chunk_bytes=16 << 10).to_dense()
    np.testing.assert_array_equal(chunked, big)
    chunked[-1, -1] = 7.0


def test_version_mismatch_is_refused_typed(daemon):
    ctl, rc = daemon
    s = socket.create_connection(("127.0.0.1", ctl.port), timeout=TIMEOUT)
    try:
        send_frame(s, MsgType.HELLO, {"token": None, "proto": 2})
        typ, reply = recv_frame(s, allow_pickle=False)
        assert typ == MsgType.ERR
        assert reply["error"] == "ProtocolVersionError"
        assert reply["retryable"] is False
        assert str(PROTO_VERSION) in reply["message"]
    finally:
        s.close()


def test_pipelined_send_data_roundtrips(daemon):
    ctl, rc = daemon
    rc.create_database("d")
    rc.create_set("d", "objs", type_name="object")
    items = [{"i": i, "pad": "x" * 300} for i in range(500)]
    rc.send_data("d", "objs", items, pipeline=True, chunk_bytes=8 << 10)
    assert list(rc.get_set_iterator("d", "objs")) == items


def test_pipelined_column_table_ingest_and_append(daemon, client):
    """A ColumnTable streams as row-range column slices out of band;
    ``append=True`` adds a second batch. The daemon's table equals what
    the reference's in-process client holds for the same columns."""
    from netsdb_tpu.relational.table import ColumnTable as RefTable
    from netsdb_tpu_torch.relational.table import ColumnTable

    ctl, rc = daemon
    rc.create_database("d")
    rc.create_set("d", "t", type_name="table")
    n = 60_000
    a = np.arange(n, dtype=np.int32)
    b = np.arange(n, dtype=np.float32) * 0.5
    info = rc.send_table("d", "t", ColumnTable(
        {"a": torch.from_numpy(a), "b": torch.from_numpy(b)}, {}, None),
        pipeline=True, chunk_bytes=64 << 10)
    assert info.num_rows == n
    back = rc.get_table("d", "t")
    np.testing.assert_array_equal(back["a"].numpy(), a)
    np.testing.assert_array_equal(back["b"].numpy(), b)
    a2 = np.arange(n, n + 100, dtype=np.int32)
    rc.send_table("d", "t", ColumnTable(
        {"a": torch.from_numpy(a2), "b": torch.zeros(100)}, {}, None),
        append=True, pipeline=True, chunk_bytes=64 << 10)
    back = rc.get_table("d", "t")
    client.create_database("d")
    client.create_set("d", "t", type_name="table")
    client.send_table("d", "t", RefTable({"a": a, "b": b}, {}, None))
    client.send_table("d", "t", RefTable(
        {"a": a2, "b": np.zeros(100, np.float32)}, {}, None), append=True)
    ref = client.get_table("d", "t")
    assert back["a"].shape[0] == n + 100
    np.testing.assert_array_equal(back["a"].numpy(), np.asarray(ref["a"]))
    np.testing.assert_array_equal(back["b"].numpy(), np.asarray(ref["b"]))


def test_pipelined_rows_ingest_matches_single_frame(daemon, client):
    """Row dicts streamed as adaptive pickled batches equal the
    single-frame path and the reference's dictionary encoding."""
    ctl, rc = daemon
    rc.create_database("d")
    rc.create_set("d", "r1", type_name="table")
    rc.create_set("d", "r2", type_name="table")
    rows = [{"k": f"key{i % 7}", "v": float(i)} for i in range(400)]
    a = rc.send_table("d", "r1", rows, pipeline=False)
    b = rc.send_table("d", "r2", rows, pipeline=True, chunk_bytes=4 << 10)
    assert (a.num_rows, sorted(a.columns)) == (b.num_rows, sorted(b.columns))
    t1, t2 = rc.get_table("d", "r1"), rc.get_table("d", "r2")
    np.testing.assert_array_equal(t1["v"].numpy(), t2["v"].numpy())
    assert t1.dicts == t2.dicts
    client.create_database("d")
    client.create_set("d", "r", type_name="table")
    client.send_table("d", "r", rows)
    ref = client.get_table("d", "r")
    assert t1.dicts == {k: list(v) for k, v in ref.dicts.items()}
    np.testing.assert_array_equal(t1["k"].numpy(), np.asarray(ref["k"]))


def test_chunked_send_data_during_scan_stream_no_deadlock(daemon):
    ctl, rc = daemon
    rc.create_database("d")
    rc.create_set("d", "src", type_name="object")
    rc.create_set("d", "dst", type_name="object")
    rc.send_data("d", "src", [{"i": i, "pad": "w" * 500}
                              for i in range(40)])
    moved = 0
    for item in rc.scan_stream("d", "src", max_frame_bytes=4 << 10):
        rc.send_data("d", "dst", [item] * 70, pipeline=True,
                     chunk_bytes=2 << 10)
        moved += 1
    assert moved == 40
    assert len(list(rc.get_set_iterator("d", "dst"))) == 40 * 70
    assert rc.ping()["sets"] == 2


def test_ingest_window_is_pipelined_not_stop_and_wait(daemon,
                                                      monkeypatch):
    ctl, rc = daemon
    rc.create_database("d")
    rc.create_set("d", "s", type_name="object")
    sent_before_first_ack = []
    sends = {"n": 0}
    orig_send = client_mod.send_frame
    orig_recv = RemoteClient._recv_reply

    def counting_send(sock, msg_type, payload, codec=0, chaos=None):
        if int(msg_type) == int(MsgType.BULK_CHUNK):
            sends["n"] += 1
        return orig_send(sock, msg_type, payload, codec=codec, chaos=chaos)

    def counting_recv(sock):
        if sends["n"] and not sent_before_first_ack:
            sent_before_first_ack.append(sends["n"])
        return orig_recv(sock)

    monkeypatch.setattr(client_mod, "send_frame", counting_send)
    monkeypatch.setattr(RemoteClient, "_recv_reply",
                        staticmethod(counting_recv))
    items = [{"i": i, "pad": "z" * 900} for i in range(256)]
    rc.send_data("d", "s", items, pipeline=True, chunk_bytes=1 << 10)
    monkeypatch.undo()
    assert sent_before_first_ack and \
        sent_before_first_ack[0] >= rc.ingest_window
    assert len(list(rc.get_set_iterator("d", "s"))) == 256


def test_bulk_ingest_refused_without_pickle_is_typed_fatal(tmp_path):
    ctl = ServeController(Configuration(root_dir=str(tmp_path / "np")),
                          port=0, device="cpu", allow_pickle=False)
    ctl.start()
    try:
        c = RemoteClient(ctl.advertise_addr, timeout=TIMEOUT)
        c.create_database("d")
        c.create_set("d", "s", type_name="object")
        with pytest.raises(RemoteError, match="allow_pickle") as ei:
            c.send_data("d", "s", [1] * 200, pipeline=True)
        assert not ei.value.retryable
        assert c.last_attempts == 1
        # the follower resync conversation streams, and its restore
        # executes pickle: refused typed and fatal at COMMIT
        with pytest.raises(RemoteError, match="RESYNC_FOLLOWER refused") \
                as ei:
            c._bulk_request(MsgType.RESYNC_FOLLOWER, {"nbytes": 1},
                            lambda: iter(()))
        assert not ei.value.retryable and c.last_attempts == 1
        c.close()
    finally:
        ctl.shutdown()


# --- the replication slice: wire-streamed resync and hedged reads ------

def _wait_reattached(mctl, timeout_s=20.0):
    import time

    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        st = mctl.follower_status()
        if st["active"] and not st["degraded"]:
            return
        time.sleep(0.05)
    raise AssertionError(
        f"follower never reattached: {mctl.follower_status()}")


def test_resync_streams_snapshot_over_wire_no_shared_fs(tmp_path,
                                                        monkeypatch):
    """Leader and follower with disjoint roots: the follower's restore
    never reads a checkpoint path — the snapshot arrives over the wire
    in bounded frames (here 4 KiB chunks)."""
    from netsdb_tpu_torch.serve.chaos import ChaosInjector
    from netsdb_tpu_torch.serve.client import RetryPolicy
    from netsdb_tpu_torch.storage import checkpoint

    def no_fs_load(*a, **k):
        raise AssertionError("resync must stream over the wire")

    monkeypatch.setattr(checkpoint, "load_store", no_fs_load)
    chunks = []
    real = RemoteClient.resync_follower

    def small_chunks(self, blob, step, chunk_bytes=8 << 20, **kw):
        chunks.append(len(blob))
        return real(self, blob, step, chunk_bytes=4096, **kw)

    monkeypatch.setattr(RemoteClient, "resync_follower", small_chunks)
    fchaos = ChaosInjector()
    fctl = ServeController(
        Configuration(root_dir=str(tmp_path / "follower_root")), port=0,
        device="cpu")
    fctl.start()
    mctl = ServeController(
        Configuration(root_dir=str(tmp_path / "leader_root")), port=0,
        device="cpu", followers=[fctl.advertise_addr],
        follower_chaos=fchaos, heartbeat_interval_s=0.1,
        heartbeat_timeout_s=0.5, heartbeat_misses=2,
        mirror_ack_timeout_s=0.5, resync_grace_s=2.0)
    mctl.start()
    try:
        c = RemoteClient(mctl.advertise_addr, timeout=TIMEOUT,
                         retry=RetryPolicy(max_attempts=5,
                                           base_delay_s=0.01))
        c.create_database("d")
        c.create_set("d", "w")
        a = np.random.default_rng(7).standard_normal((64, 64)).astype(
            np.float32)
        c.send_matrix("d", "w", a, (32, 32))
        fchaos.arm("kill")
        c.create_set("d", "other", type_name="object")  # the mirror dies
        _wait_reattached(mctl)
        assert fctl.last_resync_mode == "wire"
        assert chunks and chunks[0] > 4096  # it took several chunks
        np.testing.assert_array_equal(
            fctl.library.get_tensor("d", "w").to_dense().numpy(), a)
        c.close()
    finally:
        mctl.shutdown()
        fctl.shutdown()


def test_hedged_read_fires_after_delay_and_wins(tmp_path):
    """A stalled primary reply: the read hedges to the replica after the
    hedge delay and returns its answer long before the primary's would
    land. Mutations never hedge."""
    import time

    from netsdb_tpu_torch.serve.chaos import ChaosInjector
    from netsdb_tpu_torch.serve.client import RetryPolicy

    pchaos = ChaosInjector()
    primary = ServeController(Configuration(root_dir=str(tmp_path / "p")),
                              port=0, device="cpu", chaos=pchaos)
    primary.start()
    replica = ServeController(Configuration(root_dir=str(tmp_path / "r")),
                              port=0, device="cpu")
    replica.start()
    try:
        a = np.arange(96 * 96, dtype=np.float32).reshape(96, 96)
        for ctl in (primary, replica):
            boot = RemoteClient(ctl.advertise_addr, timeout=TIMEOUT)
            boot.create_database("d")
            boot.create_set("d", "w")
            boot.send_matrix("d", "w", a, (32, 32))
            boot.close()
        c = RemoteClient(primary.advertise_addr,
                         replicas=[replica.advertise_addr],
                         hedge_delay_s=0.05, timeout=TIMEOUT,
                         retry=RetryPolicy(max_attempts=2,
                                           base_delay_s=0.01))
        pchaos.arm("delay", delay_s=1.5)
        t0 = time.monotonic()
        t = c.get_tensor("d", "w")
        elapsed = time.monotonic() - t0
        np.testing.assert_array_equal(t.to_dense(), a)
        assert elapsed < 1.0
        assert c.hedges_issued == 1 and c.hedges_won == 1
        pchaos.arm("delay", delay_s=0.3)
        c.create_set("d", "w2")
        assert c.hedges_issued == 1
        c.close()
    finally:
        primary.shutdown()
        replica.shutdown()


def test_hedge_delay_adapts_to_observed_p99(daemon):
    ctl, _ = daemon
    c = RemoteClient(ctl.advertise_addr, replicas=[ctl.advertise_addr],
                     timeout=TIMEOUT)
    assert c.hedge_delay_s() == pytest.approx(0.05)
    for _ in range(16):
        c.ping()
    assert 0 < c.hedge_delay_s() < 0.05
    c.close()


@pytest.fixture()
def replica_pair(tmp_path):
    """Two daemons holding the same items; the primary's injector stalls
    its stream frames on demand."""
    from netsdb_tpu_torch.serve.chaos import ChaosInjector

    chaos = ChaosInjector()
    ctl1 = ServeController(Configuration(root_dir=str(tmp_path / "a")),
                           port=0, device="cpu", chaos=chaos)
    ctl2 = ServeController(Configuration(root_dir=str(tmp_path / "b")),
                           port=0, device="cpu")
    ctl1.start()
    ctl2.start()
    items = [{"i": i, "pad": "x" * 200} for i in range(50)]
    try:
        for ctl in (ctl1, ctl2):
            rc = RemoteClient(ctl.advertise_addr, timeout=TIMEOUT)
            rc.create_database("d")
            rc.create_set("d", "s", type_name="object")
            rc.send_data("d", "s", items, pipeline=False)
            rc.close()
        yield ctl1.advertise_addr, ctl2.advertise_addr, chaos, items
    finally:
        ctl1.shutdown()
        ctl2.shutdown()


@pytest.mark.parametrize("stall,hedge_s", [(True, 0.05), (False, 2.0)])
def test_scan_stream_hedges_only_a_slow_first_item(replica_pair, stall,
                                                   hedge_s):
    """A stalled first stream frame is hedged and the replica's stream
    wins; a fast primary is never hedged (the reference's two
    first-item cases)."""
    a1, a2, chaos, items = replica_pair
    if stall:
        chaos.arm("delay", types=[int(MsgType.STREAM_ITEM)], delay_s=0.8)
    rc = RemoteClient(a1, replicas=[a2], hedge_delay_s=hedge_s,
                      timeout=TIMEOUT)
    assert list(rc.scan_stream("d", "s")) == items
    if stall:
        assert rc.hedges_issued >= 1 and rc.hedges_won >= 1
    else:
        assert rc.hedges_issued == 0
    rc.close()


def test_hedged_stream_supports_nested_requests(replica_pair):
    a1, a2, _chaos, items = replica_pair
    rc = RemoteClient(a1, replicas=[a2], hedge_delay_s=0.5, timeout=TIMEOUT)
    seen = 0
    for _item in rc.scan_stream("d", "s"):
        if seen == 0:
            rc.ping()
            assert len(list(rc.scan_stream("d", "s"))) == len(items)
        seen += 1
    assert seen == len(items)
    rc.close()


def test_hedged_stream_both_replicas_down_raises(tmp_path):
    ctl = ServeController(Configuration(root_dir=str(tmp_path / "only")),
                          port=0, device="cpu")
    ctl.start()
    rc = RemoteClient(ctl.advertise_addr, replicas=["127.0.0.1:1"],
                      hedge_delay_s=0.05, timeout=TIMEOUT)
    try:
        rc.create_database("d")
        rc.create_set("d", "s", type_name="object")
        rc.send_data("d", "s", [1], pipeline=False)
        ctl.shutdown()
        with pytest.raises((RemoteError, OSError)):
            list(rc.scan_stream("d", "s"))
    finally:
        rc.close()
        ctl.shutdown()
