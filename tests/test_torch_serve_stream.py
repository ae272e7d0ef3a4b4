"""Streamed SCAN_SET and chunked GET_TENSOR through the port's daemon —
the one-daemon cases of the reference's ``tests/test_serve_stream.py``:
more than one frame above the budget, each frame within it, the same
data round-tripped (held to what the reference's local ``Client`` holds
for the same inputs), and a synchronized connection after an abandoned
or failed stream. Every daemon listens on port 0 and is shut down in
``finally``; every client has a socket timeout."""

import pickle

import numpy as np
import pytest
import torch

from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.serve.client import RemoteClient, RemoteError
from netsdb_tpu_torch.serve.protocol import MsgType
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


def test_scan_stream_splits_frames_and_roundtrips(daemon, client):
    ctl, rc = daemon
    rc.create_database("d")
    rc.create_set("d", "objs", type_name="object")
    items = [{"i": i, "pad": "x" * 1000} for i in range(300)]
    rc.send_data("d", "objs", items)
    budget = 16 << 10
    frames = list(rc._stream(MsgType.SCAN_SET_STREAM,
                             {"db": "d", "set": "objs",
                              "max_frame_bytes": budget}))
    assert len(frames) > 1
    for f in frames:
        assert len(f["batch"]) <= 4 * budget
    got = list(rc.scan_stream("d", "objs", max_frame_bytes=budget))
    # the reference's in-process client holds the same items in order
    client.create_database("d")
    client.create_set("d", "objs", type_name="object")
    client.send_data("d", "objs", items)
    assert got == list(client.get_set_iterator("d", "objs")) == items


def test_scan_stream_single_small_frame(daemon):
    ctl, rc = daemon
    rc.create_database("d")
    rc.create_set("d", "s", type_name="object")
    rc.send_data("d", "s", [1, 2, 3])
    assert list(rc.scan_stream("d", "s")) == [1, 2, 3]


def test_chunked_tensor_roundtrip(daemon, client):
    ctl, rc = daemon
    rc.create_database("d")
    rc.create_set("d", "w")
    dense = np.random.default_rng(0).standard_normal(
        (256, 128)).astype(np.float32)
    rc.send_matrix("d", "w", dense, (64, 64))
    t = rc.get_tensor_chunked("d", "w", chunk_bytes=16 << 10)
    client.create_database("d")
    client.create_set("d", "w")
    client.send_matrix("d", "w", dense, (64, 64))
    np.testing.assert_array_equal(
        t.to_dense(), np.asarray(client.get_tensor("d", "w").to_dense()))
    assert t.block_shape == (64, 64)
    frames = list(rc._stream(MsgType.GET_TENSOR_CHUNKED,
                             {"db": "d", "set": "w",
                              "chunk_bytes": 16 << 10}))
    meta = frames[0]["meta"]
    assert meta["nchunks"] > 1
    assert len(frames) == 1 + meta["nchunks"]
    for f in frames[1:]:
        assert len(f["b"]) <= 16 << 10


def test_abandoned_stream_reconnects_cleanly(daemon):
    ctl, rc = daemon
    rc.create_database("d")
    rc.create_set("d", "objs", type_name="object")
    rc.send_data("d", "objs", [{"i": i, "pad": "y" * 2000}
                               for i in range(200)])
    it = rc.scan_stream("d", "objs", max_frame_bytes=8 << 10)
    next(it)
    it.close()  # abandoned mid-stream: socket dropped, lock released
    assert rc.ping()["sets"] == 1


def test_stream_error_keeps_connection_synchronized(daemon):
    ctl, rc = daemon
    with pytest.raises(RemoteError):
        list(rc.scan_stream("nodb", "noset"))
    assert rc.ping()["uptime"] >= 0


def test_nested_request_during_stream_does_not_deadlock(daemon):
    ctl, rc = daemon
    rc.create_database("d")
    rc.create_set("d", "src", type_name="object")
    rc.create_set("d", "dst", type_name="object")
    rc.send_data("d", "src", [{"i": i, "pad": "w" * 800}
                              for i in range(100)])
    copied = 0
    for item in rc.scan_stream("d", "src", max_frame_bytes=4 << 10):
        rc.send_data("d", "dst", [item])  # nested call mid-stream
        copied += 1
    assert copied == 100
    assert len(list(rc.scan_stream("d", "dst"))) == 100
    assert rc.ping()["sets"] == 2


def test_nested_stream_during_stream_does_not_deadlock(daemon):
    ctl, rc = daemon
    rc.create_database("d")
    rc.create_set("d", "a", type_name="object")
    rc.create_set("d", "b", type_name="object")
    rc.send_data("d", "a", [{"i": i, "p": "q" * 700} for i in range(60)])
    rc.send_data("d", "b", list(range(10)))
    pairs = 0
    for _ in rc.scan_stream("d", "a", max_frame_bytes=4 << 10):
        assert list(rc.scan_stream("d", "b")) == list(range(10))
        pairs += 1
    assert pairs == 60
    assert rc.ping()["sets"] == 2


def test_first_frame_bounded_for_large_items(daemon):
    ctl, rc = daemon
    rc.create_database("d")
    rc.create_set("d", "big", type_name="object")
    rc.send_data("d", "big", [bytes(1 << 20) for _ in range(4)])
    frames = list(rc._stream(MsgType.SCAN_SET_STREAM,
                             {"db": "d", "set": "big",
                              "max_frame_bytes": 64 << 10}))
    assert len(frames) == 4
    assert all(len(f["batch"]) < (1 << 20) + 4096 for f in frames)


def _paged_daemon(tmp_path, name):
    cfg = Configuration(root_dir=str(tmp_path / name),
                        page_size_bytes=4096, page_pool_bytes=16384)
    ctl = ServeController(cfg, port=0, device="cpu")
    ctl.start()
    return ctl


def test_paged_set_streams_per_chunk_frames(tmp_path, monkeypatch):
    """A paged relation larger than its arena scans through the daemon
    as one host chunk table per frame; the relation never materializes
    (``to_table`` and ``to_host_table`` are poisoned meanwhile)."""
    from netsdb_tpu_torch.relational.outofcore import PagedColumns
    from netsdb_tpu_torch.relational.table import ColumnTable

    ctl = _paged_daemon(tmp_path, "pgstream")
    rc = None
    try:
        rc = RemoteClient(ctl.advertise_addr, timeout=TIMEOUT)
        rc.create_database("d")
        rc.create_set("d", "t", type_name="table", storage="paged")
        n = 50_000
        t = ColumnTable({"a": torch.arange(n, dtype=torch.int32),
                         "b": torch.arange(n, dtype=torch.float32) * 0.5,
                         "c": (torch.arange(n, dtype=torch.int32) * 7) % 13})
        rc.send_table("d", "t", t)
        assert ctl.library.store.page_store().stats()["spills"] > 0

        def boom(self):
            raise AssertionError("a paged scan must stream")

        monkeypatch.setattr(PagedColumns, "to_table", boom)
        monkeypatch.setattr(PagedColumns, "to_host_table", boom)
        frames = list(rc._stream(MsgType.SCAN_SET_STREAM,
                                 {"db": "d", "set": "t"}))
        assert len(frames) > 10
        rows = []
        for f in frames:
            assert f.get("paged_chunk") is True
            assert len(f["batch"]) < 64 * 1024
            (chunk,) = pickle.loads(f["batch"])
            assert isinstance(chunk, ColumnTable)
            rows.append(chunk["a"].numpy())
        np.testing.assert_array_equal(np.sort(np.concatenate(rows)),
                                      np.arange(n))
        tbl = rc.get_table_streamed("d", "t")
        np.testing.assert_array_equal(np.sort(tbl["a"].numpy()),
                                      np.arange(n))
        np.testing.assert_allclose(
            np.sort(tbl["b"].numpy()),
            np.sort(np.arange(n, dtype=np.float32) * 0.5))
    finally:
        if rc is not None:
            rc.close()
        ctl.shutdown()


def test_plain_scan_of_paged_set_assembles_host_side(tmp_path, monkeypatch):
    from netsdb_tpu_torch.relational.outofcore import PagedColumns
    from netsdb_tpu_torch.relational.table import ColumnTable

    ctl = _paged_daemon(tmp_path, "pgscan")
    rc = None
    try:
        rc = RemoteClient(ctl.advertise_addr, timeout=TIMEOUT)
        rc.create_database("d")
        rc.create_set("d", "t", type_name="table", storage="paged")
        n = 10_000
        rc.send_table("d", "t", ColumnTable(
            {"a": torch.arange(n, dtype=torch.int32),
             "b": torch.ones(n)}))

        def boom(self):
            raise AssertionError("SCAN_SET must assemble on the host")

        monkeypatch.setattr(PagedColumns, "to_table", boom)
        tbl = rc.get_table("d", "t")
        np.testing.assert_array_equal(np.sort(tbl["a"].numpy()),
                                      np.arange(n))
    finally:
        if rc is not None:
            rc.close()
        ctl.shutdown()
