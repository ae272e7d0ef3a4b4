"""The port's overlapped staging (``netsdb_tpu_torch/plan/staging.py``)
against the JAX package's: the same bucket ladder, and the same thread
discipline — a staged stream keeps its order and equals the inline
(depth 0) stream, a source or ``place`` death surfaces at the consumer,
an abandoned consumer leaves no live thread and no held read lock, and a
store closed under a live stream raises instead of reading freed pages.
These mirror ``tests/test_staging.py``. On the CPU an upload is a plain
copy; the CUDA copy stream and pinned ring run on the card
(``chip_smoke.py`` phase 7)."""

import time

import numpy as np
import pytest
import torch

from netsdb_tpu.plan import staging as ref_staging
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.plan import staging
from netsdb_tpu_torch.storage.paged import PagedTensor, PagedTensorStore

torch.set_num_threads(2)


@pytest.fixture()
def store(tmp_path):
    s = PagedTensorStore(Configuration(root_dir=str(tmp_path / "port")),
                         pool_bytes=1 << 20)
    yield s
    s.close()


def _paged(store, rows=4096, row_block=64):
    m = np.random.default_rng(0).standard_normal((rows, 8)).astype(
        np.float32)
    store.put("t", m, row_block=row_block)
    return PagedTensor(store, "t"), m


def _wait_no_stagers(timeout=10.0):
    deadline = time.monotonic() + timeout
    while staging.active_count() and time.monotonic() < deadline:
        time.sleep(0.02)
    return staging.active_count()


# ---------------------------------------------------------------- buckets
@pytest.mark.parametrize("density", [2, 4])
def test_bucket_rows_matches_the_reference(density):
    for n in range(1, 5001):
        assert staging.bucket_rows(n, density) == \
            ref_staging.bucket_rows(n, density), n
    for n, multiple in ((9, 1), (9, 8), (129, 1), (700, 16)):
        for bucketing in (True, False):
            assert staging.pad_rows_target(n, bucketing, multiple,
                                           density) == \
                ref_staging.pad_rows_target(n, bucketing, multiple, density)


def test_bucket_rows_ladder():
    assert staging.bucket_rows(1) == 8
    assert staging.bucket_rows(9) == 12
    assert staging.bucket_rows(700) == 768
    assert staging.bucket_rows(1000) == 1024
    assert staging.bucket_rows(100, 4) == 112
    for n in range(1, 5000):
        b = staging.bucket_rows(n)
        assert n <= b <= max(8, (3 * n) // 2 + 2)
        assert staging.bucket_rows(n + 1) >= b


@pytest.mark.parametrize("density", [0, 3, 8])
def test_a_bad_bucket_density_raises(density):
    with pytest.raises(ValueError, match="bucket_density"):
        staging.bucket_rows(100, density)
    with pytest.raises(ValueError, match="bucket_density"):
        Configuration(bucket_density=density)


# ---------------------------------------------------------- staged stream
def test_staged_stream_keeps_order_and_matches_depth_zero():
    staged = list(staging.stage_stream(iter(range(100)), lambda x: x * 2,
                                       depth=3))
    inline = list(staging.stage_stream(iter(range(100)), lambda x: x * 2,
                                       depth=0))
    assert staged == inline == [x * 2 for x in range(100)]
    ref = list(ref_staging.stage_stream(iter(range(100)), lambda x: x * 2,
                                        depth=3))
    assert staged == ref
    assert _wait_no_stagers() == 0


def test_staged_blocks_match_depth_zero(store):
    pt, m = _paged(store)
    up = staging.BlockUploader("cpu")

    def place(item):
        start, block = item
        return start, up.upload(block, rows=staging.bucket_rows(
            block.shape[0]))

    runs = []
    for depth in (0, 2):
        with staging.stage_stream(pt.stream_blocks(), place,
                                  depth=depth) as s:
            runs.append([(start, b.clone()) for start, b in s])
    assert [s for s, _ in runs[0]] == [s for s, _ in runs[1]]
    for (_, a), (_, b) in zip(*runs):
        assert torch.equal(a, b)
    got = torch.cat([b[:64] for _, b in runs[1]]).numpy()
    np.testing.assert_array_equal(got, m)


def test_cpu_upload_is_a_plain_copy_padded_with_zeros():
    up = staging.BlockUploader("cpu", depth=2)
    block = np.arange(15, dtype=np.float32).reshape(5, 3)
    out = up.upload(block, rows=8)
    assert out.device.type == "cpu" and out.shape == (8, 3)
    np.testing.assert_array_equal(out[:5].numpy(), block)
    assert not out[5:].any()
    block[:] = -1  # the upload owns its memory
    assert out[0, 1] == 1.0
    assert up.fence() is None and up.bytes == 60 and up.copies == 1


def test_source_death_surfaces_at_consumer():
    def source():
        yield 1
        yield 2
        raise OSError("disk gone")

    s = staging.stage_stream(source(), lambda x: x, depth=2)
    got = [next(s), next(s)]
    with pytest.raises(OSError, match="disk gone"):
        next(s)
    assert got == [1, 2]
    assert _wait_no_stagers() == 0


def test_place_death_surfaces_at_consumer():
    def place(x):
        if x == 3:
            raise ValueError("bad block")
        return x

    s = staging.stage_stream(iter(range(10)), place, depth=2)
    assert [next(s), next(s), next(s)] == [0, 1, 2]
    with pytest.raises(ValueError, match="bad block"):
        list(s)
    assert _wait_no_stagers() == 0


def test_inline_place_death_surfaces_too():
    def place(x):
        raise ValueError("bad block")

    with pytest.raises(ValueError, match="bad block"):
        next(staging.stage_stream(iter(range(3)), place, depth=0))


def test_abandoned_consumer_joins_threads_and_releases_locks(store):
    pt, _ = _paged(store)
    stream = staging.stage_stream(pt.stream_blocks(), lambda x: x, depth=2)
    next(stream)
    stream.close()
    assert _wait_no_stagers() == 0
    # the staging thread closed the host stream, which joined its reader
    with store._readers_lock:
        assert all(not t.is_alive() for t, _ in store._readers)
    # and released the read lock: a writer proceeds at once
    with pt.rw.write():
        pass


def test_abandoned_stream_without_close_is_collected(store):
    pt, _ = _paged(store)
    stream = staging.stage_stream(pt.stream_blocks(), lambda x: x, depth=2)
    next(stream)
    del stream
    assert _wait_no_stagers() == 0


def test_store_closed_while_stream_live(tmp_path):
    s = PagedTensorStore(Configuration(root_dir=str(tmp_path / "port")),
                         pool_bytes=1 << 20)
    pt, _ = _paged(s)
    stream = staging.stage_stream(pt.stream_blocks(), lambda x: x, depth=2)
    next(stream)
    s.close()  # joins the page readers under the live stream
    with pytest.raises((RuntimeError, KeyError)):
        for _ in range(200):
            next(stream)
    stream.close()
    assert _wait_no_stagers() == 0


def test_counters_count_chunks_bytes_and_copies(store):
    pt, m = _paged(store, rows=640)
    up = staging.BlockUploader("cpu")
    staging.reset_counters()
    with staging.stage_stream(pt.stream_blocks(),
                              lambda it: up.upload(it[1]), depth=2) as s:
        n = sum(1 for _ in s)
    c = staging.counters()
    assert n == 10 and c["chunks"] == 10 and c["copies"] == 10
    assert c["bytes"] == m.nbytes and c["cached_runs"] == 0
    assert c["wait_s"] >= 0.0
