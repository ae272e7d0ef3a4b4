"""The port's device block cache (``netsdb_tpu_torch/storage/devcache.py``)
against the JAX package's, and the port's warm paths through it.

The same sequence of lookups, installs, evictions and invalidations on
both caches gives the same answers and the same counters (LRU under the
byte budget, the block-granular partial mode with its epochs and pinned
head). Through the port's store: a warm stream reads no page and stages
no byte, a write bumps the set's version so nothing stale is served,
and a stream that stopped early leaves its prefix cached, so the next
stream stitches it in and reads only the rest from the arena. Byte
counts and blocks are compared exactly: the cache computes nothing."""

import numpy as np
import pytest
import torch

from netsdb_tpu.storage.devcache import DeviceBlockCache as RefCache
from netsdb_tpu_torch import Client
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.plan import staging
from netsdb_tpu_torch.plan.computations import Apply, ScanSet, WriteSet
from netsdb_tpu_torch.plan.fold import TensorFold
from netsdb_tpu_torch.storage.devcache import DeviceBlockCache, to_device
from netsdb_tpu_torch.storage.store import SetIdentifier

torch.set_num_threads(2)

ARENA = dict(page_size_bytes=4096, page_pool_bytes=16384)
COMMON = ("hits", "misses", "installs", "evictions", "invalidations",
          "rejected", "bytes", "entries", "budget_bytes")


def _blk(n=256):
    return [np.zeros(n, np.uint8)]


def _whole_run_script(c):
    """The reference's LRU/budget/counter scenario; returns what each
    step answered."""
    seen = [c.get(("a:s", 1, "tables")) is None,
            c.install(("a:s", 1, "tables"), _blk()),
            c.install(("b:s", 1, "tables"), _blk()),
            c.get(("a:s", 1, "tables")) is not None]
    seen += [c.install(("c:s", i, "tables"), _blk()) for i in range(16)]
    seen += [c.get(("b:s", 1, "tables")) is None,  # LRU went first
             c.install(("huge", 1, "x"), [np.zeros(8192, np.uint8)]),
             c.invalidate("c:s")]
    seen += [c.get(("c:s", i, "tables")) is None for i in range(16)]
    seen.append(dict(c.stats()))
    c.resize(0)
    seen += [c.enabled, c.get(("a:s", 1, "tables")),
             c.install(("a:s", 2, "tables"), _blk())]
    return seen


def test_whole_run_lru_and_counters_match_the_reference():
    port = _whole_run_script(DeviceBlockCache(budget_bytes=4096))
    ref = _whole_run_script(RefCache(budget_bytes=4096))
    port_stats, ref_stats = port.pop(-4), ref.pop(-4)
    assert port == ref
    assert {k: port_stats[k] for k in COMMON} == \
        {k: ref_stats[k] for k in COMMON}
    assert port_stats["evictions"] > 0 and port_stats["rejected"] == 1
    assert port_stats["bytes"] <= 4096


def _partial_script(c, tick):
    """Block entries: plan, install, stitch, dirty ranges, epochs, pins."""
    base, ranges = ("d:w", "trows", 64), [(0, 64), (64, 128), (128, 150)]
    out = []
    epoch, covered = c.plan_ranges(base, ranges)
    out += [epoch, sorted(covered)]
    out += [c.install_block(base, r, np.full(100, i, np.float32), epoch)
            for i, r in enumerate(ranges[:2])]
    epoch, covered = c.plan_ranges(base, ranges)
    out += [epoch, sorted(covered), float(covered[(64, 128)][0]),
            c.coverage("d:w")]
    tick(c, 2, 1)
    out.append(c.install_block(base, ranges[2], np.zeros(30, np.float32),
                               epoch))
    out.append(c.plan_ranges(base, ranges)[1].keys() == set(ranges))
    # a dirty tail drops only the blocks it touches and bumps the epoch
    out.append(c.invalidate_range("d:w", 100))
    epoch2, covered = c.plan_ranges(base, ranges)
    out += [epoch2 > epoch, sorted(covered), c.coverage("d:w")]
    # an install planned before the write is refused
    out.append(c.install_block(base, ranges[2], np.zeros(30, np.float32),
                               epoch))
    out.append(c.invalidate("d:w"))
    out.append(c.plan_ranges(base, ranges)[1])
    out.append({k: v for k, v in c.stats().items()})
    return out


def _tick_port(c, served, ranges):
    c.tick_partial(served, ranges)


def _tick_ref(c, served, ranges):
    c.tick_partial("d:w", served, ranges)


@pytest.mark.parametrize("pin_bytes", [0, 1000])
def test_partial_blocks_match_the_reference(pin_bytes):
    port = _partial_script(DeviceBlockCache(1 << 20, partial=True,
                                            pin_bytes=pin_bytes),
                           _tick_port)
    ref = _partial_script(RefCache(1 << 20, partial=True,
                                   pin_bytes=pin_bytes), _tick_ref)
    port_stats, ref_stats = port.pop(), ref.pop()
    assert port == ref
    keys = COMMON + ("partial_hits", "stitched_ranges",
                     "dirty_invalidations", "pinned_bytes")
    assert {k: port_stats[k] for k in keys} == \
        {k: ref_stats[k] for k in keys}


def test_pinned_head_survives_eviction():
    c = DeviceBlockCache(budget_bytes=1000, partial=True, pin_bytes=400)
    base = ("d:w", "trows")
    epoch, _ = c.plan_ranges(base, [(0, 10)])
    for i in range(8):  # 200-byte blocks; the first two are the head
        assert c.install_block(base, (10 * i, 10 * i + 10),
                               np.zeros(50, np.float32), epoch)
    _, covered = c.plan_ranges(base, [(10 * i, 10 * i + 10)
                                      for i in range(8)])
    assert (0, 10) in covered and (10, 20) in covered
    assert c.stats()["pinned_bytes"] == 400 and c.stats()["evictions"] > 0
    c.set_pin_budget(100)  # below the pinned total: every pin lifts
    assert c.stats()["pinned_bytes"] == 0


def test_value_nbytes_reads_metadata():
    from netsdb_tpu.storage.devcache import _value_nbytes as ref_nbytes
    from netsdb_tpu_torch.storage.devcache import _value_nbytes

    t = torch.zeros(4, 8)
    assert _value_nbytes([(3, t)]) == 64 + 128
    assert _value_nbytes([(3, t)]) == ref_nbytes([(3, np.zeros((4, 8),
                                                               np.float32))])
    dev = to_device(np.ones((2, 3), np.float32), "cpu")
    assert dev.device.type == "cpu" and _value_nbytes(dev) == 24


# ------------------------------------------------- through the port's store
def _client(tmp_path, **kw):
    c = Client(Configuration(root_dir=str(tmp_path / "port"), **ARENA, **kw),
               device="cpu")
    c.create_database("d")
    c.create_set("d", "w", storage="paged")
    return c


def _matrix(seed, rows=400, cols=16):
    return np.random.default_rng(seed).standard_normal(
        (rows, cols)).astype(np.float32)


def _reads(c):
    return c.store.page_store().stats()["page_reads"]


@pytest.mark.parametrize("partial", [True, False])
def test_warm_matmul_reads_no_page_and_stages_nothing(tmp_path, partial):
    c = _client(tmp_path, device_cache_partial=partial)
    m = _matrix(0)
    c.send_matrix("d", "w", m)
    rhs = np.random.default_rng(1).standard_normal((16, 5)).astype(
        np.float32)
    cold = c.paged_matmul("d", "w", rhs)
    np.testing.assert_allclose(cold.numpy(), m @ rhs, rtol=1e-5, atol=1e-5)
    assert c.store.page_store().stats()["spills"] > 0
    reads, before = _reads(c), staging.counters()
    warm = c.paged_matmul("d", "w", rhs)
    after = staging.counters()
    assert _reads(c) == reads
    assert after["bytes"] == before["bytes"]
    assert after["cached_runs"] == before["cached_runs"] + 1
    assert torch.equal(warm, cold)
    st = c.store.device_cache().stats()
    assert st["hits"] == 1 and st["misses"] == 1 and st["installs"] == 1


@pytest.mark.parametrize("partial", [True, False])
def test_a_write_bumps_the_version_and_nothing_stale_is_served(tmp_path,
                                                               partial):
    c = _client(tmp_path, device_cache_partial=partial)
    ident = SetIdentifier("d", "w")
    c.send_matrix("d", "w", _matrix(0))
    # a rows-mode fold through the executor: each block doubled
    sink = WriteSet(Apply(ScanSet("d", "w"), fn=lambda w: w.to_dense() * 2,
                          tensor_fold=TensorFold(mode="rows"),
                          label="double"), "d", "out")

    def query():
        return next(iter(c.execute_computations(sink).values())).numpy()

    np.testing.assert_array_equal(query(), _matrix(0) * 2)
    reads = _reads(c)
    np.testing.assert_array_equal(query(), _matrix(0) * 2)  # warm
    assert _reads(c) == reads
    v0 = c.store.version_of(ident)
    new = _matrix(7)
    c.send_matrix("d", "w", new)
    assert c.store.version_of(ident) > v0
    assert c.store.device_cache().stats()["invalidations"] > 0
    reads = _reads(c)
    np.testing.assert_array_equal(query(), new * 2)
    assert _reads(c) > reads  # streamed again, from the new pages
    eye = np.eye(16, dtype=np.float32)
    c.clear_set("d", "w")
    assert c.store.version_of(ident) > v0 + 1
    with pytest.raises(ValueError, match="no paged matrix"):
        c.paged_matmul("d", "w", eye)


def test_a_stopped_stream_leaves_its_prefix_for_the_next(tmp_path):
    c = _client(tmp_path)
    m = _matrix(0, rows=400)
    c.send_matrix("d", "w", m)
    pt = c.store.paged_tensor(SetIdentifier("d", "w"))
    ranges = pt.block_ranges()
    assert len(ranges) == 7  # 64-byte rows: 64 rows a page, ragged tail
    up = staging.BlockUploader("cpu")

    def plan():
        return staging.PartialPlan(
            pt.devcache, ("d:w", "test"), ranges,
            lambda idxs: pt.stream_blocks(blocks=idxs))

    def place(item):
        return item[0], up.upload(item[1])

    with staging.stage_stream(None, place, 2, partial=plan()) as s:
        head = [next(s) for _ in range(3)]  # then the consumer stops
    reads = _reads(c)
    with staging.stage_stream(None, place, 2, partial=plan()) as s:
        full = [(start, b.clone()) for start, b in s]
    assert [s for s, _ in full] == [s for s, _ in ranges]
    np.testing.assert_array_equal(torch.cat([b for _, b in full]).numpy(),
                                  m)
    # at least the first two head blocks were cached (the third may
    # still have been in flight when the consumer stopped); only the
    # rest was read from the arena
    read_now = _reads(c) - reads
    assert read_now <= len(ranges) - 2
    for (s0, a), (s1, b) in zip(head, full):
        assert s0 == s1 and torch.equal(a, b)
    st = pt.devcache.stats()
    assert st["partial_hits"] >= 2 and st["stitched_ranges"] >= 1
    # and the third stream reads nothing at all
    reads = _reads(c)
    with staging.stage_stream(None, place, 2, partial=plan()) as s:
        assert len(list(s)) == len(ranges)
    assert _reads(c) == reads


def test_the_cache_budget_holds_through_the_store(tmp_path):
    # blocks of 64 rows, 4096 bytes (+64 for the row count riding
    # along): the budget holds three
    c = _client(tmp_path, device_cache_bytes=3 * 4160)
    m = _matrix(0, rows=400)
    c.send_matrix("d", "w", m)
    eye = np.eye(16, dtype=np.float32)
    for _ in range(2):
        np.testing.assert_array_equal(c.paged_matmul("d", "w", eye).numpy(),
                                      m)
    st = c.store.device_cache().stats()
    assert st["bytes"] <= 3 * 4160 and st["evictions"] > 0
