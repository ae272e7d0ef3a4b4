"""The SUMMA matmul over paged operands (``parallel/summa.py``) against the
JAX package's, on the CPU (``tests/test_summa.py``'s cases).

The JAX side runs on 4 of the suite's virtual CPU devices (the ``mesh4``
fixture); the port on 4 virtual positions of the CPU. Integer-valued f32
operands make every summation order exact, so the gates are byte
equality: SUMMA (1-d and the 2x2 grid) against the single-position
stream, the port against the reference, and FF's plan leg with
``distributed_matmul`` on against the same request with it off."""

import numpy as np
import pytest
import torch

from netsdb_tpu.config import Configuration as JConfiguration
from netsdb_tpu.parallel import summa as JS
from netsdb_tpu.storage.paged import PagedTensorStore as JStore
from netsdb_tpu_torch import obs
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.parallel import summa as S
from netsdb_tpu_torch.parallel.mesh import virtual_devices
from netsdb_tpu_torch.plan import staging
from netsdb_tpu_torch.storage.devcache import DeviceBlockCache
from netsdb_tpu_torch.storage.paged import PagedTensorStore

pytestmark = pytest.mark.mesh


def _int_f32(rng, shape, lo=-8, hi=8):
    return rng.integers(lo, hi, size=shape).astype(np.float32)


def _store(tmp_path, rows=1024, k=96, cols=40, row_block=128, cls=None,
           cfg_cls=Configuration, **cfg):
    config = cfg_cls(root_dir=str(tmp_path / "s"),
                     page_size_bytes=64 * 1024, **cfg)
    pts = (cls or PagedTensorStore)(config, force_python=True)
    rng = np.random.default_rng(7)
    m = _int_f32(rng, (rows, k))
    rhs = _int_f32(rng, (k, cols))
    pts.put("m", m, row_block=row_block)
    return pts, m, rhs


@pytest.fixture()
def devs():
    with virtual_devices(4, "cpu") as d:
        yield list(d)


def _reference(tmp_path, fn, mesh4, **kw):
    pts, m, rhs = _store(tmp_path / "ref", cls=JStore,
                         cfg_cls=JConfiguration, **kw)
    return fn(pts, "m", rhs, devices=list(mesh4.devices.flat))


def test_summa_byte_equal_single_position_and_the_reference(tmp_path,
                                                             devs, mesh4):
    pts, m, rhs = _store(tmp_path)
    base = pts.matmul_streamed("m", rhs)  # the single-position stream
    assert np.array_equal(base.numpy(), m @ rhs)
    out = S.summa_matmul_streamed(pts, "m", rhs, devices=devs)
    assert out.numpy().tobytes() == base.numpy().tobytes()
    want = _reference(tmp_path, JS.summa_matmul_streamed, mesh4)
    assert out.numpy().tobytes() == want.tobytes()
    assert staging.active_count() == 0


def test_summa_ragged_tail_and_vector_rhs(tmp_path, devs):
    # 9 blocks over 4 participants (uneven rounds, a ragged last block)
    pts, m, rhs = _store(tmp_path, rows=1100, k=50, row_block=128)
    base = pts.matmul_streamed("m", rhs)
    out = S.summa_matmul_streamed(pts, "m", rhs, devices=devs)
    assert out.numpy().tobytes() == base.numpy().tobytes()
    vec = np.arange(50, dtype=np.float32)
    got = S.summa_matmul_streamed(pts, "m", vec, devices=devs)
    assert got.shape == (1100,)
    assert np.array_equal(got.numpy(), m @ vec)
    with pytest.raises(ValueError, match=">= 2"):
        S.summa_matmul_streamed(pts, "m", rhs, devices=devs[:1])
    with pytest.raises(ValueError, match="contraction"):
        S.summa_matmul_streamed(pts, "m", rhs[:10], devices=devs)


def test_summa_per_participant_staged_fraction(tmp_path, devs):
    """Each participant stages ~1/N of A plus its B panel, never the
    whole operands (the reference's 35% headroom for padding)."""
    pts, m, rhs = _store(tmp_path, rows=2048, k=64, cols=32,
                         row_block=256)  # 8 blocks / 4 participants
    stats = {}
    out = S.summa_matmul_streamed(pts, "m", rhs, devices=devs,
                                  stats_out=stats)
    assert np.array_equal(out.numpy(), m @ rhs)
    assert stats["participants"] == 4
    assert stats["rounds"] == 2
    assert stats["panel_bcasts"] == 8
    per = stats["staged_bytes_per_participant"]
    assert set(per) == {0, 1, 2, 3}
    ideal = stats["operand_bytes"] / 4
    for d, nbytes in per.items():
        assert nbytes <= ideal * 1.35, (d, nbytes, ideal)


def test_distributed_matmul_knob_routes_streamed(tmp_path, devs):
    rounds0 = obs.REGISTRY.counter("summa.rounds").value
    pts, m, rhs = _store(tmp_path, distributed_matmul=True,
                         summa_participants=4)
    stats = {}
    out = pts.matmul_streamed("m", rhs, stats_out=stats)
    assert obs.REGISTRY.counter("summa.rounds").value > rounds0
    assert stats["participants"] == 4
    pts2, _, _ = _store(tmp_path / "off", distributed_matmul=False)
    assert out.numpy().tobytes() == \
        pts2.matmul_streamed("m", rhs).numpy().tobytes()


def test_fewer_than_two_participants_take_the_stream_and_count_it(
        tmp_path):
    """One visible position: the single-position stream, counted."""
    pts, m, rhs = _store(tmp_path, distributed_matmul=True)
    n0 = obs.REGISTRY.counter("summa.single_position").value
    stats = {}
    out = pts.matmul_streamed("m", rhs, stats_out=stats)
    assert np.array_equal(out.numpy(), m @ rhs)
    assert obs.REGISTRY.counter("summa.single_position").value == n0 + 1
    assert stats == {"participants": 1, "rounds": 0}


def test_summa_warm_rerun_reads_no_page(tmp_path, devs):
    """A second run under the same mesh serves every A block from the
    block-granular device cache: no page read, only the B panels
    staged."""
    pts, m, rhs = _store(tmp_path, rows=2048, k=64, cols=32,
                         row_block=256)
    cache = DeviceBlockCache(64 * 1024 * 1024, partial=True)
    cold, warm = {}, {}
    o1 = S.summa_matmul_streamed(pts, "m", rhs, devices=devs, cache=cache,
                                 cache_scope="d:m", stats_out=cold)
    reads0 = pts.stats()["page_reads"]
    o2 = S.summa_matmul_streamed(pts, "m", rhs, devices=devs, cache=cache,
                                 cache_scope="d:m", stats_out=warm)
    assert o2.numpy().tobytes() == o1.numpy().tobytes()
    assert pts.stats()["page_reads"] == reads0
    assert warm["staged_bytes_total"] == rhs.nbytes
    assert cold["staged_bytes_total"] > warm["staged_bytes_total"]
    st = cache.stats()
    assert st["partial_hits"] >= pts.num_blocks("m")
    assert st["hits"] >= 1
    assert staging.active_count() == 0


def test_summa_mesh_label_keys_never_alias(tmp_path, devs):
    """Cached blocks are keyed by the layout: a run over another
    participant count misses."""
    pts, m, rhs = _store(tmp_path, rows=2048, k=64, cols=32,
                         row_block=256)
    cache = DeviceBlockCache(64 * 1024 * 1024, partial=True)
    S.summa_matmul_streamed(pts, "m", rhs, devices=devs, cache=cache,
                            cache_scope="d:m")
    st0 = cache.stats()
    out = S.summa_matmul_streamed(pts, "m", rhs, devices=devs[:2],
                                  cache=cache, cache_scope="d:m")
    assert np.array_equal(out.numpy(), m @ rhs)
    assert cache.stats()["misses"] == st0["misses"] + 1
    assert S.mesh_label("data", devs) != S.mesh_label("data", devs[:2])


def test_ops_matmul_distributed_matches_resident(devs):
    from netsdb_tpu_torch.core.blocked import BlockedTensor
    from netsdb_tpu_torch.ops.matmul import matmul

    rng = np.random.default_rng(3)
    a = BlockedTensor.from_dense(torch.from_numpy(_int_f32(rng, (300, 70))),
                                 (128, 128))
    b = BlockedTensor.from_dense(torch.from_numpy(_int_f32(rng, (70, 90))),
                                 (128, 128))
    base = matmul(a, b, distributed=False)
    r0 = obs.REGISTRY.counter("summa.rounds").value
    out = matmul(a, b, distributed=True)
    assert obs.REGISTRY.counter("summa.rounds").value == r0 + 1
    assert out.shape == base.shape and out.meta == base.meta
    assert torch.equal(out.to_dense(), base.to_dense())
    assert torch.equal(S.summa_matmul_resident(a.to_dense(), b.to_dense(),
                                               devices=devs),
                       a.to_dense() @ b.to_dense())


def test_summa_counters_are_in_the_registry():
    snap = obs.REGISTRY.snapshot()
    counters = snap.get("counters", snap)
    for name, _help in S.COUNTERS:
        assert name in counters, name
    for name in ("reshard.plans", "reshard.steps", "reshard.blocks_moved",
                 "reshard.bytes_moved"):
        import netsdb_tpu_torch.parallel.reshard  # noqa: F401

        assert name in obs.REGISTRY.snapshot().get("counters", snap), name


# --- the 2-d processor grid -------------------------------------------------

def test_summa_grid_byte_equal_single_position_and_the_reference(
        tmp_path, devs, mesh4):
    pts, m, rhs = _store(tmp_path)
    base = pts.matmul_streamed("m", rhs)
    out = S.summa_grid_matmul_streamed(pts, "m", rhs, devices=devs,
                                       grid=(2, 2))
    assert out.numpy().tobytes() == base.numpy().tobytes()
    want = _reference(tmp_path, JS.summa_grid_matmul_streamed, mesh4)
    assert out.numpy().tobytes() == want.tobytes()
    with pytest.raises(ValueError, match="needs 6"):
        S.summa_grid_matmul_streamed(pts, "m", rhs, devices=devs,
                                     grid=(2, 3))


def test_summa_grid_staged_fraction_and_counters(tmp_path, devs):
    rounds0 = obs.REGISTRY.counter("summa.grid_rounds").value
    pts, m, rhs = _store(tmp_path, rows=2048, k=64, cols=32,
                         row_block=256)  # 8 blocks / 2 grid rows
    stats = {}
    out = S.summa_grid_matmul_streamed(pts, "m", rhs, devices=devs,
                                       grid=(2, 2), stats_out=stats)
    assert np.array_equal(out.numpy(), m @ rhs)
    assert stats["grid"] == (2, 2) and stats["participants"] == 4
    assert stats["rounds"] == 4 and stats["steps"] == 16
    for d, nbytes in stats["staged_bytes_per_participant"].items():
        assert nbytes <= m.nbytes / 4 * 1.6, (d, nbytes)
    assert obs.REGISTRY.counter("summa.grid_rounds").value == rounds0 + 4


def test_summa_grid_knob_routes_and_label_keys(tmp_path, devs):
    g0 = obs.REGISTRY.counter("summa.grid_rounds").value
    pts, m, rhs = _store(tmp_path, distributed_matmul=True,
                         summa_participants=4, summa_grid="2x2")
    out = pts.matmul_streamed("m", rhs)
    assert obs.REGISTRY.counter("summa.grid_rounds").value > g0
    assert np.array_equal(out.numpy(), m @ rhs)
    assert S.grid_label(devs, 2, 2) != S.mesh_label("data", devs)
    assert S.grid_label(devs, 2, 2) != S.grid_label(devs, 1, 4)

    class _C:
        summa_grid = "2x2"

    for c in (_C, JConfiguration):
        assert S.grid_shape(_C(), 4) == JS.grid_shape(_C(), 4) == (2, 2)
    assert S.grid_shape(_C(), 3) is None  # does not fit
    _C.summa_grid = None
    assert S.grid_shape(_C(), 4) is None
    _C.summa_grid = "2xbogus"
    with pytest.raises(ValueError, match="PRxPC"):
        S.grid_shape(_C(), 4)
    _C.summa_grid = (1, 1)
    with pytest.raises(ValueError, match=">= 2"):
        S.grid_shape(_C(), 4)


def test_summa_grid_warm_rerun_reads_no_page(tmp_path, devs):
    pts, m, rhs = _store(tmp_path, rows=2048, k=64, cols=32,
                         row_block=256)
    cache = DeviceBlockCache(64 * 1024 * 1024, partial=True)
    o1 = S.summa_grid_matmul_streamed(pts, "m", rhs, devices=devs,
                                      grid=(2, 2), cache=cache,
                                      cache_scope="d:m")
    reads0 = pts.stats()["page_reads"]
    warm = {}
    o2 = S.summa_grid_matmul_streamed(pts, "m", rhs, devices=devs,
                                      grid=(2, 2), cache=cache,
                                      cache_scope="d:m", stats_out=warm)
    assert o2.numpy().tobytes() == o1.numpy().tobytes()
    assert pts.stats()["page_reads"] == reads0
    assert warm["staged_bytes_total"] <= rhs.nbytes
    assert staging.active_count() == 0


# --- the plan leg -------------------------------------------------------------

def test_ff_plan_leg_routes_through_summa_and_matches_the_reference(
        tmp_path):
    """FF inference over paged weights: with ``distributed_matmul`` on
    the weight streams route through SUMMA (1-d and 2x2), byte-equal to
    the knob-off run and to the reference's distributed run."""
    from netsdb_tpu.client import Client as JClient
    from netsdb_tpu.models.ff import FFModel as JFF
    from netsdb_tpu.plan.executor import clear_compiled_cache
    from netsdb_tpu_torch import Client
    from netsdb_tpu_torch.models.ff import FFModel

    rng = np.random.default_rng(5)
    F, H, L = 96, 128, 10
    w1, b1 = _int_f32(rng, (H, F), -2, 2), _int_f32(rng, (H,), -2, 2)
    wo, bo = _int_f32(rng, (L, H), -2, 2), _int_f32(rng, (L,), -2, 2)
    x = _int_f32(rng, (32, F), -2, 2)

    def run(tag, cls=Client, model=FFModel, cfg_cls=Configuration, **cfg):
        kw = {} if cls is JClient else {"device": "cpu"}
        c = cls(cfg_cls(root_dir=str(tmp_path / tag), page_size_bytes=4096,
                        page_pool_bytes=16384, **cfg), **kw)
        m = model(db="ff", block=(32, 32))
        m.setup(c, storages={"w1": "paged", "wo": "paged"})
        m.load_weights(c, w1, b1, wo, bo)
        m.load_inputs(c, x)
        return np.asarray(m.inference(c).to_dense())

    clear_compiled_cache()
    want = run("ref", JClient, JFF, JConfiguration, distributed_matmul=True,
               summa_participants=4)
    with virtual_devices(4, "cpu"):
        base = run("base")
        r0 = obs.REGISTRY.counter("summa.rounds").value
        dist = run("dist", distributed_matmul=True, summa_participants=4)
        assert obs.REGISTRY.counter("summa.rounds").value > r0
        g0 = obs.REGISTRY.counter("summa.grid_rounds").value
        grid = run("grid", distributed_matmul=True, summa_participants=4,
                   summa_grid="2x2")
        assert obs.REGISTRY.counter("summa.grid_rounds").value > g0
    np.testing.assert_array_equal(base, dist)
    np.testing.assert_array_equal(base, grid)
    np.testing.assert_allclose(dist, want, rtol=1e-6, atol=1e-6)
