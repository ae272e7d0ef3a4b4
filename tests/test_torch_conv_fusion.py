"""The staged conv2d pipeline of the port against the reference's
(``tests/test_conv_fusion.py``'s three cases: 12 x 12 images, stride and
padding, the intermediate sets), within 1e-5; its conv job through the
compiled-program cache equals the same job node by node."""

import importlib

import numpy as np
import pytest

from netsdb_tpu.plan.executor import clear_compiled_cache as j_clear
from netsdb_tpu_torch import Client
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.plan import executor
from netsdb_tpu_torch.storage.store import SetIdentifier

jcf = importlib.import_module("netsdb_tpu.workloads.conv_fusion")
cf = importlib.import_module("netsdb_tpu_torch.workloads.conv_fusion")

TOL = 1e-5


@pytest.fixture
def small_case():
    rng = np.random.default_rng(7)
    images = rng.standard_normal((3, 2, 12, 12)).astype(np.float32)
    kernels = rng.standard_normal((5, 2, 3, 3)).astype(np.float32)
    bias = rng.standard_normal(5).astype(np.float32)
    return images, kernels, bias


@pytest.fixture()
def port(tmp_path):
    return Client(Configuration(root_dir=str(tmp_path / "port")),
                  device="cpu")


def _both(client, port, db, case, **kw):
    j_clear()
    executor.clear_compiled_cache()
    want = jcf.ConvFusionPipeline(db=db, kernel_size=3, block=(16, 16),
                                  **kw).run(client, *case)
    got = cf.ConvFusionPipeline(db=db, kernel_size=3, block=(16, 16),
                                **kw).run(port, *case)
    assert [g.key for g in got] == [w.key for w in want]
    for g, w in zip(got, want):
        assert isinstance(g, cf.Image) and isinstance(g.data, np.ndarray)
        assert g.data.shape == w.data.shape
        np.testing.assert_allclose(g.data, np.asarray(w.data), rtol=TOL,
                                   atol=TOL)
    return got


def test_staged_pipeline_matches_the_reference(client, port, small_case):
    got = _both(client, port, "cf1", small_case)
    assert len(got) == 3
    # and the direct convolution in float64
    images, kernels, bias = (a.astype(np.float64) for a in small_case)
    for img in got:
        x = images[img.key]
        ref = np.zeros((5, 10, 10))
        for o in range(5):
            for y in range(10):
                for xx in range(10):
                    ref[o, y, xx] = (x[:, y:y + 3, xx:xx + 3]
                                     * kernels[o]).sum() + bias[o]
        np.testing.assert_allclose(img.data, ref, rtol=1e-4, atol=1e-4)


def test_stride_and_padding(client, port, small_case):
    got = _both(client, port, "cf2", small_case, stride=2, padding=1)
    assert got[0].data.shape == (5, 6, 6)


def test_intermediate_sets_materialized(client, port, small_case):
    _both(client, port, "cf3", small_case)
    width = 2 * 3 * 3 + 1
    for name, shape in (("kernel_flat", (5, width)),
                        ("image_flat", (3 * 10 * 10, width)),
                        ("result", (300, 5))):
        got = next(port.get_set_iterator("cf3", name))
        want = next(client.get_set_iterator("cf3", name))
        assert got.shape == tuple(want.shape) == shape
        assert got.meta.block_shape == (16, 16)
        assert got.device == port.device
        np.testing.assert_allclose(got.to_dense().numpy(),
                                   np.asarray(want.to_dense()), rtol=TOL,
                                   atol=TOL)
    kflat = next(port.get_set_iterator("cf3", "kernel_flat"))
    iflat = next(port.get_set_iterator("cf3", "image_flat"))
    np.testing.assert_allclose(kflat.to_dense().numpy()[:, -1],
                               small_case[2], rtol=1e-6)
    np.testing.assert_allclose(iflat.to_dense().numpy()[:, width - 1],
                               np.ones(300), rtol=1e-6)


def test_conv_job_compiled_equals_node_by_node(port, small_case):
    pipe = cf.ConvFusionPipeline(db="cf4", kernel_size=3, block=(16, 16))
    pipe.run(port, *small_case)
    compiled = port.get_tensor("cf4", "result").to_dense().clone()
    sink = pipe.build_conv()
    plan = executor.plan_from_sinks([sink])
    values = executor._evaluate(plan, executor.scan_values(port, plan),
                                port.device)
    nbn = values[sink.inputs[0].node_id].to_dense()
    assert (compiled == nbn).all()
    assert any(k.startswith("cf4-conv2d::")
               for k in executor.compiled_cache_keys())


def test_placements_raise_naming_a4(port, tmp_path):
    """Placed conv sets once raised naming ROADMAP.md A4 part 3; they are
    ported: ``image_flat`` row-sharded and ``kernel_flat`` replicated
    over 4 positions give the unplaced run's images bit for bit (each
    position's rows are the same products), with no gather. A placement
    that is no Placement still raises."""
    from netsdb_tpu_torch.parallel.mesh import (clear_gather_log,
                                                gather_log, virtual_devices)
    from netsdb_tpu_torch.parallel.placement import Placement

    rng = np.random.default_rng(8)
    images = rng.standard_normal((3, 3, 12, 12)).astype(np.float32)
    kernels = rng.standard_normal((4, 3, 5, 5)).astype(np.float32)
    solo = cf.ConvFusionPipeline(db="cf5", kernel_size=5, block=(16, 16))
    solo.setup(port)
    want = solo.run(port, images, kernels)
    clear_gather_log()
    with virtual_devices(4, "cpu"):
        c = Client(Configuration(root_dir=str(tmp_path / "placed")),
                   device="cpu")
        placed = cf.ConvFusionPipeline(db="cf5", kernel_size=5,
                                       block=(16, 16))
        placed.setup(c, placements={
            "image_flat": Placement.data_parallel(ndim=2),
            "kernel_flat": Placement.replicated()})
        got = placed.run(c, images, kernels)
        assert c.get_tensor("cf5", "image_flat").data.parts(0) == 4
    assert gather_log() == []
    assert [i.key for i in got] == [i.key for i in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.data, w.data)
    with pytest.raises(TypeError, match="placement"):
        cf.ConvFusionPipeline(db="cf6").setup(port, placements={
            "image_flat": object()})
