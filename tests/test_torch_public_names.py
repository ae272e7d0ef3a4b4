"""Public names of the done slices against the reference's:
``Client.collect_stats``, ``Client.mesh`` and ``ops/nn.py``'s ``relu``,
``bias_exp``, ``row_sum`` and ``col_sum`` (on padded blocked inputs,
within 1e-6)."""

import numpy as np
import pytest
import torch

from netsdb_tpu.client import Client as JClient
from netsdb_tpu.config import Configuration as JConfiguration
from netsdb_tpu.core.blocked import BlockedTensor as JBlocked
from netsdb_tpu.ops import nn as jnn
from netsdb_tpu.parallel.placement import Placement as JPlacement
from netsdb_tpu_torch import Client
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.core.blocked import BlockedTensor
from netsdb_tpu_torch.ops import nn
from netsdb_tpu_torch.parallel.mesh import virtual_devices
from netsdb_tpu_torch.parallel.placement import Placement

TOL = 1e-6


def _fill(c, placement_cls):
    rng = np.random.default_rng(0)
    c.create_database("d")
    c.create_set("d", "m")
    c.send_matrix("d", "m", rng.standard_normal((20, 12), dtype=np.float32),
                  (8, 8))
    c.create_set("d", "o", type_name="object", persistence="persistent")
    c.send_data("d", "o", [{"k": 1}, {"k": 2}, {"k": 3}])
    c.create_set("d", "p", placement=placement_cls.data_parallel(ndim=2))
    c.send_matrix("d", "p", rng.standard_normal((16, 8), dtype=np.float32),
                  (4, 4))
    c.create_set("d", "empty")


def test_collect_stats_matches_the_reference(tmp_path):
    ref = JClient(JConfiguration(root_dir=str(tmp_path / "ref")))
    _fill(ref, JPlacement)
    with virtual_devices(8, "cpu"):
        port = Client(Configuration(root_dir=str(tmp_path / "port")),
                      device="cpu")
        _fill(port, Placement)
        got = port.collect_stats()
    want = ref.collect_stats()
    assert sorted(got) == sorted(want) == ["d:empty", "d:m", "d:o", "d:p"]
    for name, w in want.items():
        g = got[name]
        assert set(w) <= set(g), (name, set(w) - set(g))
        for key in w:
            if key == "version":  # store-wide counters number differently
                continue
            assert g[key] == w[key], (name, key, g[key], w[key])


def test_client_mesh_is_the_last_placements_mesh(tmp_path):
    """As ``tests/test_placement_api.py:75``: the client's mesh is the
    placement's mesh over the client's device positions."""
    with virtual_devices(8, "cpu"):
        c = Client(Configuration(root_dir=str(tmp_path)), device="cpu")
        assert c.mesh is None
        c.create_database("d")
        c.create_set("d", "plain")
        assert c.mesh is None
        c.create_set("d", "m", placement=Placement.data_parallel(ndim=2))
        c.send_matrix("d", "m", np.arange(64 * 16, dtype=np.float32)
                      .reshape(64, 16), block_shape=(8, 8))
        assert c.mesh is Placement.data_parallel(ndim=2).mesh()
        assert c.mesh.shape == {"data": 8}
        assert c.store.set_stats(c.store.list_sets()[1])[
            "placement"].startswith("mesh[")
        c.create_set("d", "r", placement=Placement.replicated())
        assert c.mesh is Placement.replicated().mesh()


def _pair(shape, block, seed):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (JBlocked.from_dense(a, block),
            BlockedTensor.from_dense(a, block, device="cpu"))


def _same(got: BlockedTensor, want: JBlocked):
    assert got.meta.shape == tuple(want.meta.shape)
    assert got.meta.block_shape == tuple(want.meta.block_shape)
    g = got.data.numpy()
    w = np.asarray(want.data)
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    if got.meta.is_padded:  # the zero margin
        assert not (g * (1 - got.mask().numpy())).any()


@pytest.mark.parametrize("shape,block", [((10, 7), (4, 4)),
                                         ((16, 8), (8, 8)),
                                         ((5, 13), (2, 6))])
def test_relu_row_sum_col_sum_on_padded_blocks(shape, block):
    ja, pa = _pair(shape, block, 1)
    _same(nn.relu(pa), jnn.relu(ja))
    _same(nn.row_sum(pa), jnn.row_sum(ja))
    _same(nn.col_sum(pa), jnn.col_sum(ja))


@pytest.mark.parametrize("shape,block", [((10, 7), (4, 4)),
                                         ((16, 8), (8, 8)),
                                         ((5, 13), (2, 6))])
def test_bias_exp_on_padded_blocks(shape, block):
    """exp(x + b) — the ``FFTransposeBiasSum`` stage; exp(0) = 1, so the
    margin must be masked again."""
    ja, pa = _pair(shape, block, 2)
    bias = np.random.default_rng(3).standard_normal(
        (shape[0], 1)).astype(np.float32) * 0.1
    jb = JBlocked.from_dense(bias, (block[0], 1))
    pb = BlockedTensor.from_dense(bias, (block[0], 1), device="cpu")
    _same(nn.bias_exp(pa, pb), jnn.bias_exp(ja, jb))
