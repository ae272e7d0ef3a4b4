"""The port's placements, meshes and sharded values against the JAX
package's, on the CPU: the same placements resolve to the same axes, the
catalog keeps the same ``"sharding"`` meta, and a blocked tensor placed
on a mesh keeps the reference's layout and its zero margin."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from netsdb_tpu.core.blocked import BlockedTensor as JaxBlocked
from netsdb_tpu.parallel.mesh import make_mesh as jmake_mesh
from netsdb_tpu.parallel.mesh import shard_blocked as jshard_blocked
from netsdb_tpu.parallel.placement import Placement as JaxPlacement
from netsdb_tpu.relational.table import ColumnTable
from netsdb_tpu_torch import Client
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.core.blocked import BlockedTensor
from netsdb_tpu_torch.parallel import mesh as pmesh
from netsdb_tpu_torch.parallel.mesh import (ShardedTensor, make_mesh,
                                            replicate, shard_blocked,
                                            virtual_devices)
from netsdb_tpu_torch.parallel.placement import Placement
from netsdb_tpu_torch.storage.store import SetIdentifier

PLACEMENTS = {
    "data-parallel": Placement.data_parallel(ndim=2),
    "replicated": Placement.replicated(ndim=2, n_devices=4),
    "sequence": Placement((("sp", 8),), (None, "sp", None)),
    "two-axes": Placement((("data", 2), ("model", 0)), ("data", "model")),
    "joint-axes": Placement((("a", 2), ("b", 4)), (("a", "b"), None)),
}


def jax_twin(p: Placement) -> JaxPlacement:
    return JaxPlacement.from_meta(p.to_meta())


@pytest.mark.parametrize("name", list(PLACEMENTS))
def test_meta_round_trip_matches_jax(name):
    p = PLACEMENTS[name]
    assert Placement.from_meta(p.to_meta()) == p
    assert p.to_meta() == jax_twin(p).to_meta()
    assert p.label() == jax_twin(p).label()
    assert Placement.from_meta(None) is None
    assert Placement.from_meta({}) is None


# (axes, n_devices): size-0 axes, the degraded collapse, fixed sizes
RESOLVE = {
    "free-axis-8": ((("data", 0),), 8),
    "free-axis-1": ((("data", 0),), 1),
    "fixed-and-free": ((("data", 2), ("model", 0)), 8),
    "uneven-remainder": ((("a", 3), ("b", 0)), 8),
    "degraded": ((("sp", 8),), 4),
    "degraded-2d": ((("a", 4), ("b", 4)), 8),
    "fits": ((("a", 2), ("b", 4)), 8),
    "fixed-over-n": ((("a", 16), ("b", 0)), 8),
}


@pytest.mark.parametrize("name", list(RESOLVE))
def test_resolved_axes_match_jax(name):
    axes, n = RESOLVE[name]
    ours = Placement(axes, (None,)).resolved_axes(n)
    assert ours == JaxPlacement(axes, (None,)).resolved_axes(n)


def test_two_free_axes_raise_in_both():
    axes = (("a", 0), ("b", 0))
    with pytest.raises(ValueError, match="at most one axis"):
        Placement(axes, (None,)).resolved_axes(8)
    with pytest.raises(ValueError, match="at most one axis"):
        JaxPlacement(axes, (None,)).resolved_axes(8)


def test_mesh_over_virtual_positions_and_axis_size():
    with virtual_devices(8, "cpu") as devices:
        assert len(devices) == 8
        p = PLACEMENTS["two-axes"]
        mesh = p.mesh()
        assert mesh.shape == {"data": 2, "model": 4}
        assert mesh is p.mesh()  # cached: equal placements share a mesh
        assert p.axis_size() == 8 == jax_twin(p).axis_size()
        assert Placement.data_parallel().axis_size() == 8
    # outside the block the CPU is one position again: degraded
    assert pmesh.visible_devices("cpu") == (torch.device("cpu"),)
    assert PLACEMENTS["sequence"].mesh(
        pmesh.visible_devices("cpu")).shape == {"sp": 1}


def test_virtual_positions_are_never_the_default():
    """Positions default to the visible cards and never fall back to the
    CPU; virtual positions hold only inside their block."""
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in pmesh.visible_devices())
    else:
        with pytest.raises(RuntimeError, match="'cpu'"):
            pmesh.visible_devices()
    saved = pmesh.make_mesh((1,), ("data",), pmesh.visible_devices("cpu"))
    pmesh.set_default_mesh(saved)
    try:
        with virtual_devices(4, "cpu"):
            assert pmesh.default_mesh().size == 4
            assert pmesh.visible_devices() == (torch.device("cpu"),) * 4
            with virtual_devices(2, "cpu"):
                assert len(pmesh.visible_devices("cpu")) == 2
            assert len(pmesh.visible_devices("cpu")) == 4
        assert pmesh.default_mesh() is saved
    finally:
        pmesh.set_default_mesh(None)
    with pytest.raises(ValueError, match="at least one"):
        with virtual_devices(0, "cpu"):
            pass


@pytest.fixture()
def port_client(tmp_path):
    c = Client(Configuration(root_dir=str(tmp_path / "port")), device="cpu")
    c.create_database("d")
    return c


def test_catalog_round_trip_of_a_placed_set(client, port_client):
    p = PLACEMENTS["sequence"]
    client.create_database("d")
    client.create_set("d", "x", placement=jax_twin(p))
    with virtual_devices(8, "cpu"):
        port_client.create_set("d", "x", placement=p)
        port_client.create_set("d", "w", placement=p.to_meta())  # dict form
    ours = port_client.catalog.get_set("d", "x")["meta"]["sharding"]
    assert ours == client.catalog.get_set("d", "x")["meta"]["sharding"]
    assert Placement.from_meta(ours) == p
    for name in ("x", "w"):
        assert port_client.store.placement_of(SetIdentifier("d", name)) == p
    with pytest.raises(TypeError, match="Placement"):
        port_client.create_set("d", "bad", placement=object())
    with pytest.raises(ValueError, match="at most one axis"):
        port_client.create_set("d", "bad", placement=Placement(
            (("a", 0), ("b", 0)), (None,)))
    assert not port_client.catalog.set_exists("d", "bad")


def test_placed_set_stores_sharded_values(port_client):
    x = np.arange(2 * 16 * 4, dtype=np.float32).reshape(2, 16, 4)
    with virtual_devices(8, "cpu"):
        port_client.create_set("d", "x", placement=PLACEMENTS["sequence"])
        port_client.send_data("d", "x", [x])
        (item,) = port_client.store.get_items(SetIdentifier("d", "x"))
    assert isinstance(item, ShardedTensor)
    assert item.local_shape == (2, 2, 4) and item.shards.shape == (8,)
    np.testing.assert_array_equal(item.to_dense().numpy(), x)
    for i in range(8):
        np.testing.assert_array_equal(item.shards[i].numpy(),
                                      x[:, 2 * i:2 * (i + 1)])


@pytest.mark.parametrize("rows,spec", [(16, ("data", None)),
                                       (6, ("data", None)),
                                       (16, (None, None))])
def test_shard_blocked_keeps_layout_and_zero_margin(rows, spec):
    """A ragged blocked matrix on the 8-position mesh: the reference's
    divisibility fallback (a dimension the padded shape cannot split
    stays replicated) picks the same spec, and every shard's padded
    margin stays zero."""
    dense = np.random.default_rng(0).standard_normal(
        (rows - 1, 7)).astype(np.float32)
    ours = BlockedTensor.from_dense(dense, (2, 4))
    theirs = JaxBlocked.from_dense(jnp.asarray(dense), (2, 4))
    with virtual_devices(8, "cpu"):
        mesh = make_mesh((8,), ("data",))
        placed = shard_blocked(ours, mesh, spec)
    jplaced = jshard_blocked(theirs, jmake_mesh((8,), ("data",)),
                             PartitionSpec(*spec))
    jspec = tuple(jplaced.data.sharding.spec)
    assert placed.data.spec == jspec + (None,) * (2 - len(jspec))
    np.testing.assert_array_equal(placed.data.to_dense().numpy(),
                                  np.asarray(jplaced.data))
    mask = ours.mask()
    for idx in mesh.positions():
        region = placed.data.region(idx)
        margin = placed.data.shards[idx] * (1 - mask[region])
        assert float(margin.abs().max()) == 0.0
    logical = placed.to_dense()  # gathers where a sharded dim is cut
    if isinstance(logical, ShardedTensor):
        logical = logical.to_dense()
    np.testing.assert_array_equal(logical.numpy(), dense)


def test_replicate_keeps_one_copy_per_device():
    bt = BlockedTensor.from_dense(np.ones((5, 3), np.float32), (2, 2))
    with virtual_devices(4, "cpu"):
        placed = replicate(bt, make_mesh((4,), ("data",)))
    shards = list(placed.data.shards.flat)
    assert all(s is shards[0] for s in shards)  # one physical device
    dense = placed.to_dense()  # cutting the margin keeps it replicated
    assert isinstance(dense, ShardedTensor) and dense.shape == (5, 3)
    assert all(s is dense.shards.flat[0] for s in dense.shards.flat)
    assert float(placed.data.first()[5:].abs().max()) == 0.0


def test_sharded_tensor_checks_and_gathers():
    with virtual_devices(4, "cpu"):
        mesh = make_mesh((4,), ("sp",))
        x = torch.arange(24.0).reshape(2, 12)
        st = ShardedTensor.from_dense(x, mesh, (None, "sp"))
        assert st.shape == (2, 12) and st.dtype == torch.float32
        torch.testing.assert_close(st.to_dense(), x)
        torch.testing.assert_close(st[:, :6], x[:, :6])  # cuts a sharded dim
        with pytest.raises(ValueError, match="does not split"):
            ShardedTensor.from_dense(torch.zeros(2, 10), mesh, (None, "sp"))
        with pytest.raises(ValueError, match="more entries"):
            ShardedTensor.from_dense(torch.zeros(2), mesh, (None, "sp", None))
        with pytest.raises(ValueError, match="expected"):
            ShardedTensor(st.shards, mesh, ("sp", None), (2, 12))


def test_placing_a_column_table_is_not_ported():
    """Row-sharded relations are ``relational/sharded.py``: ROADMAP.md A4."""
    table = ColumnTable.from_rows([{"a": 1}, {"a": 2}])
    with pytest.raises(NotImplementedError, match="ROADMAP.md A4"):
        Placement.data_parallel().apply(table)
    assert Placement.data_parallel().apply("host object") == "host object"
