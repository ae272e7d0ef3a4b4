"""The sequence-parallel transformer layer through the port against the
JAX package's, on the CPU.

The JAX side runs on ``tests/conftest.py``'s 8 virtual CPU devices; the
port on 8 virtual positions of the CPU (``virtual_devices(8, "cpu")``).
Both load their weights from the same numpy seed and take the same numpy
inputs; on the CPU both rings take their naive fold. Within 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from netsdb_tpu.client import Client as JaxClient
from netsdb_tpu.config import Configuration as JaxConfiguration
from netsdb_tpu.models.transformer import TransformerLayerModel as JaxLayer
from netsdb_tpu.models.transformer import TransformerLayerParams as JaxParams
from netsdb_tpu.parallel.mesh import make_mesh as jmake_mesh
from netsdb_tpu.parallel.placement import Placement as JaxPlacement
from netsdb_tpu.plan.executor import clear_compiled_cache
from netsdb_tpu_torch import Client
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.models import transformer as port_transformer
from netsdb_tpu_torch.models.transformer import TransformerLayerModel
from netsdb_tpu_torch.ops.cuda_kernels import flash_attention_step
from netsdb_tpu_torch.parallel import ring
from netsdb_tpu_torch.parallel.mesh import (ShardedTensor, make_mesh,
                                            virtual_devices)
from netsdb_tpu_torch.parallel.placement import Placement
from netsdb_tpu_torch.storage.store import SetIdentifier
from netsdb_tpu_torch.weights import transformer_params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)


def params(embed, seed):
    rng = np.random.default_rng(seed)
    scale = embed ** -0.5
    return {name: rng.standard_normal(shape).astype(np.float32) * scale
            for name, shape in (("w_qkv", (embed, 3 * embed)),
                                ("w_out", (embed, embed)),
                                ("w_up", (embed, 4 * embed)),
                                ("w_down", (4 * embed, embed)))}


@pytest.mark.parametrize("causal", [True, False])
def test_forward_sp_matches_jax(causal):
    embed, heads, seq = 32, 4, 64
    w = params(embed, seed=1)
    x = np.random.default_rng(2).standard_normal(
        (2, seq, embed)).astype(np.float32)
    jmesh = jmake_mesh((8,), ("sp",))
    jp = JaxParams(**{n: jnp.asarray(a) for n, a in w.items()})
    jx = jax.device_put(jnp.asarray(x),
                        NamedSharding(jmesh, P(None, "sp", None)))
    ref = np.asarray(JaxLayer(num_heads=heads).forward_sp(
        jp, jx, jmesh, axis="sp", causal=causal))
    model = TransformerLayerModel(num_heads=heads)
    with virtual_devices(8, "cpu"):
        mesh = make_mesh((8,), ("sp",))
        out = model.forward_sp(transformer_params_from_numpy(w, device="cpu"),
                               torch.from_numpy(x), mesh, axis="sp",
                               causal=causal)
    assert isinstance(out, ShardedTensor) and out.spec == (None, "sp", None)
    np.testing.assert_allclose(out.to_dense().numpy(), ref, **TOL)
    # and the single-device forward of the same layer
    solo = model.forward(transformer_params_from_numpy(w, device="cpu"),
                         torch.from_numpy(x), causal=causal)
    np.testing.assert_allclose(out.to_dense().numpy(), solo.numpy(), **TOL)


def test_forward_sp_with_the_flash_ring_matches_jax(monkeypatch):
    """With the ring's auto-select forced to the fold CUDA tensors get,
    the layer folds through the ring step (its plain version on the
    CPU, no launch)."""
    embed, heads, seq = 32, 4, 64
    w = params(embed, seed=3)
    x = np.random.default_rng(4).standard_normal(
        (2, seq, embed)).astype(np.float32)
    monkeypatch.setattr(ring, "auto_impl", lambda device: "flash")
    before = flash_attention_step.launches
    with virtual_devices(8, "cpu"):
        out = TransformerLayerModel(num_heads=heads).forward_sp(
            transformer_params_from_numpy(w, device="cpu"),
            torch.from_numpy(x), make_mesh((8,), ("sp",)), axis="sp")
    assert flash_attention_step.launches == before
    jmesh = jmake_mesh((8,), ("sp",))
    jp = JaxParams(**{n: jnp.asarray(a) for n, a in w.items()})
    ref = JaxLayer(num_heads=heads).forward_sp(jp, jnp.asarray(x), jmesh,
                                               axis="sp")
    np.testing.assert_allclose(out.to_dense().numpy(), np.asarray(ref), **TOL)


def run_jax(tmp_path, name, placements, x_placement, x):
    clear_compiled_cache()
    client = JaxClient(JaxConfiguration(root_dir=str(tmp_path / name)))
    m = JaxLayer(db="tl", num_heads=4)
    m.setup(client, placements=placements)
    m.load_random_weights(client, 64, seed=5)
    m.load_inputs(client, x, placement=x_placement)
    return np.asarray(m.serve_forward(client))


def run_port(tmp_path, name, placements, x_placement, x):
    client = Client(Configuration(root_dir=str(tmp_path / name)),
                    device="cpu")
    m = TransformerLayerModel(db="tl", num_heads=4)
    m.setup(client, placements=placements)
    m.load_random_weights(client, 64, seed=5)
    m.load_inputs(client, x, placement=x_placement)
    return client, m.serve_forward(client)


def sp_placements(cls, n):
    axes = (("sp", n),)
    return ({s: cls(axes, (None, None)) for s in TransformerLayerModel.SETS},
            cls(axes, (None, "sp", None)))


def test_serve_forward_through_placed_sets_matches_jax(tmp_path):
    """``tests/test_transformer.py::test_transformer_sp_through_set_api``
    through both packages: weights in replicated placed sets, x sharded
    on the sequence, the forward DAG running the ring over the
    placement's mesh."""
    x = np.random.default_rng(3).standard_normal((2, 64, 64)).astype(
        np.float32)
    ref = run_jax(tmp_path, "jax", *sp_placements(JaxPlacement, 8), x)
    with virtual_devices(8, "cpu"):
        client, out = run_port(tmp_path, "port",
                               *sp_placements(Placement, 8), x)
    assert isinstance(out, ShardedTensor) and out.mesh.shape == {"sp": 8}
    np.testing.assert_allclose(out.to_dense().numpy(), ref, **TOL)
    # the sharded result is the output set's one item, not gathered
    (item,) = client.store.get_items(SetIdentifier("tl", "y"))
    assert item is out
    # and the single-device forward from unplaced sets agrees
    _, solo = run_port(tmp_path, "solo", None, None, x)
    assert isinstance(solo, torch.Tensor)
    np.testing.assert_allclose(out.to_dense().numpy(), solo.numpy(), **TOL)


def test_placement_larger_than_the_positions_collapses(tmp_path,
                                                       monkeypatch):
    """("sp", 16) on 8 positions: the degraded-hardware rule collapses
    the mesh to size 1 in both packages, and both run their single-device
    forward — the port never reaches the ring."""
    def no_ring(*a, **kw):
        raise AssertionError("the collapsed placement reached the ring")

    monkeypatch.setattr(port_transformer, "ring_attention", no_ring)
    x = np.random.default_rng(6).standard_normal((2, 64, 64)).astype(
        np.float32)
    ref = run_jax(tmp_path, "jax", *sp_placements(JaxPlacement, 16), x)
    assert JaxPlacement((("sp", 16),), (None,)).mesh().shape["sp"] == 1
    with virtual_devices(8, "cpu"):
        _, out = run_port(tmp_path, "port", *sp_placements(Placement, 16), x)
    assert isinstance(out, torch.Tensor)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_mesh_of_one_position_runs_the_single_device_forward(tmp_path):
    x = np.random.default_rng(7).standard_normal((2, 64, 64)).astype(
        np.float32)
    with virtual_devices(1, "cpu"):
        _, out = run_port(tmp_path, "one", *sp_placements(Placement, 0), x)
    _, solo = run_port(tmp_path, "solo", None, None, x)
    assert isinstance(out, torch.Tensor)
    torch.testing.assert_close(out, solo)


def test_sp_layer_behind_a_daemon_matches_jax(tmp_path):
    """The layer over placed sets behind a RemoteClient: the DAG carries
    the placement, the daemon (in this process, inside 4 virtual CPU
    positions) resolves the mesh over its own positions and runs the
    ring; the output equals the reference's in-process ``forward_sp`` on
    the same numpy weights within 1e-3, and the daemon's stored output
    is sharded over its 4 positions."""
    from jax.sharding import Mesh as JMesh

    from netsdb_tpu_torch.serve.client import RemoteClient
    from netsdb_tpu_torch.serve.server import ServeController

    embed, heads, seq = 64, 4, 64
    w = params(embed, seed=11)
    x = np.random.default_rng(12).standard_normal(
        (2, seq, embed)).astype(np.float32)
    jmesh = JMesh(np.array(jax.devices()[:4]), ("sp",))
    jp = JaxParams(**{n: jnp.asarray(a) for n, a in w.items()})
    ref = np.asarray(JaxLayer(num_heads=heads).forward_sp(
        jp, jnp.asarray(x), jmesh, axis="sp", causal=True))
    placements, x_placement = sp_placements(Placement, 4)
    with virtual_devices(4, "cpu"):
        ctl = ServeController(Configuration(root_dir=str(tmp_path / "d")),
                              port=0, device="cpu")
        ctl.start()
        try:
            c = RemoteClient(ctl.advertise_addr, timeout=120)
            m = TransformerLayerModel(db="tl", num_heads=heads)
            m.setup(c, placements=placements)
            for name, a in w.items():
                c.send_matrix("tl", name, a, (embed, embed))
            m.load_inputs(c, x, placement=x_placement)
            (out,) = m.serve_forward(c, placement=x_placement)
            (item,) = ctl.library.store.get_items(SetIdentifier("tl", "y"))
            c.close()
        finally:
            ctl.shutdown()
    assert isinstance(item, ShardedTensor) and item.mesh.shape == {"sp": 4}
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-3, atol=1e-3)
