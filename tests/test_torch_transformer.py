"""The transformer layer through the port against the JAX package's, on
the CPU, within 1e-4: both load their weights from the same numpy seed
and take the same numpy inputs (embed 64, heads 4, seq 64, batch 2)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from netsdb_tpu.models.transformer import TransformerLayerModel as JaxLayer
from netsdb_tpu.plan.executor import clear_compiled_cache
from netsdb_tpu_torch import Client
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.models.transformer import TransformerLayerModel
from netsdb_tpu_torch.ops import attention as attn
from netsdb_tpu_torch.ops.cuda_kernels import flash_attention
from netsdb_tpu_torch.storage.store import SetIdentifier
from netsdb_tpu_torch.weights import transformer_params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
EMBED, HEADS, SEQ, BATCH = 64, 4, 64, 2


@pytest.fixture()
def port_client(tmp_path):
    return Client(Configuration(root_dir=str(tmp_path / "port")),
                  device="cpu")


def both(client, port_client, seq=SEQ, seed=0):
    clear_compiled_cache()
    jm, pm = JaxLayer(num_heads=HEADS), TransformerLayerModel(num_heads=HEADS)
    x = np.random.default_rng(seed + 1).standard_normal(
        (BATCH, seq, EMBED)).astype(np.float32)
    for m, c in ((jm, client), (pm, port_client)):
        m.setup(c)
        m.load_random_weights(c, embed=EMBED, seed=seed)
        m.load_inputs(c, x)
    return jm, pm, x


@pytest.mark.parametrize("causal", [True, False])
def test_serve_forward_matches_jax(client, port_client, causal):
    jm, pm, _ = both(client, port_client)
    out = pm.serve_forward(port_client, causal=causal)
    assert out.shape == (BATCH, SEQ, EMBED) and out.device.type == "cpu"
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jm.serve_forward(client, causal=causal)),
        **TOL)
    # materialised into the output set as one tensor
    items = port_client.store.get_items(SetIdentifier("transformer", "y"))
    assert len(items) == 1 and items[0] is out


def test_forward_matches_jax_with_carried_params(client, port_client):
    jm, pm, x = both(client, port_client, seed=3)
    jp = jm.params_from_store(client)
    ref = np.asarray(jm.forward(jp, jnp.asarray(x)))
    pp = pm.params_from_store(port_client)
    np.testing.assert_allclose(pm.forward(pp, torch.from_numpy(x)).numpy(),
                               ref, **TOL)
    carried = transformer_params_from_numpy(
        {n: np.asarray(getattr(jp, n)) for n in
         ("w_qkv", "w_out", "w_up", "w_down")}, device="cpu")
    np.testing.assert_allclose(
        pm.forward(carried, torch.from_numpy(x)).numpy(), ref, **TOL)


def test_weights_blocked_like_jax_and_padding_never_leaks(client,
                                                          port_client):
    both(client, port_client)
    for name in ("w_qkv", "w_out", "w_up", "w_down"):
        ours = port_client.get_tensor("transformer", name)
        ref = client.get_tensor("transformer", name)
        assert ours.meta.block_shape == tuple(ref.meta.block_shape)
        np.testing.assert_array_equal(ours.data.numpy(),
                                      np.asarray(ref.data))
    # a weight set with a ragged, padded edge: to_dense strips the
    # margin before the layer reads it, so the output does not change
    pm = TransformerLayerModel(num_heads=HEADS)
    before = pm.serve_forward(port_client).clone()
    w_up = port_client.get_tensor("transformer", "w_up").to_dense()
    port_client.send_matrix("transformer", "w_up", w_up, (48, 100))
    assert port_client.get_tensor("transformer", "w_up").is_padded
    assert tuple(pm.params_from_store(port_client).w_up.shape) == (
        EMBED, 4 * EMBED)
    torch.testing.assert_close(pm.serve_forward(port_client), before)


def test_flash_path_through_the_layer_matches_jax(client, port_client,
                                                  monkeypatch):
    """With the auto-select forced to the one CUDA tensors get, the
    layer takes the flash path (on a CPU tensor: its plain version, no
    launch)."""
    jm, pm, _ = both(client, port_client, seq=256, seed=5)
    monkeypatch.setattr(attn, "auto_impl", lambda device, block_size: "flash")
    before = flash_attention.launches
    out = pm.serve_forward(port_client)
    assert flash_attention.launches == before
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jm.serve_forward(client)), **TOL)


def test_ln_is_population_variance_and_gelu_is_tanh():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32) * 3 + 1
    ln = TransformerLayerModel._ln(torch.from_numpy(x)).numpy()
    mu = x.mean(-1, keepdims=True)
    pop = ((x - mu) ** 2).mean(-1, keepdims=True)   # divide by n, not n-1
    np.testing.assert_allclose(ln, (x - mu) / np.sqrt(pop + 1e-5), **TOL)
    np.testing.assert_allclose(ln, np.asarray(JaxLayer._ln(jnp.asarray(x))),
                               **TOL)
    # the MLP's gelu is the tanh approximation (jax.nn.gelu's default)
    w_up = np.eye(16, 64, dtype=np.float32)
    w_down = np.eye(64, 16, dtype=np.float32)
    params = transformer_params_from_numpy(
        dict(w_qkv=np.zeros((16, 48), np.float32),
             w_out=np.zeros((16, 16), np.float32), w_up=w_up, w_down=w_down),
        device="cpu")
    got = TransformerLayerModel()._mlp(torch.from_numpy(x), params).numpy()
    tanh_gelu = 0.5 * x * (1 + np.tanh(np.sqrt(2 / np.pi)
                                       * (x + 0.044715 * x ** 3)))
    np.testing.assert_allclose(got, tanh_gelu, **TOL)
    erf_gelu = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(got - erf_gelu).max() > 1e-4  # the two really differ here


def test_placed_inputs_are_not_ported(port_client):
    """Placed inputs are ported; what the layer still refuses is the fused
    ``serve_forward`` over a paged weight set (it streams only through
    ``build_forward_dag_staged``), Ulysses attention and a placed
    relational table (ROADMAP.md A4)."""
    from netsdb_tpu.relational.table import ColumnTable
    from netsdb_tpu_torch.parallel.mesh import make_mesh
    from netsdb_tpu_torch.parallel.placement import Placement
    from netsdb_tpu_torch.parallel.ring import ulysses_attention

    paged = TransformerLayerModel(db="paged", num_heads=HEADS)
    paged.setup(port_client, storages={"w_up": "paged"})
    paged.load_random_weights(port_client, embed=EMBED, seed=0)
    paged.load_inputs(port_client, np.ones((1, 8, EMBED), np.float32))
    with pytest.raises(ValueError, match="paged"):
        paged.serve_forward(port_client)
    pm = TransformerLayerModel(num_heads=HEADS)
    q = torch.zeros(1, HEADS, 8, EMBED // HEADS)
    # Ulysses and placed relations are ported (tests/test_torch_ulysses.py,
    # tests/test_torch_sharded_relational.py)
    out = ulysses_attention(q, q, q, make_mesh((1,), ("sp",), [q.device]),
                            axis="sp")
    assert out.to_dense().shape == q.shape
    del ColumnTable
    # a placed input with no sharded axis runs the single-device forward
    pm.setup(port_client)
    pm.load_random_weights(port_client, embed=EMBED, seed=0)
    x = np.random.default_rng(1).standard_normal((1, 8, EMBED))
    pm.load_inputs(port_client, x,
                   placement=Placement.replicated(ndim=3, n_devices=1))
    torch.testing.assert_close(
        pm.serve_forward(port_client),
        pm.forward(pm.params_from_store(port_client),
                   torch.from_numpy(x).float()))
