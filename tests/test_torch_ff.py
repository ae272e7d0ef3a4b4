"""FF inference through the port's database path against the JAX
package's, on the CPU: the same numpy weights and inputs go into a JAX
``Client`` and a port ``Client(device="cpu")``, and ``inference``,
``inference_fused`` (both heads) and ``forward`` must agree, f32 within
1e-5, padded margins included."""

import numpy as np
import pytest
import torch

from netsdb_tpu.models.ff import FFModel as JaxFF
from netsdb_tpu.plan.executor import clear_compiled_cache
from netsdb_tpu_torch import Client
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.models.ff import FFModel
from netsdb_tpu_torch.weights import ff_params_from_numpy, load_matrices

TOL = dict(rtol=1e-5, atol=1e-5)

# the _tiny_model shapes of __graft_entry__.py, and a ragged case
SIZES = {"tiny": dict(block=(8, 8), features=16, hidden=32, labels=8,
                      batch=16),
         "ragged": dict(block=(8, 8), features=13, hidden=27, labels=5,
                        batch=11)}


@pytest.fixture()
def port_client(tmp_path):
    return Client(Configuration(root_dir=str(tmp_path / "port")),
                  device="cpu")


def draw(size, seed=0):
    rng = np.random.default_rng(seed)
    f, h, l, b = (size[k] for k in ("features", "hidden", "labels", "batch"))
    weights = dict(
        w1=rng.standard_normal((h, f)).astype(np.float32) * 0.3,
        b1=rng.standard_normal((h,)).astype(np.float32) * 0.1,
        wo=rng.standard_normal((l, h)).astype(np.float32) * 0.3,
        bo=rng.standard_normal((l,)).astype(np.float32) * 0.1)
    return weights, rng.standard_normal((b, f)).astype(np.float32)


def load_both(client, port_client, size, seed=0):
    # the JAX executor caches a compiled plan per job name and plan
    # shape; inference_fused closes over the params, so start clean
    clear_compiled_cache()
    weights, x = draw(size, seed)
    models = []
    for cls, c in ((JaxFF, client), (FFModel, port_client)):
        m = cls(block=size["block"])
        m.setup(c)
        m.load_weights(c, **weights)
        m.load_inputs(c, x)
        models.append(m)
    return models


def close(ours, ref):
    assert ours.shape == tuple(ref.shape)
    assert ours.meta.block_shape == tuple(ref.meta.block_shape)
    np.testing.assert_allclose(ours.data.numpy(), np.asarray(ref.data), **TOL)
    assert torch.count_nonzero(ours.data * (1 - ours.mask())) == 0


@pytest.mark.parametrize("size", sorted(SIZES))
def test_inference_matches_jax(client, port_client, size):
    jm, pm = load_both(client, port_client, SIZES[size])
    out = pm.inference(port_client)
    close(out, jm.inference(client))
    # materialised into the output set, on the client's device
    stored = port_client.get_tensor("ff", "output")
    assert stored is out and stored.device.type == "cpu"
    assert out.is_padded == (size == "ragged")


@pytest.mark.parametrize("out_mode", ["softmax", "label"])
@pytest.mark.parametrize("size", sorted(SIZES))
def test_inference_fused_matches_jax(client, port_client, size, out_mode):
    jm, pm = load_both(client, port_client, SIZES[size], seed=1)
    close(pm.inference_fused(port_client, out_mode),
          jm.inference_fused(client, out_mode))


@pytest.mark.parametrize("size", sorted(SIZES))
def test_forward_and_logits_match_jax(client, port_client, size):
    jm, pm = load_both(client, port_client, SIZES[size], seed=2)
    jp = jm.params_from_store(client)
    pp = pm.params_from_store(port_client)
    x = port_client.get_tensor("ff", "inputs")
    jx = client.get_tensor("ff", "inputs")
    close(pm.forward(pp, x), jm.forward(jp, jx))
    close(pm.logits(pp, x), jm.logits(jp, jx))
    # the same params carried across as numpy arrays
    carried = ff_params_from_numpy(
        {n: (np.asarray(getattr(jp, n).data), getattr(jp, n).meta.shape,
             getattr(jp, n).meta.block_shape) for n in ("w1", "b1", "wo", "bo")},
        device="cpu")
    close(pm.forward(carried, x), jm.forward(jp, jx))


def test_random_weights_match_jax(client, port_client):
    jm, pm = JaxFF(block=(8, 8)), FFModel(block=(8, 8))
    jm.setup(client)
    pm.setup(port_client)
    jm.load_random_weights(client, 13, 27, 5, seed=3)
    pm.load_random_weights(port_client, 13, 27, 5, seed=3)
    for name in ("w1", "b1", "wo", "bo"):
        np.testing.assert_array_equal(
            port_client.get_tensor("ff", name).data.numpy(),
            np.asarray(client.get_tensor("ff", name).data))


def test_plan_has_the_reference_shape(port_client):
    from netsdb_tpu_torch.plan.planner import plan_from_sinks

    plan = plan_from_sinks([FFModel().build_inference_dag()])
    text = plan.to_plan_string()
    for label in ("FFTransposeMult", "FFReluBiasSum", "FFInputLayerJoin",
                  "FFOutputLayer"):
        assert label in text
    assert sum(a.startswith("scan_") for a in text.splitlines()) == 5
    # independently built DAGs of one shape share one structural key
    again = plan_from_sinks([FFModel().build_inference_dag()])
    assert plan.cache_key() == again.cache_key()


def test_dropout_inference_is_seeded(port_client):
    pm = FFModel(block=(8, 8))
    weights, x = draw(SIZES["ragged"])
    pm.setup(port_client)
    pm.load_weights(port_client, **weights)
    pm.load_inputs(port_client, x)
    runs = [pm.inference(port_client, 0.5, torch.Generator().manual_seed(4))
            for _ in range(2)]
    assert torch.equal(runs[0].data, runs[1].data)
    plain = pm.inference(port_client)
    assert not torch.equal(runs[0].data, plain.data)
    assert torch.count_nonzero(runs[0].data * (1 - runs[0].mask())) == 0


def test_load_matrices_helper(port_client):
    w = np.arange(12, dtype=np.float32).reshape(3, 4)
    load_matrices(port_client, "m", {"w": (w, (2, 2))})
    t = port_client.get_tensor("m", "w")
    assert t.meta.block_shape == (2, 2) and t.meta.padded_shape == (4, 4)
    np.testing.assert_array_equal(t.to_dense().numpy(), w)
    meta = port_client.catalog.get_set("m", "w")["meta"]
    assert meta["shape"] == [3, 4] and meta["block_shape"] == [2, 2]


def test_carried_params_reject_a_dirty_margin():
    bad = np.ones((4, 4), np.float32)
    with pytest.raises(ValueError, match="margin"):
        ff_params_from_numpy({n: (bad, (3, 3), (2, 2))
                              for n in ("w1", "b1", "wo", "bo")},
                             device="cpu")
