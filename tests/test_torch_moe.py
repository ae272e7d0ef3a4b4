"""The mixture-of-experts layer of the port against the reference's
(``netsdb_tpu/models/moe.py``) on one device: ``moe_forward`` with
``mesh=None`` and the dense oracle, the params carried across as numpy,
within 1e-5; dropped tokens give zero rows; and expert parallelism over
a mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from netsdb_tpu.models import moe as jmoe
from netsdb_tpu_torch.models import moe
from netsdb_tpu_torch.weights import moe_params_from_numpy

TOL = 1e-5


def _params(d, hidden, n_experts, seed):
    jp = jmoe.init_moe_params(d=d, hidden=hidden, n_experts=n_experts,
                              seed=seed)
    carried = moe_params_from_numpy(
        {n: np.asarray(getattr(jp, n)) for n in ("w_gate", "w_up",
                                                  "w_down")}, device="cpu")
    return jp, carried


def _x(tokens, d, seed):
    return np.random.default_rng(seed).standard_normal(
        (tokens, d)).astype(np.float32)


def test_init_draws_the_references_params():
    jp = jmoe.init_moe_params(d=16, hidden=32, n_experts=4, seed=1)
    pp = moe.init_moe_params(16, 32, 4, seed=1, device="cpu")
    for name in ("w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(getattr(pp, name).numpy(),
                                      np.asarray(getattr(jp, name)))


@pytest.mark.parametrize("cf", [8.0, 2.0, 0.25])
def test_moe_forward_matches_the_reference(cf):
    jp, pp = _params(16, 32, 4, seed=1)
    x = _x(32, 16, 0)
    want = np.asarray(jmoe.moe_forward(jp, jnp.asarray(x),
                                       capacity_factor=cf))
    got = moe.moe_forward(pp, torch.from_numpy(x), capacity_factor=cf)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    oracle = moe.moe_forward_dense_oracle(pp, torch.from_numpy(x), cf)
    np.testing.assert_allclose(oracle.numpy(), want, rtol=1e-4, atol=TOL)
    want_oracle = np.asarray(jmoe.moe_forward_dense_oracle(
        jp, jnp.asarray(x), cf))
    np.testing.assert_allclose(oracle.numpy(), want_oracle, rtol=TOL,
                               atol=TOL)


def test_capacity_overflow_drops_tokens_to_zero_rows():
    jp, pp = _params(8, 16, 2, seed=2)
    x = torch.from_numpy(_x(16, 8, 3))
    tight = moe.moe_forward(pp, x, capacity_factor=0.25)  # 2 per expert
    ample = moe.moe_forward(pp, x, capacity_factor=8.0)
    r = moe.route(pp, x, capacity_factor=0.25)
    assert r.capacity == 2
    dropped = ~r.keep
    assert int(dropped.sum()) > 0
    assert (tight[dropped] == 0).all()
    assert torch.equal(tight[r.keep] != 0, torch.ones_like(tight[r.keep],
                                                           dtype=torch.bool))
    np.testing.assert_allclose(tight[r.keep].numpy(), ample[r.keep].numpy(),
                               rtol=TOL, atol=TOL)
    want = np.asarray(jmoe.moe_forward(jp, jnp.asarray(x.numpy()),
                                       capacity_factor=0.25))
    np.testing.assert_array_equal(np.all(want == 0, axis=1),
                                  dropped.numpy())
    np.testing.assert_allclose(tight.numpy(), want, rtol=TOL, atol=TOL)


def test_mesh_raises_naming_a4():
    """``moe_forward(mesh=)`` once raised naming ROADMAP.md A4; expert
    parallelism is ported: over a (data 2, model 4) mesh it equals the
    reference's expert-parallel run and the port's ``mesh=None`` within
    1e-5 (the combine's sums have one non-zero term each; the batched
    products over fewer experts may take another kernel), and a model
    axis that does not divide the experts raises."""
    from netsdb_tpu.parallel.mesh import make_mesh as jmake_mesh
    from netsdb_tpu_torch.parallel.mesh import make_mesh, virtual_devices

    jp, pp = _params(16, 32, 8, seed=3)
    x = _x(64, 16, 4)
    jmesh = jmake_mesh((2, 4), ("data", "model"))
    want = np.asarray(jax.jit(lambda p, xx: jmoe.moe_forward(
        p, xx, 4.0, jmesh, "model"))(jp, jnp.asarray(x)))
    _, six = _params(16, 32, 6, seed=3)
    with virtual_devices(8, "cpu"):
        mesh = make_mesh((2, 4), ("data", "model"))
        got = moe.moe_forward(pp, torch.from_numpy(x), 4.0, mesh, "model")
        with pytest.raises(ValueError, match="do not split"):
            moe.moe_forward(six, torch.from_numpy(x), 4.0, mesh, "model")
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        got.numpy(), moe.moe_forward(pp, torch.from_numpy(x), 4.0).numpy(),
        rtol=TOL, atol=1e-6)


def test_init_defaults_to_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        assert moe.init_moe_params(4, 8, 2).w_up.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            moe.init_moe_params(4, 8, 2)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            moe_params_from_numpy({"w_gate": np.zeros((4, 2)),
                                   "w_up": np.zeros((2, 4, 8)),
                                   "w_down": np.zeros((2, 8, 4))})
