"""Pipeline parallelism and expert-parallel MoE of the port
(``parallel/pipeline.py``, ``models/moe.py`` with ``mesh=``) against the
JAX package's (``tests/test_pipeline_moe.py``, all six cases), on the
CPU.

The JAX side runs on ``tests/conftest.py``'s 8 virtual CPU devices; the
port on as many virtual positions of the CPU. Both take the same numpy
params and microbatches from a seed. Each case holds the port to the
reference's own limit against the reference's output (rtol 1e-4, atol
1e-5 for the pipeline; rtol 1e-3, atol 1e-4 for MoE). Where the port's
schedule runs the same stage ops on the same microbatches as a
sequential loop on one position (the pipeline), it is also held to that
one-position result bit for bit. Expert parallelism is held to
``mesh=None`` within 1e-5: every sum of the combine has one non-zero
term, but the batched products over fewer experts may take another
kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from netsdb_tpu.models import moe as jmoe
from netsdb_tpu.parallel.mesh import make_mesh as jmake_mesh
from netsdb_tpu.parallel.pipeline import pipeline_apply as jpipeline_apply
from netsdb_tpu_torch.models import moe
from netsdb_tpu_torch.ops.common import full_f32_precision
from netsdb_tpu_torch.parallel.mesh import make_mesh, virtual_devices
from netsdb_tpu_torch.parallel.pipeline import pipeline_apply
from netsdb_tpu_torch.weights import moe_params_from_numpy

PP_TOL = dict(rtol=1e-4, atol=1e-5)
MOE_TOL = dict(rtol=1e-3, atol=1e-4)


def _stacked(n_stages, d, seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((n_stages, d, d)).astype(
        np.float32) * np.float32(0.3),
        "b": rng.standard_normal((n_stages, d)).astype(
            np.float32) * np.float32(0.1)}


def _jstage(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _stage(params, x):
    full_f32_precision()
    return torch.tanh(x @ params["w"] + params["b"])


def _torch_tree(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _sequential(params, xs, n_stages):
    """Every microbatch through the stages in turn, on one position."""
    outs = []
    for x in xs:
        for i in range(n_stages):
            x = _stage({k: v[i] for k, v in params.items()}, x)
        outs.append(x)
    return torch.stack(outs)


@pytest.mark.parametrize("n_micro, mb, d", [(4, 8, 16), (1, 4, 8)],
                         ids=["matches_sequential", "single_microbatch"])
def test_pipeline_matches_the_reference(n_micro, mb, d):
    """The reference's ``test_matches_sequential`` and
    ``test_single_microbatch``: 8 stages over 8 positions."""
    params = _stacked(8, d, seed=9)
    xs = np.random.default_rng(10).standard_normal((n_micro, mb, d)).astype(
        np.float32)
    want = np.asarray(jpipeline_apply(
        _jstage, {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(xs), jmake_mesh((8,), ("pp",)), "pp"))
    with virtual_devices(8, "cpu"):
        mesh = make_mesh((8,), ("pp",))
        got = pipeline_apply(_stage, _torch_tree(params),
                             torch.from_numpy(xs), mesh, "pp")
    assert got.spec == (None, None, None) and got.shape == want.shape
    np.testing.assert_allclose(got.to_dense().numpy(), want, **PP_TOL)
    seq = _sequential(_torch_tree(params), torch.from_numpy(xs), 8)
    assert torch.equal(got.to_dense(), seq)


@pytest.mark.parametrize("n_positions, n_micro", [(4, 5), (2, 3)])
def test_pipeline_over_a_two_axis_mesh_is_replicated(n_positions, n_micro):
    """The pp axis inside a (data, pp) mesh: every position holds the
    same output, equal to the sequential loop bit for bit."""
    params = _stacked(n_positions, 8, seed=3)
    xs = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (n_micro, 3, 8)).astype(np.float32))
    with virtual_devices(2 * n_positions, "cpu"):
        mesh = make_mesh((2, n_positions), ("data", "pp"))
        got = pipeline_apply(_stage, _torch_tree(params), xs, mesh, "pp")
    seq = _sequential(_torch_tree(params), xs, n_positions)
    for t in got.shards.flat:
        assert torch.equal(t, seq)


def test_pipeline_wrong_stage_count_raises():
    params = _torch_tree(_stacked(4, 8, seed=1))  # 4 stages, 8 positions
    with virtual_devices(8, "cpu"):
        mesh = make_mesh((8,), ("pp",))
        with pytest.raises(ValueError, match="stages"):
            pipeline_apply(_stage, params, torch.zeros(2, 4, 8), mesh, "pp")
    with pytest.raises(ValueError, match="stages"):
        jpipeline_apply(_jstage, {k: jnp.asarray(v.numpy())
                                  for k, v in params.items()},
                        jnp.zeros((2, 4, 8)), jmake_mesh((8,), ("pp",)),
                        "pp")


def _moe_pair(d, hidden, n_experts, seed):
    jp = jmoe.init_moe_params(d=d, hidden=hidden, n_experts=n_experts,
                              seed=seed)
    pp = moe_params_from_numpy(
        {n: np.asarray(getattr(jp, n)) for n in ("w_gate", "w_up",
                                                  "w_down")}, device="cpu")
    return jp, pp


def _x(tokens, d, seed):
    return np.random.default_rng(seed).standard_normal(
        (tokens, d)).astype(np.float32)


def test_moe_matches_dense_oracle():
    jp, pp = _moe_pair(16, 32, 4, seed=1)
    x = _x(32, 16, 2)
    out = moe.moe_forward(pp, torch.from_numpy(x), capacity_factor=8.0)
    oracle = moe.moe_forward_dense_oracle(pp, torch.from_numpy(x), 8.0)
    np.testing.assert_allclose(out.numpy(), oracle.numpy(), **MOE_TOL)
    want = np.asarray(jmoe.moe_forward(jp, jnp.asarray(x), 8.0))
    np.testing.assert_allclose(out.numpy(), want, **MOE_TOL)


def test_moe_capacity_drops_tokens():
    jp, pp = _moe_pair(8, 16, 2, seed=2)
    x = _x(16, 8, 3)
    tight = moe.moe_forward(pp, torch.from_numpy(x), capacity_factor=0.25)
    ample = moe.moe_forward(pp, torch.from_numpy(x), capacity_factor=8.0)
    dropped = int((tight == 0).all(dim=1).sum())
    assert dropped > 0
    assert int((ample == 0).all(dim=1).sum()) <= dropped
    want = np.asarray(jmoe.moe_forward(jp, jnp.asarray(x), 0.25))
    assert dropped == int(np.all(want == 0, axis=1).sum())


@pytest.mark.parametrize("n_experts, axis_size", [(8, 8), (16, 4)])
def test_moe_expert_parallel_matches_unsharded(n_experts, axis_size):
    """The reference's ``test_expert_parallel_matches_unsharded``: the
    experts split over the model axis against ``mesh=None`` and the
    reference's jitted run."""
    jp, pp = _moe_pair(16, 32, n_experts, seed=3)
    x = _x(64, 16, 4)
    jmesh = jmake_mesh((8 // axis_size, axis_size), ("data", "model"))
    want = np.asarray(jax.jit(lambda p, xx: jmoe.moe_forward(
        p, xx, 4.0, jmesh, "model"))(jp, jnp.asarray(x)))
    base = moe.moe_forward(pp, torch.from_numpy(x), 4.0)
    with virtual_devices(8, "cpu"):
        mesh = make_mesh((8 // axis_size, axis_size), ("data", "model"))
        ep = moe.moe_forward(pp, torch.from_numpy(x), 4.0, mesh, "model")
    np.testing.assert_allclose(ep.numpy(), base.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ep.numpy(), want, **MOE_TOL)


def test_moe_expert_axis_must_divide_the_experts():
    _, pp = _moe_pair(8, 16, 6, seed=5)
    with virtual_devices(4, "cpu"):
        mesh = make_mesh((4,), ("model",))
        with pytest.raises(ValueError, match="6 experts"):
            moe.moe_forward(pp, torch.zeros(8, 8), 2.0, mesh, "model")
