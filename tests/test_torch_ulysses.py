"""The port's Ulysses attention against the JAX package's, on the CPU
(``tests/test_attention_parallel.py``'s cases).

The JAX side runs ``ulysses_attention`` under ``shard_map`` on the suite's
virtual CPU devices; the port on as many virtual positions of the CPU,
where ``attention_dispatch`` takes the plain attention (B1, the flash
kernel, is what it launches on a CUDA tensor: ``chip_smoke.py`` phase
18). Same numpy q/k/v from a seed; within rtol = atol = 1e-5 of each
other and of single-device attention (the ring tests' limit)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from netsdb_tpu.parallel.mesh import make_mesh as jmake_mesh
from netsdb_tpu.parallel.ring import ulysses_attention as julysses
from netsdb_tpu_torch.ops.attention import attention
from netsdb_tpu_torch.parallel.mesh import (ShardedTensor, make_mesh,
                                            virtual_devices)
from netsdb_tpu_torch.parallel.ring import ulysses_attention

TOL = dict(rtol=1e-5, atol=1e-5)


def qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def jax_ulysses(arrays, n, causal):
    mesh = jmake_mesh((n,), ("sp",), devices=jax.devices()[:n])
    spec = NamedSharding(mesh, P(None, None, "sp", None))
    q, k, v = (jax.device_put(jnp.asarray(a), spec) for a in arrays)
    return np.asarray(julysses(q, k, v, mesh, axis="sp", causal=causal))


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_ulysses_matches_the_reference(n, causal):
    arrays = qkv((1, 8, 64, 8), seed=n)
    with virtual_devices(n, "cpu"):
        mesh = make_mesh((n,), ("sp",))
        out = ulysses_attention(*(torch.from_numpy(a) for a in arrays),
                                mesh, axis="sp", causal=causal)
    assert isinstance(out, ShardedTensor)
    assert out.spec == (None, None, "sp", None)
    got = out.to_dense().numpy()
    np.testing.assert_allclose(got, jax_ulysses(arrays, n, causal), **TOL)
    single = attention(*(torch.from_numpy(a) for a in arrays), causal)
    np.testing.assert_allclose(got, single.numpy(), **TOL)


def test_ulysses_takes_sharded_inputs_and_keeps_their_layout():
    arrays = qkv((2, 4, 32, 16), seed=3)
    with virtual_devices(4, "cpu"):
        mesh = make_mesh((4,), ("sp",))
        sharded = [ShardedTensor.from_dense(torch.from_numpy(a), mesh,
                                            (None, None, "sp", None))
                   for a in arrays]
        out = ulysses_attention(*sharded, mesh, axis="sp")
    assert out.shards.flat[1].shape == (2, 4, 8, 16)
    np.testing.assert_allclose(out.to_dense().numpy(),
                               jax_ulysses(arrays, 4, True), **TOL)


def test_indivisible_heads_rejected():
    arrays = [torch.from_numpy(a) for a in qkv((1, 4, 64, 8))]
    with virtual_devices(8, "cpu"):
        mesh = make_mesh((8,), ("sp",))
        with pytest.raises(ValueError, match="heads"):
            ulysses_attention(*arrays, mesh, axis="sp")
    with pytest.raises(ValueError, match="heads"):
        jmesh = jmake_mesh((8,), ("sp",))
        julysses(*(jnp.asarray(a.numpy()) for a in arrays), jmesh,
                 axis="sp")


def test_ulysses_over_one_axis_of_a_two_axis_mesh():
    """Positions that differ on the other axis hold replicas and each run
    their own all-to-alls; every replica gives the same answer."""
    arrays = qkv((1, 4, 32, 8), seed=5)
    with virtual_devices(8, "cpu"):
        mesh = make_mesh((2, 4), ("data", "sp"))
        out = ulysses_attention(*(torch.from_numpy(a) for a in arrays),
                                mesh, axis="sp")
    for j in range(4):
        assert torch.equal(out.shards[0, j], out.shards[1, j])
    np.testing.assert_allclose(out.to_dense().numpy(),
                               jax_ulysses(arrays, 4, True), **TOL)

