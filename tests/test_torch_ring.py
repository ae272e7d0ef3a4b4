"""The port's ring attention against the JAX package's, on the CPU.

The JAX side runs on ``tests/conftest.py``'s 8 virtual CPU devices
(``make_mesh((8,), ("sp",))``); the port runs on 8 virtual positions of
the CPU (``virtual_devices(8, "cpu")``). Both take the same numpy q/k/v
and the same fold ('flash': the ring step, Pallas in interpret mode on
the JAX side and the plain version on the port's; 'naive': the
``_block_attn`` fold), within 1e-5 of each other and of single-device
attention."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from netsdb_tpu.ops.attention import attention as jattention
from netsdb_tpu.parallel.mesh import make_mesh as jmake_mesh
from netsdb_tpu.parallel.ring import ring_attention as jring
from netsdb_tpu_torch.ops.attention import attention
from netsdb_tpu_torch.ops.cuda_kernels import flash_attention_step
from netsdb_tpu_torch.parallel import ring
from netsdb_tpu_torch.parallel.mesh import (ShardedTensor, make_mesh,
                                            virtual_devices)

TOL = dict(rtol=1e-5, atol=1e-5)
# the shapes of tests/test_attention_parallel.py's ring tests: the
# naive fold at (1, 2, 64, 8), the flash fold at lane-aligned chunks
SHAPES = {"naive": (1, 2, 64, 8), "flash": (1, 2, 8 * 128, 128)}


def qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.fixture()
def mesh8():
    with virtual_devices(8, "cpu"):
        yield make_mesh((8,), ("sp",))


def jax_ring(arrays, causal, impl):
    mesh = jmake_mesh((8,), ("sp",))
    spec = NamedSharding(mesh, P(None, None, "sp", None))
    q, k, v = (jax.device_put(jnp.asarray(a), spec) for a in arrays)
    return np.asarray(jring(q, k, v, mesh, axis="sp", causal=causal,
                            impl=impl))


@pytest.mark.parametrize("impl", ["flash", "naive"])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_matches_jax_and_single_device(mesh8, impl, causal):
    arrays = qkv(SHAPES[impl])
    out = ring.ring_attention(*(torch.from_numpy(a) for a in arrays), mesh8,
                              axis="sp", causal=causal, impl=impl)
    assert isinstance(out, ShardedTensor)
    got = out.to_dense().numpy()
    np.testing.assert_allclose(got, jax_ring(arrays, causal, impl), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jattention(*(jnp.asarray(a) for a in arrays),
                                   causal=causal)), **TOL)


def test_output_keeps_the_sequence_sharding(mesh8):
    arrays = qkv((1, 2, 64, 8), seed=1)
    out = ring.ring_attention(*(torch.from_numpy(a) for a in arrays), mesh8,
                              axis="sp")
    assert out.spec == (None, None, "sp", None)
    assert out.mesh is mesh8 and out.local_shape == (1, 2, 8, 8)
    whole = attention(*(torch.from_numpy(a) for a in arrays))
    for i in range(8):
        torch.testing.assert_close(out.shards[i],
                                   whole[:, :, 8 * i:8 * (i + 1)],
                                   rtol=1e-5, atol=1e-5)


def test_diagonal_chunk_comes_first(mesh8, monkeypatch):
    """At step i position p folds the chunk that originated at
    (p - i) % n, with global offsets p * s_local and src * s_local."""
    calls = []

    def spy(q, k, v, acc, l, m, q_offset, k_offset, causal, scale):
        calls.append((q_offset, k_offset))
        return flash_attention_step(q, k, v, acc, l, m, q_offset, k_offset,
                                    causal, scale)

    monkeypatch.setattr(ring, "flash_attention_step", spy)
    arrays = qkv((1, 2, 64, 8), seed=2)
    ring.ring_attention(*(torch.from_numpy(a) for a in arrays), mesh8,
                        axis="sp", impl="flash")
    s_local, n = 8, 8
    assert len(calls) == n * n
    for i in range(n):
        for p in range(n):
            assert calls[i * n + p] == (p * s_local,
                                        ((p - i) % n) * s_local)


def test_rotation_between_shared_positions_copies_nothing():
    chunks = [torch.full((2,), float(i)) for i in range(4)]
    out = ring._rotate(chunks)
    assert [int(t[0]) for t in out] == [3, 0, 1, 2]
    assert all(a is b for a, b in zip(out, chunks[-1:] + chunks[:-1]))


def test_auto_select_and_flash_on_cpu_launches_nothing(mesh8):
    assert ring.auto_impl(torch.device("cuda")) == "flash"
    assert ring.auto_impl(torch.device("cuda:1")) == "flash"
    assert ring.auto_impl(torch.device("cpu")) == "naive"
    before = flash_attention_step.launches
    arrays = qkv((1, 2, 64, 8), seed=3)
    out = ring.ring_attention(*(torch.from_numpy(a) for a in arrays), mesh8,
                              axis="sp", impl="flash")
    assert flash_attention_step.launches == before
    np.testing.assert_allclose(out.to_dense().numpy(),
                               jax_ring(arrays, True, "naive"), **TOL)
    with pytest.raises(ValueError, match="unknown ring attention impl"):
        ring.ring_attention(*(torch.from_numpy(a) for a in arrays), mesh8,
                            axis="sp", impl="ulysses")


def test_ring_over_one_axis_of_a_two_axis_mesh():
    """Positions that differ on the other axis hold replicas and each
    run their own ring; every replica gives the same answer."""
    arrays = qkv((1, 2, 32, 8), seed=4)
    with virtual_devices(8, "cpu"):
        mesh = make_mesh((2, 4), ("data", "sp"))
        out = ring.ring_attention(*(torch.from_numpy(a) for a in arrays),
                                  mesh, axis="sp", impl="flash")
    assert out.shards.shape == (2, 4)
    for j in range(4):
        assert torch.equal(out.shards[0, j], out.shards[1, j])
    np.testing.assert_allclose(
        out.to_dense().numpy(),
        np.asarray(jattention(*(jnp.asarray(a) for a in arrays))), **TOL)


def test_ulysses_is_not_ported(mesh8):
    """Ulysses was ROADMAP.md A4 and is ported: over the 8 positions it
    equals the reference's over its 8 devices (tests/test_torch_ulysses.py
    covers the rest)."""
    from netsdb_tpu.parallel.ring import ulysses_attention as julysses

    arrays = qkv((1, 8, 64, 8))
    out = ring.ulysses_attention(*(torch.from_numpy(a) for a in arrays),
                                 mesh8, axis="sp")
    mesh = jmake_mesh((8,), ("sp",))
    spec = NamedSharding(mesh, P(None, None, "sp", None))
    want = julysses(*(jax.device_put(jnp.asarray(a), spec) for a in arrays),
                    mesh, axis="sp")
    np.testing.assert_allclose(out.to_dense().numpy(), np.asarray(want),
                               **TOL)
