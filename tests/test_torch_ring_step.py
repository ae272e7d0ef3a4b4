"""The port's ring step (B2) against the JAX package's, on the CPU.

On a CPU tensor ``flash_attention_step`` runs its plain version, which
keeps the Pallas kernel's k blocking and exp2-domain carry; it is held
against the JAX ``flash_attention_step`` in interpret mode (as
``tests/test_pallas_kernels.py`` runs it), f32 within 1e-5. The port's
carry keeps l and m as (bh, s_q, 1); the reference's are lane-padded to
(bh, s_q, 128) with lane 0 meaningful, so the tests read lane 0 and
broadcast back when they feed the reference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from netsdb_tpu.ops.pallas_kernels import NEG_INF
from netsdb_tpu.ops.pallas_kernels import flash_attention_step as jstep
from netsdb_tpu_torch.ops.cuda_kernels import (flash_attention,
                                               flash_attention_step,
                                               flash_attention_step_plain)

TOL = dict(rtol=1e-5, atol=1e-5)
BH = 4


def arrays(*shape, seed=0, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def empty_carry(s_q, d):
    return (np.zeros((BH, s_q, d), np.float32),
            np.zeros((BH, s_q, 1), np.float32),
            np.full((BH, s_q, 1), NEG_INF, np.float32))


def to_lanes(x):
    """(bh, s, 1) → the reference's lane-padded (bh, s, 128)."""
    return np.broadcast_to(x, x.shape[:2] + (128,)).copy()


def port_step(q, k, v, carry, q_off, k_off, causal=True, dtype=None):
    dtype = dtype or torch.float32
    acc, l, m = (torch.from_numpy(c.copy()) for c in carry)
    flash_attention_step(torch.from_numpy(q).to(dtype),
                         torch.from_numpy(k).to(dtype),
                         torch.from_numpy(v).to(dtype), acc, l, m,
                         q_offset=q_off, k_offset=k_off, causal=causal)
    return tuple(t.numpy() for t in (acc, l, m))


def jax_step(q, k, v, carry, q_off, k_off, causal=True, dtype=jnp.float32):
    acc, l, m = carry
    out = jstep(jnp.asarray(q, dtype), jnp.asarray(k, dtype),
                jnp.asarray(v, dtype), jnp.asarray(acc),
                jnp.asarray(to_lanes(l)), jnp.asarray(to_lanes(m)),
                q_offset=q_off, k_offset=k_off, causal=causal)
    acc, l, m = (np.asarray(t) for t in out)
    return acc, l[:, :, :1], m[:, :, :1]


def finish(carry):
    acc, l, _ = carry
    return acc / np.maximum(l, 1e-30)


def assert_carry_close(ours, theirs, tol=TOL):
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, b, **tol)


# (s_q, s_k, d, q_offset, k_offset, causal): the chunks a ring meets
STEPS = {
    "diagonal-s64-d32": (64, 64, 32, 0, 0, True),
    "diagonal-s128-d128": (128, 128, 128, 128, 128, True),
    "past-s64-d32": (64, 64, 32, 64, 0, True),
    "past-s128-d128": (128, 128, 128, 256, 0, True),
    "sq-ne-sk": (64, 128, 32, 64, 0, True),
    "sk-ne-sq-past": (128, 64, 32, 128, 64, True),
    "noncausal-s64-d32": (64, 64, 32, 64, 128, False),
    "noncausal-s128-d128": (128, 128, 128, 0, 128, False),
}


@pytest.mark.parametrize("case", list(STEPS))
def test_step_matches_jax_kernel(case):
    s_q, s_k, d, q_off, k_off, causal = STEPS[case]
    (q,) = arrays(BH, s_q, d, seed=1, n=1)
    k, v = arrays(BH, s_k, d, seed=2, n=2)
    # a live carry first (the query chunk's own diagonal chunk), then
    # the step under test, through both packages
    q_self, k_self = arrays(BH, s_q, d, seed=3, n=2)
    port = port_step(q, q_self, k_self, empty_carry(s_q, d), q_off, q_off)
    ref = jax_step(q, q_self, k_self, empty_carry(s_q, d), q_off, q_off)
    assert_carry_close(port, ref)
    port = port_step(q, k, v, port, q_off, k_off, causal)
    ref = jax_step(q, k, v, ref, q_off, k_off, causal)
    assert_carry_close(port, ref)
    np.testing.assert_allclose(finish(port), finish(ref), **TOL)


@pytest.mark.parametrize("s,d", [(64, 32), (128, 128)])
def test_future_chunk_leaves_the_carry_unchanged(s, d):
    q, k, v = arrays(BH, s, d, seed=4)
    live = port_step(q, k, v, empty_carry(s, d), s, s)
    for carry in (live, empty_carry(s, d)):
        again = port_step(q, k, v, carry, s, 2 * s)
        for a, b in zip(again, carry):
            np.testing.assert_array_equal(a, b)
        ref = jax_step(q, k, v, carry, s, 2 * s)
        assert_carry_close(again, ref, dict(rtol=0, atol=0))


def test_fully_masked_rows_keep_an_empty_carry():
    """Keys at 32..95 against queries at 0..63: rows 0..31 see no live
    key. Their empty carry stays (0, 0, NEG_INF) — the reference's fold
    would count exp2(NEG_INF - NEG_INF) = 1 per masked key there, a case
    its ring never reaches — and the other rows match the reference."""
    q, k, v = arrays(BH, 64, 32, seed=5)
    acc, l, m = port_step(q, k, v, empty_carry(64, 32), 0, 32)
    np.testing.assert_array_equal(acc[:, :32], 0)
    np.testing.assert_array_equal(l[:, :32], 0)
    np.testing.assert_array_equal(m[:, :32], np.float32(NEG_INF))
    ref = jax_step(q, k, v, empty_carry(64, 32), 0, 32)
    assert_carry_close((acc[:, 32:], l[:, 32:], m[:, 32:]),
                       tuple(t[:, 32:] for t in ref))


def test_bf16_rounds_like_the_jax_kernel():
    q, k, v = arrays(BH, 64, 32, seed=6)
    port = port_step(q, k, v, empty_carry(64, 32), 0, 0,
                     dtype=torch.bfloat16)
    port = port_step(q, k, v, port, 64, 0, dtype=torch.bfloat16)
    ref = jax_step(q, k, v, empty_carry(64, 32), 0, 0, dtype=jnp.bfloat16)
    ref = jax_step(q, k, v, ref, 64, 0, dtype=jnp.bfloat16)
    # both round q·scale·log2e and P to bf16 at the same places; sums
    # run in f32 in another order, so a rounding of P may differ
    np.testing.assert_allclose(finish(port), finish(ref), rtol=1e-2,
                               atol=1e-2)
    np.testing.assert_allclose(port[2], ref[2], rtol=1e-5, atol=1e-5)


def test_lane_padded_carry_adapter_round_trips():
    """Alternate the two packages step by step, handing the carry over
    through the lane adapter each time: the result equals each
    package's own chain."""
    s, d, n = 64, 32, 4
    q, k, v = arrays(BH, n * s, d, seed=7)
    qc = q[:, -s:]
    mixed = port_only = jax_only = empty_carry(s, d)
    for i in range(n):
        chunk = (qc, k[:, i * s:(i + 1) * s], v[:, i * s:(i + 1) * s])
        step = port_step if i % 2 == 0 else jax_step
        mixed = step(*chunk, mixed, (n - 1) * s, i * s)
        port_only = port_step(*chunk, port_only, (n - 1) * s, i * s)
        jax_only = jax_step(*chunk, jax_only, (n - 1) * s, i * s)
    assert_carry_close(mixed, port_only)
    assert_carry_close(mixed, jax_only)
    lanes = to_lanes(port_only[1])
    assert lanes.shape == (BH, s, 128)
    np.testing.assert_array_equal(lanes[:, :, :1], port_only[1])


@pytest.mark.parametrize("causal", [True, False])
def test_carry_step_chain_matches_flash(causal):
    """Folding a sequence chunk by chunk through flash_attention_step
    reproduces the port's flash_attention over the whole sequence, and
    the JAX package's chain of the same steps."""
    bh, n_chunks, sl, d = BH, 4, 128, 128
    s = n_chunks * sl
    q, k, v = arrays(bh, s, d, seed=5)
    whole = flash_attention(*(torch.from_numpy(a).reshape(1, bh, s, d)
                              for a in (q, k, v)),
                            causal=causal).reshape(bh, s, d).numpy()
    outs, refs = [], []
    for qi in range(n_chunks):
        qc = q[:, qi * sl:(qi + 1) * sl]
        port = ref = empty_carry(sl, d)
        for ki in range(n_chunks):
            chunk = (qc, k[:, ki * sl:(ki + 1) * sl],
                     v[:, ki * sl:(ki + 1) * sl])
            port = port_step(*chunk, port, qi * sl, ki * sl, causal)
            ref = jax_step(*chunk, ref, qi * sl, ki * sl, causal)
        outs.append(finish(port))
        refs.append(finish(ref))
    np.testing.assert_allclose(np.concatenate(outs, axis=1), whole, **TOL)
    np.testing.assert_allclose(np.concatenate(outs, axis=1),
                               np.concatenate(refs, axis=1), **TOL)


def test_step_consumes_the_carry_and_only_reads_qkv():
    q, k, v = (torch.from_numpy(a) for a in arrays(BH, 64, 32, seed=8))
    keep = [t.clone() for t in (q, k, v)]
    acc, l, m = (torch.from_numpy(c) for c in empty_carry(64, 32))
    out = flash_attention_step(q, k, v, acc, l, m, q_offset=0, k_offset=0)
    assert all(a is b for a, b in zip(out, (acc, l, m)))  # in place
    assert bool((l > 0).all())
    for a, b in zip((q, k, v), keep):
        assert torch.equal(a, b)
    # the plain version returns new tensors and leaves its inputs alone
    before = [t.clone() for t in (acc, l, m)]
    new = flash_attention_step_plain(q, k, v, acc, l, m, 64, 0)
    assert all(a is not b for a, b in zip(new, (acc, l, m)))
    for a, b in zip((acc, l, m), before):
        assert torch.equal(a, b)


def test_step_on_cpu_counts_no_launch():
    before = flash_attention_step.launches
    port_step(*arrays(BH, 64, 32), empty_carry(64, 32), 0, 0)
    assert flash_attention_step.launches == before


def test_step_operand_checks_raise():
    q, k, v = (torch.from_numpy(a) for a in arrays(BH, 64, 32, seed=9))
    acc, l, m = (torch.from_numpy(c) for c in empty_carry(64, 32))
    with pytest.raises(ValueError, match="carry l"):
        flash_attention_step(q, k, v, acc, l.reshape(BH, 64), m, 0, 0)
    with pytest.raises(ValueError, match="carry acc"):
        flash_attention_step(q, k, v, acc.double(), l, m, 0, 0)
    with pytest.raises(TypeError, match="dtype"):
        flash_attention_step(q, k.double(), v, acc, l, m, 0, 0)
    with pytest.raises(ValueError, match="do not fit"):
        flash_attention_step(q, k[:, :, :16], v[:, :, :16], acc, l, m, 0, 0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention_step(*(t.to("meta") for t in (q, k, v, acc, l, m)),
                             q_offset=0, k_offset=0)
