"""The port's attention against the JAX package's, on the CPU.

On a CPU tensor ``flash_attention`` runs its plain version, which keeps
the Pallas kernel's blocking and exp2-domain carry; it is held against
the JAX kernel in interpret mode (as ``tests/test_pallas_kernels.py``
runs it) and against the JAX package's plain ``attention``, f32 within
1e-5."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from netsdb_tpu.ops import attention as jattn
from netsdb_tpu.ops.pallas_kernels import flash_attention as jflash
from netsdb_tpu_torch.ops import attention as attn
from netsdb_tpu_torch.ops.cuda_kernels import (flash_attention,
                                               flash_attention_plain)

TOL = dict(rtol=1e-5, atol=1e-5)


def qkv(b=2, h=3, s=128, d=32, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d)).astype(np.float32)
            for _ in range(3)]


def ours(arrays):
    return [torch.from_numpy(a) for a in arrays]


def theirs(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_jax_kernel_and_full(causal):
    arrays = qkv()
    out = flash_attention(*ours(arrays), causal=causal, block_q=32,
                          block_k=32).numpy()
    np.testing.assert_allclose(
        out, np.asarray(jflash(*theirs(arrays), causal=causal, block_q=32,
                               block_k=32)), **TOL)
    np.testing.assert_allclose(
        out, np.asarray(jattn.attention(*theirs(arrays), causal=causal)),
        **TOL)


def test_flash_unequal_blocks():
    arrays = qkv(s=128)
    out = flash_attention(*ours(arrays), block_q=64, block_k=32).numpy()
    np.testing.assert_allclose(
        out, np.asarray(jflash(*theirs(arrays), block_q=64, block_k=32)),
        **TOL)
    np.testing.assert_allclose(
        out, np.asarray(jattn.attention(*theirs(arrays))), **TOL)


def test_flash_custom_scale_and_dtype_preserved():
    arrays = qkv(s=64)
    out = flash_attention(*ours(arrays), scale=0.5, block_q=32, block_k=32)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jattn.attention(*theirs(arrays), scale=0.5)),
        **TOL)


def test_flash_bf16_rounds_like_the_jax_kernel():
    arrays = qkv(s=64)
    q, k, v = (t.to(torch.bfloat16) for t in ours(arrays))
    out = flash_attention(q, k, v, block_q=32, block_k=32)
    assert out.dtype == torch.bfloat16
    ref = jflash(*(jnp.asarray(a, jnp.bfloat16) for a in arrays),
                 block_q=32, block_k=32)
    # both round q·scale and P to bf16 at the same places; the output's
    # last bf16 ulp may differ with the f32 summation order
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


def test_flash_gcd_block_fallback():
    # s=96 with block 64 → gcd 32: warns, runs, matches plain attention
    arrays = qkv(s=96)
    with pytest.warns(UserWarning, match="falling back"):
        out = flash_attention(*ours(arrays), block_q=64, block_k=64)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jattn.attention(*theirs(arrays))), **TOL)


def test_flash_rejects_unusable_seq():
    # gcd(100, 64) = 4 < 8 → no usable block, in both packages
    arrays = qkv(s=100)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(ValueError, match="usable block"):
            flash_attention(*ours(arrays), block_q=64, block_k=64)
        with pytest.raises(ValueError, match="usable block"):
            jflash(*theirs(arrays), block_q=64, block_k=64)


def test_flash_on_cpu_counts_no_launch():
    before = flash_attention.launches
    flash_attention(*ours(qkv(s=64)), block_q=32, block_k=32)
    assert flash_attention.launches == before


def test_flash_plain_needs_dividing_blocks():
    with pytest.raises(ValueError, match="must divide"):
        flash_attention_plain(*ours(qkv(s=96)), block_q=64, block_k=64)


@pytest.mark.parametrize("impl,block", [("full", None), ("blockwise", 32),
                                        ("flash", None), ("flash", 32),
                                        (None, None), (None, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_dispatch_each_impl(impl, block, causal):
    arrays = qkv(s=128)
    out = attn.attention_dispatch(*ours(arrays), causal=causal, impl=impl,
                                  block_size=block)
    np.testing.assert_allclose(
        out.numpy(),
        np.asarray(jattn.attention_dispatch(*theirs(arrays), causal=causal,
                                            impl=impl, block_size=block)),
        **TOL)


def test_attention_dispatch_rejects_unknown_impl():
    with pytest.raises(ValueError, match="unknown attention impl"):
        attn.attention_dispatch(*ours(qkv(s=64)), impl="ring")


def test_auto_select_picks_flash_on_hopper(monkeypatch):
    """CUDA tensors always auto-select the kernel, whatever the sequence
    length or block size (the kernel masks a ragged sequence); CPU
    tensors keep the reference's off-TPU rule. With the rule forced to
    flash, s=128 (not a whole number of 256-blocks) runs the flash path
    and matches plain attention."""
    for device in ("cuda", "cuda:0"):
        assert attn.auto_impl(torch.device(device), None) == "flash"
        assert attn.auto_impl(torch.device(device), 96) == "flash"
    assert attn.auto_impl(torch.device("cpu"), None) == "full"
    assert attn.auto_impl(torch.device("cpu"), 32) == "blockwise"

    called = []

    def spy(*a, **kw):
        called.append(a[0].shape[2])
        return flash_attention(*a, **kw)

    monkeypatch.setattr(attn, "flash_attention", spy)
    attn.attention_dispatch(*ours(qkv(b=1, h=2, s=128, d=16)))  # CPU: full
    assert called == []
    monkeypatch.setattr(attn, "auto_impl", lambda device, block_size: "flash")
    arrays = qkv(b=1, h=2, s=128, d=16)
    out = attn.attention_dispatch(*ours(arrays))
    assert called == [128]
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jattn.attention(*theirs(arrays))), **TOL)


def test_mha_forward_and_head_layout():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 16, 24)).astype(np.float32)
    w_qkv = rng.standard_normal((24, 72)).astype(np.float32) * 0.2
    w_out = rng.standard_normal((24, 24)).astype(np.float32) * 0.2
    for impl in ("full", "flash"):
        out = attn.mha_forward(*(torch.from_numpy(a) for a in
                                 (x, w_qkv, w_out)), num_heads=4, impl=impl,
                               block_size=8 if impl == "flash" else None)
        np.testing.assert_allclose(
            out.numpy(),
            np.asarray(jattn.mha_forward(jnp.asarray(x), jnp.asarray(w_qkv),
                                         jnp.asarray(w_out), 4, impl="full")),
            **TOL)
    qkv_t = torch.from_numpy(rng.standard_normal((2, 16, 72)).astype(np.float32))
    q, k, v = attn.split_qkv_heads(qkv_t, 4)
    jq, _, jv = jattn.split_qkv_heads(jnp.asarray(qkv_t.numpy()), 4)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(attn.merge_heads(q).numpy(),
                                  np.asarray(jattn.merge_heads(jq)))


def test_kernel_operand_checks_raise():
    """What the CUDA wrapper checks before a launch (the kernel takes
    contiguous f32/bf16 operands of one shape with D <= 128)."""
    from netsdb_tpu_torch.ops.cuda_kernels import _check_cuda_operands

    q, k, v = ours(qkv(s=64))
    _check_cuda_operands(q, k, v)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _check_cuda_operands(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="dtype"):
        _check_cuda_operands(q, k.double(), v)
    with pytest.raises(ValueError, match="shape"):
        _check_cuda_operands(q, k[:, :, :32], v)
    with pytest.raises(ValueError, match="contiguous"):
        _check_cuda_operands(q.transpose(2, 3), k.transpose(2, 3),
                             v.transpose(2, 3))
    wide = torch.zeros(1, 1, 8, 160)
    with pytest.raises(ValueError, match="head dim"):
        _check_cuda_operands(wide, wide, wide)
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention(*(t.to("meta") for t in (q, k, v)), block_q=32,
                        block_k=32)
