"""The port's FF ops against the JAX package's, on the CPU, f32 within
1e-5: the same numpy inputs through both, padded data compared whole
(so the margins must agree too, at exactly zero)."""

import numpy as np
import pytest
import torch

from netsdb_tpu.core.blocked import BlockedTensor as JaxBlocked
from netsdb_tpu.ops import linalg as jlinalg
from netsdb_tpu.ops.matmul import matmul as jmatmul, matmul_t as jmatmul_t
from netsdb_tpu.ops import nn as jnn
from netsdb_tpu_torch.core.blocked import BlockedTensor
from netsdb_tpu_torch.ops import linalg, nn
from netsdb_tpu_torch.ops.matmul import matmul, matmul_t
from netsdb_tpu_torch.ops.common import mxu_dot, neutral_fill, remask

TOL = dict(rtol=1e-5, atol=1e-5)


def both(x, block):
    return BlockedTensor.from_dense(x, block), JaxBlocked.from_dense(x, block)


def close(ours, ref, **tol):
    assert ours.meta.shape == tuple(ref.meta.shape)
    np.testing.assert_allclose(ours.data.numpy(), np.asarray(ref.data),
                               **(tol or TOL))


def rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("m,k,n,block", [(16, 16, 8, (8, 8)),
                                         (13, 27, 5, (8, 8)),
                                         (9, 7, 11, (4, 4))])
def test_matmul_and_matmul_t(m, k, n, block):
    a, ja = both(rand(m, k), block)
    b, jb = both(rand(k, n, seed=1), block)
    close(matmul(a, b), jmatmul(ja, jb))
    bt, jbt = both(rand(n, k, seed=2), block)
    close(matmul_t(a, bt), jmatmul_t(ja, jbt))


def test_matmul_mixed_block_grains_and_mismatch():
    # contraction padded differently on each side
    a, ja = both(rand(6, 10), (4, 8))
    b, jb = both(rand(10, 3, seed=1), (4, 4))
    close(matmul(a, b), jmatmul(ja, jb))
    with pytest.raises(ValueError, match="contraction mismatch"):
        matmul(a, a)


def test_matmul_bf16_opt_in_keeps_accum_dtype():
    a, _ = both(rand(8, 8), (8, 8))
    out = matmul(a, a, compute_dtype="bfloat16",
                        accum_dtype="bfloat16")
    assert out.dtype == torch.bfloat16
    ref = matmul(a, a)
    np.testing.assert_allclose(out.data.float().numpy(), ref.data.numpy(),
                               atol=0.1, rtol=0.05)


def test_mxu_dot_full_precision_matches_f64():
    a, b = rand(32, 64), rand(64, 16, seed=1)
    out = mxu_dot(torch.from_numpy(a), torch.from_numpy(b))
    assert out.dtype == torch.float32
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32
    np.testing.assert_allclose(out.numpy(), a.astype(np.float64) @ b,
                               **TOL)


@pytest.mark.parametrize("shape,block", [((16, 8), (8, 8)),
                                         ((13, 11), (8, 8))])
def test_bias_relu_sigmoid(shape, block):
    x, jx = both(rand(*shape), block)
    bias, jbias = both(rand(shape[0], 1, seed=3), (block[0], 1))
    close(nn.bias_relu(x, bias), jnn.bias_relu(jx, jbias))
    close(nn.bias_sigmoid(x, bias), jnn.bias_sigmoid(jx, jbias))


def test_bias_relu_dropout_uses_the_generator():
    x, _ = both(np.abs(rand(13, 11)) + 1.0, (8, 8))
    bias, _ = both(np.zeros((13, 1), np.float32), (8, 1))
    runs = [nn.bias_relu(x, bias, 0.5, torch.Generator().manual_seed(7))
            for _ in range(2)]
    assert torch.equal(runs[0].data, runs[1].data)  # same seed, same mask
    y = runs[0]
    kept = y.to_dense() != 0
    assert 0 < int(kept.sum()) < kept.numel()
    # kept values are scaled by 1 / (1 - rate); the margin stays zero
    torch.testing.assert_close(y.to_dense()[kept], 2 * x.to_dense()[kept])
    assert torch.count_nonzero(y.data * (1 - y.mask())) == 0
    with pytest.raises(ValueError, match="Generator"):
        nn.bias_relu(x, bias, 0.5)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("shape,block", [((8, 16), (8, 8)),
                                         ((5, 13), (8, 8))])
def test_softmax_and_ff_output_layer(axis, shape, block):
    x, jx = both(rand(*shape), block)
    close(nn.softmax(x, axis), jnn.softmax(jx, axis))
    bias, jbias = both(rand(shape[0], 1, seed=4), (block[0], 1))
    out = nn.ff_output_layer(x, bias, axis)
    close(out, jnn.ff_output_layer(jx, jbias, axis))
    # all-padding rows/cols give NaN in the softmax; they must read 0
    assert torch.isfinite(out.data).all()
    assert torch.count_nonzero(out.data * (1 - out.mask())) == 0


def test_row_col_sum_and_mask_helpers():
    x, jx = both(rand(13, 11), (8, 8))
    close(linalg.row_sum(x), jlinalg.row_sum(jx))
    close(linalg.col_sum(x), jlinalg.col_sum(jx))
    filled = neutral_fill(x, -1.0)
    assert float(filled[13:].max()) == -1.0 and float(filled[:, 11:].max()) == -1.0
    dirty = x.with_data(x.data + 1.0)
    assert torch.count_nonzero(remask(dirty).data * (1 - x.mask())) == 0
