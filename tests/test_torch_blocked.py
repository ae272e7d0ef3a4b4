"""The port's BlockedTensor against the JAX package's, on the CPU: the
same numpy inputs give the same padded data, with the margin exactly 0."""

import numpy as np
import pytest
import torch

from netsdb_tpu.core.blocked import BlockedTensor as JaxBlocked
from netsdb_tpu_torch.core.blocked import BlockMeta, BlockedTensor

RAGGED = [((13, 27), (8, 8)), ((5, 3), (4, 2)), ((16, 16), (8, 8)),
          ((7,), (3,)), ((3, 10, 6), (2, 4, 4))]


@pytest.mark.parametrize("shape,block", RAGGED)
def test_from_dense_matches_jax_and_margin_is_zero(shape, block):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    ours = BlockedTensor.from_dense(x, block)
    ref = JaxBlocked.from_dense(x, block)
    assert ours.meta.padded_shape == ref.meta.padded_shape
    assert ours.is_padded == ref.meta.is_padded
    np.testing.assert_array_equal(ours.data.numpy(), np.asarray(ref.data))
    # the round trip is exact and the margin is exactly zero
    np.testing.assert_array_equal(ours.to_dense().numpy(), x)
    margin = ours.data * (1 - ours.mask())
    assert torch.count_nonzero(margin) == 0
    np.testing.assert_array_equal(ours.mask().numpy(), np.asarray(ref.mask()))


@pytest.mark.parametrize("shape,block", RAGGED[:2])
def test_from_blocks_matches_jax(shape, block):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    meta = BlockMeta(shape, block)
    blocks = {}
    for i in range(meta.grid[0]):
        for j in range(meta.grid[1]):
            # ragged edge blocks arrive unpadded
            blocks[(i, j)] = x[i * block[0]:(i + 1) * block[0],
                               j * block[1]:(j + 1) * block[1]]
    ours = BlockedTensor.from_blocks(blocks, shape, block)
    ref = JaxBlocked.from_blocks(blocks, shape, block)
    np.testing.assert_array_equal(ours.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(ours.to_dense().numpy(), x)
    np.testing.assert_array_equal(ours.block(meta.grid[0] - 1, 0).numpy(),
                                  np.asarray(ref.block(meta.grid[0] - 1, 0)))


def test_with_data_keeps_meta_and_rejects_wrong_shape():
    t = BlockedTensor.from_dense(np.ones((5, 3), np.float32), (4, 2))
    u = t.with_data(t.data * 2)
    assert u.meta == t.meta and float(u.to_dense().sum()) == 30.0
    with pytest.raises(ValueError, match="padded"):
        BlockedTensor(torch.zeros(5, 3), t.meta)


def test_from_dense_owns_its_memory():
    x = np.ones((4, 4), np.float32)
    t = BlockedTensor.from_dense(x, (4, 4))
    x[:] = 7
    assert float(t.data.max()) == 1.0


def test_meta_validation_matches_jax():
    with pytest.raises(ValueError, match="rank mismatch"):
        BlockMeta((4, 4), (2,))
    with pytest.raises(ValueError, match="non-positive"):
        BlockMeta((4, 4), (0, 2))
    with pytest.raises(IndexError):
        BlockMeta((4, 4), (2, 2)).block_slice((2, 0))
