"""The LA op set of the port (``ops/linalg.py``, ``t_matmul`` and
``gram``, and the ``BlockedTensor`` helpers the DSL uses) against the
JAX package's, on the CPU: every op on the same numpy inputs, blocked
aligned and ragged, and the whole padded result compared — the margin
must read 0 — within 1e-5 abs (1e-4 for the inverse)."""

import dataclasses
from typing import Any, Callable

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from netsdb_tpu.core.blocked import BlockedTensor as JaxBlocked
from netsdb_tpu.ops import linalg as jax_la
from netsdb_tpu.ops.matmul import gram as jax_gram
from netsdb_tpu_torch.core.blocked import BlockedTensor
from netsdb_tpu_torch.ops import linalg as la
from netsdb_tpu_torch.ops import matmul as mm
from netsdb_tpu_torch.ops.matmul import gram

# (rows, cols, block): a whole number of blocks, and a ragged grid
SHAPES = {"aligned": (8, 12, (4, 4)), "ragged": (7, 10, (4, 3))}


@dataclasses.dataclass
class Side:
    la: Any
    gram: Callable
    make: Callable
    kw: dict


JAX = Side(jax_la, jax_gram, lambda d, b: JaxBlocked.from_dense(d, b), {})
PORT = Side(la, gram,
            lambda d, b: BlockedTensor.from_dense(d, b, device="cpu"),
            {"device": "cpu"})


def inputs(side, shape, seed=0):
    rows, cols, block = SHAPES[shape]
    rng = np.random.default_rng(seed)
    a, b = (rng.standard_normal((rows, cols)).astype(np.float32)
            for _ in range(2))
    c = rng.standard_normal((rows, 5)).astype(np.float32)
    sq = (rng.standard_normal((rows, rows)) + 4 * np.eye(rows)).astype(
        np.float32)
    return (side.make(a, block), side.make(b, block),
            side.make(c, (block[0], 2)), side.make(sq, (block[0], block[0])))


def ctor(fn):
    """A constructor of the op set, called with the side's device."""
    return lambda s, a, b, c, sq: fn(s, a, b, c, sq, **s.kw)


OPS = {
    "add": lambda s, a, b, c, sq: s.la.add(a, b),
    "subtract": lambda s, a, b, c, sq: s.la.subtract(a, b),
    "scale_multiply": lambda s, a, b, c, sq: s.la.scale_multiply(a, b),
    "scalar_multiply": lambda s, a, b, c, sq: s.la.scalar_multiply(a, 2.5),
    "transpose": lambda s, a, b, c, sq: s.la.transpose(a),
    "max_element": lambda s, a, b, c, sq: s.la.max_element(a),
    "min_element": lambda s, a, b, c, sq: s.la.min_element(a),
    "row_max": lambda s, a, b, c, sq: s.la.row_max(a),
    "row_min": lambda s, a, b, c, sq: s.la.row_min(a),
    "row_sum": lambda s, a, b, c, sq: s.la.row_sum(a),
    "col_max": lambda s, a, b, c, sq: s.la.col_max(a),
    "col_min": lambda s, a, b, c, sq: s.la.col_min(a),
    "col_sum": lambda s, a, b, c, sq: s.la.col_sum(a),
    "duplicate_row": lambda s, a, b, c, sq: s.la.duplicate_row(
        s.la.col_max(a), 6, 4),
    "duplicate_col": lambda s, a, b, c, sq: s.la.duplicate_col(
        s.la.row_min(a), 5, 2),
    "identity": ctor(lambda s, a, b, c, sq, **kw: s.la.identity(
        a.shape[0], a.meta.block_shape[0], **kw)),
    "zeros": ctor(lambda s, a, b, c, sq, **kw: s.la.zeros(
        *a.shape, *a.meta.block_shape, **kw)),
    "ones": ctor(lambda s, a, b, c, sq, **kw: s.la.ones(
        *a.shape, *a.meta.block_shape, **kw)),
    "inverse": lambda s, a, b, c, sq: s.la.inverse(sq),
    "matmul": lambda s, a, b, c, sq: s.la.matmul(s.la.transpose(c), a),
    "matmul_t": lambda s, a, b, c, sq: s.la.matmul_t(a, b),
    "t_matmul": lambda s, a, b, c, sq: s.la.t_matmul(a, c),
    "gram": lambda s, a, b, c, sq: s.gram(a),
    "reblock": lambda s, a, b, c, sq: a.reblock((5, 2)),
    "astype_bf16": lambda s, a, b, c, sq: a.astype(
        jnp.bfloat16 if s is JAX else torch.bfloat16),
    "zeros_blocked": lambda s, a, b, c, sq: type(a).zeros(
        a.shape, a.meta.block_shape),
}


def as_f32(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x).astype(np.float32))


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("op", sorted(OPS))
def test_op_matches_jax(op, shape):
    ours = OPS[op](PORT, *inputs(PORT, shape))
    ref = OPS[op](JAX, *inputs(JAX, shape))
    tol = dict(rtol=0, atol=1e-4 if op == "inverse" else 1e-5)
    if not isinstance(ours, BlockedTensor):  # the global max and min
        assert ours.dim() == 0
        np.testing.assert_allclose(as_f32(ours), as_f32(ref), **tol)
        return
    assert ours.shape == tuple(ref.shape)
    assert ours.meta.block_shape == tuple(ref.meta.block_shape)
    assert ours.device.type == "cpu"
    np.testing.assert_allclose(as_f32(ours.data), as_f32(ref.data), **tol)
    margin = ours.data.float() * (1 - ours.mask())
    assert torch.count_nonzero(margin) == 0


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_blocks_match_jax(shape):
    ours, ref = inputs(PORT, shape)[0], inputs(JAX, shape)[0]
    assert ours.meta.num_blocks == ref.meta.num_blocks
    pairs = list(zip(ours.blocks(), ref.blocks()))
    assert len(pairs) == ours.meta.num_blocks
    for (i, blk), (j, rblk) in pairs:
        assert i == j
        np.testing.assert_array_equal(blk.numpy(), np.asarray(rblk))


def test_misaligned_operands_raise_as_in_jax():
    a, b, c, _ = inputs(PORT, "ragged")
    with pytest.raises(ValueError, match="reblock first"):
        la.add(a, b.reblock((2, 2)))
    with pytest.raises(ValueError, match="shape mismatch"):
        la.subtract(a, c)
    with pytest.raises(ValueError, match="contraction mismatch"):
        mm.t_matmul(a, la.transpose(c))
    with pytest.raises(ValueError, match="non-square"):
        la.inverse(a)
