"""Blocked tensors — netsDB's matrix-block sets as one padded tensor.

Counterpart of ``netsdb_tpu/core/blocked.py``. netsDB stores a matrix
as a set of ``FFMatrixBlock`` objects; here it is ONE ``torch.Tensor``
padded up to a whole number of blocks, with the block grid kept as
metadata. The padded margin is always exactly zero: ops that do not map
0 to 0 re-mask their output (``netsdb_tpu_torch.ops.common``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

Shape = Tuple[int, ...]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


def as_torch_dtype(dtype) -> Optional[torch.dtype]:
    """A torch dtype from a torch dtype, a numpy dtype or a name such as
    ``"bfloat16"`` (the spelling the reference's ``compute_dtype`` uses)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return _DTYPES[name]


def owned_tensor(x, dtype=None, device=None) -> torch.Tensor:
    """A tensor that owns its memory: a stored set must not change when
    the caller later writes to the array it sent. With no ``dtype``,
    float64 data is stored as float32, as the JAX package's
    ``jnp.asarray`` stores it (64-bit types off)."""
    dtype = as_torch_dtype(dtype)
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    if dtype is None and x.dtype in (np.float64, torch.float64):
        dtype = torch.float32
    if isinstance(x, np.ndarray):
        return torch.tensor(x, dtype=dtype, device=device)  # copies
    return x.to(device=device, dtype=dtype, copy=True)


@dataclasses.dataclass(frozen=True)
class BlockMeta:
    """Logical (unpadded) shape + block shape."""

    shape: Shape
    block_shape: Shape

    def __post_init__(self):
        if len(self.shape) != len(self.block_shape):
            raise ValueError(
                f"rank mismatch: shape {self.shape} vs block {self.block_shape}")
        if any(b <= 0 for b in self.block_shape):
            raise ValueError(f"non-positive block shape {self.block_shape}")

    @property
    def rank(self) -> int:
        return len(self.shape)

    @property
    def grid(self) -> Shape:
        """Blocks along each dim (ceil-div; the ragged last block is padded)."""
        return tuple(-(-s // b) for s, b in zip(self.shape, self.block_shape))

    @property
    def padded_shape(self) -> Shape:
        return tuple(g * b for g, b in zip(self.grid, self.block_shape))

    @property
    def is_padded(self) -> bool:
        return self.padded_shape != self.shape

    @property
    def num_blocks(self) -> int:
        return int(np.prod(self.grid))

    def block_slice(self, index: Sequence[int]) -> Tuple[slice, ...]:
        """Slice of the padded tensor covered by block ``index``."""
        if len(index) != self.rank:
            raise ValueError(f"block index {index} has wrong rank for {self}")
        for i, (ix, g) in enumerate(zip(index, self.grid)):
            if not 0 <= ix < g:
                raise IndexError(f"block index {ix} out of range [0,{g}) on dim {i}")
        return tuple(slice(ix * b, (ix + 1) * b)
                     for ix, b in zip(index, self.block_shape))


class BlockedTensor:
    """A logical tensor stored padded-to-block. ``data`` always has
    ``meta.padded_shape``; entries beyond ``meta.shape`` are zero."""

    def __init__(self, data: torch.Tensor, meta: BlockMeta):
        if tuple(data.shape) != meta.padded_shape:
            raise ValueError(
                f"data shape {tuple(data.shape)} != padded {meta.padded_shape}")
        self.data = data
        self.meta = meta

    # --- construction -------------------------------------------------
    @staticmethod
    def from_dense(dense: Union[np.ndarray, torch.Tensor],
                   block_shape: Shape, dtype=None,
                   device=None) -> "BlockedTensor":
        """Pad a dense array up to whole blocks (zeros in the margin)."""
        t = owned_tensor(dense, dtype, device)
        meta = BlockMeta(tuple(t.shape), tuple(block_shape))
        if meta.is_padded:
            # F.pad takes (last-dim before, after, ..., first-dim ...)
            pad = []
            for s, p in reversed(list(zip(meta.shape, meta.padded_shape))):
                pad += [0, p - s]
            t = F.pad(t, pad)
        return BlockedTensor(t, meta)

    @staticmethod
    def zeros(shape: Shape, block_shape: Shape, dtype=torch.float32,
              device=None) -> "BlockedTensor":
        meta = BlockMeta(tuple(shape), tuple(block_shape))
        return BlockedTensor(torch.zeros(meta.padded_shape,
                                         dtype=as_torch_dtype(dtype),
                                         device=device), meta)

    @staticmethod
    def from_blocks(blocks: dict, shape: Shape, block_shape: Shape,
                    dtype=torch.float32, device=None) -> "BlockedTensor":
        """Assemble from a {block_index: array} dict; ragged edge blocks
        may come unpadded and are zero-padded into place."""
        meta = BlockMeta(tuple(shape), tuple(block_shape))
        out = torch.zeros(meta.padded_shape, dtype=as_torch_dtype(dtype),
                          device=device)
        for index, arr in blocks.items():
            sl = meta.block_slice(tuple(index))
            arr = torch.as_tensor(arr, dtype=out.dtype, device=out.device)
            dst = tuple(slice(s.start, s.start + d)
                        for s, d in zip(sl, arr.shape))
            out[dst] = arr
        return BlockedTensor(out, meta)

    # --- access -------------------------------------------------------
    @property
    def shape(self) -> Shape:
        return self.meta.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def grid(self) -> Shape:
        return self.meta.grid

    @property
    def is_padded(self) -> bool:
        return self.meta.is_padded

    def block(self, *index: int) -> torch.Tensor:
        return self.data[self.meta.block_slice(index)]

    def blocks(self):
        """``(index, block)`` pairs in row-major block order."""
        for index in np.ndindex(*self.meta.grid):
            yield index, self.block(*index)

    def to_dense(self) -> torch.Tensor:
        """Strip padding back to the logical shape (a view)."""
        if not self.meta.is_padded:
            return self.data
        return self.data[tuple(slice(0, s) for s in self.meta.shape)]

    def mask(self, dtype=torch.float32) -> torch.Tensor:
        """1 inside the logical extent, 0 in the padded margin."""
        m = torch.ones((), dtype=dtype, device=self.data.device)
        for dim, (s, p) in enumerate(zip(self.meta.shape,
                                         self.meta.padded_shape)):
            dim_mask = (torch.arange(p, device=self.data.device) < s).to(dtype)
            bshape = [1] * self.meta.rank
            bshape[dim] = p
            m = m * dim_mask.reshape(bshape)
        return m.expand(self.meta.padded_shape)

    def with_data(self, data: torch.Tensor) -> "BlockedTensor":
        return BlockedTensor(data, self.meta)

    def astype(self, dtype) -> "BlockedTensor":
        return self.with_data(self.data.to(as_torch_dtype(dtype)))

    def reblock(self, block_shape: Shape) -> "BlockedTensor":
        """The same logical tensor under another block shape (re-padded
        with zeros), on the same device and in the same dtype."""
        return BlockedTensor.from_dense(self.to_dense(), block_shape,
                                        dtype=self.dtype, device=self.device)

    def __repr__(self) -> str:
        return (f"BlockedTensor(shape={self.meta.shape}, "
                f"block={self.meta.block_shape}, grid={self.meta.grid}, "
                f"dtype={self.dtype}, device={self.device})")
