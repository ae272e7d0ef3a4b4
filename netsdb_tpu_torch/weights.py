"""Carry weights into the port as numpy arrays.

The port never sees an object of the JAX package: a caller holding that
package's parameters converts them to numpy (``np.asarray``) together
with their block metadata, and these functions build the port's
parameter objects or fill a port client's sets from them. Like the
client, they put the parameters on CUDA unless given ``device=``, and
raise where there is no card. :func:`params_to_numpy` goes the other
way (a trained model's params back to numpy, padded data and metadata),
and :func:`logical` cuts a padded matrix to its logical view.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from netsdb_tpu_torch.config import resolve_device
from netsdb_tpu_torch.core.blocked import BlockMeta, BlockedTensor, owned_tensor
from netsdb_tpu_torch.models.ff import FFParams
from netsdb_tpu_torch.models.logreg import LogRegParams
from netsdb_tpu_torch.models.moe import MoEParams
from netsdb_tpu_torch.models.transformer import TransformerLayerParams
from netsdb_tpu_torch.ops.lstm import LSTMParams

# (padded array, logical shape, block shape)
PaddedMatrix = Tuple[np.ndarray, Sequence[int], Sequence[int]]


def blocked_from_numpy(padded: np.ndarray, shape: Sequence[int],
                       block_shape: Sequence[int],
                       device=None) -> BlockedTensor:
    """A ``BlockedTensor`` from its padded data and metadata, on
    ``device`` (CUDA unless the caller asks for another). Raises
    ``ValueError`` if the padded margin is not exactly zero, the
    invariant every op of the port relies on."""
    bt = BlockedTensor(owned_tensor(padded, device=resolve_device(device)),
                       BlockMeta(tuple(shape), tuple(block_shape)))
    if bt.is_padded and bool((bt.data * (1 - bt.mask(bt.dtype))).ne(0).any()):
        raise ValueError(f"padded margin of {bt!r} is not zero")
    return bt


def ff_params_from_numpy(arrays: Mapping[str, PaddedMatrix],
                         device=None) -> FFParams:
    """``FFParams`` from ``{w1, b1, wo, bo}``, each given as
    ``(padded array, logical shape, block shape)``."""
    return FFParams(**{name: blocked_from_numpy(*arrays[name], device=device)
                       for name in ("w1", "b1", "wo", "bo")})


def logreg_params_from_numpy(arrays: Mapping[str, PaddedMatrix],
                             device=None) -> LogRegParams:
    """``LogRegParams`` from ``{w, b}``, each given as ``(padded array,
    logical shape, block shape)``."""
    return LogRegParams(**{name: blocked_from_numpy(*arrays[name],
                                                    device=device)
                           for name in ("w", "b")})


def lstm_params_from_numpy(arrays: Mapping[str, PaddedMatrix],
                           device=None) -> LSTMParams:
    """``LSTMParams`` from the 12 gate sets ``{w_i, ..., u_i, ..., b_i,
    ...}``, each given as ``(padded array, logical shape, block shape)``."""
    names = [f.name for f in dataclasses.fields(LSTMParams)]
    return LSTMParams(**{name: blocked_from_numpy(*arrays[name],
                                                  device=device)
                         for name in names})


def conv_arrays_to_device(images: np.ndarray, kernels: np.ndarray,
                          bias: Optional[np.ndarray] = None, device=None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     Optional[torch.Tensor]]:
    """Images (N, C, H, W), kernels (O, I, KH, KW) and bias (O,) as f32
    tensors on ``device`` (CUDA unless the caller asks for another), for
    the ``ops.conv`` functions; ``bias`` stays None when not given."""
    device = resolve_device(device)

    def put(a):
        return owned_tensor(a, dtype=torch.float32, device=device)

    return put(images), put(kernels), None if bias is None else put(bias)


def transformer_params_from_numpy(arrays: Mapping[str, np.ndarray],
                                  device=None) -> TransformerLayerParams:
    """``TransformerLayerParams`` from dense ``{w_qkv, w_out, w_up,
    w_down}`` arrays, on ``device`` (CUDA unless the caller asks for
    another)."""
    device = resolve_device(device)
    return TransformerLayerParams(**{
        name: owned_tensor(arrays[name], dtype=torch.float32, device=device)
        for name in ("w_qkv", "w_out", "w_up", "w_down")})


def moe_params_from_numpy(arrays: Mapping[str, np.ndarray],
                          device=None) -> MoEParams:
    """``MoEParams`` from dense ``{w_gate, w_up, w_down}`` arrays, on
    ``device`` (CUDA unless the caller asks for another)."""
    device = resolve_device(device)
    return MoEParams(**{
        name: owned_tensor(arrays[name], dtype=torch.float32, device=device)
        for name in ("w_gate", "w_up", "w_down")})


def blocked_to_numpy(bt: BlockedTensor) -> PaddedMatrix:
    """``(padded array, logical shape, block shape)`` of a
    ``BlockedTensor``, the inverse of :func:`blocked_from_numpy`."""
    return (bt.data.detach().cpu().numpy(), tuple(bt.shape),
            tuple(bt.meta.block_shape))


def logical(matrix: PaddedMatrix) -> np.ndarray:
    """The logical (unpadded) view of ``(padded array, shape, block)``."""
    padded, shape, _ = matrix
    return padded[tuple(slice(0, n) for n in shape)]


def params_to_numpy(params) -> Dict[str, Union[PaddedMatrix, np.ndarray]]:
    """A params dataclass (``FFParams``, ``LogRegParams``,
    ``TransformerLayerParams``, ...) back to numpy: a ``BlockedTensor``
    field as its padded matrix, a tensor field as its array."""
    return {f.name: (blocked_to_numpy(v) if isinstance(v, BlockedTensor)
                     else v.detach().cpu().numpy())
            for f in dataclasses.fields(params)
            for v in [getattr(params, f.name)]}


def load_matrices(client, db: str,
                  matrices: Mapping[str, Tuple[np.ndarray, Sequence[int]]]
                  ) -> None:
    """Send each ``{set name: (dense array, block shape)}`` into the
    port client's set of that name in ``db``, creating the database and
    the sets as needed."""
    client.create_database(db)
    for name, (dense, block_shape) in matrices.items():
        client.create_set(db, name)
        client.send_matrix(db, name, dense, tuple(block_shape))
