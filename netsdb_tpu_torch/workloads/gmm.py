"""Gaussian mixture model by EM — counterpart of
``netsdb_tpu/workloads/gmm.py`` (reference ``src/sharedLibraries/headers/
GMM/``, ``TestGmm.cc``), diagonal covariances as there.

The initial means come from 5 rounds of the port's k-means (its own
random init: see ``workloads/kmeans.py``), the variances are the
points' population variance, the weights uniform. ``_log_prob`` forms the
(rows, k, d) differences a slice of rows at a time (``chunk_rows``), the
same arithmetic per row, so a large set never holds the whole cube.

EM runs over row blocks of the points (:func:`gmm_em_blocks`): one block
on one device, or a row-sharded placed set's blocks, one a position.
Each block runs the E-step on its own rows and forms partial moments;
the partials are summed in position order before the M-step.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from netsdb_tpu_torch.core.blocked import BlockedTensor
from netsdb_tpu_torch.ops.common import full_f32_precision
from netsdb_tpu_torch.parallel import placed_ops
from netsdb_tpu_torch.parallel.mesh import move, position_sum
from netsdb_tpu_torch.storage.store import SetIdentifier

#: rows of points whose (rows, k, d) differences are formed at once
CHUNK_ELEMS = 1 << 26


class GMMState(NamedTuple):
    means: torch.Tensor      # (k, d)
    variances: torch.Tensor  # (k, d)
    weights: torch.Tensor    # (k,)


def _log_prob(points: torch.Tensor, state: GMMState) -> torch.Tensor:
    """(n, k) log N(x; mu_k, diag var_k) + log w_k."""
    n, d = points.shape
    k = state.means.shape[0]
    var = state.variances.clamp_min(1e-6)
    norm = 0.5 * torch.sum(torch.log(2 * math.pi * var), dim=-1)[None]
    logw = torch.log(state.weights.clamp_min(1e-12))[None]
    out = torch.empty((n, k), dtype=points.dtype, device=points.device)
    step = max(1, CHUNK_ELEMS // max(k * d, 1))
    for r in range(0, n, step):
        diff = points[r:r + step, None, :] - state.means[None, :, :]
        ll = -0.5 * torch.sum(diff * diff / var[None], dim=-1)
        out[r:r + step] = ll - norm + logw
    return out


def _blocks(points) -> List[torch.Tensor]:
    return [points] if isinstance(points, torch.Tensor) else list(points)


def _at(state: GMMState, device) -> GMMState:
    return GMMState(*(move(t, device) for t in state))


def gmm_init(points, k: int, seed: int = 0) -> GMMState:
    """The initial state: k-means means (5 rounds), the population
    variance of every dimension, uniform weights. ``points`` is a tensor
    or its row blocks (the variance then in two passes: the mean, then
    the squared deviations, each summed in block order)."""
    from netsdb_tpu_torch.workloads.kmeans import kmeans_blocks

    blocks = _blocks(points)
    dev, dtype, d = blocks[0].device, blocks[0].dtype, blocks[0].shape[1]
    init_means, _ = kmeans_blocks(blocks, k, iters=5, seed=seed)
    if len(blocks) == 1:
        var = torch.var(blocks[0], dim=0, correction=0)
    else:
        n = sum(b.shape[0] for b in blocks)
        mean = position_sum([b.sum(0) for b in blocks], dev) / n
        var = position_sum([((b - move(mean, b.device)) ** 2).sum(0)
                            for b in blocks], dev) / n
    return GMMState(
        means=init_means,
        variances=torch.ones((k, d), dtype=dtype, device=dev) * var[None],
        weights=torch.full((k,), 1.0 / k, dtype=dtype, device=dev))


def gmm_step(points, state: GMMState) -> GMMState:
    """One EM round: responsibilities (E), then weighted moments (M).
    ``points`` is a tensor or its row blocks: each block's E-step and
    partial moments on its device, summed in block order."""
    blocks = _blocks(points)
    dev = state.means.device
    n = sum(b.shape[0] for b in blocks)
    nks, firsts, seconds = [], [], []
    full_f32_precision()
    for b in blocks:
        resp = torch.softmax(_log_prob(b, _at(state, b.device)), dim=1)
        nks.append(resp.sum(0))
        firsts.append(resp.T @ b)
        seconds.append(resp.T @ (b * b))
    nk = position_sum(nks, dev).clamp_min(1e-8)
    means = position_sum(firsts, dev) / nk[:, None]
    ex2 = position_sum(seconds, dev) / nk[:, None]
    return GMMState(means=means,
                    variances=(ex2 - means * means).clamp_min(1e-6),
                    weights=nk / n)


def gmm_em(points, k: int, iters: int = 20, seed: int = 0,
           init: Optional[GMMState] = None
           ) -> Tuple[GMMState, torch.Tensor]:
    """→ (final state, responsibilities (n, k)); ``init`` replaces the
    k-means start. ``points`` is a tensor or its row blocks (the state
    and the responsibilities, in block order, on the first block's
    device)."""
    blocks = _blocks(points)
    dev, dtype = blocks[0].device, blocks[0].dtype
    state = init if init is not None else gmm_init(blocks, k, seed)
    state = GMMState(*(t.to(device=dev, dtype=dtype) for t in state))
    for _ in range(iters):
        state = gmm_step(blocks, state)
    resp = [move(torch.softmax(_log_prob(b, _at(state, b.device)), dim=1),
                 dev) for b in blocks]
    return state, resp[0] if len(resp) == 1 else torch.cat(resp)


def gmm_log_likelihood(points: torch.Tensor, state: GMMState) -> torch.Tensor:
    return torch.mean(torch.logsumexp(_log_prob(points, state), dim=1))


def gmm_on_set(client, db: str, set_name: str, k: int, iters: int = 20,
               out_set: str = "gmm_state", seed: int = 0
               ) -> Tuple[GMMState, torch.Tensor]:
    """Set driver: points from a tensor set; means, variances and weights
    written back side by side as one tensor set (k x 2d+1) of the same
    block shape. A row-sharded placed set runs EM over its positions'
    rows."""
    pts = client.get_tensor(db, set_name)
    state, resp = gmm_em(placed_ops.row_blocks(pts, "gmm_on_set"), k, iters,
                         seed=seed)
    if not client.set_exists(db, out_set):
        client.create_set(db, out_set)
    packed = torch.cat([state.means, state.variances,
                        state.weights[:, None]], dim=1)
    client.store.put_tensor(SetIdentifier(db, out_set),
                            BlockedTensor.from_dense(packed,
                                                     pts.meta.block_shape))
    return state, resp
