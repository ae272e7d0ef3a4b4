"""Gaussian mixture model by EM — counterpart of
``netsdb_tpu/workloads/gmm.py`` (reference ``src/sharedLibraries/headers/
GMM/``, ``TestGmm.cc``), diagonal covariances as there.

The initial means come from 5 rounds of the port's k-means (its own
random init: see ``workloads/kmeans.py``), the variances are the
points' population variance, the weights uniform. ``_log_prob`` forms the
(rows, k, d) differences a slice of rows at a time (``chunk_rows``), the
same arithmetic per row, so a large set never holds the whole cube.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from netsdb_tpu_torch.parallel.placement import refuse_placed
from netsdb_tpu_torch.core.blocked import BlockedTensor
from netsdb_tpu_torch.ops.common import full_f32_precision
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


def gmm_init(points: torch.Tensor, k: int, seed: int = 0) -> GMMState:
    """The initial state: k-means means (5 rounds), the population
    variance of every dimension, uniform weights."""
    from netsdb_tpu_torch.workloads.kmeans import kmeans

    init_means, _ = kmeans(points, k, iters=5, seed=seed)
    var = torch.var(points, dim=0, correction=0)
    return GMMState(
        means=init_means,
        variances=torch.ones((k, points.shape[1]), dtype=points.dtype,
                             device=points.device) * var[None],
        weights=torch.full((k,), 1.0 / k, dtype=points.dtype,
                           device=points.device))


def gmm_step(points: torch.Tensor, state: GMMState) -> GMMState:
    """One EM round: responsibilities (E), then weighted moments (M)."""
    n = points.shape[0]
    resp = torch.softmax(_log_prob(points, state), dim=1)
    nk = resp.sum(0).clamp_min(1e-8)
    full_f32_precision()
    means = (resp.T @ points) / nk[:, None]
    ex2 = (resp.T @ (points * points)) / nk[:, None]
    return GMMState(means=means,
                    variances=(ex2 - means * means).clamp_min(1e-6),
                    weights=nk / n)


def gmm_em(points: torch.Tensor, k: int, iters: int = 20, seed: int = 0,
           init: Optional[GMMState] = None
           ) -> Tuple[GMMState, torch.Tensor]:
    """→ (final state, responsibilities (n, k)); ``init`` replaces the
    k-means start."""
    state = init if init is not None else gmm_init(points, k, seed)
    state = GMMState(*(t.to(device=points.device, dtype=points.dtype)
                       for t in state))
    for _ in range(iters):
        state = gmm_step(points, state)
    return state, torch.softmax(_log_prob(points, state), dim=1)


def gmm_log_likelihood(points: torch.Tensor, state: GMMState) -> torch.Tensor:
    return torch.mean(torch.logsumexp(_log_prob(points, state), dim=1))


def gmm_on_set(client, db: str, set_name: str, k: int, iters: int = 20,
               out_set: str = "gmm_state", seed: int = 0
               ) -> Tuple[GMMState, torch.Tensor]:
    """Set driver: points from a tensor set; means, variances and weights
    written back side by side as one tensor set (k x 2d+1) of the same
    block shape."""
    refuse_placed(client, db, set_name, "gmm_on_set")
    pts = client.get_tensor(db, set_name)
    state, resp = gmm_em(pts.to_dense(), k, iters, seed=seed)
    if not client.set_exists(db, out_set):
        client.create_set(db, out_set)
    packed = torch.cat([state.means, state.variances,
                        state.weights[:, None]], dim=1)
    client.store.put_tensor(SetIdentifier(db, out_set),
                            BlockedTensor.from_dense(packed,
                                                     pts.meta.block_shape))
    return state, resp
