"""KMeans — counterpart of ``netsdb_tpu/workloads/kmeans.py`` (reference
``KMeansAggregate.h``, ``TestKMeans.cc``).

Lloyd's loop on the points' device: each round assigns every point to the
argmin of ``‖c‖² − 2 p·c`` (one f32 product, TF32 off; ties to the lower
centroid) and sums the points of each centroid with ``index_add_`` (f32
atomics: the sums' order, so their last bits, differ from the
reference's ``segment_sum``). An empty cluster keeps its centroid.

The random init picks k distinct rows with a ``torch.Generator`` seeded
by ``seed`` on the points' device, not the reference's
``jax.random.choice``, which torch cannot reproduce: pass
``init_centroids=`` or ``init="sample"`` (the numpy Bernoulli sampler,
the reference's draws) for the reference's exact start.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from netsdb_tpu_torch.parallel.placement import refuse_placed
from netsdb_tpu_torch.core.blocked import BlockedTensor
from netsdb_tpu_torch.ops.common import full_f32_precision
from netsdb_tpu_torch.storage.store import SetIdentifier


def _assign(points: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    full_f32_precision()
    dots = points @ centroids.T
    c2 = torch.sum(centroids * centroids, dim=1)
    return torch.argmin(c2[None, :] - 2.0 * dots, dim=1)


def random_init(points: torch.Tensor, k: int, seed: int = 0) -> torch.Tensor:
    """k distinct rows of ``points``, drawn by a generator on their device
    seeded with ``seed``."""
    g = torch.Generator(device=points.device).manual_seed(seed)
    idx = torch.randperm(points.shape[0], generator=g,
                         device=points.device)[:k]
    return points.index_select(0, idx)


def sample_init(points: torch.Tensor, k: int, seed: int = 0) -> torch.Tensor:
    """The reference's MLLib-compliant init (Bernoulli sample, shuffle,
    distinct; ``TestKMeansMLLibCompliant.cc:462-530``) on a host copy of
    the points: the same rows as the reference for the same seed, in
    sorted order; fewer than k when the sample repeats points."""
    from netsdb_tpu_torch.utils.sampler import sample_k_distinct

    host = points.detach().cpu().numpy()
    return torch.from_numpy(sample_k_distinct(host, k, seed=seed)).to(
        points.device)


def lloyd_step(points: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """One round: assign, then each centroid the mean of its points."""
    k = cents.shape[0]
    assign = _assign(points, cents)
    sums = torch.zeros_like(cents).index_add_(0, assign, points)
    counts = torch.bincount(assign, minlength=k).to(points.dtype)
    return torch.where(counts[:, None] > 0,
                       sums / counts.clamp_min(1)[:, None], cents)


def kmeans(points: torch.Tensor, k: int, iters: int = 10,
           init_centroids: Optional[torch.Tensor] = None,
           seed: int = 0, init: str = "random"
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (centroids (k, d), assignments (n,)). ``init="sample"`` may shrink
    k, as in the reference, when the sample has duplicate points."""
    if init not in ("random", "sample"):
        raise ValueError(f"init must be 'random' or 'sample', got {init!r}")
    if init_centroids is None:
        init_centroids = (sample_init(points, k, seed) if init == "sample"
                          else random_init(points, k, seed))
    cents = init_centroids.to(device=points.device, dtype=points.dtype)
    for _ in range(iters):
        cents = lloyd_step(points, cents)
    return cents, _assign(points, cents)


def kmeans_on_set(client, db: str, set_name: str, k: int, iters: int = 10,
                  out_set: str = "kmeans_centroids", seed: int = 0):
    """Set driver (``TestKMeans``'s shape): points from a tensor set (n x
    d), the centroids written back as a tensor set of the same block
    shape."""
    refuse_placed(client, db, set_name, "kmeans_on_set")
    pts = client.get_tensor(db, set_name)
    cents, assign = kmeans(pts.to_dense(), k, iters, seed=seed)
    if not client.set_exists(db, out_set):
        client.create_set(db, out_set)
    client.store.put_tensor(SetIdentifier(db, out_set),
                            BlockedTensor.from_dense(cents,
                                                     pts.meta.block_shape))
    return cents, assign
