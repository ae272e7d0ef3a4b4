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

The loop runs over row blocks of the points (:func:`kmeans_blocks`): one
block on one device, or a row-sharded placed set's blocks, one a
position (the reference's jitted loop over a sharded array, where XLA
inserts the psums). Each round every block assigns its own rows and
forms partial sums and counts; the partials are summed in position
order. The counts are small integers and exact in any order; the sums
differ from one block's in the last bits, so a point halfway between
two centroids may change cluster.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from netsdb_tpu_torch.core.blocked import BlockedTensor
from netsdb_tpu_torch.ops.common import full_f32_precision
from netsdb_tpu_torch.parallel import placed_ops
from netsdb_tpu_torch.parallel.mesh import move, position_sum
from netsdb_tpu_torch.storage.store import SetIdentifier


def _assign(points: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    full_f32_precision()
    dots = points @ centroids.T
    c2 = torch.sum(centroids * centroids, dim=1)
    return torch.argmin(c2[None, :] - 2.0 * dots, dim=1)


def random_init(points, k: int, seed: int = 0) -> torch.Tensor:
    """k distinct rows of ``points`` (a tensor, or its row blocks in
    order), drawn by a generator on the first block's device seeded with
    ``seed``: the same rows however the points are split."""
    blocks = [points] if isinstance(points, torch.Tensor) else list(points)
    dev = blocks[0].device
    g = torch.Generator(device=dev).manual_seed(seed)
    n = sum(b.shape[0] for b in blocks)
    idx = torch.randperm(n, generator=g, device=dev)[:k]
    if len(blocks) == 1:
        return blocks[0].index_select(0, idx)
    return placed_ops.take_rows_of_blocks(blocks, idx)


def sample_init(points: torch.Tensor, k: int, seed: int = 0) -> torch.Tensor:
    """The reference's MLLib-compliant init (Bernoulli sample, shuffle,
    distinct; ``TestKMeansMLLibCompliant.cc:462-530``) on a host copy of
    the points: the same rows as the reference for the same seed, in
    sorted order; fewer than k when the sample repeats points."""
    from netsdb_tpu_torch.utils.sampler import sample_k_distinct

    host = points.detach().cpu().numpy()
    return torch.from_numpy(sample_k_distinct(host, k, seed=seed)).to(
        points.device)


def lloyd_step(points, cents: torch.Tensor) -> torch.Tensor:
    """One round: assign, then each centroid the mean of its points
    (``points`` a tensor, or its row blocks: partial sums and counts per
    block, summed in block order)."""
    blocks = [points] if isinstance(points, torch.Tensor) else points
    k = cents.shape[0]
    sums, counts = [], []
    for b in blocks:
        c = move(cents, b.device)
        assign = _assign(b, c)
        sums.append(torch.zeros_like(c).index_add_(0, assign, b))
        counts.append(torch.bincount(assign, minlength=k).to(b.dtype))
    total = position_sum(sums, cents.device)
    count = position_sum(counts, cents.device)
    return torch.where(count[:, None] > 0,
                       total / count.clamp_min(1)[:, None], cents)


def kmeans(points: torch.Tensor, k: int, iters: int = 10,
           init_centroids: Optional[torch.Tensor] = None,
           seed: int = 0, init: str = "random"
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (centroids (k, d), assignments (n,)). ``init="sample"`` may shrink
    k, as in the reference, when the sample has duplicate points."""
    if init not in ("random", "sample"):
        raise ValueError(f"init must be 'random' or 'sample', got {init!r}")
    if init_centroids is None and init == "sample":
        init_centroids = sample_init(points, k, seed)
    return kmeans_blocks([points], k, iters, init_centroids, seed)


def kmeans_blocks(blocks: Sequence[torch.Tensor], k: int, iters: int = 10,
                  init_centroids: Optional[torch.Tensor] = None,
                  seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`kmeans` over the points' row blocks (each on its own
    device; the random init draws the same rows however they are split):
    the centroids on the first block's device, the assignments of every
    row in block order there too."""
    blocks = list(blocks)
    dev = blocks[0].device
    if init_centroids is None:
        init_centroids = random_init(blocks, k, seed)
    cents = init_centroids.to(device=dev, dtype=blocks[0].dtype)
    for _ in range(iters):
        cents = lloyd_step(blocks, cents)
    assign: List[torch.Tensor] = [
        move(_assign(b, move(cents, b.device)), dev) for b in blocks]
    return cents, assign[0] if len(assign) == 1 else torch.cat(assign)


def kmeans_on_set(client, db: str, set_name: str, k: int, iters: int = 10,
                  out_set: str = "kmeans_centroids", seed: int = 0):
    """Set driver (``TestKMeans``'s shape): points from a tensor set (n x
    d), the centroids written back as a tensor set of the same block
    shape. A row-sharded placed set runs :func:`kmeans_blocks` over its
    positions' rows."""
    pts = client.get_tensor(db, set_name)
    cents, assign = kmeans_blocks(placed_ops.row_blocks(pts, "kmeans_on_set"),
                                  k, iters, seed=seed)
    if not client.set_exists(db, out_set):
        client.create_set(db, out_set)
    client.store.put_tensor(SetIdentifier(db, out_set),
                            BlockedTensor.from_dense(cents,
                                                     pts.meta.block_shape))
    return cents, assign
