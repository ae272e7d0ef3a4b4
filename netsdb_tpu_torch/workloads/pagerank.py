"""PageRank — counterpart of ``netsdb_tpu/workloads/pagerank.py``
(reference ``RankUpdateAggregation.h``, ``JoinRankedUrlWithLink.h``,
``TestPageRank*.cc``).

Edges are (src, dst) index tensors on one device; each round gathers
every source's rank over its out-degree and sums the contributions per
target with ``index_add_``, in f32 (the reference's dtype). An id out of
``[0, num_nodes)`` raises ``IndexError`` (``segment_sum`` drops it; on
the card ``index_add_`` would assert). The table driver folds the
relation's validity into -1 endpoints and masks those rows before any
index is used, as the reference does. Over a row-sharded placed link
relation each position forms its rows' contributions and the partial
sums are added in position order.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from netsdb_tpu_torch.config import resolve_device
from netsdb_tpu_torch.parallel.mesh import move, position_sum
from netsdb_tpu_torch.parallel.placement import row_tables


def _ids(ids, device) -> torch.Tensor:
    if isinstance(ids, torch.Tensor):
        return ids.to(torch.int64)
    return torch.as_tensor(np.asarray(ids), device=resolve_device(device)
                           ).to(torch.int64)


def _check_range(ids: torch.Tensor, num_nodes: int, what: str) -> None:
    if ids.numel():
        lo, hi = torch.aminmax(ids)
        if int(lo) < 0 or int(hi) >= num_nodes:
            raise IndexError(f"pagerank: {what} ids span [{int(lo)}, "
                             f"{int(hi)}], outside [0, {num_nodes})")


def pagerank(src, dst, num_nodes: int, damping: float = 0.85,
             iters: int = 20, device=None) -> torch.Tensor:
    """→ rank vector (num_nodes,) f32 on the edges' device (tensors), or
    on ``device`` (CUDA unless asked) for arrays. A node with no out-edge
    spreads its rank evenly (the ranks keep summing to 1)."""
    src = _ids(src, device)
    dst = _ids(dst, src.device)
    _check_range(src, num_nodes, "src")
    _check_range(dst, num_nodes, "dst")
    out_degree = torch.bincount(src, minlength=num_nodes).to(torch.float32)
    safe_deg = out_degree.clamp_min(1.0)
    dangling_node = out_degree == 0
    rank = torch.full((num_nodes,), 1.0 / num_nodes, dtype=torch.float32,
                      device=src.device)
    for _ in range(iters):
        # (rank / deg)[src] is rank[src] / deg[src], value for value
        contrib = (rank / safe_deg).index_select(0, src)
        incoming = torch.zeros_like(rank).index_add_(0, dst, contrib)
        dangling = torch.where(dangling_node, rank, 0.0).sum()
        rank = (1 - damping) / num_nodes + damping * (
            incoming + dangling / num_nodes)
    return rank


def _write_ranks(client, db: str, out_set: str, ranks: np.ndarray) -> None:
    if not client.set_exists(db, out_set):
        client.create_set(db, out_set, type_name="object")
    client.clear_set(db, out_set)
    client.send_data(db, out_set, [(int(i), float(r))
                                   for i, r in enumerate(ranks)])


def pagerank_on_set(client, db: str, links_set: str, num_nodes: int,
                    damping: float = 0.85, iters: int = 20,
                    out_set: str = "ranks") -> np.ndarray:
    """Set driver: the links set holds (src, dst) pairs (the reference's
    ``Link`` objects), run on the client's device; the ranks are written
    as (url, rank) pairs (a placed object set holds the same host
    records)."""
    edges: Iterable = list(client.get_set_iterator(db, links_set))
    pairs = np.asarray([(e[0], e[1]) for e in edges],
                       np.int64).reshape(-1, 2)
    ranks = pagerank(torch.from_numpy(pairs[:, 0]).to(client.device),
                     torch.from_numpy(pairs[:, 1]).to(client.device),
                     num_nodes, damping, iters).cpu().numpy()
    _write_ranks(client, db, out_set, ranks)
    return ranks


def pagerank_on_table_set(client, db: str, links_set: str, num_nodes: int,
                          damping: float = 0.85, iters: int = 20,
                          out_set: str = "ranks") -> np.ndarray:
    """Relation driver: the link relation is a stored ``ColumnTable``
    {src, dst}, resident or placed (row-sharded: each position's rows
    contribute, the partial sums added in position order). Rows that are
    invalid or carry a -1 endpoint contribute nothing; as in the
    reference, this driver drops dangling mass."""
    from netsdb_tpu_torch.relational.dag import _fold_mask

    blocks = []
    for t in row_tables(client.get_table(db, links_set)):
        t = _fold_mask(t)
        s = t["src"].to(torch.int64)
        d = t["dst"].to(torch.int64)
        ok = (s >= 0) & (d >= 0)
        sc = torch.where(ok, s, 0)
        dc = torch.where(ok, d, 0)
        _check_range(sc, num_nodes, "src")
        _check_range(dc, num_nodes, "dst")
        blocks.append((ok, sc, dc))
    dev = blocks[0][0].device
    deg = position_sum([
        torch.zeros(num_nodes, dtype=torch.float32, device=sc.device)
        .index_add_(0, sc, ok.to(torch.float32))
        for ok, sc, _ in blocks], dev)
    safe = deg.clamp_min(1.0)
    rank = torch.full((num_nodes,), 1.0 / num_nodes, dtype=torch.float32,
                      device=dev)
    for _ in range(iters):
        parts = []
        for ok, sc, dc in blocks:
            share = move(rank / safe, sc.device)
            contrib = torch.where(ok, share.index_select(0, sc), 0.0)
            parts.append(torch.zeros(num_nodes, dtype=torch.float32,
                                     device=sc.device)
                         .index_add_(0, dc, contrib))
        agg = position_sum(parts, dev)
        rank = (1.0 - damping) / num_nodes + damping * agg
    ranks = rank.cpu().numpy()
    _write_ranks(client, db, out_set, ranks)
    return ranks
