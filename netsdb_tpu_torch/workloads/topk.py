"""Top-K — counterpart of ``netsdb_tpu/workloads/topk.py`` (reference
``TopKTest.h``, ``TestTopK.cc``). ``lax.top_k`` puts equal scores at the
lower index first; ``torch.topk`` leaves their order open, so the port
takes a stable descending sort (the rule of
``relational.kernels.top_k_masked``). Over a row-sharded placed relation
the table driver runs the shuffle's distributed top-k (a local top-k
per position, the candidates merged in position order), which keeps the
same tie rule."""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

from netsdb_tpu_torch.parallel import placed_ops
from netsdb_tpu_torch.parallel.placement import is_placed_table
from netsdb_tpu_torch.relational import kernels as K
from netsdb_tpu_torch.relational.table import ColumnTable


def top_k(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (values, int32 indices), descending, ties to the lower index."""
    vals, order = torch.sort(scores, descending=True, stable=True)
    return vals[:k], order[:k].to(torch.int32)


def top_k_on_set(client, db: str, set_name: str, k: int,
                 score: Callable[[Any], float],
                 out_set: str = "topk") -> List[Any]:
    """Score every item of a set with ``score`` on the host and keep the
    K best, scored on the client's device (reference TopK over arbitrary
    objects with a distance lambda; a placed object set holds the same
    host records)."""
    items = list(client.get_set_iterator(db, set_name))
    if not items:
        return []
    scores = torch.tensor([score(it) for it in items], dtype=torch.float32,
                          device=client.device)
    k = min(k, len(items))
    _, idx = top_k(scores, k)
    winners = [items[i] for i in idx.tolist()]
    if not client.set_exists(db, out_set):
        client.create_set(db, out_set, type_name="object")
    client.clear_set(db, out_set)
    client.send_data(db, out_set, winners)
    return winners


def top_k_on_table_set(client, db: str, set_name: str, score_col: str,
                       k: int, out_set: str = "topk_table") -> ColumnTable:
    """Relation driver: the scores are a column of a stored
    ``ColumnTable``; the k winners become a k-row relation {row, score},
    rows past the valid ones masked."""
    t = client.get_table(db, set_name)
    scores = t[score_col]
    if is_placed_table(t):
        idx, ok = _placed_top_k(t, score_col, k)
    else:
        idx, ok = K.top_k_masked(scores, min(k, scores.shape[0]), t.mask())
    picked = placed_ops.take_rows(scores, idx.to(torch.int64),
                                  "top_k_on_table_set")
    out = ColumnTable({"row": idx, "score": picked}, valid=ok)
    if not client.set_exists(db, out_set):
        client.create_set(db, out_set, type_name="table")
    client.clear_set(db, out_set)
    client.send_data(db, out_set, [out])
    return out


def _placed_top_k(t: ColumnTable, score_col: str,
                  k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``top_k_masked`` over a placed relation: the distributed top-k of
    a row-sharded column (``shuffle.distributed_top_k``), its keys
    mapped back to row numbers; a replicated relation runs on its first
    position."""
    from netsdb_tpu_torch.relational.shuffle import distributed_top_k

    col = t.cols[score_col]
    kk = min(k, t.__dict__.get("_source_rows", col.shape[0]))
    entry = col.spec[0]
    if entry is None:
        return K.top_k_masked(col.first(), kk, t.valid.first()
                              if t.valid is not None else None)
    n = col.parts(0)
    _, keys, ok = distributed_top_k(col.mesh, entry, col, kk,
                                    mask=t.valid)
    rows = (keys % n) * col.local_shape[0] + keys // n
    return rows.to(torch.int32), ok