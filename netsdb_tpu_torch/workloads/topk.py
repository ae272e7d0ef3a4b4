"""Top-K — counterpart of ``netsdb_tpu/workloads/topk.py`` (reference
``TopKTest.h``, ``TestTopK.cc``). ``lax.top_k`` puts equal scores at the
lower index first; ``torch.topk`` leaves their order open, so the port
takes a stable descending sort (the rule of
``relational.kernels.top_k_masked``)."""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

from netsdb_tpu_torch.parallel.placement import refuse_placed
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
    objects with a distance lambda)."""
    refuse_placed(client, db, set_name, "top_k_on_set")
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
    refuse_placed(client, db, set_name, "top_k_on_table_set")
    t = client.get_table(db, set_name)
    scores = t[score_col]
    kk = min(k, scores.shape[0])
    idx, ok = K.top_k_masked(scores, kk, t.mask())
    out = ColumnTable({"row": idx,
                       "score": scores.index_select(0, idx.to(torch.int64))},
                      valid=ok)
    if not client.set_exists(db, out_set):
        client.create_set(db, out_set, type_name="table")
    client.clear_set(db, out_set)
    client.send_data(db, out_set, [out])
    return out
