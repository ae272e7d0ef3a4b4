"""Streamable decompositions of the TPC-H cores — counterpart of
``netsdb_tpu/relational/folds.py``, first part.

A :class:`~netsdb_tpu_torch.plan.fold.FoldSpec` gives a query an init /
per-chunk step / finalize form over its fact table, the reference's
page-by-page pipeline contract (``src/storage/headers/PageScanner.h:
25-34``). Every step first folds the chunk's validity into its columns
(``dag._fold_mask``: invalid rows get -1 keys and 0 measures, which the
kernels' orphan-key rule drops) and then runs the same expressions as
the whole-table core, accumulating instead of reducing once. Join plans
come from captured statistics (:func:`plan_from_captured`), never from
the streamed columns.

Q01 and Q06 are here: ``dag.q01_sink`` and ``dag.q06_sink`` derive their
whole-relation path from them. The other eight folds stream paged
relations and come with them (ROADMAP.md A6, part 2).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from netsdb_tpu_torch.plan.fold import FoldSpec, single_pass
from netsdb_tpu_torch.relational.planner import JoinPlan, plan_join_from_stats
from netsdb_tpu_torch.relational.stats import ColumnStats
from netsdb_tpu_torch.relational.table import date_to_int

Captured = Dict[str, Dict[str, ColumnStats]]


def plan_from_captured(cap: Captured, nrows: Dict[str, int],
                       build_tab: str, build_col: str,
                       probe_tab: str, probe_col: str,
                       kind: Optional[str] = None) -> JoinPlan:
    """``planner.plan_join`` from captured summaries instead of live
    tables, with the same widening rule (the plan's key space bounds
    both columns, so orphan foreign keys stay in range)."""
    bs = cap[build_tab][build_col]
    ks = max(bs.key_space, cap[probe_tab][probe_col].key_space)
    merged = ColumnStats(bs.n_rows, bs.min_val, max(bs.max_val, ks - 1),
                         bs.n_distinct)
    return plan_join_from_stats(merged, nrows[probe_tab], kind)


def _fm(t):
    from netsdb_tpu_torch.relational.dag import _fold_mask

    return _fold_mask(t)


# ---------------------------------------------------------------- Q01
def fold_q01(cap: Captured, dicts, nrows, *, delta_date: str = "1998-09-02"
             ) -> FoldSpec:
    from netsdb_tpu_torch.relational.queries import _q01_fold

    delta = date_to_int(delta_date)

    def shape(src):
        n_ls = len(src.dicts["l_linestatus"])
        return n_ls, len(src.dicts["l_returnflag"]) * n_ls

    def init(prev, src):
        _, g = shape(src)
        dev = src.device
        return (torch.zeros((5, g), dtype=torch.float32, device=dev),
                torch.zeros((g,), dtype=torch.int32, device=dev))

    def step(st, t):
        t = _fm(t)
        n_ls, g = shape(t)
        s, c = _q01_fold(g, n_ls, t["l_returnflag"], t["l_linestatus"],
                         t["l_quantity"], t["l_extendedprice"],
                         t["l_discount"], t["l_tax"],
                         t["l_shipdate"] <= delta)
        return (st[0] + s, st[1] + c)

    return single_pass(init, step, lambda st, src: (st[0], st[1]))


# ---------------------------------------------------------------- Q06
def fold_q06(cap: Captured, dicts, nrows, *, d0: str = "1994-01-01",
             d1: str = "1995-01-01", disc: float = 0.06, qty: int = 24
             ) -> FoldSpec:
    a, b = date_to_int(d0), date_to_int(d1)

    def step(st, t):
        t = _fm(t)
        ship, discount = t["l_shipdate"], t["l_discount"]
        # the reference closes over disc: its bounds are Python floats
        mask = ((ship >= a) & (ship < b)
                & (discount >= disc - 0.011) & (discount <= disc + 0.011)
                & (t["l_quantity"] < qty))
        return st + torch.where(mask, t["l_extendedprice"] * discount,
                                0.0).sum()

    return single_pass(
        lambda prev, src: torch.zeros((), dtype=torch.float32,
                                      device=src.device),
        step, lambda st, src: (st,))
