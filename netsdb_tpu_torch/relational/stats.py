"""Per-column statistics — the planner's input; counterpart of
``netsdb_tpu/relational/stats.py``.

The reference collects per-set statistics and feeds them to its greedy
physical planner (``src/queryPlanning/headers/TCAPAnalyzer.h:20-40``).
Here the facts are column-level (row count, key min and max, distinct
count) because the choices they drive are LUT-versus-sort joins and
dense-versus-scatter segment reductions
(:mod:`~netsdb_tpu_torch.relational.planner`).

Statistics are collected where the data is when it arrives: the host
columns a table is built from are analysed before they are uploaded
(:func:`analyze_columns`, called by ``ColumnTable.from_rows`` /
``from_columns``), and the result is cached PER TABLE INSTANCE, so every
later plan decision is a dict lookup. A table that reaches the planner
with a cold cache (a filtered or gathered table) is analysed where its
columns live: on a card that is one min/max reduction per column and
two scalars back, never the column itself.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from netsdb_tpu_torch.relational.table import _STATS_ATTR, ColumnTable


@dataclasses.dataclass(frozen=True)
class ColumnStats:
    """Host-side facts about one integer column (keys, codes, dates).
    ``n_distinct`` is -1 until asked for (``column_stats(...,
    distinct=True)``): no plan decision needs its sort."""

    n_rows: int
    min_val: int
    max_val: int
    n_distinct: int = -1

    @property
    def key_space(self) -> int:
        """Every value lies in ``[0, key_space)``; at least 1, so static
        sizes stay positive for empty or all-negative columns."""
        return max(self.max_val + 1, 1)

    @property
    def density(self) -> float:
        """Fraction of the key space the column occupies."""
        if self.n_distinct < 0:
            raise ValueError("distinct count not computed; use "
                             "column_stats(table, col, distinct=True)")
        return self.n_distinct / max(self.key_space, 1)


def analyze_array(arr, distinct: bool = False) -> ColumnStats:
    """Min/max of a numpy array or a tensor, and the distinct count when
    asked. A tensor is reduced where it lives (a placed column on its
    first position, gathered)."""
    if hasattr(arr, "shards"):
        arr = arr.to_dense()
    if isinstance(arr, torch.Tensor):
        a = arr.detach()
        if a.numel() == 0:
            return ColumnStats(0, 0, -1, 0 if distinct else -1)
        if a.dtype == torch.bool:
            a = a.to(torch.int32)
        lo, hi = torch.aminmax(a)
        nd = int(torch.unique(a).numel()) if distinct else -1
        return ColumnStats(int(a.numel()), int(lo), int(hi), nd)
    a = np.asarray(arr)
    if a.size == 0:
        return ColumnStats(0, 0, -1, 0 if distinct else -1)
    if a.dtype.kind == "b":
        a = a.astype(np.int32)
    nd = int(np.unique(a).size) if distinct else -1
    return ColumnStats(int(a.size), int(a.min()), int(a.max()), nd)


def analyze_columns(cols: Dict[str, np.ndarray]) -> Dict[str, ColumnStats]:
    """Statistics of every integer and bool host column (float measures
    carry no planning signal)."""
    return {n: analyze_array(c) for n, c in cols.items()
            if np.asarray(c).dtype.kind in "ib"}


def _stats_cache(table: ColumnTable) -> Dict[str, ColumnStats]:
    cache = table.__dict__.get(_STATS_ATTR)
    if cache is None:
        cache = {}
        table.__dict__[_STATS_ATTR] = cache
    return cache


def inject_stats(table: ColumnTable,
                 stats: Dict[str, ColumnStats]) -> ColumnTable:
    """Seed ``table``'s cache with statistics collected elsewhere (the
    DAG builders' captured summaries). Returns the same table."""
    _stats_cache(table).update(stats)
    return table


def column_stats(table: ColumnTable, col: str,
                 distinct: bool = False) -> ColumnStats:
    """Statistics of ``table[col]``, cached on the table instance."""
    cache = _stats_cache(table)
    if col not in cache or (distinct and cache[col].n_distinct < 0):
        cache[col] = analyze_array(table[col], distinct)
    return cache[col]


def key_space(table: ColumnTable, col: str) -> int:
    """Static key-space bound (max key + 1) — the group count every
    segment reduction over the column needs."""
    return column_stats(table, col).key_space


def _is_int_or_bool(t: torch.Tensor) -> bool:
    return t.dtype == torch.bool or not (t.dtype.is_floating_point
                                         or t.dtype.is_complex)


def analyze_table(table: ColumnTable,
                  cols: Optional[Iterable[str]] = None
                  ) -> Dict[str, ColumnStats]:
    """The cache for ``cols`` (default: every integer and bool column),
    filled where cold."""
    if cols is None:
        cols = [n for n, c in table.cols.items() if _is_int_or_bool(c)]
    return {c: column_stats(table, c) for c in cols}
