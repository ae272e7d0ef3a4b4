"""Statistics-driven physical planning — counterpart of
``netsdb_tpu/relational/planner.py``.

Three choices change the algorithm, not the schedule, and are made here
from ingest-time column statistics
(:mod:`~netsdb_tpu_torch.relational.stats`) and per-device-kind
thresholds (:mod:`~netsdb_tpu_torch.relational.tuning`):

- **LUT versus sort equi-join** (:func:`plan_join`): a dense lookup
  table for dense surrogate keys, argsort + searchsorted when the key
  space is mostly empty or the table would pass the byte cap;
- **dense versus scatter segment reduction** (:func:`segment_method`,
  and the grid count of :func:`count_method`);
- **broadcast versus repartition distribution**
  (:func:`plan_distribution`).

The reference's analogue is ``TCAPAnalyzer``'s greedy choices from set
statistics (``src/queryPlanning/headers/TCAPAnalyzer.h:20-40``).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch

from netsdb_tpu_torch.relational import tuning
from netsdb_tpu_torch.relational.stats import ColumnStats, column_stats
from netsdb_tpu_torch.relational.table import ColumnTable


class JoinPlan(NamedTuple):
    """Physical equi-join choice: ``strategy`` ``"lut"`` (scatter build,
    gather probe) or ``"sort"`` (argsort + searchsorted); ``key_space``
    is the stats-derived dense bound of the key columns."""

    strategy: str
    key_space: int

    @property
    def is_lut(self) -> bool:
        return self.strategy == "lut"


def plan_join_from_stats(build: ColumnStats, n_probe: int,
                         kind: Optional[str] = None) -> JoinPlan:
    """LUT while the key space is within ``join_lut_factor`` of the
    touched rows and the LUT fits the byte cap; otherwise sort."""
    ks = build.key_space
    factor = tuning.get("join_lut_factor", kind)
    max_bytes = tuning.get("join_lut_max_bytes", kind)
    touched = build.n_rows + n_probe
    if ks <= factor * max(touched, 1) and ks * 4 <= max_bytes:
        return JoinPlan("lut", ks)
    return JoinPlan("sort", ks)


def plan_join(build: ColumnTable, build_col: str,
              probe: ColumnTable, probe_col: Optional[str] = None,
              kind: Optional[str] = None) -> JoinPlan:
    """The join of ``build[build_col]`` probed by ``probe[probe_col]``,
    planned for the build table's device kind unless ``kind`` is given.
    With ``probe_col`` the plan's ``key_space`` bounds both columns, so
    a segment reduction over the foreign key that reuses it stays in
    range even with orphan keys."""
    bs = column_stats(build, build_col)
    ks = bs.key_space
    if probe_col is not None:
        ks = max(ks, column_stats(probe, probe_col).key_space)
    merged = ColumnStats(bs.n_rows, bs.min_val, max(bs.max_val, ks - 1),
                         bs.n_distinct)
    return plan_join_from_stats(
        merged, probe.num_rows,
        kind if kind is not None else tuning.device_kind(build.device))


def segment_method(num_segments: int, kind: Optional[str] = None) -> str:
    """``"dense"`` or ``"scatter"`` for a ``num_segments``-group reduce."""
    limit = tuning.get("segment_dense_limit", kind)
    return "dense" if num_segments <= limit else "scatter"


def count_method(num_segments: int, kind: Optional[str] = None) -> str:
    """``"dense"``, ``"grid"`` (the exact one-hot product count) or
    ``"scatter"`` for a pure count."""
    if num_segments <= tuning.get("segment_dense_limit", kind):
        return "dense"
    if num_segments <= tuning.get("count_grid_limit", kind):
        return "grid"
    return "scatter"


class DistPlan(NamedTuple):
    """Replicate the build side (``"broadcast"``) or hash-repartition
    both sides (``"partition"``)."""

    strategy: str


# broadcast while the replicated build side stays under this fraction of
# one device's memory (the reference's BroadcastJoinBuildHTJobStage rule)
_BROADCAST_HBM_FRACTION = 0.10


def device_memory_bytes(device=None) -> int:
    """One device's memory: the card's total memory, or the host's
    physical memory for the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        return int(torch.cuda.get_device_properties(dev).total_memory)
    return int(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))


def plan_distribution(build_bytes: int, n_devices: int,
                      device_bytes: Optional[int] = None) -> DistPlan:
    """Broadcast while the build side is small against one device's
    memory (dimension tables); repartition when both sides are
    fact-scale."""
    if device_bytes is None:
        device_bytes = device_memory_bytes()
    if build_bytes <= _BROADCAST_HBM_FRACTION * device_bytes:
        return DistPlan("broadcast")
    return DistPlan("partition")
