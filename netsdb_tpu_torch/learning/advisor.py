"""Placement advisor — the port's ``netsdb_tpu/learning/advisor.py``:
Lachesis without the RL server.

The reference chooses data-placement (partition lambda + page size) for
new sets from job history, via a rule-based frequency optimizer or a
deep-RL server (``src/selfLearning/headers/
RuleBasedDataPlacementOptimizerForLoadJob.h``,
``DRLBasedDataPlacementOptimizerForLoadJob.h``, Python A3C
``scripts/pangeaDeepRL/rlServer.py``). Here the decision variable is
the sharding config (mesh shape + PartitionSpecs per set role), and the
reward is measured wall time — so the advisor is an explore/exploit
bandit over candidate configs backed by the history DB: try each
candidate once, then serve the best known, re-exploring stale arms.
The reference's separate-process RL loop is deliberately not
reproduced; measured-history selection is what its own experiments
showed mattered (documentation.md:5-10 — the win comes from reusing
the learned placement, not the learner).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

from netsdb_tpu_torch.learning.history import HistoryDB, get_history_db


@dataclasses.dataclass(frozen=True)
class PlacementCandidate:
    """One sharding configuration, e.g. mesh (4,2) with batch on data.

    ``specs`` maps a set role to its decision value: a block-shape
    tuple under ``"block"``, and/or a
    :class:`~netsdb_tpu_torch.parallel.placement.Placement` under
    ``"placement"`` (or a specific set name) — ``Client.create_set``
    applies the latter as the set's mesh sharding, making distribution
    itself an arm of the bandit."""

    label: str
    mesh_shape: tuple
    specs: Dict[str, object]  # set-role → block tuple or Placement


def fusion_candidates() -> tuple:
    """Fusion on/off as advisor ARMS — the plan-compilation decision
    exposed to the same explore/exploit bandit that learns placements
    (``arm.specs["plan_fusion"]`` is applied to the executing client's
    ``config.plan_fusion`` by the A/B harness,
    :func:`~netsdb_tpu_torch.learning.ab_bench.bench_fusion_ab`).  The cost
    model in ``plan/fusion.py`` decides WHICH regions fuse; these arms
    let measured wall time decide WHETHER fusing pays for a given job
    at all — the never-fuse/always-fuse comparison *Fast and Fusiest*
    (arxiv 2602.15166) shows a mapper must win against."""
    return (
        PlacementCandidate("fusion_on", (1,), {"plan_fusion": True}),
        PlacementCandidate("fusion_off", (1,), {"plan_fusion": False}),
    )


def mapper_candidates() -> tuple:
    """The fusion MAPPER choice (optimal DP vs the greedy whole-run mapper) as
    advisor arms (``arm.specs["fusion_mapper"]`` applied to the
    executing client's ``config.fusion_mapper`` by
    :func:`~netsdb_tpu_torch.learning.ab_bench.bench_mapper_ab`).  The DP is
    exact under its cost model, but the cost model is learned — so
    whether its splits actually beat greedy whole-run fusion on a
    given plan SHAPE is a measured decision, recorded per job the same
    way placements are."""
    return (
        PlacementCandidate("mapper_optimal", (1,),
                           {"fusion_mapper": "optimal"}),
        PlacementCandidate("mapper_greedy", (1,),
                           {"fusion_mapper": "greedy"}),
    )


def rebalance_candidates() -> tuple:
    """Live shard rebalancing on/off as advisor arms
    (``arm.specs["rebalance"]`` applied to the serving pool's
    ``config.rebalance`` by
    :func:`~netsdb_tpu_torch.learning.ab_bench.bench_rebalance_ab`).  The
    skew detector in ``serve/rebalance.py`` decides WHAT to move;
    these arms let measured routed throughput decide WHETHER moving
    pays for a given traffic mix — the observe → propose → measure →
    commit-or-revert loop of the self-rebalancing placement design,
    with the advisor's history DB as its memory."""
    return (
        PlacementCandidate("rebalance_on", (1,), {"rebalance": True}),
        PlacementCandidate("rebalance_frozen", (1,),
                           {"rebalance": False}),
    )


class PlacementAdvisor:
    def __init__(self, candidates: Sequence[PlacementCandidate],
                 db: Optional[HistoryDB] = None,
                 explore_threshold: int = 1):
        if not candidates:
            raise ValueError("need at least one candidate")
        self.candidates = list(candidates)
        self.db = db or get_history_db()
        self.explore_threshold = explore_threshold

    def _runs_for(self, job_name: str, label: str) -> int:
        return sum(1 for r in self.db.runs(job_name) if r["config"] == label)

    def choose(self, job_name: str) -> PlacementCandidate:
        """Unexplored candidate first; otherwise the best mean elapsed."""
        for c in self.candidates:
            if self._runs_for(job_name, c.label) < self.explore_threshold:
                return c
        best, best_t = None, float("inf")
        for c in self.candidates:
            t = self.db.mean_elapsed(job_name, c.label)
            if t is not None and t < best_t:
                best, best_t = c, t
        return best or self.candidates[0]

    def record(self, job_name: str, candidate: PlacementCandidate,
               elapsed_s: float) -> None:
        self.db.record(job_name, plan_key="", elapsed_s=elapsed_s,
                       config_label=candidate.label)

    def measure_and_choose(self, job_name: str,
                           run: Callable[[PlacementCandidate], float],
                           rounds: Optional[int] = None) -> PlacementCandidate:
        """Drive the explore loop: run each candidate (run() returns
        elapsed seconds), then return the winner — the reference's
        'first run slow, later runs fast' self-learning behavior
        (documentation.md:5-10)."""
        if rounds is None:  # enough to explore every arm to threshold
            rounds = len(self.candidates) * self.explore_threshold
        for _ in range(rounds):
            cand = self.choose(job_name)
            if self._runs_for(job_name, cand.label) >= self.explore_threshold:
                break  # all explored; cand is the winner
            elapsed = run(cand)
            self.record(job_name, cand, elapsed)
        return self.choose(job_name)
