"""Logical planner — counterpart of ``netsdb_tpu/plan/planner.py``:
topo-sort the DAG from its sinks and keep shared subgraphs once, and
list each sink's stage (the nodes from its scans to it). The executor
compiles whole plans and fusion regions itself (``plan/executor.py``,
``plan/fusion.py``); the stages describe the plan. The TCAP-like dump
stays the debuggable plan artifact."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

from netsdb_tpu_torch.plan.computations import Computation, ScanSet, WriteSet


@dataclasses.dataclass
class JobStage:
    """One materialization unit (the reference's ``TupleSetJobStage``):
    the topo slice of nodes from scans to one sink."""

    stage_id: int
    sink: WriteSet
    nodes: List[Computation]  # topo order, sink last

    @property
    def scans(self) -> List[ScanSet]:
        return [n for n in self.nodes if isinstance(n, ScanSet)]


@dataclasses.dataclass
class LogicalPlan:
    sinks: List[WriteSet]
    topo: List[Computation]  # whole-DAG topo order
    stages: List[JobStage]

    def to_plan_string(self) -> str:
        """TCAP-like textual dump (test/debug surface)."""
        return "\n".join(n.plan_atom() for n in self.topo)

    def consumers(self) -> Dict[int, List[Computation]]:
        """node_id → its consumers in topo order (the reverse edges the
        fusion mapper walks)."""
        out: Dict[int, List[Computation]] = {}
        for n in self.topo:
            for i in n.inputs:
                out.setdefault(i.node_id, []).append(n)
        return out

    def cache_key(self) -> str:
        """Canonical structural key: nodes renumbered by topo position,
        so two independently built DAGs of the same shape give the same
        key (structure + labels, not lambda identity)."""
        names = {n.node_id: f"n{i}" for i, n in enumerate(self.topo)}
        atoms = []
        for n in self.topo:
            ins = ",".join(names[i.node_id] for i in n.inputs)
            if isinstance(n, (ScanSet, WriteSet)):
                extra = f"{n.db}:{n.set_name}"
            else:
                extra = getattr(n, "label", "")
            atoms.append(f"{names[n.node_id]}={n.op_kind}({ins};{extra})")
        return "|".join(atoms)


def _topo_sort(sinks: Sequence[Computation]) -> List[Computation]:
    order: List[Computation] = []
    seen: Dict[int, bool] = {}

    def visit(node: Computation, path: set):
        if node.node_id in seen:
            return
        if node.node_id in path:
            raise ValueError("computation graph has a cycle")
        path = path | {node.node_id}
        for dep in node.inputs:
            visit(dep, path)
        seen[node.node_id] = True
        order.append(node)

    for s in sinks:
        visit(s, set())
    return order


def plan_from_sinks(sinks: Sequence[WriteSet]) -> LogicalPlan:
    """Build the plan from sink computations."""
    for s in sinks:
        if not isinstance(s, WriteSet):
            raise TypeError(f"sink {s!r} is not a WriteSet")
    stages = [JobStage(stage_id=i, sink=sink, nodes=_topo_sort([sink]))
              for i, sink in enumerate(sinks)]
    return LogicalPlan(sinks=list(sinks), topo=_topo_sort(sinks),
                       stages=stages)
