"""Query executor — counterpart of ``netsdb_tpu/plan/executor.py``.

The reference composes a resident all-tensor DAG into one jitted program
(``executor.py:1188-1231``) and interprets the rest eagerly
(``:1232-1236``). PyTorch runs eagerly, so the two branches are one
here: scan each set, replay the DAG in topo order under
``torch.inference_mode()`` (every op launches on the device the scanned
tensors live on), then materialise each sink into its output set. A
placed set's sharded value (:class:`~netsdb_tpu_torch.parallel.mesh.
ShardedTensor`) reaches the DAG as it is and a sharded sink value is
stored as it is: nothing is gathered on the way. There is no
compiled-program cache to key. Streamed execution over paged sets is
ROADMAP.md A2.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from netsdb_tpu_torch.core.blocked import BlockedTensor
from netsdb_tpu_torch.parallel.mesh import ShardedTensor
from netsdb_tpu_torch.plan.computations import ScanSet, WriteSet
from netsdb_tpu_torch.plan.planner import LogicalPlan, plan_from_sinks
from netsdb_tpu_torch.storage.store import SetIdentifier


def _evaluate(plan: LogicalPlan, scan_values: Dict[int, Any]) -> Dict[int, Any]:
    """Replay the DAG in topo order; a shared subgraph runs once."""
    values: Dict[int, Any] = dict(scan_values)
    for node in plan.topo:
        if node.node_id not in values:
            values[node.node_id] = node.evaluate(
                *[values[i.node_id] for i in node.inputs])
    return values


def execute_computations(client, sinks: List[WriteSet],
                         job_name: str = "job",
                         materialize: bool = True
                         ) -> Dict[SetIdentifier, Any]:
    """Plan and run; returns {output set ident: value} and (by default)
    materialises the results into the store — the reference's OUTPUT
    sets. ``job_name`` names the job as in the reference (which keys its
    compiled-program cache on it)."""
    del job_name  # eager execution: nothing is cached per job
    plan = plan_from_sinks(sinks)
    scan_values: Dict[int, Any] = {}
    for node in plan.topo:
        if isinstance(node, ScanSet):
            items = client.store.get_items(SetIdentifier(node.db,
                                                         node.set_name))
            # a one-tensor set's value is the tensor itself; any other
            # set is scanned as its item list
            single = len(items) == 1 and isinstance(
                items[0], (BlockedTensor, torch.Tensor, ShardedTensor))
            scan_values[node.node_id] = items[0] if single else items
    with torch.inference_mode():
        values = _evaluate(plan, scan_values)

    results: Dict[SetIdentifier, Any] = {}
    for sink in plan.sinks:
        out = values[sink.inputs[0].node_id]
        ident = SetIdentifier(sink.db, sink.set_name)
        results[ident] = out
        if materialize:
            client.store.create_set(ident)
            if isinstance(out, BlockedTensor):
                client.store.put_tensor(ident, out)
                continue
            client.store.clear_set(ident)
            if isinstance(out, (torch.Tensor, ShardedTensor)):
                # one tensor IS the set's content (not its rows)
                client.store.add_data(ident, [out])
            elif isinstance(out, dict):
                client.store.add_data(ident, list(out.items()))
            else:
                client.store.add_data(ident, list(out))
    return results
