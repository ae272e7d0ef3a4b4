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
compiled-program cache to key.

A scan of a paged tensor set gives a :class:`~netsdb_tpu_torch.storage.
paged.PagedTensor` handle, and the node that consumes it streams it
through its :class:`~netsdb_tpu_torch.plan.fold.TensorFold`
(:func:`_run_tensor_stream`, the reference's ``:512-690``). Gather
nodes (``passthrough``) forward the handle; any other node without a
fold raises ``ValueError`` naming ``tensor_fold`` — a paged set is never
materialised behind the caller's back. A job whose sinks split into
paged and resident components runs each component on its own.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List

import torch

from netsdb_tpu_torch.core.blocked import BlockedTensor, BlockMeta
from netsdb_tpu_torch.parallel.mesh import ShardedTensor
from netsdb_tpu_torch.plan import staging
from netsdb_tpu_torch.plan.computations import ScanSet, WriteSet
from netsdb_tpu_torch.plan.planner import LogicalPlan, plan_from_sinks
from netsdb_tpu_torch.storage.paged import PagedTensor
from netsdb_tpu_torch.storage.store import SetIdentifier


def _has_paged(value: Any) -> bool:
    if isinstance(value, PagedTensor):
        return True
    return isinstance(value, tuple) and any(_has_paged(v) for v in value)


def _reblock(dense: torch.Tensor, block_shape) -> BlockedTensor:
    """``dense`` as a BlockedTensor of ``block_shape``, padded with zeros
    only where the blocks need it (no copy otherwise)."""
    meta = BlockMeta(tuple(dense.shape), tuple(block_shape))
    if meta.is_padded:
        pad = []
        for s, p in reversed(list(zip(meta.shape, meta.padded_shape))):
            pad += [0, p - s]
        dense = torch.nn.functional.pad(dense, pad)
    return BlockedTensor(dense, meta)


def _run_tensor_stream(node, tfold, in_vals: List[Any], src: int) -> Any:
    """Stream the paged tensor ``in_vals[src]`` through ``node``: only the
    current block, the staged next blocks, the node's other inputs and
    the output are on the device; the next block's upload runs while
    the current one computes (:mod:`~netsdb_tpu_torch.plan.staging`). A
    warm query replays the blocks from the device cache.

    Rows mode: ``fn`` runs once per row block (the block in place of the
    paged input); each block pads to its row bucket (zero rows, sliced
    off the output), the output rows are concatenated and re-blocked to
    ``out_block``. Reduce mode: blocks are contraction slices, never
    padded; ``partial`` accumulates into its carry in place and
    ``finalize`` applies the epilogue. A placed paged set applies its
    placement to each staged block. Cached blocks are never written."""
    pt: PagedTensor = in_vals[src]
    others = [v for i, v in enumerate(in_vals) if i != src]
    cfg = pt.store.config
    depth = cfg.stage_depth
    rb = pt.store.meta(pt.name)[1][0]  # nominal rows per block
    placement = pt.placement
    label = placement.label() if placement is not None else None
    uploader = staging.BlockUploader(pt.device, depth)
    kind = "trows" if tfold.mode == "rows" else "treduce"
    cache, scope = pt.devcache, pt.cache_scope
    stream_kw: Dict[str, Any] = {}
    if cache is not None and scope is not None and cache.enabled:
        if cache.partial:
            # block entries: no write version in the key, since every
            # write of a tensor set drops all its blocks
            stream_kw["partial"] = staging.PartialPlan(
                cache, (scope[0], kind, rb, cfg.shape_bucketing,
                        cfg.bucket_density, label),
                pt.block_ranges(), lambda idxs: pt.stream_blocks(blocks=idxs))
        else:
            stream_kw.update(
                cache=cache,
                cache_key=(scope[0], scope[1], kind, rb, cfg.shape_bucketing,
                           cfg.bucket_density, label),
                cache_validator=lambda: pt.cache_version_fn() == scope[1])

    def upload(block, rows=None):
        b = uploader.upload(block, rows=rows)
        return placement.apply(b) if placement is not None else b

    def stream(place):
        return contextlib.closing(staging.stage_stream(
            None if "partial" in stream_kw else pt.stream_blocks(), place,
            depth, name=f"{kind}:{pt.name}", uploader=uploader,
            **stream_kw))

    if tfold.mode == "rows":
        def place(item):
            _start, block = item
            n = block.shape[0]
            return n, upload(block, staging.pad_rows_target(
                n, cfg.shape_bucketing, density=cfg.bucket_density))

        outs, blocked = [], False
        with stream(place) as blocks:
            for n, block in blocks:
                shape = tuple(block.shape)
                args = list(others)
                args.insert(src, BlockedTensor(block, BlockMeta(shape,
                                                                shape)))
                out = node.fn(*args)
                if isinstance(out, BlockedTensor):
                    blocked = True
                    out = out.to_dense()
                outs.append(out[:n] if out.shape[0] != n else out)
        dense = torch.cat(outs, dim=0)
        if tfold.out_block is not None:
            return _reblock(dense, tfold.out_block)
        return _reblock(dense, tuple(dense.shape)) if blocked else dense

    def place(item):
        start, block = item
        return start, upload(block)

    carry = None
    with stream(place) as blocks:
        for start, block in blocks:
            carry = tfold.partial(carry, start, block, *others)
    if tfold.finalize is not None:
        return tfold.finalize(carry, *others)
    return carry


def _label(node) -> str:
    return getattr(node, "label", node.op_kind)


def _evaluate(plan: LogicalPlan, scan_values: Dict[int, Any]) -> Dict[int, Any]:
    """Replay the DAG in topo order; a shared subgraph runs once. A node
    that consumes a paged handle streams it through its fold."""
    values: Dict[int, Any] = dict(scan_values)
    for node in plan.topo:
        if node.node_id in values:
            continue
        in_vals = [values[i.node_id] for i in node.inputs]
        paged = [i for i, v in enumerate(in_vals) if _has_paged(v)]
        if paged and not getattr(node, "passthrough", False):
            tfold = getattr(node, "tensor_fold", None)
            direct = [i for i in paged if isinstance(in_vals[i], PagedTensor)]
            if tfold is None or len(paged) > 1 or direct != paged:
                names = [in_vals[i].name if isinstance(in_vals[i],
                                                       PagedTensor)
                         else f"input {i}" for i in paged]
                raise ValueError(
                    f"node {_label(node)!r} consumes paged tensor set(s) "
                    f"{names} but "
                    + ("declares no tensor_fold" if tfold is None else
                       "only one input, given directly, may stream")
                    + "; give the node a plan.fold.TensorFold, or store the "
                      "set with storage='memory'")
            values[node.node_id] = _run_tensor_stream(node, tfold, in_vals,
                                                      paged[0])
            continue
        values[node.node_id] = node.evaluate(*in_vals)
    return values


def _reaches(sink, scan_ids) -> bool:
    stack, seen = [sink], set()
    while stack:
        n = stack.pop()
        if n.node_id in seen:
            continue
        seen.add(n.node_id)
        if n.node_id in scan_ids:
            return True
        stack.extend(n.inputs)
    return False


def execute_computations(client, sinks: List[WriteSet],
                         job_name: str = "job",
                         materialize: bool = True
                         ) -> Dict[SetIdentifier, Any]:
    """Plan and run; returns {output set ident: value} and (by default)
    materialises the results into the store — the reference's OUTPUT
    sets. ``job_name`` names the job as in the reference (which keys its
    compiled-program cache on it)."""
    plan = plan_from_sinks(sinks)
    store = client.store
    if len(plan.sinks) > 1:
        # sinks that reach no paged set run apart from those that do
        # (the reference's auto-split, executor.py:1101-1134)
        paged_scans = {n.node_id for n in plan.topo
                       if isinstance(n, ScanSet) and store.storage_of(
                           SetIdentifier(n.db, n.set_name)) == "paged"}
        if paged_scans:
            resident = [s for s in plan.sinks
                        if not _reaches(s, paged_scans)]
            if resident and len(resident) < len(plan.sinks):
                out = execute_computations(client, resident, job_name,
                                           materialize)
                out.update(execute_computations(
                    client, [s for s in plan.sinks if s not in resident],
                    job_name, materialize))
                return out
    scan_values: Dict[int, Any] = {}
    for node in plan.topo:
        if isinstance(node, ScanSet):
            ident = SetIdentifier(node.db, node.set_name)
            if store.storage_of(ident) == "paged":
                scan_values[node.node_id] = store.paged_tensor(ident)
                continue
            items = store.get_items(ident)
            # a one-tensor set's value is the tensor itself; any other
            # set, and a set of a list-scan type (tensor4d) whatever it
            # holds, is scanned as its item list
            single = len(items) == 1 and isinstance(
                items[0], (BlockedTensor, torch.Tensor, ShardedTensor)) \
                and not store.scans_as_list(ident)
            scan_values[node.node_id] = items[0] if single else items
    with torch.inference_mode():
        values = _evaluate(plan, scan_values)

    results: Dict[SetIdentifier, Any] = {}
    for sink in plan.sinks:
        out = values[sink.inputs[0].node_id]
        ident = SetIdentifier(sink.db, sink.set_name)
        results[ident] = out
        if materialize:
            store.create_set(ident)
            if isinstance(out, BlockedTensor):
                store.put_tensor(ident, out)
                continue
            store.clear_set(ident)
            if isinstance(out, (torch.Tensor, ShardedTensor)):
                # one tensor IS the set's content (not its rows)
                store.add_data(ident, [out])
            elif isinstance(out, dict):
                store.add_data(ident, list(out.items()))
            else:
                store.add_data(ident, list(out))
    return results
