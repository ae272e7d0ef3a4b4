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

A relation set (one :class:`~netsdb_tpu_torch.relational.table.
ColumnTable`) is scanned as its table, on the client's device; a node
carrying a relational ``fold`` runs the fold's whole path over it, and a
sink whose value is a table stores that table as its output set's one
item (the reference's ``:151-226``, ``:1248``).

A scan of a paged relation gives its :class:`~netsdb_tpu_torch.
relational.outofcore.PagedColumns` handle. A node whose ``fold`` streams
that input runs the fold chunk by chunk over the staged page stream
(:func:`_run_fold`, the reference's ``:227-456``): one init, one step
per chunk and one finalize per pass, the node's other inputs resident.
A paged build side among those inputs takes the one-pass grace hash when
the fold declares its join keys and a merge, the per-block loop when it
declares only a merge, and otherwise is assembled once on the device.
Gather nodes forward the handle; any other consumer gets the relation
assembled on the device, once per request and replayed from the device
cache by warm requests. The reference's fusion regions (``plan_fusion``)
are ROADMAP.md A2 and raise in the configuration.

A scan of a paged record set gives its :class:`~netsdb_tpu_torch.
storage.paged.PagedObjects` handle, an iterable of the records. The host
nodes that consume records (``Filter``, ``MultiApply``, a key or
``on=`` ``Join``, a ``key``/``value``/``combine`` ``Aggregate``, a host
``Partition``) iterate it under ``contextlib.closing`` (:func:`_eval_node`),
so a predicate that raises mid-stream releases the set's read lock at
once; every other node gets the handle itself. A record input of a
``Join(on=...)`` is columnarised on the client's device (the
reference's ``:163-184``).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List

import torch

from netsdb_tpu_torch.core.blocked import BlockedTensor, BlockMeta
from netsdb_tpu_torch.parallel.mesh import ShardedTensor
from netsdb_tpu_torch.plan import staging
from netsdb_tpu_torch.plan.computations import (Aggregate, Computation,
                                                Filter, Join, MultiApply,
                                                Partition, ScanSet,
                                                WriteSet)
from netsdb_tpu_torch.plan.fold import flatten_resident
from netsdb_tpu_torch.plan.planner import LogicalPlan, plan_from_sinks
from netsdb_tpu_torch.relational.outofcore import (PagedColumns,
                                                   partition_by_key)
from netsdb_tpu_torch.relational.table import ColumnTable
from netsdb_tpu_torch.storage.paged import PagedObjects, PagedTensor
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


def _run_fold_once(fold, pc: PagedColumns, resident) -> Any:
    """One (possibly multi-pass) fold over a paged relation's chunk
    stream: every pass re-streams the relation. Steps may update their
    own state in place and never write a chunk (cached chunks belong to
    the device cache)."""
    state = None
    for init, step in fold.passes:
        state = init(state, pc, *resident)
        # closing: a step that raises releases the stream's read lock now
        with contextlib.closing(pc.stream_tables()) as chunks:
            for chunk in chunks:
                state = step(state, chunk, *resident)
    return fold.finalize(state, pc, *resident)


def _pad_table_rows(t: ColumnTable, rows: int) -> ColumnTable:
    """``t`` padded with invalid rows to ``rows`` rows: every build
    partition gets one shape."""
    pad = rows - t.num_rows
    if pad <= 0:
        return t
    cols = {k: torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])
            for k, v in t.cols.items()}
    valid = torch.cat([t.mask(), torch.zeros(pad, dtype=torch.bool,
                                             device=t.device)])
    return ColumnTable(cols, t.dicts, valid)


def _part_chunks(ppc: PagedColumns):
    """The chunks of one probe partition, with the probe's own global
    ``_rowid`` (kept by the partitioner as ``_rowid0``; folds break ties
    on it)."""
    with contextlib.closing(ppc.stream_tables()) as chunks:
        for t in chunks:
            cols = dict(t.cols)
            cols["_rowid"] = cols.pop("_rowid0")
            yield ColumnTable(cols, t.dicts, t.valid)


def _run_fold_grace(fold, pc: PagedColumns, rest, bi: int,
                    build_pc: PagedColumns) -> Any:
    """The one-pass grace hash for a paged build side: both sides are
    hash-partitioned by the fold's join keys into spill relations of the
    arena (one host pass each; the probe's partitions keep only the
    columns the step reads), then each partition pair runs the fold with
    its build partition resident, and the outputs merge. The probe's
    pages are read once. The next pair's build partition is assembled
    and uploaded on a staging thread, ``stage_depth`` pairs ahead, while
    the current pair probes."""
    nparts = build_pc.num_pages()
    build_parts: list = []
    probe_parts: list = []
    out = None
    try:
        build_parts = partition_by_key(build_pc, fold.build_key, nparts)
        probe_parts = partition_by_key(pc, fold.probe_key, nparts,
                                       keep_rowid=True,
                                       columns=fold.probe_columns)
        maxr = max((bp.num_rows for bp in build_parts if bp is not None),
                   default=0)
        depth = build_pc.store.config.stage_depth
        uploader = staging.BlockUploader(
            build_pc.device, (depth + 1) * (len(build_pc.int_names)
                                            + len(build_pc.float_names)))

        def stage_build(p):
            return p, _pad_table_rows(
                build_parts[p].to_table(uploader=uploader), maxr)

        # a partition without build rows can only miss
        pairs = (p for p in range(nparts) if build_parts[p] is not None)
        with contextlib.closing(staging.stage_stream(
                pairs, stage_build, depth,
                name=f"grace-build:{build_pc.name}",
                uploader=uploader)) as builds:
            for p, btab in builds:
                part_res = list(rest)
                part_res[bi] = btab
                state = None
                for init, step in fold.passes:
                    state = init(state, pc, *part_res)
                    if probe_parts[p] is None:
                        continue
                    # closing: a step that raises must release the
                    # partition's read lock before the drops below
                    with contextlib.closing(
                            _part_chunks(probe_parts[p])) as chunks:
                        for chunk in chunks:
                            state = step(state, chunk, *part_res)
                part = fold.finalize(state, pc, *part_res)
                out = part if out is None else fold.merge(out, part)
    finally:
        # after the build stager was joined: no upload reads them now
        for prt in build_parts + probe_parts:
            if prt is not None:
                prt.drop()
    return out


def _run_fold(fold, pc: PagedColumns, resident) -> Any:
    """A fold over a paged relation, by what its resident inputs are.

    A paged resident the fold can merge partitions of (``merge``, and a
    ``build_key`` it holds when the fold declares one) is the build
    side: with a ``probe_key`` and more than one page it takes the
    one-pass grace hash; otherwise the build side's chunks loop outside
    and the probe streams once per chunk. Every other paged resident is
    assembled on the device once (replayed from the device cache by warm
    requests) — no step computes on the CPU."""
    builds = [i for i, v in enumerate(resident)
              if isinstance(v, PagedColumns)]
    bi, keyed = None, False
    if builds and fold.merge is not None:
        if fold.build_key is not None:
            # the merge is only right for partitions of the declared key's
            # side (q02's winner merge is wrong for partitions of supplier)
            for i in builds:
                if fold.build_key in (resident[i].int_names
                                      + resident[i].float_names):
                    bi, keyed = i, True
                    break
        else:
            bi = builds[0]
    rest = [v.assembled() if isinstance(v, PagedColumns) and i != bi else v
            for i, v in enumerate(resident)]
    if bi is None:
        return _run_fold_once(fold, pc, tuple(rest))
    build_pc = resident[bi]
    if keyed and fold.probe_key is not None and build_pc.num_pages() > 1:
        return _run_fold_grace(fold, pc, rest, bi, build_pc)
    out = None
    with contextlib.closing(build_pc.stream_tables()) as btabs:
        for btab in btabs:
            rest[bi] = btab
            part = _run_fold_once(fold, pc, tuple(rest))
            out = part if out is None else fold.merge(out, part)
    return out


def _label(node) -> str:
    return getattr(node, "label", node.op_kind)


def _consumes_records(node: Computation) -> bool:
    """Whether ``node`` iterates its inputs' records (and so must close
    a paged record stream it does not finish)."""
    return (isinstance(node, (Filter, MultiApply))
            or (isinstance(node, Join) and node.fn is None)
            or (isinstance(node, Aggregate) and node.fn is None)
            or (isinstance(node, Partition)
                and not isinstance(node.key_fn, str)))


def _eval_node(node: Computation, in_vals: List[Any], device) -> Any:
    """``node.evaluate``, with each :class:`PagedObjects` input of a
    record-consuming node handed over as a stream under
    ``contextlib.closing``: the stream holds the set's read lock, and it
    is closed when the node returns or raises, whatever the node's
    frames or traceback still reference (an open stream blocks drops)."""
    kw = {"device": device} if isinstance(node, Join) else {}
    if not _consumes_records(node) or not any(
            isinstance(v, PagedObjects) for v in in_vals):
        return node.evaluate(*in_vals, **kw)
    with contextlib.ExitStack() as stack:
        safe = [stack.enter_context(contextlib.closing(iter(v)))
                if isinstance(v, PagedObjects) else v for v in in_vals]
        return node.evaluate(*safe, **kw)


def _evaluate(plan: LogicalPlan, scan_values: Dict[int, Any],
              device=None) -> Dict[int, Any]:
    """Replay the DAG in topo order; a shared subgraph runs once. A node
    whose fold streams a paged relation folds over its chunks; a node
    that consumes a paged tensor streams it through its tensor fold; a
    paged relation reaching any other consumer is assembled once; a
    paged record set reaches its consumers as its handle."""
    values: Dict[int, Any] = dict(scan_values)
    assembled: Dict[int, ColumnTable] = {}

    def demote(v):
        if isinstance(v, PagedColumns):
            if id(v) not in assembled:
                assembled[id(v)] = v.assembled()
            return assembled[id(v)]
        if isinstance(v, tuple):
            return tuple(demote(x) for x in v)
        return v

    for node in plan.topo:
        if node.node_id in values:
            continue
        in_vals = [values[i.node_id] for i in node.inputs]
        fold, src = getattr(node, "fold", None), getattr(node, "fold_src", 0)
        if fold is not None and isinstance(in_vals[src], PagedColumns):
            resident = flatten_resident(tuple(
                v for i, v in enumerate(in_vals) if i != src))
            values[node.node_id] = _run_fold(fold, in_vals[src], resident)
            continue
        if getattr(node, "passthrough", False):
            values[node.node_id] = _eval_node(node, in_vals, device)
            continue
        in_vals = [demote(v) for v in in_vals]
        paged = [i for i, v in enumerate(in_vals) if _has_paged(v)]
        if paged:
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
        values[node.node_id] = _eval_node(node, in_vals, device)
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
                handle = store.paged_objects(ident)
                if handle is None:
                    handle = store.paged_relation(ident)
                scan_values[node.node_id] = (
                    handle if handle is not None
                    else store.paged_tensor(ident))
                continue
            items = store.get_items(ident)
            # a one-tensor or one-table set's value is the item itself;
            # any other set, and a set of a list-scan type (tensor4d)
            # whatever it holds, is scanned as its item list
            single = len(items) == 1 and isinstance(
                items[0], (BlockedTensor, torch.Tensor, ShardedTensor,
                           ColumnTable)) \
                and not store.scans_as_list(ident)
            scan_values[node.node_id] = items[0] if single else items
    with torch.inference_mode():
        values = _evaluate(plan, scan_values, client.device)

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
            if isinstance(out, (torch.Tensor, ShardedTensor, ColumnTable)):
                # one tensor or relation IS the set's content (not its
                # rows)
                store.add_data(ident, [out])
            elif isinstance(out, dict):
                store.add_data(ident, list(out.items()))
            else:
                store.add_data(ident, list(out))
    return results
