"""Query executor — counterpart of ``netsdb_tpu/plan/executor.py``.

**The compiled-program cache.** The reference composes a resident
all-traceable DAG into one jitted program and caches it per job name and
plan shape (``executor.py:43-148``, ``:1186-1231``). Here the cache holds
:class:`~netsdb_tpu_torch.plan.programs.Program` s under the reference's
keys — ``{job}::{plan}`` for a whole plan, ``fold::`` for a fold's
per-chunk step, ``eager::`` for one traceable node of a streamed plan,
``region::`` for a fusion region — in an LRU of 64 programs, with the
reference's ``hits``/``misses``/``traces`` counters and the per-region
trace map (:func:`compile_stats`). On the card a program is a CUDA graph
per input signature, captured after one eager run and replayed after
that; on the CPU it is the composed eager callable and a trace is its
first build, so keys and counters behave the same on both. A program's
signature covers every input's shape, dtype and device, each scanned
set's identity and write version, and the values its callables close
over, so a second model of other shapes, a DAG with the same labels and
other constants, a rewritten set and an evicted and reloaded set each
get their own program (``programs.py`` says how; the reference keys on
job and plan shape alone). A write to a set drops the graphs that read
it. Training steps do not come here (a model's ``train_step`` runs as it
comes, as the reference's does).

**Which path a job takes.** A job whose sinks mix paged and resident
components splits into them first (the auto-split, reference
``:1101-1134``). A component that scans a paged set runs streamed
(:func:`_execute_streamed`): with ``config.plan_fusion`` (on by
default) the mapper of ``plan/fusion.py`` runs spine regions of resident
nodes as one program each and grafts rowwise pre-chains and epilogues
onto streamed folds; every fold step, rows-mode tensor-stream step and
remaining traceable node is a program of the cache (reduce-mode block
steps run as they come, :func:`_run_tensor_stream`). A component whose
scans are
all resident tensors or tables and whose nodes are all traceable
(:func:`_is_traceable`) runs as ONE program. Everything else runs node by
node (:func:`_evaluate`), which is also the baseline the compiled paths
are held to.

**Streams.** A scan of a paged tensor set gives a
:class:`~netsdb_tpu_torch.storage.paged.PagedTensor` handle: the node
that consumes it streams it through its :class:`~netsdb_tpu_torch.plan.
fold.TensorFold` (:func:`_run_tensor_stream`, reference ``:512-690``);
gather nodes (``passthrough``) forward it, and any other node raises
``ValueError`` naming ``tensor_fold``. A scan of a paged relation gives
its :class:`~netsdb_tpu_torch.relational.outofcore.PagedColumns`: a node
whose ``fold`` streams it runs init, a step per chunk and finalize per
pass (:func:`_run_fold`, reference ``:227-456``), its other inputs
resident; a paged build side takes the one-pass grace hash when the fold
declares its join keys and a merge, the per-block loop when it declares
only a merge, and otherwise is assembled once on the device. Any other
consumer gets the relation assembled on the device (from the device
cache on a warm request). A scan of a paged record set gives its
:class:`~netsdb_tpu_torch.storage.paged.PagedObjects`: host nodes that
consume records iterate it under ``contextlib.closing``
(:func:`_eval_node`). Steps never write a chunk (cached chunks belong to
the device cache); a fold step may update its state in place.

Sinks are materialised into their output sets; a program's outputs are
copies taken right after its replay, so a later request never rewrites
an earlier result.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from netsdb_tpu_torch import obs
from netsdb_tpu_torch.core.blocked import BlockedTensor, BlockMeta
from netsdb_tpu_torch.parallel import placed_ops
from netsdb_tpu_torch.parallel.mesh import ShardedTensor, visible_devices
from netsdb_tpu_torch.parallel.placement import is_placed_table
from netsdb_tpu_torch.plan import fusion, programs, staging
from netsdb_tpu_torch.plan.computations import (Aggregate, Apply,
                                                Computation, Filter, Join,
                                                MultiApply, Partition,
                                                ScanSet, WriteSet)
from netsdb_tpu_torch.plan.fold import flatten_resident
from netsdb_tpu_torch.plan.planner import LogicalPlan, plan_from_sinks
from netsdb_tpu_torch.relational.outofcore import (PagedColumns,
                                                   partition_by_key)
from netsdb_tpu_torch.relational.table import ColumnTable
from netsdb_tpu_torch.storage import store as _store
from netsdb_tpu_torch.storage.paged import PagedObjects, PagedTensor
from netsdb_tpu_torch.storage.store import SetIdentifier

# --- the compiled-program cache ------------------------------------------

_COMPILED_CACHE_CAP = 64
_compiled_cache: "collections.OrderedDict[str, programs.Program]" = \
    collections.OrderedDict()
_cache_lock = threading.Lock()
# "traces" counts program builds (one per new input signature of any
# cached program); with bucketed chunk shapes it stays flat across
# ragged tails
_compile_stats = {"hits": 0, "misses": 0, "traces": 0}
# "job:fingerprint" of a fusion region → builds of its program
_REGION_TRACES_CAP = 1024
_region_traces: Dict[str, int] = {}


def compile_stats() -> Dict[str, Any]:
    """The cache's ``hits``/``misses`` (lookups), ``traces`` (program
    builds) and the per-fusion-region build map ``region_traces``."""
    with _cache_lock:
        out: Dict[str, Any] = dict(_compile_stats)
        out["region_traces"] = dict(_region_traces)
        return out


obs.REGISTRY.register_collector("compile", compile_stats)
obs.REGISTRY.register_collector("programs", programs.program_stats)


def compiled_cache_keys() -> List[str]:
    """The cache's keys, least recently used first."""
    with _cache_lock:
        return list(_compiled_cache)


def clear_compiled_cache() -> None:
    """Drop every program (and its graphs) and the region trace map."""
    with _cache_lock:
        _compiled_cache.clear()
        _region_traces.clear()


def cached_programs() -> List[programs.Program]:
    with _cache_lock:
        return list(_compiled_cache.values())


def _cached_program(key: str, region: Optional[str] = None,
                    stream: bool = False,
                    ref_args: Sequence[int] = ()) -> programs.Program:
    """Get or insert the program under ``key`` (the one LRU discipline of
    every call site). ``region`` names the fusion region it runs
    (``"job:fingerprint"``), whose builds also tick ``region_traces``;
    ``stream`` and ``ref_args`` are
    :class:`~netsdb_tpu_torch.plan.programs.Program`'s."""
    with _cache_lock:
        prog = _compiled_cache.get(key)
        if prog is not None:
            _compiled_cache.move_to_end(key)
            _compile_stats["hits"] += 1
            return prog

    def traced():
        with _cache_lock:
            _compile_stats["traces"] += 1
            if region is not None:
                _region_traces[region] = _region_traces.get(region, 0) + 1
                while len(_region_traces) > _REGION_TRACES_CAP:
                    _region_traces.pop(next(iter(_region_traces)))
        obs.add("executor.traces")
        obs.operators.op_add("traces")

    prog = programs.Program(key, traced, stream=stream, ref_args=ref_args)
    with _cache_lock:
        _compile_stats["misses"] += 1
        prog = _compiled_cache.setdefault(key, prog)
        _compiled_cache.move_to_end(key)
        while len(_compiled_cache) > _COMPILED_CACHE_CAP:
            _compiled_cache.popitem(last=False)
    return prog


def run_program(key: str, fn: Callable, *args, **kw) -> Any:
    """``fn(*args)`` through the cached program ``key``, its variant
    chosen by the arguments and by what ``fn`` closes over — the entry for
    callers outside a DAG (``compile_pdml``, ``LSTMModel.run_sequence``);
    ``kw`` are :func:`_cached_program`'s."""
    return _bound(_cached_program(key, **kw), fn)(*args)


def _bound(prog: programs.Program, fn: Callable,
           fns: Optional[Sequence[Callable]] = None) -> Callable:
    """``prog`` called with ``fn``, the closure of ``fns`` (default
    ``[fn]``: what ``fn`` runs) taken once."""
    keep: List[Any] = []
    tok = programs.closure_token(fns if fns is not None else [fn], keep)
    return lambda *a: prog(fn, *a, closure=tok, keep=keep)


def _invalidate_set(ident: str) -> None:
    for prog in cached_programs():
        prog.invalidate(ident)


_store.on_set_write(_invalidate_set)


# --- node kinds ------------------------------------------------------------

def _is_traceable(node: Computation) -> bool:
    """Host-object nodes stay out of programs: predicate filters and
    key-function joins and group-bys over records."""
    if isinstance(node, Filter):
        return False
    if isinstance(node, Join) and node.fn is None:
        return False
    if isinstance(node, Aggregate) and node.fn is None:
        return False
    return getattr(node, "traceable", True)


def _program_safe_values(vals) -> bool:
    """True when every value is a tensor, blocked tensor or table (or a
    gather tuple of them) — what a program takes as input."""
    def ok(v) -> bool:
        if isinstance(v, tuple):
            return all(ok(x) for x in v)
        return isinstance(v, (ColumnTable, BlockedTensor, torch.Tensor,
                              ShardedTensor))
    return all(ok(v) for v in vals)


def _has_placed(value: Any) -> bool:
    """A placed relation (row-sharded or replicated over a mesh), also
    inside a gather tuple."""
    if isinstance(value, tuple):
        return any(_has_placed(v) for v in value)
    return is_placed_table(value)


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


# --- streams ---------------------------------------------------------------

def _assembled(pc: PagedColumns) -> ColumnTable:
    """``pc`` assembled on the device (from the device cache when warm);
    a store-owned relation's table is tagged resident, so programs read
    it in place and a write to the set drops them."""
    table = pc.assembled()
    if pc.cache_scope is not None and pc.cache_version_fn is not None:
        programs.tag_resident(table, programs.ResidentTag(
            pc.program_scope or str(pc.cache_scope),
            pc.cache_version_fn()))
    return table


def _summa_tensor_route(tfold, pt: PagedTensor, others) -> Any:
    """The ``config.distributed_matmul`` plan leg (reference
    ``executor._summa_tensor_route``): a rows-mode node whose
    :class:`~netsdb_tpu_torch.plan.fold.TensorFold` declares
    ``summa_rhs`` (``fn(block, *others) == block @ summa_rhs(*others)``)
    skips the per-block loop; ``PagedTensorStore.matmul_streamed`` — the
    one place the routing is decided — runs it through SUMMA (each
    participant staging only its panel of the paged operand), or through
    the single-position stream with fewer than 2 participants. Returns
    the assembled BlockedTensor, or None when the route does not apply
    (knob off, no declaration, or a declared RHS that does not fit)."""
    rhs_fn = getattr(tfold, "summa_rhs", None)
    if rhs_fn is None or not pt.store.config.distributed_matmul:
        return None
    rhs = rhs_fn(*others)
    if rhs is None:
        return None
    rhs = rhs.to_dense() if isinstance(rhs, BlockedTensor) else \
        torch.as_tensor(rhs)
    (_rows, k), _blk, _dtype = pt.store.meta(pt.name)
    if rhs.dim() != 2 or rhs.shape[0] != k:
        return None  # the declaration does not fit these inputs
    cache, scope = pt.devcache, pt.cache_scope
    stats: Dict[str, Any] = {}
    with obs.span("executor.tensor_summa", "executor") as sp, pt.rw.read():
        dense = pt.store.matmul_streamed(
            pt.name, rhs, device=pt.device, devcache=cache,
            cache_scope=None if scope is None else str(scope[0]),
            cache_version=None if scope is None else scope[1],
            stats_out=stats)
        if sp is not None:
            sp.counters["summa.participants"] = stats.get("participants", 0)
            sp.counters["summa.rounds"] = stats.get("rounds", 0)
    obs.operators.op_add("summa.participants", stats.get("participants", 0))
    obs.operators.op_add("summa.rounds", stats.get("rounds", 0))
    _account_chunks(stats.get("rounds", 0), scope)
    if tfold.out_block is not None:
        return _reblock(dense, tfold.out_block)
    return _reblock(dense, tuple(dense.shape))


def _account_chunks(n: int, scope) -> None:
    """Book a paged tensor's blocks (or SUMMA rounds) as
    ``executor.chunks`` of its set (``scope``: the handle's (set,
    version) cache scope, or None)."""
    obs.attrib.account("executor.chunks", n,
                       scope=None if scope is None else str(scope[0]))


def _run_tensor_stream(node, tfold, in_vals: List[Any], src: int,
                       step_jit=None) -> Any:
    """Stream the paged tensor ``in_vals[src]`` through ``node``: only the
    current block, the staged next blocks, the node's other inputs and
    the output are on the device; the next block's upload runs while
    the current one computes (:mod:`~netsdb_tpu_torch.plan.staging`). A
    warm query replays the blocks from the device cache.

    Rows mode: ``fn`` runs once per row block (the block in place of the
    paged input); each block pads to its row bucket (zero rows, sliced
    off the output), its output rows are copied into the result as they
    come and the result is re-blocked to ``out_block``. Reduce mode: blocks are contraction slices, never
    padded; ``partial`` accumulates into its carry in place and
    ``finalize`` applies the epilogue. A placed paged set applies its
    placement to each staged block. Cached blocks are never written.
    ``step_jit(pidx, step, fns)`` gives a rows-mode block step its
    program (None: the step runs as it comes). Reduce steps always run as
    they come: ``partial`` slices its other inputs at the block's host
    offset, so every block would be a signature of its own, and its graph
    would hold a static copy of that block — the whole paged set in graph
    memory."""
    pt: PagedTensor = in_vals[src]
    others = [v for i, v in enumerate(in_vals) if i != src]
    if tfold.mode == "rows":
        routed = _summa_tensor_route(tfold, pt, others)
        if routed is not None:
            return routed
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

        def step(block, *os):
            shape = tuple(block.shape)
            args = list(os)
            args.insert(src, BlockedTensor(block, BlockMeta(shape, shape)))
            return node.fn(*args)

        jstep = (step_jit(0, step, fns=[node.fn])
                 if step_jit is not None else step)
        total = pt.store.meta(pt.name)[0][0]
        dense, blocked, off = None, False, 0
        clock = obs.DeviceClock(pt.device)
        nblk = 0
        with obs.span("executor.tensor_rows", "executor") as sp, \
                stream(place) as blocks:
            for n, block in blocks:
                mark = clock.start()
                out = jstep(block, *others)
                clock.stop(mark)
                nblk += 1
                if isinstance(out, BlockedTensor):
                    blocked = True
                    out = out.to_dense()
                # a placed block's product: the output rows are assembled
                # on one device (a replicated product moves nothing)
                out = placed_ops.whole(out, f"tensor stream:{node.label}",
                                       "the stream assembles its rows on "
                                       "one device")
                if dense is None:
                    dense = out.new_empty((total,) + tuple(out.shape[1:]))
                # before the next step: a program's output is its graph's
                dense[off:off + n].copy_(out[:n])
                off += n
            if sp is not None:
                sp.counters["blocks"] = nblk
            clock.commit(sp)
        _account_chunks(nblk, scope)
        if tfold.out_block is not None:
            return _reblock(dense, tfold.out_block)
        return _reblock(dense, tuple(dense.shape)) if blocked else dense

    def place(item):
        start, block = item
        return start, upload(block)

    carry = None
    clock = obs.DeviceClock(pt.device)
    nblk = 0
    with obs.span("executor.tensor_reduce", "executor") as sp, \
            stream(place) as blocks:
        for start, block in blocks:
            mark = clock.start()
            carry = tfold.partial(carry, start, block, *others)
            clock.stop(mark)
            nblk += 1
        if sp is not None:
            sp.counters["blocks"] = nblk
        clock.commit(sp)
    _account_chunks(nblk, scope)
    if tfold.finalize is not None:
        return tfold.finalize(carry, *others)
    return carry


def _fold_steps(fold, step_jit):
    """The fold's passes with each step through its program (pass index
    ``pidx``; the state is carried, the chunk copied in)."""
    if step_jit is None:
        return list(fold.passes)
    return [(init, step_jit(pidx, step))
            for pidx, (init, step) in enumerate(fold.passes)]


def _run_fold_once(fold, pc: PagedColumns, resident, step_jit=None,
                   placed: bool = True) -> Any:
    """One (possibly multi-pass) fold over a paged relation's chunk
    stream: every pass re-streams the relation. Steps may update their
    own state in place and never write a chunk (cached chunks belong to
    the device cache). A placed relation (``placed`` and a placement on
    the set) streams placed chunks: each position's rows of a chunk are
    one step (``relational.sharded.step_placed``), the residents laid
    out per position, and finalize runs on the first position's."""
    from netsdb_tpu_torch.relational import sharded

    state = None
    placement = pc.placement() if placed else None
    views = None
    if placement is not None:
        views = sharded.position_residents(
            resident, placement.mesh(visible_devices(pc.device.type)))
    else:
        resident = sharded.gathered(resident)
    clock = obs.DeviceClock(pc.device)
    with obs.span("executor.fold_stream", "executor") as sp:
        n = 0
        for init, step in _fold_steps(fold, step_jit):
            state = init(state, pc, *(resident if views is None
                                      else views[0]))
            # closing: a step that raises releases the stream's read lock
            with contextlib.closing(
                    pc.stream_tables(placement=placement)) as chunks:
                for chunk in chunks:
                    mark = clock.start()
                    if views is None:
                        state = step(state, chunk, *resident)
                    else:
                        state = sharded.step_placed(step, state, chunk,
                                                    views)
                    clock.stop(mark)
                    n += 1
        if sp is not None:
            sp.counters["chunks"] = n
        clock.commit(sp)
    obs.operators.op_add("chunks", n)
    obs.attrib.account("executor.chunks", n, scope=pc.cache_scope)
    if views is None:
        return fold.finalize(state, pc, *resident)
    return fold.finalize(sharded.moved(state, pc.device), pc, *views[0])


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
                    build_pc: PagedColumns, step_jit=None) -> Any:
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

        passes = _fold_steps(fold, step_jit)
        # a partition without build rows can only miss
        pairs = (p for p in range(nparts) if build_parts[p] is not None)
        with obs.span("executor.grace_pairs", "executor") as gsp, \
                contextlib.closing(staging.stage_stream(
                    pairs, stage_build, depth,
                    name=f"grace-build:{build_pc.name}",
                    uploader=uploader)) as builds:
            npairs = nchunks = 0
            clock = obs.DeviceClock(pc.device)
            for p, btab in builds:
                part_res = list(rest)
                part_res[bi] = btab
                state = None
                for init, step in passes:
                    state = init(state, pc, *part_res)
                    if probe_parts[p] is None:
                        continue
                    # closing: a step that raises must release the
                    # partition's read lock before the drops below
                    with contextlib.closing(
                            _part_chunks(probe_parts[p])) as chunks:
                        for chunk in chunks:
                            mark = clock.start()
                            state = step(state, chunk, *part_res)
                            clock.stop(mark)
                            nchunks += 1
                part = fold.finalize(state, pc, *part_res)
                out = part if out is None else fold.merge(out, part)
                npairs += 1
            if gsp is not None:
                gsp.counters["pairs"] = npairs
                gsp.counters["chunks"] = nchunks
            clock.commit(gsp)
        obs.operators.op_add("chunks", nchunks)
        obs.operators.op_add("pairs", npairs)
        # a join-heavy client's chunks book like any other fold's
        obs.attrib.account("executor.chunks", nchunks, scope=pc.cache_scope)
    finally:
        # after the build stager was joined: no upload reads them now
        for prt in build_parts + probe_parts:
            if prt is not None:
                prt.drop()
    return out


def _run_fold(fold, pc: PagedColumns, resident, step_jit=None) -> Any:
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
    rest = [_assembled(v) if isinstance(v, PagedColumns) and i != bi else v
            for i, v in enumerate(resident)]
    if bi is None:
        return _run_fold_once(fold, pc, tuple(rest), step_jit)
    # a paged build side: the probe streams unplaced and placed residents
    # are gathered; a placed probe is a counted fallback
    from netsdb_tpu_torch.relational import sharded

    if pc.placement() is not None:
        sharded.note_fallback(f"fold over {pc.name}",
                              "a paged build side: the placed probe "
                              "streamed unplaced")
    rest = list(sharded.gathered(rest))
    build_pc = resident[bi]
    if keyed and fold.probe_key is not None and build_pc.num_pages() > 1:
        return _run_fold_grace(fold, pc, rest, bi, build_pc, step_jit)
    out = None
    with contextlib.closing(build_pc.stream_tables(placement=None)) as btabs:
        for btab in btabs:
            rest[bi] = btab
            part = _run_fold_once(fold, pc, tuple(rest), step_jit,
                                  placed=False)
            out = part if out is None else fold.merge(out, part)
    return out


# --- node-by-node evaluation -----------------------------------------------

class _Demoter:
    """Paged relations (also inside gather tuples) assembled on the
    device for consumers that do not stream them, once per request."""

    def __init__(self):
        self._done: Dict[int, ColumnTable] = {}

    def __call__(self, v):
        if isinstance(v, PagedColumns):
            if id(v) not in self._done:
                self._done[id(v)] = _assembled(v)
            return self._done[id(v)]
        if isinstance(v, tuple):
            return tuple(self(x) for x in v)
        return v


def _dispatch(node, in_vals: List[Any], device, demote: _Demoter,
              step_jit=None, node_program=None) -> Any:
    """One node over its input values: a fold over a paged relation, a
    tensor fold over a paged tensor, a gather that forwards handles, or
    ``evaluate`` (through ``node_program`` for a traceable fn over
    program-safe values, when given)."""
    fold, src = getattr(node, "fold", None), getattr(node, "fold_src", 0)
    if fold is not None and len(in_vals) > src \
            and isinstance(in_vals[src], PagedColumns):
        resident = flatten_resident(tuple(
            v for i, v in enumerate(in_vals) if i != src))
        return _run_fold(fold, in_vals[src], resident, step_jit)
    if getattr(node, "passthrough", False):
        return _eval_node(node, in_vals, device)
    in_vals = [demote(v) for v in in_vals]
    if any(_has_placed(v) for v in in_vals):
        from netsdb_tpu_torch.relational import sharded

        return sharded.dispatch_placed(node, in_vals, device, _eval_node)
    paged = [i for i, v in enumerate(in_vals) if _has_paged(v)]
    if paged:
        tfold = getattr(node, "tensor_fold", None)
        direct = [i for i in paged if isinstance(in_vals[i], PagedTensor)]
        if tfold is None or len(paged) > 1 or direct != paged:
            names = [in_vals[i].name if isinstance(in_vals[i], PagedTensor)
                     else f"input {i}" for i in paged]
            raise ValueError(
                f"node {_label(node)!r} consumes paged tensor set(s) "
                f"{names} but "
                + ("declares no tensor_fold" if tfold is None else
                   "only one input, given directly, may stream")
                + "; give the node a plan.fold.TensorFold, or store the "
                  "set with storage='memory'")
        return _run_tensor_stream(node, tfold, in_vals, paged[0], step_jit)
    fn = getattr(node, "fn", None)
    if (node_program is not None and fn is not None and _is_traceable(node)
            and isinstance(node, (Apply, Join, Aggregate))
            and _program_safe_values(in_vals)):
        return node_program(node, fn, in_vals)
    return _eval_node(node, in_vals, device)


def _evaluate(plan: LogicalPlan, scan_values: Dict[int, Any], device=None,
              recorder=None) -> Dict[int, Any]:
    """Replay the DAG node by node in topo order (a shared subgraph runs
    once), no program involved: folds and tensor folds stream their
    paged inputs step by step, other consumers of a paged relation get it
    assembled. ``recorder`` (an :class:`~netsdb_tpu_torch.obs.operators.
    OperatorRecorder`) times each node into the EXPLAIN tree."""
    values: Dict[int, Any] = dict(scan_values)
    demote = _Demoter()
    base = recorder.reserve(len(plan.topo)) if recorder is not None else 0
    if recorder is not None:
        recorder.mode = "eager" if base == 0 else "mixed"
    pos = {n.node_id: base + i for i, n in enumerate(plan.topo)}
    for node in plan.topo:
        if node.node_id in values:
            if recorder is not None:
                opr = recorder.node(pos[node.node_id], node,
                                    [pos[i.node_id] for i in node.inputs])
                opr.rows_out = obs.operators.rows_of(values[node.node_id])
            continue
        in_vals = [values[i.node_id] for i in node.inputs]
        if recorder is None:
            values[node.node_id] = _dispatch(node, in_vals, device, demote)
            continue
        with recorder.op(pos[node.node_id], node,
                         [pos[i.node_id] for i in node.inputs],
                         in_vals) as opr:
            out = _dispatch(node, in_vals, device, demote)
            opr.rows_out = obs.operators.rows_of(out)
        values[node.node_id] = out
    return values


# --- the streamed path with fusion regions -----------------------------------

def _execute_streamed(client, plan: LogicalPlan,
                      scan_values: Dict[int, Any],
                      job_name: str) -> Dict[int, Any]:
    """Topo-evaluate a plan with paged scans (reference ``:693-1050``):
    fold and tensor-fold consumers stream their paged inputs with each
    step a cached program; spine regions run as one program each, graft
    regions run their pre-chain inside the fold's step and their
    epilogue as one program over its output; other traceable nodes over
    program-safe values are ``eager::`` programs. ``plan_fusion=False``
    takes the per-node paths with the same keys."""
    device = client.device
    cfg = client.store.config
    plan_key = plan.cache_key()
    # nodes are keyed by topo POSITION: two fold nodes sharing a label in
    # one plan never share a program
    topo_pos = {n.node_id: i for i, n in enumerate(plan.topo)}
    regions = None
    graft_at: Dict[int, Any] = {}
    consumers: Dict[int, Any] = {}
    if cfg.plan_fusion:
        consumers = plan.consumers()
        rmap = fusion.map_regions(plan, scan_values, cfg, job_name,
                                  traceable=_is_traceable,
                                  consumers=consumers)
        if rmap.regions:
            regions = rmap
            graft_at = {r.anchor: r for r in rmap.regions
                        if r.kind == "graft"}
    node_by_id = {n.node_id: n for n in plan.topo}
    skip = set(regions.fused_away) if regions is not None else set()
    values: Dict[int, Any] = dict(scan_values)
    demote = _Demoter()

    def step_jit_for(node, fz: str = ""):
        # ``fz``: the graft region's fingerprint when the fold's steps
        # carry a fused pre-chain — a different program from the bare
        # fold's
        def step_jit(pidx, step, fns=None):
            key = (f"fold::{job_name}::{plan_key}::"
                   f"n{topo_pos[node.node_id]}::{node.label}::{pidx}{fz}")
            return _bound(_cached_program(key, stream=True), step, fns)
        return step_jit

    def node_program(node, fn, in_vals):
        key = f"eager::{job_name}::{plan_key}::n{topo_pos[node.node_id]}"
        return _bound(_cached_program(key), fn)(*in_vals)

    def graft_epilogue(greg, out):
        """A graft region's downstream chain over the fold's merged output
        as ONE program (values a program cannot take run the chain as it
        comes: a counted fallback)."""
        if greg is None or not greg.post_ids:
            return out
        chain = fusion.compose_chain(
            [node_by_id[i].fn for i in greg.post_ids])
        if not _program_safe_values([out]):
            fusion.fallback("graft epilogue input not program-safe")
            return chain(out)
        key = (f"region::{job_name}::{plan_key}::r{greg.rid}"
               f"::{greg.fingerprint}::epi")
        prog = _cached_program(key, region=f"{job_name}:{greg.fingerprint}")
        return _bound(prog, chain,
                      [node_by_id[i].fn for i in greg.post_ids])(out)

    def dispatch(node, in_vals):
        """A node's streamed-path evaluation; a graft anchor's epilogue
        applies on every return path."""
        greg = graft_at.get(node.node_id)
        fold, src = getattr(node, "fold", None), getattr(node, "fold_src", 0)
        if greg is not None and greg.pre_ids:
            # the fused pre-chain was skipped: its paged scan handle takes
            # the chain's place, and the chunk transforms run in the step
            in_vals = list(in_vals)
            in_vals[src] = values[greg.stream_src]
            if fold is not None and isinstance(in_vals[src], PagedColumns):
                resident = flatten_resident(tuple(
                    v for i, v in enumerate(in_vals) if i != src))
                run_fold = fusion.wrap_fold_prechain(
                    fold, [node_by_id[i].fn for i in greg.pre_ids])
                return graft_epilogue(greg, _run_fold(
                    run_fold, in_vals[src], resident,
                    step_jit_for(node, fz=f"::fz{greg.fingerprint}")))
        return graft_epilogue(greg, _dispatch(
            node, in_vals, device, demote, step_jit_for(node),
            node_program))

    recorder = obs.operators.current_recorder()
    op_base = recorder.reserve(len(plan.topo)) if recorder else 0
    if recorder is not None and op_base != 0:
        recorder.mode = "mixed"
    op_pos = {n.node_id: op_base + i for i, n in enumerate(plan.topo)}

    def run_spine(reg) -> bool:
        """One spine region as ONE program; False when its inputs are not
        program-safe (a counted fallback: the caller runs its nodes one
        by one)."""
        nodes = [node_by_id[i] for i in reg.node_ids]
        rset = set(reg.node_ids)
        in_ids: List[int] = []
        for n in nodes:
            for i in n.inputs:
                if i.node_id not in rset and i.node_id not in in_ids:
                    in_ids.append(i.node_id)
        args = [values[i] for i in in_ids]
        if not _program_safe_values(args):
            fusion.fallback("spine inputs not program-safe")
            return False
        if any(_has_placed(a) for a in args):
            # placed relations run node by node (per position or by
            # their fold, relational/sharded.dispatch_placed)
            fusion.fallback("spine inputs placed over a mesh")
            return False
        out_ids = [nid for nid in reg.node_ids
                   if not consumers.get(nid)
                   or any(c.node_id not in rset
                          for c in consumers.get(nid, ()))]

        def region_fn(*fargs, _nodes=tuple(nodes), _in=tuple(in_ids),
                      _out=tuple(out_ids)):
            vals = dict(zip(_in, fargs))
            for n in _nodes:
                vals[n.node_id] = n.evaluate(
                    *[vals[i.node_id] for i in n.inputs])
            return tuple(vals[o] for o in _out)

        key = (f"region::{job_name}::{plan_key}::r{reg.rid}"
               f"::{reg.fingerprint}")
        prog = _bound(_cached_program(
            key, region=f"{job_name}:{reg.fingerprint}"), region_fn,
            [n.fn for n in nodes])
        tail = nodes[-1]
        ctx = (recorder.op(op_pos[tail.node_id], tail,
                           [op_pos[i.node_id] for i in tail.inputs], args)
               if recorder is not None else contextlib.nullcontext())
        with obs.span("executor.fusion_region", "executor") as sp, \
                ctx as opr:
            clock = obs.DeviceClock(device)
            mark = clock.start()
            outs = prog(*args)
            clock.stop(mark)
            clock.commit(sp)
            if sp is not None:
                sp.counters["nodes"] = len(nodes)
            if opr is not None:
                opr.add("region_nodes", len(nodes))
        for nid, v in zip(out_ids, outs):
            values[nid] = v
        if recorder is not None:
            for n in nodes:
                rec = recorder.node(op_pos[n.node_id], n,
                                    [op_pos[i.node_id] for i in n.inputs])
                rec.fused = True
                rec.region = reg.rid
                if n.node_id in values:
                    rec.rows_out = obs.operators.rows_of(values[n.node_id])
        return True

    for node in plan.topo:
        if node.node_id in skip:
            # inside a region (a spine's body, a graft's chains): only
            # registered, so the EXPLAIN tree keeps the plan's shape
            if recorder is not None:
                opr = recorder.node(op_pos[node.node_id], node,
                                    [op_pos[i.node_id] for i in node.inputs])
                opr.fused = True
                opr.region = regions.region_of(node.node_id)
                if node.node_id in values:
                    opr.rows_out = obs.operators.rows_of(
                        values[node.node_id])
            continue
        if node.node_id in values:
            if recorder is not None:
                opr = recorder.node(op_pos[node.node_id], node,
                                    [op_pos[i.node_id] for i in node.inputs])
                opr.rows_out = obs.operators.rows_of(values[node.node_id])
            continue
        sreg = (regions.spine_at.get(node.node_id)
                if regions is not None else None)
        if sreg is not None:
            if run_spine(sreg):
                continue
            skip.difference_update(sreg.node_ids)  # node by node
        # a fused-away input (a graft pre-chain member) has no value: the
        # dispatch substitutes the chain's paged scan
        in_vals = [values.get(i.node_id) if i.node_id in skip
                   else values[i.node_id] for i in node.inputs]
        greg = graft_at.get(node.node_id)
        if recorder is None:
            out_val = dispatch(node, in_vals)
        else:
            with recorder.op(op_pos[node.node_id], node,
                             [op_pos[i.node_id] for i in node.inputs],
                             in_vals) as opr:
                out_val = dispatch(node, in_vals)
                opr.rows_out = obs.operators.rows_of(out_val)
                if regions is not None:
                    rid = regions.region_of(node.node_id)
                    if rid is not None:
                        opr.region = rid
        values[node.node_id] = out_val
        if greg is not None and greg.post_ids:
            # the epilogue ran inside dispatch: the chain's tail carries it
            values[greg.post_ids[-1]] = out_val
    return values


# --- jobs ------------------------------------------------------------------

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


_TENSOR_ITEMS = (BlockedTensor, torch.Tensor, ShardedTensor, ColumnTable)


def scan_values(client, plan: LogicalPlan) -> Dict[int, Any]:
    """Each scan's value: a paged set's handle, a one-tensor or one-table
    set's item, any other set's (and a list-scan type's) item list."""
    store = client.store
    out: Dict[int, Any] = {}
    for node in plan.topo:
        if not isinstance(node, ScanSet):
            continue
        ident = SetIdentifier(node.db, node.set_name)
        if store.storage_of(ident) == "paged":
            handle = store.paged_objects(ident)
            if handle is None:
                handle = store.paged_relation(ident)
            out[node.node_id] = (handle if handle is not None
                                 else store.paged_tensor(ident))
            continue
        items = store.get_items(ident)
        single = (len(items) == 1 and isinstance(items[0], _TENSOR_ITEMS)
                  and not store.scans_as_list(ident))
        out[node.node_id] = items[0] if single else items
    return out


def _is_tensor_scan(value: Any) -> bool:
    """A scan value a program takes: one tensor, blocked tensor or table,
    or a list of tensors (a list-scan set such as the conv images)."""
    if isinstance(value, _TENSOR_ITEMS):
        return True
    return (isinstance(value, list) and bool(value)
            and all(isinstance(v, (BlockedTensor, torch.Tensor))
                    for v in value))


def execute_computations(client, sinks: List[WriteSet],
                         job_name: str = "job",
                         materialize: bool = True
                         ) -> Dict[SetIdentifier, Any]:
    """Plan and run; returns {output set ident: value} and (by default)
    materialises the results into the store — the reference's OUTPUT
    sets. The job is recorded node by node into an EXPLAIN tree when the
    query is traced or an ``obs.operators.explain_capture`` is active
    (an auto-split job records its components into one tree)."""
    with obs.operators.recording(job_name, client.store.config):
        return _execute_computations(client, sinks, job_name, materialize)


def _execute_computations(client, sinks: List[WriteSet], job_name: str,
                          materialize: bool) -> Dict[SetIdentifier, Any]:
    with obs.span("planner.plan", "planner"):
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
    scans = scan_values(client, plan)
    scan_nodes = [n for n in plan.topo if isinstance(n, ScanSet)]
    any_paged = any(isinstance(v, (PagedColumns, PagedTensor, PagedObjects))
                    for v in scans.values())
    tensor_scans = [n for n in scan_nodes if _is_tensor_scan(scans[n.node_id])]
    tags: Dict[int, programs.ResidentTag] = {}
    for n in tensor_scans:
        ident = SetIdentifier(n.db, n.set_name)
        for t in programs.tensor_leaves(scans[n.node_id]):
            tags[id(t)] = programs.ResidentTag(store.program_scope(ident),
                                               store.version_of(ident))
    recorder = obs.operators.current_recorder()
    with torch.inference_mode(), \
            programs.resident_tags(tags, list(scans.values())):
        if any_paged:
            with obs.span("executor.streamed", "executor"):
                values = _execute_streamed(client, plan, scans, job_name)
            sink_vals = {s.node_id: values[s.inputs[0].node_id]
                         for s in plan.sinks}
        elif (tensor_scans and len(tensor_scans) == len(scan_nodes)
              and all(_is_traceable(n) for n in plan.topo)):
            sink_vals = _run_whole_plan(client, plan, scans, job_name,
                                        recorder)
        else:
            with obs.span("executor.eager", "executor"):
                values = _evaluate(plan, scans, client.device, recorder)
            sink_vals = {s.node_id: values[s.inputs[0].node_id]
                         for s in plan.sinks}

    results: Dict[SetIdentifier, Any] = {}
    with obs.span("executor.materialize", "executor"):
        for sink in plan.sinks:
            out = sink_vals[sink.node_id]
            ident = SetIdentifier(sink.db, sink.set_name)
            results[ident] = out
            if not materialize:
                continue
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


def _run_whole_plan(client, plan: LogicalPlan, scans: Dict[int, Any],
                    job_name: str, recorder) -> Dict[int, Any]:
    """A resident, all-traceable component as ONE program keyed
    ``{job}::{plan}`` (reference ``:1188-1231``); its scanned sets are
    read in place, its outputs are copies."""
    canon = {n.node_id: i for i, n in enumerate(plan.topo)}
    device = client.device

    def run(tensor_args: Dict[int, Any], _plan=plan, _canon=canon):
        merged = {n.node_id: tensor_args[_canon[n.node_id]]
                  for n in _plan.topo if isinstance(n, ScanSet)}
        values = _evaluate(_plan, merged, device)
        return [values[s.inputs[0].node_id] for s in _plan.sinks]

    prog = _bound(_cached_program(f"{job_name}::{plan.cache_key()}"), run,
                  [getattr(n, "fn", None) for n in plan.topo
                   if not isinstance(n, (ScanSet, WriteSet))])
    args = {canon[nid]: v for nid, v in scans.items()}
    with obs.span("executor.whole_plan_jit", "executor") as sp:
        clock = obs.DeviceClock(device)
        t0 = time.perf_counter()
        mark = clock.start()
        out_list = prog(args)
        clock.stop(mark)
        wall = time.perf_counter() - t0
        if sp is not None:
            sp.counters["wall_s"] = wall
        clock.commit(sp)
    if recorder is not None:
        # one program ran every node: the tree keeps the plan's shape,
        # nodes marked fused, under one root with the program's time
        recorder.mark_fused(plan.topo, wall, wall)
    return {s.node_id: out_list[i] for i, s in enumerate(plan.sinks)}
