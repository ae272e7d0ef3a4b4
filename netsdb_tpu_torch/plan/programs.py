"""Compiled programs — the port's counterpart of one jitted XLA program.

A :class:`Program` is what the executor's compiled-program cache holds
under one key (``plan/executor._cached_program``). It is called with the
callable to run and its arguments; like a jitted function it keeps one
*variant* per input signature, and a new signature is one **trace**:

* on the card a variant is a ``torch.cuda.CUDAGraph``. The first call of
  a signature runs the callable eagerly on the capture stream (that run
  answers the call), then captures it; later calls copy their transient
  inputs into the graph's static inputs and replay it. Every launch the
  callable makes (kernels of cuBLAS, of torch, and the hand-written
  kernels B1 and B2) is then one graph launch;
* on the CPU a variant is the callable itself, run as it comes: there is
  nothing to capture, but keys, signatures and counters behave as on the
  card, so the CPU tests hold them.

**What a signature holds.** A capture bakes in input addresses and every
host decision made while it ran, so a signature covers everything the
callable could have read:

* the arguments' structure and, per tensor, shape, stride, dtype and
  device; Python scalars and ``ColumnTable`` dictionaries by value; a
  ``BlockedTensor``'s block shape;
* every tensor the request scanned from a set, and every relation
  assembled from a paged set, by its set and that set's write version
  (:func:`resident_tags`), and on the card its address: the graph reads
  it in place, never a copy, and the variant holds it. A write,
  ``update_columns``, an eviction or ``remove_set`` of the set drops
  every variant that read it (:meth:`Program.invalidate`), which
  releases the tensor; the next request captures again;
* the values the callables close over (:func:`closure_token`): a second
  DAG with the same labels and other constants is another variant, never
  a stale replay.

Every other tensor input (an intermediate of the request, a fold's
carried state, a streamed chunk) is copied into the graph's static input
before each replay.

**Outputs.** A replay overwrites the graph's output buffers, so every
replay clones its outputs before it lets go of the graph: callers that
replay one graph at once (a daemon's handler threads running the same
fold) take turns from the input copies to the output clones, and none
sees another's state. A *stream* program (a per-chunk step: its
argument 0, a fold's carried state, is copied in like a chunk) captures
a signature from the second request that calls it on: the first request
runs its steps eagerly, so a cold stream, whose memory is bounded by its
chunks, holds no graph's copies of its state and chunk.

**What is not captured.** The first run is watched for host
synchronisations (``torch.cuda.set_sync_debug_mode``): a callable that
syncs (``.item()``, ``.cpu()``, boolean indexing, ``nonzero``) cannot be
replayed, so that variant stays eager and the fallback is counted with
its reason (``fusion.fallbacks``, :func:`fallback_log`). So do inputs a
graph cannot hold (host objects) and a capture that fails; a failed
capture is discarded and the stream stays usable. The sync debug mode
and the warning hook are the process's, so one build (first run and
capture) runs at a time. A placed set's
``ShardedTensor`` is flattened into its distinct shard tensors (on one
card, the ring's positions are virtual and their copies stay on it). A
validity check that must read a value on the host
(an id range, a singular matrix) is deferred instead
(``ops.common.defer_check``): the program clamps, and the check runs
after the run and after every replay.

Each graph keeps its own private memory pool (no pool is shared, so
replays in any order are safe); :func:`program_stats` reports the bytes
reserved while capturing, and the live pools together stay under
:data:`GRAPH_POOL_BUDGET_BYTES` (the least recently replayed graphs are
dropped past it).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import itertools
import os
import sys
import threading
import traceback
import types
import warnings
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from netsdb_tpu_torch.core.blocked import BlockedTensor
from netsdb_tpu_torch.ops.common import deferring
from netsdb_tpu_torch.parallel.mesh import ShardedTensor
from netsdb_tpu_torch.relational.table import ColumnTable

#: variants one program keeps (least recently used dropped first)
VARIANTS_PER_PROGRAM = 16

_stats_lock = threading.Lock()
_stats = {"captures": 0, "replays": 0, "eager_runs": 0,
          "capture_bytes": 0}
# the hand-written kernels' launches recorded into captured graphs
_captured: "collections.Counter[str]" = collections.Counter()
_fallbacks: "collections.OrderedDict[str, Dict[str, Any]]" = \
    collections.OrderedDict()
_FALLBACK_LOG_CAP = 256


def program_stats() -> Dict[str, Any]:
    """Captures, replays, eager runs of variants that stay eager, the
    bytes reserved while capturing (the graphs' pools) and the launches of
    the hand-written kernels recorded into the captured graphs, by
    wrapper (``captured_launches``: what one replay of them launches),
    since the last :func:`reset_program_stats`."""
    with _stats_lock:
        return dict(_stats, captured_launches=dict(_captured))


def fallback_log() -> List[Dict[str, Any]]:
    """Every program key whose variant stayed eager, with the reason and
    how often it ran eagerly since (oldest first)."""
    with _stats_lock:
        return [dict(v, key=k) for k, v in _fallbacks.items()]


def reset_program_stats() -> None:
    with _stats_lock:
        for k in _stats:
            _stats[k] = 0
        _fallbacks.clear()
        _captured.clear()


def _tick(name: str, n: int = 1) -> None:
    with _stats_lock:
        _stats[name] += n


# --- resident tags (set, version) of the request's scanned tensors ------

_tags = threading.local()


@dataclasses.dataclass(frozen=True)
class ResidentTag:
    """The set a scanned tensor belongs to and its write version."""

    ident: str
    version: int


_requests = itertools.count(1)


class resident_tags:
    """Context of one request: ``tags`` maps ``id(tensor)`` of every
    tensor a scan gave to its :class:`ResidentTag`; programs called in the
    context read those tensors where they lie, keyed by their set.
    ``serial`` numbers the request (a stream program captures from its
    second request on)."""

    def __init__(self, tags: Dict[int, ResidentTag], keep: Sequence[Any]):
        self.tags = tags
        self.keep = list(keep)  # the ids stay valid while in context
        self.serial = next(_requests)
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_tags, "ctx", None)
        _tags.ctx = self
        return self

    def __exit__(self, *exc):
        _tags.ctx = self._prev


def tag_resident(value: Any, tag: ResidentTag) -> Any:
    """Add ``value``'s tensors (a relation assembled from a set and kept
    by the device cache) to the request's resident tags; returns
    ``value``."""
    ctx = getattr(_tags, "ctx", None)
    if ctx is not None:
        for t in tensor_leaves(value):
            ctx.tags[id(t)] = tag
        ctx.keep.append(value)
    return value


def tensor_leaves(value: Any) -> List[torch.Tensor]:
    leaves: List[torch.Tensor] = []
    _flatten(value, leaves)
    return leaves


# --- flattening --------------------------------------------------------

def _flatten(x: Any, leaves: List[torch.Tensor]) -> Any:
    """Append ``x``'s tensors to ``leaves``; return its hashable treedef
    (scalars and dictionaries by value, other objects by identity)."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return "T"
    if isinstance(x, BlockedTensor):
        if not isinstance(x.data, torch.Tensor):  # a placed, sharded one
            return ("PBT", x.meta, _flatten(x.data, leaves))
        leaves.append(x.data)
        return ("BT", x.meta)
    if isinstance(x, ShardedTensor):
        # each distinct shard tensor once, positions mapped onto them
        slots: Dict[int, int] = {}
        index = []
        for t in x.shards.flat:
            if id(t) not in slots:
                slots[id(t)] = len(slots)
                leaves.append(t)
            index.append(slots[id(t)])
        return ("ST", _Mesh(x.mesh), x.spec, x.shape, tuple(index))
    if isinstance(x, ColumnTable):
        names = tuple(x.cols)
        if any(isinstance(x.cols[n], ShardedTensor) for n in names):
            # a placed relation: each column (and the mask) as its shards
            return ("PCT", names, _Dicts(x.dicts),
                    tuple(_flatten(x.cols[n], leaves) for n in names),
                    None if x.valid is None else _flatten(x.valid, leaves))
        leaves.extend(x.cols[n] for n in names)
        if x.valid is not None:
            leaves.append(x.valid)
        return ("CT", names, _Dicts(x.dicts), x.valid is not None)
    if isinstance(x, tuple) and not hasattr(x, "_fields"):
        return ("tuple", tuple(_flatten(v, leaves) for v in x))
    if isinstance(x, tuple):  # a NamedTuple
        return ("nt", type(x), tuple(_flatten(v, leaves) for v in x))
    if isinstance(x, list):
        return ("list", tuple(_flatten(v, leaves) for v in x))
    if isinstance(x, dict):
        keys = tuple(x)
        return ("dict", keys, tuple(_flatten(x[k], leaves) for k in keys))
    if x is None or isinstance(x, (bool, int, float, str, bytes,
                                   torch.dtype, torch.device)):
        return ("c", type(x), x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        names = tuple(f.name for f in dataclasses.fields(x) if f.init)
        return ("dc", type(x), names,
                tuple(_flatten(getattr(x, n), leaves) for n in names))
    return ("o", type(x), id(x))  # a host object: no graph holds it


def _unflatten(tree: Any, it) -> Any:
    if tree == "T":
        return next(it)
    kind = tree[0]
    if kind == "BT":
        return BlockedTensor(next(it), tree[1])
    if kind == "PBT":
        return BlockedTensor(_unflatten(tree[2], it), tree[1])
    if kind == "CT":
        cols = {n: next(it) for n in tree[1]}
        valid = next(it) if tree[3] else None
        return ColumnTable(cols, tree[2].dicts, valid)
    if kind == "PCT":
        cols = {n: _unflatten(t, it) for n, t in zip(tree[1], tree[3])}
        valid = _unflatten(tree[4], it) if tree[4] is not None else None
        return ColumnTable(cols, tree[2].dicts, valid)
    if kind == "tuple":
        return tuple(_unflatten(t, it) for t in tree[1])
    if kind == "nt":
        return tree[1](*[_unflatten(t, it) for t in tree[2]])
    if kind == "list":
        return [_unflatten(t, it) for t in tree[1]]
    if kind == "dict":
        return {k: _unflatten(t, it) for k, t in zip(tree[1], tree[2])}
    if kind == "c":
        return tree[2]
    if kind == "dc":
        return tree[1](**{n: _unflatten(t, it)
                          for n, t in zip(tree[2], tree[3])})
    if kind == "ST":
        mesh = tree[1].mesh
        distinct = [next(it) for _ in range(max(tree[4]) + 1)]
        shards = np.empty(mesh.devices.shape, dtype=object)
        for flat, slot in enumerate(tree[4]):
            shards.flat[flat] = distinct[slot]
        out = ShardedTensor.__new__(ShardedTensor)
        out.mesh, out.spec, out.shape, out.shards = (mesh, tree[2], tree[3],
                                                     shards)
        return out
    raise TypeError("an opaque leaf has no static copy")


def _opaque_types(tree: Any) -> List[str]:
    """The type names of a treedef's opaque leaves."""
    if tree == "T" or not isinstance(tree, tuple):
        return []
    if tree[0] == "o":
        return [tree[1].__name__]
    out: List[str] = []
    for part in tree[1:]:
        if isinstance(part, tuple):
            for t in part:
                if isinstance(t, tuple):
                    out.extend(_opaque_types(t))
    return out


# dictionaries by content: each list hashed once per list object (the
# memo holds the list, so an id is never reused while it is memoised)
_LISTS: "collections.OrderedDict[int, Tuple[Any, Any]]" = \
    collections.OrderedDict()
_MEMO_CAP = 4096
_memo_lock = threading.Lock()


def _list_token(values) -> Any:
    with _memo_lock:
        hit = _LISTS.get(id(values))
        if hit is not None and hit[0] is values:
            _LISTS.move_to_end(id(values))
            return hit[1]
    tok = (len(values), hash(tuple(values)))
    with _memo_lock:
        _LISTS[id(values)] = (values, tok)
        while len(_LISTS) > _MEMO_CAP:
            _LISTS.popitem(last=False)
    return tok


class _Mesh:
    """A mesh in a treedef: equal by axes and positions' devices, and
    holding the mesh itself for the rebuilt sharded tensor."""

    __slots__ = ("mesh", "tok")

    def __init__(self, mesh):
        self.mesh = mesh
        self.tok = (mesh.axis_names, mesh.devices.shape,
                    tuple(str(d) for d in mesh.devices.flat))

    def __hash__(self):
        return hash(self.tok)

    def __eq__(self, other):
        return isinstance(other, _Mesh) and other.tok == self.tok


class _Dicts:
    """A table's dictionaries in a treedef: equal by content, and holding
    the dictionaries themselves for the rebuilt table."""

    __slots__ = ("dicts", "tok")

    def __init__(self, dicts: Dict[str, Any]):
        self.dicts = dicts
        self.tok = tuple((k, _list_token(v)) for k, v in dicts.items())

    def __hash__(self):
        return hash(self.tok)

    def __eq__(self, other):
        return isinstance(other, _Dicts) and other.tok == self.tok


# --- closure tokens ----------------------------------------------------

_MAX_DEPTH = 4

# equal code objects share one serial while any of them lives: a function
# shipped by value to a daemon arrives as a new code object with every
# request, and must find the variants its earlier copies captured
_code_serials: "weakref.WeakKeyDictionary[types.CodeType, int]" = \
    weakref.WeakKeyDictionary()
_code_seq = itertools.count()
_code_lock = threading.Lock()


def _code_serial(code: types.CodeType) -> int:
    with _code_lock:
        n = _code_serials.get(code)
        if n is None:
            n = _code_serials[code] = next(_code_seq)
        return n


def _code_names(code: types.CodeType, out: set) -> set:
    out.update(code.co_names)
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            _code_names(const, out)
    return out


def closure_token(fns: Sequence[Any], keep: List[Any]) -> Any:
    """A hashable token of everything ``fns`` close over: constants by
    value, tensors by identity (``keep`` holds them, so an identity is
    never reused while a variant keyed on it lives), functions by code
    (equal code objects alike), closure and defaults — and, for a
    function whose globals are not its module's (one shipped by value),
    by the globals its code names — objects by their attributes down to
    a small depth and by identity below it, and the relational engine's
    thresholds in force (``relational.tuning``), whose strategy choices a
    capture bakes in."""
    from netsdb_tpu_torch.relational import tuning

    return (tuple(_token(f, keep, 0, set()) for f in fns),
            tuning.state_token())


def _token(x: Any, keep: List[Any], depth: int, seen: set) -> Any:
    if x is None or isinstance(x, (bool, int, float, complex, str, bytes)):
        return x if not isinstance(x, float) else ("f", x)
    if isinstance(x, (torch.dtype, torch.device, type,
                      types.ModuleType)):
        return ("k", repr(x))
    if isinstance(x, torch.Tensor):
        keep.append(x)
        return ("t", id(x), tuple(x.shape), x.dtype)
    if id(x) in seen:
        return ("cycle",)
    seen = seen | {id(x)}
    if isinstance(x, np.ndarray):
        if x.nbytes <= 4096:
            return ("a", x.dtype.str, x.shape, x.tobytes())
        keep.append(x)
        return ("A", id(x))
    if isinstance(x, BlockedTensor):
        keep.append(x.data)
        return ("bt", x.meta, id(x.data))
    if isinstance(x, (tuple, list)):
        if len(x) > 64 and all(isinstance(v, str) for v in x[:8]):
            return ("L", _list_token(x))
        return (type(x).__name__,
                tuple(_token(v, keep, depth, seen) for v in x))
    if isinstance(x, dict):
        return ("d", tuple((repr(k), _token(v, keep, depth, seen))
                           for k, v in x.items()))
    if depth >= _MAX_DEPTH:
        keep.append(x)
        return ("id", type(x).__qualname__, id(x))
    if isinstance(x, types.FunctionType):
        code = x.__code__
        keep.append(code)
        cells = tuple(_cell(c, keep, depth + 1, seen)
                      for c in (x.__closure__ or ()))
        glob = None
        mod = sys.modules.get(x.__module__ or "")
        if mod is None or x.__globals__ is not vars(mod):
            g = x.__globals__
            glob = _token({n: g[n] for n in sorted(_code_names(code, set()))
                           if n in g}, keep, depth + 1, seen)
        return ("fn", _code_serial(code), code.co_filename, x.__qualname__,
                _token(x.__defaults__, keep, depth + 1, seen),
                _token(x.__kwdefaults__, keep, depth + 1, seen), cells, glob)
    if isinstance(x, types.MethodType):
        return ("m", _token(x.__func__, keep, depth, seen),
                _token(x.__self__, keep, depth + 1, seen))
    if isinstance(x, functools.partial):
        return ("p", _token(x.func, keep, depth + 1, seen),
                _token(x.args, keep, depth + 1, seen),
                _token(x.keywords, keep, depth + 1, seen))
    if isinstance(x, types.BuiltinFunctionType):
        return ("b", getattr(x, "__qualname__", repr(x)),
                _token(getattr(x, "__self__", None), keep, depth + 1, seen))
    attrs = getattr(x, "__dict__", None)
    if attrs is not None:
        return ("o", type(x).__qualname__,
                _token(attrs, keep, depth + 1, seen))
    if dataclasses.is_dataclass(x):
        return ("dc", type(x).__qualname__,
                tuple(_token(getattr(x, f.name), keep, depth + 1, seen)
                      for f in dataclasses.fields(x)))
    keep.append(x)
    return ("id", type(x).__qualname__, id(x))


def _cell(c, keep, depth, seen):
    try:
        v = c.cell_contents
    except ValueError:  # an empty cell (a name bound later)
        return ("empty",)
    return _token(v, keep, depth, seen)


# --- the graphs' memory --------------------------------------------------

#: the graph pools every program's variants may hold together: past it,
#: the least recently replayed graphs are dropped (their programs capture
#: again when next called)
GRAPH_POOL_BUDGET_BYTES = 16 << 30

_pools: "collections.OrderedDict[Tuple[int, Any], Tuple[Any, int]]" = \
    collections.OrderedDict()
_pools_lock = threading.Lock()


def graph_pool_bytes() -> int:
    """The bytes the live graphs' private pools reserved when captured."""
    with _pools_lock:
        return sum(n for ref, n in _pools.values() if ref() is not None)


def _pool_add(prog, sig, nbytes: int) -> None:
    new = (id(prog), sig)
    drop = []
    with _pools_lock:
        _pools[new] = (weakref.ref(prog), int(nbytes))
        for key in [k for k, (ref, _) in _pools.items() if ref() is None]:
            del _pools[key]
        total = sum(n for _, n in _pools.values())
        for key in list(_pools):
            if total <= GRAPH_POOL_BUDGET_BYTES:
                break
            if key == new:
                continue
            ref, n = _pools.pop(key)
            total -= n
            drop.append((ref(), key[1]))
    for live, old in drop:
        if live is not None:
            live.drop(old)


def _pool_forget(prog, sigs) -> None:
    with _pools_lock:
        for sig in sigs:
            _pools.pop((id(prog), sig), None)


def _pool_touch(prog, sig) -> None:
    with _pools_lock:
        key = (id(prog), sig)
        if key in _pools:
            _pools.move_to_end(key)


# --- launch counters of the hand-written kernels -----------------------

def _kernel_wrappers() -> List[Any]:
    from netsdb_tpu_torch.ops import cuda_kernels

    return [cuda_kernels.flash_attention, cuda_kernels.flash_attention_step]


# --- the capture stream -------------------------------------------------

_streams: Dict[int, torch.cuda.Stream] = {}


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    s = _streams.get(idx)
    if s is None:
        s = _streams[idx] = torch.cuda.Stream(device=idx)
    return s


_TORCH_DIR = os.path.dirname(torch.__file__)
_DEFAULT_SHOW_IMPL = warnings._showwarnmsg_impl


def _sync_site() -> str:
    """Where a host synchronisation came from: the innermost frame outside
    torch, and the torch function it called."""
    frames = [f for f in traceback.extract_stack()
              if not f.filename.endswith(("warnings.py", "programs.py"))]
    inner = next((f for f in reversed(frames)
                  if not f.filename.startswith(_TORCH_DIR)), None)
    via = next((f for f in reversed(frames)
                if f.filename.startswith(_TORCH_DIR)), None)
    where = (f"{os.path.relpath(inner.filename)}:{inner.lineno} "
             f"({inner.name})" if inner is not None else "?")
    return where + (f" via torch {via.name}" if via is not None else "")


class _SyncWatch:
    """Record the host synchronisations the calling thread makes
    (``torch.cuda.set_sync_debug_mode("warn")``). The mode and the
    warning hook are the process's: enter it only under
    :data:`_build_lock`."""

    def __init__(self):
        self.sites: List[str] = []

    def __enter__(self):
        self._mode = torch.cuda.get_sync_debug_mode()
        # a caller recording warnings itself still sees the syncs
        forward = warnings._showwarnmsg_impl is not _DEFAULT_SHOW_IMPL
        self._ctx = warnings.catch_warnings()
        self._ctx.__enter__()
        warnings.simplefilter("always")
        me = threading.get_ident()
        show = warnings.showwarning

        def hook(message, category, filename, lineno, file=None, line=None):
            sync = "called a synchronizing" in str(message)
            if sync and threading.get_ident() == me and len(self.sites) < 3:
                self.sites.append(_sync_site())
            if forward or not sync:
                show(message, category, filename, lineno, file, line)

        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(self._mode)
        self._ctx.__exit__(*exc)


#: one build (first run under :class:`_SyncWatch`, then the capture on the
#: device's capture stream) at a time in the process: the watch swaps the
#: process's sync debug mode and warning hook, and the capture stream is
#: shared. Reentrant, for a callable that builds another program.
_build_lock = threading.RLock()


# --- variants ----------------------------------------------------------

class _Eager:
    """A variant that stays eager (with the reason)."""

    def __init__(self, reason: str, keep: Sequence[Any] = ()):
        self.reason = reason
        self.keep = list(keep)


class _Seen:
    """A stream program's signature first called in request ``serial``:
    it runs eagerly until a later request calls it, which captures."""

    def __init__(self, serial: int, keep: Sequence[Any] = ()):
        self.serial = serial
        self.keep = list(keep)


class _Graph:
    def __init__(self, graph, kinds, statics, out_tree, outs, checks,
                 launches, keep, nbytes):
        self.graph = graph
        self.inference = torch.is_inference_mode_enabled()
        self.kinds = kinds          # "ref" | "copy" per leaf
        self.statics = statics      # the graph's input tensors
        self.out_tree = out_tree
        self.outs = outs            # the graph's output tensors
        self.checks = checks
        self.launches = launches    # {kernel wrapper: launches per replay}
        self.keep = keep
        self.nbytes = nbytes
        # the static inputs and outputs are shared: concurrent callers
        # (a daemon's handler threads, on one stream) take turns from the
        # input copies to the output clones
        self._mu = threading.Lock()

    def replay(self, leaves: List[torch.Tensor]) -> Any:
        with self._mu, torch.inference_mode(self.inference):
            for kind, static, src in zip(self.kinds, self.statics, leaves):
                if kind == "copy":
                    static.copy_(src)
            self.graph.replay()
            for fn, n in self.launches.items():
                fn.launches += n
            for check in self.checks:
                check()
            outs = [t.clone() for t in self.outs]
        return _unflatten(self.out_tree, iter(outs))


class Program:
    """One cached program: a variant per input signature (see the module
    docstring). ``stream`` marks a per-chunk step: its argument 0 (a
    carried state, a block) is never read in place, and it captures from
    its second request on. ``on_trace`` is called
    once per new signature (the executor's trace counters). ``ref_args``
    lists the positions whose tensors are read in place like scanned
    sets, keyed by identity (address on the card) instead of by set and
    version: inputs their caller never writes in place
    (``compile_pdml``'s bound matrices, the LSTM's stored weights)."""

    def __init__(self, key: str, on_trace: Callable[[], None],
                 stream: bool = False, ref_args: Sequence[int] = ()):
        self.key = key
        self._on_trace = on_trace
        self.stream = stream
        self.ref_args = frozenset(ref_args)
        self._mu = threading.Lock()
        self._variants: "collections.OrderedDict[Any, Any]" = \
            collections.OrderedDict()
        self._by_set: Dict[str, set] = {}

    def __call__(self, fn: Callable, *args, closure: Any = None,
                 keep: Sequence[Any] = ()) -> Any:
        """``fn(*args)``, through the variant of this signature.
        ``closure`` is :func:`closure_token` of what ``fn`` closes over,
        ``keep`` the objects that token holds by identity."""
        leaves: List[torch.Tensor] = []
        trees, positions = [], []
        for pos, a in enumerate(args):
            n = len(leaves)
            trees.append(_flatten(a, leaves))
            positions.extend([pos] * (len(leaves) - n))
        ctx = getattr(_tags, "ctx", None)
        tags = ctx.tags if ctx is not None else {}
        on_card = any(t.is_cuda for t in leaves)
        kinds, leaf_sig, idents = [], [], set()
        for t, pos in zip(leaves, positions):
            entry = (tuple(t.shape), t.stride(), t.dtype, t.device)
            tag = tags.get(id(t))
            if self.stream and pos == 0:
                kinds.append("copy")
            elif pos in self.ref_args:
                kinds.append("ref")
                entry += ("arg", t.data_ptr() if t.is_cuda else id(t))
            elif tag is not None:
                kinds.append("ref")
                entry += (tag, t.data_ptr() if t.is_cuda else None)
                idents.add(tag.ident)
            else:
                kinds.append("copy")
            leaf_sig.append(entry)
        if self.ref_args:
            keep = list(keep) + [t for t, pos in zip(leaves, positions)
                                 if pos in self.ref_args]
        sig = (tuple(trees), tuple(leaf_sig), closure)
        serial = ctx.serial if ctx is not None else None
        with self._mu:
            var = self._variants.get(sig)
            if var is not None:
                self._variants.move_to_end(sig)
        if var is None:
            self._on_trace()
            if not on_card:
                self._remember(sig, _Eager("", keep), idents)
                return fn(*args)
            if self.stream and serial is not None:
                self._remember(sig, _Seen(serial, keep), idents)
                return fn(*args)
        elif isinstance(var, _Seen):
            if var.serial == serial:
                return fn(*args)
        elif isinstance(var, _Eager):
            if on_card:
                _note_eager(self.key, var.reason)
            return fn(*args)
        else:
            _tick("replays")
            _pool_touch(self, sig)
            return var.replay(leaves)
        return self._build(sig, fn, args, trees, leaves, kinds, keep, idents)

    def _remember(self, sig, var, idents) -> None:
        with self._mu:
            self._variants[sig] = var
            self._variants.move_to_end(sig)
            for ident in idents:
                self._by_set.setdefault(ident, set()).add(sig)
            gone = []
            while len(self._variants) > VARIANTS_PER_PROGRAM:
                old, _ = self._variants.popitem(last=False)
                gone.append(old)
                for sigs in self._by_set.values():
                    sigs.discard(old)
        _pool_forget(self, gone)
        if isinstance(var, _Graph):
            _pool_add(self, sig, var.nbytes)

    def drop(self, sig) -> None:
        """Drop one variant (its graph and pool)."""
        with self._mu:
            self._variants.pop(sig, None)
            for sigs in self._by_set.values():
                sigs.discard(sig)
        _pool_forget(self, [sig])

    def invalidate(self, ident: str) -> int:
        """Drop the variants that read set ``ident`` in place; returns how
        many were dropped."""
        with self._mu:
            sigs = self._by_set.pop(ident, set())
            n = 0
            for sig in sigs:
                if self._variants.pop(sig, None) is not None:
                    n += 1
        _pool_forget(self, sigs)
        return n

    def variants(self) -> int:
        with self._mu:
            return len(self._variants)

    def _build(self, sig, fn, args, trees, leaves, kinds, keep,
               idents) -> Any:
        """A signature's first run on the card (its first call, or a stream
        program's first call in a later request): run eagerly on the
        capture stream, watching for host syncs, then capture."""
        reason = _uncapturable(trees, leaves)
        if reason:
            self._remember(sig, _Eager(reason, keep), idents)
            _note_eager(self.key, reason, new=True)
            return fn(*args)
        device = next(t.device for t in leaves if t.is_cuda)
        with _build_lock:
            stream = _capture_stream(device)
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream), _SyncWatch() as watch, \
                    deferring() as checks:
                out = fn(*args)
            torch.cuda.current_stream(device).wait_stream(stream)
            for check in checks:
                check()
            reason = ""
            if watch.sites:
                reason = "host sync at " + "; ".join(watch.sites)
            else:
                opaque = _opaque_types(_flatten(out, []))
                if opaque:
                    reason = f"non-tensor output {opaque[0]}"
            if not reason:
                try:
                    var = self._capture(fn, trees, leaves, kinds, device,
                                        stream, keep)
                except Exception as e:  # noqa: BLE001 — a counted fallback
                    reason = f"capture failed: {type(e).__name__}: {e}"[:300]
        if reason:
            self._remember(sig, _Eager(reason, keep), idents)
            _note_eager(self.key, reason, new=True)
        else:
            self._remember(sig, var, idents)
        return out

    def _capture(self, fn, trees, leaves, kinds, device, stream,
                 keep) -> _Graph:
        statics = [t if kind == "ref" else torch.empty_strided(
            t.shape, t.stride(), dtype=t.dtype, device=t.device)
            for t, kind in zip(leaves, kinds)]
        it = iter(statics)
        static_args = [_unflatten(tr, it) for tr in trees]
        wrappers = _kernel_wrappers()
        before = {w: w.launches for w in wrappers}
        mem0 = torch.cuda.memory_reserved(device)
        graph = torch.cuda.CUDAGraph()
        stream.wait_stream(torch.cuda.current_stream(device))
        err: Optional[BaseException] = None
        with torch.cuda.stream(stream), deferring() as checks:
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = fn(*static_args)
            except Exception as e:  # noqa: BLE001
                err = e
            try:
                with warnings.catch_warnings():
                    # a callable that launched nothing gives an empty
                    # graph, whose replay is a no-op: nothing to warn of
                    warnings.filterwarnings(
                        "ignore", message="The CUDA Graph is empty")
                    graph.capture_end()
            except Exception as e:  # noqa: BLE001
                err = err or e
        launches = {w: w.launches - before[w] for w in wrappers}
        for w in wrappers:  # a capture launches nothing
            w.launches = before[w]
        torch.cuda.current_stream(device).wait_stream(stream)
        if err is not None:
            del graph
            raise err
        # the graph's private pool: the memory reserved while capturing
        nbytes = torch.cuda.memory_reserved(device) - mem0
        with _stats_lock:
            _captured.update({w.__name__: n for w, n in launches.items()
                              if n})
        _tick("captures")
        _tick("capture_bytes", max(nbytes, 0))
        outs: List[torch.Tensor] = []
        out_tree = _flatten(out, outs)
        return _Graph(graph, kinds, statics, out_tree, outs, list(checks),
                      {w: n for w, n in launches.items() if n},
                      list(keep), max(nbytes, 0))


def _uncapturable(trees, leaves) -> str:
    for tr in trees:
        opaque = _opaque_types(tr)
        if opaque:
            return f"non-tensor input {opaque[0]}"
    if any(not t.is_cuda for t in leaves):
        return "host tensor input"
    cards = {t.device for t in leaves}
    if len(cards) > 1:
        # one graph captures on one device's stream: mesh positions on
        # several physical cards run as they come
        return f"inputs on {len(cards)} cards (mesh positions span cards)"
    if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
        return "inputs require grad"
    return ""


def _note_eager(key: str, reason: str, new: bool = False) -> None:
    """Count an eager run of a variant that cannot be captured; a new one
    is also a ``fusion.fallbacks`` tick."""
    with _stats_lock:
        _stats["eager_runs"] += 1
        ent = _fallbacks.get(key)
        if ent is None:
            ent = _fallbacks[key] = {"reason": reason, "runs": 0}
            while len(_fallbacks) > _FALLBACK_LOG_CAP:
                _fallbacks.popitem(last=False)
        ent["runs"] += 1
        ent["reason"] = reason or ent["reason"]
    if new:
        from netsdb_tpu_torch.plan import fusion

        fusion.fallback(f"{key[:120]}: {reason}")
