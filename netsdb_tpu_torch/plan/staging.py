"""Overlapped device staging — counterpart of
``netsdb_tpu/plan/staging.py``: the ring buffer between the page
readers and the device.

:func:`stage_stream` wraps a host block iterator so that a background
thread runs the caller's ``place`` (pad + upload + placement) up to
``depth`` blocks ahead of the consumer, while the consumer computes on
the current block. The pipeline is three stages deep::

    arena --(prefetch reader)--> host block --(staging thread: place)-->
    device block --(consumer)--> fold step

**On a CUDA card** (:class:`BlockUploader`) an upload overlaps compute
only if it comes from page-locked memory, on a stream other than the
compute stream, ordered by an event, with the caching allocator told
that the block crosses streams. So every uploader issues its copies on
the device's one copy stream (:func:`copy_stream`) and owns a ring of
``depth + 1`` pinned host buffers: ``place`` copies the page
into the next buffer (after the event of the copy that last read that
buffer has completed), issues ``dst.copy_(pinned, non_blocking=True)``
on the copy stream and records an event. The staging thread runs
``place`` with the uploader's device and copy stream current, then
records a fence; the consumer's ``__next__`` makes its current stream
wait for the fence and calls ``record_stream`` on every tensor of the
block. A failed pin raises. **On the CPU** an upload is a plain copy.

Thread discipline, as in the reference: the staging thread owns the
source iterator (advances and closes it, so a source's read lock is
taken and released on one thread); any death of the thread re-raises at
the consumer; ``close()`` stops, drains and joins it, and
:func:`active_count` lets tests assert that no staging thread outlives
its stream.

The device block cache rides the same constructor: a whole-run cache
hit replays device-resident blocks with no thread and no copy
(:class:`_CachedRun`); in partial mode cached ranges are stitched into
the stream and only the gaps are read and staged (:func:`_stage_partial`).
Blocks are installed only after their copy has completed.

:func:`bucket_rows` rounds ragged row counts up to a fixed ladder, as in
the reference. The reference's donated fold accumulators have no
counterpart here: the executor accumulates into its carry in place.
Counters (chunks, bytes, copies, wait seconds, cached runs) are kept per
stream (``StagedStream.stats``) and for the module (:func:`counters`).
As in the reference, each chunk handed to a consumer also ticks the
metrics registry (``staging.chunks``, ``staging.bytes`` and the
``staging.wait_s`` histogram the staging-wait SLO reads), the query
trace captured on the consumer's thread (``stage.chunks``,
``stage.bytes``, ``stage.wait_s``; a run served wholly from the device
cache adds ``stage.cached_runs``), the plan node being recorded and,
for a set's stream, the per-(client, set) attribution ledger
(``staged_chunks``, ``staged_bytes``).
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from netsdb_tpu_torch import obs
from netsdb_tpu_torch.storage.devcache import _value_nbytes, to_device

# ---------------------------------------------------------------------
# shape buckets
# ---------------------------------------------------------------------

#: no bucket below this many rows
BUCKET_FLOOR = 8


def bucket_rows(n: int, density: int = 2) -> int:
    """Smallest bucket >= ``n`` of the ladder: ``density`` 2 gives
    {2^k, 3·2^(k-1)} (padding under 50%), 4 adds 2^(k-1)·{1.25, 1.75}
    (padding under 25%)."""
    if density not in (2, 4):
        raise ValueError(f"bucket_density must be 2 or 4, got {density!r}")
    if n <= BUCKET_FLOOR:
        return BUCKET_FLOOR
    p = 1 << (n - 1).bit_length()  # next power of two >= n
    if density >= 4:
        for mul in (10, 12, 14):   # (p/2)·{1.25, 1.5, 1.75} = p·mul/16
            c = (p * mul) // 16
            if c >= n:
                return c
        return p
    half = (3 * p) // 4            # the 1.5x step below it
    return half if half >= n else p


def pad_rows_target(n: int, bucketing: bool, multiple: int = 1,
                    density: int = 2) -> int:
    """Rows a block of ``n`` rows pads to: its bucket when ``bucketing``,
    else ``n``; then rounded up to ``multiple``."""
    target = bucket_rows(n, density) if bucketing else n
    if multiple > 1:
        target += (-target) % multiple
    return target


# ---------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------

_counts_lock = threading.Lock()
_COUNT_KEYS = ("chunks", "bytes", "copies", "wait_s", "cached_runs",
               "place_s", "pin_s")
_counts = dict.fromkeys(_COUNT_KEYS, 0)


def _count(**deltas) -> None:
    with _counts_lock:
        for k, v in deltas.items():
            _counts[k] += v


def counters() -> dict:
    """Module totals since the last :func:`reset_counters`: blocks
    handed to consumers (``chunks``), host→device bytes and copies of
    the uploaders, seconds consumers waited for a staged block
    (``wait_s``), streams served wholly from the device cache
    (``cached_runs``), seconds the staging threads spent in ``place``
    (``place_s``) and, of those, in filling pinned buffers (``pin_s``:
    waiting for a buffer's last copy and copying the page into it)."""
    with _counts_lock:
        return dict(_counts)


def reset_counters() -> None:
    with _counts_lock:
        _counts.update(dict.fromkeys(_COUNT_KEYS, 0))


# ---------------------------------------------------------------------
# the uploader
# ---------------------------------------------------------------------

def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


_copy_streams: dict = {}
_copy_streams_lock = threading.Lock()


def copy_stream(device: torch.device) -> "torch.cuda.Stream":
    """The one copy stream of a CUDA device, shared by every uploader:
    the caching allocator keeps a pool of blocks per stream, so uploads
    that all allocate on one stream reuse each other's freed blocks."""
    with _copy_streams_lock:
        stream = _copy_streams.get(device)
        if stream is None:
            stream = _copy_streams[device] = torch.cuda.Stream(device=device)
        return stream


class BlockUploader:
    """Uploads host blocks to one device (see the module docstring). One
    uploader serves one stream: its pinned ring is not shared."""

    def __init__(self, device, depth: int = 2):
        device = torch.device(device)
        self.cuda = device.type == "cuda"
        if self.cuda and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.bytes = 0
        self.copies = 0
        if self.cuda:
            self.stream = copy_stream(device)
            # [pinned buffer, event of the last copy out of it]
            self._ring = [[None, None] for _ in range(max(depth, 0) + 1)]
            self._slot = 0

    def scope(self):
        """The uploader's device and copy stream as the calling thread's
        current ones (nothing on the CPU)."""
        if not self.cuda:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(self.stream))
        return stack

    def upload(self, block: np.ndarray, rows: Optional[int] = None
               ) -> torch.Tensor:
        """``block`` on the device, zero-padded to ``rows`` rows. On CUDA
        the copy is issued on the copy stream and may still be running
        when this returns: the stream's fence orders it."""
        block = np.asarray(block)
        n = block.shape[0]
        rows = n if rows is None else rows
        self.bytes += block.nbytes
        self.copies += 1
        _count(bytes=block.nbytes, copies=1)
        if not self.cuda:
            out = to_device(block, self.device)
            if rows > n:
                out = torch.cat([out, out.new_zeros((rows - n,)
                                                    + out.shape[1:])])
            return out
        t0 = time.perf_counter()
        slot = self._ring[self._slot]
        self._slot = (self._slot + 1) % len(self._ring)
        buf, last = slot
        if last is not None:
            last.synchronize()  # never refill a buffer a copy still reads
        if buf is None or buf.numel() < block.nbytes:
            buf = torch.empty(max(block.nbytes, 1), dtype=torch.uint8,
                              pin_memory=True)
            if not buf.is_pinned():
                raise RuntimeError("could not page-lock a staging buffer")
        tdtype = _torch_dtype(block.dtype)
        host = buf[:block.nbytes].view(tdtype).view(block.shape)
        np.copyto(host.numpy(), block)
        _count(pin_s=time.perf_counter() - t0)
        with self.scope():
            dst = torch.empty((rows,) + tuple(block.shape[1:]), dtype=tdtype,
                              device=self.device)
            dst[:n].copy_(host, non_blocking=True)
            if rows > n:
                dst[n:].zero_()
            ev = torch.cuda.Event()
            ev.record(self.stream)
        slot[0], slot[1] = buf, ev
        return dst

    def fence(self) -> Optional["torch.cuda.Event"]:
        """An event after everything issued on the copy stream so far
        (None on the CPU)."""
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record(self.stream)
        return ev

    def settle(self) -> None:
        """Wait until everything issued on the copy stream has landed."""
        ev = self.fence()
        if ev is not None:
            ev.synchronize()


def _tensors(value) -> Iterator[torch.Tensor]:
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(getattr(value, "cols", None), dict):  # ColumnTable
        for c in value.cols.values():
            yield from _tensors(c)
        if value.valid is not None:
            yield from _tensors(value.valid)
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _tensors(v)
    elif getattr(value, "shards", None) is not None:  # ShardedTensor
        yield from {id(t): t for t in value.shards.flat}.values()
    elif isinstance(getattr(value, "data", None), torch.Tensor):
        yield value.data  # BlockedTensor


def _hand_over(placed, fence, uploader: Optional[BlockUploader]) -> None:
    """Order the consumer's current stream after the block's copies and
    tell the allocator the block's memory is used there."""
    if fence is None:
        return
    stream = torch.cuda.current_stream(uploader.device)
    stream.wait_event(fence)
    for t in _tensors(placed):
        if t.is_cuda:
            t.record_stream(stream)


def _used_here(value):
    """Tell the allocator a cached block is used on the consumer's
    current stream (it was allocated on a copy stream)."""
    for t in _tensors(value):
        if t.is_cuda:
            t.record_stream(torch.cuda.current_stream(t.device))
    return value


def hand_over(value, uploader: BlockUploader):
    """Order the caller's current stream after everything ``uploader``
    queued so far, and mark ``value``'s tensors as used there: for an
    upload made outside a staged stream (nothing on the CPU)."""
    _hand_over(value, uploader.fence(), uploader)
    return value


def used_here(value):
    """A cached value's tensors marked as used on the caller's current
    stream (they were allocated on a copy stream)."""
    return _used_here(value)


def _place_one(place, item, uploader: Optional[BlockUploader]):
    t0 = time.perf_counter()
    try:
        if uploader is None:
            return place(item), None
        with uploader.scope():
            placed = place(item)
            return placed, uploader.fence()
    finally:
        _count(place_s=time.perf_counter() - t0)


# ---------------------------------------------------------------------
# the staged stream
# ---------------------------------------------------------------------

_END, _ERR, _ITEM = "end", "err", "item"

# live staging threads: tests assert none outlives its stream
_stagers: list = []
_stagers_lock = threading.Lock()


def active_count() -> int:
    """Staging threads still alive; 0 once every stream is consumed or
    closed."""
    with _stagers_lock:
        _stagers[:] = [t for t in _stagers if t.is_alive()]
        return len(_stagers)


obs.REGISTRY.register_collector(
    "staging", lambda: {"active_stagers": active_count()})


def _stage_put(q: "queue.Queue", stop: threading.Event, item) -> bool:
    """Bounded put that gives up once the consumer closed the stream."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def _stage_worker(source, place, q: "queue.Queue", stop: threading.Event,
                  on_complete, uploader, want_nbytes: bool) -> None:
    """The staging thread. A free function over explicit state, never a
    bound method: the thread must not keep its StagedStream alive, or an
    abandoned stream could never be collected. ``on_complete`` runs only
    when the source is exhausted (a truncated run is never installed);
    its failure reaches the consumer like any other."""
    try:
        try:
            for item in source:
                if stop.is_set():
                    return
                placed, fence = _place_one(place, item, uploader)
                # sized here, overlapped with the consumer's compute
                nbytes = _value_nbytes(placed) if want_nbytes else None
                if not _stage_put(q, stop, (_ITEM, (placed, fence, nbytes))):
                    return  # the consumer abandoned the stream
        finally:
            # the worker owns the source: close it here, so its locks
            # are released on the thread that took them
            close = getattr(source, "close", None)
            if close is not None:
                close()
        if on_complete is not None:
            on_complete()
    except BaseException as e:  # any death reaches the consumer
        _stage_put(q, stop, (_ERR, e))
        return
    _stage_put(q, stop, (_END, None))


class StagedStream:
    """Iterator over ``place(item)`` for each item of ``source``, with
    ``place`` running up to ``depth`` items ahead on a background
    thread; ``depth <= 0`` places inline on the consumer's thread (no
    overlap, same results). ``uploader`` (a :class:`BlockUploader`)
    gives ``place`` its copy stream and orders each block for the
    consumer. ``scope`` ("db:set") names the set the attribution ledger
    books the staged bytes to (None: a temporary, unattributed); the
    trace, the client identity and the plan node are captured here, on
    the consumer's thread."""

    def __init__(self, source: Iterable, place: Callable[[Any], Any],
                 depth: int = 2, name: str = "stage",
                 on_complete: Optional[Callable[[], None]] = None,
                 uploader: Optional[BlockUploader] = None,
                 scope: Optional[str] = None):
        self._source = iter(source)
        self._place = place
        self._depth = int(depth)
        self._name = name
        self._closed = False
        self._on_complete = on_complete
        self._uploader = uploader
        self.stats = {"chunks": 0, "wait_s": 0.0}
        self._trace = obs.current_trace()
        self._scope = scope
        self._client = obs.attrib.current_client()
        self._op = obs.operators.current_op()
        self._want_nbytes = (scope is not None or self._trace is not None
                             or self._op is not None)
        self._thread: Optional[threading.Thread] = None
        if self._depth > 0:
            self._q: "queue.Queue" = queue.Queue(maxsize=self._depth)
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=_stage_worker,
                args=(self._source, place, self._q, self._stop, on_complete,
                      uploader, self._want_nbytes),
                daemon=True, name=f"netsdb-stage-{name}")
            with _stagers_lock:
                _stagers[:] = [t for t in _stagers if t.is_alive()]
                _stagers.append(self._thread)
            self._thread.start()

    def __iter__(self) -> Iterator[Any]:
        return self

    def _deliver(self, placed, fence, nbytes: Optional[int], wait_s: float):
        _hand_over(placed, fence, self._uploader)
        self.stats["chunks"] += 1
        self.stats["wait_s"] += wait_s
        _count(chunks=1, wait_s=wait_s)
        self._account(nbytes, wait_s)
        return placed

    def _account(self, nbytes: Optional[int], wait_s: float) -> None:
        """One chunk's ticks (module docstring); ``nbytes`` was sized on
        the staging thread."""
        obs.REGISTRY.counter("staging.chunks").inc()
        if nbytes:
            obs.REGISTRY.counter("staging.bytes").inc(int(nbytes))
        if wait_s > 0:
            obs.REGISTRY.histogram("staging.wait_s").observe(wait_s)
        if self._op is not None:
            self._op.add("stage.chunks")
            if nbytes:
                self._op.add("stage.bytes", nbytes)
            if wait_s > 0:
                self._op.add("stage.wait_s", wait_s)
        if self._scope is not None:
            obs.attrib.account("staged_chunks", 1, scope=self._scope,
                               client=self._client)
            obs.attrib.account("staged_bytes", nbytes or 0,
                               scope=self._scope, client=self._client)
        tr = self._trace
        if tr is None:
            return
        tr.add("stage.chunks")
        tr.add("stage.bytes", nbytes or 0)
        if wait_s > 0:
            tr.add("stage.wait_s", wait_s)

    def __next__(self):
        if self._closed:
            raise StopIteration
        if self._thread is None:  # inline mode
            try:
                item = next(self._source)
            except StopIteration:
                try:
                    if self._on_complete is not None:
                        self._on_complete()
                finally:
                    self.close()
                raise
            placed, fence = _place_one(self._place, item, self._uploader)
            return self._deliver(
                placed, fence,
                _value_nbytes(placed) if self._want_nbytes else None, 0.0)
        t0 = time.perf_counter()
        while True:
            try:
                kind, val = self._q.get(timeout=0.5)
            except queue.Empty:
                if not self._thread.is_alive():  # died without a word
                    self._closed = True
                    raise RuntimeError(
                        f"staging thread {self._name!r} died")
                continue
            if kind is _ERR:
                self._closed = True
                raise val
            if kind is _END:
                self._closed = True
                raise StopIteration
            return self._deliver(*val, time.perf_counter() - t0)

    def close(self) -> None:
        """Stop, drain and join the staging thread (idempotent): after
        this the source is closed and no thread of this stream runs."""
        if self._thread is None:
            if not self._closed:
                self._closed = True
                close = getattr(self._source, "close", None)
                if close is not None:
                    close()
            return
        self._closed = True
        self._stop.set()
        while True:  # drain, so a worker blocked in put() sees the stop
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=30)
        with _stagers_lock:
            _stagers[:] = [t for t in _stagers if t.is_alive()]

    def __enter__(self) -> "StagedStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        # an abandoned stream must not keep its thread (or its source's
        # read lock) until interpreter exit
        with contextlib.suppress(Exception):
            self.close()


class _CachedRun:
    """A whole run served from the device cache: no source, no thread,
    no copy; the same ``close()`` discipline as :class:`StagedStream`."""

    def __init__(self, blocks):
        self._it = iter(blocks)

    def __iter__(self):
        return self

    def __next__(self):
        return _used_here(next(self._it))

    def close(self) -> None:
        self._it = iter(())

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _CacheRecorder:
    """Wraps ``place`` so that a completed run installs into the cache
    as one entry (whole-run mode). Recording stops, and the held blocks
    are dropped, as soon as the run outgrows the whole budget: a set
    larger than the cache streams with only ``depth`` blocks live."""

    def __init__(self, cache, key, place, validator=None, uploader=None):
        self._client = obs.attrib.current_client()
        self._cache = cache
        self._key = key
        self._place = place
        self._validator = validator
        self._uploader = uploader
        self._blocks: list = []
        self._bytes = 0
        self._overflow = False

    def __call__(self, item):
        placed = self._place(item)
        if not self._overflow:
            self._bytes += _value_nbytes(placed)
            if self._bytes > self._cache.budget_bytes:
                self._overflow = True
                self._blocks = []
            else:
                self._blocks.append(placed)
                self._cache.make_room(self._bytes)
        return placed

    def complete(self) -> None:
        if self._overflow:
            self._cache.reject_oversized()
            return
        if self._uploader is not None:
            self._uploader.settle()  # install only landed blocks
        self._cache.install(self._key, self._blocks,
                            validator=self._validator, client=self._client)


class PartialPlan:
    """What :func:`stage_stream` needs to stitch one stream against the
    block-granular cache: the ``cache``, the ``base_key`` block entries
    key under (scope first, no write version), the set's full ordered
    ``ranges`` (from metadata) and ``source_for(indices)``, a host
    iterator over only those blocks (None: all of them)."""

    __slots__ = ("cache", "base_key", "ranges", "source_for")

    def __init__(self, cache, base_key, ranges, source_for):
        self.cache = cache
        self.base_key = tuple(base_key)
        self.ranges = [(int(s), int(e)) for s, e in ranges]
        self.source_for = source_for


class _BlockInstaller:
    """Wraps ``place`` so that every staged gap block installs into the
    partial cache as it streams (a consumer that stops early keeps what
    it staged). A block installs once its copy has landed: the previous
    block is installed while the next one's copy runs. Installs are
    epoch-gated, so a write racing the stream refuses them."""

    def __init__(self, cache, base_key, gap_ranges, epoch, place,
                 uploader=None):
        self._client = obs.attrib.current_client()
        self._cache = cache
        self._base_key = base_key
        self._gaps = list(gap_ranges)  # consumed in order
        self._epoch = epoch
        self._place = place
        self._uploader = uploader
        self._i = 0
        self._installed = 0
        self._pending = None  # (range, block, fence)

    def _flush(self) -> None:
        if self._pending is None:
            return
        rng, placed, fence = self._pending
        self._pending = None
        if fence is not None:
            fence.synchronize()
        if self._cache.install_block(self._base_key, rng, placed,
                                     epoch=self._epoch):
            self._installed += 1

    def __call__(self, item):
        placed = self._place(item)
        fence = self._uploader.fence() if self._uploader else None
        self._flush()
        if self._i < len(self._gaps):
            self._pending = (self._gaps[self._i], placed, fence)
            self._i += 1
        return placed

    def complete(self) -> None:
        self._flush()
        if self._installed == len(self._gaps):
            self._cache.record_run_install(str(self._base_key[0]),
                                           client=self._client)


class _StitchedStream:
    """Row-order interleave of cached blocks and a staged gap stream:
    cached ranges come from device memory (no page read, no copy), gap
    ranges through the normal pipeline; the consumer sees one stream."""

    def __init__(self, segments, staged, cache, scope: str):
        # segments: [("hit", block) | ("gap", None)] in block order
        self._segments = segments
        self._staged = staged
        self._cache = cache
        self._scope = scope
        self._i = 0
        self._closed = False
        # a contiguous run of cached blocks is one stitched range
        self._pending_ranges = sum(
            1 for j, (kind, _) in enumerate(segments)
            if kind == "hit" and (j == 0 or segments[j - 1][0] != "hit"))

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        if self._i >= len(self._segments):
            self.close()
            raise StopIteration
        kind, block = self._segments[self._i]
        self._i += 1
        if kind == "hit":
            self._cache.tick_partial(1, self._pending_ranges,
                                     scope=self._scope)
            self._pending_ranges = 0
            _count(chunks=1)
            return _used_here(block)
        return next(self._staged)

    def close(self) -> None:
        self._closed = True
        if self._staged is not None:
            self._staged.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        with contextlib.suppress(Exception):
            self.close()


def _cached_run_hit() -> None:
    """A run served wholly from the device cache: the query profile's
    zero-transfer marker, on the consuming plan node too."""
    _count(cached_runs=1)
    obs.add("stage.cached_runs")
    obs.operators.op_add("stage.cached_runs")


def _stage_partial(plan: PartialPlan, place, depth: int, name: str,
                   uploader, scope: Optional[str]):
    """The partial-cache leg of :func:`stage_stream`: consult, stitch,
    install as blocks stream."""
    scope = scope if scope is not None else str(plan.base_key[0])
    epoch, covered = plan.cache.plan_ranges(plan.base_key, plan.ranges)
    gaps = [i for i, r in enumerate(plan.ranges) if r not in covered]
    if not gaps:
        _cached_run_hit()
        return _StitchedStream([("hit", covered[r]) for r in plan.ranges],
                               None, plan.cache, scope)
    rec = _BlockInstaller(plan.cache, plan.base_key,
                          [plan.ranges[i] for i in gaps], epoch, place,
                          uploader)
    staged = StagedStream(plan.source_for(gaps), rec, depth=depth,
                          name=name, on_complete=rec.complete,
                          uploader=uploader, scope=scope)
    if not covered:
        return staged
    return _StitchedStream([("hit", covered[r]) if r in covered
                            else ("gap", None) for r in plan.ranges],
                           staged, plan.cache, scope)


def stage_stream(source: Optional[Iterable], place: Callable[[Any], Any],
                 depth: int = 2, name: str = "stage", cache=None,
                 cache_key=None, cache_validator=None, partial=None,
                 uploader: Optional[BlockUploader] = None,
                 scope: Optional[str] = None):
    """Wrap ``source`` so that ``place`` runs up to ``depth`` items ahead
    on a background thread — the one constructor every streamed
    consumer goes through.

    ``cache``/``cache_key`` make the stream use the whole-run cache: a
    hit replays the device-resident run (no thread, no page read, no
    copy); a miss streams and installs the completed run
    (``cache_validator``, no-arg -> bool, re-checks the key at install
    time). ``partial`` (a :class:`PartialPlan`) takes the block-granular
    path instead, ignoring ``source``. ``uploader`` gives ``place`` its
    copy stream (see :class:`BlockUploader`). ``scope`` ("db:set") is the
    set the attribution ledger books the staged bytes to; it defaults to
    the cache key's first part, and a stream with neither (a grace-hash
    spill) is unattributed."""
    if partial is not None and partial.cache.enabled \
            and partial.cache.partial and partial.ranges:
        return _stage_partial(partial, place, depth, name, uploader, scope)
    if partial is not None and source is None:
        source = partial.source_for(None)
    if scope is None and cache_key is not None:
        scope = str(cache_key[0])
    if cache is not None and cache_key is not None and cache.enabled:
        hit = cache.get(cache_key)
        if hit is not None:
            _count(chunks=len(hit))
            _cached_run_hit()
            return _CachedRun(hit)
        rec = _CacheRecorder(cache, cache_key, place, cache_validator,
                             uploader)
        return StagedStream(source, rec, depth=depth, name=name,
                            on_complete=rec.complete, uploader=uploader,
                            scope=scope)
    return StagedStream(source, place, depth=depth, name=name,
                        uploader=uploader, scope=scope)
