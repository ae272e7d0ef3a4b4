"""Paged tensor storage and streaming — counterpart of
``netsdb_tpu/storage/paged.py`` (the tensor half).

A matrix of a ``storage="paged"`` set lives row-block-wise as pages of
the native page arena (``native/pagestore.cpp``, bound by
:mod:`netsdb_tpu_torch.native.pagestore`), which keeps hot pages in a
capped pool and spills cold ones to files under ``config.data_dir``.
Consumers stream it block by block: a prefetch reader thread reads
pages ahead of the consumer (the reference's ``PageCircularBuffer``),
and :mod:`netsdb_tpu_torch.plan.staging` uploads them to the device
ahead of the compute. The matrix is never materialised whole on the
device.

The pure-Python page backend is kept for tests and for machines without
g++, but only when asked for (``force_python=True``): a failed native
build raises. A paged relation keeps its int and float columns as two
matrices of this store with one row blocking
(:class:`~netsdb_tpu_torch.relational.outofcore.PagedColumns`); a paged
object set keeps its host records as pickled batches of about one page
each (:class:`PagedObjects`), which iterate page by page.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import queue
import threading
import time
import warnings
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.utils.locks import RWLock, TrackedLock


class _PyPageBackend:
    """Dict-of-bytes backend with the native store's surface (tests, and
    machines without g++ when the caller asks for it)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._pages: Dict[int, bytes] = {}
        self._sets: Dict[int, list] = {}
        self._next = 1

    def create_set(self, set_id, policy="lru"):
        with self._mu:
            self._sets.setdefault(set_id, [])

    def write_page(self, set_id, payload) -> int:
        data = payload if isinstance(payload, bytes) else \
            np.ascontiguousarray(payload).tobytes()
        with self._mu:
            pid = self._next
            self._next += 1
            self._pages[pid] = data
            self._sets[set_id].append(pid)
        return pid

    def read_page(self, page_id) -> bytes:
        with self._mu:
            return self._pages[page_id]

    def overwrite_page(self, page_id, payload) -> None:
        data = payload if isinstance(payload, bytes) else \
            np.ascontiguousarray(payload).tobytes()
        with self._mu:
            old = self._pages.get(page_id)
            if old is None:
                raise KeyError(f"unknown page {page_id}")
            if len(old) != len(data):
                raise ValueError(f"overwrite_page: size change {len(old)} "
                                 f"-> {len(data)} not allowed")
            self._pages[page_id] = data

    def free_page(self, page_id) -> None:
        with self._mu:
            self._pages.pop(page_id, None)
            for pages in self._sets.values():
                if page_id in pages:
                    pages.remove(page_id)

    def set_pages(self, set_id):
        with self._mu:
            return list(self._sets[set_id])

    def page_size(self, page_id) -> int:
        with self._mu:
            return len(self._pages[page_id])

    def stats(self):
        with self._mu:
            nbytes = sum(len(v) for v in self._pages.values())
        return {"hits": 0, "misses": 0, "evictions": 0, "spills": 0,
                "loads": 0, "bytes_allocated": nbytes,
                "bytes_in_use": nbytes}

    def close(self):
        pass


class PagedTensor:
    """Streaming read handle on a matrix living as arena pages — the
    value a ``ScanSet`` of a paged tensor set gives the executor. It
    never materialises: consumers stream row blocks.

    ``rw`` is the owning set item's stream-versus-drop lock;
    ``placement`` the set's placement (applied to each staged block);
    ``device`` the client's device the blocks are staged to. The store
    binds ``devcache``, ``cache_scope`` (set ident, write version) and
    ``cache_version_fn`` for store-owned handles."""

    def __init__(self, store: "PagedTensorStore", name: str, rw=None,
                 placement=None, device=None):
        self.store = store
        self.name = name
        self.rw = rw if rw is not None else RWLock()
        self.placement = placement
        self.device = torch.device(device if device is not None else "cpu")
        self.devcache = None
        self.cache_scope = None
        self.cache_version_fn = None

    @property
    def shape(self) -> Tuple[int, int]:
        return self.store.meta(self.name)[0]

    @property
    def dtype(self) -> np.dtype:
        return self.store.meta(self.name)[2]

    def num_blocks(self) -> int:
        return self.store.num_blocks(self.name)

    def stream_blocks(self, prefetch: Optional[int] = None,
                      blocks: Optional[list] = None
                      ) -> Iterator[Tuple[int, np.ndarray]]:
        """Yield (start_row, block) under the read lock for the
        generator's lifetime; ``blocks`` restricts the stream to those
        page indices."""
        with self.rw.read():
            yield from self.store.stream_blocks(self.name, prefetch,
                                                blocks=blocks)

    def block_ranges(self) -> list:
        """[(start_row, end_row)] per page block, from metadata only."""
        return self.store.block_ranges(self.name)


class PagedObjects:
    """Host records paged as pickled batches in the shared arena —
    counterpart of the reference's ``PagedObjects`` (netsDB's pages hold
    arbitrary objects, ``src/storage/headers/PDBPage.h:17-33``).
    Iterating the handle streams the records page by page (pin one
    batch, yield its records, move on) under the read lock, so the
    executor's host nodes consume it as they consume a list.

    A batch is flushed as one page once its measured pickled size
    reaches ``config.page_size_bytes`` (at least 4096); the arena caps
    and spills these pages as it does matrix pages.

    Locking: an append only adds pages, so it holds the read lock (which
    excludes :meth:`drop`) and the handle's append mutex, never the
    write lock: it does not wait for live streams, and a consumer that
    appends while it iterates cannot deadlock on its own read lock. A
    stream started mid-append may see a prefix of the batch's pages."""

    def __init__(self, store: "PagedTensorStore", name: str,
                 num_items: int = 0):
        self.store = store
        self.name = name
        self.num_items = num_items
        self.rw = RWLock(name="PagedObjects.rw")
        self._append_mu = threading.Lock()
        self.dropped = False
        store.backend.create_set(store._set_id(name))

    @staticmethod
    def ingest(store: "PagedTensorStore", name: str,
               items: list) -> "PagedObjects":
        """A new relation holding ``items``. Nothing else can reach it
        before it is returned, so its pages are written without its
        locks: a caller may ingest under the store lock and never wait
        on a relation's streams."""
        po = PagedObjects(store, name)
        po._write(items)
        return po

    def append(self, items: list) -> None:
        """Write records as more pickled-batch pages."""
        if not items:
            return
        with self._append_mu, self.rw.read():
            if self.dropped:
                raise KeyError(f"paged object set {self.name!r} was "
                               f"dropped; cannot append")
            self._write(items)

    def _write(self, items: list) -> None:
        """Page ``items`` as pickled batches; the caller holds the append
        lock and the read lock, or owns a relation no one else sees."""
        import io
        import pickle

        if not items:
            return
        sid = self.store._set_id(self.name)
        target = max(self.store.config.page_size_bytes, 4096)
        # the batch is measured as it fills (an incremental pickler over
        # the batch's own records), so a page never holds much more than
        # the target, whatever the records' sizes
        batch: list = []
        buf = io.BytesIO()
        measurer = pickle.Pickler(buf, protocol=pickle.HIGHEST_PROTOCOL)

        def flush():
            nonlocal buf, measurer
            if not batch:
                return
            self.store.backend.write_page(
                sid, pickle.dumps(batch, protocol=pickle.HIGHEST_PROTOCOL))
            batch.clear()
            buf = io.BytesIO()
            measurer = pickle.Pickler(buf, protocol=pickle.HIGHEST_PROTOCOL)

        for it in items:
            batch.append(it)
            try:
                measurer.dump(it)
                full = buf.tell() >= target
            except (pickle.PicklingError, TypeError, AttributeError):
                # the real dumps in flush() raises with the batch
                full = True
            if full:
                flush()
        flush()
        self.num_items += len(items)

    def __iter__(self):
        """The records, page by page, under the read lock (held until
        the generator ends or is closed)."""
        import pickle

        with self.rw.read():
            if self.dropped:
                raise KeyError(f"paged object set {self.name!r} was "
                               f"dropped; cannot stream")
            sid = self.store._set_id(self.name)
            for pid in self.store.backend.set_pages(sid):
                # pages this store wrote
                yield from pickle.loads(self.store._read(pid))

    def __len__(self) -> int:
        return self.num_items

    def to_list(self) -> list:
        return list(self)

    def drop(self) -> None:
        """Free the pages, once the streams reading them are done."""
        with self.rw.write():
            self.dropped = True
            sid = self.store._ids.pop(self.name, None)
            if sid is None:
                return
            for pid in self.store.backend.set_pages(sid):
                self.store.backend.free_page(pid)


class PagedTensorStore:
    """Row-block paged storage for matrices over one page arena."""

    def __init__(self, config: Optional[Configuration] = None,
                 pool_bytes: Optional[int] = None,
                 force_python: bool = False):
        self.config = config if config is not None else Configuration()
        self._meta: Dict[int, Tuple[Tuple[int, int], Tuple[int, int],
                                    np.dtype]] = {}
        self._ids: Dict[str, int] = {}
        self._sid = itertools.count(1)
        # per set: (rows per page, start row per page), from page sizes
        self._layout: Dict[int, Tuple[list, list]] = {}
        # live prefetch readers, joined before the arena is freed
        self._readers: List[Tuple[threading.Thread, threading.Event]] = []
        self._readers_lock = TrackedLock("PagedTensorStore._readers_lock")
        self._closed = False
        self._leaked = False
        self._reads = 0
        self._read_s = 0.0
        self._reads_lock = threading.Lock()
        if force_python:
            self.backend = _PyPageBackend()
            self.native = False
        else:
            from netsdb_tpu_torch.native.pagestore import NativePageStore

            self.config.ensure_dirs()
            self.backend = NativePageStore(
                pool_bytes or self.config.page_pool_bytes
                or self.config.shared_mem_bytes,
                os.path.join(self.config.data_dir, "pages"))
            self.native = True

    def _set_id(self, name: str) -> int:
        # monotonic: a dropped set's id is never handed out again
        if name not in self._ids:
            self._ids[name] = next(self._sid)
        return self._ids[name]

    def put(self, name: str, dense: np.ndarray,
            row_block: Optional[int] = None, append: bool = False) -> None:
        """Page a matrix in as contiguous row blocks of ``row_block``
        rows (default: as many rows as fit ``page_size_bytes``).
        ``append=True`` writes the batch as more pages after the
        existing ones, so blocks may be ragged mid-stream; readers
        derive each page's rows from its size."""
        dense = np.ascontiguousarray(dense)
        if dense.ndim != 2:
            raise ValueError(f"paged store holds matrices; got rank-"
                             f"{dense.ndim} array of shape {dense.shape}")
        rows, cols = dense.shape
        if append and name in self._ids:
            sid = self._ids[name]
            (orows, ocols), (rb, _), dtype = self._meta[sid]
            if ocols != cols or dtype != dense.dtype:
                raise ValueError(
                    f"append to {name!r}: schema mismatch ({ocols} cols/"
                    f"{dtype} vs {cols} cols/{dense.dtype})")
            for r0 in range(0, rows, rb):
                self.backend.write_page(sid, dense[r0:r0 + rb])
            self._meta[sid] = ((orows + rows, cols), (rb, cols), dtype)
            self._layout.pop(sid, None)
            return
        row_block = row_block or max(
            1, self.config.page_size_bytes
            // max(dense.dtype.itemsize * cols, 1))
        replacing = name in self._ids
        sid = self._set_id(name)
        self.backend.create_set(sid)
        if replacing:  # free the old pages, or reads would mix them in
            for pid in self.backend.set_pages(sid):
                self.backend.free_page(pid)
        for r0 in range(0, rows, row_block):
            self.backend.write_page(sid, dense[r0:r0 + row_block])
        self._meta[sid] = ((rows, cols), (row_block, cols), dense.dtype)
        self._layout.pop(sid, None)

    def truncate_to(self, name: str, n_pages: int, rows: int) -> None:
        """Roll a matrix back to its first ``n_pages`` pages and ``rows``
        rows, freeing the pages after them: the undo of a failed append,
        so that two matrices paged together stay in step."""
        sid = self._ids.get(name)
        if sid is None:
            return
        for pid in self.backend.set_pages(sid)[n_pages:]:
            self.backend.free_page(pid)
        (_, cols), (rb, _), dtype = self._meta[sid]
        self._meta[sid] = ((rows, cols), (rb, cols), dtype)
        self._layout.pop(sid, None)

    def _block_layout(self, sid: int) -> Tuple[list, list]:
        """(rows per page, start row per page) from the pages' sizes —
        right for ragged appended streams; cached per set."""
        cached = self._layout.get(sid)
        if cached is not None:
            return cached
        (_, cols), _, dtype = self._meta[sid]
        width = max(dtype.itemsize * cols, 1)
        ns = [self.backend.page_size(pid) // width
              for pid in self.backend.set_pages(sid)]
        starts = list(itertools.accumulate([0] + ns[:-1]))
        self._layout[sid] = (ns, starts)
        return ns, starts

    def meta(self, name: str) -> Tuple[Tuple[int, int], Tuple[int, int],
                                       np.dtype]:
        """((rows, cols), (row_block, cols), dtype) of a stored matrix."""
        return self._meta[self._ids[name]]

    def _read(self, pid: int):
        t0 = time.perf_counter()
        raw = self.backend.read_page(pid)
        with self._reads_lock:
            self._reads += 1
            self._read_s += time.perf_counter() - t0
        return raw

    def _pages(self, name: str, index: int) -> list:
        pids = self.backend.set_pages(self._ids[name])
        if not 0 <= index < len(pids):
            raise IndexError(f"block {index} out of range ({len(pids)} "
                             f"blocks in {name!r})")
        return pids

    def read_block(self, name: str, index: int) -> Tuple[int, np.ndarray]:
        """Random access to one row block: (start_row, block)."""
        sid = self._ids[name]
        (_, cols), _, dtype = self._meta[sid]
        pids = self._pages(name, index)
        ns, starts = self._block_layout(sid)
        raw = self._read(pids[index])
        return starts[index], np.frombuffer(raw, dtype=dtype).reshape(
            ns[index], cols)

    def rewrite_block(self, name: str, index: int,
                      block: np.ndarray) -> None:
        """Overwrite one row block in place; its shape may not change."""
        sid = self._ids[name]
        (_, cols), _, dtype = self._meta[sid]
        pids = self._pages(name, index)
        ns, _ = self._block_layout(sid)
        block = np.ascontiguousarray(block, dtype=dtype)
        if block.shape != (ns[index], cols):
            raise ValueError(
                f"rewrite_block: block {index} of {name!r} is "
                f"{(ns[index], cols)}, got {block.shape}; an in-place "
                f"rewrite keeps the block's shape")
        self.backend.overwrite_page(pids[index], block.tobytes())

    def num_blocks(self, name: str) -> int:
        return len(self.backend.set_pages(self._ids[name]))

    def block_ranges(self, name: str) -> list:
        """[(start_row, end_row)] per block, from metadata only (no page
        is read)."""
        ns, starts = self._block_layout(self._ids[name])
        return [(s, s + n) for s, n in zip(starts, ns)]

    def stream_blocks(self, name: str, prefetch: Optional[int] = None,
                      blocks: Optional[list] = None
                      ) -> Iterator[Tuple[int, np.ndarray]]:
        """Yield (start_row, block) in order. ``prefetch`` pages are read
        ahead on a reader thread (None: ``config.stream_prefetch_pages``;
        0: inline reads); ``blocks`` (sorted page indices) restricts the
        stream to those pages, so pages whose blocks are already on the
        device are never read."""
        if self._closed:
            raise RuntimeError("PagedTensorStore is closed")
        if prefetch is None:
            prefetch = self.config.stream_prefetch_pages
        sid = self._ids[name]
        (_, cols), _, dtype = self._meta[sid]
        pids = self.backend.set_pages(sid)
        _, starts = self._block_layout(sid)
        if blocks is not None:
            pids = [pids[i] for i in blocks]
            starts = [starts[i] for i in blocks]

        def view(raw):
            n = len(raw) // max(dtype.itemsize * cols, 1)
            return np.frombuffer(raw, dtype=dtype).reshape(n, cols)

        if prefetch <= 0 or len(pids) <= 1:
            for pid, start in zip(pids, starts):
                yield start, view(self._read(pid))
            return

        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        done = object()
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def reader():
            try:
                for pid, start in zip(pids, starts):
                    if not put((start, self._read(pid))):
                        return  # the consumer abandoned the stream
            except BaseException as e:  # any death reaches the consumer
                put((done, e))
                return
            put((done, None))

        t = threading.Thread(target=reader, daemon=True,
                             name=f"netsdb-pages-{name}")
        with self._readers_lock:
            if self._closed:
                raise RuntimeError("PagedTensorStore is closed")
            self._readers[:] = [(rt, rs) for rt, rs in self._readers
                                if rt.is_alive()]
            self._readers.append((t, stop))
        t.start()
        try:
            while True:
                try:
                    start, raw = q.get(timeout=0.5)
                except queue.Empty:
                    if not t.is_alive():
                        raise RuntimeError("page reader thread died")
                    continue
                if start is done:
                    if raw is not None:
                        raise raw
                    break
                yield start, view(raw)
        finally:
            stop.set()
            t.join(timeout=5)

    def matmul_streamed(self, name: str, rhs, device=None,
                        stage_depth: Optional[int] = None,
                        devcache=None, cache_scope: Optional[str] = None,
                        cache_version: Optional[int] = None,
                        stats_out: Optional[Dict[str, Any]] = None
                        ) -> torch.Tensor:
        """``M @ rhs`` with M streamed page by page through ``device``
        (default: ``rhs``'s device). One block, ``rhs`` and the staged
        next blocks are on the device at a time; each block pads to its
        row bucket (zero rows, sliced off after the product) as in the
        executor's rows-mode stream. With ``devcache`` and
        ``cache_scope`` (store-owned sets), the staged blocks install
        into the device block cache (block by block in partial mode;
        as one run keyed by ``cache_version`` otherwise) and a warm call
        reads no page. Returns the product on the device, in f32.

        With ``config.distributed_matmul`` the stream routes through
        SUMMA instead — the one place that routing is decided: over the
        ``config.summa_grid`` grid when it fits the participants
        (``summa.participants``: the visible positions of the device's
        type, capped at ``config.summa_participants``), else over the
        1-d mesh when there are at least 2; with fewer, this stream runs
        and ``summa.single_position`` counts it. ``stats_out`` receives
        the SUMMA run's statistics."""
        from netsdb_tpu_torch.ops.common import full_f32_precision
        from netsdb_tpu_torch.plan import staging

        rhs = torch.as_tensor(rhs)
        device = torch.device(device if device is not None else rhs.device)
        if getattr(self.config, "distributed_matmul", False):
            from netsdb_tpu_torch import obs
            from netsdb_tpu_torch.parallel import summa

            devices = summa.participants(self.config, device.type)
            grid = summa.grid_shape(self.config, len(devices))
            kw = dict(stage_depth=stage_depth, cache=devcache,
                      cache_scope=cache_scope, stats_out=stats_out)
            if grid is not None:
                return summa.summa_grid_matmul_streamed(
                    self, name, rhs, devices=devices, grid=grid, **kw)
            if len(devices) >= 2:
                return summa.summa_matmul_streamed(self, name, rhs,
                                                   devices=devices, **kw)
            obs.REGISTRY.counter("summa.single_position").inc()
            if stats_out is not None:
                stats_out.update(participants=1, rounds=0)
        # lint: disable=device-put-direct -- the caller's right operand, moved once to the streamed matmul's device; the paged blocks themselves go through the device cache
        rhs = rhs.to(device)
        cfg = self.config
        depth = cfg.stage_depth if stage_depth is None else stage_depth
        rb = self.meta(name)[1][0]
        uploader = staging.BlockUploader(device, depth)

        def place(item):
            _start, block = item
            n = block.shape[0]
            target = staging.pad_rows_target(n, cfg.shape_bucketing,
                                             density=cfg.bucket_density)
            return n, uploader.upload(block, rows=target)

        cache_kw = {}
        if devcache is not None and cache_scope is not None \
                and devcache.enabled:
            layout = (rb, cfg.shape_bucketing, cfg.bucket_density)
            if devcache.partial:
                cache_kw["partial"] = staging.PartialPlan(
                    devcache, (cache_scope, "mm") + layout,
                    self.block_ranges(name),
                    lambda idxs: self.stream_blocks(name, blocks=idxs))
            elif cache_version is not None:
                cache_kw.update(cache=devcache, cache_key=(
                    cache_scope, cache_version, "mm") + layout)
        full_f32_precision()
        outs = []
        with contextlib.closing(staging.stage_stream(
                None if "partial" in cache_kw else self.stream_blocks(name),
                place, depth, name=f"mm:{name}", uploader=uploader,
                **cache_kw)) as staged:
            for n, block in staged:
                out = torch.matmul(block, rhs.to(block.dtype)).float()
                outs.append(out[:n] if out.shape[0] != n else out)
        return torch.cat(outs, dim=0)

    def drop(self, name: str) -> None:
        """Free a matrix's pages (and spill files) back to the arena."""
        sid = self._ids.pop(name, None)
        if sid is None:
            return
        for pid in self.backend.set_pages(sid):
            self.backend.free_page(pid)
        self._meta.pop(sid, None)
        self._layout.pop(sid, None)

    def stats(self) -> Dict[str, Any]:
        """The arena's counters (hits, misses, evictions, spills, loads,
        bytes) plus ``page_reads``, the pages read out of the arena by
        this store since it was made, and ``page_read_s``, the seconds
        those reads took (spill-file loads included)."""
        out = dict(self.backend.stats())
        with self._reads_lock:
            out["page_reads"] = self._reads
            out["page_read_s"] = self._read_s
        return out

    def close(self) -> None:
        """Stop and join every live prefetch reader, then free the
        arena. A reader that does not stop (hung IO) keeps the arena
        alive: freeing it under the reader would be a use-after-free."""
        with self._readers_lock:
            self._closed = True
            readers = list(self._readers)
            self._readers.clear()
        for _, stop in readers:
            stop.set()
        for t, _ in readers:
            t.join(timeout=30)
        alive = [t for t, _ in readers if t.is_alive()]
        if alive or self._leaked:
            self._leaked = True
            warnings.warn(f"PagedTensorStore.close: {len(alive)} prefetch "
                          f"reader(s) did not stop; the arena is kept")
            return
        self.backend.close()
