"""Set store — counterpart of ``netsdb_tpu/storage/store.py``.

Every set holds a list of items: one :class:`BlockedTensor` for a matrix
set, one tensor for an activation set, or host objects. The client puts
tensors on its device before they reach a memory set. A set created
with a placement (:class:`~netsdb_tpu_torch.parallel.placement.
Placement`) applies it to every item stored into it.

A set created with ``storage="paged"`` holds its one matrix as pages of
the shared page arena (:meth:`SetStore.page_store`, capped at
``config.page_pool_bytes``, spilling to ``config.data_dir``): it is
never resident on the device, :meth:`SetStore.get_tensor` refuses it,
and queries stream it through :class:`~netsdb_tpu_torch.storage.paged.
PagedTensor` handles bound to the device block cache
(:meth:`SetStore.device_cache`). Every write bumps the set's version and
drops its cached blocks. ``flush``/``load_set`` write a set to
``config.data_dir`` and bring it back, paged sets as paged sets; the
file format is the port's own. A paged set given host records keeps
them as pickled-batch pages (:class:`~netsdb_tpu_torch.storage.paged.
PagedObjects`): the first batch is ingested under the store lock, and
later batches append outside it, under the set's append lock, so an
append that waits on the records' own locks never freezes the store.
:meth:`SetStore.update_set` is the atomic read-modify-write of a memory
set's items (the columnarising append of an ``objects`` set).

A relation set holds one :class:`~netsdb_tpu_torch.relational.table.
ColumnTable` on the store's device; :meth:`SetStore.append_table` adds
a batch of rows to it, remapping the batch's dictionary codes into the
stored dictionaries, under the store lock. A paged relation set holds
one :class:`~netsdb_tpu_torch.relational.outofcore.PagedColumns`
instead, bound to the device cache: an append writes more pages outside
the store lock (under the set's append lock, waiting for the streams of
the relation) and dirties only its rows; every write is logged as a
dirty range, at most ``config.device_cache_dirty_log`` of them before
the log folds into one whole-set entry.

**Eviction** (reference ``store.py:1173-1212``). The store holds at most
``max_host_bytes`` (default ``config.shared_mem_bytes``) of memory sets'
items. In the port those bytes live on the client's device (a memory
set's tensors and tables are on the card), so the budget bounds device
memory, not host memory. Past it, after a write,
:meth:`SetStore._maybe_evict` flushes memory sets to ``config.data_dir``
and drops their items, ordered by each set's ``eviction`` policy
(``"lru"``, ``"mru"``, ``"random"``), the set just written excluded (a
reload evicts nothing: the next write does, as in the reference);
paged sets are never evicted (their pages already live in the arena).
``stats.evictions`` counts them, and a dropped set reloads on its next
read. Every write, eviction and removal is announced to the listeners of
:func:`on_set_write` (the compiled-program cache drops the programs that
read the set in place).

A set keeps the type it was created with. A ``tensor4d`` set (the conv
model's image, filter and bias sets) is scanned as its item list even
when it holds one tensor, as the reference scans a set of numpy arrays
(:meth:`SetStore.scans_as_list`); any other set holding one tensor is
scanned as that tensor.

**Dedup** (reference ``store.py:911-935``, ``:1119-1212``).
:meth:`SetStore.add_shared_mapping` points a set at another set's
storage (``alias_of``): its reads are the other set's items, and every
write to it raises, since it is read-only. :meth:`SetStore.set_pooled`
swaps a weight set's tensor for a :class:`~netsdb_tpu_torch.dedup.pool.
PooledTensor` (slots into a block pool shared across sets); a read
assembles it (one gather, cached on the pooled tensor). A set's bytes
then count only its slot grid, and each live pool counts once
(:meth:`SetStore.live_pool_bytes`). Under memory pressure the cached
assemblies go first (:meth:`SetStore.drop_pool_caches`), before any set
is evicted. A dropped assembly and every fresh one count as a write of
the set (its version moves and its programs drop), so no program reads a
freed assembly in place; so does a write to a set that others alias.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import os
import pickle
import random
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional

import numpy as np
import torch

from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.core.blocked import BlockedTensor, BlockMeta
from netsdb_tpu_torch.parallel.mesh import ShardedTensor
from netsdb_tpu_torch.parallel.placement import Placement
from netsdb_tpu_torch.utils.locks import RWLock


# set types whose scan is always the item list
LIST_SCAN_TYPES = frozenset({"tensor4d"})

EVICTION_POLICIES = ("lru", "mru", "random")

_write_listeners: List[Callable[[str], None]] = []
# numbers the stores of this process (several daemons of a pool may share
# one process, with the same set names)
_store_ids = itertools.count(1)


def on_set_write(fn: Callable[[str], None]) -> None:
    """Call ``fn(scope)`` whenever a set's content changes, or the set is
    evicted or removed; ``scope`` is :meth:`SetStore.program_scope` of
    the set."""
    if fn not in _write_listeners:
        _write_listeners.append(fn)


def _announce(ident) -> None:
    for fn in list(_write_listeners):
        fn(str(ident))


@dataclasses.dataclass
class CacheStats:
    """Hit, miss, eviction, spill and load counters (reference
    ``CacheStats``): a hit is a read of a set in memory, a miss or load
    one that had to reload it, a spill one flush of an evicted set."""

    hits: int = 0
    misses: int = 0
    evictions: int = 0
    spills: int = 0
    loads: int = 0


class SetIdentifier(NamedTuple):
    """(database, set) pair — reference ``SetIdentifier``."""

    db: str
    set: str

    def __str__(self) -> str:
        return f"{self.db}:{self.set}"


@dataclasses.dataclass
class _PagedMatrix:
    """The item of a paged tensor set: the matrix's arena name (unique
    per ingest, so a late drop of a replaced matrix never frees the
    pages of its successor) and its stream-versus-drop lock."""

    name: str
    rw: RWLock = dataclasses.field(default_factory=RWLock)


@dataclasses.dataclass
class _StoredSet:
    ident: SetIdentifier
    items: Optional[List[Any]]  # None: on disk, loaded on first read
    persistence: str = "transient"
    placement: Optional[Any] = None
    storage: str = "memory"
    type_name: str = "tensor"
    # monotonic write version (store-wide counter): the freshness token
    # the device cache keys whole runs on
    version: int = 0
    # bounded log of written row ranges: (start, end), (start, end,
    # columns) for an update in place, (0, None) for a whole-set write
    dirty_log: list = dataclasses.field(default_factory=list)
    # orders the appends and updates of one paged relation
    append_mu: Any = dataclasses.field(default_factory=threading.Lock)
    eviction: str = "lru"
    last_access: float = 0.0
    nbytes: int = 0
    # dedup: the set whose storage this set reads (read-only), and the
    # block mapping it was aliased under
    alias_of: Optional[SetIdentifier] = None
    shared_mapping: Optional[Dict] = None


def _item_nbytes(item: Any) -> int:
    """Bytes an item holds (tensors by their padded size); a host record
    counts 256, as in the reference."""
    if isinstance(item, BlockedTensor):
        return _item_nbytes(item.data)
    if isinstance(item, torch.Tensor):
        return item.numel() * item.element_size()
    if isinstance(item, ShardedTensor):
        return sum(t.numel() * t.element_size()
                   for t in {id(t): t for t in item.shards.flat}.values())
    resident = getattr(item, "nbytes_resident", None)  # PooledTensor: its
    if resident is not None:  # slot grid; the shared pool counts once,
        return int(resident)  # in SetStore.live_pool_bytes
    cols = getattr(item, "cols", None)
    if isinstance(cols, dict):  # ColumnTable (placed columns: each shard)
        n = sum(_item_nbytes(c) for c in cols.values())
        valid = getattr(item, "valid", None)
        return n + (_item_nbytes(valid) if valid is not None else 0)
    return 256


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu").contiguous().numpy()


def _host_tensor(t) -> torch.Tensor:
    """A stored tensor, gathered if it is sharded, as one CPU tensor."""
    if isinstance(t, ShardedTensor):
        t = t.to_dense()
    return t.detach().cpu()


class SetStore:
    """All sets of all databases of one client. One reentrant lock
    serialises every read-modify-write of the set map; pages are freed
    outside it, under the matrix's write lock, so a drop waits for the
    streams reading it without freezing the store."""

    def __init__(self, config: Optional[Configuration] = None,
                 device=None, max_host_bytes: Optional[int] = None):
        self.config = config if config is not None else Configuration()
        self.device = torch.device(device if device is not None else "cpu")
        self.max_host_bytes = max_host_bytes or self.config.shared_mem_bytes
        self.stats = CacheStats()
        self._sets: Dict[SetIdentifier, _StoredSet] = {}
        self._lock = threading.RLock()
        self._page_store = None
        self._device_cache = None
        self._gen = itertools.count()
        self._version_ctr = itertools.count(1)
        self._scope_tag = f"@{next(_store_ids)}"
        # sets holding a PooledTensor (dedup/pool.py): pool accounting
        # scans these only
        self._pooled: set = set()

    # --- shared resources (lazy: most clients never page a set) -------
    def page_store(self):
        """The :class:`~netsdb_tpu_torch.storage.paged.PagedTensorStore`
        behind every paged set, made on first use."""
        with self._lock:
            if self._page_store is None:
                from netsdb_tpu_torch.storage.paged import PagedTensorStore

                self._page_store = PagedTensorStore(
                    self.config, pool_bytes=self.config.page_pool_bytes)
            return self._page_store

    def close(self) -> None:
        """Close the page store, where one was made (its arena and page
        files); the resident sets stay readable."""
        with self._lock:
            if self._page_store is not None:
                self._page_store.close()

    def device_cache(self):
        """The cross-query :class:`~netsdb_tpu_torch.storage.devcache.
        DeviceBlockCache`, budgeted by ``config.device_cache_bytes``."""
        with self._lock:
            if self._device_cache is None:
                from netsdb_tpu_torch.storage.devcache import \
                    DeviceBlockCache

                self._device_cache = DeviceBlockCache(
                    self.config.device_cache_bytes,
                    partial=self.config.device_cache_partial,
                    pin_bytes=self.config.device_cache_pin_bytes)
            return self._device_cache

    def _touch(self, s: _StoredSet, rows=None, columns=None) -> None:
        """Advance a set's write version, log the written rows and drop
        the set's stale cached device blocks — called by every path that
        changes a set's content.

        ``rows=(start, end)`` names the written row range of a paged
        relation (``columns`` the columns of an update in place); None is
        a whole-set write, which drops every block of the set. A ranged
        write's blocks were already dropped by ``PagedColumns.append`` /
        ``update_column``, which own that invalidation so that direct
        callers stay coherent. When the log reaches
        ``config.device_cache_dirty_log`` entries it folds into one
        whole-set entry and the whole set's blocks drop."""
        s.version = next(self._version_ctr)
        folded = len(s.dirty_log) >= self.config.device_cache_dirty_log
        if folded:
            s.dirty_log[:] = [(0, None)]
        elif rows is None:
            s.dirty_log.append((0, None))
        elif columns is not None:
            s.dirty_log.append((int(rows[0]), int(rows[1]),
                                tuple(sorted(columns))))
        else:
            s.dirty_log.append((int(rows[0]), int(rows[1])))
        cache = self._device_cache
        if cache is not None and (rows is None or folded
                                  or not cache.partial):
            cache.invalidate(str(s.ident))
        s.last_access = time.time()
        if s.items is not None and s.storage == "memory":
            s.nbytes = sum(_item_nbytes(i) for i in s.items)
        _announce(self.program_scope(s.ident))
        for other in self._sets.values():  # readers of this set's storage
            if other.alias_of == s.ident:
                _announce(self.program_scope(other.ident))

    def _bind_cache(self, pc, ident: SetIdentifier) -> None:
        """Bind a store-owned paged relation to the device cache (grace
        partitions and temporaries stay unbound, so uncached)."""
        pc.devcache = self.device_cache()
        pc.cache_scope = str(ident)
        pc.cache_version_fn = functools.partial(self.version_of, ident)
        pc.program_scope = self.program_scope(ident)
        pc.placement_fn = functools.partial(self.placement_of, ident)

    def program_scope(self, ident: SetIdentifier) -> str:
        """The set's name in the compiled-program cache: ``db:set`` of
        this store. Versions count per store, so two stores of one
        process (two daemons of a pool, with the same set names) never
        share a program variant that reads a set in place, and a write in
        one never drops the other's. A placed set's name carries its mesh
        label (placement, mesh shape and positions), so a variant over 4
        positions never replays one over 1."""
        s = self._sets.get(ident)
        pl = s.placement if s is not None else None
        if pl is None:
            return f"{ident}{self._scope_tag}"
        return f"{ident}{self._scope_tag}@{pl.mesh_label(self.device.type)}"

    def version_of(self, ident: SetIdentifier) -> int:
        """The set's write version (0: unknown set); a set aliasing
        another moves with that set's writes too (versions come from one
        store-wide counter, so the larger is the newer)."""
        s = self._sets.get(ident)
        if s is None:
            return 0
        if s.alias_of is not None:
            return max(s.version, self.version_of(s.alias_of))
        return s.version

    # --- set lifecycle ------------------------------------------------
    def create_set(self, ident: SetIdentifier, placement: Optional[Any] = None,
                   storage: str = "memory",
                   persistence: str = "transient",
                   type_name: str = "tensor", eviction: str = "lru") -> None:
        """Create the set if it is new. A placement given for an existing
        set replaces its placement and re-places what it holds; an
        existing set keeps its type and eviction policy."""
        if storage not in ("memory", "paged"):
            raise ValueError(f"storage must be 'memory' or 'paged', "
                             f"got {storage!r}")
        if eviction not in EVICTION_POLICIES:
            raise ValueError(f"eviction must be one of {EVICTION_POLICIES}, "
                             f"got {eviction!r}")
        with self._lock:
            s = self._sets.get(ident)
            if s is None:
                s = self._sets[ident] = _StoredSet(
                    ident, [], persistence=persistence, placement=placement,
                    storage=storage, type_name=type_name, eviction=eviction)
                self._touch(s)
            elif placement is not None:
                s.placement = placement
                if s.storage == "memory":
                    s.items = [placement.apply(i)
                               for i in self._items_locked(s)]
                self._touch(s)

    def set_placement(self, ident: SetIdentifier, placement,
                      items: Optional[List[Any]] = None) -> None:
        """Swap a set's declared placement without re-staging its data —
        the commit step of ``parallel/reshard.reshard_set``, which has
        already moved the device-resident blocks (or the resident
        ``items``, passed here) through collective steps. The content is
        unchanged, so no write version moves and no dirty range is
        logged: blocks cached under the new layout's key stay matchable.
        The programs that read the set's old items in place are
        dropped."""
        with self._lock:
            s = self._writable(ident)
            old_scope = self.program_scope(ident)
            s.placement = placement
            if items is not None:
                s.items = list(items)
                s.nbytes = sum(_item_nbytes(i) for i in s.items)
            s.last_access = time.time()
        _announce(old_scope)

    def storage_of(self, ident: SetIdentifier) -> str:
        s = self._sets.get(ident)
        return s.storage if s is not None else "memory"

    def scans_as_list(self, ident: SetIdentifier) -> bool:
        """True when a scan of the set gives its item list whatever it
        holds (a type of ``LIST_SCAN_TYPES``)."""
        s = self._sets.get(ident)
        return s is not None and s.type_name in LIST_SCAN_TYPES

    def placement_of(self, ident: SetIdentifier) -> Optional[Any]:
        with self._lock:
            s = self._sets.get(ident)
            return s.placement if s is not None else None

    def list_sets(self) -> List[SetIdentifier]:
        with self._lock:
            return list(self._sets)

    def remove_set(self, ident: SetIdentifier) -> None:
        """Drop a set: its items, its cached device blocks, its flushed
        file, and (outside the lock, once its streams are done) its
        pages. An unknown set is a no-op."""
        with self._lock:
            s = self._sets.pop(ident, None)
            dead = (s.items or []) if s is not None else []
            if self._device_cache is not None:
                self._device_cache.invalidate(str(ident))
            path = self._spill_path(ident)
            if os.path.exists(path):
                os.remove(path)
        _announce(self.program_scope(ident))
        self._drop_pages(dead)

    def clear_set(self, ident: SetIdentifier) -> None:
        with self._lock:
            s = self._sets.get(ident)
            if s is None:
                return
            dead = s.items or []
            s.items = []
            self._touch(s)
        self._drop_pages(dead)

    def _drop_pages(self, items: List[Any]) -> None:
        """Return the pages of replaced or cleared paged matrices,
        relations and record sets to the arena, once the streams reading
        them are done."""
        from netsdb_tpu_torch.relational.outofcore import PagedColumns
        from netsdb_tpu_torch.storage.paged import PagedObjects

        for item in items:
            if isinstance(item, (PagedColumns, PagedObjects)):
                item.drop()
            elif isinstance(item, _PagedMatrix):
                with item.rw.write():
                    self.page_store().drop(item.name)

    # --- writes -------------------------------------------------------
    def add_data(self, ident: SetIdentifier, items: List[Any]) -> None:
        """Append items. A paged set takes exactly one matrix (a 2-D
        array or tensor) or one relation, which replaces its content, or
        host records, which append as pickled-batch pages: the store
        lock only locates and pins the set's :class:`~netsdb_tpu_torch.
        storage.paged.PagedObjects`, and the append runs outside it
        under the set's append lock (a concurrent remove or replace
        drops the pinned handle, and the append then raises)."""
        from netsdb_tpu_torch.relational.table import ColumnTable

        po = None
        with self._lock:
            s = self._writable(ident)
            if s.storage == "paged":
                if not items:
                    return
                item = items[0]
                whole = isinstance(item, (ColumnTable, BlockedTensor,
                                          np.ndarray, torch.Tensor))
                if whole and (len(items) != 1 or (
                        not isinstance(item, ColumnTable)
                        and np.ndim(item) != 2)):
                    raise ValueError(
                        f"paged set {ident} holds one matrix (2-D), one "
                        f"relation or host records; got {len(items)} "
                        f"item(s) starting with {type(item).__name__}")
                if isinstance(item, ColumnTable):
                    dead = self._ingest_paged_relation(s, item)
                elif whole:
                    dead = self._ingest_paged(
                        s, _host(item) if isinstance(item, torch.Tensor)
                        else np.asarray(item))
                else:
                    po = self._pin_paged_objects(s)
                    dead = ([] if po is not None
                            else self._ingest_paged_objects(s, items))
            else:
                dead = []
                s.items = self._items_locked(s) + self._placed(s, items)
            if po is None:
                self._touch(s)
                self._maybe_evict(exclude=ident)
        if po is not None:
            with s.append_mu:
                po.append(items)
            with self._lock:
                if self._sets.get(ident) is s:
                    self._touch(s)
        self._drop_pages(dead)

    def _pin_paged_objects(self, s: _StoredSet):
        """The :class:`~netsdb_tpu_torch.storage.paged.PagedObjects` a
        paged set holds, or None. Caller holds the store lock."""
        from netsdb_tpu_torch.storage.paged import PagedObjects

        return next((i for i in self._items_locked(s)
                     if isinstance(i, PagedObjects)), None)

    def _ingest_paged_objects(self, s: _StoredSet,
                              items: List[Any]) -> List[Any]:
        """Page host records into the arena under a fresh name (no stream
        can hold a relation that does not exist yet, so this runs under
        the store lock). Returns the replaced items, whose pages the
        caller frees outside the lock."""
        from netsdb_tpu_torch.storage.paged import PagedObjects

        dead = list(s.items or [])
        s.items = [PagedObjects.ingest(
            self.page_store(), f"{s.ident}#g{next(self._gen)}", items)]
        return dead

    def paged_objects(self, ident: SetIdentifier):
        """The :class:`~netsdb_tpu_torch.storage.paged.PagedObjects` a
        paged record set holds, or None."""
        with self._lock:
            return self._pin_paged_objects(self._require(ident))

    def update_set(self, ident: SetIdentifier, fn) -> None:
        """Atomic read-modify-write of a memory set's items: ``fn(items)
        -> new items`` runs under the store lock, so two concurrent
        updaters cannot lose each other's batch. The set's placement
        applies to the result."""
        with self._lock:
            s = self._writable(ident)
            if s.storage != "memory":
                raise ValueError(f"update_set needs a memory set; {ident} "
                                 f"is {s.storage!r}")
            s.items = self._placed(s, fn(list(self._items_locked(s))))
            self._touch(s)
            self._maybe_evict(exclude=ident)

    def put_tensor(self, ident: SetIdentifier, tensor: BlockedTensor) -> None:
        """Replace a set's content with one blocked matrix (every weight
        set is exactly one). A paged set pages the matrix into the arena
        from the host."""
        with self._lock:
            s = self._writable(ident)
            if s.storage == "paged":
                dead = self._ingest_paged(s, _host(tensor.to_dense()))
            else:
                dead = []
                s.items = self._placed(s, [tensor])
            self._touch(s)
            self._maybe_evict(exclude=ident)
        self._drop_pages(dead)

    def _ingest_paged(self, s: _StoredSet, dense: np.ndarray) -> List[Any]:
        """Page one matrix into the arena under a fresh name; returns the
        replaced items, whose pages the caller frees outside the lock."""
        dead = list(s.items or [])
        name = f"{s.ident}#g{next(self._gen)}.mat"
        self.page_store().put(name, np.ascontiguousarray(dense))
        s.items = [_PagedMatrix(name)]
        return dead

    def _ingest_paged_relation(self, s: _StoredSet, table) -> List[Any]:
        """Page one relation into the arena under a fresh name (a fresh
        relation has no streams to wait for, so this runs under the store
        lock): its valid rows, pages of about ``page_size_bytes`` (at
        least 64 rows). Returns the replaced items, whose pages the
        caller frees outside the lock."""
        from netsdb_tpu_torch.relational.outofcore import (PagedColumns,
                                                           _host_cols)

        dead = list(s.items or [])
        names = [n for n in table.cols if n != "_rowid"]
        cols = _host_cols(table, names)
        if table.valid is not None:
            keep = table.mask().detach().cpu().numpy()
            cols = {n: c[keep] for n, c in cols.items()}
        row_block = max(self.config.page_size_bytes
                        // (4 * max(len(names), 1)), 64)
        pc = PagedColumns.ingest(self.page_store(),
                                 f"{s.ident}#g{next(self._gen)}", cols,
                                 row_block=row_block,
                                 dicts=dict(table.dicts), device=self.device)
        self._bind_cache(pc, s.ident)
        s.items = [pc]
        return dead

    def paged_relation(self, ident: SetIdentifier):
        """The :class:`~netsdb_tpu_torch.relational.outofcore.
        PagedColumns` a paged relation set holds, or None."""
        from netsdb_tpu_torch.relational.outofcore import PagedColumns

        with self._lock:
            return next((i for i in self._items_locked(self._require(ident))
                         if isinstance(i, PagedColumns)), None)

    def _append_paged(self, s: _StoredSet, table) -> None:
        """Append a batch to a paged relation set. The first batch is a
        fresh ingest under the store lock; later ones write more pages
        outside it, under the set's append lock (the write waits for the
        relation's streams, which must not freeze the store). The stored
        dictionaries change only after the pages are written."""
        from netsdb_tpu_torch.relational.outofcore import (PagedColumns,
                                                           _host_cols)
        from netsdb_tpu_torch.relational.table import merge_dicts

        with s.append_mu:
            with self._lock:
                if self._sets.get(s.ident) is not s:
                    raise KeyError(f"set {s.ident} was removed during "
                                   f"append")
                pc = next((i for i in self._items_locked(s)
                           if isinstance(i, PagedColumns)), None)
                if pc is None:
                    dead = self._ingest_paged_relation(s, table)
                    self._touch(s)
            if pc is None:
                self._drop_pages(dead)
                return
            names = [n for n in table.cols if n != "_rowid"]
            cols = _host_cols(table, names)
            if table.valid is not None:
                keep = table.mask().detach().cpu().numpy()
                cols = {n: c[keep] for n, c in cols.items()}
            # validate everything before any stored state changes
            expected = set(pc.int_names) | set(pc.float_names)
            if set(cols) != expected:
                raise ValueError(
                    f"append to {s.ident}: schema mismatch — stored "
                    f"{sorted(expected)}, batch {sorted(cols)}")
            missing = [n for n in pc.dicts
                       if n in cols and n not in table.dicts]
            if missing:
                raise ValueError(
                    f"append to {s.ident}: columns {missing} are "
                    f"dict-encoded in the stored set but arrive as raw "
                    f"ints — codes would be meaningless")
            staged = {}
            for name, d_new in table.dicts.items():
                if name not in pc.dicts:
                    raise ValueError(f"append to {s.ident}: column "
                                     f"{name!r} is dict-encoded in the "
                                     f"batch but not in the stored set")
                staged[name], remap = merge_dicts(pc.dicts[name], d_new)
                cols[name] = remap[cols[name]]
            before = pc.num_rows
            pc.append(cols)  # atomic: rolls its pages back on failure
            pc.dicts.update(staged)
            with self._lock:
                self._touch(s, rows=(before, pc.num_rows))

    def update_columns(self, ident: SetIdentifier,
                       cols: Dict[str, Any]) -> None:
        """Overwrite whole columns of a paged relation in place: pages
        are rewritten where they sit, and the device cache drops only
        the blocks of streams that held a touched column. The rewrite
        runs outside the store lock, under the set's append lock."""
        with self._lock:
            s = self._writable(ident)
            if s.storage != "paged":
                raise ValueError(f"update_columns needs a paged table set; "
                                 f"{ident} is {s.storage!r}")
        pc = self.paged_relation(ident)
        if pc is None:
            raise ValueError(f"set {ident} holds no paged relation")
        with s.append_mu:
            for name, values in cols.items():
                pc.update_column(name, values)
            with self._lock:
                self._touch(s, rows=(0, pc.num_rows),
                            columns=tuple(sorted(cols)))

    def append_table(self, ident: SetIdentifier, table) -> None:
        """Append a batch of rows to a relation set (the reference's
        addData flow, ``StorageAddData``): a paged set writes more pages
        (:meth:`_append_paged`); for a memory set the stored table and
        the batch concatenate on the device with a dictionary remap,
        under the store lock. An empty set takes the batch as its
        table."""
        from netsdb_tpu_torch.relational.table import (ColumnTable,
                                                       concat_tables)

        with self._lock:
            s = self._writable(ident)
            paged = s.storage == "paged"
        if paged:
            self._append_paged(s, table)
            return
        with self._lock:
            s = self._writable(ident)
            items = self._items_locked(s)
            tables = [i for i in items if isinstance(i, ColumnTable)]
            if len(items) != len(tables) or len(tables) > 1:
                raise ValueError(
                    f"append_table needs a single-relation table set; "
                    f"{ident} holds {len(items)} items ({len(tables)} "
                    f"tables); appending would drop the rest")
            table = table.to(self.device)
            # a placed relation appends as the relation it lays out and is
            # placed again (a table appended to carries no padding rows)
            base = tables[0]._whole() if tables else None
            new = concat_tables(base, table) if tables else table
            s.items = self._placed(s, [new])
            self._touch(s)
            self._maybe_evict(exclude=ident)

    # --- reads --------------------------------------------------------
    def get_items(self, ident: SetIdentifier) -> List[Any]:
        """A set's items; an evicted set reloads from ``data_dir`` here.
        A set aliasing another reads that set's items (reference
        ``PartitionTensorBlockSharedPageIterator``); a pooled tensor is
        given as its assembly, and an assembly made anew is a write of
        the set."""
        with self._lock:
            s = self._require(ident)
            if s.alias_of is not None:
                return self.get_items(s.alias_of)
            if s.items is not None:
                self.stats.hits += 1
            items = list(self._items_locked(s))
            s.last_access = time.time()
            if ident in self._pooled:
                items = self._assembled(s, items)
            return items

    def _assembled(self, s: _StoredSet, items: List[Any]) -> List[Any]:
        from netsdb_tpu_torch.dedup.pool import PooledTensor

        out, fresh = [], False
        for item in items:
            if isinstance(item, PooledTensor):
                fresh |= item.cached is None
                item = item.assemble()
            out.append(item)
        if fresh:  # a new buffer: no program may hold the old one
            self._touch(s)
        return out

    def scan(self, ident: SetIdentifier) -> Iterator[Any]:
        """A set's items, one by one — reference ``SetScan`` /
        ``SetIterator``; a paged record set streams its records page by
        page. A paged matrix or relation streams through queries and is
        never an item here: its scan raises."""
        from netsdb_tpu_torch.relational.outofcore import PagedColumns
        from netsdb_tpu_torch.storage.paged import PagedObjects

        items = self.get_items(ident)
        if len(items) == 1 and isinstance(items[0], PagedObjects):
            return iter(items[0])
        if any(isinstance(i, _PagedMatrix) for i in items):
            raise ValueError(
                f"set {ident} holds a paged matrix: it streams through a "
                f"node with a tensor_fold, or through paged_matmul")
        if any(isinstance(i, PagedColumns) for i in items):
            raise ValueError(
                f"set {ident} holds a paged relation: it streams through a "
                f"node with a fold; get_table assembles it on the host")
        return iter(items)

    def set_stats(self, ident: SetIdentifier) -> Dict[str, Any]:
        """The reference's per-set statistics (``StorageCollectStats``):
        item count, bytes, residency, persistence, the set it aliases,
        its placement's label, storage, write version and dirty-range
        log; and its eviction policy."""
        with self._lock:
            s = self._require(ident)
            return {"ident": str(ident), "num_items": len(s.items or []),
                    "nbytes": s.nbytes, "in_memory": s.items is not None,
                    "persistence": s.persistence,
                    "alias_of": str(s.alias_of) if s.alias_of else None,
                    "placement": (s.placement.label()
                                  if s.placement is not None else None),
                    "storage": s.storage, "version": s.version,
                    "dirty_ranges": list(s.dirty_log),
                    "eviction": s.eviction}

    def get_tensor(self, ident: SetIdentifier) -> BlockedTensor:
        items = self.get_items(ident)
        if any(isinstance(i, _PagedMatrix) for i in items):
            raise ValueError(
                f"set {ident} holds a paged matrix: it streams and is never "
                f"resident on the device; consume it through a node with a "
                f"tensor_fold, or with paged_matmul")
        tensors = [i for i in items if isinstance(i, BlockedTensor)]
        if len(tensors) != 1:
            raise ValueError(
                f"set {ident} holds {len(tensors)} tensors; expected exactly 1")
        return tensors[0]

    def _paged_item(self, ident: SetIdentifier):
        s = self._require(ident)
        pm = next((i for i in self._items_locked(s)
                   if isinstance(i, _PagedMatrix)), None)
        if pm is None:
            raise ValueError(f"set {ident} holds no paged matrix")
        return s, pm

    def paged_tensor(self, ident: SetIdentifier):
        """The streaming handle of a paged tensor set — the value a
        ``ScanSet`` of it gives the executor — bound to the device cache
        under (set, write version). Never materialises."""
        from netsdb_tpu_torch.storage.paged import PagedTensor

        with self._lock:
            s, pm = self._paged_item(ident)
            pt = PagedTensor(self.page_store(), pm.name, rw=pm.rw,
                             placement=s.placement, device=self.device)
            pt.devcache = self.device_cache()
            pt.cache_scope = (str(ident), s.version)
            pt.cache_version_fn = functools.partial(self.version_of, ident)
            return pt

    def paged_matmul(self, ident: SetIdentifier, rhs) -> torch.Tensor:
        """``stored matrix @ rhs`` with the matrix streamed page by page
        through the client's device (one block, ``rhs`` and the staged
        next blocks resident at a time), its blocks cached across
        calls."""
        with self._lock:
            s, pm = self._paged_item(ident)
            ps, version = self.page_store(), s.version
        with pm.rw.read():
            return ps.matmul_streamed(pm.name, rhs, device=self.device,
                                      devcache=self.device_cache(),
                                      cache_scope=str(ident),
                                      cache_version=version)

    def restore_paged_matrix(self, ident: SetIdentifier, blocks,
                             row_block: int) -> None:
        """Rebuild a paged tensor set from its arena pages — the
        RESYNC_FOLLOWER replay path. ``blocks`` are the leader's row
        blocks in order; each is written as its own arena page (ragged
        blocks are fine: readers take a page's rows from its size), so
        the matrix never materialises densely on the follower."""
        with self._lock:
            s = self._writable(ident)
            dead = list(s.items or [])
            if not blocks:
                s.items = []
                s.nbytes = 0
            else:
                name = f"{s.ident}#g{next(self._gen)}.mat"
                ps = self.page_store()
                for i, b in enumerate(blocks):
                    ps.put(name, np.ascontiguousarray(b),
                           row_block=max(int(row_block), 1), append=i > 0)
                s.items = [_PagedMatrix(name)]
            self._touch(s)
        self._drop_pages(dead)

    # --- dedup (reference addSharedMapping, SharedTensorBlockSet) -----
    def add_shared_mapping(self, private: SetIdentifier,
                           shared: SetIdentifier,
                           mapping: Optional[Dict] = None) -> None:
        """Point ``private`` at ``shared``'s storage (reference
        ``PDBClient::addSharedMapping``): its items go, its reads are
        ``shared``'s, and it is read-only from now on."""
        with self._lock:
            s = self._require(private)
            dead = list(s.items or [])
            s.alias_of = shared
            s.shared_mapping = dict(mapping or {})
            s.items = []
            s.nbytes = 0
            self._pooled.discard(private)
            self._touch(s)
        self._drop_pages(dead)

    def set_pooled(self, ident: SetIdentifier, pooled: Any) -> None:
        """Replace a weight set's tensor by its pooled form
        (``dedup/pool.py``); the dense tensor is freed once nothing else
        holds it."""
        with self._lock:
            s = self._writable(ident)
            s.items = [pooled]
            self._pooled.add(ident)
            self._touch(s)

    def live_pool_bytes(self) -> int:
        """Bytes of every distinct block pool that a set holds, each pool
        once however many sets share it; a pool drops out with the last
        set that holds it."""
        with self._lock:
            return self._live_pool_bytes()

    def _pooled_items(self):
        """``(set, item)`` of every pooled tensor a live set holds;
        forgets removed sets. Caller holds the lock."""
        from netsdb_tpu_torch.dedup.pool import PooledTensor

        for ident in list(self._pooled):
            s = self._sets.get(ident)
            if s is None or s.alias_of is not None:
                self._pooled.discard(ident)
                continue
            for item in s.items or []:
                if isinstance(item, PooledTensor):
                    yield s, item

    def _live_pool_bytes(self) -> int:
        pools = {id(item.pool): item.pool.nbytes
                 for _, item in self._pooled_items()}
        return sum(pools.values())

    def _live_pool_cache_bytes(self) -> int:
        """Bytes held by the pooled sets' cached assemblies (they count
        toward the eviction budget: the caches may be the pressure)."""
        return sum(item.cache_nbytes for _, item in self._pooled_items())

    def drop_pool_caches(self) -> int:
        """Release every pooled set's cached assembly (the cheapest
        memory to give back: one gather rebuilds it); each set whose
        assembly went counts as written, so the programs that read the
        assembly in place drop it too. Returns the bytes released."""
        with self._lock:
            released = 0
            for s, item in list(self._pooled_items()):
                n = item.drop_cache()
                if n:
                    released += n
                    self._touch(s)
            return released

    # --- persistence --------------------------------------------------
    def _spill_path(self, ident: SetIdentifier) -> str:
        safe = f"{ident.db}__{ident.set}".replace("/", "_")
        return os.path.join(self.config.data_dir, f"{safe}.ptset")

    def flush(self, ident: SetIdentifier) -> str:
        """Write a set to ``config.data_dir`` (it stays in memory). A
        paged matrix or relation is read page by page on the host and
        written whole; it comes back paged."""
        from netsdb_tpu_torch.relational.outofcore import PagedColumns
        from netsdb_tpu_torch.storage.paged import PagedObjects

        with self._lock:
            s = self._require(ident)
            if s.items is not None:
                self.stats.hits += 1  # a flush reads the set
            payload = []
            items = self._items_locked(s)
            if s.ident in self._pooled:
                items = [i.assemble() if hasattr(i, "assemble") else i
                         for i in items]  # a pool is not a disk format
            for item in items:
                if isinstance(item, PagedObjects):
                    payload.append(("paged_objects", item.to_list()))
                elif isinstance(item, PagedColumns):
                    payload.append(("paged_table",
                                    item.to_host_table().__getstate__()))
                elif isinstance(item, _PagedMatrix):
                    blocks = [b for _, b in
                              self.page_store().stream_blocks(item.name)]
                    payload.append(("paged", np.concatenate(blocks)))
                elif isinstance(item, BlockedTensor):
                    payload.append(("blocked", _host_tensor(item.data),
                                    item.meta.shape, item.meta.block_shape))
                elif isinstance(item, (torch.Tensor, ShardedTensor)):
                    payload.append(("tensor", _host_tensor(item)))
                elif type(item).__name__ == "ColumnTable":
                    payload.append(("table", item.__getstate__()))
                else:
                    payload.append(("object", item))
            record = {"persistence": s.persistence, "storage": s.storage,
                      "type_name": s.type_name, "eviction": s.eviction,
                      "placement": (s.placement.to_meta()
                                    if s.placement is not None else None),
                      "alias_of": (tuple(s.alias_of) if s.alias_of
                                   else None),
                      "shared_mapping": s.shared_mapping,
                      "items": payload}
            self.config.ensure_dirs()
            path = self._spill_path(ident)
            tmp = f"{path}.tmp{os.getpid()}"
            with open(tmp, "wb") as f:
                pickle.dump(record, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, path)
            self.stats.spills += 1
            return path

    def load_set(self, ident: SetIdentifier) -> None:
        """Bring a flushed set back (after a restart, in a fresh client
        over the same ``root_dir``), paged sets as paged sets."""
        with self._lock:
            if ident not in self._sets:
                self._sets[ident] = _StoredSet(ident, None,
                                               persistence="persistent")
            self._items_locked(self._sets[ident])

    def _load_from_disk(self, s: _StoredSet) -> None:
        path = self._spill_path(s.ident)
        if not os.path.exists(path):
            raise KeyError(f"set {s.ident} has no data in memory or on disk")
        with open(path, "rb") as f:  # a file this store wrote
            record = pickle.load(f)
        s.storage = record["storage"]
        s.persistence = record["persistence"]
        s.type_name = record.get("type_name", "tensor")
        s.eviction = record.get("eviction", s.eviction)
        if record.get("alias_of"):
            s.alias_of = SetIdentifier(*record["alias_of"])
            s.shared_mapping = record.get("shared_mapping")
        self._pooled.discard(s.ident)  # a pooled set reloads dense
        if s.placement is None and record["placement"]:
            s.placement = Placement.from_meta(record["placement"])
        s.items = []
        items = []
        for kind, *data in record["items"]:
            if kind == "paged":
                self._ingest_paged(s, data[0])
                self._touch(s)
                return
            if kind == "paged_objects":
                self._ingest_paged_objects(s, data[0])
                self._touch(s)
                return
            if kind == "paged_table":
                from netsdb_tpu_torch.relational.table import ColumnTable

                table = ColumnTable.__new__(ColumnTable)
                table.__setstate__(data[0])
                self._ingest_paged_relation(s, table)
                self._touch(s)
                return
            if kind == "blocked":
                items.append(BlockedTensor(data[0].to(self.device),
                                           BlockMeta(tuple(data[1]),
                                                     tuple(data[2]))))
            elif kind == "tensor":
                items.append(data[0].to(self.device))
            elif kind == "table":
                from netsdb_tpu_torch.relational.table import ColumnTable

                table = ColumnTable.__new__(ColumnTable)
                table.__setstate__(data[0])
                items.append(table.to(self.device))
            else:
                items.append(data[0])
        s.items = self._placed(s, items)
        self._touch(s)

    # --- eviction -----------------------------------------------------
    def _maybe_evict(self, exclude: Optional[SetIdentifier] = None) -> None:
        """Past ``max_host_bytes``, flush and drop memory sets by their
        policies until the total fits (or nothing but ``exclude`` is
        left). Caller holds the store lock."""
        total = sum(s.nbytes for s in self._sets.values()
                    if s.items is not None and s.storage == "memory")
        total += self._live_pool_bytes() + self._live_pool_cache_bytes()
        if total <= self.max_host_bytes:
            return
        # cached pool assemblies go first: one gather rebuilds them
        total -= self.drop_pool_caches()
        if total <= self.max_host_bytes:
            return
        candidates = [s for s in self._sets.values()
                      if s.items is not None and s.ident != exclude
                      and s.nbytes > 0 and s.storage == "memory"
                      and s.alias_of is None]

        def key(s: _StoredSet):
            if s.eviction == "mru":
                return -s.last_access
            if s.eviction == "random":
                return random.random()
            return s.last_access  # lru

        pool_before = self._live_pool_bytes()
        for s in sorted(candidates, key=key):
            if total <= self.max_host_bytes:
                break
            self.flush(s.ident)
            total -= s.nbytes
            s.items = None
            s.nbytes = 0
            self.stats.evictions += 1
            _announce(self.program_scope(s.ident))
            if s.ident in self._pooled:
                # the last set holding a pool releases it: credit the
                # bytes, or the loop evicts everyone else too
                pool_now = self._live_pool_bytes()
                total -= pool_before - pool_now
                pool_before = pool_now

    # --- helpers ------------------------------------------------------
    def _items_locked(self, s: _StoredSet) -> List[Any]:
        if s.items is None:
            self._load_from_disk(s)
            self.stats.misses += 1
            self.stats.loads += 1
        return s.items

    @staticmethod
    def _placed(s: _StoredSet, items: List[Any]) -> List[Any]:
        if s.placement is None:
            return list(items)
        return [s.placement.apply(i) for i in items]

    def _require(self, ident: SetIdentifier) -> _StoredSet:
        s = self._sets.get(ident)
        if s is None:
            raise KeyError(f"unknown set {ident}; create_set first")
        return s

    def _writable(self, ident: SetIdentifier) -> _StoredSet:
        s = self._require(ident)
        if s.alias_of is not None:
            raise ValueError(f"set {ident} aliases {s.alias_of}; it is "
                             f"read-only")
        return s
