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
file format is the port's own. Paged object sets and relations belong
to ROADMAP.md A6 (part 2).

A relation set holds one :class:`~netsdb_tpu_torch.relational.table.
ColumnTable` on the store's device; :meth:`SetStore.append_table` adds
a batch of rows to it, remapping the batch's dictionary codes into the
stored dictionaries, under the store lock.

A set keeps the type it was created with. A ``tensor4d`` set (the conv
model's image, filter and bias sets) is scanned as its item list even
when it holds one tensor, as the reference scans a set of numpy arrays
(:meth:`SetStore.scans_as_list`); any other set holding one tensor is
scanned as that tensor.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import os
import pickle
import threading
from typing import Any, Dict, Iterator, List, NamedTuple, Optional

import numpy as np
import torch

from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.core.blocked import BlockedTensor, BlockMeta
from netsdb_tpu_torch.parallel.mesh import ShardedTensor
from netsdb_tpu_torch.parallel.placement import Placement
from netsdb_tpu_torch.utils.locks import RWLock


# set types whose scan is always the item list
LIST_SCAN_TYPES = frozenset({"tensor4d"})


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
                 device=None):
        self.config = config if config is not None else Configuration()
        self.device = torch.device(device if device is not None else "cpu")
        self._sets: Dict[SetIdentifier, _StoredSet] = {}
        self._lock = threading.RLock()
        self._page_store = None
        self._device_cache = None
        self._gen = itertools.count()
        self._version_ctr = itertools.count(1)

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

    def _touch(self, s: _StoredSet) -> None:
        """Advance a set's write version and drop the set's cached device
        blocks — called by every path that changes a set's content (every
        write of a tensor set is whole-set)."""
        s.version = next(self._version_ctr)
        if self._device_cache is not None:
            self._device_cache.invalidate(str(s.ident))

    def version_of(self, ident: SetIdentifier) -> int:
        """The set's write version (0: unknown set)."""
        s = self._sets.get(ident)
        return s.version if s is not None else 0

    # --- set lifecycle ------------------------------------------------
    def create_set(self, ident: SetIdentifier, placement: Optional[Any] = None,
                   storage: str = "memory",
                   persistence: str = "transient",
                   type_name: str = "tensor") -> None:
        """Create the set if it is new. A placement given for an existing
        set replaces its placement and re-places what it holds; an
        existing set keeps its type."""
        if storage not in ("memory", "paged"):
            raise ValueError(f"storage must be 'memory' or 'paged', "
                             f"got {storage!r}")
        with self._lock:
            s = self._sets.get(ident)
            if s is None:
                s = self._sets[ident] = _StoredSet(
                    ident, [], persistence=persistence, placement=placement,
                    storage=storage, type_name=type_name)
                self._touch(s)
            elif placement is not None:
                s.placement = placement
                if s.storage == "memory":
                    s.items = [placement.apply(i)
                               for i in self._items_locked(s)]
                self._touch(s)

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
        """Return the pages of replaced or cleared paged matrices to the
        arena, once the streams reading them are done."""
        for item in items:
            if isinstance(item, _PagedMatrix):
                with item.rw.write():
                    self.page_store().drop(item.name)

    # --- writes -------------------------------------------------------
    def add_data(self, ident: SetIdentifier, items: List[Any]) -> None:
        """Append items. A paged set takes exactly one matrix (a 2-D
        array or tensor), which replaces its content."""
        with self._lock:
            s = self._require(ident)
            if s.storage == "paged":
                if len(items) != 1 or np.ndim(items[0]) != 2 or not \
                        isinstance(items[0], (np.ndarray, torch.Tensor)):
                    raise NotImplementedError(
                        f"paged set {ident}: paged object sets and "
                        f"relations are not ported yet (ROADMAP.md A6); a "
                        f"paged tensor set holds one matrix")
                dense = items[0]
                dead = self._ingest_paged(
                    s, _host(dense) if isinstance(dense, torch.Tensor)
                    else np.asarray(dense))
            else:
                dead = []
                s.items = self._items_locked(s) + self._placed(s, items)
            self._touch(s)
        self._drop_pages(dead)

    def put_tensor(self, ident: SetIdentifier, tensor: BlockedTensor) -> None:
        """Replace a set's content with one blocked matrix (every weight
        set is exactly one). A paged set pages the matrix into the arena
        from the host."""
        with self._lock:
            s = self._require(ident)
            if s.storage == "paged":
                dead = self._ingest_paged(s, _host(tensor.to_dense()))
            else:
                dead = []
                s.items = self._placed(s, [tensor])
            self._touch(s)
        self._drop_pages(dead)

    def _ingest_paged(self, s: _StoredSet, dense: np.ndarray) -> List[Any]:
        """Page one matrix into the arena under a fresh name; returns the
        replaced items, whose pages the caller frees outside the lock."""
        dead = list(s.items or [])
        name = f"{s.ident}#g{next(self._gen)}.mat"
        self.page_store().put(name, np.ascontiguousarray(dense))
        s.items = [_PagedMatrix(name)]
        return dead

    def append_table(self, ident: SetIdentifier, table) -> None:
        """Append a batch of rows to a relation set (the reference's
        addData flow, ``StorageAddData``): the stored table and the
        batch concatenate on the device with a dictionary remap, under
        the store lock. An empty set takes the batch as its table."""
        from netsdb_tpu_torch.relational.table import (ColumnTable,
                                                       concat_tables)

        with self._lock:
            s = self._require(ident)
            if s.storage == "paged":
                raise NotImplementedError(
                    f"append_table on paged set {ident}: paged relations "
                    f"are not ported yet (ROADMAP.md A6)")
            items = self._items_locked(s)
            tables = [i for i in items if isinstance(i, ColumnTable)]
            if len(items) != len(tables) or len(tables) > 1:
                raise ValueError(
                    f"append_table needs a single-relation table set; "
                    f"{ident} holds {len(items)} items ({len(tables)} "
                    f"tables); appending would drop the rest")
            table = table.to(self.device)
            new = concat_tables(tables[0], table) if tables else table
            s.items = self._placed(s, [new])
            self._touch(s)

    # --- reads --------------------------------------------------------
    def get_items(self, ident: SetIdentifier) -> List[Any]:
        with self._lock:
            return list(self._items_locked(self._require(ident)))

    def scan(self, ident: SetIdentifier) -> Iterator[Any]:
        """A set's items, one by one — reference ``SetScan`` /
        ``SetIterator``. A paged matrix streams through queries and is
        never an item here: its scan raises."""
        items = self.get_items(ident)
        if any(isinstance(i, _PagedMatrix) for i in items):
            raise ValueError(
                f"set {ident} holds a paged matrix: it streams through a "
                f"node with a tensor_fold, or through paged_matmul")
        return iter(items)

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

    # --- persistence --------------------------------------------------
    def _spill_path(self, ident: SetIdentifier) -> str:
        safe = f"{ident.db}__{ident.set}".replace("/", "_")
        return os.path.join(self.config.data_dir, f"{safe}.ptset")

    def flush(self, ident: SetIdentifier) -> str:
        """Write a set to ``config.data_dir`` (it stays in memory). A
        paged matrix is read page by page on the host and written as one
        array; it comes back paged."""
        with self._lock:
            s = self._require(ident)
            payload = []
            for item in self._items_locked(s):
                if isinstance(item, _PagedMatrix):
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
                      "type_name": s.type_name,
                      "placement": (s.placement.to_meta()
                                    if s.placement is not None else None),
                      "items": payload}
            self.config.ensure_dirs()
            path = self._spill_path(ident)
            tmp = f"{path}.tmp{os.getpid()}"
            with open(tmp, "wb") as f:
                pickle.dump(record, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, path)
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
        if s.placement is None and record["placement"]:
            s.placement = Placement.from_meta(record["placement"])
        s.items = []
        items = []
        for kind, *data in record["items"]:
            if kind == "paged":
                self._ingest_paged(s, data[0])
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

    # --- helpers ------------------------------------------------------
    def _items_locked(self, s: _StoredSet) -> List[Any]:
        if s.items is None:
            self._load_from_disk(s)
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
