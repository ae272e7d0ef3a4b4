"""Client facade — counterpart of ``netsdb_tpu/client.py`` (the
reference's ``PDBClient``): catalog + set store + executor behind one
object, in-process.

The client owns a device. Every set it stores, every scan value and
every result lives there: ``"cuda"`` unless the caller passes
``device="cpu"``. A placed set spreads over the visible positions of
that device type (every card, or the virtual positions of
:func:`~netsdb_tpu_torch.parallel.mesh.virtual_devices`). A paged set
(``storage="paged"``) stays in the host page arena and streams through
the device when a query reads it. A relation set
(``type_name="table"``) holds one column table on the client's device,
filled by :meth:`Client.send_table`; its planner statistics are
collected from the host arrays at ingest. Arguments of the reference
that belong to later slices raise ``NotImplementedError`` naming the
ROADMAP.md item.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from netsdb_tpu_torch.catalog.catalog import Catalog
from netsdb_tpu_torch.config import Configuration, resolve_device
from netsdb_tpu_torch.core.blocked import BlockedTensor, owned_tensor
from netsdb_tpu_torch.parallel.mesh import visible_devices
from netsdb_tpu_torch.parallel.placement import Placement
from netsdb_tpu_torch.storage.store import SetIdentifier, SetStore


def table_info(table) -> Dict[str, Any]:
    """The analyze-set summary of one relation: its column statistics
    (from the table's cache, filled at ingest), dictionaries and row
    count."""
    from netsdb_tpu_torch.relational.stats import analyze_table

    return {"stats": dict(analyze_table(table)),
            "dicts": dict(table.dicts), "num_rows": table.num_rows}


class Client:
    """In-process database client.

    =======================  =====================================
    reference (PDBClient)    here
    =======================  =====================================
    createDatabase           :meth:`create_database`
    createSet<T>             :meth:`create_set`
    removeSet                :meth:`remove_set`
    sendData<T>              :meth:`send_data` / :meth:`send_matrix` /
                             :meth:`send_table`
    getSetIterator<T>        :meth:`get_set_iterator`
    registerType(.so)        :meth:`register_type`
    executeComputations      :meth:`execute_computations`
    clearSet                 :meth:`clear_set`
    =======================  =====================================
    """

    def __init__(self, config: Optional[Configuration] = None,
                 catalog_path: Optional[str] = None,
                 address: Optional[str] = None,
                 device: Union[str, torch.device, None] = None):
        if address is not None:
            raise NotImplementedError(
                "Client(address=...) — the served RemoteClient — is not "
                "ported yet: ROADMAP.md A7")
        self.config = config if config is not None else Configuration()
        self.device = resolve_device(device)
        self.catalog = Catalog(catalog_path or ":memory:")
        self.store = SetStore(self.config, self.device)

    # --- DDL ----------------------------------------------------------
    def create_database(self, db: str) -> None:
        self.catalog.create_database(db)

    def create_set(self, db: str, set_name: str, type_name: str = "tensor",
                   persistence: str = "transient", eviction: str = "lru",
                   partition_lambda: Optional[str] = None, placement=None,
                   storage: str = "memory") -> SetIdentifier:
        """Create a set. ``placement`` (a :class:`~netsdb_tpu_torch.
        parallel.placement.Placement` or its ``to_meta`` dict) declares
        how the set is sharded over the mesh of the client's device
        positions: every tensor stored into the set is placed with it,
        and the catalog keeps it under ``"sharding"``.

        ``storage="paged"`` keeps the set's matrix as pages of the
        shared page arena: queries stream it through nodes that carry a
        ``tensor_fold`` (a placed paged set places each staged block).
        ``persistence="persistent"`` marks the set for
        :meth:`flush_data`. ``type_name="tensor4d"`` makes a set that
        is scanned as its item list even when it holds one tensor (the
        conv model's image sets); ``type_name="table"`` a relation set
        for :meth:`send_table` (a paged relation raises, ROADMAP.md A6,
        and a placed one when data arrives, A4).

        ``eviction`` keeps the reference's default, ``"lru"``: the port
        never spills a set under a host-memory budget, so another policy
        raises (ROADMAP.md A2). ``partition_lambda``, the reference's
        named key function for the dispatcher, raises (ROADMAP.md A6)."""
        if eviction != "lru":
            raise NotImplementedError(
                f"create_set(eviction={eviction!r}): set eviction under a "
                f"host-memory budget is not ported yet: ROADMAP.md A2")
        if partition_lambda is not None:
            raise NotImplementedError(
                "create_set(partition_lambda=...): the dispatcher's "
                "partitioning is not ported yet: ROADMAP.md A6")
        if isinstance(placement, dict):
            placement = Placement.from_meta(placement)
        if placement is not None and not isinstance(placement, Placement):
            raise TypeError(f"placement must be a Placement or its meta "
                            f"dict, got {type(placement).__name__}")
        if storage not in ("memory", "paged"):
            raise ValueError(f"storage must be 'memory' or 'paged', "
                             f"got {storage!r}")
        if storage == "paged" and type_name not in ("tensor", "matrix"):
            raise NotImplementedError(
                f"create_set(type_name={type_name!r}, storage='paged'): "
                f"paged object sets and relations are not ported yet: "
                f"ROADMAP.md A6")
        if persistence not in ("transient", "persistent"):
            raise ValueError(f"persistence must be 'transient' or "
                             f"'persistent', got {persistence!r}")
        if not self.catalog.database_exists(db):
            raise KeyError(f"database {db!r} does not exist; "
                           f"create_database first")
        meta = {}
        if placement is not None:
            # resolves the axes now: two size-0 axes raise before the
            # catalog row is written
            placement.mesh(visible_devices(self.device.type))
            meta["sharding"] = placement.to_meta()
        self.catalog.create_set(db, set_name, type_name, meta, persistence)
        ident = SetIdentifier(db, set_name)
        self.store.create_set(ident, placement=placement, storage=storage,
                              persistence=persistence, type_name=type_name)
        return ident

    def remove_set(self, db: str, set_name: str) -> None:
        self.catalog.remove_set(db, set_name)
        self.store.remove_set(SetIdentifier(db, set_name))

    def clear_set(self, db: str, set_name: str) -> None:
        self.store.clear_set(SetIdentifier(db, set_name))

    def set_exists(self, db: str, set_name: str) -> bool:
        return self.catalog.set_exists(db, set_name)

    def register_type(self, type_name: str, entry_point: str) -> None:
        """Register an op/model implementation by dotted import path
        (reference registerType of a user-type .so)."""
        self.catalog.register_type(type_name, entry_point)

    # --- data path ----------------------------------------------------
    def _on_device(self, item: Any) -> Any:
        if isinstance(item, (np.ndarray, torch.Tensor)):
            return owned_tensor(item, device=self.device)
        return item

    def send_data(self, db: str, set_name: str, items: Sequence[Any]) -> None:
        """Append items to a set. Arrays and tensors move to the
        client's device; other objects are stored as they are. A paged
        set takes one matrix, which stays on the host."""
        ident = SetIdentifier(db, set_name)
        if self.store.storage_of(ident) == "paged":
            self.store.add_data(ident, list(items))
            return
        self.store.add_data(ident, [self._on_device(i) for i in items])

    def send_matrix(self, db: str, set_name: str,
                    dense: Union[np.ndarray, torch.Tensor],
                    block_shape: Optional[Tuple[int, int]] = None,
                    dtype=None) -> BlockedTensor:
        """Load a dense matrix as one blocked tensor on the client's
        device (reference ``FFMatrixUtil::load_matrix`` + sendData). A
        paged set pages it into the arena from the host instead; the
        returned tensor is then the host copy."""
        block_shape = tuple(block_shape or self.config.default_block_shape)
        ident = SetIdentifier(db, set_name)
        paged = self.store.storage_of(ident) == "paged"
        t = BlockedTensor.from_dense(
            dense, block_shape, dtype=dtype,
            device="cpu" if paged else self.device)
        self.store.put_tensor(ident, t)
        cat = self.catalog.get_set(db, set_name)
        if cat is not None:
            cat["meta"].update(shape=list(t.shape),
                               block_shape=list(t.meta.block_shape),
                               dtype=str(t.dtype).replace("torch.", ""))
            self.catalog.update_set_meta(db, set_name, cat["meta"])
        return t

    def send_table(self, db: str, set_name: str, rows_or_table,
                   date_cols: Sequence[str] = (), append: bool = False):
        """Ingest a relation as one column table on the client's device:
        row dicts are dictionary-encoded and analysed on the host, then
        uploaded once; a table on another device moves with its
        statistics. ``append=True`` adds the rows to the stored relation
        (the reference's addData) instead of replacing it. The catalog
        records the set's row count and columns. Returns the table as
        stored (for an append, the batch)."""
        from netsdb_tpu_torch.relational.stats import analyze_table
        from netsdb_tpu_torch.relational.table import ColumnTable

        if isinstance(rows_or_table, ColumnTable):
            table = rows_or_table
            if table.device.type == "cpu":
                analyze_table(table)  # on the host, before any upload
            table = table.to(self.device)
        else:
            table = ColumnTable.from_rows(list(rows_or_table), date_cols,
                                          device=self.device)
        ident = SetIdentifier(db, set_name)
        if append:
            self.store.append_table(ident, table)
            num_rows = self.get_table(db, set_name).num_rows
        else:
            self.store.clear_set(ident)
            self.store.add_data(ident, [table])
            num_rows = table.num_rows
        self.catalog.update_table_meta(db, set_name, num_rows, table.cols)
        return table

    def get_table(self, db: str, set_name: str):
        """The one column table a relation set holds."""
        from netsdb_tpu_torch.relational.table import ColumnTable

        items = self.store.get_items(SetIdentifier(db, set_name))
        tables = [i for i in items if isinstance(i, ColumnTable)]
        if len(tables) != 1:
            raise ValueError(f"set {db}:{set_name} holds {len(tables)} "
                             f"tables; expected 1")
        return tables[0]

    def analyze_set(self, db: str, set_name: str) -> Dict[str, Any]:
        """Planner statistics of a stored relation — ``{"stats",
        "dicts", "num_rows"}`` — from the statistics collected at
        ingest (the reference's ``StorageCollectStats``); the DAG
        builders read these summaries, never the table."""
        return table_info(self.get_table(db, set_name))

    def get_tensor(self, db: str, set_name: str) -> BlockedTensor:
        return self.store.get_tensor(SetIdentifier(db, set_name))

    def get_set_iterator(self, db: str, set_name: str) -> Iterator[Any]:
        """The set's items, one by one (a paged matrix raises)."""
        return self.store.scan(SetIdentifier(db, set_name))

    def paged_matmul(self, db: str, set_name: str, rhs) -> torch.Tensor:
        """``stored matrix @ rhs`` with the matrix of a paged set streamed
        page by page through the client's device."""
        return self.store.paged_matmul(SetIdentifier(db, set_name), rhs)

    def flush_data(self) -> None:
        """Write every persistent set to ``config.data_dir`` (reference
        ``flushData``); ``store.load_set`` brings a set back in a fresh
        client over the same ``root_dir``, paged sets as paged sets."""
        for ident in self.store.list_sets():
            info = self.catalog.get_set(ident.db, ident.set)
            if info and info.get("persistence") == "persistent":
                self.store.flush(ident)

    # --- query execution ----------------------------------------------
    def execute_computations(self, *sinks, job_name: str = "job",
                             materialize: bool = True):
        """Plan and run a Computation DAG (reference
        ``QueryClient::executeComputations``); ``sinks`` are
        :class:`~netsdb_tpu_torch.plan.computations.WriteSet` nodes."""
        from netsdb_tpu_torch.plan.executor import execute_computations

        return execute_computations(self, list(sinks), job_name=job_name,
                                    materialize=materialize)
