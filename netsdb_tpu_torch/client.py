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
filled by :meth:`Client.send_table`, or, paged, its columns as row-chunk
pages of the arena that queries fold chunk by chunk; its planner
statistics are collected from the host arrays at ingest. A set of
``type_name="objects"`` columnarises the records it is sent into one
such table, so ``Join(on=...)`` runs over it on the device; any other
set keeps host records as they are (paged: as pickled-batch pages of the
arena, streamed by queries). Arguments of the reference that belong to
later slices raise ``NotImplementedError`` naming the ROADMAP.md item.

``Client(address="host:port")`` returns the served form instead: a
:class:`~netsdb_tpu_torch.serve.client.RemoteClient` of a resident daemon
(``python -m netsdb_tpu_torch.serve.server``), as the reference's does.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from netsdb_tpu_torch.catalog.catalog import Catalog
from netsdb_tpu_torch.config import (Configuration, enable_compilation_cache,
                                     resolve_device)
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
    addSharedMapping         :meth:`add_shared_mapping`
    StorageCollectStats      :meth:`collect_stats`
    =======================  =====================================
    """

    def __new__(cls, config: Optional[Configuration] = None,
                catalog_path: Optional[str] = None,
                address: Optional[str] = None,
                device: Union[str, torch.device, None] = None,
                token: Optional[str] = None, replicas=None):
        if address is not None:
            # the served form: a thin RPC client of a resident daemon,
            # which owns the store and the card
            from netsdb_tpu_torch.serve.client import RemoteClient

            return RemoteClient(address, token=token, replicas=replicas)
        if replicas:
            raise ValueError("replicas= needs address=")
        return super().__new__(cls)

    def __init__(self, config: Optional[Configuration] = None,
                 catalog_path: Optional[str] = None,
                 address: Optional[str] = None,
                 device: Union[str, torch.device, None] = None,
                 token: Optional[str] = None, replicas=None):
        del address, token, replicas  # consumed by __new__
        self.config = config if config is not None else Configuration()
        self.device = resolve_device(device)
        # the kernel libraries build into (and load from) the configured
        # compilation cache
        enable_compilation_cache(self.config)
        self.catalog = Catalog(catalog_path or ":memory:")
        self.store = SetStore(self.config, self.device)
        self._mesh = None
        self._advisor = None  # the placement advisor (learning/)
        self._advisor_key = "default"
        self._advisor_arm = None  # the arm this client's DDL applied

    @property
    def mesh(self):
        """The mesh of the last ``create_set`` given a placement (None
        while every set is on one device)."""
        return self._mesh

    # --- self-learning placement --------------------------------------
    def set_placement_advisor(self, advisor, key: str = "default") -> None:
        """Install a placement advisor (``learning.advisor.
        PlacementAdvisor`` or ``learning.rl.DRLPlacementAdvisor``) that
        the DDL and query paths consult, as the reference's
        self-learning hooks at set creation and scheduling do. ``key``
        names the workload whose measured history drives placement:
        :meth:`create_set` applies the arm the advisor chooses for
        ``key`` (a ``Placement`` under ``"placement"`` or the set's
        name, or a block shape under ``"block"``), and
        :meth:`execute_computations` records each job's elapsed time
        against the arm that was applied."""
        self._advisor = advisor
        self._advisor_key = key

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
        ``tensor_fold`` (a placed paged set places each staged block);
        host records sent to a paged set are kept as pickled-batch pages
        that queries and :meth:`get_set_iterator` stream.
        ``persistence="persistent"`` marks the set for
        :meth:`flush_data`. ``type_name="tensor4d"`` makes a set that
        is scanned as its item list even when it holds one tensor (the
        conv model's image sets); ``type_name="table"`` a relation set
        for :meth:`send_table`. A paged relation keeps its columns as
        row-chunk pages of the arena, and queries stream it through
        nodes that carry a relational ``fold``. A placed relation set
        lays out what :meth:`send_table` sends over the mesh (rows padded
        to the shard granularity, a validity mask, fact tables
        row-sharded, dimensions replicated), and a paged and placed one
        shards each streamed chunk. ``type_name="objects"`` columnarises what
        :meth:`send_data` sends (a paged ``objects`` set pages the table).

        ``eviction`` (``"lru"``, ``"mru"`` or ``"random"``) orders the set
        among those the store flushes and drops when its memory sets
        outgrow ``store.max_host_bytes`` (on the client's device); a
        dropped set reloads on its next read. ``partition_lambda`` names
        the key function the dispatcher routes the set's records by (the
        reference's createSet with a dispatch computation); the catalog
        keeps it in the set's meta."""
        from netsdb_tpu_torch.storage.store import EVICTION_POLICIES

        if eviction not in EVICTION_POLICIES:
            raise ValueError(f"eviction must be one of {EVICTION_POLICIES}, "
                             f"got {eviction!r}")
        if isinstance(placement, dict):
            placement = Placement.from_meta(placement)
        if placement is not None and not isinstance(placement, Placement):
            raise TypeError(f"placement must be a Placement or its meta "
                            f"dict, got {type(placement).__name__}")
        if storage not in ("memory", "paged"):
            raise ValueError(f"storage must be 'memory' or 'paged', "
                             f"got {storage!r}")
        if persistence not in ("transient", "persistent"):
            raise ValueError(f"persistence must be 'transient' or "
                             f"'persistent', got {persistence!r}")
        if not self.catalog.database_exists(db):
            raise KeyError(f"database {db!r} does not exist; "
                           f"create_database first")
        meta: Dict[str, Any] = {}
        if partition_lambda:
            meta["partition_lambda"] = partition_lambda
        arm = (self._advisor.choose(self._advisor_key)
               if self._advisor is not None else None)
        if placement is None and arm is not None:
            # an arm may carry the set's sharding (keyed "placement" or
            # by the set's name): the arm is then the configuration in
            # force for this DDL, and jobs record against it
            spec = arm.specs.get("placement") or arm.specs.get(set_name)
            if isinstance(spec, Placement):
                placement = spec
                self._advisor_arm = arm
                self._advisor.db.record(
                    f"{self._advisor_key}:decisions",
                    plan_key=f"set:{db}.{set_name}", elapsed_s=0.0,
                    config_label=arm.label)
        if placement is not None:
            # resolves the axes now: two size-0 axes raise before the
            # catalog row is written
            mesh = placement.mesh(visible_devices(self.device.type))
            meta["sharding"] = placement.to_meta()
            # the placement-history row: the sharding DDL applied
            from netsdb_tpu_torch.learning.history import get_history_db

            get_history_db().record(
                f"{db}.{set_name}:placement",
                plan_key=f"set:{db}.{set_name}", elapsed_s=0.0,
                config_label=placement.label())
        if arm is not None and type_name == "tensor" \
                and "block" in arm.specs:
            # the arm's block shape (the reference's page-size knob)
            # lands in the catalog, where send_matrix and the models
            # read it; stashed only when the arm decided something for
            # THIS set, so a later set does not re-tag the job
            meta["placement"] = arm.label
            meta["block_shape"] = list(arm.specs["block"])
            self._advisor_arm = arm
            self._advisor.db.record(f"{self._advisor_key}:decisions",
                                    plan_key=f"set:{db}.{set_name}",
                                    elapsed_s=0.0, config_label=arm.label)
        self.catalog.create_set(db, set_name, type_name, meta, persistence)
        ident = SetIdentifier(db, set_name)
        self.store.create_set(ident, placement=placement, storage=storage,
                              persistence=persistence, type_name=type_name,
                              eviction=eviction)
        if placement is not None:
            self._mesh = mesh
        return ident

    def remove_set(self, db: str, set_name: str) -> None:
        """Drop a set; a paged set's pages go back to the arena once the
        streams reading them are done."""
        self.catalog.remove_set(db, set_name)
        self.store.remove_set(SetIdentifier(db, set_name))

    def clear_set(self, db: str, set_name: str) -> None:
        self.store.clear_set(SetIdentifier(db, set_name))

    def set_exists(self, db: str, set_name: str) -> bool:
        return self.catalog.set_exists(db, set_name)

    def register_type(self, type_name: str, entry_point: str,
                      source: Optional[str] = None,
                      ship_module: bool = False) -> None:
        """Register an op/model implementation by dotted import path
        (reference registerType of a user-type .so). ``source`` ships
        the module's code with the type, so a daemon that never
        installed the module can still bind it (the reference's
        replicated .so, ``PDBCatalog.h:45-50``); ``ship_module=True``
        reads it off the locally importable module."""
        if ship_module and source is None:
            from netsdb_tpu_torch.catalog.catalog import read_module_source

            source = read_module_source(entry_point)
        self.catalog.register_type(type_name, entry_point, source=source)

    # --- data path ----------------------------------------------------
    def _on_device(self, item: Any) -> Any:
        if isinstance(item, (np.ndarray, torch.Tensor)):
            return owned_tensor(item, device=self.device)
        return item

    def send_data(self, db: str, set_name: str, items: Sequence[Any]) -> None:
        """Append items to a set. Arrays and tensors move to the
        client's device; other objects are stored as they are. A paged
        set takes one matrix, which stays on the host, or host records,
        which append as pages.

        A set of ``type_name="objects"`` columnarises the records
        (:func:`~netsdb_tpu_torch.relational.autojoin.table_from_objects`,
        strings dictionary-encoded on the host) and appends them to its
        one table, on the client's device (paged: as more pages), with
        the dictionaries remapped (``concat_tables``) atomically under
        the store lock, so that concurrent senders lose no batch."""
        ident = SetIdentifier(db, set_name)
        info = self.catalog.get_set(db, set_name)
        paged = self.store.storage_of(ident) == "paged"
        if info is not None and info.get("type") == "objects":
            if not items:
                return
            from netsdb_tpu_torch.relational.autojoin import (
                concat_tables, table_from_objects)
            from netsdb_tpu_torch.relational.table import ColumnTable

            new = table_from_objects(list(items),
                                     device="cpu" if paged else self.device)
            if paged:
                self.store.append_table(ident, new)
                return

            def append(existing):
                tables = [i for i in existing if isinstance(i, ColumnTable)]
                return [concat_tables(tables[0], new) if tables else new]

            self.store.update_set(ident, append)
            return
        if paged:
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
        returned tensor is then the host copy. Block shape: the argument,
        else the set's advisor-chosen block (catalog meta, written by
        :meth:`create_set` under a placement advisor), else the
        configuration's default."""
        if block_shape is None:
            cat = self.catalog.get_set(db, set_name)
            if cat is not None and "placement" in cat["meta"]:
                block_shape = cat["meta"].get("block_shape")
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
        statistics. A paged set pages the table's valid rows into the
        arena from the host instead (nothing is uploaded). ``append=True``
        adds the rows to the stored relation (the reference's addData)
        instead of replacing it; on a paged set, as more pages. The
        catalog records the set's row count and columns. Returns the
        table as stored (for an append, the batch)."""
        from netsdb_tpu_torch.relational.stats import analyze_table
        from netsdb_tpu_torch.relational.table import ColumnTable

        ident = SetIdentifier(db, set_name)
        dest = ("cpu" if self.store.storage_of(ident) == "paged"
                else self.device)
        if isinstance(rows_or_table, ColumnTable):
            table = rows_or_table
            if table.device.type == "cpu":
                analyze_table(table)  # on the host, before any upload
            table = table.to(dest)
        else:
            table = ColumnTable.from_rows(list(rows_or_table), date_cols,
                                          device=dest)
        if append:
            self.store.append_table(ident, table)
            num_rows = self.analyze_set(db, set_name)["num_rows"]
        else:
            self.store.clear_set(ident)
            self.store.add_data(ident, [table])
            num_rows = table.num_rows
        self.catalog.update_table_meta(db, set_name, num_rows, table.cols)
        return table

    def get_table(self, db: str, set_name: str):
        """The one column table a relation set holds. A paged relation is
        assembled on the host (CPU columns; the device never holds it
        whole): queries should fold over its stream instead."""
        from netsdb_tpu_torch.relational.table import ColumnTable

        ident = SetIdentifier(db, set_name)
        pc = (self.store.paged_relation(ident)
              if self.store.storage_of(ident) == "paged" else None)
        if pc is not None:
            return pc.to_host_table()
        items = self.store.get_items(ident)
        tables = [i for i in items if isinstance(i, ColumnTable)]
        if len(tables) != 1:
            raise ValueError(f"set {db}:{set_name} holds {len(tables)} "
                             f"tables; expected 1")
        return tables[0]

    def analyze_set(self, db: str, set_name: str) -> Dict[str, Any]:
        """Planner statistics of a stored relation — ``{"stats",
        "dicts", "num_rows"}`` — from the statistics collected at
        ingest (the reference's ``StorageCollectStats``); the DAG
        constructors read these summaries, never the table. A paged relation
        answers from its ingest-time statistics and never streams."""
        ident = SetIdentifier(db, set_name)
        pc = (self.store.paged_relation(ident)
              if self.store.storage_of(ident) == "paged" else None)
        if pc is not None:
            return {"stats": dict(pc.stats), "dicts": dict(pc.dicts),
                    "num_rows": pc.num_rows}
        return table_info(self.get_table(db, set_name))

    def get_tensor(self, db: str, set_name: str) -> BlockedTensor:
        return self.store.get_tensor(SetIdentifier(db, set_name))

    def get_set_iterator(self, db: str, set_name: str) -> Iterator[Any]:
        """The set's items, one by one; a paged record set streams its
        records page by page (a paged matrix or relation raises)."""
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

    # --- dedup (reference addSharedMapping, SharedTensorBlockSet) -----
    def dedup_resident(self, sets: Sequence[Tuple[str, str]],
                       bands: int = 16, seed: int = 0) -> Dict[str, Any]:
        """Dedup resident weight sets block by block: byte-equal blocks
        share one slot of a pool on the device, and each set keeps a slot
        grid (``dedup/pool.py``; ``bands`` and ``seed`` are the LSH
        index's, which the summed report does not read). Sets are pooled per (block shape, dtype)
        class; reads are unchanged to the bit. Returns the summed
        pooling report."""
        from netsdb_tpu_torch.dedup.pool import pool_models

        by_class: Dict[Any, Dict[str, BlockedTensor]] = {}
        for db, set_name in sets:
            t = self.get_tensor(db, set_name)
            by_class.setdefault((t.meta.block_shape, str(t.dtype)),
                                {})[f"{db}:{set_name}"] = t
        keys = ("models", "total_blocks", "unique_blocks",
                "shared_block_refs", "hbm_bytes_before", "hbm_bytes_pooled")
        total: Dict[str, Any] = {"classes": len(by_class),
                                 **{k: 0 for k in keys}}
        for group in by_class.values():
            pooled, report = pool_models(group, bands=bands, seed=seed,
                                         report_lsh=False)
            for name, pt in pooled.items():
                self.store.set_pooled(SetIdentifier(*name.split(":", 1)), pt)
            for k in keys:
                total[k] += report[k]
        total["hbm_savings_pct"] = round(
            100 * (1 - total["hbm_bytes_pooled"]
                   / max(total["hbm_bytes_before"], 1)), 1)
        return total

    def add_shared_mapping(self, private_db: str, private_set: str,
                           shared_db: str, shared_set: str,
                           mapping: Optional[Dict] = None) -> None:
        """Make ``private_set`` read ``shared_set``'s storage (it is
        read-only from then on)."""
        self.store.add_shared_mapping(SetIdentifier(private_db, private_set),
                                      SetIdentifier(shared_db, shared_set),
                                      mapping)

    def collect_stats(self) -> Dict[str, Any]:
        """Per-set storage statistics (reference ``StorageCollectStats``),
        keyed by ``"db:set"``."""
        return {str(i): self.store.set_stats(i)
                for i in self.store.list_sets()}

    # --- query execution ----------------------------------------------
    def execute_computations(self, *sinks, job_name: str = "job",
                             materialize: bool = True,
                             explain: bool = False):
        """Plan and run a Computation DAG (reference
        ``QueryClient::executeComputations``); ``sinks`` are
        :class:`~netsdb_tpu_torch.plan.computations.WriteSet` nodes.

        ``explain=True`` is the in-process EXPLAIN ANALYZE: every plan
        node's wall time, rows, program builds and fusion region are
        recorded (``obs/operators.py``) and the return becomes
        ``(results, operators_tree)``.

        With a placement advisor installed, the job's elapsed time is
        recorded against the arm whose placement this client's DDL
        actually applied (:meth:`create_set` stashes it), never against
        an arm that was merely chosen."""
        from netsdb_tpu_torch import obs
        from netsdb_tpu_torch.learning.history import set_config_label
        from netsdb_tpu_torch.plan.executor import execute_computations

        def run():
            if self._advisor is None or self._advisor_arm is None:
                return execute_computations(self, list(sinks),
                                            job_name=job_name,
                                            materialize=materialize)
            set_config_label(self._advisor_arm.label)
            try:
                return execute_computations(self, list(sinks),
                                            job_name=job_name,
                                            materialize=materialize)
            finally:
                set_config_label("")  # no stale-arm tagging

        if not explain:
            return run()
        with obs.operators.explain_capture() as cap:
            results = run()
        return results, cap.get("operators")
