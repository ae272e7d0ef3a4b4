"""Metadata catalog — databases, sets and registered types in sqlite.

The port's own copy of ``netsdb_tpu/catalog/catalog.py`` (host-only
code, copied so the port never imports the JAX package), cut to what
the ported path uses: the reference ``PDBCatalog``'s database, set and
type rows (``src/catalog/headers/PDBCatalog.h:45-50``) — a type row may
carry its module's source, shipped to daemons that never installed it —
and the mesh-node rows.
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
import time
from typing import Dict, List, Optional

_SCHEMA = """
CREATE TABLE IF NOT EXISTS databases (
    name TEXT PRIMARY KEY,
    created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS sets (
    db_name TEXT NOT NULL,
    set_name TEXT NOT NULL,
    type_name TEXT NOT NULL DEFAULT 'tensor',
    meta_json TEXT NOT NULL DEFAULT '{}',
    persistence TEXT NOT NULL DEFAULT 'transient',
    created_at REAL NOT NULL,
    PRIMARY KEY (db_name, set_name)
);
CREATE TABLE IF NOT EXISTS types (
    type_name TEXT PRIMARY KEY,
    entry_point TEXT NOT NULL,
    registered_at REAL NOT NULL,
    source TEXT
);
CREATE TABLE IF NOT EXISTS nodes (
    node_id INTEGER PRIMARY KEY,
    address TEXT NOT NULL,
    num_devices INTEGER NOT NULL,
    device_kind TEXT NOT NULL
);
"""


class Catalog:
    """Sqlite-backed metadata store, serialised by one lock."""

    def __init__(self, path: str = ":memory:"):
        if path != ":memory:":
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._lock:
            self._conn.executescript(_SCHEMA)
            # a catalog written before type rows carried their source
            try:
                self._conn.execute("ALTER TABLE types ADD COLUMN source TEXT")
            except sqlite3.OperationalError:
                pass  # the column is there
            self._conn.commit()

    # --- databases ----------------------------------------------------
    def create_database(self, name: str) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR IGNORE INTO databases VALUES (?, ?)",
                (name, time.time()))
            self._conn.commit()

    def database_exists(self, name: str) -> bool:
        with self._lock:
            cur = self._conn.execute(
                "SELECT 1 FROM databases WHERE name = ?", (name,))
            return cur.fetchone() is not None

    def list_databases(self) -> List[str]:
        with self._lock:
            cur = self._conn.execute(
                "SELECT name FROM databases ORDER BY name")
            return [r[0] for r in cur.fetchall()]

    def drop_database(self, name: str) -> None:
        """Remove a database and every set registered under it."""
        with self._lock:
            self._conn.execute("DELETE FROM sets WHERE db_name = ?", (name,))
            self._conn.execute("DELETE FROM databases WHERE name = ?",
                               (name,))
            self._conn.commit()

    # --- sets ---------------------------------------------------------
    def create_set(self, db_name: str, set_name: str,
                   type_name: str = "tensor", meta: Optional[Dict] = None,
                   persistence: str = "transient") -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO sets VALUES (?, ?, ?, ?, ?, ?)",
                (db_name, set_name, type_name, json.dumps(meta or {}),
                 persistence, time.time()))
            self._conn.commit()

    def set_exists(self, db_name: str, set_name: str) -> bool:
        with self._lock:
            cur = self._conn.execute(
                "SELECT 1 FROM sets WHERE db_name = ? AND set_name = ?",
                (db_name, set_name))
            return cur.fetchone() is not None

    def get_set(self, db_name: str, set_name: str) -> Optional[Dict]:
        with self._lock:
            cur = self._conn.execute(
                "SELECT type_name, meta_json, persistence FROM sets "
                "WHERE db_name = ? AND set_name = ?", (db_name, set_name))
            row = cur.fetchone()
        if row is None:
            return None
        return {"db": db_name, "set": set_name, "type": row[0],
                "meta": json.loads(row[1]), "persistence": row[2]}

    def list_sets(self, db_name: Optional[str] = None) -> List[Dict]:
        """``{"db", "set"}`` of every registered set, or of one
        database's."""
        with self._lock:
            if db_name is None:
                cur = self._conn.execute("SELECT db_name, set_name FROM sets")
            else:
                cur = self._conn.execute(
                    "SELECT db_name, set_name FROM sets WHERE db_name = ?",
                    (db_name,))
            return [{"db": r[0], "set": r[1]} for r in cur.fetchall()]

    def remove_set(self, db_name: str, set_name: str) -> None:
        with self._lock:
            self._conn.execute(
                "DELETE FROM sets WHERE db_name = ? AND set_name = ?",
                (db_name, set_name))
            self._conn.commit()

    def update_set_meta(self, db_name: str, set_name: str, meta: Dict) -> None:
        with self._lock:
            self._conn.execute(
                "UPDATE sets SET meta_json = ? WHERE db_name = ? AND set_name = ?",
                (json.dumps(meta), db_name, set_name))
            self._conn.commit()

    def update_table_meta(self, db_name: str, set_name: str, num_rows: int,
                          columns) -> None:
        """Record a relation set's row count and column names in its
        meta (what ``send_table`` writes after every ingest or append).
        An unknown set is a no-op."""
        info = self.get_set(db_name, set_name)
        if info is None:
            return
        info["meta"].update(num_rows=int(num_rows),
                            columns=sorted(columns))
        self.update_set_meta(db_name, set_name, info["meta"])

    # --- types (Python entry points in place of the reference's .so) --
    def register_type(self, type_name: str, entry_point: str,
                      source: Optional[str] = None) -> None:
        """``source`` (optional Python module text) is the reference
        catalog's replicated user-type .so (``PDBCatalog.h:45-50``): a
        daemon loads it when the entry point's module is not installed
        there."""
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO types "
                "(type_name, entry_point, registered_at, source) "
                "VALUES (?, ?, ?, ?)",
                (type_name, entry_point, time.time(), source))
            self._conn.commit()

    def get_type(self, type_name: str) -> Optional[str]:
        """The entry point registered under ``type_name``, or None."""
        with self._lock:
            row = self._conn.execute(
                "SELECT entry_point FROM types WHERE type_name = ?",
                (type_name,)).fetchone()
        return row[0] if row else None

    def get_type_source(self, type_name: str) -> Optional[str]:
        """The module source shipped with ``type_name``, or None."""
        with self._lock:
            row = self._conn.execute(
                "SELECT source FROM types WHERE type_name = ?",
                (type_name,)).fetchone()
        return row[0] if row else None

    def list_types(self) -> List[Dict]:
        """Every registered type as ``{"type", "entry_point"}``."""
        with self._lock:
            cur = self._conn.execute(
                "SELECT type_name, entry_point FROM types")
            return [{"type": r[0], "entry_point": r[1]}
                    for r in cur.fetchall()]

    # --- nodes (the reference's PDBCatalogNode / conf/serverlist) -----
    def register_node(self, node_id: int, address: str, num_devices: int,
                      device_kind: str) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO nodes VALUES (?, ?, ?, ?)",
                (node_id, address, num_devices, device_kind))
            self._conn.commit()

    def list_nodes(self) -> List[Dict]:
        with self._lock:
            cur = self._conn.execute(
                "SELECT node_id, address, num_devices, device_kind "
                "FROM nodes")
            return [{"node_id": r[0], "address": r[1],
                     "num_devices": r[2], "device_kind": r[3]}
                    for r in cur.fetchall()]

    def close(self) -> None:
        with self._lock:
            self._conn.close()


def read_module_source(entry_point: str) -> str:
    """The source text of an entry point's importable module — the
    client's half of shipping a type (``register_type(ship_module=
    True)``; the reference reads the .so bytes off disk)."""
    import importlib.util

    spec = importlib.util.find_spec(entry_point.partition(":")[0])
    if spec is None or spec.origin is None:
        raise ImportError(
            f"ship_module: cannot locate source for {entry_point!r}")
    with open(spec.origin, "r") as f:
        return f.read()
