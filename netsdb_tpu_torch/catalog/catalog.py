"""Metadata catalog — databases, sets and registered types in sqlite.

The port's own copy of ``netsdb_tpu/catalog/catalog.py`` (host-only
code, copied so the port never imports the JAX package), cut to what
the ported path uses: the reference ``PDBCatalog``'s database, set and
type rows (``src/catalog/headers/PDBCatalog.h:45-50``). Shipping type
source and mesh-node rows stay with the serving slice (ROADMAP.md A7).
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
import time
from typing import Dict, Optional

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
    registered_at REAL NOT NULL
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
    def register_type(self, type_name: str, entry_point: str) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO types VALUES (?, ?, ?)",
                (type_name, entry_point, time.time()))
            self._conn.commit()
