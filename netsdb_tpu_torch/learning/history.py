"""Execution-history store — the port's ``netsdb_tpu/learning/history.py``,
the Lachesis self-learning database, lite.

The reference persists every job/stage/data interaction to sqlite
(``src/selfLearning/headers/SelfLearningDB.h:21-51``: tables JOB /
JOB_INSTANCE / JOB_STAGE / DATA / LAMBDA / RUN_STAT), written by the
scheduler during planning (``QuerySchedulerServer.cc:246-430``). Our
executor records one row per job run: plan structure, elapsed wall
time, and the placement/sharding config label in effect — the signal
the placement advisor (``netsdb_tpu_torch.learning.advisor``) learns from.

One process-wide database (in memory unless :func:`set_history_db`
installs another), written from the executor on every job, from any
thread: every statement runs under the database's one lock. The
in-memory default keeps the newest ``DEFAULT_MAX_ROWS`` runs, so a
long-running daemon's history stays bounded; a database installed with
:func:`set_history_db` keeps what its ``max_rows`` says (all, unless
given).
"""

from __future__ import annotations


import os
import sqlite3
import threading
import time
from typing import Dict, List, Optional

_SCHEMA = """
CREATE TABLE IF NOT EXISTS job_run (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    job_name TEXT NOT NULL,
    plan_key TEXT NOT NULL,
    config_label TEXT NOT NULL DEFAULT '',
    elapsed_s REAL NOT NULL,
    ts REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS job_run_name ON job_run (job_name);
"""

#: runs the process-wide in-memory default keeps (the newest)
DEFAULT_MAX_ROWS = 65_536


class HistoryDB:
    def __init__(self, path: str = ":memory:",
                 max_rows: Optional[int] = None):
        if max_rows is not None and max_rows < 1:
            raise ValueError(f"max_rows must be >= 1, got {max_rows!r}")
        self.max_rows = max_rows
        if path != ":memory:":
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._lock:
            self._conn.executescript(_SCHEMA)
            self._conn.commit()

    def record(self, job_name: str, plan_key: str, elapsed_s: float,
               config_label: str = "") -> None:
        with self._lock:
            self._conn.execute(
                "INSERT INTO job_run (job_name, plan_key, config_label, "
                "elapsed_s, ts) VALUES (?, ?, ?, ?, ?)",
                (job_name, plan_key, config_label, elapsed_s, time.time()))
            if self.max_rows is not None:
                # ids only grow, so this keeps at most the newest max_rows
                self._conn.execute(
                    "DELETE FROM job_run WHERE id <= "
                    "(SELECT MAX(id) FROM job_run) - ?", (self.max_rows,))
            self._conn.commit()

    def count(self) -> int:
        with self._lock:
            return self._conn.execute(
                "SELECT COUNT(*) FROM job_run").fetchone()[0]

    def runs(self, job_name: str) -> List[Dict]:
        with self._lock:
            cur = self._conn.execute(
                "SELECT plan_key, config_label, elapsed_s, ts FROM job_run "
                "WHERE job_name = ? ORDER BY ts", (job_name,))
            return [{"plan_key": r[0], "config": r[1], "elapsed_s": r[2],
                     "ts": r[3]} for r in cur.fetchall()]

    def mean_elapsed(self, job_name: str, config_label: str) -> Optional[float]:
        with self._lock:
            cur = self._conn.execute(
                "SELECT AVG(elapsed_s), COUNT(*) FROM job_run "
                "WHERE job_name = ? AND config_label = ?",
                (job_name, config_label))
            avg, n = cur.fetchone()
        return float(avg) if n else None

    def close(self):
        with self._lock:
            self._conn.close()


# process-global sink the executor writes through (None → in-memory)
_db: Optional[HistoryDB] = None
_current_config_label = ""


def set_history_db(db: Optional[HistoryDB]) -> None:
    global _db
    _db = db


def set_config_label(label: str) -> None:
    """Tag subsequent runs with the active placement config."""
    global _current_config_label
    _current_config_label = label


def record_job(job_name: str, plan, elapsed_s: float) -> None:
    """Called by the executor after every job (see plan/executor.py)."""
    get_history_db().record(job_name, plan.cache_key()[:512], elapsed_s,
                            _current_config_label)


def get_history_db() -> HistoryDB:
    global _db
    if _db is None:
        _db = HistoryDB(max_rows=DEFAULT_MAX_ROWS)
    return _db
