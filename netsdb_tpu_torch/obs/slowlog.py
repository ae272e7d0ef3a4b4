"""Structured slow-query log — the port's ``netsdb_tpu/obs/slowlog.py``:
a bounded on-disk ring of profiles.

The trace ring is memory-only and FIFO: a burst of fast queries evicts
the slow outlier, and a restart loses everything. Here any query whose
trace total reaches ``config.obs_slow_query_s`` gets its full profile
(spans, counters, host/device split, meta) written as one JSON file
under ``<root_dir>/slowlog/``, pruned to the newest
``config.obs_slowlog_entries`` files; the entries survive a restart and
the sequence numbers continue from what is on disk.

File name: ``slow-<seq 12 digits>-<qid>.json`` — lexicographic order is
age order, so pruning and listing are directory scans. Writes are atomic
(temporary file, then rename).

The daemon's ``GET_TRACE`` frame with ``{"slow": true}`` returns the
entries; ``HEALTH`` carries the summary."""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, List, Optional

from netsdb_tpu_torch.obs import metrics as _metrics
from netsdb_tpu_torch.utils.locks import TrackedLock

_PREFIX = "slow-"
_SUFFIX = ".json"


class SlowQueryLog:
    """Bounded on-disk ring of slow-query profiles."""

    def __init__(self, root_dir: str, capacity: int = 64,
                 threshold_s: Optional[float] = None):
        self.dir = os.path.join(root_dir, "slowlog")
        self.capacity = max(int(capacity), 1)
        self.threshold_s = threshold_s
        self._mu = TrackedLock("SlowQueryLog._mu")
        os.makedirs(self.dir, exist_ok=True)
        # restart continuity: the next sequence number follows the
        # newest file already on disk
        self._seq = 0
        for name in self._names():
            try:
                self._seq = max(self._seq,
                                int(name[len(_PREFIX):].split("-", 1)[0]))
            except (ValueError, IndexError):
                continue

    def _names(self) -> List[str]:
        try:
            return sorted(n for n in os.listdir(self.dir)
                          if n.startswith(_PREFIX) and n.endswith(_SUFFIX))
        except OSError:
            return []

    # --- record -------------------------------------------------------
    def record(self, profile: Dict[str, Any]) -> Optional[str]:
        """Persist one profile; returns the file path (None on any
        persistence trouble — losing a slowlog entry must never fail
        the query that produced it)."""
        qid = str(profile.get("qid") or "unknown")[:32]
        with self._mu:
            self._seq += 1
            name = f"{_PREFIX}{self._seq:012d}-{qid}{_SUFFIX}"
            path = os.path.join(self.dir, name)
            tmp = path + ".tmp"
            try:
                with open(tmp, "w") as f:
                    json.dump(profile, f, default=str)
                os.replace(tmp, path)  # atomic: never a torn JSON
            except (OSError, TypeError, ValueError):
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                return None
            # prune oldest beyond capacity (lexicographic == age)
            names = self._names()
            for old in names[:max(len(names) - self.capacity, 0)]:
                try:
                    os.remove(os.path.join(self.dir, old))
                except OSError:
                    pass
        _metrics.REGISTRY.counter("obs.slow_queries").inc()
        return path

    def maybe_record(self, profile: Dict[str, Any]) -> Optional[str]:
        """Record iff the profile's total exceeds the threshold
        (None/0 threshold = disabled)."""
        if not self.threshold_s:
            return None
        total = profile.get("total_s")
        if total is None or total < self.threshold_s:
            return None
        return self.record(profile)

    def merge_section(self, qid: str, section: str,
                      payload: Any) -> bool:
        """Attach ``payload`` under ``section`` on every persisted
        entry of ``qid`` — the slowlog half of the PUT_TRACE merge:
        the server persists a slow profile when its trace closes,
        BEFORE the client's spans can possibly arrive (the client only
        ships after the reply), so without this rewrite every slowlog
        entry would permanently lack its ``client`` section. Atomic
        (tmp + rename) like :meth:`record`; returns True when at least
        one entry matched. Bounded work: the directory holds at most
        ``capacity`` files and a qid names at most a handful."""
        qid = str(qid)[:32]
        hit = False
        with self._mu:
            for name in self._names():
                stem = name[len(_PREFIX):-len(_SUFFIX)]
                if stem.split("-", 1)[-1] != qid:
                    continue
                path = os.path.join(self.dir, name)
                tmp = path + ".tmp"
                try:
                    with open(path) as f:
                        prof = json.load(f)
                    prof[section] = payload
                    with open(tmp, "w") as f:
                        json.dump(prof, f, default=str)
                    os.replace(tmp, path)
                    hit = True
                except (OSError, TypeError, ValueError):
                    try:
                        os.remove(tmp)
                    except OSError:
                        pass
        return hit

    # --- inspect ------------------------------------------------------
    def entries(self, last: Optional[int] = None) -> List[Dict[str, Any]]:
        """Persisted profiles, newest LAST (the TraceRing convention).
        Unreadable files are skipped, never fatal."""
        names = self._names()
        if last is not None:
            names = names[-int(last):]
        out = []
        for name in names:
            try:
                with open(os.path.join(self.dir, name)) as f:
                    prof = json.load(f)
            except (OSError, ValueError):
                continue
            prof["slowlog_file"] = name
            out.append(prof)
        return out

    def summary(self) -> Dict[str, Any]:
        names = self._names()
        return {"entries": len(names), "dir": self.dir,
                "threshold_s": self.threshold_s,
                "newest": names[-1] if names else None}
