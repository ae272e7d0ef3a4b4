"""Locks — the port's ``netsdb_tpu/utils/locks.py``: the
readers-preference readers-writer lock of streams against mutations,
:class:`TrackedLock` and :class:`TrackedRLock` (``threading`` locks
that carry a rank name), and the lockdep-style runtime lock-order
witness that reads those names.

Streams of a paged set hold the read side of its :class:`RWLock` for
their lifetime; dropping or replacing the set's pages takes the write
side, so pages are never freed under a live stream.

The witness: every :class:`TrackedLock`/:class:`TrackedRLock`/
:class:`RWLock` acquisition, while a witness is installed, records
*rank* edges (held lock → newly acquired lock) into one bounded
process-wide graph and checks each new edge for a cycle — an AB/BA
inversion that is a potential deadlock even if this run never
interleaved it (Linux's lockdep, for Python locks). Ranks are lock
names: every per-set serve lock is one rank, every relation
:class:`RWLock` one rank per owner class (``PagedObjects.rw``,
``PagedColumns.rw``, ``_PagedMatrix.rw``), so instance churn cannot
grow the graph.

Mode-aware like lockdep's recursive-read handling: a rank cycle whose
:class:`RWLock` participation is read on both of its cycle edges is
suppressed (counted, not raised), since under readers-preference a read
never blocks while another reader holds the lock. A genuine
``rw.write`` inversion still fires.

Cost: with the witness disabled (the default), a tracked acquisition
pays one module-global read and an ``is None`` check on top of the raw
``threading`` primitive. Enabled (``Configuration(lock_witness=True)``
on a store or a daemon, or :func:`witness_scope`), each acquisition
walks the thread's held stack and consults the edge set.

Findings export through the metrics registry: ``analysis.lock_edges``
(gauge: distinct rank edges) and ``analysis.violations`` (counter:
cycles detected), plus the ``analysis`` collector section.
``raise_on_cycle`` raises :class:`LockOrderViolation` naming both
acquisition sites; record mode collects violations for a later check.
"""

from __future__ import annotations

import contextlib
import sys
import threading
from typing import Dict, List, Optional, Set, Tuple


class LockOrderViolation(RuntimeError):
    """A runtime lock-acquisition-order cycle (potential deadlock)."""


#: per-thread held-rank stack, shared across witness instances so
#: acquire/release pairs spanning a witness swap stay balanced
_HELD_TLS = threading.local()


class LockWitness:
    """Bounded cross-thread acquisition-order graph with cycle
    detection — one per process while enabled."""

    def __init__(self, max_edges: int = 4096, max_violations: int = 64,
                 raise_on_cycle: bool = False):
        self._mu = threading.Lock()
        self.max_edges = max_edges
        self.raise_on_cycle = raise_on_cycle
        #: (held_rank, acquired_rank) → {"sites": (held_site,
        #: acquired_site) of the first sighting, "modes": set of
        #: (held_mode, acquired_mode) pairs observed — 'r' shared /
        #: 'w' exclusive}
        self.edges: Dict[Tuple[str, str], Dict[str, object]] = {}
        self._succ: Dict[str, Set[str]] = {}
        self.violations: List[dict] = []
        self._max_violations = max_violations
        self.dropped_edges = 0
        #: rank cycles realized ONLY through shared-mode (read/read)
        #: RWLock participation — unrealizable as deadlocks under the
        #: readers-preference semantics (waiting writers never block
        #: new readers), counted but not violations: lockdep's
        #: recursive-read exemption
        self.read_cycles_suppressed = 0
        #: total tracked acquisitions observed (unsynchronized tally)
        self.acquisitions = 0

    # --- per-thread held stack ---------------------------------------
    # The stack is MODULE-level (shared by every witness instance):
    # acquire/release pairs that span a witness_scope() swap — a
    # background thread acquiring under the session witness and
    # releasing while a test's scoped witness is installed — must
    # still balance, or the restored witness would carry stale held
    # entries and manufacture phantom edges forever after.
    @staticmethod
    def _held() -> List[Tuple[str, str, str]]:
        stack = getattr(_HELD_TLS, "stack", None)
        if stack is None:
            stack = _HELD_TLS.stack = []
        return stack

    def note_acquire(self, rank: str, site: str,
                     mode: str = "w") -> None:
        self.acquisitions += 1
        held = self._held()
        if any(r == rank for r, _, _ in held):
            # re-entrant / same-rank nesting (RLock, reader-preference
            # RWLock self-probe): no self-edges
            held.append((rank, site, mode))
            return
        new_edges = list(held)
        held.append((rank, site, mode))
        if not new_edges:
            return
        try:
            with self._mu:
                for h_rank, h_site, h_mode in new_edges:
                    key = (h_rank, rank)
                    rec = self.edges.get(key)
                    if rec is not None:
                        rec["modes"].add((h_mode, mode))
                        continue
                    if len(self.edges) >= self.max_edges:
                        self.dropped_edges += 1
                        continue
                    # cycle check BEFORE inserting: a path rank →*
                    # h_rank means some thread orders them the other way
                    path = self._path(rank, h_rank)
                    self.edges[key] = {"sites": (h_site, site),
                                       "modes": {(h_mode, mode)}}
                    self._succ.setdefault(h_rank, set()).add(rank)
                    self._export_edge_count()  # new edges are rare
                    if path is not None:
                        self._check_cycle(h_rank, rank, h_site, site,
                                          path)
        except LockOrderViolation:
            # raise mode: the CALLER undoes the underlying primitive;
            # undo our held-stack push so the witness stays balanced
            # (a detector of potential deadlocks must never wedge the
            # lock it just flagged)
            self.note_release(rank)
            raise

    def note_release(self, rank: str) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == rank:
                del held[i]
                return

    def _export_edge_count(self) -> None:
        """Mirror the edge count into the registry gauge AT INSERTION
        (a collector-time set would land one snapshot late)."""
        try:
            from netsdb_tpu_torch.obs.metrics import registry

            registry().gauge("analysis.lock_edges").set(len(self.edges))
        except Exception:  # noqa: BLE001 — obs must never break locking
            pass

    # --- graph -------------------------------------------------------
    def _path(self, src: str, dst: str) -> Optional[List[str]]:
        """A src →* dst path in the current edge set, else None.
        Iterative DFS; the graph is rank-sized (tens of nodes)."""
        if src == dst:
            return [src]
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            for nxt in self._succ.get(node, ()):
                if nxt == dst:
                    return path + [nxt]
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def _check_cycle(self, a: str, b: str, a_site: str, b_site: str,
                     path: List[str]) -> None:
        """``path`` runs b →* a; with the new a→b edge that closes a
        rank cycle.  Suppress it when some lock in the cycle
        participates ONLY in shared mode on both its cycle edges:
        under readers-preference, a read acquisition can never block
        while another reader holds the lock (waiting writers do not
        gate new readers), so no interleaving realizes the deadlock
        the cycle suggests — lockdep's recursive-read exemption."""
        cycle_nodes = path + [b]  # b, ..., a, b
        cycle_edges = list(zip(cycle_nodes[:-1], cycle_nodes[1:]))
        for node in path:  # every node; a and b included via path ends
            in_edge = next((e for e in cycle_edges if e[1] == node),
                           None)
            out_edge = next((e for e in cycle_edges if e[0] == node),
                            None)
            if in_edge is None or out_edge is None:
                continue
            in_modes = {m[1] for m in
                        self.edges.get(in_edge, {}).get("modes", ())}
            out_modes = {m[0] for m in
                         self.edges.get(out_edge, {}).get("modes", ())}
            if in_modes == {"r"} and out_modes == {"r"}:
                self.read_cycles_suppressed += 1
                return
        self._violation(a, b, a_site, b_site, path)

    def _violation(self, a: str, b: str, a_site: str, b_site: str,
                   path: List[str]) -> None:
        rec = {
            "cycle": path + [b],
            "edge": (a, b),
            "sites": {a: a_site, b: b_site},
            "reverse_sites": {
                y: self.edges.get((x, y),
                                  {"sites": ("?", "?")})["sites"][1]
                for x, y in zip(path, path[1:])},
            "thread": threading.current_thread().name,
        }
        if len(self.violations) < self._max_violations:
            self.violations.append(rec)
        try:  # export through the central registry (never fatal)
            from netsdb_tpu_torch.obs.metrics import registry

            registry().counter("analysis.violations").inc()
        except Exception:  # noqa: BLE001 — obs must never break locking
            pass
        if self.raise_on_cycle:
            cyc = " -> ".join(rec["cycle"])
            other = "; ".join(f"{p} acquired at {s}"
                              for p, s in rec["reverse_sites"].items())
            raise LockOrderViolation(
                f"lock-order inversion: acquiring {b!r} at {b_site} "
                f"while holding {a!r} (acquired at {a_site}), but the "
                f"reverse order already exists: cycle {cyc} ({other})")

    def report(self) -> dict:
        with self._mu:
            return {
                "edges": len(self.edges),
                "dropped_edges": self.dropped_edges,
                "acquisitions": self.acquisitions,
                "read_cycles_suppressed": self.read_cycles_suppressed,
                "violations": list(self.violations),
            }

    def _export_edges_locked(self) -> List[dict]:
        return [{"held": a, "acquired": b,
                 "sites": list(rec["sites"]),
                 "modes": sorted("".join(m) for m in rec["modes"])}
                for (a, b), rec in sorted(self.edges.items())]

    def export_edges(self) -> List[dict]:
        """The recorded rank edges as plain JSON-safe records (held
        rank, acquired rank, both first-sighting sites, share modes)."""
        with self._mu:
            return self._export_edges_locked()

    def dump(self, path: str) -> None:
        """Write the edge graph (plus run totals) as JSON, in the
        reference's dump format."""
        import json

        # one _mu extent for edges AND totals: a dump taken while a
        # live thread still acquires must be self-consistent
        with self._mu:
            payload = {
                "edges": self._export_edges_locked(),
                "acquisitions": self.acquisitions,
                "dropped_edges": self.dropped_edges,
                "violations": len(self.violations),
            }
        with open(path, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=1, sort_keys=True)


#: the process-wide witness; None = disabled (the common case — every
#: tracked acquisition pays exactly this read + an is-None check)
_WITNESS: Optional[LockWitness] = None


def witness() -> Optional[LockWitness]:
    return _WITNESS


def enable_witness(raise_on_cycle: bool = False,
                   max_edges: int = 4096) -> LockWitness:
    """Install (or return the already-installed) process witness."""
    global _WITNESS
    if _WITNESS is None:
        _WITNESS = LockWitness(max_edges=max_edges,
                               raise_on_cycle=raise_on_cycle)
        try:
            from netsdb_tpu_torch.obs.metrics import registry

            registry().register_collector("analysis", _witness_stats)
        except Exception:  # noqa: BLE001 — obs must never break locking
            pass
    else:
        _WITNESS.raise_on_cycle = raise_on_cycle
    return _WITNESS


def disable_witness() -> None:
    global _WITNESS
    _WITNESS = None


@contextlib.contextmanager
def witness_scope(raise_on_cycle: bool = False, max_edges: int = 4096):
    """Temporarily install a FRESH witness and restore the previous
    one on exit — a deterministic check gets a private graph without
    clobbering a process-wide witness."""
    global _WITNESS
    prev = _WITNESS
    w = LockWitness(max_edges=max_edges, raise_on_cycle=raise_on_cycle)
    _WITNESS = w
    try:
        yield w
    finally:
        _WITNESS = prev


def _witness_stats() -> dict:
    w = _WITNESS
    if w is None:
        return {"enabled": False}
    rep = w.report()
    return {"enabled": True, "edges": rep["edges"],
            "dropped_edges": rep["dropped_edges"],
            "acquisitions": rep["acquisitions"],
            "read_cycles_suppressed": rep["read_cycles_suppressed"],
            "violations": len(rep["violations"])}


def _call_site(depth: int = 2) -> str:
    f = sys._getframe(depth)
    return f"{f.f_code.co_filename.rsplit('/', 1)[-1]}:{f.f_lineno}"


class TrackedLock:
    """``threading.Lock`` with a witness rank name.  Drop-in: context
    manager, ``acquire(blocking=, timeout=)``, ``release()``,
    ``locked()``."""

    _factory = staticmethod(threading.Lock)
    __slots__ = ("_lk", "name", "_count")

    def __init__(self, name: str):
        self._lk = self._factory()
        self.name = name
        # recursion depth of the current holder (mutated only while
        # the lock is held, so no extra synchronization): the RLock
        # ``locked()`` probe — try-acquire would succeed reentrantly
        self._count = 0

    def acquire(self, blocking: bool = True, timeout: float = -1,
                _site_depth: int = 2) -> bool:
        ok = self._lk.acquire(blocking, timeout)
        if ok:
            self._count += 1
            w = _WITNESS
            if w is not None:
                try:
                    w.note_acquire(self.name, _call_site(_site_depth))
                except BaseException:
                    # raise-mode violation: hand the lock BACK before
                    # propagating — the detector must never leave the
                    # flagged lock wedged
                    self._count -= 1
                    self._lk.release()
                    raise
        return ok

    def release(self) -> None:
        self._count -= 1
        self._lk.release()
        w = _WITNESS
        if w is not None:
            w.note_release(self.name)

    def locked(self) -> bool:
        return self._lk.locked()

    def __enter__(self) -> "TrackedLock":
        self.acquire(_site_depth=3)
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"


class TrackedRLock(TrackedLock):
    """``threading.RLock`` with a witness rank name."""

    _factory = staticmethod(threading.RLock)
    __slots__ = ()

    def locked(self) -> bool:  # RLock has no locked() pre-3.12, and a
        # try-acquire probe would succeed reentrantly for the holder
        return self._count > 0


class RWLock:
    """Readers-preference shared/exclusive lock.

    The arena pin-refcount pattern (``native/pagestore.cpp``) at Python
    granularity: many concurrent page streams may read one paged
    relation while mutations (append / drop) wait for the readers to
    drain. Readers-preference deliberately: a stream that opens a
    nested stream of the same relation (grace-hash self-probe) must not
    deadlock behind a queued writer, and at this layer's scale writer
    starvation is not a realistic load.

    ``name`` is the witness RANK (default ``"RWLock"`` — every
    relation lock is one level in the hierarchy; see the module
    docstring).  Read and write acquisitions both witness the same
    rank: the ordering hazard is which LEVEL nests inside which, not
    the share mode.
    """

    def __init__(self, name: str = "RWLock"):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self.name = name

    @contextlib.contextmanager
    def read(self):
        with self._cond:
            while self._writer:
                self._cond.wait()
            self._readers += 1
        w = _WITNESS
        if w is not None:
            try:
                w.note_acquire(self.name, _call_site(3), mode="r")
            except BaseException:
                with self._cond:  # undo the read before propagating
                    self._readers -= 1
                    if self._readers == 0:
                        self._cond.notify_all()
                raise
        try:
            yield
        finally:
            if w is not None:
                w.note_release(self.name)
            with self._cond:
                self._readers -= 1
                if self._readers == 0:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def write(self):
        with self._cond:
            while self._writer or self._readers:
                self._cond.wait()
            self._writer = True
        w = _WITNESS
        if w is not None:
            try:
                w.note_acquire(self.name, _call_site(3), mode="w")
            except BaseException:
                with self._cond:  # undo the write before propagating
                    self._writer = False
                    self._cond.notify_all()
                raise
        try:
            yield
        finally:
            if w is not None:
                w.note_release(self.name)
            with self._cond:
                self._writer = False
                self._cond.notify_all()
