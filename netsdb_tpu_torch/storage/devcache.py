"""Cross-query device block cache — counterpart of the set-scope half of
``netsdb_tpu/storage/devcache.py`` (the buffer pool for device memory).

netsDB's workers keep the pages of a hot set pinned across jobs
(``PageCache.h``); here the staged blocks of a paged set stay on the
device across queries, so a warm query over the same weights reads no
page and copies nothing to the device.

:class:`DeviceBlockCache` holds two kinds of entries under one byte
budget and one LRU order:

* **whole-run entries** (``partial=False``): one per complete stream of
  a set, keyed ``(scope, version, kind, ...)``; a write bumps the set's
  version, so a stale run never matches again.
* **block entries** (``partial=True``, the default): one per staged
  block, keyed ``base_key + ((start, end),)`` with no version; writes
  drop the blocks they touch (:meth:`invalidate_range`), and a
  per-scope epoch refuses installs planned before a racing write.
  Lookups (:meth:`plan_ranges`) return the cached blocks of one
  stream's layout so the stream stitches them in and stages only the
  gaps. The contiguous head of a set may be pinned against eviction
  within ``pin_bytes``.

Byte accounting reads ``nbytes`` (metadata only, never the data).
Cached blocks are owned by the cache: nothing writes into them (the
executor's reduce carry is always a fresh tensor). Installs happen only
after the block's copy to the device has completed
(``plan/staging``), so a hit never serves a block still being written.
A paged relation's chunks are cached as column tables, keyed by the
relation's stream shape and, for a projected stream, its columns: an
append drops only the blocks of its rows, an update in place only the
blocks of streams that held the updated column.

A third family holds **session state** (``serve/sessions.py``): one
mutable entry per ``(session, model, layer)``, TTL'd, sharing the LRU
order and the byte budget with the blocks. Eviction and TTL expiry hand
the entry to the registered spill callback (the session arena) instead
of losing it; a close drops it without a spill.

Every lookup, install and served block ticks the metrics registry
(``devcache.lookups``/``hits``/``misses``/``installs``/``partial_hits``,
which the hit-rate objective and the telemetry history read), the
current query trace and the per-(client, set) attribution ledger, as in
the reference.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch


#: scope prefix of session-state entries, so a session scope never
#: collides with a set scope ("db:set") in the by-scope index or the
#: scheduler's warm probe
SESSION_SCOPE_PREFIX = "__session__:"


def session_scope(sid: str) -> str:
    """The by-scope index key of one session's state entries."""
    return SESSION_SCOPE_PREFIX + str(sid)


def to_device(x, device, placement=None):
    """The synchronous upload of a host block to ``device`` (with the
    set's placement applied) — used where no staged stream runs; staged
    streams upload through :class:`~netsdb_tpu_torch.plan.staging.
    BlockUploader`, whose CPU branch is this function."""
    if isinstance(x, np.ndarray):
        out = torch.from_numpy(np.array(x)).to(device)  # owns its memory
    else:
        out = torch.as_tensor(x).to(device)
    return placement.apply(out) if placement is not None else out


def _value_nbytes(value) -> int:
    """Bytes of a cached value from metadata: tensors, numpy arrays,
    sharded tensors (each distinct shard once), column tables (columns
    and mask) and (n, block) tuples."""
    cols = getattr(value, "cols", None)
    if isinstance(cols, dict):  # ColumnTable
        return (sum(_value_nbytes(c) for c in cols.values())
                + _value_nbytes(value.valid if value.valid is not None
                                else ()))
    shards = getattr(value, "shards", None)
    if shards is not None:  # ShardedTensor
        seen = {id(t): t for t in shards.flat}
        return sum(int(t.nbytes) for t in seen.values())
    if isinstance(value, (tuple, list)):
        return sum(_value_nbytes(v) for v in value)
    if isinstance(value, dict):  # session state records, column maps
        return sum(_value_nbytes(v) for v in value.values())
    nbytes = getattr(value, "nbytes", None)
    if nbytes is not None:
        return int(nbytes)
    return 64  # ints riding along with blocks


def _metrics():
    from netsdb_tpu_torch.obs import REGISTRY

    return REGISTRY


def _tick(name: str, scope: str, n: int = 1, lookup: bool = False,
          client: Optional[str] = None) -> None:
    """One device-cache event on the registry, the current trace, the
    plan node being recorded and the attribution ledger."""
    from netsdb_tpu_torch import obs

    if lookup:
        obs.REGISTRY.counter("devcache.lookups").inc()
    obs.REGISTRY.counter(name).inc(n)
    obs.add(name, n)
    if name != "devcache.installs":
        obs.operators.op_add(name, n)
    obs.attrib.account(name, n, scope=scope, client=client)


def _is_block_key(key: Tuple) -> bool:
    rng = key[-1]
    return (isinstance(rng, tuple) and len(rng) == 2
            and isinstance(rng[0], int))


class DeviceBlockCache:
    """LRU cache of staged set blocks under one byte budget. Thread-safe:
    lookups run on consumer threads, installs on staging threads and
    invalidations on writers."""

    def __init__(self, budget_bytes: int = 0, partial: bool = False,
                 pin_bytes: int = 0):
        self._mu = threading.Lock()
        self._budget = int(budget_bytes or 0)
        self.partial = bool(partial)
        self._pin_budget = int(pin_bytes or 0)
        # key -> (blocks, nbytes); insertion order is recency order
        self._entries: "OrderedDict[Tuple, Tuple[List[Any], int]]" = \
            OrderedDict()
        self._by_scope: Dict[str, set] = {}
        self._bytes = 0
        self._stats = {"hits": 0, "misses": 0, "installs": 0,
                       "evictions": 0, "invalidations": 0, "rejected": 0}
        if self.partial:
            self._stats.update({"partial_hits": 0, "stitched_ranges": 0,
                                "dirty_invalidations": 0,
                                "pinned_bytes": 0})
        self._epochs: Dict[str, int] = {}
        self._pinned: set = set()
        self._pinned_bytes = 0
        # base key -> end row of the contiguous pinned head
        self._pin_hw: Dict[Tuple, int] = {}
        # base key -> total rows of the set at its last plan
        self._totals: Dict[Tuple, int] = {}
        # session entries: key -> {"deadline", "ttl", "expired"}; the
        # session_* stats stay hidden until the session lane is wired
        self._session_meta: Dict[Tuple, Dict[str, Any]] = {}
        self._session_spill_cb: Optional[
            Callable[[str, str, str, Any], None]] = None
        self._stats.update({"session_evictions": 0,
                            "session_expirations": 0})
        self._session_on = False

    # --- sizing -------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._budget > 0

    @property
    def budget_bytes(self) -> int:
        return self._budget

    def resize(self, budget_bytes: int) -> None:
        """Re-point the budget; shrinking evicts at once (and below the
        pinned total lifts every pin)."""
        with self._mu:
            self._budget = int(budget_bytes or 0)
            if self._budget < self._pinned_bytes:
                self._unpin_all_locked()
            self._evict_to_fit_locked(0)

    def set_pin_budget(self, pin_bytes: int) -> None:
        """Re-point the head-pin budget (partial mode); shrinking below
        the pinned total lifts every pin."""
        with self._mu:
            if not self.partial:
                return
            self._pin_budget = max(int(pin_bytes or 0), 0)
            if self._pinned_bytes > self._pin_budget:
                self._unpin_all_locked()

    def _unpin_all_locked(self) -> None:
        self._pinned.clear()
        self._pinned_bytes = 0
        self._pin_hw.clear()
        if "pinned_bytes" in self._stats:
            self._stats["pinned_bytes"] = 0

    # --- whole runs ---------------------------------------------------
    def get(self, key: Tuple) -> Optional[List[Any]]:
        """The run cached under ``key`` (refreshing its recency), or
        None, counted as a miss."""
        with self._mu:
            if not self.enabled:
                return None
            entry = self._entries.get(key)
            if entry is None:
                self._stats["misses"] += 1
            else:
                self._entries.move_to_end(key)
                self._stats["hits"] += 1
        _tick("devcache.misses" if entry is None else "devcache.hits",
              str(key[0]), lookup=True)
        return None if entry is None else entry[0]

    def make_room(self, nbytes: int) -> None:
        """Evict LRU entries until ``nbytes`` fit under the budget — called
        as a cold run records, so resident entries plus the run in
        flight stay about one budget."""
        with self._mu:
            if self.enabled:
                self._evict_to_fit_locked(min(int(nbytes), self._budget))

    def reject_oversized(self) -> None:
        """Count a run that outgrew the whole budget while recording."""
        with self._mu:
            if self.enabled:
                self._stats["rejected"] += 1

    def install(self, key: Tuple, blocks: List[Any], validator=None,
                client: Optional[str] = None) -> bool:
        """Insert one complete run; False when it exceeds the budget or
        ``validator`` (evaluated under the cache lock) says the key is
        no longer current. ``client`` is the identity the install is
        attributed to (captured on the consumer's thread)."""
        nbytes = _value_nbytes(blocks)
        with self._mu:
            if not self.enabled or nbytes > self._budget:
                if self.enabled:
                    self._stats["rejected"] += 1
                return False
            if validator is not None and not validator():
                return False
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._evict_to_fit_locked(nbytes)
            self._entries[key] = (blocks, nbytes)
            self._bytes += nbytes
            self._by_scope.setdefault(str(key[0]), set()).add(key)
            self._stats["installs"] += 1
        _tick("devcache.installs", str(key[0]), client=client)
        return True

    def _evict_to_fit_locked(self, incoming: int) -> None:
        # one pass in LRU order, skipping pinned block entries
        if self._bytes + incoming <= self._budget:
            return
        victims, freed = [], 0
        for key, (_, nbytes) in self._entries.items():
            if key in self._pinned:
                continue
            victims.append(key)
            freed += nbytes
            if self._bytes - freed + incoming <= self._budget:
                break
        for key in victims:
            self._drop_entry_locked(key)
            self._stats["evictions"] += 1
        if victims:
            _metrics().counter("devcache.evictions").inc(len(victims))

    def _drop_entry_locked(self, key: Tuple) -> bool:
        entry = self._entries.pop(key, None)
        if entry is None:
            return False
        self._bytes -= entry[1]
        scoped = self._by_scope.get(str(key[0]))
        if scoped is not None:
            scoped.discard(key)
            if not scoped:
                self._by_scope.pop(str(key[0]), None)
        if key in self._pinned:
            self._pinned.discard(key)
            self._pinned_bytes -= entry[1]
        meta = self._session_meta.pop(key, None)
        if meta is not None:
            # pressure and expiry demote session state, never lose it
            self._stats["session_expirations" if meta.get("expired")
                        else "session_evictions"] += 1
            _metrics().counter("session.evicted").inc()
            if self._session_spill_cb is not None:
                sid = str(key[0])[len(SESSION_SCOPE_PREFIX):]
                try:
                    self._session_spill_cb(sid, str(key[1]), str(key[2]),
                                           entry[0][0])
                except Exception:  # noqa: BLE001 — the callback counts
                    pass           # its own faults
        return True

    # --- partial mode: block entries and stitching -------------------
    @staticmethod
    def _block_key(base_key: Tuple, rng: Tuple[int, int]) -> Tuple:
        return tuple(base_key) + ((int(rng[0]), int(rng[1])),)

    def scope_epoch(self, scope: str) -> int:
        """The scope's current dirty epoch: a stream captures it when it
        plans and every block install checks it again, so a write racing
        the stream never leaves a stale block entry."""
        with self._mu:
            return self._epochs.get(str(scope), 0)

    def has_scope(self, scope: str) -> bool:
        """True when any entry of ``scope`` is resident (the hit and miss
        counters do not move)."""
        with self._mu:
            return bool(self._by_scope.get(str(scope)))

    def plan_ranges(self, base_key: Tuple, ranges: List[Tuple[int, int]]
                    ) -> Tuple[int, Dict[Tuple[int, int], Any]]:
        """(epoch, {range: block}) for the cached blocks of ``base_key``
        among one stream's ``ranges``. Full coverage counts one hit, any
        gap one miss; served blocks tick ``partial_hits`` when the
        stream yields them."""
        scope = str(base_key[0])
        with self._mu:
            if not (self.enabled and self.partial):
                return 0, {}
            epoch = self._epochs.get(scope, 0)
            if ranges:
                self._totals[tuple(base_key)] = int(ranges[-1][1])
            covered: Dict[Tuple[int, int], Any] = {}
            for rng in ranges:
                key = self._block_key(base_key, rng)
                entry = self._entries.get(key)
                if entry is not None:
                    self._entries.move_to_end(key)
                    covered[(int(rng[0]), int(rng[1]))] = entry[0][0]
            full = bool(ranges) and len(covered) == len(ranges)
            self._stats["hits" if full else "misses"] += 1
        _tick("devcache.hits" if full else "devcache.misses", scope,
              lookup=True)
        return epoch, covered

    def install_block(self, base_key: Tuple, rng: Tuple[int, int],
                      block: Any, epoch: int) -> bool:
        """Insert one staged block under ``base_key + (range,)``. Refused
        when a write moved the scope's epoch past ``epoch``, when the
        block alone exceeds the budget, or when only pinned entries are
        left to evict. Blocks of the contiguous head (from row 0, in
        install order) are pinned while the pin budget lasts."""
        nbytes = _value_nbytes(block)
        scope = str(base_key[0])
        with self._mu:
            if not (self.enabled and self.partial):
                return False
            if self._epochs.get(scope, 0) != int(epoch):
                return False
            if nbytes > self._budget:
                self._stats["rejected"] += 1
                return False
            key = self._block_key(base_key, rng)
            if key in self._entries:  # a concurrent stream installed it
                self._entries.move_to_end(key)
                return True
            self._evict_to_fit_locked(nbytes)
            if self._bytes + nbytes > self._budget:
                self._stats["rejected"] += 1
                return False
            self._entries[key] = ([block], nbytes)
            self._bytes += nbytes
            self._by_scope.setdefault(scope, set()).add(key)
            base = tuple(base_key)
            if (self._pin_budget > 0 and int(rng[0]) == self._pin_hw.get(
                    base, 0)
                    and self._pinned_bytes + nbytes <= self._pin_budget):
                self._pinned.add(key)
                self._pinned_bytes += nbytes
                self._pin_hw[base] = int(rng[1])
            self._stats["pinned_bytes"] = self._pinned_bytes
            return True

    def record_run_install(self, scope: str = "",
                           client: Optional[str] = None) -> None:
        """Count one run-level install of ``scope`` once a stream's
        installer landed every gap block of its run."""
        with self._mu:
            if not (self.enabled and self.partial):
                return
            self._stats["installs"] += 1
        _tick("devcache.installs", str(scope), client=client)

    def tick_partial(self, blocks_served: int, stitched_ranges: int,
                     scope: str = "") -> None:
        """Count blocks a stitched stream of ``scope`` served from the
        cache (attributed as ``devcache.partial_hits``: the ledger's
        ``devcache.hits`` stays one per stream)."""
        with self._mu:
            if "partial_hits" in self._stats:
                self._stats["partial_hits"] += int(blocks_served)
                self._stats["stitched_ranges"] += int(stitched_ranges)
        if blocks_served > 0:
            _tick("devcache.partial_hits", str(scope), int(blocks_served))
        if stitched_ranges > 0:
            _metrics().counter("devcache.stitched_ranges").inc(
                int(stitched_ranges))

    def coverage(self, scope: str) -> Tuple[int, Optional[int]]:
        """(covered prefix rows, total rows) — the longest contiguous
        cached prefix from row 0 over the base keys of ``scope``, and
        that key's last planned total (None if never planned)."""
        best: Tuple[int, Optional[int]] = (0, None)
        with self._mu:
            by_base: Dict[Tuple, List[Tuple[int, int]]] = {}
            for key in self._by_scope.get(str(scope), ()):
                if _is_block_key(key):
                    by_base.setdefault(key[:-1], []).append(key[-1])
            for base, rngs in by_base.items():
                covered = 0
                for s0, e0 in sorted(rngs):
                    if s0 > covered:
                        break
                    covered = max(covered, e0)
                total = self._totals.get(base)
                if covered > best[0] or (covered == best[0]
                                         and best[1] is None):
                    best = (covered, total)
        return best

    def invalidate_range(self, scope: str, start: int,
                         end: Optional[int] = None,
                         columns=None) -> int:
        """Drop the block entries overlapping rows ``[start, end)``
        (``end=None``: to the end) and every whole-run entry of the
        scope, and bump the scope's epoch. Returns entries dropped.

        ``columns`` names the columns an update in place touched: a block
        entry whose base key ends in a projection marker (a ``frozenset``
        of columns, ``PagedColumns.partial_base_key(columns=...)``)
        disjoint from them stays, since its stream never held those
        columns; an entry without a marker holds every column and
        drops."""
        scope = str(scope)
        columns = frozenset(columns) if columns is not None else None
        dropped = dirty = 0
        with self._mu:
            self._epochs[scope] = self._epochs.get(scope, 0) + 1
            for base in [b for b in self._totals if str(b[0]) == scope]:
                self._totals.pop(base, None)
            for key in list(self._by_scope.get(scope, ())):
                if _is_block_key(key):
                    s0, e0 = key[-1]
                    if e0 <= start or (end is not None and s0 >= end):
                        continue  # disjoint: the block stays
                    if (columns is not None and len(key) > 1
                            and isinstance(key[-2], frozenset)
                            and key[-2].isdisjoint(columns)):
                        continue  # its stream never held those columns
                    dirty += 1
                if self._drop_entry_locked(key):
                    dropped += 1
            # the pinned head may be cut: re-derive each high water mark
            for base in [b for b in self._pin_hw if str(b[0]) == scope]:
                hw = 0
                for s0, e0 in sorted(k[-1] for k in self._pinned
                                     if k[:-1] == base):
                    if s0 > hw:
                        break
                    hw = max(hw, e0)
                self._pin_hw[base] = hw
            if "dirty_invalidations" in self._stats:
                self._stats["dirty_invalidations"] += dirty
                self._stats["pinned_bytes"] = self._pinned_bytes
            self._stats["invalidations"] += dropped
        if dropped:
            _metrics().counter("devcache.invalidations").inc(dropped)
        if dirty:
            _metrics().counter("devcache.dirty_invalidations").inc(dirty)
        return dropped

    def invalidate(self, scope: str) -> int:
        """Drop every entry of one set now, and (partial mode) bump its
        epoch — the hook of every whole-set write. Returns entries
        dropped."""
        scope = str(scope)
        with self._mu:
            if self.partial:
                self._epochs[scope] = self._epochs.get(scope, 0) + 1
                for table in (self._pin_hw, self._totals):
                    for base in [b for b in table if str(b[0]) == scope]:
                        table.pop(base, None)
            dropped = 0
            for key in list(self._by_scope.get(scope, ())):
                if self._drop_entry_locked(key):
                    dropped += 1
            self._stats["invalidations"] += dropped
            if "pinned_bytes" in self._stats:
                self._stats["pinned_bytes"] = self._pinned_bytes
        if dropped:
            _metrics().counter("devcache.invalidations").inc(dropped)
        return dropped

    def clear(self) -> int:
        """Drop everything (bumping every cached scope's epoch)."""
        with self._mu:
            dropped = len(self._entries)
            if self.partial:
                for scope in {str(k[0]) for k in self._entries}:
                    self._epochs[scope] = self._epochs.get(scope, 0) + 1
            self._entries.clear()
            self._by_scope.clear()
            self._session_meta.clear()
            self._unpin_all_locked()
            self._totals.clear()
            self._bytes = 0
            self._stats["invalidations"] += dropped
            return dropped

    # --- session-state entries (TTL'd, mutable; serve/sessions.py) ---
    def set_session_spill(
            self, cb: Optional[Callable[[str, str, str, Any], None]]
    ) -> None:
        """Register ``cb(sid, model, layer, value)``, run for every
        session entry that LRU pressure or TTL expiry drops. It runs
        under the cache lock, so it must be a leaf (record to the host
        arena and return)."""
        with self._mu:
            self._session_spill_cb = cb
            if cb is not None:
                self._session_on = True

    def session_put(self, sid: str, model: str, layer: str, value: Any,
                    ttl_s: float) -> bool:
        """Install (or replace) one session state entry. Unlike set
        blocks, session entries install on a budget-less cache too; False
        only when the entry alone exceeds an enabled budget."""
        key = (session_scope(sid), str(model), str(layer))
        nbytes = _value_nbytes(value)
        with self._mu:
            self._session_on = True
            if self.enabled and nbytes > self._budget:
                self._stats["rejected"] += 1
                return False
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            if self.enabled:
                self._evict_to_fit_locked(nbytes)
            self._entries[key] = ([value], nbytes)
            self._bytes += nbytes
            self._by_scope.setdefault(key[0], set()).add(key)
            self._session_meta[key] = {
                "deadline": time.monotonic() + float(ttl_s),
                "ttl": float(ttl_s)}
            self._stats["installs"] += 1
        from netsdb_tpu_torch import obs

        obs.REGISTRY.counter("devcache.installs").inc()
        obs.attrib.account("devcache.installs", scope=key[0])
        self._publish_session_bytes()
        return True

    def session_get(self, sid: str, model: str, layer: str,
                    touch: bool = True) -> Optional[Any]:
        """The resident state of one layer, or None (evicted, expired or
        never installed: the caller revives from the arena). A hit
        refreshes the LRU position and the TTL deadline (``touch``);
        expiry is checked here as well as by :meth:`session_sweep`."""
        key = (session_scope(sid), str(model), str(layer))
        with self._mu:
            entry = self._entries.get(key)
            meta = self._session_meta.get(key)
            if entry is None or meta is None:
                return None
            if time.monotonic() >= meta["deadline"]:
                meta["expired"] = True
                self._drop_entry_locked(key)
                return None
            if touch:
                self._entries.move_to_end(key)
                meta["deadline"] = time.monotonic() + meta["ttl"]
            return entry[0][0]

    def session_update(self, sid: str, model: str, layer: str,
                       value: Any) -> bool:
        """Swap one resident entry's value in place (a decode step's
        state advance), re-accounting bytes and refreshing LRU and TTL.
        False when the entry is not resident: the caller installs with
        :meth:`session_put` instead."""
        key = (session_scope(sid), str(model), str(layer))
        nbytes = _value_nbytes(value)
        with self._mu:
            entry = self._entries.get(key)
            meta = self._session_meta.get(key)
            if entry is None or meta is None:
                return False
            self._bytes += nbytes - entry[1]
            self._entries[key] = ([value], nbytes)
            self._entries.move_to_end(key)
            meta["deadline"] = time.monotonic() + meta["ttl"]
            if self.enabled:
                self._evict_to_fit_locked(0)
        self._publish_session_bytes()
        return True

    def session_drop(self, sid: str) -> int:
        """Drop every entry of one session with no spill (a close).
        Returns the entries dropped."""
        scope = session_scope(sid)
        with self._mu:
            keys = list(self._by_scope.get(scope, ()))
            for key in keys:
                self._session_meta.pop(key, None)  # first: no spill
                self._drop_entry_locked(key)
        self._publish_session_bytes()
        return len(keys)

    def session_sweep(self, now: Optional[float] = None) -> int:
        """Drop, spilling, every session entry past its TTL deadline.
        Returns the entries expired."""
        now = time.monotonic() if now is None else now
        with self._mu:
            expired = [k for k, m in self._session_meta.items()
                       if now >= m["deadline"]]
            for key in expired:
                self._session_meta[key]["expired"] = True
                self._drop_entry_locked(key)
        if expired:
            self._publish_session_bytes()
        return len(expired)

    def session_resident_bytes(self) -> int:
        """Live bytes of every resident session entry."""
        with self._mu:
            return sum(self._entries[k][1] for k in self._session_meta
                       if k in self._entries)

    def session_entries(self) -> int:
        with self._mu:
            return len(self._session_meta)

    def _publish_session_bytes(self) -> None:
        _metrics().gauge("session.resident_bytes").set(
            self.session_resident_bytes())

    def stats(self) -> Dict[str, int]:
        """Counter snapshot plus live bytes, entries and budgets."""
        with self._mu:
            out = {k: v for k, v in self._stats.items()
                   if self._session_on or not k.startswith("session_")}
            out["bytes"] = self._bytes
            out["entries"] = len(self._entries)
            out["budget_bytes"] = self._budget
            if self._session_on:
                out["session_entries"] = len(self._session_meta)
                out["session_bytes"] = sum(
                    self._entries[k][1] for k in self._session_meta
                    if k in self._entries)
            if self.partial:
                out["pin_budget_bytes"] = self._pin_budget
            return out
