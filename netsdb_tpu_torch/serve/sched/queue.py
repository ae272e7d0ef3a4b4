"""Per-client priority lanes: weighted-deficit admission with aging,
quotas and typed backpressure.

The reference's ``QuerySchedulerServer`` keeps ONE job queue and parks
every submitted job on it; our old serve layer kept one bounded
semaphore. Both are first-come: a chatty tenant monopolizes the
controller and a saturated queue answers everyone with the same
blanket refusal. This module replaces the semaphore with *lanes*:

* every request is admitted through a lane keyed by the frame's
  scheduler hint (``protocol.LANE_KEY``) or its client identity
  (``CLIENT_ID_KEY``) — per-tenant queues with zero client changes;
* free slots are granted to the non-empty lane with the lowest
  *virtual time* (``served / weight``) — weighted fair queueing over
  admission counts, so a weight-10 lane gets ~10× the admissions of a
  weight-1 lane under saturation, never 100%;
* **aging** bounds starvation deterministically: every
  ``aging_every``-th grant goes to the lane whose head waiter has
  waited longest, regardless of weights — a saturated low-priority
  lane admits within a bounded number of high-priority admissions
  (the property ``tests/test_sched.py`` pins);
* **quotas** refuse per-lane, typed: a lane already holding
  ``quota`` queued waiters rejects with :class:`LaneSaturated` — a
  DISTINCT retryable error from :class:`AdmissionFull`, carrying the
  lane's observed queue depth and a ``retry_after_s`` hint computed
  from the lane's queue-wait histogram (the metrics registry), so
  the client backs off for a server-measured interval instead of
  blind exponential jitter.

Locking: one tracked mutex (``sched.LaneScheduler._mu`` — born into
the audited hierarchy, ``docs/ANALYSIS.md``) guards the lane table;
each waiter parks OUTSIDE it on its own event, so a grant wakes
exactly the granted thread (no O(queued) spurious-wakeup convoy per
release). Grants happen under the lock in ``_pump_locked``.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, Optional

from netsdb_tpu_torch import obs
from netsdb_tpu_torch.serve.errors import AdmissionFull, LaneSaturated
from netsdb_tpu_torch.utils.locks import TrackedLock
from netsdb_tpu_torch.utils.timing import deadline_after, seconds_left

#: lane used when a frame carries neither a lane hint nor a client id
DEFAULT_LANE = "default"

#: bound on distinct lanes (a client fabricating lane names cannot grow
#: daemon memory without bound — extras fold into the default lane)
MAX_LANES = 256


class _Lane:
    __slots__ = ("name", "weight", "q", "served", "wait_hist")

    def __init__(self, name: str, weight: float):
        self.name = name
        self.weight = max(float(weight), 1e-6)
        self.q: "deque[_Waiter]" = deque()
        self.served = 0
        # per-lane queue-wait distribution: the retry_after_s hint and
        # the `sched` collector section read it; the process-wide
        # `sched.queue_wait_s` registry histogram gets the same
        # observations
        self.wait_hist = obs.Histogram(max_samples=128)


class _Waiter:
    # per-waiter event, not a shared condition: a grant wakes exactly
    # the granted thread — no O(queued) spurious-wakeup convoy on
    # every release of a saturated daemon
    __slots__ = ("t0", "granted", "ev")

    def __init__(self, t0: float):
        self.t0 = t0
        self.granted = False
        self.ev = threading.Event()


class AdmissionTicket:
    """Proof of admission — hand it back to :meth:`LaneScheduler.
    release` exactly once."""

    __slots__ = ("lane", "waited_s")

    def __init__(self, lane: str, waited_s: float):
        self.lane = lane
        self.waited_s = waited_s


class LaneScheduler:
    """Weighted-deficit lane admission over ``slots`` concurrent
    executions (the ``max_jobs`` bound the semaphore used to hold)."""

    def __init__(self, slots: int,
                 lanes: Optional[Dict[str, float]] = None,
                 quota: int = 0, aging_every: int = 8):
        self._mu = TrackedLock("sched.LaneScheduler._mu")
        self._free = max(int(slots), 1)
        self.slots = self._free
        self._quota = max(int(quota or 0), 0)
        self._aging_every = max(int(aging_every or 0), 0)
        self._grants_since_aged = 0
        self._weights = {str(k): float(v)
                         for k, v in (lanes or {}).items()}
        # lane names the OPERATOR configured — the feedback reseed
        # never overrides an explicit weight
        self.reserved_lanes = frozenset(self._weights)
        # per-lane quota overrides (feedback-seeded); lanes not listed
        # keep the global _quota
        self._lane_quotas: Dict[str, int] = {}
        # SLO load-shed override: lane -> the pre-shed quota override
        # (None = the lane had no override; restore deletes the entry).
        # At most one lane is shed at a time.
        self._shed: Dict[str, Optional[int]] = {}
        self._lanes: "OrderedDict[str, _Lane]" = OrderedDict()
        self._depth = 0

    def reseed(self, weights: Dict[str, float],
               quotas: Optional[Dict[str, int]] = None) -> None:
        """Apply feedback-derived lane weights (and per-lane quota
        overrides). Existing lanes keep their served counts — only the
        weight moves, so the WFQ share shifts without resetting
        virtual time; reserved (operator-configured) lanes are never
        touched."""
        with self._mu:
            for name, w in (weights or {}).items():
                if name in self.reserved_lanes:
                    continue
                self._weights[name] = max(float(w), 1e-6)
                lane = self._lanes.get(name)
                if lane is not None:
                    lane.weight = max(float(w), 1e-6)
            for name, q in (quotas or {}).items():
                if name in self.reserved_lanes:
                    continue
                if name in self._shed:
                    # the lane is under a shed override: reseed the
                    # REMEMBERED quota so unshed restores the fresh
                    # value, never a pre-reseed stale one
                    self._shed[name] = max(int(q), 1)
                else:
                    self._lane_quotas[name] = max(int(q), 1)

    def _quota_for_locked(self, name: str) -> int:
        return self._lane_quotas.get(name, self._quota)

    def shed(self, lane: str, factor: float,
             min_quota: int = 1) -> Optional[int]:
        """Apply the SLO load-shed quota override to ``lane``:
        ``quota × factor`` (floored at ``min_quota``), remembering the
        pre-shed state for :meth:`unshed`. Returns the shed quota, or
        None when there is nothing to shed (no effective quota, lane
        already shed, or reserved). The override halves QUEUEING
        capacity only — admitted work is never cancelled."""
        name = str(lane)
        with self._mu:
            if name in self._shed or name in self.reserved_lanes:
                return None
            current = self._quota_for_locked(name)
            if current <= 0:  # unbounded lanes have no quota to halve
                return None
            shed_q = max(int(current * factor), int(min_quota))
            if shed_q >= current:
                return None  # already at the floor
            self._shed[name] = self._lane_quotas.get(name)
            self._lane_quotas[name] = shed_q
            return shed_q

    def unshed(self) -> list:
        """Lift every load-shed quota override (the first breach-free
        check restores full capacity). Returns the lane names
        restored."""
        with self._mu:
            restored = []
            for name, prev in self._shed.items():
                if prev is None:
                    self._lane_quotas.pop(name, None)
                else:
                    self._lane_quotas[name] = prev
                restored.append(name)
            self._shed.clear()
            return restored

    def shed_lanes(self) -> list:
        """Lane names currently under a shed override (introspection)."""
        with self._mu:
            return sorted(self._shed)

    # --- lane bookkeeping --------------------------------------------
    def _lane_locked(self, name: str) -> _Lane:
        lane = self._lanes.get(name)
        if lane is not None:
            return lane
        if len(self._lanes) >= MAX_LANES and name not in self._weights:
            # fabricated-lane overflow folds into the default lane
            name = DEFAULT_LANE
            lane = self._lanes.get(name)
            if lane is not None:
                return lane
        lane = _Lane(name, self._weights.get(name, 1.0))
        if self._lanes:
            # standard WFQ join rule: a new lane enters at the CURRENT
            # minimum virtual time, not zero — otherwise a tenant
            # joining a long-lived daemon would monopolize grants
            # until its served count caught up with everyone else's
            min_vt = min(ln.served / ln.weight
                         for ln in self._lanes.values())
            lane.served = min_vt * lane.weight
        self._lanes[name] = lane
        return lane

    def retry_after_s(self, lane_name: str) -> Optional[float]:
        """The scheduler's backoff hint for one lane: the observed
        queue-wait median (None until the lane has admitted anything —
        the client then falls back to its exponential policy)."""
        with self._mu:
            lane = self._lanes.get(str(lane_name))
        if lane is None:
            return None
        return lane.wait_hist.quantile(0.5)

    # --- admission ----------------------------------------------------
    def acquire(self, lane_name: Optional[str],
                timeout_s: float) -> AdmissionTicket:
        """Park on ``lane_name`` until granted a slot. Raises
        :class:`LaneSaturated` immediately when the lane's quota is
        full, :class:`AdmissionFull` (with the lane's ``retry_after_s``
        hint) when no grant lands within ``timeout_s``."""
        name = str(lane_name) if lane_name else DEFAULT_LANE
        t0 = time.perf_counter()
        deadline = deadline_after(timeout_s)
        with self._mu:
            lane = self._lane_locked(name)
            quota = self._quota_for_locked(lane.name)
            if quota and len(lane.q) >= quota:
                depth = len(lane.q)
                obs.REGISTRY.counter("sched.quota_rejects").inc()
                raise LaneSaturated(
                    f"lane {lane.name!r} quota full ({depth} queued, "
                    f"quota {quota}) — per-tenant backoff",
                    lane=lane.name, queue_depth=depth,
                    retry_after_s=lane.wait_hist.quantile(0.5))
            if not lane.q:
                # empty -> non-empty: re-sync a RE-ACTIVATING lane's
                # virtual time to the active minimum (WFQ). A bursty
                # tenant that idled while others accumulated served
                # counts must not return with a stale low vtime and
                # monopolize grants until it "catches up".
                active = [ln for ln in self._lanes.values() if ln.q]
                if active:
                    min_vt = min(ln.served / ln.weight
                                 for ln in active)
                    lane.served = max(lane.served,
                                      min_vt * lane.weight)
            w = _Waiter(t0)
            lane.q.append(w)
            self._depth += 1
            obs.REGISTRY.gauge("sched.queue_depth").set(self._depth)
            self._pump_locked()
        # park OUTSIDE the lock on this waiter's own event: only the
        # granted thread ever wakes
        if not w.ev.wait(max(seconds_left(deadline), 0.0)):
            with self._mu:
                if not w.granted:
                    # still queued (the grant/timeout race re-checks
                    # under the lock — a grant that landed after the
                    # wait timed out is kept, never dropped)
                    lane.q.remove(w)
                    self._depth -= 1
                    obs.REGISTRY.gauge("sched.queue_depth").set(
                        self._depth)
                    obs.REGISTRY.counter("sched.timeouts").inc()
                    raise AdmissionFull(
                        f"no admission slot in lane {lane.name!r} "
                        f"within {timeout_s}s ({len(lane.q)} still "
                        f"queued) — back off and retry",
                        retry_after_s=lane.wait_hist.quantile(0.5),
                        queue_depth=len(lane.q), lane=lane.name)
        waited = time.perf_counter() - t0
        with self._mu:
            lane.wait_hist.observe(waited)
        obs.REGISTRY.counter("sched.admits").inc()
        obs.REGISTRY.histogram("sched.queue_wait_s").observe(waited)
        return AdmissionTicket(lane.name, waited)

    def release(self, ticket: AdmissionTicket) -> None:
        del ticket  # identity is not needed; slots are fungible
        with self._mu:
            self._free += 1
            self._pump_locked()

    # --- the policy ---------------------------------------------------
    def _pick_locked(self) -> Optional[_Lane]:
        nonempty = [ln for ln in self._lanes.values() if ln.q]
        if not nonempty:
            return None
        if (self._aging_every
                and self._grants_since_aged >= self._aging_every
                and len(nonempty) > 1):
            # aging turn: longest-waiting head wins regardless of
            # weights — the deterministic starvation bound
            self._grants_since_aged = 0
            lane = min(nonempty, key=lambda ln: ln.q[0].t0)
            obs.REGISTRY.counter("sched.aged_grants").inc()
            return lane
        # weighted deficit: lowest virtual time (served/weight) first;
        # name breaks ties deterministically
        return min(nonempty,
                   key=lambda ln: (ln.served / ln.weight, ln.name))

    def _pump_locked(self) -> None:
        granted = False
        while self._free > 0:
            lane = self._pick_locked()
            if lane is None:
                break
            w = lane.q.popleft()
            w.granted = True
            lane.served += 1
            self._free -= 1
            self._depth -= 1
            self._grants_since_aged += 1
            granted = True
            w.ev.set()  # wake exactly the granted waiter
        if granted:
            obs.REGISTRY.gauge("sched.queue_depth").set(self._depth)

    # --- introspection ------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """The ``sched`` collector section: msgpack-safe lane table the
        COLLECT_STATS frame (and ``cli obs --sched``) ships."""
        with self._mu:
            return {
                "slots": self.slots,
                "free_slots": self._free,
                "queued": self._depth,
                "quota": self._quota,
                "lane_quotas": dict(self._lane_quotas),
                "shed_lanes": sorted(self._shed),
                "aging_every": self._aging_every,
                "lanes": {
                    name: {"weight": ln.weight, "depth": len(ln.q),
                           "served": ln.served,
                           "wait": ln.wait_hist.summary()}
                    for name, ln in self._lanes.items()},
            }
