"""Serve-side query scheduler — the policy-driven admission layer.

netsDB's master schedules TCAP JobStages onto workers with a job queue
as the central control point (``QuerySchedulerServer``); our serve
layer admitted jobs through a bare bounded semaphore. This package is
the replacement control point, three policies composed:

* **lanes** (``queue.py``) — per-client priority lanes with weights,
  deficit scheduling, deterministic anti-starvation aging, per-lane
  quotas and typed backpressure (``LaneSaturated`` vs
  ``AdmissionFull``, both carrying a server-computed ``retry_after_s``
  from the lane's queue-wait histogram);
* **coalescing** (``coalesce.py``) — byte-identical idempotent
  EXECUTE frames single-flight into one execution fanned out to every
  waiter under its own qid/trace/token;
* **affinity** (``policy.py``) — queries keyed by the placed sets
  they scan; siblings of a cold-set installer queue behind it and
  wake into the warm device cache.

Decisions are observable: ``sched.*`` metrics in the registry, a
``sched`` collector section in COLLECT_STATS, and per-query trace
annotations and ``server.sched.*`` spans.

This is the port's copy of ``netsdb_tpu/serve/sched/``, with the
feedback loop (lane weights and quotas reseeded from the attribution and
operator ledgers) and the SLO load shedding; pin auto-sizing and the
rebalance cadence raise (see :class:`QueryScheduler`).
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
from typing import Any, Dict, Iterable, Optional

from netsdb_tpu_torch import obs
from netsdb_tpu_torch.serve.sched.coalesce import CoalesceTable
from netsdb_tpu_torch.serve.sched.policy import (  # noqa: F401 — re-exported
    AffinityGate,
    frame_fingerprint,
    sets_touched,
)
from netsdb_tpu_torch.serve.sched.queue import (  # noqa: F401 — re-exported
    DEFAULT_LANE,
    AdmissionTicket,
    LaneScheduler,
)
from netsdb_tpu_torch.utils.locks import TrackedLock

#: the dispatch-extent lane hint (LANE_KEY popped off the frame) — the
#: same zero-plumbing propagation the client identity uses
_lane_var: "contextvars.ContextVar[Optional[str]]" = \
    contextvars.ContextVar("netsdb_sched_lane", default=None)


def current_lane() -> Optional[str]:
    return _lane_var.get()


@contextlib.contextmanager
def lane_context(lane: Optional[str]):
    """Install the frame's lane hint for the handler's dynamic extent
    (None installs nothing — mirrored/nested execution keeps the outer
    hint)."""
    if lane is None:
        yield
        return
    token = _lane_var.set(str(lane))
    try:
        yield
    finally:
        _lane_var.reset(token)


class QueryScheduler:
    """The facade ``ServeController`` drives: lanes + coalescing +
    affinity behind one object, exported as the registry's ``sched``
    collector section.

    ``feedback=True`` reseeds the lane weights and quotas from the
    attribution and operator ledgers every ``feedback_every`` admissions
    (``sched/feedback.py``'s formula); ``slo_source`` (a no-arg callable
    naming the objectives breached on every window, ``SLOEngine.
    breached_objectives``) halves the heaviest lane's quota while any
    breach lasts. Both run on the same cadence, on a background thread
    off the admission path. The pin-budget auto-sizing (``pin_auto``)
    and the rebalance cadence (``rebalance_cb``) belong to the daemon
    pool and raise ``NotImplementedError`` naming ROADMAP.md A7 part
    2."""

    def __init__(self, slots: int,
                 lanes: Optional[Dict[str, float]] = None,
                 quota: int = 0, aging_every: int = 8,
                 coalesce: bool = True, affinity: bool = True,
                 affinity_wait_s: float = 30.0,
                 coalesce_wait_s: Optional[float] = 300.0,
                 coalesce_done_ttl_s: float = 0.0,
                 coalesce_done_max: int = 32,
                 cache_probe=None,
                 feedback: bool = False, feedback_every: int = 64,
                 slo_source=None, pin_auto=None, rebalance_cb=None):
        if pin_auto is not None or rebalance_cb is not None:
            raise NotImplementedError(
                "pin-budget auto-sizing and the rebalance cadence belong to "
                "the daemon pool, which is not ported yet: ROADMAP.md A7 "
                "part 2")
        self.lanes = LaneScheduler(slots, lanes=lanes, quota=quota,
                                   aging_every=aging_every)
        self.feedback_enabled = bool(feedback)
        self.shed_enabled = slo_source is not None
        self._slo_source = slo_source
        self._feedback_every = max(int(feedback_every or 0), 1)
        self._base_quota = max(int(quota or 0), 0)
        self._fb_mu = TrackedLock("sched.QueryScheduler._fb_mu")
        self._fb_count = 0
        self._fb_running = False
        self.coalesce_enabled = bool(coalesce)
        self.coalesce_wait_s = coalesce_wait_s
        self._coalesce = CoalesceTable(
            done_ttl_s=coalesce_done_ttl_s, done_max=coalesce_done_max)
        self.affinity_enabled = bool(affinity) \
            and cache_probe is not None
        self._affinity = AffinityGate(cache_probe or (lambda s: True),
                                      wait_s=affinity_wait_s)
        obs.REGISTRY.register_collector("sched", self.snapshot)

    # --- lanes --------------------------------------------------------
    def acquire(self, lane: Optional[str],
                timeout_s: float) -> AdmissionTicket:
        if self.feedback_enabled or self.shed_enabled:
            self._maybe_feedback()
        return self.lanes.acquire(lane, timeout_s)

    def _maybe_feedback(self) -> None:
        with self._fb_mu:
            self._fb_count += 1
            due = (self._fb_count % self._feedback_every == 0
                   and not self._fb_running)
            if due:
                self._fb_running = True
        if due:
            # off the admission path: the ledger snapshots and the
            # reseed must not become a periodic latency spike
            threading.Thread(target=self._feedback_bg, daemon=True,
                             name="netsdb-torch-sched-feedback").start()

    def _feedback_bg(self) -> None:
        try:
            if self.feedback_enabled:
                self.refresh_feedback()
            if self.shed_enabled:
                self.refresh_shed()
        finally:
            with self._fb_mu:
                self._fb_running = False

    def refresh_shed(self):
        """One load-shedding check (``sched/feedback.py``): an objective
        breached on every window halves the heaviest non-reserved lane's
        quota and ticks ``sched.shed_events``; no breach lifts every shed.
        Returns the lane shed by this check, else None."""
        from netsdb_tpu_torch.serve.sched import feedback as _feedback

        try:
            breached = list(self._slo_source() or ())
        except Exception as e:  # noqa: BLE001 — a broken probe must
            del e              # never wedge admission; skip the check
            return None
        if not breached:
            self.lanes.unshed()
            return None
        if self.lanes.shed_lanes():
            return None  # one shed at a time; wait for recovery
        snap = self.lanes.snapshot()
        lane = _feedback.pick_shed_lane(snap.get("lanes", {}),
                                        reserved=self.lanes.reserved_lanes)
        if lane is None:
            return None
        if self.lanes.shed(lane, _feedback.SHED_FACTOR,
                           _feedback.SHED_MIN_QUOTA) is None:
            return None
        obs.REGISTRY.counter("sched.shed_events").inc()
        return lane

    def refresh_feedback(self):
        """Reseed the lane weights and quotas from the attribution and
        operator ledgers (``sched/feedback.py``'s formula). Returns
        (weights, quotas), empty when no lane cleared the evidence
        floor."""
        from netsdb_tpu_torch.serve.sched import feedback as _feedback

        weights, quotas = _feedback.seed_lanes(
            obs.attrib.LEDGER.snapshot(),
            obs.operators.LEDGER.snapshot(),
            base_quota=self._base_quota,
            reserved=self.lanes.reserved_lanes)
        if weights:
            self.lanes.reseed(weights, quotas)
            obs.REGISTRY.counter("sched.feedback_reseeds").inc()
        return weights, quotas

    def release(self, ticket: AdmissionTicket) -> None:
        self.lanes.release(ticket)

    def retry_after_s(self, lane: str) -> Optional[float]:
        return self.lanes.retry_after_s(lane)

    # --- coalescing ---------------------------------------------------
    def coalesced(self, typ: Any, payload: Any, fn,
                  token: Optional[str] = None,
                  waiter_info: Optional[Dict[str, Any]] = None) -> Any:
        """Single-flight ``fn`` when the frame fingerprints (and
        coalescing is on); otherwise just run it. ``token`` /
        ``waiter_info`` ride through to
        :meth:`~netsdb_tpu.serve.sched.coalesce.CoalesceTable.run` —
        the token-alias plumbing that keeps waiter idempotency tokens
        replayable across the mirror hop."""
        if not self.coalesce_enabled:
            return fn()
        key = frame_fingerprint(typ, payload)
        if key is None:
            return fn()
        return self._coalesce.run(key, fn, self.coalesce_wait_s,
                                  token=token, waiter_info=waiter_info)

    def coalesce_waiters(self, typ: Any, payload: Any) -> int:
        """Waiters currently parked behind this frame's fingerprint
        (test/observability probe)."""
        key = frame_fingerprint(typ, payload)
        return self._coalesce.waiters(key) if key else 0

    # --- affinity -----------------------------------------------------
    def affinity(self, scopes: Iterable[str]):
        """Context manager gating one execution on the hot-set
        installer policy (no-op when disabled or scope-free)."""
        if not self.affinity_enabled or not scopes:
            return contextlib.nullcontext()
        return self._affinity.admit(scopes)

    # --- introspection ------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        out = self.lanes.snapshot()
        out["coalesce_enabled"] = self.coalesce_enabled
        out["affinity_enabled"] = self.affinity_enabled
        return out
