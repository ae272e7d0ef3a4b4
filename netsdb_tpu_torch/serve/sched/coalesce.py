"""Identical-query coalescing — single-flight EXECUTE frames.

N concurrent byte-identical idempotent ``EXECUTE_COMPUTATIONS`` /
``EXECUTE_PLAN`` frames used to race N cold streams through one arena;
the idempotency-token cache already proves reply REUSE is safe for
these frames (a retry replays the cached reply verbatim), so running
the execution more than once concurrently buys nothing and thrashes
the device cache. This table collapses them: the first frame with a
given fingerprint becomes the *leader* and executes normally
(mirroring, ordering locks, admission — all of it); every concurrent
duplicate becomes a *waiter* that parks on the leader's completion
event and fans the leader's reply out under its OWN query id, trace
and idempotency token (each waiter's dispatch opened its own trace;
the coalesce decision is annotated into it with the leader's qid so
GET_TRACE joins the fan-out).

Failure contract (``tests/test_sched.py`` chaos coverage): a waiter
whose leader dies mid-run gets the typed retryable
:class:`~netsdb_tpu.serve.errors.CoalesceAborted` — never a wrong or
half-written reply — and nothing ran under the waiter's token, so its
retry re-executes from scratch (the dead flight is gone from the
table before the event fires).

The fingerprint is computed by ``policy.frame_fingerprint`` over the
decoded payload AFTER the per-request metadata (qid, client id,
idempotency token, lane hint) was popped — "byte-identical" means
identical in every byte the execution can observe.

Failover scope: the mirror hop forwards the coalesce LEADER's token;
each waiter's token is finished in the leader daemon's reply cache
AND shipped to followers as a TOKEN_ALIAS frame mapping it onto the
leader token's cached reply (``run``'s ``token``/``waiter_info``
plumbing surfaces the leader token to the serve layer, which emits
the alias after the mirrored execution acked). A waiter client's
retry against a PROMOTED follower therefore still dedupes —
at-most-once survives the failover edge instead of degrading to
at-least-once-same-result.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional

from netsdb_tpu_torch import obs
from netsdb_tpu_torch.serve.errors import CoalesceAborted
from netsdb_tpu_torch.utils.locks import TrackedLock


class _Flight:
    __slots__ = ("done", "result", "error", "leader_qid",
                 "leader_token", "waiters", "t0")

    def __init__(self, leader_qid: Optional[str],
                 leader_token: Optional[str] = None):
        self.done = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.leader_qid = leader_qid
        # the leader request's idempotency token — what a waiter's
        # token aliases to across the mirror hop (TOKEN_ALIAS)
        self.leader_token = leader_token
        self.waiters = 0
        self.t0 = time.perf_counter()


class CoalesceTable:
    """fingerprint → in-flight execution; single-flight semantics.

    ``done_ttl_s``/``done_max`` arm the COMPLETED-fingerprint cache: a
    byte-identical EXECUTE arriving just after its coalesce leader
    finished (the near-miss the in-flight table cannot catch) still
    hits — the retained reply is served under the late waiter's own
    qid/token, counted as ``sched.coalesce_late_hits``.  The window is
    deliberately tight and doubly bounded (TTL + entry count, oldest
    evicted): correctness rests on the same idempotency argument as
    coalescing itself — these frames replay verbatim under a retried
    token — but a long retention would serve ever-staler reads, so the
    TTL caps the staleness exactly like a retry of a just-completed
    request would experience.  ``done_ttl_s=0`` disables retention."""

    def __init__(self, done_ttl_s: float = 0.0, done_max: int = 32):
        self._mu = TrackedLock("sched.CoalesceTable._mu")
        self._inflight: Dict[str, _Flight] = {}
        self._done_ttl_s = float(done_ttl_s or 0.0)
        self._done_max = int(done_max)
        # fingerprint → (result, finished_at, leader_token);
        # LRU-ordered, TTL-pruned on every touch (monotonic clock —
        # the serve discipline)
        self._done: "OrderedDict[str, Tuple[Any, float, Optional[str]]]" \
            = OrderedDict()

    def _prune_done(self, now: float) -> None:
        """Drop expired/overflow entries (caller holds ``_mu``)."""
        ttl = self._done_ttl_s
        while self._done:
            _k, (_v, t, _tok) = next(iter(self._done.items()))
            if now - t <= ttl and len(self._done) <= self._done_max:
                break
            self._done.popitem(last=False)

    def _retain(self, key: str, result: Any,
                leader_token: Optional[str] = None) -> None:
        """Record a leader's completed reply for the late-hit window
        (no-op when retention is disabled)."""
        if self._done_ttl_s <= 0:
            return
        now = time.monotonic()
        with self._mu:
            self._done[key] = (result, now, leader_token)
            self._done.move_to_end(key)
            self._prune_done(now)

    def done_entries(self) -> int:
        """Live completed-fingerprint entries (observability probe)."""
        with self._mu:
            self._prune_done(time.monotonic())
            return len(self._done)

    def waiters(self, key: str) -> int:
        """How many requests are currently coalesced behind ``key``'s
        leader (0 when nothing is in flight) — test/observability
        probe."""
        with self._mu:
            fl = self._inflight.get(key)
            return fl.waiters if fl is not None else 0

    def run(self, key: str, fn: Callable[[], Any],
            wait_s: Optional[float],
            token: Optional[str] = None,
            waiter_info: Optional[Dict[str, Any]] = None) -> Any:
        """Single-flight ``fn`` under ``key``. The leader runs ``fn``
        OUTSIDE the table lock; waiters park on its event (bounded by
        ``wait_s``) and return the leader's result verbatim. Leader
        exceptions propagate unchanged to the leader and surface to
        every waiter as the typed retryable :class:`CoalesceAborted`.

        ``token`` is THIS request's idempotency token; the leader's is
        stashed on the flight (and the retained late-hit entry).
        ``waiter_info`` (a caller-owned dict) gets
        ``waiter_info["leader_token"]`` filled when this request was
        absorbed by another flight — the serve layer then ships a
        TOKEN_ALIAS frame so the waiter's token dedupes on followers
        across a failover, not just here."""
        tr = obs.current_trace()
        with self._mu:
            if self._done_ttl_s > 0:
                # prune on EVERY run, not just retention touches: a
                # retained large reply must not outlive its TTL by
                # more than the daemon's idle gap between any two
                # coalescable requests
                self._prune_done(time.monotonic())
            fl = self._inflight.get(key)
            if fl is None and self._done_ttl_s > 0:
                # the near-miss window: an identical frame whose
                # leader JUST finished replays the retained reply
                # under this request's own qid/token
                hit = self._done.get(key)
                if hit is not None:
                    result, t_done, ltok = hit
                    if time.monotonic() - t_done <= self._done_ttl_s:
                        self._done.move_to_end(key)
                        obs.REGISTRY.counter(
                            "sched.coalesce_late_hits").inc()
                        if tr is not None:
                            tr.annotate("sched.coalesce_late_hit", key[:16])
                            tr.add("sched.coalesce_late_hits")
                        if waiter_info is not None and ltok is not None:
                            waiter_info["leader_token"] = ltok
                        return result
                    self._done.pop(key, None)
            if fl is None:
                fl = self._inflight[key] = _Flight(
                    tr.qid if tr is not None else None,
                    leader_token=token)
                leader = True
            elif wait_s is not None \
                    and time.perf_counter() - fl.t0 >= wait_s:
                # the in-flight leader has already outlived the wait
                # bound: parking behind it can only time out (and a
                # waiter that ALREADY timed out would retry straight
                # back into the same flight, failing every attempt of
                # a request that would succeed solo) — run this one
                # uncoalesced instead
                fl = None
                leader = False
            else:
                fl.waiters += 1
                leader = False
        if fl is None:
            return fn()
        if leader:
            try:
                out = fn()
            except BaseException as e:
                fl.error = e
                raise
            else:
                fl.result = out
                self._retain(key, out, leader_token=fl.leader_token)
                return out
            finally:
                # the flight leaves the table BEFORE the event fires:
                # a waiter released by a FAILED leader retries into a
                # fresh execution, never onto the same dead flight
                with self._mu:
                    self._inflight.pop(key, None)
                fl.done.set()
        # waiter path
        obs.REGISTRY.counter("sched.coalesce_hits").inc()
        if tr is not None:
            tr.annotate("sched.coalesced_into", fl.leader_qid or "?")
            tr.add("sched.coalesce_hits")
        with obs.span("server.sched.coalesce_wait", "serve"):
            completed = fl.done.wait(wait_s)
        if not completed:
            with self._mu:
                fl.waiters -= 1  # departed — keep the probe honest
            obs.REGISTRY.counter("sched.coalesce_failures").inc()
            raise CoalesceAborted(
                f"coalesced leader {fl.leader_qid or '?'} still "
                f"executing after {wait_s}s — this request never ran; "
                f"a retry will execute solo (over-age flights are "
                f"not re-joined)")
        if fl.error is not None:
            obs.REGISTRY.counter("sched.coalesce_failures").inc()
            raise CoalesceAborted(
                f"coalesced leader {fl.leader_qid or '?'} failed "
                f"({type(fl.error).__name__}: {fl.error}) — this "
                f"request never ran; retry re-executes")
        if waiter_info is not None and fl.leader_token is not None:
            waiter_info["leader_token"] = fl.leader_token
        return fl.result
