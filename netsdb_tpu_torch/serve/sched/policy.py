"""Scheduling policy inputs: plan fingerprints, touched-set
extraction, and the cache-aware hot-set affinity gate.

Queries are keyed two ways (the tentpole's "set/plan-keyed queues"):

* the **plan fingerprint** (:func:`frame_fingerprint`) — a canonical
  digest of the decoded EXECUTE payload after every per-request
  metadata key (qid/client/token/lane) was popped. Byte-identical
  frames from different clients digest identically; the coalesce
  table single-flights on it.
* the **placed sets touched** (:func:`sets_touched`) — the
  ``db:set`` scopes the plan's SCAN leaves stream from. The affinity
  gate keys on the subset that is COLD in the device cache: when an
  installer is already streaming those sets, sibling queries (same
  sets, different plans — the ones coalescing can't collapse) queue
  behind it and wake into the warm devcache instead of racing cold
  streams through one arena. The wait is bounded and purely a
  thrash-avoidance window — correctness never depends on it (an
  installer that fails releases the gate; siblings then stream cold
  themselves).
"""

from __future__ import annotations

import contextlib
import hashlib
import re
import threading
from typing import Any, Callable, Dict, FrozenSet, Iterable, Optional

from netsdb_tpu_torch import obs
from netsdb_tpu_torch.utils.locks import TrackedLock
from netsdb_tpu_torch.utils.timing import deadline_after, seconds_left

#: SCAN leaves of a textual plan — the to_plan_string / parse_plan
#: surface form (plan/computations.ScanSet.__repr__)
_SCAN_RE = re.compile(r"SCAN\(\s*'([^']*)'\s*,\s*'([^']*)'\s*\)")


def frame_fingerprint(typ: Any, payload: Any) -> Optional[str]:
    """Canonical digest of one decoded EXECUTE frame (metadata keys
    already popped by the dispatch), pickled by ``serve/_fnpickle.py``
    (EXECUTE_COMPUTATIONS payloads hold callables plain pickle refuses):
    identical wire bytes decode to isomorphic object graphs, which
    re-serialize identically within one process. None on any
    serialization trouble — the frame then simply does not coalesce (a
    safe fallback, never a correctness hazard)."""
    from netsdb_tpu_torch.serve import _fnpickle

    try:
        blob = _fnpickle.dumps((int(typ), payload))
    except Exception as e:  # noqa: BLE001 — unfingerprintable → solo run
        del e
        return None
    return hashlib.sha256(blob).hexdigest()


def _dag_scan_sets(sinks: Iterable[Any]) -> FrozenSet[str]:
    from netsdb_tpu_torch.plan.computations import ScanSet

    out = set()
    seen = set()
    stack = list(sinks or ())
    while stack:
        node = stack.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        if isinstance(node, ScanSet):
            out.add(f"{node.db}:{node.set_name}")
        stack.extend(getattr(node, "inputs", ()) or ())
    return frozenset(out)


def sets_touched(typ: Any, payload: Any) -> FrozenSet[str]:
    """``db:set`` scopes an EXECUTE frame's plan streams FROM (scan
    leaves; write targets are outputs and don't key affinity). Empty
    on anything unparseable — the query then runs ungated."""
    from netsdb_tpu_torch.serve.protocol import MsgType

    try:
        if typ == MsgType.EXECUTE_PLAN:
            plan = payload.get("plan") or ""
            return frozenset(f"{db}:{s}"
                             for db, s in _SCAN_RE.findall(str(plan)))
        if typ == MsgType.EXECUTE_COMPUTATIONS:
            return _dag_scan_sets(payload.get("sinks") or ())
    except Exception as e:  # noqa: BLE001 — ungated is always safe
        del e
    return frozenset()


class AffinityGate:
    """Cold-set single-installer gate, keyed per PAGE RANGE.

    ``cache_probe(scope)`` answers three ways (the partial-run cache's
    coverage probe, ``ServeController._devcache_warm``):

    * ``True`` — warm (fully resident / ungated): admit immediately.
      With block-granular caching this is what a query over an
      already-warm set gets even though earlier streams installed it
      piecemeal — full coverage, zero gating.
    * ``False`` — cold from row 0: classic single-installer gating.
    * an ``int`` — partially covered: the contiguous resident prefix
      ends at that row, so only the COLD REMAINDER ``[covered, end)``
      needs installing. The query still serializes as that
      remainder's gap installer (two gap installers racing the same
      remainder is exactly the cold-stream thrash the gate exists to
      prevent), but the gate's key records the remainder start — a
      sibling arriving after the gap landed probes warm and admits
      without ever touching the gate.

    Queries whose cold/remainder key matches an in-progress installer
    wait (bounded) for its completion and then run into the warm
    cache."""

    def __init__(self, cache_probe: Callable[[str], Any],
                 wait_s: float = 30.0):
        self._mu = TrackedLock("sched.AffinityGate._mu")
        # scope -> the installer's completion event. Membership is
        # PER SCOPE, not per cold-set key: a query whose cold sets
        # merely OVERLAP an in-progress installer's must still wait
        # (two "installers" sharing one cold set would race exactly
        # the cold streams the gate exists to prevent). The remainder
        # start of the current installer rides alongside for
        # introspection/annotation.
        self._installing: Dict[str, threading.Event] = {}
        self._remainder: Dict[str, int] = {}
        self._probe = cache_probe
        self.wait_s = float(wait_s)

    @contextlib.contextmanager
    def admit(self, scopes: Iterable[str]):
        # remainder-aware cold map: scope -> first cold row (0 = fully
        # cold; >0 = the resident prefix ends there and only the gap
        # serializes)
        cold: Dict[str, int] = {}
        for s in (scopes or ()):
            p = self._probe(s)
            if p is True:
                continue
            cold[s] = 0 if p is False else max(int(p), 0)
        if not cold:
            yield
            return
        tr = obs.current_trace()
        with self._mu:
            busy = {self._installing[s] for s in cold
                    if s in self._installing}
            # become the installer for every cold scope NOT already
            # covered — a query overlapping an in-progress install
            # still owns its uncovered remainder, so a third query on
            # that remainder queues behind THIS one instead of racing
            # a second cold stream
            mine = [s for s in cold if s not in self._installing]
            ev = None
            if mine:
                ev = threading.Event()
                for s in mine:
                    self._installing[s] = ev
                    self._remainder[s] = cold[s]
        if mine:
            obs.REGISTRY.counter("sched.affinity_installs").inc()
            if tr is not None:
                tr.annotate("sched.affinity",
                            "install" if not busy else "install+wait")
                # which ranges this installer owns: row 0 for a fully
                # cold set, the warm prefix's end for a gap install
                tr.annotate("sched.affinity_remainder",
                            {s: cold[s] for s in mine})
        if busy:
            obs.REGISTRY.counter("sched.affinity_hits").inc()
            if tr is not None:
                if not mine:
                    tr.annotate("sched.affinity", "wait")
                tr.add("sched.affinity_hits")
            deadline = deadline_after(self.wait_s)  # ONE bound, all evs
            with obs.span("server.sched.affinity_wait", "serve"):
                for busy_ev in busy:
                    left = seconds_left(deadline)
                    if left <= 0 or not busy_ev.wait(left):
                        break  # bounded: proceed past a slow installer
        try:
            yield
        finally:
            if ev is not None:
                # success or failure, the gate opens: siblings proceed
                # (into a warm cache on success, cold on failure)
                with self._mu:
                    for s in mine:
                        if self._installing.get(s) is ev:
                            del self._installing[s]
                            self._remainder.pop(s, None)
                ev.set()
