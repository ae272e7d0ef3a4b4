"""Query-scoped tracing — the port's ``netsdb_tpu/obs/trace.py``.

A :class:`QueryTrace`, keyed by a query id minted client-side and carried
in frame metadata (``serve/protocol.QUERY_ID_KEY``), collects nested
spans across client send → daemon decode and dispatch → planner →
executor chunk loops → staging upload waits → device-cache hits, each
with a start offset from the trace's own start, a duration, a category
and counters (bytes staged, chunks, cache hits, device seconds).

Propagation is a ``contextvars.ContextVar``: the serve handler (or the
client's request path) installs the trace with :func:`trace`, and every
instrumented layer below reads it back with :func:`current_trace`, opens
:func:`span` s on it and :func:`add` s counters to it. Staging threads do
not inherit the context: a stream captures the trace on the consumer's
thread and reports counters only.

Tracing is always on (``config.obs_enabled`` is the kill switch, mirrored
into :func:`set_enabled`); without a trace every call is one
context-variable read. Finished traces land in a bounded
:class:`TraceRing`: each daemon keeps its own for the ``GET_TRACE``
frame, client processes keep :data:`DEFAULT_RING`. Query ids are minted
1 in N through :class:`QidSampler` (``config.obs_trace_sample``).

**Device time.** ``device.est_s`` — the profile's device share — is
measured around each executor step by ``obs/devclock.DeviceClock``. On a
CUDA device it records a pair of CUDA events on the step's stream and
hands them to the trace (:meth:`QueryTrace.add_device_events`), which
resolves them when it finishes, after the request's own
synchronisation: the main path waits for nothing more. It is then the
device time of the steps (a replayed CUDA graph counts as one step). On
the CPU it is the wall time around each step, as in the reference. All
host clocks are ``time.perf_counter``."""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
import uuid
from typing import Any, Dict, Iterator, List, Optional

from netsdb_tpu_torch.obs import metrics as _metrics
from netsdb_tpu_torch.utils.locks import TrackedLock

#: the process-wide kill switch (``config.obs_enabled`` mirrors into it
#: at daemon start); off, no trace is ever installed
_enabled = True


def set_enabled(on: bool) -> None:
    global _enabled
    _enabled = bool(on)


def enabled() -> bool:
    return _enabled


def new_query_id() -> str:
    """A fresh query id. Callers on a request path mint through
    :func:`sample_qid` or a :class:`QidSampler` instead, so that tracing
    is paid 1 in ``obs_trace_sample`` requests."""
    return uuid.uuid4().hex[:16]


class QidSampler:
    """Deterministic 1-in-N qid mint with its own round-robin phase (one
    per caller: a shared phase would lock two interleaved callers at
    1-in-2 and never)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._n = 0

    def sample(self, sample: int = 1) -> Optional[str]:
        """A fresh query id for 1 in every ``sample`` calls, None
        otherwise (``sample <= 1``: every call); always None with
        tracing disabled."""
        if not _enabled:
            return None
        if sample <= 1:
            return new_query_id()
        with self._mu:
            self._n += 1
            hit = self._n % int(sample) == 0
        if not hit:
            _metrics.REGISTRY.counter("obs.qid_sampled_out").inc()
            return None
        return new_query_id()


_default_sampler = QidSampler()


def sample_qid(sample: int = 1) -> Optional[str]:
    """:meth:`QidSampler.sample` of the process-default sampler."""
    return _default_sampler.sample(sample)


class Span:
    """One timed region of a trace; ``start_s`` is the offset from the
    trace's start."""

    __slots__ = ("name", "category", "start_s", "duration_s", "depth",
                 "counters")

    def __init__(self, name: str, category: str, start_s: float, depth: int):
        self.name = name
        self.category = category
        self.start_s = start_s
        self.duration_s = 0.0
        self.depth = depth
        self.counters: Dict[str, float] = {}

    def as_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"name": self.name, "category": self.category,
                             "start_s": self.start_s,
                             "duration_s": self.duration_s,
                             "depth": self.depth}
        if self.counters:
            d["counters"] = dict(self.counters)
        return d


class QueryTrace:
    """The spans, counters, annotations and sections of one query on one
    side of the wire (``origin``: "client", "server" or "local").
    Thread-safe for counter adds and span records; span depth is tracked
    per thread."""

    def __init__(self, qid: str, origin: str = "local",
                 ring: Optional["TraceRing"] = None):
        self.qid = qid
        self.origin = origin
        self._ring = ring
        self._t0 = time.perf_counter()
        self._mu = threading.Lock()
        self._spans: List[Span] = []
        self._counters: Dict[str, float] = {}
        self._meta: Dict[str, Any] = {}
        self._sections: Dict[str, Any] = {}
        self._depth = threading.local()
        # (counter, span or None, [(start event, end event), ...])
        self._device_events: List[tuple] = []
        self.total_s: Optional[float] = None
        #: the finished profile (also pushed to the ring)
        self.profile_dict: Optional[Dict[str, Any]] = None

    # --- spans --------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, category: str = "") -> Iterator[Span]:
        depth = getattr(self._depth, "v", 0)
        self._depth.v = depth + 1
        sp = Span(name, category, time.perf_counter() - self._t0, depth)
        try:
            yield sp
        finally:
            sp.duration_s = (time.perf_counter() - self._t0) - sp.start_s
            self._depth.v = depth
            with self._mu:
                self._spans.append(sp)

    def record(self, name: str, duration_s: float, category: str = "",
               start_s: Optional[float] = None, **counters) -> None:
        """Record an already-measured region (the frame decode that
        finished before the trace could open)."""
        if start_s is None:
            start_s = (time.perf_counter() - self._t0) - duration_s
        sp = Span(name, category, start_s, getattr(self._depth, "v", 0))
        sp.duration_s = duration_s
        if counters:
            sp.counters.update(counters)
        with self._mu:
            self._spans.append(sp)

    def backdate(self, seconds: float) -> None:
        """Move the trace's start ``seconds`` earlier, for work done
        before it opened: a region :meth:`record` ed at offset 0 then
        precedes the first live span and ``total_s`` covers it."""
        self._t0 -= float(seconds)

    # --- counters -----------------------------------------------------
    def add(self, counter: str, n: float = 1) -> None:
        with self._mu:
            self._counters[counter] = self._counters.get(counter, 0) + n

    def add_device_events(self, counter: str, pairs: List[tuple],
                          span: Optional[Span] = None) -> None:
        """Add the device time between each (start, end) CUDA event pair
        to ``counter`` (and to ``span`` 's ``device_est_s``) when the
        trace finishes — not now, so the caller waits for nothing."""
        if pairs:
            with self._mu:
                self._device_events.append((counter, span, list(pairs)))

    def _resolve_device_events(self) -> None:
        with self._mu:
            pending, self._device_events = self._device_events, []
        for counter, span, pairs in pending:
            try:
                secs = 0.0
                for start, end in pairs:
                    end.synchronize()
                    secs += start.elapsed_time(end) / 1e3
            except RuntimeError as e:
                self.annotate("device_time_error", f"{type(e).__name__}: {e}")
                continue
            self.add(counter, secs)
            if span is not None:
                span.counters["device_est_s"] = \
                    span.counters.get("device_est_s", 0.0) + secs

    def annotate(self, key: str, value: Any) -> None:
        """A non-numeric fact on the profile's ``meta`` section (the
        device-profile directory, the client identity)."""
        with self._mu:
            self._meta[str(key)] = value

    def attach_section(self, name: str, payload: Any) -> None:
        """A top-level profile section attached before the trace
        finishes (the executor's operator tree rides as ``operators``);
        :meth:`TraceRing.merge_section` handles those that arrive
        after."""
        with self._mu:
            self._sections[str(name)] = payload

    # --- lifecycle ----------------------------------------------------
    def finish(self) -> Dict[str, Any]:
        """Close the trace (``total_s`` is set once), resolve its device
        events and push its profile to the ring. Returns the profile."""
        if self.total_s is None:
            self.total_s = time.perf_counter() - self._t0
        self._resolve_device_events()
        prof = self.profile()
        self.profile_dict = prof
        if self._ring is not None:
            self._ring.push(prof)
        return prof

    def profile(self) -> Dict[str, Any]:
        """The MessagePack-safe profile GET_TRACE ships. ``host_device``
        splits ``total_s`` into the device share — ``device.est_s`` plus
        ``stage.wait_s`` (time the consumer blocked on a staged upload),
        clamped to the total — and the host remainder."""
        with self._mu:
            spans = [s.as_dict() for s in
                     sorted(self._spans, key=lambda s: s.start_s)]
            counters = dict(self._counters)
            meta = dict(self._meta)
            sections = dict(self._sections)
        out: Dict[str, Any] = {"qid": self.qid, "origin": self.origin,
                               "total_s": self.total_s, "spans": spans,
                               "counters": counters}
        out.update(sections)
        if meta:
            out["meta"] = meta
        if self.total_s is not None:
            dev = (counters.get("device.est_s", 0.0)
                   + counters.get("stage.wait_s", 0.0))
            dev = min(dev, self.total_s)
            out["host_device"] = {"device_est_s": dev,
                                  "host_s": max(self.total_s - dev, 0.0)}
        return out


class TraceRing:
    """Bounded ring of finished profiles — the GET_TRACE source;
    ``last(n)`` returns newest last."""

    def __init__(self, capacity: int = 64, pending_capacity: int = 32):
        self._mu = TrackedLock("TraceRing._mu")
        self._cap = max(int(capacity), 1)
        self._items: List[Dict[str, Any]] = []
        # sections that arrived before their profile was pushed (see
        # merge_section): qid -> {section: payload}, oldest evicted first
        self._pending_cap = max(int(pending_capacity), 1)
        self._pending: Dict[str, Dict[str, Any]] = {}

    def push(self, profile: Dict[str, Any]) -> None:
        with self._mu:
            qid = profile.get("qid")
            pend = self._pending.pop(qid, None) if qid else None
            if pend:
                profile = {**profile, **pend}
            self._items.append(profile)
            if len(self._items) > self._cap:
                del self._items[:len(self._items) - self._cap]

    def last(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        with self._mu:
            items = list(self._items)
        return items if n is None else items[-int(n):]

    def find(self, qid: str) -> List[Dict[str, Any]]:
        with self._mu:
            return [p for p in self._items if p.get("qid") == qid]

    def merge_section(self, qid: str, section: str, payload: Any) -> bool:
        """Attach ``payload`` under ``section`` on every ringed profile of
        ``qid`` — the PUT_TRACE merge; True when one matched.

        The daemon sends its reply inside the trace and pushes the
        profile when the trace closes, so a fast client's section can
        arrive first: an unmatched section waits in a bounded buffer
        (oldest evicted) and :meth:`push` folds it in. The merge
        replaces the ring slot with an extended copy: a reader holding
        the old dict (a GET_TRACE reply in flight) keeps a consistent
        profile."""
        with self._mu:
            hit = False
            for i, p in enumerate(self._items):
                if p.get("qid") == qid:
                    merged = dict(p)
                    merged[section] = payload
                    self._items[i] = merged
                    hit = True
            if not hit:
                self._pending.setdefault(qid, {})[section] = payload
                while len(self._pending) > self._pending_cap:
                    self._pending.pop(next(iter(self._pending)))
            return hit

    def clear(self) -> None:
        with self._mu:
            self._items.clear()

    def __len__(self) -> int:
        with self._mu:
            return len(self._items)


#: the ring of traces opened without one (client-side requests,
#: in-process queries); each daemon owns its own
DEFAULT_RING = TraceRing()

_current: "contextvars.ContextVar[Optional[QueryTrace]]" = \
    contextvars.ContextVar("netsdb_torch_obs_trace", default=None)


def current_trace() -> Optional[QueryTrace]:
    return _current.get()


@contextlib.contextmanager
def trace(qid: Optional[str] = None, origin: str = "local",
          ring: Optional[TraceRing] = None) -> Iterator[Optional[QueryTrace]]:
    """Install a :class:`QueryTrace` for the duration; finish it (and
    push it to ``ring``, default :data:`DEFAULT_RING`) on exit. Yields
    None and installs nothing when tracing is disabled or a trace is
    already active (a nested query joins the outer one)."""
    if not _enabled or _current.get() is not None:
        yield None
        return
    tr = QueryTrace(qid or new_query_id(), origin,
                    ring if ring is not None else DEFAULT_RING)
    token = _current.set(tr)
    try:
        yield tr
    finally:
        _current.reset(token)
        tr.finish()
        _metrics.REGISTRY.counter(f"obs.traces.{origin}").inc()


@contextlib.contextmanager
def span(name: str, category: str = "") -> Iterator[Optional[Span]]:
    """A span on the current trace, or nothing without one."""
    tr = _current.get()
    if tr is None:
        yield None
        return
    with tr.span(name, category) as sp:
        yield sp


def add(counter: str, n: float = 1) -> None:
    """Add to a counter of the current trace (nothing without one)."""
    tr = _current.get()
    if tr is not None:
        tr.add(counter, n)
