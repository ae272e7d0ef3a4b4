"""Query-scoped tracing — the part of ``netsdb_tpu/obs/trace.py`` that
the executor and the fusion mapper call: :func:`trace` installs a
:class:`QueryTrace` for one logical query, and the layers below read it
back with :func:`current_trace` (a ``contextvars.ContextVar``), open
:func:`span` s on it and :func:`add` counters to it. Without a trace
every call is one context-variable read. The ring of finished profiles,
query-id sampling and the served ``GET_TRACE`` belong to ROADMAP.md A8;
a finished trace's profile is kept on the trace object
(:attr:`QueryTrace.profile_dict`)."""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
import uuid
from typing import Any, Dict, Iterator, List, Optional


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
    """The spans, counters, annotations and sections of one query."""

    def __init__(self, qid: str, origin: str = "local"):
        self.qid = qid
        self.origin = origin
        self._t0 = time.perf_counter()
        self._mu = threading.Lock()
        self._spans: List[Span] = []
        self._counters: Dict[str, float] = {}
        self._meta: Dict[str, Any] = {}
        self._sections: Dict[str, Any] = {}
        self._depth = threading.local()
        self.total_s: Optional[float] = None
        self.profile_dict: Optional[Dict[str, Any]] = None

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

    def add(self, counter: str, n: float = 1) -> None:
        with self._mu:
            self._counters[counter] = self._counters.get(counter, 0) + n

    def annotate(self, key: str, value: Any) -> None:
        with self._mu:
            self._meta[str(key)] = value

    def attach_section(self, name: str, payload: Any) -> None:
        with self._mu:
            self._sections[str(name)] = payload

    def profile(self) -> Dict[str, Any]:
        with self._mu:
            spans = [s.as_dict() for s in
                     sorted(self._spans, key=lambda s: s.start_s)]
            out: Dict[str, Any] = {"qid": self.qid, "origin": self.origin,
                                   "total_s": self.total_s, "spans": spans,
                                   "counters": dict(self._counters)}
            out.update(self._sections)
            if self._meta:
                out["meta"] = dict(self._meta)
        return out

    def finish(self) -> Dict[str, Any]:
        if self.total_s is None:
            self.total_s = time.perf_counter() - self._t0
        self.profile_dict = self.profile()
        return self.profile_dict


_current: "contextvars.ContextVar[Optional[QueryTrace]]" = \
    contextvars.ContextVar("netsdb_torch_obs_trace", default=None)


def current_trace() -> Optional[QueryTrace]:
    return _current.get()


@contextlib.contextmanager
def trace(qid: Optional[str] = None,
          origin: str = "local") -> Iterator[Optional[QueryTrace]]:
    """Install a :class:`QueryTrace` for the duration and finish it on
    exit; a nested call joins the outer trace (yields None)."""
    if _current.get() is not None:
        yield None
        return
    tr = QueryTrace(qid or uuid.uuid4().hex[:16], origin)
    token = _current.set(tr)
    try:
        yield tr
    finally:
        _current.reset(token)
        tr.finish()


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
