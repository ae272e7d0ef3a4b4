"""Process-wide metrics registry — the part of
``netsdb_tpu/obs/metrics.py`` that the executor and the fusion mapper
report into: monotonic :class:`Counter` s by name, and **collectors**,
callables whose dict :meth:`MetricsRegistry.snapshot` merges under their
name (the executor's ``compile`` section is one). Gauges, histograms and
the numeric history readout belong to ROADMAP.md A8.

Stdlib only: one lock-guarded integer add per tick."""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict


class Counter:
    """Monotonic counter; ``inc`` is the only mutator."""

    __slots__ = ("_mu", "_v")

    def __init__(self):
        self._mu = threading.Lock()
        self._v = 0

    def inc(self, n: int = 1) -> None:
        with self._mu:
            self._v += n

    @property
    def value(self) -> int:
        with self._mu:
            return self._v


class MetricsRegistry:
    """Name → counter map (get-or-create), plus collector sections."""

    def __init__(self):
        self._mu = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._collectors: Dict[str, Callable[[], Any]] = {}

    def counter(self, name: str) -> Counter:
        with self._mu:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def register_collector(self, name: str, fn: Callable[[], Any]) -> None:
        """Merge ``fn()`` under ``name`` at every :meth:`snapshot`;
        registering a name again replaces its collector."""
        with self._mu:
            self._collectors[name] = fn

    def snapshot(self) -> Dict[str, Any]:
        """``{"counters": {...}, <collector>: <its dict>, ...}``; a
        collector that raises gives ``{"error": ...}`` instead."""
        with self._mu:
            counters = {k: v.value for k, v in self._counters.items()}
            collectors = list(self._collectors.items())
        out: Dict[str, Any] = {"counters": counters}
        for name, fn in collectors:
            try:
                out[name] = fn()
            except Exception as e:  # noqa: BLE001 — typed into the payload
                out[name] = {"error": f"{type(e).__name__}: {e}"}
        return out


#: the process-wide registry every layer reports into
REGISTRY = MetricsRegistry()
