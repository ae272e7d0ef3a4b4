"""Process-wide metrics registry — the port's ``netsdb_tpu/obs/
metrics.py`` (``:62-262``): one :class:`MetricsRegistry` of typed
instruments that every layer reports into —

* :class:`Counter` — monotonic totals (cache hits, retries, chunks);
* :class:`Gauge` — last-set values (resident bytes, queue depth);
* :class:`Histogram` — bounded-sample distributions with exact
  ``count``/``total``/``min``/``max`` and nearest-rank p50/p95/p99 over
  a ring of the last ``max_samples`` observations;
* **collectors** — callables whose dict :meth:`MetricsRegistry.snapshot`
  merges under their name (the executor's ``compile`` section, the
  decode runtime's ``decode`` section, the scheduler's ``sched``).

Standard library only: one lock-guarded add per tick, and a snapshot of
plain ints, floats, strings and dicts, so the serve layer's
COLLECT_STATS frame ships it as it is. The telemetry history
(``obs/history.py``) rings :meth:`MetricsRegistry.numeric_snapshot`; the
OpenMetrics export (``obs/export.py``) renders :meth:`snapshot`."""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

#: default per-histogram sample bound (config.obs_hist_samples
#: overrides at construction sites that have a Configuration)
DEFAULT_HIST_SAMPLES = 512


class Counter:
    """Monotonic counter. ``inc`` is the only mutator."""

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


class Gauge:
    """Last-written value (float)."""

    __slots__ = ("_mu", "_v")

    def __init__(self):
        self._mu = threading.Lock()
        self._v = 0.0

    def set(self, v: float) -> None:
        with self._mu:
            self._v = float(v)

    def add(self, dv: float) -> None:
        with self._mu:
            self._v += float(dv)

    @property
    def value(self) -> float:
        with self._mu:
            return self._v


class Histogram:
    """Bounded-memory distribution: exact ``count``/``total``/``min``/
    ``max`` forever, quantiles from the last ``max_samples``
    observations (a ring, so the distribution tracks RECENT behavior —
    what a hedge trigger or an SLO readout wants — while a year-long
    daemon holds a fixed few KB per histogram)."""

    __slots__ = ("_mu", "_ring", "_cap", "_idx", "count", "total",
                 "_min", "_max")

    def __init__(self, max_samples: int = DEFAULT_HIST_SAMPLES):
        self._mu = threading.Lock()
        self._cap = max(int(max_samples), 8)
        self._ring: List[float] = []
        self._idx = 0
        self.count = 0
        self.total = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        with self._mu:
            self.count += 1
            self.total += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v
            if len(self._ring) < self._cap:
                self._ring.append(v)
            else:
                self._ring[self._idx] = v
                self._idx = (self._idx + 1) % self._cap

    def quantile(self, q: float) -> Optional[float]:
        """Approximate q-quantile over the retained samples (None when
        empty). Nearest-rank over a sorted copy — the ring is small by
        construction."""
        with self._mu:
            if not self._ring:
                return None
            s = sorted(self._ring)
        return s[min(int(q * (len(s) - 1) + 0.5), len(s) - 1)]

    @property
    def sample_count(self) -> int:
        with self._mu:
            return len(self._ring)

    def summary(self) -> Dict[str, Any]:
        with self._mu:
            n = self.count
            ring = sorted(self._ring)
            total, mn, mx = self.total, self._min, self._max

        def rank(q: float) -> Optional[float]:
            if not ring:
                return None
            return ring[min(int(q * (len(ring) - 1) + 0.5),
                            len(ring) - 1)]

        return {"count": n, "total": total,
                "mean": (total / n) if n else None,
                "min": mn, "max": mx,
                "p50": rank(0.50), "p95": rank(0.95), "p99": rank(0.99),
                "samples": len(ring)}


class MetricsRegistry:
    """Name → instrument map with get-or-create semantics, plus lazy
    collector sections. One per process (:data:`REGISTRY`); tests may
    build private ones."""

    def __init__(self, hist_samples: int = DEFAULT_HIST_SAMPLES):
        self._mu = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}
        self._collectors: Dict[str, Callable[[], Any]] = {}
        self._hist_samples = hist_samples

    # --- instruments --------------------------------------------------
    def counter(self, name: str) -> Counter:
        with self._mu:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def gauge(self, name: str) -> Gauge:
        with self._mu:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            return g

    def histogram(self, name: str,
                  max_samples: Optional[int] = None) -> Histogram:
        with self._mu:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(
                    max_samples or self._hist_samples)
            return h

    # --- absorption of pre-existing stats surfaces --------------------
    def register_collector(self, name: str,
                           fn: Callable[[], Any]) -> None:
        """Merge ``fn()``'s dict under ``name`` at every
        :meth:`snapshot`; registering a name again replaces its
        collector."""
        with self._mu:
            self._collectors[name] = fn

    def unregister_collector(self, name: str, fn: Callable = None
                             ) -> None:
        """Drop a collector section. With ``fn`` given, only when the
        registered collector equals it (``==``: bound methods compare
        by instance + function, and each attribute access builds a
        fresh bound-method object) — an object tearing itself down
        (``ServeController.shutdown``) must not remove a successor that
        already replaced it."""
        with self._mu:
            if fn is None or self._collectors.get(name) == fn:
                self._collectors.pop(name, None)

    # --- readout ------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Msgpack-safe point-in-time readout: counters, gauges,
        histogram summaries, then each collector's section. A collector
        that raises contributes an ``{"error": ...}`` section instead
        of killing the stats frame."""
        with self._mu:
            counters = {k: v.value for k, v in self._counters.items()}
            gauges = {k: v.value for k, v in self._gauges.items()}
            hists = {k: v.summary() for k, v in self._hists.items()}
            collectors = list(self._collectors.items())
        out: Dict[str, Any] = {"counters": counters, "gauges": gauges,
                               "histograms": hists}
        for name, fn in collectors:
            try:
                out[name] = fn()
            except Exception as e:  # noqa: BLE001 — typed into the payload
                out[name] = {"error": f"{type(e).__name__}: {e}"}
        return out

    def numeric_snapshot(self) -> Dict[str, Any]:
        """Bounded NUMERIC-ONLY readout: counters, gauges, and
        per-histogram ``(count, total)`` pairs — no quantile samples,
        no collector sections. This is the reading the telemetry
        history rings (``obs/history.py``): its size is bounded by the
        instrument count alone, never by traffic."""
        with self._mu:
            counters = list(self._counters.items())
            gauges = list(self._gauges.items())
            hists = list(self._hists.items())
        return {"counters": {k: v.value for k, v in counters},
                "gauges": {k: v.value for k, v in gauges},
                "hists": {k: (h.count, h.total) for k, h in hists}}

    def reset(self) -> None:
        """Drop every instrument and collector (tests)."""
        with self._mu:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._collectors.clear()


#: the process-wide registry every subsystem reports into
REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return REGISTRY
