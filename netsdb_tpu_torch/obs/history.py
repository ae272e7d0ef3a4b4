"""Continuous telemetry — the port's ``netsdb_tpu/obs/history.py``: a
bounded ring of registry snapshots.

The registry answers "how much, ever"; a monitor needs "how fast,
lately". :class:`TelemetryHistory` snapshots the registry's numeric
surface every ``interval_s`` (a daemon thread on the monotonic clock,
started with the daemon's listener and joined at shutdown) into a ring
of at most ``capacity`` readings, and derives rates between two
readings: QPS, staged MB/s, chunk rates, the device-cache hit rate —
what the ``GET_METRICS`` frame ships.

One reading holds counters, gauges and per-histogram ``(count, total)``
pairs only, so the ring's size is ``capacity`` times the instrument
count whatever the traffic. ``interval_s <= 0`` starts no thread:
readings then come from :meth:`TelemetryHistory.observe` (each
GET_METRICS poll takes one)."""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, Optional, Tuple

from netsdb_tpu_torch.obs import metrics as _metrics
from netsdb_tpu_torch.utils.locks import TrackedLock

#: counter/histogram names with a human meaning as a rate — the
#: derived section `deltas()` computes (name → (feed, kind, scale)):
#: plain counters divide by dt; "ratio" derives delta(good)/delta(total)
_DERIVED = (
    ("qps", "serve.requests", "rate", 1.0),
    ("staged_mb_s", "staging.bytes", "rate", 1e-6),
    ("staged_chunks_s", "staging.chunks", "rate", 1.0),
    ("devcache_hit_rate", ("devcache.hits", "devcache.lookups"),
     "ratio", 1.0),
    ("availability", ("serve.requests_ok", "serve.requests"),
     "ratio", 1.0),
    ("devcache_installs_s", "devcache.installs", "rate", 1.0),
)


class TelemetryHistory:
    """Bounded snapshot ring + rate derivation over one registry."""

    def __init__(self, registry: Optional[_metrics.MetricsRegistry] = None,
                 capacity: int = 120, interval_s: float = 5.0,
                 clock=time.monotonic):
        self.registry = registry if registry is not None \
            else _metrics.REGISTRY
        self.capacity = max(int(capacity), 2)
        self.interval_s = float(interval_s)
        self._clock = clock
        self._mu = TrackedLock("TelemetryHistory._mu")
        self._ring: "deque[Tuple[float, Dict[str, Any]]]" = \
            deque(maxlen=self.capacity)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # --- readings -----------------------------------------------------
    def _reading(self) -> Dict[str, Any]:
        """One numeric-only registry snapshot
        (:meth:`MetricsRegistry.numeric_snapshot`) — deliberately no
        samples and no collector sections, so a reading's size is
        bounded by the instrument count, not by traffic."""
        return self.registry.numeric_snapshot()

    def observe(self) -> None:
        """Take one timestamped reading now (the thread's tick; tests
        call it directly to densify without waiting)."""
        reading = (self._clock(), self._reading())
        with self._mu:
            self._ring.append(reading)

    # --- lifecycle ----------------------------------------------------
    def start(self) -> None:
        """Start the snapshot thread (idempotent; ``interval_s <= 0``
        disables — readings then come only from explicit
        :meth:`observe` calls, e.g. per GET_METRICS poll)."""
        if self._thread is not None or self.interval_s <= 0:
            return
        self.observe()  # the t0 baseline every delta anchors on
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="netsdb-torch-obs-history")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.observe()

    def stop(self, timeout_s: float = 10.0) -> None:
        """Stop + JOIN the snapshot thread (idempotent) — the daemon
        shutdown hook; after this no history thread is alive."""
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=timeout_s)

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    # --- rates --------------------------------------------------------
    def _bracket(self, window_s: Optional[float]
                 ) -> Optional[Tuple[Tuple[float, Dict[str, Any]],
                                     Tuple[float, Dict[str, Any]]]]:
        """(oldest-in-window, newest) readings; None without ≥2."""
        with self._mu:
            if len(self._ring) < 2:
                return None
            newest = self._ring[-1]
            if window_s is None:
                return self._ring[0], newest
            base = None
            for t, snap in self._ring:
                if newest[0] - t <= window_s:
                    base = (t, snap)
                    break
            if base is None or newest[0] - base[0] <= 0:
                return None
            return base, newest

    def deltas(self, window_s: Optional[float] = None) -> Dict[str, Any]:
        """Rates between the newest reading and the oldest one inside
        ``window_s`` (or the whole ring): per-counter ``<name>``/s for
        every counter that moved, plus the named derived signals
        (``qps``, ``staged_mb_s``, hit-rate trend, ...). Empty dict
        until two readings exist."""
        br = self._bracket(window_s)
        if br is None:
            return {}
        (t0, old), (t1, new) = br
        dt = t1 - t0
        if dt <= 0:
            return {}
        rates: Dict[str, float] = {}
        for name, v in new["counters"].items():
            dv = v - old["counters"].get(name, 0)
            if dv:
                rates[name] = dv / dt
        out: Dict[str, Any] = {"dt_s": dt, "rates": rates}
        derived: Dict[str, Optional[float]] = {}
        for label, feed, kind, scale in _DERIVED:
            if kind == "rate":
                dv = (new["counters"].get(feed, 0)
                      - old["counters"].get(feed, 0))
                derived[label] = (dv / dt) * scale
            else:  # ratio of two counter deltas over the window
                good, total = feed
                dg = (new["counters"].get(good, 0)
                      - old["counters"].get(good, 0))
                dt_ = (new["counters"].get(total, 0)
                       - old["counters"].get(total, 0))
                derived[label] = (dg / dt_) if dt_ > 0 else None
        out["derived"] = derived
        return out

    def summary(self) -> Dict[str, Any]:
        with self._mu:
            n = len(self._ring)
            span = (self._ring[-1][0] - self._ring[0][0]) if n >= 2 \
                else 0.0
        return {"readings": n, "capacity": self.capacity,
                "interval_s": self.interval_s, "span_s": span,
                "running": self.running}
