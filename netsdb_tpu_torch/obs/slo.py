"""SLO and health engine — the port's ``netsdb_tpu/obs/slo.py``:
declarative objectives over the metrics registry, judged with
multi-window burn rates (a short window catches a fast burn, a long one
a slow leak; both must agree before a breach is real).

The registry holds cumulative counters and objectives need rates, so
the engine keeps a bounded ring of timestamped readings (the few raw
values the objectives reference) and computes each window's value from
the newest reading and the oldest one inside the window. Until a window
has history it falls back to the all-time value.

Objective kinds:

* ``ratio_min`` — good/total >= target (availability, device-cache hit
  rate). Burn rate = (1 - ratio) / (1 - target).
* ``quantile_max`` — a histogram's q-quantile <= target (p99 request
  latency), from the histogram's bounded sample ring; burn = value /
  target.
* ``rate_max`` — a histogram's total-seconds delta per wall second <=
  target (the staging wait fraction); burn = value / target.

Clocks are monotonic. Breaches and recoveries are events in a bounded
ring, emitted on transitions only, and tick ``slo.breaches`` /
``slo.recoveries``; the daemon's HEALTH frame ships
:meth:`SLOEngine.evaluate` with the events, and the scheduler's load
shedding reads :meth:`SLOEngine.breached_objectives`."""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from netsdb_tpu_torch.obs import metrics as _metrics
from netsdb_tpu_torch.utils.locks import TrackedLock

#: default evaluation windows (seconds): fast-burn, slow-burn
DEFAULT_WINDOWS: Tuple[float, ...] = (60.0, 600.0)


@dataclasses.dataclass(frozen=True)
class Objective:
    """One declarative objective. ``good``/``total``/``hist`` name
    registry instruments; which are read depends on ``kind`` (module
    docstring). ``quantile`` applies to ``quantile_max`` only."""

    name: str
    kind: str  # "ratio_min" | "quantile_max" | "rate_max"
    target: float
    description: str = ""
    good: Optional[str] = None   # counter name (ratio_min numerator)
    total: Optional[str] = None  # counter name (ratio_min denominator)
    hist: Optional[str] = None   # histogram name (quantile_max/rate_max)
    quantile: float = 0.99

    def __post_init__(self):
        if self.kind not in ("ratio_min", "quantile_max", "rate_max"):
            raise ValueError(f"unknown objective kind {self.kind!r}")
        if self.kind == "ratio_min" and not (self.good and self.total):
            raise ValueError(f"{self.name}: ratio_min needs good+total")
        if self.kind in ("quantile_max", "rate_max") and not self.hist:
            raise ValueError(f"{self.name}: {self.kind} needs hist")


def default_objectives() -> List[Objective]:
    """The shipped objective set. The serve, staging and device-cache
    layers maintain every counter and histogram it reads."""
    return [
        Objective(
            name="availability", kind="ratio_min", target=0.999,
            good="serve.requests_ok", total="serve.requests",
            description="fraction of dispatched frames answered "
                        "without an ERR"),
        Objective(
            name="request_p99_s", kind="quantile_max", target=2.0,
            hist="serve.request_s", quantile=0.99,
            description="p99 server-side frame dispatch latency "
                        "(time-to-first-frame for streams)"),
        Objective(
            name="devcache_hit_rate", kind="ratio_min", target=0.5,
            good="devcache.hits", total="devcache.lookups",
            description="device block cache hit rate (warm serving)"),
        Objective(
            name="staging_wait_fraction", kind="rate_max", target=0.25,
            hist="staging.wait_s",
            description="fraction of wall time consumers spent blocked "
                        "on staged host->device uploads"),
    ]


class SLOEngine:
    """Evaluates objectives over one registry with windowed burn
    rates. One per daemon (the ServeController owns it); tests build
    private ones over private registries.

    ``evaluate()`` is cheap (a registry read + a few arithmetic ops)
    and takes a reading as a side effect, so a daemon polled by
    HEALTH frames accumulates exactly the history it needs — no
    background thread."""

    def __init__(self, registry: Optional[_metrics.MetricsRegistry] = None,
                 objectives: Optional[List[Objective]] = None,
                 windows: Tuple[float, ...] = DEFAULT_WINDOWS,
                 max_readings: int = 256, max_events: int = 128,
                 clock: Callable[[], float] = time.monotonic):
        self.registry = registry if registry is not None \
            else _metrics.REGISTRY
        self.objectives = list(objectives if objectives is not None
                               else default_objectives())
        self.windows = tuple(sorted(windows))
        self._clock = clock
        self._mu = TrackedLock("SLOEngine._mu")
        # (t, {counter_name: value, "ht:"+hist: total_seconds})
        self._readings: "deque[Tuple[float, Dict[str, float]]]" = \
            deque(maxlen=max(int(max_readings), 2))
        self._events: "deque[Dict[str, Any]]" = \
            deque(maxlen=max(int(max_events), 1))
        self._breached: Dict[str, bool] = {}
        self._take_reading()  # the t0 baseline every window deltas from

    # --- readings -----------------------------------------------------
    def _counter_names(self) -> List[str]:
        names = []
        for o in self.objectives:
            if o.kind == "ratio_min":
                names.extend((o.good, o.total))
        return names

    def _take_reading(self) -> Tuple[float, Dict[str, float]]:
        vals: Dict[str, float] = {}
        for name in self._counter_names():
            vals[name] = float(self.registry.counter(name).value)
        for o in self.objectives:
            if o.kind == "rate_max":
                vals[f"ht:{o.hist}"] = float(
                    self.registry.histogram(o.hist).total)
        reading = (self._clock(), vals)
        with self._mu:
            self._readings.append(reading)
        return reading

    def observe(self) -> None:
        """Take one timestamped reading (HEALTH polls call evaluate,
        which does this implicitly; call directly to densify)."""
        self._take_reading()

    # --- evaluation ---------------------------------------------------
    def _window_delta(self, now: float, window: float, key: str,
                      newest: Dict[str, float]
                      ) -> Optional[Tuple[float, float]]:
        """(delta_value, delta_seconds) between the newest reading and
        the OLDEST reading inside ``window``; None when no prior
        reading exists (caller falls back to all-time)."""
        with self._mu:
            base = None
            for t, vals in self._readings:
                if now - t <= window:
                    base = (t, vals)
                    break
            if base is None or now - base[0] <= 0:
                return None
        dv = newest.get(key, 0.0) - base[1].get(key, 0.0)
        return dv, now - base[0]

    def _eval_ratio(self, o: Objective, now: float,
                    newest: Dict[str, float]) -> Dict[str, Any]:
        """``value`` is the WORST window's ratio (what an operator
        wants to see first); ``breached`` requires EVERY window with
        data to sit below target — the multi-window agreement rule
        (module docstring): the short window alone flaps on bursts,
        the long window alone lags a real outage."""
        windows: Dict[str, Dict[str, Any]] = {}
        worst_burn = 0.0
        value = None
        agree: List[bool] = []
        for w in self.windows:
            dg = self._window_delta(now, w, o.good, newest)
            dt_ = self._window_delta(now, w, o.total, newest)
            if dg is None or dt_ is None or dt_[0] <= 0:
                # no traffic in the window (or no history): all-time
                tot = newest.get(o.total, 0.0)
                ratio = (newest.get(o.good, 0.0) / tot) if tot else None
                scope = "all-time"
            else:
                ratio = dg[0] / dt_[0]
                scope = "window"
            burn = None
            if ratio is not None:
                budget = max(1.0 - o.target, 1e-9)
                burn = max(0.0, (1.0 - ratio)) / budget
                worst_burn = max(worst_burn, burn)
                value = ratio if value is None else min(value, ratio)
                agree.append(ratio < o.target)
            windows[f"{int(w)}s"] = {"value": ratio, "burn_rate": burn,
                                     "scope": scope}
        breached = bool(agree) and all(agree)
        return {"value": value, "windows": windows,
                "worst_burn_rate": worst_burn if value is not None
                else None, "breached": breached}

    def _eval_quantile(self, o: Objective) -> Dict[str, Any]:
        h = self.registry.histogram(o.hist)
        q = h.quantile(o.quantile)
        burn = (q / o.target) if q is not None and o.target > 0 else None
        win = {"samples": {"value": q, "burn_rate": burn,
                           "scope": f"last-{h.sample_count}-samples"}}
        return {"value": q, "windows": win, "worst_burn_rate": burn,
                "breached": q is not None and q > o.target}

    def _eval_rate(self, o: Objective, now: float,
                   newest: Dict[str, float]) -> Dict[str, Any]:
        """Same agreement rule as :meth:`_eval_ratio`: ``value`` is
        the worst window's rate, ``breached`` only when every window
        with history exceeds target."""
        key = f"ht:{o.hist}"
        windows: Dict[str, Dict[str, Any]] = {}
        worst = None
        agree: List[bool] = []
        for w in self.windows:
            d = self._window_delta(now, w, key, newest)
            if d is None:
                windows[f"{int(w)}s"] = {"value": None, "burn_rate": None,
                                         "scope": "no-history"}
                continue
            rate = max(d[0], 0.0) / d[1]
            burn = (rate / o.target) if o.target > 0 else None
            worst = rate if worst is None else max(worst, rate)
            agree.append(rate > o.target)
            windows[f"{int(w)}s"] = {"value": rate, "burn_rate": burn,
                                     "scope": "window"}
        return {"value": worst, "windows": windows,
                "worst_burn_rate": (worst / o.target)
                if worst is not None and o.target > 0 else None,
                "breached": bool(agree) and all(agree)}

    def evaluate(self) -> List[Dict[str, Any]]:
        """Evaluate every objective (taking a fresh reading first).
        Msgpack-safe list, one dict per objective; breach TRANSITIONS
        emit structured events and tick registry counters."""
        now, newest = self._take_reading()
        out = []
        for o in self.objectives:
            if o.kind == "ratio_min":
                res = self._eval_ratio(o, now, newest)
            elif o.kind == "quantile_max":
                res = self._eval_quantile(o)
            else:
                res = self._eval_rate(o, now, newest)
            res.update(name=o.name, kind=o.kind, target=o.target,
                       description=o.description)
            self._transition(o, res)
            out.append(res)
        return out

    def breached_objectives(self, evaluate: bool = True) -> List[str]:
        """Names of objectives currently breached on ALL their windows
        (the multi-window agreement rule). ``evaluate=True`` takes a
        fresh evaluation first — the scheduler's load-shedding probe
        (serve/sched/feedback.py) must not depend on HEALTH polling
        cadence; ``False`` reads the last evaluation's state."""
        if evaluate:
            return [r["name"] for r in self.evaluate()
                    if r.get("breached")]
        with self._mu:
            return sorted(n for n, b in self._breached.items() if b)

    # --- events -------------------------------------------------------
    def _transition(self, o: Objective, res: Dict[str, Any]) -> None:
        breached = bool(res.get("breached"))
        with self._mu:
            was = self._breached.get(o.name, False)
            self._breached[o.name] = breached
            if breached == was:
                return
            from netsdb_tpu_torch.utils.timing import wall_now

            self._events.append({
                "at": wall_now(),  # display timestamp (sanctioned)
                "objective": o.name,
                "event": "breach" if breached else "recovery",
                "value": res.get("value"),
                "target": o.target,
                "worst_burn_rate": res.get("worst_burn_rate")})
        self.registry.counter(
            "slo.breaches" if breached else "slo.recoveries").inc()

    def events(self, last: Optional[int] = None) -> List[Dict[str, Any]]:
        with self._mu:
            evs = list(self._events)
        return evs if last is None else evs[-int(last):]
