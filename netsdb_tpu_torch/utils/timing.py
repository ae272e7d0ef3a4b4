"""Clock discipline and device timing loops — the port's
``netsdb_tpu/utils/timing.py``.

Deadlines and intervals use the monotonic clock: ``time.time()`` can
jump (an NTP step, a manual set). The one legitimate wall-clock read, a
human-readable timestamp in a job record, goes through :func:`wall_now`
so the intent is explicit at every call site.

Steady-state device time is measured as the slope between a short and a
long loop of the same work (:func:`scan_slope_seconds`), so the fixed
cost of launching and synchronising cancels in the subtraction. On a
card each run is timed with CUDA events recorded on the current stream
around it (``run(n)`` enqueues ``n`` iterations; the end event is
waited for); on the CPU with ``time.perf_counter``."""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional


def wall_now() -> float:
    """Wall-clock seconds since the epoch — for display only (job-record
    timestamps); never compared against a deadline."""
    return time.time()


def deadline_after(seconds: float) -> float:
    """A deadline ``seconds`` from now on the monotonic clock."""
    return time.monotonic() + seconds


def seconds_left(deadline: float) -> float:
    """Seconds remaining until a :func:`deadline_after` deadline
    (negative once expired)."""
    return deadline - time.monotonic()


def _timer(device) -> Callable[[Callable[[], None]], float]:
    """``timed(fn)`` -> seconds ``fn`` took: CUDA events on a card, the
    host clock on the CPU."""
    if getattr(device, "type", str(device)).startswith("cuda"):
        import torch

        def timed(fn):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        return timed

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    return timed


def device_seconds(run: Callable[[int], None], lo: int = 4, hi: int = 20,
                   device="cuda", **kw) -> Optional[float]:
    """Seconds per iteration from :func:`scan_slope_seconds`, or None
    when the signal never clears the noise floor (callers then report a
    wall-time upper bound, never a clamped denominator)."""
    res = scan_slope_seconds(run, lo=lo, hi=hi, device=device, **kw)
    return res["seconds_per_iter"] if not res["below_noise"] else None


def scan_slope_seconds(run: Callable[[int], None], lo: int, hi: int,
                       repeats: int = 3, max_escalations: int = 4,
                       min_delta_seconds: float = 0.2,
                       device="cuda") -> Dict[str, object]:
    """Median seconds per iteration of ``run(n)``, an ``n``-iteration loop
    of the work.

    The slope is trusted only when the long loop takes measurably longer
    than the short one: while the median ``t(hi) - t(lo)`` is under
    ``min_delta_seconds`` (or not positive), ``hi`` grows 4x, at most
    ``max_escalations`` times. If it never clears, ``below_noise`` is
    True and ``seconds_per_iter`` None. ``device`` picks the clock
    (module docstring)."""
    timed = _timer(device)
    for attempt in range(max_escalations + 1):
        for n in (lo, hi):
            run(n)  # warm this pair of lengths
        deltas: List[float] = []
        for _ in range(repeats):
            t_lo = timed(lambda: run(lo))
            t_hi = timed(lambda: run(hi))
            deltas.append(t_hi - t_lo)
        med_delta = sorted(deltas)[len(deltas) // 2]
        if med_delta >= min_delta_seconds:
            return {"seconds_per_iter": med_delta / (hi - lo),
                    "slopes": [d / (hi - lo) for d in deltas],
                    "below_noise": False, "lo": lo, "hi": hi}
        hi *= 4
    return {"seconds_per_iter": None,
            "slopes": [d / (hi // 4 - lo) for d in deltas],
            "below_noise": True, "lo": lo, "hi": hi // 4}
