"""Clock discipline of the serve layer — the port's copy of the clock
helpers of ``netsdb_tpu/utils/timing.py`` (``:30-46``).

Deadlines and intervals use the monotonic clock: ``time.time()`` can
jump (an NTP step, a manual set). The one legitimate wall-clock read, a
human-readable timestamp in a job record, goes through :func:`wall_now`
so the intent is explicit at every call site. The reference's
device-timing loops (``device_seconds``, ``scan_slope_seconds``) belong
to ROADMAP.md A8/A9."""

from __future__ import annotations

import time


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
