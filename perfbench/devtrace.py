"""What the device did in a traced window, from ``torch.profiler``'s trace.

The harness profiles its measured window with CPU and CUDA activity on,
and names its own host steps with ``record_function`` spans
(``SPANS``). From the trace this module reads:

- ``busy_s``: the union of the intervals in which a device operation
  (a kernel, a copy or a fill) ran;
- ``device_ops``: device time summed by operation name, most first;
- ``op_totals``: for every operation name, its launches and seconds;
- ``idle_gaps``: the time between device operations, summed by the
  innermost host span or operator that covered the middle of each gap,
  so an idle share says what the host was doing meanwhile.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Tuple

#: the harness's own spans around its calls into the program
SPAN_REQUEST = "perfbench.execute_computations"
SPAN_SYNC = "perfbench.synchronize"
SPANS = (SPAN_REQUEST, SPAN_SYNC)

#: the profiler's own bookkeeping, no work of the program
_IGNORED = ("Activity Buffer",)
TOP = 10


def union(intervals: List[Tuple[float, float]]) -> List[List[float]]:
    """The sorted, merged union of ``(start, end)`` intervals."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _host_names(host: List[Tuple[float, float, str]],
                times: List[float]) -> List[str]:
    """For each of the sorted ``times``, the innermost host interval
    covering it (host intervals of one thread nest, so a stack of the
    open ones, swept in time order, has the innermost on top)."""
    ordered = sorted(host)
    names, stack, i = [], [], 0
    for t in times:
        while i < len(ordered) and ordered[i][0] <= t:
            while stack and stack[-1][1] < ordered[i][0]:
                stack.pop()
            stack.append(ordered[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        names.append(stack[-1][2] if stack else "host (no span)")
    return names


def summarize(device: List[Tuple[float, float, str]],
              host: List[Tuple[float, float, str]],
              window: Tuple[float, float]) -> Dict[str, object]:
    """``device`` and ``host`` are ``(start_s, end_s, name)`` intervals on
    one clock, ``window`` the traced window's ``(start_s, end_s)`` on it.
    Returns busy_s, window_s, the device operation count, the top
    ``device_ops`` and ``idle_gaps`` as ``[name, seconds]`` lists, and
    ``op_totals``: every operation name's ``[launches, seconds]``."""
    w0, w1 = window
    clipped = [(max(s, w0), min(e, w1), n) for s, e, n in device
               if e > w0 and s < w1 and not n.startswith(_IGNORED)]
    merged = union([(s, e) for s, e, _ in clipped])
    busy = sum(e - s for s, e in merged)
    by_op: Dict[str, float] = collections.defaultdict(float)
    launches: Dict[str, int] = collections.defaultdict(int)
    for s, e, n in clipped:
        by_op[n] += e - s
        launches[n] += 1
    gaps = []
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            gaps.append((s, e))
    by_host: Dict[str, float] = collections.defaultdict(float)
    for (s, e), name in zip(gaps, _host_names(
            host, [(s + e) / 2 for s, e in gaps])):
        by_host[name] += e - s
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy, "window_s": w1 - w0, "device_ops_count":
            len(clipped), "device_ops": [[n, t] for n, t in top],
            "idle_gaps": [[n, t] for n, t in idle],
            "op_totals": {n: [launches[n], t] for n, t in by_op.items()}}


def intervals(prof) -> Tuple[list, list]:
    """(device, host) intervals in seconds from a finished
    ``torch.profiler.profile``, on the trace's one clock."""
    from torch.autograd import DeviceType

    device, host = [], []
    for ev in prof.events():
        tr = ev.time_range
        item = (tr.start / 1e6, tr.end / 1e6, ev.name)
        if ev.device_type == DeviceType.CUDA:
            # a host span also shows on the device's timeline as an
            # annotation over its kernels: no operation of its own
            if not getattr(ev, "is_user_annotation", False) \
                    and ev.name not in SPANS:
                device.append(item)
        elif ev.device_type == DeviceType.CPU:
            host.append(item)
    return device, host


def span_range(host: list, name: str) -> Optional[Tuple[float, float]]:
    """The first start and last end of the host spans named ``name``."""
    spans = [(s, e) for s, e, n in host if n == name]
    if not spans:
        return None
    return min(s for s, _ in spans), max(e for _, e in spans)
