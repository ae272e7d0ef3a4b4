"""The device time of an executor loop's steps — the ``device.est_s``
counter of the current query trace (``obs/trace.py``).

On a CUDA device each step is bracketed by two CUDA events on the
current stream, resolved by the trace when it finishes; on the CPU the
steps' wall time is added at once. Torch is imported only on the CUDA
path."""

from __future__ import annotations

import time
from typing import List, Optional

from netsdb_tpu_torch.obs.trace import Span, _current


class DeviceClock:
    """The device time of one executor loop's steps, for the current
    trace's ``device.est_s`` (``obs/trace.py``)::

        clock = DeviceClock(device)
        for chunk in chunks:
            mark = clock.start()
            state = step(state, chunk)
            clock.stop(mark)
        clock.commit(span)

    Without a trace every call returns at once. On a CUDA device each
    step is bracketed by two events on the current stream (none is
    recorded while that stream captures a graph); :meth:`commit` hands
    them to the trace, which resolves them when it finishes. On the CPU
    :meth:`commit` adds the summed wall time at once."""

    __slots__ = ("_tr", "_cuda", "_stream", "_wall", "_pairs")

    def __init__(self, device):
        self._tr = _current.get()
        self._cuda = (self._tr is not None
                      and getattr(device, "type", str(device)) == "cuda")
        self._stream = None
        self._wall = 0.0
        self._pairs: List[tuple] = []
        if self._cuda:
            import torch

            self._stream = torch.cuda.current_stream(device)

    def start(self):
        if self._tr is None:
            return None
        if not self._cuda:
            return time.perf_counter()
        import torch

        if torch.cuda.is_current_stream_capturing():
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self._stream)
        return ev

    def stop(self, mark) -> None:
        if mark is None:
            return
        if not self._cuda:
            self._wall += time.perf_counter() - mark
            return
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self._stream)
        self._pairs.append((mark, ev))

    def commit(self, span: Optional[Span] = None) -> None:
        """Report the steps' time to the trace (and ``span``)."""
        tr = self._tr
        if tr is None:
            return
        if self._cuda:
            tr.add_device_events("device.est_s", self._pairs, span)
            self._pairs = []
            return
        tr.add("device.est_s", self._wall)
        if span is not None:
            span.counters["device_est_s"] = self._wall
        self._wall = 0.0
