"""Tracing, profiling and logging — the port's
``netsdb_tpu/utils/profiling.py``: a bounded named-span aggregator
(:class:`StageTimer`), device profiles through ``torch.profiler``
(:func:`profile_trace`, and :func:`qid_profile_session` for one traced
query), and a stdlib logger configured as the reference's PDBLogger.

A profile session records CPU and CUDA activity on a card and CPU
activity alone on the CPU, and writes one Chrome trace
(``trace.json``, viewable in ``chrome://tracing`` or Perfetto) into its
directory. ``torch.profiler`` runs one session a process at a time: the
serving daemon skips, never queues, a second traced query's profile."""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from typing import Dict, Iterator, Optional

from netsdb_tpu_torch.obs import metrics as _metrics


class StageTimer:
    """Named wall-clock spans with summary statistics. Each name keeps
    exact ``count``/``total_s``/``max_s`` and a fixed-size sample ring
    for percentiles (:class:`~netsdb_tpu_torch.obs.metrics.Histogram`),
    so a long-lived daemon's timer stays a few KB per name."""

    def __init__(self, max_samples: int = 512):
        self._mu = threading.Lock()
        self._max_samples = max_samples
        self._hists: Dict[str, _metrics.Histogram] = {}

    def _hist(self, name: str) -> _metrics.Histogram:
        with self._mu:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = _metrics.Histogram(
                    self._max_samples)
            return h

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._hist(name).observe(time.perf_counter() - t0)

    def sample_count(self, name: str) -> int:
        """Retained samples for ``name`` (at most ``max_samples``)."""
        return self._hist(name).sample_count

    def summary(self) -> Dict[str, Dict[str, float]]:
        """``count``/``total_s``/``mean_s``/``max_s`` (exact) and the
        bounded-sample percentiles, per name."""
        with self._mu:
            hists = dict(self._hists)
        out = {}
        for name, h in hists.items():
            s = h.summary()
            if not s["count"]:
                continue
            out[name] = {"count": s["count"], "total_s": s["total"],
                         "mean_s": s["mean"], "max_s": s["max"],
                         "p50_s": s["p50"], "p95_s": s["p95"],
                         "p99_s": s["p99"]}
        return out

    def reset(self) -> None:
        with self._mu:
            self._hists.clear()


#: the process-wide timer; its summary is the registry's ``stages``
#: section
GLOBAL_TIMER = StageTimer()
_metrics.REGISTRY.register_collector("stages", GLOBAL_TIMER.summary)


def _activities(device):
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if getattr(device, "type", str(device)).startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def profile_trace(log_dir: str, device="cuda") -> Iterator[str]:
    """Profile the enclosed work with ``torch.profiler`` (CPU and CUDA
    activity on a card, CPU alone for ``device="cpu"``) and write its
    Chrome trace to ``<log_dir>/trace.json``; yields that path."""
    from torch.profiler import profile

    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    with profile(activities=_activities(device)) as prof:
        yield path
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def qid_profile_session(qid: str, log_dir: str,
                        device="cuda") -> Iterator[str]:
    """One traced query's device profile: a ``torch.profiler`` session
    writing ``<log_dir>/<qid>/trace.json``, so its directory joins the
    query's GET_TRACE profile (``meta.device_profile``). The caller
    serializes sessions. Yields the session directory."""
    path = os.path.join(log_dir, str(qid))
    with profile_trace(path, device):
        yield path


def get_logger(name: str = "netsdb_tpu_torch", level: Optional[str] = None,
               log_file: Optional[str] = None) -> logging.Logger:
    """The PDBLogger equivalent: per component, optionally to a file."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = (logging.FileHandler(log_file) if log_file
                   else logging.StreamHandler())
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(handler)
    if level:
        logger.setLevel(level)
    return logger
