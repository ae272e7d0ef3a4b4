"""Observability — the parts of ``netsdb_tpu/obs/`` that the executor and
the fusion mapper read: the metrics registry (``obs/metrics.py``),
query-scoped spans and counters (``obs/trace.py``) and the per-operator
EXPLAIN tree with its cross-query ledger (``obs/operators.py``)::

    from netsdb_tpu_torch import obs

    with obs.span("executor.fold_stream", "executor") as sp: ...
    obs.add("device.est_s", dt)
    obs.REGISTRY.counter("fusion.fallbacks").inc()

Spans and trace counters do nothing unless a query trace is installed
(``obs.trace(...)``); registry counters, gauges and histograms are
always live. Stdlib only.
Exporters, SLOs, the slow-query log and history are ROADMAP.md A8."""

from netsdb_tpu_torch.obs import operators  # noqa: F401
from netsdb_tpu_torch.obs.metrics import (REGISTRY, Counter, Gauge,
                                          Histogram, MetricsRegistry)
from netsdb_tpu_torch.obs.trace import (QueryTrace, Span, add,
                                        current_trace, span, trace)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY", "QueryTrace", "Span",
           "add", "current_trace", "operators", "span", "trace"]
