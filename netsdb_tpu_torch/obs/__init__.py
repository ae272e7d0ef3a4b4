"""Observability — the port's ``netsdb_tpu/obs/``: the metrics registry
(``obs/metrics.py``), query-scoped traces and their ring
(``obs/trace.py``), the per-operator EXPLAIN tree and its ledger
(``obs/operators.py``), the per-(client, set) attribution ledger
(``obs/attrib.py``), and, read by the serving daemon, the SLO engine
(``obs/slo.py``), the slow-query log (``obs/slowlog.py``), the telemetry
history (``obs/history.py``) and the OpenMetrics export
(``obs/export.py``)::

    from netsdb_tpu_torch import obs

    with obs.span("executor.fold_stream", "executor") as sp: ...
    obs.add("devcache.hits")
    obs.REGISTRY.counter("serve.client.retries").inc()

Spans and trace counters do nothing unless a query trace is installed
(``obs.trace(...)`` — the serve dispatch and the wire client do this);
registry instruments are always live. Standard library only
(``obs/devclock.py`` imports torch when it times a CUDA step)."""

from netsdb_tpu_torch.obs import attrib  # noqa: F401 — registers "attribution"
from netsdb_tpu_torch.obs import operators  # noqa: F401 — registers "operators"
from netsdb_tpu_torch.obs.devclock import DeviceClock  # noqa: F401
from netsdb_tpu_torch.obs.metrics import (  # noqa: F401
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    registry,
)
from netsdb_tpu_torch.obs.trace import (  # noqa: F401
    DEFAULT_RING,
    QidSampler,
    QueryTrace,
    Span,
    TraceRing,
    add,
    current_trace,
    enabled,
    new_query_id,
    sample_qid,
    set_enabled,
    span,
    trace,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "registry", "DEFAULT_RING", "QidSampler", "QueryTrace", "Span",
    "TraceRing", "add", "attrib", "current_trace", "enabled",
    "new_query_id", "operators", "sample_qid", "set_enabled", "span",
    "trace", "DeviceClock",
]
