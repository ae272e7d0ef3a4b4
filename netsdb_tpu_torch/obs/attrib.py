"""Per-(client, set) resource attribution — the port's
``netsdb_tpu/obs/attrib.py``: who used what.

Identity rides the wire: a ``RemoteClient`` attaches its ``client_id`` to
every frame (``serve/protocol.CLIENT_ID_KEY``); the daemon pops it before
dispatch and installs it with :func:`client_context` for the handler's
dynamic extent. Instrumented layers call :func:`account` with a metric
and a set scope (``"db:set"``); the ledger aggregates ``(client, scope)
-> {metric: total}``.

Accounted: ``requests`` (per dispatched frame), ``staged_bytes`` /
``staged_chunks`` (the staging pipeline's uploads), ``devcache.hits`` /
``devcache.misses`` / ``devcache.installs`` / ``devcache.partial_hits``
and ``executor.chunks``. Frames without a client id book under
:data:`ANON`, so the sums stay complete. Staging threads do not inherit
the context variable: a stream captures :func:`current_client` on the
consumer's thread and passes it explicitly.

The ledger is the registry's ``attribution`` collector, so COLLECT_STATS
and GET_METRICS ship it; the scheduler's feedback loop reads it. It holds
at most :data:`MAX_KEYS` (client, scope) pairs; the rest folds into the
``overflow`` bucket and ticks ``attrib.overflow``."""

from __future__ import annotations

import contextlib
import contextvars
import threading
from typing import Any, Dict, Iterator, Optional

from netsdb_tpu_torch.obs import metrics as _metrics
from netsdb_tpu_torch.utils.locks import TrackedLock

#: identity for frames that carried no client id — attribution must
#: stay COMPLETE (sum over clients == global counters), so anonymous
#: traffic gets a bucket instead of being dropped
ANON = "anon"

#: bound on distinct (client, scope) pairs the ledger will hold
MAX_KEYS = 4096

_client_var: "contextvars.ContextVar[Optional[str]]" = \
    contextvars.ContextVar("netsdb_torch_obs_client", default=None)


def current_client() -> Optional[str]:
    """The client identity of the current dynamic extent (None outside
    a serve dispatch that carried one)."""
    return _client_var.get()


@contextlib.contextmanager
def client_context(client_id: Optional[str]) -> Iterator[None]:
    """Install ``client_id`` for the duration — the serve dispatch
    wraps each handler in this (None installs nothing: nested/mirrored
    execution keeps the outer identity)."""
    if client_id is None:
        yield
        return
    token = _client_var.set(str(client_id))
    try:
        yield
    finally:
        _client_var.reset(token)


class ResourceLedger:
    """(client, scope) → {metric: total}. Thread-safe, bounded,
    snapshot-table msgpack-safe."""

    def __init__(self, max_keys: int = MAX_KEYS):
        self._mu = TrackedLock("ResourceLedger._mu")
        self._max = int(max_keys)
        self._counts: Dict[Any, Dict[str, float]] = {}

    def add(self, metric: str, n: float = 1, scope: Optional[str] = None,
            client: Optional[str] = None) -> None:
        """One accounting tick. ``client=None`` reads the context var
        (worker threads pass the captured identity explicitly)."""
        if client is None:
            client = _client_var.get() or ANON
        key = (str(client), str(scope) if scope else "*")
        with self._mu:
            d = self._counts.get(key)
            if d is None:
                if len(self._counts) >= self._max:
                    key = ("overflow", "*")
                    d = self._counts.setdefault(key, {})
                    _metrics.REGISTRY.counter("attrib.overflow").inc()
                else:
                    d = self._counts[key] = {}
            d[metric] = d.get(metric, 0) + n

    def snapshot(self) -> Dict[str, Dict[str, Dict[str, float]]]:
        """{client: {scope: {metric: total}}} — the COLLECT_STATS
        ``attribution`` section."""
        with self._mu:
            out: Dict[str, Dict[str, Dict[str, float]]] = {}
            for (client, scope), metrics in self._counts.items():
                out.setdefault(client, {})[scope] = dict(metrics)
            return out

    def totals(self, client: str) -> Dict[str, float]:
        """One client's metrics summed across scopes (scheduler-quota
        convenience)."""
        with self._mu:
            out: Dict[str, float] = {}
            for (c, _scope), metrics in self._counts.items():
                if c != client:
                    continue
                for m, v in metrics.items():
                    out[m] = out.get(m, 0) + v
            return out

    def reset(self) -> None:
        with self._mu:
            self._counts.clear()


#: the process ledger every instrumented layer reports into; exported
#: as the registry's "attribution" section
LEDGER = ResourceLedger()
_metrics.REGISTRY.register_collector("attribution", LEDGER.snapshot)


def account(metric: str, n: float = 1, scope: Optional[str] = None,
            client: Optional[str] = None) -> None:
    """Tick the process ledger (module-level convenience — the form
    the staging/devcache/executor call sites use)."""
    LEDGER.add(metric, n, scope=scope, client=client)
