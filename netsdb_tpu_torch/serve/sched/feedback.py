"""Scheduler feedback loop: seed lane weights/quotas from observed
behavior instead of the static ``sched_lanes`` table.

The scheduler admits per-client lanes under operator-configured
weights; the observability layer already measures exactly what
those weights should encode — per-(client, set) resource volumes in
the attribution ledger (``obs/attrib.py``) and per-operator cost rows
in the OperatorLedger (``obs/operators.py``). This module closes the
loop (the ROADMAP carry-over): a deterministic, **pinned** formula
turning those ledgers into lane weights, re-applied every
``sched_feedback_every`` admissions when ``config.sched_feedback`` is
on.

The formula (every constant is part of the test contract):

1. ``sec_per_chunk`` — the OperatorLedger's global mean wall-seconds
   per executed chunk (its cost rows supply the *conversion* from
   attributed volumes to seconds; ``DEFAULT_SEC_PER_CHUNK`` when the
   ledger is cold).
2. For every client with at least ``MIN_REQUESTS`` attributed
   requests: ``rate = (chunks × sec_per_chunk) / requests`` — the
   client's historical cost per request.
3. ``weight = clamp(median_rate / rate, 0.25, 4.0)`` — lanes whose
   requests are LIGHTER than the median earn proportionally more
   weight (up to 4×), heavy lanes proportionally less (down to ¼×).
   A zero-cost lane takes the upper clamp. Lanes the operator listed
   in ``sched_lanes`` are never reseeded — explicit configuration
   outranks inference.
4. With a global ``sched_lane_quota`` configured, per-lane quotas
   scale the same way: ``quota = max(1, round(global × weight))`` —
   light lanes may queue deeper, heavy lanes saturate sooner.

Weights only reshape the WFQ share; aging still bounds starvation
deterministically, so a mis-seeded lane degrades to slower admission,
never to none.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

#: minimum attributed requests before a client's rate is trusted
MIN_REQUESTS = 8
#: weight clamp — inference may shift shares 16× end to end, no more
CLAMP = (0.25, 4.0)
#: seconds per executor chunk when the OperatorLedger is cold
DEFAULT_SEC_PER_CHUNK = 1e-3
#: SLO load shedding (``config.sched_slo_shed``): when an objective
#: breaches on ALL its windows, the heaviest non-reserved lane's quota
#: is multiplied by SHED_FACTOR (floored at SHED_MIN_QUOTA) until the
#: first breach-free check restores it. Both constants are part of the
#: pinned test contract, like the weight formula above.
SHED_FACTOR = 0.5
SHED_MIN_QUOTA = 1
#: pin-budget auto-sizing (``config.device_cache_pin_auto``): the
#: hottest scope's attributed staged bytes become the hot-prefix pin
#: budget ONLY when that scope carries at least PIN_HOT_SHARE of all
#: attributed staged bytes, and never more than PIN_FRACTION of the
#: device-cache budget. Both constants are pinned test contract.
PIN_HOT_SHARE = 0.25
PIN_FRACTION = 0.5


def pin_budget(attrib_snapshot: Dict[str, Dict[str, Dict[str, float]]],
               cache_budget: int) -> int:
    """The auto-derived ``device_cache_pin_bytes`` (pinned formula).

    The attribution ledger's hot-set table — per-scope staged bytes
    summed over every client (``anon`` included, the ``overflow``
    fold-in bucket and the scope-free ``*`` row skipped) — names the
    HOTTEST scope. Its observed staged bytes (a ceiling on the bytes
    worth pinning: re-stages only inflate it, and the cap bounds the
    damage) become the pin budget when the scope carries at least
    ``PIN_HOT_SHARE`` of all attributed staged bytes; otherwise 0 —
    no set is hot enough to deserve eviction immunity."""
    by_scope: Dict[str, float] = {}
    for client, scopes in (attrib_snapshot or {}).items():
        if client == "overflow":
            continue
        for scope, metrics in scopes.items():
            if scope == "*":
                continue
            by_scope[scope] = by_scope.get(scope, 0.0) + float(
                metrics.get("staged_bytes") or 0.0)
    total = sum(by_scope.values())
    if total <= 0:
        return 0
    hot_bytes = max(by_scope.values())
    if hot_bytes / total < PIN_HOT_SHARE:
        return 0
    return int(min(hot_bytes, PIN_FRACTION * max(int(cache_budget), 0)))


def sec_per_chunk(op_snapshot: Dict[str, Dict[str, Dict[str, float]]]
                  ) -> float:
    """Global mean wall-seconds per chunk over every OperatorLedger
    row (the volume→seconds conversion)."""
    wall = chunks = 0.0
    for labels in (op_snapshot or {}).values():
        for row in labels.values():
            wall += float(row.get("wall_s") or 0.0)
            chunks += float(row.get("chunks") or 0.0)
    if chunks <= 0 or wall <= 0:
        return DEFAULT_SEC_PER_CHUNK
    return wall / chunks


def seed_lanes(attrib_snapshot: Dict[str, Dict[str, Dict[str, float]]],
               op_snapshot: Dict[str, Dict[str, Dict[str, float]]],
               base_quota: int = 0,
               reserved: Optional[set] = None,
               ) -> Tuple[Dict[str, float], Dict[str, int]]:
    """(weights, quotas) per the documented formula. ``reserved``
    lanes (statically configured) are skipped. Empty dicts when no
    client clears MIN_REQUESTS — the scheduler then keeps running on
    its current table."""
    spc = sec_per_chunk(op_snapshot)
    rates: Dict[str, float] = {}
    for client, scopes in (attrib_snapshot or {}).items():
        if client == "overflow":
            continue  # the ledger's fold-in bucket is not a lane
        if client == "anon":
            # unattributed requests are ADMITTED on the default lane
            # but ATTRIBUTED under "anon" — seed the lane they
            # actually queue on
            client = "default"
        if reserved and client in reserved:
            continue
        requests = chunks = 0.0
        for metrics in scopes.values():
            requests += float(metrics.get("requests") or 0.0)
            chunks += float(metrics.get("executor.chunks")
                            or metrics.get("chunks") or 0.0)
        if requests < MIN_REQUESTS:
            continue
        rates[client] = (chunks * spc) / requests
    if not rates:
        return {}, {}
    ordered = sorted(rates.values())
    median = ordered[len(ordered) // 2]
    lo, hi = CLAMP
    weights: Dict[str, float] = {}
    quotas: Dict[str, int] = {}
    for client, rate in rates.items():
        if rate <= 0 or median <= 0:
            w = hi
        else:
            w = min(max(median / rate, lo), hi)
        weights[client] = round(w, 6)
        if base_quota > 0:
            quotas[client] = max(1, round(base_quota * w))
    return weights, quotas


def pick_shed_lane(lane_snapshot: Dict[str, Dict[str, float]],
                   reserved: Optional[set] = None) -> Optional[str]:
    """The lane SLO load shedding targets: the HEAVIEST non-reserved
    lane — most admissions (the wait histogram's exact ``count`` is
    one tick per grant; the WFQ ``served`` number is join-adjusted
    virtual time and would misrank late joiners), queue depth breaking
    ties (deepest first), then name for determinism. None when every
    lane is reserved or the table is empty — explicit operator
    configuration outranks shedding, like it outranks the weight
    reseed."""
    best = None
    for name, row in (lane_snapshot or {}).items():
        if reserved and name in reserved:
            continue
        admissions = float((row.get("wait") or {}).get("count")
                           or row.get("served") or 0.0)
        key = (admissions, float(row.get("depth") or 0.0))
        if best is None or key > best[1] \
                or (key == best[1] and name < best[0]):
            best = (name, key)
    return best[0] if best else None
