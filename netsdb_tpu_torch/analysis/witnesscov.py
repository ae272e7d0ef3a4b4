"""Static ↔ runtime lock-graph reconciliation — ``lint
--witness-coverage``.

Two graphs describe the same property from opposite sides:

* the **static** lock-order graph (``rules/locking.static_lock_edges``
  — lexical nesting + interprocedural call-through + the seeded
  hierarchy), which over-approximates: every ordering the code COULD
  exercise;
* the **dynamic** witness graph (``utils/locks.LockWitness`` — the
  rank edges a real run actually recorded), which under-approximates:
  only the orderings some thread interleaving DID exercise.

Diffing them turns two silent gaps into reports:

* a static edge the witness never saw is **untested concurrency** —
  an ordering no test or run drives, where an inversion would
  ship unnoticed until production interleaves it;
* a dynamic edge the static graph never derived is a **static blind
  spot** — lock usage reaching through a call path the resolver
  cannot see (C-extension callbacks, higher-order dispatch), i.e.
  exactly where to improve the call graph next.

Neither direction is a FAILURE (the report exits 0): the value is the
diff itself, refreshed per run.  Both sides share one rank-token
grammar (``summaries.lock_token`` deliberately matches the
``TrackedLock("SetStore._lock")`` witness names), so reconciliation
is a set comparison, not a fuzzy match.  The uncovered-static count
exports as the ``analysis.witness_uncovered_edges`` gauge so the
scrape can trend it.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

from netsdb_tpu_torch.analysis.lint import (Project, load_project,
                                            set_gauge)
from netsdb_tpu_torch.analysis.rules.locking import (SEED_EDGES,
                                                     static_lock_edges)


def load_witness_dump(path: str) -> List[dict]:
    """Read a ``LockWitness.dump()`` file → its edge records."""
    with open(path, encoding="utf-8") as f:
        payload = json.load(f)
    edges = payload.get("edges")
    if not isinstance(edges, list):
        raise ValueError(f"{path}: not a witness dump "
                         f"(no 'edges' list)")
    return edges


def coverage(dynamic_edges: List[dict],
             project: Optional[Project] = None) -> Dict[str, Any]:
    """Reconcile the static graph with witness edge records.

    Returns ``{"covered", "static_uncovered", "dynamic_unpredicted",
    "static_total", "dynamic_total", "coverage"}`` where the edge
    lists carry the best site each side knows (static: file:line of
    the sighting, or "seed"; dynamic: the witness acquisition
    sites)."""
    if project is None:
        project = load_project()
    static = static_lock_edges(project)
    dyn: Dict[Tuple[str, str], dict] = {}
    for rec in dynamic_edges:
        a, b = rec.get("held"), rec.get("acquired")
        if isinstance(a, str) and isinstance(b, str):
            dyn.setdefault((a, b), rec)
    static_keys = {k for k in static
                   if not (k[0].startswith("*.")
                           or k[1].startswith("*."))}
    covered = sorted(static_keys & set(dyn))
    uncovered = sorted(static_keys - set(dyn))
    unpredicted = sorted(set(dyn) - static_keys)
    seeds = set(SEED_EDGES)

    def static_site(k: Tuple[str, str]) -> str:
        site = static.get(k)
        if site is None:
            return "seed (netsdb_tpu_torch/docs/ANALYSIS.md)" if k in seeds else "?"
        return site.describe()

    report = {
        "static_total": len(static_keys),
        "dynamic_total": len(dyn),
        "covered": [{"edge": list(k), "static_site": static_site(k)}
                    for k in covered],
        "static_uncovered": [
            {"edge": list(k), "static_site": static_site(k)}
            for k in uncovered],
        "dynamic_unpredicted": [
            {"edge": list(k), "sites": dyn[k].get("sites", []),
             "modes": dyn[k].get("modes", [])}
            for k in unpredicted],
        "coverage": (len(covered) / len(static_keys)
                     if static_keys else 1.0),
    }
    set_gauge("analysis.witness_uncovered_edges", len(uncovered))
    return report


def render(report: Dict[str, Any]) -> str:
    """Human-readable reconciliation readout."""
    lines = [
        f"witness coverage: {len(report['covered'])}/"
        f"{report['static_total']} static lock-order edges exercised "
        f"at runtime ({report['coverage']:.0%}); "
        f"{report['dynamic_total']} dynamic edges observed",
    ]
    if report["static_uncovered"]:
        lines.append(f"  untested concurrency "
                     f"({len(report['static_uncovered'])} static "
                     f"edges no run has exercised):")
        for rec in report["static_uncovered"]:
            a, b = rec["edge"]
            lines.append(f"    {a} -> {b}  [{rec['static_site']}]")
    if report["dynamic_unpredicted"]:
        lines.append(f"  static blind spots "
                     f"({len(report['dynamic_unpredicted'])} runtime "
                     f"edges the static graph never derived):")
        for rec in report["dynamic_unpredicted"]:
            a, b = rec["edge"]
            sites = ", ".join(rec.get("sites") or ())
            lines.append(f"    {a} -> {b}  [{sites}]")
    return "\n".join(lines)
