"""Two-way code ↔ catalog ↔ docs drift rules.

``metrics-drift``: every metric name minted in the port's code must be
catalogued (``obs/export.CATALOG``) and documented
(``netsdb_tpu_torch/docs/METRICS.md``), and vice versa — the
OpenMetrics scrape surface can never silently diverge from the docs.

``analysis-docs-drift`` applies the same pattern to THIS subsystem:
every registered lint rule id must have a row in
``netsdb_tpu_torch/docs/ANALYSIS.md`` (id, rationale, example,
suppression) and every documented row must
name a live rule — the rule catalog humans read is the rule set CI
runs, by construction.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Iterable, Set, Tuple

from netsdb_tpu_torch.analysis.lint import (Diagnostic, Project, Rule,
                                            register)

_INSTRUMENT_METHODS = {"counter", "gauge", "histogram"}
#: the port's own catalogues (the reference's ``docs/`` stay its own)
_METRICS_DOC = "netsdb_tpu_torch/docs/METRICS.md"
_ANALYSIS_DOC = "netsdb_tpu_torch/docs/ANALYSIS.md"


def _doc_table_names(path: str) -> Set[str]:
    """Backticked names in the first column of a markdown table."""
    out: Set[str] = set()
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                m = re.match(r"^\|\s*`([^`]+)`", line)
                if m:
                    out.add(m.group(1))
    except OSError:
        pass
    return out


@register
class MetricsCatalogRule(Rule):
    """Metric names: code ↔ obs/export.CATALOG ↔ the metric catalogue."""

    id = "metrics-drift"
    rationale = ("an uncatalogued metric is silently skipped by the "
                 "scrape; a stale doc row lies to operators")

    def check_project(self, project: Project) -> Iterable[Diagnostic]:
        from netsdb_tpu_torch.obs.export import CATALOG

        minted: Set[str] = set()
        prefixes: Set[str] = set()
        anchor = ("netsdb_tpu_torch/obs/export.py", 1)
        for mod in project.modules:
            if mod.tree is None \
                    or not mod.rel.startswith("netsdb_tpu_torch/"):
                continue
            for node in mod.walk():
                if not (isinstance(node, ast.Call) and node.args
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in _INSTRUMENT_METHODS):
                    continue
                arg = node.args[0]
                consts = []
                if isinstance(arg, ast.Constant):
                    consts = [arg]
                elif isinstance(arg, ast.IfExp):
                    consts = [b for b in (arg.body, arg.orelse)
                              if isinstance(b, ast.Constant)]
                elif isinstance(arg, ast.JoinedStr) and arg.values \
                        and isinstance(arg.values[0], ast.Constant):
                    prefixes.add(str(arg.values[0].value))
                    continue
                for c in consts:
                    if isinstance(c.value, str):
                        minted.add(c.value)
        documented = _doc_table_names(
            os.path.join(project.repo, _METRICS_DOC))

        def d(message: str) -> Diagnostic:
            return Diagnostic(rule=self.id, path=anchor[0],
                              line=anchor[1], col=0, message=message)

        for name in sorted(minted - set(CATALOG)):
            yield d(f"metric {name!r} is minted in code but missing "
                    f"from obs/export.CATALOG — the OpenMetrics "
                    f"scrape would silently skip it")
        for prefix in sorted(prefixes):
            if not any(k.startswith(prefix) for k in CATALOG):
                yield d(f"f-string metric family {prefix!r}* has no "
                        f"catalogued member in obs/export.CATALOG")
        for name in sorted(set(CATALOG) - documented):
            yield d(f"metric {name!r} is in obs/export.CATALOG but "
                    f"not documented in {_METRICS_DOC}")
        for name in sorted(documented - set(CATALOG)):
            yield d(f"metric {name!r} is documented in {_METRICS_DOC} "
                    f"but absent from obs/export.CATALOG (stale docs "
                    f"or a missing catalog entry)")


@register
class AnalysisDocsRule(Rule):
    """Lint rule ids: registry ↔ the rule catalogue, both directions."""

    id = "analysis-docs-drift"
    rationale = ("the rule catalog humans read must be the rule set "
                 "CI runs — in both directions")

    def check_project(self, project: Project) -> Iterable[Diagnostic]:
        from netsdb_tpu_torch.analysis.lint import (BAD_SUPPRESSION,
                                                    PARSE_ERROR,
                                                    STALE_BASELINE,
                                                    UNUSED_SUPPRESSION,
                                                    rule_ids)

        doc_path = os.path.join(project.repo, _ANALYSIS_DOC)
        documented = _doc_table_names(doc_path)
        registered = set(rule_ids()) | {BAD_SUPPRESSION,
                                        UNUSED_SUPPRESSION, PARSE_ERROR,
                                        STALE_BASELINE}
        anchor = "netsdb_tpu_torch/analysis/lint.py"

        def d(message: str) -> Diagnostic:
            return Diagnostic(rule=self.id, path=anchor, line=1, col=0,
                              message=message)

        if not documented:
            yield d(f"{_ANALYSIS_DOC} is missing or has no rule "
                    f"catalog table — every rule needs a documented "
                    "row (id, rationale, example, suppression)")
            return
        for rid in sorted(registered - documented):
            yield d(f"rule {rid!r} is registered but has no row in "
                    f"{_ANALYSIS_DOC} — document its rationale, "
                    f"example and suppression syntax")
        for rid in sorted(documented - registered):
            yield d(f"{_ANALYSIS_DOC} documents rule {rid!r} which "
                    f"is not registered — stale row or a missing "
                    f"rule module")
