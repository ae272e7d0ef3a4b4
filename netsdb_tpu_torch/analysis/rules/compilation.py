"""Plan-compilation discipline: who may mint compiled programs.

Fusion regions are the unit scatter-gather ships and merges — every
compiled program for a scatter subplan must be born on the region path
(``plan/fusion.py``: the region executor's keys, or
``compile_scatter_merge`` for the coordinator's merge+finalize). A
serve-layer module reaching for ``plan/executor._cached_program`` (the
port's counterpart of the reference's ``_cached_jit``: the cache of
compiled programs, captured as CUDA graphs on the card) directly would
mint a program the region tree never shows, the rollback arms
(``plan_fusion=off`` / ``fusion_mapper=greedy``) never disable, and
the ``fusion.distributed_regions`` counter never counts.
"""

from __future__ import annotations

import ast
from typing import Iterable

from netsdb_tpu_torch.analysis.lint import (Diagnostic, Module, Rule,
                                            register, terminal_name)

_SERVE = "netsdb_tpu_torch/serve/"
_SCATTER = "netsdb_tpu_torch/plan/scatter.py"
#: the executor's program cache (``plan/executor.py``)
_ANCHOR = "_cached_program"


@register
class ScatterJitRule(Rule):
    """Any ``_cached_program`` mention on the scatter paths (serve/ and
    plan/scatter.py) — compiled scatter programs are minted only by
    ``plan/fusion.py``'s region path."""

    id = "scatter-jit-route"
    rationale = ("scatter subplan/merge programs compile through "
                 "plan/fusion.py's region path (compile_scatter_merge "
                 "/ the region executor) or they escape the region "
                 "tree, the fusion rollback arms and the "
                 "fusion.distributed_regions count")

    def select(self, mod: Module) -> bool:
        return mod.rel.startswith(_SERVE) or mod.rel == _SCATTER

    def check_module(self, mod: Module) -> Iterable[Diagnostic]:
        for node in mod.walk():
            hit = None
            if isinstance(node, ast.Call):
                if terminal_name(node.func) == _ANCHOR:
                    hit = "call"
            elif isinstance(node, ast.ImportFrom):
                if any(a.name == _ANCHOR for a in node.names):
                    hit = "import"
            if hit:
                yield self.diag(
                    mod, node,
                    f"direct {_ANCHOR} ({hit}) on a scatter path — "
                    f"compile scatter programs through plan/fusion.py "
                    f"(compile_scatter_merge, or let the shard's own "
                    f"region executor compile the pushed subplan) so "
                    f"every distributed program is a region the "
                    f"EXPLAIN tree shows and plan_fusion=off rolls "
                    f"back")
