"""Concurrency-correctness toolchain over the port's own tree: AST lint
+ runtime lock witness — the port's ``netsdb_tpu/analysis/``.

Static half: :func:`run_lint` runs typed, pluggable AST rules
(``analysis/rules/``) over ``netsdb_tpu_torch/`` — lock-ordering
cycles, holds-across-blocking-calls, shared-state races, resource
discipline, and every ported pre-framework check — surfaced through
``python -m netsdb_tpu_torch lint``. The concurrency rules are
INTERPROCEDURAL: ``analysis/callgraph.py`` resolves a project-wide call
graph (module imports, methods, attribute types, aliases, thread roots)
and ``analysis/summaries.py`` folds it into transitive per-function
lock and blocking summaries. Dynamic half: ``utils/locks.LockWitness``
(lockdep-style) records the cross-thread acquisition-order graph at
runtime and flags cycles that never fired; ``analysis/witnesscov.py``
reconciles the two graphs (``lint --witness-coverage``).
``analysis/baseline.py`` is the shrink-only findings ratchet.
``netsdb_tpu_torch/docs/ANALYSIS.md`` is the human catalog; the
``analysis-docs-drift`` rule keeps it honest.

The rule ids are the reference's, letter for letter, so suppression
comments, ``--rule`` and the catalogue read the same in both trees.
"""

from netsdb_tpu_torch.analysis.lint import (  # noqa: F401
    Diagnostic, Module, Project, Rule, all_rules, render, rule_ids,
    run_lint, to_json)
