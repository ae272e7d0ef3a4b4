"""Resource-discipline rule: closable stream iterators must be closed.

``PagedColumns.stream``/``stream_tables``, ``PagedObjects`` record
streams, ``PagedTensorStore.stream_blocks`` and ``stage_stream`` all
hold a relation READ LOCK (and, for staged streams, a background
upload thread) for the iterator's lifetime.  A consumer that abandons
one mid-way without ``close()`` leaves the lock to the garbage
collector — a concurrent ``drop``/append then waits on GC timing, the
exact class of stall the staging leak registry exists to catch at
runtime.  This rule catches it at lint time.

What counts as consumed correctly:

* ``with contextlib.closing(x.stream()) as it:`` / any ``with`` over
  the producer call;
* assignment whose variable is later ``.close()``d or wrapped in
  ``closing(...)``;
* passing the producer call directly to another call (ownership
  transfers — ``stage_stream(self._host_stream(), ...)``);
* ``return``/``yield from`` of the producer call (the caller owns it);
* comprehensions (they drain to exhaustion; a generator that raises
  mid-drain propagates — acceptable).

What gets flagged:

* ``for chunk in x.stream():`` — a statement-for directly over the
  producer: a ``break``, ``return``, exception, or (inside a
  generator) an abandoned outer iterator leaks the read lock;
* ``x = y.stream()`` with no ``close``/``closing``/``with`` on ``x``
  anywhere in the same function.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterable, List, Optional, Set

from netsdb_tpu_torch.analysis.lint import (Diagnostic, Module, Rule,
                                            enclosing_functions, register,
                                            terminal_name)

#: method names producing lock-holding / thread-backed iterators
_PRODUCER_METHODS = {"stream", "stream_tables", "stream_host_tables",
                     "stream_blocks", "scan_stream"}
#: bare function names with the same contract
_PRODUCER_FUNCS = {"stage_stream"}

#: modules that IMPLEMENT the producers (their internals delegate and
#: re-yield; ownership rules differ inside)
_EXEMPT = ("netsdb_tpu_torch/plan/staging.py",)


def _is_producer_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if isinstance(f, ast.Attribute) \
            and f.attr in (_PRODUCER_METHODS | _PRODUCER_FUNCS):
        return True  # x.stream(...) AND staging.stage_stream(...)
    if isinstance(f, ast.Name) and f.id in _PRODUCER_FUNCS:
        return True
    return False


@register
class IterCloseRule(Rule):
    """Stream iterators consumed without ``closing``/``close()``."""

    id = "iter-close"
    rationale = ("an abandoned stream iterator holds its relation's "
                 "read lock until GC — close deterministically")

    def select(self, mod: Module) -> bool:
        return mod.rel not in _EXEMPT

    def check_module(self, mod: Module) -> Iterable[Diagnostic]:
        for _cls, fn in mod.functions():
            yield from self._check_fn(mod, fn)

    @staticmethod
    def _own_nodes(fn: ast.AST) -> Iterable[ast.AST]:
        """The function's nodes EXCLUDING nested def subtrees (those
        are visited as their own functions — own close scope)."""
        stack = [fn]
        while stack:
            node = stack.pop()
            if node is not fn and isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
                continue
            yield node
            stack.extend(ast.iter_child_nodes(node))

    def _check_fn(self, mod: Module, fn: ast.AST) -> Iterable[Diagnostic]:
        owned: Set[int] = set()  # id() of producer Call nodes accounted
        assigns: List[tuple] = []  # (varname, call node)
        closed_vars: Set[str] = set()

        for node in self._own_nodes(fn):
            # ownership transfers
            if isinstance(node, ast.Call):
                for arg in list(node.args) + [kw.value
                                              for kw in node.keywords]:
                    if _is_producer_call(arg):
                        owned.add(id(arg))
            if isinstance(node, ast.Return) and node.value is not None \
                    and _is_producer_call(node.value):
                owned.add(id(node.value))
            if isinstance(node, ast.YieldFrom) \
                    and _is_producer_call(node.value):
                owned.add(id(node.value))
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    if _is_producer_call(item.context_expr):
                        owned.add(id(item.context_expr))
            if isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                 ast.GeneratorExp)):
                for gen in node.generators:
                    if _is_producer_call(gen.iter):
                        owned.add(id(gen.iter))
            # var bookkeeping
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and _is_producer_call(node.value):
                assigns.append((node.targets[0].id, node.value))
            if isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Attribute) and f.attr == "close" \
                        and isinstance(f.value, ast.Name):
                    closed_vars.add(f.value.id)
                if terminal_name(f) == "closing" and node.args \
                        and isinstance(node.args[0], ast.Name):
                    closed_vars.add(node.args[0].id)

        for node in self._own_nodes(fn):
            if isinstance(node, (ast.For, ast.AsyncFor)) \
                    and _is_producer_call(node.iter) \
                    and id(node.iter) not in owned:
                name = terminal_name(node.iter.func)
                yield self.diag(
                    mod, node.iter,
                    f"iterating {name}() directly — a break, early "
                    f"return or abandoned outer generator leaks its "
                    f"read lock; wrap in contextlib.closing(...)")
        for var, call in assigns:
            if id(call) in owned or var in closed_vars:
                continue
            name = terminal_name(call.func)
            # render the suggested try/finally as a diff riding the
            # diagnostic (--json "suggestion") — still human-applied,
            # which is the --fix safety gate for this shape (lazy
            # import: fix.py imports this module at top level)
            from netsdb_tpu_torch.analysis.fix import suggest_close

            d = self.diag(
                mod, call,
                f"{var} = {name}() is never closed in this function — "
                f"close() it (try/finally or contextlib.closing) or "
                f"hand ownership to the caller")
            suggestion = suggest_close(mod, var, call)
            if suggestion:
                d = dataclasses.replace(d, suggestion=suggestion)
            yield d
