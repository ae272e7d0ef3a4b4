"""Mechanical auto-fixes for lint findings — ``lint --fix``.

The ``iter-close`` rule's commonest finding is purely mechanical::

    for chunk in pc.stream_tables():      # flagged: direct iteration
        ...

    with contextlib.closing(pc.stream_tables()) as _closing_stream:
        for chunk in _closing_stream:     # fixed
            ...

This module applies exactly that rewrite: wrap the producer call in
``contextlib.closing`` one statement up, iterate the bound name, indent
the loop body, and add ``import contextlib`` when the module lacks it.
Only statement-``for`` findings are fixed (the rule's other shape — an
assigned stream never closed — needs a ``try/finally`` whose extent a
human must choose, so it is reported, never rewritten).

Safety gates (a skipped fix is counted and reported, never guessed):

* the ``for`` header must be single-line (its iterator expression ends
  on the ``for`` line);
* the loop may not contain a multi-line string constant (re-indenting
  its lines would corrupt the literal);
* the generated binding name is collision-checked against the whole
  module source.

The rewrite is IDEMPOTENT by construction: after fixing, the loop
iterates a plain name, which the rule does not flag — re-running
``--fix`` finds nothing to do. ``--fix --dry-run`` renders the unified
diff without touching any file.
"""

from __future__ import annotations

import ast
import difflib
import os
from typing import Dict, List, Optional, Tuple

from netsdb_tpu_torch.analysis.lint import REPO, Module, load_project
from netsdb_tpu_torch.analysis.rules.resources import _is_producer_call

#: base name for the closing binding (numbered on collision)
_BIND = "_closing_stream"


def _has_multiline_string(node: ast.AST) -> bool:
    """Any str/bytes constant or f-string spanning lines — re-indenting
    its lines would change the literal's VALUE, not just layout."""
    for sub in ast.walk(node):
        multiline = getattr(sub, "end_lineno", None) is not None \
            and sub.end_lineno != getattr(sub, "lineno", None)
        if not multiline:
            continue
        if isinstance(sub, ast.Constant) \
                and isinstance(sub.value, (str, bytes)):
            return True
        if isinstance(sub, ast.JoinedStr):
            return True
    return False


def _flagged_for_sites(mod: Module) -> set:
    """(line, col) of producer calls the iter-close rule flags as
    direct statement-``for`` iteration — the fixer rewrites exactly
    the sites the rule reports (ownership analysis stays in ONE
    place, the rule)."""
    from netsdb_tpu_torch.analysis.rules.resources import IterCloseRule

    rule = IterCloseRule()
    if not rule.select(mod):
        return set()
    return {(d.line, d.col) for d in rule.check_module(mod)
            if "iterating" in d.message}


def _pick_name(source: str) -> str:
    name = _BIND
    k = 2
    while name in source:
        name = f"{_BIND}{k}"
        k += 1
    return name


def _ensure_import(lines: List[str]) -> Tuple[List[str], bool]:
    """Insert ``import contextlib`` after the module's import header
    when missing. Returns (lines, inserted). The presence check is an
    AST walk over MODULE-LEVEL imports — a function-local import or a
    docstring merely containing the text must not satisfy it (the
    rewritten loop's scope would hit NameError)."""
    try:
        tree = ast.parse("\n".join(lines))
    except SyntaxError:
        return lines, False
    # the rewrite emits `contextlib.closing(...)`, so only a top-level
    # unaliased `import contextlib` binds the name it needs (a
    # `from contextlib import closing` would not)
    for node in tree.body:
        if isinstance(node, ast.Import) \
                and any(a.name == "contextlib" and a.asname is None
                        for a in node.names):
            return lines, False
    insert_at = 0  # after the module docstring and import header
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            insert_at = getattr(node, "end_lineno", node.lineno)
        elif isinstance(node, ast.Expr) and insert_at == 0 \
                and isinstance(node.value, ast.Constant):
            insert_at = getattr(node, "end_lineno", node.lineno)
        else:
            break
    out = list(lines)
    out.insert(insert_at, "import contextlib")
    return out, True




def _one_pass(mod: Module) -> Tuple[Optional[str], int, int]:
    """One rewrite pass over ``mod``: fixes only INNERMOST flagged
    loops (an outer flagged loop containing another flagged loop is
    deferred — rewriting it with stale line numbers after the inner
    rewrite grew the file would corrupt the source; the caller
    iterates to a fixed point). Returns ``(new_source | None, fixed,
    skipped)``."""
    if mod.tree is None:
        return None, 0, 0
    flagged = _flagged_for_sites(mod)
    if not flagged:
        return None, 0, 0
    loops: List[ast.For] = []
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.For, ast.AsyncFor)) \
                and _is_producer_call(node.iter) \
                and (node.iter.lineno, node.iter.col_offset) in flagged:
            loops.append(node)
    if not loops:
        return None, 0, 0
    # innermost-only: defer any loop whose span contains another
    # flagged loop (the next pass sees fresh line numbers)
    innermost = [a for a in loops
                 if not any(b is not a and a.lineno < b.lineno
                            and b.end_lineno <= a.end_lineno
                            for b in loops)]
    lines = list(mod.lines)
    fixed = 0
    skipped = 0
    # bottom-up so earlier line numbers stay valid across rewrites
    for node in sorted(innermost, key=lambda n: -n.lineno):
        header_ok = (node.iter.end_lineno == node.lineno
                     and node.body and node.body[0].lineno > node.lineno)
        if not header_ok or _has_multiline_string(node):
            skipped += 1
            continue
        expr_src = ast.get_source_segment(mod.source, node.iter)
        if expr_src is None:
            skipped += 1
            continue
        name = _pick_name("\n".join(lines))
        indent = " " * node.col_offset
        li = node.lineno - 1
        header = lines[li]
        new_for = (header[:node.iter.col_offset] + name
                   + header[node.iter.end_col_offset:])
        block = [indent + f"with contextlib.closing({expr_src}) "
                          f"as {name}:",
                 "    " + new_for]
        for bl in lines[node.lineno:node.end_lineno]:
            block.append("    " + bl if bl.strip() else bl)
        lines[li:node.end_lineno] = block
        fixed += 1
    if not fixed:
        return None, 0, skipped
    lines, _ = _ensure_import(lines)
    new_source = "\n".join(lines)
    if mod.source.endswith("\n"):
        new_source += "\n"
    return new_source, fixed, skipped


def fix_module(mod: Module, repo: str = REPO
               ) -> Tuple[Optional[str], int, int]:
    """Compute the fixed source for one module, iterating
    :func:`_one_pass` to a fixed point (nested flagged loops fix
    inside-out across passes, each pass re-linting a freshly parsed
    in-memory :class:`Module` over the rewritten source).

    Returns ``(new_source | None, fixed, skipped)`` — ``None`` when
    nothing changed; ``skipped`` counts flagged loops the safety gates
    refused to rewrite (the stable remainder after the final pass)."""
    total_fixed = 0
    skipped = 0
    cur = mod
    for _ in range(8):  # depth bound; real nesting is 1-2 deep
        new_source, fixed, skipped = _one_pass(cur)
        if new_source is None:
            break
        total_fixed += fixed
        cur = Module(mod.path, repo, source=new_source)
    if total_fixed == 0:
        return None, 0, skipped
    return cur.source, total_fixed, skipped


#: builtins that EAGERLY drain whatever iterator chain they are
#: handed — a value they produce cannot keep the handle alive
_EAGER = {"next", "list", "tuple", "set", "dict", "sorted", "sum",
          "min", "max", "any", "all", "len"}
#: builtins that LAZILY rewrap an iterator — the wrapper holds the
#: live handle, so returning/storing one IS an escape of the handle
_LAZY = {"iter", "enumerate", "zip", "map", "filter", "reversed"}


def _escapes(stmt: ast.AST, var: str) -> bool:
    """Whether the live handle ``var`` escapes through ``stmt``:
    returned/yielded/stored directly, inside a container literal,
    inside a LAZY rewrapper (``return enumerate(var)``, a generator
    expression over it), or passed bare to a non-builtin call
    (``register(var)``, ``self.cache.append(var)``).  Values whose
    outermost operation eagerly drains the chain (``return
    next(iter(var))``, ``rows = list(var)``) — or method calls on the
    handle itself — are consumption, not escape."""
    from netsdb_tpu_torch.analysis.lint import terminal_name

    def contains_var(node: ast.AST) -> bool:
        return any(isinstance(n, ast.Name) and n.id == var
                   for n in ast.walk(node))

    def derives_safely(value: ast.AST) -> bool:
        # list/set/dict comprehensions drain eagerly (a GENERATOR
        # expression stays lazy and falls through to escape)
        if isinstance(value, (ast.ListComp, ast.SetComp,
                              ast.DictComp)):
            return True
        if not isinstance(value, ast.Call):
            return False
        if terminal_name(value.func) in _EAGER:
            return True
        # a method call ON the handle (var.read(), var.close())
        # returns derived data, not the handle
        f = value.func
        return isinstance(f, ast.Attribute) \
            and isinstance(f.value, ast.Name) and f.value.id == var

    def is_bare_var(node: ast.AST) -> bool:
        if isinstance(node, ast.Name) and node.id == var:
            return True
        if isinstance(node, ast.Starred):
            return is_bare_var(node.value)
        return False

    for node in ast.walk(stmt):
        value = None
        if isinstance(node, (ast.Return, ast.Yield, ast.YieldFrom)):
            value = node.value
        elif isinstance(node, (ast.Assign, ast.AnnAssign,
                               ast.AugAssign)):
            value = node.value
        if value is not None and contains_var(value) \
                and not derives_safely(value):
            return True
        if isinstance(node, ast.Call):
            fname = terminal_name(node.func)
            f = node.func
            on_var = isinstance(f, ast.Attribute) \
                and isinstance(f.value, ast.Name) and f.value.id == var
            if fname not in _EAGER and fname not in _LAZY \
                    and not on_var:
                args = list(node.args) + [kw.value
                                          for kw in node.keywords]
                if any(is_bare_var(a) for a in args):
                    return True
    return False


def suggest_close(mod: Module, var: str,
                  call: ast.AST) -> Optional[str]:
    """Render a SUGGESTED ``try/finally`` diff for the iter-close
    rule's assigned-never-closed shape::

        it = pc.stream()          →    it = pc.stream()
        <rest of block>                try:
                                           <rest of block>
                                       finally:
                                           it.close()

    The extent (rest of the enclosing block) is a best-effort default
    a human still reviews — which is exactly why this renders a diff
    in the report instead of rewriting the file (the ``--fix`` safety
    gate).  Returns a unified diff, or None when a safety gate
    (multi-line statements, nothing after the assignment) says a
    mechanical suggestion would be wrong."""
    if mod.tree is None:
        return None
    assign = None
    body: Optional[List[ast.stmt]] = None
    for node in ast.walk(mod.tree):
        for field in ("body", "orelse", "finalbody"):
            stmts = getattr(node, field, None)
            if not isinstance(stmts, list):
                continue
            for i, stmt in enumerate(stmts):
                if isinstance(stmt, ast.Assign) \
                        and stmt.value is call:
                    assign, body, idx = stmt, stmts, i
    if assign is None or body is None:
        return None
    rest = body[idx + 1:]
    if not rest:
        return None  # created and never used: closing extent unclear
    if assign.end_lineno != assign.lineno:
        return None
    if any(_has_multiline_string(stmt) for stmt in rest):
        return None
    if any(_escapes(stmt, var) for stmt in rest):
        # the handle itself leaves the function (returned, yielded,
        # aliased, stored) — a finally: close() here would hand the
        # caller a closed iterator; no mechanical suggestion is right
        return None
    indent = " " * assign.col_offset
    lines = list(mod.lines)
    start = rest[0].lineno - 1
    end = rest[-1].end_lineno  # exclusive slice bound
    block = [indent + "try:"]
    for bl in lines[start:end]:
        block.append("    " + bl if bl.strip() else bl)
    block += [indent + "finally:", indent + f"    {var}.close()"]
    new_lines = lines[:start] + block + lines[end:]
    new_source = "\n".join(new_lines)
    if mod.source.endswith("\n"):
        new_source += "\n"
    return "".join(difflib.unified_diff(
        mod.source.splitlines(keepends=True),
        new_source.splitlines(keepends=True),
        fromfile=f"a/{mod.rel}", tofile=f"b/{mod.rel}"))


def run_fix(paths: Optional[List[str]] = None, repo: str = REPO,
            dry_run: bool = False) -> Dict[str, object]:
    """Apply (or preview) the iter-close fixes over ``paths`` (default:
    the whole package tree). Returns ``{"fixed": n, "skipped": n,
    "files": [rel...], "diff": str}`` — ``diff`` is populated only for
    dry runs; real runs write the files in place."""
    project = load_project(paths, repo)
    total_fixed = 0
    total_skipped = 0
    files: List[str] = []
    diffs: List[str] = []
    for mod in project.modules:
        new_source, fixed, skipped = fix_module(mod, repo)
        total_skipped += skipped
        if new_source is None:
            continue
        total_fixed += fixed
        files.append(mod.rel)
        if dry_run:
            diffs.append("".join(difflib.unified_diff(
                mod.source.splitlines(keepends=True),
                new_source.splitlines(keepends=True),
                fromfile=f"a/{mod.rel}", tofile=f"b/{mod.rel}")))
        else:
            tmp = mod.path + ".lintfix.tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(new_source)
            os.replace(tmp, mod.path)
    return {"fixed": total_fixed, "skipped": total_skipped,
            "files": files, "diff": "".join(diffs)}
