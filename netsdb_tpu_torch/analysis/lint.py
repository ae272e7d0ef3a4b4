"""AST lint framework — typed, pluggable static rules over the port's
tree (the port's ``netsdb_tpu/analysis/lint.py``).

The reference once shipped a real lock inversion (``store.add_data``
held the global store lock across ``PagedObjects.append``) that was
caught by reading the code, not by tooling: per-file AST scanners
cannot see lock *nesting*, aliases, or resource lifetimes. This package is the
replacement — one framework, many small typed rules, one entry point
(``python -m netsdb_tpu_torch lint``) shared by the tests and humans.

Design:

* **Parse once.** Every target file becomes a :class:`Module` (source,
  AST, suppression table) built exactly once and shared by all rules.
* **Two rule scopes.** A rule may implement :meth:`Rule.check_module`
  (per-file diagnostics) and/or :meth:`Rule.check_project`
  (whole-tree passes — the lock-order graph, the metric-catalog drift
  check — anything that must see every module at once).
* **Typed diagnostics.** Every finding is a :class:`Diagnostic`
  (rule id, repo-relative path, line, column, message) — renderable
  as ``file:line:col: [rule-id] message`` or JSON.
* **Per-rule suppression comments.** ``# lint: disable=<rule-id>[,
  <rule-id>] -- <reason>`` on the flagged line (or the line directly
  above it) suppresses matching diagnostics.  The reason is
  MANDATORY: a suppression without one is itself a diagnostic
  (``bad-suppression``), and a suppression that never fires on a
  full-rule-set run is flagged too (``unused-suppression``) so stale
  exemptions cannot accumulate.  The rule catalogue lives in
  ``netsdb_tpu_torch/docs/ANALYSIS.md``; the ``analysis-docs-drift``
  rule keeps that file and the registered rule set agreeing in both
  directions.

The framework itself stays stdlib-only (ast/os/re/json): ``lint``
touches no device and imports no more of ``torch`` than the package's
``__init__`` already does.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
import tokenize
from typing import Any, Callable, Dict, Iterable, List, Optional, Set, Tuple

#: repo root (the directory holding netsdb_tpu_torch/ and tests/)
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: the default lint target — the whole package tree
PKG_DIR = os.path.join(REPO, "netsdb_tpu_torch")

#: suppression comment grammar: ``lint: disable=<rule>[,<rule>] --
#: <reason>`` as a comment on the flagged line or the line above
_SUPPRESS_RE = re.compile(
    r"#\s*lint:\s*disable=([A-Za-z0-9_,\- ]+?)\s*(?:--\s*(.*))?$")

#: framework-level diagnostic ids (reserved; not Rule subclasses)
BAD_SUPPRESSION = "bad-suppression"
UNUSED_SUPPRESSION = "unused-suppression"
PARSE_ERROR = "parse-error"
STALE_BASELINE = "stale-baseline"


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding: where, which rule, what — plus, for findings with
    a mechanical-but-human-applied remedy, a rendered ``suggestion``
    diff (the iter-close assigned-never-closed shape)."""

    rule: str
    path: str  # repo-relative
    line: int
    col: int
    message: str
    suggestion: Optional[str] = dataclasses.field(
        default=None, compare=False)

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: " \
               f"[{self.rule}] {self.message}"

    def to_dict(self) -> Dict[str, Any]:
        out = {"rule": self.rule, "path": self.path, "line": self.line,
               "col": self.col, "message": self.message}
        if self.suggestion is not None:
            out["suggestion"] = self.suggestion
        return out


@dataclasses.dataclass
class _Suppression:
    rules: Tuple[str, ...]
    reason: str
    line: int  # where the comment sits
    used: bool = False


class Module:
    """One parsed source file, shared by every rule in a run.

    ``source`` overrides the file read — the ``lint --fix`` rewriter
    re-lints its in-memory rewrite between passes without a disk
    round-trip (one construction path either way)."""

    def __init__(self, path: str, repo: str = REPO,
                 source: Optional[str] = None):
        self.path = os.path.abspath(path)
        self.rel = os.path.relpath(self.path, repo).replace(os.sep, "/")
        if source is None:
            with open(self.path, encoding="utf-8") as f:
                source = f.read()
        self.source = source
        self.lines = self.source.splitlines()
        self.tree: Optional[ast.AST] = None
        self.parse_error: Optional[str] = None
        try:
            self.tree = ast.parse(self.source, filename=self.path)
        except SyntaxError as e:
            self.parse_error = f"{type(e).__name__}: {e.msg} " \
                               f"(line {e.lineno})"
        self.suppressions: List[_Suppression] = self._collect_suppressions()
        #: line → suppressions covering it (own line + the next line)
        self._by_line: Dict[int, List[_Suppression]] = {}
        for sup in self.suppressions:
            for ln in (sup.line, sup.line + 1):
                self._by_line.setdefault(ln, []).append(sup)
        self._nodes: Optional[List[ast.AST]] = None
        self._functions: Optional[List[Tuple[Optional[str],
                                             ast.AST]]] = None

    def _collect_suppressions(self) -> List[_Suppression]:
        out: List[_Suppression] = []
        try:
            tokens = tokenize.generate_tokens(
                iter(self.source.splitlines(True)).__next__)
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                m = _SUPPRESS_RE.search(tok.string)
                if m is None:
                    continue
                rules = tuple(r.strip() for r in m.group(1).split(",")
                              if r.strip())
                out.append(_Suppression(rules=rules,
                                        reason=(m.group(2) or "").strip(),
                                        line=tok.start[0]))
        except tokenize.TokenError:
            pass  # the parse-error diagnostic already covers this file
        return out

    def reset_run_state(self) -> None:
        """Clear per-run mutable state (suppression hit flags) so a
        cached Module can be reused by the next ``run_lint`` without
        carrying the previous run's usage accounting."""
        for sup in self.suppressions:
            sup.used = False

    def suppressed(self, rule: str, line: int) -> bool:
        """True (and mark used) when a VALID suppression for ``rule``
        covers ``line``. A reason-less suppression never matches — it
        surfaces as ``bad-suppression`` instead."""
        for sup in self._by_line.get(line, ()):
            if rule in sup.rules and sup.reason:
                sup.used = True
                return True
        return False

    def walk(self) -> Iterable[ast.AST]:
        """Every AST node, walked once and cached — several rules scan
        the same module; re-walking generators dominates the budget."""
        if self._nodes is None:
            self._nodes = list(ast.walk(self.tree)) \
                if self.tree is not None else []
        return self._nodes

    def functions(self) -> List[Tuple[Optional[str], ast.AST]]:
        """Cached ``(class_name_or_None, function_node)`` pairs."""
        if self._functions is None:
            self._functions = (list(enclosing_functions(self.tree))
                               if self.tree is not None else [])
        return self._functions


class Project:
    """The whole lint target: every parsed module plus cross-module
    indexes rules can share (built lazily, cached per run)."""

    def __init__(self, modules: List[Module], repo: str = REPO):
        self.repo = repo
        self.modules = modules
        self._cache: Dict[str, Any] = {}

    def module(self, rel: str) -> Optional[Module]:
        for m in self.modules:
            if m.rel == rel:
                return m
        return None

    def cached(self, key: str, build: Callable[[], Any]) -> Any:
        if key not in self._cache:
            self._cache[key] = build()
        return self._cache[key]


class Rule:
    """Base class for every lint rule.

    Subclasses set :attr:`id` (the suppression/CLI handle, kebab-case)
    and :attr:`rationale` (one line; ``netsdb_tpu_torch/docs/ANALYSIS.md``
    catalogs it)
    and implement :meth:`check_module` and/or :meth:`check_project`.
    """

    id: str = ""
    rationale: str = ""

    def select(self, mod: Module) -> bool:
        """Whether ``mod`` is in this rule's scope (default: all)."""
        return True

    def check_module(self, mod: Module) -> Iterable[Diagnostic]:
        return ()

    def check_project(self, project: Project) -> Iterable[Diagnostic]:
        return ()

    # --- helpers ------------------------------------------------------
    def diag(self, mod: Module, node: Any, message: str) -> Diagnostic:
        line = getattr(node, "lineno", node if isinstance(node, int) else 1)
        col = getattr(node, "col_offset", 0)
        return Diagnostic(rule=self.id, path=mod.rel, line=int(line),
                          col=int(col), message=message)


# --- registry ---------------------------------------------------------

_REGISTRY: Dict[str, type] = {}


def register(cls: type) -> type:
    """Class decorator adding a rule to the global registry."""
    if not getattr(cls, "id", ""):
        raise ValueError(f"rule {cls.__name__} has no id")
    if cls.id in _REGISTRY:
        raise ValueError(f"duplicate rule id {cls.id!r}")
    _REGISTRY[cls.id] = cls
    return cls


def all_rules() -> List[Rule]:
    """Instantiate every registered rule, importing the rules package
    on first use (rules self-register via :func:`register`)."""
    from netsdb_tpu_torch.analysis import rules as _rules  # noqa: F401

    return [cls() for _, cls in sorted(_REGISTRY.items())]


def rule_ids() -> List[str]:
    from netsdb_tpu_torch.analysis import rules as _rules  # noqa: F401

    return sorted(_REGISTRY)


# --- running ----------------------------------------------------------

def _default_files() -> List[str]:
    out = []
    for dirpath, dirnames, filenames in os.walk(PKG_DIR):
        # sorted: the tree loads in one order on every machine
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for name in sorted(filenames):
            if name.endswith(".py"):
                out.append(os.path.join(dirpath, name))
    return out


#: parse-once cache: abs path → ((repo, mtime_ns, size), Module).
#: Parsing + the cached AST walks dominate a lint run; the lint gate,
#: a witness-coverage report beside a lint, and every fixture test in
#: one process share parses as long as the file on disk is unchanged.
_MODULE_CACHE: Dict[str, Tuple[Tuple[str, int, int], Module]] = {}


def _load_module(path: str, repo: str) -> Module:
    abspath = os.path.abspath(path)
    try:
        st = os.stat(abspath)
        key = (repo, st.st_mtime_ns, st.st_size)
    except OSError:
        return Module(abspath, repo)  # unreadable: let open() report
    cached = _MODULE_CACHE.get(abspath)
    if cached is not None and cached[0] == key:
        # the stat key has a granularity hole: a same-size rewrite
        # within the filesystem timestamp resolution keeps the key.
        # Re-reading the source closes it — a read is ~free next to
        # the parse + AST walks the cache exists to skip
        try:
            with open(abspath, encoding="utf-8") as f:
                if f.read() == cached[1].source:
                    cached[1].reset_run_state()
                    return cached[1]
        except OSError:
            pass
    mod = Module(abspath, repo)
    _MODULE_CACHE[abspath] = (key, mod)
    return mod


def load_project(paths: Optional[Iterable[str]] = None,
                 repo: str = REPO) -> Project:
    files = list(paths) if paths is not None else _default_files()
    return Project([_load_module(p, repo) for p in files], repo)


def run_lint(paths: Optional[Iterable[str]] = None,
             rules: Optional[Iterable[str]] = None,
             repo: str = REPO,
             select_all: bool = False,
             project: Optional[Project] = None) -> List[Diagnostic]:
    """Run lint rules and return the surviving diagnostics, sorted.

    ``paths`` — explicit files (default: the whole ``netsdb_tpu_torch/``
    package).  ``rules`` — rule ids to run (default: all).
    ``select_all`` — bypass every rule's scope filter (fixture tests run
    serve-scoped rules over files outside ``serve/``).  ``project`` —
    reuse an already-loaded :class:`Project` (and everything cached on
    it: call graph, summaries, static lock edges) instead of loading
    one, as a caller running the witness-coverage report and the lint
    over one tree can.

    Suppression accounting: ``bad-suppression`` fires on any
    suppression comment without a reason; ``unused-suppression`` fires
    only on FULL-rule-set runs (running one rule must not flag another
    rule's suppressions as stale).
    """
    if project is None:
        project = load_project(paths, repo)
    available = {r.id: r for r in all_rules()}
    if rules is None:
        chosen = list(available.values())
    else:
        unknown = [r for r in rules if r not in available]
        if unknown:
            raise ValueError(f"unknown rule id(s): {', '.join(unknown)}; "
                             f"available: {', '.join(sorted(available))}")
        chosen = [available[r] for r in rules]
    full_run = rules is None

    diags: List[Diagnostic] = []
    for mod in project.modules:
        if mod.parse_error is not None:
            diags.append(Diagnostic(rule=PARSE_ERROR, path=mod.rel,
                                    line=1, col=0,
                                    message=mod.parse_error))
    for rule in chosen:
        for mod in project.modules:
            if mod.tree is None:
                continue
            if not (select_all or rule.select(mod)):
                continue
            for d in rule.check_module(mod):
                if not mod.suppressed(d.rule, d.line):
                    diags.append(d)
        for d in rule.check_project(project):
            m = project.module(d.path)
            if m is None or not m.suppressed(d.rule, d.line):
                diags.append(d)

    framework_ids = {BAD_SUPPRESSION, UNUSED_SUPPRESSION, PARSE_ERROR}
    for mod in project.modules:
        for sup in mod.suppressions:
            unknown_ids = [r for r in sup.rules
                           if r not in available
                           and r not in framework_ids]
            if unknown_ids:
                # a typo'd id can never match OR be reported stale —
                # without this it would accumulate silently forever
                diags.append(Diagnostic(
                    rule=BAD_SUPPRESSION, path=mod.rel, line=sup.line,
                    col=0,
                    message=f"suppression names unknown rule id(s) "
                            f"{', '.join(unknown_ids)} — typo, or a "
                            f"rule that no longer exists"))
            if not sup.reason:
                diags.append(Diagnostic(
                    rule=BAD_SUPPRESSION, path=mod.rel, line=sup.line,
                    col=0,
                    message="suppression without a reason — write "
                            "'# lint: disable=<rule> -- <why>'"))
            elif full_run and not sup.used:
                known = [r for r in sup.rules if r in available]
                if known:
                    diags.append(Diagnostic(
                        rule=UNUSED_SUPPRESSION, path=mod.rel,
                        line=sup.line, col=0,
                        message=f"suppression for "
                                f"{', '.join(sup.rules)} never matched "
                                f"a diagnostic — stale; remove it"))
    diags.sort(key=lambda d: (d.path, d.line, d.col, d.rule))
    return diags


def set_gauge(name: str, value: float) -> None:
    """Export one analysis gauge through the central obs registry —
    never fatal (lint must work in environments where obs can't
    import), and in ONE place so every analysis.* gauge shares the
    same policy."""
    try:
        from netsdb_tpu_torch.obs.metrics import registry

        registry().gauge(name).set(value)
    except Exception:  # noqa: BLE001 — obs must never break lint
        pass


def render(diags: List[Diagnostic]) -> str:
    return "\n".join(str(d) for d in diags)


def to_json(diags: List[Diagnostic]) -> List[Dict[str, Any]]:
    return [d.to_dict() for d in diags]


# --- shared AST helpers (used by several rules) -----------------------

def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def terminal_name(node: ast.AST) -> Optional[str]:
    """The last attribute/name segment of a call target or chain."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def call_keywords(node: ast.Call) -> Set[str]:
    return {kw.arg for kw in node.keywords if kw.arg is not None}


def enclosing_functions(tree: ast.AST) -> Iterable[Tuple[Optional[str],
                                                         ast.AST]]:
    """Yield ``(class_name_or_None, function_node)`` for every function
    and method in the module, including nested ones."""
    def visit(node: ast.AST, cls: Optional[str]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                yield from visit(child, child.name)
            elif isinstance(child, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                yield cls, child
                yield from visit(child, cls)
            else:
                yield from visit(child, cls)

    yield from visit(tree, None)
