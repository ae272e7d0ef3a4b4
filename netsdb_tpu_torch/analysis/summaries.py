"""Per-function concurrency summaries over the project call graph.

The interprocedural layer between raw ASTs and the concurrency rules:
for every project function, ONE walk extracts its *facts* —

* lock tokens acquired lexically (``with <lock>:``), with sites;
* lexical nesting edges between those tokens;
* every resolved call site, annotated with the lock tokens held at
  that site (the call-through context);
* blocking calls (socket ``recv``/``accept``, ``device_put``,
  unbounded ``queue.get()``, seeded patterns), with sites;
* ``self.X`` attribute mutations (the race rule's input), annotated
  with the tokens held at the mutation site;

— then two fixpoints fold the call graph through them:

* :attr:`Summaries.trans_locks` — every lock token a function may
  acquire TRANSITIVELY (itself or any callee), each with the concrete
  acquisition site.  The lock-order rule turns "call made while
  holding T" + "callee transitively acquires L" into a T→L edge
  naming both sites, across any number of modules.
* :attr:`Summaries.trans_blocking` — every blocking call a function
  may transitively reach, depth-bounded so a diagnostics chain stays
  reviewable (a ``recv`` five layers down is an architecture note,
  not an actionable lint finding).

Token normalization (``C.attr`` / ``mod.py:name`` / ``C.rw`` rank
tokens) lives here too — it is shared by the rules, the race pass and
the witness-coverage report, and the token grammar MATCHES the
runtime witness rank names: a lock built as ``TrackedLock("<rank>")``
(or ``RWLock(name="<rank>")``) is named by that rank wherever it is
acquired — through ``self.X``, through a member object, or through a
getter that returns one (``self._sid_lock(sid)`` →
``SessionManager._sid_locks[]``) — which is what makes static↔dynamic
reconciliation a set comparison.

Recursion terminates by construction: both fixpoints only ever GROW
per-function sets drawn from finite universes (tokens, sites), so a
cycle in the call graph converges instead of recursing.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from netsdb_tpu_torch.analysis.callgraph import (CallGraph, FuncKey,
                                                 callgraph)
from netsdb_tpu_torch.analysis.lint import Module, Project, terminal_name

#: terminal names that denote a lock when used as ``with <expr>:``
_LOCK_NAME_RE = re.compile(
    r"(^|_)(lock|lk|mu|mutex)$|_mu$|_lock$|^mu$|^lock$")

#: constructor call names whose assignment marks ``self.X`` as a lock
LOCK_CTORS = {"Lock", "RLock", "RWLock", "TrackedLock", "TrackedRLock",
              "witness_lock"}

#: method names that block on I/O or another thread (``device_put``
#: is the reference's synchronous upload, kept so the two analysers
#: read the same fixtures alike; the port's own synchronous uploads
#: are matched by :func:`sync_upload_what`)
BLOCKING_METHODS = {"recv", "recv_into", "recvmsg", "accept",
                    "device_put"}
#: seeded site-specific blocking patterns: (receiver terminal, method)
BLOCKING_SEEDED = {("po", "append")}
#: receiver terminal names treated as queues for the .get() check
_QUEUE_RECV_RE = re.compile(r"(^|_)q(ueue)?s?$|queue")

#: how many call hops a blocking site may propagate up-stack before
#: it stops contributing interprocedural findings
BLOCKING_DEPTH_CAP = 3


def is_lock_name(name: Optional[str]) -> bool:
    return bool(name) and bool(_LOCK_NAME_RE.search(name))


def _ctor_rank(value: ast.AST) -> Optional[str]:
    """The rank a lock constructor names — ``TrackedLock("<rank>")``,
    ``TrackedRLock("<rank>")``, ``RWLock(name="<rank>")`` (also behind
    ``field(default_factory=lambda: ...)``) — or None."""
    if isinstance(value, ast.Call) \
            and terminal_name(value.func) == "field":
        for kw in value.keywords:
            if kw.arg == "default_factory" \
                    and isinstance(kw.value, ast.Lambda):
                return _ctor_rank(kw.value.body)
        return None
    if not (isinstance(value, ast.Call)
            and terminal_name(value.func) in LOCK_CTORS):
        return None
    args = list(value.args[:1]) + [kw.value for kw in value.keywords
                                   if kw.arg == "name"]
    for a in args:
        if isinstance(a, ast.Constant) and isinstance(a.value, str):
            return a.value
    return None


def rank_index(project: Project) -> Dict[Tuple[str, str], str]:
    """``(class, attr)`` → the rank a ``self.attr = TrackedLock("<rank>")``
    (or a dataclass lock field) names, and ``(class, method)`` → the rank
    of the lock a getter method builds and returns (``return
    self._locks.setdefault(k, TrackedLock("<rank>"))``). A pair that
    names two ranks is left out: its token falls back to the grammar."""
    def build() -> Dict[Tuple[str, str], str]:
        idx: Dict[Tuple[str, str], Set[str]] = {}
        for mod in project.modules:
            if mod.tree is None:
                continue
            for cls_name, fn in mod.functions():
                if cls_name is None:
                    continue
                for node in ast.walk(fn):
                    if isinstance(node, ast.Assign):
                        rank = _ctor_rank(node.value)
                        if rank is None:
                            continue
                        for t in node.targets:
                            if isinstance(t, ast.Attribute) \
                                    and isinstance(t.value, ast.Name) \
                                    and t.value.id == "self":
                                idx.setdefault((cls_name, t.attr),
                                               set()).add(rank)
                    elif isinstance(node, ast.Return) \
                            and node.value is not None:
                        for sub in ast.walk(node.value):
                            rank = _ctor_rank(sub)
                            if rank is not None:
                                idx.setdefault((cls_name, fn.name),
                                               set()).add(rank)
            for node in mod.walk():
                if not isinstance(node, ast.ClassDef):
                    continue
                for stmt in node.body:
                    if isinstance(stmt, ast.AnnAssign) \
                            and stmt.value is not None \
                            and isinstance(stmt.target, ast.Name):
                        rank = _ctor_rank(stmt.value)
                        if rank is not None:
                            idx.setdefault((node.name, stmt.target.id),
                                           set()).add(rank)
        return {k: next(iter(v)) for k, v in idx.items() if len(v) == 1}

    return project.cached("rank_index", build)


def lock_attr_index(project: Project) -> Dict[str, Set[str]]:
    """attr name → set of class names assigning a lock to ``self.X``
    (constructor calls and ``dataclasses.field(default_factory=
    threading.Lock)`` defaults)."""
    def build() -> Dict[str, Set[str]]:
        idx: Dict[str, Set[str]] = {}
        for mod in project.modules:
            if mod.tree is None:
                continue
            for cls_name, fn in mod.functions():
                if cls_name is None:
                    continue
                for node in ast.walk(fn):
                    if not isinstance(node, ast.Assign):
                        continue
                    if not assigns_lock(node.value):
                        continue
                    for t in node.targets:
                        if isinstance(t, ast.Attribute) \
                                and isinstance(t.value, ast.Name) \
                                and t.value.id == "self":
                            idx.setdefault(t.attr, set()).add(cls_name)
            # dataclass fields: append_mu: Any = field(
            #     default_factory=threading.Lock)
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                for stmt in node.body:
                    if isinstance(stmt, ast.AnnAssign) \
                            and stmt.value is not None \
                            and isinstance(stmt.target, ast.Name) \
                            and _field_factory_is_lock(stmt.value):
                        idx.setdefault(stmt.target.id,
                                       set()).add(node.name)
        return idx

    return project.cached("lock_attr_index", build)


def assigns_lock(value: ast.AST) -> bool:
    if isinstance(value, ast.Call):
        t = terminal_name(value.func)
        if t in LOCK_CTORS:
            return True
        return _field_factory_is_lock(value)
    return False


def _field_factory_is_lock(value: ast.AST) -> bool:
    if not (isinstance(value, ast.Call)
            and terminal_name(value.func) == "field"):
        return False
    for kw in value.keywords:
        if kw.arg != "default_factory":
            continue
        target = kw.value
        # field(default_factory=lambda: TrackedLock("rank"))
        if isinstance(target, ast.Lambda) \
                and isinstance(target.body, ast.Call):
            target = target.body.func
        if terminal_name(target) in LOCK_CTORS:
            return True
    return False


def self_path(expr: ast.AST) -> Optional[str]:
    """The dotted source path of a ``self``-rooted attribute chain
    (``self._a``, ``self._a.cache``), or None for anything else.
    Instance qualifiers and call receivers share this spelling so the
    race rule can compare them with string equality."""
    parts: List[str] = []
    cur = expr
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name) and cur.id == "self" and parts:
        return ".".join(["self"] + list(reversed(parts)))
    return None


def base_token(token: str) -> str:
    """Strip the instance qualifier (``C.mu@self._a`` → ``C.mu``).
    Rank consumers (lock-order edges, witness reconciliation) operate
    on lock LEVELS, where every instance of a class is one rank; only
    the race rule's coverage check is instance-sensitive."""
    return token.split("@", 1)[0]


def token_qualifier(token: str) -> Optional[str]:
    """The instance qualifier of a token (``C.mu@self._a`` →
    ``self._a``), or None for an unqualified rank."""
    if "@" in token:
        return token.split("@", 1)[1]
    return None


def lock_token(expr: ast.AST, cls: Optional[str], mod: Module,
               aliases: Dict[str, ast.AST],
               attr_index: Dict[str, Set[str]],
               _depth: int = 0,
               ranks: Optional[Dict[Tuple[str, str], str]] = None
               ) -> Optional[str]:
    """Normalize a ``with`` context expression to a rank token, or
    None when it doesn't look like a lock.

    Acquisitions through a member object (``with self._a.mu:``) carry
    an ``@self._a`` instance qualifier: ``self._a.mu`` and
    ``self._b.mu`` are the same rank but DIFFERENT locks, and the race
    rule must not let one cover mutations guarded by the other.  Bare
    ``self.mu`` stays unqualified (``C.mu``).

    ``ranks`` (:func:`rank_index`) renames a lock whose constructor
    names its rank to that rank, so the token is the witness's own."""
    if _depth > 3:
        return None
    ranks = ranks or {}
    # rw.read() / rw.write() → the owner class's rw rank (each
    # relation class is its own lock level; collapsing them all into
    # one "RWLock" rank mixes read-only and write-append usage of
    # DIFFERENT lock families and manufactures cycles)
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute):
        if expr.func.attr in ("read", "write"):
            base = expr.func.value
            bt = terminal_name(base)
            if not (bt == "rw" or (bt or "").endswith("rw")):
                return None
            if isinstance(base, ast.Attribute) \
                    and isinstance(base.value, ast.Name) \
                    and base.value.id == "self" and cls:
                return f"{cls}.rw"
            owners = attr_index.get("rw", set())
            qual = self_path(base.value) \
                if isinstance(base, ast.Attribute) else None
            if len(owners) == 1:
                tok = f"{next(iter(owners))}.rw"
            else:
                tok = "*.rw"  # ambiguous owner: contributes no edges
            return f"{tok}@{qual}" if qual else tok
        # self._set_lock(db, s) style: a method returning a lock
        if isinstance(expr.func.value, ast.Name) \
                and expr.func.value.id == "self" and cls \
                and (cls, expr.func.attr) in ranks:
            return ranks[(cls, expr.func.attr)]
        if is_lock_name(expr.func.attr) or expr.func.attr.endswith(
                ("_lock", "_mu")):
            owner = None
            if isinstance(expr.func.value, ast.Name) \
                    and expr.func.value.id == "self" and cls:
                owner = cls
            name = expr.func.attr
            # the per-set-lock idiom: a getter named _set_lock maps to
            # the instance-family rank C._set_locks[]
            if name.startswith("_set_lock"):
                return f"{owner or '*'}._set_locks[]"
            return f"{owner or '*'}.{name}()"
        return None
    if isinstance(expr, ast.Call):  # Lock() inline — anonymous, skip
        return None
    if isinstance(expr, ast.Attribute):
        name = expr.attr
        if not is_lock_name(name):
            return None
        base = expr.value
        if isinstance(base, ast.Name) and base.id == "self" and cls:
            return ranks.get((cls, name), f"{cls}.{name}")
        owners = attr_index.get(name, set())
        if len(owners) == 1:
            owner = next(iter(owners))
            tok = ranks.get((owner, name), f"{owner}.{name}")
        else:
            tok = f"*.{name}"
        qual = self_path(base)
        return f"{tok}@{qual}" if qual else tok
    if isinstance(expr, ast.Name):
        if expr.id in aliases:
            return lock_token(aliases[expr.id], cls, mod, aliases,
                              attr_index, _depth + 1, ranks)
        if is_lock_name(expr.id):
            return f"{mod.rel}:{expr.id}"
        return None
    return None


def token_owner(token: str) -> Optional[str]:
    """The owner class of a rank token (``SetStore._lock`` →
    ``SetStore``; a witness rank with a layer prefix,
    ``serve.HAState._mu`` → ``HAState``), or None for module-level /
    wildcard tokens."""
    if token.startswith("*.") or ":" in token or "." not in token:
        return None
    return token.rsplit(".", 1)[0].rsplit(".", 1)[-1]


def _names_device(node: ast.AST) -> bool:
    """Whether an argument reads as a device: ``device``/``dev``-named
    values, ``torch.device(...)``, or a ``"cuda..."`` string."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and node.value.startswith("cuda")
    if isinstance(node, ast.Call):
        return terminal_name(node.func) == "device"
    name = terminal_name(node)
    return bool(name) and ("device" in name.lower() or name == "dev")


def sync_upload_what(call: ast.Call) -> Optional[str]:
    """The port's synchronous host-to-device upload, the counterpart of
    the reference's ``device_put``: ``x.to(<device>)``, ``x.cuda()`` and
    ``torch.as_tensor(..., device=...)`` (also ``torch.tensor``), unless
    ``non_blocking=True`` asks for an asynchronous copy or the target is
    the literal ``"cpu"`` (a download). Returns the label, or None."""
    f = call.func
    name = terminal_name(f)
    if any(kw.arg == "non_blocking" and not (
            isinstance(kw.value, ast.Constant) and not kw.value.value)
           for kw in call.keywords):
        return None
    kws = {kw.arg: kw.value for kw in call.keywords if kw.arg}
    dev = kws.get("device")
    if isinstance(dev, ast.Constant) and dev.value in (None, "cpu"):
        return None
    if name == "cuda" and isinstance(f, ast.Attribute):
        return "cuda()"
    if name == "to" and isinstance(f, ast.Attribute):
        if "device" in kws or (call.args and _names_device(call.args[0])):
            return "to(<device>)"
        return None
    if name in ("as_tensor", "tensor") and isinstance(f, ast.Attribute) \
            and terminal_name(f.value) == "torch" and dev is not None:
        return f"torch.{name}(device=)"
    return None


def blocking_what(call: ast.Call) -> Optional[str]:
    """The human label of a blocking call, or None. Shared by the
    lexical rule and the transitive summary so the two can never
    disagree about what counts as blocking."""
    f = call.func
    name = terminal_name(f)
    if name is None:
        return None
    recv = terminal_name(f.value) if isinstance(f, ast.Attribute) \
        else None
    if name in BLOCKING_METHODS:
        return f"{name}()"
    upload = sync_upload_what(call)
    if upload is not None:
        return f"{upload} (a synchronous upload)"
    if recv is not None and (recv, name) in BLOCKING_SEEDED:
        return f"{recv}.{name}() (PagedObjects.append waits on " \
               f"the relation's stream locks)"
    if name == "get" and recv is not None \
            and _QUEUE_RECV_RE.search(recv):
        kws = {kw.arg for kw in call.keywords}
        nonblocking = "timeout" in kws or any(
            kw.arg == "block" and isinstance(kw.value, ast.Constant)
            and kw.value.value is False for kw in call.keywords) \
            or len(call.args) >= 2 \
            or (len(call.args) == 1 and isinstance(
                call.args[0], ast.Constant)
                and call.args[0].value is False)
        if not nonblocking:
            return f"{recv}.get() without a timeout"
    return None


def _loop_lock_elems(fn: ast.AST) -> Dict[str, ast.AST]:
    """Loop variable → the element expression of the list it iterates,
    for ``for X in NAME`` (or ``reversed``/``sorted``/``list`` of it)
    where ``NAME = [<elt> for ...]`` in the same function."""
    comps = {node.targets[0].id: node.value for node in ast.walk(fn)
             if isinstance(node, ast.Assign) and len(node.targets) == 1
             and isinstance(node.targets[0], ast.Name)
             and isinstance(node.value, ast.ListComp)}
    out: Dict[str, ast.AST] = {}
    if not comps:
        return out
    for node in ast.walk(fn):
        if not (isinstance(node, (ast.For, ast.AsyncFor))
                and isinstance(node.target, ast.Name)):
            continue
        it = node.iter
        if isinstance(it, ast.Call) and terminal_name(it.func) \
                in ("reversed", "sorted", "list") and it.args:
            it = it.args[0]
        if isinstance(it, ast.Name) and it.id in comps:
            out[node.target.id] = comps[it.id].elt
    return out


class CallSite:
    """One resolved call, with the lock context held at the site.

    ``receiver`` is the dotted ``self``-rooted path of the call's
    receiver (``self._a.step()`` → ``"self._a"``), or None — the race
    rule matches it against instance qualifiers on held tokens to
    decide whether a member-object lock covers the callee subtree."""

    __slots__ = ("callee", "line", "held", "receiver")

    def __init__(self, callee: FuncKey, line: int,
                 held: Tuple[str, ...],
                 receiver: Optional[str] = None):
        self.callee = callee
        self.line = line
        self.held = held
        self.receiver = receiver


class FnFacts:
    """One function's directly-observable concurrency facts."""

    __slots__ = ("key", "acquired", "lex_edges", "calls", "blocking",
                 "mutations")

    def __init__(self, key: FuncKey):
        self.key = key
        #: token → (rel, line) of the first lexical acquisition
        self.acquired: Dict[str, Tuple[str, int]] = {}
        #: (outer, inner, line) lexical nesting edges
        self.lex_edges: List[Tuple[str, str, int]] = []
        #: resolved call sites with held-lock context
        self.calls: List[CallSite] = []
        #: (what, line, held-at-site) direct blocking calls
        self.blocking: List[Tuple[str, int, Tuple[str, ...]]] = []
        #: (attr, line, held-at-site) ``self.X`` mutations
        self.mutations: List[Tuple[str, int, Tuple[str, ...]]] = []


class Summaries:
    """All per-function facts plus the transitive fixpoints."""

    def __init__(self, project: Project, graph: CallGraph):
        self.project = project
        self.graph = graph
        self.attr_index = lock_attr_index(project)
        self.ranks = rank_index(project)
        self.facts: Dict[FuncKey, FnFacts] = {}
        for info in graph.functions.values():
            self.facts[info.key] = self._collect(info)
        #: token → (rel, line): every token a function may acquire
        #: transitively, with the CONCRETE acquisition site
        self.trans_locks: Dict[FuncKey,
                               Dict[str, Tuple[str, int]]] = {}
        #: what → (rel, line, depth): transitively reachable blocking
        #: calls, depth 0 = in the function itself
        self.trans_blocking: Dict[FuncKey,
                                  Dict[str, Tuple[str, int, int]]] = {}
        self._fix_locks()
        self._fix_blocking()

    # --- single-function walk ----------------------------------------
    def _collect(self, info) -> FnFacts:
        facts = FnFacts(info.key)
        mod, cls, fn = info.mod, info.cls, info.node
        aliases = info.aliases()

        # ``for lk in locks: lk.acquire()`` over ``locks = [self.
        # _sid_lock(s) for s in ...]``: the loop variable names the
        # comprehension's lock, so it takes that lock's rank (the map is
        # built only for a function that acquires through a bare name)
        loop_elems: Optional[Dict[str, ast.AST]] = None

        def loop_elem(name: str) -> Optional[ast.AST]:
            nonlocal loop_elems
            if loop_elems is None:
                loop_elems = _loop_lock_elems(fn)
            return loop_elems.get(name)

        def tok(expr: ast.AST) -> Optional[str]:
            t = lock_token(expr, cls, mod, aliases, self.attr_index,
                           ranks=self.ranks)
            if isinstance(expr, ast.Name) \
                    and (t is None or t.startswith(f"{mod.rel}:")):
                elem = loop_elem(expr.id)
                if elem is not None:
                    t = lock_token(elem, cls, mod, aliases,
                                   self.attr_index, ranks=self.ranks) or t
            return t

        # explicit ``X.acquire()`` calls (the try/finally idiom a
        # ``with`` cannot express, e.g. around a generator yield):
        # conservatively held from the acquire line to function end
        explicit: List[Tuple[str, int]] = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "acquire":
                t = tok(node.func.value)
                if t is not None:
                    explicit.append((t, node.lineno))
                    facts.acquired.setdefault(t, (mod.rel,
                                                  node.lineno))

        def full_held(node: ast.AST,
                      held: List[Tuple[str, int]]) -> Tuple[str, ...]:
            line = getattr(node, "lineno", 0)
            toks = [t for t, _ in held]
            toks += [t for t, al in explicit
                     if al < line and t not in toks]
            return tuple(toks)

        def note_call(node: ast.Call, held: List[Tuple[str, int]]):
            callee = self.graph.resolve(mod, cls, node.func, aliases)
            held_toks = full_held(node, held)
            if callee is not None:
                receiver = self_path(node.func.value) \
                    if isinstance(node.func, ast.Attribute) else None
                facts.calls.append(CallSite(callee, node.lineno,
                                            held_toks, receiver))
            what = blocking_what(node)
            if what is not None:
                facts.blocking.append((what, node.lineno, held_toks))

        def flat_targets(t: ast.AST):
            # tuple/list unpacking: self.a, self.b = ... mutates both
            if isinstance(t, (ast.Tuple, ast.List)):
                for el in t.elts:
                    yield from flat_targets(el)
            elif isinstance(t, ast.Starred):
                yield from flat_targets(t.value)
            else:
                yield t

        def note_mutation(node: ast.AST, held: List[Tuple[str, int]]):
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AugAssign):
                targets = [node.target]
            elif isinstance(node, ast.AnnAssign) \
                    and node.value is not None:
                targets = [node.target]
            held_toks = full_held(node, held)
            for raw in targets:
                for t in flat_targets(raw):
                    # self.X = / self.X[k] = — unwrap one subscript
                    if isinstance(t, ast.Subscript):
                        t = t.value
                    if isinstance(t, ast.Attribute) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id == "self":
                        facts.mutations.append((t.attr, node.lineno,
                                                held_toks))

        def visit(node: ast.AST, held: List[Tuple[str, int]]):
            if node is not fn and isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
                return  # nested defs get their own FnFacts
            if isinstance(node, (ast.With, ast.AsyncWith)):
                new_held = list(held)
                for item in node.items:
                    # the context expression evaluates under OUTER
                    for sub in ast.walk(item.context_expr):
                        if isinstance(sub, ast.Call):
                            note_call(sub, held)
                    t = tok(item.context_expr)
                    if t is None:
                        continue
                    facts.acquired.setdefault(
                        t, (mod.rel, item.context_expr.lineno))
                    outers = [o for o, _line in new_held]
                    outers += [o for o, al in explicit
                               if al < item.context_expr.lineno
                               and o not in outers]
                    for outer in outers:
                        if outer != t:  # re-entrant same-rank: no edge
                            facts.lex_edges.append(
                                (outer, t, item.context_expr.lineno))
                    new_held.append((t, item.context_expr.lineno))
                for sub in node.body:
                    visit(sub, new_held)
                return
            if isinstance(node, ast.Call):
                note_call(node, held)
            if isinstance(node, (ast.Assign, ast.AugAssign,
                                 ast.AnnAssign)):
                note_mutation(node, held)
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        visit(fn, [])
        return facts

    # --- fixpoints ----------------------------------------------------
    def _fix_locks(self) -> None:
        for key, facts in self.facts.items():
            self.trans_locks[key] = dict(facts.acquired)
        changed = True
        while changed:
            changed = False
            for key, facts in self.facts.items():
                mine = self.trans_locks[key]
                for site in facts.calls:
                    for tok_, where in self.trans_locks.get(
                            site.callee, {}).items():
                        if tok_ not in mine:
                            mine[tok_] = where
                            changed = True

    def _fix_blocking(self) -> None:
        for key, facts in self.facts.items():
            self.trans_blocking[key] = {
                what: (key[0], line, 0)
                for what, line, _held in facts.blocking}
        changed = True
        while changed:
            changed = False
            for key, facts in self.facts.items():
                mine = self.trans_blocking[key]
                for site in facts.calls:
                    for what, (rel, line, depth) in \
                            self.trans_blocking.get(site.callee,
                                                    {}).items():
                        if depth + 1 > BLOCKING_DEPTH_CAP:
                            continue
                        cur = mine.get(what)
                        if cur is None or depth + 1 < cur[2]:
                            mine[what] = (rel, line, depth + 1)
                            changed = True


def summaries(project: Project) -> Summaries:
    """The per-run shared instance (built once, cached)."""
    return project.cached(
        "summaries", lambda: Summaries(project, callgraph(project)))
