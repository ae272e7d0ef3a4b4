"""Project-wide call graph — the interprocedural substrate every
concurrency rule now stands on.

Rules that see one module at a time miss a ``with`` in
``serve/server.py`` that calls into ``storage/devcache.py`` which
takes another tracked lock. This module closes that: one
:class:`CallGraph` per lint run resolving every call site to the
project function it lands in —

* **module imports** — ``import netsdb_tpu_torch.storage.devcache as dc``
  then ``dc.to_device(...)``; ``from netsdb_tpu_torch.plan import staging``
  then ``staging.stage_stream(...)``; dotted chains through package
  ``__init__`` re-exports fall back to a unique-stem match;
* **methods** — ``self.m(...)`` resolves through the enclosing class
  and its project-visible base classes (bounded MRO walk);
  ``ClassName.m(...)`` and ``ClassName(...)`` (constructor →
  ``__init__``);
* **attribute types** — ``self._store.add_data(...)`` resolves via
  the attribute-type index (``self._store = SetStore(...)`` in any
  method of the class names the attr's type; a globally unique owner
  also resolves) — the edge that carries serve/ analysis into
  storage/;
* **one-hop local aliases** — ``fn = self._worker; Thread(target=
  fn)`` and ``st = SetStore(cfg); st.add_data(...)``;
* **``functools.partial``** — unwrapped to its first argument.

On top of resolution the graph derives **thread roots**: every
``threading.Thread(target=...)`` / executor ``submit(...)`` target,
i.e. the entry points whose transitive reachability sets define
"which code can run concurrently with what" — the input to the
static race rule and the witness-coverage report.

Everything is stdlib ``ast``; the graph is built once per
:class:`~netsdb_tpu_torch.analysis.lint.Project` (``project.cached``) and
shared by every rule.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from netsdb_tpu_torch.analysis.lint import (Module, Project, dotted_name,
                                            set_gauge, terminal_name)

#: (module rel path, enclosing class or None, function name) — the
#: identity of one project function; nested defs share the scheme
#: (their enclosing CLASS, not function, is the second element)
FuncKey = Tuple[str, Optional[str], str]


def fmt_key(key: FuncKey) -> str:
    rel, cls, name = key
    return f"{rel}:{cls + '.' if cls else ''}{name}"


class FuncInfo:
    """One project function: where it lives and its AST node."""

    __slots__ = ("key", "mod", "cls", "node", "_aliases")

    def __init__(self, key: FuncKey, mod: Module, cls: Optional[str],
                 node: ast.AST):
        self.key = key
        self.mod = mod
        self.cls = cls
        self.node = node
        self._aliases: Optional[Dict[str, ast.AST]] = None

    def aliases(self) -> Dict[str, ast.AST]:
        """The one-hop local alias map, computed once and shared by
        every pass that resolves this function's call sites (edge
        build, thread roots, summaries)."""
        if self._aliases is None:
            self._aliases = local_aliases(self.node)
        return self._aliases


class ThreadRoot:
    """One concurrent entry point: the resolved target function plus
    every spawn site that launches it."""

    __slots__ = ("key", "sites", "kind")

    def __init__(self, key: FuncKey, kind: str):
        self.key = key
        self.kind = kind  # "thread" | "executor"
        self.sites: List[Tuple[str, int]] = []


def local_aliases(fn: ast.AST) -> Dict[str, ast.AST]:
    """name → RHS for single-target simple assignments in ``fn`` —
    the one-hop alias resolver (``lk = self._set_lock(...)``,
    ``fn = self._worker``)."""
    out: Dict[str, ast.AST] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, (ast.Attribute, ast.Call,
                                            ast.Name)):
            name = node.targets[0].id
            # a name assigned twice is not a stable alias
            out[name] = None if name in out else node.value
    return {k: v for k, v in out.items() if v is not None}


def own_nodes(fn: ast.AST) -> Iterable[ast.AST]:
    """``fn``'s nodes EXCLUDING nested def/class subtrees — nested
    functions are project functions of their own."""
    stack = [fn]
    while stack:
        node = stack.pop()
        if node is not fn and isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef,
                       ast.ClassDef)):
            yield node  # the def node itself (for parent→nested edges)
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


class CallGraph:
    """Resolution indexes + resolved call edges + thread roots."""

    def __init__(self, project: Project):
        self.project = project
        #: FuncKey → FuncInfo for every function/method in the tree
        self.functions: Dict[FuncKey, FuncInfo] = {}
        #: module rel → {local name: dotted module} (import ... as)
        self._imports: Dict[str, Dict[str, str]] = {}
        #: module rel → {local name: (dotted module, original name)}
        self._from_imports: Dict[str, Dict[str, Tuple[str, str]]] = {}
        #: module rel → {class name: [base name strings]}
        self._classes: Dict[str, Dict[str, List[str]]] = {}
        #: class name → [module rels defining it]
        self._class_owners: Dict[str, List[str]] = {}
        #: (module rel, class) → {attr: {type class names}} from
        #: ``self.attr = ClassName(...)`` assignments
        self._attr_types: Dict[Tuple[str, str], Dict[str, Set[str]]] = {}
        #: attr name → {type class names} across the whole project
        self._attr_types_global: Dict[str, Set[str]] = {}
        #: dotted module name → rel path (built lazily)
        self._mod_by_dotted: Dict[str, Optional[str]] = {}
        #: stem (filename sans .py) → [rel paths]
        self._mod_by_stem: Dict[str, List[str]] = {}
        #: caller → [(callee, line)] resolved call edges (lock
        #: context lives in summaries, not here)
        self.calls: Dict[FuncKey, List[Tuple[FuncKey, int]]] = {}
        #: resolved concurrent entry points
        self.thread_roots: Dict[FuncKey, ThreadRoot] = {}
        #: id(expr) → resolution, memoized across the three passes
        #: that visit the same call nodes (edge build, thread roots,
        #: summaries). Safe because an expression node belongs to
        #: exactly one function, so its (cls, aliases) context is
        #: fixed — and the nodes stay alive as long as the cached
        #: Module (and therefore this graph) does.
        self._resolve_memo: Dict[int, Optional[FuncKey]] = {}
        self._build_indexes()
        self._build_edges()
        self._find_thread_roots()

    # --- indexes ------------------------------------------------------
    def _build_indexes(self) -> None:
        # every class first: an attribute's type resolves to a class of
        # any module, whatever order the modules were loaded in
        for mod in self.project.modules:
            if mod.tree is None:
                continue
            for node in mod.walk():
                if isinstance(node, ast.ClassDef):
                    self._class_owners.setdefault(
                        node.name, []).append(mod.rel)
        for mod in self.project.modules:
            if mod.rel.endswith(".py"):
                stem = mod.rel.rsplit("/", 1)[-1][:-3]
                self._mod_by_stem.setdefault(stem, []).append(mod.rel)
            if mod.tree is None:
                continue
            imps: Dict[str, str] = {}
            frm: Dict[str, Tuple[str, str]] = {}
            for node in mod.walk():
                if isinstance(node, ast.Import):
                    for a in node.names:
                        local = a.asname or a.name.split(".")[0]
                        # ``import a.b`` binds ``a`` but the useful
                        # target is the full dotted path — keep both
                        imps[local] = a.name if a.asname else \
                            a.name.split(".")[0]
                        if a.asname is None:
                            imps.setdefault(a.name, a.name)
                elif isinstance(node, ast.ImportFrom) and node.module \
                        and node.level == 0:
                    for a in node.names:
                        if a.name == "*":
                            continue
                        frm[a.asname or a.name] = (node.module, a.name)
            self._imports[mod.rel] = imps
            self._from_imports[mod.rel] = frm
            classes: Dict[str, List[str]] = {}
            for node in mod.walk():
                if isinstance(node, ast.ClassDef):
                    bases = [dotted_name(b) or "" for b in node.bases]
                    classes[node.name] = [b for b in bases if b]
            self._classes[mod.rel] = classes
            for cls, fn in mod.functions():
                key = (mod.rel, cls, fn.name)
                # first definition wins on (rare) collisions between a
                # nested def and a module-level function of one name
                if key not in self.functions:
                    self.functions[key] = FuncInfo(key, mod, cls, fn)
                if cls is None:
                    continue
                for node in ast.walk(fn):
                    if not (isinstance(node, ast.Assign)
                            and len(node.targets) == 1):
                        continue
                    t = node.targets[0]
                    if not (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        continue
                    tname = self._ctor_class_name(mod, node.value)
                    if tname is None:
                        continue
                    self._attr_types.setdefault(
                        (mod.rel, cls), {}).setdefault(
                        t.attr, set()).add(tname)
                    self._attr_types_global.setdefault(
                        t.attr, set()).add(tname)

    def _ctor_class_name(self, mod: Module,
                         value: ast.AST) -> Optional[str]:
        """``ClassName(...)`` (possibly dotted) → the class name when
        it resolves to a project class."""
        if not isinstance(value, ast.Call):
            return None
        name = terminal_name(value.func)
        if name and name in self._class_owners:
            return name
        return None

    def _resolve_module(self, dotted: str) -> Optional[str]:
        """Dotted module name → project rel path, or None."""
        if dotted in self._mod_by_dotted:
            return self._mod_by_dotted[dotted]
        rel = None
        as_path = dotted.replace(".", "/")
        for cand in (as_path + ".py", as_path + "/__init__.py"):
            if self.project.module(cand) is not None:
                rel = cand
                break
        if rel is None:
            # fixtures / flat trees: a unique filename-stem match
            stem = dotted.rsplit(".", 1)[-1]
            owners = self._mod_by_stem.get(stem, ())
            if len(owners) == 1:
                rel = owners[0]
        self._mod_by_dotted[dotted] = rel
        return rel

    def _class_rel(self, cls_name: str,
                   prefer_rel: Optional[str] = None) -> Optional[str]:
        owners = self._class_owners.get(cls_name, ())
        if prefer_rel is not None and prefer_rel in owners:
            return prefer_rel
        if len(owners) == 1:
            return owners[0]
        return None

    def _method(self, rel: str, cls_name: str, name: str,
                _depth: int = 0) -> Optional[FuncKey]:
        """Find method ``name`` on class ``cls_name`` (defined in
        ``rel``), walking project-visible base classes, bounded."""
        if _depth > 4:
            return None
        key = (rel, cls_name, name)
        if key in self.functions:
            return key
        for base in self._classes.get(rel, {}).get(cls_name, ()):  # MRO
            base_name = base.rsplit(".", 1)[-1]
            base_rel = self._class_rel(base_name, prefer_rel=rel)
            if base_rel is None:
                # ``devcache.DeviceBlockCache`` style dotted base
                if "." in base:
                    mod_rel = self._resolve_by_prefix(
                        rel, base.rsplit(".", 1)[0])
                    if mod_rel and (mod_rel, base_name, name) \
                            in self.functions:
                        return (mod_rel, base_name, name)
                continue
            found = self._method(base_rel, base_name, name, _depth + 1)
            if found is not None:
                return found
        return None

    def _resolve_by_prefix(self, rel: str,
                           prefix: str) -> Optional[str]:
        """A dotted prefix (``dc`` / ``netsdb_tpu_torch.plan.staging``)
        seen in module ``rel`` → the module it names, via the import
        maps then the literal dotted path."""
        imps = self._imports.get(rel, {})
        frm = self._from_imports.get(rel, {})
        head = prefix.split(".")[0]
        if prefix in imps:
            return self._resolve_module(imps[prefix])
        if head in imps and head != prefix:
            return self._resolve_module(
                imps[head] + "." + prefix.split(".", 1)[1])
        if prefix in frm:
            dotted_mod, orig = frm[prefix]
            return self._resolve_module(dotted_mod + "." + orig)
        if head in frm and head != prefix:
            dotted_mod, orig = frm[head]
            return self._resolve_module(
                dotted_mod + "." + orig + "." + prefix.split(".", 1)[1])
        return self._resolve_module(prefix)

    # --- call-site resolution -----------------------------------------
    def resolve(self, mod: Module, cls: Optional[str], expr: ast.AST,
                aliases: Dict[str, ast.AST],
                _depth: int = 0) -> Optional[FuncKey]:
        """Resolve a callable expression (a ``Call.func`` or a
        ``target=`` value) to a project :data:`FuncKey`, or None for
        stdlib / unresolvable targets."""
        if _depth == 0:
            memo_key = id(expr)
            if memo_key in self._resolve_memo:
                return self._resolve_memo[memo_key]
            out = self.resolve(mod, cls, expr, aliases, _depth=1)
            self._resolve_memo[memo_key] = out
            return out
        if _depth > 4:
            return None
        # functools.partial(f, ...) → f
        if isinstance(expr, ast.Call) \
                and terminal_name(expr.func) == "partial" and expr.args:
            return self.resolve(mod, cls, expr.args[0], aliases,
                                _depth + 1)
        if isinstance(expr, ast.Name):
            name = expr.id
            if name in aliases:
                return self.resolve(mod, cls, aliases[name], aliases,
                                    _depth + 1)
            if (mod.rel, None, name) in self.functions:
                return (mod.rel, None, name)
            if name in self._classes.get(mod.rel, {}):
                return self._method(mod.rel, name, "__init__")
            frm = self._from_imports.get(mod.rel, {})
            if name in frm:
                dotted_mod, orig = frm[name]
                target_rel = self._resolve_module(dotted_mod)
                if target_rel is not None:
                    if (target_rel, None, orig) in self.functions:
                        return (target_rel, None, orig)
                    if orig in self._classes.get(target_rel, {}):
                        return self._method(target_rel, orig, "__init__")
                # ``from pkg import name`` re-exported through
                # __init__: fall back to a unique project class
                rel2 = self._class_rel(orig)
                if rel2 is not None:
                    return self._method(rel2, orig, "__init__")
            return None
        if not isinstance(expr, ast.Attribute):
            return None
        name = expr.attr
        base = expr.value
        if isinstance(base, ast.Name):
            if base.id == "self" and cls is not None:
                found = self._method(mod.rel, cls, name)
                if found is not None:
                    return found
                # self._attr used as a callable (bound method alias)
                return None
            # ClassName.m(...)
            if base.id in self._classes.get(mod.rel, {}):
                return self._method(mod.rel, base.id, name)
            # local var of known constructor type: st = SetStore(...)
            if base.id in aliases:
                tname = self._alias_type(mod, cls, aliases[base.id],
                                         aliases)
                if tname is not None:
                    rel2 = self._class_rel(tname)
                    if rel2 is not None:
                        return self._method(rel2, tname, name)
                return None
            # imported module (or class) attribute
            target_rel = self._resolve_by_prefix(mod.rel, base.id)
            if target_rel is not None:
                if (target_rel, None, name) in self.functions:
                    return (target_rel, None, name)
                if name in self._classes.get(target_rel, {}):
                    return self._method(target_rel, name, "__init__")
            frm = self._from_imports.get(mod.rel, {})
            if base.id in frm:  # ``from x import C`` then ``C.m(...)``
                _mod, orig = frm[base.id]
                rel2 = self._class_rel(orig)
                if rel2 is not None:
                    return self._method(rel2, orig, name)
            return None
        if isinstance(base, ast.Attribute):
            # self.X.m(...) via the attribute-type index
            if isinstance(base.value, ast.Name) \
                    and base.value.id == "self" and cls is not None:
                owners = self._attr_types.get(
                    (mod.rel, cls), {}).get(base.attr)
                if not owners:
                    owners = self._attr_types_global.get(base.attr)
                if owners and len(owners) == 1:
                    tname = next(iter(owners))
                    rel2 = self._class_rel(tname)
                    if rel2 is not None:
                        return self._method(rel2, tname, name)
                return None
            # a.b.f(...) where a.b names an imported module
            prefix = dotted_name(base)
            if prefix is not None:
                target_rel = self._resolve_by_prefix(mod.rel, prefix)
                if target_rel is not None:
                    if (target_rel, None, name) in self.functions:
                        return (target_rel, None, name)
                    if name in self._classes.get(target_rel, {}):
                        return self._method(target_rel, name,
                                            "__init__")
        return None

    def _alias_type(self, mod: Module, cls: Optional[str],
                    rhs: ast.AST,
                    aliases: Dict[str, ast.AST]) -> Optional[str]:
        """The class name a one-hop alias RHS constructs, if any."""
        if isinstance(rhs, ast.Call):
            tname = terminal_name(rhs.func)
            if tname and tname in self._class_owners:
                return tname
        return None

    # --- edges --------------------------------------------------------
    def _build_edges(self) -> None:
        for info in self.functions.values():
            aliases = info.aliases()
            edges: List[Tuple[FuncKey, int]] = []
            for node in own_nodes(info.node):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) \
                        and node is not info.node:
                    # a nested def is conservatively reachable from
                    # its parent (closures are usually invoked within
                    # or handed to workers the roots pass sees)
                    nested = (info.mod.rel, info.cls, node.name)
                    if nested in self.functions:
                        edges.append((nested, node.lineno))
                    continue
                if not isinstance(node, ast.Call):
                    continue
                callee = self.resolve(info.mod, info.cls, node.func,
                                      aliases)
                if callee is not None:
                    edges.append((callee, node.lineno))
                # callable ARGUMENTS of project functions are treated
                # as potentially invoked by the callee (stage_stream's
                # place fn, executor-style helpers)
                for arg in list(node.args) + [kw.value
                                              for kw in node.keywords]:
                    if isinstance(arg, (ast.Name, ast.Attribute)):
                        cb = self.resolve(info.mod, info.cls, arg,
                                          aliases)
                        if cb is not None and cb != callee:
                            edges.append((cb, node.lineno))
            self.calls[info.key] = edges

    # --- thread roots -------------------------------------------------
    def _find_thread_roots(self) -> None:
        for info in self.functions.values():
            aliases = info.aliases()
            for node in own_nodes(info.node):
                if not isinstance(node, ast.Call):
                    continue
                tname = terminal_name(node.func)
                target: Optional[ast.AST] = None
                kind = None
                if tname == "Thread":
                    for kw in node.keywords:
                        if kw.arg == "target":
                            target, kind = kw.value, "thread"
                elif tname == "submit" \
                        and isinstance(node.func, ast.Attribute) \
                        and node.args:
                    target, kind = node.args[0], "executor"
                if target is None:
                    continue
                key = self.resolve(info.mod, info.cls, target, aliases)
                if key is None:
                    continue
                root = self.thread_roots.get(key)
                if root is None:
                    root = self.thread_roots[key] = ThreadRoot(key,
                                                               kind)
                root.sites.append((info.mod.rel, node.lineno))

    # --- queries ------------------------------------------------------
    # NOTE: thread-root reachability deliberately lives in
    # rules/races.py (its traversal needs the construction barrier
    # and covered-site pruning); a raw barrier-less reachability here
    # would be a trap for future callers.
    def edge_count(self) -> int:
        return sum(len(v) for v in self.calls.values())


def callgraph(project: Project) -> CallGraph:
    """The per-run shared instance (built once, cached)."""
    def build() -> CallGraph:
        graph = CallGraph(project)
        set_gauge("analysis.callgraph_edges", graph.edge_count())
        return graph

    return project.cached("callgraph", build)
