"""Lock-ordering and holds-across-blocking-call rules, INTERPROCEDURAL
over the project call graph (the port's
``netsdb_tpu/analysis/rules/locking.py``).

The rules stand on ``analysis/callgraph.py`` + ``analysis/summaries.py``:
a ``with`` in ``serve/server.py`` that calls into ``storage/devcache.py``
which takes another tracked lock contributes a lock-order edge naming
BOTH sites (the holding call site and the callee's acquisition line),
and a call chain that reaches ``recv``/``queue.get()``/a synchronous
upload while any caller up-stack holds a lock is flagged at the
holding call site — not just when the blocking call is lexically
visible under the ``with``.

Rank tokens, not instances: every per-set serve lock is one rank
(``ServeController._set_locks[]``), every per-set write gate one
(``ServeController._write_gates[]``), every per-session lock one
(``SessionManager._sid_locks[]``), every relation ``RWLock`` one rank
PER OWNER CLASS (``PagedObjects.rw``, ``PagedColumns.rw``,
``_PagedMatrix.rw``) — lock *levels* order, instances don't. Token
normalization lives in ``analysis/summaries.py`` and uses the rank a
``TrackedLock("<rank>")`` names, so the static graph and the witness's
dynamic graph diff cleanly (``lint --witness-coverage``).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set, Tuple

from netsdb_tpu_torch.analysis.callgraph import fmt_key
from netsdb_tpu_torch.analysis.lint import (Diagnostic, Project, Rule,
                                            register)
from netsdb_tpu_torch.analysis.summaries import base_token, summaries

#: the port's audited hierarchy, built from its own tracked ranks (the
#: edges its code takes, read from the static graph and from the
#: witness over the serve, session, pool, replication and store
#: tests). Note the storage direction: ``append_table`` nests
#: append_mu -> store lock, and the ingest / replace paths nest store
#: lock -> relation RWLock; a store lock held across a paged append is
#: the inversion this rule exists to catch.
SEED_EDGES: Tuple[Tuple[str, str], ...] = (
    ("_StoredSet.append_mu", "SetStore._lock"),
    # relation rw ranks are per owner class
    ("SetStore._lock", "PagedObjects.rw"),
    ("SetStore._lock", "PagedColumns.rw"),
    ("SetStore._lock", "_PagedMatrix.rw"),
    ("_StoredSet.append_mu", "PagedObjects.rw"),
    ("_StoredSet.append_mu", "PagedColumns.rw"),
    ("PagedObjects._append_mu", "PagedObjects.rw"),
    ("SetStore._lock", "DeviceBlockCache._mu"),
    ("SetStore._lock", "_PyPageBackend._mu"),
    ("SetStore._lock", "PagedTensorStore._readers_lock"),
    # serve/server.py: a set-scoped frame runs under its per-set lock;
    # a write to a set also holds the set's write gate (a rebalancing
    # seal takes the gate, so no acknowledged append lands past it);
    # mirrored frames take _mirror_lock then _followers_mu, and append
    # to the durable mutation log INSIDE the mirror critical section
    # (log order must equal link FIFO order); the log's lock is a
    # strict leaf. In a joined cluster every mirrored frame, and every
    # read of a set placed over several processes, runs whole under
    # _collective_lock first
    ("ServeController._collective_lock", "ServeController._mirror_lock"),
    ("ServeController._set_locks[]", "ServeController._write_gates[]"),
    ("ServeController._write_gates[]", "SetStore._lock"),
    ("ServeController._set_locks[]", "ServeController._mirror_lock"),
    ("ServeController._mirror_lock", "ServeController._followers_mu"),
    ("ServeController._mirror_lock", "storage.MutationLog._mu"),
    ("serve.ShardPool._mu", "storage.MutationLog._mu"),
    # serve/sessions.py: a GENERATE runs under its set's lock, then the
    # sessions' own locks (sorted by sid), then the session table, the
    # arena and the applied record; a step reads its weights from the
    # store
    ("ServeController._set_locks[]", "SessionManager._sid_locks[]"),
    ("SessionManager._sid_locks[]", "SessionTable._mu"),
    ("SessionManager._sid_locks[]", "SessionArena._mu"),
    ("SessionManager._sid_locks[]", "SessionManager._applied_mu"),
    ("SessionManager._sid_locks[]", "SetStore._lock"),
    # serve/client.py: a placement fetch serializes on its own mutex,
    # then the connection; a chaos-armed send runs under the
    # connection lock (tests only)
    ("RemoteClient._placement_fetch_mu", "RemoteClient._lock"),
    ("RemoteClient._lock", "RemoteClient._placement_mu"),
    ("RemoteClient._lock", "ChaosInjector._mu"),
)

#: modules that IMPLEMENT the primitives (their internals necessarily
#: wait under their own locks)
BLOCKING_EXEMPT = ("netsdb_tpu_torch/utils/locks.py",)


class EdgeSite:
    """Where one lock-order edge was sighted in code."""

    __slots__ = ("rel", "line", "inner_rel", "inner_line", "via")

    def __init__(self, rel: str, line: int,
                 inner_rel: Optional[str] = None,
                 inner_line: Optional[int] = None,
                 via: Optional[str] = None):
        self.rel = rel
        self.line = line
        # for call-through edges: the callee acquisition site
        self.inner_rel = inner_rel
        self.inner_line = inner_line
        self.via = via  # callee key string, for the report

    def describe(self) -> str:
        s = f"{self.rel}:{self.line}"
        if self.inner_rel is not None:
            s += f" (acquired in {self.via} at " \
                 f"{self.inner_rel}:{self.inner_line})"
        return s


def static_lock_edges(project: Project
                      ) -> Dict[Tuple[str, str], Optional[EdgeSite]]:
    """The full static lock-order edge set: seeds (site None until a
    code sighting upgrades them), lexical nesting, and cross-module
    call-through edges derived from the transitive lock summaries.
    Shared by the lock-order rule and the witness-coverage report."""
    def build() -> Dict[Tuple[str, str], Optional[EdgeSite]]:
        S = summaries(project)
        edges: Dict[Tuple[str, str], Optional[EdgeSite]] = {
            e: None for e in SEED_EDGES}

        def note(key: Tuple[str, str], site: EdgeSite) -> None:
            # first CODE sighting wins; it also upgrades a seed's
            # None site so cycle reports name real file:line anchors
            if edges.get(key) is None:
                edges[key] = site

        # instance qualifiers (``C.mu@self._a``) are a RACE-rule
        # refinement; lock ORDER is about ranks, where every instance
        # of a class is one level — strip before edges so the graph
        # keeps matching the runtime witness rank grammar
        for key, facts in S.facts.items():
            for outer, inner, line in facts.lex_edges:
                outer, inner = base_token(outer), base_token(inner)
                if outer != inner:
                    note((outer, inner), EdgeSite(key[0], line))
            for site in facts.calls:
                if not site.held:
                    continue
                callee_locks = S.trans_locks.get(site.callee, {})
                for inner, (irel, iline) in callee_locks.items():
                    inner = base_token(inner)
                    if inner.startswith("*."):
                        continue
                    for outer in site.held:
                        outer = base_token(outer)
                        if inner != outer:
                            note((outer, inner),
                                 EdgeSite(key[0], site.line,
                                          inner_rel=irel,
                                          inner_line=iline,
                                          via=fmt_key(site.callee)))
        return edges

    return project.cached("static_lock_edges", build)


@register
class LockOrderRule(Rule):
    """Cross-module lock-acquisition-order cycles (potential AB/BA
    deadlocks), from lexical nesting + call-graph call-through +
    the seeded hierarchy."""

    id = "lock-order"
    rationale = ("a cycle in the with-lock nesting graph is a potential "
                 "deadlock even if no test ever interleaves it")

    def check_project(self, project: Project) -> Iterable[Diagnostic]:
        edges = static_lock_edges(project)
        # wildcard tokens never join the graph (ambiguous owners would
        # manufacture cycles out of coincidental attribute names)
        graph: Dict[str, Set[str]] = {}
        for (a, b), _site in edges.items():
            if a.startswith("*.") or b.startswith("*."):
                continue
            graph.setdefault(a, set()).add(b)
        for cycle in _find_cycles(graph):
            # anchor the report at the first code-sighted edge in the
            # cycle (a pure-seed cycle anchors at line 1 of this file)
            anchor = None
            for i in range(len(cycle)):
                e = (cycle[i], cycle[(i + 1) % len(cycle)])
                if edges.get(e) is not None:
                    anchor = edges[e]
                    break
            path, line = (anchor.rel, anchor.line) if anchor \
                else ("netsdb_tpu_torch", 1)
            chain = " -> ".join(cycle + [cycle[0]])
            sites = "; ".join(
                f"{a}->{b} at {edges[(a, b)].describe()}"
                for a, b in zip(cycle, cycle[1:] + [cycle[0]])
                if edges.get((a, b)) is not None) or "seeded edges only"
            yield Diagnostic(
                rule=self.id, path=path, line=line, col=0,
                message=f"lock-order cycle {chain} ({sites}) — a "
                        f"thread taking these in one order can "
                        f"deadlock a thread taking the other")


def _find_cycles(graph: Dict[str, Set[str]]) -> List[List[str]]:
    """Elementary cycles via DFS back-edges; each cycle reported once
    (canonical rotation)."""
    seen: Set[Tuple[str, ...]] = set()
    out: List[List[str]] = []

    def dfs(node: str, stack: List[str], on_stack: Set[str],
            visited: Set[str]):
        visited.add(node)
        on_stack.add(node)
        stack.append(node)
        for nxt in sorted(graph.get(node, ())):
            if nxt in on_stack:
                i = stack.index(nxt)
                cycle = stack[i:]
                k = cycle.index(min(cycle))
                canon = tuple(cycle[k:] + cycle[:k])
                if canon not in seen:
                    seen.add(canon)
                    out.append(list(canon))
            elif nxt not in visited:
                dfs(nxt, stack, on_stack, visited)
        stack.pop()
        on_stack.discard(node)

    visited: Set[str] = set()
    for node in sorted(graph):
        if node not in visited:
            dfs(node, [], set(), visited)
    return out


@register
class LockBlockingCallRule(Rule):
    """Blocking calls (socket recv/accept, a synchronous upload,
    queue.get without timeout, seeded patterns) reached while a lock
    is held —
    lexically under the ``with``, or through any resolved call chain
    (the interprocedural extension)."""

    id = "lock-blocking-call"
    rationale = ("a blocking call under a lock turns one slow peer "
                 "into a whole-subsystem stall")

    def check_project(self, project: Project) -> Iterable[Diagnostic]:
        S = summaries(project)
        for key, facts in S.facts.items():
            rel = key[0]
            if rel in BLOCKING_EXEMPT:
                continue
            # lexical: a blocking call textually under the with
            for what, line, held in facts.blocking:
                if not held:
                    continue
                yield Diagnostic(
                    rule=self.id, path=rel, line=line, col=0,
                    message=f"blocking call {what} while holding "
                            f"{', '.join(held)} — a slow peer stalls "
                            f"every waiter on the lock; move the "
                            f"wait outside or bound it")
            # interprocedural: a locked call site whose callee
            # transitively reaches a blocking call
            reported: Set[Tuple[int, str]] = set()
            for site in facts.calls:
                if not site.held:
                    continue
                blk = S.trans_blocking.get(site.callee, {})
                for what, (brel, bline, depth) in sorted(blk.items()):
                    if brel in BLOCKING_EXEMPT:
                        continue
                    if (site.line, what) in reported:
                        continue
                    reported.add((site.line, what))
                    hops = f"{depth + 1} call hop" \
                           f"{'s' if depth else ''} down"
                    yield Diagnostic(
                        rule=self.id, path=rel, line=site.line, col=0,
                        message=f"call into {fmt_key(site.callee)} "
                                f"reaches blocking {what} at "
                                f"{brel}:{bline} ({hops}) while "
                                f"holding {', '.join(site.held)} — "
                                f"a slow peer stalls every waiter on "
                                f"the lock; move the wait outside "
                                f"the lock or bound it")
