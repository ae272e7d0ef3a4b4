"""Static shared-state race rule over thread-root reachability.

The worker runtime is threads over shared objects (staging workers,
trace shippers, follower mirrors, scheduler installers, telemetry
daemons).  The lock rules catch *misordered* locking; this rule
catches *missing* locking: an attribute of a shared object mutated
from two different concurrent entry points where at least one
mutating path holds no tracked lock covering the owner class.

Semantics (``netsdb_tpu_torch/docs/ANALYSIS.md`` — "Interprocedural
analysis"):

* **Shared classes** — the audited hierarchy's owner classes
  (:data:`SHARED_SEED`, the classes whose rank tokens appear in the
  lock table) plus any class that assigns a tracked/threading lock to
  ``self`` (owning a lock is a declaration that instances are
  shared).
* **Mutation** — ``self.X = / += / self.X[k] =`` in any method other
  than construction (``__init__``/``__post_init__``), where ``X`` is
  not itself a lock attribute.
* **Thread roots** — resolved ``threading.Thread(target=...)`` /
  executor ``submit(...)`` entry points from the call graph.
* **Covering lock** — a rank token whose owner class is the mutated
  object's class (``SetStore._lock`` covers ``SetStore``, and the
  witness rank ``serve.HAState._mu`` covers ``HAState``).
  Coverage is path-sensitive: a root's path into the mutating method
  is *covered* when some call site along it (or the mutation site
  itself) holds a covering token.

A finding fires when ≥ 2 distinct thread roots reach mutations of one
``Class.attr`` AND at least one root reaches a mutation over a fully
uncovered path.  Single-threaded mutation (construction, test-only
use) never fires; a lock-protected twin of a racy class never fires —
both shapes are pinned by fixtures.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set, Tuple

from netsdb_tpu_torch.analysis.callgraph import FuncKey, fmt_key
from netsdb_tpu_torch.analysis.lint import (Diagnostic, Project, Rule,
                                            register, set_gauge)
from netsdb_tpu_torch.analysis.summaries import (Summaries, base_token,
                                                 is_lock_name, summaries,
                                                 token_owner,
                                                 token_qualifier)

#: owner classes of the audited lock hierarchy
#: (netsdb_tpu_torch/docs/ANALYSIS.md) — instances of these are shared
#: across threads BY DESIGN, so every unlocked mutation path is
#: suspect. The reference's owners plus the port's own: the session
#: manager and its table and arena, the decode batcher and runtime,
#: the scheduler, the shard pool's inbox, the rebalancer, the
#: placement map, the HA state and the durable mutation log.
SHARED_SEED = (
    "SetStore", "_StoredSet", "PagedObjects", "PagedColumns",
    "_PagedMatrix", "DeviceBlockCache", "_PyPageBackend",
    "PagedTensorStore", "ServeController", "_FollowerLink",
    "_IdempotencyCache", "RemoteClient", "ChaosInjector",
    "LaneScheduler", "CoalesceTable", "AffinityGate",
    "TraceRing", "ResourceLedger", "SlowQueryLog",
    "TelemetryHistory", "SLOEngine", "OperatorLedger",
    "SessionManager", "SessionTable", "SessionArena", "DecodeBatcher",
    "DecodeRuntime", "QueryScheduler", "ShuffleInbox", "ShardPool",
    "Rebalancer", "PlacementMap", "HAState", "MutationLog",
)

#: methods that are construction / teardown, not concurrent mutation
_CONSTRUCTION = {"__init__", "__post_init__", "__new__",
                 "__init_subclass__"}


def _covers(token: str, cls: str,
            receiver: Optional[str]) -> bool:
    """Does a held ``token`` cover class ``cls`` at a call site whose
    receiver path is ``receiver``?  Unqualified ranks cover the whole
    class; an instance-qualified rank (``C.mu@self._a``) covers only
    calls dispatched on that same instance path (or a member of it —
    ``self._a.inner.step()`` stays under ``self._a``'s lock)."""
    if token_owner(base_token(token)) != cls:
        return False
    qual = token_qualifier(token)
    if qual is None:
        return True
    return receiver is not None and (
        receiver == qual or receiver.startswith(qual + "."))


def _reach(S: Summaries, root: FuncKey,
           uncovered_for: Optional[str] = None) -> Set[FuncKey]:
    """Call-graph reachability from ``root`` with the CONSTRUCTION
    BARRIER (an object still inside ``__init__`` is thread-local, so
    its helpers' writes are not shared-state mutations — paths never
    continue through construction methods).

    With ``uncovered_for=C``, additionally prune every call site
    holding a lock token covering owner class ``C`` — the callee runs
    entirely inside the ``with``, so the whole subtree below a
    covered site is covered. The result is then the set of functions
    some path reaches with NO covering lock held.

    Coverage is INSTANCE-SENSITIVE for member-object locks: a token
    qualified ``C.mu@self._a`` only covers a call whose receiver is
    that same instance path (``self._a.step()``) — holding
    ``self._a.mu`` says nothing about the ``C`` instance behind
    ``self._b``. Unqualified tokens (``C.mu`` from ``with self.mu:``)
    keep their class-wide coverage."""
    seen: Set[FuncKey] = {root}
    stack = [root]
    while stack:
        cur = stack.pop()
        if cur[2] in _CONSTRUCTION and cur != root:
            continue
        facts = S.facts.get(cur)
        if facts is None:
            continue
        for site in facts.calls:
            if uncovered_for is not None and any(
                    _covers(t, uncovered_for, site.receiver)
                    for t in site.held):
                continue
            if site.callee not in seen:
                seen.add(site.callee)
                stack.append(site.callee)
    return seen


@register
class SharedStateRaceRule(Rule):
    """Attributes of shared objects mutated from ≥2 thread roots with
    at least one uncovered mutating path."""

    id = "shared-state-race"
    rationale = ("state mutated from two thread roots with no "
                 "covering lock on some path is a data race waiting "
                 "for the scheduler to expose it")

    def check_project(self, project: Project) -> Iterable[Diagnostic]:
        S = summaries(project)
        G = S.graph
        shared: Set[str] = set(SHARED_SEED)
        for owners in S.attr_index.values():
            shared |= owners
        lock_attrs: Dict[str, Set[str]] = {}
        for attr, owners in S.attr_index.items():
            for cls in owners:
                lock_attrs.setdefault(cls, set()).add(attr)

        # (class, attr) → [(FuncKey, line, held)]
        sites: Dict[Tuple[str, str],
                    List[Tuple[FuncKey, int, Tuple[str, ...]]]] = {}
        for key, facts in S.facts.items():
            cls = key[1]
            if cls is None or cls not in shared \
                    or key[2] in _CONSTRUCTION:
                continue
            for attr, line, held in facts.mutations:
                if attr in lock_attrs.get(cls, ()) \
                        or is_lock_name(attr):
                    continue
                sites.setdefault((cls, attr), []).append(
                    (key, line, held))

        findings = 0
        #: (root, owner) → uncovered reachability, computed lazily
        unc_cache: Dict[Tuple[FuncKey, str], Set[FuncKey]] = {}
        #: root → construction-barrier reachability, computed lazily
        reach_cache: Dict[FuncKey, Set[FuncKey]] = {}

        def reach(root: FuncKey) -> Set[FuncKey]:
            if root not in reach_cache:
                reach_cache[root] = _reach(S, root)
            return reach_cache[root]

        for (cls, attr), muts in sorted(sites.items()):
            methods = {key for key, _line, _held in muts}
            roots = [r for r in G.thread_roots.values()
                     if any(m in reach(r.key) for m in methods)]
            if len(roots) < 2:
                continue
            for key, line, held in muts:
                # the mutated object is always ``self``, so a member-
                # object lock (``C.mu@self._a``) guards a DIFFERENT
                # instance and never covers the site
                if any(token_qualifier(t) is None
                       and token_owner(t) == cls for t in held):
                    continue  # the mutation site itself is covered
                bad_roots = []
                for r in roots:
                    ck = (r.key, cls)
                    if ck not in unc_cache:
                        unc_cache[ck] = _reach(S, r.key,
                                               uncovered_for=cls)
                    if key in unc_cache[ck]:
                        bad_roots.append(r)
                if not bad_roots:
                    continue
                mod = project.module(key[0])
                if mod is not None and mod.suppressed(self.id, line):
                    # inline-suppressed (documented reason): run_lint
                    # would drop it anyway — keep the exported gauge
                    # agreeing with what lint actually reports
                    continue
                findings += 1
                root_names = ", ".join(sorted(
                    fmt_key(r.key) for r in roots))
                spawn = bad_roots[0].sites[0] \
                    if bad_roots[0].sites else ("?", 0)
                yield Diagnostic(
                    rule=self.id, path=key[0], line=line, col=0,
                    message=f"{cls}.{attr} is mutated here with no "
                            f"{cls} lock held, yet it is reachable "
                            f"from {len(roots)} thread roots "
                            f"({root_names}) — e.g. the root spawned "
                            f"at {spawn[0]}:{spawn[1]} reaches this "
                            f"mutation over a lock-free path; guard "
                            f"the write or document why it is safe")
        set_gauge("analysis.race_findings", findings)
