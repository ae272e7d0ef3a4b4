"""Live shard rebalancing — the feedback loop that moves the data: the
port's ``netsdb_tpu/serve/rebalance.py``.

The serve layer's placement map (``serve/placement.py``) fixes slot
COUNT at create time but not slot OWNERSHIP: ``move_slot`` re-owns one
shard slot under an epoch bump. This module is the loop that decides
WHEN to move (a skew detector on the sched-feedback cadence, fed by
the attribution ledger), WHAT to move (a byte-bounded greedy planner,
hottest member → coldest member), and HOW (the RESHARD sub-protocol:
copy the source partition to the destination, write-seal the source,
drain the tail, verify row counts, commit the epoch, drop the source)
— the reference's self-managed placement decisions (Lachesis picks
page placement from observed workload; netsDB's scheduler re-spreads
JobStages over registered workers) grown into live data movement.

**Zero downtime by construction.** A move never takes the set
offline: the source keeps serving READS until the epoch commits (the
copy + seal only block writes to that one slot, answered with the
typed retryable :class:`ShardUnavailable`), and in-flight frames
routed under the old map get the existing typed
:class:`PlacementStale` refresh-and-retry story. Nothing is ever
applied under a revised membership half-way — the commit point is one
``move_slot`` epoch bump, all-or-nothing per move.

**Exactness.** The copy is count-verified: rows at seal time must
equal rows installed at the destination, or the move aborts (source
unsealed, destination clear on the next prepare) and the round ends.
A dropped source leaves a TOMBSTONE: routed frames still riding the
old epoch get ``PlacementStale`` instead of silently applying into a
cleared set. The seal carries a TTL (:data:`SEAL_TTL_S`) so a leader
death mid-move self-heals — the source resumes serving under the
unchanged persisted map once the seal expires.

Formulas here are PINNED — module constants with the exact weights,
pure functions over snapshots — the same test contract discipline as
``serve/sched/feedback.py``. Tests assert against these names; tuning
means editing the constant, not a magic number in a loop body.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple


from netsdb_tpu_torch import obs
from netsdb_tpu_torch.serve import placement as _placement
from netsdb_tpu_torch.serve.protocol import (CODEC_PICKLE, MsgType,
                                             ProtocolError)
from netsdb_tpu_torch.utils.locks import TrackedLock


class MoveAborted(RuntimeError):
    """A slot move failed one of its structural checks (source shrank
    mid-copy, destination count mismatch, placement entry vanished)
    and was unwound. Deliberately NOT a transport error: the abort
    path must never confuse a failed verification with a dead peer."""

# --- pinned formula constants (test contract) -------------------------
#: weight of one admitted request against a set (attribution ledger's
#: ``requests`` metric) in the heat formula
REQUEST_WEIGHT = 1.0
#: weight of one executor chunk folded over the set — streamed scans
#: touch many chunks per request, so a chunk counts a quarter request
CHUNK_WEIGHT = 0.25
#: weight of one staged byte: one MiB of ingest ≈ one request of load
BYTE_WEIGHT = 1.0 / (1 << 20)
#: a feedback window whose TOTAL heat delta is below this floor yields
#: no skew verdict (and resets the streak) — idle pools never trigger
MIN_WINDOW_HEAT = 8.0
#: the planner stops once max/mean heat falls to this ratio — moving
#: past "roughly even" just burns bytes chasing noise. Note a pool of
#: N members whose sets were created at N-1 (one fresh, slot-less
#: daemon) reads N/(N-1) even when ownership is as even as it can
#: get, so this must sit BELOW that floor for the pool sizes the
#: serve layer targets (5 members → 1.25)
SETTLE_RATIO = 1.1
#: write-seal TTL on a move's source slot: a leader that dies between
#: seal and commit leaves the source self-unsealing after this many
#: seconds, resuming service under the unchanged persisted map
SEAL_TTL_S = 60.0
#: bounded move log kept for `cli obs --placement` / RESHARD status
MOVE_LOG = 32

#: (attribution metric, weight) pairs the set-heat formula sums
HEAT_METRICS: Tuple[Tuple[str, float], ...] = (
    ("requests", REQUEST_WEIGHT),
    ("executor.chunks", CHUNK_WEIGHT),
    ("staged_bytes", BYTE_WEIGHT),
)


# --- pure formula functions (snapshots in, numbers out) ---------------
def set_heats(attrib_snapshot: Dict[str, Dict[str, Dict[str, float]]]
              ) -> Dict[str, float]:
    """Per-set load from one attribution-ledger snapshot: for every
    ``db:set`` scope, the HEAT_METRICS-weighted sum across all
    clients. The unattributable ``*`` scope is ignored — it cannot be
    placed."""
    out: Dict[str, float] = {}
    for per_scope in (attrib_snapshot or {}).values():
        for scope, metrics in per_scope.items():
            if scope == "*":
                continue
            h = 0.0
            for name, weight in HEAT_METRICS:
                h += weight * float(metrics.get(name, 0) or 0)
            if h:
                out[scope] = out.get(scope, 0.0) + h
    return out


def addr_heats(entries: Dict[Tuple[str, str], Dict[str, Any]],
               heats: Dict[str, float],
               members: List[str]) -> Dict[str, float]:
    """Per-member load: each set's heat splits evenly over its LIVE
    slots (routing is slot-uniform by construction — hash placement
    by design, range placement by the contiguous ingest split), and a
    member's heat is the sum of its owned shares. Every pool member
    appears — a fresh slot-less daemon reads exactly 0.0, which is
    what makes pool growth look like skew."""
    out: Dict[str, float] = {addr: 0.0 for addr in members}
    for (db, set_name), entry in entries.items():
        h = heats.get(f"{db}:{set_name}", 0.0)
        slots = entry.get("slots", ())
        if not h or not slots:
            continue
        share = h / len(slots)
        for sl in slots:
            if sl.get("state") == _placement.LIVE \
                    and sl["addr"] in out:
                out[sl["addr"]] += share
    return out


def skew_ratio(heats: Dict[str, float]) -> float:
    """max/mean member heat — 1.0 is perfectly even; an idle pool
    (mean 0) also reads 1.0 so emptiness never looks like skew."""
    if not heats:
        return 1.0
    vals = list(heats.values())
    mean = sum(vals) / len(vals)
    if mean <= 0.0:
        return 1.0
    return max(vals) / mean


def plan_moves(entries: Dict[Tuple[str, str], Dict[str, Any]],
               heats: Dict[str, float],
               sizes: Dict[Tuple[str, str], int],
               members: List[str],
               max_bytes: int) -> List[Dict[str, Any]]:
    """The byte-bounded greedy planner: while the pool reads skewed
    (above :data:`SETTLE_RATIO`), take one LIVE slot from the hottest
    member and give it to the coldest member that owns NO slot of
    that set (slot-stable routing: a member may own at most one slot
    per set). Candidate slots rank by heat share (ties to the smaller
    partition — cheaper bytes for the same balance). ``sizes`` maps
    ``(addr, "db:set")`` to that member's LOCAL partition bytes.

    ``max_bytes`` bounds the ROUND: planning stops before a move
    would exceed it, except the first move always fits — a single
    oversized slot must stay movable or the pool can never heal.

    A pool with NO heat signal at all (fresh restart, idle ledger)
    plans by slot count instead: every set weighs 1.0, so growth
    still spreads ownership."""
    heats = dict(heats)
    if sum(heats.values()) <= 0.0:
        heats = {f"{db}:{s}": 1.0 for (db, s) in entries}
    member_heat = addr_heats(entries, heats, members)
    owners: Dict[Tuple[str, str], set] = {
        key: {sl["addr"] for sl in entry.get("slots", ())}
        for key, entry in entries.items()}
    moves: List[Dict[str, Any]] = []
    used = 0
    # bounded by the total slot population — each iteration moves one
    for _ in range(sum(len(e.get("slots", ())) for e in entries.values())):
        if skew_ratio(member_heat) <= SETTLE_RATIO:
            break
        hot = max(member_heat, key=member_heat.get)  # type: ignore[arg-type]
        best = None
        for (db, set_name), entry in entries.items():
            slots = entry.get("slots", ())
            share = heats.get(f"{db}:{set_name}", 0.0) / max(len(slots), 1)
            for i, sl in enumerate(slots):
                if sl["addr"] != hot \
                        or sl.get("state") != _placement.LIVE:
                    continue
                nbytes = int(sizes.get((hot, f"{db}:{set_name}"), 0))
                # coldest member not already owning a slot of this set
                dsts = [a for a in members
                        if a != hot and a not in owners[(db, set_name)]]
                if not dsts:
                    continue
                dst = min(dsts, key=lambda a: member_heat[a])
                if member_heat[dst] + share >= member_heat[hot]:
                    continue  # not a strict improvement: the slot
                    # would leave the destination at least as hot as
                    # the source started — churn, not balance
                cand = (share, -nbytes, db, set_name, i, dst, nbytes)
                if best is None or cand > best:
                    best = cand
        if best is None:
            break
        share, _neg, db, set_name, slot, dst, nbytes = best
        if moves and max_bytes > 0 and used + nbytes > max_bytes:
            break
        moves.append({"db": db, "set": set_name, "slot": slot,
                      "src": hot, "dst": dst, "nbytes": nbytes,
                      "heat": share})
        used += nbytes
        member_heat[hot] -= share
        member_heat[dst] += share
        owners[(db, set_name)].discard(hot)
        owners[(db, set_name)].add(dst)
    return moves


class SkewDetector:
    """Sustained-imbalance detector over cumulative attribution
    snapshots: each :meth:`observe` differences the per-set heats
    against the previous call (one feedback WINDOW), rebuilds member
    heats from the window's delta, and counts CONSECUTIVE windows
    whose skew ratio exceeds the threshold. ``windows`` in a row →
    one True verdict (and the streak resets, so a campaign must
    re-earn the next one). Windows below :data:`MIN_WINDOW_HEAT`
    reset the streak — idle pools never rebalance."""

    def __init__(self, ratio: float, windows: int):
        self.ratio = float(ratio)
        self.windows = max(int(windows), 1)
        self.streak = 0
        self._prev: Dict[str, float] = {}

    def observe(self, cum_heats: Dict[str, float],
                entries: Dict[Tuple[str, str], Dict[str, Any]],
                members: List[str]) -> Tuple[float, bool]:
        delta = {s: max(0.0, v - self._prev.get(s, 0.0))
                 for s, v in cum_heats.items()}
        self._prev = dict(cum_heats)
        if sum(delta.values()) < MIN_WINDOW_HEAT:
            self.streak = 0
            return 1.0, False
        ratio = skew_ratio(addr_heats(entries, delta, members))
        if ratio > self.ratio:
            self.streak += 1
        else:
            self.streak = 0
        if self.streak >= self.windows:
            self.streak = 0
            return ratio, True
        return ratio, False


# --- worker-side move legs (the RESHARD op dispatcher) ----------------
def _seal_key(db: str, set_name: str) -> Tuple[str, str]:
    return (str(db), str(set_name))


def sealed(ctl, db: str, set_name: str) -> bool:
    """Is (db, set) write-sealed on this daemon? Expired seals clear
    lazily — a leader death mid-move self-heals after SEAL_TTL_S."""
    key = _seal_key(db, set_name)
    with ctl._shard_mu:
        deadline = ctl._reshard_seals.get(key)
        if deadline is None:
            return False
        if time.monotonic() >= deadline:
            del ctl._reshard_seals[key]
            return False
        return True


def tombstoned(ctl, db: str, set_name: str) -> bool:
    """Was (db, set)'s local copy dropped by a committed move? Routed
    frames still riding the old epoch must answer PlacementStale, not
    silently apply into the cleared set."""
    with ctl._shard_mu:
        return _seal_key(db, set_name) in ctl._reshard_moved


def _local_partition(ctl, db: str, set_name: str):
    """This daemon's local partition as ``("table", ColumnTable)`` /
    ``("items", list)`` plus its row count, on the host (what rides the
    wire). Table sets compact to one host table (the scatter-leg shape);
    everything else ships its raw item list."""
    from netsdb_tpu_torch.serve import shard as _shard

    t = _shard.local_table(ctl, db, set_name)
    if t is not None:
        return "table", t, int(t.num_rows)
    items = ctl.library.store.get_items(_ident(db, set_name))
    return "items", _shard._host_tree(list(items)), len(items)


def _local_rows(ctl, db: str, set_name: str) -> int:
    """The local partition's row count without a host copy when the set
    holds one plain resident table (a count read must not move the
    partition off the card)."""
    from netsdb_tpu_torch.parallel.placement import is_placed_table
    from netsdb_tpu_torch.relational.table import ColumnTable

    items = ctl.library.store.get_items(_ident(db, set_name))
    if len(items) == 1 and isinstance(items[0], ColumnTable) \
            and not is_placed_table(items[0]):
        t = items[0]
        return int(t.num_rows if t.valid is None else int(t.valid.sum()))
    return _local_partition(ctl, db, set_name)[2]


def _slice_table(t, offset: int):
    from netsdb_tpu_torch.relational.table import ColumnTable

    return ColumnTable({k: v[offset:] for k, v in t.cols.items()},
                       dict(t.dicts))


def _install_table(ctl, db: str, set_name: str, chunk,
                   append: bool) -> None:
    """Write one pulled table chunk through this daemon's own ingest
    (the table moves to its device with its statistics, the catalog
    records the rows): a fresh partition replaces the set, the sealed
    tail appends to it. Either is a new write version of the set, so
    its captured programs are dropped."""
    from netsdb_tpu_torch.relational.table import ColumnTable

    if not append:
        ctl.library.store.clear_set(_ident(db, set_name))
        if chunk is not None:
            ctl.library.send_table(db, set_name, chunk)
        return
    if chunk is None:
        return
    existing = [i for i in ctl.library.store.get_items(
        _ident(db, set_name)) if isinstance(i, ColumnTable)]
    if existing and sorted(existing[0].cols) != sorted(chunk.cols):
        raise MoveAborted(
            "reshard install: tail chunk schema diverged from the "
            "initial copy — the move must abort, not merge")
    ctl.library.send_table(db, set_name, chunk, append=True)


def handle_reshard(ctl, p: Dict[str, Any]) -> Dict[str, Any]:
    """One worker-side RESHARD op against this daemon's local state.
    Runs in-process when the leader itself is a move endpoint, over
    the wire (CODEC_PICKLE replies — partitions ride the frame)
    otherwise. Ops:

    * ``prepare`` — create db + a clean local slot set (clearing any
      stale partial copy a previous aborted move left) and lift any
      tombstone: this daemon is about to become an owner again.
    * ``pull`` — the local partition from ``offset`` (0 = everything;
      the tail drain passes the initial copy's row count).
    * ``install`` — write one pulled chunk (``append`` merges the
      sealed tail after the initial copy).
    * ``seal`` / ``unseal`` — write-seal the slot behind a TTL;
      routed writes answer typed retryable while sealed, reads keep
      serving (the old owner serves until the epoch commits).
    * ``count`` — local rows + bytes (the commit verification read).
    * ``drop`` — the post-commit cleanup: clear the local copy, drop
      the shard registration, tombstone the scope.
    * ``warm`` — best-effort destination pre-warm (never
      correctness-bearing)."""
    op = p.get("op")
    db, set_name = p.get("db"), p.get("set")
    if not db or not set_name:
        raise ProtocolError("RESHARD frame needs db + set")
    ident = _ident(db, set_name)
    key = _seal_key(db, set_name)
    if op == "prepare":
        meta = p.get("meta") or {}
        ctl.library.create_database(db)
        if not ctl.library.set_exists(db, set_name):
            ctl.library.create_set(
                db, set_name,
                type_name=meta.get("type_name", "tensor"),
                persistence=meta.get("persistence", "transient"),
                eviction=meta.get("eviction", "lru"),
                storage=meta.get("storage", "memory"))
        ctl.library.clear_set(db, set_name)
        with ctl._shard_mu:
            ctl._reshard_moved.discard(key)
            ctl._reshard_seals.pop(key, None)
        return {}
    if op == "pull":
        offset = int(p.get("offset", 0))
        kind, payload, rows = _local_partition(ctl, db, set_name)
        if kind == "table":
            chunk = None if offset >= rows \
                else (payload if offset == 0
                      else _slice_table(payload, offset))
            return {"rows": rows, "kind": kind, "table": chunk}
        return {"rows": rows, "kind": kind,
                "items": payload[offset:]}
    if op == "install":
        append = bool(p.get("append"))
        if p.get("kind") == "table":
            _install_table(ctl, db, set_name, p.get("table"), append)
        else:
            from netsdb_tpu_torch.serve import shard as _shard

            items = p.get("items") or []
            if not append:
                ctl.library.store.clear_set(ident)
            if items:
                ctl.library.store.add_data(
                    ident, _shard._on_device(list(items), ctl.device))
        return {"rows": _local_rows(ctl, db, set_name)}
    if op == "seal":
        ttl = float(p.get("ttl_s", SEAL_TTL_S))
        # under the set's write gate: a write that passed its placement
        # check before the seal lands before the rows are counted, and
        # every later one sees the seal
        with ctl._write_gate(db, set_name):
            with ctl._shard_mu:
                ctl._reshard_seals[key] = time.monotonic() + ttl
            return {"rows": _local_rows(ctl, db, set_name)}
    if op == "unseal":
        with ctl._shard_mu:
            ctl._reshard_seals.pop(key, None)
        return {}
    if op == "count":
        stats = ctl.library.store.set_stats(ident)
        return {"rows": _local_rows(ctl, db, set_name),
                "nbytes": int(stats.get("nbytes", 0))}
    if op == "drop":
        with ctl._shard_mu:
            ctl._shard_sets.pop(key, None)
            ctl._reshard_seals.pop(key, None)
            ctl._reshard_moved.add(key)
        ctl.library.clear_set(db, set_name)
        return {}
    if op == "warm":
        # best-effort: page-touch the freshly installed partition so
        # the first post-move query doesn't pay the assembly (paged
        # relations re-stage off the arena; resident tables compact).
        # Never correctness-bearing — any failure is the cold path.
        try:
            rows = _local_rows(ctl, db, set_name)
            return {"warmed": rows > 0, "rows": rows}
        except Exception as e:  # noqa: BLE001 — warm is advisory
            return {"warmed": False, "error": f"{type(e).__name__}: {e}"}
    raise ProtocolError(f"unknown RESHARD op {op!r}")


class _PeerDown(Exception):
    """A move leg died on a TRANSPORT failure (peer unreachable) —
    carries the peer so the abort path can degrade exactly it."""

    def __init__(self, addr: str, cause: BaseException):
        super().__init__(f"{addr}: {type(cause).__name__}: {cause}")
        self.addr = addr


class Rebalancer:
    """Leader-side campaign driver: the skew detector on the
    sched-feedback cadence, the byte-bounded planner, and the
    per-move RESHARD executor. One instance per controller;
    :meth:`check` is safe to call from the feedback thread, the pool
    health loop, an admin frame, and tests concurrently — a single
    campaign runs at a time, every extra caller no-ops.

    ``_mu`` is a LEAF lock (tracked rank ``serve.Rebalancer._mu``):
    it guards only detector state, the running flag, and the move
    log. All placement reads, ledger snapshots, and every network
    leg run strictly outside it — the shard-section discipline."""

    def __init__(self, ctl):
        self.ctl = ctl
        cfg = ctl.config
        self._mu = TrackedLock("serve.Rebalancer._mu")
        self._detector = SkewDetector(
            getattr(cfg, "rebalance_skew_ratio", 2.0),
            getattr(cfg, "rebalance_windows", 3))
        self._force = False
        self._running = False
        self._last_ratio = 1.0
        self._log: List[Dict[str, Any]] = []

    # --- triggers -----------------------------------------------------
    def pool_changed(self) -> None:
        """Pool growth/shrink (a daemon registered, an eviction):
        bypass the sustained-window requirement — the next check
        plans immediately."""
        with self._mu:
            self._force = True

    # --- introspection ------------------------------------------------
    def status(self) -> Dict[str, Any]:
        epoch = self.ctl.placement.to_wire()["epoch"]
        with self._mu:
            return {"enabled": bool(getattr(self.ctl.config,
                                            "rebalance", False)),
                    "running": self._running,
                    "last_ratio": round(self._last_ratio, 4),
                    "streak": self._detector.streak,
                    "epoch": epoch,
                    "moves": list(self._log)}

    def placement_view(self) -> Dict[str, Any]:
        """The ``cli obs --placement`` data source: the full per-slot
        ownership table joined with local partition bytes (one
        best-effort COLLECT_STATS fan-out) and ledger heat shares,
        plus the rebalancer's status and last-move log — ONE
        server-side extractor so the pretty and ``--json`` renderings
        cannot drift."""
        ctl = self.ctl
        members = [ctl.advertise_addr] + [
            a for a in ctl._worker_addrs
            if not ctl.shards.is_degraded(a)]
        entries: Dict[Tuple[str, str], Dict[str, Any]] = {}
        for db, s in ctl.placement.sets():
            e = ctl.placement.entry(db, s)
            if e is not None:
                entries[(db, s)] = e
        heats = set_heats(obs.attrib.LEDGER.snapshot())
        sizes = self._gather_sizes(entries)
        sets_out = []
        for (db, s), e in sorted(entries.items()):
            scope = f"{db}:{s}"
            slots = e.get("slots", ())
            live = sum(1 for sl in slots
                       if sl.get("state") == _placement.LIVE)
            share = (heats.get(scope, 0.0) / live) if live else 0.0
            sets_out.append({
                "db": db, "set": s, "mode": e.get("mode"),
                "key": e.get("key"), "epoch": e.get("epoch"),
                "heat": round(heats.get(scope, 0.0), 4),
                "slots": [{
                    "slot": i, "addr": sl["addr"],
                    "state": sl.get("state"),
                    "nbytes": sizes.get((sl["addr"], scope), 0),
                    "heat": round(
                        share if sl.get("state") == _placement.LIVE
                        else 0.0, 4),
                } for i, sl in enumerate(slots)],
            })
        member_heat = addr_heats(entries, heats, members)
        return {"status": self.status(),
                "epoch": ctl.placement.to_wire()["epoch"],
                "members": [{
                    "addr": a,
                    "heat": round(member_heat.get(a, 0.0), 4),
                    "nbytes": sum(n for (ad, _sc), n in sizes.items()
                                  if ad == a),
                    "slots": sum(
                        1 for e in entries.values()
                        for sl in e.get("slots", ())
                        if sl["addr"] == a
                        and sl.get("state") == _placement.LIVE),
                } for a in members],
                "skew_ratio": round(skew_ratio(member_heat), 4),
                "sets": sets_out}

    # --- the cadence entry point --------------------------------------
    def check(self, force: bool = False) -> Optional[List[Dict[str, Any]]]:
        """One skew-detector pass; plans + runs a bounded move round
        when the imbalance is sustained (or a pool change forced it).
        Returns the round's move results (None = no round ran)."""
        ctl = self.ctl
        if not getattr(ctl.config, "rebalance", False):
            return None
        if not ctl._worker_addrs:
            return None
        if ctl._ha is not None and ctl._ha.role != "leader":
            return None  # only the leader moves data
        obs.REGISTRY.counter("rebalance.skew_checks").inc()
        members = [ctl.advertise_addr] + [
            a for a in ctl._worker_addrs
            if not ctl.shards.is_degraded(a)]
        entries: Dict[Tuple[str, str], Dict[str, Any]] = {}
        for db, s in ctl.placement.sets():
            e = ctl.placement.entry(db, s)
            if e is not None:
                entries[(db, s)] = e
        heats = set_heats(obs.attrib.LEDGER.snapshot())
        obs.REGISTRY.gauge("placement.epoch").set(
            ctl.placement.to_wire()["epoch"])
        with self._mu:
            ratio, sustained = self._detector.observe(
                heats, entries, members)
            self._last_ratio = ratio
            go = (sustained or self._force or force) \
                and not self._running and bool(entries) \
                and len(members) > 1
            if go:
                self._running = True
                self._force = False
        if not go:
            return None
        try:
            plan = plan_moves(
                self._movable(entries), heats,
                self._gather_sizes(entries), members,
                int(getattr(ctl.config,
                            "rebalance_max_bytes_per_round", 0)))
            if not plan:
                return []
            return self.run_moves(plan)
        finally:
            with self._mu:
                self._running = False

    def _movable(self, entries):
        """Planner input: paged sets stay put (their partitions live
        in the arena — moving them re-hosts resident, a follow-on)."""
        out = {}
        for (db, s), entry in entries.items():
            if self.ctl.library.store.storage_of(
                    _ident(db, s)) == "paged":
                continue
            out[(db, s)] = entry
        return out

    def _gather_sizes(self, entries) -> Dict[Tuple[str, str], int]:
        """Per-(member, scope) local partition bytes: the leader's own
        store plus one best-effort COLLECT_STATS fan-out (a silent
        worker just contributes zero — the planner still balances by
        heat, the byte bound degrades to move-count)."""
        ctl = self.ctl
        sizes: Dict[Tuple[str, str], int] = {}
        for scope, stats in (ctl.library.collect_stats() or {}).items():
            sizes[(ctl.advertise_addr, scope)] = \
                int(stats.get("nbytes", 0) or 0)
        replies = ctl.shards.fanout(MsgType.COLLECT_STATS,
                                    {"local_only": True})
        for addr, reply in (replies or {}).items():
            if not isinstance(reply, dict) or "error" in reply:
                continue
            for scope, stats in (reply.get("sets") or {}).items():
                sizes[(addr, scope)] = int(stats.get("nbytes", 0) or 0)
        return sizes

    # --- the move executor --------------------------------------------
    def _op(self, addr: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        from netsdb_tpu_torch.serve.errors import (
            ConnectionLostError,
            DeadlineExceededError,
            RemoteTimeoutError,
        )

        if addr == self.ctl.advertise_addr:
            return handle_reshard(self.ctl, payload)
        try:
            return self.ctl.shards.peer_request(
                addr, MsgType.RESHARD, payload, CODEC_PICKLE)
        except (OSError, ProtocolError, ConnectionLostError,
                RemoteTimeoutError, DeadlineExceededError) as e:
            # the peer-request layer wraps transport death in its
            # typed retryable family — for a MOVE leg that still
            # means "peer down": abort and degrade, don't guess
            raise _PeerDown(addr, e) from e

    def run_moves(self, plan: List[Dict[str, Any]]
                  ) -> List[Dict[str, Any]]:
        """Execute one planned round, move by move. The round stops
        at the first failed move (membership just changed under the
        plan — the next cadence replans against reality). A committed
        move's result carries its wall ``ms`` (copy through commit)."""
        results = []
        for mv in plan:
            try:
                t0 = time.perf_counter()
                self._move(mv["db"], mv["set"], int(mv["slot"]),
                           mv["src"], mv["dst"],
                           nbytes=int(mv.get("nbytes", 0)))
                results.append({**mv, "ok": True, "ms": (
                    time.perf_counter() - t0) * 1e3})
            except Exception as e:  # noqa: BLE001 — aborted typed below
                results.append({**mv, "ok": False,
                                "error": f"{type(e).__name__}: {e}"})
                break
        return results

    def _move(self, db: str, set_name: str, slot: int,
              src: str, dst: str, nbytes: int = 0) -> None:
        """One all-or-nothing slot move under the commit ordering:

        pull(src) → prepare(dst) → install → SEAL(src) → pull tail →
        install tail → count-verify(dst) → ``move_slot`` epoch bump →
        persist + replicate → register dst (SHARD_RESYNC) →
        push epochs → drop(src).

        The epoch bump is the commit point. Failures BEFORE it unwind
        to "nothing happened" (source unsealed, destination garbage
        cleared by its next prepare); a destination that dies between
        the bump and its registration REVERTS the bump (another epoch
        bump back to the source — the source still holds everything).
        A transport-dead peer is degraded (slots to handoff, epoch
        bump) — exactly the eviction story a failed heartbeat gives."""
        ctl = self.ctl
        cs = ctl.library.catalog.get_set(db, set_name) or {}
        meta = {"type_name": cs.get("type", "tensor"),
                "persistence": cs.get("persistence", "transient"),
                "storage": (cs.get("meta") or {}).get("storage",
                                                      "memory")}
        sealed_src = False
        try:
            pull0 = self._op(src, {"op": "pull", "db": db,
                                   "set": set_name, "offset": 0})
            n0 = int(pull0["rows"])
            self._op(dst, {"op": "prepare", "db": db, "set": set_name,
                           "meta": meta})
            self._ship(dst, db, set_name, pull0, append=False)
            sealed_src = True
            n1 = int(self._op(src, {"op": "seal", "db": db,
                                    "set": set_name,
                                    "ttl_s": SEAL_TTL_S})["rows"])
            if n1 < n0:
                raise MoveAborted(
                    f"reshard source {db}:{set_name}[{slot}] shrank "
                    f"mid-copy ({n0} → {n1} rows); aborting the move")
            if n1 > n0:
                tail = self._op(src, {"op": "pull", "db": db,
                                      "set": set_name, "offset": n0})
                self._ship(dst, db, set_name, tail, append=True)
            got = int(self._op(dst, {"op": "count", "db": db,
                                     "set": set_name})["rows"])
            if got != n1:
                raise MoveAborted(
                    f"reshard copy of {db}:{set_name}[{slot}] "
                    f"verified {got} rows at {dst}, source sealed "
                    f"{n1}; aborting the move")
        except Exception as e:
            self._abort(db, set_name, src, dst, e,
                        unseal_src=sealed_src)
            raise
        # --- commit ---------------------------------------------------
        entry = ctl.placement.move_slot(db, set_name, slot, dst)
        if entry is None:
            self._abort(db, set_name, src, dst,
                        MoveAborted("placement entry vanished"),
                        unseal_src=True)
            raise MoveAborted(
                f"reshard commit of {db}:{set_name}[{slot}] found no "
                f"placement entry; move aborted")
        ctl._replicate_placement()  # persist BEFORE the dst resync —
        # a leader restart must reload the post-move map, never a map
        # whose registered owners it cannot reconstruct
        if dst != ctl.advertise_addr:
            try:
                ctl.shards.peer_request(
                    dst, MsgType.SHARD_RESYNC,
                    {"sets": [{"db": db, "set": set_name,
                               "slot": slot,
                               "epoch": entry["epoch"]}]})
            except Exception as e:  # noqa: BLE001 — revert the bump
                # the destination died AFTER the bump: the source
                # still holds every row, so re-own it (another bump)
                # rather than strand the slot on a corpse
                ctl.placement.move_slot(db, set_name, slot, src)
                ctl._replicate_placement()
                self._abort(db, set_name, src, dst, e,
                            unseal_src=True)
                raise
        ctl._push_epochs()
        try:
            self._op(src, {"op": "drop", "db": db, "set": set_name})
        except Exception as e:  # noqa: BLE001 — committed; src is the
            # only loose end and it just proved unreachable: degrade
            # it so its stale copy can never serve
            ctl._evict_shard(src, f"reshard drop failed: "
                                  f"{type(e).__name__}: {e}")
        obs.REGISTRY.counter("rebalance.moves").inc()
        if nbytes:
            obs.REGISTRY.counter("rebalance.bytes_moved").inc(nbytes)
        obs.REGISTRY.gauge("placement.epoch").set(entry["epoch"])
        with self._mu:
            self._log.append({"db": db, "set": set_name, "slot": slot,
                              "src": src, "dst": dst,
                              "nbytes": nbytes,
                              "epoch": entry["epoch"]})
            del self._log[:-MOVE_LOG]
        try:
            self._op(dst, {"op": "warm", "db": db, "set": set_name})
        except Exception as e:  # noqa: BLE001 — warm is advisory
            del e
            pass

    def _ship(self, dst: str, db: str, set_name: str,
              pulled: Dict[str, Any], append: bool) -> None:
        payload = {"op": "install", "db": db, "set": set_name,
                   "kind": pulled.get("kind"), "append": append}
        if pulled.get("kind") == "table":
            if append and pulled.get("table") is None:
                return  # empty tail — nothing to merge
            payload["table"] = pulled.get("table")
        else:
            payload["items"] = pulled.get("items") or []
        self._op(dst, payload)

    def _abort(self, db: str, set_name: str, src: str, dst: str,
               cause: BaseException, unseal_src: bool) -> None:
        """Unwind one failed move: tick the abort counter, lift the
        source seal (best-effort — the TTL covers an unreachable
        source), and degrade a transport-dead peer so the pool's
        epoch rolls forward to handoff exactly like a failed
        heartbeat."""
        obs.REGISTRY.counter("rebalance.aborts").inc()
        if unseal_src:
            try:
                self._op(src, {"op": "unseal", "db": db,
                               "set": set_name})
            except Exception as e:  # noqa: BLE001 — TTL covers it
                del e
                pass
        if isinstance(cause, _PeerDown):
            self.ctl._evict_shard(
                cause.addr, f"reshard move failed: {cause}")
        with self._mu:
            self._log.append({"db": db, "set": set_name, "src": src,
                              "dst": dst, "aborted": True,
                              "error": f"{type(cause).__name__}: "
                                       f"{cause}"})
            del self._log[:-MOVE_LOG]

    # --- the learning-loop arm ----------------------------------------
    def advise(self, measure) -> Dict[str, Any]:
        """The placement-advisor protocol (learning/advisor.py's
        rebalance arm): measure baseline routed throughput, apply the
        current move plan, re-measure, COMMIT when the plan helped
        (ticking ``rebalance.advisor_commits``) or REVERT every move
        (the inverse plan) when it did not. ``measure()`` returns a
        higher-is-better number."""
        before = float(measure())
        self.pool_changed()
        results = self.check() or []
        applied = [r for r in results if r.get("ok")]
        if not applied:
            return {"decision": "no-plan", "before": before,
                    "after": before, "moves": results}
        after = float(measure())
        if after >= before:
            obs.REGISTRY.counter("rebalance.advisor_commits").inc(
                len(applied))
            return {"decision": "commit", "before": before,
                    "after": after, "moves": applied}
        inverse = [{"db": r["db"], "set": r["set"], "slot": r["slot"],
                    "src": r["dst"], "dst": r["src"],
                    "nbytes": r.get("nbytes", 0)}
                   for r in reversed(applied)]
        self.run_moves(inverse)
        return {"decision": "revert", "before": before,
                "after": after, "moves": applied}


def _ident(db: str, set_name: str):
    from netsdb_tpu_torch.storage.store import SetIdentifier

    return SetIdentifier(db, set_name)
