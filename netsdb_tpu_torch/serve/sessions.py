"""Stateful interactive serving: the session subsystem — the port's
``netsdb_tpu/serve/sessions.py``.

A *session* is a named, TTL'd decode loop over one registered model
(``models/decode.py``): ``SESSION_OPEN`` binds ``sid → (model, owner,
ttl)``, each ``GENERATE`` advances the session's recurrent state by
one step, ``SESSION_CLOSE`` drops it. Three stores cooperate, fastest
first:

* **Device cache** (``storage/devcache.py`` session entries) — the hot
  copy: one MUTABLE entry per ``(session, model, layer)``, on the
  daemon's device, updated in place every step. Only this module calls
  the cache's ``session_*`` mutators.
* **Host arena** (:class:`SessionArena`) — where evicted/expired
  layers land via the devcache spill callback, and where a session
  revives from after pressure, TTL expiry, or owner failover. A warm
  decode step never touches it (``arena.reads`` is the structural
  gate's counter).
* **The replicated session table** (:class:`SessionTable`) — sid →
  metadata. Not replicated by itself: the MIRRORED ``SESSION_OPEN`` /
  ``GENERATE`` / ``SESSION_CLOSE`` frames replay at every follower,
  which re-derives the same table (and the same devcache/arena state,
  since decode is deterministic) — the HA-log-shipping discipline the
  data plane already uses, reused verbatim for sessions.

Every layer value is stored STEP-TAGGED (``{"step": n, "v": array}``)
in both the devcache and the arena. The newest copy of each layer is
always in exactly one of the two (resident beats arena; the arena
keeps the highest-step spill), so a revive assembled layer-by-layer
is consistent by construction — and a torn assembly (which would mean
a bookkeeping bug, not a race) raises instead of silently decoding
from mixed steps.

Ownership and stickiness: the pool leader places each session
deterministically (itself, or one live worker by sid hash), pushing
``SESSION_OPEN op=adopt`` — with the model's dense weights on the
first session per (owner, model) — to a worker owner. A frame landing
on a non-owner answers the typed retryable ``SessionMoved`` carrying
the owner's address; the client re-points and retries under the SAME
idempotency token, so a step is never double-applied to one state
copy, and a re-applied step after failover recomputes bit-identically
from the last durable state."""

from __future__ import annotations

import contextvars
import hashlib
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from netsdb_tpu_torch import obs
from netsdb_tpu_torch.models import decode as _decode
from netsdb_tpu_torch.serve.errors import (ServeFault, SessionMoved,
                                          SessionUnknown)
from netsdb_tpu_torch.serve.protocol import CODEC_PICKLE, MsgType
from netsdb_tpu_torch.serve.sched.sessions import DecodeBatcher
from netsdb_tpu_torch.utils.locks import TrackedLock

#: the in-flight GENERATE frame's idempotency token, installed by the
#: daemon's dispatch for the handler's dynamic extent
idem_token: "contextvars.ContextVar[Optional[str]]" = \
    contextvars.ContextVar("netsdb_torch_idem_token", default=None)


def _host(value: Any) -> np.ndarray:
    """A host-side copy of one layer value (a device tensor or an
    array). The spill callback runs under the cache lock; this is the
    one transfer it makes. Decode state is f32, and its bytes cross the
    wire unchanged, so a moved session resumes bit for bit."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu").numpy().copy()
    return np.array(np.asarray(value))


class SessionTable:
    """sid → session metadata. Every daemon re-derives its own copy
    from the mirrored frame stream (module docstring); the wire dump
    only rides follower resync snapshots."""

    def __init__(self):
        self._mu = TrackedLock("SessionTable._mu")
        self._rows: Dict[str, Dict[str, Any]] = {}

    def open(self, sid: str, db: str, kind: str, owner: str,
             ttl_s: float, home: Optional[str] = None) -> Dict[str, Any]:
        with self._mu:
            row = self._rows.get(sid)
            if row is None:
                row = {"sid": sid, "db": db, "kind": kind,
                       "owner": owner, "home": home, "ttl_s": float(ttl_s),
                       "steps": 0}
                self._rows[sid] = row
            return dict(row)

    def get(self, sid: str) -> Optional[Dict[str, Any]]:
        with self._mu:
            row = self._rows.get(sid)
            return dict(row) if row else None

    def steps(self, sid: str) -> int:
        with self._mu:
            row = self._rows.get(sid)
            return int(row["steps"]) if row else 0

    def bump(self, sid: str) -> int:
        with self._mu:
            row = self._rows[sid]
            row["steps"] += 1
            return int(row["steps"])

    def set_steps(self, sid: str, steps: int) -> None:
        with self._mu:
            row = self._rows.get(sid)
            if row is not None and int(steps) > int(row["steps"]):
                row["steps"] = int(steps)

    def set_owner(self, sid: str, owner: str,
                  home: Optional[str] = None) -> None:
        with self._mu:
            row = self._rows.get(sid)
            if row is not None:
                row["owner"] = owner
                if home is not None:
                    row["home"] = home

    def close(self, sid: str) -> bool:
        with self._mu:
            return self._rows.pop(sid, None) is not None

    def count(self) -> int:
        with self._mu:
            return len(self._rows)

    def sessions(self) -> List[Dict[str, Any]]:
        with self._mu:
            return [dict(r) for r in self._rows.values()]

    def to_wire(self) -> List[Dict[str, Any]]:
        return self.sessions()

    def load_wire(self, rows: List[Dict[str, Any]]) -> None:
        with self._mu:
            for r in rows or []:
                self._rows[str(r["sid"])] = dict(r)


class SessionArena:
    """Host-side spill store for evicted/expired session state. A
    LEAF: its lock nests under the devcache lock (the spill callback)
    and under nothing else, and it never calls out. ``reads`` counts
    revive lookups that RETURNED state — the warm-decode structural
    gate asserts it stays flat across hot steps."""

    def __init__(self):
        self._mu = TrackedLock("SessionArena._mu")
        # (sid, db) → {"layers": {layer: {"step", "v"(host)}},
        #              "steps": int, "dirty": bool}
        self._slots: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self.reads = 0
        self.writes = 0

    def merge_layer(self, sid: str, db: str, layer: str, step: int,
                    value: np.ndarray, steps_hint: int = 0) -> None:
        key = (sid, db)
        with self._mu:
            slot = self._slots.setdefault(
                key, {"layers": {}, "steps": 0, "dirty": False})
            cur = slot["layers"].get(layer)
            if cur is None or int(step) >= int(cur["step"]):
                slot["layers"][layer] = {"step": int(step), "v": value}
            slot["steps"] = max(int(slot["steps"]), int(step),
                                int(steps_hint))
            slot["dirty"] = True
            self.writes += 1

    def merge_state(self, sid: str, db: str,
                    layers: Dict[str, Dict[str, Any]], steps: int,
                    dirty: bool = False) -> None:
        """A whole-state merge (the op=spill push path) — per-layer
        highest-step-wins, same rule as :meth:`merge_layer`."""
        with self._mu:
            slot = self._slots.setdefault(
                (sid, db), {"layers": {}, "steps": 0, "dirty": False})
            for layer, rec in (layers or {}).items():
                cur = slot["layers"].get(layer)
                if cur is None or int(rec["step"]) >= int(cur["step"]):
                    slot["layers"][layer] = {"step": int(rec["step"]),
                                             "v": rec["v"]}
            slot["steps"] = max(int(slot["steps"]), int(steps))
            if dirty:
                slot["dirty"] = True
            self.writes += 1

    def get_layer(self, sid: str, db: str,
                  layer: str) -> Optional[Dict[str, Any]]:
        with self._mu:
            slot = self._slots.get((sid, db))
            rec = slot["layers"].get(layer) if slot else None
            if rec is not None:
                self.reads += 1
                return dict(rec)
            return None

    def snapshot_slot(self, sid: str, db: str) -> Optional[Dict[str, Any]]:
        with self._mu:
            slot = self._slots.get((sid, db))
            if slot is None:
                return None
            return {"layers": {k: dict(v)
                               for k, v in slot["layers"].items()},
                    "steps": int(slot["steps"])}

    def steps(self, sid: str, db: str) -> int:
        with self._mu:
            slot = self._slots.get((sid, db))
            return int(slot["steps"]) if slot else 0

    def drop(self, sid: str) -> int:
        with self._mu:
            keys = [k for k in self._slots if k[0] == sid]
            for k in keys:
                del self._slots[k]
            return len(keys)

    def take_dirty(self) -> List[Tuple[str, str]]:
        """Pop the dirty markers (the housekeeping push drain)."""
        with self._mu:
            out = [k for k, s in self._slots.items() if s["dirty"]]
            for k in out:
                self._slots[k]["dirty"] = False
            return out

    def mark_dirty(self, sid: str, db: str) -> None:
        with self._mu:
            slot = self._slots.get((sid, db))
            if slot is not None:
                slot["dirty"] = True

    def stats(self) -> Dict[str, int]:
        with self._mu:
            return {"entries": len(self._slots),
                    "reads": self.reads, "writes": self.writes,
                    "bytes": sum(rec["v"].nbytes
                                 for s in self._slots.values()
                                 for rec in s["layers"].values())}


class SessionManager:
    """One per daemon: owns the decode runtime, the table/arena pair,
    the per-model batch coalescer, and the housekeeping thread (TTL
    sweep + spill push to the session's home leader)."""

    def __init__(self, ctl):
        self._ctl = ctl
        cfg = ctl.config
        self.ttl_s = float(getattr(cfg, "session_ttl_s", 600.0))
        self.state_cap = int(getattr(cfg, "session_state_bytes",
                                     16 << 20))
        self.runtime = _decode.DecodeRuntime(
            ctl.library,
            model_dedup=bool(getattr(cfg, "model_dedup", False)))
        self.table = SessionTable()
        self.arena = SessionArena()
        self.batcher = DecodeBatcher(
            self._run_batch,
            max_batch=int(getattr(cfg, "decode_batch_max", 8)))
        # models whose dense weights already shipped to an owner —
        # later sessions of the same (owner, model) adopt weight-less.
        # Guarded by _shipped_mu (handler threads race on it) and
        # invalidated by forget_owner() when the pool health loop
        # degrades/readmits a member: a restarted worker lost its
        # resident models, so a weight-less adopt there would fail
        # register_model and silently degrade placement to
        # leader-local ownership.
        self._shipped: set = set()
        self._shipped_mu = TrackedLock("SessionManager._shipped_mu")
        # per-session last-applied idempotency record
        # {token, steps, y}: the daemon-local idempotency cache only
        # dedupes retries that land on the SAME daemon — this record
        # travels WITH the state (spill push, move, handoff, adopt),
        # so a retry under the same token landing at the session's
        # NEW owner replays the recorded reply instead of advancing
        # the state a second time (the handle's no-double-apply
        # contract across relocations).
        self._applied: Dict[str, Dict[str, Any]] = {}
        self._applied_mu = TrackedLock("SessionManager._applied_mu")
        self._hk_thread: Optional[threading.Thread] = None
        self._hk_stop = threading.Event()
        self._hk_mu = TrackedLock("SessionManager._hk_mu")
        # per-session exclusion between a decode step's load→step→save
        # and a handoff/move/close packing or dropping that state. The
        # server's mirrored-frame ordering locks only exist on daemons
        # WITH followers — a plain pool worker needs this or a live
        # move can tear an in-flight step. A batch takes its sids in
        # sorted order; every other holder takes exactly one, so the
        # two can never deadlock.
        self._sid_locks: Dict[str, TrackedLock] = {}
        self._sid_locks_mu = TrackedLock("SessionManager._sid_locks_mu")
        # diagnostics breadcrumbs (racy-by-design single slots: the
        # LAST best-effort fault, surfaced via stats(); the counters
        # next to each write are the authoritative tally)
        self._last_spill_fault: Optional[str] = None
        self._last_place_fault: Optional[str] = None
        ctl.library.store.device_cache().set_session_spill(self._on_spill)

    # --- roles ---------------------------------------------------------
    def _me(self) -> str:
        return self._ctl.advertise_addr

    def _authoritative(self, row: Dict[str, Any]) -> bool:
        """Is this daemon the session's authority (may adopt, place,
        and answer SessionMoved)? With HA armed, the current LEADER
        is; unarmed, the session's home daemon is (a pool worker's
        rows carry the leader as home, so the worker only ever
        applies what it owns or bounces)."""
        ha = self._ctl._ha
        if ha is not None:
            from netsdb_tpu_torch.serve import ha as _ha

            return ha.role == _ha.LEADER
        home = row.get("home")
        return home is None or home == self._me()

    def _replica(self) -> bool:
        ha = self._ctl._ha
        if ha is None:
            return False
        from netsdb_tpu_torch.serve import ha as _ha

        return ha.role != _ha.LEADER

    def _live_workers(self) -> List[str]:
        ctl = self._ctl
        return [a for a in ctl._worker_addrs
                if not ctl.shards.is_degraded(a)]

    def _pick_owner(self, sid: str) -> str:
        """Deterministic placement from replicated inputs only: sid
        hash over the sorted live workers, or self when the pool is
        plain. A follower replaying the open (usually with no worker
        list) picks ITSELF — exactly the owner it must be if it is
        ever promoted, so failover needs no table rewrite."""
        if self._replica():
            return self._me()
        live = sorted(self._live_workers())
        if not live:
            return self._me()
        h = int(hashlib.sha1(sid.encode()).hexdigest(), 16)
        return live[h % len(live)]

    # --- devcache/arena state movement --------------------------------
    # (the ONLY call sites of the devcache session_* mutators — the
    # session-state-mutation lint rule pins this)
    def _cache(self):
        return self._ctl.library.store.device_cache()

    def _on_spill(self, sid: str, model: str, layer: str,
                  value: Any) -> None:
        """Devcache eviction/expiry escape hatch — LEAF (runs under
        the cache lock): host-copy the layer into the arena, tagged
        with its own step."""
        try:
            rec = value if isinstance(value, dict) else {
                "step": self.table.steps(sid), "v": value}
            self.arena.merge_layer(
                sid, model, layer, int(rec.get("step", 0)),
                _host(rec["v"]), steps_hint=self.table.steps(sid))
        except Exception as e:  # noqa: BLE001 — spill must never
            # take the cache down with it; the arena just misses
            # this copy (counted, last fault kept for stats())
            self._last_spill_fault = repr(e)
            obs.REGISTRY.counter("session.spill_errors").inc()

    def _install_state(self, sid: str, db: str, ttl_s: float,
                       state: Dict[str, Any], step: int) -> None:
        for layer, v in state.items():
            self._cache().session_put(sid, db, layer,
                                      {"step": int(step), "v": v},
                                      ttl_s)

    def _load_state(self, sid: str, db: str,
                    ttl_s: float) -> Tuple[Dict[str, Any], int]:
        """Assemble the session's CURRENT state layer by layer:
        newest copy wins — the resident devcache entry, unless the
        arena's spill for that layer is NEWER (then the arena copy
        revives and re-installs). A resident copy can legitimately be
        stale: a mirror follower replays ``op=open`` owning the
        session itself and installs init state at step 0, while a
        worker-owned session's durability arrives only via mirrored
        ``op=spill`` merges into the arena — after promotion the
        step-0 resident layers would otherwise assemble consistently
        and silently rewind the session. All layers must land on one
        step — a mixed assembly is a torn state and raises rather
        than decoding garbage."""
        layers = self.runtime.state_layers(db)
        out: Dict[str, Any] = {}
        steps_seen = set()
        # the arena's high-water step, read WITHOUT a read tick: on a
        # warm step every resident layer is at least this new, so the
        # zero-warm-arena-reads gate still holds
        arena_steps = self.arena.steps(sid, db)
        for layer in layers:
            rec = self._cache().session_get(sid, db, layer)
            if rec is not None and int(rec["step"]) < arena_steps:
                newer = self.arena.get_layer(sid, db, layer)
                if newer is not None \
                        and int(newer["step"]) > int(rec["step"]):
                    rec = newer
                    self._cache().session_put(sid, db, layer,
                                              dict(rec), ttl_s)
            if rec is None:
                rec = self.arena.get_layer(sid, db, layer)
                if rec is not None:
                    self._cache().session_put(sid, db, layer,
                                              dict(rec), ttl_s)
            if rec is None:
                if self.table.steps(sid) == 0 and arena_steps == 0:
                    rec = {"step": 0,
                           "v": self.runtime.init_state(db)[layer]}
                    self._cache().session_put(sid, db, layer,
                                              dict(rec), ttl_s)
                else:
                    raise SessionUnknown(
                        f"session {sid!r} state layer {layer!r} lost "
                        f"(not resident, no arena spill)")
            out[layer] = rec["v"]
            steps_seen.add(int(rec["step"]))
        if len(steps_seen) > 1:
            raise ServeFault(
                f"session {sid!r} state torn across steps "
                f"{sorted(steps_seen)}")
        step = steps_seen.pop() if steps_seen else 0
        self.table.set_steps(sid, step)
        return out, step

    def _save_state(self, sid: str, db: str, ttl_s: float,
                    state: Dict[str, Any], step: int) -> None:
        for layer, v in state.items():
            rec = {"step": int(step), "v": v}
            if self._cache().session_update(sid, db, layer, rec):
                continue
            if not self._cache().session_put(sid, db, layer, rec,
                                             ttl_s):
                # budget-rejected (the layer alone exceeds the whole
                # cache budget, so eviction can't make room): the
                # advanced state must still land somewhere durable —
                # straight into the arena, same as any spill, so the
                # next step revives it instead of raising
                # SessionUnknown over silently-dropped state
                self.arena.merge_layer(sid, db, layer, int(step),
                                       _host(v), steps_hint=int(step))
                obs.REGISTRY.counter("session.budget_spills").inc()

    def _pack(self, sid: str, db: str) -> Dict[str, Any]:
        """The session's full host-side state (devcache first, arena
        fallback per layer) — the op=spill/handoff payload. The
        last-applied idempotency record rides along so the dedup
        guarantee survives the relocation."""
        layers: Dict[str, Dict[str, Any]] = {}
        for layer in self.runtime.state_layers(db):
            rec = self._cache().session_get(sid, db, layer,
                                            touch=False)
            if rec is None:
                rec = self.arena.get_layer(sid, db, layer)
            if rec is not None:
                layers[layer] = {"step": int(rec["step"]),
                                 "v": _host(rec["v"])}
        out = {"layers": layers,
               "steps": max([self.table.steps(sid),
                             self.arena.steps(sid, db)]
                            + [r["step"] for r in layers.values()]
                            or [0])}
        applied = self._applied_record(sid)
        if applied is not None:
            out["applied"] = applied
        return out

    # --- the per-session applied-token record -------------------------
    def _applied_record(self, sid: str) -> Optional[Dict[str, Any]]:
        """Host-copied wire form of the session's last-applied step
        record, or None."""
        with self._applied_mu:
            last = self._applied.get(sid)
            if last is None:
                return None
            return {"token": last["token"],
                    "steps": int(last["steps"]),
                    "y": _host(last["y"])}

    def _note_applied(self, sid: str,
                      rec: Optional[Dict[str, Any]]) -> None:
        """Adopt a shipped applied-token record (move/handoff/spill
        push) — newest step wins, so a stale straggler push can never
        roll the dedup horizon backwards."""
        if not rec or not rec.get("token"):
            return
        with self._applied_mu:
            cur = self._applied.get(sid)
            if cur is None \
                    or int(rec.get("steps", 0)) >= int(cur["steps"]):
                self._applied[sid] = {"token": rec["token"],
                                      "steps": int(rec.get("steps", 0)),
                                      "y": rec["y"]}

    # --- the batched decode step --------------------------------------
    def _sid_lock(self, sid: str) -> TrackedLock:
        with self._sid_locks_mu:
            return self._sid_locks.setdefault(
                sid, TrackedLock("SessionManager._sid_locks[]"))

    def _run_batch(self, db: str,
                   reqs: List[Dict[str, Any]]) -> List[Any]:
        locks = [self._sid_lock(s)
                 for s in sorted({str(r["sid"]) for r in reqs})]
        for lk in locks:
            lk.acquire()
        try:
            # lint: disable=lock-blocking-call -- the session locks serialize each batched session's steps, and the step's upload is its own inputs and state: only a later step of the same sessions waits on them
            return self._run_batch_locked(db, reqs)
        finally:
            for lk in reversed(locks):
                lk.release()

    def _run_batch_locked(self, db: str,
                          reqs: List[Dict[str, Any]]) -> List[Any]:
        with obs.span("session.batch", "serve"):
            results: List[Any] = [None] * len(reqs)
            live: List[int] = []
            states, steps, ttls = [], [], []
            me = self._me()
            for i, r in enumerate(reqs):
                sid = r["sid"]
                row = self.table.get(sid)
                if row is None:
                    results[i] = SessionUnknown(
                        f"unknown session {sid!r}")
                    continue
                if row["owner"] != me:
                    # a handoff/move won the sid lock while this step
                    # sat in the coalesce queue: bounce ONLY this
                    # request typed-retryable, keep the rest batched
                    results[i] = SessionMoved(
                        f"session {sid!r} moved to {row['owner']}",
                        owner_addr=row["owner"])
                    continue
                tok = r.get("tok")
                if tok:
                    with self._applied_mu:
                        last = self._applied.get(sid)
                    if last is not None and last["token"] == tok:
                        # retry of an applied-but-unanswered step whose
                        # record travelled here with the state (the
                        # daemon-local idempotency cache can't have
                        # seen this token): replay the recorded reply,
                        # never advance the state twice under one token
                        results[i] = {"y": last["y"],
                                      "steps": int(last["steps"])}
                        continue
                ttl = float(row["ttl_s"])
                try:
                    st, step = self._load_state(sid, db, ttl)
                except ServeFault as e:
                    results[i] = e
                    continue
                live.append(i)
                states.append(st)
                steps.append(step)
                ttls.append(ttl)
            if live:
                xs = [np.asarray(reqs[i]["x"], np.float32)
                      for i in live]
                with obs.span("session.device", "serve"):
                    new, outs = self.runtime.step_batch(db, states, xs)
                for j, i in enumerate(live):
                    sid = reqs[i]["sid"]
                    step = steps[j] + 1
                    self._save_state(sid, db, ttls[j], new[j], step)
                    self.table.set_steps(sid, step)
                    results[i] = {"y": outs[j], "steps": step}
                    tok = reqs[i].get("tok")
                    if tok:
                        with self._applied_mu:
                            self._applied[sid] = {"token": tok,
                                                  "steps": step,
                                                  "y": outs[j]}
                obs.REGISTRY.counter("session.decode_steps").inc(
                    len(live))
                obs.REGISTRY.counter("session.batch_occupancy").inc(
                    len(live))
            return results

    # --- frame handlers (called from ServeController) ------------------
    def handle_open(self, p: Dict[str, Any]):
        op = p.get("op", "open")
        if op == "open":
            return self._op_open(p)
        if op == "adopt":
            return self._op_adopt(p)
        if op == "spill":
            return self._op_spill(p)
        if op == "lookup":
            return self._op_lookup(p)
        if op == "move":
            return self._op_move(p)
        if op == "handoff":
            return self._op_handoff(p)
        raise ServeFault(f"unknown SESSION_OPEN op {op!r}")

    def _op_open(self, p):
        sid = str(p["sid"])
        db = str(p["db"])
        kind = str(p.get("kind", "lstm"))
        ttl_s = float(p.get("ttl_s") or self.ttl_s)
        heads = p.get("heads")
        spec = self.runtime.register_model(
            db, kind, client=p.get("client"), heads=heads)
        nbytes = self.runtime.state_nbytes(db)
        if nbytes > self.state_cap:
            raise ServeFault(
                f"session state ({nbytes}B) exceeds "
                f"session_state_bytes ({self.state_cap}B)")
        existing = self.table.get(sid)
        if existing is not None:  # idempotent re-open
            return MsgType.OK, {"sid": sid, "owner": existing["owner"],
                                "spec": spec, "state_nbytes": nbytes,
                                "steps": existing["steps"]}
        owner = self._pick_owner(sid)
        if owner != self._me() and not self._replica():
            try:
                self._push_adopt(owner, sid, db, kind, spec, ttl_s)
            except Exception as e:  # noqa: BLE001 — placement is
                # best-effort; a dead worker falls back to local
                # ownership (the client never sees the bounce)
                self._last_place_fault = repr(e)
                owner = self._me()
        self.table.open(sid, db, kind, owner, ttl_s, home=self._me())
        if owner == self._me():
            self._install_state(sid, db, ttl_s,
                                self.runtime.init_state(db), 0)
        obs.REGISTRY.counter("session.opened").inc()
        self._ensure_housekeeping(ttl_s)
        return MsgType.OK, {"sid": sid, "owner": owner, "spec": spec,
                            "state_nbytes": nbytes, "steps": 0}

    def _push_adopt(self, owner: str, sid: str, db: str, kind: str,
                    spec: Dict[str, Any], ttl_s: float,
                    state: Optional[Dict[str, Any]] = None,
                    steps: int = 0) -> None:
        payload = {"op": "adopt", "sid": sid, "db": db, "kind": kind,
                   "heads": spec.get("heads"), "ttl_s": ttl_s,
                   "home": self._me(), "steps": int(steps)}
        if state is not None:
            payload["state"] = state
        with self._shipped_mu:
            shipped = (owner, db) in self._shipped
        if not shipped:
            # two concurrent opens may both ship — benign: the ingest
            # is idempotent; what must never happen is a weight-LESS
            # adopt at an owner that doesn't hold the model
            payload["weights"] = self._export_weights(db, kind)
            payload["block"] = [32, 32]
        self._ctl.shards.peer_request(owner, MsgType.SESSION_OPEN,
                                      payload, codec=CODEC_PICKLE)
        with self._shipped_mu:
            self._shipped.add((owner, db))

    def forget_owner(self, addr: str) -> None:
        """Invalidate the weights-already-shipped record for one pool
        member (called by the pool's degrade/readmit bookkeeping): a
        dead or restarted worker no longer holds the model, so the
        next session placed there must ship weights again."""
        with self._shipped_mu:
            self._shipped = {e for e in self._shipped if e[0] != addr}

    def _export_weights(self, db: str, kind: str) -> Dict[str, np.ndarray]:
        names = (_decode.LSTM_WEIGHTS if kind == "lstm"
                 else _decode.TRANSFORMER_WEIGHTS)
        out = {}
        for n in names:
            t = self._ctl.library.get_tensor(db, n)
            out[n] = t.data[:t.meta.shape[0], :t.meta.shape[1]] \
                .detach().to("cpu").numpy().copy()
        return out

    def _op_adopt(self, p):
        sid = str(p["sid"])
        db = str(p["db"])
        kind = str(p.get("kind", "lstm"))
        ttl_s = float(p.get("ttl_s") or self.ttl_s)
        if p.get("weights"):
            self._install_model_local(db, kind, p["weights"],
                                      tuple(p.get("block") or (32, 32)))
        self.runtime.register_model(db, kind, heads=p.get("heads"))
        self.table.open(sid, db, kind, self._me(), ttl_s,
                        home=p.get("home"))
        self.table.set_owner(sid, self._me(), home=p.get("home"))
        steps = int(p.get("steps", 0))
        state = p.get("state")
        if state:
            self.arena.merge_state(sid, db, state["layers"],
                                   state.get("steps", steps))
            self.table.set_steps(sid, int(state.get("steps", steps)))
            self._note_applied(sid, state.get("applied"))
        elif steps == 0:
            self._install_state(sid, db, ttl_s,
                                self.runtime.init_state(db), 0)
        self._ensure_housekeeping(ttl_s)
        return MsgType.OK, {"sid": sid, "owner": self._me(),
                            "steps": self.table.steps(sid)}

    def _install_model_local(self, db: str, kind: str,
                             weights: Dict[str, np.ndarray],
                             block: Tuple[int, int]) -> None:
        """Ingest shipped dense weights through this daemon's OWN
        library (create_set + send_matrix), so the worker's
        register_model walks the same store path — fingerprints, and
        the dedup pooling wiring, trigger here exactly as at the
        leader."""
        lib = self._ctl.library
        try:
            lib.create_database(db)
        except Exception as e:  # noqa: BLE001 — exists
            del e
        for name, w in weights.items():
            w = np.asarray(w, np.float32)
            if w.ndim == 1:
                w = w.reshape(-1, 1)
            shape = (block[0], 1) if w.shape[1] == 1 else tuple(block)
            try:
                lib.create_set(db, name, type_name="matrix")
            except Exception as e:  # noqa: BLE001 — exists
                del e
            lib.send_matrix(db, name, w, block_shape=shape)

    def _op_spill(self, p):
        sid = str(p["sid"])
        db = str(p["db"])
        state = p.get("state") or {}
        self.arena.merge_state(sid, db, state.get("layers", {}),
                               int(state.get("steps", 0)))
        self.table.set_steps(sid, int(state.get("steps", 0)))
        self._note_applied(sid, state.get("applied"))
        return MsgType.OK, {"sid": sid,
                            "steps": self.arena.steps(sid, db)}

    def _op_lookup(self, p):
        sid = str(p["sid"])
        row = self.table.get(sid)
        if row is None:
            raise SessionUnknown(f"unknown session {sid!r}")
        owner = row["owner"]
        if owner != self._me() and self._authoritative(row) \
                and owner not in self._live_workers():
            # heal: the recorded owner is gone — adopt here, revive
            # lands lazily from the arena on the next decode step
            self.table.set_owner(sid, self._me(), home=self._me())
            owner = self._me()
        elif self._replica():
            self.table.set_owner(sid, self._me())
            owner = self._me()
        return MsgType.OK, {"sid": sid, "owner": owner,
                            "steps": self.table.steps(sid)}

    def _op_move(self, p):
        """Relocate a LIVE session (the rebalance hook): pack the
        state wherever it currently is, adopt it at the target, and
        re-point the table. In-flight client steps bounce with the
        typed retryable ``SessionMoved`` and land at the target."""
        sid = str(p["sid"])
        to = str(p["to"])
        row = self.table.get(sid)
        if row is None:
            raise SessionUnknown(f"unknown session {sid!r}")
        if self._replica():  # replay: converge to self, no RPC
            self.table.set_owner(sid, self._me())
            return MsgType.OK, {"sid": sid, "owner": self._me()}
        db, kind = row["db"], row["kind"]
        if row["owner"] == self._me():
            with self._sid_lock(sid):
                state = self._pack(sid, db)
                # keep a local arena copy until the adopt lands: a
                # failed push must not leave the packed dict as the
                # state's only holder (ownership stays here on
                # failure, and the next step revives from this copy)
                self.arena.merge_state(sid, db, state["layers"],
                                       state["steps"])
                self._cache().session_drop(sid)
        else:
            rep = self._ctl.shards.peer_request(
                row["owner"], MsgType.SESSION_OPEN,
                {"op": "handoff", "sid": sid}, codec=CODEC_PICKLE)
            state = rep.get("state") or {"layers": {}, "steps": 0}
        if to == self._me():
            self.arena.merge_state(sid, db, state["layers"],
                                   state["steps"])
            self._note_applied(sid, state.get("applied"))
            self.table.set_owner(sid, self._me(), home=self._me())
        else:
            self._push_adopt(to, sid, db, kind,
                             self.runtime.spec(db) or {}, row["ttl_s"],
                             state=state, steps=state["steps"])
            self.table.set_owner(sid, to)
            self.arena.drop(sid)  # the adopt landed; the safety copy
            # (and any older spill) must not linger here
        self.table.set_steps(sid, int(state["steps"]))
        return MsgType.OK, {"sid": sid, "owner": to,
                            "steps": int(state["steps"])}

    def _op_handoff(self, p):
        """Old-owner half of a move: pack, then drop the local copy
        and re-point at home so late frames bounce typed."""
        sid = str(p["sid"])
        row = self.table.get(sid)
        if row is None:
            raise SessionUnknown(f"unknown session {sid!r}")
        with self._sid_lock(sid):
            state = self._pack(sid, row["db"])
            self._cache().session_drop(sid)
            self.arena.drop(sid)
            home = row.get("home") or self._me()
            self.table.set_owner(sid, home)
        with self._applied_mu:
            self._applied.pop(sid, None)  # shipped inside ``state``
        return MsgType.OK, {"sid": sid, "state": state}, CODEC_PICKLE

    def handle_generate(self, p: Dict[str, Any]):
        sid = str(p.get("sid") or p.get("set"))
        row = self.table.get(sid)
        if row is None:
            raise SessionUnknown(f"unknown session {sid!r}")
        owner = row["owner"]
        if owner != self._me():
            if self._replica():
                # mirror replay: the leader applied this — apply the
                # same deterministic step so the replica's state stays
                # warm, and converge ownership to self (the owner this
                # daemon must be the moment it is promoted)
                self.table.set_owner(sid, self._me())
            elif self._authoritative(row) \
                    and owner not in self._live_workers():
                # lazy adoption: the recorded owner died — this
                # daemon takes over, reviving from the arena spill
                self.table.set_owner(sid, self._me(), home=self._me())
            else:
                raise SessionMoved(
                    f"session {sid!r} is owned by {owner}",
                    owner_addr=owner)
        db = row["db"]
        with obs.span("session.coalesce", "serve"):
            out = self.batcher.submit(
                db, sid, {"sid": sid, "x": p["x"],
                          "tok": idem_token.get()})
        return MsgType.OK, {"sid": sid, "y": out["y"],
                            "steps": out["steps"],
                            "owner": self._me()}, CODEC_PICKLE

    def handle_close(self, p: Dict[str, Any]):
        sid = str(p.get("sid") or p.get("set"))
        row = self.table.get(sid)
        if row is None:
            return MsgType.OK, {"sid": sid, "closed": False}
        if row["owner"] != self._me() and not self._replica() \
                and row["owner"] in self._live_workers():
            try:
                self._ctl.shards.peer_request(
                    row["owner"], MsgType.SESSION_CLOSE, {"sid": sid})
            except Exception as e:  # noqa: BLE001 — the owner's
                del e  # TTL sweep collects what this forward missed
        with self._sid_lock(sid):
            dropped = self._cache().session_drop(sid)
            self.arena.drop(sid)
            closed = self.table.close(sid)
        with self._applied_mu:
            self._applied.pop(sid, None)
        # the per-sid lock is deliberately NOT popped: a thread that
        # already fetched the old lock object but not yet acquired it
        # would otherwise share the "exclusive" section with a holder
        # of a fresh object after a same-sid reopen. The map grows by
        # one small object per sid ever opened — the price of the
        # exclusion staying airtight.
        if closed:
            obs.REGISTRY.counter("session.closed").inc()
        return MsgType.OK, {"sid": sid, "closed": closed,
                            "dropped_entries": dropped}

    # --- housekeeping --------------------------------------------------
    def _ensure_housekeeping(self, ttl_s: float) -> None:
        with self._hk_mu:
            if self._hk_thread is not None \
                    and self._hk_thread.is_alive():
                return
            self._hk_stop.clear()
            t = threading.Thread(
                target=self._housekeeping, args=(ttl_s,),
                daemon=True, name="netsdb-torch-session-housekeeping")
            t.start()
            self._hk_thread = t

    def _housekeeping(self, ttl_s: float) -> None:
        interval = max(0.05, min(0.25, float(ttl_s) / 4.0))
        while not self._hk_stop.wait(interval):
            try:
                self._cache().session_sweep()
            except Exception as e:  # noqa: BLE001 — next tick retries
                del e
            self._drain_spill_pushes()

    def _drain_spill_pushes(self) -> None:
        """Ship dirty arena slots of sessions whose home is another
        daemon (a worker's durability push): the home leader merges
        them — and MIRRORS the merge — so a worker death never loses
        more than the not-yet-pushed tail."""
        me = self._me()
        for sid, db in self.arena.take_dirty():
            row = self.table.get(sid)
            home = (row or {}).get("home")
            if not home or home == me:
                continue
            slot = self.arena.snapshot_slot(sid, db)
            if slot is None:
                continue
            applied = self._applied_record(sid)
            if applied is not None:
                slot["applied"] = applied
            try:
                self._ctl.shards.peer_request(
                    home, MsgType.SESSION_OPEN,
                    {"op": "spill", "sid": sid, "db": db,
                     "state": slot},
                    codec=CODEC_PICKLE)
            except Exception as e:  # noqa: BLE001 — re-mark; the
                # next housekeeping tick retries the push
                self._last_spill_fault = repr(e)
                self.arena.mark_dirty(sid, db)
                obs.REGISTRY.counter("session.spill_push_errors").inc()

    def stop(self) -> None:
        self._hk_stop.set()
        t = self._hk_thread
        if t is not None:
            t.join(timeout=2.0)

    # --- introspection -------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        out = {"open": self.table.count(),
               "sessions": [{k: r[k] for k in
                             ("sid", "db", "owner", "steps")}
                            for r in self.table.sessions()],
               "batcher": self.batcher.snapshot(),
               "arena": self.arena.stats(),
               "decode": _decode.decode_stats(),
               "resident_bytes":
                   self._cache().session_resident_bytes()}
        rep = self.runtime.residency_report()
        if rep.get("models"):
            out["residency"] = rep
        return out
