"""Stateful interactive serving: the session subsystem of one daemon —
the port's ``netsdb_tpu/serve/sessions.py`` for a daemon that owns every
session it opens.

A *session* is a named, TTL'd decode loop over one registered model
(``models/decode.py``): ``SESSION_OPEN`` binds ``sid → (model, ttl)``,
each ``GENERATE`` advances the session's state by one step,
``SESSION_CLOSE`` drops it. Two stores cooperate, fastest first:

* **Device cache** (``storage/devcache.py`` session entries) — the hot
  copy: one mutable entry per ``(session, model, layer)``, on the
  daemon's device, updated in place every step. Only this module calls
  the cache's ``session_*`` mutators.
* **Host arena** (:class:`SessionArena`) — where evicted or expired
  layers land through the cache's spill callback, and where a session
  revives from after pressure or TTL expiry. A warm decode step never
  touches it (``arena.reads`` is the gate's counter).

Every layer value is stored step-tagged (``{"step": n, "v": value}``) in
both stores; the newest copy of each layer is in exactly one of them, so
a revive assembled layer by layer is consistent by construction, and a
torn assembly raises instead of decoding from mixed steps.

Each ``GENERATE`` carries an idempotency token; the session keeps its
last applied ``{token, steps, y}``, so a retried step returns the
recorded reply instead of advancing the state twice.

Sessions on pool workers — placement by sid hash, ``op=adopt``,
``op=spill`` pushes home, live moves (``op=move`` / ``op=handoff``) and
:meth:`SessionManager.forget_owner` — belong to ROADMAP.md A7 part 2 and
raise ``NotImplementedError`` naming it."""

from __future__ import annotations

import contextvars
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from netsdb_tpu_torch import obs
from netsdb_tpu_torch.models import decode as _decode
from netsdb_tpu_torch.serve.errors import ServeFault, SessionUnknown
from netsdb_tpu_torch.serve.protocol import CODEC_PICKLE, MsgType
from netsdb_tpu_torch.serve.sched.sessions import DecodeBatcher
from netsdb_tpu_torch.utils.locks import TrackedLock

#: the in-flight GENERATE frame's idempotency token, installed by the
#: daemon's dispatch for the handler's dynamic extent
idem_token: "contextvars.ContextVar[Optional[str]]" = \
    contextvars.ContextVar("netsdb_torch_idem_token", default=None)

_POOL_OPS = ("adopt", "spill", "move", "handoff")


def _host(value: Any) -> np.ndarray:
    """A host-side copy of one layer value (a device tensor or an
    array). The spill callback runs under the cache lock; this is the
    one transfer it makes."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu").numpy().copy()
    return np.array(np.asarray(value))


class SessionTable:
    """sid → session metadata."""

    def __init__(self):
        self._mu = TrackedLock("SessionTable._mu")
        self._rows: Dict[str, Dict[str, Any]] = {}

    def open(self, sid: str, db: str, kind: str, owner: str,
             ttl_s: float) -> Dict[str, Any]:
        with self._mu:
            row = self._rows.get(sid)
            if row is None:
                row = {"sid": sid, "db": db, "kind": kind,
                       "owner": owner, "ttl_s": float(ttl_s), "steps": 0}
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

    def set_steps(self, sid: str, steps: int) -> None:
        with self._mu:
            row = self._rows.get(sid)
            if row is not None and int(steps) > int(row["steps"]):
                row["steps"] = int(steps)

    def close(self, sid: str) -> bool:
        with self._mu:
            return self._rows.pop(sid, None) is not None

    def count(self) -> int:
        with self._mu:
            return len(self._rows)

    def sessions(self) -> List[Dict[str, Any]]:
        with self._mu:
            return [dict(r) for r in self._rows.values()]


class SessionArena:
    """Host-side spill store for evicted or expired session state. A
    leaf: its lock nests under the cache lock (the spill callback) and
    under nothing else. ``reads`` counts revive lookups that returned
    state — the warm-decode gate asserts it stays flat."""

    def __init__(self):
        self._mu = TrackedLock("SessionArena._mu")
        # (sid, db) → {"layers": {layer: {"step", "v" (host)}}, "steps"}
        self._slots: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self.reads = 0
        self.writes = 0

    def merge_layer(self, sid: str, db: str, layer: str, step: int,
                    value: np.ndarray, steps_hint: int = 0) -> None:
        with self._mu:
            slot = self._slots.setdefault((sid, db),
                                          {"layers": {}, "steps": 0})
            cur = slot["layers"].get(layer)
            if cur is None or int(step) >= int(cur["step"]):
                slot["layers"][layer] = {"step": int(step), "v": value}
            slot["steps"] = max(int(slot["steps"]), int(step),
                                int(steps_hint))
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

    def stats(self) -> Dict[str, int]:
        with self._mu:
            return {"entries": len(self._slots),
                    "reads": self.reads, "writes": self.writes,
                    "bytes": sum(rec["v"].nbytes
                                 for s in self._slots.values()
                                 for rec in s["layers"].values())}


class SessionManager:
    """One per daemon: owns the decode runtime, the table and arena, the
    per-model batch coalescer and the housekeeping thread (the TTL
    sweep)."""

    def __init__(self, ctl):
        self._ctl = ctl
        cfg = ctl.config
        self.ttl_s = float(cfg.session_ttl_s)
        self.state_cap = int(cfg.session_state_bytes)
        self.runtime = _decode.DecodeRuntime(
            ctl.library, model_dedup=bool(cfg.model_dedup))
        self.table = SessionTable()
        self.arena = SessionArena()
        self.batcher = DecodeBatcher(self._run_batch,
                                     max_batch=int(cfg.decode_batch_max))
        # per-session last applied step {token, steps, y}
        self._applied: Dict[str, Dict[str, Any]] = {}
        self._applied_mu = TrackedLock("SessionManager._applied_mu")
        self._hk_thread: Optional[threading.Thread] = None
        self._hk_stop = threading.Event()
        self._hk_mu = TrackedLock("SessionManager._hk_mu")
        # per-session exclusion of a step's load→step→save against a
        # close; a batch takes its sids in sorted order
        self._sid_locks: Dict[str, TrackedLock] = {}
        self._sid_locks_mu = TrackedLock("SessionManager._sid_locks_mu")
        self._last_spill_fault: Optional[str] = None
        ctl.library.store.device_cache().set_session_spill(self._on_spill)

    def _me(self) -> str:
        return self._ctl.advertise_addr

    def _cache(self):
        return self._ctl.library.store.device_cache()

    # --- device cache / arena state movement --------------------------
    def _on_spill(self, sid: str, model: str, layer: str,
                  value: Any) -> None:
        """The cache's eviction/expiry escape hatch (a leaf, run under
        the cache lock): host-copy the layer into the arena, tagged with
        its own step."""
        try:
            rec = value if isinstance(value, dict) else {
                "step": self.table.steps(sid), "v": value}
            self.arena.merge_layer(
                sid, model, layer, int(rec.get("step", 0)),
                _host(rec["v"]), steps_hint=self.table.steps(sid))
        except Exception as e:  # noqa: BLE001 — spill must never take
            self._last_spill_fault = repr(e)  # the cache down with it
            obs.REGISTRY.counter("session.spill_errors").inc()

    def _install_state(self, sid: str, db: str, ttl_s: float,
                       state: Dict[str, Any], step: int) -> None:
        for layer, v in state.items():
            self._cache().session_put(sid, db, layer,
                                      {"step": int(step), "v": v}, ttl_s)

    def _load_state(self, sid: str, db: str,
                    ttl_s: float) -> Tuple[Dict[str, Any], int]:
        """The session's current state, layer by layer: the resident
        entry unless the arena holds a newer spill of that layer (then
        the arena copy revives and re-installs). All layers must land on
        one step; a mixed assembly raises."""
        layers = self.runtime.state_layers(db)
        out: Dict[str, Any] = {}
        steps_seen = set()
        # the arena's high-water step, read without a read tick: on a
        # warm step every resident layer is at least this new
        arena_steps = self.arena.steps(sid, db)
        for layer in layers:
            rec = self._cache().session_get(sid, db, layer)
            if rec is not None and int(rec["step"]) < arena_steps:
                newer = self.arena.get_layer(sid, db, layer)
                if newer is not None \
                        and int(newer["step"]) > int(rec["step"]):
                    rec = newer
                    self._cache().session_put(sid, db, layer, dict(rec),
                                              ttl_s)
            if rec is None:
                rec = self.arena.get_layer(sid, db, layer)
                if rec is not None:
                    self._cache().session_put(sid, db, layer, dict(rec),
                                              ttl_s)
            if rec is None:
                if self.table.steps(sid) == 0 and arena_steps == 0:
                    rec = {"step": 0,
                           "v": self.runtime.init_state(db)[layer]}
                    self._cache().session_put(sid, db, layer, dict(rec),
                                              ttl_s)
                else:
                    raise SessionUnknown(
                        f"session {sid!r} state layer {layer!r} lost "
                        f"(not resident, no arena spill)")
            out[layer] = rec["v"]
            steps_seen.add(int(rec["step"]))
        if len(steps_seen) > 1:
            raise ServeFault(f"session {sid!r} state torn across steps "
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
            if not self._cache().session_put(sid, db, layer, rec, ttl_s):
                # the layer alone exceeds the cache budget: the advanced
                # state lands in the arena, as any spill would, so the
                # next step revives it instead of losing it
                self.arena.merge_layer(sid, db, layer, int(step),
                                       _host(v), steps_hint=int(step))
                obs.REGISTRY.counter("session.budget_spills").inc()

    # --- the batched decode step --------------------------------------
    def _sid_lock(self, sid: str) -> TrackedLock:
        with self._sid_locks_mu:
            return self._sid_locks.setdefault(
                sid, TrackedLock("SessionManager._sid_locks[]"))

    def _run_batch(self, db: str, reqs: List[Dict[str, Any]]) -> List[Any]:
        locks = [self._sid_lock(s)
                 for s in sorted({str(r["sid"]) for r in reqs})]
        for lk in locks:
            lk.acquire()
        try:
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
            for i, r in enumerate(reqs):
                sid = r["sid"]
                row = self.table.get(sid)
                if row is None:
                    results[i] = SessionUnknown(f"unknown session {sid!r}")
                    continue
                tok = r.get("tok")
                if tok:
                    with self._applied_mu:
                        last = self._applied.get(sid)
                    if last is not None and last["token"] == tok:
                        # a retry of an applied step: replay its reply
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
                xs = [np.asarray(reqs[i]["x"], np.float32) for i in live]
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
                obs.REGISTRY.counter("session.decode_steps").inc(len(live))
                obs.REGISTRY.counter("session.batch_occupancy").inc(
                    len(live))
            return results

    # --- frame handlers (called from ServeController) ------------------
    def handle_open(self, p: Dict[str, Any]):
        op = p.get("op", "open")
        if op == "open":
            return self._op_open(p)
        if op == "lookup":
            return self._op_lookup(p)
        if op in _POOL_OPS:
            raise NotImplementedError(
                f"SESSION_OPEN op={op!r} (sessions on pool workers, live "
                f"moves) is not ported yet: ROADMAP.md A7 part 2")
        raise ServeFault(f"unknown SESSION_OPEN op {op!r}")

    def _op_open(self, p):
        sid = str(p["sid"])
        db = str(p["db"])
        kind = str(p.get("kind", "lstm"))
        ttl_s = float(p.get("ttl_s") or self.ttl_s)
        spec = self.runtime.register_model(db, kind, client=p.get("client"),
                                           heads=p.get("heads"))
        nbytes = self.runtime.state_nbytes(db)
        if nbytes > self.state_cap:
            raise ServeFault(f"session state ({nbytes}B) exceeds "
                             f"session_state_bytes ({self.state_cap}B)")
        existing = self.table.get(sid)
        if existing is not None:  # idempotent re-open
            return MsgType.OK, {"sid": sid, "owner": existing["owner"],
                                "spec": spec, "state_nbytes": nbytes,
                                "steps": existing["steps"]}
        self.table.open(sid, db, kind, self._me(), ttl_s)
        self._install_state(sid, db, ttl_s, self.runtime.init_state(db), 0)
        obs.REGISTRY.counter("session.opened").inc()
        self._ensure_housekeeping(ttl_s)
        return MsgType.OK, {"sid": sid, "owner": self._me(), "spec": spec,
                            "state_nbytes": nbytes, "steps": 0}

    def _op_lookup(self, p):
        sid = str(p["sid"])
        row = self.table.get(sid)
        if row is None:
            raise SessionUnknown(f"unknown session {sid!r}")
        return MsgType.OK, {"sid": sid, "owner": row["owner"],
                            "steps": self.table.steps(sid)}

    def forget_owner(self, addr: str) -> None:
        raise NotImplementedError(
            "forget_owner (weights shipped to pool workers) is not ported "
            "yet: ROADMAP.md A7 part 2")

    def handle_generate(self, p: Dict[str, Any]):
        sid = str(p.get("sid") or p.get("set"))
        row = self.table.get(sid)
        if row is None:
            raise SessionUnknown(f"unknown session {sid!r}")
        with obs.span("session.coalesce", "serve"):
            out = self.batcher.submit(
                row["db"], sid, {"sid": sid, "x": p["x"],
                                 "tok": idem_token.get()})
        return MsgType.OK, {"sid": sid, "y": out["y"],
                            "steps": out["steps"],
                            "owner": self._me()}, CODEC_PICKLE

    def handle_close(self, p: Dict[str, Any]):
        sid = str(p.get("sid") or p.get("set"))
        if self.table.get(sid) is None:
            return MsgType.OK, {"sid": sid, "closed": False}
        with self._sid_lock(sid):
            dropped = self._cache().session_drop(sid)
            self.arena.drop(sid)
            closed = self.table.close(sid)
        with self._applied_mu:
            self._applied.pop(sid, None)
        # the per-sid lock stays in its map: a thread holding the old lock
        # object must never share the exclusion with a fresh one
        if closed:
            obs.REGISTRY.counter("session.closed").inc()
        return MsgType.OK, {"sid": sid, "closed": closed,
                            "dropped_entries": dropped}

    # --- housekeeping --------------------------------------------------
    def _ensure_housekeeping(self, ttl_s: float) -> None:
        with self._hk_mu:
            if self._hk_thread is not None and self._hk_thread.is_alive():
                return
            self._hk_stop.clear()
            t = threading.Thread(target=self._housekeeping, args=(ttl_s,),
                                 daemon=True,
                                 name="netsdb-torch-session-housekeeping")
            t.start()
            self._hk_thread = t

    def _housekeeping(self, ttl_s: float) -> None:
        interval = max(0.05, min(0.25, float(ttl_s) / 4.0))
        while not self._hk_stop.wait(interval):
            try:
                self._cache().session_sweep()
            except Exception as e:  # noqa: BLE001 — the next tick retries
                del e

    def stop(self) -> None:
        self._hk_stop.set()
        t = self._hk_thread
        if t is not None:
            t.join(timeout=2.0)

    # --- introspection -------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        out = {"open": self.table.count(),
               "sessions": [{k: r[k] for k in ("sid", "db", "owner",
                                               "steps")}
                            for r in self.table.sessions()],
               "batcher": self.batcher.snapshot(),
               "arena": self.arena.stats(),
               "decode": _decode.decode_stats(),
               "resident_bytes": self._cache().session_resident_bytes()}
        rep = self.runtime.residency_report()
        if rep.get("models"):
            out["residency"] = rep
        return out
