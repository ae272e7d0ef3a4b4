"""HA: leader election under monotonic terms — the port's
``netsdb_tpu/serve/ha.py``.

netsDB's master/worker split has a single point of failure — the
master owns the catalog, and a pool leader additionally owns the
epoch-versioned placement map and the degraded-slot handoff buffer.
This module is the failover half of closing that: an ordered **succession list** of daemons (``peers`` — index 0
is the initial leader) where each follower probes every peer AHEAD of
it and promotes itself only after ALL of them have stayed unreachable
for a full election window. Succession order makes the election
deterministic without a quorum protocol: follower *i* can only
promote when followers *0..i-1* are dead too, so two candidates never
promote for the same failure (the double-failover chaos test drives
exactly this ladder).

Terms are the fencing mechanism. Every promotion bumps a monotonic
**term number** (persisted — a restarted daemon cannot come back
believing an old term) and every mirrored frame and handoff drain the
leader emits carries it (``protocol.HA_TERM_KEY``; routed frames
additionally carry their placement epoch, so a frame is fenced by the
pair ``(term, epoch)``). A deposed leader's straggler write therefore
arrives at the new leader with a stale term and is REJECTED — typed
:class:`~netsdb_tpu_torch.serve.errors.NotLeader` naming both terms,
counted ``ha.stragglers_rejected`` — never double-applied; the deposed leader
steps down when it sees the rejection, and the client's retry lands on
the new leader under the same idempotency token.

The controller side of promotion (placement restore + rebind, epoch
push, follower adoption, handoff drain) lives in
``ServeController._promote_self`` — this module only decides WHEN and
keeps the term/role/leader-address record consistent.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, List, Optional

from netsdb_tpu_torch import obs
from netsdb_tpu_torch.serve.errors import NotLeader
from netsdb_tpu_torch.utils.locks import TrackedLock
from netsdb_tpu_torch.utils.timing import deadline_after, seconds_left

LEADER = "leader"
FOLLOWER = "follower"


class HAState:
    """One daemon's HA record: (term, role, leader address) plus the
    leader's replicated placement map, guarded by a leaf-rank lock.
    The term persists to ``<state_dir>/ha_term.json`` on every change
    so a RESTARTED daemon resumes at (at least) the term it last knew
    — a deposed leader that crashed and came back cannot mint writes
    under its old term."""

    def __init__(self, self_addr: str, peers: List[str],
                 state_dir: Optional[str] = None):
        if self_addr not in peers:
            raise ValueError(
                f"HA succession list {peers!r} does not contain this "
                f"daemon's advertise address {self_addr!r}")
        self._mu = TrackedLock("serve.HAState._mu")
        self.self_addr = self_addr
        self.peers = list(peers)
        self._path = (os.path.join(state_dir, "ha_term.json")
                      if state_dir else None)
        self._term = 1
        self._role = LEADER if peers[0] == self_addr else FOLLOWER
        self._leader_addr: Optional[str] = peers[0]
        #: the leader's replicated placement map (wire form), shipped
        #: on every epoch bump (HA_STATE) — what a freshly promoted
        #: leader restores so routed ingest works immediately
        self._placement_wire: Optional[Dict[str, Any]] = None
        self._load()

    # --- persistence (term only — roles re-derive, maps re-replicate)
    def _load(self) -> None:
        if not self._path or not os.path.exists(self._path):
            return
        try:
            with open(self._path, "r", encoding="utf-8") as f:
                rec = json.load(f)
            self._term = max(self._term, int(rec.get("term", 1)))
        except (OSError, ValueError, TypeError, KeyError):
            return  # unreadable record: keep the derived defaults

    def _save_locked(self) -> None:
        """Caller holds ``_mu``. Best-effort atomic write — a failed
        persist degrades restart fencing, never the live protocol."""
        if not self._path:
            return
        try:
            parent = os.path.dirname(self._path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            tmp = self._path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({"term": self._term}, f)
            os.replace(tmp, self._path)
        except OSError:
            return

    # --- reads --------------------------------------------------------
    @property
    def term(self) -> int:
        with self._mu:
            return self._term

    @property
    def role(self) -> str:
        with self._mu:
            return self._role

    @property
    def leader_addr(self) -> Optional[str]:
        with self._mu:
            return self._leader_addr

    def earlier_peers(self) -> List[str]:
        """Peers AHEAD of this daemon in succession order — the set
        that must ALL be dead before this daemon may promote."""
        return self.peers[:self.peers.index(self.self_addr)]

    def later_peers(self) -> List[str]:
        """Peers BEHIND this daemon — the mirror set it adopts as its
        followers when promoted."""
        return self.peers[self.peers.index(self.self_addr) + 1:]

    def snapshot(self) -> Dict[str, Any]:
        """The PING/COLLECT_STATS section."""
        with self._mu:
            return {"term": self._term, "role": self._role,
                    "leader": self._leader_addr}

    def placement_wire(self) -> Optional[Dict[str, Any]]:
        with self._mu:
            return self._placement_wire

    def store_placement(self, wire: Dict[str, Any]) -> None:
        with self._mu:
            self._placement_wire = wire

    # --- term protocol ------------------------------------------------
    def observe_term(self, term: int) -> None:
        """Validate one inbound leader-originated frame's term. A
        HIGHER term is adopted (a new leader exists; this daemon —
        whatever it thought it was — is now that leader's follower); a
        STALE term, or any leader-to-leader write at this daemon's own
        term, is the deposed-straggler rejection: typed retryable
        :class:`NotLeader` naming both terms, never applied."""
        term = int(term)
        with self._mu:
            if term > self._term:
                self._term = term
                self._role = FOLLOWER
                self._leader_addr = None  # learned via HA_STATE/probe
                self._save_locked()
                obs.REGISTRY.counter("ha.terms").inc()
                return
            if term == self._term and self._role != LEADER:
                return  # the current leader's normal mirror stream
            current, leader = self._term, self._leader_addr
        obs.REGISTRY.counter("ha.stragglers_rejected").inc()
        raise NotLeader(
            f"stale-term write rejected: frame carries term {term}, "
            f"this daemon is at term {current} — the sender was "
            f"deposed; its straggler frames are fenced, not applied",
            leader_addr=leader, term=current)

    def check_client_write(self) -> None:
        """Client-originated mutations are leader-only: a follower (or
        deposed leader) answers the typed retryable :class:`NotLeader`
        carrying the leader it knows about, so the client re-points
        instead of split-braining the stores."""
        with self._mu:
            if self._role == LEADER:
                return
            current, leader = self._term, self._leader_addr
        raise NotLeader(
            f"this daemon is a follower at term {current}; mutations "
            f"go to the leader" + (f" at {leader}" if leader else
                                   " (election in progress)"),
            leader_addr=leader, term=current)

    def adopt_leader(self, addr: Optional[str], term: int) -> None:
        """A probe (or HA_STATE frame) found a live peer claiming
        leadership at ``term``: record it. Stale claims — a deposed
        leader still announcing its old term — are rejected typed, the
        same fencing as :meth:`observe_term`."""
        term = int(term)
        with self._mu:
            if term > self._term:
                self._term = term
                self._role = (LEADER if addr == self.self_addr
                              else FOLLOWER)
                self._leader_addr = addr
                self._save_locked()
                obs.REGISTRY.counter("ha.terms").inc()
                return
            if term == self._term:
                if self._role == LEADER and addr != self.self_addr:
                    current, leader = self._term, self._leader_addr
                else:
                    self._leader_addr = addr
                    return
            else:
                current, leader = self._term, self._leader_addr
        obs.REGISTRY.counter("ha.stragglers_rejected").inc()
        raise NotLeader(
            f"stale leadership claim rejected: {addr} announced term "
            f"{term}, this daemon is at term {current}",
            leader_addr=leader, term=current)

    def promote(self) -> int:
        """This daemon becomes leader under a NEW term (monotonic bump,
        persisted before the role flips live). Returns the new term."""
        with self._mu:
            self._term += 1
            self._role = LEADER
            self._leader_addr = self.self_addr
            self._save_locked()
            term = self._term
        obs.REGISTRY.counter("ha.terms").inc()
        obs.REGISTRY.counter("ha.promotions").inc()
        return term

    def step_down(self, term: Optional[int] = None,
                  leader_addr: Optional[str] = None) -> None:
        """A mirror ack (or HA_STATE) proved a newer leader exists —
        this daemon is deposed. Adopts the higher term when given."""
        with self._mu:
            bumped = term is not None and int(term) > self._term
            if bumped:
                self._term = int(term)
            self._role = FOLLOWER
            if leader_addr:
                self._leader_addr = leader_addr
            elif bumped:
                self._leader_addr = None
            self._save_locked()
        if bumped:
            obs.REGISTRY.counter("ha.terms").inc()


class HAMonitor:
    """The follower-side probe thread: every ``probe_interval_s`` it
    walks this daemon's EARLIER succession peers in order over
    dedicated short-timeout connections. The first live one resets the
    election window (and, if it claims leadership, is adopted as the
    leader); a full ``election_timeout_s`` with every earlier peer
    unreachable triggers promotion (``ctl._promote_self``). Leaders
    idle — the loop is a no-op while this daemon holds the role, and
    re-arms if it is ever deposed."""

    def __init__(self, ctl, ha: HAState, election_timeout_s: float,
                 probe_interval_s: Optional[float] = None):
        self.ctl = ctl
        self.ha = ha
        self.election_timeout_s = float(election_timeout_s)
        self.probe_interval_s = (float(probe_interval_s)
                                 if probe_interval_s is not None
                                 else max(self.election_timeout_s / 5.0,
                                          0.02))
        #: most recent promotion failure (observability; the loop
        #: re-arms a full window and tries again)
        self.last_error: Optional[str] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None or not self.ha.earlier_peers():
            return  # the initial leader has nobody to probe
        t = threading.Thread(target=self._loop, daemon=True,
                             name="netsdb-serve-ha-monitor")
        t.start()
        self._thread = t

    def _probe(self, probes: Dict[str, Any], addr: str) \
            -> Optional[Dict[str, Any]]:
        """One liveness probe; returns the PING reply or None (the
        cached connection is dropped so the next round re-dials)."""
        from netsdb_tpu_torch.serve.client import RemoteClient, RetryPolicy

        try:
            probe = probes.get(addr)
            if probe is None:
                probe = RemoteClient(
                    addr, token=self.ctl.token,
                    timeout=self.ctl.heartbeat_timeout_s,
                    retry=RetryPolicy(max_attempts=1))
                probes[addr] = probe
            return probe.ping()
        except Exception as e:  # noqa: BLE001 — dead peer IS the signal
            del e
            probe = probes.pop(addr, None)
            if probe is not None:
                probe.close()
            return None

    def _loop(self) -> None:
        probes: Dict[str, Any] = {}
        deadline = deadline_after(self.election_timeout_s)
        while not self.ctl._stop.wait(self.probe_interval_s):
            if self.ha.role == LEADER:
                deadline = deadline_after(self.election_timeout_s)
                continue
            alive_reply = None
            for addr in self.ha.earlier_peers():
                reply = self._probe(probes, addr)
                if reply is not None:
                    alive_reply = (addr, reply)
                    break  # ANY live earlier peer blocks promotion
            if alive_reply is not None:
                deadline = deadline_after(self.election_timeout_s)
                addr, reply = alive_reply
                info = reply.get("ha") if isinstance(reply, dict) \
                    else None
                if isinstance(info, dict) and info.get("role") == LEADER:
                    try:
                        self.ha.adopt_leader(addr,
                                             int(info.get("term") or 0))
                    except NotLeader as e:
                        # a deposed earlier peer still claiming its old
                        # term: fenced, and it does NOT reset our view
                        self.last_error = str(e)
                continue
            if seconds_left(deadline) > 0:
                continue
            # every earlier candidate stayed dead for a full window
            try:
                self.ctl._promote_self()
            except Exception as e:  # noqa: BLE001 — re-armed, retried
                self.last_error = f"{type(e).__name__}: {e}"
            deadline = deadline_after(self.election_timeout_s)
        for probe in probes.values():
            probe.close()
