"""Resident controller daemon — the port's ``netsdb_tpu/serve/server.py``
for one daemon on one card (the reference's ``MasterMain``: the server
that owns the device and keeps model sets loaded across clients).

One process owns the card, the set store with its device-resident
weights, the catalog and the compiled-plan cache, all of which stay live
across client connections. A listener thread accepts connections and
hands each to a handler thread; a handler map keyed by frame type
dispatches messages (the reference's ``PDBServer``). Query jobs pass
through the query scheduler (``serve/sched/``): lanes, identical-query
coalescing and the cache-aware affinity gate.

Every handler thread runs on the daemon's device and its default stream.
Mutating frames carry idempotency tokens; completed replies are cached
(and persisted in sqlite under ``root_dir``), so a retry — across a
restart too — replays the reply instead of applying the mutation twice.

**The shard pool.** ``ServeController(workers=[addr, ...])`` makes this
daemon the leader of a partitioned worker pool (netsDB's master over its
workers): a set created with ``placement="hash"`` or ``"range"`` splits
its pages across ``[this daemon] + workers``, the leader owns the
versioned placement map (``serve/placement.py``) it ships in the HELLO
reply and the PLACEMENT frame, ingest routes to the owning shards with
the epoch gate, queries over sharded sets scatter-gather
(``serve/shard.py``: SUBPLAN, SHUFFLE_PUT) and a heartbeat loop evicts
an unreachable worker into handoff and readmits it (SHARD_RESYNC, then
the handoff drain).

**Followers and mirroring.** ``ServeController(followers=[addr, ...])``
mirrors every mutating and job frame (``MIRRORED``) to follower daemons
that hold full copies of the store: each follower gets one ordered FIFO
link (:class:`_FollowerLink`), and the frame's ordering lock — the
per-set lock under a shared :class:`_RWOrder` for set-scoped frames,
the exclusive order for the rest — is held across both the enqueue and
the local handler, so conflicting frames reach every follower in the
leader's order. Each follower runs its own copy of the job; the client's
idempotency token, query id, client id and lane travel with the frame.
A follower that fails or misses its ack is evicted into the degraded
state (the client sees the typed retryable ``FollowerDegraded``; its
retry is answered from the cached local reply), and the health loop
readmits it by replaying the mutation log from its acked offset
(``ha_mutlog``) or by a whole-store snapshot streamed over
RESYNC_FOLLOWER in bounded bulk frames (no shared filesystem). HEALTH,
COLLECT_STATS, GET_TRACE and GET_METRICS merge the followers' sections.

**HA.** ``ha_peers=[addr, ...]`` (the same ordered succession list on
every daemon, or :meth:`ServeController.arm_ha`) arms failover
(``serve/ha.py``): a follower whose earlier peers all stay dead for the
election window promotes itself under a new term, adopts the later
peers as followers and the replicated placement map with the dead
leader's slots rebound to itself. Every mirrored frame and handoff drain
carries the sender's term (``protocol.HA_TERM_KEY``); a deposed
leader's straggler is refused with the typed ``NotLeader`` naming both
terms. With ``ha_mutlog`` the placement map and the handoff buffer also
persist under ``<root>/ha`` and ``<root>/mutlog``, so a restarted
leader drains what it had buffered; and a follower keeps its own
applied log (every mirrored frame it applied, with its position in the
leader's log, on a base snapshot of its store: the one it was resynced
from, renewed from its own store whenever the log passes its bounds), so
a follower restarted on its root rebuilds its store before it serves,
replaying a bounded tail, and resumes by log replay from the position it
reports in its handshake. A retried
mutation answered from the idempotency cache is mirrored again (the
followers dedupe it by its token), so a follower that missed a frame its
leader applied before a failover gets it with the client's retry.

Rebalancing (RESHARD, except its ``view`` op) and shipping a type's
module source belong to ROADMAP.md A7 part 2, the SPMD follower and its
LOCAL_SHARDS frame to A4 part 3; each raises ``NotImplementedError``
naming its item.

**Observability.** A frame carrying a client-minted query id opens a
query trace on this daemon's own ring (``obs_trace_ring`` profiles):
the trace is back-dated by the frame's decode time (a ``server.decode``
span), carries the client's identity, and every layer below reports
into it — the dispatch, the scheduler, the executor's loops with their
device time, staging and the device cache. With
``obs_device_profile_dir`` set, a traced query also runs under a
``torch.profiler`` session (one at a time; a concurrent query skips it)
whose directory joins the profile as ``meta.device_profile``; a trace
of ``obs_slow_query_s`` or more lands in the on-disk slow-query log.
Every workload frame ticks the request counters and the latency
histogram the SLO engine judges (introspection frames, ``OBS_FRAMES``,
do not) and is attributed per (client, set). GET_TRACE reads the ring
(on a pool leader with each worker's sections merged by query id under
``shards``) or the slow-query log, PUT_TRACE merges a client's shipped
spans, HEALTH evaluates the objectives, and GET_METRICS ships the
registry with the telemetry history's rates, or as OpenMetrics text.
``obs_enabled=False`` turns tracing off.

Run it as ``python -m netsdb_tpu_torch.serve.server --port 0 --root DIR
[--device cpu]``, or call :func:`run_daemon` with a ``Configuration``:
it prints ``serving on HOST:PORT`` on a line of its own once it listens,
then serves until SHUTDOWN."""

from __future__ import annotations

import contextlib
import importlib
import inspect
import itertools
import os
import socket
import sys
import threading
import time
import traceback
import uuid
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from netsdb_tpu_torch import obs
from netsdb_tpu_torch.client import Client
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.serve import placement as _placement
from netsdb_tpu_torch.serve import sched as _sched
from netsdb_tpu_torch.serve import sessions as _sessions
from netsdb_tpu_torch.serve import shard as _shard
from netsdb_tpu_torch.serve import ha as _ha
from netsdb_tpu_torch.serve.errors import (
    BACKPRESSURE_FIELDS,
    AdmissionFull,
    CorruptFrame,
    FollowerDegraded,
    LaneSaturated,
    NotLeader,
    NotLeaderError,
    PlacementStale,
    RequestInFlight,
    ShardUnavailable,
)
from netsdb_tpu_torch.serve.protocol import (
    CLIENT_ID_KEY,
    CODEC_MSGPACK,
    CODEC_PICKLE,
    HA_TERM_KEY,
    IDEMPOTENCY_KEY,
    LANE_KEY,
    MAX_FRAME_BYTES,
    MUTLOG_POS_KEY,
    PLACEMENT_EPOCH_KEY,
    PROTO_VERSION,
    PY_KEY,
    PY_TAG,
    QUERY_ID_KEY,
    SESSION_KEY,
    SHARD_SLOT_KEY,
    MsgType,
    ProtocolError,
    decode_body,
    recv_frame,
    recv_frame_raw,
    send_frame,
    tensor_from_wire,
)
from netsdb_tpu_torch.serve.sched.sessions import DECODE_LANE
from netsdb_tpu_torch.storage.mutlog import MutationLog
from netsdb_tpu_torch.storage.store import SetIdentifier
from netsdb_tpu_torch.utils.locks import TrackedLock
from netsdb_tpu_torch.utils.timing import deadline_after, seconds_left, wall_now

#: introspection frames — outside the serve.requests counters and the
#: serve.request_s histogram (monitoring must not move what it reads)
OBS_FRAMES = frozenset({MsgType.PING, MsgType.COLLECT_STATS,
                        MsgType.GET_TRACE, MsgType.PUT_TRACE,
                        MsgType.HEALTH, MsgType.GET_METRICS})



def resolve_entry_point(entry: str) -> Any:
    """'pkg.mod:attr' → the live object (the reference's loading of a
    registered type, with the module importable here)."""
    mod_name, _, attr = entry.partition(":")
    obj: Any = importlib.import_module(mod_name)
    for part in attr.split(".") if attr else []:
        obj = getattr(obj, part)
    return obj


def _to_host(value: Any) -> Any:
    """A stored item with its tensors on the host, for a reply (blocked
    tensors and tables keep their class; their pickles then load on a
    machine without a card)."""
    from netsdb_tpu_torch.core.blocked import BlockedTensor
    from netsdb_tpu_torch.relational.table import ColumnTable

    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    if isinstance(value, BlockedTensor):
        return BlockedTensor(value.data.detach().cpu(), value.meta)
    if isinstance(value, ColumnTable):
        return value.to("cpu")
    if isinstance(value, tuple) and not hasattr(value, "_fields"):
        return tuple(_to_host(v) for v in value)
    if isinstance(value, list):
        return [_to_host(v) for v in value]
    return value


def _dense_host(t) -> np.ndarray:
    """A blocked tensor's logical matrix as a host array."""
    return np.ascontiguousarray(t.to_dense().detach().cpu().numpy())


def _plain(v: Any) -> Any:
    """A statistic as a plain Python number (MessagePack-safe)."""
    return v.item() if hasattr(v, "item") else v


class _RWOrder:
    """Readers-writer lock for mirrored-frame ordering: set-scoped
    frames hold it shared (plus their per-set lock), global frames
    (jobs, flush, DDL without a set target) hold it exclusively — so
    frames on different sets run concurrently while anything that can
    observe several sets serializes against all of them."""

    def __init__(self):
        self._mu = threading.Lock()
        self._readers = 0
        self._no_readers = threading.Condition(self._mu)
        self._writer = threading.Lock()

    def acquire_read(self):
        self._writer.acquire()  # barrier: writers exclude new readers
        with self._mu:
            self._readers += 1
        self._writer.release()

    def release_read(self):
        with self._mu:
            self._readers -= 1
            if self._readers == 0:
                self._no_readers.notify_all()

    def acquire_write(self):
        self._writer.acquire()
        with self._mu:
            while self._readers:
                self._no_readers.wait()

    def release_write(self):
        self._writer.release()


class _FollowerLink:
    """One follower daemon's ordered frame pipe: a FIFO queue drained by
    a sender thread, so the follower receives mirrored frames in exactly
    the enqueue order while the leader's handler runs on. ``submit``
    returns a record whose ``done`` event fires when the follower acked
    (``reply``) or failed (``error``, ``exc``)."""

    def __init__(self, addr: str, client):
        import queue

        self.addr = addr
        self.client = client
        self.q: "queue.Queue" = queue.Queue()
        # submit/close are atomic under this lock, so every real item
        # precedes the close sentinel: nothing waits forever behind it
        self._lk = TrackedLock("_FollowerLink._lk")
        self._closed = False
        #: mutation-log END offset of the last frame this follower
        #: acked — the log-replay resync's resume position (written by
        #: the drain thread only, so monotone; None until a logged frame
        #: acks or with the log off)
        self.acked_offset: Optional[int] = None
        self.thread = threading.Thread(target=self._drain, daemon=True,
                                       name=f"netsdb-torch-mirror-{addr}")
        self.thread.start()

    def submit(self, typ, payload, codec,
               offset: Optional[int] = None) -> Dict[str, Any]:
        """Enqueue one frame; ``offset`` is its mutation-log END offset
        (None when the frame was not logged)."""
        rec: Dict[str, Any] = {"done": threading.Event(),
                               "mutlog_off": offset}
        with self._lk:
            if self._closed:
                rec["error"] = (f"{self.addr}: follower link closed "
                                f"(evicted or daemon shutdown)")
                rec["done"].set()
                return rec
            self.q.put((typ, payload, codec, rec))
        return rec

    def close(self, abort: bool = False) -> None:
        """Stop the drain thread. ``abort=True`` also tears the client
        socket down, so a drain blocked on a hung follower fails at once
        instead of holding its records (the eviction path)."""
        with self._lk:
            if not self._closed:
                self._closed = True
                self.q.put(None)
        if abort:
            self.client._force_close()

    def _drain(self) -> None:
        while True:
            item = self.q.get()
            if item is None:
                self.client.close()
                return
            typ, payload, codec, rec = item
            if self._closed:
                # evicted mid-queue: the frames behind the failed one
                # fail fast (never re-dial the dead follower) and are
                # counted — the divergence the resync must close
                obs.REGISTRY.counter("serve.mirror_dropped").inc()
                rec["error"] = (f"{self.addr}: follower link closed "
                                f"(evicted) — frame not forwarded")
                rec["done"].set()
                continue
            try:
                rec["reply"] = self.client._request(typ, payload, codec)
                if rec.get("mutlog_off") is not None:
                    self.acked_offset = rec["mutlog_off"]
            except Exception as e:  # noqa: BLE001 — surfaced by the caller
                rec["error"] = f"{self.addr}: {type(e).__name__}: {e}"
                rec["exc"] = e  # typed inspection (NotLeader fencing)
            finally:
                rec["done"].set()


class _IdempotencyCache:
    """Completed-reply cache keyed by client idempotency token — the
    server half of at-most-once for mutating frames. A retry whose
    original is still running waits on its event; a retry of a completed
    request gets the cached reply. With ``persist_path`` (a sqlite file
    under ``root_dir``) completed tokens survive a daemon restart;
    replies that cannot pickle stay memory-only. Rows are pruned to
    ``capacity``."""

    def __init__(self, capacity: int = 4096,
                 persist_path: Optional[str] = None):
        self._mu = TrackedLock("_IdempotencyCache._mu")
        self._done: "OrderedDict[str, Tuple]" = OrderedDict()
        self._inflight: Dict[str, threading.Event] = {}
        self._capacity = capacity
        self._db = None
        #: tokens answered from the persisted table
        self.persist_hits = 0
        self._since_prune = 0
        if persist_path:
            import sqlite3

            parent = os.path.dirname(persist_path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            self._db = sqlite3.connect(persist_path,
                                       check_same_thread=False)
            try:
                self._db.execute("PRAGMA journal_mode=WAL")
                self._db.execute("PRAGMA synchronous=NORMAL")
            except sqlite3.Error:
                pass  # default journaling
            self._db.execute("CREATE TABLE IF NOT EXISTS idem "
                             "(token TEXT PRIMARY KEY, reply BLOB)")
            self._db.commit()

    def _load_persisted(self, token: str) -> Optional[Tuple]:
        import pickle
        import sqlite3

        if self._db is None:
            return None
        try:
            row = self._db.execute("SELECT reply FROM idem WHERE token = ?",
                                   (token,)).fetchone()
            if row is None:
                return None
            result = pickle.loads(row[0])
        except (sqlite3.Error, pickle.UnpicklingError, ValueError,
                EOFError, AttributeError, ImportError):
            return None
        self.persist_hits += 1
        self._done[token] = result
        return result

    def _persist(self, token: str, result: Tuple) -> None:
        import pickle
        import sqlite3

        if self._db is None:
            return
        try:
            blob = pickle.dumps(result, protocol=pickle.HIGHEST_PROTOCOL)
            self._db.execute(
                "INSERT OR REPLACE INTO idem (token, reply) VALUES (?, ?)",
                (token, blob))
            self._db.commit()
        except (sqlite3.Error, pickle.PicklingError, TypeError,
                ValueError):
            return

    def claim(self, token: str, wait_s: float) -> Optional[Tuple]:
        """The cached ``(reply_type, reply, codec)`` when ``token``
        completed; None when the caller now owns execution (it must call
        :meth:`finish` or :meth:`abort`). Raises :class:`RequestInFlight`
        when the original still runs after ``wait_s``."""
        deadline = deadline_after(wait_s)
        while True:
            with self._mu:
                if token in self._done:
                    self._done.move_to_end(token)
                    obs.REGISTRY.counter("serve.idem.memory_hits").inc()
                    return self._done[token]
                cached = self._load_persisted(token)
                if cached is not None:
                    obs.REGISTRY.counter("serve.idem.persist_hits").inc()
                    return cached
                ev = self._inflight.get(token)
                if ev is None:
                    self._inflight[token] = threading.Event()
                    return None
            left = seconds_left(deadline)
            if left <= 0 or not ev.wait(left):
                raise RequestInFlight(
                    f"duplicate request {token[:8]}… still executing "
                    f"after {wait_s}s")

    def finish(self, token: str, result: Tuple) -> None:
        with self._mu:
            self._done[token] = result
            self._persist(token, result)
            self._since_prune += 1
            prune_now = self._since_prune >= max(self._capacity // 4, 64)
            if prune_now:
                self._since_prune = 0
            while len(self._done) > self._capacity:
                self._done.popitem(last=False)
            ev = self._inflight.pop(token, None)
        if ev is not None:
            ev.set()
        if prune_now:
            self.prune()

    def abort(self, token: str) -> None:
        """Release waiters of a failed execution so a retry re-runs."""
        with self._mu:
            ev = self._inflight.pop(token, None)
        if ev is not None:
            ev.set()

    def export(self) -> List[Tuple[str, Tuple]]:
        """The completed replies held in memory, oldest first, those
        that pickle (what a snapshot carries to a resynced follower)."""
        import pickle

        with self._mu:
            done = list(self._done.items())
        out = []
        for token, result in done:
            try:
                pickle.dumps(result, protocol=pickle.HIGHEST_PROTOCOL)
            except (pickle.PicklingError, TypeError, AttributeError,
                    ValueError):
                continue
            out.append((token, result))
        return out

    def adopt(self, items) -> None:
        """Take a leader's completed replies (:meth:`export`): a frame
        the leader applied before the snapshot, retried later, dedupes
        here instead of applying on top of the snapshot that holds it."""
        import pickle
        import sqlite3

        items = [(token, tuple(result)) for token, result in items]
        with self._mu:
            for token, result in items:
                self._done[token] = result
                self._done.move_to_end(token)
            while len(self._done) > self._capacity:
                self._done.popitem(last=False)
            if self._db is None or not items:
                return
            try:
                self._db.executemany(
                    "INSERT OR REPLACE INTO idem (token, reply) "
                    "VALUES (?, ?)",
                    [(t, pickle.dumps(r, protocol=pickle.HIGHEST_PROTOCOL))
                     for t, r in items])
                self._db.commit()
            except sqlite3.Error:
                return

    def alias(self, token: str, target: str) -> bool:
        """Finish ``token`` with ``target``'s cached reply — the
        follower half of TOKEN_ALIAS: a coalesce waiter's token maps
        onto the mirrored execution of its flight leader, so the
        waiter's retry after a failover is answered here instead of
        re-executing. False when ``target`` is unknown."""
        with self._mu:
            result = self._done.get(target)
            if result is not None:
                self._done.move_to_end(target)
            else:
                result = self._load_persisted(target)
            if result is None:
                return False
            self._done[token] = result
            self._persist(token, result)
            while len(self._done) > self._capacity:
                self._done.popitem(last=False)
            ev = self._inflight.pop(token, None)
        if ev is not None:
            ev.set()
        return True

    def prune(self) -> None:
        """Drop the oldest persisted tokens beyond ``capacity``."""
        import sqlite3

        with self._mu:
            if self._db is None:
                return
            try:
                self._db.execute(
                    "DELETE FROM idem WHERE rowid NOT IN (SELECT rowid "
                    "FROM idem ORDER BY rowid DESC LIMIT ?)",
                    (self._capacity,))
                self._db.commit()
            except sqlite3.Error:
                return

    def close(self) -> None:
        import sqlite3

        with self._mu:
            db, self._db = self._db, None
            if db is not None:
                try:
                    db.close()
                except sqlite3.Error:
                    pass


# --- windowed bulk ingest: the server half of one conversation ----------

class _BulkAssembler:
    """``add`` decodes a chunk as it lands (outside any set lock);
    ``finish`` builds the payload the target op's handler applies."""

    def __init__(self, meta: dict):
        self.meta = meta
        self.chunks = 0

    def add(self, payload: dict) -> None:
        raise NotImplementedError

    def finish(self) -> Tuple[dict, int]:
        raise NotImplementedError


class _ItemsAssembler(_BulkAssembler):
    """Pickled item batches (object rows, or row dicts of a table)."""

    def __init__(self, meta: dict, allow_pickle: bool):
        super().__init__(meta)
        if not allow_pickle:
            raise ProtocolError(
                "bulk item ingest refused: chunks carry pickle and this "
                "daemon has allow_pickle off")
        self.items: list = []

    def add(self, payload: dict) -> None:
        import pickle

        self.items.extend(pickle.loads(memoryview(payload["blob"])))
        self.chunks += 1

    def finish(self) -> Tuple[dict, int]:
        out = {"db": self.meta["db"], "set": self.meta["set"],
               "items": self.items}
        if self.meta.get("as_table"):
            out.update(as_table=True,
                       date_cols=list(self.meta.get("date_cols") or ()),
                       append=bool(self.meta.get("append")))
        return out, CODEC_PICKLE


class _TableAssembler(_BulkAssembler):
    """Row-range column slices of one table: the columns are allocated
    from the BEGIN meta's ``nrows`` on the first chunk and each chunk
    lands at its row offset; ``finish`` checks the row coverage."""

    def __init__(self, meta: dict):
        super().__init__(meta)
        self.nrows = int(meta.get("nrows") or 0)
        self.cols: Optional[Dict[str, np.ndarray]] = None
        self.filled = 0

    def add(self, payload: dict) -> None:
        start, stop = (int(v) for v in payload["rows"])
        if self.cols is None:
            self.cols = {
                name: np.empty((self.nrows,) + np.asarray(arr).shape[1:],
                               np.asarray(arr).dtype)
                for name, arr in payload["cols"].items()}
        for name, arr in payload["cols"].items():
            self.cols[name][start:stop] = np.asarray(arr)
        self.filled += stop - start
        self.chunks += 1

    def finish(self) -> Tuple[dict, int]:
        from netsdb_tpu_torch.relational.table import ColumnTable

        if self.filled != self.nrows or self.cols is None:
            raise CorruptFrame(f"bulk table stream covered {self.filled} "
                               f"of {self.nrows} rows")
        table = ColumnTable(
            {k: torch.from_numpy(v) for k, v in self.cols.items()},
            {k: list(v) for k, v in (self.meta.get("dicts") or {}).items()},
            None)
        return {"db": self.meta["db"], "set": self.meta["set"],
                "items": table, "as_table": True,
                "date_cols": list(self.meta.get("date_cols") or ()),
                "append": bool(self.meta.get("append"))}, CODEC_PICKLE


class _BlobAssembler(_BulkAssembler):
    """An opaque byte stream (the RESYNC_FOLLOWER snapshot): chunks land
    in a buffer of the BEGIN meta's ``nbytes`` at their running
    offset."""

    def __init__(self, meta: dict):
        super().__init__(meta)
        self.buf = bytearray(int(meta.get("nbytes") or 0))
        self.off = 0

    def add(self, payload: dict) -> None:
        mv = memoryview(np.ascontiguousarray(payload["blob"])).cast("B")
        end = self.off + mv.nbytes
        if end > len(self.buf):
            raise CorruptFrame(
                f"bulk blob stream overflowed its declared "
                f"{len(self.buf)} bytes at offset {self.off}")
        self.buf[self.off:end] = mv
        self.off = end
        self.chunks += 1

    def finish(self) -> Tuple[dict, int]:
        out = dict(self.meta)
        out.pop("nbytes", None)
        out["snapshot_blob"] = memoryview(self.buf)[:self.off]
        return out, CODEC_PICKLE


class ServeController:
    """The daemon. ``start()`` runs the listener on a background thread
    (tests); ``serve_forever()`` blocks (``python -m``)."""

    #: frames every follower replays, in the leader's order for
    #: conflicting frames (DDL, ingest, jobs, sessions); reads stay local
    MIRRORED = frozenset({
        MsgType.CREATE_DATABASE, MsgType.CREATE_SET, MsgType.REMOVE_SET,
        MsgType.CLEAR_SET, MsgType.REGISTER_TYPE, MsgType.SEND_DATA,
        MsgType.SEND_MATRIX, MsgType.ADD_SHARED_MAPPING,
        MsgType.FLUSH_DATA, MsgType.LOAD_SET,
        MsgType.EXECUTE_COMPUTATIONS, MsgType.EXECUTE_PLAN,
        MsgType.DEDUP_RESIDENT,
        MsgType.SESSION_OPEN, MsgType.GENERATE, MsgType.SESSION_CLOSE,
    })

    #: mirrored frames scoped to one (db, set): they serialize per set
    #: and hold the order shared; every other mirrored frame holds it
    #: exclusively
    SET_SCOPED_FRAMES = frozenset({
        MsgType.CREATE_SET, MsgType.REMOVE_SET, MsgType.CLEAR_SET,
        MsgType.SEND_DATA, MsgType.SEND_MATRIX, MsgType.LOAD_SET,
        MsgType.GENERATE,
    })

    #: frames eligible for identical-query coalescing
    COALESCED_FRAMES = frozenset({MsgType.EXECUTE_COMPUTATIONS,
                                  MsgType.EXECUTE_PLAN})

    #: ops that accept the streamed-ingest conversation
    BULK_OPS = frozenset({MsgType.SEND_DATA, MsgType.RESYNC_FOLLOWER})

    #: a follower's applied log is compacted (its own store snapshotted
    #: as the log's new base, the log emptied) once it holds this many
    #: frames, or more bytes than both this floor and its base snapshot:
    #: a restart on its root replays a bounded tail, and the snapshots
    #: written stay within about the bytes logged
    applied_log_max_frames = 256
    applied_log_max_bytes = 256 << 20

    def __init__(self, config: Optional[Configuration] = None,
                 host: str = "127.0.0.1", port: int = 8108,
                 token: Optional[str] = None,
                 max_jobs: Optional[int] = None,
                 allow_pickle: bool = True,
                 followers: Optional[list] = None,
                 admission_timeout_s: float = 120.0,
                 frame_timeout_s: float = 30.0,
                 handshake_timeout_s: float = 10.0,
                 heartbeat_interval_s: float = 2.0,
                 heartbeat_timeout_s: float = 5.0,
                 heartbeat_misses: int = 3,
                 mirror_ack_timeout_s: Optional[float] = 300.0,
                 resync_grace_s: float = 30.0,
                 resync_timeout_s: float = 120.0,
                 workers: Optional[list] = None,
                 ha_peers: Optional[list] = None,
                 chaos=None, follower_chaos=None,
                 device=None):
        """The reference's constructor. ``device`` is the card the
        daemon owns (CUDA unless the caller asks for the CPU, as tests
        do). ``admission_timeout_s`` bounds a job's wait for a scheduler
        slot (then the typed retryable ``AdmissionFull``);
        ``frame_timeout_s`` bounds a frame once its first byte landed,
        a reply's drain, and a duplicate request's wait for its
        original; ``handshake_timeout_s`` bounds HELLO;
        ``mirror_ack_timeout_s`` bounds a follower's mirror ack (then it
        is evicted; None waits forever), a coalesced waiter and a
        scatter-gather's wait for its shards.

        ``followers``: addresses of follower daemons that mirror this
        one (module docstring); they are dialled lazily, with retry, on
        the first mirrored frame. ``workers``: addresses of shard
        daemons forming this leader's partitioned pool. The
        ``heartbeat_*`` knobs tune the health loops over both (a
        follower or worker missing ``heartbeat_misses`` probes in a row
        is evicted); ``resync_grace_s`` bounds a mutating frame's wait
        for a follower resync in progress (then the typed retryable
        ``FollowerDegraded``), ``resync_timeout_s`` every reply of a
        resync. ``ha_peers``: the ordered succession list that arms
        failover at :meth:`start` (every daemon of the pool passes the
        same list; index 0 leads first). ``chaos``/``follower_chaos``:
        :class:`~netsdb_tpu_torch.serve.chaos.ChaosInjector` objects for
        the client-facing and the leader→follower frames (tests)."""
        self.config = config if config is not None else Configuration()
        self.host = host
        self.port = port
        self.token = token
        self.allow_pickle = allow_pickle
        self.admission_timeout_s = admission_timeout_s
        self.frame_timeout_s = frame_timeout_s
        self.handshake_timeout_s = handshake_timeout_s
        self.heartbeat_interval_s = heartbeat_interval_s
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.heartbeat_misses = heartbeat_misses
        self.mirror_ack_timeout_s = mirror_ack_timeout_s
        self.resync_grace_s = resync_grace_s
        self.resync_timeout_s = resync_timeout_s
        self._chaos = chaos
        self._follower_chaos = follower_chaos
        # --- followers ------------------------------------------------
        # a follower address is in exactly one of {undialled, active
        # (_links), degraded (_degraded)}, all under _followers_mu;
        # _follower_offsets keeps each follower's mutation-log resume
        # offset (written at eviction and after every resync)
        self._follower_addrs: List[str] = list(followers or [])
        self._links: Dict[str, _FollowerLink] = {}
        self._degraded: Dict[str, str] = {}
        self._follower_offsets: Dict[str, int] = {}
        self._followers_mu = TrackedLock("ServeController._followers_mu")
        # the ordering model: _mirror_lock is held only to log and
        # enqueue a frame on every link, always under the frame's
        # ordering lock — the per-set lock with _order shared for
        # set-scoped frames, _order exclusive for the rest — so for
        # two conflicting frames the leader's execution order is every
        # follower's receipt order. Reads take none of these.
        self._mirror_lock = TrackedLock("ServeController._mirror_lock")
        self._order = _RWOrder()
        self._set_locks: Dict[Tuple[str, str], TrackedLock] = {}
        self._set_locks_mu = TrackedLock("ServeController._set_locks_mu")
        # set while a follower resync holds the write path; mutating
        # frames wait for it (bounded by resync_grace_s)
        self._resync_idle = threading.Event()
        self._resync_idle.set()
        self._resync_seq = itertools.count(1)
        #: how the last RESYNC_FOLLOWER restored ("wire")
        self.last_resync_mode: Optional[str] = None
        #: the last readmission this leader ran: mode ("snapshot" or
        #: "log"), bytes, frames replayed and seconds
        self.last_resync: Optional[Dict[str, Any]] = None
        self._health_thread: Optional[threading.Thread] = None
        # --- HA -------------------------------------------------------
        self._ha: Optional[_ha.HAState] = None
        self._ha_monitor: Optional[_ha.HAMonitor] = None
        self._ha_peers: List[str] = list(ha_peers or [])
        # the durable mutation log (ha_mutlog): every mirrored frame is
        # appended, so a readmitted follower replays what it missed; the
        # spill is the handoff buffer's disk copy
        self.mutlog: Optional[MutationLog] = None
        spill: Optional[MutationLog] = None
        #: this daemon process's identity, in its handshake: a leader
        #: trusts an acked offset only while the follower that acked it
        #: is the same process
        self.incarnation = uuid.uuid4().hex
        self._mutlog_id: Optional[str] = None
        # the follower half of ha_mutlog: the frames this daemon applied
        # as a follower, with their leader-log positions
        self._applied_log: Optional[MutationLog] = None
        self._applied_pos: Optional[list] = None
        # the base snapshot the log's records apply on (its id, its
        # bytes) and the frames logged on it
        self._applied_base: Optional[str] = None
        self._applied_base_bytes = 0
        self._applied_frames = 0
        #: the last rebuild at start and the last compaction (None
        #: until each happens): bytes, frames and seconds
        self.last_applied_restore: Optional[Dict[str, Any]] = None
        self.last_applied_compaction: Optional[Dict[str, Any]] = None
        # --- the shard pool -----------------------------------------
        # the leader's set → slot map (empty on a plain daemon, whose
        # placement probes then answer None); a worker's registrations
        # (db, set) → {"epoch", "slot"} of the slots it holds
        self._worker_addrs: List[str] = list(workers or [])
        self.placement = _placement.PlacementMap()
        self._shard_sets: Dict[Tuple[str, str], Dict[str, int]] = {}
        # registrations a reconcile pushed away (SHARD_RESYNC prune):
        # routed frames for them refuse typed
        self._pruned: set = set()
        self._shard_mu = TrackedLock("ServeController._shard_mu")
        self._pool_thread: Optional[threading.Thread] = None
        #: this daemon's address — rewritten by start() once the port
        #: is bound (port=0)
        self.advertise_addr = f"{host}:{port}"
        if self.config.ha_mutlog:
            logs = os.path.join(self.config.root_dir, "mutlog")
            self.mutlog = MutationLog(os.path.join(logs, "mirror.log"))
            self._mutlog_id = self._log_id(os.path.join(logs, "mirror.id"))
            spill = MutationLog(os.path.join(logs, "handoff.log"))
            self._applied_log = MutationLog(os.path.join(logs,
                                                         "applied.log"))
        self.library = Client(self.config, device=device)
        self.device = self.library.device
        if self.device.type == "cuda" and self.device.index is None:
            # handler threads select the card by index
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._idem = _IdempotencyCache(persist_path=os.path.join(
            self.config.root_dir, "idempotency.sqlite"))
        # pool connections, handoff buffers and the scatter coordinator;
        # inbound shuffle buckets
        self.shards = _shard.ShardPool(
            self, handoff_max_bytes=self.config.shard_handoff_bytes,
            spill=spill)
        self._shuffle = _shard.ShuffleInbox()
        self.sessions = _sessions.SessionManager(self)
        # observability: this daemon's ring of finished profiles (its
        # own, so two daemons of one process keep theirs apart), the SLO
        # engine, the telemetry history (its thread starts with the
        # listener and is joined at shutdown), the slow-query log and
        # the optional per-query device profiles, one session at a time
        from netsdb_tpu_torch.obs.history import TelemetryHistory
        from netsdb_tpu_torch.obs.slo import SLOEngine
        from netsdb_tpu_torch.obs.slowlog import SlowQueryLog

        cfg = self.config
        self._obs_enabled = bool(cfg.obs_enabled)
        self.trace_ring = obs.TraceRing(cfg.obs_trace_ring or 64)
        self.slo = SLOEngine()
        self.history = TelemetryHistory(
            capacity=cfg.obs_history_len or 0,
            interval_s=cfg.obs_history_interval_s or 0.0)
        self.slowlog = SlowQueryLog(cfg.root_dir,
                                    capacity=cfg.obs_slowlog_entries or 64,
                                    threshold_s=cfg.obs_slow_query_s)
        self._device_profile_dir = cfg.obs_device_profile_dir
        self._profiler_mu = TrackedLock("ServeController._profiler_mu")
        self.sched = _sched.QueryScheduler(
            slots=max_jobs or self.config.num_threads,
            lanes=self.config.sched_lanes,
            quota=self.config.sched_lane_quota,
            aging_every=self.config.sched_aging_every,
            coalesce=self.config.sched_coalesce,
            affinity=self.config.sched_affinity,
            affinity_wait_s=self.config.sched_affinity_wait_s,
            coalesce_wait_s=mirror_ack_timeout_s or 300.0,
            coalesce_done_ttl_s=self.config.sched_coalesce_done_ttl_s,
            coalesce_done_max=self.config.sched_coalesce_done_max,
            cache_probe=self._devcache_warm,
            feedback=cfg.sched_feedback,
            feedback_every=cfg.sched_feedback_every,
            # load shedding while an objective breaches on every window
            slo_source=(self.slo.breached_objectives
                        if cfg.sched_slo_shed else None))
        self._job_seq = itertools.count(1)
        self._jobs: Dict[int, Dict[str, Any]] = {}
        self._jobs_lock = TrackedLock("ServeController._jobs_lock")
        self._started = time.monotonic()
        self._busy_s = 0.0  # handler seconds of workload frames
        self._busy_mu = TrackedLock("ServeController._busy_mu")
        self._stop = threading.Event()
        self._listener: Optional[socket.socket] = None
        self._conns: set = set()
        self._conns_mu = TrackedLock("ServeController._conns_mu")
        self._threads: list = []
        self.handlers: Dict[MsgType, Callable[[Any], Tuple]] = {
            MsgType.PING: self._on_ping,
            MsgType.CREATE_DATABASE: self._on_create_database,
            MsgType.CREATE_SET: self._on_create_set,
            MsgType.REMOVE_SET: self._on_remove_set,
            MsgType.CLEAR_SET: self._on_clear_set,
            MsgType.SET_EXISTS: self._on_set_exists,
            MsgType.LIST_SETS: self._on_list_sets,
            MsgType.REGISTER_TYPE: self._on_register_type,
            MsgType.SEND_DATA: self._on_send_data,
            MsgType.SEND_MATRIX: self._on_send_matrix,
            MsgType.GET_TENSOR: self._on_get_tensor,
            MsgType.SCAN_SET: self._on_scan_set,
            MsgType.SCAN_SET_STREAM: self._on_scan_set_stream,
            MsgType.GET_TENSOR_CHUNKED: self._on_get_tensor_chunked,
            MsgType.ADD_SHARED_MAPPING: self._on_add_shared_mapping,
            MsgType.DEDUP_RESIDENT: self._on_dedup_resident,
            MsgType.FLUSH_DATA: self._on_flush_data,
            MsgType.LOAD_SET: self._on_load_set,
            MsgType.EXECUTE_COMPUTATIONS: self._on_execute_computations,
            MsgType.EXECUTE_PLAN: self._on_execute_plan,
            MsgType.LIST_JOBS: self._on_list_jobs,
            MsgType.COLLECT_STATS: self._on_collect_stats,
            MsgType.HEALTH: self._on_health,
            MsgType.ANALYZE_SET: self._on_analyze_set,
            MsgType.PAGED_MATMUL: self._on_paged_matmul,
            MsgType.PLACEMENT: self._on_placement,
            MsgType.SUBPLAN: self._on_subplan,
            MsgType.SHUFFLE_PUT: self._on_shuffle_put,
            MsgType.SHARD_RESYNC: self._on_shard_resync,
            MsgType.RESHARD: self._on_reshard,
            MsgType.SESSION_OPEN: self.sessions.handle_open,
            MsgType.GENERATE: self.sessions.handle_generate,
            MsgType.SESSION_CLOSE: self.sessions.handle_close,
            MsgType.GET_TRACE: self._on_get_trace,
            MsgType.PUT_TRACE: self._on_put_trace,
            MsgType.GET_METRICS: self._on_get_metrics,
            MsgType.RESYNC_FOLLOWER: self._on_resync_follower,
            MsgType.HA_STATE: self._on_ha_state,
            MsgType.TOKEN_ALIAS: self._on_token_alias,
            # the SPMD follower's read of its placed shards: processes
            # joined over one mesh (ROADMAP.md A4 part 3)
            MsgType.LOCAL_SHARDS: self._refuse("A4 part 3",
                                               MsgType.LOCAL_SHARDS),
        }

    @staticmethod
    def _refuse(item: str, typ: MsgType) -> Callable:
        def handler(p):
            raise NotImplementedError(
                f"{typ.name} is not ported yet: ROADMAP.md {item}")
        return handler

    # --- lifecycle ----------------------------------------------------
    def start(self) -> int:
        """Bind and start the listener thread; returns the bound port
        (``port=0`` picks an ephemeral one)."""
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((self.host, self.port))
        self._listener.listen(128)
        self.port = self._listener.getsockname()[1]
        self.advertise_addr = f"{self.host}:{self.port}"
        if self.mutlog is not None:
            # a restarted daemon reloads its placement map, its spilled
            # handoff buffer and its applied store before it serves
            self._restore_ha_runtime()
            self._restore_applied()
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name="netsdb-torch-serve-accept")
        t.start()
        self._threads.append(t)
        if (self.config.obs_history_len or 0) >= 2:
            self.history.start()
        self._start_pool_threads()
        if self._ha_peers:
            self.arm_ha(self._ha_peers)
        return self.port

    def _start_pool_threads(self) -> None:
        """(Re)start the follower and shard-pool health loops for the
        roles this daemon has now. Idempotent: promotion calls it again
        on a daemon that started with neither role."""
        if self._follower_addrs and (self._health_thread is None
                                     or not self._health_thread.is_alive()):
            self._health_thread = threading.Thread(
                target=self._health_loop, daemon=True,
                name="netsdb-torch-serve-health")
            self._health_thread.start()
            self._threads.append(self._health_thread)
        if self._worker_addrs and (self._pool_thread is None
                                   or not self._pool_thread.is_alive()):
            self._pool_thread = threading.Thread(
                target=self._pool_health_loop, daemon=True,
                name="netsdb-torch-serve-pool-health")
            self._pool_thread.start()
            self._threads.append(self._pool_thread)

    # --- HA: arming, promotion, durable restart -----------------------
    def arm_ha(self, peers: list,
               election_timeout_s: Optional[float] = None,
               probe_interval_s: Optional[float] = None) -> _ha.HAState:
        """Arm failover over the ordered succession list ``peers``
        (index 0 leads first; this daemon's ``advertise_addr`` must be
        in it). Call after :meth:`start`, so the address carries the
        bound port. ``election_timeout_s`` defaults to the config's
        ``ha_election_timeout_s``. Returns the live
        :class:`~netsdb_tpu_torch.serve.ha.HAState`."""
        if election_timeout_s is None:
            election_timeout_s = self.config.ha_election_timeout_s
        self._ha = _ha.HAState(
            self.advertise_addr, list(peers),
            state_dir=os.path.join(self.config.root_dir, "ha"))
        self._ha_monitor = _ha.HAMonitor(
            self, self._ha, election_timeout_s,
            probe_interval_s=probe_interval_s)
        self._ha_monitor.start()
        return self._ha

    def _promote_self(self) -> None:
        """Follower → leader, called by the HA monitor once every earlier
        succession peer stayed dead through the election window: mint
        the new term (fencing the deposed leader's stragglers), adopt
        the replicated placement map with the dead leader's slots
        rebound here, adopt the later peers as followers, and replicate
        the new state so routed clients re-point after one typed
        ``PlacementStale``."""
        ha = self._ha
        if ha is None or ha.role == _ha.LEADER:
            return
        old_leader = ha.leader_addr
        term = ha.promote()
        wire = ha.placement_wire()
        if wire and (wire.get("sets") or {}):
            self.placement.restore(wire)
        if old_leader and old_leader != self.advertise_addr:
            self.placement.rebind_addr(old_leader, self.advertise_addr)
        with self._followers_mu:
            self._follower_addrs = list(ha.later_peers())
        # the shard daemons the map names (less this one and the dead
        # leader) become this leader's pool
        pool = set()
        for ident in self.placement.sets():
            for slot in (self.placement.entry(*ident) or {}).get(
                    "slots", ()):
                pool.add(slot["addr"])
        pool.discard(self.advertise_addr)
        if old_leader:
            pool.discard(old_leader)
        for addr in sorted(pool):
            if addr not in self._worker_addrs:
                self._worker_addrs.append(addr)
        self._start_pool_threads()
        if self._worker_addrs:
            # the adopted map is authoritative: registrations it does
            # not grant are pruned on the workers
            self._push_epochs(prune=True)
        try:
            self._ensure_followers(
                timeout_s=min(self.heartbeat_timeout_s, 5.0))
        except FollowerDegraded as e:
            del e  # a dead later peer reattaches through the health loop
        self._replicate_placement()
        from netsdb_tpu_torch.utils.profiling import get_logger

        get_logger("netsdb_tpu_torch.serve").warning(
            "promoted %s to leader (term %d, deposed %s)",
            self.advertise_addr, term, old_leader)

    def _restore_ha_runtime(self) -> None:
        """The restart half of ``ha_mutlog``: reload the persisted
        placement map (rebinding this daemon's possibly new address) and
        the spilled handoff buffer, then mark the owners of slots still
        in handoff degraded, so the pool health loop readmits them and
        drains the restored buffer."""
        stored = self._load_placement()
        if stored:
            wire = stored.get("wire") or {}
            if wire.get("sets"):
                self.placement.restore(wire)
                old_addr = stored.get("advertise_addr")
                if old_addr and old_addr != self.advertise_addr:
                    self.placement.rebind_addr(old_addr,
                                               self.advertise_addr)
                self._push_epochs(prune=True)
        if self.shards.load_spill():
            owners = set()
            for ident in self.placement.sets():
                for slot in (self.placement.entry(*ident) or {}).get(
                        "slots", ()):
                    if slot.get("state") == _placement.HANDOFF \
                            and slot["addr"] != self.advertise_addr:
                        owners.add(slot["addr"])
            for addr in sorted(owners):
                self.shards.note_degraded(
                    addr, "handoff pending across leader restart")

    def _placement_path(self) -> str:
        return os.path.join(self.config.root_dir, "ha", "placement.json")

    def _save_placement(self) -> None:
        """Best-effort durable copy of the placement map (``ha_mutlog``
        only), written atomically; a failed save costs the next
        restart's reload, never this frame."""
        if self.mutlog is None:
            return
        import json

        path = self._placement_path()
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({"advertise_addr": self.advertise_addr,
                           "wire": self.placement.to_wire()}, f)
            os.replace(tmp, path)
        except OSError as e:
            del e

    def _load_placement(self) -> Optional[Dict[str, Any]]:
        import json

        try:
            with open(self._placement_path(), "r", encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _ha_state_payload(self) -> Dict[str, Any]:
        snap = self._ha.snapshot()
        return {"term": snap["term"], "leader": snap["leader"],
                "placement": self.placement.to_wire()}

    def _replicate_placement(self) -> None:
        """Ship (term, leader, placement) to every active follower on
        every epoch bump, through the ordered links (the map rides the
        same stream as the data it describes), so a promoted follower
        routes from the moment it wins."""
        self._save_placement()
        if self._ha is None or self._ha.role != _ha.LEADER:
            return
        payload = self._ha_state_payload()
        with self._followers_mu:
            links = list(self._links.values())
        for link in links:
            link.submit(MsgType.HA_STATE, dict(payload), CODEC_MSGPACK)

    def _send_token_alias(self, alias: str, target: str) -> None:
        """Ship one coalesce waiter's token → its flight leader's token
        to every active follower, after the leader's mirrored execution
        acked and through the same FIFO links (so the target's reply is
        already cached there). The wait is bounded; a miss costs that
        follower a re-execution on retry, never divergence."""
        payload: Dict[str, Any] = {"alias": alias, "target": target}
        if self._ha is not None:
            payload[HA_TERM_KEY] = self._ha.term
        if self.mutlog is not None:
            self.mutlog.append({"op": "alias", "alias": alias,
                                "target": target})
        with self._followers_mu:
            pending = [link.submit(MsgType.TOKEN_ALIAS, dict(payload),
                                   CODEC_MSGPACK)
                       for link in self._links.values()]
        deadline = deadline_after(self.heartbeat_timeout_s)
        for rec in pending:
            rec["done"].wait(max(seconds_left(deadline), 0.0))

    @staticmethod
    def _log_id(path: str) -> str:
        """The mutation log's identity (minted once, kept beside it): a
        follower's reported position counts only in this log."""
        try:
            with open(path, "r", encoding="utf-8") as f:
                return f.read().strip()
        except OSError:
            pass
        ident = uuid.uuid4().hex
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(ident)
        os.replace(tmp, path)
        return ident

    def _applied_snapshot_path(self) -> str:
        return os.path.join(self.config.root_dir, "mutlog",
                            "applied.snapshot")

    def _record_applied(self, typ, codec, payload, token,
                        pos: list) -> None:
        """A follower under ``ha_mutlog`` logs a mirrored frame it just
        applied (before its token is cached, so what the log holds and
        what the follower reports never fall behind the cache), then
        compacts the log once it passes its bounds
        (``applied_log_max_frames``, ``applied_log_max_bytes``)."""
        self._applied_log.append({"op": "frame", "typ": int(typ),
                                  "codec": codec, "payload": payload,
                                  "token": token, "pos": list(pos),
                                  "base": self._applied_base})
        self._applied_pos = list(pos)
        self._applied_frames += 1
        if (self._applied_frames >= self.applied_log_max_frames
                or self._applied_log.last_offset()
                > max(self.applied_log_max_bytes,
                      self._applied_base_bytes)) \
                and not self.sessions.table.count():
            self._compact_applied()

    def _compact_applied(self) -> None:
        """Snapshot this follower's own store as the new base of its
        applied log. It runs in the thread that applies the leader's
        frames, which arrive one at a time, so the snapshot holds
        exactly the frames up to ``_applied_pos``. Open decode sessions
        defer it (a snapshot holds sets, not sessions)."""
        from netsdb_tpu_torch.storage import checkpoint

        t0 = time.perf_counter()
        frames = self._applied_frames
        logged = self._applied_log.last_offset()
        blob = checkpoint.dumps_store(self._snapshot_state())
        self._save_applied_snapshot(blob, self._applied_pos)
        self.last_applied_compaction = {
            "frames": frames, "log_bytes": logged,
            "snapshot_bytes": len(blob),
            "seconds": time.perf_counter() - t0}
        obs.REGISTRY.counter("serve.applied_compactions").inc()

    def _save_applied_snapshot(self, blob, pos) -> None:
        """Make ``blob``, a store dump holding every frame up to the
        leader-log position ``pos``, the base of this follower's applied
        log, which restarts empty. The file holds the position and a new
        base id ahead of the dump, and every record names the base it
        was logged on: a crash between the rename and the truncate
        leaves records of the old base, which the restore skips."""
        import json
        import struct

        base = uuid.uuid4().hex
        head = json.dumps({"pos": list(pos) if pos else None,
                           "base": base}).encode()
        path = self._applied_snapshot_path()
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(struct.pack("!Q", len(head)))
            f.write(head)
            f.write(blob)
        os.replace(tmp, path)
        self._applied_log.truncate()
        self._applied_base = base
        self._applied_base_bytes = len(blob)
        self._applied_frames = 0
        self._applied_pos = list(pos) if pos else None

    def _restore_applied(self) -> None:
        """A follower restarted on its root rebuilds its store before it
        serves: its base snapshot, then the frames its applied log holds
        on that base, run through the handlers in order. Its position is
        the last one it applied; its handshake reports it."""
        import json
        import struct

        from netsdb_tpu_torch.storage import checkpoint

        t0 = time.perf_counter()
        path = self._applied_snapshot_path()
        if os.path.exists(path):
            with open(path, "rb") as f:
                (n,) = struct.unpack("!Q", f.read(8))
                head = json.loads(f.read(n))
                blob = f.read()
            self._restore_snapshot(checkpoint.loads_store(blob))
            self._applied_pos = head["pos"]
            self._applied_base = head["base"]
            self._applied_base_bytes = len(blob)
            del blob
        frames = 0
        for _end, rec in self._applied_log.replay(0):
            if rec.get("base") != self._applied_base:
                continue  # logged on an older base, which the snapshot holds
            reset = _sessions.idem_token.set(rec.get("token"))
            try:
                self.handlers[MsgType(rec["typ"])](dict(rec["payload"]))
            finally:
                _sessions.idem_token.reset(reset)
            self._applied_pos = list(rec["pos"])
            frames += 1
        self._applied_frames = frames
        if frames or self._applied_base is not None:
            self.last_applied_restore = {
                "snapshot_bytes": self._applied_base_bytes,
                "frames": frames,
                "log_bytes": self._applied_log.last_offset(),
                "seconds": time.perf_counter() - t0}
        if frames:
            obs.REGISTRY.counter("serve.applied_frames_restored").inc(frames)

    def serve_forever(self) -> None:
        if self._listener is None:
            self.start()
        try:
            while not self._stop.wait(0.5):
                pass
        except KeyboardInterrupt:
            pass
        finally:
            self.shutdown()

    def shutdown(self) -> None:
        self._stop.set()
        self.sessions.stop()
        # joined: no history thread outlives its daemon
        self.history.stop()
        with self._followers_mu:
            links = list(self._links.values())
        for link in links:
            link.close()
        self.shards.close()
        obs.REGISTRY.unregister_collector("sched", self.sched.snapshot)
        self._idem.close()
        if self.mutlog is not None:
            self.mutlog.close()
        if self._listener is not None:
            try:
                # wakes the accept loop (a bare close leaves the socket
                # listening until accept returns, so a daemon restarted
                # on this port could not bind)
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass
            self._listener = None
        with self._conns_mu:
            conns = list(self._conns)
        for sock in conns:  # idle handler threads block in recv
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    # --- connection handling ------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, addr = self._listener.accept()
            except OSError:
                return  # listener closed
            t = threading.Thread(target=self._serve_connection,
                                 args=(conn, addr), daemon=True)
            t.start()

    def _serve_connection(self, conn: socket.socket, addr) -> None:
        with self._conns_mu:
            self._conns.add(conn)
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            self._serve_connection_inner(conn)
        finally:
            with self._conns_mu:
                self._conns.discard(conn)
            conn.close()  # a handler that died must not leave its peer
            # waiting on an open socket

    def _serve_connection_inner(self, conn: socket.socket) -> None:
        with conn:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            try:
                conn.settimeout(self.handshake_timeout_s)
                typ, hello = recv_frame(conn, allow_pickle=False)
                if typ != MsgType.HELLO:
                    raise ProtocolError("expected HELLO")
                if hello.get("proto") != PROTO_VERSION:
                    send_frame(conn, MsgType.ERR, {
                        "error": "ProtocolVersionError",
                        "message": f"this daemon speaks wire format "
                                   f"v{PROTO_VERSION}; peer sent "
                                   f"proto={hello.get('proto')!r}",
                        "retryable": False})
                    return
                if self.token and hello.get("token") != self.token:
                    send_frame(conn, MsgType.ERR,
                               {"error": "AuthError", "message": "bad token"})
                    return
                ok_reply = {"server": "netsdb_tpu", "version": PROTO_VERSION,
                            PY_KEY: PY_TAG, "incarnation": self.incarnation}
                if self._applied_log is not None:
                    ok_reply["mirror_applied"] = self._applied_pos
                if len(self.placement):
                    # the map rides the handshake only while sharded sets
                    # exist (the plain handshake stays as it was)
                    ok_reply["placement"] = self.placement.to_wire()
                send_frame(conn, MsgType.OK, ok_reply)
                conn.settimeout(None)
            except (ProtocolError, ConnectionError, OSError):
                return
            # codec 1 only between peers of one interpreter (marshal)
            pickle_ok = self.allow_pickle and hello.get(PY_KEY) == PY_TAG
            while not self._stop.is_set():
                try:
                    typ, codec_in, raw, segs = recv_frame_raw(
                        conn, chaos=self._chaos,
                        mid_frame_timeout=self.frame_timeout_s)
                except (ProtocolError, ConnectionError, OSError):
                    return
                t_dec = time.perf_counter()
                try:
                    payload = self._decode(raw, codec_in, segs, pickle_ok,
                                           hello)
                except ProtocolError as e:
                    if not self._send_err(conn, e, retryable=False):
                        return
                    continue
                except Exception as e:
                    # a body that fails to decode never executed: a resend
                    # is safe, typed retryable
                    fault = CorruptFrame(f"{type(e).__name__}: {e}")
                    if not self._send_err(conn, fault, retryable=True):
                        return
                    continue
                if typ == MsgType.SHUTDOWN:
                    send_frame(conn, MsgType.OK, {})
                    self.shutdown()
                    return
                if typ == MsgType.BULK_BEGIN:
                    if not self._handle_bulk(conn, payload, pickle_ok):
                        return
                    continue
                if not self._dispatch_frame(
                        conn, typ, payload, codec=codec_in,
                        decode_s=time.perf_counter() - t_dec):
                    return

    def _decode(self, raw, codec_in, segs, pickle_ok: bool, hello) -> Any:
        if codec_in == CODEC_PICKLE and self.allow_pickle and not pickle_ok:
            raise ProtocolError(
                f"pickled frame refused: this daemon runs {PY_TAG} and the "
                f"peer named {hello.get(PY_KEY)!r}; functions pickled by "
                f"value load only under the interpreter that wrote them")
        return decode_body(raw, codec_in, pickle_ok, segments=segs)

    def _send_reply(self, conn, typ, payload, codec=CODEC_MSGPACK) -> None:
        """Reply under the same deadline as a mid-frame recv: a client
        that stops reading cannot wedge a handler thread."""
        conn.settimeout(self.frame_timeout_s)
        try:
            send_frame(conn, typ, payload, codec, chaos=self._chaos)
        finally:
            conn.settimeout(None)

    def _send_err(self, conn, exc, retryable: Optional[bool] = None,
                  with_traceback: bool = False) -> bool:
        """ERR frame for ``exc``; False when the connection is dead."""
        if retryable is None:
            retryable = bool(getattr(exc, "retryable", False))
        body = {"error": type(exc).__name__, "message": str(exc),
                "retryable": retryable}
        for field in BACKPRESSURE_FIELDS:
            value = getattr(exc, field, None)
            if value is not None:
                body[field] = value
        if with_traceback:
            body["traceback"] = traceback.format_exc(limit=20)
        try:
            self._send_reply(conn, MsgType.ERR, body)
            return True
        except OSError:
            return False

    def _dispatch_frame(self, conn, typ, payload, codec=CODEC_MSGPACK,
                        decode_s: float = 0.0) -> bool:
        """Execute one decoded request frame and send its reply; False
        when the connection is dead. A frame carrying a client-minted
        query id runs inside a trace on this daemon's ring (module
        docstring): back-dated by ``decode_s`` with a ``server.decode``
        span, annotated with the client, under a device profile when one
        is asked for and free, and logged to the slow-query log after it
        closes."""
        meta: Dict[str, Any] = {}
        if isinstance(payload, dict):
            for key in (QUERY_ID_KEY, CLIENT_ID_KEY, LANE_KEY,
                        IDEMPOTENCY_KEY, HA_TERM_KEY, MUTLOG_POS_KEY):
                meta[key] = payload.pop(key, None)
            if payload.pop(SESSION_KEY, None) is not None \
                    and meta[LANE_KEY] is None:
                meta[LANE_KEY] = DECODE_LANE
        meta["codec"] = codec
        qid = meta.get(QUERY_ID_KEY)
        if qid is None or not self._obs_enabled:
            return self._dispatch_traced(conn, typ, payload, meta)
        with obs.trace(str(qid), origin="server",
                       ring=self.trace_ring) as tr:
            if tr is not None:
                # the decode finished before the trace opened: the span
                # takes [0, decode_s] ahead of the dispatch, and the
                # total covers it
                tr.backdate(decode_s)
                tr.record("server.decode", decode_s, "serve", start_s=0.0)
                tr.add("frame.decode_s", decode_s)
                if meta.get(CLIENT_ID_KEY) is not None:
                    tr.annotate("client", str(meta[CLIENT_ID_KEY]))
            with self._maybe_device_profile(tr):
                ok = self._dispatch_traced(conn, typ, payload, meta)
        if tr is not None:
            self._maybe_slowlog(tr)
        return ok

    @contextlib.contextmanager
    def _maybe_device_profile(self, tr):
        """A ``torch.profiler`` session for one traced query
        (``obs_device_profile_dir``), written under ``<dir>/<qid>/``.
        One at a time: a concurrent traced query skips it instead of
        queueing behind the profiler. A profiler failure is annotated on
        the trace (``device_profile_error``) and never fails the
        query."""
        if (tr is None or not self._device_profile_dir
                or not self._profiler_mu.acquire(blocking=False)):
            yield
            return
        sess = None
        try:
            try:
                from netsdb_tpu_torch.utils.profiling import \
                    qid_profile_session

                sess = qid_profile_session(tr.qid, self._device_profile_dir,
                                           self.device)
                tr.annotate("device_profile", sess.__enter__())
            except Exception as e:  # noqa: BLE001 — annotated, not fatal
                tr.annotate("device_profile_error",
                            f"{type(e).__name__}: {e}")
                sess = None
            try:
                yield
            finally:
                if sess is not None:
                    try:
                        sess.__exit__(None, None, None)
                    except Exception as e:  # noqa: BLE001 — annotated
                        tr.annotate("device_profile_error",
                                    f"{type(e).__name__}: {e}")
        finally:
            self._profiler_mu.release()

    def _maybe_slowlog(self, tr) -> None:
        """Log a just-closed trace of ``obs_slow_query_s`` or more, from
        its ringed copy (which already holds a client section that came
        before the push). Never fails the request path."""
        try:
            thr = self.slowlog.threshold_s
            if not thr or tr.total_s is None or tr.total_s < thr:
                return
            ringed = self.trace_ring.find(tr.qid)
            self.slowlog.maybe_record(ringed[-1] if ringed
                                      else tr.profile())
        except Exception as e:  # noqa: BLE001 — counted, never fatal
            obs.REGISTRY.counter("obs.slowlog_errors").inc()
            del e

    def _dispatch_traced(self, conn, typ, payload, meta) -> bool:
        """The dispatch body, inside the trace if there is one. A retry
        of a completed mutating frame (same idempotency token) replays
        the cached reply. A workload frame observes ``serve.request_s``
        at its reply (a stream at its first frame) and ticks
        ``serve.requests`` and ``serve.requests_ok`` at its outcome;
        introspection frames tick nothing."""
        t0 = None if typ in OBS_FRAMES else time.perf_counter()
        observed = [False]

        def mark():
            if not observed[0] and t0 is not None:
                observed[0] = True
                dt = time.perf_counter() - t0
                obs.REGISTRY.histogram("serve.request_s").observe(dt)
                with self._busy_mu:
                    self._busy_s += dt

        def done(ok):
            if t0 is None:
                return
            obs.REGISTRY.counter("serve.requests").inc()
            if ok:
                obs.REGISTRY.counter("serve.requests_ok").inc()

        token = meta.get(IDEMPOTENCY_KEY)
        try:
            if token is not None:
                cached = self._idem.claim(token, wait_s=self.frame_timeout_s)
                if cached is not None:
                    self._remirror_retry(typ, payload, meta, cached)
                    self._send_reply(conn, *cached)
                    mark()
                    done(True)
                    return True
            with obs.span(f"server.dispatch:{getattr(typ, 'name', typ)}",
                          "serve"):
                out = self._execute_frame(
                    typ, payload, token, client=meta.get(CLIENT_ID_KEY),
                    lane=meta.get(LANE_KEY), qid=meta.get(QUERY_ID_KEY),
                    term=meta.get(HA_TERM_KEY),
                    codec=meta.get("codec", CODEC_MSGPACK),
                    pos=meta.get(MUTLOG_POS_KEY))
            if inspect.isgenerator(out):
                # streaming handler: each yielded (type, payload[, codec])
                # is a frame; the stream ends with STREAM_END or ERR
                for frame in out:
                    if len(frame) == 3:
                        f_type, f_payload, f_codec = frame
                    else:
                        (f_type, f_payload), f_codec = frame, CODEC_MSGPACK
                    self._send_reply(conn, f_type, f_payload, f_codec)
                    mark()  # time to first frame
                mark()
                done(True)
                return True
            with obs.span("server.reply", "serve"):
                self._send_reply(conn, *out)
            mark()
            done(True)
            return True
        except BrokenPipeError:
            mark()
            done(False)
            return False
        except Exception as e:  # handler errors go back as typed ERR
            mark()
            done(False)
            return self._send_err(conn, e, with_traceback=True)

    def _remirror_retry(self, typ, payload, meta, cached) -> None:
        """A retried mutation answered from the cache on a leader with
        followers is mirrored again (under its token, with a no-op local
        apply): a follower that missed it — the deposed leader applied
        it here but died before every follower had it — applies it now,
        the rest dedupe. A follower failure here only evicts it (its
        resync carries the frame); a deposed verdict raises."""
        if not (self._follower_addrs and typ in self.MIRRORED
                and isinstance(payload, dict)):
            return
        if self._ha is not None and meta.get(HA_TERM_KEY) is None:
            self._ha.check_client_write()
        try:
            self._run_mirrored(typ, payload,
                               meta.get("codec", CODEC_MSGPACK),
                               lambda p: cached,
                               token=meta.get(IDEMPOTENCY_KEY),
                               qid=meta.get(QUERY_ID_KEY),
                               client=meta.get(CLIENT_ID_KEY))
            obs.REGISTRY.counter("serve.remirrored_retries").inc()
        except FollowerDegraded as e:
            del e

    def _execute_frame(self, typ, payload, token, client=None, lane=None,
                       qid=None, term=None, codec=CODEC_MSGPACK, pos=None):
        """Run one request's handler with the idempotency-token
        lifecycle (the caller already claimed ``token``): the token is
        finished or aborted exactly once. The frame is attributed to its
        client (and set) and the client identity is installed for the
        handler's extent, so every layer below books under it.

        Under HA a peer frame's ``term`` is fenced against this daemon's
        (a stale one is a deposed leader's straggler: typed
        ``NotLeader``) and a client's mutation is refused unless this
        daemon leads. On a leader with followers a ``MIRRORED`` frame
        runs through :meth:`_run_mirrored`; ``codec``, ``qid``,
        ``client`` and the lane ride the forward. EXECUTE frames pass
        the scheduler's coalesce point first, before mirroring: a
        waiter absorbed by another flight mirrors nothing, and its token
        is aliased to the flight's on the followers (TOKEN_ALIAS). A
        mirrored frame with its leader-log position ``pos`` is logged to
        this follower's applied log once it applied."""
        handler = self.handlers.get(typ)
        if client is not None or isinstance(payload, dict):
            scope = None
            if isinstance(payload, dict) and payload.get("db") \
                    and payload.get("set"):
                scope = f"{payload['db']}:{payload['set']}"
            obs.attrib.account("requests", 1, scope=scope, client=client)
        winfo: Dict[str, Any] = {}
        applied = None
        if pos is not None and self._applied_log is not None \
                and typ in self.MIRRORED and isinstance(payload, dict):
            applied = dict(payload)  # as it came, before a handler pops
        try:
            if handler is None:
                raise ProtocolError(f"no handler for {typ!r}")
            if self._ha is not None:
                if term is not None:
                    self._ha.observe_term(term)
                elif typ in self.MIRRORED:
                    self._ha.check_client_write()

            def invoke():
                if self._follower_addrs and typ in self.MIRRORED:
                    return self._run_mirrored(typ, payload, codec, handler,
                                              token=token, qid=qid,
                                              client=client)
                return handler(payload)

            reset = _sessions.idem_token.set(token)
            try:
                with obs.attrib.client_context(client), \
                        _sched.lane_context(lane):
                    if typ in self.COALESCED_FRAMES:
                        out = self.sched.coalesced(
                            typ, payload, invoke, token=token,
                            waiter_info=winfo)
                    else:
                        out = invoke()
            finally:
                _sessions.idem_token.reset(reset)
        except FollowerDegraded as e:
            # the local mutation applied, only the mirror failed: the
            # token caches the local reply, so the client's retry is
            # answered without applying twice
            if token is not None:
                if e.local_result is not None:
                    self._idem.finish(token,
                                      self._normalize_reply(e.local_result))
                else:
                    self._idem.abort(token)
            raise
        except BaseException:
            if token is not None:
                self._idem.abort(token)
            raise
        if inspect.isgenerator(out):
            if token is not None:  # streams are never cached
                self._idem.abort(token)
            return out
        result = self._normalize_reply(out)
        if applied is not None:
            self._record_applied(typ, codec, applied, token, pos)
        if token is not None:
            self._idem.finish(token, result)
            ltok = winfo.get("leader_token")
            if ltok and ltok != token and self._follower_addrs:
                self._send_token_alias(token, ltok)
        return result

    @staticmethod
    def _normalize_reply(out) -> Tuple[MsgType, Any, int]:
        return out if len(out) == 3 else (out[0], out[1], CODEC_MSGPACK)

    def _devcache_warm(self, scope: str):
        """The scheduler's cache probe: True (no gating) for a disabled
        cache and for sets that are not paged; for a cold paged set
        False, or the covered prefix's end row when partly cached."""
        cache = self.library.store.device_cache()
        if not cache.enabled:
            return True
        covered = 0
        if cache.partial:
            covered, total = cache.coverage(scope)
            if total is not None and 0 < total <= covered:
                return True
        elif cache.has_scope(scope):
            return True
        db, _, set_name = scope.partition(":")
        try:
            storage = self.library.store.storage_of(
                SetIdentifier(db, set_name))
        except Exception as e:  # noqa: BLE001 — unknown set → ungated
            del e
            return True
        if storage != "paged":
            return True
        return int(covered) if covered > 0 else False

    # --- windowed bulk ingest (BULK_BEGIN/CHUNK/COMMIT) ---------------
    def _handle_bulk(self, conn, p, pickle_ok: bool) -> bool:
        """One streamed-ingest conversation: BEGIN (in ``p``) → N CHUNK
        frames, each acked once it decodes (the client pipelines a
        window of them) → COMMIT, which assembles the payload and runs
        it through the normal handler path. False when the connection
        must close (a mid-stream fault cannot be resynchronized: the
        client retries the whole conversation under its token)."""
        try:
            op = MsgType(int(p.get("op", -1)))
            if op not in self.BULK_OPS:
                raise ProtocolError(
                    f"op {p.get('op')!r} is not bulk-streamable")
            meta = dict(p.get("meta") or {})
        except (ProtocolError, ValueError) as e:
            return self._send_err(conn, e, retryable=False)
        token = p.get(IDEMPOTENCY_KEY)
        client = p.get(CLIENT_ID_KEY)
        cached = None
        if token is not None:
            try:
                cached = self._idem.claim(token, wait_s=self.frame_timeout_s)
            except Exception as e:  # RequestInFlight → typed retryable
                return self._send_err(conn, e)
            if cached is not None and not (self._follower_addrs
                                           and op in self.MIRRORED):
                # a completed execution: its reply goes out instead of "go"
                try:
                    self._send_reply(conn, *cached)
                    return True
                except OSError:
                    return False
        # a completed execution on a leader with followers streams again,
        # so its COMMIT can mirror it (:meth:`_remirror_retry`)
        owned = token is not None and cached is None
        try:
            try:
                if op == MsgType.RESYNC_FOLLOWER:
                    asm: _BulkAssembler = _BlobAssembler(meta)
                elif meta.get("mode") == "table":
                    asm = _TableAssembler(meta)
                else:
                    asm = _ItemsAssembler(meta, pickle_ok)
            except ProtocolError as e:
                return self._send_err(conn, e, retryable=False)
            if meta.get("pepoch") is not None or self.is_sharded(
                    meta.get("db"), meta.get("set")):
                # the placement-epoch gate at BEGIN: a stale map refuses
                # before the payload streams (COMMIT checks again)
                self._shard_route(meta.get("db"), meta.get("set"),
                                  meta.get("pepoch"), meta.get("slot"))
            term = p.get(HA_TERM_KEY)
            if self._ha is not None and op in self.MIRRORED \
                    and term is None:
                # the leadership gate at BEGIN, before the payload
                # streams (a peer's conversation is fenced at COMMIT)
                self._ha.check_client_write()
            self._send_reply(conn, MsgType.OK, {"go": True})
            total_in = 0
            while True:
                typ, codec_in, raw, segs = recv_frame_raw(
                    conn, chaos=self._chaos,
                    mid_frame_timeout=self.frame_timeout_s)
                total_in += len(raw) + sum(b.nbytes for b, _ in segs)
                if total_in > MAX_FRAME_BYTES:
                    self._send_err(conn, ProtocolError(
                        f"bulk conversation exceeded the "
                        f"{MAX_FRAME_BYTES}-byte cap"), retryable=False)
                    return False
                try:
                    payload = decode_body(raw, codec_in, pickle_ok,
                                          segments=segs)
                except ProtocolError:
                    raise
                except Exception as e:
                    raise CorruptFrame(f"{type(e).__name__}: {e}") from e
                if typ == MsgType.BULK_CHUNK:
                    asm.add(payload)
                    self._send_reply(conn, MsgType.OK,
                                     {"ack": payload.get("seq")})
                elif typ == MsgType.BULK_COMMIT:
                    if asm.chunks != int(payload.get("chunks", -1)):
                        raise CorruptFrame(
                            f"ingest stream torn: committed "
                            f"{payload.get('chunks')} chunks, received "
                            f"{asm.chunks}")
                    final_payload, fwd_codec = asm.finish()
                    if cached is not None:
                        self._remirror_retry(op, final_payload, {
                            "codec": fwd_codec, IDEMPOTENCY_KEY: token,
                            CLIENT_ID_KEY: client, HA_TERM_KEY: term},
                            cached)
                        self._send_reply(conn, *cached)
                        return True
                    if meta.get("pepoch") is not None:
                        # the routed epoch and slot ride to the apply,
                        # which validates them again
                        final_payload[PLACEMENT_EPOCH_KEY] = meta["pepoch"]
                        if meta.get("slot") is not None:
                            final_payload[SHARD_SLOT_KEY] = meta["slot"]
                    owned = False  # _execute_frame consumes the token
                    try:
                        result = self._execute_frame(
                            op, final_payload, token, client=client,
                            term=term, codec=fwd_codec)
                    except Exception as e:
                        # the handler refused after a whole conversation:
                        # the stream is in sync, the refusal goes back
                        # typed (a ProtocolError is deterministic)
                        return self._send_err(
                            conn, e, with_traceback=True,
                            retryable=False if isinstance(e, ProtocolError)
                            else None)
                    self._send_reply(conn, *result)
                    return True
                else:
                    raise ProtocolError(f"unexpected frame {typ!r} inside "
                                        f"a bulk-ingest conversation")
        except BrokenPipeError:
            return False
        except (ProtocolError, ConnectionError, OSError):
            return False  # transport desync — the client retries fresh
        except Exception as e:
            self._send_err(conn, e, with_traceback=True)
            return False
        finally:
            if owned:
                self._idem.abort(token)

    # --- followers: links, health, resync -------------------------------
    def _dial_follower(self, addr: str, timeout: Optional[float] = None):
        """One follower connection with mirror-path semantics: one
        attempt per request (a mirror failure must surface so the
        leader evicts and resyncs, never be hidden by a reconnect that
        breaks the frame order), a bounded dial and handshake, and
        ``timeout`` on replies (the resync's; mirror links have none: a
        mirrored EXECUTE may run for minutes, and the ack-timeout
        eviction covers a hang)."""
        from netsdb_tpu_torch.serve.client import RemoteClient, RetryPolicy

        return RemoteClient(addr, token=self.token,
                            retry=RetryPolicy(max_attempts=1),
                            chaos=self._follower_chaos, timeout=timeout,
                            connect_timeout=self.handshake_timeout_s,
                            ship_traces=False)

    def _ensure_followers(self, timeout_s: float = 30.0) -> None:
        """Dial every follower not yet connected, retrying while it
        comes up (leader and followers start in any order); each gets a
        :class:`_FollowerLink`. One that stays unreachable through
        ``timeout_s`` is evicted into the degraded state (the health
        loop keeps trying) and the frame that needed it fails typed
        retryable."""
        with self._followers_mu:
            undialled = [a for a in self._follower_addrs
                         if a not in self._links and a not in self._degraded]
        for addr in undialled:
            deadline = deadline_after(timeout_s)
            while True:
                try:
                    fc = self._dial_follower(addr)
                    with self._followers_mu:
                        self._links[addr] = _FollowerLink(addr, fc)
                    break
                except OSError as e:
                    if seconds_left(deadline) <= 0:
                        self._evict_follower(
                            addr, f"unreachable after {timeout_s:.0f}s: {e}")
                        raise FollowerDegraded(
                            f"follower daemon {addr} unreachable after "
                            f"{timeout_s:.0f}s; evicted for background "
                            f"reattach: {e}") from e
                    time.sleep(0.3)

    def _evict_follower(self, addr: str, reason: str) -> None:
        """Move a follower out of the mirror set into the degraded state
        (idempotent). The leader keeps serving from its own store; the
        health loop resyncs the follower before it is readmitted."""
        with self._followers_mu:
            link = self._links.pop(addr, None)
            if link is not None and link.acked_offset is not None:
                # everything up to this END offset is applied there, on
                # that process
                self._follower_offsets[addr] = (
                    link.acked_offset, link.client.daemon_incarnation)
            self._degraded[addr] = reason
        if link is not None:
            obs.REGISTRY.counter("serve.follower_evictions").inc()
            link.close(abort=True)

    def follower_status(self) -> Dict[str, Any]:
        with self._followers_mu:
            out = {"active": sorted(self._links),
                   "degraded": dict(self._degraded)}
        out["mirror_dropped"] = int(
            obs.REGISTRY.counter("serve.mirror_dropped").value)
        return out

    def _health_loop(self) -> None:
        """The leader's follower liveness: probe every active follower
        over its own short-timeout connection (never the ordered link: a
        probe must not queue behind a big forward), evict after
        ``heartbeat_misses`` failures in a row, and try to reattach and
        resync the degraded ones."""
        from netsdb_tpu_torch.serve.client import RemoteClient, RetryPolicy

        misses: Dict[str, int] = {}
        probes: Dict[str, Any] = {}
        while not self._stop.wait(self.heartbeat_interval_s):
            with self._followers_mu:
                active = list(self._links)
                degraded = list(self._degraded)
            for addr in active:
                try:
                    probe = probes.get(addr)
                    if probe is None:
                        probe = RemoteClient(
                            addr, token=self.token,
                            timeout=self.heartbeat_timeout_s,
                            retry=RetryPolicy(max_attempts=1))
                        probes[addr] = probe
                    probe.ping()
                    misses[addr] = 0
                except Exception as e:  # noqa: BLE001 — counted below
                    probe = probes.pop(addr, None)
                    if probe is not None:
                        probe.close()
                    misses[addr] = misses.get(addr, 0) + 1
                    if misses[addr] >= self.heartbeat_misses:
                        misses[addr] = 0
                        self._evict_follower(
                            addr, f"{self.heartbeat_misses} missed "
                                  f"heartbeats: {type(e).__name__}: {e}")
            for addr in degraded:
                if self._stop.is_set():
                    break
                self._try_reattach(addr)
        for probe in probes.values():
            probe.close()

    def _try_reattach(self, addr: str) -> bool:
        """Bring one degraded follower back: dial it, resync it by log
        replay from its acked offset when the mutation log still holds
        it, else by a whole-store snapshot, and readmit it. False while
        it stays down. The resync connection bounds every reply by
        ``resync_timeout_s``: the resync holds the write path, so a
        follower that answers the dial and then hangs must fail it."""
        try:
            fc = self._dial_follower(addr, timeout=self.resync_timeout_s)
        except OSError:
            return False
        try:
            offset = self._replay_from(addr, fc)
            if offset is not None:
                self._resync_follower_log(addr, fc, offset)
            else:
                self._resync_follower(addr, fc)
            return True
        except Exception as e:  # noqa: BLE001 — recorded, retried later
            fc.close()
            with self._followers_mu:
                if addr in self._degraded:
                    self._degraded[addr] = (f"resync failed: "
                                            f"{type(e).__name__}: {e}")
            return False

    def _replay_from(self, addr: str, fc) -> Optional[int]:
        """Where a reattaching follower's log replay starts, or None for
        a snapshot: the position it reports holding (its own applied
        log, valid across its restarts) when that is a position of this
        leader's log; else the offset it last acked, while it is still
        the same process (a follower restarted without an applied log
        lost its store)."""
        if self.mutlog is None:
            return None
        last = self.mutlog.last_offset()
        held = fc.daemon_applied
        if held and held[0] == self._mutlog_id and int(held[1]) <= last:
            return int(held[1])
        with self._followers_mu:
            acked = self._follower_offsets.get(addr)
        if acked is not None and acked[1] == fc.daemon_incarnation \
                and acked[0] <= last:
            return acked[0]
        return None

    def _readmit_follower(self, addr: str) -> None:
        """Install a fresh ordered link to a resynced follower (caller
        holds the exclusive order) and re-announce the HA state on it."""
        link = _FollowerLink(addr, self._dial_follower(addr))
        with self._followers_mu:
            self._degraded.pop(addr, None)
            self._links[addr] = link
        if self._ha is not None and self._ha.role == _ha.LEADER:
            link.submit(MsgType.HA_STATE, self._ha_state_payload(),
                        CODEC_MSGPACK)
        obs.REGISTRY.counter("serve.follower_readmits").inc()

    def _resync_follower(self, addr: str, fc) -> None:
        """Rebuild ``addr``'s store from a leader snapshot, then readmit
        it. The snapshot is taken under the exclusive frame order, so no
        mutation interleaves between what it holds and the first frame
        the readmitted follower sees; reads go on meanwhile. The snapshot
        pickles once, lands in the leader's ``<root>/resync`` (older
        steps pruned) and streams to the follower in bounded frames
        (:meth:`RemoteClient.resync_follower`). ``last_resync`` records
        the bytes and seconds."""
        from netsdb_tpu_torch.storage import checkpoint

        self._resync_idle.clear()
        self._order.acquire_write()
        try:
            t0 = time.perf_counter()
            step = next(self._resync_seq)
            root = os.path.join(self.config.root_dir, "resync")
            blob = checkpoint.dumps_store(self._snapshot_state())
            t_snap = time.perf_counter() - t0
            checkpoint.save_store_bytes(root, blob, step)
            pos = None
            if self.mutlog is not None:
                # the snapshot holds everything logged up to here (the
                # exclusive order keeps appends out)
                pos = [self._mutlog_id, self.mutlog.last_offset()]
            t1 = time.perf_counter()
            fc.resync_follower(blob, step, mutlog_pos=pos)
            t_stream = time.perf_counter() - t1
            fc.close()
            if pos is not None:
                with self._followers_mu:
                    self._follower_offsets[addr] = (pos[1],
                                                    fc.daemon_incarnation)
                checkpoint.save_meta(root, step, {"mutlog_offset": pos[1]})
            self._readmit_follower(addr)
            checkpoint.prune_steps(root, keep=1)
            self._idem.prune()
            self.last_resync = {"mode": "snapshot", "addr": addr,
                                "seq": step,
                                "bytes": len(blob), "snapshot_s": t_snap,
                                "stream_s": t_stream,
                                "total_s": time.perf_counter() - t0}
            obs.REGISTRY.counter("serve.resync.snapshots").inc()
            obs.REGISTRY.counter("serve.resync.snapshot_bytes").inc(
                len(blob))
        finally:
            self._order.release_write()
            self._resync_idle.set()

    def _resync_follower_log(self, addr: str, fc, offset: int) -> None:
        """Readmission by log replay (``ha_mutlog``): re-send every
        logged frame past ``offset``, then readmit — under the same
        exclusive order as the snapshot, so nothing appends between the
        replay bound and the new link. Each replayed frame carries its
        own idempotency token, or ``mutlog-<end>`` when it had none, so
        a frame the follower applied before it died dedupes; and the
        current term, so a deposed leader's replay is fenced."""
        self._resync_idle.clear()
        self._order.acquire_write()
        try:
            t0 = time.perf_counter()
            bound = self.mutlog.last_offset()
            frames = 0
            for end, rec in self.mutlog.replay(offset):
                if rec.get("op") == "alias":
                    fc._request(MsgType.TOKEN_ALIAS,
                                {"alias": rec["alias"],
                                 "target": rec["target"]}, CODEC_MSGPACK)
                    continue
                if rec.get("op") != "frame":
                    continue
                payload = dict(rec["payload"])
                payload.setdefault(IDEMPOTENCY_KEY, f"mutlog-{end}")
                payload[MUTLOG_POS_KEY] = [self._mutlog_id, end]
                if self._ha is not None:
                    payload[HA_TERM_KEY] = self._ha.term
                fc._request(MsgType(rec["typ"]), payload,
                            rec.get("codec", CODEC_PICKLE))
                frames += 1
            fc.close()
            with self._followers_mu:
                self._follower_offsets[addr] = (bound,
                                                fc.daemon_incarnation)
            self._readmit_follower(addr)
            self.last_resync = {"mode": "log", "addr": addr,
                                "seq": next(self._resync_seq),
                                "frames": frames,
                                "bytes": bound - offset,
                                "total_s": time.perf_counter() - t0}
            obs.REGISTRY.counter("serve.resync.log_replays").inc()
            obs.REGISTRY.counter("serve.resync.frames_replayed").inc(frames)
        finally:
            self._order.release_write()
            self._resync_idle.set()

    def _snapshot_state(self) -> Dict[str, Any]:
        """This daemon's replayable state as host values: databases,
        registered types, every set and the completed replies of its
        idempotency cache (a frame the snapshot holds, retried later,
        must dedupe on the follower). A card tensor comes to the host
        once (the caller holds the exclusive order, or is the thread
        that applies a follower's frames); a paged relation
        snapshots in its host-assembled form and a paged record set as
        its records, both re-paged on the follower; a paged matrix as
        its ordered arena page blocks (never dense); a placed set as its
        logical values with its placement, which the restore applies
        again. A type row carries its entry point; its ``source`` stays
        None, since shipping a type's module source is not ported
        (ROADMAP.md A7 part 2)."""
        from netsdb_tpu_torch.core.blocked import BlockedTensor
        from netsdb_tpu_torch.relational.outofcore import PagedColumns
        from netsdb_tpu_torch.relational.table import ColumnTable
        from netsdb_tpu_torch.storage.paged import PagedObjects
        from netsdb_tpu_torch.storage.store import _PagedMatrix

        cat = self.library.catalog
        store = self.library.store
        types = [{"type": t["type"], "entry_point": t["entry_point"],
                  "source": None} for t in cat.list_types()]
        sets = []
        for ident in store.list_sets():
            meta = cat.get_set(ident.db, ident.set) or {}
            storage = store.storage_of(ident)
            entry: Dict[str, Any] = {
                "db": ident.db, "set": ident.set,
                "type_name": meta.get("type", "tensor"),
                "persistence": meta.get("persistence", "transient"),
                "storage": storage}
            placement = store.placement_of(ident)
            if placement is not None:
                entry["placement"] = placement.to_meta()
            items = store.get_items(ident)
            one = items[0] if len(items) == 1 else None
            if storage == "paged":
                if isinstance(one, PagedColumns):
                    entry["kind"] = "paged-table"
                    entry["table"] = one.to_host_table()
                elif isinstance(one, PagedObjects):
                    entry["kind"] = "paged-objects"
                    entry["items"] = list(one)
                elif isinstance(one, _PagedMatrix):
                    ps = store.page_store()
                    with one.rw.read():
                        entry["blocks"] = [
                            np.array(b) for _, b in
                            ps.stream_blocks(one.name, prefetch=0)]
                        entry["row_block"] = int(ps.meta(one.name)[1][0])
                    entry["kind"] = "paged-matrix"
                else:
                    entry["kind"] = "paged-empty"
            elif isinstance(one, BlockedTensor):
                host = _shard._host_tree(one)  # a placed one's whole data
                entry["kind"] = "tensor"
                entry["dense"] = host.data[tuple(
                    slice(0, n) for n in host.meta.shape)].contiguous()
                entry["block_shape"] = list(one.meta.block_shape)
            elif isinstance(one, ColumnTable):
                entry["kind"] = "table"
                entry["table"] = one.to("cpu")
            else:
                entry["kind"] = "objects"
                entry["items"] = _shard._host_tree(list(items))
            sets.append(entry)
        return {"databases": cat.list_databases(), "types": types,
                "sets": sets, "idempotency": self._idem.export()}

    def _on_resync_follower(self, p):
        """Follower side: replace this daemon's store with the leader's
        snapshot, assembled from the streamed bulk conversation
        (``snapshot_blob``; no shared filesystem). The restore executes
        pickle, so it requires ``allow_pickle``. Tensors land on this
        daemon's device. Under ``ha_mutlog`` the blob and the leader-log
        position it holds (``mutlog_pos``) become the base of this
        follower's applied log."""
        if not self.allow_pickle:
            raise ProtocolError(
                "RESYNC_FOLLOWER refused: snapshot restore executes "
                "pickle and this daemon has allow_pickle off")
        from netsdb_tpu_torch.storage import checkpoint

        restored = self._restore_snapshot(
            checkpoint.loads_store(p["snapshot_blob"]))
        self.last_resync_mode = "wire"
        if self._applied_log is not None:
            # the snapshot is the base of this follower's applied log
            self._save_applied_snapshot(p["snapshot_blob"],
                                        p.get("mutlog_pos"))
        return MsgType.OK, {"restored_sets": restored}

    def _restore_snapshot(self, snap: Dict[str, Any]) -> int:
        """Replace this daemon's store with a ``_snapshot_state`` dump;
        returns the sets restored."""
        lib = self.library
        for ident in list(lib.store.list_sets()):
            lib.remove_set(ident.db, ident.set)
        for db in snap["databases"]:
            lib.create_database(db)
        for t in snap.get("types", []):
            lib.register_type(t["type"], t["entry_point"])
        restored = 0
        for entry in snap["sets"]:
            db, name = entry["db"], entry["set"]
            lib.create_set(db, name, type_name=entry["type_name"],
                           persistence=entry["persistence"],
                           placement=entry.get("placement"),
                           storage=entry.get("storage", "memory"))
            kind = entry["kind"]
            if kind == "tensor":
                lib.send_matrix(db, name, entry["dense"],
                                tuple(entry["block_shape"]))
            elif kind in ("paged-table", "table"):
                lib.send_table(db, name, entry["table"])
            elif kind == "paged-matrix":
                lib.store.restore_paged_matrix(
                    SetIdentifier(db, name), entry["blocks"],
                    int(entry.get("row_block") or 1))
            elif kind != "paged-empty" and entry["items"]:
                # verbatim: the items are already in their stored form
                lib.store.add_data(
                    SetIdentifier(db, name),
                    _shard._on_device(list(entry["items"]), self.device))
            restored += 1
        self._idem.adopt(snap.get("idempotency") or ())
        # the store was replaced wholesale: the dead device blocks go
        # back to the budget now
        lib.store.device_cache().clear()
        return restored

    # --- the mirror path -------------------------------------------------
    def _set_lock(self, db: str, set_name: str) -> TrackedLock:
        with self._set_locks_mu:
            return self._set_locks.setdefault(
                (db, set_name), TrackedLock("ServeController._set_locks[]"))

    def _run_mirrored(self, typ, payload, codec, handler, token=None,
                      qid=None, client=None):
        """Run one mirrored frame here and on every follower, holding
        its ordering lock across both the enqueue and the local handler
        (module docstring), which is what keeps the leader's order for
        conflicting frames equal to every follower's. A follower that
        fails after the local apply is evicted and the frame raises the
        typed retryable ``FollowerDegraded`` carrying the local reply
        (the token caches it, so the retry does not apply twice)."""
        if not self._resync_idle.wait(self.resync_grace_s):
            # a resync holds the write path: shed typed retryable
            raise FollowerDegraded(
                f"follower resync in progress (> {self.resync_grace_s}s); "
                f"retry shortly")
        if typ in self.SET_SCOPED_FRAMES and "db" in payload \
                and "set" in payload:
            self._order.acquire_read()
            try:
                with self._set_lock(payload["db"], payload["set"]):
                    return self._mirror_once(typ, payload, codec, handler,
                                             token, qid, client)
            finally:
                self._order.release_read()
        self._order.acquire_write()
        try:
            return self._mirror_once(typ, payload, codec, handler, token,
                                     qid, client)
        finally:
            self._order.release_write()

    def _mirror_once(self, typ, payload, codec, handler, token=None,
                     qid=None, client=None):
        # the client's token rides the forward (a frame re-forwarded
        # after a retryable local failure dedupes on the followers), as
        # do the query id (follower traces join the leader's), the
        # client id (follower attribution books the same tenant), the
        # lane and the term (a follower under a newer leader fences it)
        fwd = dict(payload)
        if token is not None:
            fwd[IDEMPOTENCY_KEY] = token
        if qid is not None:
            fwd[QUERY_ID_KEY] = qid
        if client is not None:
            fwd[CLIENT_ID_KEY] = client
        lane = _sched.current_lane()
        if lane is not None:
            fwd[LANE_KEY] = lane
        if self._ha is not None:
            fwd[HA_TERM_KEY] = self._ha.term
        fwd_codec = CODEC_PICKLE if codec == CODEC_PICKLE else CODEC_MSGPACK
        with self._mirror_lock:  # short: dial, log, ordered enqueue
            self._ensure_followers()
            offset = None
            if self.mutlog is not None:
                # appended inside the enqueue lock: the log's order is
                # every link's order
                offset = self.mutlog.append(
                    {"op": "frame", "typ": int(typ), "codec": fwd_codec,
                     "payload": fwd})
            sent = fwd
            if offset is not None:
                sent = dict(fwd)
                sent[MUTLOG_POS_KEY] = [self._mutlog_id, offset]
            with self._followers_mu:
                pending = [(addr, link.submit(typ, sent, fwd_codec,
                                              offset=offset))
                           for addr, link in self._links.items()]
        try:
            out = handler(payload)
        finally:
            failures, deposed = self._collect_mirror_failures(pending)
        if deposed is not None:
            # a follower answered NotLeader: it follows a newer term, so
            # this daemon was deposed while the frame was in flight —
            # step down and send the client to the real leader (the
            # local copy is private divergence, wiped when this daemon
            # rejoins as a follower and resyncs)
            addr, exc = deposed
            self._ha.step_down(getattr(exc, "term", None),
                               getattr(exc, "leader_addr", None))
            raise NotLeader(
                f"this daemon was deposed mid-mirror ({addr} rejected "
                f"the frame: {exc}); retry against the current leader",
                leader_addr=getattr(exc, "leader_addr", None),
                term=self._ha.term)
        if failures:
            exc = FollowerDegraded(
                "mirror failed; follower(s) evicted for resync: "
                + "; ".join(f"{a}: {m}" for a, m in failures))
            exc.local_result = out  # applied here: the retry must not redo
            raise exc
        return out

    def _collect_mirror_failures(self, pending) -> Tuple[list, Any]:
        """Wait (bounded by one shared ``mirror_ack_timeout_s``) for
        every follower's ack; evict the ones that failed or hung (the
        eviction aborts the link's socket, so its drain thread is
        released). Returns ``(failures, deposed)``: ``deposed`` is
        ``(addr, NotLeaderError)`` when a follower refused the frame for
        a newer term — a verdict on this daemon, not a follower fault,
        so that follower is kept."""
        deadline = (deadline_after(self.mirror_ack_timeout_s)
                    if self.mirror_ack_timeout_s is not None else None)
        failures = []
        deposed = None
        for addr, rec in pending:
            left = (max(0.0, seconds_left(deadline))
                    if deadline is not None else None)
            if not rec["done"].wait(left):
                failures.append(
                    (addr, f"no mirror ack within the frame's "
                           f"{self.mirror_ack_timeout_s}s budget"))
                self._evict_follower(
                    addr, f"mirror ack timeout "
                          f"({self.mirror_ack_timeout_s}s)")
            elif rec.get("error"):
                exc = rec.get("exc")
                if self._ha is not None and isinstance(exc, NotLeaderError):
                    if deposed is None:
                        deposed = (addr, exc)
                    continue
                failures.append((addr, rec["error"]))
                self._evict_follower(addr, rec["error"])
        return failures, deposed

    def _fanout_read(self, typ, payload) -> Dict[str, Any]:
        """Best-effort read fan-out to every active follower over its
        ordered link (the follower sections of COLLECT_STATS, HEALTH,
        GET_TRACE and GET_METRICS) under one shared deadline: a follower
        that cannot answer in time reports ``{"error": ...}`` and is
        never evicted by a read."""
        with self._followers_mu:
            links = dict(self._links)
        if not links:
            return {}
        recs = [(addr, link.submit(typ, payload, CODEC_MSGPACK))
                for addr, link in links.items()]
        deadline = deadline_after(self.frame_timeout_s)
        out: Dict[str, Any] = {}
        for addr, rec in recs:
            if not rec["done"].wait(max(0.0, seconds_left(deadline))):
                out[addr] = {"error": f"no reply within "
                                      f"{self.frame_timeout_s}s"}
            elif rec.get("error"):
                out[addr] = {"error": rec["error"]}
            else:
                out[addr] = rec["reply"]
        return out

    # --- jobs ----------------------------------------------------------
    def _run_job(self, job_name: str, fn: Callable[[], Any],
                 scopes=()) -> Any:
        """Admit and run one job under the query scheduler: its lane is
        the frame's lane hint, else its client identity, else the
        default; ``scopes`` ("db:set" scan leaves) pass the affinity
        gate."""
        job_id = next(self._job_seq)
        rec = {"id": job_id, "name": job_name, "status": "queued",
               "submitted": wall_now(), "elapsed": None, "lane": None}
        with self._jobs_lock:
            self._jobs[job_id] = rec
            while len(self._jobs) > 1024:
                self._jobs.pop(next(iter(self._jobs)))
        lane = _sched.current_lane() or obs.attrib.current_client()
        try:
            with obs.span("server.sched.admit", "serve"):
                ticket = self.sched.acquire(
                    lane, timeout_s=self.admission_timeout_s)
        except (AdmissionFull, LaneSaturated):
            rec["status"] = "rejected"
            raise
        rec["status"] = "running"
        rec["lane"] = ticket.lane
        t0 = time.perf_counter()
        try:
            with self.sched.affinity(scopes):
                with obs.span(f"server.job:{job_name}", "job"):
                    out = fn()
            rec["status"] = "done"
            return out
        except Exception:
            rec["status"] = "failed"
            raise
        finally:
            rec["elapsed"] = time.perf_counter() - t0
            self.sched.release(ticket)

    # --- handlers -----------------------------------------------------
    def _on_ping(self, p):
        with self._jobs_lock:
            done = sum(1 for j in self._jobs.values()
                       if j["status"] == "done")
        out = {"uptime": time.monotonic() - self._started,
               "jobs_done": done,
               "sets": len(self.library.store.list_sets())}
        if self._follower_addrs:
            out["followers"] = self.follower_status()
        if self._ha is not None:
            # the probe doubles as leader discovery: the HA monitor reads
            # the role and term straight off this
            out["ha"] = self._ha.snapshot()
        return MsgType.OK, out

    def _on_ha_state(self, p):
        """Leader → follower: (term, leader address, placement map),
        shipped through the ordered links on arming, readmission and
        every epoch bump, so a promoted follower already holds the map."""
        if self._ha is None:
            return MsgType.OK, {"armed": False}
        self._ha.adopt_leader(p.get("leader"), int(p.get("term") or 0))
        if p.get("placement"):
            self._ha.store_placement(p["placement"])
        return MsgType.OK, self._ha.snapshot()

    def _on_token_alias(self, p):
        """Leader → follower: finish a coalesce waiter's token with its
        flight leader's cached reply (the alias rides the same FIFO link
        as the mirrored execution, so the target is already cached)."""
        ok = self._idem.alias(str(p["alias"]), str(p["target"]))
        return MsgType.OK, {"aliased": bool(ok)}

    def _on_create_database(self, p):
        self.library.create_database(p["db"])
        return MsgType.OK, {}

    @staticmethod
    def _shard_mode(placement_arg) -> Tuple[Optional[str], Optional[str]]:
        """(mode, key) when ``placement`` asks for pool sharding — the
        strings ``"hash"``/``"range"`` or ``{"shard": mode, "key": col}``
        — else (None, None)."""
        if isinstance(placement_arg, str) \
                and placement_arg in ("hash", "range"):
            return placement_arg, None
        if isinstance(placement_arg, dict) and placement_arg.get("shard"):
            return str(placement_arg["shard"]), placement_arg.get("key")
        return None, None

    def _create_local_set(self, p, placement=None) -> None:
        self.library.create_set(
            p["db"], p["set"], type_name=p.get("type_name", "tensor"),
            persistence=p.get("persistence", "transient"),
            eviction=p.get("eviction", "lru"),
            partition_lambda=p.get("partition_lambda"),
            placement=placement, storage=p.get("storage", "memory"))

    def _on_create_set(self, p):
        shard_info = p.get("__shard__")
        if shard_info is not None:
            # a worker's side of a sharded create: its slot's local set
            # and the epoch routed frames are held against
            self.library.create_database(p["db"])
            self._create_local_set(p)
            self._register_shard(p["db"], p["set"], shard_info["slot"],
                                 shard_info["epoch"])
            return MsgType.OK, {}
        placement = p.get("placement")
        if placement == "mirror":
            placement = None  # the explicit spelling of the default
        mode, key = self._shard_mode(placement)
        if mode is None:
            self._create_local_set(p, placement)
            return MsgType.OK, {}
        # the leader's side: this daemon is slot 0, every worker one slot.
        # A degraded pool refuses before any mutation.
        degraded = self.shards.degraded()
        if degraded:
            raise ShardUnavailable(
                f"cannot create partitioned set {p['db']}:{p['set']}: pool "
                f"worker(s) {sorted(degraded)} are degraded; retry after "
                f"readmit")
        self._create_local_set(p)
        addrs = [self.advertise_addr] + list(self._worker_addrs)
        entry = self.placement.create(p["db"], p["set"], addrs, mode=mode,
                                      key=key)
        fwd = {k: v for k, v in p.items() if k != "placement"}
        try:
            for i, addr in enumerate(addrs[1:], start=1):
                self.shards.peer_request(
                    addr, MsgType.CREATE_SET,
                    {**fwd, "__shard__": {"slot": i,
                                          "epoch": entry["epoch"]}})
        except Exception as e:
            # a worker died mid-create: unregister the half-born entry
            # (a retry recreates over the local set)
            self.placement.remove(p["db"], p["set"])
            raise ShardUnavailable(
                f"partitioned create of {p['db']}:{p['set']} failed "
                f"mid-fanout ({type(e).__name__}: {e}); placement rolled "
                f"back — retry") from e
        self._replicate_placement()
        return MsgType.OK, {"placement": entry}

    def _fanout_sharded_ddl(self, typ, p) -> bool:
        """Forward one DDL frame to every worker slot of a sharded set,
        all or nothing: a degraded slot refuses typed retryable (a DDL
        that skipped it would diverge it). True when the set is
        sharded."""
        entry = self.placement.entry(p["db"], p["set"])
        if entry is None:
            return False
        for i, sl in enumerate(entry["slots"]):
            if sl["state"] != _placement.LIVE:
                raise ShardUnavailable(
                    f"slot {i} of {p['db']}:{p['set']} ({sl['addr']}) is "
                    f"degraded; pool-wide DDL refused rather than diverge "
                    f"the absent shard — retry after readmit",
                    slot=i, epoch=entry["epoch"])
        for sl in entry["slots"]:
            if sl["addr"] != self.advertise_addr:
                self.shards.peer_request(sl["addr"], typ,
                                         {"db": p["db"], "set": p["set"]})
        return True

    def _on_remove_set(self, p):
        if self._fanout_sharded_ddl(MsgType.REMOVE_SET, p):
            self.placement.remove(p["db"], p["set"])
            self._replicate_placement()
        # the set's buffered handoff dies with it
        self.shards.purge_handoff(p["db"], p["set"])
        with self._shard_mu:
            self._shard_sets.pop((p["db"], p["set"]), None)
        self.library.remove_set(p["db"], p["set"])
        return MsgType.OK, {}

    def _on_clear_set(self, p):
        if self._fanout_sharded_ddl(MsgType.CLEAR_SET, p):
            self.shards.purge_handoff(p["db"], p["set"])
        self.library.clear_set(p["db"], p["set"])
        return MsgType.OK, {}

    def _on_set_exists(self, p):
        return MsgType.OK, {"exists": self.library.set_exists(p["db"],
                                                              p["set"])}

    def _on_list_sets(self, p):
        return MsgType.OK, {"sets": [list(i) for i in
                                     self.library.store.list_sets()]}

    def _on_register_type(self, p):
        if p.get("source") is not None:
            raise NotImplementedError(
                "register_type(source=...): shipping a type's module "
                "source is not ported yet: ROADMAP.md A7 part 2")
        self.library.register_type(p["type_name"], p["entry_point"])
        return MsgType.OK, {}

    def _resolve_registered(self, name_or_entry: str) -> Any:
        entry = self.library.catalog.get_type(name_or_entry)
        return resolve_entry_point(entry or name_or_entry)

    def _on_send_data(self, p):
        epoch = p.pop(PLACEMENT_EPOCH_KEY, None)
        slot = p.pop(SHARD_SLOT_KEY, None)
        if self._shard_route(p.get("db"), p.get("set"), epoch,
                             slot) == "handoff":
            # the slot's shard is away: buffer exactly this batch at the
            # leader under the client's token; the readmit drain ships it
            items = p.get("items")
            count = int(getattr(items, "num_rows", None)
                        or (len(items) if hasattr(items, "__len__") else 0))
            self.shards.handoff_put(p["db"], p["set"], int(slot),
                                    _sessions.idem_token.get(), p)
            return MsgType.OK, {"count": count, "handoff": True}
        if p.get("as_table"):
            t = self.library.send_table(p["db"], p["set"], p["items"],
                                        date_cols=p.get("date_cols", ()),
                                        append=bool(p.get("append")))
            return MsgType.OK, {"count": int(t.num_rows),
                                "columns": sorted(t.cols)}
        self.library.send_data(p["db"], p["set"], p["items"])
        return MsgType.OK, {"count": len(p["items"])}

    def _on_send_matrix(self, p):
        # a batch-partitioned tensor set (the serving input) takes routed
        # frames like SEND_DATA: each slot ingests its contiguous rows
        epoch = p.pop(PLACEMENT_EPOCH_KEY, None)
        slot = p.pop(SHARD_SLOT_KEY, None)
        if self._shard_route(p.get("db"), p.get("set"), epoch,
                             slot) == "handoff":
            # a scoring batch is transient: no handoff buffering
            raise ShardUnavailable(
                f"slot {slot} of {p['db']}:{p['set']} is degraded; matrix "
                f"ingest refused — retry after readmit",
                slot=slot, epoch=epoch)
        dense, block_shape = tensor_from_wire(p["tensor"])
        t = self.library.send_matrix(p["db"], p["set"], dense, block_shape)
        return MsgType.OK, {"shape": list(t.shape),
                            "dtype": str(t.dtype).replace("torch.", ""),
                            "block_shape": list(t.meta.block_shape)}

    def _on_paged_matmul(self, p):
        out = self.library.paged_matmul(p["db"], p["set"],
                                        np.asarray(p["rhs"]))
        return MsgType.OK, {"data": out.detach().cpu().numpy()}

    def _on_get_tensor(self, p):
        t = self.library.get_tensor(p["db"], p["set"])
        return MsgType.OK, {"data": _dense_host(t),
                            "block_shape": list(t.meta.block_shape)}

    def _scan_items(self, db: str, set_name: str):
        """A set's items for the wire, on the host: a paged relation as
        its host-assembled table, a paged record set record by record; a
        paged matrix streams through PAGED_MATMUL and refuses a scan."""
        from netsdb_tpu_torch.relational.outofcore import PagedColumns

        entry = self.placement.entry(db, set_name)
        if entry is not None:
            # a sharded set: every slot's scan in slot order, the
            # workers' over their pool connections
            for i, sl in enumerate(entry["slots"]):
                if sl["state"] != _placement.LIVE:
                    raise ShardUnavailable(
                        f"slot {i} of {db}:{set_name} ({sl['addr']}) is "
                        f"degraded; scan refused rather than return a "
                        f"partial set", slot=i, epoch=entry["epoch"])
            for sl in entry["slots"]:
                if sl["addr"] == self.advertise_addr:
                    yield from self._scan_items_local(db, set_name)
                else:
                    with contextlib.closing(self.shards.client(
                            sl["addr"]).scan_stream(db, set_name)) as items:
                        yield from items
            return
        yield from self._scan_items_local(db, set_name)

    def _scan_items_local(self, db: str, set_name: str):
        from netsdb_tpu_torch.relational.outofcore import PagedColumns

        ident = SetIdentifier(db, set_name)
        items = self.library.store.get_items(ident)
        if len(items) == 1 and isinstance(items[0], PagedColumns):
            yield items[0].to_host_table()
            return
        for value in self.library.store.scan(ident):
            yield _to_host(value)

    def _on_scan_set(self, p):
        items = list(self._scan_items(p["db"], p["set"]))
        return MsgType.OK, {"items": items}, CODEC_PICKLE

    def _on_scan_set_stream(self, p):
        """Streamed scan: items go out in frames of about
        ``max_frame_bytes`` of pickled items each; the items per frame
        track the previous frame's bytes per item (growth capped at 4×
        per frame, the first frame holds one item). A paged relation
        streams one host chunk table per frame."""
        import contextlib
        import pickle

        from netsdb_tpu_torch.relational.outofcore import PagedColumns

        budget = int(p.get("max_frame_bytes") or (4 << 20))
        ident = SetIdentifier(p["db"], p["set"])
        store = self.library.store
        if store.storage_of(ident) == "paged" \
                and not self.is_sharded(p["db"], p["set"]):
            items = store.get_items(ident)
            if len(items) == 1 and isinstance(items[0], PagedColumns):
                pc = items[0]

                def pages():
                    # one host chunk table per frame, straight off the
                    # arena stream: the relation never materializes
                    seq = 0
                    with contextlib.closing(
                            pc.stream_host_tables(prefetch=2)) as chunks:
                        for tbl in chunks:
                            yield MsgType.STREAM_ITEM, {
                                "seq": seq, "paged_chunk": True,
                                "batch": pickle.dumps(
                                    [tbl],
                                    protocol=pickle.HIGHEST_PROTOCOL)}
                            seq += 1
                    yield MsgType.STREAM_END, {"frames": seq, "items": seq}

                return pages()

        def stream():
            seq = total = 0
            target = 1
            batch: list = []
            for item in self._scan_items(p["db"], p["set"]):
                batch.append(item)
                if len(batch) < target:
                    continue
                blob = pickle.dumps(batch, protocol=pickle.HIGHEST_PROTOCOL)
                yield MsgType.STREAM_ITEM, {"seq": seq, "batch": blob}
                seq += 1
                total += len(batch)
                per_item = max(len(blob) // len(batch), 1)
                target = max(1, min(budget // per_item, 4 * target))
                batch = []
            if batch:
                yield MsgType.STREAM_ITEM, {
                    "seq": seq, "batch": pickle.dumps(
                        batch, protocol=pickle.HIGHEST_PROTOCOL)}
                seq += 1
                total += len(batch)
            yield MsgType.STREAM_END, {"frames": seq, "items": total}

        return stream()

    def _on_get_tensor_chunked(self, p):
        """Chunked tensor pull: a meta frame, the dense buffer in
        ``chunk_bytes`` slices riding out of band, then STREAM_END."""
        t = self.library.get_tensor(p["db"], p["set"])
        dense = _dense_host(t)
        chunk = int(p.get("chunk_bytes") or (8 << 20))
        view = memoryview(dense).cast("B")
        nbytes = view.nbytes

        def stream():
            yield MsgType.STREAM_ITEM, {
                "seq": 0, "meta": {
                    "shape": list(dense.shape), "dtype": dense.dtype.str,
                    "block_shape": list(t.meta.block_shape),
                    "nbytes": nbytes,
                    "nchunks": max(1, -(-nbytes // chunk))}}
            seq = 1
            for off in range(0, max(nbytes, 1), chunk):
                yield MsgType.STREAM_ITEM, {
                    "seq": seq,
                    "b": np.frombuffer(view[off:off + chunk], np.uint8)}
                seq += 1
            yield MsgType.STREAM_END, {"frames": seq}

        return stream()

    def _on_dedup_resident(self, p):
        report = self.library.dedup_resident(
            [tuple(s) for s in p["sets"]], bands=int(p.get("bands", 16)),
            seed=int(p.get("seed", 0)))
        return MsgType.OK, report

    def _on_add_shared_mapping(self, p):
        self.library.add_shared_mapping(
            p["private_db"], p["private_set"], p["shared_db"],
            p["shared_set"], p.get("mapping"))
        return MsgType.OK, {}

    def _on_flush_data(self, p):
        self.library.flush_data()
        return MsgType.OK, {}

    def _on_load_set(self, p):
        self.library.store.load_set(SetIdentifier(p["db"], p["set"]))
        return MsgType.OK, {}

    def _sync_results(self, results: Dict[SetIdentifier, Any]) -> None:
        """The OK reply means the values exist, not that they were
        enqueued. Waits for this handler's stream only: the request's
        work ran there (a build's eager run on the capture stream is
        joined back to it), and a device-wide wait fails while another
        handler thread captures a graph."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    @staticmethod
    def _result_summaries(results: Dict[SetIdentifier, Any]) -> dict:
        from netsdb_tpu_torch.core.blocked import BlockedTensor
        from netsdb_tpu_torch.relational.table import ColumnTable

        out = {}
        for ident, val in results.items():
            if isinstance(val, BlockedTensor):
                out[str(ident)] = {"kind": "tensor",
                                   "shape": list(val.shape),
                                   "dtype": str(val.dtype).replace(
                                       "torch.", "")}
            elif isinstance(val, ColumnTable):
                out[str(ident)] = {"kind": "table",
                                   "rows": int(val.num_rows),
                                   "columns": sorted(val.cols)}
            elif isinstance(val, dict):
                out[str(ident)] = {"kind": "map", "count": len(val)}
            elif isinstance(val, torch.Tensor):
                # a set holding one plain tensor (the layer's output)
                out[str(ident)] = {"kind": "objects", "count": 1}
            else:
                out[str(ident)] = {"kind": "objects",
                                   "count": len(list(val))}
        return out

    def _scatter_touched(self, sinks) -> bool:
        """Does the DAG scan a set this daemon coordinates a partitioned
        placement for? An empty map (every plain daemon) answers at
        once."""
        if not len(self.placement):
            return False
        from netsdb_tpu_torch.plan import scatter

        return bool(scatter.sharded_scan_sets(sinks, self.is_sharded))

    def _execute_scatter(self, p, sinks, job_name):
        """The coordinator path over partitioned sets: ONE admitted job
        scatters a subplan to every slot and merges all or nothing; the
        reply has the local path's shape. ``explain`` replies carry the
        coordinator slot's tree as ``operators`` and the per-shard forest
        as ``shard_operators``."""
        explain = bool(p.get("explain"))
        tr = obs.current_trace()
        qid = tr.qid if tr is not None else None
        client = obs.attrib.current_client()
        holder: Dict[str, Any] = {}

        def run():
            # the subplans carry the query id: each worker traces its
            # part under it, and GET_TRACE merges them by qid
            results, shard_ops = self.shards.scatter_execute(
                sinks, job_name, materialize=p.get("materialize", True),
                explain=explain, qid=qid, client_id=client)
            if p.get("sync", True):
                self._sync_results(results)
            holder["ops"] = shard_ops
            return results

        scopes = _sched.sets_touched(MsgType.EXECUTE_COMPUTATIONS,
                                     {"sinks": sinks})
        results = self._run_job(job_name, run, scopes=scopes)
        out: Dict[str, Any] = {"results": self._result_summaries(results)}
        if explain:
            ops = holder.get("ops") or {}
            if ops.get(self.advertise_addr) is not None:
                out["operators"] = ops[self.advertise_addr]
            out["shard_operators"] = ops
        return MsgType.OK, out

    def _execute(self, p, sinks, job_name):
        if self._scatter_touched(sinks):
            return self._execute_scatter(p, sinks, job_name)

        def run():
            results = self.library.execute_computations(
                *sinks, job_name=job_name,
                materialize=p.get("materialize", True))
            if p.get("sync", True):
                self._sync_results(results)
            return results

        scopes = _sched.sets_touched(MsgType.EXECUTE_COMPUTATIONS,
                                     {"sinks": sinks})
        if p.get("explain"):
            with obs.operators.explain_capture() as cap:
                results = self._run_job(job_name, run, scopes=scopes)
            out = {"results": self._result_summaries(results)}
            if cap.get("operators") is not None:
                out["operators"] = cap["operators"]
            return MsgType.OK, out
        results = self._run_job(job_name, run, scopes=scopes)
        return MsgType.OK, {"results": self._result_summaries(results)}

    def _on_execute_computations(self, p):
        """Body (pickle codec): ``{sinks: [WriteSet...], job_name,
        materialize, explain}``; ``explain`` round-trips the operator
        tree (EXPLAIN ANALYZE over the wire)."""
        return self._execute(p, p["sinks"],
                             p.get("job_name", "remote-job"))

    def _on_execute_plan(self, p):
        """Body (MessagePack): ``{plan: text, registry: {label: entry
        point or {kwargs..., fn: entry point}}, job_name}`` — execution
        with no pickle: labels bind to registered entry points."""
        from netsdb_tpu_torch.plan.parser import parse_plan

        registry: Dict[str, Any] = {}
        for label, spec in (p.get("registry") or {}).items():
            if isinstance(spec, str):
                registry[label] = self._resolve_registered(spec)
            elif isinstance(spec, dict):
                kw = dict(spec)
                for k, v in list(kw.items()):
                    if isinstance(v, str) and ":" in v:
                        kw[k] = self._resolve_registered(v)
                registry[label] = kw
            else:
                raise ProtocolError(
                    f"registry entry for {label!r} must be an entry-point "
                    f"string or kwargs dict")
        sinks = parse_plan(p["plan"]).to_computations(registry)
        return self._execute(p, sinks, p.get("job_name", "remote-plan"))

    def _on_list_jobs(self, p):
        with self._jobs_lock:
            return MsgType.OK, {"jobs": [dict(j) for j in
                                         self._jobs.values()]}

    def _serve_stats(self) -> Dict[str, Any]:
        with self._busy_mu:
            busy = self._busy_s
        out = {"uptime_s": time.monotonic() - self._started,
               "busy_s": busy, "device": str(self.device),
               "pid": os.getpid()}
        if self.device.type == "cuda":
            # this process's allocator on the card (a pool's daemons each
            # hold their own context and graph pools)
            out["memory_reserved"] = torch.cuda.memory_reserved(self.device)
            out["max_memory_reserved"] = torch.cuda.max_memory_reserved(
                self.device)
        return out

    def _on_collect_stats(self, p):
        """This daemon's statistics (with ``mirror`` — the follower
        links and the dropped-frame count — on a leader with followers,
        and ``ha`` when armed); a leader adds each follower's under
        ``followers`` and each pool worker's under ``shards`` (best
        effort: a slow peer reports an error entry and is never evicted
        by a read)."""
        store = self.library.store
        out = {"sets": self.library.collect_stats(),
               "cache": dict(vars(store.stats)),
               "device_cache": store.device_cache().stats(),
               "metrics": obs.REGISTRY.snapshot(),
               "sessions": self.sessions.stats(),
               "serve": self._serve_stats()}
        if self._follower_addrs:
            out["mirror"] = dict(self.follower_status(),
                                 last_resync=self.last_resync)
        if self._applied_log is not None:
            out["mirror_applied"] = self._applied_pos
            out["applied_log"] = {
                "frames": self._applied_frames,
                "bytes": self._applied_log.last_offset(),
                "restore": self.last_applied_restore,
                "compaction": self.last_applied_compaction}
        if self._ha is not None:
            out["ha"] = self._ha.snapshot()
        if not p.get("local_only"):
            followers = self._fanout_read(MsgType.COLLECT_STATS,
                                          {"local_only": True})
            if followers:
                out["followers"] = followers
            shards = self.shards.fanout(MsgType.COLLECT_STATS,
                                        {"local_only": True})
            if shards:
                out["shards"] = shards
        return MsgType.OK, out

    def _on_health(self, p):
        """The SLO and health readout: every objective evaluated with its
        multi-window burn rates (``obs/slo.py``), the recent breach and
        recovery events, the slow-query log's summary, and this daemon's
        load; a leader with followers reports their links under
        ``followers_status`` and adds each follower's readout under
        ``followers``, a pool leader each worker's under ``shards`` and
        the pool's membership under ``pool`` (best effort: a slow peer
        reports an error entry and is never evicted by a read)."""
        out = {"objectives": self.slo.evaluate(),
               "events": self.slo.events(),
               "slowlog": self.slowlog.summary(),
               "followers_status": (self.follower_status()
                                    if self._follower_addrs else None),
               "serve": self._serve_stats(),
               "sessions_open": self.sessions.table.count(),
               "sched": self.sched.snapshot()}
        if not p.get("local_only"):
            followers = self._fanout_read(MsgType.HEALTH,
                                          {"local_only": True})
            if followers:
                out["followers"] = followers
            shards = self.shards.fanout(MsgType.HEALTH, {"local_only": True})
            if shards:
                out["shards"] = shards
        if self._worker_addrs:
            out["pool"] = {"workers": list(self._worker_addrs),
                           "degraded": self.shards.degraded(),
                           "placement_epoch":
                               self.placement.to_wire()["epoch"]}
        return MsgType.OK, out

    def _on_put_trace(self, p):
        """The client half of a traced query, shipped after its reply:
        merged into the qid's ringed profile (or held until the profile
        is pushed) and into its slow-query log entry as the ``client``
        section. An unmatched qid is counted, not an error."""
        prof = p.get("profile")
        if not isinstance(prof, dict):
            raise ProtocolError("PUT_TRACE needs a profile dict")
        qid = str(p.get("qid") or prof.get("qid") or "")
        merged = slow = False
        if qid and self._obs_enabled:
            merged = self.trace_ring.merge_section(qid, "client", prof)
            try:
                # a slow query was logged when its trace closed, before
                # this section existed: rewrite the entry
                slow = self.slowlog.merge_section(qid, "client", prof)
            except Exception as e:  # noqa: BLE001 — counted, never fatal
                obs.REGISTRY.counter("obs.slowlog_errors").inc()
                del e
        obs.REGISTRY.counter("obs.put_trace.merged" if merged
                             else "obs.put_trace.unmatched").inc()
        return MsgType.OK, {"merged": merged, "slowlog_merged": slow}

    def _on_get_trace(self, p):
        """The last N finished profiles of this daemon's ring, or one
        query's (``qid``); ``slow: true`` reads the slow-query log
        instead (the qid filter applies before the last-N cut). On a
        leader each profile carries, under ``followers``, the profiles
        its followers recorded under the same qid (a mirrored request
        forwards it), and on a pool leader under ``shards`` its
        workers' (a scatter-gather's subplans); the peers' replies ride
        under ``followers`` and ``shards``."""
        n = p.get("last")
        qid = p.get("qid")
        if p.get("slow"):
            profiles = self.slowlog.entries()
            if qid:
                profiles = [pr for pr in profiles
                            if pr.get("qid") == str(qid)]
            if n:
                profiles = profiles[-int(n):]
            return MsgType.OK, {"profiles": profiles,
                                "enabled": self._obs_enabled,
                                "slowlog": self.slowlog.summary()}
        if qid:
            profiles = self.trace_ring.find(str(qid))
        else:
            profiles = self.trace_ring.last(int(n) if n else None)
        out: Dict[str, Any] = {"profiles": profiles,
                               "enabled": self._obs_enabled}
        if not p.get("local_only"):
            ask = {"local_only": True, "qid": qid, "last": n}
            for section, replies in (
                    ("followers",
                     self._fanout_read(MsgType.GET_TRACE, ask)),
                    ("shards", self.shards.fanout(MsgType.GET_TRACE, ask))):
                if replies:
                    out["profiles"] = self._merge_sections(
                        out["profiles"], replies, section)
                    out[section] = replies
        return MsgType.OK, out

    @staticmethod
    def _merge_sections(profiles, replies, section: str) -> list:
        """Each profile with, under ``section``, the peers' profiles of
        the same query id (peers that answered with an error skipped)."""
        merged = []
        for prof in profiles:
            sections = {
                addr: [fp for fp in reply.get("profiles", ())
                       if fp.get("qid") == prof.get("qid")]
                for addr, reply in replies.items() if "error" not in reply}
            sections = {a: v for a, v in sections.items() if v}
            if sections:
                prof = {**prof, section: sections}
            merged.append(prof)
        return merged

    def _on_get_metrics(self, p):
        """Continuous telemetry: the registry snapshot with the
        telemetry history's summary and rates over ``window_s``
        (``obs/history.py``), or with ``format="openmetrics"`` the
        Prometheus text exposition (``obs/export.py``) of the same
        snapshot, attribution labels included. A leader adds its
        followers' snapshots: under ``followers``, or as samples with a
        ``follower`` label. A reading is taken first, so a poller gets
        rates as fresh as its own cadence."""
        from netsdb_tpu_torch.obs import export as _export

        self.history.observe()
        snapshot = obs.REGISTRY.snapshot()
        followers: Dict[str, Any] = {}
        if not p.get("local_only"):
            followers = self._fanout_read(MsgType.GET_METRICS,
                                          {"local_only": True})
        if p.get("format") == "openmetrics":
            text = _export.to_openmetrics(
                snapshot,
                followers={a: (r.get("metrics") if isinstance(r, dict)
                               else {"error": "bad reply"})
                           for a, r in followers.items()})
            return MsgType.OK, {"format": "openmetrics", "text": text}
        window = p.get("window_s")
        out: Dict[str, Any] = {
            "metrics": snapshot,
            "history": self.history.summary(),
            "deltas": self.history.deltas(float(window) if window
                                          else None)}
        if followers:
            out["followers"] = followers
        return MsgType.OK, out

    def _on_analyze_set(self, p):
        """Planner statistics computed where the data lives: the
        summaries ship, the table stays. A partitioned set merges its
        slots' summaries (:meth:`_analyze_sharded`)."""
        if self.is_sharded(p.get("db"), p.get("set")) \
                and not p.get("local_only"):
            return MsgType.OK, self._analyze_sharded(p["db"], p["set"])
        info = self.library.analyze_set(p["db"], p["set"])
        return MsgType.OK, {
            "num_rows": int(info["num_rows"]),
            "dicts": {k: list(v) for k, v in info["dicts"].items()},
            "stats": {k: [_plain(s.n_rows), _plain(s.min_val),
                          _plain(s.max_val), _plain(s.n_distinct)]
                      for k, s in info["stats"].items()}}

    def _analyze_sharded(self, db: str, set_name: str) -> Dict[str, Any]:
        """ANALYZE_SET over a partitioned set: every live slot analyses
        its pages and the summaries merge — rows sum, per column
        [n_rows, min, max, n_distinct] by sum/min/max/max (a shard's
        distinct count is a lower bound of the set's), dictionaries union
        in slot order. A degraded slot refuses: statistics of a subset of
        shards would mis-cost every plan built on them."""
        entry = self.placement.entry(db, set_name)
        parts: List[Dict[str, Any]] = []
        payload = {"db": db, "set": set_name, "local_only": True}
        for i, sl in enumerate(entry["slots"]):
            if sl["state"] != _placement.LIVE:
                raise ShardUnavailable(
                    f"slot {i} of {db}:{set_name} ({sl['addr']}) is "
                    f"degraded; partial statistics would mis-cost every "
                    f"plan — retry after readmit",
                    slot=i, epoch=entry["epoch"])
            if sl["addr"] == self.advertise_addr:
                _typ, rep = self._on_analyze_set(dict(payload))
            else:
                rep = self.shards.peer_request(
                    sl["addr"], MsgType.ANALYZE_SET, payload)
            parts.append(rep)
        merged_rows = 0
        dicts: Dict[str, List[Any]] = {}
        stats: Dict[str, List[Any]] = {}
        for rep in parts:
            merged_rows += int(rep.get("num_rows") or 0)
            for k, vals in (rep.get("dicts") or {}).items():
                seen = dicts.setdefault(k, [])
                known = set(seen)
                for v in vals:
                    if v not in known:
                        seen.append(v)
                        known.add(v)
            for k, row in (rep.get("stats") or {}).items():
                n, lo, hi, nd = row
                cur = stats.get(k)
                if cur is None:
                    stats[k] = [int(n), lo, hi, int(nd)]
                else:
                    cur[0] += int(n)
                    if lo is not None:
                        cur[1] = lo if cur[1] is None else min(cur[1], lo)
                    if hi is not None:
                        cur[2] = hi if cur[2] is None else max(cur[2], hi)
                    cur[3] = max(cur[3], int(nd))
        obs.REGISTRY.counter("shard.analyze_fanouts").inc()
        return {"num_rows": merged_rows, "dicts": dicts, "stats": stats,
                "sharded": len(parts)}

    # --- the shard pool -------------------------------------------------
    def is_sharded(self, db: Optional[str], set_name: Optional[str]) -> bool:
        """Does this daemon coordinate a partitioned placement for
        (db, set)? An empty map answers False."""
        return self.placement.entry(db, set_name) is not None

    def shard_registration(self, db: str,
                           set_name: str) -> Optional[Dict[str, int]]:
        """A worker's registration for (db, set), or None."""
        with self._shard_mu:
            reg = self._shard_sets.get((db, set_name))
            return dict(reg) if reg is not None else None

    def _register_shard(self, db: str, set_name: str, slot: int,
                        epoch: int) -> None:
        with self._shard_mu:
            self._shard_sets[(db, set_name)] = {"epoch": int(epoch),
                                                "slot": int(slot)}

    def _shard_route(self, db: Optional[str], set_name: Optional[str],
                     epoch, slot) -> str:
        """Classify one (possibly routed) mutating frame against this
        daemon's placement knowledge: ``"local"`` (apply here),
        ``"handoff"`` (buffer for a degraded slot), or the typed
        retryable :class:`PlacementStale` — before anything applies."""
        if not db or not set_name:
            return "local"
        entry = self.placement.entry(db, set_name)
        if entry is not None:  # this daemon coordinates the set
            current = entry["epoch"]
            if epoch is None:
                self._reject_stale(
                    f"set {db}:{set_name} is partitioned across a worker "
                    f"pool; fetch the placement map and route to the "
                    f"owning shards", current)
            if int(epoch) != current:
                self._reject_stale(
                    f"placement epoch rejected for {db}:{set_name}: frame "
                    f"rode epoch {epoch}, current is {current}", current)
            if slot is None or not (0 <= int(slot) < len(entry["slots"])):
                self._reject_stale(
                    f"routed frame for {db}:{set_name} carries no valid "
                    f"shard slot", current)
            sl = entry["slots"][int(slot)]
            if sl["state"] == _placement.HANDOFF:
                return "handoff"
            if sl["addr"] == self.advertise_addr:
                return "local"
            self._reject_stale(
                f"slot {slot} of {db}:{set_name} is owned by {sl['addr']}, "
                f"not this daemon", current)
        reg = self.shard_registration(db, set_name)
        if reg is not None and (epoch is None or int(epoch) != reg["epoch"]):
            self._reject_stale(
                f"placement epoch rejected for {db}:{set_name}: frame rode "
                f"epoch {epoch}, shard registered {reg['epoch']}",
                reg["epoch"])
        if reg is None and epoch is not None:
            with self._shard_mu:
                pruned = (db, set_name) in self._pruned
            if pruned:
                # a restart or promotion reconcile took this slot away:
                # a frame riding the old map must not apply into the
                # cleared set
                self._reject_stale(
                    f"shard slot of {db}:{set_name} no longer lives on "
                    f"this daemon; re-fetch the placement map", None)
        return "local"

    @staticmethod
    def _reject_stale(message: str, epoch) -> None:
        obs.REGISTRY.counter("shard.epoch_rejects").inc()
        raise PlacementStale(message, epoch=epoch)

    def _pool_health_loop(self) -> None:
        """The leader's shard liveness: heartbeat every worker over its own
        short-timeout connection, evict into handoff after
        ``heartbeat_misses`` failures, readmit (SHARD_RESYNC, then the
        handoff drain) once it answers again."""
        from netsdb_tpu_torch.serve.client import RemoteClient, RetryPolicy

        probes: Dict[str, Any] = {}
        misses: Dict[str, int] = {}
        while not self._stop.wait(self.heartbeat_interval_s):
            for addr in list(self._worker_addrs):
                try:
                    probe = probes.get(addr)
                    if probe is None:
                        probe = RemoteClient(
                            addr, token=self.token,
                            timeout=self.heartbeat_timeout_s,
                            connect_timeout=self.heartbeat_timeout_s,
                            retry=RetryPolicy(max_attempts=1))
                        probes[addr] = probe
                    probe.ping()
                    misses[addr] = 0
                    if self.shards.is_degraded(addr):
                        self._try_readmit_shard(addr)
                except Exception as e:  # noqa: BLE001 — counted below
                    probe = probes.pop(addr, None)
                    if probe is not None:
                        probe.close()
                    misses[addr] = misses.get(addr, 0) + 1
                    if misses[addr] >= self.heartbeat_misses \
                            and not self.shards.is_degraded(addr):
                        misses[addr] = 0
                        self._evict_shard(
                            addr, f"{self.heartbeat_misses} missed "
                                  f"heartbeats: {type(e).__name__}: {e}")
        for probe in probes.values():
            probe.close()

    def _evict_shard(self, addr: str, reason: str) -> None:
        """Degrade one worker: its slots flip to handoff (an epoch bump),
        its ingest buffers here until readmit, and the live workers learn
        the new epochs. Idempotent."""
        self.shards.degrade(addr, reason)

    def _push_epochs(self, exclude: Tuple[str, ...] = (),
                     prune: bool = False) -> None:
        """Re-register the current epochs on every live worker (an epoch
        bump is leader-local until this push). Best effort per worker: a
        failed push leaves that worker answering typed retryable.

        ``prune=True`` (the restart and promotion reconcile) sends the
        push to every pool worker, a slotless one with an empty list,
        marked authoritative: each worker drops the registrations the
        map no longer grants it (a slot in handoff still belongs to its
        degraded owner and is kept)."""
        sets_by_addr: Dict[str, list] = {}
        keep_by_addr: Dict[str, list] = {}
        for db, s in self.placement.sets():
            entry = self.placement.entry(db, s)
            for i, sl in enumerate(entry["slots"]):
                addr = sl["addr"]
                if addr == self.advertise_addr or addr in exclude:
                    continue
                if sl["state"] != _placement.LIVE:
                    keep_by_addr.setdefault(addr, []).append(
                        {"db": db, "set": s})
                    continue
                sets_by_addr.setdefault(addr, []).append(
                    {"db": db, "set": s, "slot": i,
                     "epoch": entry["epoch"]})
        if prune:
            for addr in self._worker_addrs:
                if addr not in exclude:
                    sets_by_addr.setdefault(addr, [])
        for addr, sets in sets_by_addr.items():
            payload: Dict[str, Any] = {"sets": sets}
            if prune:
                payload["prune"] = True
                if keep_by_addr.get(addr):
                    payload["keep"] = keep_by_addr[addr]
            try:
                self.shards.peer_request(addr, MsgType.SHARD_RESYNC,
                                         payload)
            except Exception as e:  # noqa: BLE001 — best-effort push
                del e
                self.shards.drop_client(addr)

    def _try_readmit_shard(self, addr: str) -> bool:
        """Readmit one degraded worker: re-register its epochs
        (SHARD_RESYNC; a failure degrades it again), push the bumped
        epochs to the rest of the pool, then drain only its own buffered
        batches (their tokens make a retried drain safe)."""
        try:
            self.placement.readmit_addr(addr)
            sets = []
            for db, s in self.placement.sets_for_addr(addr):
                entry = self.placement.entry(db, s)
                for i, sl in enumerate(entry["slots"]):
                    if sl["addr"] == addr:
                        sets.append({"db": db, "set": s, "slot": i,
                                     "epoch": entry["epoch"]})
            if sets:
                self.shards.peer_request(addr, MsgType.SHARD_RESYNC,
                                         {"sets": sets})
                self._push_epochs(exclude=(addr,))
                self.shards.drain_handoff(addr)
            self.shards.clear_degraded(addr)
            obs.REGISTRY.counter("shard.readmits").inc()
            self._replicate_placement()
            return True
        except Exception as e:  # noqa: BLE001 — degraded again, retried
            self.shards.degrade(addr, f"readmit failed: "
                                      f"{type(e).__name__}: {e}")
            return False

    def _on_placement(self, p):
        """The placement map (what a client's stale-map retry reads)."""
        return MsgType.OK, self.placement.to_wire()

    def _on_subplan(self, p):
        """A shard's side of scatter-gather: one pushed subplan over this
        daemon's pages (admission happened at the coordinator)."""
        return MsgType.OK, _shard.execute_subplan(self, p), CODEC_PICKLE

    def _on_shuffle_put(self, p):
        """One inbound bucket of a distributed shuffle."""
        cols = p.get("cols")
        nbytes = sum(np.asarray(v).nbytes for v in (cols or {}).values())
        obs.REGISTRY.counter("shard.shuffle_parts").inc()
        if nbytes:
            obs.REGISTRY.counter("shard.shuffle_bytes").inc(nbytes)
        self._shuffle.put(p["sid"], p["side"], int(p["slot"]), cols,
                          p.get("dicts"))
        return MsgType.OK, {}

    def _on_shard_resync(self, p):
        """Leader → worker: register the placement epochs of this
        daemon's slots (the metadata half of a readmit; the data half is
        the handoff drain). ``prune: true`` (a restarted or promoted
        leader's reconcile) makes the list authoritative: registrations
        absent from it and from ``keep`` are dropped, their local copies
        cleared, and routed frames for them refuse typed."""
        for s in p.get("sets", ()):
            self._register_shard(s["db"], s["set"], s["slot"], s["epoch"])
        if p.get("prune"):
            keep = {(s["db"], s["set"]) for s in p.get("sets", ())}
            keep |= {(s["db"], s["set"]) for s in p.get("keep", ())}
            with self._shard_mu:
                stale = [k for k in self._shard_sets if k not in keep]
                for k in stale:
                    del self._shard_sets[k]
                    self._pruned.add(k)
            for db, set_name in stale:
                try:
                    self.library.clear_set(db, set_name)
                except Exception as e:  # noqa: BLE001 — unreachable now
                    del e
        return MsgType.OK, {"sets": len(p.get("sets", ()))}

    def _on_reshard(self, p):
        """RESHARD: the ``view`` op answers the placement table
        (:meth:`placement_view`); moving slots, the rebalancer's status
        and adding workers are rebalancing, ROADMAP.md A7 part 2."""
        if p.get("op") == "view":
            return MsgType.OK, self.placement_view(), CODEC_PICKLE
        raise NotImplementedError(
            f"RESHARD op {p.get('op')!r} (rebalancing) is not ported yet: "
            f"ROADMAP.md A7 part 2")

    def placement_view(self) -> Dict[str, Any]:
        """The per-slot ownership table of every sharded set joined with
        each slot's local bytes (one best-effort COLLECT_STATS fan-out),
        and the per-member totals. The load-heat columns and the
        rebalancer's status belong to rebalancing (ROADMAP.md A7 part
        2): neither is here."""
        sizes: Dict[Tuple[str, str], int] = {}
        for scope, st in self.library.collect_stats().items():
            sizes[(self.advertise_addr, scope)] = int(
                (st or {}).get("nbytes", 0) or 0)
        for addr, reply in self.shards.fanout(
                MsgType.COLLECT_STATS, {"local_only": True}).items():
            if isinstance(reply, dict) and "error" not in reply:
                for scope, st in (reply.get("sets") or {}).items():
                    sizes[(addr, scope)] = int((st or {}).get("nbytes", 0)
                                               or 0)
        sets_out = []
        for db, s in self.placement.sets():
            e = self.placement.entry(db, s)
            scope = f"{db}:{s}"
            sets_out.append({
                "db": db, "set": s, "mode": e["mode"], "key": e["key"],
                "epoch": e["epoch"],
                "slots": [{"slot": i, "addr": sl["addr"],
                           "state": sl["state"],
                           "nbytes": sizes.get((sl["addr"], scope), 0)}
                          for i, sl in enumerate(e["slots"])]})
        members = [self.advertise_addr] + list(self._worker_addrs)
        return {"epoch": self.placement.to_wire()["epoch"],
                "members": [{
                    "addr": a, "degraded": self.shards.is_degraded(a),
                    "nbytes": sum(n for (ad, _sc), n in sizes.items()
                                  if ad == a),
                    "slots": sum(1 for so in sets_out for sl in so["slots"]
                                 if sl["addr"] == a
                                 and sl["state"] == _placement.LIVE)}
                    for a in members],
                "sets": sets_out}


def run_daemon(config: Configuration, host: str = "127.0.0.1",
               port: int = 8108, token: Optional[str] = None,
               max_jobs: Optional[int] = None, device=None,
               workers: Optional[list] = None,
               followers: Optional[list] = None,
               ha_peers: Optional[list] = None, **kwargs) -> int:
    """Start a daemon, print its bound address on a line of its own,
    and block until shutdown. ``workers`` makes it a pool leader over
    those shard daemons, ``followers`` a leader mirroring to those
    follower daemons (either may start first); ``ha_peers`` arms
    failover over that ordered succession list (the same list on every
    daemon). ``kwargs`` go to :class:`ServeController`. SIGUSR1 writes
    every thread's stack to stderr."""
    import faulthandler
    import signal

    faulthandler.register(signal.SIGUSR1, all_threads=True)
    ctl = ServeController(config, host=host, port=port, token=token,
                          max_jobs=max_jobs, device=device, workers=workers,
                          followers=followers, ha_peers=ha_peers,
                          **kwargs)
    bound = ctl.start()
    print(f"serving on {host}:{bound}", flush=True)
    ctl.serve_forever()
    return 0


def main(argv=None) -> int:
    """``python -m netsdb_tpu_torch.serve.server`` — the standalone
    daemon (:func:`run_daemon`)."""
    import argparse

    ap = argparse.ArgumentParser(prog="netsdb-torch-serve")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8108)
    ap.add_argument("--root", default=None, help="database root dir")
    ap.add_argument("--token", default=None, help="shared auth token")
    ap.add_argument("--max-jobs", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="the device the daemon owns (default cuda)")
    ap.add_argument("--workers", default=None,
                    help="comma-separated shard daemon addresses: this "
                         "daemon leads their pool")
    ap.add_argument("--followers", default=None,
                    help="comma-separated follower daemon addresses: this "
                         "daemon mirrors every mutation to them")
    ap.add_argument("--ha-peers", default=None,
                    help="comma-separated ordered succession list for "
                         "failover (index 0 leads first; the same list "
                         "on every daemon)")
    args = ap.parse_args(argv)
    config = (Configuration(root_dir=args.root) if args.root
              else Configuration())

    def addrs(text):
        return [a.strip() for a in (text or "").split(",")
                if a.strip()] or None

    return run_daemon(config, host=args.host, port=args.port,
                      token=args.token, max_jobs=args.max_jobs,
                      device=args.device, workers=addrs(args.workers),
                      followers=addrs(args.followers),
                      ha_peers=addrs(args.ha_peers))


if __name__ == "__main__":
    sys.exit(main())
