"""Thin RPC client — the port's ``netsdb_tpu/serve/client.py``: the
``Client`` facade over the wire.

:class:`RemoteClient` mirrors :class:`netsdb_tpu_torch.client.Client`
method for method but sends typed frames to a resident
:class:`~netsdb_tpu_torch.serve.server.ServeController` (the reference's
``PDBClient`` speaking to its master). It needs no card: tensors come
back as host arrays in :class:`RemoteTensor`, whose ``to_dense()``
matches ``BlockedTensor.to_dense()`` in value, so model drivers run
against either client.

Failures are typed (``serve/errors.py``). Retryable ones are retried
under a :class:`RetryPolicy` with jittered exponential backoff, bounded
by a per-request deadline, honouring the server's ``retry_after_s``
hint; a mutating frame carries one idempotency token for all its
attempts, so a retry after a lost reply is answered from the daemon's
cache instead of applied twice. Scans stream, big ingests stream as
chunks pipelined ``ingest_window`` deep, and both travel with their
arrays out of band.

The pickle codec (DAGs with their functions, object items) is used only
against a daemon that named this interpreter in its HELLO reply
(``protocol.PY_KEY``); against any other daemon — the reference's
included — such a request raises :class:`ProtocolVersionError` before a
byte is sent, and the codec-0 frames work as they are.

Against a shard pool's leader the client routes: the placement map
arrives in the handshake (or the reply of a sharded ``create_set``), and
ingest into a partitioned set splits by the set's placement
(``serve/placement.py``) and goes straight to the owning daemons in
parallel, each slot's batch under its own idempotency token. A refusal
for a stale epoch (``PlacementStaleError``) re-reads the map and
re-routes at once.

Query-shaped requests (``TRACED_TYPES``) carry a query id minted 1 in
``trace_sample`` (``obs.QidSampler``) and run inside a client-side trace
(``client.send`` and ``client.wait`` spans); the daemon traces its part
under the same id. With ``ship_traces`` the finished client profile is
shipped to the daemon (PUT_TRACE) by a background thread over its own
connection, so GET_TRACE (:meth:`RemoteClient.get_trace`) returns one
merged profile; :meth:`RemoteClient.flush_traces` waits for the queue.

With ``replicas`` (daemons holding the same data: a leader's followers)
idempotent reads hedge: when the primary's reply has not landed after
:meth:`RemoteClient.hedge_delay_s` (the observed p99 of this client's
reads, or the knob), the same request goes to a replica and the first
answer wins; a stream hedges its first item. Mutations never hedge.
With ``failover`` (the HA succession list) a typed ``NotLeader`` that
names the leader re-points the client there at once, and a lost
connection rotates through the candidates under the retry backoff,
which doubles as the wait for an election.

Rebalancing (``add_worker``, ``rebalance_status``) and type-source
shipping belong to ROADMAP.md A7 part 2: each raises
``NotImplementedError`` naming its item."""

from __future__ import annotations

import contextlib
import dataclasses
import pickle
import queue as _queue
import random
import socket
import threading
import time
import uuid
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from netsdb_tpu_torch import obs
from netsdb_tpu_torch.serve.errors import (  # noqa: F401 — re-exported API
    AdmissionFullError,
    AuthError,
    CoalesceAbortedError,
    ConnectionLostError,
    CorruptFrameError,
    DeadlineExceededError,
    FollowerDegradedError,
    LaneSaturatedError,
    NotLeaderError,
    PlacementStaleError,
    ProtocolVersionError,
    RemoteError,
    RemoteTimeoutError,
    RetryableRemoteError,
    SessionMovedError,
    SessionUnknownError,
    ShardUnavailableError,
    classify_remote,
)
from netsdb_tpu_torch.serve.protocol import (
    CLIENT_ID_KEY,
    CODEC_MSGPACK,
    CODEC_PICKLE,
    IDEMPOTENCY_KEY,
    LANE_KEY,
    MUTATING_TYPES,
    PLACEMENT_EPOCH_KEY,
    PROTO_VERSION,
    PY_KEY,
    PY_TAG,
    QUERY_ID_KEY,
    SESSION_KEY,
    SHARD_SLOT_KEY,
    MsgType,
    ProtocolError,
    recv_frame,
    send_frame,
    tensor_to_wire,
)
from netsdb_tpu_torch.utils.locks import TrackedLock
from netsdb_tpu_torch.utils.timing import deadline_after, seconds_left

#: frame types that open a client-side trace and mint the query id the
#: daemon's trace joins on (decode steps trace too)
TRACED_TYPES = frozenset({MsgType.EXECUTE_COMPUTATIONS,
                          MsgType.EXECUTE_PLAN,
                          MsgType.GENERATE})


@dataclasses.dataclass
class RetryPolicy:
    """Exponential backoff with jitter for retryable failures.
    ``deadline_s`` bounds one logical request across all its attempts
    (monotonic clock); when the next backoff would cross it,
    :class:`DeadlineExceededError` is raised instead of sleeping.
    ``max_attempts=1`` disables retries."""

    max_attempts: int = 4
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5
    deadline_s: Optional[float] = None

    def backoff_s(self, attempt: int, rng: random.Random) -> float:
        d = min(self.base_delay_s * self.multiplier ** (attempt - 1),
                self.max_delay_s)
        return d * (1.0 - self.jitter * rng.random())


class RemoteTableInfo:
    """Summary of a daemon-side table ingest (``send_table``'s reply)."""

    def __init__(self, num_rows: int, columns: list):
        self.num_rows = num_rows
        self.columns = columns

    def __repr__(self):
        return f"RemoteTableInfo(rows={self.num_rows}, cols={self.columns})"


class RemoteTensor:
    """A dense result fetched from the daemon — reads like a
    ``BlockedTensor`` (``to_dense``/``shape``/``dtype``), on the host."""

    def __init__(self, dense: np.ndarray, block_shape=None):
        self._dense = dense
        self.block_shape = tuple(block_shape) if block_shape else None

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._dense.shape)

    @property
    def dtype(self):
        return self._dense.dtype

    def to_dense(self) -> np.ndarray:
        return self._dense

    def __repr__(self) -> str:
        return f"RemoteTensor(shape={self.shape}, dtype={self.dtype})"


class RemoteIdent(Tuple[str, str]):
    """(db, set) result key, printable like ``SetIdentifier``."""

    def __new__(cls, db: str, set_: str):
        return super().__new__(cls, (db, set_))

    @property
    def db(self) -> str:
        return self[0]

    @property
    def set(self) -> str:
        return self[1]

    def __str__(self) -> str:
        return f"{self[0]}:{self[1]}"


def _later(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet: ROADMAP.md {item}")


def _host_array(v) -> np.ndarray:
    """An array or tensor as a host array (a CUDA tensor is copied)."""
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class RemoteClient:
    """``Client(address="host:port")`` returns one of these."""

    #: below this many items ``send_data`` sends one frame
    PIPELINE_MIN_ITEMS = 64

    def __init__(self, address: str, token: Optional[str] = None,
                 timeout: Optional[float] = None,
                 retry: Optional[RetryPolicy] = None,
                 chaos=None, seed: Optional[int] = None,
                 connect_timeout: Optional[float] = None,
                 replicas: Optional[Sequence[str]] = None,
                 hedge_delay_s: Optional[float] = None,
                 ingest_window: int = 4,
                 ingest_chunk_bytes: int = 8 << 20,
                 client_id: Optional[str] = None,
                 lane: Optional[str] = None,
                 trace_sample: Optional[int] = None,
                 ship_traces: bool = True,
                 failover: Optional[Sequence[str]] = None):
        """``timeout``: socket timeout of every blocking recv after the
        handshake (None blocks); ``connect_timeout`` bounds the dial and
        the handshake (defaults to ``timeout``). ``retry``: the
        :class:`RetryPolicy` (default: 4 attempts). ``seed`` seeds the
        backoff jitter. ``ingest_window``/``ingest_chunk_bytes``: bulk
        ingest streams ~``ingest_chunk_bytes`` chunks with up to
        ``ingest_window`` in flight. ``client_id`` rides every frame
        (the scheduler's default lane); ``lane`` names a scheduler lane.
        ``trace_sample``: a query id (and so an end-to-end trace) for 1
        in N query-shaped requests (None: ``Configuration``'s
        ``obs_trace_sample``, 1). ``ship_traces``: ship each finished
        client trace to the daemon (PUT_TRACE) from a background thread,
        best effort — a lost ship costs the client section, never the
        request. ``replicas``: daemons holding the same data, which
        idempotent reads hedge to after ``hedge_delay_s`` (None: the
        adaptive p99 trigger). ``failover``: candidate leader addresses
        (the HA succession list). ``chaos``: a
        :class:`~netsdb_tpu_torch.serve.chaos.ChaosInjector` faulting
        this client's frames (tests)."""
        host, _, port = address.rpartition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port)
        self.token = token
        self._lock = TrackedLock("RemoteClient._lock")
        self._sock: Optional[socket.socket] = None
        self._timeout = timeout
        self._connect_timeout = (connect_timeout if connect_timeout
                                 is not None else timeout)
        self._retry = retry or RetryPolicy()
        self._chaos = chaos
        self._rng = random.Random(seed)
        #: attempts of the last logical request; retries over the
        #: client's lifetime, in all and by the refusal's type name
        self.last_attempts = 0
        self.total_retries = 0
        self.retries_by_error: Dict[str, int] = {}
        self.ingest_window = max(1, int(ingest_window))
        self.ingest_chunk_bytes = max(64 << 10, int(ingest_chunk_bytes))
        self.client_id = client_id
        self.lane = lane
        if trace_sample is None:
            from netsdb_tpu_torch.config import Configuration

            trace_sample = Configuration.obs_trace_sample
        self._trace_sample = max(1, int(trace_sample))
        # this client's own sampling phase (obs.QidSampler)
        self._qid_sampler = obs.QidSampler()
        self.ship_traces = bool(ship_traces)
        # the PUT_TRACE shipper, started with the first shipped trace
        self._ship_mu = TrackedLock("RemoteClient._ship_mu")
        self._ship_q: Optional["_queue.Queue"] = None
        self._ship_thread: Optional[threading.Thread] = None
        #: True when the daemon named this interpreter in its HELLO
        #: reply: the pickle codec is usable
        self.pickle_ok = False
        self.daemon_incarnation: Optional[str] = None
        self.daemon_applied: Optional[list] = None
        # the thread driving a streaming reply: its nested requests take
        # a one-shot side connection
        self._stream_owner: Optional[int] = None
        # routing state: the daemon's sharded-set map (None until a
        # sharded set exists), direct connections to shard daemons, and
        # the stale-map refresh guard (one fetch at a time)
        self._placement_mu = TrackedLock("RemoteClient._placement_mu")
        self._placement_wire: Optional[Dict[str, Any]] = None
        self._shard_clients: Dict[str, "RemoteClient"] = {}
        self._placement_fetch_mu = TrackedLock(
            "RemoteClient._placement_fetch_mu")
        self._refreshing_placement: Optional[int] = None
        # hedged reads: the replica ring and this client's read
        # latencies (the trigger quantiles over them; every observation
        # also lands in the registry's serve.client.read_latency_s)
        self._replicas = list(replicas or [])
        self._hedge_delay_s = hedge_delay_s
        self._read_hist = obs.Histogram(max_samples=256)
        self._hedge_rr = 0
        self.hedges_issued = 0
        self.hedges_won = 0
        # failover: candidate leaders and the rotation cursor; the
        # number of times this client re-pointed at another daemon
        self._failover = list(failover or [])
        self._failover_idx = 0
        self.failovers = 0
        self._connect()

    # --- transport ----------------------------------------------------
    @property
    def current_address(self) -> str:
        return f"{self.host}:{self.port}"

    def _dial(self, budget_s: Optional[float] = None,
              address: Optional[str] = None) -> socket.socket:
        """Open and handshake one connection (to ``address``, a replica,
        else this client's daemon). HELLO carries ``PROTO_VERSION`` (a
        mismatch either way is the fatal :class:`ProtocolVersionError`)
        and this interpreter's tag."""
        host, port = self.host, self.port
        if address is not None:
            h, _, p = address.rpartition(":")
            host, port = (h or "127.0.0.1"), int(p)
        ct = self._connect_timeout
        if budget_s is not None:
            ct = budget_s if ct is None else min(ct, budget_s)
        s = socket.create_connection((host, port), timeout=ct)
        try:
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            send_frame(s, MsgType.HELLO, {"token": self.token,
                                          "proto": PROTO_VERSION,
                                          PY_KEY: PY_TAG})
            typ, reply = recv_frame(s, allow_pickle=False)
            if typ == MsgType.ERR:
                raise classify_remote(reply)
            if reply.get("version") != PROTO_VERSION:
                raise ProtocolVersionError(
                    "ProtocolVersionError",
                    f"daemon at {host}:{port} speaks wire format "
                    f"v{reply.get('version')}; this client is "
                    f"v{PROTO_VERSION} — mixed versions are refused")
            if address is None:
                self.pickle_ok = reply.get(PY_KEY) == PY_TAG
                # the daemon process's identity and, on a follower that
                # keeps an applied log, the leader-log position it holds
                self.daemon_incarnation = reply.get("incarnation")
                self.daemon_applied = reply.get("mirror_applied")
            if isinstance(reply.get("placement"), dict):
                # a pool leader ships its placement map in the handshake
                with self._placement_mu:
                    self._placement_wire = reply["placement"]
            s.settimeout(self._timeout)
        except BaseException:
            s.close()
            raise
        return s

    def _connect(self, budget_s: Optional[float] = None) -> None:
        self._sock = self._dial(budget_s)

    @staticmethod
    def _recv_reply(sock) -> Tuple[Any, Any]:
        """Reply recv with decode failures typed (the retryable
        CorruptFrame family). Replies may carry host objects (SCAN_SET):
        the client trusts the daemon it chose to connect to."""
        try:
            return recv_frame(sock, allow_pickle=True)
        except (ConnectionError, OSError):
            raise
        except Exception as e:
            raise CorruptFrameError(
                type(e).__name__, f"reply body failed to decode: {e}") from e

    def _oneshot_request(self, msg_type: MsgType, payload: Any, codec: int,
                         io_timeout: Optional[float] = None,
                         address: Optional[str] = None) -> Any:
        """One request over a throwaway connection — for a thread that
        is mid-stream on the main connection, and for a hedge to a
        replica (``address``)."""
        s = self._dial(io_timeout, address=address)
        try:
            if io_timeout is not None:
                s.settimeout(io_timeout)
            send_frame(s, msg_type, payload, codec, chaos=self._chaos)
            typ, reply = self._recv_reply(s)
        finally:
            s.close()
        if typ == MsgType.ERR:
            raise classify_remote(reply)
        return reply

    def _request_once(self, msg_type: MsgType, payload: Any, codec: int,
                      io_timeout: Optional[float] = None) -> Any:
        """One attempt on the persistent connection; any failure drops
        the connection (the frame stream is desynced) and the next
        attempt re-dials."""
        with self._lock:
            if self._sock is None:
                self._connect(io_timeout)
            try:
                if io_timeout is not None:
                    self._sock.settimeout(io_timeout)
                with obs.span("client.send", "client"):
                    send_frame(self._sock, msg_type, payload, codec,
                               chaos=self._chaos)
                with obs.span("client.wait", "client"):
                    typ, reply = self._recv_reply(self._sock)
                if io_timeout is not None:
                    self._sock.settimeout(self._timeout)
            except Exception:
                self._drop_connection()
                raise
        if typ == MsgType.ERR:
            raise classify_remote(reply)
        return reply

    def _retry_driver(self, attempt_fn,
                      deadline_s: Optional[float] = None) -> Any:
        """The one retry engine: ``attempt_fn(io_timeout)`` under the
        :class:`RetryPolicy` and the per-request deadline, retrying
        typed-retryable failures with jittered exponential backoff (at
        least the server's ``retry_after_s`` hint). ``io_timeout`` caps
        an attempt at the remaining budget. Every raised error is
        typed."""
        policy = self._retry
        budget_s = deadline_s if deadline_s is not None else policy.deadline_s
        deadline = deadline_after(budget_s) if budget_s is not None else None
        attempt = 1
        while True:
            self.last_attempts = attempt
            io_timeout = None
            if deadline is not None:
                left = seconds_left(deadline)
                if left <= 0:
                    raise DeadlineExceededError(
                        "DeadlineExceeded",
                        f"request deadline of {budget_s}s already spent "
                        f"before attempt {attempt}")
                io_timeout = left if self._timeout is None \
                    else min(self._timeout, left)
            try:
                return attempt_fn(io_timeout)
            except RemoteError as e:
                if not e.retryable:
                    raise
                failure: RemoteError = e
            except (socket.timeout, TimeoutError) as e:
                failure = RemoteTimeoutError(type(e).__name__,
                                             str(e) or "socket timeout")
            except (ConnectionError, OSError) as e:
                failure = ConnectionLostError(type(e).__name__, str(e))
            if attempt >= policy.max_attempts:
                raise failure
            if isinstance(failure, NotLeaderError):
                addr = getattr(failure, "leader_addr", None)
                if addr:
                    # the refusal names the leader: re-point and retry at
                    # once (a redirect, not congestion)
                    self._switch_address(addr)
                    attempt += 1
                    self._count_retry(failure)
                    continue
                # mid-election: the backoff below is the bounded wait,
                # rotating candidates meanwhile
                self._rotate_failover()
            elif isinstance(failure, (ConnectionLostError,
                                      RemoteTimeoutError)) \
                    and self._failover:
                # the daemon died outright: walk the succession list
                self._rotate_failover()
            if isinstance(failure, PlacementStaleError):
                # the frame rode an out-of-date map: re-read it and retry
                # at once (the refusal is deterministic, not congestion)
                self._refresh_placement()
                attempt += 1
                self._count_retry(failure)
                continue
            delay = policy.backoff_s(attempt, self._rng)
            hint = getattr(failure, "retry_after_s", None)
            if hint is not None and hint > 0:
                delay = max(delay, float(hint)
                            * (1.0 + 0.25 * self._rng.random()))
            if deadline is not None and delay > seconds_left(deadline):
                raise DeadlineExceededError(
                    "DeadlineExceeded",
                    f"request deadline of {budget_s}s exhausted after "
                    f"{attempt} attempt(s); last failure: {failure}",
                ) from failure
            time.sleep(delay)
            attempt += 1
            self._count_retry(failure)

    def _count_retry(self, failure: BaseException) -> None:
        name = type(failure).__name__
        self.retries_by_error[name] = self.retries_by_error.get(name, 0) + 1
        self.total_retries += 1
        obs.REGISTRY.counter("serve.client.retries").inc()

    def _check_codec(self, codec: int) -> None:
        if codec == CODEC_PICKLE and not self.pickle_ok:
            raise ProtocolVersionError(
                "ProtocolVersionError",
                f"the daemon at {self.current_address} did not name this "
                f"interpreter ({PY_TAG}) in its handshake: pickled frames "
                f"(DAGs, object items, decode steps) are not sent to it")

    def _request(self, msg_type: MsgType, payload: Any,
                 codec: int = CODEC_MSGPACK,
                 deadline_s: Optional[float] = None) -> Any:
        """One logical request: an idempotency token on mutating frames
        (the same for every attempt), the client identity and lane on
        every frame, a sampled query id on query-shaped frames, then
        :meth:`_retry_driver`. A traced request ships its client profile
        afterwards (``ship_traces``)."""
        self._check_codec(codec)
        if isinstance(payload, dict):
            extra = {}
            if msg_type in MUTATING_TYPES and IDEMPOTENCY_KEY not in payload:
                extra[IDEMPOTENCY_KEY] = uuid.uuid4().hex
            if self.client_id is not None and CLIENT_ID_KEY not in payload:
                extra[CLIENT_ID_KEY] = str(self.client_id)
            if self.lane is not None and LANE_KEY not in payload:
                extra[LANE_KEY] = str(self.lane)
            if extra:
                payload = dict(payload)
                payload.update(extra)
        qid = None
        if msg_type in TRACED_TYPES and isinstance(payload, dict) \
                and QUERY_ID_KEY not in payload and obs.enabled():
            # one id per logical query (retries reuse it)
            qid = self._qid_sampler.sample(self._trace_sample)
            if qid is not None:
                payload = dict(payload)
                payload[QUERY_ID_KEY] = qid
        oneshot = self._stream_owner == threading.get_ident()

        def attempt(io_timeout):
            if oneshot:
                return self._oneshot_request(msg_type, payload, codec,
                                             io_timeout=io_timeout)
            if self._replicas and msg_type not in MUTATING_TYPES \
                    and msg_type != MsgType.SHUTDOWN:
                return self._request_hedged(msg_type, payload, codec,
                                            io_timeout=io_timeout)
            return self._request_once(msg_type, payload, codec,
                                      io_timeout=io_timeout)

        if qid is None:
            return self._retry_driver(attempt, deadline_s)
        with obs.trace(qid, origin="client") as tr:
            out = self._retry_driver(attempt, deadline_s)
        if tr is not None and self.ship_traces:
            self._ship_trace(qid, tr)
        return out

    def _ship_trace(self, qid: str, tr) -> None:
        """Queue a finished client trace for the shipper thread — never
        on the caller's path. A full queue drops the profile
        (``serve.client.trace_ship_dropped``)."""
        with self._ship_mu:
            if self._ship_q is None:
                self._ship_q = _queue.Queue(maxsize=64)
                self._ship_thread = threading.Thread(
                    target=self._ship_loop, args=(self._ship_q,),
                    daemon=True, name="netsdb-torch-trace-ship")
                self._ship_thread.start()
            q = self._ship_q
        try:
            q.put_nowait({"qid": qid, "profile": tr.profile_dict})
        except _queue.Full:
            obs.REGISTRY.counter("serve.client.trace_ship_dropped").inc()

    def _ship_loop(self, q: "_queue.Queue") -> None:
        """The shipper: PUT_TRACE each queued profile over its own
        connection (the request connection and its lock stay untouched),
        re-dialling after a failure; failures are counted. Ends at the
        None that :meth:`close` queues."""
        sock = None
        try:
            while True:
                item = q.get()
                try:
                    if item is None:
                        return
                    try:
                        if sock is None:
                            sock = self._dial()
                        send_frame(sock, MsgType.PUT_TRACE, item,
                                   CODEC_MSGPACK)
                        typ, reply = self._recv_reply(sock)
                        if typ == MsgType.ERR:
                            raise classify_remote(reply)
                        obs.REGISTRY.counter(
                            "serve.client.traces_shipped").inc()
                    except Exception as e:  # noqa: BLE001 — counted
                        obs.REGISTRY.counter(
                            "serve.client.trace_ship_failures").inc()
                        del e
                        if sock is not None:
                            sock.close()
                            sock = None
                finally:
                    q.task_done()
        finally:
            if sock is not None:
                sock.close()

    def flush_traces(self, timeout_s: float = 5.0) -> bool:
        """Wait until every queued client trace has shipped (or failed),
        up to ``timeout_s``; True when the queue drained."""
        q = self._ship_q
        if q is None:
            return True
        deadline = deadline_after(timeout_s)
        with q.all_tasks_done:
            while q.unfinished_tasks:
                left = seconds_left(deadline)
                if left <= 0:
                    return False
                q.all_tasks_done.wait(left)
        return True

    # --- windowed bulk ingest (BULK_BEGIN/CHUNK/COMMIT) ---------------
    def _bulk_once(self, sock: socket.socket, begin: dict, chunk_fn) -> Any:
        """One attempt of a streamed-ingest conversation: BEGIN, chunks
        pipelined ``ingest_window`` deep (each acked once the daemon
        decoded it), COMMIT, whose reply is the op's reply. A BEGIN
        answered without ``go`` is the daemon replaying a completed
        execution (a retry after a lost final reply)."""
        send_frame(sock, MsgType.BULK_BEGIN, begin, chaos=self._chaos)
        typ, reply = self._recv_reply(sock)
        if typ == MsgType.ERR:
            raise classify_remote(reply)
        if not (isinstance(reply, dict) and reply.get("go")):
            return reply
        seq = unacked = 0
        for chunk in chunk_fn():
            chunk["seq"] = seq
            send_frame(sock, MsgType.BULK_CHUNK, chunk, chaos=self._chaos)
            seq += 1
            unacked += 1
            while unacked >= self.ingest_window:
                typ, ack = self._recv_reply(sock)
                if typ == MsgType.ERR:
                    raise classify_remote(ack)
                unacked -= 1
        while unacked:
            typ, ack = self._recv_reply(sock)
            if typ == MsgType.ERR:
                raise classify_remote(ack)
            unacked -= 1
        send_frame(sock, MsgType.BULK_COMMIT, {"chunks": seq},
                   chaos=self._chaos)
        typ, reply = self._recv_reply(sock)
        if typ == MsgType.ERR:
            raise classify_remote(reply)
        return reply

    def _bulk_request(self, op: MsgType, meta: dict, chunk_fn,
                      deadline_s: Optional[float] = None,
                      token: Optional[str] = None) -> Any:
        """One logical bulk ingest, retried whole under the policy with
        ONE idempotency token for every attempt (nothing applies before
        COMMIT; a retry after a lost COMMIT reply replays the cached
        result). ``chunk_fn`` returns a fresh chunk iterator per call;
        ``token`` overrides the minted token (routed ingest passes its
        slot's)."""
        begin = {"op": int(op), "meta": meta,
                 IDEMPOTENCY_KEY: token or uuid.uuid4().hex}
        if self.client_id is not None:
            begin[CLIENT_ID_KEY] = str(self.client_id)

        def attempt(io_timeout):
            if self._stream_owner == threading.get_ident():
                s = self._dial(io_timeout)
                try:
                    if io_timeout is not None:
                        s.settimeout(io_timeout)
                    return self._bulk_once(s, begin, chunk_fn)
                finally:
                    s.close()
            with self._lock:
                if self._sock is None:
                    self._connect(io_timeout)
                try:
                    if io_timeout is not None:
                        self._sock.settimeout(io_timeout)
                    out = self._bulk_once(self._sock, begin, chunk_fn)
                    if io_timeout is not None:
                        self._sock.settimeout(self._timeout)
                    return out
                except Exception:
                    self._drop_connection()
                    raise

        return self._retry_driver(attempt, deadline_s)

    # --- hedged reads -------------------------------------------------
    def _observe_read_latency(self, dt: float) -> None:
        """One read's latency, into this client's histogram (what
        :meth:`hedge_delay_s` quantiles over) and the registry's
        ``serve.client.read_latency_s`` (what COLLECT_STATS ships)."""
        self._read_hist.observe(dt)
        obs.REGISTRY.histogram("serve.client.read_latency_s").observe(dt)

    def hedge_delay_s(self) -> float:
        """The hedge trigger: the ``hedge_delay_s`` knob when set, else
        the p99 of this client's recent read latencies once it has 8,
        else 50 ms."""
        if self._hedge_delay_s is not None:
            return self._hedge_delay_s
        if self._read_hist.sample_count >= 8:
            p99 = self._read_hist.quantile(0.99)
            if p99 is not None:
                return p99
        return 0.05

    def read_latency_stats(self) -> Dict[str, Any]:
        """Summary of this client's read latencies (the histogram the
        hedge trigger reads)."""
        return self._read_hist.summary()

    def _request_hedged(self, msg_type: MsgType, payload: Any, codec: int,
                        io_timeout: Optional[float] = None) -> Any:
        """One attempt of an idempotent read with hedging: the primary
        runs on the persistent connection (on a short-lived thread, so
        it can be timed); if its reply has not landed within
        :meth:`hedge_delay_s`, the same request goes to the next replica
        over a one-shot connection and the first success wins. A winning
        hedge force-closes the primary's socket, releasing its thread
        and the connection lock. Failures surface as an unhedged
        attempt's would."""
        t0 = time.perf_counter()
        results: "_queue.Queue" = _queue.Queue()

        def attempt(tag, fn):
            try:
                results.put((tag, None, fn()))
            except BaseException as e:  # noqa: BLE001 — re-raised below
                results.put((tag, e, None))

        threading.Thread(
            target=attempt, daemon=True,
            args=("primary", lambda: self._request_once(
                msg_type, payload, codec, io_timeout=io_timeout)),
        ).start()
        try:
            tag, err, val = results.get(timeout=self.hedge_delay_s())
        except _queue.Empty:
            self.hedges_issued += 1
            obs.REGISTRY.counter("serve.client.hedges_issued").inc()
            addr = self._replicas[self._hedge_rr % len(self._replicas)]
            self._hedge_rr += 1
            threading.Thread(
                target=attempt, daemon=True,
                args=("hedge", lambda: self._oneshot_request(
                    msg_type, payload, codec, io_timeout=io_timeout,
                    address=addr)),
            ).start()
            tag, err, val = results.get()
            if err is not None:
                # the first to answer failed: wait for the other
                tag2, err2, val2 = results.get()
                if err2 is None:
                    tag, err, val = tag2, None, val2
                elif tag == "hedge":
                    tag, err = "primary", err2  # the primary's error wins
        if err is not None:
            raise err
        if tag == "hedge":
            self.hedges_won += 1
            obs.REGISTRY.counter("serve.client.hedges_won").inc()
            # release the primary; its socket is dropped here or by its
            # own failure
            self._force_close()
        self._observe_read_latency(time.perf_counter() - t0)
        return val

    def _drop_connection(self) -> None:
        s, self._sock = self._sock, None
        if s is not None:
            try:
                s.close()
            except OSError:
                pass

    def _switch_address(self, address: str) -> None:
        """Re-point this client at another daemon (a ``NotLeader`` named
        it, or the failover rotation picked it): the persistent
        connection drops and the next attempt dials the new address. The
        placement cache stays: its epochs validate it."""
        host, _, port = address.rpartition(":")
        with self._lock:
            if (host or "127.0.0.1") == self.host and int(port) == self.port:
                return
            self.host = host or "127.0.0.1"
            self.port = int(port)
            self._drop_connection()
        self.failovers += 1

    def _rotate_failover(self) -> None:
        """Move to the next failover candidate other than the current
        address (no-op without a candidate list)."""
        n = len(self._failover)
        for _ in range(n):
            cand = self._failover[self._failover_idx % n]
            self._failover_idx += 1
            h, _, p = cand.rpartition(":")
            if (h or "127.0.0.1") != self.host or int(p) != self.port:
                self._switch_address(cand)
                return

    def _force_close(self) -> None:
        """Unstick an in-flight request from another thread: shut the
        socket down without waiting for ``_lock`` (the stuck thread holds
        it), so its blocking recv or send fails at once. The descriptor
        is closed only by a thread holding the lock — here when no
        request is in flight, else by the failing request itself — so a
        late send of that request can never land on a descriptor the
        process has reused for another connection."""
        s = self._sock
        if s is not None:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        if self._lock.acquire(blocking=False):
            try:
                self._drop_connection()
            finally:
                self._lock.release()

    def close(self) -> None:
        with self._ship_mu:
            q, t = self._ship_q, self._ship_thread
            self._ship_q = self._ship_thread = None
        if q is not None:
            # a bounded grace for ships in flight, then the shipper ends
            try:
                q.put_nowait(None)
            except _queue.Full:
                pass
            if t is not None:
                t.join(timeout=2.0)
        with self._placement_mu:
            shard_clients = list(self._shard_clients.values())
            self._shard_clients.clear()
        for sc in shard_clients:
            sc.close()
        with self._lock:
            self._drop_connection()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # --- session ------------------------------------------------------
    def ping(self) -> Dict[str, Any]:
        return self._request(MsgType.PING, {})

    def shutdown_server(self) -> None:
        with self._lock:
            if self._sock is None:
                self._connect()
            try:
                send_frame(self._sock, MsgType.SHUTDOWN, {})
                recv_frame(self._sock, allow_pickle=False)
            except (ConnectionError, OSError):
                pass  # the daemon may die before acking
            finally:
                self._drop_connection()

    # --- DDL ----------------------------------------------------------
    def create_database(self, db: str) -> None:
        self._request(MsgType.CREATE_DATABASE, {"db": db})

    def create_set(self, db: str, set_name: str, type_name: str = "tensor",
                   persistence: str = "transient", eviction: str = "lru",
                   partition_lambda: Optional[str] = None,
                   placement=None, storage: str = "memory") -> RemoteIdent:
        """``placement`` may be a ``Placement`` (sent as its
        ``to_meta``) or its meta dict; ``storage="paged"`` backs the set
        with the daemon's page arena."""
        if placement is not None and hasattr(placement, "to_meta"):
            placement = placement.to_meta()
        reply = self._request(MsgType.CREATE_SET, {
            "db": db, "set": set_name, "type_name": type_name,
            "persistence": persistence, "eviction": eviction,
            "partition_lambda": partition_lambda,
            "placement": placement, "storage": storage})
        entry = reply.get("placement") if isinstance(reply, dict) else None
        if isinstance(entry, dict):
            # a sharded create answers with its entry: cache it, so the
            # first ingest routes without a stale-map round trip
            with self._placement_mu:
                wire = self._placement_wire or {"epoch": 0, "sets": {}}
                wire.setdefault("sets", {})[f"{db}:{set_name}"] = entry
                wire["epoch"] = max(int(wire.get("epoch") or 0),
                                    int(entry.get("epoch") or 0))
                self._placement_wire = wire
        return RemoteIdent(db, set_name)

    def remove_set(self, db: str, set_name: str) -> None:
        self._request(MsgType.REMOVE_SET, {"db": db, "set": set_name})

    def clear_set(self, db: str, set_name: str) -> None:
        self._request(MsgType.CLEAR_SET, {"db": db, "set": set_name})

    def set_exists(self, db: str, set_name: str) -> bool:
        return self._request(MsgType.SET_EXISTS,
                             {"db": db, "set": set_name})["exists"]

    def list_sets(self) -> List[Tuple[str, str]]:
        return [tuple(s) for s in
                self._request(MsgType.LIST_SETS, {})["sets"]]

    def register_type(self, type_name: str, entry_point: str,
                      source: Optional[str] = None,
                      ship_module: bool = False) -> None:
        """Register an entry point the daemon can import; shipping the
        module's source (``source``/``ship_module``) raises."""
        if source is not None or ship_module:
            _later("register_type(source=..., ship_module=...)",
                   "A7 part 2")
        self._request(MsgType.REGISTER_TYPE,
                      {"type_name": type_name, "entry_point": entry_point,
                       "source": None})

    # --- placement-aware routing (shard pools) -------------------------
    def _refresh_placement(self) -> None:
        """Re-read the daemon's placement map (best effort: a failure
        keeps the old map, and the next routed attempt refuses typed
        again). Concurrent callers wait for the fetch in flight and use
        its result; the fetching thread's own re-entry is a no-op."""
        me = threading.get_ident()
        if self._refreshing_placement == me:
            return
        if not self._placement_fetch_mu.acquire(blocking=False):
            self._placement_fetch_mu.acquire()
            self._placement_fetch_mu.release()
            return
        self._refreshing_placement = me
        try:
            wire = self._request(MsgType.PLACEMENT, {})
            with self._placement_mu:
                self._placement_wire = wire
            obs.REGISTRY.counter("serve.client.placement_refreshes").inc()
        except Exception as e:  # noqa: BLE001 — best effort by contract
            del e
        finally:
            self._refreshing_placement = None
            self._placement_fetch_mu.release()

    def placement_map(self) -> Optional[Dict[str, Any]]:
        """The cached placement map (None until the daemon has a sharded
        set)."""
        with self._placement_mu:
            return self._placement_wire

    def _placement_entry(self, db: str, set_name: str,
                         refresh: bool = False) -> Optional[Dict]:
        """One set's entry from the cached map; no traffic unless
        ``refresh``."""
        from netsdb_tpu_torch.serve.placement import PlacementMap

        if refresh:
            self._refresh_placement()
        with self._placement_mu:
            wire = self._placement_wire
        if not wire:
            return None
        return PlacementMap.entry_from_wire(wire, db, set_name)

    def _shard_client(self, addr: str) -> "RemoteClient":
        """Cached direct connection to one shard daemon, one attempt per
        request: the routed loop owns the retries (it refreshes the map
        between them)."""
        with self._placement_mu:
            sc = self._shard_clients.get(addr)
        if sc is not None:
            return sc
        sc = RemoteClient(addr, token=self.token, timeout=self._timeout,
                          retry=RetryPolicy(max_attempts=1),
                          connect_timeout=self._connect_timeout,
                          ingest_window=self.ingest_window,
                          ingest_chunk_bytes=self.ingest_chunk_bytes,
                          client_id=self.client_id, lane=self.lane)
        with self._placement_mu:
            other = self._shard_clients.setdefault(addr, sc)
        if other is not sc:
            sc.close()
        return other

    def _drop_shard_client(self, addr: str) -> None:
        with self._placement_mu:
            sc = self._shard_clients.pop(addr, None)
        if sc is not None:
            sc.close()

    def _send_partition(self, addr: str, db: str, set_name: str, part,
                        as_table: bool, date_cols, epoch: int, slot: int,
                        token: str, chunk_bytes: int) -> Any:
        """One slot's partition to its owner (or to the leader, for a
        slot in handoff): big payloads stream with the epoch in the BEGIN
        meta, small ones ride one frame. ``token`` is the slot's stable
        idempotency token, so a retried partition dedupes."""
        from netsdb_tpu_torch.relational.table import ColumnTable

        sc = self._shard_client(addr)
        routed = {"pepoch": int(epoch), "slot": int(slot)}
        if isinstance(part, ColumnTable):
            nbytes = sum(int(v.nbytes) for v in part.cols.values())
            if nbytes >= chunk_bytes:
                return sc._bulk_request(
                    MsgType.SEND_DATA,
                    {"db": db, "set": set_name, "mode": "table",
                     "date_cols": list(date_cols), "append": True,
                     "dicts": {k: list(v) for k, v in part.dicts.items()},
                     "nrows": int(part.num_rows), **routed},
                    sc._table_chunks(part, chunk_bytes), token=token)
            payload: Dict[str, Any] = {
                "db": db, "set": set_name, "items": part,
                "as_table": True, "date_cols": list(date_cols),
                "append": True}
        elif len(part) >= self.PIPELINE_MIN_ITEMS:
            meta = {"db": db, "set": set_name, "mode": "items", **routed}
            if as_table:
                meta.update(as_table=True, date_cols=list(date_cols),
                            append=True)
            return sc._bulk_request(
                MsgType.SEND_DATA, meta,
                sc._item_chunks(list(part), chunk_bytes), token=token)
        elif as_table:
            payload = {"db": db, "set": set_name, "items": list(part),
                       "as_table": True, "date_cols": list(date_cols),
                       "append": True}
        else:
            payload = {"db": db, "set": set_name, "items": list(part)}
        payload[PLACEMENT_EPOCH_KEY] = int(epoch)
        payload[SHARD_SLOT_KEY] = int(slot)
        payload[IDEMPOTENCY_KEY] = token
        return sc._request(MsgType.SEND_DATA, payload, codec=CODEC_PICKLE)

    def _routed_ingest(self, db: str, set_name: str, parts: Dict[int, Any],
                       as_table: bool, date_cols,
                       chunk_bytes: int) -> Dict[int, Any]:
        """One logical ingest fanned out to the owning shards in parallel.
        Failed slots retry under the RetryPolicy with the map re-read
        between rounds (an evicted slot's partition then goes to the
        leader's handoff buffer); the per-slot tokens keep every retry at
        most once."""
        tokens = {slot: uuid.uuid4().hex for slot in parts}
        remaining = dict(parts)
        replies: Dict[int, Any] = {}
        policy = self._retry
        attempt = 1
        obs.REGISTRY.counter("serve.client.routed_ingests").inc()
        while True:
            entry = self._placement_entry(db, set_name, refresh=attempt > 1)
            if entry is None:
                raise PlacementStaleError(
                    "PlacementStale",
                    f"{db}:{set_name} vanished from the placement map")
            errors: Dict[int, BaseException] = {}
            lock = threading.Lock()

            def send_slot(slot, part, entry=entry, errors=errors,
                          lock=lock):
                sl = entry["slots"][slot]
                addr = (self.current_address if sl["state"] != "live"
                        else sl["addr"])
                try:
                    reply = self._send_partition(
                        addr, db, set_name, part, as_table, date_cols,
                        entry["epoch"], slot, tokens[slot], chunk_bytes)
                    with lock:
                        replies[slot] = reply
                except Exception as e:  # noqa: BLE001 — every failure
                    # lands in errors, or its partition would be lost
                    self._drop_shard_client(addr)
                    with lock:
                        errors[slot] = e

            threads = [threading.Thread(target=send_slot, args=(slot, part),
                                        daemon=True)
                       for slot, part in remaining.items()]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            remaining = {slot: part for slot, part in remaining.items()
                         if slot in errors}
            if not remaining:
                return replies
            # a deterministic slot failure wins at once
            fatal = next((e for e in errors.values()
                          if isinstance(e, RemoteError) and not e.retryable),
                         None)
            if fatal is not None:
                raise fatal
            if attempt >= policy.max_attempts:
                raise next(iter(errors.values()))
            if not all(isinstance(e, PlacementStaleError)
                       for e in errors.values()):
                # transport faults back off; stale-map refusals resolve
                # with the refresh at the top of the next round
                time.sleep(policy.backoff_s(attempt, self._rng))
            attempt += 1
            self._count_retry(next(iter(errors.values())))

    # --- data path ----------------------------------------------------
    def _item_chunks(self, items: list, chunk_bytes: int):
        """Adaptive item batching: the first chunk holds one item, then
        the batch tracks the observed bytes per item (growth capped at
        4× per chunk); each blob rides out of band as a uint8 view."""
        def chunks():
            i = 0
            target = 1
            while i < len(items):
                batch = items[i:i + target]
                blob = pickle.dumps(batch, protocol=pickle.HIGHEST_PROTOCOL)
                yield {"n": len(batch), "blob": np.frombuffer(blob, np.uint8)}
                per_item = max(len(blob) // len(batch), 1)
                target = max(1, min(chunk_bytes // per_item, 4 * target))
                i += len(batch)

        return chunks

    def send_data(self, db: str, set_name: str, items: Sequence[Any],
                  pipeline: Optional[bool] = None,
                  chunk_bytes: Optional[int] = None) -> None:
        """Object ingest. Big batches stream as bounded chunks under the
        windowed-ack pipeline (``pipeline=None`` decides by item count;
        ``True``/``False`` pins a path)."""
        from netsdb_tpu_torch.serve import placement as _pl

        items = list(items)
        cb = int(chunk_bytes or self.ingest_chunk_bytes)
        entry = self._placement_entry(db, set_name)
        if entry is not None:
            self._routed_ingest(db, set_name,
                                dict(_pl.split_items(items, entry)),
                                as_table=False, date_cols=(),
                                chunk_bytes=cb)
            return
        use = (pipeline if pipeline is not None
               else len(items) >= self.PIPELINE_MIN_ITEMS)
        try:
            if not use:
                self._request(MsgType.SEND_DATA,
                              {"db": db, "set": set_name, "items": items},
                              codec=CODEC_PICKLE)
                return
            self._bulk_request(MsgType.SEND_DATA,
                               {"db": db, "set": set_name, "mode": "items"},
                               self._item_chunks(items, cb))
        except PlacementStaleError:
            # the set was sharded after this client's map: route
            if self._placement_entry(db, set_name, refresh=True) is None:
                raise
            self.send_data(db, set_name, items, pipeline=pipeline,
                           chunk_bytes=chunk_bytes)

    @staticmethod
    def _table_chunks(table, chunk_bytes: int):
        """Row-range slices of a table's host columns, riding out of
        band; the dictionaries travel once in the BEGIN meta."""
        cols = {k: np.ascontiguousarray(_host_array(v))
                for k, v in table.cols.items()}
        nrows = int(table.num_rows)
        row_bytes = max(1, sum(c.dtype.itemsize for c in cols.values()))
        per_chunk = max(1, chunk_bytes // row_bytes)

        def chunks():
            for start in range(0, max(nrows, 1), per_chunk):
                stop = min(nrows, start + per_chunk)
                yield {"rows": [start, stop],
                       "cols": {k: v[start:stop] for k, v in cols.items()}}

        return chunks

    def send_table(self, db: str, set_name: str, rows_or_table,
                   date_cols: Sequence[str] = (),
                   append: bool = False,
                   pipeline: Optional[bool] = None,
                   chunk_bytes: Optional[int] = None) -> RemoteTableInfo:
        """Ship rows (or a ``ColumnTable``) for daemon-side columnar
        ingest; returns a :class:`RemoteTableInfo`. A table streams as
        row-range column slices out of band, rows as pickled batches,
        both under the windowed-ack pipeline when big
        (``pipeline=None`` decides by size). A partitioned set routes:
        the rows split across the owning shards, each partition straight
        to its daemon; ``append=False`` first clears the set pool-wide."""
        cb = int(chunk_bytes or self.ingest_chunk_bytes)
        if self._placement_entry(db, set_name) is not None:
            return self._send_table_routed(db, set_name, rows_or_table,
                                           date_cols, append, cb)
        try:
            return self._send_table_plain(db, set_name, rows_or_table,
                                          date_cols, append, pipeline, cb)
        except PlacementStaleError:
            # the set was sharded after this client's map: route
            if self._placement_entry(db, set_name, refresh=True) is None:
                raise
            return self.send_table(db, set_name, rows_or_table,
                                   date_cols=date_cols, append=append,
                                   pipeline=pipeline,
                                   chunk_bytes=chunk_bytes)

    def _send_table_routed(self, db: str, set_name: str, rows_or_table,
                           date_cols, append: bool,
                           chunk_bytes: int) -> RemoteTableInfo:
        from netsdb_tpu_torch.relational.table import ColumnTable
        from netsdb_tpu_torch.serve import placement as _pl

        entry = self._placement_entry(db, set_name)
        if not append:
            # replace = a pool-wide clear, then the partitions append
            self.clear_set(db, set_name)
        if isinstance(rows_or_table, ColumnTable):
            table = rows_or_table
            self._routed_ingest(db, set_name,
                                dict(_pl.split_table(table, entry)),
                                as_table=True, date_cols=date_cols,
                                chunk_bytes=chunk_bytes)
            total = int(table.compact().num_rows if table.valid is not None
                        else table.num_rows)
            return RemoteTableInfo(total, sorted(table.cols))
        items = list(rows_or_table)
        replies = self._routed_ingest(db, set_name,
                                      dict(_pl.split_items(items, entry)),
                                      as_table=True, date_cols=date_cols,
                                      chunk_bytes=chunk_bytes)
        cols = sorted({c for r in replies.values() if isinstance(r, dict)
                       for c in (r.get("columns") or ())})
        return RemoteTableInfo(len(items), cols)

    def _send_table_plain(self, db, set_name, rows_or_table, date_cols,
                          append, pipeline, cb) -> RemoteTableInfo:
        from netsdb_tpu_torch.relational.table import ColumnTable

        if isinstance(rows_or_table, ColumnTable):
            table = rows_or_table
            if table.valid is not None:
                table = table.compact()
            nbytes = sum(int(v.nbytes) for v in table.cols.values())
            use = pipeline if pipeline is not None else nbytes >= cb
            if use:
                reply = self._bulk_request(
                    MsgType.SEND_DATA,
                    {"db": db, "set": set_name, "mode": "table",
                     "date_cols": list(date_cols), "append": append,
                     "dicts": {k: list(v) for k, v in table.dicts.items()},
                     "nrows": int(table.num_rows)},
                    self._table_chunks(table, cb))
                return RemoteTableInfo(reply["count"],
                                       list(reply["columns"]))
            items: Any = table.to("cpu")
        else:
            items = list(rows_or_table)
            use = (pipeline if pipeline is not None
                   else len(items) >= self.PIPELINE_MIN_ITEMS)
            if use:
                reply = self._bulk_request(
                    MsgType.SEND_DATA,
                    {"db": db, "set": set_name, "mode": "items",
                     "as_table": True, "date_cols": list(date_cols),
                     "append": append},
                    self._item_chunks(items, cb))
                return RemoteTableInfo(reply["count"],
                                       list(reply["columns"]))
        reply = self._request(
            MsgType.SEND_DATA,
            {"db": db, "set": set_name, "items": items, "as_table": True,
             "date_cols": list(date_cols), "append": append},
            codec=CODEC_PICKLE)
        return RemoteTableInfo(reply["count"], list(reply["columns"]))

    def analyze_set(self, db: str, set_name: str) -> Dict[str, Any]:
        """Planner statistics computed daemon-side; only the summaries
        cross the wire."""
        from netsdb_tpu_torch.relational.stats import ColumnStats

        reply = self._request(MsgType.ANALYZE_SET,
                              {"db": db, "set": set_name})
        return {"num_rows": reply["num_rows"],
                "dicts": {k: list(v) for k, v in reply["dicts"].items()},
                "stats": {k: ColumnStats(*v)
                          for k, v in reply["stats"].items()}}

    def get_table(self, db: str, set_name: str):
        """A table set as a host ``ColumnTable``."""
        from netsdb_tpu_torch.relational.table import ColumnTable

        tables = [i for i in self.get_set_iterator(db, set_name)
                  if isinstance(i, ColumnTable)]
        if len(tables) != 1:
            raise ValueError(
                f"set {db}:{set_name} holds {len(tables)} tables; expected 1")
        return tables[0]

    def send_matrix(self, db: str, set_name: str, dense, block_shape=None,
                    dtype=None) -> RemoteTensor:
        """Send a dense matrix (its buffer rides out of band, no copy);
        the daemon blocks it on its device."""
        dense = _host_array(dense)
        if dtype is not None:
            dense = dense.astype(dtype)
        entry = self._placement_entry(db, set_name)
        if entry is not None:
            return self._send_matrix_routed(db, set_name, dense,
                                            block_shape, entry)
        reply = self._request(MsgType.SEND_MATRIX, {
            "db": db, "set": set_name,
            "tensor": tensor_to_wire(dense, block_shape)})
        return RemoteTensor(dense, reply.get("block_shape"))

    def _send_matrix_routed(self, db: str, set_name: str, dense,
                            block_shape, entry) -> RemoteTensor:
        """Batch-partitioned tensor ingest (the serving frame): rows split
        by the placement's contiguous range slices, slice *i* to slot
        *i*, so slot order is batch order; slices go out in parallel. A
        degraded slot's typed refusal surfaces to the caller (a scoring
        batch is transient: no handoff buffering)."""
        from netsdb_tpu_torch.serve import placement as _pl

        if entry.get("mode") != "range":
            raise ValueError(
                f"tensor set {db}:{set_name} is partitioned "
                f"{entry.get('mode')!r}; matrices shard by contiguous row "
                f"ranges only — create with placement=\"range\"")
        slots = entry["slots"]
        slices = _pl.range_slices(int(dense.shape[0]), len(slots))
        errors: Dict[int, BaseException] = {}
        lock = threading.Lock()

        def send_slot(i: int, lo: int, hi: int) -> None:
            sl = slots[i]
            addr = (self.current_address if sl["state"] != "live"
                    else sl["addr"])
            try:
                self._shard_client(addr)._request(MsgType.SEND_MATRIX, {
                    "db": db, "set": set_name,
                    "tensor": tensor_to_wire(
                        np.ascontiguousarray(dense[lo:hi]), block_shape),
                    PLACEMENT_EPOCH_KEY: int(entry["epoch"]),
                    SHARD_SLOT_KEY: i})
            except Exception as e:  # noqa: BLE001 — surfaced below
                self._drop_shard_client(addr)
                with lock:
                    errors[i] = e

        threads = [threading.Thread(target=send_slot, args=(i, lo, hi),
                                    daemon=True)
                   for i, (lo, hi) in enumerate(slices)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[min(errors)]
        obs.REGISTRY.counter("serve.client.routed_ingests").inc()
        return RemoteTensor(dense, list(block_shape) if block_shape else None)

    def get_tensor(self, db: str, set_name: str) -> RemoteTensor:
        reply = self._request(MsgType.GET_TENSOR,
                              {"db": db, "set": set_name})
        return RemoteTensor(reply["data"], reply.get("block_shape"))

    def paged_matmul(self, db: str, set_name: str, rhs) -> np.ndarray:
        """``stored @ rhs`` computed daemon-side, the paged matrix
        streamed from the arena."""
        reply = self._request(MsgType.PAGED_MATMUL,
                              {"db": db, "set": set_name,
                               "rhs": _host_array(rhs)})
        return np.asarray(reply["data"])

    def get_tensor_chunked(self, db: str, set_name: str,
                           chunk_bytes: int = 8 << 20) -> RemoteTensor:
        """Pull a tensor as a chunked stream: this side holds the result
        plus one chunk."""
        meta = None
        buf = None
        off = 0
        for frame in self._stream(MsgType.GET_TENSOR_CHUNKED,
                                  {"db": db, "set": set_name,
                                   "chunk_bytes": int(chunk_bytes)}):
            if meta is None:
                meta = frame["meta"]
                buf = bytearray(meta["nbytes"])
            else:
                b = frame["b"]
                n = b.nbytes if isinstance(b, np.ndarray) else len(b)
                buf[off:off + n] = memoryview(b) if isinstance(
                    b, np.ndarray) else b
                off += n
        if meta is None:
            raise ProtocolError("empty chunked-tensor stream")
        dense = np.frombuffer(buf, dtype=np.dtype(meta["dtype"])
                              ).reshape(meta["shape"])
        return RemoteTensor(dense, meta.get("block_shape"))

    def get_set_iterator(self, db: str, set_name: str) -> Iterator[Any]:
        reply = self._request(MsgType.SCAN_SET, {"db": db, "set": set_name})
        return iter(reply["items"])

    def scan_stream(self, db: str, set_name: str,
                    max_frame_bytes: int = 4 << 20) -> Iterator[Any]:
        """Stream a set's items with bounded buffering on both ends (one
        frame at a time). The connection is held while iterating;
        abandoning the iterator drops it and the next request
        re-dials."""
        for frame in self._stream(MsgType.SCAN_SET_STREAM,
                                  {"db": db, "set": set_name,
                                   "max_frame_bytes": int(max_frame_bytes)}):
            yield from pickle.loads(frame["batch"])

    def get_table_streamed(self, db: str, set_name: str,
                           max_frame_bytes: int = 4 << 20):
        """Assemble a table set from the streamed scan."""
        from netsdb_tpu_torch.relational.table import ColumnTable

        parts: dict = {}
        dicts: dict = {}
        got = False
        with contextlib.closing(
                self.scan_stream(db, set_name, max_frame_bytes)) as items:
            for item in items:
                if not isinstance(item, ColumnTable):
                    raise TypeError(f"set {db}:{set_name} holds "
                                    f"{type(item).__name__} items, not "
                                    f"tables")
                got = True
                dicts.update(item.dicts)
                cols = item.compact().cols if item.valid is not None \
                    else item.cols
                for k, v in cols.items():
                    parts.setdefault(k, []).append(_host_array(v))
        if not got:
            raise ValueError(f"set {db}:{set_name} is empty")
        import torch

        return ColumnTable({k: torch.from_numpy(np.concatenate(v))
                            for k, v in parts.items()}, dicts, None)

    def _stream_frames(self, sock: socket.socket, msg_type: MsgType,
                       payload: Any) -> Iterator[Any]:
        send_frame(sock, msg_type, payload, chaos=self._chaos)
        while True:
            typ, reply = self._recv_reply(sock)
            if typ == MsgType.STREAM_END:
                return
            if typ == MsgType.ERR:
                raise classify_remote(reply)
            yield reply

    def _stream_hedged(self, msg_type: MsgType,
                       payload: Any) -> Iterator[Any]:
        """A streaming read that hedges its first item: the primary
        opens the stream on a connection of its own; if its first frame
        has not landed within :meth:`hedge_delay_s`, the same request
        goes to the next replica, and the connection that delivers a
        first frame first wins — the loser's socket is closed at once,
        so at most one duplicated first frame crosses the wire. The
        winner's stream is then read inline. The persistent connection
        stays free for nested requests."""
        first_q: "_queue.Queue" = _queue.Queue()
        socks: Dict[str, socket.socket] = {}
        cancelled: set = set()
        state_lock = threading.Lock()

        def opener(tag: str, address: Optional[str]) -> None:
            s = None
            try:
                s = self._dial(address=address)
                with state_lock:
                    if tag in cancelled:
                        s.close()
                        return
                    socks[tag] = s
                send_frame(s, msg_type, payload, chaos=self._chaos)
                typ, reply = self._recv_reply(s)
                first_q.put((tag, typ, reply, None))
            except BaseException as e:  # noqa: BLE001 — surfaced below
                with state_lock:
                    socks.pop(tag, None)
                if s is not None:
                    s.close()
                first_q.put((tag, None, None, e))

        threading.Thread(target=opener, daemon=True,
                         args=("primary", None)).start()
        t0 = time.perf_counter()
        try:
            winner = first_q.get(timeout=self.hedge_delay_s())
            legs = 1 if winner[0] == "primary" else 2
        except _queue.Empty:
            self.hedges_issued += 1
            obs.REGISTRY.counter("serve.client.hedges_issued").inc()
            addr = self._replicas[self._hedge_rr % len(self._replicas)]
            self._hedge_rr += 1
            threading.Thread(target=opener, daemon=True,
                             args=("hedge", addr)).start()
            legs = 2
            winner = first_q.get()
            if winner[3] is not None:
                # the first to answer failed: wait for the other; on a
                # double failure the primary's error wins
                other = first_q.get()
                legs = 0
                if other[3] is None or winner[0] == "hedge":
                    winner = other
        tag, typ, frame, err = winner
        if legs:
            # cancel the loser: close its socket, or mark it so a leg
            # not yet dialled closes itself
            with state_lock:
                for other_tag in ("primary", "hedge"):
                    if other_tag == tag:
                        continue
                    cancelled.add(other_tag)
                    s = socks.pop(other_tag, None)
                    if s is not None:
                        try:
                            s.shutdown(socket.SHUT_RDWR)
                        except OSError:
                            pass
                        s.close()
        if err is not None:
            raise err
        if tag == "hedge":
            self.hedges_won += 1
            obs.REGISTRY.counter("serve.client.hedges_won").inc()
        self._observe_read_latency(time.perf_counter() - t0)
        with state_lock:
            sock = socks.pop(tag)
        try:
            while True:
                if typ == MsgType.STREAM_END:
                    return
                if typ == MsgType.ERR:
                    raise classify_remote(frame)
                yield frame
                typ, frame = self._recv_reply(sock)
        finally:
            sock.close()

    def _stream(self, msg_type: MsgType, payload: Any) -> Iterator[Any]:
        """A streaming request: yield each STREAM_ITEM payload until
        STREAM_END (ERR raises; the connection stays synchronized). A
        stream opened from a thread already mid-stream uses its own
        connection."""
        if self.client_id is not None and CLIENT_ID_KEY not in payload:
            payload = dict(payload)
            payload[CLIENT_ID_KEY] = str(self.client_id)
        if self._replicas and self._stream_owner != threading.get_ident():
            yield from self._stream_hedged(msg_type, payload)
            return
        if self._stream_owner == threading.get_ident():
            s = self._dial()
            try:
                yield from self._stream_frames(s, msg_type, payload)
            finally:
                s.close()
            return
        self._lock.acquire()
        self._stream_owner = threading.get_ident()
        done = False
        try:
            if self._sock is None:
                self._connect()
            yield from self._stream_frames(self._sock, msg_type, payload)
            done = True
        except RemoteError:
            done = True  # ERR ends the stream; the connection is in sync
            raise
        finally:
            self._stream_owner = None
            if not done:
                self._drop_connection()
            self._lock.release()

    def dedup_resident(self, sets: Sequence[Tuple[str, str]],
                       bands: int = 16, seed: int = 0) -> Dict[str, Any]:
        """Daemon-side block-level model dedup (``Client.
        dedup_resident``); returns the pooling report."""
        return self._request(MsgType.DEDUP_RESIDENT,
                             {"sets": [list(s) for s in sets],
                              "bands": bands, "seed": seed})

    def add_shared_mapping(self, private_db: str, private_set: str,
                           shared_db: str, shared_set: str,
                           mapping: Optional[Dict] = None) -> None:
        self._request(MsgType.ADD_SHARED_MAPPING, {
            "private_db": private_db, "private_set": private_set,
            "shared_db": shared_db, "shared_set": shared_set,
            "mapping": mapping})

    def flush_data(self) -> None:
        self._request(MsgType.FLUSH_DATA, {})

    def load_set(self, db: str, set_name: str) -> None:
        self._request(MsgType.LOAD_SET, {"db": db, "set": set_name})

    # --- stateful serving (serve/sessions.py) -------------------------
    def open_session(self, db: str, kind: str = "lstm",
                     ttl_s: Optional[float] = None,
                     heads: Optional[int] = None,
                     session_id: Optional[str] = None) -> "SessionHandle":
        """Open one decode session over model ``db`` (the session id is
        minted here); returns a :class:`SessionHandle`."""
        sid = str(session_id or uuid.uuid4().hex)
        payload: Dict[str, Any] = {"op": "open", "sid": sid, "db": db,
                                   "kind": kind, SESSION_KEY: sid}
        if ttl_s is not None:
            payload["ttl_s"] = float(ttl_s)
        if heads is not None:
            payload["heads"] = int(heads)
        rep = self._request(MsgType.SESSION_OPEN, payload)
        return SessionHandle(self, sid, db, kind, owner=rep.get("owner"),
                             spec=rep.get("spec"),
                             steps=int(rep.get("steps", 0)))

    # --- query execution ----------------------------------------------
    def execute_computations(self, *sinks, job_name: str = "remote-job",
                             materialize: bool = True,
                             fetch_results: bool = True,
                             explain: bool = False):
        """Ship the computation DAG (its functions pickled by value) and
        run it on the daemon. Returns ``{ident: value}`` like the
        in-process client (``fetch_results=False``: the summaries only;
        the results stay resident on the daemon). ``explain=True``
        returns ``(results, operators_tree)``."""
        reply = self._request(
            MsgType.EXECUTE_COMPUTATIONS,
            {"sinks": list(sinks), "job_name": job_name,
             "materialize": materialize, "explain": bool(explain)},
            codec=CODEC_PICKLE)
        results = self._collect_results(reply["results"], fetch_results)
        if explain:
            return results, reply.get("operators")
        return results

    def execute_plan(self, plan_text: str, registry: Dict[str, Any],
                     job_name: str = "remote-plan", materialize: bool = True,
                     fetch_results: bool = True, explain: bool = False):
        """Pickle-free execution: plan text plus a label → entry-point
        registry the daemon binds."""
        reply = self._request(
            MsgType.EXECUTE_PLAN,
            {"plan": plan_text, "registry": registry, "job_name": job_name,
             "materialize": materialize, "explain": bool(explain)})
        results = self._collect_results(reply["results"], fetch_results)
        if explain:
            return results, reply.get("operators")
        return results

    def _collect_results(self, summaries: Dict[str, Any],
                         fetch: bool) -> Dict[RemoteIdent, Any]:
        out: Dict[RemoteIdent, Any] = {}
        for key, summary in summaries.items():
            db, _, set_name = key.partition(":")
            ident = RemoteIdent(db, set_name)
            if not fetch:
                out[ident] = summary
            elif summary.get("kind") == "tensor":
                out[ident] = self.get_tensor(db, set_name)
            else:
                items = list(self.get_set_iterator(db, set_name))
                out[ident] = dict(items) if summary.get("kind") == "map" \
                    else items
        return out

    def list_jobs(self) -> List[Dict[str, Any]]:
        return self._request(MsgType.LIST_JOBS, {})["jobs"]

    # --- stats --------------------------------------------------------
    def collect_stats(self) -> Dict[str, Any]:
        return self._request(MsgType.COLLECT_STATS, {})

    def health(self) -> Dict[str, Any]:
        return self._request(MsgType.HEALTH, {})

    def get_trace(self, last: Optional[int] = None,
                  qid: Optional[str] = None,
                  slow: bool = False) -> Dict[str, Any]:
        """Finished query profiles from the daemon's ring, newest last:
        the last ``last``, or one query's (``qid``). A profile whose
        client shipped its spans carries them as ``client``; on a pool
        leader each carries its workers' profiles under ``shards``.
        ``slow=True`` reads the daemon's slow-query log instead."""
        return self._request(MsgType.GET_TRACE,
                             {"last": last, "qid": qid, "slow": bool(slow)})

    def get_metrics(self, format: Optional[str] = None,
                    window_s: Optional[float] = None) -> Dict[str, Any]:
        """The daemon's registry snapshot with the telemetry history's
        summary and rates over ``window_s``; ``format="openmetrics"``:
        the Prometheus text exposition instead (``{"text": ...}``)."""
        payload: Dict[str, Any] = {}
        if format:
            payload["format"] = format
        if window_s is not None:
            payload["window_s"] = float(window_s)
        return self._request(MsgType.GET_METRICS, payload)

    def placement_view(self) -> Dict[str, Any]:
        """The leader's live placement table: per-slot owner, state and
        bytes of every sharded set, and the per-member totals."""
        return self._request(MsgType.RESHARD, {"op": "view"},
                             codec=CODEC_PICKLE)

    def resync_follower(self, snapshot_blob, step: int,
                        chunk_bytes: int = 8 << 20,
                        mutlog_pos: Optional[list] = None) -> Dict[str, Any]:
        """Stream a leader's store snapshot (``checkpoint.dumps_store``
        bytes) to this daemon in bounded frames under the windowed-ack
        pipeline: a follower resync with no shared filesystem. Chunks
        are slices of the blob riding out of band (no copies here).
        ``mutlog_pos``: the leader-log position the snapshot holds."""
        mv = memoryview(snapshot_blob).cast("B")

        def chunks():
            for off in range(0, max(mv.nbytes, 1), chunk_bytes):
                yield {"blob": np.frombuffer(mv[off:off + chunk_bytes],
                                             np.uint8)}

        meta: Dict[str, Any] = {"step": int(step), "nbytes": mv.nbytes}
        if mutlog_pos is not None:
            meta["mutlog_pos"] = list(mutlog_pos)
        return self._bulk_request(MsgType.RESYNC_FOLLOWER, meta, chunks)

    def rebalance_status(self):
        _later("rebalance_status (shard rebalancing)", "A7 part 2")

    def add_worker(self, addr: str, campaign: bool = True):
        _later("add_worker (shard rebalancing)", "A7 part 2")


class SessionHandle:
    """Client-side handle of one interactive decode session. Each
    logical step mints one idempotency token and resends it on every
    retry, so an applied-but-unanswered step is answered from the
    daemon's record instead of advancing the state twice."""

    def __init__(self, client: RemoteClient, sid: str, db: str,
                 kind: str, owner: Optional[str] = None,
                 spec: Optional[Dict[str, Any]] = None, steps: int = 0):
        self._client = client
        self.sid = sid
        self.db = db
        self.kind = kind
        self.owner = owner or client.current_address
        self.spec = spec or {}
        self.steps = int(steps)
        self.moves = 0  # owner re-points (sessions on workers: A7 part 2)
        self._closed = False

    def generate(self, x, deadline_s: float = 30.0) -> np.ndarray:
        """One decode step: the model's output row for this session,
        retried under ``deadline_s`` with one token for the step."""
        if self._closed:
            raise RuntimeError(f"session {self.sid!r} is closed")
        payload = {"db": self.db, "set": self.sid, "sid": self.sid,
                   "x": np.asarray(_host_array(x), np.float32),
                   SESSION_KEY: self.sid,
                   IDEMPOTENCY_KEY: uuid.uuid4().hex}
        rep = self._client._request(MsgType.GENERATE, payload,
                                    codec=CODEC_PICKLE,
                                    deadline_s=deadline_s)
        self.steps = int(rep.get("steps", self.steps + 1))
        return np.asarray(rep["y"])

    def close(self, deadline_s: float = 10.0) -> bool:
        """Close the session on the daemon (idempotent; the TTL sweep
        collects what a lost close leaves)."""
        if self._closed:
            return False
        self._closed = True
        try:
            rep = self._client._request(
                MsgType.SESSION_CLOSE,
                {"sid": self.sid, "db": self.db, "set": self.sid},
                deadline_s=deadline_s)
            return bool(rep.get("closed"))
        except (RemoteError, ConnectionError, OSError):
            return False

    def __enter__(self) -> "SessionHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        return (f"<SessionHandle {self.sid[:8]} db={self.db!r} "
                f"owner={self.owner} steps={self.steps}>")
