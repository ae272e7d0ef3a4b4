"""Typed failure taxonomy for the serve control plane.

The reference surfaces every RPC failure as an ``errMsg`` string the
caller string-matches (``src/communication/headers/PDBCommunicator.h``);
we instead split faults into two machine-readable families so the
client can decide mechanically:

* **retryable** — the request may not have been observed, or the
  condition is transient: connection reset, mid-frame truncation,
  corrupt frame, admission queue full, follower degraded/resyncing.
  :class:`RemoteClient` retries these with exponential backoff +
  jitter, bounded by a per-request deadline. Mutating frames carry an
  idempotency token so a retry after an ambiguous outcome (the server
  may have applied the mutation but the reply was lost) is deduplicated
  server-side instead of double-applied.
* **fatal** — the request was observed and deterministically refused:
  handler errors, protocol violations, refused codecs, bad auth.
  Retrying would yield the same answer; the error is raised immediately.

Server side, handlers raise :class:`ServeFault` subclasses whose
``retryable`` flag crosses the wire in the ERR payload; client side,
:func:`classify_remote` rebuilds the matching :class:`RemoteError`
subclass from the frame. Both halves live in one module so the kind
names cannot drift apart.
"""

from __future__ import annotations

from typing import Any, Dict


# --- server-side faults ------------------------------------------------

class ServeFault(Exception):
    """A fault a server handler raises deliberately. ``retryable``
    rides the ERR payload so clients classify without string-matching;
    ``kind`` is the wire name (defaults to the class name)."""

    retryable = False

    @property
    def kind(self) -> str:
        return type(self).__name__


class AdmissionFull(ServeFault):
    """The job-admission layer did not free a slot within the
    admission timeout — back off and retry (the reference's
    QuerySchedulerServer would park the job; we refuse typed instead of
    wedging a handler thread). ``retry_after_s`` is the scheduler's
    OWN backoff hint — the lane's observed queue-wait median, which a
    client honors instead of blind exponential jitter; ``queue_depth``
    and ``lane`` identify how deep behind which lane the request was
    parked. All three ride the ERR payload."""

    retryable = True

    def __init__(self, *args, retry_after_s=None, queue_depth=None,
                 lane=None):
        super().__init__(*args)
        self.retry_after_s = retry_after_s
        self.queue_depth = queue_depth
        self.lane = lane


class LaneSaturated(ServeFault):
    """One client lane's admission QUOTA is full — distinct from
    :class:`AdmissionFull` (the whole daemon saturated) by design: the
    right client reaction is per-tenant backoff, not failover, and an
    operator alerting on quota rejections must be able to tell "this
    tenant is over its share" from "the daemon is drowning". Carries
    the lane's observed queue depth and the scheduler's
    ``retry_after_s`` hint (the lane's queue-wait median)."""

    retryable = True

    def __init__(self, *args, lane=None, queue_depth=None,
                 retry_after_s=None):
        super().__init__(*args)
        self.lane = lane
        self.queue_depth = queue_depth
        self.retry_after_s = retry_after_s


class CoalesceAborted(ServeFault):
    """A coalesced waiter's leader execution died (or outlived the
    coalesce wait bound) before producing a reply. The waiter's own
    request never ran and nothing was applied under its token — a
    retry re-executes from scratch: a FAILED leader's flight leaves
    the table before waiters release, and an over-age (still-running)
    flight is never re-joined, so the retry runs solo. Never carries
    a partial reply: a waiter gets the leader's COMPLETE result or
    this typed retryable error."""

    retryable = True


class FollowerDegraded(ServeFault):
    """A follower failed mid-mirror (or a resync is in progress). The
    leader keeps serving from its own store; the follower is evicted
    and resynced in the background. When the local mutation already
    applied, ``local_result`` carries its reply so the idempotent retry
    returns success without re-executing."""

    retryable = True

    def __init__(self, *args):
        super().__init__(*args)
        self.local_result = None


class CorruptFrame(ServeFault):
    """A frame arrived but its body failed to decode (bit flips, torn
    writes). The request was never executed, so a resend is safe."""

    retryable = True


class PlacementStale(ServeFault):
    """A frame routed under an out-of-date placement map: its epoch no
    longer matches the target set's (the leader evicted or readmitted
    a shard since the sender's map was fetched), or the sender didn't
    know the set was partitioned at all. Nothing was applied — the
    typed retryable contract is refresh-then-re-route: the client
    re-fetches the map (``RemoteClient`` does this automatically
    between attempts) and re-partitions against current membership.
    ``epoch`` carries the receiver's current epoch for the set."""

    retryable = True

    def __init__(self, *args, epoch=None):
        super().__init__(*args)
        self.epoch = epoch


class ShardUnavailable(ServeFault):
    """A scatter-gather coordinator (or routed ingest) needs a shard
    slot that is currently degraded/unreachable. The query was NOT
    partially merged — partials are discarded whole, never combined
    across epochs — and retrying after the shard readmits (or the
    leader revises placement) succeeds. Carries the affected ``slot``
    and the set's current ``epoch``."""

    retryable = True

    def __init__(self, *args, slot=None, epoch=None):
        super().__init__(*args)
        self.slot = slot
        self.epoch = epoch


class NotLeader(ServeFault):
    """This daemon cannot accept the write: it is an HA follower (the
    client aimed at the wrong daemon, or a failover moved the role),
    or the frame carried a STALE term (a deposed leader's straggler —
    fenced, never applied). ``leader_addr`` carries the leader this
    daemon knows about (None mid-election) so the client re-points
    WITHOUT a discovery scan; ``term`` is this daemon's current term.
    Retryable by contract: nothing was applied, and the retry against
    the right leader dedupes under the same idempotency token."""

    retryable = True

    def __init__(self, *args, leader_addr=None, term=None):
        super().__init__(*args)
        self.leader_addr = leader_addr
        self.term = term


class SessionMoved(ServeFault):
    """A session-scoped frame (GENERATE / SESSION_CLOSE) arrived at a
    daemon that no longer owns the session's state: the session was
    relocated (owner death adoption, a live session rebalance) or the
    frame hit the leader for a worker-owned session. Nothing was
    applied — the state advanced zero steps here. ``owner_addr`` names
    the daemon that owns it NOW (None when only a table lookup at the
    leader can answer), so the client's sticky handle re-points
    without a discovery scan and retries under the same idempotency
    token."""

    retryable = True

    def __init__(self, *args, owner_addr=None):
        super().__init__(*args)
        self.owner_addr = owner_addr


class SessionUnknown(ServeFault):
    """The session id is not in the (replicated) session table: never
    opened here, already closed, or expired past its TTL with no spill
    left to revive from. Fatal by contract — retrying the same handle
    cannot help; the caller opens a fresh session."""

    retryable = False


class RequestInFlight(ServeFault):
    """A duplicate idempotency token arrived while the original request
    is still executing; the retry should back off and re-ask (it will
    then hit the completed-result cache)."""

    retryable = True


# --- client-side errors ------------------------------------------------

class RemoteError(RuntimeError):
    """Base: a request failed. ``kind`` is the server-side exception
    class name (or the local failure type), ``remote_traceback`` the
    server traceback when one crossed the wire. Fatal unless a subclass
    says otherwise."""

    retryable = False

    def __init__(self, kind: str, message: str, remote_traceback: str = ""):
        super().__init__(f"{kind}: {message}")
        self.kind = kind
        self.remote_traceback = remote_traceback
        # scheduler backpressure details (populated by classify_remote
        # when the ERR frame carried them — AdmissionFull/LaneSaturated)
        self.retry_after_s = None
        self.queue_depth = None
        self.lane = None
        # placement details (PlacementStale/ShardUnavailable family)
        self.epoch = None
        self.slot = None
        # HA failover details (NotLeader family): where the leader
        # moved and the rejecting daemon's term
        self.leader_addr = None
        self.term = None
        # session stickiness details (SessionMoved family): where the
        # session's state lives now
        self.owner_addr = None


class RetryableRemoteError(RemoteError):
    """The transient family — safe to resend (mutations are deduped
    server-side via the idempotency token)."""

    retryable = True


class ConnectionLostError(RetryableRemoteError):
    """The transport died mid-request (reset, refused dial, peer closed
    mid-frame). The outcome is ambiguous: the server may or may not
    have executed the request — exactly what idempotency tokens are
    for."""


class RemoteTimeoutError(RetryableRemoteError):
    """The socket-level timeout expired waiting for the peer."""


class AdmissionFullError(RetryableRemoteError):
    """Server-side :class:`AdmissionFull` — job queue saturated. When
    the frame carried one, ``retry_after_s`` is the scheduler's
    backoff hint (the lane's observed queue-wait median) and the
    client's retry loop sleeps THAT instead of blind exponential
    jitter."""


class LaneSaturatedError(RetryableRemoteError):
    """Server-side :class:`LaneSaturated` — THIS client's lane quota
    is full (the daemon may be otherwise idle). ``lane``,
    ``queue_depth`` and ``retry_after_s`` carry the scheduler's view;
    back off per-tenant, don't fail over."""


class CoalesceAbortedError(RetryableRemoteError):
    """Server-side :class:`CoalesceAborted` — this request was
    coalesced behind an identical in-flight execution whose leader
    died mid-run. Nothing executed under this request; a retry
    re-executes from scratch."""


class FollowerDegradedError(RetryableRemoteError):
    """Server-side :class:`FollowerDegraded` — a follower was evicted
    mid-request or a resync holds the mutation path. The leader applied
    the local mutation; the idempotent retry returns its result."""


class CorruptFrameError(RetryableRemoteError):
    """Server-side :class:`CorruptFrame` — the frame body failed to
    decode; the request never ran."""


class PlacementStaleError(RetryableRemoteError):
    """Server-side :class:`PlacementStale` — the frame rode an
    out-of-date placement map and was rejected whole. ``epoch`` (when
    the frame carried it) is the receiver's current epoch for the set;
    :class:`RemoteClient` refreshes its cached map between attempts so
    the retry re-routes against current membership."""


class ShardUnavailableError(RetryableRemoteError):
    """Server-side :class:`ShardUnavailable` — a shard slot the
    request needs is degraded. Nothing was partially applied or
    merged; retry after the pool heals (backoff applies)."""


class NotLeaderError(RetryableRemoteError):
    """Server-side :class:`NotLeader` — the daemon is a follower (or a
    deposed leader that already fenced this client's frame).
    ``leader_addr`` (when the rejection carried one) names the daemon
    to re-point at; :class:`RemoteClient` switches its address and
    retries immediately, or backs off through the election window when
    no leader is known yet. ``term`` is the rejecting daemon's current
    term."""


class SessionMovedError(RetryableRemoteError):
    """Server-side :class:`SessionMoved` — the session's state lives on
    a different daemon now. ``owner_addr`` (when the rejection carried
    one) names the new owner; the client's session handle re-points at
    it — or re-asks the leader's session table when it didn't — and
    retries under the same token. The typed relocation signal that
    makes stickiness survive rebalance and failover."""


class SessionUnknownError(RemoteError):
    """Server-side :class:`SessionUnknown` — the session id is gone
    (closed or TTL-expired with no spill). Fatal: open a new
    session."""


class AuthError(RemoteError):
    """Handshake refused — fatal, retrying cannot help."""


class ProtocolVersionError(RemoteError):
    """The peer speaks a different wire-format version (HELLO carries
    ``proto``; see ``protocol.PROTO_VERSION``). Fatal by construction:
    a v2 peer would misparse a v3 out-of-band segment table as body
    bytes, so mixed-version connections are refused at handshake."""


class DeadlineExceededError(RemoteError):
    """The per-request deadline expired before a retry could succeed.
    Deliberately NOT retryable: the budget is spent; the caller decides
    whether to re-issue with a fresh deadline."""


_KIND_MAP: Dict[str, type] = {
    "AdmissionFull": AdmissionFullError,
    "LaneSaturated": LaneSaturatedError,
    "CoalesceAborted": CoalesceAbortedError,
    "FollowerDegraded": FollowerDegradedError,
    "CorruptFrame": CorruptFrameError,
    "PlacementStale": PlacementStaleError,
    "ShardUnavailable": ShardUnavailableError,
    "NotLeader": NotLeaderError,
    "SessionMoved": SessionMovedError,
    "SessionUnknown": SessionUnknownError,
    "AuthError": AuthError,
    "ProtocolVersionError": ProtocolVersionError,
}

#: scheduler-backpressure detail fields that cross the wire inside the
#: ERR payload (server ``_send_err`` includes them when the fault
#: carries them; ``classify_remote`` rebuilds them on the error).
#: ``epoch``/``slot`` are the placement family's analogues: the
#: receiver's current epoch rides the rejection so a client can tell
#: "my map is stale" from "the pool is degraded".
#: ``leader_addr``/``term`` are the HA family's: a NotLeader rejection
#: names the daemon to re-point at and the rejecting daemon's term.
#: ``owner_addr`` is the session family's: a SessionMoved rejection
#: names the daemon holding the session's state now.
BACKPRESSURE_FIELDS = ("retry_after_s", "queue_depth", "lane",
                       "epoch", "slot", "leader_addr", "term",
                       "owner_addr")


def classify_remote(reply: Dict[str, Any]) -> RemoteError:
    """ERR frame payload → the matching typed error. Known kinds map to
    their dedicated class; unknown kinds fall back on the frame's
    ``retryable`` flag (so new server faults degrade gracefully to the
    right *family* on old clients). Scheduler backpressure details
    (``retry_after_s``/``queue_depth``/``lane``) are rebuilt onto the
    error so the retry loop can honor the server's hint."""
    kind = reply.get("error", "Error")
    message = reply.get("message", "")
    tb = reply.get("traceback", "")
    cls = _KIND_MAP.get(kind)
    if cls is None:
        cls = RetryableRemoteError if reply.get("retryable") else RemoteError
    err = cls(kind, message, tb)
    for field in BACKPRESSURE_FIELDS:
        if reply.get(field) is not None:
            setattr(err, field, reply[field])
    return err
