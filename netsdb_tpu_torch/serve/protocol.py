"""Typed-frame wire protocol — the port's ``netsdb_tpu/serve/
protocol.py``, wire format v3 as it is there.

A frame is::

    !HBIQ  header = magic(u16) | codec(u8) | msg_type(u32) | body_len(u64)

followed by ``body_len`` body bytes. Control bodies are MessagePack
(codec 0, the port's own codec in ``serve/_msgpack.py``, byte-identical
to the reference's); computation DAGs, which carry Python callables, are
pickles (codec 1, functions pickled by value by ``serve/_fnpickle.py``).
A codec-2 frame carries the arrays of a MessagePack body out of band::

    !HBIQ header (body_len = the body only)
    !I    segment count
    n ×  !QI  per-segment (nbytes u64, checksum u32)
    body bytes (arrays are {"__ndseg__": idx, "d": dtype, "s": shape})
    seg0 bytes … segN bytes  (raw C-contiguous ndarray buffers)

``send_frame`` upgrades codec 0 to codec 2 when the payload holds arrays
of at least :data:`OOB_MIN_BYTES`, and sends header, table, body and
segments with one vectored ``sendmsg``; the receiver lands each segment
in its own writable buffer. :func:`segment_checksum` guards each
segment. Peers exchange :data:`PROTO_VERSION` in HELLO and refuse a
mismatch typed.

The port's HELLO and its reply also carry :data:`PY_KEY`, the
interpreter tag of ``serve/_fnpickle.py``: marshal's code format belongs
to one interpreter version, so a peer may send or receive codec 1 only
when both sides named the same tag. The reference's daemon ignores the
extra field and names none, so a port client talking to it sends codec
0 frames only; the port's daemon refuses codec 1 from a peer that named
no tag or another one.

``send_frame`` and ``recv_frame_raw`` take an optional ``chaos``
(:class:`~netsdb_tpu_torch.serve.chaos.ChaosInjector`) that may drop,
delay, corrupt or truncate the frame; without one the hook is a single
``is None`` check.

Security note: codec 1 executes code on deserialization, exactly like
the reference's ``registerType`` shipping .so binaries. The same boundary
applies to REGISTER_TYPE frames carrying module ``source``, executed
daemon-side when EXECUTE_PLAN first binds the type
(``server.resolve_entry_point``). The serve layer is a trusted-cluster
control plane, and an optional shared token (HELLO) gates connections.
"""

from __future__ import annotations

import socket
import struct
import time
from enum import IntEnum
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from netsdb_tpu_torch.serve import _fnpickle, _msgpack

MAGIC = 0x4E54  # "NT"
_HEADER = struct.Struct("!HBIQ")
MAX_FRAME_BYTES = 1 << 34  # 16 GiB sanity cap on a single frame

#: wire-format version, exchanged in the HELLO handshake. v3 added
#: out-of-band tensor segments (codec 2) and the BULK_* streamed-ingest
#: conversation; mixed-version peers are refused with a typed error.
PROTO_VERSION = 3

CODEC_MSGPACK = 0
CODEC_PICKLE = 1
#: msgpack body + out-of-band raw-buffer segments (see module docstring)
CODEC_MSGPACK_OOB = 2

#: HELLO / HELLO-reply field naming the peer's interpreter (the tag
#: ``_fnpickle`` checks); codec 1 needs both sides to name the same one
PY_KEY = "py"
PY_TAG = _fnpickle.PY_TAG

#: arrays at or above this ride out-of-band; smaller ones stay inline
#: (a segment costs a 12-byte table entry + an iovec slot — not worth it
#: for tiny arrays).
OOB_MIN_BYTES = 1 << 10
_SEG_COUNT = struct.Struct("!I")
_SEG_ENTRY = struct.Struct("!QI")  # nbytes(u64) | checksum(u32)
MAX_SEGMENTS = 4096
#: iovecs per sendmsg call — comfortably under any platform IOV_MAX
_IOV_BATCH = 64


class MsgType(IntEnum):
    """Frame type ids — the reference's handler-map TYPEIDs
    (``PDBServer::registerHandler``). Grouped like its message families
    (Cat*, Storage*, DistributedStorage*, ExecuteComputation, ...)."""

    # session
    HELLO = 1
    OK = 2
    ERR = 3
    PING = 4
    SHUTDOWN = 5
    # streamed replies (ref: FrontendQueryTestServer paging results back
    # page-by-page, FrontendQueryTestServer.cc:785-890): a streaming
    # request is answered by N STREAM_ITEM frames then one STREAM_END;
    # an ERR frame aborts the stream
    STREAM_ITEM = 6
    STREAM_END = 7
    # catalog / DDL (ref Cat* + DistributedStorageAddSet family)
    CREATE_DATABASE = 10
    CREATE_SET = 11
    REMOVE_SET = 12
    CLEAR_SET = 13
    SET_EXISTS = 14
    LIST_SETS = 15
    REGISTER_TYPE = 16
    # data path (ref DispatcherAddData / StorageAddData / SetScan)
    SEND_DATA = 20
    SEND_MATRIX = 21
    GET_TENSOR = 22
    SCAN_SET = 23
    ADD_SHARED_MAPPING = 24
    FLUSH_DATA = 25
    LOAD_SET = 26
    # streamed data path: bounded-memory scan / chunked tensor pull
    SCAN_SET_STREAM = 27
    GET_TENSOR_CHUNKED = 28
    # serve-time model dedup: pool shared blocks across resident models
    DEDUP_RESIDENT = 29
    # query execution (ref ExecuteComputation)
    EXECUTE_COMPUTATIONS = 30
    EXECUTE_PLAN = 31
    LIST_JOBS = 32
    # stats (ref StorageCollectStats)
    COLLECT_STATS = 40
    # planner statistics computed where the data lives: per-column
    # summaries + dictionaries of one stored relation, so DAG builders
    # (suite_sink_for) never pull tables from a daemon (ref
    # StorageCollectStats → Statistics, PangeaStorageServer.h:48)
    ANALYZE_SET = 41
    # query-scoped observability: the last N completed query trace
    # profiles from the daemon's ring buffer (obs/trace.TraceRing);
    # the leader merges follower sections by query id
    GET_TRACE = 44
    # the CLIENT ships its side of a traced query (send/wait/hedge
    # spans) to the daemon after the reply lands; the daemon merges it
    # into the qid's ringed profile, so GET_TRACE returns ONE
    # end-to-end client->leader->follower decomposition. Best-effort:
    # a lost PUT_TRACE costs a client section, never the query.
    PUT_TRACE = 45
    # SLO/health readout (obs/slo.py): evaluated objectives with
    # multi-window burn rates + breach events + slowlog summary;
    # the leader merges follower sections like COLLECT_STATS
    HEALTH = 46
    # continuous telemetry export (obs/history.py + obs/export.py):
    # format=openmetrics returns the Prometheus text exposition of the
    # central registry (stable catalogued names, client/set labels
    # from the attribution ledger, leader-merged follower samples);
    # the default structured form carries the registry snapshot plus
    # the history ring's derived rates (QPS, staged MB/s, hit-rate
    # trends) that `cli obs --top` refreshes from
    GET_METRICS = 47
    # multi-host reads: a master assembling a mesh-spanning array asks
    # each follower for ITS addressable shards (index ranges + bytes) —
    # the reference streaming each node's local pages to the frontend
    # (FrontendQueryTestServer.cc:785-890); reads never enter the SPMD
    # program, so no collective/ordering hazards
    LOCAL_SHARDS = 42
    # streamed compute over a paged TENSOR set: stored @ rhs with the
    # stored matrix paged through the device (larger-than-HBM weights
    # behind the daemon; ref pipelines over pinned weight pages)
    PAGED_MATMUL = 43
    # fault tolerance: a leader tells an evicted follower to rebuild
    # its store from a checkpoint snapshot (storage/checkpoint.py
    # save_store/load_store) before being readmitted to the mirror set
    RESYNC_FOLLOWER = 50
    # windowed bulk ingest (the dispatcher-striped ingest role): BEGIN
    # opens a streamed conversation for one mutating op (SEND_DATA /
    # RESYNC_FOLLOWER), CHUNK frames carry bounded slices of the
    # payload back-to-back under a depth-W ack window (not
    # stop-and-wait), COMMIT assembles + applies under the target op's
    # ordering locks. The server decodes chunks OUTSIDE the per-set
    # lock and applies under it.
    BULK_BEGIN = 60
    BULK_CHUNK = 61
    BULK_COMMIT = 62
    # --- horizontal scale-out (sharded worker pool) -------------------
    # the leader's versioned placement map: which daemon owns which
    # shard slot of each hash/range-partitioned set. Shipped in the v3
    # handshake when the pool holds sharded sets, re-fetched by clients
    # on a PlacementStale rejection (the stale-map retry loop).
    PLACEMENT = 70
    # coordinator → shard: execute one pushed subplan (Scan→Filter/
    # Apply→Aggregate region, a partial fold, or one leg of a
    # distributed shuffle join) over the shard's LOCAL pages and reply
    # with the bounded partial the coordinator merges — the reference's
    # master scheduling JobStages onto workers over their local
    # partitions (QuerySchedulerServer.cc:216-330).
    SUBPLAN = 71
    # shard → shard: one hash bucket of a distributed shuffle (the
    # grace-hash partition step run across daemons). Column buffers
    # ride as out-of-band segments — no tobytes copies on the shuffle
    # path, same zero-copy framing as BULK table chunks.
    SHUFFLE_PUT = 72
    # leader → readmitted shard: re-register the shard's placement
    # epochs ahead of the handoff drain (the shard-scoped resync — a
    # readmitted shard receives only its OWN buffered pages, never a
    # whole-store snapshot like RESYNC_FOLLOWER)
    SHARD_RESYNC = 73
    # --- multi-host HA (leader election + failover) -------------------
    # leader → follower: the authoritative HA record — current term,
    # leader address and the placement map's wire form, shipped on
    # every placement-epoch bump (and at resync/promotion) so a
    # freshly promoted follower serves routed ingest from its
    # REPLICATED map immediately instead of starting empty.
    HA_STATE = 74
    # leader → follower: alias one idempotency token to another's
    # cached reply. The coalesce path executes ONE leader token but
    # finishes every waiter's token locally; this frame ships the
    # waiter→leader mapping across the mirror hop, so a waiter client
    # retrying a coalesced EXECUTE against the PROMOTED follower still
    # dedupes instead of re-executing.
    TOKEN_ALIAS = 75
    # live shard rebalancing (serve/rebalance.py): one frame, an "op"
    # field dispatches the sub-protocol. Worker-side ops run one leg of
    # a slot move (prepare the destination's local set, seal the source
    # registration behind a TTL, count rows, drop the source copy — the
    # bulk copy itself rides plain SEND_DATA frames with the epoch keys,
    # the drain_handoff idiom); leader-side ops are the admin plane
    # (status, plan, run a bounded round, register a new pool member).
    # Epoch-bumped all-or-nothing per move: the source keeps serving
    # until the destination acks and the new epoch commits.
    RESHARD = 76
    # --- stateful interactive serving (serve/sessions.py) -------------
    # open one decode session against a deployed model: the leader
    # assigns an OWNER daemon (sticky for every later GENERATE), seeds
    # the session's recurrent/KV state, and records the session in the
    # replicated session table. One frame, an "op" field dispatches the
    # sub-protocol (open / lookup / adopt / spill) — the RESHARD idiom:
    # lookup is the client's re-route probe after SessionMoved, adopt
    # installs a packed state at a new owner on relocation, spill is a
    # worker pushing an evicted session's state to the leader's arena
    # so owner death never loses it.
    SESSION_OPEN = 77
    # one decode step (or a short run of steps) against an open
    # session's resident state. Routed STICKY to the owning daemon;
    # concurrent GENERATEs for the same model coalesce into one padded
    # batched step program on the owner. Mutating (the state advances),
    # so idempotency tokens fence retries — a replayed step returns the
    # cached reply instead of advancing the state twice.
    GENERATE = 78
    # close one session: drop its devcache/arena state everywhere and
    # remove it from the replicated table. Idempotent by construction.
    SESSION_CLOSE = 79


#: payload key carrying the client-generated idempotency token on
#: mutating frames. The server caches the completed reply per token, so
#: a retry after an ambiguous failure (reply lost mid-wire) returns the
#: first execution's result instead of double-applying the mutation.
IDEMPOTENCY_KEY = "__idem__"

#: payload key carrying the client-minted query id (obs/trace.py) on
#: traced frames. The server pops it before dispatch, opens a
#: query-scoped trace under it, and re-attaches it to mirrored
#: forwards — so one logical query's spans join up across the client,
#: the leader and every follower (queryable via GET_TRACE).
QUERY_ID_KEY = "__qid__"

#: payload key carrying the client identity (an operator-chosen string,
#: e.g. a tenant or service name) on every frame a RemoteClient built
#: with ``client_id=...`` sends. The server pops it before dispatch and
#: installs it for the handler's dynamic extent
#: (``obs/attrib.client_context``), so staged bytes, device-cache
#: traffic and executor chunk counts aggregate per (client, db:set) —
#: the accounting the multi-tenant scheduler admits against. Mirrored
#: forwards re-attach it so followers attribute the same way.
CLIENT_ID_KEY = "__client__"

#: OPTIONAL payload key carrying a scheduler lane hint (a priority
#: class name, e.g. "interactive"/"batch"). The server pops it before
#: dispatch and admits the frame's job through that lane of the query
#: scheduler (``serve/sched/``); absent, the lane defaults to the
#: frame's client identity — per-client lanes with no client change.
#: Lane WEIGHTS are server configuration (``config.sched_lanes``): a
#: client can only name a lane, never grant itself priority the
#: operator didn't configure.
LANE_KEY = "__lane__"

#: payload key carrying the placement-map epoch on frames ROUTED to a
#: shard slot of a partitioned set (ingest the client aimed at an
#: owning daemon, coordinator→shard subplans). The receiving daemon
#: validates it against the epoch it was registered under; a mismatch
#: is the typed retryable ``PlacementStale`` — the client/coordinator
#: refreshes the map and re-routes instead of applying against a
#: membership the leader already revised (the partial/doubled-merge
#: hazard the epoch exists to close).
PLACEMENT_EPOCH_KEY = "__pepoch__"

#: payload key carrying the sender's HA TERM on every leader-
#: originated frame (mirrored forwards, handoff drains, resync) in an
#: HA-armed topology. The receiver validates it against the term it
#: knows: a HIGHER term is adopted (a new leader was elected), a STALE
#: term is the deposed-leader straggler — rejected with the typed
#: retryable ``NotLeader`` naming both terms, never applied. Routed
#: frames carry this alongside ``PLACEMENT_EPOCH_KEY`` — the
#: ``(term, epoch)`` fencing pair. Absent in non-HA topologies, so
#: every existing frame stays byte-identical.
HA_TERM_KEY = "__term__"

#: payload key (the port's own) of a mirrored frame's position in the
#: leader's mutation log: ``[log id, END offset]``. A follower that keeps
#: its own applied log (``ha_mutlog``) records it, reports the last one
#: in its HELLO reply (``mirror_applied``), and so resumes by log replay
#: from what it holds even across a restart on its root.
MUTLOG_POS_KEY = "__mpos__"

#: payload key carrying the target shard SLOT index on routed ingest.
#: A slot in handoff state routes to the LEADER with this key intact:
#: the leader buffers the batch for the degraded shard and drains it
#: on readmit (the shard-scoped resync).
SHARD_SLOT_KEY = "__slot__"

#: payload key carrying the session id on session-scoped frames
#: (GENERATE / SESSION_CLOSE). The server pops it before dispatch and
#: admits the frame through the reserved decode lane of the query
#: scheduler — the session lane shape: one lane for every interactive
#: decode step, sticky to the owner daemon, so batch coalescing sees
#: all concurrent sessions of a model in one place and one-shot
#: analytics never starve behind a decode loop (or vice versa).
SESSION_KEY = "__session__"

#: frame types that mutate daemon state or launch jobs — the set the
#: client attaches idempotency tokens to before retrying. Reads are
#: naturally idempotent and retried bare. (BULK_BEGIN carries its
#: logical op's token explicitly — the whole conversation is one
#: logical mutation.)
MUTATING_TYPES = frozenset({
    MsgType.CREATE_DATABASE, MsgType.CREATE_SET, MsgType.REMOVE_SET,
    MsgType.CLEAR_SET, MsgType.REGISTER_TYPE, MsgType.SEND_DATA,
    MsgType.SEND_MATRIX, MsgType.ADD_SHARED_MAPPING, MsgType.FLUSH_DATA,
    MsgType.LOAD_SET, MsgType.EXECUTE_COMPUTATIONS, MsgType.EXECUTE_PLAN,
    MsgType.DEDUP_RESIDENT, MsgType.RESYNC_FOLLOWER, MsgType.BULK_BEGIN,
    MsgType.SESSION_OPEN, MsgType.GENERATE, MsgType.SESSION_CLOSE,
})


class ProtocolError(ConnectionError):
    pass


_MASK64 = 0xFFFFFFFFFFFFFFFF


def _mix64(v: int) -> int:
    """splitmix64 finalizer — full avalanche, so a single-bit change in
    the input flips ~half the output bits (plain sum^xor folds let
    top-bit flips cancel between the two reductions)."""
    v &= _MASK64
    v ^= v >> 33
    v = (v * 0xFF51AFD7ED558CCD) & _MASK64
    v ^= v >> 29
    v = (v * 0xC4CEB9FE1A85EC53) & _MASK64
    v ^= v >> 32
    return v


def segment_checksum(mv) -> int:
    """32-bit integrity checksum of an out-of-band segment, computed at
    memory speed: numpy u64 sum + xor reductions over the buffer (full
    coverage — every byte participates in both), each avalanched
    through splitmix64 before folding. ~2.5× faster than zlib.adler32
    on commodity hosts, which matters because the checksum is the only
    full pass the zero-copy path makes over the tensor bytes. Verified
    against 3k-trial single-bit-flip fuzzing (0 misses)."""
    n = mv.nbytes if isinstance(mv, memoryview) else len(mv)
    mv = memoryview(mv)
    main = n - (n & 7)
    s = x = 0
    if main:
        a = np.frombuffer(mv[:main], np.uint64)
        s = int(np.add.reduce(a, dtype=np.uint64))
        x = int(np.bitwise_xor.reduce(a))
    if n & 7:
        tail = int.from_bytes(mv[main:], "little")
        s = (s + tail) & _MASK64
        x ^= tail
    # asymmetric combine: s passes through TWO mixes, x one — a
    # symmetric mix(s)^mix(x^n) collides whenever the (s, x^n) pair
    # swaps (e.g. the low-bit flip of a 1-byte segment)
    acc = _mix64(_mix64(s) ^ x ^ n)
    return (acc ^ (acc >> 32)) & 0xFFFFFFFF


class _OOBPacker:
    """msgpack ``default`` hook that diverts big ndarrays out-of-band.

    Arrays ≥ :data:`OOB_MIN_BYTES` become ``{"__ndseg__": idx, ...}``
    descriptors; their buffers are collected as ``memoryview``s in
    :attr:`segments` (NO byte copy — ``ascontiguousarray`` is a no-op
    on already-contiguous input, the overwhelmingly common case).
    Smaller arrays inline as before (one small copy)."""

    __slots__ = ("segments",)

    def __init__(self):
        self.segments: List[memoryview] = []

    def __call__(self, obj: Any):
        if isinstance(obj, np.ndarray):
            a = np.ascontiguousarray(obj)
            if a.nbytes >= OOB_MIN_BYTES and not a.dtype.hasobject \
                    and len(self.segments) < MAX_SEGMENTS:
                self.segments.append(memoryview(a).cast("B"))
                return {"__ndseg__": len(self.segments) - 1,
                        "d": a.dtype.str, "s": list(a.shape)}
            return {"__nd__": True, "d": a.dtype.str, "s": list(a.shape),
                    "b": bytes(a.data)}
        if isinstance(obj, (np.integer,)):
            return int(obj)
        if isinstance(obj, (np.floating,)):
            return float(obj)
        raise TypeError(f"cannot serialize {type(obj)!r} over the wire; "
                        f"wrap host objects in a pickled job instead")


def _pack_default(obj: Any):
    """msgpack hook for the inline-only (codec 0) encoder."""
    if isinstance(obj, np.ndarray):
        a = np.ascontiguousarray(obj)
        return {"__nd__": True, "d": a.dtype.str, "s": list(a.shape),
                "b": bytes(a.data)}
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    raise TypeError(f"cannot serialize {type(obj)!r} over the wire; "
                    f"wrap host objects in a pickled job instead")


def _inline_array(obj: dict) -> np.ndarray:
    """Inline ``__nd__`` dict → WRITABLE ndarray. ``bytearray(...)``
    copies the (small — big arrays ride out-of-band) buffer so the
    result owns writable memory; ``np.frombuffer`` over msgpack's
    ``bytes`` would be read-only."""
    buf = bytearray(obj["b"])
    return np.frombuffer(buf, dtype=np.dtype(obj["d"])).reshape(obj["s"])


def _unpack_hook(obj):
    if isinstance(obj, dict) and obj.get("__nd__"):
        return _inline_array(obj)
    return obj


def _make_oob_hook(segments: Sequence[Any]):
    """Unpack hook resolving ``__ndseg__`` descriptors to zero-copy,
    WRITABLE arrays over the received segment buffers (bytearrays —
    ``np.frombuffer`` inherits their writability)."""

    def hook(obj):
        if isinstance(obj, dict):
            if "__ndseg__" in obj:
                idx = obj["__ndseg__"]
                return np.frombuffer(
                    segments[idx], dtype=np.dtype(obj["d"])
                ).reshape(obj["s"])
            if obj.get("__nd__"):
                return _inline_array(obj)
        return obj

    return hook


def encode_body(payload: Any, codec: int = CODEC_MSGPACK) -> bytes:
    if codec == CODEC_MSGPACK:
        return _msgpack.packb(payload, default=_pack_default)
    if codec == CODEC_PICKLE:
        return _fnpickle.dumps(payload)
    raise ProtocolError(f"unknown codec {codec}")


def encode_body_oob(payload: Any) -> Tuple[bytes, List[memoryview]]:
    """msgpack body + out-of-band segment list (codec 2 when the list
    is non-empty, codec 0 otherwise). The segments are ``memoryview``s
    over the payload's own array buffers — zero copies."""
    packer = _OOBPacker()
    body = _msgpack.packb(payload, default=packer)
    return body, packer.segments


def decode_body(body: Any, codec: int, allow_pickle: bool,
                segments: Optional[Sequence[Tuple[Any, int]]] = None) -> Any:
    """``segments``: the (buffer, checksum) pairs read after a codec-2
    body. Checksums are verified HERE (not in the transport read) so a
    flipped segment byte surfaces as a decode failure — the typed
    retryable CorruptFrame path — with the connection still
    frame-synchronized, never a torn read."""
    if codec == CODEC_MSGPACK_OOB:
        bufs = []
        for i, (buf, crc) in enumerate(segments or ()):
            if segment_checksum(buf) != crc:
                raise ValueError(
                    f"out-of-band segment {i} checksum mismatch "
                    f"(bit flip on the wire)")
            bufs.append(buf)
        return _msgpack.unpackb(body, object_hook=_make_oob_hook(bufs))
    if codec == CODEC_MSGPACK:
        return _msgpack.unpackb(body, object_hook=_unpack_hook)
    if codec == CODEC_PICKLE:
        if not allow_pickle:
            raise ProtocolError(
                "pickled frame refused: this endpoint has allow_pickle "
                "off (enable it only on trusted-cluster control planes)")
        return _fnpickle.loads(body)
    raise ProtocolError(f"unknown codec {codec}")


def _pack_segtable(segments: Sequence[memoryview]) -> bytes:
    out = bytearray(_SEG_COUNT.size + len(segments) * _SEG_ENTRY.size)
    _SEG_COUNT.pack_into(out, 0, len(segments))
    off = _SEG_COUNT.size
    for mv in segments:
        _SEG_ENTRY.pack_into(out, off, mv.nbytes, segment_checksum(mv))
        off += _SEG_ENTRY.size
    return bytes(out)


def _sendmsg_all(sock: socket.socket, parts: Sequence[Any]) -> None:
    """ONE vectored send for header + segment table + body + segments
    (scatter-gather: the kernel walks the iovecs, no host-side
    concatenation, and header + small bodies never split across TCP
    segments under TCP_NODELAY). Handles partial sends and batches
    iovecs below IOV_MAX; falls back to sendall where sendmsg is
    unavailable."""
    views = []
    for p in parts:
        v = p if isinstance(p, memoryview) else memoryview(p)
        v = v.cast("B") if v.format != "B" or v.ndim != 1 else v
        if v.nbytes:
            views.append(v)
    if not views:
        return
    if not hasattr(sock, "sendmsg"):
        for v in views:
            sock.sendall(v)
        return
    while views:
        sent = sock.sendmsg(views[:_IOV_BATCH])
        while sent:
            head = views[0]
            if sent >= head.nbytes:
                sent -= head.nbytes
                views.pop(0)
            else:
                views[0] = head[sent:]
                sent = 0


def send_frame(sock: socket.socket, msg_type: int, payload: Any,
               codec: int = CODEC_MSGPACK, chaos=None) -> None:
    """Send one frame. ``chaos``: an optional
    :class:`~netsdb_tpu_torch.serve.chaos.ChaosInjector` that may drop,
    delay, corrupt or truncate it (tests only).

    The msgpack codec auto-upgrades to codec 2 (out-of-band segments)
    when the payload holds arrays ≥ :data:`OOB_MIN_BYTES`; everything
    goes out as one vectored ``sendmsg`` either way."""
    segments: List[memoryview] = []
    if codec in (CODEC_MSGPACK, CODEC_MSGPACK_OOB):
        # a caller echoing a RECEIVED frame's wire codec may pass
        # codec 2 — the payload is a decoded dict again, so re-encode
        # through the OOB path (the mirror-forward case: a big-tensor
        # frame arrives as codec 2 and must forward losslessly)
        body, segments = encode_body_oob(payload)
        wire_codec = CODEC_MSGPACK_OOB if segments else CODEC_MSGPACK
    else:
        body = encode_body(payload, codec)
        wire_codec = codec
    header = _HEADER.pack(MAGIC, wire_codec, int(msg_type), len(body))
    segtable = _pack_segtable(segments) if segments else b""
    if chaos is not None:
        header, segtable, body, segments = chaos.on_send(
            sock, int(msg_type), header, body,
            segtable=segtable, segments=segments)
    _sendmsg_all(sock, [header, segtable, body, *segments])


def _recv_exact(sock: socket.socket, n: int,
                mid_timeout: Optional[float] = None,
                started: bool = False) -> memoryview:
    """Read exactly ``n`` bytes. ``mid_timeout`` is a CUMULATIVE
    deadline on finishing the read once it has started (``started=True``
    means the frame is already mid-flight, so the clock runs from byte
    0): an idle connection may block indefinitely awaiting the next
    frame, but once bytes flow the remainder must land within the
    budget — a peer trickling one byte per near-timeout gap cannot hold
    the thread past the deadline. Expiry raises
    :class:`ProtocolError`, never a bare socket.timeout."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    old_timeout: Any = False  # sentinel: False = not overridden
    deadline = None
    try:
        if started and mid_timeout is not None:
            old_timeout = sock.gettimeout()
            deadline = time.monotonic() + mid_timeout
        while got < n:
            if deadline is not None:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise ProtocolError(
                        f"peer stalled mid-frame ({n - got} of {n} bytes "
                        f"still missing after {mid_timeout}s)")
                sock.settimeout(left)
            try:
                r = sock.recv_into(view[got:], n - got)
            except socket.timeout:
                if old_timeout is False:
                    raise  # the caller's own socket timeout, not ours
                raise ProtocolError(
                    f"peer stalled mid-frame (> {mid_timeout}s)")
            if r == 0:
                raise ProtocolError("peer closed mid-frame")
            got += r
            if got < n and mid_timeout is not None and old_timeout is False:
                # first bytes landed — the frame has started; bound the
                # remainder with one shared deadline
                old_timeout = sock.gettimeout()
                deadline = time.monotonic() + mid_timeout
    finally:
        if old_timeout is not False:
            sock.settimeout(old_timeout)
    return memoryview(buf)


def recv_frame_raw(sock: socket.socket, chaos=None,
                   mid_frame_timeout: Optional[float] = None,
                   ) -> Tuple[MsgType, int, bytes, List[Tuple[Any, int]]]:
    """Receive one frame without decoding — servers decode separately so
    a refused codec becomes an ERR reply, not a dropped connection.
    Returns ``(type, codec, body, segments)``; ``segments`` is the
    codec-2 out-of-band list of (writable buffer, expected checksum)
    pairs, empty for other codecs — each segment lands in its own
    buffer via ``recv_into`` (no reassembly copy) and checksum
    verification is deferred to :func:`decode_body`.

    ``mid_frame_timeout`` is the deadline-discipline knob: waiting for
    a frame to START may block (idle persistent connection), but once
    the first header byte lands the rest of header + body + segments
    must arrive within the timeout or the read fails typed (server
    worker threads pass this so a hung peer can never wedge a handler
    thread). ``chaos`` may fault the read before it starts."""
    if chaos is not None:
        chaos.on_recv(sock)
    header = _recv_exact(sock, _HEADER.size, mid_timeout=mid_frame_timeout)
    magic, codec, msg_type, body_len = _HEADER.unpack(header)
    if magic != MAGIC:
        raise ProtocolError(f"bad frame magic {magic:#x}")
    if body_len > MAX_FRAME_BYTES:
        raise ProtocolError(f"frame of {body_len} bytes exceeds cap")
    # ONE budget for everything after the header: each follow-up read
    # gets only the REMAINING time, so a codec-2 frame with thousands
    # of segments cannot stretch the deadline to nsegs × timeout (a
    # peer dribbling one segment per near-timeout gap would otherwise
    # hold a handler thread for hours)
    deadline = (time.monotonic() + mid_frame_timeout
                if mid_frame_timeout is not None else None)

    def budget() -> Optional[float]:
        if deadline is None:
            return None
        rem = deadline - time.monotonic()
        if rem <= 0:
            raise ProtocolError(
                f"peer stalled mid-frame (frame budget of "
                f"{mid_frame_timeout}s spent)")
        return rem

    seg_meta: List[Tuple[int, int]] = []
    if codec == CODEC_MSGPACK_OOB:
        cnt = _recv_exact(sock, _SEG_COUNT.size,
                          mid_timeout=budget(), started=True)
        (nsegs,) = _SEG_COUNT.unpack(cnt)
        if nsegs > MAX_SEGMENTS:
            raise ProtocolError(f"frame carries {nsegs} segments "
                                f"(cap {MAX_SEGMENTS})")
        table = _recv_exact(sock, nsegs * _SEG_ENTRY.size,
                            mid_timeout=budget(), started=True)
        seg_meta = [_SEG_ENTRY.unpack_from(table, i * _SEG_ENTRY.size)
                    for i in range(nsegs)]
        total = body_len + sum(n for n, _ in seg_meta)
        if total > MAX_FRAME_BYTES:
            raise ProtocolError(f"frame of {total} bytes exceeds cap")
    body = _recv_exact(sock, body_len, mid_timeout=budget(),
                       started=True)
    segments = [(_recv_exact(sock, n, mid_timeout=budget(),
                             started=True), crc)
                for n, crc in seg_meta]
    try:
        typ = MsgType(msg_type)
    except ValueError:
        # unknown type ids stay raw ints: the server answers them with a
        # "no handler" ERR instead of dropping the connection
        typ = msg_type
    return typ, codec, bytes(body), segments


def recv_frame(sock: socket.socket, allow_pickle: bool = False,
               chaos=None, mid_frame_timeout: Optional[float] = None,
               ) -> Tuple[MsgType, Any]:
    msg_type, codec, body, segments = recv_frame_raw(
        sock, chaos=chaos, mid_frame_timeout=mid_frame_timeout)
    return msg_type, decode_body(body, codec, allow_pickle,
                                 segments=segments)


# --- tensor wire form -------------------------------------------------

def tensor_to_wire(dense: np.ndarray, block_shape=None) -> dict:
    """Dense tensor → wire dict. The device-side blocking/placement is
    the server's job; the wire carries the raw dense buffer once (as an
    out-of-band segment — never ``tobytes()``-copied)."""
    return {"data": np.ascontiguousarray(dense),
            "block_shape": list(block_shape) if block_shape else None}


def tensor_from_wire(obj: dict) -> Tuple[np.ndarray, Any]:
    """Wire dict → (dense, block_shape). The array arrives WRITABLE:
    out-of-band segments decode over their own received buffers, inline
    arrays are copied into owned memory (see ``_inline_array``)."""
    data = obj["data"]
    bs = obj.get("block_shape")
    return data, (tuple(bs) if bs else None)
