"""Scatter-gather execution for the sharded worker pool — the port's
``netsdb_tpu/serve/shard.py``.

The coordinator half (:class:`ShardPool`, owned by the leader) maps a
query's :class:`~netsdb_tpu_torch.plan.scatter.ScatterSpec` onto the pool:
one SUBPLAN per shard slot (the leader runs its own slot in-process — it
is slot 0 of every set it placed), partials collected under one shared
deadline, merged in slot order, and the merged result written into the
coordinator's store the way a local execution writes it, so reads of the
output set need nothing new.

The shard half (:func:`execute_subplan`) runs a shipped subplan through
the daemon's own executor over its local pages: staging, the device
cache, compiled programs and fusion regions all apply per shard, and
only the bounded partial goes back — as host values (a device-to-host
copy per shard on the card).

The distributed shuffle (``shuffle_join``) runs shard to shard: every
slot hash-partitions both local join sides by the key's splitmix64 mix
(on the host, so a key's slot equals ``placement.mix64_array``'s
whatever the device) and ships bucket *j* to slot *j* as a SHUFFLE_PUT
whose columns ride out of band; each slot folds its own bucket and the
coordinator merges the outputs with the fold's ``merge``.

Failure discipline: partials merge all or nothing. A slot that fails
(connection loss, epoch mismatch, deadline) discards every partial,
evicts an unreachable shard from the placement (an epoch bump) and
surfaces the typed retryable ``ShardUnavailable``/``PlacementStale`` —
never a partial or doubled merge.

The handoff buffer for degraded slots lives in memory; with
``ha_mutlog`` it also spills to a mutation log, and a restarted leader
rebuilds it (:meth:`ShardPool.load_spill`). A degraded member's
record of the decode-model weights shipped to it is dropped
(:meth:`ShardPool.degrade`): a restarted worker no longer holds them.
"""

from __future__ import annotations

import itertools
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from netsdb_tpu_torch import obs
from netsdb_tpu_torch.serve import placement as _placement
from netsdb_tpu_torch.serve.errors import PlacementStale, ShardUnavailable
from netsdb_tpu_torch.serve.protocol import (
    CLIENT_ID_KEY,
    CODEC_MSGPACK,
    CODEC_PICKLE,
    HA_TERM_KEY,
    IDEMPOTENCY_KEY,
    PLACEMENT_EPOCH_KEY,
    QUERY_ID_KEY,
    SHARD_SLOT_KEY,
    MsgType,
)
from netsdb_tpu_torch.utils.locks import TrackedLock
from netsdb_tpu_torch.utils.timing import deadline_after, seconds_left

_shuffle_ids = itertools.count(1)


def _host_tree(value: Any) -> Any:
    """A fold state or output with every tensor on the host (what rides
    the wire); a placed tensor as its logical tensor."""
    from netsdb_tpu_torch.core.blocked import BlockedTensor
    from netsdb_tpu_torch.parallel.mesh import ShardedTensor
    from netsdb_tpu_torch.relational.table import ColumnTable

    if isinstance(value, ShardedTensor):
        return value.to_dense().detach().cpu()
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    if isinstance(value, BlockedTensor):
        return BlockedTensor(_host_tree(value.data), value.meta)
    if isinstance(value, ColumnTable):
        return value.to("cpu")
    if isinstance(value, tuple) and not hasattr(value, "_fields"):
        return tuple(_host_tree(v) for v in value)
    if isinstance(value, list):
        return [_host_tree(v) for v in value]
    if isinstance(value, dict):
        return {k: _host_tree(v) for k, v in value.items()}
    return value


def _on_device(value: Any, device) -> Any:
    """The inverse of :func:`_host_tree`: every tensor on ``device``."""
    from netsdb_tpu_torch.core.blocked import BlockedTensor
    from netsdb_tpu_torch.relational.table import ColumnTable

    if isinstance(value, torch.Tensor):
        return value.to(device)
    if isinstance(value, BlockedTensor):
        return BlockedTensor(value.data.to(device), value.meta)
    if isinstance(value, ColumnTable):
        return value.to(device)
    if isinstance(value, tuple) and not hasattr(value, "_fields"):
        return tuple(_on_device(v, device) for v in value)
    if isinstance(value, list):
        return [_on_device(v, device) for v in value]
    return value


def local_table(ctl, db: str, set_name: str):
    """This daemon's partition of a table set as ONE host ``ColumnTable``
    (a paged relation assembles off the arena, a resident one compacts
    its validity); None when the set holds no table (an empty shard)."""
    from netsdb_tpu_torch.relational.outofcore import PagedColumns
    from netsdb_tpu_torch.relational.table import ColumnTable
    from netsdb_tpu_torch.storage.store import SetIdentifier

    for item in ctl.library.store.get_items(SetIdentifier(db, set_name)):
        if isinstance(item, PagedColumns):
            return item.to_host_table()
        if isinstance(item, ColumnTable):
            return item.compact().to("cpu")
    return None


def local_schema(ctl, db: str, set_name: str) -> Tuple[Dict, int]:
    """(dicts, num_rows) of this daemon's partition — what a scatterable
    fold's coordinator-side finalize may read."""
    from netsdb_tpu_torch.relational.outofcore import PagedColumns
    from netsdb_tpu_torch.relational.table import ColumnTable
    from netsdb_tpu_torch.storage.store import SetIdentifier

    for item in ctl.library.store.get_items(SetIdentifier(db, set_name)):
        if isinstance(item, (PagedColumns, ColumnTable)):
            return dict(item.dicts), int(item.num_rows)
    return {}, 0


class ShuffleInbox:
    """Bounded store of inbound shuffle buckets keyed by (shuffle id,
    side, sender slot). A sender's retry overwrites its own key, so a
    bucket never counts twice; entries no leg claims are pruned by TTL on
    later puts."""

    def __init__(self, max_bytes: int = 1 << 30, ttl_s: float = 600.0):
        self._mu = TrackedLock("serve.ShuffleInbox._mu")
        self._cv = threading.Condition(self._mu)
        self._entries: Dict[str, Dict[str, Any]] = {}
        self._bytes = 0
        self._max_bytes = int(max_bytes)
        self._ttl_s = float(ttl_s)

    @staticmethod
    def _size(cols: Optional[Dict[str, np.ndarray]]) -> int:
        return sum(np.asarray(v).nbytes for v in (cols or {}).values())

    def put(self, sid: str, side: str, slot: int,
            cols: Optional[Dict[str, np.ndarray]],
            dicts: Optional[Dict] = None) -> None:
        nbytes = self._size(cols)
        with self._cv:
            self._prune_locked()
            entry = self._entries.setdefault(
                sid, {"sides": {}, "bytes": 0, "t": time.monotonic()})
            old = entry["sides"].get(side, {}).get(slot)
            # the cap judges the net change: a retried put replaces its
            # own bytes
            old_bytes = self._size(old[0]) if old is not None else 0
            if self._bytes - old_bytes + nbytes > self._max_bytes:
                raise ShardUnavailable(
                    f"shuffle inbox over its {self._max_bytes}-byte "
                    f"bound; retry shortly")
            if old is not None:
                entry["bytes"] -= old_bytes
                self._bytes -= old_bytes
            entry["sides"].setdefault(side, {})[slot] = (cols, dicts)
            entry["bytes"] += nbytes
            self._bytes += nbytes
            self._cv.notify_all()

    def wait(self, sid: str, sides: Dict[str, int],
             timeout_s: float) -> Dict[str, Dict[int, Tuple]]:
        """Block until ``sid`` holds ``sides[side]`` buckets per side (or
        raise typed retryable after ``timeout_s``), then pop the entry."""
        if not sides or all(n <= 0 for n in sides.values()):
            return {}

        def complete(entry) -> bool:
            return entry is not None and all(
                len(entry["sides"].get(side, {})) >= n
                for side, n in sides.items())

        deadline = deadline_after(timeout_s)
        with self._cv:
            while True:
                entry = self._entries.get(sid)
                if complete(entry):
                    self._entries.pop(sid)
                    self._bytes -= entry["bytes"]
                    return entry["sides"]
                left = seconds_left(deadline)
                if left <= 0 or not self._cv.wait(left):
                    # the last bucket may have landed as the wait ended
                    if complete(self._entries.get(sid)):
                        continue
                    got = {s: len((entry or {}).get("sides", {})
                                  .get(s, {})) for s in sides}
                    raise ShardUnavailable(
                        f"distributed shuffle {sid} incomplete after "
                        f"{timeout_s}s (received {got}, expected "
                        f"{sides}) — a peer shard is unreachable")

    def _prune_locked(self) -> None:
        cutoff = time.monotonic() - self._ttl_s
        for sid in [s for s, e in self._entries.items() if e["t"] < cutoff]:
            self._bytes -= self._entries[sid]["bytes"]
            self._entries.pop(sid)


# --- shard-side subplan execution ----------------------------------------

def check_epochs(ctl, epochs: Dict[str, int]) -> None:
    """Hold a routed frame's placement epochs against this daemon's
    registrations (a worker's shard sets, a leader's own map). A mismatch
    refuses the frame whole, typed retryable, before anything runs."""
    for scope, epoch in (epochs or {}).items():
        db, _, set_name = scope.partition(":")
        current = None
        reg = ctl.shard_registration(db, set_name)
        if reg is not None:
            current = reg["epoch"]
        else:
            entry = ctl.placement.entry(db, set_name)
            if entry is not None:
                current = entry["epoch"]
        if current is None or int(epoch) != int(current):
            obs.REGISTRY.counter("shard.epoch_rejects").inc()
            raise PlacementStale(
                f"placement epoch rejected for {scope}: frame rode epoch "
                f"{epoch}, daemon registered "
                f"{current if current is not None else 'none'}",
                epoch=current)


def execute_subplan(ctl, p: dict) -> dict:
    """One shard's leg of a scatter-gather execution (the coordinator runs
    its own slot through here in-process). Returns the bounded partial on
    the host, plus the leg's program delta (``compile_stats`` misses and
    traces across the run — process-global, so meaningful only on a
    quiesced daemon)."""
    from netsdb_tpu_torch.plan import executor as _executor

    obs.REGISTRY.counter("shard.subplans").inc()
    check_epochs(ctl, p.get("epochs"))
    kind = p["kind"]
    if kind == "shuffle_join":
        return _execute_shuffle_leg(ctl, p)
    explain = bool(p.get("explain"))

    def run():
        results = ctl.library.execute_computations(
            *p["sinks"], job_name=f"{p.get('job_name', 'scatter')}@shard",
            materialize=False)
        return next(iter(results.values()))

    before = _executor.compile_stats()
    tree = None
    with obs.span("server.shard.subplan", "serve"):
        if explain:
            with obs.operators.explain_capture() as cap:
                value = run()
            tree = cap.get("operators")
        else:
            value = run()
    after = _executor.compile_stats()
    out: Dict[str, Any] = {"compile": {
        "programs": after["misses"] - before["misses"],
        "traces": after["traces"] - before["traces"]}}
    if kind in ("fold_state", "multi_fold"):
        db, set_name = p["scan"]
        dicts, rows = local_schema(ctl, db, set_name)
        out.update(state=_host_tree(value), dicts=dicts, rows=rows)
    elif kind == "tensor_chain":
        # dense and unpadded (to_dense strips block padding): the
        # coordinator's concat must see the true batch extent; item lists
        # (conv2d) ship per item
        from netsdb_tpu_torch.core.blocked import BlockedTensor

        def _host(v):
            if isinstance(v, BlockedTensor):
                v = v.to_dense()
            return v.detach().cpu() if isinstance(v, torch.Tensor) \
                else v

        out["tensor"] = [_host(v) for v in value] \
            if isinstance(value, (list, tuple)) else _host(value)
    else:  # group_partial: the dict is the partial
        out["groups"] = _host_tree(value)
    if tree is not None:
        out["operators"] = tree
    return out


def _partition_cols(table, key: str, nslots: int,
                    columns: Optional[Tuple[str, ...]] = None
                    ) -> List[Optional[Dict[str, np.ndarray]]]:
    """Hash-partition a host table's rows by ``key`` into per-slot column
    dicts (splitmix64, the rule of hash placement); ``columns`` projects
    the carried columns (the fold's probe columns plus the key)."""
    if table is None:
        return [None] * nslots
    names = list(table.cols)
    if columns:
        keep = set(columns) | {key}
        names = [n for n in names if n in keep]
    cols = {n: table.cols[n].detach().cpu().numpy() for n in names}
    slot_ids = _placement.hash_slot_ids(cols[key], nslots)
    out: List[Optional[Dict[str, np.ndarray]]] = []
    for j in range(nslots):
        idx = np.nonzero(slot_ids == j)[0]
        out.append({n: v[idx] for n, v in cols.items()})
    return out


def _execute_shuffle_leg(ctl, p: dict) -> dict:
    """One slot's leg of the shuffle join: partition both local sides,
    exchange buckets with every peer slot, fold the own bucket on this
    daemon's device, return the output on the host."""
    from netsdb_tpu_torch.relational.table import ColumnTable

    fold = p["fold"]
    slot = int(p["slot"])
    addrs = list(p["addrs"])
    nslots = len(addrs)
    sid = p["sid"]
    sides = (("probe", tuple(p["probe"]), fold.probe_key,
              tuple(fold.probe_columns) if fold.probe_columns else None),
             ("build", tuple(p["build"]), fold.build_key, None))
    own: Dict[str, Tuple] = {}
    dicts_by_side: Dict[str, Dict] = {}
    with obs.span("server.shard.shuffle", "serve"):
        for side, (db, set_name), key, columns in sides:
            table = local_table(ctl, db, set_name)
            dicts_by_side[side] = dict(table.dicts) if table is not None \
                else {}
            buckets = _partition_cols(table, key, nslots, columns)
            for j in range(nslots):
                if j == slot:
                    own[side] = (buckets[j], dicts_by_side[side])
                    continue
                # the data connection: the peer's control connection
                # carries its own in-flight SUBPLAN
                ctl.shards.data_client(addrs[j])._request(
                    MsgType.SHUFFLE_PUT,
                    {"sid": sid, "side": side, "slot": slot,
                     "cols": buckets[j], "dicts": dicts_by_side[side]},
                    CODEC_MSGPACK)
        inbound = ctl._shuffle.wait(
            sid, {side: nslots - 1 for side, *_ in sides} if nslots > 1
            else {}, float(p.get("shuffle_timeout_s") or 120.0))

    tables: Dict[str, Any] = {}
    for side, _ident, _key, _cols in sides:
        parts: List[Dict[str, np.ndarray]] = []
        dicts = dict(dicts_by_side.get(side) or {})
        for j in range(nslots):
            if j == slot:
                cols = own[side][0]
            else:
                cols, peer_dicts = inbound.get(side, {}).get(j, (None, None))
                for name, vocab in (peer_dicts or {}).items():
                    if name in dicts and list(dicts[name]) != list(vocab):
                        # raw code columns concatenate soundly only under
                        # one dictionary
                        raise ValueError(
                            f"distributed shuffle: shard {j}'s dictionary "
                            f"for column {name!r} diverges from shard "
                            f"{slot}'s; re-ingest the set with aligned "
                            f"dictionaries")
                    dicts.setdefault(name, vocab)
            if cols:
                parts.append(cols)
        if not parts:
            tables[side] = None
            continue
        tables[side] = ColumnTable(
            {n: torch.from_numpy(np.concatenate(
                [np.asarray(c[n]) for c in parts])).to(ctl.device)
             for n in parts[0]}, dicts, None)
    if tables["probe"] is None or tables["build"] is None:
        # an empty bucket: nothing to fold, the merge skips it
        return {"table": None}
    t0 = time.perf_counter()
    with obs.span("server.shard.subplan", "serve"), torch.inference_mode():
        out = fold.whole(tables["probe"], tables["build"])
    reply: Dict[str, Any] = {"table": _host_tree(out)}
    if p.get("explain"):
        # the leg runs outside the executor: a one-node tree keeps the
        # per-shard EXPLAIN forest complete
        wall = time.perf_counter() - t0
        reply["operators"] = {
            "job": p.get("job_name", "scatter"), "mode": "shuffle",
            "total_wall_s": wall,
            "nodes": [{
                "id": 0, "kind": "ShuffleJoin",
                "label": f"{fold.probe_key}={fold.build_key}",
                "inputs": [], "wall_s": wall,
                "rows_in": int(tables["probe"].num_rows),
                "rows_out": int(getattr(out, "num_rows", 0) or 0),
                "counters": {}}]}
    return reply


# --- results ---------------------------------------------------------------

def materialize_result(store, ident, out) -> None:
    """Write one merged result into the coordinator's store the way the
    executor materialises a sink."""
    from netsdb_tpu_torch.core.blocked import BlockedTensor
    from netsdb_tpu_torch.relational.table import ColumnTable

    store.create_set(ident)
    if isinstance(out, BlockedTensor):
        store.put_tensor(ident, out)
    elif isinstance(out, (ColumnTable, torch.Tensor)):
        store.clear_set(ident)
        store.add_data(ident, [out])
    elif isinstance(out, dict):
        store.clear_set(ident)
        store.add_data(ident, list(out.items()))
    else:
        store.clear_set(ident)
        store.add_data(ident, list(out))


def _annotate_shard(tree: Any, addr: str) -> Any:
    """Mark every node of one shard's EXPLAIN tree (its flat ``nodes``
    list) and the tree itself with the daemon that ran it."""
    if isinstance(tree, dict):
        out = dict(tree)
        if isinstance(out.get("nodes"), list):
            out["nodes"] = [dict(n, shard=addr) if isinstance(n, dict)
                            else n for n in out["nodes"]]
        out["shard"] = addr
        return out
    if isinstance(tree, list):
        return [_annotate_shard(t, addr) for t in tree]
    return tree


class ShardPool:
    """Per-controller pool state: cached connections to shard peers, the
    leader's handoff buffers for degraded slots and the coordinator entry
    point. Workers carry one too (no workers of their own) as the
    connection cache the shuffle dials through."""

    def __init__(self, ctl, handoff_max_bytes: int = 256 << 20,
                 spill=None):
        self.ctl = ctl
        self._mu = TrackedLock("serve.ShardPool._mu")
        self._clients: Dict[str, Any] = {}
        self._degraded: Dict[str, str] = {}
        # (db, set, slot) → [(token, payload)]: ingest buffered while the
        # slot's shard is away, drained (only these) on readmit
        self._handoff: Dict[Tuple[str, str, int],
                            List[Tuple[str, dict]]] = {}
        self._handoff_bytes = 0
        self._handoff_max = int(handoff_max_bytes)
        # the buffer's disk copy (a MutationLog, ``ha_mutlog``): every
        # put, drain and purge appends a record under _mu, so a restarted
        # leader rebuilds the buffer (load_spill); None keeps it in memory
        self._spill = spill

    # --- connections --------------------------------------------------
    def _dial(self, addr: str):
        from netsdb_tpu_torch.serve.client import RemoteClient, RetryPolicy

        return RemoteClient(addr, token=self.ctl.token,
                            retry=RetryPolicy(max_attempts=1),
                            timeout=self.ctl.mirror_ack_timeout_s,
                            connect_timeout=self.ctl.handshake_timeout_s)

    def client(self, addr: str):
        """Cached pool connection, one attempt per request: a failure
        surfaces so the coordinator can evict and refuse typed."""
        with self._mu:
            c = self._clients.get(addr)
        if c is not None:
            return c
        c = self._dial(addr.partition(":")[2] if addr.startswith("data:")
                       else addr)
        with self._mu:
            other = self._clients.setdefault(addr, c)
        if other is not c:
            c.close()
        return other

    def data_client(self, addr: str):
        """A second cached connection for SHUFFLE_PUT: the control
        connection to a shard is busy with its in-flight SUBPLAN, and a
        shuffle leg pushes buckets to that shard while it runs."""
        return self.client(f"data:{addr}")

    def fresh_client(self, addr: str):
        """An uncached connection for one in-flight subplan (the caller
        closes it): concurrent scatters do not queue on one connection,
        and the deadline force-closes exactly this query's socket."""
        return self._dial(addr)

    def drop_client(self, addr: str) -> None:
        for key in (addr, f"data:{addr}"):
            with self._mu:
                c = self._clients.pop(key, None)
            if c is not None:
                c._force_close()

    def peer_request(self, addr: str, typ, payload,
                     codec: int = CODEC_MSGPACK):
        return self.client(addr)._request(typ, payload, codec)

    def close(self) -> None:
        with self._mu:
            clients = list(self._clients.values())
            self._clients.clear()
            if self._spill is not None:
                self._spill.close()
        for c in clients:
            c.close()

    # --- degraded bookkeeping ----------------------------------------
    def _forget_session_weights(self, addr: str) -> None:
        """A member left (or came back): the session manager's record of
        the weights shipped to it is stale — a restarted worker no longer
        holds the models, and a weightless adopt there would fail."""
        sessions = getattr(self.ctl, "sessions", None)
        if sessions is not None:
            sessions.forget_owner(addr)

    def degrade(self, addr: str, reason: str) -> None:
        with self._mu:
            fresh = addr not in self._degraded
            self._degraded[addr] = reason
        if fresh:
            obs.REGISTRY.counter("shard.evictions").inc()
        self._forget_session_weights(addr)
        changed = self.ctl.placement.degrade_addr(addr)
        self.drop_client(addr)
        if changed:
            # the bump is leader-local until the surviving workers
            # re-register under it (best effort)
            self.ctl._push_epochs(exclude=(addr,))
        # every membership change replicates (and, under ha_mutlog,
        # persists) the map: a follower promoted mid-outage must know
        # which slots are in handoff
        self.ctl._replicate_placement()

    def note_degraded(self, addr: str, reason: str) -> None:
        """Record-only degrade (a restarted leader's map already holds
        the slot in handoff; a full :meth:`degrade` would bump its epoch
        again): the health loop then runs the normal readmit."""
        with self._mu:
            self._degraded.setdefault(addr, reason)

    def is_degraded(self, addr: str) -> bool:
        with self._mu:
            return addr in self._degraded

    def clear_degraded(self, addr: str) -> None:
        with self._mu:
            self._degraded.pop(addr, None)

    def degraded(self) -> Dict[str, str]:
        with self._mu:
            return dict(self._degraded)

    # --- handoff (the shard-scoped resync buffer) ---------------------
    @staticmethod
    def _payload_bytes(p: dict) -> int:
        items = p.get("items")
        if hasattr(items, "cols"):
            return int(sum(int(v.nbytes) for v in items.cols.values()))
        try:
            return 256 * len(items)
        except TypeError:
            return 1 << 20

    def handoff_put(self, db: str, set_name: str, slot: int,
                    token: Optional[str], payload: dict) -> None:
        """Buffer one routed batch for a degraded slot. It drains under
        the client's idempotency token when the frame carried one (a
        shard that already applied the original dedupes the copy), else
        under a token minted here."""
        token = token or uuid.uuid4().hex
        nbytes = self._payload_bytes(payload)
        rec = (token, dict(payload))
        key = (db, set_name, slot)
        with self._mu:
            if self._handoff_bytes + nbytes > self._handoff_max:
                raise ShardUnavailable(
                    f"handoff buffer for degraded shard slot {slot} is "
                    f"full ({self._handoff_max} bytes); retry later",
                    slot=slot)
            self._handoff.setdefault(key, []).append(rec)
            self._handoff_bytes += nbytes
            if self._spill is not None:
                # under _mu: the spill's record order is the buffer's
                self._spill.append({"op": "put", "key": list(key),
                                    "token": token,
                                    "payload": dict(payload)})
        # the buffer-vs-readmit race: if the slot went live while this
        # frame was in flight, the drain may already have run — pull the
        # batch back and refuse typed (the client re-routes); if the
        # drain shipped it, it was delivered
        entry = self.ctl.placement.entry(db, set_name)
        sl = (entry["slots"][slot]
              if entry is not None and slot < len(entry["slots"]) else None)
        if sl is None or sl["state"] != _placement.HANDOFF:
            with self._mu:
                cur = self._handoff.get(key, [])
                if rec in cur:
                    cur.remove(rec)
                    self._handoff_bytes -= nbytes
                    if not cur:
                        self._handoff.pop(key, None)
                    if self._spill is not None:
                        self._spill.append({"op": "unput",
                                            "key": list(key),
                                            "token": token})
                    raise PlacementStale(
                        f"slot {slot} of {db}:{set_name} readmitted "
                        f"mid-buffer; re-route to the live shard",
                        epoch=entry["epoch"] if entry else None)
            return
        obs.REGISTRY.counter("shard.handoff_batches").inc()

    def handoff_pending(self, addr: str) -> int:
        """Buffered batches bound for ``addr``'s slots."""
        count = 0
        for db, set_name in self.ctl.placement.sets_for_addr(addr):
            entry = self.ctl.placement.entry(db, set_name)
            for i, s in enumerate(entry["slots"]):
                if s["addr"] == addr:
                    with self._mu:
                        count += len(self._handoff.get((db, set_name, i),
                                                       ()))
        return count

    def purge_handoff(self, db: str, set_name: str) -> int:
        """Drop every buffered batch of one set (REMOVE/CLEAR); returns
        the batch count, keeping the byte count exact."""
        dropped = 0
        with self._mu:
            for key in [k for k in self._handoff
                        if k[0] == db and k[1] == set_name]:
                gone = self._handoff.pop(key)
                dropped += len(gone)
                self._handoff_bytes -= sum(self._payload_bytes(p)
                                           for _, p in gone)
            if dropped and self._spill is not None:
                self._spill.append({"op": "purge", "db": db,
                                    "set": set_name})
        return dropped

    def drain_handoff(self, addr: str) -> int:
        """Ship a readmitted shard exactly its own buffered batches under
        their tokens (a retried drain never applies twice). Batches leave
        the buffer only after they shipped; one buffered meanwhile goes
        in the next round."""
        drained = 0
        for db, set_name in self.ctl.placement.sets_for_addr(addr):
            entry = self.ctl.placement.entry(db, set_name)
            for i, s in enumerate(entry["slots"]):
                if s["addr"] != addr:
                    continue
                key = (db, set_name, i)
                while True:
                    with self._mu:
                        batches = list(self._handoff.get(key, ()))
                    if not batches:
                        break
                    for token, payload in batches:
                        fwd = dict(payload)
                        fwd[PLACEMENT_EPOCH_KEY] = entry["epoch"]
                        fwd[SHARD_SLOT_KEY] = i
                        if token:
                            fwd[IDEMPOTENCY_KEY] = token
                        if self.ctl._ha is not None:
                            # a drain is a peer frame: a shard under a
                            # newer leader fences a deposed one's drain
                            fwd[HA_TERM_KEY] = self.ctl._ha.term
                        self.peer_request(addr, MsgType.SEND_DATA, fwd,
                                          CODEC_PICKLE)
                        drained += 1
                    with self._mu:
                        cur = self._handoff.get(key, [])
                        rest = cur[len(batches):]
                        self._handoff_bytes -= sum(
                            self._payload_bytes(p)
                            for _, p in cur[:len(batches)])
                        if rest:
                            self._handoff[key] = rest
                        else:
                            self._handoff.pop(key, None)
                        if self._spill is not None:
                            self._spill.append(
                                {"op": "drain", "key": list(key),
                                 "n": len(batches)})
                            if not self._handoff:
                                # nothing pending: the spill's history
                                # is dead weight
                                self._spill.truncate()
        if drained:
            obs.REGISTRY.counter("shard.handoff_drained").inc(drained)
        return drained

    def load_spill(self) -> int:
        """Rebuild the buffer from its spill after a leader restart
        (``ha_mutlog``): put, unput, drain and purge replay in order, and
        what survives is exactly what was buffered and undelivered when
        the daemon died. Returns the pending batch count."""
        if self._spill is None:
            return 0
        with self._mu:
            self._handoff.clear()
            for _end, rec in self._spill.replay():
                op = rec.get("op")
                if op == "put":
                    self._handoff.setdefault(tuple(rec["key"]), []).append(
                        (rec.get("token"), rec["payload"]))
                elif op == "unput":
                    key = tuple(rec["key"])
                    cur = self._handoff.get(key, [])
                    for j in range(len(cur) - 1, -1, -1):
                        if cur[j][0] == rec.get("token"):
                            cur.pop(j)
                            break
                    if not cur:
                        self._handoff.pop(key, None)
                elif op == "drain":
                    key = tuple(rec["key"])
                    rest = self._handoff.get(key, [])[
                        int(rec.get("n") or 0):]
                    if rest:
                        self._handoff[key] = rest
                    else:
                        self._handoff.pop(key, None)
                elif op == "purge":
                    for key in [k for k in self._handoff
                                if k[0] == rec.get("db")
                                and k[1] == rec.get("set")]:
                        self._handoff.pop(key)
            self._handoff_bytes = sum(self._payload_bytes(p)
                                      for batches in self._handoff.values()
                                      for _, p in batches)
            return sum(len(b) for b in self._handoff.values())

    # --- read fan-out (stats and health sections) ---------------------
    def fanout(self, typ, payload) -> Dict[str, Any]:
        """Best-effort read fan-out to every worker under one deadline: a
        slow shard reports an error entry and is never evicted by a
        read."""
        addrs = list(self.ctl._worker_addrs)
        if not addrs:
            return {}
        out: Dict[str, Any] = {}
        deadline = deadline_after(self.ctl.frame_timeout_s)

        def ask(addr):
            try:
                out[addr] = self.peer_request(addr, typ, payload)
            except Exception as e:  # noqa: BLE001 — best-effort section
                out[addr] = {"error": f"{type(e).__name__}: {e}"}

        threads = [threading.Thread(target=ask, args=(a,), daemon=True)
                   for a in addrs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(max(0.0, seconds_left(deadline)))
        for addr in addrs:
            out.setdefault(addr, {"error": "no reply within "
                                           f"{self.ctl.frame_timeout_s}s"})
        return out

    # --- the coordinator ----------------------------------------------
    def scatter_execute(self, sinks: List[Any], job_name: str,
                        materialize: bool = True, explain: bool = False,
                        qid: Optional[str] = None,
                        client_id: Optional[str] = None):
        """Run one sink DAG over the pool: analyse, fan out, merge all or
        nothing, materialise. Returns ``(results, shard_ops)``, the second
        the per-shard EXPLAIN forest (None unless ``explain``)."""
        from netsdb_tpu_torch.plan import scatter

        ctl = self.ctl
        spec = scatter.analyze_sinks(sinks, ctl.is_sharded)
        if spec is None:
            touched = scatter.sharded_scan_sets(sinks, ctl.is_sharded)
            raise ValueError(
                f"query scans partitioned set(s) "
                f"{[f'{d}:{s}' for d, s in touched]} in a shape "
                f"scatter-gather cannot push (supported: single-pass "
                f"folds declaring state_merge, dict group-bys with "
                f"combine, grace-hash joins with declared keys+merge, "
                f"layer chains with a sink scatter_gather declaration); "
                f"a partitioned set's pages live only on its shards, so "
                f"there is no local fallback")
        entries = {}
        for db, s in spec.scan_sets:
            entry = ctl.placement.entry(db, s)
            entries[(db, s)] = entry
            for i, sl in enumerate(entry["slots"]):
                if sl["state"] != _placement.LIVE:
                    raise ShardUnavailable(
                        f"shard slot {i} of {db}:{s} ({sl['addr']}) is "
                        f"degraded; scatter-gather refuses rather than "
                        f"merge a partial result", slot=i,
                        epoch=entry["epoch"])
        addrs = [sl["addr"] for sl in entries[spec.scan_sets[0]]["slots"]]
        for e in entries.values():
            if [sl["addr"] for sl in e["slots"]] != addrs:
                raise ValueError(
                    f"sets {spec.scan_sets} are not co-placed on one pool; "
                    f"cross-pool scatter is unsupported")
        payload: Dict[str, Any] = {
            "kind": spec.kind, "job_name": job_name,
            "explain": bool(explain),
            "epochs": {f"{db}:{s}": e["epoch"]
                       for (db, s), e in entries.items()}}
        if spec.kind == "shuffle_join":
            payload.update(
                sid=f"{ctl.advertise_addr}#{next(_shuffle_ids)}",
                addrs=addrs, probe=list(spec.probe),
                build=list(spec.build), fold=spec.fold,
                shuffle_timeout_s=min(ctl.mirror_ack_timeout_s or 120.0,
                                      120.0))
        elif spec.kind == "multi_fold":
            payload["sinks"] = [scatter.multi_partial_sink(spec)]
            payload["scan"] = list(spec.scan_sets[0])
        else:
            payload["sinks"] = [scatter.partial_sink(spec)]
            if spec.kind == "fold_state":
                payload["scan"] = list(spec.scan_sets[0])
        obs.REGISTRY.counter("shard.scatter_queries").inc()

        replies: List[Optional[dict]] = [None] * len(addrs)
        failures: List[Tuple[int, str, BaseException]] = []
        conns: Dict[int, Any] = {}  # this query's own connections

        def run_slot(i: int, addr: str) -> None:
            p = dict(payload)
            if spec.kind == "shuffle_join":
                p["slot"] = i
            try:
                if addr == ctl.advertise_addr:
                    replies[i] = execute_subplan(ctl, p)
                    return
                if qid is not None:
                    p[QUERY_ID_KEY] = qid
                if client_id is not None:
                    p[CLIENT_ID_KEY] = client_id
                sc = self.fresh_client(addr)
                conns[i] = sc
                try:
                    replies[i] = sc._request(MsgType.SUBPLAN, p,
                                             CODEC_PICKLE)
                finally:
                    sc.close()
            except Exception as e:  # noqa: BLE001 — typed below
                failures.append((i, addr, e))

        threads, local = [], None
        for i, addr in enumerate(addrs):
            if addr == ctl.advertise_addr:
                local = (i, addr)
                continue
            t = threading.Thread(target=run_slot, args=(i, addr),
                                 daemon=True, name=f"netsdb-scatter-{i}")
            t.start()
            threads.append((i, addr, t))
        if local is not None:
            run_slot(*local)
        deadline = deadline_after(ctl.mirror_ack_timeout_s or 300.0)
        for i, addr, t in threads:
            t.join(max(0.0, seconds_left(deadline)))
            if t.is_alive():
                failures.append((i, addr, TimeoutError(
                    f"no subplan reply within the "
                    f"{ctl.mirror_ack_timeout_s}s budget")))
                # unblock the parked thread through this query's own
                # socket, never a concurrent query's
                sc = conns.get(i)
                if sc is not None:
                    sc._force_close()
        if failures:
            self._raise_scatter_failure(failures)
        return self._merge(spec, addrs, replies, materialize, explain,
                           job_name)

    def _raise_scatter_failure(self, failures) -> None:
        """Every partial is discarded; unreachable shards are evicted (an
        epoch bump: in-flight stale routes now refuse typed)."""
        from netsdb_tpu_torch.serve.errors import (PlacementStaleError,
                                                   RemoteError,
                                                   ShardUnavailableError)

        parts, fatal, stale = [], None, 0
        for i, addr, e in failures:
            parts.append(f"slot {i} ({addr}): {type(e).__name__}: {e}")
            if isinstance(e, (PlacementStaleError, PlacementStale)):
                stale += 1  # membership moved; the shard is healthy
            elif isinstance(e, (ShardUnavailableError, ShardUnavailable)):
                # an answered capacity refusal: the refusing daemon is
                # alive — evict nobody for backpressure
                pass
            elif isinstance(e, RemoteError) and not e.retryable:
                # a deterministic refusal: the query is wrong, not the pool
                fatal = fatal or e
            elif isinstance(e, (ValueError, TypeError, KeyError,
                                NotImplementedError)) \
                    and not isinstance(e, OSError):
                # the coordinator's own slot refused deterministically
                fatal = fatal or e
            else:
                # transport loss, timeout, retryable fault: evict
                self.degrade(addr, f"subplan failed: "
                                   f"{type(e).__name__}: {e}")
        if fatal is not None:
            raise fatal
        if stale == len(failures):
            raise PlacementStale(
                "scatter-gather raced a placement change; partials "
                "discarded — retry re-routes against the current map: "
                + "; ".join(parts))
        raise ShardUnavailable(
            "scatter-gather failed; partials discarded (never merged): "
            + "; ".join(parts))

    def _merge(self, spec, addrs, replies, materialize, explain,
               job_name="scatter"):
        from netsdb_tpu_torch.plan import scatter
        from netsdb_tpu_torch.storage.store import SetIdentifier

        device = self.ctl.device
        obs.REGISTRY.counter("shard.partials_merged").inc(len(replies))
        shard_ops = None
        if explain:
            shard_ops = {addrs[i]: _annotate_shard(r["operators"], addrs[i])
                         for i, r in enumerate(replies)
                         if r and r.get("operators") is not None}
        if spec.kind in ("fold_state", "multi_fold"):
            states = [_on_device(r["state"], device) for r in replies]
            dicts: Dict[str, list] = {}
            rows = 0
            for r in replies:
                for k, v in (r.get("dicts") or {}).items():
                    if k in dicts and list(dicts[k]) != list(v):
                        # group codes accumulated under divergent
                        # vocabularies would decode wrong
                        raise ValueError(
                            f"scatter merge: shard dictionaries for "
                            f"column {k!r} diverge; re-ingest the set "
                            f"with aligned dictionaries")
                    dicts.setdefault(k, v)
                rows += int(r.get("rows") or 0)
            if spec.kind == "multi_fold":
                fold = scatter.MultiFoldMerge(spec.components)
                label = "multi::" + "+".join(
                    (getattr(c.node, "label", "") or c.node.op_kind)
                    for c in spec.components)
                traceable = all(getattr(c.node, "traceable", True)
                                for c in spec.components)
            else:
                fold = spec.fold
                label = getattr(spec.node, "label", "") or spec.node.op_kind
                traceable = bool(getattr(spec.node, "traceable", True))
            cfg = self.ctl.config
            with torch.inference_mode():
                if cfg.plan_fusion and cfg.fusion_mapper == "optimal":
                    # merge and finalize as ONE program; fusion off and
                    # the greedy mapper keep the eager merge
                    value = scatter.merge_fold_states_compiled(
                        fold, states, dicts, rows, job_name, label,
                        traceable=traceable)
                else:
                    value = scatter.merge_fold_states(fold, states, dicts,
                                                      rows)
        elif spec.kind == "group_partial":
            value = scatter.merge_group_dicts(
                spec.node, [r["groups"] for r in replies])
        elif spec.kind == "tensor_chain":
            value = scatter.merge_tensor_chain(
                spec.gather, [_on_device(r["tensor"], device)
                              for r in replies], device=device)
        else:
            tables = [_on_device(r["table"], device) for r in replies
                      if r.get("table") is not None]
            if not tables:
                raise ValueError(
                    "distributed shuffle produced no partials (both join "
                    "sides empty on every shard)")
            with torch.inference_mode():
                value = scatter.merge_join_outputs(spec.fold, tables)
        store = self.ctl.library.store
        if spec.kind == "multi_fold":
            results: Dict[Any, Any] = {}
            for c, v in zip(spec.components, value):
                ident = SetIdentifier(c.sink.db, c.sink.set_name)
                if materialize:
                    materialize_result(store, ident, v)
                results[ident] = v
            return results, shard_ops
        ident = SetIdentifier(spec.sink.db, spec.sink.set_name)
        if materialize:
            materialize_result(store, ident, value)
        return {ident: value}, shard_ops
