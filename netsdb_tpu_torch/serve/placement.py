"""Leader-owned placement map for the sharded worker pool — the port's
``netsdb_tpu/serve/placement.py``, host numpy throughout.

netsDB's topology is master/worker *partitioned* storage: the master
plans a job into stages that run on the workers holding the set's pages
(``QuerySchedulerServer.cc:216-330``), so a node adds capacity, not a
copy. A set created with ``placement="hash"`` (or ``"range"``) splits
its pages across a pool of daemons, and the leader owns the
authoritative, **versioned** map of which daemon holds which slot.

The map is:

* shipped to clients in the handshake (the HELLO reply carries a
  ``placement`` section only while sharded sets exist) and re-read with
  the ``PLACEMENT`` frame;
* **epoch-versioned** per set: every membership change (a shard evicted
  into handoff, a readmit) bumps the set's epoch. Routed frames carry
  the sender's epoch (``protocol.PLACEMENT_EPOCH_KEY``) and a receiver
  registered under another one refuses with the typed retryable
  ``PlacementStale``, so an ingest never half-applies and partials
  computed under two memberships never merge;
* slot-stable: an eviction flips a slot to ``handoff`` (its ingest
  buffers at the leader, scatter-gather refuses typed) instead of
  re-assigning its hash space, so a readmitted shard gets exactly its
  own buffered pages back.

Routing is deterministic and shared by client and server: ``range``
splits each batch into contiguous row ranges (the default); ``hash``
routes rows by a splitmix64-mixed key column so equal keys co-locate.
A key lands on the same slot as in the reference, bit for bit.
"""

from __future__ import annotations

import hashlib
import pickle
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from netsdb_tpu_torch.utils.locks import TrackedLock

#: slot states: ``live`` (the shard daemon owns the slot) and ``handoff``
#: (degraded — the leader buffers the slot's ingest and drains it on
#: readmit; queries refuse typed while any slot is here)
LIVE = "live"
HANDOFF = "handoff"


def mix64_array(values) -> np.ndarray:
    """Vectorised splitmix64 finaliser over an integer column (the mix
    the grace-hash partitioner and the distributed shuffle use too)."""
    with np.errstate(over="ignore"):
        v = np.asarray(values).astype(np.uint64)
        v ^= v >> np.uint64(33)
        v *= np.uint64(0xFF51AFD7ED558CCD)
        v ^= v >> np.uint64(29)
        v *= np.uint64(0xC4CEB9FE1A85EC53)
        v ^= v >> np.uint64(32)
    return v


def _host(col) -> np.ndarray:
    if isinstance(col, torch.Tensor):
        return col.detach().cpu().numpy()
    return np.asarray(col)


def hash_slot_ids(key_col, nslots: int) -> np.ndarray:
    """Row → owning slot for hash placement (integer key columns; a
    device column is read to the host first)."""
    return (mix64_array(_host(key_col)) % np.uint64(nslots)).astype(
        np.int64)


def item_slot(item: Any, nslots: int) -> int:
    """Stable slot of one opaque object row: a digest of its pickle,
    content-stable across processes (unlike ``hash()``)."""
    blob = pickle.dumps(item, protocol=pickle.HIGHEST_PROTOCOL)
    return int.from_bytes(hashlib.blake2s(blob, digest_size=8).digest(),
                          "little") % nslots


def range_slices(nrows: int, nslots: int) -> List[Tuple[int, int]]:
    """Contiguous even split of a batch: slot i gets rows
    [i*n/k, (i+1)*n/k)."""
    return [((nrows * i) // nslots, (nrows * (i + 1)) // nslots)
            for i in range(nslots)]


def split_table(table, entry: Dict[str, Any]):
    """One ``ColumnTable`` batch → ``[(slot, sub_table)]`` on the host,
    empty slots omitted: row-range views in range mode, one gather per
    slot in hash mode. Shared by the routing client and the leader's
    handoff drain, so the two never partition differently."""
    from netsdb_tpu_torch.relational.table import ColumnTable

    nslots = len(entry["slots"])
    if table.valid is not None:
        table = table.compact()
    cols = {k: _host(v) for k, v in table.cols.items()}
    nrows = int(table.num_rows)
    mode, key = entry.get("mode"), entry.get("key")
    if mode == "hash" and key and key not in cols:
        # range-splitting here would break the set's key co-location
        raise ValueError(
            f"hash-placed set declares key {key!r} but this batch "
            f"carries columns {sorted(cols)}")

    def sub(take) -> ColumnTable:
        return ColumnTable({k: torch.from_numpy(np.ascontiguousarray(
            take(v))) for k, v in cols.items()}, dict(table.dicts), None)

    out = []
    if mode == "hash" and key in cols:
        slot_ids = hash_slot_ids(cols[key], nslots)
        for i in range(nslots):
            idx = np.nonzero(slot_ids == i)[0]
            if idx.size:
                out.append((i, sub(lambda v, idx=idx: v[idx])))
        return out
    for i, (start, stop) in enumerate(range_slices(nrows, nslots)):
        if stop > start:
            out.append((i, sub(lambda v, a=start, b=stop: v[a:b])))
    return out


def split_items(items: list, entry: Dict[str, Any]):
    """One object-row batch → ``[(slot, sublist)]`` (the contract of
    :func:`split_table`)."""
    nslots = len(entry["slots"])
    buckets: List[list] = [[] for _ in range(nslots)]
    if entry.get("mode") == "hash":
        key = entry.get("key")
        if key and items and all(isinstance(it, dict) and key in it
                                 for it in items):
            slot_ids = hash_slot_ids(
                np.asarray([it[key] for it in items]), nslots)
            for item, slot in zip(items, slot_ids):
                buckets[int(slot)].append(item)
            return [(i, b) for i, b in enumerate(buckets) if b]
        for item in items:
            if key and isinstance(item, dict) and key in item:
                slot = int(hash_slot_ids(np.asarray([item[key]]),
                                         nslots)[0])
            else:
                slot = item_slot(item, nslots)
            buckets[slot].append(item)
    else:
        for i, (start, stop) in enumerate(range_slices(len(items),
                                                       nslots)):
            buckets[i] = items[start:stop]
    return [(i, b) for i, b in enumerate(buckets) if b]


class PlacementMap:
    """The leader's set → shard-slot table. Thread-safe; readers get
    copies, so no caller mutates shared state."""

    def __init__(self):
        self._mu = TrackedLock("serve.PlacementMap._mu")
        self._entries: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._epoch = 0

    # --- registration -------------------------------------------------
    def create(self, db: str, set_name: str, addrs: List[str],
               mode: str = "range",
               key: Optional[str] = None) -> Dict[str, Any]:
        if mode not in ("hash", "range"):
            raise ValueError(f"placement mode must be 'hash' or "
                             f"'range', got {mode!r}")
        with self._mu:
            self._epoch += 1
            entry = {"mode": mode, "key": key, "epoch": self._epoch,
                     "slots": [{"addr": a, "state": LIVE} for a in addrs]}
            self._entries[(db, set_name)] = entry
            return self._copy(entry)

    def remove(self, db: str, set_name: str) -> None:
        with self._mu:
            self._entries.pop((db, set_name), None)

    # --- reads --------------------------------------------------------
    @staticmethod
    def _copy(entry: Dict[str, Any]) -> Dict[str, Any]:
        return {"mode": entry["mode"], "key": entry["key"],
                "epoch": entry["epoch"],
                "slots": [dict(s) for s in entry["slots"]]}

    def entry(self, db: str, set_name: str) -> Optional[Dict[str, Any]]:
        with self._mu:
            e = self._entries.get((db, set_name))
            return self._copy(e) if e is not None else None

    def sets(self) -> List[Tuple[str, str]]:
        with self._mu:
            return sorted(self._entries)

    def __len__(self) -> int:
        with self._mu:
            return len(self._entries)

    def sets_for_addr(self, addr: str) -> List[Tuple[str, str]]:
        """Every (db, set) with a slot on ``addr`` (the readmit drain's
        work list)."""
        with self._mu:
            return sorted(k for k, e in self._entries.items()
                          if any(s["addr"] == addr for s in e["slots"]))

    # --- membership changes (each bumps the affected epochs) ----------
    def _flip(self, addr: str, state: str) -> List[Tuple[str, str]]:
        changed = []
        with self._mu:
            for ident, e in self._entries.items():
                hit = False
                for s in e["slots"]:
                    if s["addr"] == addr and s["state"] != state:
                        s["state"] = state
                        hit = True
                if hit:
                    self._epoch += 1
                    e["epoch"] = self._epoch
                    changed.append(ident)
        return changed

    def degrade_addr(self, addr: str) -> List[Tuple[str, str]]:
        """Evict one shard daemon: its slots flip to handoff and every
        affected set's epoch bumps (frames routed under the old epoch
        now refuse typed)."""
        return self._flip(addr, HANDOFF)

    def readmit_addr(self, addr: str) -> List[Tuple[str, str]]:
        """Readmit one shard daemon after its handoff drained."""
        return self._flip(addr, LIVE)

    def rebind_addr(self, old: str, new: str) -> List[Tuple[str, str]]:
        """Rewrite every slot owned by ``old`` to ``new`` (state live)
        and bump the affected epochs: a client still routing under the
        old map gets one typed ``PlacementStale``, refreshes and
        re-routes."""
        changed = []
        with self._mu:
            for ident, e in self._entries.items():
                hit = False
                for s in e["slots"]:
                    if s["addr"] == old:
                        s["addr"] = new
                        s["state"] = LIVE
                        hit = True
                if hit:
                    self._epoch += 1
                    e["epoch"] = self._epoch
                    changed.append(ident)
        return changed

    def move_slot(self, db: str, set_name: str, slot: int,
                  new_addr: str) -> Optional[Dict[str, Any]]:
        """Re-own one slot (state live) and bump the set's epoch; the
        slot count never changes. None when the set or slot does not
        exist."""
        with self._mu:
            e = self._entries.get((db, set_name))
            if e is None or not (0 <= slot < len(e["slots"])):
                return None
            e["slots"][slot]["addr"] = new_addr
            e["slots"][slot]["state"] = LIVE
            self._epoch += 1
            e["epoch"] = self._epoch
            return self._copy(e)

    # --- wire form ----------------------------------------------------
    def to_wire(self) -> Dict[str, Any]:
        with self._mu:
            return {"epoch": self._epoch,
                    "sets": {f"{db}:{s}": self._copy(e)
                             for (db, s), e in self._entries.items()}}

    def restore(self, wire: Dict[str, Any]) -> int:
        """Install a map captured by :meth:`to_wire`, epochs exactly as
        they were; returns the restored set count."""
        sets = (wire or {}).get("sets") or {}
        with self._mu:
            self._entries = {}
            for key, entry in sets.items():
                db, _, set_name = key.partition(":")
                self._entries[(db, set_name)] = {
                    "mode": entry["mode"], "key": entry.get("key"),
                    "epoch": int(entry["epoch"]),
                    "slots": [dict(s) for s in entry["slots"]]}
            self._epoch = max(
                [int((wire or {}).get("epoch") or 0)]
                + [e["epoch"] for e in self._entries.values()])
            return len(self._entries)

    @staticmethod
    def entry_from_wire(wire: Dict[str, Any], db: str,
                        set_name: str) -> Optional[Dict[str, Any]]:
        """One set's entry out of a shipped map (the client's read)."""
        if not wire:
            return None
        return (wire.get("sets") or {}).get(f"{db}:{set_name}")
