"""Durable per-store mutation log — the log-shipping half of HA, the
port's ``netsdb_tpu/storage/mutlog.py`` with the same file format (a log
that one package writes, the other reads).

The serve layer's mirror path (``serve/server.py`` ``_mirror_once``)
forwards every mutating frame to its followers over ordered FIFO links;
this module gives that same path a DISK tail. Two consumers:

* **Log-replay resync** — when a follower is evicted, the leader
  remembers the byte offset of the last frame that follower acked. On
  reattach it replays ``replay(from_offset)`` — only the frames the
  follower missed — instead of streaming a whole-store snapshot (the
  snapshot resync stays as the fallback when no offset is known or the
  log was truncated past it).
* **Durable handoff spill** — the degraded-slot handoff buffer
  (``serve/shard.py``) appends every buffered batch (and a record per
  drain/purge) so buffered ingest survives a leader RESTART; replay at
  startup rebuilds exactly the still-pending batches.

Record framing: ``u64 length | u32 crc32(payload) | payload`` with
big-endian headers and a pickled payload (the trusted-control-plane
boundary — same argument as the checkpoint snapshots and the wire's
codec 1). The payload holds host values only: a tensor in a record is
written as a numpy array (:func:`host_record`), never as a card tensor,
and functions inside a logged DAG pickle by value
(``serve/_fnpickle.py``), which plain pickle reads back. Offsets handed
to callers are always END offsets: the position a reader who has
applied everything up to and including that record resumes from, so
``last_offset()`` == file size and ``replay(0)`` yields the whole log.

Torn tails are expected (a crash mid-append): ``open`` scans the file
and truncates the first record whose header or checksum does not
validate — the log's prefix property is what replay correctness rests
on, so a torn record and everything after it are dropped rather than
skipped over.
"""

from __future__ import annotations

import os
import pickle
import struct
import zlib
from typing import Any, Iterator, Tuple

from netsdb_tpu_torch import obs
from netsdb_tpu_torch.utils.locks import TrackedLock

def host_record(value: Any) -> Any:
    """``value`` with every tensor in its dicts, lists and tuples as a
    host numpy array (what a record may hold); other objects as they
    are."""
    import torch

    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, dict):
        return {k: host_record(v) for k, v in value.items()}
    if isinstance(value, list):
        return [host_record(v) for v in value]
    if isinstance(value, tuple) and not hasattr(value, "_fields"):
        return tuple(host_record(v) for v in value)
    return value


#: record header: payload length (u64) + crc32 of the payload (u32)
_HDR = struct.Struct("!QI")

#: refuse to parse absurd lengths (a torn header read as a length
#: would otherwise allocate unbounded buffers during recovery scans)
_MAX_RECORD_BYTES = 1 << 31


class MutationLog:
    """Append-only framed record log at ``path``.

    All methods are thread-safe (``_mu`` is a leaf rank). Every append
    is flushed to the OS and never ``fsync``ed (the reference's
    ``fsync=False`` default): durable across a process restart, which
    is the HA contract; a power loss losing the last records degrades
    to re-execution under the idempotency tokens the records carry,
    never divergence (the same durability stance as the idempotency
    sqlite's ``synchronous=NORMAL``)."""

    def __init__(self, path: str):
        self.path = path
        self._mu = TrackedLock("storage.MutationLog._mu")
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        valid_end = self._scan_valid_end(path)
        self._f = open(path, "ab")
        if self._f.tell() != valid_end:
            # torn tail from a crash mid-append: drop the partial
            # record (and anything after it) — replay must only ever
            # see a valid prefix
            self._f.truncate(valid_end)
            self._f.seek(valid_end)
        self._end = valid_end

    @staticmethod
    def _scan_valid_end(path: str) -> int:
        """Largest offset such that [0, offset) parses as whole,
        checksum-clean records."""
        if not os.path.exists(path):
            return 0
        end = 0
        with open(path, "rb") as f:
            while True:
                hdr = f.read(_HDR.size)
                if len(hdr) < _HDR.size:
                    return end
                length, crc = _HDR.unpack(hdr)
                if length > _MAX_RECORD_BYTES:
                    return end
                payload = f.read(length)
                if len(payload) < length \
                        or zlib.crc32(payload) != crc:
                    return end
                end += _HDR.size + length

    # --- writes -------------------------------------------------------
    def append(self, record: Any) -> int:
        """Append one record; returns the log's END offset after it —
        the resume position for a reader that has applied this record."""
        from netsdb_tpu_torch.serve import _fnpickle

        payload = _fnpickle.dumps(host_record(record))
        frame = _HDR.pack(len(payload), zlib.crc32(payload)) + payload
        with self._mu:
            if self._f.closed:
                raise ValueError(f"mutation log {self.path} is closed")
            self._f.write(frame)
            self._f.flush()
            self._end += len(frame)
            end = self._end
        obs.REGISTRY.counter("mutlog.appended_bytes").inc(len(frame))
        return end

    def truncate(self) -> None:
        """Reset the log to empty — the compaction moment (e.g. every
        spilled handoff batch has drained, or a snapshot superseded
        the whole tail)."""
        with self._mu:
            if self._f.closed:
                return
            self._f.truncate(0)
            self._f.seek(0)
            self._f.flush()
            self._end = 0

    # --- reads --------------------------------------------------------
    def last_offset(self) -> int:
        with self._mu:
            return self._end

    def replay(self, from_offset: int = 0) -> Iterator[Tuple[int, Any]]:
        """Yield ``(end_offset, record)`` for every record at or after
        ``from_offset``, bounded by the log's size at call time.
        Reads run on a dedicated handle — appends may continue
        concurrently (their records simply fall past the bound)."""
        with self._mu:
            bound = self._end
        if from_offset >= bound:
            return
        f = open(self.path, "rb")
        try:
            f.seek(from_offset)
            pos = from_offset
            while pos < bound:
                hdr = f.read(_HDR.size)
                if len(hdr) < _HDR.size:
                    return  # truncated under us — valid prefix ends
                length, crc = _HDR.unpack(hdr)
                payload = f.read(length)
                if len(payload) < length \
                        or zlib.crc32(payload) != crc:
                    return
                pos += _HDR.size + length
                yield pos, pickle.loads(payload)
        finally:
            f.close()

    def close(self) -> None:
        with self._mu:
            if not self._f.closed:
                self._f.close()
