"""The session/decode lane shape — coalescing GENERATE into batches.

One-shot analytics coalesce by FINGERPRINT (``policy.frame_fingerprint``:
identical queries share one execution). Decode traffic inverts the
shape: concurrent ``GENERATE`` frames are all DIFFERENT (each advances
its own session) yet want to share one padded step program dispatch —
coalescing by MODEL, not by identity. :class:`DecodeBatcher` is that
lane: the first arrival for a model becomes the batch leader, lingers
one small window for peers, then drains up to ``max_batch`` waiters
into a single ``run_batch`` call (``models/decode.step_batch`` under
the serve handler), fanning each session's own result back to its
waiter. The leader keeps draining while work is queued — the
``sched.coalesced`` leader/waiter discipline, reshaped for
batch-of-distinct-work.

Two structural guarantees the chaos tests lean on:

* **At most one occurrence of a session per batch** — a retried or
  pipelined duplicate stays queued for the NEXT batch, so one batch
  can never double-advance a session's state.
* **Exceptions fan out** — a failed batch rejects every waiter in it
  with the original fault; nothing blocks forever on a dead leader
  (the leader runs the batch on its own request thread).

Frames carrying ``protocol.SESSION_KEY`` admit through the reserved
:data:`DECODE_LANE` of the lane scheduler (unless the client named an
explicit lane), so decode loops and one-shot analytics get weighted
fairness instead of FIFO interleaving.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from netsdb_tpu_torch.utils.locks import TrackedLock

#: the scheduler lane session-scoped frames admit through when the
#: client named none — reserved for interactive decode so a busy
#: analytics lane can't starve sessions (and vice versa).
DECODE_LANE = "decode"


class _Waiter:
    __slots__ = ("sid", "req", "done", "result", "error")

    def __init__(self, sid: str, req: Any):
        self.sid = sid
        self.req = req
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class DecodeBatcher:
    """Per-model batch coalescing for concurrent decode steps.

    ``run_batch(db, reqs) -> results`` executes one padded step over
    the batch (index-aligned results). ``submit`` blocks the calling
    handler thread until its session's result (or fault) is ready.
    """

    def __init__(self, run_batch: Callable[[str, List[Any]], List[Any]],
                 max_batch: int = 8, window_s: float = 0.003):
        self._run = run_batch
        self.max_batch = max(1, int(max_batch))
        self.window_s = float(window_s)
        self._mu = TrackedLock("DecodeBatcher._mu")
        self._cv = threading.Condition(self._mu)
        self._pending: Dict[str, List[_Waiter]] = {}
        self._leader: Dict[str, bool] = {}
        self._stats = {"batches": 0, "coalesced": 0, "max_occupancy": 0}

    def submit(self, db: str, sid: str, req: Any) -> Any:
        """Enqueue one session's step; returns its result. The first
        waiter of an idle model becomes the leader and drains the
        queue batch by batch; everyone else parks on their event."""
        w = _Waiter(sid, req)
        with self._mu:
            q = self._pending.setdefault(db, [])
            q.append(w)
            lead = not self._leader.get(db, False)
            if lead:
                self._leader[db] = True
            else:
                self._cv.notify_all()
        if lead:
            self._drain(db)
        w.done.wait()
        if w.error is not None:
            raise w.error
        return w.result

    def _drain(self, db: str) -> None:
        # Leadership ends ONLY under ``_mu`` in the same critical
        # section that observed an empty queue — a waiter therefore
        # either enqueues before that check (this leader batches it)
        # or after the flag clears (it becomes the next leader).
        # Anything else loses a wakeup: waiters park on their own
        # event, not the condition variable.
        try:
            while True:
                deadline = time.monotonic() + self.window_s
                with self._mu:
                    while (len(self._pending.get(db, ()))
                           < self.max_batch):
                        left = deadline - time.monotonic()
                        if left <= 0:
                            break
                        self._cv.wait(left)
                    batch = self._take_locked(db)
                    if not batch:
                        self._leader[db] = False
                        return
                try:
                    results = self._run(db, [w.req for w in batch])
                    if len(results) != len(batch):
                        raise RuntimeError(
                            f"decode batch returned {len(results)} "
                            f"results for {len(batch)} requests")
                    for w, r in zip(batch, results):
                        # a per-request fault (e.g. one session moved
                        # out from under the batch) fails ONLY its own
                        # waiter; the rest of the batch keeps its
                        # results
                        if isinstance(r, BaseException):
                            w.error = r
                        else:
                            w.result = r
                except BaseException as e:  # noqa: BLE001 — fan out
                    for w in batch:
                        w.error = e
                finally:
                    for w in batch:
                        w.done.set()
        except BaseException as e:  # leader thread dying: fail the
            with self._mu:          # parked waiters, don't strand them
                self._leader[db] = False
                orphans = self._pending.pop(db, [])
            for w in orphans:
                w.error = e
                w.done.set()
            raise

    def _take_locked(self, db: str) -> List[_Waiter]:
        """Up to ``max_batch`` waiters, AT MOST ONE PER SESSION —
        duplicates (a pipelined retry) wait for the next batch so a
        single dispatch can never double-step a session."""
        q = self._pending.get(db, [])
        batch: List[_Waiter] = []
        seen = set()
        rest: List[_Waiter] = []
        for w in q:
            if len(batch) < self.max_batch and w.sid not in seen:
                batch.append(w)
                seen.add(w.sid)
            else:
                rest.append(w)
        if rest:
            self._pending[db] = rest
        else:
            self._pending.pop(db, None)
        if batch:
            self._stats["batches"] += 1
            self._stats["coalesced"] += len(batch)
            if len(batch) > self._stats["max_occupancy"]:
                self._stats["max_occupancy"] = len(batch)
        return batch

    def snapshot(self) -> Dict[str, Any]:
        with self._mu:
            out = dict(self._stats)
            out["pending"] = sum(len(v)
                                 for v in self._pending.values())
        return out
