"""Deterministic fault injection for the serve control plane — the
port's copy of ``netsdb_tpu/serve/chaos.py``, decision for decision, so
one seed gives one fault sequence in both packages.

A :class:`ChaosInjector` is an explicit object handed to a
:class:`~netsdb_tpu_torch.serve.client.RemoteClient` (request/reply
frames), a :class:`~netsdb_tpu_torch.serve.server.ServeController`
(request recv + reply send), or a controller's ``follower_chaos``
(leader→follower mirror frames). Production paths never construct one,
and the hook in ``protocol.send_frame``/``recv_frame_raw`` is a single
``is None`` check — zero cost when chaos is off.

Two modes, freely combined:

* **scripted** (:meth:`arm`): a FIFO of exact actions consumed by the
  next matching frames — the deterministic mode the chaos tests use to
  place one fault at one protocol step.
* **probabilistic**: seeded per-frame rates (``drop``/``delay``/
  ``corrupt``/``truncate``), bounded by ``max_faults`` so a retrying
  client always converges. Same seed → same fault sequence.

Actions (``where="send"`` unless noted):

* ``drop`` — the frame is never written (or read, ``where="recv"``);
  the socket is torn down so the peer observes a reset instead of
  hanging, and :class:`ConnectionResetError` is raised locally.
* ``delay`` — sleep ``delay_s`` before the frame proceeds (drives the
  timeout paths).
* ``corrupt`` — every body byte is XOR-flipped; the header (and its
  length field) stays valid, so the peer reads a well-framed body that
  fails to decode — the CorruptFrame path.
* ``corrupt_seg`` — flips one byte in the middle of the largest
  OUT-OF-BAND tensor segment (wire format v3): the MessagePack body
  still decodes, but the segment no longer matches its
  ``protocol.segment_checksum`` in the segment table — the corruption
  lands where the body's own framing cannot see it. Falls back to
  ``corrupt`` on frames without segments.
* ``truncate`` — the frame is cut mid-flight, then the socket is torn
  down: the peer's ``_recv_exact`` sees EOF mid-frame. On a codec-2
  frame the cut lands INSIDE the first tensor segment (header, segment
  table and body all arrive intact first).
* ``kill`` — alias of ``drop``; reads better in follower-kill tests.

Every injected fault is recorded in :attr:`faults` for assertions.
"""

from __future__ import annotations

import random
import time
from typing import Any, List, Optional, Tuple

from netsdb_tpu_torch.utils.locks import TrackedLock

_ACTIONS = ("drop", "delay", "corrupt", "corrupt_seg", "truncate", "kill")


class ChaosInjector:
    def __init__(self, seed: int = 0, drop: float = 0.0, delay: float = 0.0,
                 corrupt: float = 0.0, truncate: float = 0.0,
                 delay_s: float = 0.05,
                 max_faults: Optional[int] = None):
        self._rng = random.Random(seed)
        self._rates = (("drop", drop), ("delay", delay),
                       ("corrupt", corrupt), ("truncate", truncate))
        self.delay_s = delay_s
        self.max_faults = max_faults
        self._mu = TrackedLock("ChaosInjector._mu")
        # scripted queue: (action, where, types-or-None, delay_s)
        self._script: List[Tuple[str, str, Optional[frozenset], float]] = []
        self.faults: List[Tuple[str, str, Any]] = []  # (action, where, typ)

    # --- configuration -------------------------------------------------
    def arm(self, *actions: str, where: str = "send", types=None,
            delay_s: Optional[float] = None) -> "ChaosInjector":
        """Queue deterministic actions for the next frames passing the
        ``where`` hook (optionally only frames whose type is in
        ``types``). Scripted actions fire regardless of ``max_faults``."""
        for a in actions:
            if a not in _ACTIONS:
                raise ValueError(f"unknown chaos action {a!r}")
            with self._mu:
                self._script.append(
                    (a, where, frozenset(int(t) for t in types) if types
                     else None, self.delay_s if delay_s is None else delay_s))
        return self

    # --- decision ------------------------------------------------------
    def _next(self, where: str, msg_type: Optional[int]):
        with self._mu:
            for i, (action, w, types, dly) in enumerate(self._script):
                if w != where:
                    continue
                if types is not None and (msg_type is None
                                          or int(msg_type) not in types):
                    continue
                del self._script[i]
                self.faults.append((action, where, msg_type))
                return action, dly
            if self.max_faults is not None \
                    and len(self.faults) >= self.max_faults:
                return None, 0.0
            roll = self._rng.random()
            acc = 0.0
            for action, rate in self._rates:
                acc += rate
                if roll < acc:
                    self.faults.append((action, where, msg_type))
                    return action, self.delay_s
        return None, 0.0

    # --- hooks (called from protocol.py) -------------------------------
    @staticmethod
    def _teardown(sock) -> None:
        import socket as _socket

        try:
            sock.shutdown(_socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass

    def on_send(self, sock, msg_type: int, header: bytes, body: bytes,
                segtable: bytes = b"", segments=()) -> Tuple:
        """Possibly fault the outgoing frame; returns the (header,
        segtable, body, segments) to actually write. ``segments`` are
        the out-of-band tensor buffers of a codec-2 frame (empty
        otherwise); the segment TABLE — lengths + checksums — is never
        rewritten, so a mutated segment arrives detectably stale.
        ``drop``/``truncate`` tear the socket down and raise
        ConnectionResetError so the caller's failure path runs exactly
        as it would on a real reset."""
        segments = list(segments)
        action, dly = self._next("send", msg_type)
        if action is None:
            return header, segtable, body, segments
        if action == "delay":
            time.sleep(dly)
            return header, segtable, body, segments
        if action == "corrupt_seg" and segments:
            i = max(range(len(segments)), key=lambda k: segments[k].nbytes)
            mutated = bytearray(segments[i])
            mutated[len(mutated) // 2] ^= 0xA5
            segments[i] = memoryview(mutated)
            return header, segtable, body, segments
        if action in ("corrupt", "corrupt_seg"):
            return header, segtable, bytes(b ^ 0xA5 for b in body), segments
        if action == "truncate":
            try:
                sock.sendall(header)
                sock.sendall(segtable)
                if segments:
                    # the cut lands INSIDE a tensor segment: body and
                    # segment table arrive whole, the raw buffer doesn't
                    sock.sendall(body)
                    first = segments[0]
                    sock.sendall(first[: max(1, first.nbytes // 2)])
                else:
                    sock.sendall(body[: max(1, len(body) // 2)])
            except OSError:
                pass
            self._teardown(sock)
            raise ConnectionResetError(
                f"chaos: frame type {msg_type} truncated (injected)")
        # drop / kill
        self._teardown(sock)
        raise ConnectionResetError(
            f"chaos: frame type {msg_type} dropped (injected)")

    def on_recv(self, sock) -> None:
        """Possibly fault before reading the next frame (the incoming
        direction — frame types are unknown until read, so recv scripts
        match any type)."""
        action, dly = self._next("recv", None)
        if action is None:
            return
        if action == "delay":
            time.sleep(dly)
            return
        self._teardown(sock)
        raise ConnectionResetError("chaos: inbound frame dropped (injected)")
