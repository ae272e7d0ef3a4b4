"""Locks — the port's copies from ``netsdb_tpu/utils/locks.py``: the
readers-preference readers-writer lock of streams against mutations, and
:class:`TrackedLock`, a ``threading.Lock`` that carries its rank name
(the serve layer names every lock it takes). The reference's lock-order
witness, which reads those names, belongs to ROADMAP.md A8.

Streams of a paged set hold the read side for their lifetime; dropping
or replacing the set's pages takes the write side, so pages are never
freed under a live stream."""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator


class RWLock:
    def __init__(self):
        self._cond = threading.Condition(threading.Lock())
        self._readers = 0
        self._writer = False

    @contextlib.contextmanager
    def read(self) -> Iterator[None]:
        with self._cond:
            while self._writer:
                self._cond.wait()
            self._readers += 1
        try:
            yield
        finally:
            with self._cond:
                self._readers -= 1
                if not self._readers:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def write(self) -> Iterator[None]:
        with self._cond:
            while self._writer or self._readers:
                self._cond.wait()
            self._writer = True
        try:
            yield
        finally:
            with self._cond:
                self._writer = False
                self._cond.notify_all()


class TrackedLock:
    """``threading.Lock`` with a rank name. Drop-in: context manager,
    ``acquire(blocking=, timeout=)``, ``release()``, ``locked()``."""

    __slots__ = ("_lk", "name")

    def __init__(self, name: str):
        self._lk = threading.Lock()
        self.name = name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        return self._lk.acquire(blocking, timeout)

    def release(self) -> None:
        self._lk.release()

    def locked(self) -> bool:
        return self._lk.locked()

    def __enter__(self) -> "TrackedLock":
        self._lk.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self._lk.release()

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"
