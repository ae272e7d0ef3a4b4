"""A readers-preference readers-writer lock — the port's copy of the
stream-versus-mutation lock of ``netsdb_tpu/utils/locks.py`` (without
the reference's lock-order witness, which belongs to ROADMAP.md A8).

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
