"""Reader-writer lock: a copy of ``alluxio_tpu/utils/locks.py``'s
``RWLock``, which the worker's per-block client locks use (reference:
``worker/block/ClientRWLock.java``)."""

from __future__ import annotations

import threading
from typing import Optional


class RWLock:
    """Writer-preferring reader-writer lock, reentrant for readers and for
    the writer (per-thread hold counts make read re-acquisition safe even
    while a writer is queued)."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._readers = 0
        self._holds = threading.local()  # this thread's read-hold depth
        self._writer: Optional[threading.Thread] = None
        self._writer_depth = 0
        self._waiting_writers = 0

    def _my_holds(self) -> int:
        return getattr(self._holds, "depth", 0)

    def acquire_read(self, timeout: Optional[float] = None) -> bool:
        me = threading.current_thread()
        with self._cond:
            if self._writer is me:
                self._writer_depth += 1
                return True
            if self._my_holds() > 0:
                # reentrant read: never wait (a queued writer must not
                # deadlock an existing reader re-entering)
                self._holds.depth += 1
                self._readers += 1
                return True
            ok = self._cond.wait_for(
                lambda: self._writer is None and self._waiting_writers == 0,
                timeout)
            if not ok:
                return False
            self._holds.depth = 1
            self._readers += 1
            return True

    def release_read(self) -> None:
        me = threading.current_thread()
        with self._cond:
            if self._writer is me:
                self._writer_depth -= 1
                return
            self._holds.depth = self._my_holds() - 1
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self, timeout: Optional[float] = None) -> bool:
        me = threading.current_thread()
        with self._cond:
            if self._writer is me:
                self._writer_depth += 1
                return True
            self._waiting_writers += 1
            try:
                ok = self._cond.wait_for(
                    lambda: self._writer is None and self._readers == 0,
                    timeout)
                if not ok:
                    return False
                self._writer = me
                self._writer_depth = 1
                return True
            finally:
                self._waiting_writers -= 1

    def release_write(self) -> None:
        with self._cond:
            self._writer_depth -= 1
            if self._writer_depth == 0:
                self._writer = None
                self._cond.notify_all()
