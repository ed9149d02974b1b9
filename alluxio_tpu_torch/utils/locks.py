"""Reader-writer lock (a copy of ``alluxio_tpu/utils/locks.py``).

Used by the inode tree (coarse tree lock — a deliberate departure from the
reference's 8k-LoC fine-grained per-inode lock scheme,
``file/meta/{InodeLockManager.java:47,InodeTree.java:84}``; see
``master/inode_tree.py`` for the rationale) and by per-block client locks on
the worker (reference: ``worker/block/ClientRWLock.java``).
"""

from __future__ import annotations

import threading


class RWLock:
    """Writer-preferring reader-writer lock, reentrant for readers and for
    the writer (per-thread hold counts make read re-acquisition safe even
    while a writer is queued)."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._readers = 0
        self._holds = threading.local()  # this thread's read-hold depth
        self._writer: "threading.Thread | None" = None
        self._writer_depth = 0
        self._waiting_writers = 0
        # Monotonic write-acquisition counter: every mutation of the
        # protected structure requires the write lock, so "version
        # unchanged" == "structure unchanged" (conservative: bumps even
        # for a no-op write section). Read it under the read lock for a
        # coherent snapshot. Used by the master's listing cache.
        self.version = 0

    def _my_holds(self) -> int:
        return getattr(self._holds, "depth", 0)

    # -- read side ----------------------------------------------------------
    def acquire_read(self, timeout: float = None) -> bool:
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

    # -- write side ---------------------------------------------------------
    def acquire_write(self, timeout: float = None) -> bool:
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
                self.version += 1
                return True
            finally:
                self._waiting_writers -= 1

    def release_write(self) -> None:
        with self._cond:
            self._writer_depth -= 1
            if self._writer_depth == 0:
                self._writer = None
                self._cond.notify_all()

    # -- context managers ---------------------------------------------------
    class _Guard:
        def __init__(self, acquire, release):
            self._acquire, self._release = acquire, release

        def __enter__(self):
            self._acquire()
            return self

        def __exit__(self, *exc):
            self._release()
            return False

    def read_locked(self) -> "_Guard":
        return RWLock._Guard(self.acquire_read, self.release_read)

    def write_locked(self) -> "_Guard":
        return RWLock._Guard(self.acquire_write, self.release_write)
