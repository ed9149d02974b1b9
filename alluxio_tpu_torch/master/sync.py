"""UFS metadata-sync machinery: the two path caches of
``alluxio_tpu/master/sync.py`` (its ``ActiveSyncManager`` comes with the
master's checkers).

Re-designs of the reference's sync subsystem:
- ``file/meta/UfsSyncPathCache.java`` -> :class:`UfsSyncPathCache` — when
  was a path (or its whole subtree) last synced, so the on-access gate can
  skip redundant UFS round-trips;
- ``file/meta/AsyncUfsAbsentPathCache.java`` -> :class:`AbsentPathCache` —
  remember UFS-absent paths so repeated misses don't hammer the store;
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Tuple


class UfsSyncPathCache:
    """LRU map path -> (last_sync_ms, recursive). A recursive sync of /a
    also freshens /a/b lookups (reference: UfsSyncPathCache.shouldSync)."""

    def __init__(self, max_size: int = 100_000) -> None:
        self._entries: "collections.OrderedDict[str, Tuple[int, bool]]" = \
            collections.OrderedDict()
        self._max = max_size
        self._lock = threading.Lock()

    def notify_synced(self, path: str, now_ms: int,
                      recursive: bool = False) -> None:
        with self._lock:
            self._entries[path] = (now_ms, recursive)
            self._entries.move_to_end(path)
            while len(self._entries) > self._max:
                self._entries.popitem(last=False)

    def last_sync_ms(self, path: str) -> int:
        """Newest applicable sync time: the path's own, or any ancestor's
        recursive sync."""
        best = 0
        with self._lock:
            entry = self._entries.get(path)
            if entry is not None:
                best = entry[0]
            p = path
            while p and p != "/":
                p = p.rsplit("/", 1)[0] or "/"
                entry = self._entries.get(p)
                if entry is not None and entry[1]:
                    best = max(best, entry[0])
        return best

    def should_sync(self, path: str, now_ms: int,
                    interval_ms: int) -> bool:
        if interval_ms < 0:
            return False
        if interval_ms == 0:
            return True
        return now_ms - self.last_sync_ms(path) >= interval_ms

    def invalidate(self, path: str) -> None:
        with self._lock:
            self._entries.pop(path, None)


class AbsentPathCache:
    """Capped TTL set of UFS paths known to be absent
    (reference: AsyncUfsAbsentPathCache)."""

    def __init__(self, max_size: int = 10_000, ttl_s: float = 60.0) -> None:
        self._entries: "collections.OrderedDict[str, float]" = \
            collections.OrderedDict()
        self._max = max_size
        self._ttl = ttl_s
        self._lock = threading.Lock()

    def add(self, path: str) -> None:
        with self._lock:
            self._entries[path] = time.monotonic()
            self._entries.move_to_end(path)
            while len(self._entries) > self._max:
                self._entries.popitem(last=False)

    def is_absent(self, path: str) -> bool:
        with self._lock:
            t = self._entries.get(path)
            if t is None:
                return False
            if time.monotonic() - t > self._ttl:
                del self._entries[path]
                return False
            return True

    def remove(self, path: str) -> None:
        """A write created the path (or an ancestor changed): forget it and
        every cached descendant."""
        prefix = path.rstrip("/") + "/"
        with self._lock:
            self._entries.pop(path, None)
            for k in [k for k in self._entries
                      if k.startswith(prefix)]:
                del self._entries[k]

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
