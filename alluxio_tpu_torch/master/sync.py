"""UFS metadata-sync machinery (a copy of ``alluxio_tpu/master/sync.py``).

Re-designs of the reference's sync subsystem:
- ``file/meta/UfsSyncPathCache.java`` -> :class:`UfsSyncPathCache` — when
  was a path (or its whole subtree) last synced, so the on-access gate can
  skip redundant UFS round-trips;
- ``file/meta/AsyncUfsAbsentPathCache.java`` -> :class:`AbsentPathCache` —
  remember UFS-absent paths so repeated misses don't hammer the store;
- ``file/activesync/{ActiveSyncManager.java:81,ActiveSyncer.java}`` ->
  :class:`ActiveSyncManager` — journaled sync points re-synced by a
  heartbeat. The reference rides HDFS iNotify; object stores have no event
  stream, so the master polls with fingerprint diffs (the same mechanism
  the reference falls back to on full-sync intervals).
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Dict, List, Tuple

from alluxio_tpu_torch.journal.format import EntryType
from alluxio_tpu_torch.utils.exceptions import InvalidArgumentError
from alluxio_tpu_torch.utils.uri import AlluxioURI

LOG = logging.getLogger(__name__)


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


class ActiveSyncManager:
    """Journaled sync points + the polling re-sync pass
    (reference: ``ActiveSyncManager.java:81``; the heartbeat tick is the
    ``ActiveSyncer`` equivalent, registered as MASTER_ACTIVE_UFS_SYNC)."""

    journal_name = "ActiveSyncManager"

    def __init__(self, fs_master, journal) -> None:
        self._fsm = fs_master
        self._journal = journal
        self._points: List[str] = []
        self._lock = threading.Lock()
        #: per-point stats: path -> (last_run_ms, changed_count)
        self.last_runs: Dict[str, Tuple[int, int]] = {}
        journal.register(self)

    # -- API (the file-system service's start_sync/stop_sync) ----------------
    def add_sync_point(self, path: "str | AlluxioURI") -> None:
        uri = AlluxioURI(path)
        self._fsm.get_status(uri)  # must exist (reference parity)
        with self._lock:
            if uri.path in self._points:
                return
        with self._journal.create_context() as ctx:
            ctx.append(EntryType.ADD_SYNC_POINT, {"path": uri.path})

    def remove_sync_point(self, path: "str | AlluxioURI") -> None:
        uri = AlluxioURI(path)
        with self._lock:
            if uri.path not in self._points:
                raise InvalidArgumentError(
                    f"{uri.path} is not a sync point")
        with self._journal.create_context() as ctx:
            ctx.append(EntryType.REMOVE_SYNC_POINT, {"path": uri.path})

    def sync_points(self) -> List[str]:
        with self._lock:
            return list(self._points)

    # -- the ActiveSyncer tick ----------------------------------------------
    def heartbeat(self) -> None:
        for path in self.sync_points():
            try:
                changed = self._fsm.sync_metadata(path, recursive=True)
                self.last_runs[path] = (
                    int(time.time() * 1000), int(changed))
            except Exception:  # noqa: BLE001 - keep other points alive
                LOG.exception("active sync of %s failed", path)

    # -- journal contract ----------------------------------------------------
    def process_entry(self, entry) -> bool:
        if entry.type == EntryType.ADD_SYNC_POINT:
            with self._lock:
                p = entry.payload["path"]
                if p not in self._points:
                    self._points.append(p)
            return True
        if entry.type == EntryType.REMOVE_SYNC_POINT:
            with self._lock:
                try:
                    self._points.remove(entry.payload["path"])
                except ValueError:
                    pass
            return True
        return False

    def snapshot(self) -> dict:
        with self._lock:
            return {"points": list(self._points)}

    def restore(self, snap: dict) -> None:
        with self._lock:
            self._points = list(snap.get("points", []))

    def reset_state(self) -> None:
        with self._lock:
            self._points = []
