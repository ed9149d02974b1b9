"""TTL bucket list: a copy of ``alluxio_tpu/master/ttl.py``.

Re-design of ``core/server/master/.../file/meta/{TtlBucket,TtlBucketList}.java``:
inodes with a TTL are hashed into coarse time buckets keyed by expiry
interval; the TTL checker heartbeat (``file/InodeTtlChecker.java``) polls
expired buckets and applies each inode's TtlAction (DELETE or FREE).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Set

DEFAULT_BUCKET_INTERVAL_MS = 60 * 60 * 1000  # 1h, reference default


class TtlBucketList:
    def __init__(self, bucket_interval_ms: int = DEFAULT_BUCKET_INTERVAL_MS):
        self._interval = bucket_interval_ms
        self._buckets: Dict[int, Set[int]] = {}
        self._expiry: Dict[int, int] = {}  # inode id -> expiry ms
        self._lock = threading.Lock()

    def _bucket_of(self, expiry_ms: int) -> int:
        return expiry_ms // self._interval

    def insert(self, inode_id: int, base_time_ms: int, ttl_ms: int) -> None:
        expiry = base_time_ms + ttl_ms
        with self._lock:
            self._expiry[inode_id] = expiry
            self._buckets.setdefault(self._bucket_of(expiry), set()).add(inode_id)

    def remove(self, inode_id: int) -> None:
        with self._lock:
            expiry = self._expiry.pop(inode_id, None)
            if expiry is None:
                return
            b = self._buckets.get(self._bucket_of(expiry))
            if b is not None:
                b.discard(inode_id)
                if not b:
                    del self._buckets[self._bucket_of(expiry)]

    def poll_expired(self, now_ms: int) -> List[int]:
        """Return (and retain) ids of inodes whose TTL has elapsed; the TTL
        checker removes them after a successful action."""
        out: List[int] = []
        with self._lock:
            for bucket_key in sorted(self._buckets):
                if bucket_key * self._interval > now_ms:
                    break
                for iid in self._buckets[bucket_key]:
                    if self._expiry.get(iid, 1 << 62) <= now_ms:
                        out.append(iid)
        return out

    def clear(self) -> None:
        with self._lock:
            self._buckets.clear()
            self._expiry.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._expiry)
