"""Master-side metadata invalidation log: the push half of the client
metadata cache (a copy of ``alluxio_tpu/master/invalidation.py``).

Every namespace mutation appends ``(version, path)`` to a bounded ring;
``GetStatus``/``ListStatus`` responses carry the log's current version as
a stamp, and clients piggyback their applied version on the metrics
heartbeat — the response returns every invalidated path-prefix since,
so a warm client cache stays coherent within one heartbeat interval
without any per-read round trip (reference: Alluxio's
``MetadataCachingBaseFileSystem`` only has TTL expiry; the push protocol
follows the self-invalidating-cache framing of Hoard, arxiv 1812.00669,
over the PR-6 conf-overlay heartbeat channel).

Protocol invariants (see docs/metadata.md):

- The stamp is read BEFORE the data under the path lock, so a response's
  payload is always at least as new as its stamp; any later mutation has
  a larger version and WILL be delivered as an invalidation.
- A client only caches a response whose stamp >= its applied version —
  an older response might predate an invalidation the client already
  consumed, and would otherwise be retained forever.
- A client whose version fell off the ring (overflow, or first contact)
  gets ``reset`` and drops its whole cache.
"""

from __future__ import annotations

import threading
from bisect import bisect_right
from typing import List, Optional, Tuple

_metrics_fn = None


def _metrics():
    global _metrics_fn
    if _metrics_fn is None:
        from alluxio_tpu_torch.metrics import metrics as _m

        _metrics_fn = _m
    return _metrics_fn()


class MetadataInvalidationLog:
    """Bounded ring of namespace invalidations, versioned monotonically.

    Entries are appended in strictly increasing version order, so a
    client's catch-up query bisects to its suffix — every heartbeat
    pays O(log n + new entries), not a scan of the whole ring under the
    lock every mutation contends on."""

    def __init__(self, capacity: int = 8192) -> None:
        self._lock = threading.Lock()
        self._capacity = max(16, capacity)
        self._entries: List[Tuple[int, str]] = []
        self._version = 0

    @property
    def version(self) -> int:
        """Current version (racy int read — monotonic, safe)."""
        return self._version

    def append(self, path: str) -> int:
        """Record that ``path`` (and, by client-side prefix semantics,
        its descendants and parent listing) changed.  Returns the new
        version."""
        with self._lock:
            self._version += 1
            self._entries.append((self._version, path))
            if len(self._entries) > 2 * self._capacity:
                # amortized trim: one O(capacity) copy per capacity
                # appends keeps append O(1) while a list stays
                # bisectable (a deque is O(n) to index)
                del self._entries[:-self._capacity]
            v = self._version
        _metrics().counter("Master.MetadataCacheInvalidations").inc()
        return v

    def restore_version(self, version: int) -> None:
        """Adopt a snapshot's version (journal component restore): the
        ring's entries are not part of the snapshot — readers below the
        floor get ``reset``, exactly as after a ring overflow."""
        with self._lock:
            self._version = int(version)
            self._entries.clear()

    def since(self, version: Optional[int]) -> dict:
        """Invalidations newer than ``version`` in wire form:
        ``{"to": v, "prefixes": [...], "reset": bool}``.  ``None`` (a
        client establishing its floor) and versions older than the ring
        both come back as ``reset`` — the client drops its cache and
        adopts ``to`` as its new applied version."""
        with self._lock:
            cur = self._version
            if version is None:
                return {"to": cur, "prefixes": [], "reset": True}
            version = int(version)
            if version > cur:
                # a version we never issued: the client tracked a
                # master that had applied MORE entries than us (e.g. a
                # deposed leader's torn, never-committed tail).  Unknown
                # horizon -> reset.
                return {"to": cur, "prefixes": [], "reset": True}
            if version == cur:
                return {"to": cur, "prefixes": [], "reset": False}
            retained = len(self._entries)
            oldest = self._entries[0][0] if retained else cur + 1
            if version < oldest - 1:
                return {"to": cur, "prefixes": [], "reset": True}
            start = bisect_right(self._entries, version,
                                 key=lambda e: e[0])
            prefixes = sorted({p for _v, p in self._entries[start:]})
            return {"to": cur, "prefixes": prefixes, "reset": False}
