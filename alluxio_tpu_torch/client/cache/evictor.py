"""Page-cache evictors (LRU, LFU).

A copy of ``alluxio_tpu/client/cache/evictor.py``: the evictor nominates
victims in policy order; the store vetoes the ones it cannot evict.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Optional

from alluxio_tpu_torch.client.cache.meta import PageId


class CacheEvictor:
    def update_on_get(self, page_id: PageId) -> None:
        raise NotImplementedError

    def update_on_put(self, page_id: PageId) -> None:
        raise NotImplementedError

    def update_on_delete(self, page_id: PageId) -> None:
        raise NotImplementedError

    def evict_matching(self, pred) -> Optional[PageId]:
        """First victim IN POLICY ORDER satisfying ``pred`` — lets a
        caller skip pages it cannot evict (e.g. pinned) without
        abandoning the policy."""
        raise NotImplementedError

    @staticmethod
    def create(kind: str) -> "CacheEvictor":
        k = kind.upper()
        if k == "LRU":
            return LRUCacheEvictor()
        if k == "LFU":
            return LFUCacheEvictor()
        raise ValueError(f"unknown evictor {kind}")


class LRUCacheEvictor(CacheEvictor):
    def __init__(self) -> None:
        self._order: "OrderedDict[PageId, None]" = OrderedDict()
        self._lock = threading.Lock()

    def update_on_get(self, page_id: PageId) -> None:
        with self._lock:
            if page_id in self._order:
                self._order.move_to_end(page_id)

    def update_on_put(self, page_id: PageId) -> None:
        with self._lock:
            self._order[page_id] = None
            self._order.move_to_end(page_id)

    def update_on_delete(self, page_id: PageId) -> None:
        with self._lock:
            self._order.pop(page_id, None)

    def evict_matching(self, pred) -> Optional[PageId]:
        with self._lock:
            return next((p for p in self._order if pred(p)), None)


class LFUCacheEvictor(CacheEvictor):
    def __init__(self) -> None:
        self._counts: Dict[PageId, int] = {}
        self._lock = threading.Lock()

    def update_on_get(self, page_id: PageId) -> None:
        with self._lock:
            if page_id in self._counts:
                self._counts[page_id] += 1

    def update_on_put(self, page_id: PageId) -> None:
        with self._lock:
            self._counts[page_id] = self._counts.get(page_id, 0) + 1

    def update_on_delete(self, page_id: PageId) -> None:
        with self._lock:
            self._counts.pop(page_id, None)

    def evict_matching(self, pred) -> Optional[PageId]:
        with self._lock:
            cands = [p for p in self._counts if pred(p)]
            return min(cands, key=self._counts.get) if cands else None
