"""Page cache metadata types.

A copy of ``alluxio_tpu/client/cache/meta.py``: pages are fixed-size
(default 1 MiB) slices of a file, keyed by (file_id, page_index); the
meta store tracks the cached pages and the bytes held per tier.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional


@dataclass(frozen=True)
class PageId:
    file_id: str
    page_index: int

    def __str__(self) -> str:
        return f"{self.file_id}#{self.page_index}"


@dataclass
class PageInfo:
    page_id: PageId
    page_size: int
    tier: str = "HOST"  # HBM | HOST | DISK


class PageMetaStore:
    """Tracks cached pages + per-tier usage."""

    def __init__(self) -> None:
        self._pages: Dict[PageId, PageInfo] = {}
        self._bytes_by_tier: Dict[str, int] = {}
        self._lock = threading.RLock()

    def add(self, info: PageInfo) -> None:
        with self._lock:
            old = self._pages.get(info.page_id)
            if old is not None:
                self._bytes_by_tier[old.tier] = (
                    self._bytes_by_tier.get(old.tier, 0) - old.page_size)
            self._pages[info.page_id] = info
            self._bytes_by_tier[info.tier] = (
                self._bytes_by_tier.get(info.tier, 0) + info.page_size)

    def remove(self, page_id: PageId) -> Optional[PageInfo]:
        with self._lock:
            info = self._pages.pop(page_id, None)
            if info is not None:
                self._bytes_by_tier[info.tier] = (
                    self._bytes_by_tier.get(info.tier, 0) - info.page_size)
            return info

    def get(self, page_id: PageId) -> Optional[PageInfo]:
        with self._lock:
            return self._pages.get(page_id)

    def has(self, page_id: PageId) -> bool:
        with self._lock:
            return page_id in self._pages

    def bytes_in_tier(self, tier: str) -> int:
        with self._lock:
            return self._bytes_by_tier.get(tier, 0)

    def pages_of_file(self, file_id: str) -> Iterator[PageId]:
        with self._lock:
            return iter([pid for pid in self._pages
                         if pid.file_id == file_id])

    def __len__(self) -> int:
        with self._lock:
            return len(self._pages)
