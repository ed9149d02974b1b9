"""Page cache key: pages are slices of a file, keyed by (file_id, index).

``PageId`` as in ``alluxio_tpu/client/cache/meta.py``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PageId:
    file_id: str
    page_index: int

    def __str__(self) -> str:
        return f"{self.file_id}#{self.page_index}"
