"""Page stores: where the host tier's page bytes live.

A copy of ``alluxio_tpu/client/cache/page_store.py``:

- **LocalPageStore** — one file per page under ``<root>/<file_id>/<index>``,
  the JAX package's layout byte for byte, so pages one package wrote are
  restored by the other (:meth:`LocalPageStore.restore_pages`);
- **MemPageStore** — dict-backed (tests, and a host tier without disk).

The device tier lives in ``hbm_store.py``.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Dict, Iterator, Optional, Tuple

from alluxio_tpu_torch.client.cache.meta import PageId


class PageStore:
    def put(self, page_id: PageId, data: bytes) -> None:
        raise NotImplementedError

    def get(self, page_id: PageId, offset: int = 0,
            length: int = -1) -> Optional[bytes]:
        raise NotImplementedError

    def delete(self, page_id: PageId) -> bool:
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemPageStore(PageStore):
    def __init__(self) -> None:
        self._pages: Dict[PageId, bytes] = {}
        self._lock = threading.Lock()

    def put(self, page_id: PageId, data: bytes) -> None:
        with self._lock:
            self._pages[page_id] = bytes(data)

    def get(self, page_id: PageId, offset: int = 0,
            length: int = -1) -> Optional[bytes]:
        with self._lock:
            data = self._pages.get(page_id)
        if data is None:
            return None
        end = len(data) if length < 0 else offset + length
        return data[offset:end]

    def delete(self, page_id: PageId) -> bool:
        with self._lock:
            return self._pages.pop(page_id, None) is not None


class LocalPageStore(PageStore):
    """One file per page, ``<root>/<file_id>/<page_index>``."""

    def __init__(self, root: str) -> None:
        self._root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, page_id: PageId) -> str:
        safe = page_id.file_id.replace("/", "_")
        return os.path.join(self._root, safe, str(page_id.page_index))

    def put(self, page_id: PageId, data: bytes) -> None:
        p = self._path(page_id)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = p + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, p)

    def get(self, page_id: PageId, offset: int = 0,
            length: int = -1) -> Optional[bytes]:
        p = self._path(page_id)
        try:
            fd = os.open(p, os.O_RDONLY)
        except FileNotFoundError:
            return None
        try:
            if length < 0:
                length = os.fstat(fd).st_size - offset
            return os.pread(fd, length, offset)
        finally:
            os.close(fd)

    def delete(self, page_id: PageId) -> bool:
        p = self._path(page_id)
        try:
            os.remove(p)
        except FileNotFoundError:
            return False
        d = os.path.dirname(p)
        try:
            if not os.listdir(d):
                os.rmdir(d)
        except OSError:
            pass
        return True

    def restore_pages(self) -> Iterator[Tuple[PageId, int]]:
        """Enumerate pages already on disk, as ``(page id, size)``."""
        for file_dir in os.listdir(self._root):
            fdir = os.path.join(self._root, file_dir)
            if not os.path.isdir(fdir):
                continue
            for idx in os.listdir(fdir):
                try:
                    size = os.path.getsize(os.path.join(fdir, idx))
                    yield PageId(file_dir, int(idx)), size
                except (ValueError, OSError):
                    continue

    def purge(self) -> None:
        shutil.rmtree(self._root, ignore_errors=True)
        os.makedirs(self._root, exist_ok=True)
