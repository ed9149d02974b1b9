"""Page-cached file stream.

The port of ``alluxio_tpu/client/cache/stream.py``: random reads are
served page-at-a-time from the local page cache, falling through to the
inner stream on a miss. Whole-block reads (``block_stream``) go to the
inner stream: the device loader bypasses the page cache, and its device
tier covers those.
"""

from __future__ import annotations

from alluxio_tpu_torch.client.cache.manager import LocalCacheManager
from alluxio_tpu_torch.client.cache.meta import PageId


class CachingFileInStream:
    """``inner`` is duck-typed: ``info.file_id``, ``length``, ``seek``,
    ``pread``, ``block_stream`` and ``close``."""

    def __init__(self, inner, cache: LocalCacheManager) -> None:
        self._inner = inner
        self._cache = cache
        self._page_size = cache.page_size
        self.info = inner.info
        self._file_key = f"{inner.info.file_id:x}"
        self._pos = 0

    @property
    def length(self) -> int:
        return self._inner.length

    def seek(self, pos: int) -> None:
        self._pos = pos
        self._inner.seek(pos)

    def tell(self) -> int:
        return self._pos

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            n = self.length - self._pos
        data = self.pread(self._pos, n)
        self._pos += len(data)
        return data

    def pread(self, offset: int, n: int) -> bytes:
        out = bytearray()
        pos = offset
        end = min(offset + n, self.length)
        while pos < end:
            page_index = pos // self._page_size
            off_in_page = pos % self._page_size
            want = min(end - pos, self._page_size - off_in_page)
            chunk = self._read_page(page_index, off_in_page, want)
            if not chunk:
                break
            out.extend(chunk)
            pos += len(chunk)
        return bytes(out)

    def _read_page(self, page_index: int, offset: int, n: int) -> bytes:
        pid = PageId(self._file_key, page_index)
        hit = self._cache.get(pid, offset, n)
        if hit is not None:
            return hit
        page_start = page_index * self._page_size
        page_len = min(self._page_size, self.length - page_start)
        if page_len <= 0:
            return b""
        page = self._inner.pread(page_start, page_len)
        self._cache.put(pid, page)
        return page[offset:offset + n]

    def block_stream(self, index: int):
        """Delegate to the inner stream (whole-block reads bypass the
        page cache)."""
        return self._inner.block_stream(index)

    def close(self) -> None:
        self._inner.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
