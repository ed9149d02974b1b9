"""Per-block data streams: the short-circuit rung.

The port of ``alluxio_tpu/client/block_streams.py``'s ``BlockInStream``
base and ``LocalBlockInStream``: a block cached on a same-host worker is
read by mmap-ing its file and handing out a zero-copy numpy view. The
lease (the block file's path and length) is handed in; obtaining it over
the worker RPC comes with the cluster-client port.
"""

from __future__ import annotations

import mmap
from typing import Callable, Optional

import numpy as np

from alluxio_tpu_torch.metrics import metrics


def _record_read(bucket: str, nbytes: int) -> None:
    """Per-source read accounting (``Client.BytesRead.<bucket>`` /
    ``Client.BlocksRead.<bucket>``)."""
    m = metrics()
    m.counter(f"Client.BytesRead.{bucket}").inc(nbytes)
    m.counter(f"Client.BlocksRead.{bucket}").inc()


class BlockInStream:
    """Positioned reads over one block."""

    def __init__(self, block_id: int, length: int) -> None:
        self.block_id = block_id
        self.length = length
        #: raw serving source of the LAST read: a worker tier alias
        #: ("MEM"/"SSD"/...), "SHM" for short-circuit, or "UFS"
        self.last_source: Optional[str] = None

    def pread(self, offset: int, n: int) -> bytes:
        raise NotImplementedError

    def read_all(self) -> bytes:
        return self.pread(0, self.length)

    def source_bucket(self) -> str:
        """The last read's serving source as an input-doctor bucket:
        ``shm``, ``remote``, ``ufs`` or ``unknown``."""
        src = self.last_source
        if src is None:
            return "unknown"
        if src == "SHM":
            return "shm"
        if src == "UFS":
            return "ufs"
        return "remote"

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class LocalBlockInStream(BlockInStream):
    """Short-circuit: mmap a same-host worker's block file.

    ``path`` and ``length`` are the lease the worker granted; ``on_close``
    (optional) releases it."""

    def __init__(self, path: str, length: int, *, block_id: int = 0,
                 on_close: Optional[Callable[[], None]] = None) -> None:
        super().__init__(block_id, length)
        self.last_source = "SHM"
        self._path = path
        self._on_close = on_close
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, prot=mmap.PROT_READ) \
            if length > 0 else None

    def pread(self, offset: int, n: int) -> bytes:
        if self._mm is None:
            return b""
        out = self._mm[offset:offset + n]
        _record_read("shm", len(out))
        return out

    def numpy_view(self, dtype=np.uint8) -> np.ndarray:
        """Zero-copy read-only ndarray over the mmap."""
        if self._mm is None:
            return np.empty(0, dtype=dtype)
        _record_read("shm", len(self._mm))
        return np.frombuffer(self._mm, dtype=dtype)

    def close(self) -> None:
        if self._mm is not None:
            try:
                self._mm.close()
            except BufferError:
                # a numpy view is still live (e.g. a staging copy in
                # progress); leave the mapping to GC — on Linux the pages
                # stay valid even if the file is later unlinked
                pass
            self._mm = None
        self._f.close()
        if self._on_close is not None:
            on_close, self._on_close = self._on_close, None
            on_close()
