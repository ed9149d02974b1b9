"""FUSE operation handlers over the native client (a copy of
``alluxio_tpu/fuse/fs.py``).

Re-design of ``integration/fuse/src/main/java/alluxio/fuse/
AlluxioFuseFileSystem.java:52-55`` (jnr-fuse callbacks -> the master/
worker clients): the same operation semantics — sequential-only writes,
whole-file truncate, POSIX errno mapping — expressed as plain Python
methods so they are unit-testable without a kernel mount, then bridged
into ``fuse_operations`` by ``process.py``.

Returns follow the FUSE convention: >= 0 success (read/write return
byte counts), negative errno on failure.
"""

from __future__ import annotations

import errno
import logging
import stat as stat_mod
import threading
from typing import Dict, Optional, Tuple

from alluxio_tpu_torch.utils.exceptions import (
    AlluxioTpuError, DirectoryNotEmptyError, FileAlreadyExistsError,
    FileDoesNotExistError, InvalidPathError, PermissionDeniedError,
)

LOG = logging.getLogger(__name__)

_ERRNO = (
    (FileDoesNotExistError, errno.ENOENT),
    (FileAlreadyExistsError, errno.EEXIST),
    (DirectoryNotEmptyError, errno.ENOTEMPTY),
    (PermissionDeniedError, errno.EACCES),
    (InvalidPathError, errno.EINVAL),
)


def _neg_errno(e: Exception) -> int:
    for exc_type, code in _ERRNO:
        if isinstance(e, exc_type):
            return -code
    if isinstance(e, AlluxioTpuError):
        return -errno.EIO
    return -errno.EIO


class _OpenFile:
    """One open handle: a read stream, a sequential write stream, or a
    deferred write (``lazy_path``: an existing file opened writable
    without O_TRUNC — content is preserved unless a write arrives)."""

    def __init__(self, reader=None, writer=None,
                 lazy_path: Optional[str] = None) -> None:
        self.reader = reader
        self.writer = writer
        self.lazy_path = lazy_path
        self.write_pos = 0
        self.lock = threading.Lock()


class FuseFs:
    """Callback logic (kernel-independent)."""

    def __init__(self, fs, root: str = "/") -> None:
        self._fs = fs
        self._root = root.rstrip("/")
        self._handles: Dict[int, _OpenFile] = {}
        self._next_fh = 1
        self._lock = threading.Lock()

    def _path(self, fuse_path: str) -> str:
        return (self._root + fuse_path).rstrip("/") or "/"

    # -- handle table --------------------------------------------------------
    def _add(self, of: _OpenFile) -> int:
        with self._lock:
            fh = self._next_fh
            self._next_fh += 1
            self._handles[fh] = of
            return fh

    def _get(self, fh: int) -> Optional[_OpenFile]:
        with self._lock:
            return self._handles.get(fh)

    # -- metadata ------------------------------------------------------------
    def getattr(self, path: str) -> "int | Tuple[int, int, int, int]":
        """(mode, size, mtime_ms, nlink) or -errno."""
        try:
            st = self._fs.get_status(self._path(path))
        except Exception as e:  # noqa: BLE001
            return _neg_errno(e)
        if st.folder:
            return (stat_mod.S_IFDIR | 0o755, 0,
                    st.last_modification_time_ms, 2)
        return (stat_mod.S_IFREG | 0o644, st.length,
                st.last_modification_time_ms, 1)

    def readdir(self, path: str):
        """List of names or -errno."""
        try:
            infos = self._fs.list_status(self._path(path))
        except Exception as e:  # noqa: BLE001
            return _neg_errno(e)
        return [i.name for i in infos]

    def mkdir(self, path: str) -> int:
        try:
            self._fs.create_directory(self._path(path))
            return 0
        except Exception as e:  # noqa: BLE001
            return _neg_errno(e)

    def unlink(self, path: str) -> int:
        try:
            self._fs.delete(self._path(path))
            return 0
        except Exception as e:  # noqa: BLE001
            return _neg_errno(e)

    def rmdir(self, path: str) -> int:
        try:
            self._fs.delete(self._path(path))
            return 0
        except Exception as e:  # noqa: BLE001
            return _neg_errno(e)

    def rename(self, src: str, dst: str) -> int:
        try:
            self._fs.rename(self._path(src), self._path(dst))
            return 0
        except Exception as e:  # noqa: BLE001
            return _neg_errno(e)

    def truncate(self, path: str, length: int) -> int:
        """Like the reference: truncate-to-0 = delete+recreate (the
        common ``open(O_TRUNC)`` path); anything else is unsupported
        (blocks are immutable once committed)."""
        full = self._path(path)
        try:
            st = self._fs.get_status(full)
        except FileDoesNotExistError:
            return -errno.ENOENT
        except Exception as e:  # noqa: BLE001
            return _neg_errno(e)
        if length == st.length:
            return 0
        if length == 0:
            try:
                self._fs.delete(full)
                self._fs.create_file(full).close()
                return 0
            except Exception as e:  # noqa: BLE001
                return _neg_errno(e)
        return -errno.EOPNOTSUPP

    # -- data ----------------------------------------------------------------
    def open(self, path: str, write: bool) -> int:
        """fh (>0) or -errno."""
        full = self._path(path)
        try:
            if write:
                try:
                    st = self._fs.get_status(full)
                except FileDoesNotExistError:
                    # O_CREAT on a fresh path (kernels with a create
                    # callback normally route here only for existing
                    # files, but be safe)
                    return self._add(_OpenFile(
                        writer=self._fs.create_file(full)))
                if st.folder:
                    return -errno.EISDIR
                # EXISTING file, no O_TRUNC (the kernel truncates via a
                # separate truncate() call): POSIX demands the content
                # survive until something actually writes — `touch` and
                # read-only r+ opens must not wipe the file
                return self._add(_OpenFile(
                    reader=self._fs.open_file(full, info=st),
                    lazy_path=full))
            st = self._fs.get_status(full)
            if st.folder:
                return -errno.EISDIR
            return self._add(_OpenFile(
                reader=self._fs.open_file(full, info=st)))
        except Exception as e:  # noqa: BLE001
            return _neg_errno(e)

    def create(self, path: str) -> int:
        try:
            return self._add(_OpenFile(
                writer=self._fs.create_file(self._path(path))))
        except Exception as e:  # noqa: BLE001
            return _neg_errno(e)

    def read(self, fh: int, size: int, offset: int) -> "int | bytes":
        of = self._get(fh)
        if of is None or of.reader is None:
            return -errno.EBADF
        try:
            with of.lock:
                return of.reader.pread(offset, size)
        except Exception as e:  # noqa: BLE001
            return _neg_errno(e)

    def write(self, fh: int, data: bytes, offset: int) -> int:
        """Sequential-only, like the reference FUSE adapter."""
        of = self._get(fh)
        if of is None:
            return -errno.EBADF
        if of.writer is None and of.lazy_path is not None:
            # first write through a deferred handle: a full rewrite
            # from offset 0 is the one pattern blocks support
            with of.lock:
                if of.writer is None:
                    if offset != 0:
                        return -errno.EOPNOTSUPP
                    try:
                        if of.reader is not None:
                            of.reader.close()
                            of.reader = None
                        of.writer = self._fs.create_file(
                            of.lazy_path, overwrite=True)
                    except Exception as e:  # noqa: BLE001
                        return _neg_errno(e)
        if of.writer is None:
            return -errno.EBADF
        with of.lock:
            if offset != of.write_pos:
                LOG.warning("non-sequential FUSE write at %d (expected "
                            "%d)", offset, of.write_pos)
                return -errno.EOPNOTSUPP
            try:
                of.writer.write(data)
            except Exception as e:  # noqa: BLE001
                return _neg_errno(e)
            of.write_pos += len(data)
            return len(data)

    def flush(self, fh: int) -> int:
        """Called at every fd close: COMMIT a write stream here so the
        application's ``close()`` returns with the file durably visible
        (FUSE ``release`` is async — committing there races readers;
        same choice as the reference's AlluxioFuseFileSystem)."""
        of = self._get(fh)
        if of is None:
            return 0
        with of.lock:
            if of.writer is not None:
                try:
                    of.writer.close()
                except Exception as e:  # noqa: BLE001
                    return _neg_errno(e)
                of.writer = None
        return 0

    def release(self, fh: int) -> int:
        with self._lock:
            of = self._handles.pop(fh, None)
        if of is None:
            return 0
        try:
            if of.writer is not None:
                of.writer.close()
            if of.reader is not None:
                of.reader.close()
            return 0
        except Exception as e:  # noqa: BLE001
            return _neg_errno(e)

    def close_all(self) -> None:
        with self._lock:
            handles, self._handles = dict(self._handles), {}
        for of in handles.values():
            try:
                if of.writer is not None:
                    of.writer.cancel()
                if of.reader is not None:
                    of.reader.close()
            except Exception:  # noqa: BLE001
                pass
