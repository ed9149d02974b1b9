"""Local-filesystem UFS (a copy of ``alluxio_tpu/underfs/local.py``).

Re-design of ``underfs/local/.../LocalUnderFileSystem.java`` — backs dev
deployments, tests, and the journal in single-host mode. Atomic creates go
through a temp file + rename, matching the reference's atomicity contract.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import BinaryIO, List, Optional

from alluxio_tpu_torch.underfs.base import (
    CreateOptions, DeleteOptions, UfsStatus, UnderFileSystem,
)


def _strip_scheme(path: str) -> str:
    if path.startswith("file://"):
        return path[len("file://"):]
    return path


class _AtomicWriter:
    """Write to a temp file; rename into place on close."""

    def __init__(self, final_path: str, mode: int) -> None:
        d = os.path.dirname(final_path)
        os.makedirs(d, exist_ok=True)
        fd, self._tmp = tempfile.mkstemp(prefix=".atpu_tmp_", dir=d)
        self._f = os.fdopen(fd, "wb")
        self._final = final_path
        self._mode = mode
        self.closed = False

    def write(self, b: bytes) -> int:
        return self._f.write(b)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if self.closed:
            return
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        os.chmod(self._tmp, self._mode)
        os.replace(self._tmp, self._final)
        self.closed = True

    def abort(self) -> None:
        if not self.closed:
            self._f.close()
            if os.path.exists(self._tmp):
                os.remove(self._tmp)
            self.closed = True

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:
            self.abort()
        return False


class LocalUnderFileSystem(UnderFileSystem):
    schemes = ("file", "")

    def get_underfs_type(self) -> str:
        return "local"

    def create(self, path: str, options: Optional[CreateOptions] = None) -> BinaryIO:
        opts = options or CreateOptions()
        p = _strip_scheme(path)
        if opts.ensure_atomic:
            return _AtomicWriter(p, opts.mode)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        return open(p, "wb")

    def open(self, path: str, offset: int = 0) -> BinaryIO:
        f = open(_strip_scheme(path), "rb")
        if offset:
            f.seek(offset)
        return f

    def read_range(self, path: str, offset: int, length: int) -> bytes:
        fd = os.open(_strip_scheme(path), os.O_RDONLY)
        try:
            return os.pread(fd, length, offset)
        finally:
            os.close(fd)

    def delete_file(self, path: str) -> bool:
        p = _strip_scheme(path)
        if not os.path.isfile(p):
            return False
        os.remove(p)
        return True

    def delete_directory(self, path: str,
                         options: Optional[DeleteOptions] = None) -> bool:
        p = _strip_scheme(path)
        opts = options or DeleteOptions()
        if not os.path.isdir(p):
            return False
        if opts.recursive:
            shutil.rmtree(p)
        else:
            if os.listdir(p):
                return False
            os.rmdir(p)
        return True

    def rename_file(self, src: str, dst: str) -> bool:
        s, d = _strip_scheme(src), _strip_scheme(dst)
        if not os.path.isfile(s):
            return False
        os.makedirs(os.path.dirname(d), exist_ok=True)
        os.replace(s, d)
        return True

    def rename_directory(self, src: str, dst: str) -> bool:
        s, d = _strip_scheme(src), _strip_scheme(dst)
        if not os.path.isdir(s):
            return False
        os.makedirs(os.path.dirname(d), exist_ok=True)
        os.rename(s, d)
        return True

    def mkdirs(self, path: str, create_parent: bool = True) -> bool:
        p = _strip_scheme(path)
        if os.path.exists(p):
            return False
        if create_parent:
            os.makedirs(p, exist_ok=True)
        else:
            os.mkdir(p)
        return True

    def get_status(self, path: str) -> Optional[UfsStatus]:
        p = _strip_scheme(path)
        try:
            st = os.stat(p)
        except FileNotFoundError:
            return None
        return UfsStatus(
            name=p, is_directory=os.path.isdir(p),
            length=st.st_size if not os.path.isdir(p) else 0,
            last_modified_ms=int(st.st_mtime * 1000),
            owner=str(st.st_uid), group=str(st.st_gid),
            mode=st.st_mode & 0o777,
            content_hash=f"{st.st_mtime_ns}_{st.st_size}")

    def list_status(self, path: str) -> Optional[List[UfsStatus]]:
        p = _strip_scheme(path)
        if not os.path.isdir(p):
            return None
        out = []
        for name in sorted(os.listdir(p)):
            child = self.get_status(os.path.join(p, name))
            if child is not None:
                child.name = name
                out.append(child)
        return out

    def get_space_total(self) -> int:
        st = os.statvfs(_strip_scheme(self._root) or "/")
        return st.f_blocks * st.f_frsize

    def get_space_used(self) -> int:
        st = os.statvfs(_strip_scheme(self._root) or "/")
        return (st.f_blocks - st.f_bfree) * st.f_frsize
