"""pyarrow FileSystem adapter: the namespace as a first-class Arrow FS (a
copy of ``alluxio_tpu/client/arrow_fs.py``).

Re-design of the reference's HDFS-compatible client
(``core/client/hdfs/src/main/java/alluxio/hadoop/AbstractFileSystem.java:80``
— the Hadoop ``FileSystem`` SPI that lets Spark/Hive/Presto address
``alluxio://`` paths) for the Python data stack: an
``pyarrow.fs.FileSystemHandler`` over the native client, so
``pyarrow.dataset`` / ``pyarrow.parquet`` / pandas / Dask address
``atpu`` paths with true random-access reads (positioned ``pread``
against cached blocks, not a buffered byte stream).

Usage::

    fs = arrow_file_system("localhost:19998")
    pq.write_table(table, "warehouse/t.parquet", filesystem=fs)
    ds.dataset("warehouse", filesystem=fs).to_table()
"""

from __future__ import annotations

from datetime import datetime, timezone
from typing import List, Optional

from alluxio_tpu_torch.utils.exceptions import (
    FileAlreadyExistsError, FileDoesNotExistError,
)


def _require_pyarrow():
    try:
        import pyarrow.fs as pafs
    except ImportError as e:  # pragma: no cover - baked into the image
        raise RuntimeError("pyarrow is required for the Arrow FS "
                           "adapter") from e
    return pafs


def _norm(path: str) -> str:
    from alluxio_tpu_torch.utils.uri import AlluxioURI

    # AlluxioURI strips scheme+authority and normalizes ('..', '//')
    return AlluxioURI(path.strip()).path


class _InputFile:
    """Random-access reader pyarrow wraps via ``PythonFile``: ``read``
    serves from the positioned ``pread`` path so parquet footer/column
    seeks hit cached blocks directly."""

    def __init__(self, stream, length: int) -> None:
        self._s = stream
        self._len = length
        self._pos = 0
        self.closed = False

    def size(self) -> int:
        return self._len

    def readable(self) -> bool:
        return True

    def writable(self) -> bool:
        return False

    def seekable(self) -> bool:
        return True

    def tell(self) -> int:
        return self._pos

    def seek(self, offset: int, whence: int = 0) -> int:
        if whence == 1:
            offset += self._pos
        elif whence == 2:
            offset += self._len
        self._pos = max(0, min(offset, self._len))
        return self._pos

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            n = self._len - self._pos
        data = self._s.pread(self._pos, n)
        self._pos += len(data)
        return data

    def flush(self) -> None:
        pass

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            self._s.close()


class _OutputFile:
    """Sequential writer over ``FileOutStream``."""

    def __init__(self, stream) -> None:
        self._s = stream
        self._pos = 0
        self.closed = False

    def writable(self) -> bool:
        return True

    def readable(self) -> bool:
        return False

    def seekable(self) -> bool:
        return False

    def tell(self) -> int:
        return self._pos

    def write(self, data) -> int:
        data = bytes(data)
        self._s.write(data)
        self._pos += len(data)
        return len(data)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            self._s.close()


def _handler_class():
    """Build the handler class lazily (subclassing
    ``pyarrow.fs.FileSystemHandler`` imports pyarrow)."""
    pafs = _require_pyarrow()

    class AlluxioTpuArrowHandler(pafs.FileSystemHandler):
        """``FileSystemHandler`` over the native ``FileSystem`` client."""

        def __init__(self, fs) -> None:
            self._fs = fs

        # -- identity --------------------------------------------------------
        def get_type_name(self) -> str:
            return "atpu"

        def normalize_path(self, path: str) -> str:
            return _norm(path)

        def __eq__(self, other) -> bool:
            return isinstance(other, AlluxioTpuArrowHandler) and \
                other._fs is self._fs

        def __ne__(self, other) -> bool:
            return not self.__eq__(other)

        # -- info ------------------------------------------------------------
        def _info(self, path: str):
            from pyarrow.fs import FileInfo, FileType

            path = _norm(path)
            try:
                st = self._fs.get_status(path)
            except FileDoesNotExistError:
                return FileInfo(path, FileType.NotFound)
            mtime = datetime.fromtimestamp(
                st.last_modification_time_ms / 1000.0, tz=timezone.utc)
            if st.folder:
                return FileInfo(path, FileType.Directory, mtime=mtime)
            return FileInfo(path, FileType.File, size=st.length,
                            mtime=mtime)

        def get_file_info(self, paths: List[str]):
            return [self._info(p) for p in paths]

        def get_file_info_selector(self, selector):
            from pyarrow.fs import FileInfo, FileType

            base = _norm(selector.base_dir)
            try:
                infos = self._fs.list_status(
                    base, recursive=selector.recursive)
            except FileDoesNotExistError:
                if selector.allow_not_found:
                    return []
                raise FileNotFoundError(base)
            out = []
            for st in infos:
                mtime = datetime.fromtimestamp(
                    st.last_modification_time_ms / 1000.0,
                    tz=timezone.utc)
                if st.folder:
                    out.append(FileInfo(st.path, FileType.Directory,
                                        mtime=mtime))
                else:
                    out.append(FileInfo(st.path, FileType.File,
                                        size=st.length, mtime=mtime))
            return out

        # -- directories -----------------------------------------------------
        def create_dir(self, path: str, recursive: bool) -> None:
            try:
                self._fs.create_directory(_norm(path), recursive=recursive,
                                          allow_exists=True)
            except FileAlreadyExistsError:
                pass

        def delete_dir(self, path: str) -> None:
            self._fs.delete(_norm(path), recursive=True)

        def delete_dir_contents(self, path: str,
                                missing_dir_ok: bool = False) -> None:
            path = _norm(path)
            if path == "/":
                raise ValueError(
                    "delete_dir_contents('/') is forbidden; use "
                    "delete_root_dir_contents")
            try:
                children = self._fs.list_status(path)
            except FileDoesNotExistError:
                if missing_dir_ok:
                    return
                raise FileNotFoundError(path)
            for st in children:
                self._fs.delete(st.path, recursive=True)

        def delete_root_dir_contents(self) -> None:
            for st in self._fs.list_status("/"):
                self._fs.delete(st.path, recursive=True)

        # -- files -----------------------------------------------------------
        def delete_file(self, path: str) -> None:
            path = _norm(path)
            try:
                st = self._fs.get_status(path)
            except FileDoesNotExistError:
                raise FileNotFoundError(path)
            if st.folder:
                raise IsADirectoryError(path)
            self._fs.delete(path)

        def move(self, src: str, dest: str) -> None:
            self._fs.rename(_norm(src), _norm(dest))

        def copy_file(self, src: str, dest: str) -> None:
            with self._fs.open_file(_norm(src)) as fin:
                out = self._fs.create_file(_norm(dest), overwrite=True)
                with out:
                    pos = 0
                    while True:
                        chunk = fin.pread(pos, 4 << 20)
                        if not chunk:
                            break
                        out.write(chunk)
                        pos += len(chunk)

        # -- streams ---------------------------------------------------------
        def open_input_stream(self, path: str):
            import pyarrow as pa

            return pa.PythonFile(self._open_reader(path), mode="r")

        def open_input_file(self, path: str):
            import pyarrow as pa

            return pa.PythonFile(self._open_reader(path), mode="r")

        def _open_reader(self, path: str) -> _InputFile:
            path = _norm(path)
            try:
                st = self._fs.get_status(path)
            except FileDoesNotExistError:
                raise FileNotFoundError(path)
            if st.folder:
                raise IsADirectoryError(path)
            return _InputFile(self._fs.open_file(path, info=st), st.length)

        def open_output_stream(self, path: str, metadata=None):
            import pyarrow as pa

            out = self._fs.create_file(_norm(path), overwrite=True)
            return pa.PythonFile(_OutputFile(out), mode="w")

        def open_append_stream(self, path: str, metadata=None):
            raise NotImplementedError(
                "append is not supported (blocks are immutable once "
                "committed; rewrite the file instead)")

    return AlluxioTpuArrowHandler


def arrow_file_system(master: Optional[str] = None, *, fs=None, conf=None):
    """An ``pyarrow.fs.PyFileSystem`` over the namespace.

    Pass either a live client ``fs`` or a ``master`` address (plus
    optional ``conf``) to own one.
    """
    pafs = _require_pyarrow()
    if fs is None:
        from alluxio_tpu_torch.client.file_system import FileSystem

        fs = FileSystem(master, conf=conf)
    handler = _handler_class()(fs)
    return pafs.PyFileSystem(handler)
