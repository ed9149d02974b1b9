"""HDFS UFS connector via pyarrow's libhdfs binding (a copy of
``alluxio_tpu/underfs/hdfs.py``).

Re-design of ``underfs/hdfs/src/main/java/alluxio/underfs/hdfs/
HdfsUnderFileSystem.java:80``: this build rides ``pyarrow.fs.
HadoopFileSystem`` (JNI libhdfs) instead of the Hadoop Java client.
Requires a Hadoop native installation (``HADOOP_HOME``/``CLASSPATH``) at
runtime; the factory registers only when pyarrow can load it. Active sync
(the reference's iNotify path, ``UnderFileSystem.java:713-742``) is
exposed as poll-based change detection via content fingerprints — see
``master/sync.py``.
"""

from __future__ import annotations

import urllib.parse
from typing import BinaryIO, Dict, List, Optional

from pyarrow import fs as pafs  # gates factory registration when absent

from alluxio_tpu_torch.underfs.base import (
    CreateOptions, DeleteOptions, UfsStatus, UnderFileSystem,
)


class HdfsUnderFileSystem(UnderFileSystem):
    """``hdfs://namenode:port/...``."""

    schemes = ("hdfs",)

    def __init__(self, root_uri: str,
                 properties: Optional[Dict[str, str]] = None) -> None:
        super().__init__(root_uri, properties)
        parsed = urllib.parse.urlsplit(root_uri)
        props = properties or {}
        self._fs = pafs.HadoopFileSystem(  # raises if libhdfs missing
            host=parsed.hostname or "default",
            port=parsed.port or 8020,
            user=props.get("hdfs.user") or None,
            replication=int(props.get("hdfs.replication", 3)))

    def _p(self, path: str) -> str:
        if "://" in path:
            return urllib.parse.urlsplit(path).path or "/"
        return path

    def get_underfs_type(self) -> str:
        return "hdfs"

    def create(self, path: str,
               options: Optional[CreateOptions] = None) -> BinaryIO:
        return self._fs.open_output_stream(self._p(path))

    def open(self, path: str, offset: int = 0) -> BinaryIO:
        f = self._fs.open_input_file(self._p(path))
        if offset:
            f.seek(offset)
        return f

    def read_range(self, path: str, offset: int, length: int) -> bytes:
        with self._fs.open_input_file(self._p(path)) as f:
            return f.read_at(length, offset)

    def delete_file(self, path: str) -> bool:
        self._fs.delete_file(self._p(path))
        return True

    def delete_directory(self, path: str,
                         options: Optional[DeleteOptions] = None) -> bool:
        opts = options or DeleteOptions()
        if not opts.recursive and (self.list_status(path) or []):
            return False
        self._fs.delete_dir(self._p(path))
        return True

    def rename_file(self, src: str, dst: str) -> bool:
        self._fs.move(self._p(src), self._p(dst))
        return True

    rename_directory = rename_file

    def mkdirs(self, path: str, create_parent: bool = True) -> bool:
        self._fs.create_dir(self._p(path), recursive=create_parent)
        return True

    def _to_status(self, info, name: str) -> UfsStatus:
        return UfsStatus(
            name=name,
            is_directory=info.type == pafs.FileType.Directory,
            length=info.size or 0,
            last_modified_ms=int(info.mtime.timestamp() * 1000)
            if info.mtime else None)

    def get_status(self, path: str) -> Optional[UfsStatus]:
        info = self._fs.get_file_info(self._p(path))
        if info.type == pafs.FileType.NotFound:
            return None
        return self._to_status(info, path)

    def list_status(self, path: str) -> Optional[List[UfsStatus]]:
        base = self._p(path)
        info = self._fs.get_file_info(base)
        if info.type != pafs.FileType.Directory:
            return None
        sel = pafs.FileSelector(base, recursive=False)
        return [self._to_status(i, i.base_name)
                for i in self._fs.get_file_info(sel)]
