"""Under-filesystem (UFS) SPI (a copy of ``alluxio_tpu/underfs/base.py``).

Re-design of ``core/common/src/main/java/alluxio/underfs/UnderFileSystem.java:183-742``
(create/open/delete/rename/status/fingerprint contract) +
``BaseUnderFileSystem.java``: the pluggable contract between the framework
and persistent storage (local disk, object stores, HDFS, ...).

Differences from the reference, on purpose:
- streams are plain Python file-like objects (``read(n)``, ``write(b)``)
  plus ``open_positioned`` for stateless positioned reads — the shape the
  zero-copy TPU read path wants (pread into a staging buffer);
- the object-store base class lives in ``object_base.py`` and emulates
  directories with breadcrumb markers exactly like the reference's
  ``ObjectUnderFileSystem``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import BinaryIO, Dict, Iterator, List, Optional

from alluxio_tpu_torch.utils.fingerprint import Fingerprint


@dataclass
class UfsStatus:
    name: str  # path relative to the listed directory, or full path for status
    is_directory: bool = False
    length: int = 0
    last_modified_ms: Optional[int] = None
    owner: str = ""
    group: str = ""
    mode: Optional[int] = None
    content_hash: str = ""
    xattr: Dict[str, str] = field(default_factory=dict)

    def fingerprint(self) -> Fingerprint:
        return Fingerprint.from_status(self)


@dataclass
class CreateOptions:
    create_parent: bool = True
    ensure_atomic: bool = True  # write temp + rename, like reference's NonAtomicFileOutputStream wrapping
    owner: str = ""
    group: str = ""
    mode: int = 0o644


@dataclass
class DeleteOptions:
    recursive: bool = False


class UfsMode(enum.Enum):
    """Per-UFS maintenance mode (reference: ``UfsMode`` / master-tracked
    read-only/no-access maintenance)."""

    READ_WRITE = "READ_WRITE"
    READ_ONLY = "READ_ONLY"
    NO_ACCESS = "NO_ACCESS"


class UnderFileSystem:
    """Abstract UFS. Paths handed to these methods are full UFS URIs
    (e.g. ``/disk/path`` or ``mem://bucket/key``)."""

    #: scheme(s) this UFS serves, e.g. ("s3",) — used by the factory registry
    schemes: tuple = ()

    def __init__(self, root_uri: str, properties: Optional[Dict[str, str]] = None):
        self._root = root_uri
        self._properties = dict(properties or {})

    # -- identity -----------------------------------------------------------
    def get_underfs_type(self) -> str:
        raise NotImplementedError

    def get_root(self) -> str:
        return self._root

    # -- file IO ------------------------------------------------------------
    def create(self, path: str, options: Optional[CreateOptions] = None) -> BinaryIO:
        """Open a new file for writing; visible at ``path`` only on close."""
        raise NotImplementedError

    def open(self, path: str, offset: int = 0) -> BinaryIO:
        """Open for sequential reading starting at ``offset``."""
        raise NotImplementedError

    def read_range(self, path: str, offset: int, length: int) -> bytes:
        """Positioned read (one-shot pread); default via open()."""
        with self.open(path, offset) as f:
            return f.read(length)

    # -- namespace ops ------------------------------------------------------
    def delete_file(self, path: str) -> bool:
        raise NotImplementedError

    def delete_directory(self, path: str,
                         options: Optional[DeleteOptions] = None) -> bool:
        raise NotImplementedError

    def rename_file(self, src: str, dst: str) -> bool:
        raise NotImplementedError

    def rename_directory(self, src: str, dst: str) -> bool:
        raise NotImplementedError

    def mkdirs(self, path: str, create_parent: bool = True) -> bool:
        raise NotImplementedError

    # -- status -------------------------------------------------------------
    def exists(self, path: str) -> bool:
        return self.get_status(path) is not None

    def is_file(self, path: str) -> bool:
        s = self.get_status(path)
        return s is not None and not s.is_directory

    def is_directory(self, path: str) -> bool:
        s = self.get_status(path)
        return s is not None and s.is_directory

    def get_status(self, path: str) -> Optional[UfsStatus]:
        raise NotImplementedError

    def list_status(self, path: str) -> Optional[List[UfsStatus]]:
        """Direct children (name = relative); None if path is not a dir."""
        raise NotImplementedError

    def get_fingerprint(self, path: str) -> Fingerprint:
        return Fingerprint.from_status(self.get_status(path))

    # -- capacity / mode ----------------------------------------------------
    def get_space_total(self) -> int:
        return -1

    def get_space_used(self) -> int:
        return -1

    # -- misc ---------------------------------------------------------------
    def supports_active_sync(self) -> bool:
        """Reference: HDFS iNotify active sync (``UnderFileSystem.java:713-742``)."""
        return False

    def connect_from_master(self, hostname: str) -> None:
        pass

    def connect_from_worker(self, hostname: str) -> None:
        pass

    def cleanup(self) -> None:
        pass

    def close(self) -> None:
        pass
