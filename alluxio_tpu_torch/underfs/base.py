"""Under-filesystem (UFS) SPI (a copy of ``alluxio_tpu/underfs/base.py``).

Re-design of ``core/common/src/main/java/alluxio/underfs/UnderFileSystem.java:183-742``
(create/open/delete/rename/status/fingerprint contract) +
``BaseUnderFileSystem.java``: the pluggable contract between the framework
and persistent storage (local disk, object stores, HDFS, ...).

Streams are plain Python file-like objects. The namespace operations
(delete, rename, mkdirs, listing) and the capacity and mode queries come
with the master slice, which calls them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import BinaryIO, Dict, List, Optional

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


class UnderFileSystem:
    """Abstract UFS: the part of the JAX contract the worker calls (its
    async cache and cold reads read ranges; ``persist_file`` creates a
    file and fingerprints it). Paths handed to these methods are full
    UFS URIs (e.g. ``/disk/path``)."""

    #: scheme(s) this UFS serves, e.g. ("file",) — used by the registry
    schemes: tuple = ()

    def __init__(self, root_uri: str, properties: Optional[Dict[str, str]] = None):
        self._root = root_uri
        self._properties = dict(properties or {})

    def create(self, path: str, options: Optional[CreateOptions] = None) -> BinaryIO:
        """Open a new file for writing; visible at ``path`` only on close."""
        raise NotImplementedError

    def read_range(self, path: str, offset: int, length: int) -> bytes:
        """Positioned read (one-shot pread)."""
        raise NotImplementedError

    def get_status(self, path: str) -> Optional[UfsStatus]:
        raise NotImplementedError

    def get_fingerprint(self, path: str) -> Fingerprint:
        return Fingerprint.from_status(self.get_status(path))

    def close(self) -> None:
        pass
