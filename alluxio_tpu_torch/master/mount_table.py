"""Mount table: namespace path <-> UFS path mapping (a copy of
``alluxio_tpu/master/mount_table.py``).

Re-design of ``core/server/master/.../file/meta/MountTable.java:66`` (resolve
``:358``): nested mounts, read-only/shared flags, reverse resolution, and
per-mount options. State is journaled by the FileSystemMaster.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from alluxio_tpu_torch.utils.exceptions import (
    AlreadyExistsError, InvalidPathError, NotFoundError,
)
from alluxio_tpu_torch.utils.uri import SEPARATOR, AlluxioURI

ROOT = "/"


@dataclass
class MountInfo:
    mount_id: int
    alluxio_path: str
    ufs_uri: str
    read_only: bool = False
    shared: bool = False
    properties: Dict[str, str] = field(default_factory=dict)

    def to_wire(self) -> dict:
        return {"mount_id": self.mount_id, "alluxio_path": self.alluxio_path,
                "ufs_uri": self.ufs_uri, "read_only": self.read_only,
                "shared": self.shared, "properties": dict(self.properties)}

    @staticmethod
    def from_wire(d: dict) -> "MountInfo":
        return MountInfo(**d)


@dataclass
class Resolution:
    """Result of mapping a namespace path to its UFS location."""

    mount_info: MountInfo
    ufs_path: str  # full UFS uri string for this path

    @property
    def mount_id(self) -> int:
        return self.mount_info.mount_id


class MountTable:
    def __init__(self) -> None:
        self._mounts: Dict[str, MountInfo] = {}
        self._lock = threading.RLock()

    # -- mutation (called under journal application) ------------------------
    def add(self, info: MountInfo) -> None:
        path = AlluxioURI(info.alluxio_path).path
        with self._lock:
            if path in self._mounts:
                raise AlreadyExistsError(f"mount point {path} already exists")
            for existing in self._mounts.values():
                e_ufs = existing.ufs_uri.rstrip(SEPARATOR)
                n_ufs = info.ufs_uri.rstrip(SEPARATOR)
                if not existing.shared and not info.shared and (
                        e_ufs == n_ufs
                        or e_ufs.startswith(n_ufs + SEPARATOR)
                        or n_ufs.startswith(e_ufs + SEPARATOR)):
                    raise InvalidPathError(
                        f"UFS path {info.ufs_uri} overlaps existing mount "
                        f"{existing.ufs_uri}")
            self._mounts[path] = MountInfo(
                info.mount_id, path, info.ufs_uri, info.read_only,
                info.shared, dict(info.properties))

    def delete(self, alluxio_path: str) -> MountInfo:
        path = AlluxioURI(alluxio_path).path
        with self._lock:
            if path == ROOT:
                raise InvalidPathError("cannot unmount root")
            info = self._mounts.pop(path, None)
            if info is None:
                raise NotFoundError(f"no mount point at {path}")
            return info

    # -- queries ------------------------------------------------------------
    def get_mount_point(self, uri: AlluxioURI) -> Optional[str]:
        """Longest mount-point prefix covering ``uri``."""
        path = uri.path
        with self._lock:
            best: Optional[str] = None
            for mp in self._mounts:
                if AlluxioURI(mp).is_ancestor_of(uri):
                    if best is None or len(mp) > len(best):
                        best = mp
            return best

    def is_mount_point(self, uri: AlluxioURI) -> bool:
        with self._lock:
            return uri.path in self._mounts

    def is_mount_path(self, path: str) -> bool:
        """``is_mount_point`` for a plain path string (hot listing loop:
        no AlluxioURI construction per child)."""
        with self._lock:
            return path in self._mounts

    def contains_mount_below(self, uri: AlluxioURI) -> bool:
        """True if any mount point (other than at uri) is nested under uri."""
        with self._lock:
            for mp in self._mounts:
                if mp != uri.path and uri.is_ancestor_of(AlluxioURI(mp)):
                    return True
            return False

    def resolve(self, uri: AlluxioURI) -> Resolution:
        """Map a namespace path to (mount, full UFS path)
        (reference: ``MountTable.java:358``)."""
        mp = self.get_mount_point(uri)
        if mp is None:
            raise NotFoundError(f"path {uri} is not covered by any mount")
        with self._lock:
            info = self._mounts[mp]
        rel = uri.path[len(mp):].lstrip(SEPARATOR)
        base = info.ufs_uri.rstrip(SEPARATOR)
        ufs_path = f"{base}{SEPARATOR}{rel}" if rel else (
            info.ufs_uri if info.ufs_uri.endswith(SEPARATOR) or not rel
            else base)
        return Resolution(mount_info=info, ufs_path=ufs_path)

    def reverse_resolve(self, ufs_uri: str) -> Optional[AlluxioURI]:
        """Map a UFS path back into the namespace (longest-prefix mount)."""
        with self._lock:
            best: Optional[Tuple[str, MountInfo]] = None
            for mp, info in self._mounts.items():
                base = info.ufs_uri.rstrip(SEPARATOR)
                if ufs_uri == base or ufs_uri.startswith(base + SEPARATOR) or (
                        info.ufs_uri.endswith(SEPARATOR)
                        and ufs_uri.startswith(info.ufs_uri)):
                    if best is None or len(base) > len(best[1].ufs_uri.rstrip(SEPARATOR)):
                        best = (mp, info)
            if best is None:
                return None
            mp, info = best
            rel = ufs_uri[len(info.ufs_uri.rstrip(SEPARATOR)):].lstrip(SEPARATOR)
            return AlluxioURI(mp).join(rel) if rel else AlluxioURI(mp)

    def mount_points(self) -> List[MountInfo]:
        with self._lock:
            return [MountInfo(i.mount_id, i.alluxio_path, i.ufs_uri,
                              i.read_only, i.shared, dict(i.properties))
                    for i in self._mounts.values()]

    def get_by_id(self, mount_id: int) -> Optional[MountInfo]:
        with self._lock:
            for info in self._mounts.values():
                if info.mount_id == mount_id:
                    return info
            return None

    def clear(self) -> None:
        with self._lock:
            self._mounts.clear()

    # -- snapshot -----------------------------------------------------------
    def snapshot(self) -> list:
        with self._lock:
            return [i.to_wire() for i in self._mounts.values()]

    def restore(self, snap: list) -> None:
        with self._lock:
            self._mounts.clear()
            for d in snap or []:
                info = MountInfo.from_wire(d)
                self._mounts[info.alluxio_path] = info
