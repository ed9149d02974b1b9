"""UFS factory registry + per-process UFS manager: a copy of
``alluxio_tpu/underfs/registry.py`` without its connector discovery.

Re-designs of ``underfs/UnderFileSystemFactoryRegistry.java`` (a plain
scheme-keyed registry) and ``core/server/common/.../underfs/
{UfsManager,AbstractUfsManager}.java``: mount-id-keyed cached instances (the
JAX per-UFS maintenance modes are not ported: nothing sets one).
The port registers the local UFS only (bare paths and ``file://``); the
object-store and HDFS connectors are not ported.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from alluxio_tpu_torch.underfs.base import UnderFileSystem
from alluxio_tpu_torch.underfs.local import LocalUnderFileSystem
from alluxio_tpu_torch.utils.exceptions import (NotFoundError,
                                                 NotSupportedError)

_FACTORIES: Dict[str, Callable[..., UnderFileSystem]] = {
    "": LocalUnderFileSystem,
    "file": LocalUnderFileSystem,
}


def _scheme_of(uri: str) -> str:
    if "://" in uri:
        return uri.split("://", 1)[0]
    return ""  # bare path -> local


def create_ufs(uri: str,
               properties: Optional[Dict[str, str]] = None) -> UnderFileSystem:
    factory = _FACTORIES.get(_scheme_of(uri))
    if factory is None:
        raise NotSupportedError(
            f"no UFS factory for scheme {_scheme_of(uri)!r} ({uri})")
    return factory(uri, properties)


class UfsManager:
    """Mount-id-keyed cache of UFS instances (reference: AbstractUfsManager)."""

    def __init__(self) -> None:
        self._by_mount: Dict[int, UnderFileSystem] = {}
        self._lock = threading.RLock()

    def add_mount(self, mount_id: int, ufs_uri: str,
                  properties: Optional[Dict[str, str]] = None
                  ) -> UnderFileSystem:
        with self._lock:
            if mount_id in self._by_mount:
                return self._by_mount[mount_id]
            ufs = create_ufs(ufs_uri, properties)
            self._by_mount[mount_id] = ufs
            return ufs

    def remove_mount(self, mount_id: int) -> None:
        with self._lock:
            ufs = self._by_mount.pop(mount_id, None)
        if ufs is not None:
            ufs.close()

    def get(self, mount_id: int) -> UnderFileSystem:
        with self._lock:
            ufs = self._by_mount.get(mount_id)
        if ufs is None:
            raise NotFoundError(f"no UFS for mount id {mount_id}")
        return ufs

    def has(self, mount_id: int) -> bool:
        with self._lock:
            return mount_id in self._by_mount

    def close(self) -> None:
        with self._lock:
            mounts = list(self._by_mount.values())
            self._by_mount.clear()
        for ufs in mounts:
            ufs.close()
