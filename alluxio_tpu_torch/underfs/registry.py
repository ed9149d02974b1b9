"""UFS factory registry + per-process UFS manager (a copy of
``alluxio_tpu/underfs/registry.py``).

Re-designs of ``underfs/UnderFileSystemFactoryRegistry.java`` (ServiceLoader
discovery -> here a plain scheme-keyed registry with entry-point-style
``register`` calls) and the UFS managers
(``core/server/common/.../underfs/{UfsManager,AbstractUfsManager}.java``):
mount-id-keyed cached instances shared by master/worker/job processes.

One difference from the JAX registry, on purpose: an optional connector's
module is imported when a URI of one of its schemes is first created (or
``supported_schemes()`` is asked), not when the registry is imported.
They bring ``requests`` and ``pyarrow``, and every master makes its root
UFS at boot: a master or worker whose mounts are local or ``mem://``
imports none of them. What a caller observes is JAX's: the same schemes,
and a factory registered by the caller replaces an optional one.
``UfsManager`` keeps JAX's per-UFS maintenance modes
(``set_ufs_mode``/``get_ufs_mode``, READ_WRITE by default); as in JAX,
nothing in the master applies one yet.
"""

from __future__ import annotations

import importlib
import threading
from typing import Callable, Dict, Optional, Tuple

from alluxio_tpu_torch.underfs.base import UfsMode, UnderFileSystem
from alluxio_tpu_torch.underfs.local import LocalUnderFileSystem
from alluxio_tpu_torch.underfs.object_base import MemUnderFileSystem
from alluxio_tpu_torch.utils.exceptions import (NotFoundError,
                                                 NotSupportedError)

_FACTORIES: Dict[str, Callable[..., UnderFileSystem]] = {}
_LOCK = threading.Lock()


#: optional connectors: (module, factory name, schemes). JAX's table
#: leaves some schemes to the class's own ``schemes`` attribute; here each
#: is written out, since the module is not imported to read it. hdfs needs
#: a working pyarrow and so registers only where it imports.
_OPTIONAL_CONNECTORS = (
    ("alluxio_tpu_torch.underfs.web", "WebUnderFileSystem", ("http", "https")),
    ("alluxio_tpu_torch.underfs.s3", "S3UnderFileSystem", ("s3", "s3a")),
    ("alluxio_tpu_torch.underfs.gcs", "GcsUnderFileSystem", ("gs", "gcs")),
    # oss/cos/kodo dispatch by dialect: the vendor's NATIVE auth when
    # <vendor>.dialect=native, the S3-compatible gateway otherwise
    ("alluxio_tpu_torch.underfs.s3_compat", "create_oss_ufs", ("oss",)),
    ("alluxio_tpu_torch.underfs.s3_compat", "create_cos_ufs",
     ("cos", "cosn")),
    ("alluxio_tpu_torch.underfs.s3_compat", "create_kodo_ufs", ("kodo",)),
    # swift dispatches by dialect: Keystone-native when swift.auth.url
    # is set, S3-middleware gateway otherwise (underfs/swift.py)
    ("alluxio_tpu_torch.underfs.swift", "create_swift_ufs", ("swift",)),
    ("alluxio_tpu_torch.underfs.s3_compat", "ObsUnderFileSystem", ("obs",)),
    ("alluxio_tpu_torch.underfs.azure", "WasbUnderFileSystem",
     ("wasb", "wasbs")),
    ("alluxio_tpu_torch.underfs.azure", "AdlsUnderFileSystem",
     ("abfs", "abfss", "adl")),
    ("alluxio_tpu_torch.underfs.ozone", "OzoneUnderFileSystem",
     ("o3fs", "ofs")),
    ("alluxio_tpu_torch.underfs.hdfs", "HdfsUnderFileSystem", ("hdfs",)),
    # REST dialect of the hdfs family: stdlib-only, always registers
    ("alluxio_tpu_torch.underfs.webhdfs", "WebHdfsUnderFileSystem",
     ("webhdfs",)),
)

#: scheme -> (module, factory name) of an optional connector not imported
#: yet; an entry leaves on its first lookup, or when the caller registers
#: the scheme itself
_UNRESOLVED: Dict[str, Tuple[str, str]] = {
    scheme: (module, name)
    for module, name, schemes in _OPTIONAL_CONNECTORS for scheme in schemes}


def register_factory(scheme: str, factory: Callable[..., UnderFileSystem]) -> None:
    with _LOCK:
        _UNRESOLVED.pop(scheme, None)
        _FACTORIES[scheme] = factory


def _factory(scheme: str) -> Optional[Callable[..., UnderFileSystem]]:
    """The scheme's factory, importing its optional connector on the
    first lookup; None where there is none or its deps are absent.
    Called with ``_LOCK`` held."""
    if scheme in _UNRESOLVED:
        module, name = _UNRESOLVED.pop(scheme)
        try:
            _FACTORIES[scheme] = getattr(importlib.import_module(module), name)
        except Exception:  # noqa: BLE001 - dep absent: skip connector
            pass
    return _FACTORIES.get(scheme)


def _scheme_of(uri: str) -> str:
    if "://" in uri:
        return uri.split("://", 1)[0]
    return ""  # bare path -> local


def create_ufs(uri: str, properties: Optional[Dict[str, str]] = None) -> UnderFileSystem:
    scheme = _scheme_of(uri)
    with _LOCK:
        factory = _factory(scheme)
    if factory is None:
        raise NotSupportedError(f"no UFS factory for scheme {scheme!r} ({uri})")
    return factory(uri, properties)


def supported_schemes() -> Tuple[str, ...]:
    with _LOCK:
        for scheme in list(_UNRESOLVED):
            _factory(scheme)
        return tuple(sorted(_FACTORIES))


# built-ins (reference: ServiceLoader META-INF/services entries per connector)
register_factory("", LocalUnderFileSystem)
register_factory("file", LocalUnderFileSystem)
register_factory("mem", MemUnderFileSystem)


class UfsManager:
    """Mount-id-keyed cache of UFS instances (reference: AbstractUfsManager)."""

    def __init__(self) -> None:
        self._by_mount: Dict[int, UnderFileSystem] = {}
        self._modes: Dict[str, UfsMode] = {}  # ufs root -> mode
        self._lock = threading.RLock()

    def add_mount(self, mount_id: int, ufs_uri: str,
                  properties: Optional[Dict[str, str]] = None) -> UnderFileSystem:
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

    # -- maintenance mode (reference: MasterUfsManager ufs modes) ----------
    def set_ufs_mode(self, ufs_root: str, mode: UfsMode) -> None:
        with self._lock:
            self._modes[ufs_root] = mode

    def get_ufs_mode(self, ufs_root: str) -> UfsMode:
        with self._lock:
            return self._modes.get(ufs_root, UfsMode.READ_WRITE)

    def close(self) -> None:
        with self._lock:
            mounts = list(self._by_mount.values())
            self._by_mount.clear()
        for ufs in mounts:
            ufs.close()
