"""Delegating UFS wrapper + sleep-injecting subclass (a copy of
``alluxio_tpu/underfs/delegating.py``).

Re-designs of the reference's test doubles, shipped in-package because
operators use them for fault drills too:
``tests/src/test/java/alluxio/testutils/underfs/delegating/
DelegatingUnderFileSystem.java`` (intercept any UFS op) and
``.../underfs/sleeping/SleepingUnderFileSystem.java:38`` (per-op
configurable sleeps to simulate a slow object store).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from alluxio_tpu_torch.underfs.base import UnderFileSystem


class DelegatingUnderFileSystem(UnderFileSystem):
    """Forwards every op to a wrapped UFS; subclass and override to
    intercept."""

    def __init__(self, delegate: UnderFileSystem) -> None:
        super().__init__(delegate.get_root(), {})
        self._ufs = delegate

    def get_underfs_type(self):
        return self._ufs.get_underfs_type()

    def create(self, path, options=None):
        return self._ufs.create(path, options)

    def open(self, path, offset=0):
        return self._ufs.open(path, offset)

    def read_range(self, path, offset, length):
        return self._ufs.read_range(path, offset, length)

    def delete_file(self, path):
        return self._ufs.delete_file(path)

    def delete_directory(self, path, options=None):
        return self._ufs.delete_directory(path, options)

    def rename_file(self, src, dst):
        return self._ufs.rename_file(src, dst)

    def rename_directory(self, src, dst):
        return self._ufs.rename_directory(src, dst)

    def mkdirs(self, path, create_parent=True):
        return self._ufs.mkdirs(path, create_parent)

    def get_status(self, path):
        return self._ufs.get_status(path)

    def list_status(self, path):
        return self._ufs.list_status(path)

    def get_fingerprint(self, path):
        return self._ufs.get_fingerprint(path)

    def get_space_total(self):
        return self._ufs.get_space_total()

    def get_space_used(self):
        return self._ufs.get_space_used()

    def supports_active_sync(self):
        return self._ufs.supports_active_sync()

    def close(self):
        self._ufs.close()


class SleepingUnderFileSystem(DelegatingUnderFileSystem):
    """Injects per-op sleeps (reference: SleepingUnderFileSystemOptions):
    ``sleeps={"open": 0.5, "list_status": 1.0}`` delays those ops."""

    def __init__(self, delegate: UnderFileSystem,
                 sleeps: Optional[Dict[str, float]] = None) -> None:
        super().__init__(delegate)
        self.sleeps = dict(sleeps or {})
        self.op_counts: Dict[str, int] = {}

    def _nap(self, op: str) -> None:
        self.op_counts[op] = self.op_counts.get(op, 0) + 1
        s = self.sleeps.get(op, 0.0)
        if s > 0:
            time.sleep(s)

    def create(self, path, options=None):
        self._nap("create")
        return super().create(path, options)

    def open(self, path, offset=0):
        self._nap("open")
        return super().open(path, offset)

    def read_range(self, path, offset, length):
        self._nap("read_range")
        return super().read_range(path, offset, length)

    def delete_file(self, path):
        self._nap("delete_file")
        return super().delete_file(path)

    def delete_directory(self, path, options=None):
        self._nap("delete_directory")
        return super().delete_directory(path, options)

    def rename_file(self, src, dst):
        self._nap("rename_file")
        return super().rename_file(src, dst)

    def rename_directory(self, src, dst):
        self._nap("rename_directory")
        return super().rename_directory(src, dst)

    def mkdirs(self, path, create_parent=True):
        self._nap("mkdirs")
        return super().mkdirs(path, create_parent)

    def get_status(self, path):
        self._nap("get_status")
        return super().get_status(path)

    def list_status(self, path):
        self._nap("list_status")
        return super().list_status(path)
