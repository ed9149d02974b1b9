"""Worker-side UFS manager (a copy of ``alluxio_tpu/worker/ufs_manager.py``).

Re-design of ``core/server/worker/src/main/java/alluxio/worker/underfs/
WorkerUfsManager.java``: the worker resolves mount-id -> UFS lazily by
asking the file master for its mount table (duck-typed:
``get_mount_points()`` gives entries with ``mount_id``, ``ufs_uri`` and
``properties``), then caches instances locally.
"""

from __future__ import annotations

from alluxio_tpu_torch.underfs.registry import UfsManager


class WorkerUfsManager:
    """UFS manager that learns mounts from the master on demand."""

    def __init__(self, fs_master_client) -> None:
        self._inner = UfsManager()
        self._fs = fs_master_client

    def get(self, mount_id: int):
        if not self._inner.has(mount_id):
            for mp in self._fs.get_mount_points():
                if not self._inner.has(mp.mount_id):
                    self._inner.add_mount(mp.mount_id, mp.ufs_uri,
                                          mp.properties)
        return self._inner.get(mount_id)

    def has(self, mount_id: int) -> bool:
        return self._inner.has(mount_id)

    def add_mount(self, *a, **k):
        return self._inner.add_mount(*a, **k)

    def remove_mount(self, mount_id: int) -> None:
        self._inner.remove_mount(mount_id)

    def close(self) -> None:
        self._inner.close()
