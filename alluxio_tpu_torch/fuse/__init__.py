"""FUSE adapter: mount the namespace as a local POSIX filesystem
(re-design of ``integration/fuse``; see ``process.py``). A copy of
``alluxio_tpu/fuse/__init__.py``."""

from alluxio_tpu_torch.fuse.fs import FuseFs  # noqa: F401

__all__ = ["FuseFs"]
