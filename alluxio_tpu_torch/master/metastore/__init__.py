"""Pluggable inode/block metadata stores: the part of
``alluxio_tpu/master/metastore/`` the port has.

Re-design of ``core/server/master/.../metastore/``: the reference offers
HEAP (on-heap maps, ``heap/HeapInodeStore.java:46``), ROCKS (off-heap
JNI) and rocks+write-back-cache. The JAX package adds SQLITE, LSM and
CACHING backends on the same ``InodeStore`` contract (``base.py``); the
port has **HeapInodeStore** (dicts, the JAX default) and brings the
others with the metastore-backends slice.

Edges (parent_id, child_name) -> child_id are first-class, as in the
reference's ``InodeStore#getChild``; every store serves them in name
order through the ``iter_edges`` iterator contract (``base.py``).
"""

from __future__ import annotations

from alluxio_tpu_torch.master.metastore.base import InodeStore
from alluxio_tpu_torch.master.metastore.heap import HeapInodeStore
from alluxio_tpu_torch.utils.exceptions import InvalidArgumentError

__all__ = [
    "InodeStore",
    "HeapInodeStore",
    "create_inode_store",
]

#: the JAX package's other kinds, which the port does not have yet
_LATER = ("SQLITE", "LSM", "CACHING")


def create_inode_store(kind: str, directory: str) -> InodeStore:
    """Factory keyed by ``atpu.master.metastore``. ``HEAP`` gives the
    heap store; every other kind raises :class:`InvalidArgumentError`
    (the JAX factory's typed error for a kind it does not know)."""
    base = (kind or "").strip().upper().partition(":")[0]
    if base == "HEAP":
        return HeapInodeStore()
    if base in _LATER:
        raise InvalidArgumentError(
            f"metastore kind {kind!r} comes with the metastore-backends "
            "slice of the port (SQLITE, LSM, CACHING); use HEAP")
    raise InvalidArgumentError(
        f"unknown metastore kind {kind!r} "
        "(expected HEAP, SQLITE, LSM, CACHING or CACHING:<backing>)")
