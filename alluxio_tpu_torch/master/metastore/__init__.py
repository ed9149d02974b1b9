"""Pluggable inode/block metadata stores: a copy of
``alluxio_tpu/master/metastore/__init__.py``.

Re-design of ``core/server/master/.../metastore/``: the reference offers
HEAP (on-heap maps, ``heap/HeapInodeStore.java:46``), ROCKS (off-heap
JNI, ``rocks/RocksInodeStore.java:60``) and rocks+write-back-cache
(``caching/CachingInodeStore.java:91``). Here:

- **HeapInodeStore** — dicts; fastest, bounded by RAM.
- **SqliteInodeStore** — stdlib ``sqlite3`` as a spill-to-disk store,
  WAL mode.
- **LsmInodeStore** — the capacity backend in the RocksDB role: WAL +
  memtable + bloom-filtered sorted runs + size-tiered compaction
  (``lsm.py``); RAM holds only the hot set and per-run filters, the
  namespace lives under ``atpu.master.metastore.dir``.
- **CachingInodeStore** — LRU write-back cache in front of any backing
  store, flushing evicted dirty entries.

Edges (parent_id, child_name) -> child_id are first-class, as in the
reference's ``InodeStore#getChild``; every store serves them in name
order through the ``iter_edges`` iterator contract (``base.py``).

``create_inode_store`` is keyed by ``atpu.master.metastore``: ``HEAP``,
``SQLITE``, ``LSM`` (caching-wrapped by default — the hot set is part of
the design), bare ``CACHING`` (over SQLITE, the historical meaning), or
an explicit composition ``CACHING:SQLITE`` / ``CACHING:LSM`` /
``CACHING:HEAP``.
"""

from __future__ import annotations

from typing import Optional

from alluxio_tpu_torch.master.metastore.base import InodeStore
from alluxio_tpu_torch.master.metastore.caching import CachingInodeStore
from alluxio_tpu_torch.master.metastore.heap import HeapInodeStore
from alluxio_tpu_torch.master.metastore.lsm import LsmInodeStore
from alluxio_tpu_torch.master.metastore.sqlite import SqliteInodeStore
from alluxio_tpu_torch.utils.exceptions import InvalidArgumentError

__all__ = [
    "InodeStore",
    "HeapInodeStore",
    "SqliteInodeStore",
    "LsmInodeStore",
    "CachingInodeStore",
    "create_inode_store",
]


def _create_base(kind: str, directory: str,
                 lsm_options: Optional[dict]) -> InodeStore:
    if kind == "HEAP":
        return HeapInodeStore()
    if kind == "SQLITE":
        return SqliteInodeStore(directory)
    if kind == "LSM":
        return LsmInodeStore(directory, **(lsm_options or {}))
    raise InvalidArgumentError(
        f"unknown metastore kind {kind!r} "
        "(expected HEAP, SQLITE, LSM, CACHING or CACHING:<backing>)")


def create_inode_store(kind: str, directory: str,
                       cache_size: int = 100_000,
                       lsm_options: Optional[dict] = None) -> InodeStore:
    """Factory keyed by ``atpu.master.metastore``.  Unknown kinds raise
    :class:`InvalidArgumentError` (a typed error the conf layer and RPC
    surfaces already translate), not a bare ``ValueError``."""
    k = (kind or "").strip().upper()
    base, _, backing = k.partition(":")
    if base == "CACHING":
        # bare CACHING keeps its historical meaning: LRU over SQLITE
        return CachingInodeStore(
            _create_base(backing or "SQLITE", directory, lsm_options),
            cache_size)
    if base == "LSM":
        # the hot set is part of the LSM design: point lookups that
        # matter (the training job's working set) stay heap-speed
        return CachingInodeStore(
            _create_base("LSM", directory, lsm_options), cache_size)
    return _create_base(base, directory, lsm_options)
