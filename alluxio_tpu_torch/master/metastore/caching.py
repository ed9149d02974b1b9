"""Write-back LRU cache over a backing store, a copy of
``alluxio_tpu/master/metastore/caching.py``
(reference: ``metastore/caching/CachingInodeStore.java:91``).

Over the LSM store this is the "hot set" layer: the working set of a
training job (the shard directories being listed and the files being
opened) stays heap-speed while the cold namespace lives in the runs.
``stats()`` surfaces hit/miss counters — the
``Master.MetastoreCacheHitRatio`` gauge — merged over the backing
store's own stats.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Tuple

from alluxio_tpu_torch.master.inode import Inode
from alluxio_tpu_torch.master.metastore.base import InodeStore


class CachingInodeStore(InodeStore):
    def __init__(self, backing: InodeStore, max_size: int = 100_000) -> None:
        self._backing = backing
        self._max = max_size
        self._cache: "OrderedDict[int, Inode]" = OrderedDict()
        self._dirty: set = set()
        self._lock = threading.RLock()
        self._hits = 0
        self._misses = 0

    @property
    def backing(self) -> InodeStore:
        return self._backing

    def get(self, inode_id: int) -> Optional[Inode]:
        with self._lock:
            if inode_id in self._cache:
                self._hits += 1
                self._cache.move_to_end(inode_id)
                return self._cache[inode_id]
            self._misses += 1
        inode = self._backing.get(inode_id)
        if inode is not None:
            with self._lock:
                self._cache[inode_id] = inode
                self._evict_locked()
        return inode

    def put(self, inode: Inode) -> None:
        with self._lock:
            self._cache[inode.id] = inode
            self._cache.move_to_end(inode.id)
            self._dirty.add(inode.id)
            self._evict_locked()

    def _evict_locked(self) -> None:
        while len(self._cache) > self._max:
            victim_id, victim = self._cache.popitem(last=False)
            if victim_id in self._dirty:
                self._backing.put(victim)
                self._dirty.discard(victim_id)

    def remove(self, inode_id: int) -> None:
        with self._lock:
            self._cache.pop(inode_id, None)
            self._dirty.discard(inode_id)
        self._backing.remove(inode_id)

    def add_child(self, parent_id: int, name: str, child_id: int) -> None:
        self._backing.add_child(parent_id, name, child_id)

    def remove_child(self, parent_id: int, name: str) -> None:
        self._backing.remove_child(parent_id, name)

    def get_child_id(self, parent_id: int, name: str) -> Optional[int]:
        return self._backing.get_child_id(parent_id, name)

    def child_names(self, parent_id: int) -> List[str]:
        return self._backing.child_names(parent_id)

    def child_count(self, parent_id: int) -> int:
        return self._backing.child_count(parent_id)

    def iter_edges(self, parent_id: int,
                   start_after: Optional[str] = None) \
            -> Iterator[Tuple[str, int]]:
        # edges write through, so the backing store's scan is authoritative
        return self._backing.iter_edges(parent_id, start_after)

    def has_children(self, parent_id: int) -> bool:
        return self._backing.has_children(parent_id)

    def iter_inodes(self) -> Iterator[Inode]:
        self.flush()
        return self._backing.iter_inodes()

    def all_ids(self) -> Iterator[int]:
        self.flush()
        return self._backing.all_ids()

    def flush(self) -> None:
        with self._lock:
            for iid in list(self._dirty):
                inode = self._cache.get(iid)
                if inode is not None:
                    self._backing.put(inode)
            self._dirty.clear()

    def clear(self) -> None:
        with self._lock:
            self._cache.clear()
            self._dirty.clear()
        self._backing.clear()

    def close(self) -> None:
        self.flush()
        self._backing.close()

    def estimated_size(self) -> int:
        self.flush()
        return self._backing.estimated_size()

    def stats(self) -> Dict[str, object]:
        # Write-back means the backing inode count excludes dirty
        # cache residents; flush so the reported counts are truthful.
        self.flush()
        out = dict(self._backing.stats())
        with self._lock:
            hits, misses = self._hits, self._misses
            out["cache_entries"] = len(self._cache)
        out["cache_hits"] = hits
        out["cache_misses"] = misses
        out["cache_hit_ratio"] = round(hits / (hits + misses), 4) \
            if hits + misses else 0.0
        out["kind"] = f"CACHING:{out.get('kind', '?')}"
        return out

    def checkpoint_state(self) -> Optional[dict]:
        self.flush()
        return self._backing.checkpoint_state()

    def restore_state(self, state: dict) -> None:
        with self._lock:
            self._cache.clear()
            self._dirty.clear()
        self._backing.restore_state(state)
