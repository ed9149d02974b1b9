"""On-heap dict-backed inode store, a copy of
``alluxio_tpu/master/metastore/heap.py`` (reference:
``heap/HeapInodeStore.java:46``) — fastest, bounded by RAM."""

from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Optional, Tuple

from alluxio_tpu_torch.master.inode import Inode
from alluxio_tpu_torch.master.metastore.base import InodeStore


class HeapInodeStore(InodeStore):
    def __init__(self) -> None:
        self._inodes: Dict[int, Inode] = {}
        self._edges: Dict[Tuple[int, str], int] = {}
        self._children: Dict[int, Dict[str, int]] = {}
        self._lock = threading.RLock()

    def get(self, inode_id: int) -> Optional[Inode]:
        with self._lock:
            return self._inodes.get(inode_id)

    def put(self, inode: Inode) -> None:
        with self._lock:
            self._inodes[inode.id] = inode

    def remove(self, inode_id: int) -> None:
        with self._lock:
            self._inodes.pop(inode_id, None)

    def add_child(self, parent_id: int, name: str, child_id: int) -> None:
        with self._lock:
            self._edges[(parent_id, name)] = child_id
            self._children.setdefault(parent_id, {})[name] = child_id

    def remove_child(self, parent_id: int, name: str) -> None:
        with self._lock:
            self._edges.pop((parent_id, name), None)
            kids = self._children.get(parent_id)
            if kids is not None:
                kids.pop(name, None)
                if not kids:
                    del self._children[parent_id]

    def get_child_id(self, parent_id: int, name: str) -> Optional[int]:
        with self._lock:
            return self._edges.get((parent_id, name))

    def child_names(self, parent_id: int) -> List[str]:
        with self._lock:
            return sorted(self._children.get(parent_id, {}).keys())

    def iter_edges(self, parent_id: int,
                   start_after: Optional[str] = None) \
            -> Iterator[Tuple[str, int]]:
        with self._lock:
            kids = sorted(self._children.get(parent_id, {}).items())
        for name, child_id in kids:
            if start_after is not None and name <= start_after:
                continue
            yield name, child_id

    def has_children(self, parent_id: int) -> bool:
        with self._lock:
            return bool(self._children.get(parent_id))

    def child_count(self, parent_id: int) -> int:
        with self._lock:
            return len(self._children.get(parent_id, {}))

    def all_ids(self) -> Iterator[int]:
        with self._lock:
            return iter(list(self._inodes.keys()))

    def clear(self) -> None:
        with self._lock:
            self._inodes.clear()
            self._edges.clear()
            self._children.clear()

    def estimated_size(self) -> int:
        with self._lock:
            return len(self._inodes)

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {"kind": "HEAP", "inodes": len(self._inodes),
                    "edges": len(self._edges)}
