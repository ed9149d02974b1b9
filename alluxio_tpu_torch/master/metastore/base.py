"""``InodeStore`` — the contract every metastore backend implements (a
copy of ``alluxio_tpu/master/metastore/base.py``).

Beyond the original point ops, the contract now carries an ITERATOR
surface (``iter_edges`` / ``iter_inodes`` / ``has_children``) so list
paths can stream a directory page-by-page instead of materializing it:
``InodeTree.children()`` and the ListStatus paged path ride
``iter_edges``, which LSM serves as a single range scan and SQLite as an
ordered SELECT.  The base-class defaults keep third-party stores working
unchanged (they synthesize the iterators from ``child_names`` +
``get_child_id``).

Stores that can snapshot themselves faster than an inode-by-inode dump
(LSM: sealed runs + WAL position) override ``checkpoint_state`` /
``restore_state``; ``InodeTree.snapshot`` delegates when available.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

from alluxio_tpu_torch.master.inode import Inode


class InodeStore:
    def get(self, inode_id: int) -> Optional[Inode]:
        raise NotImplementedError

    def put(self, inode: Inode) -> None:
        raise NotImplementedError

    def remove(self, inode_id: int) -> None:
        raise NotImplementedError

    def add_child(self, parent_id: int, name: str, child_id: int) -> None:
        raise NotImplementedError

    def remove_child(self, parent_id: int, name: str) -> None:
        raise NotImplementedError

    def get_child_id(self, parent_id: int, name: str) -> Optional[int]:
        raise NotImplementedError

    def child_names(self, parent_id: int) -> List[str]:
        raise NotImplementedError

    def child_count(self, parent_id: int) -> int:
        return len(self.child_names(parent_id))

    def all_ids(self) -> Iterator[int]:
        raise NotImplementedError

    def clear(self) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def flush(self) -> None:
        pass

    def estimated_size(self) -> int:
        raise NotImplementedError

    # -------------------------------------------------- iterator contract
    def iter_edges(self, parent_id: int,
                   start_after: Optional[str] = None) \
            -> Iterator[Tuple[str, int]]:
        """Children of ``parent_id`` as ``(name, child_id)`` in name
        order, starting strictly after ``start_after`` — the resumable
        cursor paged listings hand back to the client."""
        for name in self.child_names(parent_id):
            if start_after is not None and name <= start_after:
                continue
            child_id = self.get_child_id(parent_id, name)
            if child_id is not None:
                yield name, child_id

    def iter_inodes(self) -> Iterator[Inode]:
        for inode_id in self.all_ids():
            inode = self.get(inode_id)
            if inode is not None:
                yield inode

    def has_children(self, parent_id: int) -> bool:
        """Cheap emptiness probe — delete paths need "any child at all?",
        not the full (possibly millions-long) name list."""
        return next(self.iter_edges(parent_id), None) is not None

    # ------------------------------------------------------ observability
    def stats(self) -> Dict[str, object]:
        return {"kind": type(self).__name__, "inodes": self.estimated_size()}

    # ------------------------------------------------- native checkpoints
    def checkpoint_state(self) -> Optional[dict]:
        """Store-native checkpoint payload, or ``None`` if the store has
        no cheaper representation than an inode-by-inode dump."""
        return None

    def restore_state(self, state: dict) -> None:
        raise NotImplementedError(
            f"{type(self).__name__} has no native checkpoint format")
