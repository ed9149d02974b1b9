"""Inode records: a copy of ``alluxio_tpu/master/inode.py``.

Re-design of ``core/server/master/.../file/meta/{MutableInodeFile,
MutableInodeDirectory}.java`` + ``InodeTreePersistentState``: plain mutable
dataclasses, fully msgpack-serializable so the same representation backs the
heap store, journal entries and checkpoints. TTL semantics mirror
``file/meta/TtlBucket``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from alluxio_tpu_torch.utils import ids

NO_PARENT = -1
NO_TTL = -1


class PersistenceState:
    NOT_PERSISTED = "NOT_PERSISTED"
    TO_BE_PERSISTED = "TO_BE_PERSISTED"
    PERSISTED = "PERSISTED"
    LOST = "LOST"


class TtlAction:
    DELETE = "DELETE"
    FREE = "FREE"


@dataclass
class Inode:
    id: int = 0
    parent_id: int = NO_PARENT
    name: str = ""
    is_directory: bool = False
    creation_time_ms: int = 0
    last_modification_time_ms: int = 0
    last_access_time_ms: int = 0
    owner: str = ""
    group: str = ""
    mode: int = 0o755
    pinned: bool = False
    pinned_media: List[str] = field(default_factory=list)
    ttl: int = NO_TTL
    ttl_action: str = TtlAction.DELETE
    persistence_state: str = PersistenceState.NOT_PERSISTED
    #: an ASYNC_THROUGH persist was pending when the file went LOST;
    #: recovery must restore TO_BE_PERSISTED, not drop the durability
    #: request (journaled via SET_ATTRIBUTE so it replays)
    lost_pending_persist: bool = False
    ufs_fingerprint: str = ""
    xattr: Dict[str, str] = field(default_factory=dict)

    # file-only
    block_size_bytes: int = 0
    length: int = 0
    completed: bool = False
    cacheable: bool = True
    block_ids: List[int] = field(default_factory=list)
    replication_min: int = 0
    replication_max: int = -1
    temp_ufs_path: str = ""

    # directory-only
    mount_point: bool = False
    direct_children_loaded: bool = False

    @staticmethod
    def new_directory(inode_id: int, parent_id: int, name: str, *,
                      owner: str = "", group: str = "", mode: int = 0o755,
                      now_ms: Optional[int] = None) -> "Inode":
        now = now_ms if now_ms is not None else int(time.time() * 1000)
        return Inode(id=inode_id, parent_id=parent_id, name=name,
                     is_directory=True, creation_time_ms=now,
                     last_modification_time_ms=now, last_access_time_ms=now,
                     owner=owner, group=group, mode=mode)

    @staticmethod
    def new_file(container_id: int, parent_id: int, name: str, *,
                 block_size_bytes: int, owner: str = "", group: str = "",
                 mode: int = 0o644, ttl: int = NO_TTL,
                 ttl_action: str = TtlAction.DELETE,
                 replication_min: int = 0, replication_max: int = -1,
                 now_ms: Optional[int] = None) -> "Inode":
        now = now_ms if now_ms is not None else int(time.time() * 1000)
        return Inode(id=ids.file_id_from_container(container_id),
                     parent_id=parent_id, name=name, is_directory=False,
                     creation_time_ms=now, last_modification_time_ms=now,
                     last_access_time_ms=now, owner=owner, group=group,
                     mode=mode, block_size_bytes=block_size_bytes, ttl=ttl,
                     ttl_action=ttl_action, replication_min=replication_min,
                     replication_max=replication_max)

    @property
    def container_id(self) -> int:
        return ids.container_id(self.id)

    def next_block_id(self) -> int:
        """Id for the next sequential block of this file."""
        return ids.block_id(self.container_id, len(self.block_ids))

    def to_wire_dict(self) -> Dict[str, Any]:
        # hand-rolled shallow copy: dataclasses.asdict deep-recurses
        # through every field (~29 helper calls per inode) and was the
        # third-largest CPU item in master create profiles; the only
        # mutable fields needing a copy are the three containers
        d = dict(self.__dict__)
        d["pinned_media"] = list(d["pinned_media"])
        d["xattr"] = dict(d["xattr"])
        d["block_ids"] = list(d["block_ids"])
        return d

    @staticmethod
    def from_wire_dict(d: Dict[str, Any]) -> "Inode":
        return Inode(**d)
