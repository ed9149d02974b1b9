"""Journal entry encoding: a copy of ``alluxio_tpu/journal/format.py``.

Re-design of the reference's journal-entry union
(``core/transport/src/main/proto/proto/journal/{journal,file,block,meta}.proto``)
and segment format (``core/server/common/.../journal/ufs/UfsJournalLogWriter``):
entries are ``(sequence, type, payload-dict)`` records, framed as
``[u32 length][u32 crc32][msgpack bytes]``. The crc makes torn tail writes
detectable so replay can stop cleanly at the last durable record — the same
contract the reference gets from its protobuf delimited stream + length
checks.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from typing import Any, BinaryIO, Dict, Iterator

import msgpack

_HEADER = struct.Struct("<II")  # length, crc32


def map_or_read(f: BinaryIO):
    """A contiguous view of a log file: mmap when possible (zero heap
    copy on multi-GB recovery), ``f.read()`` fallback (pipes, empty
    files — mmapping zero bytes raises). The two paths would disagree
    for a pre-seeked file (mmap maps from 0, read() from ``tell()``),
    so callers must pass freshly-opened or rewound files — checked
    here (when the stream can tell at all) rather than papered over
    with a sliced view the cleanup sites couldn't ``close()``."""
    import mmap

    if f.seekable() and f.tell() != 0:
        raise ValueError("map_or_read requires position 0 "
                         "(pre-seeked file would decode differently "
                         "on the mmap vs read() path)")
    try:
        return mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    except (ValueError, OSError):
        return f.read()


def iter_frames(data: bytes) -> "Iterator[tuple]":
    """Yield ``(body_offset, body_length)`` for each valid
    ``[u32 len][u32 crc32][body]`` frame in ``data``; stops cleanly at
    the torn tail (short header/body, zero-length zero-padding guard,
    or CRC mismatch). The ONE framing scanner for every log in the
    system — ``native.scan_frames``, zero-copy with no per-frame
    allocations when the library is built, its counted plain path
    otherwise."""
    from alluxio_tpu_torch import native

    yield from native.scan_frames(data)[0]


class EntryType:
    """Catalog of journal entry types (union members in the reference's
    ``journal.proto``). String-typed for forward compatibility."""

    # file.proto equivalents
    INODE_FILE = "inode_file"
    INODE_DIRECTORY = "inode_directory"
    NEW_BLOCK = "new_block"
    UPDATE_INODE = "update_inode"
    UPDATE_INODE_FILE = "update_inode_file"
    COMPLETE_FILE = "complete_file"
    DELETE_FILE = "delete_file"
    RENAME = "rename"
    SET_ACL = "set_acl"
    SET_ATTRIBUTE = "set_attribute"
    ADD_MOUNT_POINT = "add_mount_point"
    DELETE_MOUNT_POINT = "delete_mount_point"
    PERSIST_FILE = "persist_file"
    ASYNC_PERSIST_REQUEST = "async_persist_request"
    UPDATE_UFS_MODE = "update_ufs_mode"
    #: client-cache invalidation with no metadata entry of its own
    #: (block-location drift: worker loss/quarantine, re-replication,
    #: free) — journaled so the invalidation-log version stays a pure
    #: function of the applied journal on primary AND standbys
    #: (docs/ha.md)
    INVALIDATE_PATH = "invalidate_path"
    # block.proto equivalents
    BLOCK_CONTAINER_ID = "block_container_id"
    BLOCK_INFO = "block_info"
    DELETE_BLOCK = "delete_block"
    # meta.proto equivalents
    CLUSTER_INFO = "cluster_info"
    PATH_PROPERTIES = "path_properties"
    REMOVE_PATH_PROPERTIES = "remove_path_properties"
    # file.proto active-sync equivalents
    ADD_SYNC_POINT = "add_sync_point"
    REMOVE_SYNC_POINT = "remove_sync_point"
    # table.proto equivalents
    ATTACH_DB = "attach_db"
    DETACH_DB = "detach_db"
    ADD_TABLE = "add_table"
    REMOVE_TABLE = "remove_table"
    ADD_TRANSFORM_JOB_INFO = "add_transform_job_info"
    REMOVE_TRANSFORM_JOB_INFO = "remove_transform_job_info"


@dataclass
class JournalEntry:
    sequence: int
    type: str
    payload: Dict[str, Any] = field(default_factory=dict)

    def encode(self) -> bytes:
        body = msgpack.packb((self.sequence, self.type, self.payload),
                             use_bin_type=True)
        return _HEADER.pack(len(body), zlib.crc32(body)) + body

    @staticmethod
    def decode_stream(f: BinaryIO) -> Iterator["JournalEntry"]:
        """Yield entries until EOF or a torn/corrupt record (clean stop)."""
        data = map_or_read(f)
        try:
            for off, length in iter_frames(data):
                seq, etype, payload = msgpack.unpackb(
                    data[off:off + length], raw=False)
                yield JournalEntry(seq, etype, payload)
        finally:
            if hasattr(data, "close"):
                data.close()


class Journaled:
    """A state-machine component whose mutations flow through the journal
    (reference: ``journal/Journaled.java``). Components must be
    deterministic: ``process_entry`` replayed in sequence order rebuilds
    exactly the same state."""

    #: stable name used to namespace checkpoint snapshots
    journal_name: str = ""

    def process_entry(self, entry: JournalEntry) -> bool:
        """Apply one entry; return False if the type is not ours."""
        raise NotImplementedError

    def snapshot(self) -> Dict[str, Any]:
        """Serialize full state for a checkpoint."""
        raise NotImplementedError

    def restore(self, snap: Dict[str, Any]) -> None:
        """Reset state from a checkpoint snapshot."""
        raise NotImplementedError

    def reset_state(self) -> None:
        self.restore(self._empty_snapshot())

    def _empty_snapshot(self) -> Dict[str, Any]:
        return {}
