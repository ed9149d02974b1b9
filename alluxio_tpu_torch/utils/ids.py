"""Block/file/session id schemes: a copy of ``alluxio_tpu/utils/ids.py``.

Re-design of the reference's id math (``core/common/src/main/java/alluxio/
master/block/BlockId.java`` and ``util/IdUtils.java``): a block id packs a
*container id* (shared by all blocks of one file) with a sequence number;
the file id is the container's max-sequence block id. This keeps
block -> file reverse lookups arithmetic instead of stored.
"""

from __future__ import annotations

import random
import threading
import time

SEQUENCE_BITS = 24
SEQUENCE_MASK = (1 << SEQUENCE_BITS) - 1
MAX_SEQUENCE = SEQUENCE_MASK  # reserved for "the file itself"


def block_id(container_id: int, sequence: int) -> int:
    if not 0 <= sequence <= MAX_SEQUENCE:
        raise ValueError(f"sequence out of range: {sequence}")
    return (container_id << SEQUENCE_BITS) | sequence


def container_id(bid: int) -> int:
    return bid >> SEQUENCE_BITS


def sequence_number(bid: int) -> int:
    return bid & SEQUENCE_MASK


def file_id_from_container(cid: int) -> int:
    return block_id(cid, MAX_SEQUENCE)


def file_id_for_block(bid: int) -> int:
    return file_id_from_container(container_id(bid))


def is_file_id(bid: int) -> bool:
    return sequence_number(bid) == MAX_SEQUENCE


class ContainerIdGenerator:
    """Journaled monotonically-increasing container ids."""

    def __init__(self, next_id: int = 1) -> None:
        self._next = next_id
        self._lock = threading.Lock()

    def next_container_id(self) -> int:
        with self._lock:
            cid = self._next
            self._next += 1
            return cid

    @property
    def peek(self) -> int:
        with self._lock:
            return self._next

    def restore(self, next_id: int) -> None:
        with self._lock:
            self._next = max(self._next, next_id)


_rng = random.Random()


_session_lock = threading.Lock()
_session_counter = 0


def create_session_id() -> int:
    global _session_counter
    with _session_lock:
        _session_counter += 1
        return (int(time.time() * 1000) << 20) | (_session_counter & 0xFFFFF)


def create_worker_id(host: str, port: int) -> int:
    """Random-ish but stable-per-boot worker id."""
    return _rng.getrandbits(62) | 1


def create_mount_id() -> int:
    return _rng.getrandbits(62) | 1
