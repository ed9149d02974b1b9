"""Key/value codecs for the LSM metastore: a copy of
``alluxio_tpu/master/metastore/encoding.py``.

One flat, ordered byte-keyspace holds both record families (reference:
``rocks/RocksInodeStore.java`` keeps inodes and edges in two column
families; a single prefixed keyspace gives the same separation with one
set of runs):

- inode records:  ``b'i' + be64(inode_id)``          -> msgpack wire dict
- edge records:   ``b'e' + be64(parent_id) + name``  -> be64(child_id)

Big-endian fixed-width ids make byte order == numeric order, so every
edge of one directory is CONTIGUOUS and sorted by child name: the
``children()`` call the list paths hammer is a single range scan over
``edge_prefix(parent_id)``.  (``b'e' < b'i'``, so the two families never
interleave.)
"""

from __future__ import annotations

import struct
from typing import Tuple

_BE64 = struct.Struct(">Q")

INODE_PREFIX = b"i"
EDGE_PREFIX = b"e"


def inode_key(inode_id: int) -> bytes:
    return INODE_PREFIX + _BE64.pack(inode_id)


def decode_inode_key(key: bytes) -> int:
    return _BE64.unpack_from(key, 1)[0]


def edge_key(parent_id: int, name: str) -> bytes:
    return EDGE_PREFIX + _BE64.pack(parent_id) + name.encode("utf-8")


def edge_prefix(parent_id: int) -> bytes:
    return EDGE_PREFIX + _BE64.pack(parent_id)


def decode_edge_key(key: bytes) -> Tuple[int, str]:
    return _BE64.unpack_from(key, 1)[0], key[9:].decode("utf-8")


def edge_value(child_id: int) -> bytes:
    return _BE64.pack(child_id)


def decode_edge_value(value: bytes) -> int:
    return _BE64.unpack(value)[0]
