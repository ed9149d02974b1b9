"""Append-only write-ahead log for the LSM metastore: a copy of
``alluxio_tpu/master/metastore/wal.py``.

Every mutation is framed ``[u32 len][u32 crc32][msgpack (key, value)]``
and appended before it touches the memtable; replay on open rebuilds
exactly the un-flushed tail of the store.  A torn or corrupt tail record
(the kill-mid-write case) fails its CRC and replay stops there — the log
always recovers to a clean PREFIX of the appended operations, never to a
mix (property-tested in ``tests/test_torch_metastore.py``).

``sync=False`` (the default wired from ``atpu.master.metastore.lsm.
wal.sync``) buffers through the OS: in the full master the JOURNAL is
the durability root and rebuilds the metastore from its own fsynced log,
so paying a second fsync per metadata op here would double the write
cost for nothing.  Standalone embedders that want the store itself to be
crash-durable turn it on.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Iterator, Optional, Tuple

import msgpack

_HDR = struct.Struct(">II")


class WriteAheadLog:
    def __init__(self, path: str, *, sync: bool = False) -> None:
        self._path = path
        self._sync = sync
        self._f = open(path, "ab")

    @property
    def path(self) -> str:
        return self._path

    def append(self, key: bytes, value: Optional[bytes]) -> None:
        payload = msgpack.packb((key, value), use_bin_type=True)
        self._f.write(_HDR.pack(len(payload), zlib.crc32(payload)))
        self._f.write(payload)
        self._f.flush()
        if self._sync:
            os.fsync(self._f.fileno())

    def replay(self) -> Iterator[Tuple[bytes, Optional[bytes]]]:
        """Yield every intact record in append order; stop (silently) at
        the first torn/corrupt frame."""
        try:
            f = open(self._path, "rb")
        except FileNotFoundError:
            return
        with f:
            while True:
                hdr = f.read(_HDR.size)
                if len(hdr) < _HDR.size:
                    return
                length, crc = _HDR.unpack(hdr)
                payload = f.read(length)
                if len(payload) < length or zlib.crc32(payload) != crc:
                    return
                key, value = msgpack.unpackb(payload, raw=False)
                yield key, value

    def truncate(self) -> None:
        """Drop every record — called after the memtable they rebuilt was
        sealed into a sorted run."""
        self._f.truncate(0)
        self._f.seek(0)
        self._f.flush()
        if self._sync:
            os.fsync(self._f.fileno())

    def size_bytes(self) -> int:
        try:
            return os.path.getsize(self._path)
        except OSError:
            return 0

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()
