"""Immutable sorted-run files for the LSM metastore: a copy of
``alluxio_tpu/master/metastore/sstable.py``.

A run is a sealed memtable (or a compaction of older runs): records in
key order, followed by a sparse index (one pointer every
``INDEX_INTERVAL`` records), a bloom filter over every key, and a
msgpack footer.  Readers hold the index + bloom in memory — for a
billion-inode namespace that's the only per-run RAM cost — and serve

- point lookups: bloom check, binary-search the sparse index, then ONE
  ``os.pread`` of the interval (no shared file position, so concurrent
  readers never contend), and
- range scans: seek via the index, then stream in 1MB chunks — the
  ``children()`` range scan and compaction input path.

The writer is fully streaming (compaction merges can be far larger than
RAM): records are written as they arrive and the bloom filter — which
needs the exact key count to size itself — is built in a second,
sequential pass over the just-written file.

Tombstones (deleted keys) are vlen ``0xFFFFFFFF`` records; they must
survive until a compaction that includes the OLDEST run, else a deleted
key would resurrect from below.

Layout::

    "ATPUSST1" | records... | footer(msgpack) | u32 footer_len | "ATPUSST1"
    record = u32 klen | u32 vlen(-1 = tombstone) | key | value
"""

from __future__ import annotations

import bisect
import os
import struct
import zlib
from typing import Iterable, Iterator, Optional, Tuple

import msgpack

MAGIC = b"ATPUSST1"
INDEX_INTERVAL = 16
_REC = struct.Struct(">II")
_U32 = struct.Struct(">I")
_TOMBSTONE_LEN = 0xFFFFFFFF
_SCAN_CHUNK = 1 << 20
#: sentinel distinguishing "key absent from this run" from "key present
#: as a tombstone" (which must SHADOW older runs, not fall through)
MISSING = object()


class BloomFilter:
    """Double-hashed bloom over raw byte keys.  crc32 with two fixed
    seeds gives the pair of independent hashes (stable across processes,
    unlike ``hash(bytes)`` under PYTHONHASHSEED)."""

    def __init__(self, bits: int, k: int,
                 data: Optional[bytearray] = None) -> None:
        self.bits = max(8, bits)
        self.k = max(1, k)
        self.data = data if data is not None else \
            bytearray((self.bits + 7) // 8)

    @classmethod
    def sized_for(cls, count: int, bits_per_key: int) -> "BloomFilter":
        # k = ln(2) * bits_per_key minimizes the false-positive rate
        return cls(max(1, count) * bits_per_key,
                   max(1, int(0.69 * bits_per_key)))

    def _probes(self, key: bytes) -> Iterator[int]:
        h1 = zlib.crc32(key)
        h2 = zlib.crc32(key, 0x9E3779B9) | 1
        for i in range(self.k):
            yield (h1 + i * h2) % self.bits

    def add(self, key: bytes) -> None:
        for bit in self._probes(key):
            self.data[bit >> 3] |= 1 << (bit & 7)

    def __contains__(self, key: bytes) -> bool:
        return all(self.data[b >> 3] & (1 << (b & 7))
                   for b in self._probes(key))


def _parse_records(chunks: Iterable[bytes]) \
        -> Iterator[Tuple[bytes, Optional[bytes]]]:
    """Incrementally parse the record stream out of byte chunks."""
    buf = bytearray()
    pos = 0
    for chunk in chunks:
        buf += chunk
        while True:
            if len(buf) - pos < _REC.size:
                break
            klen, vlen = _REC.unpack_from(buf, pos)
            body = klen if vlen == _TOMBSTONE_LEN else klen + vlen
            if len(buf) - pos < _REC.size + body:
                break
            p = pos + _REC.size
            key = bytes(buf[p:p + klen])
            value = None if vlen == _TOMBSTONE_LEN \
                else bytes(buf[p + klen:p + klen + vlen])
            pos += _REC.size + body
            yield key, value
        if pos:
            del buf[:pos]
            pos = 0


def write_run(path: str,
              entries: Iterable[Tuple[bytes, Optional[bytes]]],
              *, bits_per_key: int = 10) -> None:
    """Seal ``entries`` (already key-sorted, values ``None`` for
    tombstones) into a run file.  ``entries`` may be a generator —
    compaction merges stream through here without materializing.
    Atomic: written to ``path + '.tmp'`` and renamed, so a crash
    mid-seal leaves no half-run behind."""
    tmp = path + ".tmp"
    index: list = []
    count = 0
    with open(tmp, "w+b") as f:
        f.write(MAGIC)
        off = len(MAGIC)
        for key, value in entries:
            if count % INDEX_INTERVAL == 0:
                index.append([key, off])
            if value is None:
                f.write(_REC.pack(len(key), _TOMBSTONE_LEN))
                f.write(key)
                off += _REC.size + len(key)
            else:
                f.write(_REC.pack(len(key), len(value)))
                f.write(key)
                f.write(value)
                off += _REC.size + len(key) + len(value)
            count += 1
        f.flush()
        # second pass: the bloom needs the exact key count to size
        # itself, and the keys just went to disk — reread sequentially
        bloom = BloomFilter.sized_for(count, bits_per_key)
        f.seek(len(MAGIC))

        def _chunks(remaining: int) -> Iterator[bytes]:
            while remaining > 0:
                chunk = f.read(min(_SCAN_CHUNK, remaining))
                if not chunk:
                    return
                remaining -= len(chunk)
                yield chunk

        for key, _value in _parse_records(_chunks(off - len(MAGIC))):
            bloom.add(key)
        f.seek(0, os.SEEK_END)
        footer = msgpack.packb({
            "count": count,
            "data_end": off,
            "index": index,
            "bloom": bytes(bloom.data),
            "bloom_bits": bloom.bits,
            "bloom_k": bloom.k,
        }, use_bin_type=True)
        f.write(footer)
        f.write(_U32.pack(len(footer)))
        f.write(MAGIC)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class SortedRun:
    """Open (immutable) run.  Holds a raw fd and reads with ``os.pread``
    — safe to share across threads, and safe to keep using after the
    path is unlinked by a compaction swap (POSIX keeps the inode alive
    while an fd is open)."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._fd = os.open(path, os.O_RDONLY)
        self.file_size = os.fstat(self._fd).st_size
        #: live-scan refcount + retirement flag, managed by LsmInodeStore
        #: under its lock (a compacted-away run is closed only when the
        #: last in-flight scan over it finishes)
        self.refs = 0
        self.retired = False
        tail = os.pread(self._fd, _U32.size + len(MAGIC),
                        self.file_size - _U32.size - len(MAGIC))
        if tail[_U32.size:] != MAGIC:
            raise IOError(f"corrupt run file {path!r}: bad trailer magic")
        footer_len = _U32.unpack(tail[:_U32.size])[0]
        footer_off = self.file_size - _U32.size - len(MAGIC) - footer_len
        footer = msgpack.unpackb(
            os.pread(self._fd, footer_len, footer_off), raw=False)
        self.count: int = footer["count"]
        self._data_end: int = footer["data_end"]
        self._index_keys = [k for k, _ in footer["index"]]
        self._index_offs = [o for _, o in footer["index"]]
        self._bloom = BloomFilter(footer["bloom_bits"], footer["bloom_k"],
                                  bytearray(footer["bloom"]))

    # ------------------------------------------------------------ reads
    def get(self, key: bytes):
        """Value bytes, ``None`` for a tombstone, or ``MISSING`` — via
        one pread of the containing index interval."""
        if self.count == 0 or key not in self._bloom:
            return MISSING
        i = bisect.bisect_right(self._index_keys, key) - 1
        if i < 0:
            return MISSING
        start = self._index_offs[i]
        stop = self._index_offs[i + 1] if i + 1 < len(self._index_offs) \
            else self._data_end
        blob = os.pread(self._fd, stop - start, start)
        for k, v in _parse_records((blob,)):
            if k == key:
                return v
            if k > key:
                return MISSING
        return MISSING

    def iter_from(self, start_key: bytes = b"") \
            -> Iterator[Tuple[bytes, Optional[bytes]]]:
        """Stream ``(key, value|None)`` — tombstones INCLUDED (the merge
        layer needs them to shadow older runs) — from the first key
        >= ``start_key``, in 1MB chunked preads."""
        if start_key:
            i = bisect.bisect_right(self._index_keys, start_key) - 1
            off = self._index_offs[i] if i >= 0 else len(MAGIC)
        else:
            off = len(MAGIC)

        def _chunks() -> Iterator[bytes]:
            pos = off
            while pos < self._data_end:
                n = min(_SCAN_CHUNK, self._data_end - pos)
                chunk = os.pread(self._fd, n, pos)
                if not chunk:
                    return
                pos += len(chunk)
                yield chunk

        for k, v in _parse_records(_chunks()):
            if k >= start_key:
                yield k, v

    def close(self) -> None:
        try:
            os.close(self._fd)
        except OSError:
            pass
