"""File-level streams over per-block streams: a copy of
``alluxio_tpu/client/streams.py`` over the port's block streams.

It keeps the port's two repairs of the JAX write path: a cancelled
``FileOutStream`` cancels its open block (the port's block writers abort
it on the worker rather than commit the bytes sent), and ``written`` and
the block boundaries count BYTES for any contiguous buffer, so a numpy
array wider than a byte is split and completed at its true length (the
JAX stream slices a memoryview by items). And ``block_stream`` (the
zero-copy loader's entry) waits for a source of a persisted block: a new
primary master knows no worker until the workers re-register with it, so
for that window a persisted block has neither a location nor a live
worker to read it through from the UFS. The JAX stream raises at once
there, and a loader reading through a master failover fails its epoch;
here the open retries, its locations refreshed, for up to
``NO_SOURCE_WAIT_S`` (a block with no UFS copy still fails at once).

Re-design of ``core/client/fs/src/main/java/alluxio/client/file/
{AlluxioFileInStream.java:66,AlluxioFileOutStream.java:56}``: a seekable
read stream that walks block streams (with failed-worker retry), and a
write stream that allocates a new block id per block boundary and completes
the file on close. Write types mirror the reference
(``MUST_CACHE``/``ASYNC_THROUGH``/``CACHE_THROUGH``/``THROUGH``).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Set

from alluxio_tpu_torch.client.block_store import BlockStoreClient
from alluxio_tpu_torch.client.block_streams import BlockInStream, BlockOutStream
from alluxio_tpu_torch.metrics import metrics
from alluxio_tpu_torch.rpc.clients import FsMasterClient
from alluxio_tpu_torch.utils.exceptions import (
    BlockDoesNotExistError, InvalidArgumentError, UnavailableError,
)
from alluxio_tpu_torch.utils.wire import FileBlockInfo, FileInfo


class WriteType:
    MUST_CACHE = "MUST_CACHE"
    CACHE_THROUGH = "CACHE_THROUGH"
    THROUGH = "THROUGH"
    ASYNC_THROUGH = "ASYNC_THROUGH"
    NONE = "NONE"


class ReadType:
    NO_CACHE = "NO_CACHE"
    CACHE = "CACHE"
    CACHE_PROMOTE = "CACHE_PROMOTE"


class FileInStream:
    """Seekable whole-file reader (reference: AlluxioFileInStream)."""

    #: cap on cached open per-block streams. Each open short-circuit
    #: stream holds a worker-side PIN (eviction can't unlink a mapped
    #: block), so the cap bounds unevictable blocks per stream:
    #: ``max_open_streams * open_streams_per_worker``. Workloads holding
    #: many long-lived FileInStreams (the JAX loader) pass 1.
    MAX_OPEN_STREAMS = 4

    def __init__(self, fs_master: FsMasterClient, store: BlockStoreClient,
                 info: FileInfo, *, cache: bool = True,
                 max_open_streams: Optional[int] = None) -> None:
        self._fs = fs_master
        self._store = store
        self.info = info
        self._cache = cache
        self._pos = 0
        self._block_infos: Optional[List[FileBlockInfo]] = None
        #: small LRU of OPEN per-block streams keyed by block index: a
        #: positioned-read workload hopping between blocks (random-4k
        #: over a multi-block file) must not pay a lease+mmap reopen on
        #: every block switch (reference keeps positioned-read streams
        #: cached per block the same way)
        self._streams: "dict[int, BlockInStream]" = {}
        self._max_open_streams = max_open_streams or self.MAX_OPEN_STREAMS

    # -- metadata ------------------------------------------------------------
    @property
    def length(self) -> int:
        return self.info.length

    def _blocks(self) -> List[FileBlockInfo]:
        if self._block_infos is None:
            self._block_infos = self._fs.get_file_block_info_list(
                self.info.path)
        return self._block_infos

    def _ufs_info_for(self, index: int) -> Optional[dict]:
        if not self.info.ufs_path or not self.info.persisted:
            return None
        bs = self.info.block_size_bytes
        fbi = self._blocks()[index]
        return {"ufs_path": self.info.ufs_path, "offset": index * bs,
                "length": fbi.block_info.length,
                "mount_id": self.info.mount_id}

    # -- stream protocol -----------------------------------------------------
    def seek(self, pos: int) -> None:
        if pos < 0 or pos > self.length:
            raise InvalidArgumentError(f"seek {pos} out of [0, {self.length}]")
        self._pos = pos

    def tell(self) -> int:
        return self._pos

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            n = self.length - self._pos
        self._pos, out = self._read_at(self._pos, n)
        return out

    def pread(self, offset: int, n: int) -> bytes:
        """Positioned read without moving the cursor
        (reference: positioned read, ``block_worker.proto:68``)."""
        return self._read_at(offset, n)[1]

    def _read_at(self, pos: int, n: int) -> "tuple[int, bytes]":
        # chunk list + single join: the block streams hand back
        # freshly-owned bytes (mmap slice / gRPC frame), a one-chunk
        # read returns them as-is, and a spanning read pays exactly one
        # assembly pass — the old bytearray.extend + bytes() pair cost
        # two extra full passes over the data
        chunks = []
        while n > 0 and pos < self.length:
            chunk = self._read_from_block(pos, n)
            if not chunk:
                break
            chunks.append(chunk)
            pos += len(chunk)
            n -= len(chunk)
        return pos, chunks[0] if len(chunks) == 1 else b"".join(chunks)

    _MAX_READ_ATTEMPTS = 3

    def _read_from_block(self, pos: int, n: int) -> bytes:
        bs = self.info.block_size_bytes
        index = pos // bs
        offset_in_block = pos % bs
        last_err: Optional[Exception] = None
        excluded: Set[str] = set()
        for attempt in range(self._MAX_READ_ATTEMPTS):
            if attempt:
                time.sleep(0.05 * attempt)
            try:
                stream = self._block_stream(index, exclude=excluded)
            except UnavailableError as e:
                # no source yet (commit may still be propagating to the
                # master): refresh locations and retry briefly
                last_err = e
                self._block_infos = None
                continue
            readable = stream.length - offset_in_block
            if readable <= 0:
                return b""
            try:
                t0 = time.perf_counter()
                chunk = stream.pread(offset_in_block, min(n, readable))
                # per-tier read latency: the block stream tags its
                # serving source AFTER the read (a worker may self-heal
                # a stale location into a UFS read-through mid-call)
                metrics().timer(
                    f"Client.BlockReadTime.{stream.source_bucket()}"
                ).update(time.perf_counter() - t0)
                return chunk
            except UnavailableError as e:
                # serving worker died mid-read: remember it, refresh the
                # block's locations, retry another replica / UFS fallback
                # (reference: AlluxioFileInStream failed-worker retry,
                # :94-95)
                last_err = e
                self._store.mark_failed(stream.address)
                # every cached stream to the dead worker is equally
                # doomed: drop them all, or blocks cached there would
                # each burn a failed attempt + backoff before failover
                dead = stream.address.key() if stream.address else None
                for i in [i for i, s2 in self._streams.items()
                          if s2.address is not None
                          and s2.address.key() == dead]:
                    self._drop_stream(i)
                self._drop_stream(index)
                self._block_infos = None
            except BlockDoesNotExistError as e:
                # stale location (evicted since the master's last heartbeat):
                # the worker is healthy, so don't mark it failed — exclude it
                # for this read only and retry another replica
                last_err = e
                if stream.address is not None:
                    excluded.add(stream.address.key())
                self._drop_stream(index)
                self._block_infos = None
        raise last_err  # type: ignore[misc]

    def _drop_stream(self, index: int) -> None:
        stream = self._streams.pop(index, None)
        if stream is not None:
            try:
                stream.close()
            except Exception:  # noqa: BLE001 - already broken
                pass

    def _block_stream(self, index: int,
                      exclude: Optional[Set[str]] = None) -> BlockInStream:
        cached = self._streams.get(index)
        if cached is not None:
            if not exclude or (cached.address is None or
                               cached.address.key() not in exclude):
                # LRU touch
                self._streams[index] = self._streams.pop(index)
                return cached
            self._drop_stream(index)
        while len(self._streams) >= self._max_open_streams:
            self._drop_stream(next(iter(self._streams)))
        fbi = self._blocks()[index]
        stream = self._store.open_block(
            fbi, ufs_info=self._ufs_info_for(index),
            cache_cold_reads=self._cache, exclude=exclude)
        self._streams[index] = stream
        return stream

    #: seconds ``block_stream`` waits for a persisted block's source
    NO_SOURCE_WAIT_S = 15.0

    def block_stream(self, index: int) -> BlockInStream:
        """Expose the per-block stream — the zero-copy loader uses this to
        mmap whole blocks instead of byte-copy reads. A persisted block
        that no worker can serve yet (no location, no live worker: a
        master failover before the workers re-registered) is retried
        with its locations refreshed, backing off from 50 ms to 1 s, for
        up to ``NO_SOURCE_WAIT_S``."""
        deadline = time.monotonic() + self.NO_SOURCE_WAIT_S
        delay = 0.05
        while True:
            try:
                return self._block_stream(index)
            except UnavailableError:
                if self._ufs_info_for(index) is None or \
                        time.monotonic() + delay > deadline:
                    raise
            self._block_infos = None
            time.sleep(delay)
            delay = min(1.0, 2 * delay)

    def pread_ranges(self, ranges: "List[tuple]", *,
                     route_stats: Optional[Dict[str, int]] = None
                     ) -> List[bytes]:
        """Scatter/gather positioned reads over a list of ``(offset,
        length)`` file ranges — the range-list entry point of the
        ``choose_route`` ladder (docs/table_reads.md). Ranges are split
        at block boundaries, grouped per block, and each block group is
        served by the best transport in ONE pass: same-host SHM blocks
        hand back zero-copy ``memoryview`` slices, wire-crossing groups
        ride ``pread_many`` (small ops coalesce into ``read_many``
        scatter batches through the native plan executor, large ops take
        the striped plane) — instead of one RPC per seek.

        Results come back in request order as buffer objects (``bytes``
        or ``memoryview``); a range past EOF truncates exactly like
        :meth:`pread`. Any block-group failure falls back to the per-op
        :meth:`pread` path, which carries the failed-worker retry
        ladder — the router can only make reads faster, never fail them.
        ``route_stats``: optional dict the served byte counts are added
        into, keyed by route (``shm``/``batch``/``striped``/``stream``).
        """
        from alluxio_tpu_torch.client.remote_read import choose_route

        bs = self.info.block_size_bytes or self.length or 1
        # split ranges at block boundaries: (block, off_in_block, n,
        # range_index) preserving request order within each range
        by_block: "Dict[int, List[tuple]]" = {}
        parts_per_range: List[List[Optional[bytes]]] = []
        for r_i, (off, n) in enumerate(ranges):
            off = max(0, int(off))
            n = max(0, min(int(n), self.length - off))
            slots: List[Optional[bytes]] = []
            while n > 0:
                index = off // bs
                off_in_block = off % bs
                take = min(n, bs - off_in_block)
                by_block.setdefault(index, []).append(
                    (off_in_block, take, r_i, len(slots)))
                slots.append(None)
                off += take
                n -= take
            parts_per_range.append(slots)
        rt = self._store.remote_read
        striped_conf = rt.conf if rt is not None and rt.enabled else None
        batch_conf = getattr(self._store, "batch_read", None)
        for index in sorted(by_block):
            ops = by_block[index]
            try:
                stream = self._block_stream(index)
                if hasattr(stream, "pread_view"):
                    # same-host SHM segment: every op is a zero-copy view
                    for off_in_block, take, r_i, slot in ops:
                        view = stream.pread_view(off_in_block, take)
                        parts_per_range[r_i][slot] = view
                        self._note_route(route_stats, "shm", len(view))
                    continue
                outs = stream.pread_many([o[0] for o in ops],
                                         [o[1] for o in ops])
            except Exception:  # noqa: BLE001 - per-op ladder handles retry
                outs = [self.pread(index * bs + o[0], o[1]) for o in ops]
            for (off_in_block, take, r_i, slot), out in zip(ops, outs):
                parts_per_range[r_i][slot] = out
                self._note_route(
                    route_stats,
                    choose_route(take, batch=batch_conf,
                                 batch_ops=len(ops),
                                 striped=striped_conf), len(out))
        out: List[bytes] = []
        for slots in parts_per_range:
            if not slots:
                out.append(b"")
            elif len(slots) == 1:
                out.append(slots[0])
            else:
                out.append(b"".join(slots))
        return out

    @staticmethod
    def _note_route(route_stats: Optional[Dict[str, int]], route: str,
                    nbytes: int) -> None:
        if route_stats is not None:
            route_stats[route] = route_stats.get(route, 0) + nbytes

    def close(self) -> None:
        for index in list(self._streams):
            self._drop_stream(index)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class FileOutStream:
    """Whole-file writer (reference: AlluxioFileOutStream)."""

    def __init__(self, fs_master: FsMasterClient, store: BlockStoreClient,
                 info: FileInfo, *, write_type: str = WriteType.ASYNC_THROUGH,
                 tier: str = "", pinned: bool = False) -> None:
        self._fs = fs_master
        self._store = store
        self.info = info
        self._write_type = write_type
        self._tier = tier
        self._pinned = pinned
        self._block_size = info.block_size_bytes
        self._current: Optional[BlockOutStream] = None
        self._current_written = 0
        self._block_ids: List[int] = []
        self.written = 0
        self._closed = False
        #: sticky writer target: all blocks of one stream land on one worker
        self._worker_address = None

    def write(self, data: bytes) -> int:
        if self._closed:
            raise InvalidArgumentError("stream closed")
        view = memoryview(data)
        if view.ndim != 1 or view.itemsize != 1:
            view = view.cast("B")  # count and split by bytes
        while len(view) > 0:
            if self._current is None:
                block_id = self._fs.get_new_block_id(self.info.path)
                self._current = self._store.open_block_writer(
                    block_id, size_hint=self._block_size,
                    tier=self._tier, pinned=self._pinned,
                    preferred=self._worker_address)
                self._worker_address = self._store.last_write_address
                self._block_ids.append(block_id)
                self._current_written = 0
            room = self._block_size - self._current_written
            chunk = view[:room]
            # writers take buffers: the local path hands the view to
            # BufferedWriter as-is, the gRPC path re-chunks and owns its
            # copies — a bytes() here would re-copy every written byte
            self._current.write(chunk)
            self._current_written += len(chunk)
            self.written += len(chunk)
            view = view[len(chunk):]
            if self._current_written >= self._block_size:
                self._current.close()
                self._current = None
        return len(data)

    def cancel(self) -> None:
        if self._current is not None:
            self._current.close(cancel=True)
            self._current = None
        self._closed = True
        self._fs.delete(self.info.path)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._current is not None:
            self._current.close()
            self._current = None
        self._fs.complete_file(self.info.path, length=self.written)
        if self._write_type == WriteType.ASYNC_THROUGH:
            self._fs.schedule_async_persistence(self.info.path)
        elif self._write_type in (WriteType.THROUGH, WriteType.CACHE_THROUGH):
            self._persist_sync()
            if self._write_type == WriteType.THROUGH:
                # THROUGH keeps no cached copy (reference semantics)
                self._fs.free(self.info.path, forced=True)

    def _persist_sync(self) -> None:
        """Synchronous persist via the worker holding the cached blocks
        (reference: CACHE_THROUGH's UfsFileWriteHandler path; here the
        worker-side persist executor writes the UFS file in one shot).
        Uses the same temp-path + master-commit protocol as async persist
        so a concurrent delete can never leave a zombie UFS file."""
        st = self._fs.get_status(self.info.path)
        if not st.ufs_path:
            return
        worker = self._store.last_write_worker
        if worker is None:
            return
        if not self._block_ids:  # zero-byte file
            self._fs.commit_persist(self.info.path, "",
                                    expected_id=st.file_id)
            return
        import uuid

        d, _, name = st.ufs_path.rpartition("/")
        temp_ufs = f"{d}/.atpu_persist.{name}.{uuid.uuid4().hex[:8]}"
        worker.persist_file(temp_ufs, self._block_ids, st.mount_id)
        self._fs.commit_persist(self.info.path, temp_ufs,
                                expected_id=st.file_id)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is not None:
            self.cancel()
        else:
            self.close()
        return False

