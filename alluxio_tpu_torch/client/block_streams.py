"""Per-block data streams: the port of
``alluxio_tpu/client/block_streams.py``.

Re-design of ``core/client/fs/src/main/java/alluxio/client/block/stream/
{BlockInStream.java:97,LocalFileDataReader.java:41,GrpcDataReader.java:49,
LocalFileDataWriter,GrpcDataWriter}.java``:

- ``LocalBlockInStream`` — block cached on a same-host worker: lease the
  file path (``open_local_block``) and mmap it; zero RPC per byte, and a
  zero-copy numpy view for the host -> device copy. The lease (the
  worker's shared block lock) is held until :meth:`close`.
- ``GrpcBlockInStream`` — cached on a remote worker, or cold with a UFS
  descriptor the worker reads through: gRPC chunk streams; a read larger
  than one stripe rides the striped plane (``client/remote_read.py``)
  and a batch of small reads one ``read_many`` RPC.
- ``LocalBlockOutStream`` / ``GrpcBlockOutStream`` — the write side:
  a short-circuit temp-file write committed by RPC, or a client stream.

The same-host SHM stream is ``client/shm_transport.py``'s, and the
ladder that picks among them is ``client/block_store.py``.
"""

from __future__ import annotations

import mmap
import os
import queue
import socket
import threading
from concurrent import futures
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np

from alluxio_tpu_torch import native
from alluxio_tpu_torch.client import fastpath
from alluxio_tpu_torch.client.remote_read import (
    MAX_POOLED_CHANNELS, GrpcReadSource, choose_route,
)
from alluxio_tpu_torch.metrics import metrics
from alluxio_tpu_torch.utils.exceptions import UnavailableError


def _record_read(bucket: str, nbytes: int) -> None:
    """Per-source read accounting (``Client.BytesRead.<bucket>`` /
    ``Client.BlocksRead.<bucket>``)."""
    m = metrics()
    m.counter(f"Client.BytesRead.{bucket}").inc(nbytes)
    m.counter(f"Client.BlocksRead.{bucket}").inc()


class BatchReadConf(NamedTuple):
    """Scatter/gather coalescing knobs (``atpu.user.batch.read.*``)."""

    enabled: bool = True
    max_op_bytes: int = 64 << 10
    max_ops: int = 256
    #: scatter read_many responses through the native plan executor
    #: (``atpu.user.native.fastpath.enabled``); the Python path gives
    #: the same bytes
    native_fastpath: bool = True

    @classmethod
    def from_conf(cls, conf) -> "BatchReadConf":
        from alluxio_tpu_torch.conf import Keys

        return cls(
            enabled=conf.get_bool(Keys.USER_BATCH_READ_ENABLED),
            max_op_bytes=conf.get_bytes(Keys.USER_BATCH_READ_MAX_OP_BYTES),
            max_ops=max(1, conf.get_int(Keys.USER_BATCH_READ_MAX_OPS)),
            native_fastpath=conf.get_bool(
                Keys.USER_NATIVE_FASTPATH_ENABLED))


def is_local_worker(address, local_hostname: str) -> bool:
    """Same-host check gate for the short-circuit and SHM rungs: the
    worker's host is this one and its shm dir a real local directory."""
    if address.host not in (local_hostname, "localhost", "127.0.0.1",
                            socket.gethostname()):
        return False
    return bool(address.shm_dir) and os.path.isdir(address.shm_dir)


class BlockInStream:
    """Positioned reads over one block."""

    def __init__(self, block_id: int, length: int) -> None:
        self.block_id = block_id
        self.length = length
        #: serving worker (set by BlockStoreClient); failed-worker retry
        #: marks it when a read dies mid-stream
        self.address = None
        #: the rung of BlockStoreClient's ladder that opened this
        #: stream: "shm", "lease", "remote" or "ufs" (None outside it)
        self.rung: Optional[str] = None
        #: raw serving source of the LAST read: a worker tier alias
        #: ("MEM"/"SSD"/...), "SHM" for short-circuit, or "UFS"
        self.last_source: Optional[str] = None

    def pread(self, offset: int, n: int) -> bytes:
        raise NotImplementedError

    def read_all(self) -> bytes:
        return self.pread(0, self.length)

    def pread_many(self, offsets: Sequence[int],
                   sizes: Sequence[int]) -> List[bytes]:
        """Scatter/gather: N positioned reads, results in request order.
        The base implementation is the per-op loop; transports that can
        coalesce override it with the same results."""
        return [self.pread(off, n) for off, n in zip(offsets, sizes)]

    def memoryview(self) -> Optional[memoryview]:
        """Zero-copy view when the source is local; None otherwise."""
        return None

    @property
    def source(self) -> str:
        raise NotImplementedError

    def source_bucket(self) -> str:
        """The last read's serving source as an input-doctor bucket:
        ``shm``, ``remote``, ``ufs`` or ``unknown``."""
        src = self.last_source
        if src is None:
            return "unknown"
        if src == "SHM":
            return "shm"
        if src == "UFS":
            return "ufs"
        return "remote"

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class LocalBlockInStream(BlockInStream):
    """Short-circuit: mmap the worker's block file via a path lease
    (reference: ``LocalFileDataReader.java:41``). ``worker`` is a
    ``WorkerClient``; the lease is released in :meth:`close`."""

    source = "LOCAL"

    def __init__(self, worker, session_id: int, block_id: int) -> None:
        lease = worker.open_local_block(session_id, block_id)
        self._worker = worker
        self._session = session_id
        self._on_close: Optional[Callable[[], None]] = None
        self._map(lease["path"], lease["length"], block_id)

    @classmethod
    def from_path(cls, path: str, length: int, *, block_id: int = 0,
                  on_close: Optional[Callable[[], None]] = None
                  ) -> "LocalBlockInStream":
        """A stream over a block file whose lease the caller holds by
        other means; ``on_close`` (optional) releases it."""
        self = cls.__new__(cls)
        self._worker = None
        self._session = 0
        self._on_close = on_close
        self._map(path, length, block_id)
        return self

    def _map(self, path: str, length: int, block_id: int) -> None:
        BlockInStream.__init__(self, block_id, length)
        self.last_source = "SHM"
        self._path = path
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, prot=mmap.PROT_READ) \
            if length > 0 else None

    def pread(self, offset: int, n: int) -> bytes:
        if self._mm is None:
            return b""
        out = self._mm[offset:offset + n]
        _record_read("shm", len(out))
        return out

    def memoryview(self) -> Optional[memoryview]:
        return memoryview(self._mm) if self._mm is not None else memoryview(b"")

    def numpy_view(self, dtype=np.uint8) -> np.ndarray:
        """Zero-copy read-only ndarray over the mmap."""
        if self._mm is None:
            return np.empty(0, dtype=dtype)
        _record_read("shm", len(self._mm))
        return np.frombuffer(self._mm, dtype=dtype)

    def close(self) -> None:
        if self._f.closed:
            return
        if self._mm is not None:
            try:
                self._mm.close()
            except BufferError:
                # a numpy view is still live (e.g. a staging copy in
                # progress); leave the mapping to GC — on Linux the pages
                # stay valid even if the file is later unlinked
                pass
            self._mm = None
        self._f.close()
        if self._worker is not None:
            try:
                self._worker.close_local_block(self._session, self.block_id)
            except Exception:  # noqa: BLE001 - lease expires with session
                pass
        if self._on_close is not None:
            on_close, self._on_close = self._on_close, None
            on_close()


class GrpcBlockInStream(BlockInStream):
    """Remote read over gRPC chunk streams
    (reference: ``GrpcDataReader.java:49``).

    Reads larger than one stripe ride the parallel plane
    (``client/remote_read.py``): concurrent range streams across the
    block's replica set — or pooled channels to a single worker — with
    hedged stragglers and zero-join assembly into one preallocated
    buffer. Smaller reads, and a runtime with ``stripe_size=0``, take
    the single-stream loop. A batch of small reads goes out as
    ``read_many`` RPCs (:meth:`pread_many`)."""

    source = "REMOTE"

    def __init__(self, worker, block_id: int, length: int, *,
                 ufs: Optional[dict] = None, cache: bool = True,
                 chunk_size: int = 1 << 20, remote_read=None,
                 replicas: Optional[list] = None, client_factory=None,
                 on_failed=None,
                 batch: Optional[BatchReadConf] = None) -> None:
        """``worker``: a ``WorkerClient``; ``ufs``: the block's UFS
        descriptor (``ufs_path``, ``offset``, ``length``, ``mount_id``)
        for a worker read-through when the block is cold; ``cache``:
        whether that read-through caches it; ``remote_read``: a
        ``RemoteReadRuntime`` (None = single stream only); ``replicas``:
        the block's location addresses, nearest first;
        ``client_factory``: address -> WorkerClient for replica
        fan-out; ``on_failed``: callback(address) when a worker dies
        mid-stripe; ``batch``: scatter/gather coalescing (None = per-op
        only)."""
        super().__init__(block_id, length)
        self._worker = worker
        self._ufs = ufs
        self._cache = cache
        self._chunk = chunk_size
        self._remote_read = remote_read
        self._replicas = replicas or []
        self._client_factory = client_factory
        self._on_failed = on_failed
        self._batch = batch

    # -- parallel data plane -------------------------------------------------
    def _striped_sources(self, conf) -> list:
        """The stripe fan-out: one source per replica (rotating onto
        pooled channels when concurrency exceeds the replica count), or
        ``concurrency`` pooled channels to the single serving worker."""
        addrs = [a for a in self._replicas if a is not None]
        if not addrs:
            if self.address is None:
                return []
            addrs = [self.address]
        fan_out = max(len(addrs), min(conf.concurrency,
                                      MAX_POOLED_CHANNELS * len(addrs)))
        sources = []
        for i in range(fan_out):
            addr = addrs[i % len(addrs)]
            channel = i // len(addrs)
            if self.address is not None and addr.key() == self.address.key():
                worker = self._worker
            elif self._client_factory is not None:
                worker = self._client_factory(addr)
            else:
                continue
            sources.append(GrpcReadSource(
                worker, addr, channel, block_id=self.block_id,
                ufs=self._ufs, cache=self._cache))
        return sources

    def _striped_read(self, offset: int, n: int) -> memoryview:
        rt = self._remote_read
        read = rt.read(block_id=self.block_id,
                       sources=self._striped_sources(rt.conf),
                       offset=offset, length=n, chunk_size=self._chunk,
                       on_failed=self._on_failed)
        view = read.read_view()
        self.last_source = read.source_tag or "REMOTE"
        _record_read(self.source_bucket(), len(view))
        return view

    def _use_striped(self, n: int) -> bool:
        rt = self._remote_read
        return rt is not None and rt.enabled and \
            choose_route(n, striped=rt.conf) == "striped"

    def _read(self, offset: int, n: int):
        n = max(0, min(n, self.length - offset))
        if self._use_striped(n):
            return self._striped_read(offset, n)
        out = bytearray(n)
        view = memoryview(out)
        got = 0
        source = None
        for msg in self._worker.read_block(
                self.block_id, offset=offset, length=n,
                chunk_size=self._chunk, ufs=self._ufs, cache=self._cache):
            data = msg["data"]
            view[got:got + len(data)] = data
            got += len(data)
            source = msg.get("source", source)
        if got != n:
            raise UnavailableError(
                f"short read of block {self.block_id}: {got} of {n} bytes")
        # a worker that tags no source still served from its cache (cold
        # reads raise without a UFS descriptor, and with one it tags UFS)
        self.last_source = source or "REMOTE"
        _record_read(self.source_bucket(), n)
        return view

    def pread(self, offset: int, n: int) -> bytes:
        return bytes(self._read(offset, n))

    def read_all_view(self) -> memoryview:
        """The whole block as a buffer view, with no copy past the one
        the chunks land in (a striped read hands back its assembly
        buffer)."""
        return self._read(0, self.length)

    # -- scatter/gather ------------------------------------------------------
    def pread_many(self, offsets: Sequence[int],
                   sizes: Sequence[int]) -> List[bytes]:
        """Small-op batches coalesce into ``read_many`` RPCs: one wire
        round trip and ONE response buffer per ``max_ops`` ops.
        Ineligible ops (too large, a cold block needing its UFS
        descriptor, batching off) and any RPC failure take the per-op
        path, which gives the same bytes."""
        b = self._batch
        eligible = (self._ufs is None and len(sizes) > 0 and choose_route(
            max(sizes), batch=b, batch_ops=len(offsets)) == "batch")
        if not eligible:
            return super().pread_many(offsets, sizes)
        try:
            return self._batched_pread_many(offsets, sizes, b.max_ops)
        except Exception:  # noqa: BLE001 - transparent per-op fallback
            metrics().counter("Client.BatchReadFallbacks").inc()
            return super().pread_many(offsets, sizes)

    def _batched_pread_many(self, offsets: Sequence[int],
                            sizes: Sequence[int],
                            max_ops: int) -> List[bytes]:
        m = metrics()
        resps: List[dict] = []
        for i in range(0, len(offsets), max_ops):
            offs = list(offsets[i:i + max_ops])
            szs = [max(0, min(s, self.length - off))
                   for off, s in zip(offs, sizes[i:i + max_ops])]
            resp = self._worker.read_many(self.block_id, offs, szs)
            resps.append(resp)
            self.last_source = resp.get("source") or "REMOTE"
            m.counter("Client.BatchReadBatches").inc()
            m.counter("Client.BatchReadOps").inc(len(offs))
        out = self._scatter_responses(resps)
        total = sum(len(b) for b in out)
        m.counter("Client.BatchReadBytes").inc(total)
        _record_read(self.source_bucket(), total)
        return out

    def _scatter_responses(self, resps: List[dict]) -> List[bytes]:
        """Cut the ``read_many`` payloads into per-op bytes. With the
        fastpath on, all responses scatter into ONE buffer through a
        single GIL-free native call; the slice loop below gives the same
        bytes."""
        nops = sum(len(r["lengths"]) for r in resps)
        if self._batch is not None and self._batch.native_fastpath \
                and nops > 1:
            if fastpath.available():
                try:
                    return self._native_scatter(resps, nops)
                except fastpath.NativeExecError:
                    pass  # the fallback is counted
            else:
                fastpath.note_unavailable()
        out: List[bytes] = []
        for resp in resps:
            buf = memoryview(resp["data"])
            pos = 0
            for n in resp["lengths"]:
                out.append(bytes(buf[pos:pos + n]))
                pos += n
        return out

    def _native_scatter(self, resps: List[dict], nops: int) -> List[bytes]:
        lens = np.fromiter((n for r in resps for n in r["lengths"]),
                           dtype=np.int64, count=nops)
        bounds = np.zeros(nops + 1, dtype=np.int64)
        np.cumsum(lens, out=bounds[1:])
        ops = fastpath.op_table(nops)
        ops["len"] = lens  # kind zero-init == OP_COPY
        ops["dst_off"] = bounds[:-1]
        keep = []
        row = 0
        for resp in resps:
            k = len(resp["lengths"])
            loc = native._buffer_address(resp["data"])
            if loc is None:
                fastpath.note_unavailable()
                raise fastpath.NativeExecError("no payload address")
            addr, n, ka = loc
            keep.append(ka)
            ops["src"][row:row + k] = addr
            ops["src_len"][row:row + k] = n
            # offsets within this response = global dest offsets
            # rebased to the response's first op
            ops["src_off"][row:row + k] = bounds[row:row + k] - bounds[row]
            row += k
        dest = bytearray(int(bounds[-1]))
        fastpath.execute_table(ops, dest, host="batch")
        del keep
        return fastpath.slice_out(dest, bounds.tolist())

    @property
    def is_ufs_fallback(self) -> bool:
        return self._ufs is not None


class BlockOutStream:
    def __init__(self, block_id: int) -> None:
        self.block_id = block_id
        self.written = 0

    def write(self, data: bytes) -> None:
        raise NotImplementedError

    def close(self, cancel: bool = False) -> None:
        raise NotImplementedError

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        self.close(cancel=exc_type is not None)
        return False


class LocalBlockOutStream(BlockOutStream):
    """Short-circuit write: append straight to the worker's temp file,
    then commit (or abort) it by RPC (reference: ``LocalFileDataWriter`` +
    ``CreateLocalBlock`` lease)."""

    def __init__(self, worker, session_id: int, block_id: int,
                 *, size_hint: int, tier: str = "", pinned: bool = False):
        super().__init__(block_id)
        self._worker = worker
        self._session = session_id
        self._pinned = pinned
        path = worker.create_local_block(session_id, block_id,
                                         size_hint=size_hint, tier=tier)
        self._f = open(path, "wb")
        self._closed = False

    def write(self, data) -> None:
        """``data``: any buffer (bytes, memoryview, a numpy array)."""
        n = self._f.write(data)
        self.written += n

    def close(self, cancel: bool = False) -> None:
        if self._closed:
            return
        self._closed = True
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        self._worker.complete_local_block(self._session, self.block_id,
                                          cancel=cancel, pinned=self._pinned)


class GrpcBlockOutStream(BlockOutStream):
    """Remote write: chunks ride the client-stream as they are produced —
    a bounded queue feeds the in-flight RPC so network transfer overlaps
    the producer and peak memory stays ~queue-depth chunks, not a whole
    block (reference: ``GrpcDataWriter`` chunked flow control)."""

    _QUEUE_DEPTH = 4
    _CHUNK = 1 << 20

    def __init__(self, worker, session_id: int, block_id: int,
                 *, tier: str = "", pinned: bool = False,
                 chunk_size: Optional[int] = None) -> None:
        super().__init__(block_id)
        self._worker = worker
        self._session = session_id
        self._tier = tier
        self._pinned = pinned
        self._chunk = max(1, chunk_size) if chunk_size else self._CHUNK
        self._queue: "queue.Queue" = queue.Queue(maxsize=self._QUEUE_DEPTH)
        self._result: "futures.Future" = futures.Future()
        self._sender = threading.Thread(target=self._send, daemon=True,
                                        name=f"block-writer-{block_id}")
        self._sender.start()
        self._closed = False

    def _send(self) -> None:
        def gen():
            yield {"block_id": self.block_id, "session_id": self._session,
                   "tier": self._tier, "pinned": self._pinned}
            while True:
                item = self._queue.get()
                if item is None:
                    return
                yield item
                if "cancel" in item:
                    return

        try:
            resp = self._worker._channel.call_stream_in(
                self._worker.service, "write_block", gen())
            self._result.set_result(resp["length"])
        except BaseException as e:  # noqa: BLE001 - delivered on close()
            self._result.set_exception(e)
            # unblock a producer stuck on a full queue
            while True:
                try:
                    self._queue.get_nowait()
                except queue.Empty:
                    break

    def write(self, data) -> None:
        """``data``: any contiguous buffer; chunks and ``written`` count
        its bytes, whatever its item size."""
        view = memoryview(data).cast("B")
        for i in range(0, len(view), self._chunk):
            if self._result.done():  # sender died: surface its error
                self._result.result()
            self._queue.put({"data": bytes(view[i:i + self._chunk])})
        self.written += len(view)

    def close(self, cancel: bool = False) -> None:
        if self._closed:
            return
        self._closed = True
        if cancel:
            # the worker aborts its temp block on a cancel message and
            # fails the RPC; ending the stream instead would commit the
            # bytes sent so far
            self._queue.put({"cancel": True})
            try:
                self._result.result(timeout=30)
            except Exception:  # noqa: BLE001 - the abort's own error
                pass
            return
        self._queue.put(None)
        n = self._result.result(timeout=300)
        if n != self.written:
            raise UnavailableError(
                f"short write: {n} of {self.written} bytes for block "
                f"{self.block_id}")
        self._sender.join()
