"""Worker-side UFS block IO: the block descriptor, the unstriped read
with its cache fill, and the async cache manager.

A copy of ``alluxio_tpu/worker/ufs_io.py``. The worker's cold path is the
striped, coalescing fetcher (``worker/ufs_fetch.py``), and the async
cache manager always rides it; the unstriped read
(``UfsBlockReader.read_block``) is the cold-read bench's baseline.

Re-design of ``core/server/worker/.../block/{UnderFileSystemBlockStore.java,
UnderFileSystemBlockReader.java:50}`` + the async cache manager
(``worker/block/AsyncCacheRequestManager.java:52,88``): when a client reads
a block that is not cached, the worker streams it from the UFS at the block
offset and *concurrently* writes it into the local top tier, so the next
reader is warm. ``AsyncCacheManager`` executes client-issued cache requests
off the read path (passive caching).
"""

from __future__ import annotations

import logging
import queue
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from alluxio_tpu_torch.underfs.base import UnderFileSystem
from alluxio_tpu_torch.utils import ids as id_utils
from alluxio_tpu_torch.utils.exceptions import (
    AlreadyExistsError, best_effort,
)
from alluxio_tpu_torch.worker.tiered_store import TieredBlockStore

LOG = logging.getLogger(__name__)

_CHUNK = 4 << 20


@dataclass
class UfsBlockDescriptor:
    """Where a block lives in its UFS file."""

    block_id: int
    ufs_path: str
    offset: int
    length: int
    mount_id: int = 0


class UfsBlockReader:
    """Single-range read-through: serve from UFS while caching into the
    local store. This is the *unstriped* path — one blocking connection,
    first byte after the last — kept as the bench baseline
    (``stress/ufs_cold_bench.py``); the worker's cold reads ride
    ``worker/ufs_fetch.py``, and the async cache calls ``cache_block``
    when a block was not cached by the fetch it joined."""

    def __init__(self, store: TieredBlockStore) -> None:
        self._store = store

    def read_block(self, ufs: UnderFileSystem, desc: UfsBlockDescriptor, *,
                   cache: bool = True, tier_alias: str = "") -> bytes:
        """Fetch the whole block (the device read path wants whole pages
        into a staging buffer, not tiny chunks)."""
        from alluxio_tpu_torch.metrics import metrics
        from alluxio_tpu_torch.utils.tracing import tracer

        with tracer().span("atpu.worker.ufs_read",
                           block_id=desc.block_id, bytes=desc.length):
            data = ufs.read_range(desc.ufs_path, desc.offset, desc.length)
        m = metrics()
        m.counter("Worker.UfsBlocksRead").inc()
        m.counter("Worker.UfsBytesRead").inc(len(data))
        if cache:
            self.cache_block(desc.block_id, data, tier_alias)
        return data

    def cache_block(self, block_id: int, data: bytes,
                    tier_alias: str = "") -> bool:
        session = id_utils.create_session_id()
        try:
            self._store.create_block(session, block_id,
                                     initial_bytes=len(data),
                                     tier_alias=tier_alias)
        except AlreadyExistsError:
            return False
        except Exception:  # noqa: BLE001 - cache fill is best-effort
            LOG.debug("cache fill for block %s failed", block_id, exc_info=True)
            return False
        try:
            with self._store.get_temp_writer(session, block_id) as w:
                w.append(data)
            self._store.commit_block(session, block_id)
            return True
        except Exception:  # noqa: BLE001
            LOG.debug("cache commit for block %s failed", block_id,
                      exc_info=True)
            best_effort("cache-fill abort", self._store.abort_block,
                        session, block_id)
            return False


class AsyncCacheManager:
    """Executes passive-cache requests off the read path
    (reference: ``AsyncCacheRequestManager.java:88``). A client that read a
    block remotely (or straight from UFS) asks its local worker to cache it
    in the background.

    The queue is bounded (``atpu.worker.async.cache.queue.max``): a burst
    of cache requests beyond it is *rejected* (counted in
    ``Worker.AsyncCacheRejected``) instead of growing the backlog without
    limit — passive caching is advisory, the client already has the bytes.

    Cache fills ride the ``UfsBlockFetcher``'s coalescing registry, as
    foreground reads do, so a background fill never duplicates an
    in-flight foreground fetch of the same block.

    With worker QoS on (``prioritize=True``) the queue drains in
    priority order — client-issued ASYNC_FILL requests before the
    prefetch agent's speculative PREFETCH loads — and each request's
    class and tenant ride into the coalescing fetch, so the per-mount
    stripe executors see the true originator. Off, the queue is exact
    FIFO."""

    def __init__(self, store: TieredBlockStore,
                 ufs_resolver: Callable[[int], UnderFileSystem],
                 fetcher, num_threads: int = 1, queue_max: int = 512,
                 prioritize: bool = False) -> None:
        from alluxio_tpu_torch.qos import PriorityTaskQueue

        self._store = store
        self._reader = UfsBlockReader(store)
        self._ufs_resolver = ufs_resolver
        self._fetcher = fetcher  # ufs_fetch.UfsBlockFetcher
        self._queue = PriorityTaskQueue(max(1, queue_max),
                                        prioritize=prioritize)
        self._prioritize = prioritize
        self._inflight: Dict[int, bool] = {}
        self._lock = threading.Lock()
        self._closed = False
        self._threads = [threading.Thread(target=self._run, daemon=True,
                                          name=f"async-cache-{i}")
                         for i in range(max(1, num_threads))]
        for t in self._threads:
            t.start()

    def submit(self, desc: UfsBlockDescriptor, *,
               priority: Optional[int] = None, tenant: str = "") -> bool:
        from alluxio_tpu_torch.metrics import metrics
        from alluxio_tpu_torch.qos import ASYNC_FILL, PRIORITY_NAMES

        if priority is None:
            priority = ASYNC_FILL
        with self._lock:
            if self._closed or desc.block_id in self._inflight or \
                    self._store.has_block(desc.block_id):
                return False
            if self._fetcher.caching_in_flight(desc.block_id):
                # a foreground read-through is already CACHING this
                # block (an in-flight cache=False fetch is not enough
                # to stand down — joining it upgrades it instead)
                return False
            self._inflight[desc.block_id] = True
        try:
            self._queue.put_nowait((desc, priority, tenant), priority)
        except queue.Full:
            with self._lock:
                self._inflight.pop(desc.block_id, None)
            metrics().counter("Worker.AsyncCacheRejected").inc()
            return False
        if self._prioritize:
            metrics().counter(
                "Worker.QosAsyncCache."
                + PRIORITY_NAMES.get(priority, str(priority))).inc()
        return True

    def _run(self) -> None:
        while True:
            try:
                desc, priority, tenant = self._queue.get(timeout=0.2)
            except queue.Empty:
                if self._closed:
                    return
                continue
            if self._closed:
                # shutdown drops the backlog: passive caching is
                # advisory and must not delay worker stop
                self._queue.task_done()
                return
            try:
                if self._store.has_block(desc.block_id):
                    continue  # cached while queued
                ufs = self._ufs_resolver(desc.mount_id)
                # coalesces with any concurrent fetch of this block;
                # joining a cache=False fetch upgrades it, and if even
                # that was too late, cache from the bytes. The request's
                # class/tenant ride into the stripe executor so
                # background fills queue as background
                data = self._fetcher.fetch(ufs, desc, cache=True,
                                           priority=priority,
                                           tenant=tenant).result()
                if not self._store.has_block(desc.block_id):
                    self._reader.cache_block(desc.block_id, data)
            except Exception:  # noqa: BLE001
                LOG.debug("async cache of block %s failed", desc.block_id,
                          exc_info=True)
            finally:
                with self._lock:
                    self._inflight.pop(desc.block_id, None)
                self._queue.task_done()

    def wait_idle(self, timeout_s: float = 10.0) -> bool:
        """Block until the queue drains or the deadline passes; returns
        True if idle."""
        import time

        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._queue.all_tasks_done:
                if self._queue.unfinished_tasks == 0:
                    return True
            time.sleep(0.005)
        return False

    def close(self, timeout_s: float = 5.0) -> None:
        """Stop taking requests and join the cache threads (a fill in
        progress finishes; the backlog is dropped)."""
        # flag-based shutdown: workers poll the flag between short
        # blocking gets, so no poison pills are needed — pills on a
        # BOUNDED queue either deadlock (queue full) or corrupt the
        # unfinished-task accounting wait_idle() relies on
        with self._lock:
            self._closed = True
        for t in self._threads:
            t.join(timeout_s)
