"""Pipelined UFS cold reads: striped parallel fetch, streaming
read-through, and in-flight coalescing (a copy of
``alluxio_tpu/worker/ufs_fetch.py``).

Replaces the naive cold path (one blocking whole-block ``read_range``
in the JAX ``ufs_io.UfsBlockReader.read_block``) with a fetch pipeline:

- **striped parallel fetch** — a block is split into fixed-size stripes
  fetched concurrently over a per-mount bounded executor, so cold-read
  bandwidth is limited by the link, not by one UFS connection (the
  Hoard / hierarchical-HPC-I/O result: object stores serve many modest
  streams far faster than one);
- **streaming read-through** — waiters consume bytes as stripes land in
  ascending offset order, so time-to-first-byte is O(stripe) instead of
  O(block), and the tiered-store temp writer fills in parallel with the
  stream (``TieredBlockStore.open_cache_fill``);
- **in-flight coalescing** — a per-block registry shares one UFS fetch
  among N concurrent cold readers (every host hitting step-0 of an
  epoch together), with late readers attaching to the stripe pipeline
  mid-flight; the async cache manager and the prefetch agent's loads
  dedupe against foreground fetches through the same registry.

A UFS that rejects ranged reads (short reads, errors on sub-block
ranges) demotes the fetch to a single full-range read — and when no
stripe succeeded but the full read did (the rejection signature), the
mount is remembered for ``UNSTRIPED_MOUNT_TTL_S`` so later fetches skip
the doomed striping attempt without demoting the mount forever.

Observability: ``Worker.UfsFetch*`` counters + ``Worker.UfsFetchTtfb``
timer, a ``Worker.UfsFetchTime`` timer of each successful fetch's wall
time (the reference lacks it), and an ``atpu.worker.ufs_fetch`` span per fetch under the caller's
live span, with its ``queue_wait``, ``ufs_fetch`` and ``cache_fill``
phases. The port's tracer records every span while it is on (the JAX
tracer's sampling is not copied), and the span also names the starter's
``tenant`` and the fetch's final QoS ``class`` (tags the JAX span lacks).

QoS (``atpu.worker.qos.enabled``): every fetch carries a priority class
(ON_DEMAND > ASYNC_FILL > PREFETCH) and a tenant (principal).  The
per-mount executors drain in priority order — a queued prefetch fetch
is overtaken by an arriving on-demand read (in-flight stripes are never
interrupted), and a queued fetch is PROMOTED the moment an on-demand
reader coalesces onto it — with per-tenant caps on concurrent stripe
tasks so one flooding principal cannot monopolize the mount's
connection budget (``atpu.worker.ufs.fetch.tenant.limit``).  Disabled,
the executors are plain FIFO pools: byte-identical to a build without
QoS.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

from alluxio_tpu_torch.metrics import metrics
from alluxio_tpu_torch.qos import ON_DEMAND, PRIORITY_NAMES, PriorityExecutor
from alluxio_tpu_torch.underfs.base import UnderFileSystem
from alluxio_tpu_torch.utils import faults
from alluxio_tpu_torch.utils import tracing as _tracing
from alluxio_tpu_torch.utils.striping import plan_stripes as _plan_stripes
from alluxio_tpu_torch.worker.tiered_store import CacheFill, TieredBlockStore
from alluxio_tpu_torch.worker.ufs_io import UfsBlockDescriptor

LOG = logging.getLogger(__name__)

#: how long a mount that failed a ranged read stays demoted to
#: single-range fetches before striping is retried
UNSTRIPED_MOUNT_TTL_S = 600.0


@dataclass(frozen=True)
class FetchConf:
    """Tuning for the striped fetch pipeline (see
    ``atpu.worker.ufs.fetch.*`` in ``conf/property_key.py``)."""

    #: bytes per stripe; also the time-to-first-byte unit
    stripe_size: int = 4 << 20
    #: stripes in flight per block
    concurrency: int = 4
    #: concurrent UFS reads per mount, across all blocks
    per_mount_limit: int = 16
    #: priority-class scheduling + tenant caps (atpu.worker.qos.enabled)
    qos_enabled: bool = False
    #: concurrent stripe tasks one tenant may occupy per mount (with
    #: QoS on; 0 = unlimited)
    tenant_limit: int = 8

    @classmethod
    def from_conf(cls, conf) -> "FetchConf":
        from alluxio_tpu_torch.conf import Keys

        return cls(
            stripe_size=max(1, conf.get_bytes(
                Keys.WORKER_UFS_FETCH_STRIPE_SIZE)),
            concurrency=max(1, conf.get_int(
                Keys.WORKER_UFS_FETCH_CONCURRENCY)),
            per_mount_limit=max(1, conf.get_int(
                Keys.WORKER_UFS_FETCH_PER_MOUNT_LIMIT)),
            qos_enabled=conf.get_bool(Keys.WORKER_QOS_ENABLED),
            tenant_limit=max(0, conf.get_int(
                Keys.WORKER_UFS_FETCH_TENANT_LIMIT)),
        )


def plan_stripes(length: int, stripe_size: int) -> List[Tuple[int, int]]:
    """(block-relative offset, length) per stripe; never empty — a
    zero-length block still needs one completion event to close the
    pipeline (the shared planner returns [] there)."""
    if length <= 0:
        return [(0, 0)]
    return _plan_stripes(length, stripe_size)


class FetchError(IOError):
    """A cold fetch failed after exhausting the single-range fallback."""


class BlockFetch:
    """One in-flight cold-block fetch shared by any number of waiters.

    Stripe workers call :meth:`_complete_stripe` / :meth:`_stripe_failed`;
    waiters stream with :meth:`iter_range` or block with :meth:`result`.
    All state transitions happen under ``_cond`` and notify all waiters.
    """

    def __init__(self, desc: UfsBlockDescriptor, conf: FetchConf, *,
                 store: Optional[TieredBlockStore] = None,
                 on_done=None) -> None:
        self.desc = desc
        self.conf = conf
        self._store = store
        #: QoS class of the most demanding waiter (coalescing joins by
        #: an on-demand reader lower it and promote the queued tasks)
        self.priority = ON_DEMAND
        #: the starting caller's principal (its stripe tasks' tenant)
        self.tenant = ""
        self.stripes = plan_stripes(desc.length, conf.stripe_size)
        self.fallback = False
        #: any stripe read succeeded / the fallback read succeeded —
        #: together they distinguish "mount rejects ranged reads"
        #: (fallback ok, zero stripes ok) from a transient error
        self.any_stripe_ok = False
        self.fallback_ok = False
        #: bytes actually served: desc.length unless the UFS object
        #: turned out shorter (legacy single-range semantics: serve and
        #: cache what exists instead of failing every waiter)
        self.served_length = max(0, desc.length)
        #: readers sharing this fetch (1 = the starter); registry-managed
        self.waiters = 1
        self.created_at = time.perf_counter()
        self.first_byte_at: Optional[float] = None
        self._buf = bytearray(max(0, desc.length))
        self._landed = [False] * len(self.stripes)
        self._frontier = 0  # contiguous landed stripes from stripe 0
        self._next = 0      # next stripe index to hand a worker
        self._striping_aborted = False
        self._done = False
        self._error: Optional[BaseException] = None
        self._cond = threading.Condition()
        self._result: Optional[bytes] = None  # shared result() snapshot
        #: newly-contiguous stripe ranges awaiting a cache-fill append,
        #: built in frontier order under ``_cond``, drained in that
        #: order under ``_fill_lock`` OUTSIDE ``_cond`` so disk writes
        #: never stall stripe completions or streaming waiters
        self._fill_pending: List[Tuple[int, int]] = []
        self._fill_lock = threading.Lock()
        #: attached by the fetcher (before stripe workers start) when
        #: this fetch should read-through cache
        self._cache_fill: Optional[CacheFill] = None
        #: a caching reader joined too late to attach a fill; finalize
        #: then fills from the completed buffer instead
        self._cache_wanted = False
        self._cache_tier_alias = ""
        self._on_done = on_done
        self._span = self._open_span()
        #: phase accumulators (only written when the fetch is traced):
        #: UFS read time summed across stripe workers, cache-fill write
        #: time, and when the first stripe task actually started — the
        #: created->first-claim gap is the executor queue wait
        self._ufs_ms = 0.0
        self._fill_ms = 0.0
        self._first_claim_at: Optional[float] = None

    # -- tracing ------------------------------------------------------------
    def _open_span(self):
        """Manually-managed span: the fetch starts on the caller's thread
        (inheriting its trace context) but finishes on whichever stripe
        worker lands last, so the context-manager form cannot be used."""
        t = _tracing.tracer()
        if not t.enabled:
            return None
        ctx = _tracing.current_trace_context()
        span = _tracing.Span(
            "atpu.worker.ufs_fetch", _tracing.new_span_id(),
            ctx.span_id if ctx else None,
            ctx.trace_id if ctx else _tracing.new_trace_id(),
            sampled=ctx.sampled if ctx else t._sample())
        span.tags = {"block_id": str(self.desc.block_id),
                     "bytes": str(self.desc.length),
                     "stripes": str(len(self.stripes))}
        return span

    def _close_span(self) -> None:
        if self._span is None:
            return
        if self._first_claim_at is not None:
            self._span.phase(
                "queue_wait",
                (self._first_claim_at - self.created_at) * 1000.0)
        if self._ufs_ms > 0.0:
            self._span.phase("ufs_fetch", self._ufs_ms)
        if self._fill_ms > 0.0:
            self._span.phase("cache_fill", self._fill_ms)
        self._span.duration_ms = \
            (time.perf_counter() - self.created_at) * 1000.0
        self._span.tags["fallback"] = str(self.fallback)
        self._span.tags["waiters"] = str(self.waiters)
        self._span.tags["tenant"] = self.tenant
        self._span.tags["class"] = PRIORITY_NAMES.get(
            self.priority, str(self.priority))
        if self._error is not None:
            self._span.error = \
                f"{type(self._error).__name__}: {self._error}"
        if self._span.sampled:
            _tracing.tracer().record(self._span)

    # -- stripe-worker side -------------------------------------------------
    def _claim_stripe(self) -> Optional[int]:
        with self._cond:
            if self._span is not None and self._first_claim_at is None:
                self._first_claim_at = time.perf_counter()
            if self._striping_aborted or self._error is not None:
                return None
            if self._next >= len(self.stripes):
                return None
            i = self._next
            self._next += 1
            return i

    def _note_ufs_ms(self, elapsed_ms: float) -> None:
        """Accumulate one stripe's UFS read time (workers run
        concurrently, so the sum can exceed the span's wall — the
        critical-path analyzer scales phases into self-time)."""
        with self._cond:
            self._ufs_ms += elapsed_ms

    def _complete_stripe(self, i: int, data: bytes) -> None:
        off, ln = self.stripes[i]
        m = metrics()
        with self._cond:
            if self._landed[i]:
                # raced with a full-range fallback fill: the buffer is
                # already published to waiters — a straggler write here
                # (object replaced mid-fetch -> different bytes) would
                # tear it, so landed stripes are never rewritten
                return
            self._buf[off:off + ln] = data
            self.any_stripe_ok = True
            self._landed[i] = True
            if self.first_byte_at is None and i == 0:
                self.first_byte_at = time.perf_counter()
                m.timer("Worker.UfsFetchTtfb").update(
                    self.first_byte_at - self.created_at)
            finished = self._advance_frontier_locked()
            self._cond.notify_all()
        self._drain_fill()
        if finished:
            self._finalize_success()

    def _advance_frontier_locked(self) -> bool:
        """Advance the contiguous frontier, queueing newly-contiguous
        stripes for the cache fill. Runs under ``_cond``, so the queue
        is strictly in frontier order; the actual (disk-touching)
        appends happen in :meth:`_drain_fill` outside the lock."""
        n = len(self.stripes)
        while self._frontier < n and self._landed[self._frontier]:
            off, ln = self.stripes[self._frontier]
            if self._cache_fill is not None and ln > 0:
                self._fill_pending.append((off, ln))
            self._frontier += 1
        return self._frontier == n

    def _drain_fill(self, blocking: bool = False) -> None:
        """Append queued frontier ranges to the cache fill. Holding
        ``_fill_lock`` across the whole drain keeps appends in frontier
        order; a stripe worker that finds another thread draining skips
        instead of queueing behind its disk writes (the drainer — or at
        the latest the blocking drain in finalize — picks the ranges
        up). Buffer reads are safe outside ``_cond`` because landed
        stripes are never rewritten."""
        if blocking:
            self._fill_lock.acquire()
        elif not self._fill_lock.acquire(blocking=False):
            return
        try:
            while True:
                with self._cond:
                    fill = self._cache_fill
                    if fill is None or not self._fill_pending:
                        return
                    off, ln = self._fill_pending.pop(0)
                t_fill = time.perf_counter() if self._span is not None \
                    else 0.0
                ok = fill.append(self._buf[off:off + ln])
                if self._span is not None:
                    # under _fill_lock: drains are serialized
                    self._fill_ms += \
                        (time.perf_counter() - t_fill) * 1000.0
                if not ok:
                    with self._cond:  # fill failed: serve-only
                        self._cache_fill = None
                        self._fill_pending.clear()
                    return
        finally:
            self._fill_lock.release()

    def _stripe_failed(self, ufs: UnderFileSystem,
                       exc: BaseException) -> None:
        """First stripe failure demotes the fetch to one full-range read
        (the UFS may reject ranged reads outright); a second failure
        fails the fetch for every waiter."""
        with self._cond:
            if self._done or self._error is not None:
                return
            if self._striping_aborted:  # fallback already running/failed
                return
            self._striping_aborted = True
        LOG.debug("stripe fetch of block %s failed; falling back to "
                  "single-range read", self.desc.block_id, exc_info=True)
        self.fallback = True
        metrics().counter("Worker.UfsFetchFallbacks").inc()
        try:
            t_ufs = time.perf_counter() if self._span is not None else 0.0
            data = ufs.read_range(self.desc.ufs_path, self.desc.offset,
                                  self.desc.length)
            if self._span is not None:
                self._note_ufs_ms((time.perf_counter() - t_ufs) * 1000.0)
        except BaseException as e2:  # noqa: BLE001
            self._fail(e2)
            return
        self.fallback_ok = True
        m = metrics()
        m.counter("Worker.UfsFetchBytes").inc(len(data))
        n = min(len(data), self.desc.length)
        truncated = n < self.desc.length
        late_fill = None
        with self._cond:
            if truncated:
                # the UFS object is shorter than the block metadata
                # says (shrunk/replaced): mirror the legacy path —
                # serve and cache the bytes that exist. The stripe-wise
                # incremental fill would pad zeros, so it is replaced
                # by a buffered fill of the served slice at finalize —
                # but only when someone actually asked for caching
                self.served_length = n
                late_fill, self._cache_fill = self._cache_fill, None
                self._fill_pending.clear()
                self._cache_wanted = self._cache_wanted or \
                    late_fill is not None
            # fill ONLY un-landed stripes: landed ones are published to
            # waiters/cache fill and must never be rewritten (a replaced
            # object mid-fetch would tear mixed-version bytes into them)
            for i, (off, ln) in enumerate(self.stripes):
                if self._landed[i]:
                    continue
                upper = min(off + ln, n)
                if off < upper:
                    self._buf[off:upper] = data[off:upper]
                self._landed[i] = True
            if self.first_byte_at is None:
                self.first_byte_at = time.perf_counter()
                m.timer("Worker.UfsFetchTtfb").update(
                    self.first_byte_at - self.created_at)
            if truncated:
                self._frontier = len(self.stripes)
                finished = True
            else:
                finished = self._advance_frontier_locked()
            self._cond.notify_all()
        if late_fill is not None:
            late_fill.abort()
        self._drain_fill()
        if finished:
            self._finalize_success()

    def _finalize_success(self) -> None:
        # blocking: every queued append must land before the commit
        self._drain_fill(blocking=True)
        with self._cond:
            fill, wanted = self._cache_fill, self._cache_wanted
        if fill is not None:
            t_fill = time.perf_counter() if self._span is not None else 0.0
            fill.commit()
            if self._span is not None:
                self._fill_ms += (time.perf_counter() - t_fill) * 1000.0
        elif wanted and self._store is not None:
            # a caching reader attached after the frontier moved (or
            # the fetch truncated): the block is resident now, fill in
            # one buffered pass of the served slice
            late = self._store.open_cache_fill(self.desc.block_id,
                                               self.served_length,
                                               self._cache_tier_alias)
            if late is not None and \
                    late.append(self._buf[:self.served_length]):
                late.commit()
        # legacy cold-read counters (logical block/bytes served from
        # UFS) so pre-striping dashboards keep reading correctly;
        # Worker.UfsFetchBytes above counts raw UFS traffic instead
        m = metrics()
        m.counter("Worker.UfsBlocksRead").inc()
        m.counter("Worker.UfsBytesRead").inc(self.served_length)
        m.timer("Worker.UfsFetchTime").update(
            time.perf_counter() - self.created_at)
        with self._cond:
            self._done = True
            self._cond.notify_all()
        self._close_span()
        if self._on_done is not None:
            self._on_done(self)

    def _fail(self, exc: BaseException) -> None:
        metrics().counter("Worker.UfsFetchFailures").inc()
        with self._cond:
            fill, self._cache_fill = self._cache_fill, None
            self._fill_pending.clear()
        if fill is not None:
            fill.abort()  # before waking waiters: they check has_block
        with self._cond:
            self._error = exc
            self._cond.notify_all()
        self._close_span()
        if self._on_done is not None:
            self._on_done(self)

    def try_attach_cache_fill(self, store: TieredBlockStore,
                              tier_alias: str = "") -> bool:
        """Attach a read-through cache fill — at start, or mid-flight
        when a caching reader joins a fetch that began with
        ``cache=False``. Appends are frontier-ordered, so attaching is
        only sound while nothing has passed the frontier; after that
        ``_cache_wanted`` makes finalize cache the completed buffer in
        one pass instead."""
        with self._cond:
            if self._cache_fill is not None:
                return True
            if self._done or self._error is not None:
                return False
            if self._frontier:
                self._cache_wanted = True  # finalize fills from buffer
                self._cache_tier_alias = tier_alias
                return False
            fill = store.open_cache_fill(self.desc.block_id,
                                         self.desc.length, tier_alias)
            if fill is None:
                return False
            self._cache_fill = fill
            return True

    # -- waiter side --------------------------------------------------------
    @property
    def done(self) -> bool:
        with self._cond:
            return self._done

    @property
    def error(self) -> Optional[BaseException]:
        with self._cond:
            return self._error

    def wait_done(self, timeout_s: Optional[float] = None) -> bool:
        """Wait for the whole pipeline — including the cache-fill
        commit, which lands just after the final stripe — to finish.
        Streaming waiters can drain every byte slightly before this.
        Returns False on timeout or when the fetch failed (check
        :attr:`error` to distinguish)."""
        deadline = None if timeout_s is None else \
            time.monotonic() + timeout_s
        with self._cond:
            while not self._done and self._error is None:
                remaining = None if deadline is None else \
                    deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(remaining)
            return self._done

    def _stripe_index(self, pos: int) -> int:
        return min(pos // max(1, self.conf.stripe_size),
                   len(self.stripes) - 1)

    def _wait_stripe(self, i: int) -> None:
        with self._cond:
            while not self._landed[i] and self._error is None:
                self._cond.wait()
            if self._error is not None and not self._landed[i]:
                raise FetchError(
                    f"cold fetch of block {self.desc.block_id} failed: "
                    f"{self._error}") from self._error

    def iter_range(self, offset: int = 0, length: int = -1,
                   chunk_size: int = 1 << 20) -> Iterator[bytes]:
        """Yield ``[offset, offset+length)`` in ascending order, each
        chunk as soon as the stripe containing it has landed — this is
        what makes the read-through *streaming*: a waiter gets its first
        chunk after one stripe, not after the whole block."""
        end = self.desc.length if length < 0 else \
            min(self.desc.length, offset + length)
        pos = max(0, offset)
        chunk_size = max(1, chunk_size)
        # one copy per chunk (a bare bytearray slice would be a second);
        # holding the view only pins the bytearray's size, never writes
        view = memoryview(self._buf)
        while pos < end:
            si = self._stripe_index(pos)
            self._wait_stripe(si)
            # a truncated fetch (shrunk UFS object) shortens the stream
            # exactly like the legacy single-range path did
            end = min(end, self.served_length)
            s_off, s_len = self.stripes[si]
            upper = min(end, s_off + s_len)
            while pos < upper:
                n = min(chunk_size, upper - pos)
                yield bytes(view[pos:pos + n])
                pos += n

    def result(self) -> bytes:
        """Block until the whole block is resident; raises on failure.
        All waiters share one immutable snapshot — N coalesced readers
        of a big block must not mean N full-block copies."""
        with self._cond:
            while not self._done and self._error is None:
                self._cond.wait()
            if self._error is not None:
                raise FetchError(
                    f"cold fetch of block {self.desc.block_id} failed: "
                    f"{self._error}") from self._error
            if self._result is None:
                self._result = bytes(
                    memoryview(self._buf)[:self.served_length])
            return self._result


class UfsBlockFetcher:
    """Per-block fetch registry + per-mount bounded stripe executors.

    ``fetch()`` is the single cold-read entry point for foreground
    reads, the async cache manager and the prefetch agent's loads: the
    first caller starts the stripe pipeline, every later caller for the
    same block attaches to it mid-flight (``Worker.UfsFetchCoalesced``).
    """

    def __init__(self, store: TieredBlockStore, conf: FetchConf, *,
                 host: str = "") -> None:
        self._store = store
        self.conf = conf
        #: locality host the fault-injection scope matches against
        self._fault_host = host
        self._lock = threading.Lock()
        self._inflight: Dict[int, BlockFetch] = {}
        self._executors: Dict[int, PriorityExecutor] = {}
        #: mount_id -> retry-after (monotonic): a mount whose UFS failed
        #: a ranged read goes straight to single-range until the TTL
        #: lapses — a permanent demotion would let one transient stripe
        #: error collapse the mount to one connection forever
        self._unstriped_mounts: Dict[int, float] = {}
        self._closed = False
        self._m = metrics()

    # -- registry -----------------------------------------------------------
    def in_flight(self, block_id: int) -> bool:
        with self._lock:
            return block_id in self._inflight

    def caching_in_flight(self, block_id: int) -> bool:
        """True when an in-flight fetch of this block is already
        read-through caching it (a cache=False fetch is NOT enough for
        a passive-cache request to stand down)."""
        with self._lock:
            fetch = self._inflight.get(block_id)
        return fetch is not None and fetch._cache_fill is not None

    def _executor(self, mount_id: int) -> PriorityExecutor:
        with self._lock:
            if self._closed:
                # close() already drained the map; recreating here
                # would leak an executor no shutdown will ever see
                raise FetchError("fetcher is closed")
            ex = self._executors.get(mount_id)
            if ex is None:
                # with QoS off this drains FIFO with no tenant caps —
                # semantically the ThreadPoolExecutor it replaced
                ex = PriorityExecutor(
                    self.conf.per_mount_limit,
                    thread_name_prefix=f"ufs-fetch-m{mount_id}",
                    prioritize=self.conf.qos_enabled,
                    tenant_cap=self.conf.tenant_limit
                    if self.conf.qos_enabled else 0)
                self._executors[mount_id] = ex
            return ex

    #: qos_stats memo TTL: three gauges read these on every metrics
    #: scrape — one executor sweep serves all three, not three
    QOS_STATS_TTL_S = 0.5

    def qos_stats(self) -> Dict[str, float]:
        """Aggregated executor QoS counters (gauges in BlockWorker);
        briefly memoized so one scrape's three gauges share a sweep."""
        now = time.monotonic()
        cached = getattr(self, "_qos_stats_cache", None)
        if cached is not None and now - cached[0] < self.QOS_STATS_TTL_S:
            return cached[1]
        with self._lock:
            exs = list(self._executors.values())
        stats = {
            "deferred": float(sum(e.deferred for e in exs)),
            "promoted": float(sum(e.promoted for e in exs)),
            "queued": float(sum(e.queued() for e in exs)),
        }
        self._qos_stats_cache = (now, stats)
        return stats

    def _mark_unstriped(self, mount_id: int) -> None:
        with self._lock:
            self._unstriped_mounts[mount_id] = \
                time.monotonic() + UNSTRIPED_MOUNT_TTL_S

    def _effective_conf_locked(self, desc: UfsBlockDescriptor) -> FetchConf:
        expiry = self._unstriped_mounts.get(desc.mount_id)
        if expiry is not None and expiry <= time.monotonic():
            del self._unstriped_mounts[desc.mount_id]
            expiry = None
        if expiry is None:
            return self.conf
        # known-unstriped mount: one worker, one whole-block stripe
        return FetchConf(stripe_size=max(1, desc.length), concurrency=1,
                         per_mount_limit=self.conf.per_mount_limit,
                         qos_enabled=self.conf.qos_enabled,
                         tenant_limit=self.conf.tenant_limit)

    def _on_done(self, fetch: BlockFetch) -> None:
        # demote the mount only on the precise range-rejection
        # signature — every stripe failed but the full-range read
        # worked AT FULL LENGTH. A transient error mid-fetch, a total
        # outage, or a shrunk object (stripes past EOF short-read, the
        # truncated fallback is legal) must not collapse the mount to
        # one connection.
        if fetch.fallback_ok and not fetch.any_stripe_ok and \
                fetch.served_length >= fetch.desc.length:
            self._mark_unstriped(fetch.desc.mount_id)
        with self._lock:
            self._inflight.pop(fetch.desc.block_id, None)

    # -- entry point --------------------------------------------------------
    def fetch(self, ufs: UnderFileSystem, desc: UfsBlockDescriptor, *,
              cache: bool = True, tier_alias: str = "",
              priority: int = ON_DEMAND, tenant: str = "") -> BlockFetch:
        """Start (or join) the fetch of one cold block.

        ``priority`` is the caller's QoS class (the async cache manager
        passes ASYNC_FILL, the prefetch agent's loads PREFETCH); with
        QoS disabled it is ignored.  Joining a queued lower-priority
        fetch PROMOTES it: the moment an on-demand reader waits on a
        prefetch-initiated fetch, its queued stripe tasks jump the
        background work ahead of them."""
        with self._lock:
            if self._closed:
                raise FetchError("fetcher is closed")
            existing = self._inflight.get(desc.block_id)
            if existing is None:
                conf = self._effective_conf_locked(desc)
            else:
                existing.waiters += 1
        if existing is None:
            # construct outside the registry lock: zero-filling the
            # block-sized buffer is tens of ms for huge blocks and must
            # not stall coalescing joins / fetch starts of other blocks
            fetch = BlockFetch(desc, conf, store=self._store,
                               on_done=self._on_done)
            fetch.priority, fetch.tenant = priority, tenant
            with self._lock:
                if self._closed:
                    raise FetchError("fetcher is closed")
                existing = self._inflight.get(desc.block_id)
                if existing is None:
                    self._inflight[desc.block_id] = fetch
                else:  # raced with another starter: join theirs
                    existing.waiters += 1
        if existing is not None:
            self._m.counter("Worker.UfsFetchCoalesced").inc()
            promote_ex = None
            if self.conf.qos_enabled:
                # decide under the registry lock: two simultaneous
                # joiners must not both read the stale priority and
                # skip (or double-run) the promotion
                with self._lock:
                    if priority < existing.priority:
                        existing.priority = priority
                        promote_ex = self._executors.get(desc.mount_id)
            if promote_ex is not None:
                # an on-demand reader joined background work: its
                # queued stripe tasks stop yielding to other queues
                moved = promote_ex.promote(desc.block_id, priority)
                if moved:
                    self._m.counter("Worker.QosFetchPromoted").inc(moved)
            if cache:
                # a caching reader joining a cache=False fetch upgrades
                # it while that is still sound (nothing past the
                # frontier); otherwise the caller caches from the bytes
                existing.try_attach_cache_fill(self._store, tier_alias)
            return existing
        if cache:
            # likewise outside the lock: opening the fill can trigger
            # allocation/eviction IO; no stripe runs before the workers
            # below are submitted, so it cannot race the frontier
            fetch.try_attach_cache_fill(self._store, tier_alias)
        self._m.counter("Worker.UfsFetchStarted").inc()
        if self.conf.qos_enabled:
            self._m.counter(
                "Worker.QosFetch."
                + PRIORITY_NAMES.get(priority, str(priority))).inc()
        try:
            ex = self._executor(desc.mount_id)
            workers = min(conf.concurrency, len(fetch.stripes))
            for _ in range(max(1, workers)):
                ex.submit(self._stripe_loop, ufs, fetch,
                          priority=priority, tenant=tenant,
                          group=desc.block_id)
        except BaseException as e:  # closed/shutdown race: no workers
            fetch._fail(e)          # will ever land stripes — fail the
            raise                   # fetch so no waiter hangs on it
        return fetch

    def _stripe_loop(self, ufs: UnderFileSystem, fetch: BlockFetch) -> None:
        """One pipeline worker: pull stripe indices until exhausted.
        Each loop occupies one per-mount executor slot, so concurrent
        UFS connections per mount never exceed ``per_mount_limit``."""
        while True:
            i = fetch._claim_stripe()
            if i is None:
                return
            off, ln = fetch.stripes[i]
            # one retry per stripe before demoting the whole fetch: the
            # full-range fallback re-downloads everything over a single
            # connection, far too expensive an answer to one transient
            # 503/reset on an otherwise healthy striped fetch
            for attempt in (0, 1):
                try:
                    if ln > 0:
                        if faults.armed() and faults.injector() \
                                .take_ufs_error(self._fault_host):
                            raise faults.InjectedFaultError(
                                f"injected UFS fault for stripe {i} of "
                                f"block {fetch.desc.block_id}")
                        t_ufs = time.perf_counter() \
                            if fetch._span is not None else 0.0
                        data = ufs.read_range(fetch.desc.ufs_path,
                                              fetch.desc.offset + off, ln)
                        if fetch._span is not None:
                            fetch._note_ufs_ms(
                                (time.perf_counter() - t_ufs) * 1000.0)
                        if len(data) != ln:
                            raise FetchError(
                                f"short stripe read: {len(data)}B of "
                                f"{ln}B at +{off} of block "
                                f"{fetch.desc.block_id}")
                    else:
                        data = b""
                    self._m.counter("Worker.UfsFetchStripes").inc()
                    self._m.counter("Worker.UfsFetchBytes").inc(ln)
                    fetch._complete_stripe(i, data)
                    break
                except BaseException as e:  # noqa: BLE001
                    if attempt:
                        fetch._stripe_failed(ufs, e)
                        return
                    self._m.counter("Worker.UfsFetchStripeRetries").inc()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            executors = list(self._executors.values())
            self._executors.clear()
        for ex in executors:
            ex.shutdown(wait=False)
