"""Parallel remote-read data plane: striped multi-stream reads, replica
fan-out, hedged requests, and zero-join chunk assembly (the port of
``alluxio_tpu/client/remote_read.py``).

A single ``read_block`` stream to one replica caps a remote read at one
connection's rate, and one slow worker sets the tail. This module makes
that path a pipelined, parallel subsystem:

- **striped multi-stream reads** — a read larger than one stripe is
  split into ranges fetched over concurrent ``read_block`` streams,
  fanned out across replicas when the master reports more than one
  location, and across pooled gRPC channels (distinct TCP connections)
  to a single worker otherwise (the Hoard / network-image-loading
  result: many modest streams beat one connection);
- **zero-join assembly** — stripes land via ``memoryview`` writes into
  ONE preallocated buffer; no per-chunk ``bytearray.extend`` and no
  final whole-read ``bytes()`` re-copy. The loader gets the buffer as a
  view (``numpy.frombuffer`` wraps it zero-copy);
- **pipelined windowing** — a bounded in-flight window keeps stripes
  streaming while the consumer drains, capping readahead past the
  contiguous frontier (and with it peak wasted work when a read dies);
- **hedged requests** — a stripe that exceeds a latency quantile of its
  worker's rolling EWMA is re-issued to another source; first answer
  wins, the loser's stream is cancelled.  Straggler robustness for
  free.

Observability: ``Client.RemoteRead{Stripes,Hedges,HedgeWins,Reroutes,
Bytes}`` counters, the ``Client.RemoteReadTtfb`` timer, the
size-bucketed ``Client.ReadLatency.*`` timers, and an
``atpu.client.remote_read`` span per striped read that joins the
caller's trace so the input doctor can attribute remote-read stalls.

One difference: each stripe's stream carries the read span's trace
context, so the worker's ``read_block`` spans join the read's trace as
its children. The JAX module opens its stripes on executor threads that
have no trace context, so their worker spans start traces of their own.
"""

from __future__ import annotations

import functools as _functools
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from alluxio_tpu_torch.client import fastpath
from alluxio_tpu_torch.metrics import metrics
from alluxio_tpu_torch.metrics.stall import size_bucket
from alluxio_tpu_torch.utils.exceptions import (
    BlockDoesNotExistError, UnavailableError,
)
from alluxio_tpu_torch.utils.striping import plan_stripes
from alluxio_tpu_torch.utils import tracing as _tracing

#: hedge delays below this never fire — on a same-host CI cluster the
#: EWMA can sit at microseconds, and hedging every stripe there is a
#: hedge storm, not tail protection
MIN_HEDGE_DELAY_S = 0.002

#: pooled channels (= distinct TCP connections) to ONE worker never
#: exceed this, whatever the stripe concurrency — the per-worker
#: connection budget against a single peer
MAX_POOLED_CHANNELS = 8


@dataclass(frozen=True)
class RemoteReadConf:
    """Tuning for the striped remote-read pipeline (see
    ``atpu.user.remote.read.*`` in ``conf/property_key.py``). A keyword
    constructor; :meth:`from_conf` reads the keys."""

    #: bytes per stripe; reads ≤ this ride the legacy single stream.
    #: 0 disables striping entirely (byte-identical legacy path).
    stripe_size: int = 4 << 20
    #: stripes of one read in flight concurrently
    concurrency: int = 4
    #: readahead cap: stripes are only issued while their offset is
    #: within this many bytes of the consumer's drain point
    window_bytes: int = 32 << 20
    #: latency quantile of a worker's rolling EWMA above which a stripe
    #: is hedged to another source; 0 disables hedging
    hedge_quantile: float = 0.95
    #: commit large stripe chunks/scratch through the native plan
    #: executor (``atpu.user.native.fastpath.enabled``): GIL-free
    #: memcpy into the assembly buffer; plain memoryview copy is the
    #: byte-identical fallback
    native_fastpath: bool = True
    #: per-tenant cap on concurrent stripe streams (incl. hedges)
    #: across every striped read in this process; 0 = unlimited.
    #: The frontier stripe of each read bypasses the cap (liveness).
    tenant_stripe_limit: int = 0
    #: the tenant these reads bill against (the client's principal)
    tenant: str = ""

    @classmethod
    def from_conf(cls, conf) -> "RemoteReadConf":
        from alluxio_tpu_torch.conf import Keys
        from alluxio_tpu_torch.security.user import get_client_user

        return cls(
            stripe_size=max(0, conf.get_bytes(
                Keys.USER_REMOTE_READ_STRIPE_SIZE)),
            concurrency=max(1, conf.get_int(
                Keys.USER_REMOTE_READ_CONCURRENCY)),
            window_bytes=max(0, conf.get_bytes(
                Keys.USER_REMOTE_READ_WINDOW_BYTES)),
            hedge_quantile=min(1.0, max(0.0, conf.get_float(
                Keys.USER_REMOTE_READ_HEDGE_QUANTILE))),
            native_fastpath=conf.get_bool(
                Keys.USER_NATIVE_FASTPATH_ENABLED),
            tenant_stripe_limit=max(0, conf.get_int(
                Keys.USER_QOS_STRIPE_LIMIT)),
            tenant=get_client_user(conf),
        )

    @property
    def enabled(self) -> bool:
        return self.stripe_size > 0


def choose_route(length: int, *, same_host_shm: bool = False,
                 batch=None, batch_ops: int = 1,
                 striped: Optional[RemoteReadConf] = None) -> str:
    """The read-plane routing decision, in one place:

    - ``"shm"``     — same-host + SHM transport live: mmap the segment,
                      zero RPC/serialize/copy per read
    - ``"batch"``   — a multi-op batch of small reads: coalesce into
                      ``read_many`` RPCs (one wire round trip per batch)
    - ``"striped"`` — a read larger than one stripe: the parallel
                      multi-stream plane below
    - ``"stream"``  — everything else: the legacy single ``read_block``
                      stream (and the byte-identical disabled path)

    Precedence is top-down: same-host beats everything (no wire at
    all), batching beats striping only because it is checked for small
    ops striping would never take. Every fast route falls back one row
    down on failure — the router can only make reads faster, never fail
    them. ``batch`` is a ``BatchReadConf`` (duck-typed to avoid a
    module cycle with ``block_streams``)."""
    if same_host_shm:
        return "shm"
    if batch is not None and batch.enabled and batch_ops > 1 and \
            length <= batch.max_op_bytes:
        return "batch"
    if striped is not None and striped.enabled and \
            length > striped.stripe_size:
        return "striped"
    return "stream"


@_functools.lru_cache(maxsize=64)
def _z_score(quantile: float) -> float:
    """Normal z-score of a quantile — cached: the hedger evaluates it
    for every in-flight stripe on every coordinator wake-up, always
    with the same configured quantile."""
    from statistics import NormalDist

    return NormalDist().inv_cdf(quantile)


class LatencyStats:
    """Rolling per-worker stripe-latency EWMA + EWMA absolute deviation
    (the TCP-RTO estimator shape).  The hedge threshold for quantile
    ``q`` is ``ewma + z(q) * dev`` — a normal-tail read of "this stripe
    is past the worker's q-quantile".  No threshold is produced until a
    worker has a few samples: hedging on zero history is a coin flip."""

    MIN_SAMPLES = 5
    _ALPHA = 0.2  # EWMA weight of the newest sample

    def __init__(self) -> None:
        self._lock = threading.Lock()
        #: key -> (ewma_s, ewma_abs_dev_s, samples)
        self._stats: Dict[str, Tuple[float, float, int]] = {}

    def observe(self, key: str, latency_s: float) -> None:
        with self._lock:
            prev = self._stats.get(key)
            if prev is None:
                self._stats[key] = (latency_s, latency_s / 2.0, 1)
                return
            ewma, dev, n = prev
            err = abs(latency_s - ewma)
            a = self._ALPHA
            self._stats[key] = (ewma + a * (latency_s - ewma),
                                dev + a * (err - dev), n + 1)

    @staticmethod
    def _z(quantile: float) -> float:
        return _z_score(min(0.999, max(0.5, quantile)))

    def hedge_delay_s(self, key: str, quantile: float) -> Optional[float]:
        """Seconds an in-flight stripe on ``key`` may run before it is
        past the worker's ``quantile`` and worth hedging; None while the
        worker has too little history to call anything a straggler."""
        if quantile <= 0.0:
            return None
        with self._lock:
            st = self._stats.get(key)
        if st is None or st[2] < self.MIN_SAMPLES:
            return None
        ewma, dev, _ = st
        return max(MIN_HEDGE_DELAY_S, ewma + self._z(quantile) * dev)

    def snapshot(self) -> Dict[str, Tuple[float, float, int]]:
        with self._lock:
            return dict(self._stats)


class ReadSource:
    """One independent path to block bytes — a replica, or one pooled
    channel (TCP connection) of a replica.

    ``open(offset, length, chunk_size)`` returns a *stream handle*: an
    iterable of ``{"data": bytes, "source": tier}`` messages covering
    exactly ``[offset, offset+length)`` of the block, with a
    ``cancel()`` method that aborts the underlying transfer (hedging
    cancels the loser).  ``worker_key`` groups sources that die together
    (all channels of one worker); ``key`` identifies the latency-EWMA
    bucket."""

    key: str = ""
    worker_key: str = ""
    address = None  # WorkerNetAddress for mark_failed plumbing

    def open(self, offset: int, length: int, chunk_size: int):
        raise NotImplementedError


class GrpcReadSource(ReadSource):
    """A replica worker reached over one pooled gRPC channel."""

    def __init__(self, worker, address, channel: int, *, block_id: int,
                 ufs: Optional[dict] = None, cache: bool = True) -> None:
        self._worker = worker
        self._block_id = block_id
        self._ufs = ufs
        self._cache = cache
        self.channel = channel
        self.address = address
        self.worker_key = address.key() if address is not None \
            else f"worker#{id(worker)}"
        self.key = self.worker_key if channel == 0 \
            else f"{self.worker_key}~{channel}"

    def open(self, offset: int, length: int, chunk_size: int):
        return self._worker.read_block_stream(
            self._block_id, offset=offset, length=length,
            chunk_size=chunk_size, ufs=self._ufs, cache=self._cache,
            channel=self.channel)


class _Attempt:
    """One in-flight stripe transfer (a primary, a re-route, or a
    hedge).  Direct attempts write chunks straight into the shared
    buffer under the stripe's write lock; hedges buffer into scratch
    and commit wholesale if they win."""

    __slots__ = ("stripe", "source", "direct", "is_hedge", "started",
                 "handle", "cancelled", "scratch")

    def __init__(self, stripe: int, source: ReadSource, *,
                 direct: bool, is_hedge: bool) -> None:
        self.stripe = stripe
        self.source = source
        self.direct = direct
        self.is_hedge = is_hedge
        self.started = time.perf_counter()
        self.handle = None
        self.cancelled = False
        self.scratch: Optional[bytearray] = None if direct else bytearray()


class StripedRead:
    """One parallel read of ``[offset, offset+length)`` of a block.

    The caller's thread is the coordinator: it waits on the scheduler
    condition, fires overdue hedges, and drains the contiguous frontier
    (``read_view`` drains instantly; ``iter_views`` at the consumer's
    pace, which is what the in-flight window meters against)."""

    def __init__(self, runtime: "RemoteReadRuntime", *, block_id: int,
                 sources: List[ReadSource], offset: int, length: int,
                 chunk_size: int = 1 << 20,
                 on_failed: Optional[Callable] = None) -> None:
        if not sources:
            raise UnavailableError(
                f"no sources for striped read of block {block_id}")
        self._rt = runtime
        self._conf = runtime.conf
        self.block_id = block_id
        self._sources = sources
        self._offset = offset
        self._n = max(0, length)
        self._chunk = max(1, chunk_size)
        self._on_failed = on_failed
        self._stripes = plan_stripes(self._n, self._conf.stripe_size)
        k = len(self._stripes)
        self._buf = bytearray(self._n)
        self._cond = threading.Condition()
        self._stripe_locks = [threading.Lock() for _ in range(k)]
        self._winner: List[Optional[_Attempt]] = [None] * k
        self._landed = [False] * k
        #: contiguous bytes received from stripe start by direct
        #: attempts (monotone): lets the consumer drain INTO the
        #: frontier stripe at chunk granularity, so streaming TTFB is
        #: O(chunk) like the single-stream path, not O(stripe). Safe
        #: across re-routes/hedges because every source serves the same
        #: block bytes — a rewrite repeats identical values.
        self._progress = [0] * k
        self._attempts: List[List[_Attempt]] = [[] for _ in range(k)]
        self._routed: List[set] = [set() for _ in range(k)]
        self._hedged = [False] * k
        self._frontier = 0          # first not-landed stripe index
        self._drained = 0           # bytes the consumer has taken
        self._next_submit = 0
        self._active = 0
        self._dead_workers: set = set()
        self._started = False
        #: a direct submit was denied by the tenant stripe budget; the
        #: coordinator polls instead of waiting indefinitely (budget
        #: frees on OTHER reads' completions, which don't notify us)
        self._budget_deferred = False
        #: bytes (range-relative) actually served when a source's
        #: stream ended cleanly short of its range — a shrunk UFS
        #: object served truncated, mirroring the legacy reader
        self._truncated_at: Optional[int] = None
        self._error: Optional[BaseException] = None
        self._last_failure: Optional[BaseException] = None
        self._first_byte_at: Optional[float] = None
        self._t0 = time.perf_counter()
        self.source_tag: Optional[str] = None  # serving tier of any chunk
        self.hedges = 0
        self.hedge_wins = 0
        self.reroutes = 0
        self._m = metrics()
        self._span = self._open_span()
        #: the context each stripe's stream carries to the worker
        self._traceparent = None if self._span is None else \
            _tracing.format_traceparent(_tracing.TraceContext(
                self._span.trace_id, self._span.span_id,
                self._span.sampled))
        #: phase accumulators (only written when this read is traced):
        #: executor queue wait and transfer ("wire") time of winning
        #: attempts, summed across stripes
        self._queue_ms = 0.0
        self._wire_ms = 0.0
        self._latency_recorded = False

    # -- tracing -------------------------------------------------------------
    def _open_span(self):
        t = _tracing.tracer()
        if not t.enabled:
            return None
        ctx = _tracing.current_trace_context()
        span = _tracing.Span(
            "atpu.client.remote_read", _tracing.new_span_id(),
            ctx.span_id if ctx else None,
            ctx.trace_id if ctx else _tracing.new_trace_id(),
            sampled=ctx.sampled if ctx else t._sample())
        span.tags = {"block_id": str(self.block_id),
                     "bytes": str(self._n),
                     "stripes": str(len(self._stripes)),
                     "sources": str(len(self._sources))}
        return span

    def _close_span(self) -> None:
        """Record the size-bucketed latency (``Client.ReadLatency.*``)
        once, with this read's trace id as its exemplar when the span is
        sampled, and finish and record this read's span."""
        if self._n > 0 and not self._latency_recorded:
            self._latency_recorded = True
            exemplar = self._span.trace_id \
                if self._span is not None and self._span.sampled else None
            self._m.timer(f"Client.ReadLatency.{size_bucket(self._n)}"
                          ).update(time.perf_counter() - self._t0,
                                   exemplar=exemplar)
        if self._span is None:
            return
        if self._queue_ms > 0.0:
            self._span.phase("queue_wait", self._queue_ms)
        if self._wire_ms > 0.0:
            self._span.phase("wire", self._wire_ms)
        self._span.duration_ms = (time.perf_counter() - self._t0) * 1000.0
        self._span.tags["hedges"] = str(self.hedges)
        self._span.tags["hedge_wins"] = str(self.hedge_wins)
        self._span.tags["reroutes"] = str(self.reroutes)
        if self._error is not None:
            self._span.error = \
                f"{type(self._error).__name__}: {self._error}"
        if self._span.sampled:
            _tracing.tracer().record(self._span)
        self._span = None

    # -- scheduling (all under self._cond) -----------------------------------
    def _frontier_bytes(self) -> int:
        if self._frontier >= len(self._stripes):
            return self._n
        return self._stripes[self._frontier][0] + \
            self._progress[self._frontier]

    def _pick_source_locked(self, stripe: int,
                            avoid_key: Optional[str] = None
                            ) -> Optional[ReadSource]:
        """Next healthy, untried source for a stripe — round-robin
        rotated by stripe index so concurrent stripes spread across the
        replica set; a hedge prefers a different worker than the slow
        attempt's (``avoid_key``)."""
        ns = len(self._sources)
        candidates = []
        for j in range(ns):
            s = self._sources[(stripe + j) % ns]
            if s.worker_key in self._dead_workers:
                continue
            if id(s) in self._routed[stripe]:
                continue
            candidates.append(s)
        if not candidates:
            return None
        if avoid_key is not None:
            for s in candidates:
                if s.worker_key != avoid_key:
                    return s
        return candidates[0]

    def _submit_locked(self, stripe: int, source: ReadSource, *,
                       direct: bool, is_hedge: bool,
                       force_budget: bool = False) -> Optional[_Attempt]:
        # tenant stripe budget FIRST, before any booking: a denied
        # submit must leave no trace so the coordinator simply retries
        # once budget frees.  The frontier stripe (and failure
        # re-routes) pass force_budget — the cap shapes readahead and
        # hedging, never liveness.
        if not self._rt.budget.acquire(self._conf.tenant,
                                       self._conf.tenant_stripe_limit,
                                       force=force_budget):
            if is_hedge:
                self._m.counter("Client.QosHedgesSuppressed").inc()
            else:
                self._m.counter("Client.QosStripesDeferred").inc()
                self._budget_deferred = True
            return None
        a = _Attempt(stripe, source, direct=direct, is_hedge=is_hedge)
        self._attempts[stripe].append(a)
        self._routed[stripe].add(id(source))
        self._active += 1
        try:
            self._rt.executor().submit(self._run_attempt, a)
        except BaseException as e:  # noqa: BLE001 - runtime shut down
            # un-book the attempt so the read fails instead of hanging
            # on a task that will never run (close() raced this read)
            self._attempts[stripe].remove(a)
            self._active -= 1
            self._rt.budget.release(self._conf.tenant)
            if self._error is None:
                self._error = UnavailableError(
                    f"remote-read executor unavailable: {e}")
                self._cancel_all_locked()
                self._cond.notify_all()
            return None
        return a

    def _submit_eligible_locked(self) -> None:
        window = self._conf.window_bytes
        k = len(self._stripes)
        self._budget_deferred = False
        while self._next_submit < k:
            i = self._next_submit
            if self._active >= self._conf.concurrency:
                return
            rel_off = self._stripes[i][0]
            # the frontier stripe is always admissible — a window
            # smaller than one stripe must not deadlock the read
            if i != self._frontier and window > 0 and \
                    rel_off >= self._drained + window:
                return
            src = self._pick_source_locked(i)
            if src is None:
                if self._active == 0 and self._error is None:
                    self._error = self._last_failure or UnavailableError(
                        f"no healthy sources left for block "
                        f"{self.block_id}")
                    self._cond.notify_all()
                return
            a = self._submit_locked(i, src, direct=True, is_hedge=False,
                                    force_budget=(i == self._frontier))
            if a is None:
                # budget-deferred (retry once a stream frees) or the
                # read just died on an executor failure
                return
            self._next_submit += 1

    def _fire_hedges_locked(self) -> None:
        q = self._conf.hedge_quantile
        if q <= 0.0 or len(self._sources) < 2:
            return
        now = time.perf_counter()
        for i in range(self._frontier, min(self._next_submit,
                                           len(self._stripes))):
            if self._landed[i] or self._hedged[i]:
                continue
            live = [a for a in self._attempts[i] if not a.cancelled]
            if len(live) != 1:
                continue
            a = live[0]
            if a.handle is None:
                continue  # still queued/opening: nothing to outrace
            delay = self._rt.stats.hedge_delay_s(a.source.key, q)
            if delay is None or now - a.started < delay:
                continue
            src = self._pick_source_locked(i,
                                           avoid_key=a.source.worker_key)
            if src is None:
                # no untried healthy source, and within one read the
                # candidate set only shrinks: stop considering this
                # stripe, or the overdue deadline would spin the
                # coordinator awake at ~1 kHz until the stripe lands
                self._hedged[i] = True
                continue
            # marked hedged either way: a budget-suppressed hedge is
            # given up, not retried — spinning the coordinator on an
            # overdue deadline while the tenant is at cap would burn
            # CPU for a race the budget says we cannot afford
            self._hedged[i] = True
            a2 = self._submit_locked(i, src, direct=False, is_hedge=True)
            if a2 is not None:
                self.hedges += 1
                self._m.counter("Client.RemoteReadHedges").inc()

    def _wait_timeout_locked(self) -> Optional[float]:
        """Coordinator wait bound: the earliest hedge deadline, tightened
        to a short poll while the tenant stripe budget is deferring our
        submissions (another read's completion frees budget without
        notifying this read's condition)."""
        t = self._next_hedge_deadline_locked()
        if self._budget_deferred:
            return 0.05 if t is None else min(t, 0.05)
        return t

    def _next_hedge_deadline_locked(self) -> Optional[float]:
        """Seconds until the earliest in-flight stripe becomes hedge-
        eligible; None when nothing will (wait for completions only)."""
        q = self._conf.hedge_quantile
        if q <= 0.0 or len(self._sources) < 2:
            return None
        now = time.perf_counter()
        best: Optional[float] = None
        for i in range(self._frontier, min(self._next_submit,
                                           len(self._stripes))):
            if self._landed[i] or self._hedged[i]:
                continue
            live = [a for a in self._attempts[i] if not a.cancelled]
            if len(live) != 1 or live[0].handle is None:
                continue
            delay = self._rt.stats.hedge_delay_s(live[0].source.key, q)
            if delay is None:
                continue
            remain = live[0].started + delay - now
            best = remain if best is None else min(best, remain)
        if best is None:
            return None
        return max(best, 0.001)

    def _cancel_all_locked(self) -> None:
        for attempts in self._attempts:
            for a in attempts:
                if not a.cancelled:
                    a.cancelled = True
                    if a.handle is not None:
                        try:
                            a.handle.cancel()
                        except Exception:  # noqa: BLE001 - already dead
                            pass

    # -- attempt side (executor threads) -------------------------------------
    def _native_copy(self, dst_off: int, data) -> bool:
        """Commit ``data`` into the assembly buffer at ``dst_off``
        through the native executor — a GIL-free memcpy, so a multi-MB
        stripe commit no longer stalls every other Python thread.
        False (fastpath off, library missing, small chunk, any native
        problem) means the caller does the plain memoryview copy,
        which is byte-identical."""
        if not self._conf.native_fastpath or \
                len(data) < fastpath.MIN_COPY_BYTES:
            return False
        return fastpath.copy_into(self._buf, dst_off, data, host="stripe")

    def _note_first_byte(self) -> None:
        if self._first_byte_at is not None:
            return
        with self._cond:
            if self._first_byte_at is None:
                self._first_byte_at = time.perf_counter()
                self._m.timer("Client.RemoteReadTtfb").update(
                    self._first_byte_at - self._t0)

    def _run_attempt(self, a: _Attempt) -> None:
        i = a.stripe
        rel_off, ln = self._stripes[i]
        lock = self._stripe_locks[i]
        buf = memoryview(self._buf)
        src_tag = None
        # the transfer clock starts HERE, not at submit: time spent
        # queued behind other attempts in the shared executor is not
        # the worker's latency — counting it would hedge queued stripes
        # into the same saturated queue and corrupt the EWMA
        now = time.perf_counter()
        if self._span is not None:
            with self._cond:
                self._queue_ms += (now - a.started) * 1000.0
        a.started = now
        try:
            token = _tracing.bind_remote_parent(self._traceparent)
            try:
                handle = a.source.open(self._offset + rel_off, ln,
                                       self._chunk)
            finally:
                _tracing.reset_remote_parent(token)
            with self._cond:
                if a.cancelled or self._error is not None:
                    try:
                        handle.cancel()
                    except Exception:  # noqa: BLE001
                        pass
                    self._attempt_gone_locked(a)
                    return
                a.handle = handle
            pos = 0
            for msg in handle:
                data = msg.get("data") or b""
                src_tag = msg.get("source", src_tag)
                if not data:
                    continue
                self._note_first_byte()
                if pos + len(data) > ln:
                    raise UnavailableError(
                        f"over-long stripe: worker sent {pos + len(data)}B "
                        f"for a {ln}B range of block {self.block_id}")
                if a.direct:
                    with lock:
                        if self._winner[i] is not None or a.cancelled:
                            try:
                                handle.cancel()
                            except Exception:  # noqa: BLE001
                                pass
                            with self._cond:
                                self._attempt_gone_locked(a)
                            return
                        if not self._native_copy(rel_off + pos, data):
                            buf[rel_off + pos:
                                rel_off + pos + len(data)] = data
                    with self._cond:
                        if pos + len(data) > self._progress[i]:
                            self._progress[i] = pos + len(data)
                            if i == self._frontier:
                                self._cond.notify_all()
                else:
                    a.scratch.extend(data)
                pos += len(data)
            if pos != ln:
                # a CLEANLY short stream is data, not sickness: the
                # source is serving a shorter object than the metadata
                # says (shrunk UFS object read-through — the worker
                # serves available bytes by design). Finish truncated
                # like the legacy single-stream reader did; raising
                # here would also blacklist a healthy worker.
                self._stripe_truncated(a, pos)
                return
            self._complete_attempt(a, src_tag)
        except BaseException as e:  # noqa: BLE001 - routed, not raised
            self._attempt_failed(a, e)

    def _attempt_gone_locked(self, a: _Attempt) -> None:
        """Remove a finished/cancelled attempt from the live set and
        wake the coordinator so it can resubmit within the window.
        Every booked attempt holds exactly one tenant-budget unit
        (acquired in ``_submit_locked``); it is returned here."""
        try:
            self._attempts[a.stripe].remove(a)
        except ValueError:
            pass
        self._active -= 1
        self._rt.budget.release(self._conf.tenant)
        self._cond.notify_all()

    def _complete_attempt(self, a: _Attempt, src_tag: Optional[str]) -> None:
        i = a.stripe
        rel_off, ln = self._stripes[i]
        lock = self._stripe_locks[i]
        with lock:
            if self._winner[i] is not None:
                with self._cond:
                    self._attempt_gone_locked(a)
                return
            self._winner[i] = a
            if not a.direct and not self._native_copy(rel_off, a.scratch):
                memoryview(self._buf)[rel_off:rel_off + ln] = a.scratch
        latency = time.perf_counter() - a.started
        self._rt.stats.observe(a.source.key, latency)
        self._m.counter("Client.RemoteReadStripes").inc()
        self._m.counter("Client.RemoteReadBytes").inc(ln)
        with self._cond:
            if self._span is not None:
                # winning transfers only: the read was blocked on these
                self._wire_ms += latency * 1000.0
            self._attempt_gone_locked(a)
            self._landed[i] = True
            if src_tag is not None:
                self.source_tag = src_tag
            if a.is_hedge:
                self.hedge_wins += 1
                self._m.counter("Client.RemoteReadHedgeWins").inc()
            # the loser of a hedged stripe is pure waste now: cancel it
            for other in list(self._attempts[i]):
                if not other.cancelled:
                    other.cancelled = True
                    if other.handle is not None:
                        try:
                            other.handle.cancel()
                        except Exception:  # noqa: BLE001
                            pass
            while self._frontier < len(self._stripes) and \
                    self._landed[self._frontier]:
                self._frontier += 1
            self._submit_eligible_locked()
            self._cond.notify_all()

    def _stripe_truncated(self, a: _Attempt, served: int) -> None:
        """Accept a truncated stripe and finish the read at the
        truncation point: land this and every later stripe (their bytes
        will never arrive) and cancel their in-flight attempts. Earlier
        stripes keep streaming — the data before the point is real."""
        i = a.stripe
        rel_off, ln = self._stripes[i]
        commit = False
        with self._stripe_locks[i]:
            if self._winner[i] is None:
                self._winner[i] = a
                commit = True
                if not a.direct and served > 0 and not self._native_copy(
                        rel_off, memoryview(a.scratch)[:served]):
                    memoryview(self._buf)[rel_off:rel_off + served] = \
                        memoryview(a.scratch)[:served]
        with self._cond:
            self._attempt_gone_locked(a)
            if not commit or self._error is not None:
                return
            point = rel_off + served
            if self._truncated_at is None or point < self._truncated_at:
                self._truncated_at = point
            for j in range(i, len(self._stripes)):
                if not self._landed[j]:
                    self._landed[j] = True
                    for other in self._attempts[j]:
                        if not other.cancelled:
                            other.cancelled = True
                            if other.handle is not None:
                                try:
                                    other.handle.cancel()
                                except Exception:  # noqa: BLE001
                                    pass
            self._next_submit = len(self._stripes)
            while self._frontier < len(self._stripes) and \
                    self._landed[self._frontier]:
                self._frontier += 1
            self._cond.notify_all()

    def _attempt_failed(self, a: _Attempt, exc: BaseException) -> None:
        with self._cond:
            self._attempt_gone_locked(a)
            i = a.stripe
            if a.cancelled or self._landed[i] or self._error is not None:
                return  # benign: we lost a hedge race or the read died
            self._last_failure = exc
            self._dead_workers.add(a.source.worker_key)
            if self._on_failed is not None and \
                    not isinstance(exc, BlockDoesNotExistError):
                # a missing block is a stale location, not a sick
                # worker: route around it here without poisoning the
                # store's failed-worker memory
                try:
                    self._on_failed(a.source.address)
                except Exception:  # noqa: BLE001 - advisory
                    pass
            live = [x for x in self._attempts[i] if not x.cancelled]
            if live:
                return  # the stripe's hedge is still running; it decides
            src = self._pick_source_locked(i)
            if src is None:
                self._error = exc
                self._cancel_all_locked()
                self._cond.notify_all()
                return
            self.reroutes += 1
            self._m.counter("Client.RemoteReadReroutes").inc()
            # sole surviving attempt for the stripe: direct writes are
            # safe again (the failed writer is finished by definition).
            # NOT a hedge even when the failed attempt was one — this
            # transfer races nothing, and counting it as a hedge win
            # would inflate the rate operators tune hedge.quantile by.
            # force_budget: a budget-denied re-route would orphan the
            # stripe forever (it is behind _next_submit and has no
            # live attempt left to finish it) — repair beats the cap
            self._submit_locked(i, src, direct=True, is_hedge=False,
                                force_budget=True)

    # -- consumer side -------------------------------------------------------
    def _start_locked(self) -> None:
        if not self._started:
            self._started = True
            self._submit_eligible_locked()

    def _effective_n(self) -> int:
        return self._n if self._truncated_at is None \
            else min(self._n, self._truncated_at)

    def read_view(self) -> memoryview:
        """Assemble the whole range and return it as a zero-copy view
        over the preallocated buffer (drains the frontier instantly, so
        the window only meters in-flight stripes). A truncated source
        (shrunk object) shortens the view, like the legacy reader."""
        if self._n == 0:
            self._close_span()
            return memoryview(b"")
        try:
            with self._cond:
                self._start_locked()
                while self._frontier < len(self._stripes) and \
                        self._error is None:
                    self._drained = self._frontier_bytes()
                    self._submit_eligible_locked()
                    self._fire_hedges_locked()
                    self._cond.wait(self._wait_timeout_locked())
                if self._error is not None:
                    raise self._error
                self._drained = self._n
                return memoryview(self._buf)[:self._effective_n()]
        finally:
            self._close_span()

    def iter_views(self, chunk_size: int = 1 << 20) -> Iterator[memoryview]:
        """Yield the range in ascending order, each chunk as soon as
        the stripe containing it lands; stripes are only issued while
        within ``window_bytes`` of the consumer's drain point, so a
        slow consumer bounds in-flight memory instead of buffering the
        whole read.

        ``read_view`` (instant drain) is what the block streams use
        today; this is the drain-paced surface for sequential
        streamers (FUSE/proxy-style consumers, the remote-read bench's
        TTFB probe) and is where the window conf actually meters."""
        chunk_size = max(1, chunk_size)
        pos = 0
        mv = memoryview(self._buf)
        try:
            while pos < self._effective_n():
                with self._cond:
                    self._start_locked()
                    while self._frontier_bytes() <= pos and \
                            pos < self._effective_n() and \
                            self._error is None:
                        # resubmit on every wake: budget-deferred
                        # stripes must go out the moment another
                        # read's completion frees tenant budget (the
                        # 50ms poll exists for exactly this)
                        self._submit_eligible_locked()
                        self._fire_hedges_locked()
                        self._cond.wait(self._wait_timeout_locked())
                    if self._error is not None:
                        raise self._error
                    upper = min(self._frontier_bytes(),
                                self._effective_n())
                while pos < upper:
                    n = min(chunk_size, upper - pos)
                    yield mv[pos:pos + n]
                    pos += n
                    with self._cond:
                        self._drained = pos
                        self._submit_eligible_locked()
        finally:
            with self._cond:
                if pos < self._effective_n() and self._error is None:
                    # consumer abandoned the read: stop the transfers
                    self._error = UnavailableError("read abandoned")
                    self._cancel_all_locked()
            self._close_span()


class RemoteReadRuntime:
    """Per-client runtime shared by all striped reads: the stripe
    executor, the rolling per-worker latency stats the hedger consults,
    and the conf.  Owned (and closed) by ``BlockStoreClient``."""

    def __init__(self, conf: Optional[RemoteReadConf] = None) -> None:
        from alluxio_tpu_torch.qos import StripeBudget

        self.conf = conf or RemoteReadConf()
        self.stats = LatencyStats()
        #: tenant-scoped cap on concurrent stripe streams across every
        #: striped read in this runtime (atpu.user.qos.stripe.limit);
        #: the cap itself lives in the (swappable) conf, so retunes
        #: apply live
        self.budget = StripeBudget()
        self._ex: Optional[ThreadPoolExecutor] = None
        self._closed = False
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self.conf.enabled

    def executor(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._closed:
                # close() already drained; recreating here would leak
                # an executor no shutdown will ever see
                raise UnavailableError("remote-read runtime is closed")
            if self._ex is None:
                # room for a few concurrent striped reads plus their
                # hedges before attempts queue behind each other
                self._ex = ThreadPoolExecutor(
                    max_workers=max(8, self.conf.concurrency * 4),
                    thread_name_prefix="remote-read")
            return self._ex

    def read(self, *, block_id: int, sources: List[ReadSource],
             offset: int, length: int, chunk_size: int = 1 << 20,
             on_failed: Optional[Callable] = None) -> StripedRead:
        return StripedRead(self, block_id=block_id, sources=sources,
                           offset=offset, length=length,
                           chunk_size=chunk_size, on_failed=on_failed)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            ex, self._ex = self._ex, None
        if ex is not None:
            ex.shutdown(wait=False)
