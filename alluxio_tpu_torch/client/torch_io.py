"""Device read path: cached blocks -> device tensors.

The port of ``alluxio_tpu/client/jax_io.py``. Ladder per block:

1. **Device-tier hit** — the block is already resident in the device page
   store: the "read" returns the live tensor; no host traffic at all.
2. **Host hit (short-circuit)** — block cached on a same-host worker:
   mmap -> zero-copy numpy view -> pinned staging -> asynchronous copy to
   the device, then the page store retains it for the next epoch.
3. **Streamed** — any other stream: its bytes are read, then (2)'s copy.

A producer thread does all host-side work (stream opens, mmap setup, page
pre-fault) ahead of the consumer; the consumer issues the host->device
copies, which run asynchronously on its current stream, and keeps
``prefetch`` of them in flight while it computes.

With a prefetch service, the agent's adopt thread fills the device tier
ahead of the consumer through :meth:`DeviceBlockLoader.prefetch_into_hbm`,
on a copy stream the loader owns; the consumer's current stream waits on
each such page's copy event before the page is handed out.
"""

from __future__ import annotations

import threading
import weakref
from collections import deque
from concurrent.futures import CancelledError
from concurrent.futures import TimeoutError as FuturesTimeoutError
from typing import Iterator, List, Optional, Sequence

import numpy as np

from alluxio_tpu_torch import native
from alluxio_tpu_torch.client.cache.hbm_store import (HbmPageStore,
                                                      host_to_device,
                                                      order_after, side_copy)
from alluxio_tpu_torch.client.cache.meta import PageId
from alluxio_tpu_torch.conf import Keys
from alluxio_tpu_torch.device import resolve_device
from alluxio_tpu_torch.metrics import metrics
from alluxio_tpu_torch.metrics.stall import (BUCKET_ADVICE, SIZE_BUCKETS,
                                             STALL_BUCKETS, size_bucket)
from alluxio_tpu_torch.utils.tracing import annotate, current_span

#: transfer prefetch depth when the caller passes none and ``fs`` has no
#: conf to read ``atpu.tpu.prefetch.buffer.batches`` from (its default)
DEFAULT_PREFETCH = 2

#: live StepStats instances backing the ONE process-level
#: Client.InputBoundFraction gauge
_LIVE_STEP_STATS: "weakref.WeakSet" = None  # type: ignore[assignment]
_GAUGE_LOCK = threading.Lock()


def _process_input_bound_fraction() -> float:
    with _GAUGE_LOCK:
        stats = list(_LIVE_STEP_STATS or ())
    if not stats:
        return 0.0
    wait = elapsed = 0.0
    for st in stats:
        w, e = st.window_totals()
        wait += w
        elapsed += e
    return (wait / elapsed) if elapsed > 0 else 0.0


class StepStats:
    """Input-stall attribution for one :class:`DeviceBlockLoader`.

    Every time the consumer waits on the loader pipeline, the wait is
    attributed to the serving tier of the block that eventually arrived.
    Exports ``Client.InputStall.<bucket>`` timers, additive
    ``Client.InputStallUs/Count/Bytes.<bucket>`` counters, the per-size
    and tier x size counters, and the rolling
    ``Client.InputBoundFraction`` gauge — the JAX client's names."""

    def __init__(self, window: int = 512) -> None:
        global _LIVE_STEP_STATS

        self._lock = threading.Lock()
        self._m = metrics()
        self.wait_s = {b: 0.0 for b in STALL_BUCKETS}
        self.count = {b: 0 for b in STALL_BUCKETS}
        self.bytes = {b: 0 for b in STALL_BUCKETS}
        self.size_wait_s = {b: 0.0 for b in SIZE_BUCKETS}
        self.size_count = {b: 0 for b in SIZE_BUCKETS}
        self.size_bytes = {b: 0 for b in SIZE_BUCKETS}
        self.cross_wait_s = {(t, s): 0.0 for t in STALL_BUCKETS
                             for s in SIZE_BUCKETS}
        self.cross_count = {(t, s): 0 for t in STALL_BUCKETS
                            for s in SIZE_BUCKETS}
        #: rolling (wait_s, elapsed_s) per consumed block
        self._window: deque = deque(maxlen=window)
        with _GAUGE_LOCK:
            if _LIVE_STEP_STATS is None:
                _LIVE_STEP_STATS = weakref.WeakSet()
            _LIVE_STEP_STATS.add(self)
        self._m.register_gauge("Client.InputBoundFraction",
                               _process_input_bound_fraction)

    def close(self) -> None:
        """Drop this collector from the process gauge."""
        with _GAUGE_LOCK:
            if _LIVE_STEP_STATS is not None:
                _LIVE_STEP_STATS.discard(self)

    def window_totals(self) -> "tuple[float, float]":
        """(waited_s, elapsed_s) over the rolling window."""
        with self._lock:
            return (sum(w for w, _ in self._window),
                    sum(e for _, e in self._window))

    def record(self, bucket: str, wait_s: float, nbytes: int,
               elapsed_s: float) -> None:
        if bucket not in self.wait_s:
            bucket = "unknown"
        sb = size_bucket(nbytes)
        with self._lock:
            self.wait_s[bucket] += wait_s
            self.count[bucket] += 1
            self.bytes[bucket] += nbytes
            self.size_wait_s[sb] += wait_s
            self.size_count[sb] += 1
            self.size_bytes[sb] += nbytes
            self.cross_wait_s[(bucket, sb)] += wait_s
            self.cross_count[(bucket, sb)] += 1
            self._window.append((wait_s, max(elapsed_s, wait_s)))
        us = int(wait_s * 1e6)
        self._m.timer(f"Client.InputStall.{bucket}").update(wait_s)
        self._m.counter(f"Client.InputStallSizeUs.{sb}").inc(us)
        self._m.counter(f"Client.InputStallSizeCount.{sb}").inc()
        self._m.counter(f"Client.InputStallUs.{bucket}").inc(us)
        self._m.counter(f"Client.InputStallCount.{bucket}").inc()
        self._m.counter(f"Client.InputStallBytes.{bucket}").inc(nbytes)
        self._m.counter(f"Client.InputStallCrossUs.{bucket}.{sb}").inc(us)
        self._m.counter(f"Client.InputStallCrossCount.{bucket}.{sb}").inc()

    def input_bound_fraction(self) -> float:
        """Share of recent wall time the consumer spent waiting for
        input (0 = compute-bound, 1 = fully input-bound)."""
        wait, elapsed = self.window_totals()
        return (wait / elapsed) if elapsed > 0 else 0.0

    def report(self) -> dict:
        """Ranked bottleneck verdict (the input doctor)."""
        with self._lock:
            wait = dict(self.wait_s)
            count = dict(self.count)
            nbytes = dict(self.bytes)
            s_wait = dict(self.size_wait_s)
            s_count = dict(self.size_count)
            s_bytes = dict(self.size_bytes)
            x_wait = dict(self.cross_wait_s)
            x_count = dict(self.cross_count)
        total = sum(wait.values())
        buckets = {}
        for b in STALL_BUCKETS:
            if not count[b]:
                continue
            buckets[b] = {
                "wait_s": round(wait[b], 6), "count": count[b],
                "bytes": nbytes[b],
                "share": round(wait[b] / total, 4) if total else 0.0,
            }
        ranked = sorted(buckets, key=lambda b: buckets[b]["wait_s"],
                        reverse=True)
        frac = self.input_bound_fraction()
        if not ranked:
            verdict = "no input-stall samples recorded"
        else:
            top = ranked[0]
            verdict = (f"input-bound {frac:.0%} of recent wall time; "
                       f"top bottleneck: {top} "
                       f"({buckets[top]['share']:.0%} of "
                       f"{total:.3f}s stall) — {BUCKET_ADVICE[top]}")
        size_buckets = {}
        for b in SIZE_BUCKETS:
            if not s_count[b]:
                continue
            by_source = {}
            for t in STALL_BUCKETS:
                if not x_count[(t, b)]:
                    continue
                by_source[t] = {
                    "wait_s": round(x_wait[(t, b)], 6),
                    "count": x_count[(t, b)],
                    "share": round(x_wait[(t, b)] / s_wait[b], 4)
                    if s_wait[b] else 0.0,
                }
            size_buckets[b] = {
                "wait_s": round(s_wait[b], 6), "count": s_count[b],
                "bytes": s_bytes[b],
                "share": round(s_wait[b] / total, 4) if total else 0.0,
                "by_source": by_source,
            }
        return {"total_wait_s": round(total, 6),
                "input_bound_fraction": round(frac, 4),
                "buckets": buckets, "ranked": ranked,
                "size_buckets": size_buckets,
                "verdict": verdict}


class DeviceBlockLoader:
    """Loads whole blocks of one or more files as device-resident
    tensors, with a device-tier retention cache and transfer prefetch.

    ``fs`` is duck-typed: ``get_status(path)`` gives ``.file_id`` and
    ``.block_ids``; ``open_file(path, info=, max_open_streams=1)
    .block_stream(i)`` gives a stream with ``numpy_view`` (short-circuit)
    or ``read_all_view`` / ``read_all``, plus ``source_bucket()``; its
    ``conf``, when it has one, gives the transfer prefetch depth that the
    caller does not pass. ``device=None`` means the current CUDA device."""

    def __init__(self, fs, paths: Sequence[str], *,
                 device=None, hbm_bytes: int = 0,
                 prefetch: Optional[int] = None, dtype=np.uint8,
                 prefetch_service=None) -> None:
        self._fs = fs
        self._dtype = np.dtype(dtype)
        self._device = resolve_device(device)
        self._hbm = HbmPageStore(hbm_bytes, self._device) \
            if hbm_bytes > 0 else None
        if prefetch is None:
            # double-buffer depth for the zero-copy iterator
            # (atpu.tpu.prefetch.buffer.batches, default 2)
            conf = getattr(fs, "conf", None)
            prefetch = DEFAULT_PREFETCH if conf is None else \
                conf.get_int(Keys.TPU_PREFETCH_BUFFER_BATCHES)
        self._prefetch = max(0, prefetch)
        # clairvoyant prefetch service (duck-typed, optional): set, the
        # loader consumes epochs in the oracle's seeded order, registers
        # its cursor via on_consume, and records hit/late/miss outcomes
        self._svc = prefetch_service
        self._epoch_counter = 0
        self._m = metrics()
        #: input doctor: per-tier wait attribution for this loader
        self.step_stats = StepStats()
        #: flat list of (path, block_index, page_id)
        self._plan: List[tuple] = []
        #: path -> master block ids
        self.block_ids_by_path: dict = {}
        self._infos = {}
        resolved = dict(prefetch_service.oracle.manifest.file_infos) \
            if prefetch_service is not None else {}
        for path in paths:
            info = resolved.get(str(path)) or fs.get_status(path)
            self._infos[path] = info
            self.block_ids_by_path[path] = list(info.block_ids)
            for i in range(len(info.block_ids)):
                self._plan.append((path, i, PageId(f"{info.file_id:x}", i)))
        # streams are per-thread: a stream holds per-block state, so
        # concurrent host_block callers must not share one
        self._tls = threading.local()
        self._all_streams: List = []
        self._streams_lock = threading.Lock()
        #: the producer thread's stream cache, published in its finally
        #: so early-exit retirement can close it from the consumer side
        self._producer_streams = None
        # ONE persistent producer thread across epochs: a fresh thread
        # per epoch would miss the thread-local stream cache and reopen
        # every stream each epoch
        self._producer_pool = None
        # at most one live epoch: starting a new one (or close()) cancels
        # the previous producer
        self._epoch_lock = threading.Lock()
        self._current_stop: Optional[threading.Event] = None
        self._closed = False
        #: the adopt thread's copy stream (a CUDA device tier fed by a
        #: prefetch service only)
        self._copy_stream = None
        if self._svc is not None and self._hbm is not None:
            if self._device.type == "cuda":
                import torch

                self._copy_stream = torch.cuda.Stream(device=self._device)
            self._svc.bind_hbm(self.prefetch_into_hbm)

    def __len__(self) -> int:
        return len(self._plan)

    @property
    def device(self):
        return self._device

    @property
    def plan(self) -> List[tuple]:
        """The load plan as public ``(path, block_index)`` pairs."""
        return [(path, i) for (path, i, _pid) in self._plan]

    def host_block(self, path: str, index: int):
        """Public host-side read of one block (zero-copy numpy view on the
        short-circuit path, else a streamed copy)."""
        return self._host_bytes(path, index)

    # -- single block --------------------------------------------------------
    def _host_bytes(self, path: str, index: int):
        """Host-side view of one block: zero-copy numpy over mmap when the
        short-circuit path applies, else a bytes copy from the stream."""
        streams = getattr(self._tls, "streams", None)
        if streams is None:
            streams = self._tls.streams = {}
        f = streams.get(path)
        if f is None:
            f = self._fs.open_file(path, info=self._infos.get(path),
                                   max_open_streams=1)
            with self._streams_lock:
                # closed-check INSIDE the lock: a thread racing close()
                # must not register a stream after close() swept them
                if self._closed:
                    f.close()
                    raise RuntimeError("loader is closed")
                self._all_streams.append(f)
            streams[path] = f
        stream = f.block_stream(index)
        view = getattr(stream, "numpy_view", None)
        if view is not None:
            self._m.counter("Client.JaxShortCircuitBlocks").inc()
            self._tls.last_bucket = "shm"
            return view(dtype=self._dtype)
        self._m.counter("Client.JaxStreamedBlocks").inc()
        reader = getattr(stream, "read_all_view", None)
        buf = reader() if reader is not None else stream.read_all()
        data = np.frombuffer(buf, dtype=self._dtype)
        # AFTER the read: only the stream knows what served it
        self._tls.last_bucket = stream.source_bucket()
        return data

    def _to_device(self, host):
        """Host -> device copy, timed under the ``device_put`` phase."""
        with annotate("atpu.loader.h2d"):
            sp = current_span()
            if sp is None:
                return host_to_device(host, self._device)
            import time as _time

            t_put = _time.perf_counter()
            arr = host_to_device(host, self._device)
            sp.phase("device_put", (_time.perf_counter() - t_put) * 1000.0)
            return arr

    def prefetch_into_hbm(self, ref) -> bool:
        """Prefetch-agent hook (the agent's adopt thread): host-read one
        block and adopt it into the device tier ahead of its consume. On
        a CUDA device the copy runs on the loader's copy stream, under the
        loader's device, and the page keeps the copy's event."""
        if self._hbm is None or self._closed:
            return False
        info = self._infos.get(ref.path)
        fid = info.file_id if info is not None else ref.file_id
        pid = PageId(f"{fid:x}", ref.block_index)
        if self._hbm.has(pid):
            return True
        host = self._host_bytes(ref.path, ref.block_index)
        if self._copy_stream is None:
            return self._hbm.adopt(pid, host_to_device(host, self._device))
        arr, ready = side_copy(host, self._device, self._copy_stream)
        return self._hbm.adopt(pid, arr, ready=ready)

    def load_block(self, plan_index: int):
        """One block as a device tensor (device-tier cached across epochs)."""
        if self._closed:
            raise RuntimeError("loader is closed")
        path, index, pid = self._plan[plan_index]
        if self._hbm is not None:
            lease = self._hbm.get(pid)
            if lease is not None:
                self._m.counter("Client.JaxHbmHits").inc()
                arr = lease.wait()
                # safe to unpin before returning: eviction only drops the
                # store's reference, so the consumer's tensor stays valid
                lease.close()
                return arr
        arr = self._to_device(self._host_bytes(path, index))
        if self._hbm is not None:
            self._hbm.adopt(pid, arr)  # no second transfer
        return arr

    # -- iteration -----------------------------------------------------------
    def __iter__(self) -> Iterator:
        return self.epoch()

    def _epoch_entries(self, epoch_no: int) -> List[tuple]:
        """The per-epoch load plan as ``(path, index, pid, ref)`` rows:
        the static file order without a prefetch service, else the
        oracle's seeded permutation for this epoch."""
        if self._svc is None:
            return [(p, i, pid, None) for (p, i, pid) in self._plan]
        entries = []
        for ref in self._svc.epoch_sequence(epoch_no):
            info = self._infos.get(ref.path)
            fid = info.file_id if info is not None else ref.file_id
            entries.append((ref.path, ref.block_index,
                            PageId(f"{fid:x}", ref.block_index), ref))
        return entries

    def epoch(self) -> Iterator:
        """Iterate all blocks as device tensors with transfer prefetch.

        Two-stage pipeline: a producer thread does ALL host-side work
        ahead of the consumer; the queue is bounded, and an abandoned
        generator unblocks the producer via a stop flag. A new epoch()
        cancels a stale one, whose iterator then fails loudly.

        Early consumer exit (break mid-epoch) retires the producer
        executor: the queue is drained, the producer's streams closed,
        and the ``loader-host-prefetch`` thread joined before control
        returns."""
        import queue as _q
        import time as _time

        q: _q.Queue = _q.Queue(maxsize=max(1, self._prefetch) + 1)
        stop = threading.Event()
        retire = threading.Event()
        SENTINEL = object()

        def producer(entries, gen):
            try:
                for (path, index, pid, ref) in entries:
                    if stop.is_set():
                        return
                    if self._hbm is not None:
                        lease = self._hbm.get(pid)
                        if lease is not None:
                            self._m.counter("Client.JaxHbmHits").inc()
                            arr, ready = lease.array, lease.ready
                            lease.close()
                            if ref is not None:
                                out = self._svc.on_consume(
                                    ref, resident_hint=True,
                                    generation=gen)
                                if out != "stale":
                                    self._svc.release(ref)
                            # the consumer orders its own stream after
                            # ``ready``: this thread's stream is not its
                            self._put(q, stop, (pid, arr, True, "hbm",
                                                arr.nbytes, ready))
                            continue
                    outcome = None
                    if ref is not None:
                        # classify BEFORE the read (ready state decides
                        # hit vs late)
                        outcome = self._svc.on_consume(ref,
                                                       generation=gen)
                        t0 = _time.monotonic()
                    with annotate("atpu.loader.host_read"):
                        with annotate("atpu.loader.view"):
                            host = self._host_bytes(path, index)
                        if host.size:
                            # pre-fault every page off the consumer's
                            # clock (natively: GIL-free, a byte a page)
                            with annotate("atpu.loader.prefault"):
                                native.prefault(host)
                    bucket = getattr(self._tls, "last_bucket", "unknown")
                    if ref is not None:
                        if outcome != "stale":
                            # a stale consume must NOT release: the new
                            # epoch's own consume releases the pin
                            self._svc.release(ref)
                        if outcome not in ("hit", "stale"):
                            self._svc.record_stall(
                                _time.monotonic() - t0)
                    self._put(q, stop, (pid, host, False, bucket,
                                        host.nbytes, None))
            except BaseException as e:  # noqa: BLE001 re-raised in consumer
                # a read failure must FAIL the epoch, not silently end
                # it short (a truncated epoch looks complete downstream)
                self._put(q, stop, ("__error__", e))
            finally:
                self._put(q, stop, SENTINEL)
                # publish this thread's stream cache for late retirement
                self._producer_streams = getattr(self._tls, "streams",
                                                 None)
                if retire.is_set():
                    self._close_streams_dict(self._producer_streams)

        with self._epoch_lock:
            if self._closed:
                # a pre-close generator first iterated after close()
                # must not resurrect the pool/streams
                raise RuntimeError("loader is closed")
            if self._current_stop is not None:
                self._current_stop.set()
            self._current_stop = stop
            if self._producer_pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._producer_pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="loader-host-prefetch")
            epoch_no = self._epoch_counter
            self._epoch_counter += 1
            gen = self._svc.begin_epoch(epoch_no) \
                if self._svc is not None else None
            fut = self._producer_pool.submit(producer,
                                             self._epoch_entries(epoch_no),
                                             gen)
        inflight: deque = deque()
        finished = False
        try:
            last_item_t = _time.monotonic()
            while True:
                wait_t0 = _time.monotonic()
                with annotate("atpu.loader.queue_wait"):
                    while True:
                        try:
                            item = q.get(timeout=0.5)
                            break
                        except _q.Empty:
                            if stop.is_set():
                                raise RuntimeError(
                                    "epoch cancelled: the loader was "
                                    "closed or a newer epoch() "
                                    "superseded this iterator")
                if item is SENTINEL:
                    break
                if item[0] == "__error__":
                    raise item[1]
                pid, data, on_device, bucket, nbytes, ready = item
                now = _time.monotonic()
                self.step_stats.record(bucket, now - wait_t0, nbytes,
                                       now - last_item_t)
                last_item_t = now
                outer = current_span()
                if outer is not None:
                    outer.phase("drain", (now - wait_t0) * 1000.0)
                if on_device:
                    arr = order_after(data, ready)
                else:
                    arr = self._to_device(data)
                    if self._hbm is not None:
                        self._hbm.adopt(pid, arr)  # no second transfer
                inflight.append(arr)
                while len(inflight) > self._prefetch:
                    yield inflight.popleft()
            while inflight:
                yield inflight.popleft()
            finished = True
        finally:
            with self._epoch_lock:
                cancelled = self._current_stop is not stop
                closed = self._closed
            early_exit = not finished and not cancelled and not closed
            if early_exit:
                retire.set()
            stop.set()
            self._drain(q)  # unblock a producer parked on the full queue
            try:
                fut.result(timeout=5)
            except CancelledError:  # close() shut the pool first
                pass
            except (TimeoutError, FuturesTimeoutError):
                if not cancelled:
                    # a live epoch's producer is wedged: surface it
                    raise
            # one last put can land between the first drain and the
            # producer observing stop: drain again now that it exited
            self._drain(q)
            if early_exit:
                with self._epoch_lock:
                    pool = None
                    if self._current_stop is stop:
                        self._current_stop = None
                        pool, self._producer_pool = \
                            self._producer_pool, None
                if pool is not None:
                    pool.shutdown(wait=True)
                    self._close_streams_dict(self._producer_streams)

    @staticmethod
    def _drain(q) -> None:
        import queue as _q

        while True:
            try:
                q.get_nowait()
            except _q.Empty:
                break

    def _close_streams_dict(self, streams) -> None:
        """Close a retiring thread's cached block streams. Clears the
        dict in place, so a second call is a no-op."""
        if not streams:
            return
        victims = list(streams.values())
        streams.clear()
        with self._streams_lock:
            for f in victims:
                if f in self._all_streams:
                    self._all_streams.remove(f)
        for f in victims:
            f.close()

    @staticmethod
    def _put(q, stop, item) -> None:
        """Hand ``item`` to the consumer, blocking while the queue is
        full, under ``atpu.loader.queue_put``."""
        import queue as _q

        with annotate("atpu.loader.queue_put"):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except _q.Full:
                    continue

    def hbm_stats(self) -> dict:
        if self._hbm is None:
            return {"hbm_bytes": 0}
        return {"hbm_bytes": self._hbm.used_bytes,
                "hbm_pages": self._hbm.page_count}

    def stall_report(self) -> dict:
        """Input-doctor verdict (see :meth:`StepStats.report`)."""
        return self.step_stats.report()

    def close(self) -> None:
        self.step_stats.close()
        if self._svc is not None:
            self._svc.bind_hbm(None)  # agent must not touch a dead loader
        with self._epoch_lock:
            self._closed = True
            if self._current_stop is not None:
                self._current_stop.set()  # unblock a parked producer
                self._current_stop = None
            pool, self._producer_pool = self._producer_pool, None
        if pool is not None:
            pool.shutdown(wait=True)
        with self._streams_lock:
            for f in self._all_streams:
                f.close()
            self._all_streams.clear()
        if self._hbm is not None:
            self._hbm.close()


def batched_device_iterator(loader: DeviceBlockLoader, *, record_bytes: int,
                            batch_size: int, drop_remainder: bool = True):
    """Group fixed-size records from uint8 block tensors into batches on
    the device. Records must not straddle blocks (the writer pads); a
    block's tail shorter than a record is dropped."""
    import torch

    pending = None
    for block in loader.epoch():
        n = block.shape[0] // record_bytes
        recs = block[:n * record_bytes].reshape(n, record_bytes)
        if pending is not None:
            recs = torch.cat([pending, recs], dim=0)
            pending = None
        n_full = recs.shape[0] // batch_size
        for b in range(n_full):
            yield recs[b * batch_size:(b + 1) * batch_size]
        rem = recs.shape[0] % batch_size
        if rem:
            pending = recs[-rem:]
    if pending is not None and not drop_remainder:
        yield pending
