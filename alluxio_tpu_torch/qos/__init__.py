"""QoS primitives (a copy of ``alluxio_tpu/qos/__init__.py``): priority
classes, token buckets and tenant-scoped concurrency budgets.

- :class:`TokenBucket` / :class:`TokenBucketSet` — per-principal rate
  limiting with a retry-after hint, used by the master's RPC admission
  controller (``qos/admission.py``);
- :class:`PriorityExecutor` — a bounded executor that drains in
  priority order with per-tenant concurrency caps (the worker's
  per-mount UFS stripe executors); queued background work is overtaken
  by arriving on-demand work, and a queued fetch joined by an on-demand
  reader is promoted;
- :class:`PriorityTaskQueue` — the async cache manager's bounded queue;
- :class:`StripeBudget` — per-tenant cap on concurrent client-side
  stripe streams (``client/remote_read.py``).

With QoS off (the default) both queues drain in exact FIFO order with no
caps, and the stripe budget is unlimited."""

from __future__ import annotations

import heapq
import itertools
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

LOG = logging.getLogger(__name__)

__all__ = [
    "ON_DEMAND", "ASYNC_FILL", "PREFETCH", "PRIORITY_NAMES",
    "priority_from_name", "TokenBucket", "TokenBucketSet",
    "PriorityExecutor", "PriorityTaskQueue", "StripeBudget",
]

#: Priority classes, lowest number drains first.  ON_DEMAND is a reader
#: blocked RIGHT NOW; ASYNC_FILL is a client-issued passive cache fill
#: (the client already has the bytes); PREFETCH is speculative work for
#: a predicted future access.
ON_DEMAND = 0
ASYNC_FILL = 1
PREFETCH = 2

PRIORITY_NAMES = {ON_DEMAND: "ON_DEMAND", ASYNC_FILL: "ASYNC_FILL",
                  PREFETCH: "PREFETCH"}
_NAME_TO_PRIORITY = {v: k for k, v in PRIORITY_NAMES.items()}


def priority_from_name(name: str, default: int = ASYNC_FILL) -> int:
    """Wire string -> class; unknown strings fall back to ``default``
    (an old client naming a class this build dropped must not crash the
    worker)."""
    return _NAME_TO_PRIORITY.get(str(name or "").upper(), default)


class TokenBucket:
    """Classic token bucket with a *retry-after* answer.

    ``try_acquire`` never blocks: over-limit callers are the ones being
    shed, and making them queue inside the limiter would recreate the
    unbounded backlog admission control exists to prevent.  The returned
    hint is how long until one token accrues — what the master puts in
    the typed ``ResourceExhausted`` so clients back off instead of
    hammering.
    """

    __slots__ = ("rate", "burst", "_tokens", "_last", "_clock", "_lock")

    def __init__(self, rate: float, burst: float, *,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.rate = max(1e-9, float(rate))
        self.burst = max(1.0, float(burst))
        self._tokens = self.burst  # start full: a fresh principal is
        self._last = clock()       # not mid-flood by definition
        self._clock = clock
        self._lock = threading.Lock()

    def try_acquire(self, n: float = 1.0) -> Tuple[bool, float]:
        """``(admitted, retry_after_s)``; the hint is 0.0 on admit."""
        with self._lock:
            now = self._clock()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.rate)
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return True, 0.0
            return False, (n - self._tokens) / self.rate

    def available(self) -> float:
        with self._lock:
            now = self._clock()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.rate)
            self._last = now
            return self._tokens


class TokenBucketSet:
    """Keyed token buckets with bounded membership.

    The key space is attacker-controlled (any client can mint
    principals), so the map is capped: beyond ``max_keys`` the
    least-recently-USED bucket is evicted — O(1) via insertion-ordered
    dict, because a principal flood must not make every admission
    check O(cap).  An evicted flooding principal that comes back gets
    a fresh (full) bucket — one burst of grace, still bounded memory.
    """

    def __init__(self, rate: float, burst: float, *, max_keys: int = 4096,
                 clock: Callable[[], float] = time.monotonic) -> None:
        from collections import OrderedDict

        self.rate = float(rate)
        self.burst = float(burst)
        self._max = max(1, int(max_keys))
        self._clock = clock
        self._lock = threading.Lock()
        #: key -> bucket, ordered least- to most-recently used
        self._buckets: "OrderedDict[str, TokenBucket]" = OrderedDict()
        self.evictions = 0

    def bucket(self, key: str) -> TokenBucket:
        with self._lock:
            b = self._buckets.get(key)
            if b is None:
                if len(self._buckets) >= self._max:
                    self._buckets.popitem(last=False)  # LRU out
                    self.evictions += 1
                b = self._buckets[key] = TokenBucket(
                    self.rate, self.burst, clock=self._clock)
            else:
                self._buckets.move_to_end(key)
            return b

    def try_acquire(self, key: str, n: float = 1.0) -> Tuple[bool, float]:
        return self.bucket(key).try_acquire(n)

    def __len__(self) -> int:
        with self._lock:
            return len(self._buckets)


class _Task:
    __slots__ = ("priority", "seq", "fn", "args", "tenant", "group",
                 "stale")

    def __init__(self, priority: int, seq: int, fn, args, tenant: str,
                 group) -> None:
        self.priority = priority
        self.seq = seq
        self.fn = fn
        self.args = args
        self.tenant = tenant
        self.group = group
        self.stale = False  # superseded by a promoted copy

    def order(self) -> Tuple[int, int]:
        return (self.priority, self.seq)


class PriorityExecutor:
    """Bounded thread pool draining a priority queue with per-tenant
    concurrency caps — the enforcement point the worker's per-mount UFS
    stripe executors ride.

    Semantics:

    - tasks of a lower priority number run first; within a class,
      submission order (so ``prioritize=False`` — QoS disabled — is
      exactly the FIFO ThreadPoolExecutor it replaces);
    - an arriving ON_DEMAND task overtakes QUEUED background work;
      in-flight tasks are never interrupted (preempt-queued-only);
    - :meth:`promote` re-prioritizes queued tasks of a group — the
      coalescing path upgrades a queued PREFETCH fetch the moment an
      on-demand reader joins it;
    - a task whose tenant already runs ``tenant_cap`` tasks is passed
      over (parked) until one of that tenant's tasks finishes, so one
      flooding principal cannot occupy every executor slot however
      early it queued.  Parked work is counted in ``deferred``.

    ``submit`` after :meth:`shutdown` raises ``RuntimeError`` like the
    stdlib executor it replaces.
    """

    def __init__(self, max_workers: int, *, thread_name_prefix: str = "qos",
                 prioritize: bool = True, tenant_cap: int = 0) -> None:
        self._max_workers = max(1, int(max_workers))
        self._prefix = thread_name_prefix
        self._prioritize = bool(prioritize)
        self.tenant_cap = max(0, int(tenant_cap))
        self._heap: List[Tuple[Tuple[int, int], _Task]] = []
        self._parked: Dict[str, List[_Task]] = {}
        self._running: Dict[str, int] = {}
        self._threads: List[threading.Thread] = []
        self._cond = threading.Condition()
        self._seq = itertools.count()
        self._closed = False
        self._idle = 0
        #: live (non-stale, non-parked) heap entries — maintained so
        #: submit's spawn decision is O(1) instead of sweeping a
        #: flood-deep heap under the lock on every submission
        self._ready = 0
        self.deferred = 0   # tenant-cap park events
        self.promoted = 0   # queued tasks re-prioritized

    # ------------------------------------------------------------ submit
    def submit(self, fn, *args, priority: int = ON_DEMAND,
               tenant: str = "", group=None) -> None:
        with self._cond:
            if self._closed:
                raise RuntimeError("cannot submit after shutdown")
            if not self._prioritize:
                priority, tenant = 0, ""
            t = _Task(priority, next(self._seq), fn, args, tenant, group)
            heapq.heappush(self._heap, (t.order(), t))
            self._ready += 1
            if len(self._threads) < self._max_workers and \
                    self._ready > self._idle:
                th = threading.Thread(
                    target=self._run, daemon=True,
                    name=f"{self._prefix}-{len(self._threads)}")
                self._threads.append(th)
                th.start()
            self._cond.notify()

    def promote(self, group, priority: int) -> int:
        """Raise every queued (and parked) task of ``group`` at a lower
        priority to ``priority``; returns how many moved.  In-flight
        tasks are untouched — promotion reorders the queue, it does not
        preempt."""
        if not self._prioritize:
            return 0
        moved = 0
        with self._cond:
            for _, t in list(self._heap):
                if not t.stale and t.group == group and \
                        t.priority > priority:
                    # stale + clone keeps _ready balanced: -1 (stale
                    # discard pre-counted here) +1 (clone)
                    t.stale = True
                    clone = _Task(priority, next(self._seq), t.fn,
                                  t.args, t.tenant, t.group)
                    heapq.heappush(self._heap, (clone.order(), clone))
                    moved += 1
            for tasks in self._parked.values():
                for t in tasks:
                    if t.group == group and t.priority > priority:
                        # in-place: the unpark path picks the best-
                        # priority parked task, so this takes effect
                        # at the tenant's next free slot
                        t.priority = priority
                        moved += 1
            if moved:
                self.promoted += moved
                self._cond.notify_all()
        return moved

    # ------------------------------------------------------------- drain
    def _tenant_at_cap_locked(self, tenant: str) -> bool:
        return bool(self.tenant_cap) and tenant != "" and \
            self._running.get(tenant, 0) >= self.tenant_cap

    def _pop_locked(self) -> Optional[_Task]:
        """Highest-priority runnable task; tenants at cap are parked
        (re-queued by priority when one of their tasks ends)."""
        while self._heap:
            _, t = heapq.heappop(self._heap)
            if t.stale:
                continue  # _ready already dropped when it was staled
            self._ready -= 1
            if self._tenant_at_cap_locked(t.tenant):
                self._parked.setdefault(t.tenant, []).append(t)
                self.deferred += 1
                continue
            return t
        return None

    def _run(self) -> None:
        while True:
            with self._cond:
                self._idle += 1
                try:
                    while True:
                        task = self._pop_locked()
                        if task is not None:
                            break
                        # like ThreadPoolExecutor.shutdown(wait=False):
                        # no NEW submits, but already-queued (and
                        # parked) work still runs — dropping it would
                        # strand fetch waiters forever
                        if self._closed and not self._heap and \
                                not self._parked:
                            return
                        self._cond.wait()
                finally:
                    self._idle -= 1
                self._running[task.tenant] = \
                    self._running.get(task.tenant, 0) + 1
            try:
                task.fn(*task.args)
            except BaseException:  # noqa: BLE001 - stripe loops own errors
                LOG.debug("priority-executor task raised", exc_info=True)
            finally:
                with self._cond:
                    n = self._running.get(task.tenant, 0) - 1
                    if n > 0:
                        self._running[task.tenant] = n
                    else:
                        self._running.pop(task.tenant, None)
                    parked = self._parked.get(task.tenant)
                    if parked and not self._tenant_at_cap_locked(
                            task.tenant):
                        # best (priority, seq) first, NOT FIFO: a
                        # parked task promoted by a coalescing
                        # on-demand join must use the tenant's next
                        # slot ahead of its older background work
                        t2 = min(parked, key=_Task.order)
                        parked.remove(t2)
                        if not parked:
                            del self._parked[task.tenant]
                        heapq.heappush(self._heap, (t2.order(), t2))
                        self._ready += 1
                    self._cond.notify()

    def queued(self) -> int:
        with self._cond:
            return self._ready + \
                sum(len(v) for v in self._parked.values())

    def running_by_tenant(self) -> Dict[str, int]:
        with self._cond:
            return dict(self._running)

    def shutdown(self, wait: bool = False) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if wait:
            for th in self._threads:
                th.join(timeout=5)


class PriorityTaskQueue:
    """Bounded priority queue with ``queue.Queue`` task-accounting
    compatibility (``task_done`` / ``unfinished_tasks`` /
    ``all_tasks_done``), which ``AsyncCacheManager.wait_idle`` relies on.
    ``prioritize=False`` degrades to exact FIFO."""

    def __init__(self, maxsize: int, *, prioritize: bool = True) -> None:
        self._max = max(1, int(maxsize))
        self._prioritize = bool(prioritize)
        self._heap: List[Tuple[int, int, object]] = []
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self.all_tasks_done = threading.Condition(self._lock)
        self.unfinished_tasks = 0
        self._seq = itertools.count()

    def put_nowait(self, item, priority: int = 0) -> None:
        import queue as _q

        with self._lock:
            if len(self._heap) >= self._max:
                raise _q.Full
            if not self._prioritize:
                priority = 0
            heapq.heappush(self._heap,
                           (priority, next(self._seq), item))
            self.unfinished_tasks += 1
            self._not_empty.notify()

    def get(self, timeout: Optional[float] = None):
        import queue as _q

        deadline = None if timeout is None else \
            time.monotonic() + timeout
        with self._not_empty:
            while not self._heap:
                remaining = None if deadline is None else \
                    deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise _q.Empty
                self._not_empty.wait(remaining)
            return heapq.heappop(self._heap)[2]

    def task_done(self) -> None:
        with self.all_tasks_done:
            n = self.unfinished_tasks - 1
            if n < 0:
                raise ValueError("task_done() called too many times")
            self.unfinished_tasks = n
            if n == 0:
                self.all_tasks_done.notify_all()

    def qsize(self) -> int:
        with self._lock:
            return len(self._heap)


class StripeBudget:
    """Per-tenant cap on concurrent remote-read stripe streams.

    The client-side counterpart of the worker's tenant caps: a shared
    multi-tenant client process (FUSE mount, REST proxy) must not let
    one tenant's striped reads monopolize the DCN fan-out.  ``cap`` is
    read per call so a remediation/conf overlay can retune it live;
    ``cap <= 0`` means unlimited and costs one comparison.

    ``acquire(force=True)`` always succeeds (and is still counted):
    the frontier stripe of a read must never deadlock behind the
    budget — the cap shapes readahead and hedges, not liveness.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._held: Dict[str, int] = {}
        #: denied acquires (any kind); the metrics split
        #: deferred-stripes from suppressed-hedges at the call sites
        self.deferred = 0

    def acquire(self, tenant: str, cap: int, *, force: bool = False) -> bool:
        with self._lock:
            held = self._held.get(tenant, 0)
            if not force and cap > 0 and held >= cap:
                self.deferred += 1
                return False
            self._held[tenant] = held + 1
            return True

    def release(self, tenant: str) -> None:
        with self._lock:
            n = self._held.get(tenant, 0) - 1
            if n > 0:
                self._held[tenant] = n
            else:
                self._held.pop(tenant, None)

    def held(self, tenant: str) -> int:
        with self._lock:
            return self._held.get(tenant, 0)
