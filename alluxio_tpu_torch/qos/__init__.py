"""Worker QoS priority classes and the async-cache queue: a copy of the
part of ``alluxio_tpu/qos/__init__.py`` that the worker's async cache
uses. With QoS off (the default) the queue is exact FIFO; admission
control, the stripe executors and tenant caps are not ported."""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import List, Optional, Tuple

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
