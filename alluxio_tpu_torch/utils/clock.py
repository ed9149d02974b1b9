"""Clock abstraction with a manually steppable test clock (a copy of
``alluxio_tpu/utils/clock.py``).

Reference: ``core/common/src/main/java/alluxio/clock/{Clock,SystemClock,
ManualClock}.java`` — the manual clock is what makes TTL/lost-worker tests
deterministic.
"""

from __future__ import annotations

import threading
import time


class Clock:
    def millis(self) -> int:
        raise NotImplementedError

    def seconds(self) -> float:
        return self.millis() / 1000.0


class SystemClock(Clock):
    def millis(self) -> int:
        return time.time_ns() // 1_000_000


class ManualClock(Clock):
    """A clock tests can step forward."""

    def __init__(self, start_ms: int = 0) -> None:
        self._ms = start_ms
        self._lock = threading.Lock()

    def millis(self) -> int:
        with self._lock:
            return self._ms

    def add_time_ms(self, delta_ms: int) -> None:
        with self._lock:
            self._ms += delta_ms

    def set_time_ms(self, ms: int) -> None:
        with self._lock:
            self._ms = ms
