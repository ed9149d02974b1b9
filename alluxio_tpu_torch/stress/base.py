"""Shared stress-bench machinery: result schema, latency stats, and the
threaded closed-loop driver (a copy of ``alluxio_tpu/stress/base.py``).

Re-design of ``stress/common/src/main/java/alluxio/stress/
{BaseParameters.java:56,TaskResult,worker/IOTaskSummary.java}``: results
are a JSON line with throughput + latency percentiles; the driver runs N
closed-loop worker threads for a fixed duration (or op count) with an
optional shared token-bucket rate limiter (the MaxThroughput suite's
"target throughput" knob, ``cli/suite/MaxThroughput.java``).
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional

__all__ = ["BenchResult", "DriveResult", "drive", "percentiles",
           "RateLimiter"]


def percentiles(samples_s: List[float]) -> Dict[str, float]:
    """p50/p95/p99/max of latency samples, reported in microseconds
    (matching the reference's IOTaskSummary histogram fields)."""
    if not samples_s:
        return {"p50_us": 0.0, "p95_us": 0.0, "p99_us": 0.0, "max_us": 0.0}
    s = sorted(samples_s)
    n = len(s)

    def at(q: float) -> float:
        return round(1e6 * s[min(n - 1, int(q * n))], 1)

    return {"p50_us": at(0.50), "p95_us": at(0.95), "p99_us": at(0.99),
            "max_us": round(1e6 * s[-1], 1)}


@dataclasses.dataclass
class BenchResult:
    """One bench outcome; ``json_line()`` is the wire contract every
    stress CLI prints (one line, stdout)."""

    bench: str
    params: Dict[str, Any]
    metrics: Dict[str, Any]
    errors: int = 0
    duration_s: float = 0.0

    def json_line(self) -> str:
        return json.dumps({
            "bench": self.bench,
            "params": self.params,
            "metrics": self.metrics,
            "errors": self.errors,
            "duration_s": round(self.duration_s, 3),
        }, sort_keys=True)


class RateLimiter:
    """Shared token bucket: ``acquire()`` blocks until the global op rate
    is under ``ops_per_s``. Coarse (100ms refill) but fair enough for a
    throughput search."""

    def __init__(self, ops_per_s: float) -> None:
        self._rate = float(ops_per_s)
        self._tokens = 0.0
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def acquire(self) -> None:
        while True:
            with self._lock:
                now = time.monotonic()
                self._tokens = min(self._rate,
                                   self._tokens + (now - self._last) * self._rate)
                self._last = now
                if self._tokens >= 1.0:
                    self._tokens -= 1.0
                    return
                need = (1.0 - self._tokens) / self._rate
            time.sleep(min(need, 0.1))


@dataclasses.dataclass
class DriveResult:
    ops: int
    bytes: int
    errors: int
    latencies_s: List[float]
    wall_s: float

    @property
    def ops_per_s(self) -> float:
        return self.ops / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def mb_per_s(self) -> float:
        return self.bytes / self.wall_s / 1e6 if self.wall_s > 0 else 0.0


def drive(n_threads: int, op: Callable[[int, int], int], *,
          duration_s: float = 0.0, ops_per_thread: int = 0,
          rate_limiter: Optional[RateLimiter] = None,
          setup: Optional[Callable[[int], Any]] = None) -> DriveResult:
    """Closed-loop driver: each of ``n_threads`` threads calls
    ``op(thread_index, i)`` (returning bytes processed) until the wall
    clock passes ``duration_s`` OR it has issued ``ops_per_thread`` ops.
    ``setup(thread_index)`` runs once per thread before the clock starts
    (per-thread streams/clients — FileInStream is not thread-safe).
    Latencies are collected per-thread (no lock on the hot path).
    """
    if not duration_s and not ops_per_thread:
        raise ValueError("need duration_s or ops_per_thread")
    ctxs: List[Any] = [None] * n_threads
    if setup is not None:
        for t in range(n_threads):
            ctxs[t] = setup(t)
    lat: List[List[float]] = [[] for _ in range(n_threads)]
    counts = [0] * n_threads
    nbytes = [0] * n_threads
    errors = [0] * n_threads
    start_gate = threading.Barrier(n_threads + 1)
    stop = threading.Event()

    def worker(t: int) -> None:
        my_lat, i = lat[t], 0
        start_gate.wait()
        while not stop.is_set():
            if ops_per_thread and i >= ops_per_thread:
                break
            if rate_limiter is not None:
                rate_limiter.acquire()
                if stop.is_set():
                    break
            t0 = time.monotonic()
            try:
                nbytes[t] += op(t, i) or 0
                counts[t] += 1
            except Exception:  # noqa: BLE001 — counted, bench goes on
                errors[t] += 1
            my_lat.append(time.monotonic() - t0)
            i += 1

    threads = [threading.Thread(target=worker, args=(t,), daemon=True)
               for t in range(n_threads)]
    for th in threads:
        th.start()
    start_gate.wait()
    t0 = time.monotonic()
    if duration_s:
        stop.wait(duration_s)
        stop.set()
    for th in threads:
        th.join()
    wall = time.monotonic() - t0
    merged: List[float] = []
    for sub in lat:
        merged.extend(sub)
    return DriveResult(ops=sum(counts), bytes=sum(nbytes),
                       errors=sum(errors), latencies_s=merged, wall_s=wall)


def host_speed_stamp_ms() -> float:
    """10M-adds wall time in ms: the one host-speed calibration figure
    (CI-container CPU drifts 3-4x between allocations; GIL-bound op/s
    rows scale ~inversely with this). Used by the suite's
    host-calibration row and the bench's host-fallback rows under the
    SAME key name, ``python_10m_adds_ms``."""
    import time as _t

    t0 = _t.monotonic()
    x = 0
    for i in range(10_000_000):
        x += i
    return round((_t.monotonic() - t0) * 1000, 1)
