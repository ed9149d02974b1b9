"""Process metrics registry: counters, timers and gauges.

A copy of the part of ``alluxio_tpu/metrics/registry.py`` that the device
data plane uses. Names keep the JAX package's ``Instance.Name`` form and
the loader emits the same names (``Client.JaxHbmHits``,
``Client.JaxShortCircuitBlocks``, ``Client.JaxStreamedBlocks``,
``Client.InputStall*``), so tools that read the JAX client's metrics read
the port's unchanged.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Dict, Optional

_INSTANCES = ("Master", "Worker", "Client", "JobMaster", "JobWorker",
              "Cluster", "Process")


class Counter:
    __slots__ = ("_value", "_lock")

    def __init__(self) -> None:
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def count(self) -> int:
        with self._lock:
            return self._value


class Timer:
    """Latency reservoir of recent samples plus a lifetime count."""

    def __init__(self, reservoir: int = 1028) -> None:
        self._samples: deque = deque(maxlen=reservoir)
        self._count = 0
        self._total_s = 0.0
        self._lock = threading.Lock()

    def update(self, seconds: float) -> None:
        with self._lock:
            self._count += 1
            self._total_s += seconds
            self._samples.append(seconds)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            samples = sorted(self._samples)
            count = self._count
            total = self._total_s

        def pct(p: float) -> float:
            if not samples:
                return 0.0
            return samples[min(len(samples) - 1,
                               int(p / 100.0 * len(samples)))]

        return {"count": count, "p50": pct(50), "p95": pct(95),
                "p99": pct(99),
                "mean": (total / count) if count else 0.0}


class MetricsRegistry:
    def __init__(self, instance: str = "Process") -> None:
        self.instance = instance
        self._counters: Dict[str, Counter] = {}
        self._timers: Dict[str, Timer] = {}
        self._gauges: Dict[str, Callable[[], float]] = {}
        self._lock = threading.Lock()

    def _name(self, name: str) -> str:
        return name if "." in name and name.split(".", 1)[0] in _INSTANCES \
            else f"{self.instance}.{name}"

    def counter(self, name: str) -> Counter:
        name = self._name(name)
        with self._lock:
            return self._counters.setdefault(name, Counter())

    def timer(self, name: str) -> Timer:
        name = self._name(name)
        with self._lock:
            return self._timers.setdefault(name, Timer())

    def register_gauge(self, name: str, fn: Callable[[], float]) -> None:
        name = self._name(name)
        with self._lock:
            self._gauges[name] = fn

    def snapshot(self) -> Dict[str, float]:
        """Flat name -> value map (counters, gauges, timer summaries)."""
        out: Dict[str, float] = {}
        with self._lock:
            counters = dict(self._counters)
            timers = dict(self._timers)
            gauges = dict(self._gauges)
        for n, c in counters.items():
            out[n] = c.count
        for n, t in timers.items():
            for k, v in t.snapshot().items():
                out[f"{n}.{k}"] = v
        for n, g in gauges.items():
            try:
                out[n] = float(g())
            except Exception:  # noqa: BLE001 - a dead gauge is skipped
                pass
        return out


_default: Optional[MetricsRegistry] = None
_default_lock = threading.Lock()


def metrics(instance: Optional[str] = None) -> MetricsRegistry:
    """Process-default registry (set ``instance`` on first call in a process)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricsRegistry(instance or "Process")
        elif instance is not None:
            _default.instance = instance
        return _default
