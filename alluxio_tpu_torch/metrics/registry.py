"""Process metrics registry: counters, timers and gauges.

A copy of the part of ``alluxio_tpu/metrics/registry.py`` that the port
uses: the flat snapshot its sinks and the metrics heartbeat ship, and
the Prometheus text exposition of the worker's web endpoint (counters,
gauges and timer histograms; the JAX meters and trace exemplars are not
copied). Names keep the JAX package's ``Instance.Name`` form and the
loader emits the same names (``Client.JaxHbmHits``,
``Client.JaxShortCircuitBlocks``, ``Client.JaxStreamedBlocks``,
``Client.InputStall*``), so tools that read the JAX client's metrics read
the port's unchanged.
"""

from __future__ import annotations

import re
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

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
    """Latency reservoir of recent samples plus a lifetime count and
    lifetime cumulative bucket counts (the Prometheus histogram)."""

    #: classic Prometheus latency bucket bounds (seconds); lifetime
    #: counts keep the exposition series monotonic across scrapes
    HISTOGRAM_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                         1.0, 2.5, 5.0, 10.0)

    def __init__(self, reservoir: int = 1028) -> None:
        self._samples: deque = deque(maxlen=reservoir)
        self._count = 0
        self._total_s = 0.0
        self._bucket_counts = [0] * len(self.HISTOGRAM_BUCKETS)
        self._lock = threading.Lock()

    def update(self, seconds: float) -> None:
        with self._lock:
            self._count += 1
            self._total_s += seconds
            self._samples.append(seconds)
            for i, le in enumerate(self.HISTOGRAM_BUCKETS):
                if seconds <= le:
                    self._bucket_counts[i] += 1

    class _Ctx:
        def __init__(self, timer: "Timer") -> None:
            self._timer = timer

        def __enter__(self):
            self._t0 = time.monotonic()
            return self

        def __exit__(self, *exc):
            self._timer.update(time.monotonic() - self._t0)
            return False

    def time(self) -> "_Ctx":
        """A scope whose wall time is one sample."""
        return Timer._Ctx(self)

    def histogram(self) -> "tuple[List[int], float, int]":
        """Lifetime cumulative bucket counts (the last one +Inf) plus
        (sum, count)."""
        with self._lock:
            counts = list(self._bucket_counts)
            counts.append(self._count)
            return counts, self._total_s, self._count

    def recent(self, n: int) -> List[float]:
        """The last ``n`` samples (at most the reservoir), sorted."""
        with self._lock:
            return sorted(list(self._samples)[-n:]) if n > 0 else []

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

    @staticmethod
    def _prom_name(name: str) -> str:
        """Exposition-legal metric name: ``[a-zA-Z_:][a-zA-Z0-9_:]*``."""
        metric = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
        if metric and metric[0].isdigit():
            metric = "_" + metric
        return metric

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (# HELP/# TYPE preambles,
        ``_total``-suffixed counters, timer histograms with
        bucket/sum/count), as the JAX registry writes it."""
        with self._lock:
            counters = dict(self._counters)
            timers = dict(self._timers)
            gauges = dict(self._gauges)
        lines: List[str] = []

        def emit(name: str, kind: str, help_text: str) -> str:
            metric = self._prom_name(name)
            lines.append(f"# HELP {metric} {help_text}")
            lines.append(f"# TYPE {metric} {kind}")
            return metric

        for name, c in sorted(counters.items()):
            metric = emit(name + "_total", "counter", f"counter {name}")
            lines.append(f"{metric} {c.count}")
        for name, g in sorted(gauges.items()):
            try:
                value = float(g())
            except Exception:  # noqa: BLE001 - dead gauge: skip
                continue
            metric = emit(name, "gauge", f"gauge {name}")
            lines.append(f"{metric} {value}")
        for name, t in sorted(timers.items()):
            counts, total, n = t.histogram()
            metric = emit(name + "_seconds", "histogram",
                          f"latency histogram of {name}")
            for le, cum in zip(t.HISTOGRAM_BUCKETS, counts):
                lines.append(f'{metric}_bucket{{le="{le}"}} {cum}')
            lines.append(f'{metric}_bucket{{le="+Inf"}} {counts[-1]}')
            lines.append(f"{metric}_sum {total}")
            lines.append(f"{metric}_count {n}")
        return "\n".join(lines) + "\n"


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
