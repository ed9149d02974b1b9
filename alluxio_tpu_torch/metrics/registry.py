"""Process metrics registry: counters, meters, timers and gauges.

A copy of ``alluxio_tpu/metrics/registry.py``: the flat snapshot the
sinks and the metrics heartbeat ship (a meter as its count and its
``.rate1m``), and the Prometheus text exposition of the web endpoints
(counters, meters, gauges and timer histograms, each bucket with the
OpenMetrics exemplar of the last sampled trace that landed in it).
Names keep the JAX package's ``Instance.Name`` form and the loader emits
the same names (``Client.JaxHbmHits``, ``Client.JaxShortCircuitBlocks``,
``Client.JaxStreamedBlocks``, ``Client.InputStall*``), so tools that
read the JAX client's metrics read the port's unchanged.
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

    def dec(self, n: int = 1) -> None:
        self.inc(-n)

    @property
    def count(self) -> int:
        with self._lock:
            return self._value


class Meter:
    """Rate meter: counts events, reports 1-minute-window rate."""

    __slots__ = ("_count", "_window", "_lock")

    def __init__(self) -> None:
        self._count = 0
        self._window: deque = deque()
        self._lock = threading.Lock()

    def mark(self, n: int = 1) -> None:
        now = time.monotonic()
        with self._lock:
            self._count += n
            self._window.append((now, n))
            self._trim(now)

    def _trim(self, now: float) -> None:
        while self._window and now - self._window[0][0] > 60.0:
            self._window.popleft()

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def one_minute_rate(self) -> float:
        now = time.monotonic()
        with self._lock:
            self._trim(now)
            total = sum(n for _, n in self._window)
            return total / 60.0


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
        # bucket index -> (trace_id, observed seconds, unix ts): the most
        # recent sampled trace that landed in that bucket, so the
        # exposition can link slow buckets straight to a trace
        self._exemplars: Dict[int, "tuple[str, float, float]"] = {}
        self._lock = threading.Lock()

    def update(self, seconds: float, exemplar: Optional[str] = None) -> None:
        """One sample; ``exemplar`` (a trace id) becomes its bucket's
        exemplar."""
        with self._lock:
            self._count += 1
            self._total_s += seconds
            self._samples.append(seconds)
            idx = len(self.HISTOGRAM_BUCKETS)  # +Inf
            for i, le in enumerate(self.HISTOGRAM_BUCKETS):
                if seconds <= le:
                    self._bucket_counts[i] += 1
                    idx = min(idx, i)
            if exemplar is not None:
                self._exemplars[idx] = (exemplar, seconds, time.time())

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

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def histogram(self) -> "tuple[List[int], float, int]":
        """Lifetime cumulative bucket counts (the last one +Inf) plus
        (sum, count)."""
        with self._lock:
            counts = list(self._bucket_counts)
            counts.append(self._count)
            return counts, self._total_s, self._count

    def exemplars(self) -> "Dict[int, tuple[str, float, float]]":
        """Bucket index -> (trace_id, seconds, unix_ts); index
        ``len(HISTOGRAM_BUCKETS)`` is the +Inf bucket."""
        with self._lock:
            return dict(self._exemplars)

    def recent(self, n: int) -> List[float]:
        """The last ``n`` samples (at most the reservoir), sorted."""
        with self._lock:
            return sorted(list(self._samples)[-n:]) if n > 0 else []

    def percentile(self, p: float) -> float:
        """The ``p``-th percentile (0-100) of the reservoir; 0 when empty."""
        with self._lock:
            if not self._samples:
                return 0.0
            s = sorted(self._samples)
        return s[min(len(s) - 1, int(p / 100.0 * len(s)))]

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
        self._meters: Dict[str, Meter] = {}
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

    def meter(self, name: str) -> Meter:
        name = self._name(name)
        with self._lock:
            return self._meters.setdefault(name, Meter())

    def timer(self, name: str) -> Timer:
        name = self._name(name)
        with self._lock:
            return self._timers.setdefault(name, Timer())

    def register_gauge(self, name: str, fn: Callable[[], float]) -> None:
        name = self._name(name)
        with self._lock:
            self._gauges[name] = fn

    def snapshot(self) -> Dict[str, float]:
        """Flat name -> value map (counters, meter counts and 1-minute
        rates, gauges, timer summaries)."""
        out: Dict[str, float] = {}
        with self._lock:
            counters = dict(self._counters)
            meters = dict(self._meters)
            timers = dict(self._timers)
            gauges = dict(self._gauges)
        for n, c in counters.items():
            out[n] = c.count
        for n, m in meters.items():
            out[n] = m.count
            out[n + ".rate1m"] = m.one_minute_rate
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
        bucket/sum/count and OpenMetrics exemplars), as the JAX registry
        writes it."""
        with self._lock:
            counters = dict(self._counters)
            meters = dict(self._meters)
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
        for name, m in sorted(meters.items()):
            metric = emit(name + "_total", "counter", f"meter {name}")
            lines.append(f"{metric} {m.count}")
            metric = emit(name + "_rate1m", "gauge",
                          f"1-minute rate of {name}")
            lines.append(f"{metric} {m.one_minute_rate}")
        for name, g in sorted(gauges.items()):
            try:
                value = float(g())
            except Exception:  # noqa: BLE001 - dead gauge: skip
                continue
            metric = emit(name, "gauge", f"gauge {name}")
            lines.append(f"{metric} {value}")
        for name, t in sorted(timers.items()):
            counts, total, n = t.histogram()
            ex = t.exemplars()
            metric = emit(name + "_seconds", "histogram",
                          f"latency histogram of {name}")

            def bucket_line(le: str, cum: int, idx: int) -> str:
                line = f'{metric}_bucket{{le="{le}"}} {cum}'
                e = ex.get(idx)
                if e is not None:
                    # OpenMetrics exemplar: links the bucket to a
                    # representative trace id for drill-down
                    tid, val, ts = e
                    line += (f' # {{trace_id="{tid}"}}'
                             f" {val:.6f} {ts:.3f}")
                return line

            for i, (le, cum) in enumerate(
                    zip(t.HISTOGRAM_BUCKETS, counts)):
                lines.append(bucket_line(str(le), cum, i))
            lines.append(bucket_line("+Inf", counts[-1],
                                     len(t.HISTOGRAM_BUCKETS)))
            lines.append(f"{metric}_sum {total}")
            lines.append(f"{metric}_count {n}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._meters.clear()
            self._timers.clear()
            self._gauges.clear()


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


def reset_metrics() -> None:
    """Drop the process-default registry; the next ``metrics()`` makes
    a new one."""
    global _default
    with _default_lock:
        _default = None
