"""Process pause monitor — the JvmPauseMonitor analogue (a copy of
``alluxio_tpu/utils/pause_monitor.py``).

Re-design of ``core/common/src/main/java/alluxio/util/
JvmPauseMonitor.java:42`` (started at ``AlluxioMasterProcess.java:
265-273``): a daemon thread sleeps a short interval and measures the
overshoot. A large overshoot means the PROCESS stalled — GC pressure,
GIL starvation from a native extension, CFS throttling, a swapping
host — exactly the stalls that make heartbeats miss and elections
fire spuriously. Pauses are logged and counted into the metrics
registry so ``fsadmin report``/Prometheus surface them.
"""

from __future__ import annotations

import logging
import threading
import time

LOG = logging.getLogger(__name__)


class PauseMonitor:
    """Sleep-drift stall detector."""

    def __init__(self, *, interval_s: float = 0.5,
                 warn_s: float = 1.0, error_s: float = 5.0,
                 metrics=None) -> None:
        self._interval = interval_s
        self._warn = warn_s
        self._error = error_s
        if metrics is None:
            from alluxio_tpu_torch.metrics import metrics as _m

            metrics = _m()
        self._m = metrics
        self._thread: "threading.Thread | None" = None
        self._stop = threading.Event()
        self.total_pause_s = 0.0
        self.max_pause_s = 0.0
        # register up front: dashboards must see 0.0 for "healthy",
        # not a missing series that also means "monitor not running"
        self._m.register_gauge("Process.MaxPauseSeconds",
                               lambda: self.max_pause_s)

    # -- detection core (pure; unit-testable without the thread) -----------
    def observe(self, elapsed_s: float) -> float:
        """Record one sleep of ``elapsed_s`` wall seconds against the
        configured interval; returns the pause length (0 when none)."""
        pause = elapsed_s - self._interval
        if pause < self._warn:
            return 0.0
        self.total_pause_s += pause
        self.max_pause_s = max(self.max_pause_s, pause)
        if pause >= self._error:
            self._m.counter("Process.SeverePauses").inc()
            LOG.error("process paused ~%.2fs (GC/GIL/host stall): "
                      "heartbeats and elections may have missed", pause)
        else:
            self._m.counter("Process.Pauses").inc()
            LOG.warning("process paused ~%.2fs", pause)
        return pause

    def _run(self) -> None:
        while not self._stop.is_set():
            t0 = time.monotonic()
            self._stop.wait(self._interval)
            if self._stop.is_set():
                return
            self.observe(time.monotonic() - t0)

    def start(self) -> "PauseMonitor":
        if self._thread is None:
            self._stop.clear()  # restartable after stop()
            self._thread = threading.Thread(
                target=self._run, name="pause-monitor", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None


_process_monitor: "PauseMonitor | None" = None
_process_lock = threading.Lock()


def ensure_process_monitor() -> PauseMonitor:
    """ONE monitor per OS process, shared by every in-process role
    (LocalCluster runs master + N workers in one interpreter; a host
    stall is one event, not N+1 counter bumps racing one gauge)."""
    global _process_monitor
    with _process_lock:
        if _process_monitor is None:
            _process_monitor = PauseMonitor().start()
        return _process_monitor
