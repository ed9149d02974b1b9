"""Heartbeat threads, timers, and the test scheduler.

A copy of ``alluxio_tpu/heartbeat/core.py``: a named daemon thread runs
one executor on a timer; tests force a heartbeat onto a
:class:`ScheduledTimer` and tick it by hand through
:class:`HeartbeatScheduler` instead of sleeping.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, Optional

LOG = logging.getLogger(__name__)


class HeartbeatContext:
    """Heartbeat names, as the JAX package's catalog spells them (only
    the ones the port runs)."""

    MASTER_TTL_CHECK = "Master.TtlCheck"
    MASTER_LOST_WORKER_DETECTION = "Master.LostWorkerDetection"
    MASTER_REPLICATION_CHECK = "Master.ReplicationCheck"
    MASTER_PERSISTENCE_SCHEDULER = "Master.PersistenceScheduler"
    MASTER_TABLE_TRANSFORM_MONITOR = "Master.TableTransformMonitor"
    MASTER_HEALTH_CHECK = "Master.HealthCheck"
    MASTER_METRICS_SINKS = "Master.MetricsSinks"
    WORKER_METRICS_SINKS = "Worker.MetricsSinks"
    WORKER_BLOCK_SYNC = "Worker.BlockSync"
    WORKER_PIN_LIST_SYNC = "Worker.PinListSync"
    WORKER_STORAGE_HEALTH = "Worker.StorageHealth"
    WORKER_CLIENT_METRICS = "Worker.ClientMetrics"
    WORKER_MANAGEMENT_TASKS = "Worker.ManagementTasks"
    JOB_MASTER_LOST_WORKER_DETECTION = "JobMaster.LostWorkerDetection"
    JOB_WORKER_COMMAND_HANDLING = "JobWorker.CommandHandling"
    CLIENT_METRICS_HEARTBEAT = "Client.MetricsHeartbeat"
    CLIENT_PREFETCH_AGENT = "Client.PrefetchAgent"


class HeartbeatExecutor:
    """One tick of work. Implementations must be re-entrant-safe."""

    def heartbeat(self) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class _Timer:
    def tick(self) -> bool:
        """Block until the next tick is due. False = timer shut down."""
        raise NotImplementedError

    def shutdown(self) -> None:
        pass


_TimerFactory = Callable[[str, float], _Timer]


class SleepingTimer(_Timer):
    """Fixed-interval timer."""

    def __init__(self, name: str, interval_s: float) -> None:
        self._name = name
        self._interval = interval_s
        self._event = threading.Event()
        self._shutdown = False

    def tick(self) -> bool:
        if self._shutdown:
            return False
        self._event.wait(self._interval)
        return not self._shutdown

    def shutdown(self) -> None:
        self._shutdown = True
        self._event.set()


class ScheduledTimer(_Timer):
    """Test-controllable timer: ticks only when ``HeartbeatScheduler.execute``
    fires it."""

    def __init__(self, name: str, interval_s: float = 0.0) -> None:
        self.name = name
        self._tick_event = threading.Event()
        self._ready_event = threading.Event()
        self._done_event = threading.Event()
        self._shutdown = False
        HeartbeatScheduler._register(self)

    def tick(self) -> bool:
        if self._shutdown:
            return False
        self._ready_event.set()
        self._tick_event.wait()
        self._tick_event.clear()
        return not self._shutdown

    def _fire(self) -> None:
        self._done_event.clear()
        self._tick_event.set()

    def _signal_done(self) -> None:
        self._done_event.set()

    def shutdown(self) -> None:
        self._shutdown = True
        self._tick_event.set()
        HeartbeatScheduler._deregister(self)


class HeartbeatScheduler:
    """Global coordinator for `ScheduledTimer`s — tests call
    ``await_ready(name)`` then ``execute(name)`` to run exactly one tick."""

    _timers: Dict[str, ScheduledTimer] = {}
    _lock = threading.Lock()

    @classmethod
    def _register(cls, timer: ScheduledTimer) -> None:
        with cls._lock:
            cls._timers[timer.name] = timer

    @classmethod
    def _deregister(cls, timer: ScheduledTimer) -> None:
        with cls._lock:
            if cls._timers.get(timer.name) is timer:
                del cls._timers[timer.name]

    @classmethod
    def is_scheduled(cls, name: str) -> bool:
        with cls._lock:
            return name in cls._timers

    @classmethod
    def await_ready(cls, name: str, timeout_s: float = 10.0) -> bool:
        with cls._lock:
            t = cls._timers.get(name)
        if t is None:
            return False
        return t._ready_event.wait(timeout_s)

    @classmethod
    def execute(cls, name: str, timeout_s: float = 10.0) -> None:
        """Fire one tick of heartbeat ``name`` and wait for it to finish."""
        if not cls.await_ready(name, timeout_s):
            raise TimeoutError(f"heartbeat {name} never became ready")
        with cls._lock:
            t = cls._timers.get(name)
        if t is None:
            raise KeyError(f"heartbeat {name} not registered")
        t._ready_event.clear()
        t._fire()
        if not t._done_event.wait(timeout_s):
            raise TimeoutError(f"heartbeat {name} tick did not complete")

    @classmethod
    def clear(cls) -> None:
        with cls._lock:
            cls._timers.clear()


class HeartbeatThread:
    """A named daemon thread driving one executor on a timer."""

    #: Test hook: names (or True for all) forced onto ScheduledTimer.
    _scheduled_names: set = set()
    _schedule_all = False

    def __init__(self, name: str, executor: HeartbeatExecutor,
                 interval_s: float,
                 timer_factory: Optional[_TimerFactory] = None):
        self.name = name
        self._executor = executor
        if timer_factory is not None:
            self._timer = timer_factory(name, interval_s)
        elif self._schedule_all or name in self._scheduled_names:
            self._timer = ScheduledTimer(name, interval_s)
        else:
            self._timer = SleepingTimer(name, interval_s)
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._started = False

    @classmethod
    def use_scheduled_timers(cls, *names: str) -> None:
        """Force named heartbeats (or all, if none given) onto test timers."""
        if not names:
            cls._schedule_all = True
        else:
            cls._scheduled_names.update(names)

    @classmethod
    def reset_timer_policy(cls) -> None:
        cls._schedule_all = False
        cls._scheduled_names.clear()

    def start(self) -> None:
        self._started = True
        self._thread.start()

    def _run(self) -> None:
        try:
            while self._timer.tick():
                try:
                    self._executor.heartbeat()
                except Exception:  # noqa: BLE001 - heartbeat must survive
                    LOG.exception("Uncaught exception in heartbeat %s",
                                  self.name)
                finally:
                    if isinstance(self._timer, ScheduledTimer):
                        self._timer._signal_done()
        finally:
            self._executor.close()

    def stop(self, timeout_s: float = 5.0) -> None:
        self._timer.shutdown()
        if self._started:
            self._thread.join(timeout_s)


class FunctionExecutor(HeartbeatExecutor):
    """Adapter: wrap a plain callable as an executor."""

    def __init__(self, fn: Callable[[], None]) -> None:
        self._fn = fn

    def heartbeat(self) -> None:
        self._fn()
