"""Job worker: pulls task commands on heartbeat, runs them in a bounded
executor pool (a copy of ``alluxio_tpu/job/worker.py``; ``join`` waits
for every thread the worker started).

Re-design of ``job/server/src/main/java/alluxio/worker/{job/command/
CommandHandlingExecutor.java,job/task/{TaskExecutor.java:35,88,
TaskExecutorManager}.java,JobWorker.java}``: register -> heartbeat (ship
health + task updates, receive commands) -> execute
``PlanDefinition.run_task`` with a locality-pinned FS client.
"""

from __future__ import annotations

import logging
import os
import threading
from concurrent import futures
from typing import Any, Dict, List, Optional

from alluxio_tpu_torch.heartbeat import (
    HeartbeatContext, HeartbeatExecutor, HeartbeatThread,
)
from alluxio_tpu_torch.job.plan import (
    PlanRegistry, RunTaskContext, default_registry,
)
from alluxio_tpu_torch.job.wire import JobCommand, JobWorkerHealth, Status

LOG = logging.getLogger(__name__)


class TaskExecutorManager:
    """Bounded task pool with a pause gate (reference:
    ``TaskExecutorManager``): while paused, a task waits to start; the
    ``set_throttle`` command pauses and resumes it (as in JAX, no job
    master sends one yet)."""

    def __init__(self, width: int = 4) -> None:
        self.width = width
        self._pool = futures.ThreadPoolExecutor(
            max_workers=width, thread_name_prefix="job-task")
        self._unpaused = threading.Event()
        self._unpaused.set()
        self._active = 0
        self._lock = threading.Lock()

    def submit(self, fn, *args) -> "futures.Future":
        def gated():
            self._unpaused.wait()
            with self._lock:
                self._active += 1
            try:
                return fn(*args)
            finally:
                with self._lock:
                    self._active -= 1

        return self._pool.submit(gated)

    def pause(self) -> None:
        self._unpaused.clear()

    def resume(self) -> None:
        self._unpaused.set()

    @property
    def num_active(self) -> int:
        with self._lock:
            return self._active

    def shutdown(self) -> None:
        """Cancel the queued tasks and return without waiting for the
        running ones (a paused pool is released first), as the JAX pool
        does."""
        self._unpaused.set()
        self._pool.shutdown(wait=False, cancel_futures=True)

    def join(self) -> None:
        """Wait for the running tasks to end and join every pool thread
        (after ``shutdown``)."""
        self._pool.shutdown(wait=True)


class JobWorker:
    """One job worker bound to a co-located block worker's locality host."""

    def __init__(self, job_master_client, file_system, hostname: str, *,
                 registry: Optional[PlanRegistry] = None,
                 task_pool_width: int = 4,
                 heartbeat_interval_s: float = 1.0) -> None:
        self._jm = job_master_client
        self._fs = file_system
        self.hostname = hostname
        self._registry = registry or default_registry()
        self._executor = TaskExecutorManager(task_pool_width)
        self._hb_interval = heartbeat_interval_s
        self.worker_id: Optional[int] = None
        self._lock = threading.Lock()
        self._pending_updates: List[Dict[str, Any]] = []
        self._running: Dict[tuple, futures.Future] = {}
        self._hb_thread: Optional[HeartbeatThread] = None

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        self.register()
        self._hb_thread = HeartbeatThread(
            HeartbeatContext.JOB_WORKER_COMMAND_HANDLING,
            _HbExec(self.heartbeat), self._hb_interval)
        self._hb_thread.start()

    def stop(self) -> None:
        """Stop the heartbeat and cancel the queued tasks; a running task
        is not waited for (as in JAX), so a worker whose task hangs on a
        dead peer stops at once. ``join`` waits for it."""
        if self._hb_thread is not None:
            self._hb_thread.stop()
        self._executor.shutdown()

    def join(self) -> None:
        """Join the task pool's threads (after ``stop``)."""
        self._executor.join()

    def register(self) -> None:
        self.worker_id = self._jm.register_worker(self.hostname)

    # -- heartbeat ----------------------------------------------------------
    def heartbeat(self) -> None:
        with self._lock:
            updates, self._pending_updates = self._pending_updates, []
        health = JobWorkerHealth(
            worker_id=self.worker_id or 0, hostname=self.hostname,
            load_avg=_load_avg(), task_pool_size=self._executor.width,
            num_active_tasks=self._executor.num_active,
            unfinished_tasks=len(self._running))
        try:
            commands = self._jm.heartbeat(self.worker_id, health.to_wire(),
                                          updates)
        except Exception:  # noqa: BLE001 - master may be failing over
            with self._lock:  # retry updates next tick
                self._pending_updates = updates + self._pending_updates
            LOG.debug("job heartbeat failed", exc_info=True)
            return
        for raw in commands:
            self._handle(JobCommand.from_wire(raw))

    def _handle(self, cmd: JobCommand) -> None:
        if cmd.kind == "run":
            self._run_task(cmd)
        elif cmd.kind == "cancel":
            fut = self._running.get((cmd.job_id, cmd.task_id))
            if fut is not None:
                fut.cancel()
        elif cmd.kind == "register":
            self.register()
        elif cmd.kind == "set_throttle":
            if cmd.task_args == "pause":
                self._executor.pause()
            else:
                self._executor.resume()

    # -- task execution -----------------------------------------------------
    def _run_task(self, cmd: JobCommand) -> None:
        key = (cmd.job_id, cmd.task_id)
        self._push_update(cmd.job_id, cmd.task_id, Status.RUNNING)

        def run():
            plan = self._registry.get(cmd.job_config.get("type", ""))
            ctx = RunTaskContext(self._fs, self.hostname)
            return plan.run_task(cmd.job_config, cmd.task_args, ctx)

        fut = self._executor.submit(run)
        self._running[key] = fut
        fut.add_done_callback(
            lambda f, jid=cmd.job_id, tid=cmd.task_id:
            self._on_task_done(jid, tid, f))

    def _on_task_done(self, job_id: int, task_id: int,
                      fut: "futures.Future") -> None:
        self._running.pop((job_id, task_id), None)
        if fut.cancelled():
            self._push_update(job_id, task_id, Status.CANCELED)
            return
        err = fut.exception()
        if err is not None:
            LOG.warning("task %s/%s failed: %s", job_id, task_id, err)
            self._push_update(job_id, task_id, Status.FAILED,
                              error=f"{type(err).__name__}: {err}")
        else:
            self._push_update(job_id, task_id, Status.COMPLETED,
                              result=fut.result())

    def _push_update(self, job_id: int, task_id: int, status: str, *,
                     result: Any = None, error: str = "") -> None:
        with self._lock:
            self._pending_updates.append({
                "job_id": job_id, "task_id": task_id, "status": status,
                "result": result, "error_message": error})


class _HbExec(HeartbeatExecutor):
    def __init__(self, fn) -> None:
        self._fn = fn

    def heartbeat(self) -> None:
        self._fn()


def _load_avg() -> float:
    try:
        return os.getloadavg()[0]
    except OSError:
        return 0.0
