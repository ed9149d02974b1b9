"""Heartbeat framework with deterministic test control (a copy of
``alluxio_tpu/heartbeat``): named periodic executors, and the scheduler
that lets tests tick a named heartbeat by hand instead of sleeping."""

from alluxio_tpu_torch.heartbeat.core import (  # noqa: F401
    FunctionExecutor, HeartbeatContext, HeartbeatExecutor, HeartbeatScheduler,
    HeartbeatThread, ScheduledTimer, SleepingTimer,
)
