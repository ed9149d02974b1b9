"""Metrics (a copy of ``alluxio_tpu/metrics``): the process registry of
counters, meters, timers and gauges and its exposition."""

from alluxio_tpu_torch.metrics.registry import (  # noqa: F401
    Counter, Meter, MetricsRegistry, Timer, metrics, reset_metrics,
)
