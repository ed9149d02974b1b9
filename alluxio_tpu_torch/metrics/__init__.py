"""Metrics: the subset of ``alluxio_tpu.metrics`` the device data plane emits."""

from alluxio_tpu_torch.metrics.registry import (  # noqa: F401
    Counter, MetricsRegistry, Timer, metrics,
)
