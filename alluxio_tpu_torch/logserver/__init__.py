"""Centralized log aggregation (reference: ``logserver/``); a copy of
``alluxio_tpu/logserver/__init__.py``."""

from alluxio_tpu_torch.logserver.process import (
    LogServerProcess, enable_remote_logging,
)

__all__ = ["LogServerProcess", "enable_remote_logging"]
