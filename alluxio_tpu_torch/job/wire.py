"""Job-service wire types: a copy of ``alluxio_tpu/job/wire.py``.

Re-design of ``job/common/src/main/java/alluxio/job/wire/{JobInfo,TaskInfo,
Status,JobWorkerHealth}.java``: statuses form the same small lattice
(CREATED -> RUNNING -> COMPLETED | FAILED | CANCELED) and everything
serializes to msgpack-friendly dicts, field for field as the JAX
package's do, so either package decodes the other's bytes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from alluxio_tpu_torch.utils.wire import _NESTED, _wire_dataclass


class Status:
    CREATED = "CREATED"
    RUNNING = "RUNNING"
    COMPLETED = "COMPLETED"
    FAILED = "FAILED"
    CANCELED = "CANCELED"

    FINISHED = (COMPLETED, FAILED, CANCELED)

    @staticmethod
    def is_finished(s: str) -> bool:
        return s in Status.FINISHED


@_wire_dataclass
@dataclass
class TaskInfo:
    """One task of a plan, bound to one job worker
    (reference: ``job/wire/TaskInfo.java``)."""

    job_id: int = 0
    task_id: int = 0
    worker_id: int = 0
    status: str = Status.CREATED
    error_message: str = ""
    result: Any = None
    args: Any = None


@_wire_dataclass
@dataclass
class JobInfo:
    """Plan or workflow status snapshot (reference: ``job/wire/
    {PlanInfo,WorkflowInfo}.java``)."""

    job_id: int = 0
    name: str = ""
    status: str = Status.CREATED
    error_message: str = ""
    result: Any = None
    tasks: List[TaskInfo] = field(default_factory=list)
    children: List[int] = field(default_factory=list)
    last_updated_ms: int = 0


_NESTED[("JobInfo", "tasks")] = TaskInfo


@_wire_dataclass
@dataclass
class JobWorkerHealth:
    """Job-worker load report shipped on each heartbeat
    (reference: ``job/wire/JobWorkerHealth.java``)."""

    worker_id: int = 0
    hostname: str = ""
    load_avg: float = 0.0
    task_pool_size: int = 0
    num_active_tasks: int = 0
    unfinished_tasks: int = 0


@dataclass
class JobCommand:
    """Command piggybacked on the heartbeat response (reference:
    ``grpc/job_master.proto`` RunTaskCommand/CancelTaskCommand/
    RegisterCommand)."""

    kind: str = ""  # run | cancel | register | set_throttle
    job_id: int = 0
    task_id: int = 0
    job_config: Optional[Dict[str, Any]] = None
    task_args: Any = None

    def to_wire(self) -> Dict[str, Any]:
        return {"kind": self.kind, "job_id": self.job_id,
                "task_id": self.task_id, "job_config": self.job_config,
                "task_args": self.task_args}

    @classmethod
    def from_wire(cls, d: Dict[str, Any]) -> "JobCommand":
        return cls(**d)
