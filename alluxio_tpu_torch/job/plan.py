"""Plan SPI: two-phase jobs (a copy of ``alluxio_tpu/job/plan.py``;
reference: ``job/server/src/main/java/alluxio/job/plan/PlanDefinition.java``
+ ``PlanDefinitionRegistry.java``).

``select_executors`` runs on the job master and partitions work over the
registered job workers; ``run_task`` runs on the chosen workers with an FS
client bound to the worker's locality (so reads cache into the co-located
block worker — the host-local tier).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from alluxio_tpu_torch.job.wire import JobWorkerHealth
from alluxio_tpu_torch.utils.exceptions import InvalidArgumentError
from alluxio_tpu_torch.utils.wire import WorkerInfo


@dataclass
class RegisteredJobWorker:
    """Job-master view of one job worker."""

    worker_id: int
    hostname: str
    health: JobWorkerHealth


class SelectContext:
    """Master-side planning context: read-only cluster views."""

    def __init__(self, fs_master, block_master) -> None:
        self.fs_master = fs_master
        self.block_master = block_master

    def block_workers(self) -> List[WorkerInfo]:
        return self.block_master.get_worker_infos()

    def live_hosts(self) -> set:
        """Locality hosts that have a live block worker — load/replicate
        targets must be co-located with one."""
        return {w.address.tiered_identity.value("host")
                for w in self.block_workers()}


class RunTaskContext:
    """Worker-side execution context: a FileSystem client whose locality
    identity matches the co-located block worker, so LOCAL_FIRST policies
    target this host's tier."""

    def __init__(self, file_system, worker_hostname: str) -> None:
        self.fs = file_system
        self.hostname = worker_hostname


class PlanDefinition:
    #: registry key; job configs carry {"type": name, ...}
    name = ""
    #: True when a task's effect is the same on ANY worker (cache/copy/
    #: persist work), letting the coordinator re-dispatch a lost
    #: worker's tasks. Host-AFFINE tasks (evict: "remove MY copy") must
    #: stay False — run elsewhere they'd destroy a healthy replica.
    relocatable = False

    def select_executors(self, config: Dict[str, Any],
                         workers: List[RegisteredJobWorker],
                         ctx: SelectContext
                         ) -> List[Tuple[int, Any]]:
        """Return [(job_worker_id, task_args), ...]."""
        raise NotImplementedError

    def run_task(self, config: Dict[str, Any], task_args: Any,
                 ctx: RunTaskContext) -> Any:
        raise NotImplementedError

    def join(self, config: Dict[str, Any],
             task_results: List[Any]) -> Any:
        """Aggregate task results into the job result (reference:
        ``PlanDefinition.join``)."""
        return task_results


class PlanRegistry:
    """Name -> PlanDefinition (reference: ``PlanDefinitionRegistry`` uses
    ServiceLoader discovery; here plans self-register on import)."""

    def __init__(self) -> None:
        self._plans: Dict[str, PlanDefinition] = {}

    def register(self, plan: PlanDefinition) -> None:
        self._plans[plan.name] = plan

    def get(self, name: str) -> PlanDefinition:
        plan = self._plans.get(name)
        if plan is None:
            raise InvalidArgumentError(f"unknown job type: {name!r}; "
                                       f"known: {sorted(self._plans)}")
        return plan

    def names(self) -> List[str]:
        return sorted(self._plans)


_DEFAULT: Optional[PlanRegistry] = None


def default_registry() -> PlanRegistry:
    """The shared registry with all built-in plans loaded."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = PlanRegistry()
        from alluxio_tpu_torch.job.plans import register_builtin_plans

        register_builtin_plans(_DEFAULT)
    return _DEFAULT
