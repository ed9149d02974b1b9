"""Job master RPC service + client (a copy of
``alluxio_tpu/rpc/job_service.py``: the same service name and method
paths, so either package's client drives the other's job master).

Re-design of ``core/transport/src/main/proto/grpc/job_master.proto``:
client surface (Run/Cancel/GetJobStatus/ListAll ``:165-195``) and
job-worker surface (RegisterJobWorker + Heartbeat with piggybacked task
commands ``:225-230``) on the shared msgpack-gRPC core.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from alluxio_tpu_torch.job.wire import JobInfo, Status
from alluxio_tpu_torch.rpc.clients import resolve_retry_duration_s
from alluxio_tpu_torch.rpc.core import RpcChannel, ServiceDefinition
from alluxio_tpu_torch.utils.exceptions import DeadlineExceededError
from alluxio_tpu_torch.utils.retry import ExponentialTimeBoundedRetry, retry

JOB_SERVICE = "JobMasterService"


def job_master_service(job_master) -> ServiceDefinition:
    svc = ServiceDefinition(JOB_SERVICE)
    svc.unary("run", lambda r: {"job_id": job_master.run(r["config"])})
    svc.unary("cancel", lambda r: (job_master.cancel(r["job_id"]), {})[1])
    svc.unary("get_status",
              lambda r: job_master.get_status(r["job_id"]).to_wire())
    svc.unary("list_jobs", lambda r: {
        "jobs": [j.to_wire() for j in job_master.list_jobs()]})
    svc.unary("list_plan_types",
              lambda r: {"types": job_master.list_plan_types()})
    svc.unary("register_worker", lambda r: {
        "worker_id": job_master.register_worker(r["hostname"])})
    svc.unary("list_workers", lambda r: {
        "workers": [{"worker_id": w.worker_id,
                     "hostname": w.hostname,
                     "health": w.health.to_wire()}
                    for w in job_master.workers()]})
    svc.unary("worker_heartbeat", lambda r: {
        "commands": job_master.heartbeat(
            r["worker_id"], r.get("health") or {},
            r.get("task_updates") or [])})
    return svc


class JobMasterClient:
    """Typed retrying client (reference: ``job/client/.../
    RetryHandlingJobMasterClient.java``)."""

    service = JOB_SERVICE

    def __init__(self, address: str, *,
                 retry_duration_s: Optional[float] = None,
                 metadata=None, conf=None):
        """``retry_duration_s`` falls back to ``conf``'s
        ``atpu.user.rpc.retry.duration`` (30s default)."""
        self._channel = RpcChannel(address, metadata=metadata)
        self._retry_duration_s = resolve_retry_duration_s(
            retry_duration_s, conf)

    def _call(self, method: str, request: dict, timeout: float = 30.0):
        return retry(
            lambda: self._channel.call(self.service, method, request,
                                       timeout=timeout),
            ExponentialTimeBoundedRetry(self._retry_duration_s, 0.05, 3.0))

    # -- client surface -----------------------------------------------------
    def run(self, config: Dict[str, Any]) -> int:
        return self._call("run", {"config": config})["job_id"]

    def cancel(self, job_id: int) -> None:
        self._call("cancel", {"job_id": job_id})

    def get_status(self, job_id: int) -> JobInfo:
        return JobInfo.from_wire(self._call("get_status",
                                            {"job_id": job_id}))

    def list_jobs(self) -> List[JobInfo]:
        return [JobInfo.from_wire(j)
                for j in self._call("list_jobs", {})["jobs"]]

    def list_workers(self) -> List[Dict[str, Any]]:
        """Registered job workers with their latest health report
        (reference: the worker-health section of
        ``fsadmin report jobservice``)."""
        return self._call("list_workers", {})["workers"]

    def list_plan_types(self) -> List[str]:
        return self._call("list_plan_types", {})["types"]

    # -- worker surface -----------------------------------------------------
    def register_worker(self, hostname: str) -> int:
        return self._call("register_worker",
                          {"hostname": hostname})["worker_id"]

    def heartbeat(self, worker_id: int, health: Dict[str, Any],
                  task_updates: List[Dict[str, Any]]) -> List[dict]:
        return self._call("worker_heartbeat", {
            "worker_id": worker_id, "health": health,
            "task_updates": task_updates})["commands"]

    def wait_for_job(self, job_id: int, timeout_s: float = 120.0,
                     poll_s: float = 0.05) -> JobInfo:
        """Poll until the job finishes (test/CLI convenience)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            info = self.get_status(job_id)
            if Status.is_finished(info.status):
                return info
            time.sleep(poll_s)
        raise DeadlineExceededError(
            f"job {job_id} not finished within {timeout_s}s")
