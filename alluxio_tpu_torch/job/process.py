"""Job master / job worker process assembly (a copy of
``alluxio_tpu/job/process.py``).

Re-design of ``job/server/src/main/java/alluxio/master/
AlluxioJobMasterProcess.java:58`` and ``worker/JobWorker.java``: the job
master is its own RPC endpoint (co-deployable with the metadata master),
job workers ride alongside block workers on each host.
"""

from __future__ import annotations

from typing import Optional

from alluxio_tpu_torch.conf import Configuration, Keys
from alluxio_tpu_torch.heartbeat import (
    HeartbeatContext, HeartbeatExecutor, HeartbeatThread,
)
from alluxio_tpu_torch.job.master import JobMaster
from alluxio_tpu_torch.job.worker import JobWorker
from alluxio_tpu_torch.rpc.clients import BlockMasterClient, FsMasterClient
from alluxio_tpu_torch.rpc.core import RpcServer
from alluxio_tpu_torch.rpc.job_service import (
    JobMasterClient, job_master_service,
)


class _Exec(HeartbeatExecutor):
    def __init__(self, fn) -> None:
        self._fn = fn

    def heartbeat(self) -> None:
        self._fn()


class JobMasterProcess:
    def __init__(self, conf: Configuration, master_address: str, *,
                 clock=None) -> None:
        self._conf = conf
        fast_dir = conf.get(Keys.MASTER_FASTPATH_DIR)
        self.job_master = JobMaster(
            FsMasterClient(master_address, conf=conf,
                           fastpath_dir=fast_dir),
            BlockMasterClient(master_address, conf=conf,
                              fastpath_dir=fast_dir),
            capacity=conf.get_int(Keys.JOB_MASTER_JOB_CAPACITY),
            clock=clock,
            worker_timeout_ms=conf.get_ms(Keys.JOB_MASTER_WORKER_TIMEOUT))
        self.rpc_server: Optional[RpcServer] = None
        self.rpc_port: Optional[int] = None
        self._threads = []

    def start(self) -> int:
        from alluxio_tpu_torch.utils.tracing import set_tracing_enabled

        set_tracing_enabled(self._conf.get_bool(Keys.TRACE_ENABLED))
        self.rpc_server = RpcServer(
            bind_host="0.0.0.0",
            port=self._conf.get_int(Keys.JOB_MASTER_RPC_PORT),
            thread_name_prefix="job-master-rpc")
        self.rpc_server.add_service(job_master_service(self.job_master))
        self.rpc_port = self.rpc_server.start()
        self._threads = [HeartbeatThread(
            HeartbeatContext.JOB_MASTER_LOST_WORKER_DETECTION,
            _Exec(self.job_master.detect_lost_workers),
            self._conf.get_duration_s(
                Keys.JOB_MASTER_LOST_WORKER_INTERVAL))]
        for t in self._threads:
            t.start()
        return self.rpc_port

    def stop(self) -> None:
        for t in self._threads:
            t.stop()
        self._threads = []
        if self.rpc_server is not None:
            self.rpc_server.stop()

    @property
    def address(self) -> str:
        return f"localhost:{self.rpc_port}"


def make_job_worker(conf: Configuration, job_master_address: str,
                    master_address: str, hostname: str) -> JobWorker:
    """Build a job worker whose FS client is locality-pinned to the
    co-located block worker's host (the ``host=`` tier of its tiered
    identity: the load plan matches job workers to block workers by it)."""
    from alluxio_tpu_torch.client.file_system import FileSystem

    wconf = conf.copy()
    wconf.set(Keys.TIERED_IDENTITY, f"host={hostname}")
    fs = FileSystem(master_address, conf=wconf)
    return JobWorker(
        JobMasterClient(job_master_address), fs, hostname,
        task_pool_width=conf.get_int(Keys.JOB_WORKER_THREADPOOL_SIZE),
        heartbeat_interval_s=conf.get_duration_s(
            Keys.JOB_WORKER_HEARTBEAT_INTERVAL))
