"""In-process test cluster: master + N workers over real gRPC, and on
request the job service (a copy of
``alluxio_tpu/minicluster/local_cluster.py``).

Re-design of ``minicluster/.../LocalAlluxioCluster.java:45`` +
``LocalAlluxioClusterResource``: every role runs as threads in one process,
RPC rides real gRPC on ephemeral ports, tier dirs live under a scratch
directory. Functional tests use this; process-level failover tests use
``multi_process.py`` (reference: ``MultiProcessCluster.java:94``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from alluxio_tpu_torch.conf import Configuration, Keys
from alluxio_tpu_torch.master.process import MasterProcess
from alluxio_tpu_torch.rpc.clients import (
    BlockMasterClient, FsMasterClient, MetaMasterClient, WorkerClient,
)
from alluxio_tpu_torch.rpc.core import RpcServer
from alluxio_tpu_torch.rpc.worker_service import worker_service
from alluxio_tpu_torch.utils.wire import TieredIdentity, WorkerNetAddress
from alluxio_tpu_torch.worker.process import BlockWorker
from alluxio_tpu_torch.worker.ufs_manager import WorkerUfsManager


class _WorkerHandle:
    def __init__(self, worker: BlockWorker, server: RpcServer, port: int):
        self.worker = worker
        self.server = server
        self.port = port

    @property
    def address(self) -> str:
        return f"localhost:{self.port}"

    def stop(self) -> None:
        self.worker.stop()
        self.server.stop()


class LocalCluster:
    def __init__(self, base_dir: str, *, num_workers: int = 1,
                 conf_overrides: Optional[Dict] = None,
                 worker_mem_bytes: int = 64 << 20,
                 block_size: int = 1 << 20,
                 start_worker_heartbeats: bool = False,
                 start_job_service: bool = False) -> None:
        self._base = base_dir
        self._num_workers = num_workers
        self._worker_mem = worker_mem_bytes
        self._start_hb = start_worker_heartbeats
        self.conf = Configuration(load_env=False)
        self.conf.set(Keys.HOME, base_dir)
        self.conf.set(Keys.MASTER_JOURNAL_FOLDER,
                      os.path.join(base_dir, "journal"))
        self.conf.set(Keys.MASTER_RPC_PORT, 0)  # ephemeral
        self.conf.set(Keys.USER_BLOCK_SIZE_BYTES_DEFAULT, block_size)
        self.conf.set(Keys.MASTER_SAFEMODE_WAIT, "0s")
        # the master's fast-path socket lives in the cluster directory,
        # not in /tmp; the cluster's clients read the same key
        self.conf.set(Keys.MASTER_FASTPATH_DIR, base_dir)
        if not start_worker_heartbeats:
            # No heartbeat loop means worker liveness is unknowable: the
            # lost-worker detector would silently expire a healthy worker
            # after the default timeout (and with no heartbeat to carry
            # the re-register command it can never come back). Overrides
            # below still win for tests that drive detection explicitly.
            self.conf.set(Keys.MASTER_WORKER_TIMEOUT, "10000min")
        for k, v in (conf_overrides or {}).items():
            self.conf.set(k, v)
        self.master: Optional[MasterProcess] = None
        self.workers: List[_WorkerHandle] = []
        self._start_job_service = start_job_service
        self.job_master = None
        self.job_workers: List = []

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "LocalCluster":
        root_ufs = os.path.join(self._base, "underFSStorage")
        os.makedirs(root_ufs, exist_ok=True)
        self.master = MasterProcess(self.conf, root_ufs_uri=root_ufs)
        self.master.start()
        for i in range(self._num_workers):
            self._start_worker(i)
        if self._start_job_service:
            self.start_job_service()
        return self

    def _start_worker(self, index: int) -> _WorkerHandle:
        wconf = self.conf.copy()
        wdir = os.path.join(self._base, f"worker{index}")
        wconf.set(Keys.WORKER_DATA_FOLDER, wdir)
        wconf.set(Keys.WORKER_SHM_DIR, os.path.join(wdir, "shm"))
        wconf.set(Keys.WORKER_RAMDISK_SIZE, self._worker_mem)
        wconf.set(Keys.WORKER_HOSTNAME, "localhost")
        # ephemeral per-worker web port: a shared fixed default would
        # EADDRINUSE the second worker when the endpoint is enabled
        wconf.set(Keys.WORKER_WEB_PORT, 0)
        bm_client = self.block_client()
        fs_client = self.fs_client()
        # distinct locality hosts so policies can tell workers apart
        address = WorkerNetAddress(
            host="localhost", rpc_port=0,
            shm_dir=os.path.join(wdir, "shm"),
            tiered_identity=TieredIdentity.from_spec(
                f"host=localhost-w{index},slice=slice0"))
        worker = BlockWorker(wconf, bm_client, fs_client,
                             ufs_manager=None, address=address,
                             meta_master_client=self.meta_client())
        # UFS resolution must be in place before the RPC server serves a
        # single read (a UFS-descriptor read in the gap would crash on None)
        worker.ufs_manager = WorkerUfsManager(fs_client)
        from alluxio_tpu_torch.security.authentication import worker_authenticator

        server = RpcServer(bind_host="127.0.0.1", port=0,
                           authenticator=worker_authenticator(wconf))
        server.add_service(worker_service(worker))
        port = server.start()
        worker.address.rpc_port = port
        worker.address.data_port = port
        if self._start_hb:
            worker.start()
        else:
            worker.register_with_master()
            worker.maybe_start_web()
        handle = _WorkerHandle(worker, server, port)
        self.workers.append(handle)
        return handle

    def restart_master(self) -> MasterProcess:
        """Stop the master and start a new ``MasterProcess`` on the same
        journal and RPC port: it replays the journal, and the workers
        re-register with it on their next heartbeat (the master answers
        an unknown worker's heartbeat with REGISTER). The port's own
        drill; the JAX cluster restarts its master through the
        multi-process and HA harnesses."""
        port = self.master.rpc_port
        self.master.stop()
        conf = self.conf.copy()
        conf.set(Keys.MASTER_RPC_PORT, port)
        self.master = MasterProcess(
            conf, root_ufs_uri=os.path.join(self._base, "underFSStorage"))
        self.master.start()
        if self.job_master is not None:
            self._attach_checkers()
        return self.master

    def add_worker(self) -> _WorkerHandle:
        return self._start_worker(len(self.workers))

    def start_job_service(self) -> None:
        """Start a job master + one job worker per block worker
        (reference: job master/worker co-deployment, §3.5 of SURVEY.md),
        then attach the master's replication checker and persistence
        scheduler to it."""
        from alluxio_tpu_torch.job.process import (
            JobMasterProcess, make_job_worker,
        )

        jconf = self.conf.copy()
        jconf.set(Keys.JOB_MASTER_RPC_PORT, 0)
        # tight heartbeat so in-process tests converge fast
        jconf.set(Keys.JOB_WORKER_HEARTBEAT_INTERVAL, "50ms")
        self.job_master = JobMasterProcess(jconf, self.master.address)
        self.job_master.start()
        # publish the ephemeral port the job master actually bound
        self.conf.set(Keys.JOB_MASTER_RPC_PORT, self.job_master.rpc_port)
        for i in range(len(self.workers)):
            jw = make_job_worker(jconf, self.job_master.address,
                                 self.master.address, f"localhost-w{i}")
            jw.start()
            self.job_workers.append(jw)
        self._attach_checkers()

    def _attach_checkers(self) -> None:
        self.master.attach_replication_checker(self.job_client(),
                                               interval_s=0.1)
        self.master.attach_persistence_scheduler(self.job_client(),
                                                 interval_s=0.1)

    def stop(self) -> None:
        """Stop the master's checkers, the job workers, the job master,
        the block workers and the master, in that order, joining every
        thread each started (a job worker's task pool once its running
        tasks end)."""
        if self.master is not None:
            self.master.detach_job_service()
        for jw in self.job_workers:
            jw.stop()
        for jw in self.job_workers:
            jw.join()
        if self.job_master is not None:
            self.job_master.stop()
        for w in self.workers:
            w.stop()
        if self.master is not None:
            self.master.stop()

    def __enter__(self) -> "LocalCluster":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # -- clients ------------------------------------------------------------
    def fs_client(self) -> FsMasterClient:
        return FsMasterClient(self.master.address,
                              fastpath_dir=self._fastpath_dir)

    def block_client(self) -> BlockMasterClient:
        return BlockMasterClient(self.master.address,
                                 fastpath_dir=self._fastpath_dir)

    def meta_client(self) -> MetaMasterClient:
        return MetaMasterClient(self.master.address,
                                fastpath_dir=self._fastpath_dir)

    @property
    def _fastpath_dir(self) -> str:
        return self.conf.get(Keys.MASTER_FASTPATH_DIR)

    def worker_client(self, index: int = 0) -> WorkerClient:
        return WorkerClient(self.workers[index].address)

    def job_client(self):
        from alluxio_tpu_torch.rpc.job_service import JobMasterClient

        return JobMasterClient(self.job_master.address)

    def file_system(self):
        """A full FileSystem client bound to this cluster."""
        from alluxio_tpu_torch.client.file_system import FileSystem

        return FileSystem(self.master.address, conf=self.conf)
