"""Master process assembly: the core of ``alluxio_tpu/master/process.py``'s
``MasterProcess``.

Re-design of ``core/server/master/.../{AlluxioMaster.java:35,
AlluxioMasterProcess.java:97,156,197,300}``: journal boot -> gain primacy ->
replay -> start masters + heartbeats -> serve RPC, with a **safe-mode
window** after primacy during which client ops are rejected while workers
re-register (reference: ``DefaultSafeModeManager``).

The port's master holds the journal, the block master, the permission
checker, the metastore (any kind ``atpu.master.metastore`` names), the
file master, the path properties, the table master (the catalog, registered with the journal before replay)
and the cluster config checker; it serves the FS, block, table and meta
services over gRPC and the same-host fast path, and ticks the lost-worker,
TTL and transform-monitor heartbeats. Once a job service exists, the
replication checker and the persistence scheduler attach late
(``attach_replication_checker``, ``attach_persistence_scheduler``); the
table master reaches the job master by ``atpu.job.master.rpc.port`` when
it starts a transform. Each of the JAX master's other parts comes with
its own slice: the HA process (``FaultTolerantMasterProcess``) and its
quorum view, the integrity checkers and active sync, the metrics master
with its history, health, remediation, the web server, the update check,
the scheduled backup, admission and audit, and the master's metrics
sinks.
A conf key that asks for one of the opt-in ones
raises ``NotSupportedError`` rather than being ignored.
"""

from __future__ import annotations

import logging
import time
import uuid
from typing import TYPE_CHECKING, List, Optional

from alluxio_tpu_torch.conf import Configuration, Keys
from alluxio_tpu_torch.heartbeat import (
    HeartbeatContext, HeartbeatExecutor, HeartbeatThread,
)
from alluxio_tpu_torch.journal.system import create_journal_system
from alluxio_tpu_torch.master.block_master import BlockMaster
from alluxio_tpu_torch.master.file_master import FileSystemMaster
from alluxio_tpu_torch.metrics import metrics
from alluxio_tpu_torch.rpc.core import RpcServer
from alluxio_tpu_torch.rpc.master_service import (
    block_master_service, fs_master_service, meta_master_service,
)
from alluxio_tpu_torch.rpc.table_service import table_master_service
from alluxio_tpu_torch.utils.clock import Clock, SystemClock
from alluxio_tpu_torch.utils.exceptions import NotSupportedError

if TYPE_CHECKING:
    from alluxio_tpu_torch.master.persistence import PersistenceScheduler

LOG = logging.getLogger(__name__)

#: opt-in JAX master components that are not ported yet: the conf key
#: that switches each on, and what it would build
_UNPORTED_OPT_INS = (
    (Keys.MASTER_RPC_ADMISSION_ENABLED, "RPC admission control"),
    (Keys.MASTER_WEB_ENABLED, "the master web server"),
    (Keys.MASTER_UPDATE_CHECK_ENABLED, "the update checker"),
    (Keys.MASTER_DAILY_BACKUP_ENABLED, "the scheduled backup"),
    (Keys.MASTER_REMEDIATION_ENABLED, "the remediation engine"),
)


class _Exec(HeartbeatExecutor):
    def __init__(self, fn) -> None:
        self._fn = fn

    def heartbeat(self) -> None:
        self._fn()


class MasterProcess:
    def __init__(self, conf: Configuration, *,
                 clock: Optional[Clock] = None,
                 root_ufs_uri: Optional[str] = None) -> None:
        for key, what in _UNPORTED_OPT_INS:
            if conf.get_bool(key):
                raise NotSupportedError(
                    f"{key.name} asks for {what}, which the port's master "
                    "does not have yet")
        if conf.get(Keys.MASTER_JOURNAL_INIT_FROM_BACKUP):
            raise NotSupportedError(
                f"{Keys.MASTER_JOURNAL_INIT_FROM_BACKUP.name}: journal "
                "backups are not ported yet")
        self._conf = conf
        self._clock = clock or SystemClock()
        self.journal = create_journal_system(
            str(conf.get(Keys.MASTER_JOURNAL_TYPE)).upper(),
            conf.get(Keys.MASTER_JOURNAL_FOLDER),
            max_log_size=conf.get_bytes(
                Keys.MASTER_JOURNAL_LOG_SIZE_BYTES_MAX),
            checkpoint_period_entries=conf.get_int(
                Keys.MASTER_JOURNAL_CHECKPOINT_PERIOD_ENTRIES))
        self.block_master = BlockMaster(
            self.journal, clock=self._clock,
            worker_timeout_ms=conf.get_ms(Keys.MASTER_WORKER_TIMEOUT))
        from alluxio_tpu_torch.security.authorization import PermissionChecker
        from alluxio_tpu_torch.security.user import get_os_user

        checker = PermissionChecker(
            enabled=conf.get_bool(
                Keys.SECURITY_AUTHORIZATION_PERMISSION_ENABLED),
            supergroup=str(conf.get(
                Keys.SECURITY_AUTHORIZATION_PERMISSION_SUPERGROUP)),
            superuser=get_os_user())
        self.permission_checker = checker
        from alluxio_tpu_torch.master.metastore import create_inode_store

        # pluggable metastore backend (reference: HEAP/ROCKS/caching):
        # HEAP serves from dicts; SQLITE spills metadata > RAM to disk;
        # LSM is the capacity backend (WAL + memtable + sorted runs,
        # caching-wrapped hot set); CACHING fronts SQLITE with a bounded
        # write-back LRU
        inode_store = create_inode_store(
            str(conf.get(Keys.MASTER_METASTORE)),
            conf.get(Keys.MASTER_METASTORE_DIR),
            cache_size=conf.get_int(
                Keys.MASTER_METASTORE_INODE_CACHE_MAX_SIZE),
            lsm_options={
                "memtable_bytes": conf.get_bytes(
                    Keys.MASTER_METASTORE_LSM_MEMTABLE_BYTES),
                "max_runs_per_tier": conf.get_int(
                    Keys.MASTER_METASTORE_LSM_COMPACTION_TRIGGER),
                "wal_sync": conf.get_bool(
                    Keys.MASTER_METASTORE_LSM_WAL_SYNC),
            })
        self.fs_master = FileSystemMaster(
            self.block_master, self.journal, clock=self._clock,
            inode_store=inode_store,
            default_block_size=conf.get_bytes(
                Keys.USER_BLOCK_SIZE_BYTES_DEFAULT),
            permission_checker=checker,
            umask=int(conf.get(Keys.SECURITY_AUTHORIZATION_PERMISSION_UMASK)),
            ufs_path_cache_capacity=conf.get_int(
                Keys.MASTER_UFS_PATH_CACHE_CAPACITY))
        from alluxio_tpu_torch.master.path_properties import (
            ConfigurationChecker, PathProperties,
        )

        self.path_properties = PathProperties(self.journal)
        from alluxio_tpu_torch.table.master import TableMaster

        def _table_fs_factory():
            from alluxio_tpu_torch.client.file_system import FileSystem

            fs_conf = Configuration(load_env=False)
            fs_conf.set(Keys.MASTER_FASTPATH_DIR,
                        conf.get(Keys.MASTER_FASTPATH_DIR))
            return FileSystem(self.address, conf=fs_conf)

        def _table_job_factory():
            from alluxio_tpu_torch.rpc.job_service import JobMasterClient

            return JobMasterClient(
                f"localhost:{conf.get_int(Keys.JOB_MASTER_RPC_PORT)}",
                conf=conf)

        # registered with the journal BEFORE replay so catalog entries
        # from prior runs find their component
        self.table_master = TableMaster(self.journal,
                                        fs_factory=_table_fs_factory,
                                        job_client_factory=_table_job_factory)
        self.config_checker = ConfigurationChecker()
        self.config_checker.register(
            "master", {k: str(v) for k, v in conf.to_map().items()})
        self._root_ufs_uri = root_ufs_uri or \
            conf.get(Keys.MASTER_MOUNT_TABLE_ROOT_UFS) or \
            conf.get(Keys.HOME) + "/underFSStorage"
        self.rpc_server: Optional[RpcServer] = None
        self.fastpath_server = None
        self._threads: List[HeartbeatThread] = []
        #: the checkers attached to a job service
        self._job_threads: List[HeartbeatThread] = []
        self.cluster_id = str(uuid.uuid4())
        self.start_time_ms = 0
        self._safe_mode_until = float("inf")
        self.rpc_port: Optional[int] = None
        self.replay_s = 0.0

    def in_safe_mode(self) -> bool:
        return time.monotonic() < self._safe_mode_until

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> int:
        """Boot straight to primary; returns the bound RPC port."""
        from alluxio_tpu_torch.utils.pause_monitor import (
            ensure_process_monitor,
        )
        from alluxio_tpu_torch.utils.tracing import (
            apply_trace_conf, set_tracing_enabled,
        )

        set_tracing_enabled(self._conf.get_bool(Keys.TRACE_ENABLED))
        apply_trace_conf(self._conf)
        # stall detector (reference: JvmPauseMonitor started at
        # AlluxioMasterProcess.java:265-273): ONE per process
        ensure_process_monitor()
        self.journal.start()
        t0 = time.perf_counter()
        self.journal.gain_primacy()
        #: seconds the journal replay took (checkpoint and segments)
        self.replay_s = time.perf_counter() - t0
        return self._start_serving()

    def _start_serving(self) -> int:
        """Primacy is held: start masters, heartbeats and the RPC server."""
        self.start_time_ms = self._clock.millis()
        if hasattr(self.journal, "start_group_commit"):
            # dedicated group-commit flusher: journal writes + fsyncs
            # leave the striped inode-lock critical sections
            self.journal.start_group_commit(self._conf.get_duration_s(
                Keys.MASTER_JOURNAL_FLUSH_BATCH_TIME))
        self.fs_master.start(self._root_ufs_uri)
        self._safe_mode_until = time.monotonic() + self._conf.get_duration_s(
            Keys.MASTER_SAFEMODE_WAIT)
        metrics("Master")
        from alluxio_tpu_torch.security.authentication import Authenticator
        from alluxio_tpu_torch.utils import faults

        # arm the conf-gated fault hooks (atpu.debug.fault.*): the
        # rpc.reject.rate drill sheds master dispatches too
        faults.injector().configure(self._conf)
        self._start_heartbeats()
        authenticator = Authenticator(self._conf)
        self.rpc_server = RpcServer(
            bind_host="0.0.0.0",
            port=self._conf.get_int(Keys.MASTER_RPC_PORT),
            authenticator=authenticator)
        self.rpc_server.add_service(fs_master_service(self.fs_master))
        self.rpc_server.add_service(block_master_service(self.block_master))
        self.rpc_server.add_service(table_master_service(
            self.table_master,
            permission_checker=self.permission_checker))
        self.rpc_server.add_service(meta_master_service(
            self._conf, cluster_id=self.cluster_id,
            start_time_ms=self.start_time_ms,
            safe_mode_fn=self.in_safe_mode, journal=self.journal,
            path_properties=self.path_properties,
            config_checker=self.config_checker,
            permission_checker=self.permission_checker,
            metastore_stats_fn=self.fs_master.metastore_stats))
        self.rpc_port = self.rpc_server.start()
        if self._conf.get_bool(Keys.MASTER_FASTPATH_ENABLED):
            from alluxio_tpu_torch.rpc.fastpath import (
                FastPathServer, socket_path_for,
            )

            self.fastpath_server = FastPathServer(
                socket_path_for(
                    f"localhost:{self.rpc_port}",
                    self._conf.get(Keys.MASTER_FASTPATH_DIR)),
                authenticator=authenticator)
            for svc in self.rpc_server._services.values():
                self.fastpath_server.add_service(svc)
            self.fastpath_server.start()
        return self.rpc_port

    def _start_heartbeats(self) -> None:
        conf = self._conf
        self._threads = [
            HeartbeatThread(
                HeartbeatContext.MASTER_LOST_WORKER_DETECTION,
                _Exec(self.block_master.detect_lost_workers),
                conf.get_duration_s(
                    Keys.MASTER_LOST_WORKER_DETECTION_INTERVAL)),
            HeartbeatThread(
                HeartbeatContext.MASTER_TTL_CHECK,
                _Exec(self.fs_master.check_ttl_expired),
                conf.get_duration_s(Keys.MASTER_TTL_CHECK_INTERVAL)),
            HeartbeatThread(
                HeartbeatContext.MASTER_TABLE_TRANSFORM_MONITOR,
                _Exec(self.table_master.heartbeat),
                conf.get_duration_s(Keys.TABLE_TRANSFORM_MONITOR_INTERVAL)),
        ]
        for t in self._threads:
            t.start()

    def attach_replication_checker(self, job_client,
                                   interval_s: Optional[float] = None) -> None:
        """Start the replication-control loop once a job service exists
        (reference: ``ReplicationChecker.java:57`` registered as an FSM
        heartbeat; here the job master boots after the metadata master, so
        the checker attaches late)."""
        from alluxio_tpu_torch.master.replication import ReplicationChecker

        checker = ReplicationChecker(
            self.fs_master, self.block_master, job_client,
            max_inflight=self._conf.get_int(
                Keys.MASTER_REPLICATION_MAX_INFLIGHT))
        self.replication_checker = checker
        t = HeartbeatThread(
            HeartbeatContext.MASTER_REPLICATION_CHECK,
            _Exec(checker.heartbeat),
            interval_s if interval_s is not None else
            self._conf.get_duration_s(
                Keys.MASTER_REPLICATION_CHECK_INTERVAL))
        t.start()
        self._job_threads.append(t)

    def attach_persistence_scheduler(self, job_client,
                                     interval_s: Optional[float] = None
                                     ) -> "PersistenceScheduler":
        """Start the async-persist scheduling loop once a job service
        exists (reference: the PersistenceScheduler heartbeat,
        ``DefaultFileSystemMaster.java:3810`` — attaches late here for the
        same reason as the replication checker)."""
        from alluxio_tpu_torch.master.persistence import PersistenceScheduler

        scheduler = PersistenceScheduler(self.fs_master, job_client)
        t = HeartbeatThread(
            HeartbeatContext.MASTER_PERSISTENCE_SCHEDULER,
            _Exec(scheduler.heartbeat),
            interval_s if interval_s is not None else
            self._conf.get_duration_s(
                Keys.MASTER_PERSISTENCE_SCHEDULER_INTERVAL))
        t.start()
        self._job_threads.append(t)
        return scheduler

    def detach_job_service(self) -> None:
        """Stop and join the checkers that call the job service, before
        it goes away (a checker mid-call would otherwise retry against a
        stopped job master until its RPC budget runs out)."""
        for t in self._job_threads:
            t.stop()
        self._job_threads = []

    def stop(self) -> None:
        self.detach_job_service()
        for t in self._threads:
            t.stop()
        self._threads = []
        if self.fastpath_server is not None:
            self.fastpath_server.stop()
            self.fastpath_server = None
        if self.rpc_server is not None:
            self.rpc_server.stop()
        self.fs_master.stop()
        self.journal.stop()

    @property
    def address(self) -> str:
        return f"localhost:{self.rpc_port}"
