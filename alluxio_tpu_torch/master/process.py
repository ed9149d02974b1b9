"""Master process assembly: the core of ``alluxio_tpu/master/process.py``'s
``MasterProcess``.

Re-design of ``core/server/master/.../{AlluxioMaster.java:35,
AlluxioMasterProcess.java:97,156,197,300}``: journal boot -> gain primacy ->
replay -> start masters + heartbeats -> serve RPC, with a **safe-mode
window** after primacy during which client ops are rejected while workers
re-register (reference: ``DefaultSafeModeManager``).

The port's master holds the journal, the block master, the permission
checker, the metastore (any kind ``atpu.master.metastore`` names), the
file master, the path properties, the table master (the catalog,
registered with the journal before replay), the cluster config checker
and the observability loop: the metrics master with its history, the
health rules, the remediation engine when it is switched on, the
stack sampler (``atpu.profile.*``) and the web server when it is
switched on. It serves the FS, block, table and meta services over gRPC
and the same-host fast path, and ticks the lost-worker, TTL,
transform-monitor and health heartbeats, and the metrics sinks that
``atpu.metrics.sinks`` names. Once a job service exists, the
replication checker and the persistence scheduler attach late
(``attach_replication_checker``, ``attach_persistence_scheduler``); the
table master reaches the job master by ``atpu.job.master.rpc.port`` when
it starts a transform. Each of the JAX master's other parts comes with
its own slice: the HA process (``FaultTolerantMasterProcess``) and its
quorum view with its history samples and health rule, the integrity
checkers and active sync, the update check, the scheduled backup, and
admission and audit with the tenant-overload rule. A conf key that asks
for one of the opt-in ones raises ``NotSupportedError`` rather than being
ignored.
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
    (Keys.MASTER_UPDATE_CHECK_ENABLED, "the update checker"),
    (Keys.MASTER_DAILY_BACKUP_ENABLED, "the scheduled backup"),
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
        self.metrics_master = None
        self.health_monitor = None
        self.remediation = None
        self.replication_checker = None
        self._worker_lost_listener_installed = False
        self.web_server = None
        self.web_port: Optional[int] = None
        self._threads: List[HeartbeatThread] = []
        #: the checkers attached to a job service
        self._job_threads: List[HeartbeatThread] = []
        self.cluster_id = str(uuid.uuid4())
        self.start_time_ms = 0
        self._safe_mode_until = float("inf")
        self.rpc_port: Optional[int] = None
        self.replay_s = 0.0
        #: last metastore_stats() pull (refreshed on the health tick) —
        #: gauges must not take the store lock on every scrape
        self._metastore_sample: dict = {}
        reg = metrics()
        reg.register_gauge("Master.MetastoreInodes", lambda: float(
            self._metastore_sample.get("inodes", 0) or 0))
        reg.register_gauge("Master.MetastoreMemtableBytes", lambda: float(
            self._metastore_sample.get("memtable_bytes", 0) or 0))
        reg.register_gauge("Master.MetastoreRuns", lambda: float(
            self._metastore_sample.get("runs", 0) or 0))
        reg.register_gauge("Master.MetastoreCompactionBytes", lambda: float(
            self._metastore_sample.get("compaction_bytes", 0) or 0))
        reg.register_gauge("Master.MetastoreCacheHitRatio", lambda: float(
            self._metastore_sample.get("cache_hit_ratio", 0.0) or 0.0))

    def _sample_metadata_history(self) -> None:
        """Push the metadata control plane's own gauges into the history
        rings as ``master``-source series on the health tick: inode-lock
        wait p99 — what the metadata-lock-contention rule watches — plus
        journal group-commit batch/flush shape and the invalidation-log
        counter.

        One difference: the JAX master passes ``0.99`` and ``0.50`` to a
        ``Timer.percentile`` that takes percent, so its ``.p99`` and
        ``.p50`` series hold the reservoir's lowest samples; the port
        samples the 99th and 50th percentiles."""
        history = self.metrics_master.history \
            if self.metrics_master is not None else None
        if history is None:
            return
        reg = metrics()
        history.ingest("master", {
            "Master.MetadataInodeLockWaitTime.p99":
                reg.timer("Master.MetadataInodeLockWaitTime")
                .percentile(99),
            "Master.MetadataJournalBatchSize.p50":
                reg.timer("Master.MetadataJournalBatchSize")
                .percentile(50),
            "Master.MetadataJournalFlushTime.p99":
                reg.timer("Master.MetadataJournalFlushTime")
                .percentile(99),
            "Master.MetadataCacheInvalidations": float(
                reg.counter("Master.MetadataCacheInvalidations").count),
        })
        # metastore shape: inode population, LSM memtable/run debt and
        # hot-set hit ratio — what the metastore-compaction-debt rule
        # watches.  HEAP/SQLITE backends report zeros for the LSM-only
        # series, which keeps the rule inert on those backends.
        try:
            self._metastore_sample = dict(
                self.fs_master.metastore_stats())
        except Exception:
            LOG.debug("metastore stats sample failed", exc_info=True)
        stats = self._metastore_sample
        history.ingest("master", {
            "Master.MetastoreInodes": float(stats.get("inodes", 0) or 0),
            "Master.MetastoreMemtableBytes":
                float(stats.get("memtable_bytes", 0) or 0),
            "Master.MetastoreRuns": float(stats.get("runs", 0) or 0),
            "Master.MetastoreCompactionBytes":
                float(stats.get("compaction_bytes", 0) or 0),
            "Master.MetastoreCacheHitRatio":
                float(stats.get("cache_hit_ratio", 0.0) or 0.0),
        })

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
        from alluxio_tpu_torch.utils.profiler import apply_profile_conf

        apply_profile_conf(self._conf)
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
        self._init_metrics_master()
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
            metrics_master=self.metrics_master,
            health_monitor=self.health_monitor,
            remediation_engine=self.remediation,
            invalidation_log=self.fs_master.invalidations,
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
        if self._conf.get_bool(Keys.MASTER_WEB_ENABLED):
            from alluxio_tpu_torch.master.web import MasterWebServer

            self.web_server = MasterWebServer(
                self, port=self._conf.get_int(Keys.MASTER_WEB_PORT),
                bind_host=self._conf.get(Keys.MASTER_WEB_BIND_HOST))
            self.web_port = self.web_server.start()
        return self.rpc_port

    def _init_metrics_master(self) -> None:
        """Metrics history + health-rule engine (cluster doctor),
        assembled before the heartbeats that tick them.  A lost worker
        leaves the aggregates immediately: its snapshot is cleared and
        its history series get an explicit end marker instead of
        lingering for the source TTL."""
        conf = self._conf
        from alluxio_tpu_torch.master.metrics_master import (
            MetricsMaster, MetricsStore,
        )

        max_sources = conf.get_int(Keys.MASTER_METRICS_MAX_SOURCES)
        store = MetricsStore(max_sources=max_sources)
        history = None
        if conf.get_bool(Keys.MASTER_METRICS_HISTORY_ENABLED):
            import math

            from alluxio_tpu_torch.metrics.history import MetricsHistory

            prefixes = tuple(
                p.strip() for p in str(conf.get(
                    Keys.MASTER_METRICS_HISTORY_ALLOW_PREFIXES)).split(",")
                if p.strip())
            # bound the offer queue by what can actually accumulate
            # between two drain ticks under the operator's conf: one
            # offer per source per report interval, over the drain
            # (health-eval) period, 2x for interval jitter — a raised
            # source cap or a slowed eval interval must not turn into
            # silent per-cycle tick drops
            report_s = max(0.001, min(
                conf.get_duration_s(Keys.WORKER_METRICS_HEARTBEAT_INTERVAL),
                conf.get_duration_s(Keys.USER_METRICS_HEARTBEAT_INTERVAL)))
            drains_behind = max(1, math.ceil(conf.get_duration_s(
                Keys.MASTER_HEALTH_EVAL_INTERVAL) / report_s))
            history = MetricsHistory(
                capacity=conf.get_int(Keys.MASTER_METRICS_HISTORY_CAPACITY),
                retention_s=conf.get_duration_s(
                    Keys.MASTER_METRICS_HISTORY_RETENTION),
                max_series=conf.get_int(
                    Keys.MASTER_METRICS_HISTORY_MAX_SERIES),
                allow_prefixes=prefixes,
                pending_max=2 * max_sources * drains_behind)
            reg = metrics()
            reg.register_gauge("Master.MetricsHistorySeries",
                               lambda: float(history.series_count()))
            reg.register_gauge("Master.MetricsHistorySamplesDropped",
                               lambda: float(history.dropped_samples))
            reg.register_gauge("Master.MetricsHistoryTicksDropped",
                               lambda: float(history.dropped_ticks))
        self.metrics_master = MetricsMaster(store=store, history=history)
        self.health_monitor = None
        if conf.get_bool(Keys.MASTER_HEALTH_ENABLED):
            from alluxio_tpu_torch.master.health import (
                HealthMonitor, default_rules, metastore_compaction_debt_rule,
            )

            rules = default_rules(
                stall_threshold=conf.get_float(
                    Keys.MASTER_HEALTH_STALL_THRESHOLD),
                stall_window_s=conf.get_duration_s(
                    Keys.MASTER_HEALTH_STALL_WINDOW),
                inode_lock_wait_p99_s=conf.get_duration_s(
                    Keys.MASTER_HEALTH_METADATA_LOCK_WAIT_THRESHOLD))
            # inert on HEAP/SQLITE (they report zero runs); on LSM it
            # catches compaction losing the race with flushes before
            # read amplification turns into an outage
            rules.append(metastore_compaction_debt_rule(
                conf.get_int(Keys.MASTER_METASTORE_COMPACTION_DEBT_RUNS)))
            if history is None:
                # don't advertise rules that silently no-op without
                # the history store: the report must only list rules
                # that are genuinely watching
                dropped = [r.name for r in rules if r.needs_history]
                rules = [r for r in rules if not r.needs_history]
                LOG.warning(
                    "health enabled without metrics history "
                    "(atpu.master.metrics.history.enabled=false): "
                    "rules %s are disabled, only %s remain active",
                    dropped, [r.name for r in rules])

            def _expected_worker_sources():
                # LIVE registered workers only (a lost worker is the
                # worker-lost rule's business) with time since their
                # LAST registration (stamped by the listener below) —
                # NOT start_time_ms, which survives loss/recovery and
                # would false-fire the missing-source staleness alert
                # for the whole grace window after every routine
                # worker re-registration.  Unknown sources read as
                # age 0 (alert suppressed): conservative until their
                # registration is observed.
                now = time.time()
                reg = self._worker_registered_at
                out = []
                for i in self.block_master.get_worker_infos():
                    src = f"worker-{i.address.host}:" \
                          f"{i.address.rpc_port}"
                    at = reg.get(src)
                    out.append((src, max(0.0, now - at)
                                if at is not None else 0.0))
                return out

            self.health_monitor = HealthMonitor(
                self.metrics_master,
                rules=rules,
                fire_after_s=conf.get_duration_s(
                    Keys.MASTER_HEALTH_FIRE_AFTER),
                resolve_after_s=conf.get_duration_s(
                    Keys.MASTER_HEALTH_RESOLVE_AFTER),
                eval_interval_s=conf.get_duration_s(
                    Keys.MASTER_HEALTH_EVAL_INTERVAL),
                worker_sources_fn=_expected_worker_sources)

        self.remediation = None
        if self.health_monitor is not None and \
                conf.get_bool(Keys.MASTER_REMEDIATION_ENABLED):
            from alluxio_tpu_torch.master.remediation import (
                RemediationEngine,
            )

            # default-off: with the key false this block never runs —
            # no engine object, no alert listener, no overlay in the
            # heartbeat response, no remediation in get_health
            self.remediation = RemediationEngine(
                self.block_master,
                metrics_master=self.metrics_master,
                dry_run=conf.get_bool(Keys.MASTER_REMEDIATION_DRY_RUN),
                max_actions_per_window=conf.get_int(
                    Keys.MASTER_REMEDIATION_MAX_ACTIONS_PER_WINDOW),
                window_s=conf.get_duration_s(
                    Keys.MASTER_REMEDIATION_WINDOW),
                cooldown_s=conf.get_duration_s(
                    Keys.MASTER_REMEDIATION_COOLDOWN),
                probation_s=conf.get_duration_s(
                    Keys.MASTER_REMEDIATION_PROBATION),
                rereplicate_blocks=conf.get_int(
                    Keys.MASTER_REMEDIATION_REREPLICATE_BLOCKS),
                quarantine_max_fraction=conf.get_float(
                    Keys.MASTER_REMEDIATION_QUARANTINE_MAX_FRACTION),
                hedge_quantile_base=conf.get_float(
                    Keys.USER_REMOTE_READ_HEDGE_QUANTILE),
                remote_concurrency_base=conf.get_int(
                    Keys.USER_REMOTE_READ_CONCURRENCY),
                prefetch_budget_base=conf.get_bytes(
                    Keys.PREFETCH_BUDGET_BYTES))
            if self.replication_checker is not None:
                self.remediation.bind_replication(self.replication_checker)
            self.health_monitor.alert_listeners.append(
                self.remediation.on_alerts)

        # source -> wall time of its last full registration; reset on
        # (re-)init conservatively — ages restart at 0, which only
        # delays the missing-source staleness alert by its grace
        self._worker_registered_at = {}

        def _on_worker_lost(info) -> None:
            source = f"worker-{info.address.host}:{info.address.rpc_port}"
            self._worker_registered_at.pop(source, None)
            # block=True: a lost-but-chatty worker's metrics heartbeats
            # must not re-admit its snapshot into Cluster.* aggregates
            self.metrics_master.store.clear_source(source, block=True)
            if self.metrics_master.history is not None:
                # fold still-queued offers first so a pre-death
                # heartbeat drained later cannot clear the end marker
                self.metrics_master.drain_history()
                self.metrics_master.history.end_source(source)

        def _on_worker_registered(info) -> None:
            # full block-list re-registration is the only revival
            # signal: metrics heartbeats alone must not clear the end
            # marker or unblock the store (a lost worker with a wedged
            # block-sync thread still ships metrics while serving
            # nothing)
            source = f"worker-{info.address.host}:{info.address.rpc_port}"
            self._worker_registered_at[source] = time.time()
            self.metrics_master.store.unblock_source(source)
            if self.metrics_master.history is not None:
                self.metrics_master.history.revive_source(source)

        def _on_location_drift(block_ids) -> None:
            """Block-location drift (worker loss/quarantine/release,
            re-replication) -> journaled ``INVALIDATE_PATH`` entries:
            client caches repair their location-derived fields on the
            next heartbeat instead of waiting out the cache TTL.  A mass
            event (whole worker's residents) collapses to one root
            invalidation — full cache drop beats flooding the bounded
            ring off its horizon one path at a time."""
            from alluxio_tpu_torch.utils import ids as _ids

            if len(block_ids) > 1024:
                self.fs_master.journal_invalidations(["/"])
                return
            tree = self.fs_master.inode_tree
            paths = set()
            with tree.lock.read_locked():
                for fid in {_ids.file_id_for_block(b) for b in block_ids}:
                    uri = tree.path_of_id(fid)
                    if uri is not None:
                        paths.add(uri.path)
            self.fs_master.journal_invalidations(sorted(paths))

        # once per process: the closures resolve self.metrics_master at
        # call time, so a second registration would only duplicate work
        if not self._worker_lost_listener_installed:
            self.block_master.lost_worker_listeners.append(_on_worker_lost)
            self.block_master.registered_worker_listeners.append(
                _on_worker_registered)
            self.block_master.location_change_listeners.append(
                _on_location_drift)
            self._worker_lost_listener_installed = True

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

        def _health_tick() -> None:
            if self.health_monitor is not None:
                self.health_monitor.evaluate()
            elif self.metrics_master.history is not None:
                # health disabled but history on: evaluate() normally
                # drains the pending offers, so tick the drain directly
                # or the bounded pending queue overflows between queries
                self.metrics_master.drain_history()
            self._sample_metadata_history()

        if self.health_monitor is not None or \
                self.metrics_master.history is not None:
            self._threads.append(HeartbeatThread(
                HeartbeatContext.MASTER_HEALTH_CHECK, _Exec(_health_tick),
                conf.get_duration_s(Keys.MASTER_HEALTH_EVAL_INTERVAL)))
        from alluxio_tpu_torch.metrics.sinks import SinkManager

        self.sink_manager = SinkManager(conf, metrics())
        if self.sink_manager.sinks:
            # the manager itself is the executor (heartbeat + close), so
            # sinks are closed on thread shutdown — same shape as the
            # worker side
            self._threads.append(HeartbeatThread(
                HeartbeatContext.MASTER_METRICS_SINKS, self.sink_manager,
                conf.get_duration_s(Keys.METRICS_SINK_INTERVAL)))
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
        if self.remediation is not None:
            # the re-replication action needs the job service; like the
            # checker itself it binds late, once one exists
            self.remediation.bind_replication(checker)
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
        if self.web_server is not None:
            self.web_server.stop()
            self.web_server = None
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
