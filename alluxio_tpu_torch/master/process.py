"""Master process assembly: the core of ``alluxio_tpu/master/process.py``'s
``MasterProcess``.

Re-design of ``core/server/master/.../{AlluxioMaster.java:35,
AlluxioMasterProcess.java:97,156,197,300}``: journal boot -> gain primacy ->
replay -> start masters + heartbeats -> serve RPC, with a **safe-mode
window** after primacy during which client ops are rejected while workers
re-register (reference: ``DefaultSafeModeManager``).

The port's master holds the journal, the block master, the permission
checker, the metastore (any kind ``atpu.master.metastore`` names), the
file master, the active sync points and the path properties, the table
master (the catalog; both registered with the journal before replay),
the integrity daemons (lost files, orphan blocks, abandoned UFS temps),
the cluster config checker and the observability loop: the metrics
master with its history, the health rules, the remediation engine when
it is switched on, the stack sampler (``atpu.profile.*``) and the web
server when it is switched on. Serving, it starts the audit writer and,
when ``atpu.master.rpc.admission.enabled`` is set, the admission
controller with the tenant-overload rule. It serves the FS (audited,
with the sync-point RPCs), block, table and meta services over gRPC and
the same-host fast path, both gated by admission, and ticks the
lost-worker, TTL, active-sync, transform-monitor, lost-file,
block-integrity, UFS-cleanup and health heartbeats (the health tick also
samples the admission counters), and the metrics sinks that
``atpu.metrics.sinks`` names. Once a job service exists, the
replication checker and the persistence scheduler attach late
(``attach_replication_checker``, ``attach_persistence_scheduler``); the
table master reaches the job master by ``atpu.job.master.rpc.port`` when
it starts a transform. A multi-master deployment adds the quorum view
(``masters_report``, the registry heartbeat, the quorum gauges with
their history samples and the ``master-quorum-degraded`` rule); the
scheduled backup and ``atpu.master.journal.init.from.backup`` are
switched on by their keys. ``FaultTolerantMasterProcess`` is the HA
master: a journal-tailing standby (serving reads when
``atpu.master.ha.standby.reads.enabled``) that promotes when its primary
selector (the Raft election under the EMBEDDED journal, a file lock on
the shared journal otherwise) grants primacy, and demotes when deposed.
The update check comes with the host-only surfaces; a conf key that asks
for it raises ``NotSupportedError`` rather than being ignored.

Differences from the JAX master:

- the ``Master.AuditLogDropped`` and ``Master.AuditLogDroppedDenied``
  gauges read the audit writer's dropped counts (all entries, and those
  of denied calls; the JAX master keeps the first on the writer only),
  so a master in its own process can show that every shed call was
  either audited or counted as dropped;
- the HA master fences its primary reads on both transports. The JAX
  master wraps the FS read handlers in the primacy check after the
  fast-path server has copied them, so until the asynchronous demote
  stops that server a deposed leader answers same-host reads from
  lagging state, unmarked. Here the fence is applied before either
  server takes the handlers;
- a demotion also stops the web server and the job-service checkers,
  which the next promotion's serving start (or a new attach) brings
  back; the JAX demote leaves its web server bound, so its next
  promotion cannot bind the web port again.
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
    FS_SERVICE, STANDBY_FS_READS, block_master_service, fs_master_service,
    meta_master_service,
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
    (Keys.MASTER_UPDATE_CHECK_ENABLED, "the update checker"),
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
        self._conf = conf
        self._clock = clock or SystemClock()
        jtype = str(conf.get(Keys.MASTER_JOURNAL_TYPE)).upper()
        if jtype == "EMBEDDED":
            lo = conf.get_ms(Keys.MASTER_EMBEDDED_JOURNAL_ELECTION_TIMEOUT_MIN)
            hi = conf.get_ms(Keys.MASTER_EMBEDDED_JOURNAL_ELECTION_TIMEOUT_MAX)
            self.journal = create_journal_system(
                jtype, conf.get(Keys.MASTER_JOURNAL_FOLDER),
                address=str(conf.get(
                    Keys.MASTER_EMBEDDED_JOURNAL_ADDRESS)),
                addresses=str(conf.get(
                    Keys.MASTER_EMBEDDED_JOURNAL_ADDRESSES)),
                election_timeout_ms=(int(lo), int(hi)),
                heartbeat_interval_ms=int(conf.get_ms(
                    Keys.MASTER_EMBEDDED_JOURNAL_HEARTBEAT_INTERVAL)),
                snapshot_period_entries=conf.get_int(
                    Keys.MASTER_EMBEDDED_JOURNAL_SNAPSHOT_PERIOD_ENTRIES))
        else:
            self.journal = create_journal_system(
                jtype, conf.get(Keys.MASTER_JOURNAL_FOLDER),
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
        from alluxio_tpu_torch.master.sync import ActiveSyncManager

        self.active_sync = ActiveSyncManager(self.fs_master, self.journal)
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
        from alluxio_tpu_torch.master.integrity import (
            BlockIntegrityChecker, LostFileDetector, UfsCleaner,
        )

        self.lost_file_detector = LostFileDetector(self.fs_master,
                                                   self.block_master)
        self.block_integrity_checker = BlockIntegrityChecker(
            self.fs_master, self.block_master)
        self.ufs_cleaner = UfsCleaner(
            self.fs_master.mount_table, self.fs_master._ufs,
            ttl_ms=conf.get_ms(Keys.MASTER_PERSISTENCE_TEMP_TTL))
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
        self.admission = None
        self.audit_writer = None
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
        self.scheduled_backup = None
        from alluxio_tpu_torch.journal.ha import MasterRegistry

        #: shared-journal presence registry behind `fsadmin report
        #: masters` and the quorum-degraded health sampling (docs/ha.md)
        self.master_registry = MasterRegistry(
            str(conf.get(Keys.MASTER_JOURNAL_FOLDER)))
        #: expected quorum size: the configured master list (client
        #: addresses, falling back to the raft member list); 0 = not HA
        self._ha_expected = max(
            len(self._conf_address_list(Keys.MASTER_RPC_ADDRESSES)),
            len(self._conf_address_list(
                Keys.MASTER_EMBEDDED_JOURNAL_ADDRESSES)))
        #: last quorum-liveness sample (health tick) — served as gauges
        #: and ingested as `master` history series (docs/ha.md)
        self._ha_live_sample = 1.0
        self._ha_lag_sample = 0.0
        #: (address-or-None, monotonic expiry) — bounds the registry
        #: directory scan leader_address costs on the standby read path
        self._leader_cache: "Optional[tuple]" = None
        #: publishes registry rows / runs the publish heartbeat: multi-
        #: master deployments only (FaultTolerantMasterProcess forces
        #: True — the file-lock flavor can run without a configured
        #: master list).  A plain single master must not grow a masters/
        #: dir it rewrites every second for nobody.
        self._ha_member = self._ha_expected > 1
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
        reg.register_gauge("Master.AuditLogDropped", lambda: float(
            self.audit_writer.dropped if self.audit_writer is not None
            else 0))
        reg.register_gauge("Master.AuditLogDroppedDenied", lambda: float(
            self.audit_writer.dropped_denied
            if self.audit_writer is not None else 0))
        if self._ha_expected > 1:
            reg.register_gauge("Master.HaQuorumExpected",
                               lambda: float(self._ha_expected))
            reg.register_gauge("Master.HaQuorumLive",
                               lambda: self._ha_live_sample)
            reg.register_gauge("Master.HaStandbyLagEntries",
                               lambda: self._ha_lag_sample)

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

    def _conf_address_list(self, key) -> List[str]:
        return [a.strip() for a in str(self._conf.get(key) or "").split(",")
                if a.strip()]

    # -- HA quorum view ------------------------------------------------------
    #: a registry row older than this is counted dead by the quorum-
    #: degraded sampling (3 missed refresh ticks, floor 3s for jittery
    #: test hosts).  Standbys refresh their row on the journal-tailer
    #: tick, not the publish heartbeat, so the threshold must cover the
    #: SLOWER of the two cadences — else an operator raising the tail
    #: interval makes every healthy standby read as dead and latches
    #: the master-quorum-degraded alert on a healthy quorum.
    def _ha_live_threshold_s(self) -> float:
        return max(3.0,
                   3 * self._conf.get_duration_s(
                       Keys.MASTER_HA_PUBLISH_INTERVAL),
                   3 * self._conf.get_duration_s(
                       Keys.MASTER_STANDBY_TAIL_INTERVAL))

    @property
    def client_address(self) -> str:
        """The address clients reach THIS master at (conf hostname +
        the actually-bound RPC/standby port)."""
        port = self.rpc_port or getattr(self, "standby_rpc_port", None) or \
            self._conf.get_int(Keys.MASTER_RPC_PORT)
        return f"{self._conf.get(Keys.MASTER_HOSTNAME)}:{port}"

    def _raft_to_client_address(self, raft_addr: str) -> Optional[str]:
        """Map a raft member address to its client RPC address by list
        position (``atpu.master.rpc.addresses`` zipped with
        ``atpu.master.embedded.journal.addresses``, the reference's
        convention)."""
        rpc = self._conf_address_list(Keys.MASTER_RPC_ADDRESSES)
        raft = self._conf_address_list(
            Keys.MASTER_EMBEDDED_JOURNAL_ADDRESSES)
        if raft_addr in raft and len(rpc) == len(raft):
            return rpc[raft.index(raft_addr)]
        return None

    def leader_address(self) -> Optional[str]:
        """Best-known current primary (client address) — the hint a
        standby's NotPrimaryError carries.  None when unknown.  A bound
        primary RPC port plus live journal primacy IS primacy here: the
        FT ``serving`` flag flips only after ``_start_serving`` returns,
        and the registry must not publish a freshly-promoted master as a
        standby in between.  The primacy check matters on the way DOWN
        too: a deposed leader whose RPC server has not stopped yet must
        hint the NEW leader (or nothing), never itself — a self-hint
        would spin redirected clients on the deposed master."""
        if self.rpc_port and self.journal.is_primary():
            return self.client_address
        node = getattr(self.journal, "node", None)
        if node is not None:  # EMBEDDED: raft leader, mapped to rpc addr
            leader_id = node.leader_id
            if leader_id and leader_id != node.node_id:
                return self._raft_to_client_address(leader_id)
            return None
        # shared-journal flavor: freshest published PRIMARY row.  The
        # scan is synchronous disk IO (listdir + per-row json) and every
        # standby-served read resolves the hint, so cache the answer for
        # a fraction of the publish interval — the rows themselves are
        # never fresher than that interval, and a wrong hint only costs
        # the client one redirect hop
        now = time.monotonic()
        cached = self._leader_cache
        if cached is not None and now < cached[1]:
            return cached[0]
        limit = self._ha_live_threshold_s()
        best = None
        for row in self.master_registry.list():
            if row.get("role") != "PRIMARY":
                continue
            if row.get("last_contact_s", limit) >= limit:
                continue
            if row.get("address") == self.client_address:
                continue  # ourselves (stale row from a previous term)
            if best is None or row["last_contact_s"] < \
                    best["last_contact_s"]:
                best = row
        addr = best["address"] if best else None
        ttl = 0.5 * self._conf.get_duration_s(
            Keys.MASTER_HA_PUBLISH_INTERVAL)
        self._leader_cache = (addr, now + ttl)
        return addr

    def _publish_registry(self) -> None:
        """One registry row for this master (role, applied sequence,
        term) — primaries publish on their own heartbeat, standbys on
        the tailer tick.  Role rides the same port+primacy signal as
        ``leader_address`` so a deposed-but-not-demoted master never
        advertises PRIMARY."""
        if not self._ha_member:
            return
        # never publish an unreachable row: before a port is bound the
        # address falls back to conf MASTER_RPC_PORT, which tests (and
        # ephemeral-port deployments) set to 0 — a ":0" row would sit in
        # the file-per-address registry forever, poisoning quorum views
        if self.client_address.endswith(":0"):
            return
        role = "PRIMARY" if self.rpc_port and self.journal.is_primary() \
            else "STANDBY"
        node = getattr(self.journal, "node", None)
        term = node.log.term if node is not None else 0
        self.master_registry.publish(
            self.client_address, role=role,
            sequence=int(getattr(self.journal, "sequence", 0)), term=term)

    def masters_report(self) -> dict:
        """The quorum view served by ``get_masters`` (`fsadmin report
        masters`, statuspage "Masters"): one row per known master,
        merged from the shared-journal registry and — under the
        EMBEDDED journal — live Raft quorum state."""
        rows: dict = {}
        for row in self.master_registry.list():
            rows[row["address"]] = dict(row)
        self._publish_registry()  # our own row, fresh
        me = rows[self.client_address] = {
            "address": self.client_address,
            "role": "PRIMARY" if self.rpc_port and
            self.journal.is_primary() else "STANDBY",
            "sequence": int(getattr(self.journal, "sequence", 0)),
            "term": 0, "last_contact_s": 0.0,
        }
        tailer = getattr(self, "_tailer", None)
        if tailer is not None and me["role"] == "STANDBY":
            me["tailer_lag_s"] = max(
                0.0, time.monotonic() - tailer.last_caught_up)
        quorum = None
        if hasattr(self.journal, "quorum_info"):
            quorum = self.journal.quorum_info()
            me["term"] = quorum.get("term", 0)
            for m in quorum.get("members", []):
                addr = self._raft_to_client_address(m["node_id"]) or \
                    m["node_id"]
                if addr == self.client_address:
                    continue
                row = rows.setdefault(addr, {"address": addr,
                                             "sequence": None})
                row["role"] = {"LEADER": "PRIMARY",
                               "FOLLOWER": "STANDBY"}.get(
                    m.get("role", ""), "UNKNOWN")
                row["term"] = quorum.get("term", 0)
                row["match_index"] = m.get("match_index")
                row["last_contact_s"] = m.get("last_contact_s")
        # lag relative to the furthest-applied member we can see; raft
        # members without a registry row still report replication
        # progress through the leader's match_index
        def _applied(r):
            return r["sequence"] if r.get("sequence") is not None \
                else r.get("match_index")

        seqs = [_applied(r) for r in rows.values()
                if _applied(r) is not None]
        head = max(seqs) if seqs else 0
        for r in rows.values():
            if _applied(r) is not None:
                r["lag_entries"] = head - _applied(r)
        out = {"leader": self.leader_address(),
               "masters": sorted(rows.values(),
                                 key=lambda r: r["address"])}
        if quorum is not None:
            out["quorum"] = quorum
        return out

    def _sample_ha_history(self) -> None:
        """Quorum liveness gauges into the history rings on the health
        tick (``master`` source): what the ``master-quorum-degraded``
        rule watches (docs/ha.md)."""
        if self._ha_expected <= 1:
            return
        history = self.metrics_master.history \
            if self.metrics_master is not None else None
        if history is None:
            return
        limit = self._ha_live_threshold_s()
        live = 1  # ourselves
        lag = 0
        node = getattr(self.journal, "node", None)
        if node is not None:
            info = node.quorum_info()
            for m in info.get("members", []):
                age = m.get("last_contact_s")
                if m.get("address") != "self" and age is not None and \
                        age < limit:
                    live += 1
            follower_match = [m.get("match_index", 0)
                              for m in info.get("members", [])
                              if m.get("address") != "self"]
            if follower_match:
                lag = max(0, info.get("commit_index", 0)
                          - min(follower_match))
        else:
            my_seq = int(getattr(self.journal, "sequence", 0))
            for row in self.master_registry.list():
                if row.get("address") == self.client_address:
                    continue
                if row.get("last_contact_s", limit) < limit:
                    live += 1
                    lag = max(lag, my_seq - int(row.get("sequence", 0)))
        self._ha_live_sample = float(live)
        self._ha_lag_sample = float(lag)
        history.ingest("master", {
            "Master.HaQuorumExpected": float(self._ha_expected),
            "Master.HaQuorumLive": float(live),
            "Master.HaStandbyLagEntries": float(lag),
        })

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
        self._init_from_backup_if_configured()
        t0 = time.perf_counter()
        self.journal.gain_primacy()
        #: seconds the journal replay took (checkpoint and segments)
        self.replay_s = time.perf_counter() - t0
        return self._start_serving()

    def _init_from_backup_if_configured(self) -> None:
        """Seed an empty journal from a metadata backup (reference:
        initFromBackup, AlluxioMasterProcess.java:173-190)."""
        backup = self._conf.get(Keys.MASTER_JOURNAL_INIT_FROM_BACKUP)
        if backup and hasattr(self.journal, "init_from_backup"):
            self.journal.init_from_backup(str(backup))

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
        from alluxio_tpu_torch.security.audit import AsyncAuditLogWriter
        from alluxio_tpu_torch.security.authentication import Authenticator
        from alluxio_tpu_torch.utils import faults

        # arm the conf-gated fault hooks (atpu.debug.fault.*): the
        # rpc.reject.rate drill sheds master dispatches too
        faults.injector().configure(self._conf)
        self.audit_writer = AsyncAuditLogWriter()
        self.audit_writer.start()
        self.admission = None
        if self._conf.get_bool(Keys.MASTER_RPC_ADMISSION_ENABLED):
            from alluxio_tpu_torch.qos.admission import (
                AdmissionConf, AdmissionController,
            )

            # built BEFORE the metrics master so the tenant-overload
            # health rule can close over it; shed RPCs are audited
            # with allowed=False next to the permission denials
            self.admission = AdmissionController(
                AdmissionConf.from_conf(self._conf),
                audit_writer=self.audit_writer)
        self._init_metrics_master()
        self._start_heartbeats()
        authenticator = Authenticator(self._conf)
        self.rpc_server = RpcServer(
            bind_host="0.0.0.0",
            port=self._conf.get_int(Keys.MASTER_RPC_PORT),
            authenticator=authenticator,
            admission=self.admission)
        self.rpc_server.add_service(fs_master_service(
            self.fs_master, active_sync=self.active_sync,
            audit_writer=self.audit_writer))
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
            admission=self.admission,
            invalidation_log=self.fs_master.invalidations,
            masters_fn=self.masters_report,
            metastore_stats_fn=self.fs_master.metastore_stats))
        # before either transport takes the handlers: the fast path
        # copies them when it registers a service
        self._fence_primary_reads()
        self.rpc_port = self.rpc_server.start()
        # announce primacy to the quorum view the moment the port is
        # bound, then keep the row fresh on its own heartbeat
        from alluxio_tpu_torch.utils.exceptions import best_effort

        if self._ha_member:
            best_effort("master registry publish",
                        self._publish_registry)
            self._threads.append(HeartbeatThread(
                HeartbeatContext.MASTER_LOST_MASTER_DETECTION,
                _Exec(self._publish_registry),
                self._conf.get_duration_s(
                    Keys.MASTER_HA_PUBLISH_INTERVAL)))
            self._threads[-1].start()
        if self._conf.get_bool(Keys.MASTER_FASTPATH_ENABLED):
            from alluxio_tpu_torch.rpc.fastpath import (
                FastPathServer, socket_path_for,
            )

            self.fastpath_server = FastPathServer(
                socket_path_for(
                    f"localhost:{self.rpc_port}",
                    self._conf.get(Keys.MASTER_FASTPATH_DIR)),
                authenticator=authenticator,
                admission=self.admission)
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

    def _fence_primary_reads(self) -> None:
        """A master that is not HA stays primary while it serves: its
        reads need no primacy check."""

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
            if self.admission is not None:
                from alluxio_tpu_torch.master.health import (
                    tenant_overload_rule,
                )

                # flags a principal whose master RPCs are being shed
                # at a sustained rate — the doctor names the tenant
                # exceeding its share instead of operators diffing
                # audit logs
                rules.append(tenant_overload_rule(
                    self.admission.shed_counts))
            # inert on HEAP/SQLITE (they report zero runs); on LSM it
            # catches compaction losing the race with flushes before
            # read amplification turns into an outage
            if self._ha_expected > 1:
                from alluxio_tpu_torch.master.health import (
                    quorum_degraded_rule,
                )

                # a lost standby costs nothing today, which is exactly
                # why it must alert: the next failure is the outage
                rules.append(quorum_degraded_rule(self._ha_expected))
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
                HeartbeatContext.MASTER_ACTIVE_SYNC,
                _Exec(self.active_sync.heartbeat),
                conf.get_duration_s(Keys.MASTER_ACTIVE_SYNC_INTERVAL)),
            HeartbeatThread(
                HeartbeatContext.MASTER_TABLE_TRANSFORM_MONITOR,
                _Exec(self.table_master.heartbeat),
                conf.get_duration_s(Keys.TABLE_TRANSFORM_MONITOR_INTERVAL)),
            HeartbeatThread(
                HeartbeatContext.MASTER_LOST_FILES_DETECTION,
                _Exec(self.lost_file_detector.heartbeat),
                conf.get_duration_s(
                    Keys.MASTER_LOST_FILES_DETECTION_INTERVAL)),
            HeartbeatThread(
                HeartbeatContext.MASTER_BLOCK_INTEGRITY_CHECK,
                _Exec(self.block_integrity_checker.heartbeat),
                conf.get_duration_s(
                    Keys.MASTER_BLOCK_INTEGRITY_CHECK_INTERVAL)),
            HeartbeatThread(
                HeartbeatContext.MASTER_UFS_CLEANUP,
                _Exec(self.ufs_cleaner.heartbeat),
                conf.get_duration_s(Keys.MASTER_UFS_CLEANUP_INTERVAL)),
        ]

        def _health_tick() -> None:
            if self.health_monitor is not None:
                self.health_monitor.evaluate()
            elif self.metrics_master.history is not None:
                # health disabled but history on: evaluate() normally
                # drains the pending offers, so tick the drain directly
                # or the bounded pending queue overflows between queries
                self.metrics_master.drain_history()
            if self.admission is not None:
                # Master.RpcAdmission* series ride the same tick the
                # remediation samples do: flood shapes stay visible in
                # the history after the flood is gone
                self.admission.sample_history(self.metrics_master.history)
            self._sample_metadata_history()
            self._sample_ha_history()

        if self.health_monitor is not None or \
                self.metrics_master.history is not None:
            self._threads.append(HeartbeatThread(
                HeartbeatContext.MASTER_HEALTH_CHECK, _Exec(_health_tick),
                conf.get_duration_s(Keys.MASTER_HEALTH_EVAL_INTERVAL)))
        if conf.get_bool(Keys.MASTER_DAILY_BACKUP_ENABLED):
            from alluxio_tpu_torch.master.backup import ScheduledBackup

            self.scheduled_backup = ScheduledBackup(
                self.journal, conf.get(Keys.MASTER_BACKUP_DIR),
                interval_s=conf.get_duration_s(
                    Keys.MASTER_DAILY_BACKUP_INTERVAL),
                retention=conf.get_int(Keys.MASTER_DAILY_BACKUP_RETENTION))
            # ticked well under the backup interval so a missed beat
            # only delays, never skips, a due backup
            self._threads.append(HeartbeatThread(
                HeartbeatContext.MASTER_DAILY_BACKUP,
                _Exec(self.scheduled_backup.heartbeat),
                min(60.0, conf.get_duration_s(
                    Keys.MASTER_DAILY_BACKUP_INTERVAL))))
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
        if self.audit_writer is not None:
            self.audit_writer.stop()
        self.fs_master.stop()
        self.journal.stop()
        from alluxio_tpu_torch.utils.exceptions import best_effort

        best_effort("master registry withdraw",
                    self.master_registry.withdraw, self.client_address)

    @property
    def address(self) -> str:
        return f"localhost:{self.rpc_port}"


class FaultTolerantMasterProcess(MasterProcess):
    """HA master: boots as a journal-tailing standby and starts serving
    when the primary selector grants primacy (reference:
    ``FaultTolerantAlluxioMasterProcess`` + standby tailing)."""

    def __init__(self, conf: Configuration, *, selector=None, **kwargs
                 ) -> None:
        super().__init__(conf, **kwargs)
        from alluxio_tpu_torch.journal.ha import (
            FileLockPrimarySelector, JournalTailer,
        )

        # standby-serving torn-read exclusion: the standby apply paths
        # (tailer tick, raft apply loop) hold no inode-path locks, so a
        # concurrently served read could observe a half-applied
        # rename/delete — a state no journal version ever contained,
        # which would break the advertised staleness contract.  Holding
        # the tree-wide WRITE lock around each apply batch excludes the
        # read handlers (which hold it in read mode via lock_path); it
        # is acquired OUTSIDE the journal/node locks, the same
        # tree-first canonical order the primary's RPC paths use
        # (docs/ha.md).
        def _apply_exclusion():
            return self.fs_master.inode_tree.lock.write_locked()

        if selector is not None:
            self.selector = selector
        else:
            from alluxio_tpu_torch.journal.raft import (
                EmbeddedJournalSystem, RaftPrimarySelector,
            )

            if isinstance(self.journal, EmbeddedJournalSystem):
                # embedded journal: Raft election IS primary election, and
                # followers apply continuously (no tailer needed)
                self.selector = RaftPrimarySelector(self.journal)
                self.journal.node.on_step_down(self._on_deposed)
            else:
                self.selector = FileLockPrimarySelector(
                    conf.get(Keys.MASTER_JOURNAL_FOLDER))
        node = getattr(self.journal, "node", None)
        if node is not None:  # EMBEDDED (any selector): raft apply loop
            node.apply_exclusion = _apply_exclusion
        import threading

        self._tailer = JournalTailer(
            self.journal,
            interval_s=conf.get_duration_s(
                Keys.MASTER_STANDBY_TAIL_INTERVAL),
            node=self.client_address,
            on_tick=self._publish_registry,
            apply_exclusion=_apply_exclusion)
        self._promote_thread = None
        self._promote_lock = threading.Lock()
        self._stopped = False
        self.serving = False
        # an FT master is an HA member even without a configured master
        # list (the file-lock flavor discovers peers via the shared
        # journal dir alone): always publish registry rows
        self._ha_member = True
        #: read-only RPC server while standby (atpu.master.ha.standby.
        #: reads.enabled): GetStatus/ListStatus/Exists off the tailing
        #: apply, everything else a NotPrimaryError redirect
        self._standby_server = None
        self.standby_rpc_port: Optional[int] = None

    def start(self) -> int:  # type: ignore[override]
        """Standby boot: tail the journal; a background thread waits for
        primacy and promotes. Returns 0 (no RPC port while standby) —
        callers poll ``rpc_port``/``serving``."""
        import threading

        from alluxio_tpu_torch.utils.pause_monitor import ensure_process_monitor
        from alluxio_tpu_torch.utils.tracing import (
            apply_trace_conf, set_tracing_enabled,
        )

        set_tracing_enabled(self._conf.get_bool(Keys.TRACE_ENABLED))
        apply_trace_conf(self._conf)
        from alluxio_tpu_torch.utils.profiler import apply_profile_conf

        apply_profile_conf(self._conf)
        # the HA master is the one whose elections stall detection
        # protects — it must not be the one path without it
        ensure_process_monitor()
        self.selector.start()
        self.journal.start()
        self._init_from_backup_if_configured()
        t0 = time.perf_counter()
        if self.selector.try_acquire():
            # under _promote_lock: a Raft step-down firing _on_deposed
            # mid-boot must not demote half-initialized serving state
            with self._promote_lock:
                self.journal.gain_primacy()
                self.replay_s = time.perf_counter() - t0
                port = self._start_serving()
                self.serving = True
            return port
        self.journal.standby_start()
        self.replay_s = time.perf_counter() - t0
        # standby endpoint FIRST: the tailer's on_tick publishes this
        # master's registry row, and publishing before the read port is
        # bound advertises the configured (possibly ephemeral :0) port —
        # a stale row the file-per-address registry then keeps forever
        self._start_standby_serving()
        self._tailer.start()
        self._promote_thread = threading.Thread(
            target=self._wait_and_promote, name="primacy-waiter",
            daemon=True)
        self._promote_thread.start()
        return 0

    def _start_standby_serving(self) -> None:
        """Open the read-only RPC endpoint on the configured master
        port: reads are served off the tailed state, stamped with this
        standby's journal-deterministic md_version; every other RPC is
        a typed NotPrimaryError redirect (docs/ha.md)."""
        if not self._conf.get_bool(Keys.MASTER_HA_STANDBY_READS_ENABLED):
            return
        from alluxio_tpu_torch.rpc.master_service import (
            standby_block_service, standby_fs_service,
            standby_meta_service,
        )
        from alluxio_tpu_torch.security.authentication import Authenticator

        server = RpcServer(
            bind_host="0.0.0.0",
            port=self._conf.get_int(Keys.MASTER_RPC_PORT),
            authenticator=Authenticator(self._conf))
        server.add_service(standby_fs_service(
            self.fs_master, self.leader_address,
            active_sync=self.active_sync))
        server.add_service(standby_block_service(
            self.block_master, self.leader_address))
        server.add_service(standby_meta_service(
            self._conf, leader_fn=self.leader_address,
            cluster_id=self.cluster_id,
            start_time_ms=self.start_time_ms, journal=self.journal,
            masters_fn=self.masters_report,
            permission_checker=self.permission_checker))
        self.standby_rpc_port = server.start()
        self._standby_server = server
        LOG.info("standby master serving reads on port %d",
                 self.standby_rpc_port)

    def _stop_standby_serving(self) -> None:
        if self._standby_server is not None:
            self._standby_server.stop()
            self._standby_server = None
            self.standby_rpc_port = None

    def _fence_primary_reads(self) -> None:
        """Primacy-gate the serving FS reads: a deposed leader demotes
        asynchronously (``_on_deposed`` runs on its own thread), and
        until its servers actually stop it would keep serving reads
        from state that now LAGS the new leader — without the standby
        marker, so a strong client would trust them.  Checking live
        primacy per read closes that window the moment the node learns
        it stepped down.  ``_start_serving`` calls this before the gRPC
        server starts and before the fast-path server copies the
        handlers, so both transports are fenced (the JAX master fences
        after the fast path took its copies).  (A partitioned leader
        that has not yet heard the higher term can still serve
        briefly-stale reads — the classic lease-read gap; terms fence
        every write. docs/ha.md.)"""
        svc = self.rpc_server.service(FS_SERVICE)
        if svc is None:
            return
        journal = self.journal

        def gate(fn):
            def handler(r):
                if not journal.is_primary():
                    from alluxio_tpu_torch.utils.exceptions import (
                        NotPrimaryError,
                    )

                    raise NotPrimaryError(
                        "this master was deposed",
                        leader=self.leader_address() or None)
                return fn(r)

            return handler

        for name, (fn, kind) in list(svc.methods.items()):
            if name in STANDBY_FS_READS:
                svc.methods[name] = (gate(fn), kind)

    def _wait_and_promote(self) -> None:
        while not self._stopped:
            if self.selector.wait_for_primacy(timeout_s=0.5):
                with self._promote_lock:
                    if self._stopped:
                        # stop() raced our acquisition: hand the lock back
                        # so another master can promote
                        self.selector.release()
                        return
                    self.promote()
                return

    def _on_deposed(self) -> None:
        """Raft step-down while serving: stop client RPCs and rejoin the
        election loop as a standby. Journal writes already fail fast
        (propose raises when not leader), so this is availability hygiene,
        not the fence — terms are the fence. Runs on its own thread: the
        raft node invokes callbacks under its lock."""
        import threading

        def demote():
            with self._promote_lock:
                if self._stopped or not self.serving:
                    return
                self.serving = False
                for t in self._threads:
                    t.stop()
                self._threads = []
                # the job-service checkers write through the journal: a
                # standby cannot; a new attach brings them back
                self.detach_job_service()
                if self.web_server is not None:
                    # released so the next promotion can bind it again
                    self.web_server.stop()
                    self.web_server = None
                if getattr(self, "fastpath_server", None) is not None:
                    # a deposed master must not keep serving local
                    # clients over the Unix socket either
                    self.fastpath_server.stop()
                    self.fastpath_server = None
                if self.rpc_server is not None:
                    self.rpc_server.stop()
                    self.rpc_server = None
                self.rpc_port = None
                if getattr(self, "audit_writer", None) is not None:
                    self.audit_writer.stop()
                    self.audit_writer = None
                # rejoin the quorum as a standby: resume tailing (a
                # no-op tick under raft, but it publishes our STANDBY
                # registry row) and re-open the read-only endpoint
                self._tailer.start()
                self._start_standby_serving()
                self._promote_thread = threading.Thread(
                    target=self._wait_and_promote, name="primacy-waiter",
                    daemon=True)
                self._promote_thread.start()

        threading.Thread(target=demote, name="raft-demote",
                         daemon=True).start()

    def promote(self) -> int:
        """Standby -> primary: stop tailing, finish the tail in place (no
        state reset — the standby is already caught up), open the write
        log, start serving.  The standby read server is stopped FIRST so
        ``_start_serving`` can bind the same configured port."""
        self._tailer.stop()
        self._stop_standby_serving()
        if hasattr(self.journal, "gain_primacy_from_standby"):
            self.journal.gain_primacy_from_standby()
        else:
            self.journal.gain_primacy()
        port = self._start_serving()
        self.serving = True
        return port

    def stop(self) -> None:
        with self._promote_lock:
            self._stopped = True
        if self._promote_thread is not None:
            self._promote_thread.join(timeout=10)
            self._promote_thread = None
        self._tailer.stop()
        self._stop_standby_serving()
        was_serving = self.serving
        self.serving = False
        if was_serving:
            super().stop()
        else:
            self.journal.stop()
            from alluxio_tpu_torch.utils.exceptions import best_effort

            best_effort("master registry withdraw",
                        self.master_registry.withdraw,
                        self.client_address)
        self.selector.release()
