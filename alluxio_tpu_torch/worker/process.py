"""Worker process assembly (a copy of ``alluxio_tpu/worker/process.py``).

Re-design of ``core/server/worker/.../{AlluxioWorkerProcess.java,
block/DefaultBlockWorker.java:77,197-242}``: builds the tiered store from
config (tier templates), wires the master-sync heartbeats, tier
management, the striped and coalescing UFS fetch pipeline
(``worker/ufs_fetch.py``) and the async cache manager riding it, the
SHM lease store, the metrics heartbeat to the master and the metrics
sinks, the read-only web endpoint and the process pause monitor, arms
the conf-gated fault hooks, and exposes the block-level API the data
server handlers call. Transport-independent: the gRPC data server
(``rpc/worker_service.py``) and in-process callers drive the same
object.

Left out with the slices that bring them: the config-consistency report
to the master, trace and profiler configuration, and the profile that
rides the JAX metrics heartbeat (``utils/profiler``).
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional

from alluxio_tpu_torch.conf import Configuration, Keys, Templates, parse_bytes
from alluxio_tpu_torch.heartbeat import HeartbeatContext, HeartbeatThread
from alluxio_tpu_torch.underfs.registry import UfsManager
from alluxio_tpu_torch.utils.exceptions import BlockDoesNotExistError
from alluxio_tpu_torch.utils.wire import TieredIdentity, WorkerNetAddress
from alluxio_tpu_torch.worker.allocator import Allocator
from alluxio_tpu_torch.worker.annotator import BlockAnnotator
from alluxio_tpu_torch.worker.management import ManagementTaskCoordinator
from alluxio_tpu_torch.worker.master_sync import (
    BlockMasterSync, PinListSync, StorageChecker,
)
from alluxio_tpu_torch.worker.meta import BlockMetadataManager
from alluxio_tpu_torch.worker.shm_store import ShmStore
from alluxio_tpu_torch.worker.tiered_store import BlockReader, TieredBlockStore
from alluxio_tpu_torch.worker.ufs_fetch import (
    BlockFetch, FetchConf, UfsBlockFetcher,
)
from alluxio_tpu_torch.worker.ufs_io import (
    AsyncCacheManager, UfsBlockDescriptor,
)

LOG = logging.getLogger(__name__)


class LocalBlockLease:
    """Short-circuit lease: path + held shared lock; close() releases."""

    def __init__(self, path: str, length: int, lock) -> None:
        self.path = path
        self.length = length
        self._lock = lock

    def close(self) -> None:
        self._lock.close()

    def __enter__(self) -> "LocalBlockLease":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def build_store_from_conf(conf: Configuration) -> TieredBlockStore:
    """Tier layout from the template keys
    (reference: WORKER_TIERED_STORE_LEVELS + per-level templates)."""
    meta = BlockMetadataManager()
    levels = conf.get_int(Keys.WORKER_TIERED_STORE_LEVELS)
    data_folder = conf.get(Keys.WORKER_DATA_FOLDER)
    shm_dir = conf.get(Keys.WORKER_SHM_DIR)
    ram_size = conf.get_bytes(Keys.WORKER_RAMDISK_SIZE)
    for lvl in range(levels):
        alias = conf.get(Templates.WORKER_TIER_ALIAS.format(lvl)) or \
            {0: "MEM", 1: "SSD", 2: "HDD"}.get(lvl, f"TIER{lvl}")
        tier = meta.add_tier(alias)
        paths = conf.get_list(Templates.WORKER_TIER_DIRS_PATH.format(lvl))
        quotas = conf.get_list(Templates.WORKER_TIER_DIRS_QUOTA.format(lvl))
        if not paths:
            if alias == "MEM":
                paths = [os.path.join(shm_dir, "mem")]
                quotas = quotas or [str(ram_size)]
            else:
                paths = [os.path.join(data_folder, alias.lower())]
                quotas = quotas or [str(4 * ram_size)]
        for i, p in enumerate(paths):
            quota = parse_bytes(quotas[i]) if i < len(quotas) else ram_size
            tier.add_dir(p, quota, medium_type=alias)
    allocator = Allocator.create(conf.get(Keys.WORKER_ALLOCATOR_CLASS), meta)
    ann_kind = conf.get(Keys.WORKER_ANNOTATOR_CLASS)
    if ann_kind == "LRFU":
        annotator = BlockAnnotator.create(
            "LRFU", step_factor=conf.get_float(Keys.WORKER_LRFU_STEP_FACTOR),
            attenuation_factor=conf.get_float(
                Keys.WORKER_LRFU_ATTENUATION_FACTOR))
    else:
        annotator = BlockAnnotator.create(ann_kind)
    return TieredBlockStore(meta, allocator, annotator)


class _MetricsReporter:
    """Ships this worker's metric snapshot — plus any completed trace
    spans drained from the local ring — to the master each tick for
    cluster aggregation and trace stitching (reference: worker side of
    metric_master.proto)."""

    def __init__(self, meta_client, source: str) -> None:
        self._client = meta_client
        self._source = source

    def heartbeat(self) -> None:
        from alluxio_tpu_torch.metrics import metrics
        from alluxio_tpu_torch.utils import faults
        from alluxio_tpu_torch.utils.tracing import tracer

        if faults.armed() and \
                faults.injector().heartbeat_frozen(self._source):
            # injected fault: the node is alive but its telemetry is
            # not — exactly the wedge the heartbeat-staleness rule and
            # the quarantine remediation exist to catch
            return
        spans = tracer().drain(500) if tracer().enabled else []
        from alluxio_tpu_torch.utils.profiler import profiler

        flame = profiler().drain() if profiler().running else None
        try:
            self._client.metrics_heartbeat(self._source,
                                           metrics().snapshot(),
                                           spans=spans, profile=flame)
        except Exception:  # noqa: BLE001 master transition: retry next tick
            # spans riding this tick are dropped — tracing is telemetry,
            # re-queueing could double-ship on a late-delivered RPC
            LOG.debug("metrics heartbeat failed", exc_info=True)

    def close(self) -> None:
        pass


class BlockWorker:
    """The worker: tiered store + protocols. Reference: DefaultBlockWorker.

    ``block_master_client``, ``fs_master_client`` and
    ``meta_master_client`` are duck-typed: the JAX package's gRPC master
    clients, or any object with their surface (``get_worker_id``,
    ``register``, ``heartbeat``, ``commit_block``;
    ``get_pinned_file_ids``; ``metrics_heartbeat``)."""

    def __init__(self, conf: Configuration, block_master_client,
                 fs_master_client=None,
                 ufs_manager: Optional[UfsManager] = None,
                 address: Optional[WorkerNetAddress] = None,
                 meta_master_client=None) -> None:
        from alluxio_tpu_torch.utils import faults

        self._meta_client = meta_master_client
        self._conf = conf
        # arm the conf-gated fault hooks (atpu.debug.fault.*) — a
        # no-op with the defaults; chaos tests set them
        faults.injector().configure(conf)
        self.store = build_store_from_conf(conf)
        self.ufs_manager = ufs_manager or UfsManager()
        host = conf.get(Keys.WORKER_HOSTNAME)
        self.address = address or WorkerNetAddress(
            host=host,
            rpc_port=conf.get_int(Keys.WORKER_RPC_PORT),
            shm_dir=conf.get(Keys.WORKER_SHM_DIR),
            tiered_identity=TieredIdentity.from_spec(
                conf.get(Keys.TIERED_IDENTITY), hostname=host))
        self._master_sync = BlockMasterSync(self.store, self.address,
                                            block_master_client)
        self._pin_sync = PinListSync(self.store, fs_master_client) \
            if fs_master_client is not None else None
        self._storage_checker = StorageChecker(self.store)
        self._mgmt = ManagementTaskCoordinator(
            self.store,
            align=conf.get_bool(Keys.WORKER_MANAGEMENT_TIER_ALIGN_ENABLED),
            promote=conf.get_bool(Keys.WORKER_MANAGEMENT_TIER_PROMOTE_ENABLED),
            quota_percent=conf.get_int(
                Keys.WORKER_MANAGEMENT_PROMOTE_QUOTA_PERCENT))
        fault_host = self.address.tiered_identity.value("host") \
            or self.address.host
        self.ufs_fetcher = UfsBlockFetcher(
            self.store, FetchConf.from_conf(conf), host=fault_host)
        # same-host zero-copy plane: lease registry over the MEM tier's
        # /dev/shm segments (shm/)
        self.shm_store = ShmStore(
            self.store,
            lease_ttl_s=conf.get_duration_s(Keys.WORKER_SHM_LEASE_TTL),
            max_leases=conf.get_int(Keys.WORKER_SHM_MAX_LEASES),
            host=fault_host)
        self.web_server = None
        self.web_port: Optional[int] = None
        self.sink_manager = None
        qos_enabled = conf.get_bool(Keys.WORKER_QOS_ENABLED)
        self.async_cache = AsyncCacheManager(
            self.store, lambda mount_id: self.ufs_manager.get(mount_id),
            self.ufs_fetcher,
            num_threads=conf.get_int(Keys.WORKER_ASYNC_CACHE_THREADS),
            queue_max=conf.get_int(Keys.WORKER_ASYNC_CACHE_QUEUE_MAX),
            prioritize=qos_enabled)
        if qos_enabled:
            from alluxio_tpu_torch.metrics import metrics as _metrics

            # Worker.Qos* gauges ride the metrics heartbeat into the
            # master's Cluster.* aggregates and history series
            reg = _metrics()
            fetcher = self.ufs_fetcher
            reg.register_gauge(
                "Worker.QosFetchDeferred",
                lambda: fetcher.qos_stats()["deferred"])
            reg.register_gauge(
                "Worker.QosFetchQueued",
                lambda: fetcher.qos_stats()["queued"])
            reg.register_gauge(
                "Worker.QosFetchPromotedTotal",
                lambda: fetcher.qos_stats()["promoted"])
        self._threads: List[HeartbeatThread] = []

    # -- lifecycle ----------------------------------------------------------
    @property
    def worker_id(self) -> Optional[int]:
        return self._master_sync.worker_id

    def register_with_master(self) -> int:
        """Register without starting the heartbeats (the worker is then
        ticked by hand, or by :meth:`start` later)."""
        return self._master_sync.register_with_master()

    def start(self) -> None:
        """Register then start heartbeats
        (reference: ``DefaultBlockWorker.start:197-242``)."""
        from alluxio_tpu_torch.metrics import metrics as _metrics
        from alluxio_tpu_torch.metrics.sinks import SinkManager
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
        ensure_process_monitor()
        self._master_sync.register_with_master()
        if self._meta_client is not None:
            try:  # config consistency report (ServerConfigurationChecker)
                self._meta_client.register_node_conf(
                    f"worker-{self.address.host}:{self.address.rpc_port}",
                    {k: str(v) for k, v in self._conf.to_map().items()})
            except Exception:  # noqa: BLE001 - older master
                LOG.debug("config report failed", exc_info=True)
        hb_interval = self._conf.get_duration_s(
            Keys.WORKER_BLOCK_HEARTBEAT_INTERVAL)
        mgmt_interval = self._conf.get_duration_s(
            Keys.WORKER_MANAGEMENT_TASK_INTERVAL)
        self._threads = [
            HeartbeatThread(HeartbeatContext.WORKER_BLOCK_SYNC,
                            self._master_sync, hb_interval),
            HeartbeatThread(HeartbeatContext.WORKER_STORAGE_HEALTH,
                            self._storage_checker, 60.0),
            HeartbeatThread(HeartbeatContext.WORKER_MANAGEMENT_TASKS,
                            self._mgmt, mgmt_interval),
        ]
        if self._meta_client is not None:
            self._threads.append(HeartbeatThread(
                HeartbeatContext.WORKER_CLIENT_METRICS,
                _MetricsReporter(
                    self._meta_client,
                    f"worker-{self.address.host}:{self.address.rpc_port}"),
                self._conf.get_duration_s(
                    Keys.WORKER_METRICS_HEARTBEAT_INTERVAL)))
        if self._pin_sync is not None:
            self._threads.append(
                HeartbeatThread(HeartbeatContext.WORKER_PIN_LIST_SYNC,
                                self._pin_sync, hb_interval))
        self.sink_manager = SinkManager(self._conf, _metrics())
        if self.sink_manager.sinks:
            self._threads.append(HeartbeatThread(
                HeartbeatContext.WORKER_METRICS_SINKS, self.sink_manager,
                self._conf.get_duration_s(Keys.METRICS_SINK_INTERVAL)))
        self.maybe_start_web()
        for t in self._threads:
            t.start()

    def maybe_start_web(self) -> None:
        """Start the read-only web endpoint when enabled (safe to call
        without the heartbeat machinery: serves live store state)."""
        if self.web_server is None and \
                self._conf.get_bool(Keys.WORKER_WEB_ENABLED):
            from alluxio_tpu_torch.worker.web import WorkerWebServer

            self.web_server = WorkerWebServer(
                self, port=self._conf.get_int(Keys.WORKER_WEB_PORT),
                bind_host=self._conf.get(Keys.WORKER_WEB_BIND_HOST))
            self.web_port = self.web_server.start()

    def heartbeat(self) -> None:
        """One block-sync tick by hand: report the delta since the last
        one and act on the master's command."""
        self._master_sync.heartbeat()

    def stop(self) -> None:
        for t in self._threads:
            t.stop()
        self._threads = []
        if self.web_server is not None:
            self.web_server.stop()
            self.web_server = None
        if self.sink_manager is not None:
            self.sink_manager.close()  # joins a Graphite sender
            self.sink_manager = None
        self.async_cache.close()
        self.ufs_fetcher.close()

    # -- data-plane API (called by the data server / local clients) --------
    def create_block(self, session_id: int, block_id: int, *,
                     initial_bytes: int, tier_alias: str = "") -> str:
        """Returns the temp-block *path* — the short-circuit write lease
        (reference: ``CreateLocalBlock`` in block_worker.proto:127-152)."""
        temp = self.store.create_block(session_id, block_id,
                                       initial_bytes=initial_bytes,
                                       tier_alias=tier_alias)
        return temp.path

    def get_temp_writer(self, session_id: int, block_id: int):
        return self.store.get_temp_writer(session_id, block_id)

    def commit_block(self, session_id: int, block_id: int,
                     pinned: bool = False) -> None:
        """Commit locally then report to the master (reference:
        ``DefaultBlockWorker.commitBlock`` -> BlockMasterClient.commitBlock).

        The heartbeat "committed" delta is emitted only AFTER the master
        acknowledges: a delta arriving before the commit RPC makes the
        master free the block as an orphan (observed race)."""
        meta = self.store.commit_block(session_id, block_id, pinned,
                                       emit=False)
        client = self._master_sync._client
        try:
            if self._master_sync.worker_id is not None:
                used = self.store.meta.get_tier(meta.tier_alias).used_bytes
                client.commit_block(self._master_sync.worker_id, used,
                                    meta.tier_alias, block_id, meta.length)
        finally:
            # emit even when the RPC failed: the heartbeat delta then tells
            # the master about the block, which either records it (RPC
            # actually landed) or frees the orphan — both clean outcomes
            self.store._emit("committed", block_id)

    def abort_block(self, session_id: int, block_id: int) -> None:
        self.store.abort_block(session_id, block_id)

    def open_reader(self, block_id: int) -> BlockReader:
        """Local committed-block reader (holds the shared lock)."""
        return self.store.get_reader(block_id)

    def open_local_block(self, block_id: int) -> LocalBlockLease:
        """Short-circuit read lease: the committed block file's path plus a
        shared lock held until the lease closes, so eviction cannot unlink
        the file mid-mmap (reference: ``OpenLocalBlock`` +
        ``ShortCircuitBlockReadHandler`` keep a block lock for the stream's
        lifetime)."""
        lock = self.store.pin_block(block_id)
        meta = self.store.get_block_meta(block_id)
        if meta is None:  # raced with eviction between pin and lookup
            lock.close()
            raise BlockDoesNotExistError(f"block {block_id} not cached")
        return LocalBlockLease(meta.path, meta.length, lock)

    def open_ufs_fetch(self, desc: UfsBlockDescriptor, *,
                       cache: bool = True, priority: int = 0,
                       tenant: str = "") -> BlockFetch:
        """Start (or join) the striped cold fetch of a block; the
        returned handle streams chunks as stripes land — the data
        server serves from it while the tiered store fills in
        parallel.  ``priority``/``tenant`` feed the QoS scheduler
        (default ON_DEMAND, anonymous tenant)."""
        ufs = self.ufs_manager.get(desc.mount_id)
        return self.ufs_fetcher.fetch(ufs, desc, cache=cache,
                                      priority=priority, tenant=tenant)

    def read_ufs_block(self, desc: UfsBlockDescriptor, *,
                       cache: bool = True) -> bytes:
        """Cold read-through, whole block at once (reference:
        UnderFileSystemBlockReader). Rides the same striped/coalesced
        pipeline as :meth:`open_ufs_fetch`."""
        return self.open_ufs_fetch(desc, cache=cache).result()

    def persist_file(self, ufs_path: str, block_ids: List[int],
                     mount_id: int) -> str:
        """Write locally-cached blocks out as one UFS file; returns the UFS
        content fingerprint (reference: the worker-side persist executor,
        ``worker/file/`` + job-service ``PersistDefinition``)."""
        ufs = self.ufs_manager.get(mount_id)
        with ufs.create(ufs_path) as out:
            for bid in block_ids:
                with self.open_reader(bid) as r:
                    pos = 0
                    while pos < r.length:
                        chunk = r.read(pos, 4 << 20)
                        if not chunk:
                            raise IOError(
                                f"block {bid} truncated at {pos} "
                                f"(expected {r.length} bytes)")
                        out.write(chunk)
                        pos += len(chunk)
        return ufs.get_fingerprint(ufs_path).serialize()

    def cleanup_session(self, session_id: int) -> None:
        self.shm_store.close_session(session_id)
        self.store.cleanup_session(session_id)
