"""Public FileSystem client API: a copy of ``alluxio_tpu/client/file_system.py``.

Re-design of ``core/client/fs/src/main/java/alluxio/client/file/
{FileSystem.java:79,BaseFileSystem.java:92,FileSystemContext.java:91}``:
one facade over the master clients + block store, with an optional
client-side metadata cache (``MetadataCachingBaseFileSystem``) and the
config-hash live-reinit handshake (``FileSystemContextReinitializer.java:44``).
"""

from __future__ import annotations

import socket
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

from alluxio_tpu_torch.client.block_store import BlockStoreClient
from alluxio_tpu_torch.client.block_streams import BatchReadConf
from alluxio_tpu_torch.client.policy import BlockLocationPolicy
from alluxio_tpu_torch.client.remote_read import RemoteReadConf
from alluxio_tpu_torch.client.streams import FileInStream, FileOutStream, WriteType
from alluxio_tpu_torch.conf import Configuration, Keys
from alluxio_tpu_torch.rpc.clients import (
    BlockMasterClient, FsMasterClient, MetaMasterClient,
)
from alluxio_tpu_torch.utils.exceptions import best_effort
from alluxio_tpu_torch.utils.uri import AlluxioURI
from alluxio_tpu_torch.utils.wire import FileInfo, MountPointInfo, TieredIdentity


class _MetadataCache:
    """Bounded-LRU path -> FileInfo / listing cache with master-pushed
    invalidation (reference: ``client/file/MetadataCache.java`` is
    TTL-only; here every GetStatus/ListStatus response carries a
    version stamp from the master's invalidation log and the metrics
    heartbeat delivers invalidated path-prefixes, so a warm entry stays
    coherent within one heartbeat interval — docs/metadata.md.  TTL
    remains the belt-and-braces bound for partitioned clients).

    Thread-safe: the heartbeat thread applies pushes while reader
    threads hit the cache."""

    #: listings live under ``path + _LIST`` so path-prefix invalidation
    #: naturally covers them
    _LIST = "\0list"

    def __init__(self, max_size: int, ttl_s: float) -> None:
        self._max = max_size
        self._ttl = ttl_s
        self._entries: "OrderedDict[str, tuple]" = OrderedDict()
        self._lock = threading.Lock()
        #: highest master invalidation-log version applied here (None
        #: until the first heartbeat establishes the floor)
        self.applied_version: Optional[int] = None

    # -- reads --------------------------------------------------------------
    def get(self, path: str) -> Optional[FileInfo]:
        return self._get(path)

    def get_listing(self, path: str) -> Optional[List[FileInfo]]:
        return self._get(path + self._LIST)

    def _get(self, key: str):
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return None
            value, expiry, _stamp = e
            if time.monotonic() > expiry:
                del self._entries[key]
                return None
            self._entries.move_to_end(key)
            return value

    # -- writes -------------------------------------------------------------
    def put(self, path: str, info: FileInfo,
            stamp: Optional[int] = None) -> None:
        self._put(path, info, stamp)

    def put_listing(self, path: str, infos: List[FileInfo],
                    stamp: Optional[int] = None) -> None:
        self._put(path + self._LIST, infos, stamp)

    def _put(self, key: str, value, stamp: Optional[int]) -> None:
        with self._lock:
            if stamp is not None and self.applied_version is not None \
                    and stamp < self.applied_version:
                # the response predates invalidations already applied
                # here — caching it could retain a forever-stale entry
                return
            if key not in self._entries and \
                    len(self._entries) >= self._max:
                self._entries.popitem(last=False)
            self._entries[key] = (value, time.monotonic() + self._ttl, stamp)
            self._entries.move_to_end(key)

    # -- invalidation -------------------------------------------------------
    def invalidate(self, path: str) -> None:
        """Local write-through invalidation (this client's own mutation
        — effective immediately, before any push): drop the path, its
        parent's entry+listing, and every cached descendant."""
        with self._lock:
            self._invalidate_locked(path)

    def _invalidate_locked(self, path: str) -> None:
        self._entries.pop(path, None)
        self._entries.pop(path + self._LIST, None)
        prefix = path.rstrip("/") + "/"
        for p in [p for p in self._entries if p.startswith(prefix)]:
            self._entries.pop(p, None)
        parent = AlluxioURI(path).parent()
        if parent is not None:
            self._entries.pop(parent.path, None)
            self._entries.pop(parent.path + self._LIST, None)

    def apply_push(self, inv: dict) -> int:
        """Apply a master invalidation batch
        (``{"to": v, "prefixes": [...], "reset": bool}``) from the
        metrics-heartbeat response; returns the number of prefixes
        applied.  ``reset`` (first contact, or this client fell off the
        master's bounded ring) drops everything."""
        prefixes = inv.get("prefixes") or ()
        with self._lock:
            if inv.get("reset"):
                self._entries.clear()
            else:
                for p in prefixes:
                    self._invalidate_locked(p)
            to = inv.get("to")
            if to is not None:
                self.applied_version = int(to)
        return len(prefixes)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def size(self) -> int:
        with self._lock:
            return len(self._entries)


class FileSystem:
    """The user-facing client (reference: ``FileSystem.Factory.create``)."""

    def __init__(self, master_address: str,
                 conf: Optional[Configuration] = None) -> None:
        self._conf = conf or Configuration()
        from alluxio_tpu_torch.utils.tracing import (
            apply_trace_conf, set_tracing_enabled,
        )

        if self._conf.get_bool(Keys.TRACE_ENABLED):
            set_tracing_enabled(True)
        apply_trace_conf(self._conf)
        from alluxio_tpu_torch.utils.profiler import apply_profile_conf

        apply_profile_conf(self._conf)
        from alluxio_tpu_torch.security.authentication import client_metadata

        md = tuple(client_metadata(self._conf))
        fp_dir = self._conf.get(Keys.MASTER_FASTPATH_DIR)
        # HA: when the caller-supplied address names a member of the
        # conf master list (atpu.master.rpc.addresses), widen to the
        # whole list so every client path — metadata, block, and the
        # metrics heartbeat — rides leader redirects and rotation
        # across the quorum (docs/ha.md).  An explicit address OUTSIDE
        # the list wins untouched: attaching to a specific master (or
        # another cluster) must not be silently rerouted by site conf.
        conf_list = [a.strip() for a in
                     str(self._conf.get(Keys.MASTER_RPC_ADDRESSES)
                         or "").split(",") if a.strip()]
        given = [a.strip() for a in str(master_address).split(",")
                 if a.strip()]
        if conf_list and (not given or set(given) <= set(conf_list)):
            addresses = ",".join(conf_list)
        else:
            addresses = str(master_address)
        # retry budget from conf (atpu.user.rpc.retry.duration):
        # overload drills shorten it so a flooded client gives up fast
        # instead of stacking 30s of backoff behind a shedding master
        retry_kw = dict(
            retry_duration_s=self._conf.get_duration_s(
                Keys.USER_RPC_RETRY_MAX_DURATION),
            base_sleep_s=self._conf.get_duration_s(
                Keys.USER_RPC_RETRY_BASE_SLEEP),
            max_sleep_s=self._conf.get_duration_s(
                Keys.USER_RPC_RETRY_MAX_SLEEP))
        self.fs_master = FsMasterClient(addresses, metadata=md,
                                        fastpath_dir=fp_dir, **retry_kw)
        self.block_master = BlockMasterClient(addresses, metadata=md,
                                              fastpath_dir=fp_dir,
                                              **retry_kw)
        self.meta_master = MetaMasterClient(addresses, metadata=md,
                                            fastpath_dir=fp_dir,
                                            **retry_kw)
        identity = TieredIdentity.from_spec(
            self._conf.get(Keys.TIERED_IDENTITY),
            hostname=socket.gethostname())
        self.store = BlockStoreClient(
            self.block_master, identity=identity,
            read_policy=BlockLocationPolicy.create(
                self._conf.get(Keys.USER_BLOCK_READ_POLICY),
                identity=identity),
            write_policy=BlockLocationPolicy.create(
                self._conf.get(Keys.USER_BLOCK_WRITE_POLICY),
                identity=identity),
            short_circuit=self._conf.get_bool(Keys.USER_SHORT_CIRCUIT_ENABLED),
            passive_cache=self._conf.get_bool(
                Keys.USER_FILE_PASSIVE_CACHE_ENABLED),
            write_unavailable_window_s=self._conf.get_duration_s(
                Keys.USER_BLOCK_WRITE_UNAVAILABLE_WINDOW),
            streaming_chunk_size=self._conf.get_bytes(
                Keys.USER_STREAMING_READER_CHUNK_SIZE),
            streaming_writer_chunk_size=self._conf.get_bytes(
                Keys.USER_STREAMING_WRITER_CHUNK_SIZE),
            remote_read=RemoteReadConf.from_conf(self._conf),
            shm_enabled=self._conf.get_bool(Keys.USER_SHM_ENABLED),
            shm_cache_max=self._conf.get_int(
                Keys.USER_SHM_SEGMENT_CACHE_MAX),
            shm_renew_fraction=self._conf.get_float(
                Keys.USER_SHM_LEASE_RENEW_FRACTION),
            batch_read=BatchReadConf.from_conf(self._conf),
            native_fastpath=self._conf.get_bool(
                Keys.USER_NATIVE_FASTPATH_ENABLED))
        # pull cluster defaults once at start (reference: clients load
        # cluster-default config via the meta master on first connect)
        self._path_conf: Dict[str, Dict[str, str]] = {}
        self._path_conf_hash: Optional[str] = None
        self._config_hash: Optional[str] = None
        if self._conf.get_bool(Keys.USER_CONF_CLUSTER_DEFAULT_ENABLED):
            try:
                from alluxio_tpu_torch.conf import Source

                # short retry: an offline master must not stall client
                # construction for the full 30s default retry window
                quick = MetaMasterClient(addresses, metadata=md,
                                         retry_duration_s=1.0)
                resp = quick.get_configuration()
                self._conf.merge(resp["properties"], Source.CLUSTER_DEFAULT)
                self._config_hash = resp["hash"]
                self._refresh_path_conf()
            except Exception:  # noqa: BLE001 - offline client still works
                pass
        md_cache_size = self._conf.get_int(Keys.USER_METADATA_CACHE_MAX_SIZE)
        self._md_cache = _MetadataCache(
            md_cache_size,
            self._conf.get_duration_s(Keys.USER_METADATA_CACHE_EXPIRATION_TIME)
        ) if md_cache_size > 0 and self._conf.get_bool(
            Keys.USER_METADATA_CACHE_ENABLED) else None
        from alluxio_tpu_torch.metrics import metrics as _m

        self._md_hits = _m().counter("Client.MetadataCacheHits")
        self._md_misses = _m().counter("Client.MetadataCacheMisses")
        self._md_inval = _m().counter("Client.MetadataCacheInvalidated")
        self._sync_interval_ms = int(1000 * self._conf.get_duration_s(
            Keys.USER_FILE_METADATA_SYNC_INTERVAL))
        self._page_cache = None
        if self._conf.get_bool(Keys.USER_CLIENT_CACHE_ENABLED):
            from alluxio_tpu_torch.client.cache.manager import LocalCacheManager

            self._page_cache = LocalCacheManager.from_conf(self._conf)
        #: config-hash handshake pacing (reference: ConfigHashSync): the
        #: metrics heartbeat re-checks the cluster-default hash at most
        #: once per atpu.user.conf.sync.interval — set BEFORE the
        #: heartbeat thread starts, which may tick immediately
        self._conf_sync_interval_s = self._conf.get_duration_s(
            Keys.USER_CONF_SYNC_INTERVAL)
        self._last_conf_sync = time.monotonic()
        self._metrics_thread = None
        if self._conf.get_bool(Keys.USER_METRICS_COLLECTION_ENABLED):
            from alluxio_tpu_torch.heartbeat import (
                HeartbeatContext, HeartbeatThread,
            )

            self._metrics_thread = HeartbeatThread(
                HeartbeatContext.CLIENT_METRICS_HEARTBEAT,
                _ClientMetricsSync(self), self._conf.get_duration_s(
                    Keys.USER_METRICS_HEARTBEAT_INTERVAL))
            self._metrics_thread.start()

    def send_metrics(self) -> None:
        """Ship this client's metric snapshot — plus completed trace
        spans drained from the local ring — to the master for cluster
        aggregation and trace stitching (reference:
        ``client/metrics/ClientMasterSync``).  The response may carry a
        remediation tuning overlay; applying it here means pushed
        retunes land within one heartbeat interval, no extra RPC."""
        from alluxio_tpu_torch.metrics import metrics
        from alluxio_tpu_torch.utils.profiler import profiler
        from alluxio_tpu_torch.utils.tracing import tracer

        spans = tracer().drain(500) if tracer().enabled else []
        flame = profiler().drain() if profiler().running else None
        resp = self.meta_master.metrics_heartbeat(
            f"client-{socket.gethostname()}-{id(self):x}",
            metrics().snapshot(), spans=spans, profile=flame,
            md_cache_version=self._md_cache.applied_version
            if self._md_cache is not None else None,
            want_md_invalidations=self._md_cache is not None)
        if self._md_cache is not None and isinstance(resp, dict) and \
                isinstance(resp.get("md_invalidations"), dict):
            self._md_inval.inc(
                self._md_cache.apply_push(resp["md_invalidations"]))
        if self._conf_sync_interval_s > 0 and \
                self._conf.get_bool(Keys.USER_CONF_CLUSTER_DEFAULT_ENABLED):
            now = time.monotonic()
            if now - self._last_conf_sync >= self._conf_sync_interval_s:
                self._last_conf_sync = now
                best_effort("config-hash sync", self.check_config_sync)
        if isinstance(resp, dict) and "conf_overlay_version" in resp:
            self.apply_conf_overlay(resp.get("conf_overlay") or {},
                                    int(resp["conf_overlay_version"]))

    #: master-pushable keys -> (clamp, apply) — everything else in an
    #: overlay is ignored: the push surface is a closed catalog, not a
    #: remote-write of arbitrary client conf
    _OVERLAY_CLAMPS = {
        "atpu.user.remote.read.hedge.quantile":
            lambda v: min(1.0, max(0.5, float(v))),
        "atpu.user.remote.read.concurrency":
            lambda v: min(64, max(1, int(float(v)))),
        "atpu.prefetch.budget.bytes":
            lambda v: min(4 << 30, max(16 << 20, int(float(v)))),
    }

    def apply_conf_overlay(self, overlay: Dict[str, object],
                           version: int) -> None:
        """Apply (or revert) the master's remediation tuning overlay.
        Idempotent per version; values are clamped client-side (a
        misbehaving master cannot push a client off a cliff); keys the
        overlay no longer carries revert to the value this client
        booted with."""
        if version == getattr(self, "_overlay_version", None):
            return
        self._overlay_version = version
        runtime = self.store.remote_read
        bases = getattr(self, "_overlay_bases", None)
        if bases is None:
            bases = self._overlay_bases = {
                "atpu.user.remote.read.hedge.quantile":
                    runtime.conf.hedge_quantile,
                "atpu.user.remote.read.concurrency":
                    runtime.conf.concurrency,
                "atpu.prefetch.budget.bytes": None,  # scheduler-owned
            }
        import dataclasses as _dc

        from alluxio_tpu_torch.metrics import metrics

        applied = []
        replace = {}
        for key, clamp in self._OVERLAY_CLAMPS.items():
            raw = overlay.get(key)
            try:
                value = clamp(raw) if raw is not None else bases[key]
            except (TypeError, ValueError):
                continue  # a malformed push must not break heartbeats
            if key == "atpu.user.remote.read.hedge.quantile":
                replace["hedge_quantile"] = float(value)
            elif key == "atpu.user.remote.read.concurrency":
                replace["concurrency"] = int(value)
            elif key == "atpu.prefetch.budget.bytes":
                from alluxio_tpu_torch.prefetch.scheduler import (
                    retune_budget,
                )

                # None = overlay withdrawn: restore each scheduler's
                # own configured budget
                retune_budget(None if raw is None else int(value))
            if raw is not None:
                applied.append(key)
        # the conf dataclass is frozen; swap it atomically so a stream
        # mid-read never sees a half-applied retune
        runtime.conf = _dc.replace(runtime.conf, **replace)
        metrics().counter("Client.ConfOverlayApplied").inc()
        self._overlay_active = applied

    @property
    def conf(self):
        """This client's resolved :class:`Configuration` (read-only use;
        layered services — e.g. the table reader — key their behavior
        off client conf without reaching into privates)."""
        return self._conf

    # ------------------------------------------------------------- metadata
    def get_status(self, path: "str | AlluxioURI") -> FileInfo:
        p = AlluxioURI(path).path
        if self._md_cache is None:
            return self.fs_master.get_status(
                p, sync_interval_ms=self._sync_interval_ms)
        hit = self._md_cache.get(p)
        if hit is not None:
            self._md_hits.inc()
            return hit
        self._md_misses.inc()
        info, stamp = self.fs_master.get_status(
            p, sync_interval_ms=self._sync_interval_ms, want_version=True)
        self._md_cache.put(p, info, stamp)
        return info

    def exists(self, path: "str | AlluxioURI") -> bool:
        return self.fs_master.exists(AlluxioURI(path).path)

    def list_status(self, path: "str | AlluxioURI",
                    recursive: bool = False) -> List[FileInfo]:
        p = AlluxioURI(path).path
        if self._md_cache is None or recursive:
            return self.fs_master.list_status(
                p, recursive=recursive,
                sync_interval_ms=self._sync_interval_ms)
        hit = self._md_cache.get_listing(p)
        if hit is not None:
            self._md_hits.inc()
            return list(hit)
        self._md_misses.inc()
        infos, stamp = self.fs_master.list_status(
            p, recursive=False, sync_interval_ms=self._sync_interval_ms,
            want_version=True)
        self._md_cache.put_listing(p, infos, stamp)
        return list(infos)

    def create_directory(self, path: "str | AlluxioURI", **opts) -> FileInfo:
        self._invalidate(path)
        return self.fs_master.create_directory(AlluxioURI(path).path, **opts)

    def delete(self, path: "str | AlluxioURI", recursive: bool = False,
               alluxio_only: bool = False) -> None:
        self._invalidate(path)
        self.fs_master.delete(AlluxioURI(path).path, recursive=recursive,
                              alluxio_only=alluxio_only)

    def rename(self, src: "str | AlluxioURI", dst: "str | AlluxioURI") -> None:
        self._invalidate(src)
        self._invalidate(dst)
        self.fs_master.rename(AlluxioURI(src).path, AlluxioURI(dst).path)

    def mount(self, path: "str | AlluxioURI", ufs_uri: str, **opts) -> None:
        self._invalidate(path)
        self.fs_master.mount(AlluxioURI(path).path, ufs_uri, **opts)

    def unmount(self, path: "str | AlluxioURI") -> None:
        self._invalidate(path)
        self.fs_master.unmount(AlluxioURI(path).path)

    def get_mount_points(self) -> List[MountPointInfo]:
        return self.fs_master.get_mount_points()

    def set_attribute(self, path: "str | AlluxioURI", **opts) -> None:
        self._invalidate(path)
        self.fs_master.set_attribute(AlluxioURI(path).path, **opts)

    def free(self, path: "str | AlluxioURI", recursive: bool = False,
             forced: bool = False) -> List[int]:
        return self.fs_master.free(AlluxioURI(path).path,
                                   recursive=recursive, forced=forced)

    def persist(self, path: "str | AlluxioURI") -> None:
        self.fs_master.schedule_async_persistence(AlluxioURI(path).path)

    def persist_now(self, path: "str | AlluxioURI", *,
                    expected_id: int = 0) -> str:
        """Synchronously write a cached file back to its UFS via a worker
        holding its blocks, then mark the inode persisted (reference: the
        worker-side persist executor driven by ``PersistDefinition``).

        ``expected_id`` pins the operation to one inode: a rename that
        put a DIFFERENT (already-persisted) file at ``path`` must fail
        the job — reporting success would silently drop the renamed
        file's ASYNC_THROUGH durability; the scheduler re-resolves the
        id and retries at the new path."""
        from alluxio_tpu_torch.utils.exceptions import (
            FileDoesNotExistError, UnavailableError,
        )

        info = self.get_status(path)
        if expected_id and info.file_id != expected_id:
            raise FileDoesNotExistError(
                f"inode {expected_id} is no longer at {path} (found "
                f"{info.file_id}) — re-resolve and retry")
        if not info.ufs_path:
            raise UnavailableError(f"{path} has no UFS path to persist to")
        if info.persisted:
            return ""
        fbis = self.fs_master.get_file_block_info_list(info.path)
        # the persisting worker must hold every block locally: pick one
        # present in all blocks' location sets (LOCAL_FIRST writes keep a
        # file's blocks on one worker, so this is the common case)
        target = None
        if fbis:
            candidates = None
            addr_by_key = {}
            for fbi in fbis:
                keys = set()
                for loc in fbi.block_info.locations:
                    keys.add(loc.address.key())
                    addr_by_key[loc.address.key()] = loc.address
                candidates = keys if candidates is None else \
                    (candidates & keys)
            if not candidates:
                raise UnavailableError(
                    f"no single worker holds all cached blocks of {path}")
            target = addr_by_key[sorted(candidates)[0]]
        if target is None:
            # zero-block file: master creates the empty UFS object, then
            # marks persisted (a PERSISTED inode with no UFS object would
            # be deleted by the next metadata sync)
            fingerprint = self.fs_master.commit_persist(
                info.path, "", expected_id=info.file_id)
            self._invalidate(path)
            return fingerprint
        # persist to a TEMP UFS path; the master promotes it
        # (commit_persist) only while the SAME inode is still live, so a
        # concurrent delete or delete+recreate can never leave a zombie
        # or stale UFS file for metadata sync to resurrect
        # (reference: temp persist paths + UfsCleaner for abandoned ones)
        import uuid

        d, _, name = info.ufs_path.rpartition("/")
        temp_ufs = f"{d}/.atpu_persist.{name}.{uuid.uuid4().hex[:8]}"
        worker = self.store.worker_client(target)
        worker.persist_file(
            temp_ufs, [fbi.block_info.block_id for fbi in fbis],
            info.mount_id)
        fingerprint = self.fs_master.commit_persist(
            info.path, temp_ufs, expected_id=info.file_id)
        self._invalidate(path)
        return fingerprint

    def _invalidate(self, path) -> None:
        if self._md_cache is not None:
            self._md_cache.invalidate(AlluxioURI(path).path)

    # ----------------------------------------------------------------- data
    def open_file(self, path: "str | AlluxioURI", *,
                  cache: Optional[bool] = None,
                  info: Optional[FileInfo] = None,
                  max_open_streams: Optional[int] = None) -> FileInStream:
        """``info``: a FileInfo the caller already holds (skips the
        get_status round-trip — the loader's first-batch path).
        ``max_open_streams``: cap on cached per-block streams (worker
        pins) — long-lived many-file holders pass 1."""
        if info is None:
            info = self.get_status(path)
        if info.folder:
            from alluxio_tpu_torch.utils.exceptions import InvalidArgumentError

            raise InvalidArgumentError(f"{path} is a directory")
        if cache is None:
            cache = self._conf.get(Keys.USER_FILE_READ_TYPE_DEFAULT) != \
                "NO_CACHE"
        stream = FileInStream(self.fs_master, self.store, info,
                              cache=cache,
                              max_open_streams=max_open_streams)
        if self._page_cache is not None:
            from alluxio_tpu_torch.client.cache.stream import CachingFileInStream

            return CachingFileInStream(stream, self._page_cache)
        return stream

    def _refresh_path_conf(self) -> None:
        resp = self.meta_master.get_path_conf()
        self._path_conf = resp.get("properties", {})
        self._path_conf_hash = resp.get("hash")

    def path_default(self, path: "str | AlluxioURI",
                     key) -> Optional[str]:
        """Per-path cluster default for a property, longest prefix wins
        (reference: PathProperties served by the meta master)."""
        if not self._path_conf:
            return None
        from alluxio_tpu_torch.master.path_properties import resolve_path_property

        name = key if isinstance(key, str) else key.name
        return resolve_path_property(self._path_conf,
                                     AlluxioURI(path).path, name)

    def create_file(self, path: "str | AlluxioURI", *,
                    write_type: Optional[str] = None,
                    block_size_bytes: Optional[int] = None,
                    tier: str = "", pinned: bool = False,
                    **opts) -> FileOutStream:
        self._invalidate(path)
        wt = write_type or \
            self.path_default(path, Keys.USER_FILE_WRITE_TYPE_DEFAULT) or \
            self._conf.get(Keys.USER_FILE_WRITE_TYPE_DEFAULT)
        if "replication_min" not in opts:
            rep = self.path_default(path, Keys.USER_FILE_REPLICATION_MIN)
            if rep is not None:
                opts["replication_min"] = int(rep)
        if "replication_max" not in opts:
            rep = self.path_default(path, Keys.USER_FILE_REPLICATION_MAX)
            if rep is None:
                rep = self._conf.get_int(Keys.USER_FILE_REPLICATION_MAX)
            if rep is not None and int(rep) >= 0:
                opts["replication_max"] = int(rep)
        persist_on_complete = wt == WriteType.ASYNC_THROUGH
        info = self.fs_master.create_file(
            AlluxioURI(path).path, block_size_bytes=block_size_bytes,
            persist_on_complete=persist_on_complete, **opts)
        return FileOutStream(self.fs_master, self.store, info,
                             write_type=wt, tier=tier, pinned=pinned)

    def read_all(self, path: "str | AlluxioURI") -> bytes:
        with self.open_file(path) as f:
            return f.read()

    def write_all(self, path: "str | AlluxioURI", data: bytes,
                  **opts) -> None:
        with self.create_file(path, **opts) as f:
            f.write(data)

    # -------------------------------------------------- live reconfiguration
    def check_config_sync(self) -> bool:
        """Config-hash handshake: pull cluster defaults when the master's
        hash moves (reference: ``ConfigHashSync.java:36``). Returns True if
        config was re-synced."""
        h = self.meta_master.get_config_hash()
        if self._config_hash is None:
            self._config_hash = h
            return False
        if h != self._config_hash:
            from alluxio_tpu_torch.conf import Source

            resp = self.meta_master.get_configuration()
            self._conf.merge(resp["properties"], Source.CLUSTER_DEFAULT)
            self._config_hash = resp["hash"]
            try:
                self._refresh_path_conf()
            except Exception:  # noqa: BLE001 - older master without the RPC
                pass
            return True
        return False

    # -------------------------------------------------------------- cleanup
    def close(self) -> None:
        if self._metrics_thread is not None:
            self._metrics_thread.stop()
            self._metrics_thread = None
        self.store.close()
        if self._page_cache is not None:
            self._page_cache.close()


class _ClientMetricsSync:
    """Heartbeat executor shipping client metrics (reference:
    ``client/metrics/ClientMasterSync.java``)."""

    def __init__(self, fs: FileSystem) -> None:
        self._fs = fs

    def heartbeat(self) -> None:
        try:
            self._fs.send_metrics()
        except Exception:  # noqa: BLE001 master transition: retry next tick
            pass

    def close(self) -> None:
        pass
