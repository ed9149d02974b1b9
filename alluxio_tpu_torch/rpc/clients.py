"""Typed, retrying RPC clients: a copy of ``alluxio_tpu/rpc/clients.py``
(the master clients, with their multi-master failover and the master
fast path, and the worker's).

Re-design of ``client/file/RetryHandlingFileSystemMasterClient.java``,
``client/block/RetryHandlingBlockMasterClient.java`` and
``AbstractMasterClient``: every call runs under an exponential time-bounded
retry on transient errors; surfaces mirror the in-process adapters so the
rest of the stack cannot tell transport from direct calls.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import alluxio_tpu_torch.shm  # noqa: F401 - registers the typed SHM errors
from alluxio_tpu_torch.rpc.core import RpcChannel
from alluxio_tpu_torch.rpc.master_service import (
    BLOCK_SERVICE, FS_SERVICE, META_SERVICE,
)
from alluxio_tpu_torch.rpc.worker_service import WORKER_SERVICE
from alluxio_tpu_torch.utils.retry import ExponentialTimeBoundedRetry, retry
from alluxio_tpu_torch.utils.wire import (
    BlockInfo, FileBlockInfo, FileInfo, MountPointInfo, WorkerInfo,
    WorkerNetAddress,
)

#: (registry, counters) cache — the failover counters sit on every RPC
#: attempt, so resolve them once per registry generation, not per call
#: (tests swap the registry via reset_metrics, hence the identity key)
_failover_metrics_cache: Tuple[object, object] = (None, None)


def _failover_metrics():
    global _failover_metrics_cache
    from alluxio_tpu_torch.metrics import metrics

    reg = metrics()
    cached_reg, counters = _failover_metrics_cache
    if cached_reg is not reg:
        counters = (reg.counter("Client.FailoverRedirects"),
                    reg.counter("Client.FailoverRotations"),
                    reg.counter("Client.StandbyReads"))
        _failover_metrics_cache = (reg, counters)
    return counters


def resolve_retry_duration_s(value: Optional[float] = None,
                             conf=None) -> float:
    """The client RPC retry budget: an explicit value wins, else the
    ``atpu.user.rpc.retry.duration`` conf key, else the historical
    30s constant.  One resolver for every typed client (fs/block/meta,
    job, table) so overload drills shorten give-up time everywhere by
    setting one key."""
    if value is not None:
        return float(value)
    if conf is not None:
        from alluxio_tpu_torch.conf import Keys

        return float(conf.get_duration_s(Keys.USER_RPC_RETRY_MAX_DURATION))
    return 30.0


class _BaseClient:
    """Multi-endpoint master client (reference: ``MasterInquireClient`` +
    ``AbstractMasterClient`` re-resolving the leader across the
    configured masters).  ``address`` may be a comma-separated list for
    HA deployments; the client then

    - follows **leader hints**: a standby's typed ``NotPrimaryError``
      names the current primary, and the client jumps straight to it
      without consuming a retry attempt (``retry.note_redirect``);
    - **rotates** with full-jitter backoff on connection loss /
      hint-less unavailability, so a dead primary's clients fan out
      over the survivors instead of stampeding one;
    - optionally routes **reads to standbys**
      (``atpu.user.standby.reads.enabled``): read-marked RPCs
      round-robin across the non-active members (endpoints that
      recently failed sit out a short cooldown), keeping GetStatus/
      ListStatus load off the primary (docs/ha.md)."""

    service = ""

    #: seconds a failed endpoint sits out of standby-read rotation
    _DOWN_COOLDOWN_S = 3.0

    def __init__(self, address: str, *,
                 retry_duration_s: Optional[float] = None,
                 base_sleep_s: float = 0.05, max_sleep_s: float = 3.0,
                 metadata=None, fastpath: bool = True,
                 fastpath_dir: Optional[str] = None, conf=None,
                 standby_reads: bool = False) -> None:
        """``fastpath_dir``: where master fastpath sockets live; pass the
        ``atpu.master.fastpath.dir`` property when a Configuration is at
        hand (FileSystem does) — otherwise the env override or /tmp.
        ``retry_duration_s`` defaults from ``conf``'s
        ``atpu.user.rpc.retry.duration`` (30s)."""
        import os as _os

        self._use_fast = fastpath and \
            not _os.environ.get("ATPU_FASTPATH_DISABLE")
        self._fast_dir = fastpath_dir or \
            _os.environ.get("ATPU_MASTER_FASTPATH_DIR", "/tmp")
        self._channels = []
        self._addresses: List[str] = []
        for a in str(address).split(","):
            if not a.strip():
                continue
            self._channels.append(self._make_channel(a.strip(), metadata))
            self._addresses.append(a.strip())
        self._active = 0
        self._standby_reads = bool(standby_reads)
        self._read_rr = 0
        self._down_until: Dict[int, float] = {}
        self._endpoints_lock = threading.Lock()
        self._metadata = metadata
        self._retry_duration_s = resolve_retry_duration_s(
            retry_duration_s, conf)
        self._base_sleep_s = base_sleep_s
        self._max_sleep_s = max_sleep_s

    def _make_channel(self, address: str, metadata):
        from alluxio_tpu_torch.rpc.fastpath import HybridChannel

        ch = RpcChannel(address, metadata=metadata)
        if self._use_fast:
            # probes <dir>/atpu-master-<port>.sock; silently stays
            # pure-gRPC when the master is remote or fastpath is off
            ch = HybridChannel(ch, fastpath_dir=self._fast_dir)
        return ch

    @property
    def _channel(self) -> RpcChannel:
        return self._channels[self._active]

    @property
    def transport(self) -> str:
        """``"fastpath"`` while calls to the current master ride its
        same-host socket, else ``"grpc"``."""
        return getattr(self._channel, "transport", "grpc")

    def close(self) -> None:
        """Close the calling thread's fast-path connections; the gRPC
        channels are pooled per address and stay open for the process's
        other clients."""
        for ch in self._channels:
            close = getattr(ch, "close", None)
            if close is not None:
                close()

    def _rotate(self) -> None:
        self._active = (self._active + 1) % len(self._channels)

    def _follow_leader(self, leader: str) -> None:
        """Point the active (write) endpoint at the hinted primary,
        minting a channel when the hint names a master outside the
        configured list (e.g. a replacement member)."""
        leader = leader.strip()
        with self._endpoints_lock:
            try:
                self._active = self._addresses.index(leader)
            except ValueError:
                self._channels.append(
                    self._make_channel(leader, self._metadata))
                self._addresses.append(leader)
                self._active = len(self._channels) - 1

    def _mark_down(self, idx: int) -> None:
        self._down_until[idx] = time.monotonic() + self._DOWN_COOLDOWN_S

    def _handle_not_primary(self, leader, idx: int) -> None:
        """Shared redirect/rotate bookkeeping for every not-primary
        path (unary handler, strong-read conversion, stream
        establishment — keep them identical): a hinted failure follows
        the leader (the retry policy's free redirect); a hint-less one
        rotates off the endpoint, so a standby that cannot name a
        leader (mid-election, partitioned) is not re-picked for the
        whole retry budget."""
        redirects, rotations, _ = _failover_metrics()
        if leader:
            self._follow_leader(leader)
            redirects.inc()
        elif len(self._channels) > 1:
            if idx == self._active:
                self._rotate()
            rotations.inc()

    def _pick(self, read: bool) -> int:
        """Endpoint for this attempt: writes (and single-endpoint
        clients) go to the believed leader; standby-routed reads
        round-robin the OTHER members, falling back to the leader when
        every standby is cooling down."""
        if not (read and self._standby_reads and len(self._channels) > 1):
            return self._active
        now = time.monotonic()
        n = len(self._channels)
        for _ in range(n):
            self._read_rr = (self._read_rr + 1) % n
            i = self._read_rr
            if i == self._active:
                continue
            if self._down_until.get(i, 0.0) <= now:
                return i
        return self._active

    def _call(self, method: str, request: dict, timeout: float = 30.0, *,
              read: bool = False):
        from alluxio_tpu_torch.utils.exceptions import (
            AlluxioTpuError, NotPrimaryError, UnavailableError,
        )

        def attempt():
            idx = self._pick(read)
            try:
                out = self._channels[idx].call(
                    self.service, method, request, timeout=timeout)
                if read and isinstance(out, dict) and \
                        out.pop("standby", False):
                    hint = out.pop("leader", None)
                    if not self._standby_reads and \
                            len(self._channels) > 1:
                        # a standby served a read this client expected
                        # read-your-writes from — convert the mark back
                        # into a redirect (single-endpoint clients
                        # pointed AT a standby asked for what they got)
                        raise NotPrimaryError(
                            "read served by a standby", leader=hint)
            except NotPrimaryError as e:
                self._handle_not_primary(e.leader, idx)
                raise
            except UnavailableError:
                self._mark_down(idx)
                if idx == self._active and len(self._channels) > 1:
                    self._rotate()
                    _failover_metrics()[1].inc()
                raise
            except AlluxioTpuError as e:
                if read and e.standby and not self._standby_reads and \
                        len(self._channels) > 1:
                    # a standby answered a strong read with an ERROR off
                    # its bounded-stale state (e.g. NOT_FOUND for a path
                    # the primary just acked): as untrustworthy as a
                    # stale result — retry on the primary
                    self._handle_not_primary(e.leader, idx)
                    raise NotPrimaryError(
                        "standby answered a strong read",
                        leader=e.leader) from e
                raise
            if read and idx != self._active:
                _failover_metrics()[2].inc()
            return out

        return retry(
            attempt,
            ExponentialTimeBoundedRetry(self._retry_duration_s,
                                        self._base_sleep_s,
                                        self._max_sleep_s))


class FsMasterClient(_BaseClient):
    service = FS_SERVICE

    def get_status(self, path: str, sync_interval_ms: int = -1, *,
                   want_version: bool = False):
        """``want_version=True`` -> ``(FileInfo, stamp)`` where stamp is
        the master's metadata-invalidation version taken BEFORE the
        lookup (None against a server predating the stamp protocol) —
        what the client metadata cache stores (docs/metadata.md)."""
        resp = self._call(
            "get_status", {"path": str(path),
                           "sync_interval_ms": sync_interval_ms},
            read=True)
        stamp = resp.pop("md_version", None)
        info = FileInfo.from_wire(resp)
        return (info, stamp) if want_version else info

    def exists(self, path: str) -> bool:
        return self._call("exists", {"path": str(path)},
                          read=True)["exists"]

    @staticmethod
    def _decode_columnar(cols: dict) -> List[FileInfo]:
        """Struct-of-arrays listing wire format -> FileInfo rows (the
        one decoder for both the unary and streamed paths)."""
        if not cols:
            return []
        keys = tuple(cols)
        return [FileInfo.from_wire(dict(zip(keys, row)))
                for row in zip(*(cols[k] for k in keys))]

    def list_status(self, path: str, recursive: bool = False,
                    sync_interval_ms: int = -1, *,
                    want_version: bool = False):
        """``want_version=True`` -> ``(infos, stamp)`` — see
        :meth:`get_status`."""
        resp = self._call("list_status", {
            "path": str(path), "recursive": recursive,
            "sync_interval_ms": sync_interval_ms, "columnar": True},
            read=True)
        stamp = resp.get("md_version")
        col = resp.get("columnar")
        if col is None:  # server predates the columnar listing format
            infos = [FileInfo.from_wire(d) for d in resp["infos"]]
        else:
            infos = self._decode_columnar(col["cols"])
        return (infos, stamp) if want_version else infos

    def iter_status(self, path: str, recursive: bool = False,
                    sync_interval_ms: int = -1,
                    batch_size: int = 500):
        """Streamed listing (reference: partial-response ListStatus):
        yields FileInfo in server-side batches — constant client
        memory per batch however large the directory.

        Stream ESTABLISHMENT (up to the first chunk) rides the same
        retry + HA-rotation machinery as the unary calls; a failure
        mid-stream propagates — entries already yielded cannot be
        transparently replayed without a resume cursor."""
        from alluxio_tpu_torch.utils.exceptions import UnavailableError

        request = {"path": str(path), "recursive": recursive,
                   "sync_interval_ms": sync_interval_ms,
                   "batch_size": batch_size, "columnar": True}

        def attempt():
            from alluxio_tpu_torch.utils.exceptions import NotPrimaryError

            idx = self._pick(read=True)
            it = self._channels[idx].call_stream(
                self.service, "list_status_stream", request)
            try:
                first = next(it)
            except StopIteration:
                return None, it
            except NotPrimaryError as e:
                # must precede the UnavailableError arm (its subclass):
                # a deposed leader's fence or a not-yet-caught-up
                # standby names the leader — follow the hint instead of
                # cooling down a healthy member and blind-rotating
                self._handle_not_primary(e.leader, idx)
                raise
            except UnavailableError:
                self._mark_down(idx)
                if idx == self._active and len(self._channels) > 1:
                    self._rotate()
                raise
            if isinstance(first, dict) and first.get("standby") and \
                    not self._standby_reads and len(self._channels) > 1:
                # same strong-read contract as the unary path: a
                # standby-served stream redirects instead of feeding a
                # stale listing to a read-your-writes client
                hint = first.get("leader")
                self._handle_not_primary(hint, idx)
                raise NotPrimaryError("read served by a standby",
                                      leader=hint)
            return first, it

        first, it = retry(
            attempt,
            ExponentialTimeBoundedRetry(self._retry_duration_s,
                                        self._base_sleep_s,
                                        self._max_sleep_s))
        from itertools import chain

        chunks = it if first is None else chain([first], it)
        for chunk in chunks:
            cols = chunk.get("cols")
            if cols is not None:  # columnar batch (struct-of-arrays)
                yield from self._decode_columnar(cols)
            else:  # row-dict batch (pre-columnar server)
                for d in chunk.get("infos", []):
                    yield FileInfo.from_wire(d)

    def create_file(self, path: str, **opts) -> FileInfo:
        return FileInfo.from_wire(self._call(
            "create_file", {"path": str(path), **opts}))

    def create_directory(self, path: str, **opts) -> FileInfo:
        return FileInfo.from_wire(self._call(
            "create_directory", {"path": str(path), **opts}))

    def get_new_block_id(self, path: str) -> int:
        return self._call("get_new_block_id", {"path": str(path)})["block_id"]

    def complete_file(self, path: str, length: Optional[int] = None,
                      ufs_fingerprint: str = "") -> None:
        self._call("complete_file", {"path": str(path), "length": length,
                                     "ufs_fingerprint": ufs_fingerprint})

    def delete(self, path: str, recursive: bool = False,
               alluxio_only: bool = False) -> None:
        self._call("delete", {"path": str(path), "recursive": recursive,
                              "alluxio_only": alluxio_only})

    def rename(self, src: str, dst: str) -> None:
        self._call("rename", {"src": str(src), "dst": str(dst)})

    def free(self, path: str, recursive: bool = False,
             forced: bool = False) -> List[int]:
        return self._call("free", {"path": str(path), "recursive": recursive,
                                   "forced": forced})["freed_blocks"]

    def mount(self, path: str, ufs_uri: str, *, read_only: bool = False,
              shared: bool = False,
              properties: Optional[Dict[str, str]] = None) -> None:
        self._call("mount", {"path": str(path), "ufs_uri": ufs_uri,
                             "read_only": read_only, "shared": shared,
                             "properties": properties})

    def unmount(self, path: str) -> None:
        self._call("unmount", {"path": str(path)})

    def get_mount_points(self) -> List[MountPointInfo]:
        resp = self._call("get_mount_points", {})
        return [MountPointInfo.from_wire(d) for d in resp["mounts"]]

    def set_attribute(self, path: str, **opts) -> None:
        self._call("set_attribute", {"path": str(path), **opts})

    def get_file_block_info_list(self, path: str) -> List[FileBlockInfo]:
        resp = self._call("get_file_block_info_list", {"path": str(path)})
        return [FileBlockInfo.from_wire(d) for d in resp["infos"]]

    def schedule_async_persistence(self, path: str) -> None:
        self._call("schedule_async_persistence", {"path": str(path)})

    def get_pinned_file_ids(self) -> List[int]:
        return self._call("get_pinned_file_ids", {})["ids"]

    def sync_metadata(self, path: str) -> bool:
        return self._call("sync_metadata", {"path": str(path)})["changed"]

    def set_acl(self, path: str, entries: List[str], *,
                default: bool = False, recursive: bool = False) -> None:
        self._call("set_acl", {"path": str(path), "entries": entries,
                               "default": default, "recursive": recursive})

    def get_acl(self, path: str) -> dict:
        return self._call("get_acl", {"path": str(path)})

    def start_sync(self, path: str) -> None:
        self._call("start_sync", {"path": str(path)})

    def stop_sync(self, path: str) -> None:
        self._call("stop_sync", {"path": str(path)})

    def get_sync_path_list(self) -> List[str]:
        return self._call("get_sync_path_list", {})["paths"]

    def mark_persisted(self, path: str, ufs_fingerprint: str = "") -> None:
        self._call("mark_persisted", {"path": str(path),
                                      "ufs_fingerprint": ufs_fingerprint})

    def commit_persist(self, path: str, temp_ufs_path: str,
                       expected_id: int = 0) -> str:
        return self._call("commit_persist", {
            "path": str(path), "temp_ufs_path": temp_ufs_path,
            "expected_id": expected_id})["fingerprint"]

    def file_system_heartbeat(self, worker_id: int,
                              persisted_files: List[int]) -> None:
        self._call("file_system_heartbeat", {
            "worker_id": worker_id, "persisted_files": persisted_files})


class BlockMasterClient(_BaseClient):
    """Surface-compatible with ``InProcessBlockMasterClient``."""

    service = BLOCK_SERVICE

    def get_worker_id(self, address: WorkerNetAddress) -> int:
        return self._call("get_worker_id",
                          {"address": address.to_wire()})["worker_id"]

    def register(self, worker_id: int, capacity: Dict[str, int],
                 used: Dict[str, int], blocks: Dict[str, List[int]],
                 address: Optional[WorkerNetAddress] = None) -> None:
        self._call("register", {
            "worker_id": worker_id, "capacity": capacity, "used": used,
            "blocks": blocks,
            "address": address.to_wire() if address else None})

    def heartbeat(self, worker_id: int, used: Dict[str, int],
                  added: Dict[str, List[int]], removed: List[int],
                  metrics_snapshot: Optional[Dict[str, float]] = None) -> dict:
        return self._call("heartbeat", {
            "worker_id": worker_id, "used": used, "added": added,
            "removed": removed, "metrics": metrics_snapshot})

    def commit_block(self, worker_id: int, used_on_tier: int, tier: str,
                     block_id: int, length: int) -> None:
        self._call("commit_block", {
            "worker_id": worker_id, "used_on_tier": used_on_tier,
            "tier": tier, "block_id": block_id, "length": length})

    def get_block_info(self, block_id: int) -> BlockInfo:
        return BlockInfo.from_wire(self._call("get_block_info",
                                              {"block_id": block_id}))

    def report_device_blocks(self, host: str,
                             mesh_blocks: "Dict[int, List[int]]") -> None:
        """Report this client's HBM warm set (mesh pos -> block ids);
        replaces the previous report from the same host."""
        self._call("report_device_blocks", {
            "host": host,
            "mesh_blocks": {str(k): [int(b) for b in v]
                            for k, v in mesh_blocks.items()}})

    def clear_device_blocks(self, host: str) -> None:
        self.report_device_blocks(host, {})

    def device_block_map(self) -> "Dict[int, Dict[int, str]]":
        resp = self._call("device_block_map", {})
        return {int(bid): {int(p): h for p, h in m.items()}
                for bid, m in resp["map"].items()}

    def get_block_infos(self, block_ids: List[int]) -> List[BlockInfo]:
        resp = self._call("get_block_infos", {"block_ids": block_ids})
        return [BlockInfo.from_wire(d) for d in resp["infos"]]

    def get_worker_infos(self, include_lost: bool = False,
                         include_quarantined: bool = False
                         ) -> List[WorkerInfo]:
        """Default view excludes quarantined workers — it is the
        placement listing; admin/report callers opt them back in."""
        resp = self._call("get_worker_infos",
                          {"include_lost": include_lost,
                           "include_quarantined": include_quarantined})
        return [WorkerInfo.from_wire(d) for d in resp["infos"]]

    def get_capacity(self) -> Dict[str, Dict[str, int]]:
        """Returns ``{"capacity": {tier: bytes}, "used": {tier: bytes}}``."""
        return self._call("get_capacity", {})


class MetaMasterClient(_BaseClient):
    service = META_SERVICE

    def get_configuration(self, *, sources: bool = False) -> dict:
        return self._call("get_configuration", {"sources": sources})

    def get_config_hash(self) -> str:
        return self._call("get_config_hash", {})["hash"]

    def get_master_info(self) -> dict:
        return self._call("get_master_info", {})

    def get_metastore_info(self) -> dict:
        """Metastore backend shape for ``fsadmin report metastore``:
        {"stats": {kind, inodes, and on LSM memtable/run/compaction
        counters + cache hit ratio}}."""
        return self._call("get_metastore_info", {})

    def get_metrics(self) -> Dict[str, float]:
        return self._call("get_metrics", {})["metrics"]

    def set_log_level(self, level: str, logger: str = "") -> dict:
        return self._call("set_log_level", {"logger": logger,
                                            "level": level})

    def get_log_level(self, logger: str = "") -> dict:
        return self._call("get_log_level", {"logger": logger})

    def set_trace_enabled(self, enabled: bool, *,
                          clear: bool = False) -> dict:
        return self._call("set_trace_enabled",
                          {"enabled": enabled, "clear": clear})

    def get_trace(self, *, limit: int = 500, prefix: str = "",
                  trace_id: str = "") -> dict:
        return self._call("get_trace", {"limit": limit, "prefix": prefix,
                                        "trace_id": trace_id})

    def get_trace_profile(self, *, trace_id: str = "", prefix: str = "",
                          root_prefix: str = "", limit: int = 4000,
                          max_traces: int = 256) -> dict:
        """Critical-path analysis over the master's stitched traces:
        with ``trace_id`` the blocking chain of that one trace, without
        it the aggregate per-phase read-path profile."""
        return self._call("get_trace_profile", {
            "trace_id": trace_id, "prefix": prefix,
            "root_prefix": root_prefix, "limit": limit,
            "max_traces": max_traces})

    def get_quorum_info(self) -> dict:
        return self._call("get_quorum_info", {})

    def get_masters(self) -> dict:
        """Quorum view for ``fsadmin report masters``: per-master role,
        term, last-applied sequence, tailer lag and last contact
        (docs/ha.md).  Read-marked: standbys answer it too, so the view
        survives a dead primary."""
        return self._call("get_masters", {}, read=True)

    def transfer_quorum_leadership(self, target: str) -> dict:
        return self._call("transfer_quorum_leadership",
                          {"target": target})

    def set_path_conf(self, path: str, properties: Dict[str, str]) -> None:
        self._call("set_path_conf", {"path": str(path),
                                     "properties": properties})

    def remove_path_conf(self, path: str,
                         keys: Optional[List[str]] = None) -> None:
        self._call("remove_path_conf", {"path": str(path), "keys": keys})

    def get_path_conf(self) -> dict:
        """{"properties": {path: {k: v}}, "hash": str}"""
        return self._call("get_path_conf", {})

    def register_node_conf(self, node_id: str,
                           config: Dict[str, str]) -> None:
        self._call("register_node_conf", {"node_id": node_id,
                                          "config": config})

    def metrics_heartbeat(self, source: str,
                          metrics: Dict[str, float],
                          spans: Optional[List[dict]] = None,
                          md_cache_version: Optional[int] = None,
                          want_md_invalidations: bool = False,
                          profile: Optional[dict] = None) -> dict:
        """Ship a node's metric snapshot — and any completed trace spans
        drained from its ring — for cluster aggregation / trace
        stitching (reference: ``metric_master.proto`` ClientMasterSync).
        The response may carry a remediation config overlay
        (``conf_overlay`` + ``conf_overlay_version``) the client is
        expected to apply — see docs/self_healing.md — and, when
        ``want_md_invalidations`` is set, the metadata-cache
        invalidation batch since ``md_cache_version``
        (``md_invalidations`` — docs/metadata.md)."""
        req = {"source": source, "metrics": metrics, "spans": spans or []}
        if profile is not None:
            # merged flame data from the node's stack sampler
            # (utils/profiler.py) rides the same heartbeat
            req["profile"] = profile
        if want_md_invalidations:
            req["want_md_invalidations"] = True
            req["md_cache_version"] = md_cache_version
        return self._call("metrics_heartbeat", req)

    def get_metrics_history(self, name: str = "", *, source: str = "",
                            resolution: str = "raw", since: float = 0.0,
                            rate: bool = False, limit: int = 0,
                            prefix: str = "") -> dict:
        """Time-resolved metric series from the master's history store.
        No ``name`` -> ``{"names": [...], "stats": {...}}``; with one ->
        ``{"series": [{source, name, resolution, points, ended_at}],
        "stats": {...}}``."""
        return self._call("get_metrics_history", {
            "name": name, "source": source, "resolution": resolution,
            "since": since, "rate": rate, "limit": limit,
            "prefix": prefix})

    def get_health(self, *, evaluate: bool = True) -> dict:
        """Ranked alerts from the master's health-rule engine
        (cluster doctor)."""
        return self._call("get_health", {"evaluate": evaluate})

    def get_qos(self) -> dict:
        """Admission-control state + per-principal shed/admit rows +
        cluster Qos metrics (`fsadmin report qos`)."""
        return self._call("get_qos", {})

    def get_config_report(self) -> dict:
        return self._call("get_config_report", {})

    def checkpoint(self) -> None:
        self._call("checkpoint", {}, timeout=300.0)

    def backup(self, directory: Optional[str] = None) -> dict:
        return self._call("backup", {"directory": directory}, timeout=600.0)


class WorkerClient(_BaseClient):
    """Data-plane client for one worker (reference: block streams +
    short-circuit RPCs in ``client/block/stream``).

    Beyond the default channel, the client can mint **pooled channels**
    — distinct TCP connections to the same worker — so the striped
    remote-read path fans stripes of one block out over several
    connections instead of serializing them behind one HTTP/2 flow-
    control window (reference: GrpcConnectionPool's per-NetworkGroup
    channel multiplicity)."""

    service = WORKER_SERVICE

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self._pooled: Dict[int, "RpcChannel"] = {}
        self._pooled_lock = threading.Lock()

    def pooled_channel(self, index: int) -> RpcChannel:
        """Channel for pool slot ``index`` (0 = the default channel).
        Channels are created lazily and cached for the client's life;
        the process-wide gRPC channel pool dedupes across clients."""
        if index == 0:
            return self._channel
        with self._pooled_lock:
            ch = self._pooled.get(index)
            if ch is None:
                ch = RpcChannel(self._channels[0].address,
                                metadata=self._metadata, pool_index=index)
                self._pooled[index] = ch
            return ch

    def read_block(self, block_id: int, *, offset: int = 0, length: int = -1,
                   chunk_size: int = 1 << 20,
                   ufs: Optional[dict] = None,
                   cache: bool = True) -> Iterator[dict]:
        return self._channel.call_stream(self.service, "read_block", {
            "block_id": block_id, "offset": offset, "length": length,
            "chunk_size": chunk_size, "ufs": ufs, "cache": cache})

    def read_block_stream(self, block_id: int, *, offset: int = 0,
                          length: int = -1, chunk_size: int = 1 << 20,
                          ufs: Optional[dict] = None, cache: bool = True,
                          channel: int = 0):
        """Cancellable ``read_block`` range stream over pool slot
        ``channel`` — the striped read path's transport (it must abort
        hedge losers mid-transfer, which plain ``read_block`` cannot)."""
        return self.pooled_channel(channel).open_stream(
            self.service, "read_block", {
                "block_id": block_id, "offset": offset, "length": length,
                "chunk_size": chunk_size, "ufs": ufs, "cache": cache})

    def read_block_bytes(self, block_id: int, **kwargs) -> bytes:
        return b"".join(msg["data"] for msg in
                        self.read_block(block_id, **kwargs))

    def read_many(self, block_id: int, offsets, sizes) -> dict:
        """Scatter/gather batch read: N small reads of one block in ONE
        RPC — ``{data: <concatenated bytes>, lengths: [..], source}``.
        The caller slices per-op views out of ``data`` (the response
        lands in one buffer; no per-op payloads to reassemble)."""
        return self._call("read_many", {
            "block_id": block_id, "offsets": list(offsets),
            "sizes": list(sizes)})

    def shm_open(self, session_id: int, block_id: int) -> dict:
        """Lease the block's same-host SHM segment:
        ``{lease_id, path, length, ttl_s}``. Raises typed
        ShmLeaseDeniedError / ShmSegmentUnavailableError — the caller's
        cue to fall back to the remote path (shm/)."""
        return self._call("shm_open", {"session_id": session_id,
                                       "block_id": block_id})

    def shm_renew(self, session_id: int, lease_id: int) -> dict:
        return self._call("shm_renew", {"session_id": session_id,
                                        "lease_id": lease_id})

    def shm_release(self, session_id: int, lease_id: int) -> None:
        # advisory like close_local_block: the worker's TTL reclaims it
        # anyway — short deadline, no retry against a dead worker
        self._channel.call(self.service, "shm_release",
                           {"session_id": session_id,
                            "lease_id": lease_id}, timeout=2.0)

    def write_block(self, block_id: int, session_id: int, data: bytes, *,
                    tier: str = "", chunk_size: int = 1 << 20,
                    pinned: bool = False) -> int:
        def gen():
            yield {"block_id": block_id, "session_id": session_id,
                   "tier": tier, "size_hint": len(data), "pinned": pinned}
            for i in range(0, len(data), chunk_size):
                yield {"data": data[i:i + chunk_size]}

        resp = self._channel.call_stream_in(self.service, "write_block", gen())
        return resp["length"]

    def open_local_block(self, session_id: int, block_id: int) -> dict:
        return self._call("open_local_block", {"session_id": session_id,
                                               "block_id": block_id})

    def close_local_block(self, session_id: int, block_id: int) -> None:
        # advisory lease release: the worker's session cleanup expires it
        # anyway, so NO retry and a short deadline — a GC-time close of a
        # leaked stream against a dead cluster must not block for the
        # full retry window (observed: 30s stalls on the caller's thread)
        self._channel.call(self.service, "close_local_block",
                           {"session_id": session_id,
                            "block_id": block_id}, timeout=2.0)

    def create_local_block(self, session_id: int, block_id: int, *,
                           size_hint: int, tier: str = "") -> str:
        return self._call("create_local_block", {
            "session_id": session_id, "block_id": block_id,
            "size_hint": size_hint, "tier": tier})["path"]

    def complete_local_block(self, session_id: int, block_id: int, *,
                             cancel: bool = False,
                             pinned: bool = False) -> None:
        self._call("complete_local_block", {
            "session_id": session_id, "block_id": block_id,
            "cancel": cancel, "pinned": pinned})

    def async_cache(self, block_id: int, ufs_path: str, offset: int,
                    length: int, mount_id: int = 0,
                    qos_class: str = "") -> bool:
        """``qos_class``: "ASYNC_FILL" (default) or "PREFETCH" — with
        worker QoS on, speculative loads drain after client-issued
        fills and on-demand reads."""
        return self._call("async_cache", {
            "block_id": block_id, "ufs_path": ufs_path, "offset": offset,
            "length": length, "mount_id": mount_id,
            "qos_class": qos_class})["accepted"]

    def prefetch_pin(self, block_id: int, ttl_s: float = 600.0) -> bool:
        """Eviction shield for a clairvoyantly-placed block (held until
        ``prefetch_unpin`` or TTL expiry — the worker reclaims pins of
        clients that died without unpinning; no lease to keep alive)."""
        return self._call("prefetch_pin", {"block_id": block_id,
                                           "ttl_s": ttl_s})["pinned"]

    def prefetch_unpin(self, block_id: int) -> None:
        self._call("prefetch_unpin", {"block_id": block_id})

    def remove_block(self, block_id: int) -> None:
        self._call("remove_block", {"block_id": block_id})

    def move_block(self, block_id: int, tier: str) -> None:
        self._call("move_block", {"block_id": block_id, "tier": tier})

    def cleanup_session(self, session_id: int) -> None:
        self._call("cleanup_session", {"session_id": session_id})

    def persist_file(self, ufs_path: str, block_ids: List[int],
                     mount_id: int = 0) -> str:
        return self._call("persist_file", {
            "ufs_path": ufs_path, "block_ids": block_ids,
            "mount_id": mount_id}, timeout=300.0)["fingerprint"]
