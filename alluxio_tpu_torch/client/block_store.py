"""Client-side block store: source selection + stream construction (the
port of ``alluxio_tpu/client/block_store.py``).

Re-design of ``core/client/fs/src/main/java/alluxio/client/block/
AlluxioBlockStore.java:63`` + the ladder in ``stream/BlockInStream.java:80-124``,
including the **passive cache trigger** (``AlluxioFileInStream.java:137``
triggerAsyncCaching): when a read was served remotely or from UFS, ask the
nearest local worker to cache the block in the background.

The read ladder of :meth:`BlockStoreClient.open_block`, closest first —
each rung falls to the next on failure, so the ladder can only make a
read faster, never fail it:

1. ``shm``: a same-host worker's MEM-tier segment, leased and mapped
   once, then served from the segment cache (``client/shm_transport.py``);
2. ``lease``: the short-circuit path lease (``LocalBlockInStream``);
3. ``remote``: a cached copy on a worker over gRPC, striped across the
   replica set or pooled channels (``client/remote_read.py``);
4. ``ufs``: a policy-chosen worker reads the block through from the UFS.

Each stream the ladder returns carries the rung that opened it
(``BlockInStream.rung``).
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Dict, List, Optional, Set

from alluxio_tpu_torch.client.block_streams import (
    BatchReadConf, BlockInStream, BlockOutStream, GrpcBlockInStream,
    GrpcBlockOutStream, LocalBlockInStream, LocalBlockOutStream,
    is_local_worker,
)
from alluxio_tpu_torch.client.policy import BlockLocationPolicy
from alluxio_tpu_torch.client.remote_read import (RemoteReadConf,
                                                  RemoteReadRuntime)
from alluxio_tpu_torch.client.shm_transport import ShmTransport
from alluxio_tpu_torch.metrics import metrics
from alluxio_tpu_torch.rpc.clients import WorkerClient
from alluxio_tpu_torch.utils import ids as id_utils
from alluxio_tpu_torch.utils.exceptions import UnavailableError
from alluxio_tpu_torch.utils.retry import ExponentialTimeBoundedRetry
from alluxio_tpu_torch.utils.wire import (
    BlockInfo, FileBlockInfo, TieredIdentity, WorkerInfo, WorkerNetAddress,
)


class BlockStoreClient:
    """``block_master``: a block-master client, duck-typed — the JAX
    package's ``BlockMasterClient`` or any object with its
    ``get_worker_infos`` (the port has no master client yet)."""

    def __init__(self, block_master, *,
                 identity: Optional[TieredIdentity] = None,
                 read_policy: Optional[BlockLocationPolicy] = None,
                 write_policy: Optional[BlockLocationPolicy] = None,
                 ufs_read_policy: Optional[BlockLocationPolicy] = None,
                 short_circuit: bool = True,
                 passive_cache: bool = True,
                 write_unavailable_window_s: float = 15.0,
                 streaming_chunk_size: int = 1 << 20,
                 streaming_writer_chunk_size: int = 1 << 20,
                 remote_read: Optional[RemoteReadConf] = None,
                 shm_enabled: bool = True,
                 shm_cache_max: int = 64,
                 shm_renew_fraction: float = 0.5,
                 batch_read: Optional[BatchReadConf] = None,
                 native_fastpath: bool = True) -> None:
        """``streaming_chunk_size`` / ``streaming_writer_chunk_size``:
        per-message chunk of the gRPC read and write streams;
        ``remote_read``: striped-read tuning — the default conf stripes
        large remote reads, ``RemoteReadConf(stripe_size=0)`` pins the
        single-stream path; ``shm_enabled`` / ``shm_cache_max`` /
        ``shm_renew_fraction`` (``atpu.user.shm.*``): the same-host SHM
        plane — disabled, the ladder starts at the short-circuit lease,
        byte for byte; ``batch_read`` (``atpu.user.batch.read.*``):
        ``read_many`` coalescing for ``pread_many`` on remote streams;
        ``native_fastpath`` (``atpu.user.native.fastpath.enabled``): the
        SHM plane's batched reads through the native plan executor (the
        batch and striped flags ride their confs)."""
        self._bm = block_master
        self._identity = identity or TieredIdentity.from_spec(
            None, hostname=socket.gethostname())
        self._read_policy = read_policy or BlockLocationPolicy.create(
            "LOCAL_FIRST", identity=self._identity)
        self._write_policy = write_policy or BlockLocationPolicy.create(
            "LOCAL_FIRST", identity=self._identity)
        self._ufs_read_policy = ufs_read_policy or BlockLocationPolicy.create(
            "DETERMINISTIC_HASH", shards=1)
        self._short_circuit = short_circuit
        self._passive_cache = passive_cache
        self._write_unavailable_window_s = write_unavailable_window_s
        self._chunk_size = max(1, streaming_chunk_size)
        self._writer_chunk_size = max(1, streaming_writer_chunk_size)
        #: the parallel remote-read runtime every GrpcBlockInStream of
        #: this store shares: stripe executor + per-worker latency EWMAs
        #: (hedging learns across reads, so it lives here, not per-stream)
        self.remote_read = RemoteReadRuntime(remote_read)
        self.session_id = id_utils.create_session_id()
        #: same-host zero-copy plane (``atpu.user.shm.enabled``); None
        #: starts the ladder at the short-circuit lease
        self.shm: Optional[ShmTransport] = ShmTransport(
            self.session_id, cache_max=shm_cache_max,
            renew_fraction=shm_renew_fraction,
            host=socket.gethostname(),
            native_fastpath=native_fastpath) if shm_enabled else None
        #: scatter/gather coalescing conf shared by every remote stream
        self.batch_read = batch_read if batch_read is not None \
            else BatchReadConf()
        #: worker that served the most recent write
        self.last_write_worker: Optional[WorkerClient] = None
        self.last_write_address: Optional[WorkerNetAddress] = None
        self._workers: Dict[str, WorkerClient] = {}
        self._lock = threading.Lock()
        #: workers that recently failed reads, with the failure time —
        #: entries expire after _FAILED_WORKER_TTL_S so a recovered worker
        #: comes back into rotation (reference: AlluxioFileInStream
        #: failed-worker memory, :94-95)
        self._failed_workers: Dict[str, float] = {}

    @classmethod
    def from_conf(cls, block_master, conf, **kwargs) -> "BlockStoreClient":
        """A client configured by the ``atpu.user.shm.*``,
        ``atpu.user.remote.read.*``, ``atpu.user.batch.read.*`` and
        ``atpu.user.native.fastpath.enabled`` keys of ``conf`` (a port
        ``Configuration``). Other keyword arguments pass through."""
        from alluxio_tpu_torch.conf import Keys

        return cls(
            block_master,
            remote_read=RemoteReadConf.from_conf(conf),
            shm_enabled=conf.get_bool(Keys.USER_SHM_ENABLED),
            shm_cache_max=conf.get_int(Keys.USER_SHM_SEGMENT_CACHE_MAX),
            shm_renew_fraction=conf.get_float(
                Keys.USER_SHM_LEASE_RENEW_FRACTION),
            batch_read=BatchReadConf.from_conf(conf),
            native_fastpath=conf.get_bool(Keys.USER_NATIVE_FASTPATH_ENABLED),
            **kwargs)

    @property
    def block_master(self):
        """The block-master client (public: placement reporting etc.)."""
        return self._bm

    # -- worker client cache -------------------------------------------------
    def worker_client(self, address: WorkerNetAddress) -> WorkerClient:
        key = f"{address.host}:{address.data_port or address.rpc_port}"
        with self._lock:
            c = self._workers.get(key)
            if c is None:
                c = WorkerClient(key)
                self._workers[key] = c
            return c

    _FAILED_WORKER_TTL_S = 30.0

    def _is_failed(self, key: str) -> bool:
        t = self._failed_workers.get(key)
        if t is None:
            return False
        if time.monotonic() - t > self._FAILED_WORKER_TTL_S:
            del self._failed_workers[key]
            return False
        return True

    def _live_workers(self) -> List[WorkerInfo]:
        return [w for w in self._bm.get_worker_infos()
                if not self._is_failed(w.address.key())]

    def mark_failed(self, address: Optional[WorkerNetAddress]) -> None:
        if address is not None:
            self._failed_workers[address.key()] = time.monotonic()

    # -- read ladder ---------------------------------------------------------
    def _opened(self, stream: BlockInStream, rung: str, address,
                counter: str) -> BlockInStream:
        stream.address = address
        stream.rung = rung
        metrics().counter(f"Client.BlockOpens.{counter}").inc()
        return stream

    def open_block(self, fbi: FileBlockInfo, *,
                   ufs_info: Optional[dict] = None,
                   cache_cold_reads: bool = True,
                   exclude: Optional[Set[str]] = None) -> BlockInStream:
        """Build the best stream for one block
        (reference: ``BlockInStream.create``, ``BlockInStream.java:97``).

        ``exclude``: worker address keys to skip for this call only (the
        caller saw a stale location there mid-retry)."""
        info = fbi.block_info
        exclude = exclude or set()
        local_hostname = socket.gethostname()
        # 1-2) same-host cached copy: SHM zero-copy map first (one lease
        # RPC, then every read is a slice of the segment), then the
        # path-lease short-circuit — each falls one rung on failure
        if self._short_circuit:
            for loc in info.locations:
                if loc.address.key() in exclude or \
                        not is_local_worker(loc.address, local_hostname):
                    continue
                client = self.worker_client(loc.address)
                if self.shm is not None:
                    try:
                        return self._opened(
                            self.shm.open_stream(client, info.block_id),
                            "shm", loc.address, "shm")
                    except Exception:  # noqa: BLE001 - fall through ladder
                        # lease denied / block not in the top tier /
                        # map failed / worker dead: the short-circuit
                        # and remote rungs still serve it
                        pass
                try:
                    return self._opened(
                        LocalBlockInStream(client, self.session_id,
                                           info.block_id),
                        "lease", loc.address, "shm")
                except Exception:  # noqa: BLE001 - fall through ladder
                    pass
        # 3) remote cached copy, nearest first; the UFS descriptor rides
        # along so a stale location (block evicted since the master's last
        # heartbeat) self-heals server-side via read-through
        addrs = [loc.address for loc in info.locations
                 if not self._is_failed(loc.address.key())
                 and loc.address.key() not in exclude]
        if addrs:
            idx = self._identity.nearest([a.tiered_identity for a in addrs])
            address = addrs[idx if idx is not None else 0]
            # the whole healthy replica set rides along, nearest first:
            # striped reads fan stripes out across it, and a replica
            # dying mid-read re-routes instead of failing
            replicas = [address] + [a for a in addrs
                                    if a.key() != address.key()]
            stream = GrpcBlockInStream(
                self.worker_client(address), info.block_id, info.length,
                ufs=ufs_info, cache=cache_cold_reads,
                chunk_size=self._chunk_size, remote_read=self.remote_read,
                replicas=replicas, client_factory=self.worker_client,
                on_failed=self.mark_failed, batch=self.batch_read)
            self._maybe_passive_cache(info, ufs_info)
            return self._opened(stream, "remote", address, "remote")
        # 4) UFS fallback through a policy-chosen worker (caches read-through)
        if ufs_info is None:
            raise UnavailableError(
                f"block {info.block_id} has no cached copy and no UFS source")
        workers = [w for w in self._live_workers()
                   if w.address.key() not in exclude]
        address = self._ufs_read_policy.pick(workers, block_id=info.block_id,
                                             block_size=info.length)
        if address is None:
            raise UnavailableError("no live workers for UFS read")
        # striping still applies on the cold path: the stripes stream
        # back over pooled channels
        stream = GrpcBlockInStream(self.worker_client(address),
                                   info.block_id, info.length, ufs=ufs_info,
                                   cache=cache_cold_reads,
                                   chunk_size=self._chunk_size,
                                   remote_read=self.remote_read,
                                   client_factory=self.worker_client,
                                   on_failed=self.mark_failed,
                                   batch=self.batch_read)
        return self._opened(stream, "ufs", address, "ufs")

    def _maybe_passive_cache(self, info: BlockInfo,
                             ufs_info: Optional[dict]) -> None:
        """Reading remotely: ask a local worker to cache a copy
        (reference: AsyncCache RPC, ``AlluxioFileInStream.java:137``)."""
        if not self._passive_cache or ufs_info is None:
            return
        local_hostname = socket.gethostname()
        for w in self._live_workers():
            if is_local_worker(w.address, local_hostname) and not any(
                    loc.address.key() == w.address.key()
                    for loc in info.locations):
                try:
                    self.worker_client(w.address).async_cache(
                        info.block_id, ufs_info["ufs_path"],
                        ufs_info["offset"], ufs_info["length"],
                        ufs_info.get("mount_id", 0))
                except Exception:  # noqa: BLE001 - best effort
                    pass
                return

    # -- write ---------------------------------------------------------------
    def _pick_writable(self, block_id: int, size_hint: int,
                       preferred: Optional[WorkerNetAddress]
                       ) -> Optional[WorkerNetAddress]:
        # Unfiltered list: the failed memory records READ errors (30s
        # TTL); a worker that botched one read is still a valid write
        # target, and filtering it here could starve the retry window.
        workers = list(self._bm.get_worker_infos())
        if preferred is not None and any(
                w.address.key() == preferred.key() for w in workers):
            # one file's blocks stay on one worker so worker-side persist
            # can stream them out locally
            return preferred
        return self._write_policy.pick(workers, block_id=block_id,
                                       block_size=size_hint)

    def open_block_writer(self, block_id: int, *, size_hint: int,
                          tier: str = "", pinned: bool = False,
                          preferred: Optional[WorkerNetAddress] = None
                          ) -> BlockOutStream:
        address = self._pick_writable(block_id, size_hint, preferred)
        if address is None and self._write_unavailable_window_s > 0:
            # Transient unavailability: a worker that missed heartbeats
            # under host overload is marked lost, empties the live set,
            # then re-registers seconds later. Wait out that window with
            # jittered backoff instead of failing the stream.
            policy = ExponentialTimeBoundedRetry(
                max_duration_s=self._write_unavailable_window_s,
                base_sleep_s=0.05, max_sleep_s=1.0)
            policy.attempt()  # first attempt already happened above
            while address is None and policy.attempt():
                address = self._pick_writable(block_id, size_hint, preferred)
        if address is None:
            raise UnavailableError("no live workers to write to")
        client = self.worker_client(address)
        self.last_write_worker = client
        self.last_write_address = address
        if self._short_circuit and is_local_worker(address,
                                                   socket.gethostname()):
            try:
                return LocalBlockOutStream(client, self.session_id, block_id,
                                           size_hint=size_hint, tier=tier,
                                           pinned=pinned)
            except Exception:  # noqa: BLE001
                pass
        return GrpcBlockOutStream(client, self.session_id, block_id,
                                  tier=tier, pinned=pinned,
                                  chunk_size=self._writer_chunk_size)

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        """Stop the stripe executor, unmap every SHM segment, and close
        this client's session on each worker it used, which releases
        every SHM lease and short-circuit lease it holds there (the
        leases' TTL backstops a worker that cannot be reached). Close the
        loaders reading through this client first: a segment that a copy
        still views stays mapped until the view is gone, but its lease
        and its eviction pin end here."""
        self.remote_read.close()
        if self.shm is not None:
            self.shm.close()
        for c in self._workers.values():
            try:
                c.cleanup_session(self.session_id)
            except Exception:  # noqa: BLE001
                pass
