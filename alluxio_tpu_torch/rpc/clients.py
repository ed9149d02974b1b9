"""Typed, retrying RPC clients: the worker's, from
``alluxio_tpu/rpc/clients.py`` (``_BaseClient`` and ``WorkerClient``).

Every unary call runs under an exponential time-bounded retry on
transient errors (reference: ``AbstractClient`` + ``RetryUtils``). The
port's base client talks to one address; the JAX client's multi-master
failover (leader hints, rotation, standby reads) and its master fast
path come with the master clients' slice.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Optional

import alluxio_tpu_torch.shm  # noqa: F401 - registers the typed SHM errors
from alluxio_tpu_torch.rpc.core import RpcChannel, StreamCall
from alluxio_tpu_torch.rpc.worker_service import WORKER_SERVICE
from alluxio_tpu_torch.utils.retry import ExponentialTimeBoundedRetry, retry


class _BaseClient:
    """One service at one address, every unary call retried on transient
    errors within the retry budget."""

    service = ""

    def __init__(self, address: str, *, conf=None, metadata=None) -> None:
        """``conf``: a port ``Configuration`` whose
        ``atpu.user.rpc.retry.*`` keys set the retry budget and backoff
        (their defaults without one: 30 s, 50 ms, 3 s)."""
        from alluxio_tpu_torch.conf import Configuration, Keys

        conf = conf if conf is not None else Configuration(load_env=False)
        self.address = address
        self._channel = RpcChannel(address, metadata=metadata)
        self._retry = tuple(conf.get_duration_s(k) for k in (
            Keys.USER_RPC_RETRY_MAX_DURATION, Keys.USER_RPC_RETRY_BASE_SLEEP,
            Keys.USER_RPC_RETRY_MAX_SLEEP))

    def _call(self, method: str, request: dict, timeout: float = 30.0):
        return retry(
            lambda: self._channel.call(self.service, method, request,
                                       timeout=timeout),
            ExponentialTimeBoundedRetry(*self._retry))


class WorkerClient(_BaseClient):
    """Data-plane client for one worker (reference: block streams +
    short-circuit RPCs in ``client/block/stream``).

    Beyond the default channel, the client mints **pooled channels** —
    distinct TCP connections to the same worker — so the striped read
    path fans stripes of one block out over several connections instead
    of serializing them behind one HTTP/2 flow-control window."""

    service = WORKER_SERVICE

    def __init__(self, address: str, *, conf=None, metadata=None) -> None:
        super().__init__(address, conf=conf, metadata=metadata)
        self._pooled: Dict[int, RpcChannel] = {}
        self._pooled_lock = threading.Lock()

    def pooled_channel(self, index: int) -> RpcChannel:
        """Channel for pool slot ``index`` (0 = the default channel),
        created lazily and kept for the client's life; the process-wide
        channel pool shares it with other clients of the address."""
        if index == 0:
            return self._channel
        with self._pooled_lock:
            ch = self._pooled.get(index)
            if ch is None:
                ch = RpcChannel(self.address,
                                metadata=self._channel.metadata,
                                pool_index=index)
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
                          channel: int = 0) -> StreamCall:
        """Cancellable ``read_block`` range stream over pool slot
        ``channel``: the striped read path's transport (it aborts hedge
        losers mid-transfer, which plain ``read_block`` cannot)."""
        return self.pooled_channel(channel).open_stream(
            self.service, "read_block", {
                "block_id": block_id, "offset": offset, "length": length,
                "chunk_size": chunk_size, "ufs": ufs, "cache": cache})

    def read_block_bytes(self, block_id: int, **kwargs) -> bytes:
        return b"".join(msg["data"] for msg in
                        self.read_block(block_id, **kwargs))

    def read_many(self, block_id: int, offsets, sizes) -> dict:
        """Scatter/gather batch read: N small reads of one block in ONE
        RPC — ``{data: <concatenated bytes>, lengths: [..], source}``."""
        return self._call("read_many", {
            "block_id": block_id, "offsets": list(offsets),
            "sizes": list(sizes)})

    def shm_open(self, session_id: int, block_id: int) -> dict:
        """Lease the block's same-host SHM segment:
        ``{lease_id, path, length, ttl_s}``. Raises the typed
        ``ShmLeaseDeniedError`` / ``ShmSegmentUnavailableError``, the
        caller's cue to take a lower rung (``shm/``)."""
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

        resp = self._channel.call_stream_in(self.service, "write_block",
                                            gen())
        return resp["length"]

    def open_local_block(self, session_id: int, block_id: int) -> dict:
        return self._call("open_local_block", {"session_id": session_id,
                                               "block_id": block_id})

    def close_local_block(self, session_id: int, block_id: int) -> None:
        # advisory lease release: the worker's session cleanup expires it
        # anyway, so NO retry and a short deadline — a close against a
        # dead worker must not block for the full retry window
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
        """``qos_class``: "ASYNC_FILL" (default) or "PREFETCH"."""
        return self._call("async_cache", {
            "block_id": block_id, "ufs_path": ufs_path, "offset": offset,
            "length": length, "mount_id": mount_id,
            "qos_class": qos_class})["accepted"]

    def prefetch_pin(self, block_id: int, ttl_s: float = 600.0) -> bool:
        """Eviction shield for a clairvoyantly-placed block (held until
        ``prefetch_unpin`` or TTL expiry)."""
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
