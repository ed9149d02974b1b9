"""Worker->master sync protocols.

A copy of ``alluxio_tpu/worker/master_sync.py``.

Re-designs of ``core/server/worker/.../block/{BlockMasterSync.java:51,
BlockHeartbeatReporter.java,PinListSync.java}`` and the storage health check
(``DefaultBlockWorker.StorageChecker:624``).

The master client is duck-typed (``get_worker_id``, ``register``,
``heartbeat``, ``commit_block``): the port's or the JAX package's gRPC
``BlockMasterClient``, or any object with that surface — the protocol
code cannot tell.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, List, Optional, Set

from alluxio_tpu_torch.heartbeat import HeartbeatExecutor
from alluxio_tpu_torch.master.block_master import WorkerCommand
from alluxio_tpu_torch.utils import ids as id_utils
from alluxio_tpu_torch.utils.wire import WorkerNetAddress
from alluxio_tpu_torch.worker.tiered_store import TieredBlockStore

LOG = logging.getLogger(__name__)


class BlockHeartbeatReporter:
    """Accumulates block movements between heartbeats
    (reference: ``BlockHeartbeatReporter``)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._added: Dict[str, List[int]] = {}
        self._removed: List[int] = []

    def on_event(self, store: TieredBlockStore, event: str, block_id: int) -> None:
        meta = store.get_block_meta(block_id)
        with self._lock:
            if event in ("committed", "moved") and meta is not None:
                for tier_blocks in self._added.values():
                    if block_id in tier_blocks:
                        tier_blocks.remove(block_id)
                self._added.setdefault(meta.tier_alias, []).append(block_id)
            elif event in ("removed", "evicted"):
                for tier_blocks in self._added.values():
                    if block_id in tier_blocks:
                        tier_blocks.remove(block_id)
                self._removed.append(block_id)

    def generate_report(self) -> Dict:
        with self._lock:
            report = {"added": {k: list(v) for k, v in self._added.items()
                                if v},
                      "removed": list(self._removed)}
            self._added.clear()
            self._removed.clear()
            return report

    def merge_back(self, report: Dict) -> None:
        """Heartbeat failed; keep the delta for the next attempt."""
        with self._lock:
            for tier, blocks in report["added"].items():
                self._added.setdefault(tier, []).extend(blocks)
            self._removed.extend(report["removed"])


class InProcessBlockMasterClient:
    """Direct-call adapter over a BlockMaster (thread-level 'RPC')."""

    def __init__(self, block_master) -> None:
        self._m = block_master

    def get_worker_id(self, address: WorkerNetAddress) -> int:
        return self._m.get_worker_id(address)

    def register(self, worker_id: int, capacity: Dict[str, int],
                 used: Dict[str, int], blocks: Dict[str, List[int]],
                 address: Optional[WorkerNetAddress] = None) -> None:
        self._m.worker_register(worker_id, capacity, used, blocks, address)

    def heartbeat(self, worker_id: int, used: Dict[str, int],
                  added: Dict[str, List[int]], removed: List[int],
                  metrics_snapshot: Optional[Dict[str, float]] = None) -> dict:
        return self._m.worker_heartbeat(worker_id, used, added, removed,
                                        metrics_snapshot)

    def commit_block(self, worker_id: int, used_on_tier: int, tier: str,
                     block_id: int, length: int) -> None:
        self._m.commit_block(worker_id, used_on_tier, tier, block_id, length)


class BlockMasterSync(HeartbeatExecutor):
    """Register + periodic heartbeat + command handling
    (reference: ``BlockMasterSync.java:96-189``)."""

    def __init__(self, store: TieredBlockStore, address: WorkerNetAddress,
                 master_client) -> None:
        self._store = store
        self._address = address
        self._client = master_client
        self._reporter = BlockHeartbeatReporter()
        store.add_listener(
            lambda ev, bid: self._reporter.on_event(store, ev, bid))
        self.worker_id: Optional[int] = None

    def register_with_master(self) -> int:
        self.worker_id = self._client.get_worker_id(self._address)
        # Discard the pending delta BEFORE snapshotting: an event that lands
        # after the clear is preserved and re-sent on the next heartbeat
        # (idempotent at the master), whereas clearing after the snapshot
        # would silently drop any commit/evict that raced the registration.
        self._reporter.generate_report()
        cap, used = self._store.store_meta()
        self._client.register(self.worker_id, cap, used,
                              self._store.block_report(), self._address)
        return self.worker_id

    def heartbeat(self) -> None:
        if self.worker_id is None:
            self.register_with_master()
            return
        report = self._reporter.generate_report()
        _, used = self._store.store_meta()
        try:
            resp = self._client.heartbeat(self.worker_id, used,
                                          report["added"], report["removed"])
        except Exception:  # noqa: BLE001 - keep delta, retry next tick
            self._reporter.merge_back(report)
            raise
        self._handle_command(resp)

    def _handle_command(self, resp: dict) -> None:
        cmd, data = resp.get("command"), resp.get("data", [])
        if cmd == WorkerCommand.REGISTER:
            # master lost us (failover / timeout): full re-register
            self.register_with_master()
        elif cmd in (WorkerCommand.FREE, WorkerCommand.DELETE):
            for bid in data:
                try:
                    self._store.remove_block(bid, timeout=0.5)
                except Exception:  # noqa: BLE001
                    LOG.debug("free of block %s deferred (busy)", bid)


class PinListSync(HeartbeatExecutor):
    """Pulls the master's pinned-file set and maps it onto local block ids
    (reference: ``PinListSync.java``)."""

    def __init__(self, store: TieredBlockStore, fs_master_client) -> None:
        self._store = store
        self._client = fs_master_client

    def heartbeat(self) -> None:
        pinned_files: Set[int] = set(self._client.get_pinned_file_ids())
        pinned_blocks = {
            bid for tier_blocks in self._store.block_report().values()
            for bid in tier_blocks
            if id_utils.file_id_for_block(bid) in pinned_files}
        # replaces only the master-driven set; commit-time pins
        # (commit_block(pinned=True)) live in store.pinned_blocks and are
        # not clobbered by a sync computed from an older block report
        self._store.master_pinned_blocks = pinned_blocks


class StorageChecker(HeartbeatExecutor):
    """Detects failed storage dirs (unwritable paths) and drops their blocks
    so the next heartbeat/registration reflects reality
    (reference: ``DefaultBlockWorker.StorageChecker:624``)."""

    def __init__(self, store: TieredBlockStore,
                 on_dir_lost=None) -> None:
        self._store = store
        self._on_dir_lost = on_dir_lost

    def heartbeat(self) -> None:
        for tier in self._store.meta.tiers:
            for d in list(tier.dirs):
                if not os.path.isdir(d.path) or not os.access(d.path, os.W_OK):
                    LOG.error("storage dir %s failed; dropping %d blocks",
                              d.path, len(d.block_ids()))
                    for bid in d.block_ids():
                        try:
                            self._store.remove_block(bid, timeout=0.1)
                        except Exception:  # noqa: BLE001
                            # busy/gone: still drop the record AND tell the
                            # master, or it keeps routing clients here
                            LOG.debug("remove_block(%s) on failed dir "
                                      "errored; dropping record", bid,
                                      exc_info=True)
                            meta = d.remove_block(bid)
                            if meta is not None:
                                d.release(meta.length)
                            self._store._emit("removed", bid)
                    tier.dirs.remove(d)
                    if self._on_dir_lost is not None:
                        self._on_dir_lost(d)
