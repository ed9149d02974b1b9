"""Block master: block -> locations map, worker registry & liveness — a
copy of ``alluxio_tpu/master/block_master.py``, with one repair: the
container-id reservation entry tells its own live apply from a replay by
the thread that reserves, not by journal primacy. The JAX master takes
an entry applied while its journal is primary for its own live apply and
leaves the id generator where it is; a lone EMBEDDED member restarted
becomes the Raft leader before its apply loop replays its log, so it
restarts the generator at 1 and hands out container ids that its inodes
already hold (a new directory then gets the id of an existing inode, and
the path walk of the next journal apply never ends).

Re-design of ``core/server/master/.../block/DefaultBlockMaster.java:119``
(workerRegister ``:869``, workerHeartbeat ``:916``,
LostWorkerDetectionHeartbeatExecutor ``:1087``) and
``block/meta/MasterWorkerInfo.java``.

Journaled state: block lengths (``BLOCK_INFO``) and the container id
counter. Block *locations* are soft state reconstructed from worker
registrations/heartbeats — exactly the reference's split: a failover
rebuilds the location map from re-registration, never from the journal.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from alluxio_tpu_torch.journal.format import EntryType, JournalEntry, Journaled
from alluxio_tpu_torch.journal.system import JournalSystem
from alluxio_tpu_torch.utils import ids
from alluxio_tpu_torch.utils.clock import Clock, SystemClock
from alluxio_tpu_torch.utils.exceptions import (
    BlockDoesNotExistError, NotFoundError,
)
from alluxio_tpu_torch.utils.wire import (
    BlockInfo, BlockLocation, TieredIdentity, WorkerInfo, WorkerNetAddress,
)

LOG = logging.getLogger(__name__)


class WorkerCommand:
    """Commands piggybacked on heartbeat responses
    (reference: ``block_master.proto`` Command / CommandType)."""

    NOTHING = "NOTHING"
    REGISTER = "REGISTER"
    FREE = "FREE"
    DELETE = "DELETE"


@dataclass
class MasterWorkerInfo:
    id: int
    address: WorkerNetAddress
    start_time_ms: int = 0
    last_contact_ms: int = 0
    registered: bool = False
    capacity_bytes_on_tiers: Dict[str, int] = field(default_factory=dict)
    used_bytes_on_tiers: Dict[str, int] = field(default_factory=dict)
    #: block id -> tier alias
    blocks: Dict[int, str] = field(default_factory=dict)
    to_remove_blocks: Set[int] = field(default_factory=set)

    @property
    def capacity_bytes(self) -> int:
        return sum(self.capacity_bytes_on_tiers.values())

    @property
    def used_bytes(self) -> int:
        return sum(self.used_bytes_on_tiers.values())

    def to_wire(self, state: str = "LIVE") -> WorkerInfo:
        return WorkerInfo(
            id=self.id, address=self.address, state=state,
            capacity_bytes=self.capacity_bytes, used_bytes=self.used_bytes,
            start_time_ms=self.start_time_ms,
            last_contact_ms=self.last_contact_ms,
            capacity_bytes_on_tiers=dict(self.capacity_bytes_on_tiers),
            used_bytes_on_tiers=dict(self.used_bytes_on_tiers),
            block_count=len(self.blocks))


@dataclass
class MasterBlockMeta:
    block_id: int
    length: int = -1  # -1 until committed


class BlockMaster(Journaled):
    journal_name = "BlockMaster"

    def __init__(self, journal: JournalSystem, clock: Optional[Clock] = None,
                 worker_timeout_ms: int = 300_000) -> None:
        self._journal = journal
        journal.register(self)
        self._clock = clock or SystemClock()
        self._worker_timeout_ms = worker_timeout_ms
        self._lock = threading.RLock()
        # journaled
        self._blocks: Dict[int, MasterBlockMeta] = {}
        self.container_ids = ids.ContainerIdGenerator()
        # soft state
        self._workers: Dict[int, MasterWorkerInfo] = {}
        self._lost_workers: Dict[int, MasterWorkerInfo] = {}
        self._top_tiers: "frozenset[str]" = frozenset()
        self._address_to_id: Dict[str, int] = {}
        #: block id -> {worker id -> tier alias}
        self._locations: Dict[int, Dict[int, str]] = {}
        #: bumped on any location/topology change; "unchanged" means
        #: every derived per-file residency figure (in_memory_percentage,
        #: top tiers) is still valid — consumed by the listing cache
        self.location_version = 0
        #: block id -> {mesh position -> reporting host}: the HBM warm
        #: set reported by JAX clients (§2.11 device-mesh block map)
        self._device_locations: Dict[int, Dict[int, str]] = {}
        #: reporting host -> last report time (ms); reports are leases —
        #: a client that dies without clearing ages out (see
        #: prune_device_reports, driven by the lost-worker heartbeat)
        self._device_report_ms: Dict[str, int] = {}
        self.device_report_ttl_ms = 5 * 60 * 1000
        #: ids below this mark are covered by a journaled reservation
        self._container_reserved = 0
        #: the thread inside ``new_container_id``'s journal write: only
        #: its own apply of the reservation is live, any other a replay
        self._reserving_thread: Optional[int] = None
        self._reserve_lock = threading.Lock()
        self._lost_blocks: Set[int] = set()
        #: worker id -> quarantine start (ms): still registered, still
        #: serving its resident blocks, but filtered out of the
        #: placement listing (writes, UFS read-through policy picks,
        #: prefetch targets, replication targets) until released.
        #: Soft state owned by the remediation engine — like locations,
        #: never journaled: a failover drops quarantine and the health
        #: rules re-derive it if the worker is still sick.
        self._quarantined: Dict[int, int] = {}
        #: listeners fired on worker loss (elastic re-replication hook)
        self.lost_worker_listeners: List = []
        #: listeners fired on full (re-)registration — the only signal
        #: that a lost worker is genuinely back serving blocks (its
        #: metrics heartbeat alone is not: a worker whose block-sync
        #: thread is wedged keeps shipping metrics while serving nothing)
        self.registered_worker_listeners: List = []
        #: listeners fired (OUTSIDE the lock) with a batch of block ids
        #: whose LOCATIONS drifted — worker loss, quarantine/release, a
        #: re-replicated copy landing.  The master process routes these
        #: into the metadata invalidation log so client caches repair on
        #: the next heartbeat instead of waiting out their TTL
        #: (docs/ha.md; ROADMAP "location drift repairs only on TTL")
        self.location_change_listeners: List = []

    def _notify_location_change(self, block_ids: List[int]) -> None:
        """Fire location-drift listeners; caller must NOT hold the lock
        (listeners resolve block->path through the inode tree)."""
        if not block_ids:
            return
        for listener in self.location_change_listeners:
            try:
                listener(block_ids)
            except Exception:  # noqa: BLE001 - one bad hook must not block
                LOG.warning("location-change listener failed",
                            exc_info=True)

    #: container ids are journaled as a high-water mark in chunks of this
    #: size: one BLOCK_CONTAINER_ID entry covers the next N allocations,
    #: so create_file doesn't pay a journal flush per id. Replay resumes
    #: from the mark; ids the crashed master never handed out are simply
    #: skipped (ids are opaque). Reference:
    #: ``BlockContainerIdGenerator`` + ``JournalEntry.block_container_id``.
    CONTAINER_ID_RESERVATION = 1024

    # ------------------------------------------------------------ container
    def new_container_id(self) -> int:
        """Journaled container-id allocation via chunked reservation.

        The mark must be DURABLE before any id it covers is published:
        another RPC could use id mark-1 and group-commit its inode entry
        while this RPC's (deferred) reservation flush never happens, and
        replay would then re-issue used ids. Hence immediate_durability
        + publishing ``_container_reserved`` only after the write (one
        fsync per CONTAINER_ID_RESERVATION creates).

        Locking: a DEDICATED ``_reserve_lock``, never ``self._lock`` —
        journal writes apply entries under the journal lock and that
        apply path takes ``self._lock`` (``process_entry``), so holding
        ``self._lock`` while entering the journal would be an ABBA
        deadlock against any concurrent block mutation."""
        cid = self.container_ids.next_container_id()
        if cid >= self._container_reserved:
            with self._reserve_lock:
                if cid < self._container_reserved:  # another thread won
                    return cid
                mark = cid + self.CONTAINER_ID_RESERVATION
                self._reserving_thread = threading.get_ident()
                try:
                    with self._journal.immediate_durability(), \
                            self._journal.create_context() as ctx:
                        ctx.append(EntryType.BLOCK_CONTAINER_ID,
                                   {"next_container_id": mark,
                                    "owner": self.journal_name})
                finally:
                    self._reserving_thread = None
                self._container_reserved = mark
        return cid

    # -------------------------------------------------------------- workers
    def get_worker_id(self, address: WorkerNetAddress) -> int:
        """Address-keyed worker id lease
        (reference: ``DefaultBlockMaster.getWorkerId``)."""
        key = address.key()
        with self._lock:
            existing = self._address_to_id.get(key)
            if existing is not None:
                lost = self._lost_workers.pop(existing, None)
                if lost is not None:
                    self._workers[existing] = lost
                    self._refresh_top_tiers()
                return existing
            wid = ids.create_worker_id(address.host, address.rpc_port)
            info = MasterWorkerInfo(id=wid, address=address,
                                    start_time_ms=self._clock.millis(),
                                    last_contact_ms=self._clock.millis())
            self._workers[wid] = info
            self._address_to_id[key] = wid
            return wid

    def worker_register(self, worker_id: int,
                        capacity_bytes_on_tiers: Dict[str, int],
                        used_bytes_on_tiers: Dict[str, int],
                        blocks_on_tiers: Dict[str, List[int]],
                        address: Optional[WorkerNetAddress] = None) -> None:
        """Full (re-)registration with complete block list
        (reference: ``workerRegister``, ``DefaultBlockMaster.java:869``)."""
        with self._lock:
            info = self._workers.get(worker_id)
            if info is None:
                info = self._lost_workers.pop(worker_id, None)
                if info is not None:
                    self._workers[worker_id] = info
            if info is None:
                if address is None:
                    raise NotFoundError(f"unknown worker id {worker_id}")
                info = MasterWorkerInfo(id=worker_id, address=address,
                                        start_time_ms=self._clock.millis())
                self._workers[worker_id] = info
                self._address_to_id[address.key()] = worker_id
            if address is not None:
                info.address = address
                self._address_to_id[address.key()] = worker_id
            # drop stale location info from a previous registration
            for bid in list(info.blocks):
                self._remove_location(bid, worker_id)
            info.blocks.clear()
            info.capacity_bytes_on_tiers = dict(capacity_bytes_on_tiers)
            info.used_bytes_on_tiers = dict(used_bytes_on_tiers)
            info.last_contact_ms = self._clock.millis()
            info.registered = True
            self._refresh_top_tiers()
            for tier, bids in blocks_on_tiers.items():
                for bid in bids:
                    if bid in self._blocks:
                        info.blocks[bid] = tier
                        self._add_location(bid, worker_id, tier)
                    else:
                        # master doesn't know this block -> tell worker to drop
                        info.to_remove_blocks.add(bid)
        for listener in self.registered_worker_listeners:
            try:
                listener(info)
            except Exception:  # noqa: BLE001 - one bad hook must not block registration
                LOG.warning("registered-worker listener failed for %s",
                            info.id, exc_info=True)

    def worker_heartbeat(self, worker_id: int,
                         used_bytes_on_tiers: Dict[str, int],
                         added_blocks: Dict[str, List[int]],
                         removed_blocks: List[int],
                         metrics: Optional[Dict[str, float]] = None) -> dict:
        """Periodic delta sync; returns a command
        (reference: ``workerHeartbeat``, ``DefaultBlockMaster.java:916``)."""
        with self._lock:
            info = self._workers.get(worker_id)
            if info is None or not info.registered:
                return {"command": WorkerCommand.REGISTER, "data": []}
            info.last_contact_ms = self._clock.millis()
            info.used_bytes_on_tiers = dict(used_bytes_on_tiers)
            for bid in removed_blocks:
                info.blocks.pop(bid, None)
                self._remove_location(bid, worker_id)
            for tier, bids in added_blocks.items():
                for bid in bids:
                    if bid in self._blocks:
                        info.blocks[bid] = tier
                        self._add_location(bid, worker_id, tier)
                    else:
                        info.to_remove_blocks.add(bid)
            if info.to_remove_blocks:
                data = sorted(info.to_remove_blocks)
                info.to_remove_blocks.clear()
                return {"command": WorkerCommand.FREE, "data": data}
            return {"command": WorkerCommand.NOTHING, "data": []}

    def _add_location(self, block_id: int, worker_id: int, tier: str) -> None:
        self._locations.setdefault(block_id, {})[worker_id] = tier
        self._lost_blocks.discard(block_id)
        self.location_version += 1

    def _remove_location(self, block_id: int, worker_id: int) -> None:
        locs = self._locations.get(block_id)
        if locs is not None:
            locs.pop(worker_id, None)
            self.location_version += 1
            if not locs:
                del self._locations[block_id]
                if block_id in self._blocks:
                    self._lost_blocks.add(block_id)

    def detect_lost_workers(self) -> List[int]:
        """Expire silent workers; fires lost-worker listeners
        (reference: LostWorkerDetectionHeartbeatExecutor,
        ``DefaultBlockMaster.java:1087``)."""
        self.prune_device_reports()
        now = self._clock.millis()
        newly_lost: List[MasterWorkerInfo] = []
        drifted: List[int] = []
        with self._lock:
            for wid, info in list(self._workers.items()):
                if now - info.last_contact_ms > self._worker_timeout_ms:
                    del self._workers[wid]
                    self._lost_workers[wid] = info
                    # a lost worker's quarantine dies with it: loss is
                    # the stronger state, and a later re-registration
                    # must start from a clean placement slate
                    self._quarantined.pop(wid, None)
                    info.registered = False
                    self._refresh_top_tiers()
                    drifted.extend(info.blocks)
                    for bid in list(info.blocks):
                        self._remove_location(bid, wid)
                    info.blocks.clear()
                    newly_lost.append(info)
        for info in newly_lost:
            for listener in self.lost_worker_listeners:
                try:
                    listener(info)
                except Exception:  # noqa: BLE001 - one bad hook must not block detection
                    LOG.warning("lost-worker listener failed for %s",
                                info.id, exc_info=True)
        self._notify_location_change(drifted)
        return [i.id for i in newly_lost]

    def worker_id_for_source(self, source: str) -> Optional[int]:
        """O(1) lookup of a LIVE worker by its metrics-source name
        (``worker-<host>:<rpc_port>``).  The remediation engine
        resolves alert subjects through this — scanning
        ``get_worker_infos`` would build a wire object per worker
        under the lock for every action taken."""
        if not source.startswith("worker-"):
            return None
        with self._lock:
            wid = self._address_to_id.get(source[len("worker-"):])
            return wid if wid in self._workers else None

    # ---------------------------------------------------------- quarantine
    def quarantine_worker(self, worker_id: int) -> bool:
        """Remove a live worker from the placement listing without
        touching its served blocks (remediation: a straggling or stale
        worker keeps serving what it has, but receives nothing new).
        Returns False for unknown/lost workers."""
        with self._lock:
            if worker_id not in self._workers:
                return False
            self._quarantined[worker_id] = self._clock.millis()
            self.location_version += 1
            drifted = list(self._workers[worker_id].blocks)
        self._notify_location_change(drifted)
        return True

    def release_worker(self, worker_id: int) -> bool:
        """Lift a quarantine (probation passed, or operator override)."""
        with self._lock:
            if self._quarantined.pop(worker_id, None) is None:
                return False
            self.location_version += 1
            info = self._workers.get(worker_id)
            drifted = list(info.blocks) if info is not None else []
        self._notify_location_change(drifted)
        return True

    def quarantined_workers(self) -> Dict[int, int]:
        """worker id -> quarantine start (ms since epoch)."""
        with self._lock:
            return dict(self._quarantined)

    def is_quarantined(self, worker_id: int) -> bool:
        with self._lock:
            return worker_id in self._quarantined

    def forget_worker(self, worker_id: int) -> None:
        """Expire one worker immediately (admin decommission / tests);
        same effect as the lost-worker detector firing for it."""
        with self._lock:
            info = self._workers.pop(worker_id, None)
            if info is None:
                return
            self._quarantined.pop(worker_id, None)
            self._lost_workers[worker_id] = info
            info.registered = False
            self._refresh_top_tiers()
            drifted = list(info.blocks)
            for bid in list(info.blocks):
                self._remove_location(bid, worker_id)
            info.blocks.clear()
        for listener in self.lost_worker_listeners:
            try:
                listener(info)
            except Exception:  # noqa: BLE001 - one bad hook must not block removal
                LOG.warning("lost-worker listener failed for %s",
                            info.id, exc_info=True)
        self._notify_location_change(drifted)

    # --------------------------------------------------------------- blocks
    def commit_block(self, worker_id: int, used_bytes_on_tier: int,
                     tier_alias: str, block_id: int, length: int) -> None:
        """Worker durably has the block; journal its length
        (reference: ``commitBlock``, ``block_master.proto:271``)."""
        with self._journal.create_context() as ctx:
            ctx.append(EntryType.BLOCK_INFO,
                       {"block_id": block_id, "length": length})
        drift = False
        with self._lock:
            info = self._workers.get(worker_id)
            if info is not None:
                # an ADDITIONAL replica landing (re-replication after a
                # quarantine/loss) is location drift other clients'
                # caches should hear about; the FIRST copy is the
                # writing client's own business
                locs = self._locations.get(block_id)
                drift = bool(locs) and worker_id not in locs
                info.blocks[block_id] = tier_alias
                info.used_bytes_on_tiers[tier_alias] = used_bytes_on_tier
                self._add_location(block_id, worker_id, tier_alias)
        if drift:
            self._notify_location_change([block_id])

    def commit_block_in_ufs(self, block_id: int, length: int) -> None:
        """Block persisted directly to UFS with no cached copy."""
        with self._journal.create_context() as ctx:
            ctx.append(EntryType.BLOCK_INFO,
                       {"block_id": block_id, "length": length})

    def remove_blocks(self, block_ids: List[int], delete_metadata: bool) -> None:
        """Mark blocks for removal on their workers; optionally drop metadata."""
        with self._lock:
            for bid in block_ids:
                for wid in list(self._locations.get(bid, {})):
                    w = self._workers.get(wid)
                    if w is not None:
                        w.to_remove_blocks.add(bid)
        if delete_metadata:
            with self._journal.create_context() as ctx:
                for bid in block_ids:
                    ctx.append(EntryType.DELETE_BLOCK, {"block_id": bid})

    def get_block_info(self, block_id: int) -> BlockInfo:
        with self._lock:
            meta = self._blocks.get(block_id)
            if meta is None:
                raise BlockDoesNotExistError(f"block {block_id} not found")
            return self._block_info_locked(meta)

    def _block_info_locked(self, meta: MasterBlockMeta) -> BlockInfo:
        locations = []
        for wid, tier in self._locations.get(meta.block_id, {}).items():
            w = self._workers.get(wid)
            if w is not None:
                locations.append(BlockLocation(worker_id=wid, address=w.address,
                                               tier_alias=tier))
        device_locations = [
            BlockLocation(
                worker_id=-(pos + 1), tier_alias="HBM",
                address=WorkerNetAddress(
                    host=host,
                    tiered_identity=TieredIdentity.from_spec(
                        f"host={host},mesh={pos}")))
            for pos, host in self._device_locations.get(
                meta.block_id, {}).items()]
        return BlockInfo(block_id=meta.block_id,
                         length=max(meta.length, 0), locations=locations,
                         device_locations=device_locations)

    # ------------------------------------------ device (HBM) warm-set map
    def report_device_blocks(self, host: str,
                             mesh_blocks: Dict[int, List[int]]) -> None:
        """A JAX client reports its warm set: mesh position -> resident
        block ids (SURVEY §2.11 "block map keyed by device mesh
        position"). Replaces that host's previous report, so a warm-set
        turnover is one call. Device residency is cache state like worker
        tiers — volatile, never journaled."""
        with self._lock:
            self._drop_device_host(host)
            for pos, bids in mesh_blocks.items():
                for bid in bids:
                    self._device_locations.setdefault(
                        int(bid), {})[int(pos)] = host
            self.location_version += 1
            if mesh_blocks:
                self._device_report_ms[host] = self._clock.millis()

    def _drop_device_host(self, host: str) -> None:
        for bid in list(self._device_locations):
            entry = self._device_locations[bid]
            for pos in [p for p, h in entry.items() if h == host]:
                del entry[pos]
            if not entry:
                del self._device_locations[bid]
        self._device_report_ms.pop(host, None)
        # device (HBM) residency feeds listing wire dicts — stale cache
        # entries would steer locality reads at hosts that dropped out
        self.location_version += 1

    def prune_device_reports(self) -> List[str]:
        """Age out device reports from hosts that stopped renewing (a
        crashed JAX client can't call clear); driven by the same
        heartbeat as lost-worker detection."""
        now = self._clock.millis()
        expired = []
        with self._lock:
            for host, ts in list(self._device_report_ms.items()):
                if now - ts > self.device_report_ttl_ms:
                    self._drop_device_host(host)
                    expired.append(host)
        return expired

    def clear_device_blocks(self, host: str) -> None:
        self.report_device_blocks(host, {})

    def device_block_map(self) -> Dict[int, Dict[int, str]]:
        """block id -> {mesh position: host} (introspection/report)."""
        with self._lock:
            return {bid: dict(m)
                    for bid, m in self._device_locations.items()}

    def get_block_infos(self, block_ids: List[int]) -> List[BlockInfo]:
        out = []
        with self._lock:
            for bid in block_ids:
                meta = self._blocks.get(bid)
                if meta is not None:
                    out.append(self._block_info_locked(meta))
        return out

    def block_exists(self, block_id: int) -> bool:
        with self._lock:
            return block_id in self._blocks

    # ------------------------------------------------------------- queries
    def worker_count(self) -> int:
        with self._lock:
            return len(self._workers)

    def lost_worker_count(self) -> int:
        with self._lock:
            return len(self._lost_workers)

    def registered_worker_count(self) -> int:
        with self._lock:
            return sum(1 for w in self._workers.values() if w.registered)

    def get_worker_infos(self, include_lost: bool = False,
                         include_quarantined: bool = True
                         ) -> List[WorkerInfo]:
        """Worker listing.  ``include_quarantined=False`` is the
        PLACEMENT view: quarantined workers vanish from it, which is
        what makes quarantine effective — every placement chooser
        (client write policy, UFS read-through pick, prefetch agent,
        replication targets) selects from this listing.  The default
        keeps them visible (marked ``QUARANTINED``) for reporting,
        health watching and in-process admin callers."""
        with self._lock:
            out = []
            for w in self._workers.values():
                if w.id in self._quarantined:
                    if include_quarantined:
                        out.append(w.to_wire("QUARANTINED"))
                else:
                    out.append(w.to_wire("LIVE"))
            if include_lost:
                out += [w.to_wire("LOST") for w in self._lost_workers.values()]
            return out

    def get_worker(self, worker_id: int) -> Optional[MasterWorkerInfo]:
        with self._lock:
            return self._workers.get(worker_id)

    def worker_resident_blocks(self, worker_id: int
                               ) -> Optional[Dict[int, str]]:
        """Locked copy of one worker's block -> tier map (None for
        unknown/lost workers).  ``MasterWorkerInfo.blocks`` is mutated
        in place by worker heartbeats, so iterating the live dict from
        another thread (the remediation engine picking hot blocks)
        would race a concurrent add/remove."""
        with self._lock:
            info = self._workers.get(worker_id)
            return dict(info.blocks) if info is not None else None

    def all_block_ids(self) -> List[int]:
        """Snapshot of every block id in the master map (integrity scan)."""
        with self._lock:
            return list(self._blocks)

    def has_locations(self, block_id: int) -> bool:
        """True when at least one live worker holds the block."""
        with self._lock:
            return bool(self._locations.get(block_id))

    def lost_blocks(self) -> Set[int]:
        with self._lock:
            return set(self._lost_blocks)

    def capacity_bytes_on_tiers(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        with self._lock:
            for w in self._workers.values():
                for tier, n in w.capacity_bytes_on_tiers.items():
                    out[tier] = out.get(tier, 0) + n
        return out

    def used_bytes_on_tiers(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        with self._lock:
            for w in self._workers.values():
                for tier, n in w.used_bytes_on_tiers.items():
                    out[tier] = out.get(tier, 0) + n
        return out

    def top_tiers(self) -> "frozenset[str]":
        """Aliases of each live worker's FASTEST tier, from registered
        topology (workers register tiers top-down; dict order carries
        the ordinal). Replaces hardcoded device-tier name lists —
        tier semantics belong to worker metadata (reference:
        ``worker/block/meta/StorageTier.java:48``). Cached: recomputed
        on membership changes, read lock-free (it sits on every
        ``_file_info`` call in a ``list_status`` loop)."""
        return self._top_tiers

    def _refresh_top_tiers(self) -> None:
        """Caller holds ``self._lock``."""
        out = set()
        for w in self._workers.values():
            for tier in w.capacity_bytes_on_tiers:
                out.add(tier)
                break  # first registered = top tier
        self._top_tiers = frozenset(out)
        self.location_version += 1

    # ---------------------------------------------------- journal contract
    def process_entry(self, entry: JournalEntry) -> bool:
        t, p = entry.type, entry.payload
        if t == EntryType.BLOCK_INFO:
            with self._lock:
                self._blocks[p["block_id"]] = MasterBlockMeta(
                    block_id=p["block_id"], length=p["length"])
        elif t == EntryType.DELETE_BLOCK:
            with self._lock:
                self._blocks.pop(p["block_id"], None)
                self._locations.pop(p["block_id"], None)
                self._lost_blocks.discard(p["block_id"])
        elif t == EntryType.BLOCK_CONTAINER_ID and \
                p.get("owner") == self.journal_name:
            if self._reserving_thread == threading.get_ident():
                # live self-apply: the generator already advanced past
                # the ids being reserved; jumping it to the mark would
                # burn the whole chunk and re-reserve on EVERY call.
                # Only track the covered range. (The JAX master asks
                # the journal's primacy here, which a restarted lone
                # Raft member holds while it replays its log.)
                self._container_reserved = max(
                    self._container_reserved, p["next_container_id"])
            else:
                # replay / standby tailing: resume above the mark
                self.container_ids.restore(p["next_container_id"])
        else:
            return False
        return True

    def snapshot(self) -> dict:
        with self._lock:
            return {
                # the RESERVED mark, not peek: a checkpoint GCs the
                # segment holding the reservation entry, so the snapshot
                # must carry the full covered range or replay would
                # re-issue ids handed out after the checkpoint
                "next_container_id": max(self.container_ids.peek,
                                         self._container_reserved),
                "blocks": [(m.block_id, m.length) for m in self._blocks.values()],
            }

    def restore(self, snap: dict) -> None:
        with self._lock:
            self._blocks = {bid: MasterBlockMeta(bid, length)
                            for bid, length in snap.get("blocks", [])}
            self.container_ids = ids.ContainerIdGenerator(
                snap.get("next_container_id", 1))
            self._container_reserved = snap.get("next_container_id", 1)
            self._locations.clear()
            self._lost_blocks.clear()
