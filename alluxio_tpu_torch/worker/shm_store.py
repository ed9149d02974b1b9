"""Worker side of the same-host zero-copy plane: the SHM lease store
(the port of ``alluxio_tpu/worker/shm_store.py``).

Grants, renews, releases and reclaims leases on MEM-tier block files
(named shared-memory segments under ``atpu.worker.shm.dir``) so a
co-located client can mmap them and read with zero copies. See
``alluxio_tpu_torch/shm/`` for the protocol contract. A full lease
table denies, and so does the injected fault
(``atpu.debug.fault.shm.lease.deny.rate``).

Pin integration: a granted lease calls
:meth:`TieredBlockStore.pin_shm`, which shields the block from eviction
until the lease's TTL expires — renewal extends the pin, release drops
it once the block's *last* lease goes away. The pin is the worker-side
truth: even if this registry and the store disagree transiently (e.g. a
release racing a renewal), the TTL backstop reclaims within one lease
lifetime, and Linux mmap semantics keep an already-mapped client safe
across an unlink regardless.

Lock order: the registry lock is NEVER held across a store call —
``pin_shm``/``unpin_shm`` take the store's alloc lock, so registry
mutations collect their side effects and apply them after release.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional, Set

from alluxio_tpu_torch.metrics import metrics
from alluxio_tpu_torch.utils import faults
from alluxio_tpu_torch.shm import (ShmLeaseDeniedError,
                                   ShmSegmentUnavailableError)
from alluxio_tpu_torch.worker.tiered_store import TieredBlockStore


class _Lease:
    __slots__ = ("lease_id", "session_id", "block_id", "expires_at")

    def __init__(self, lease_id: int, session_id: int, block_id: int,
                 expires_at: float) -> None:
        self.lease_id = lease_id
        self.session_id = session_id
        self.block_id = block_id
        self.expires_at = expires_at


class ShmStore:
    """Registry of live SHM segment leases for one worker."""

    def __init__(self, store: TieredBlockStore, *, lease_ttl_s: float = 30.0,
                 max_leases: int = 1024, host: str = "") -> None:
        self._store = store
        #: the worker's locality host, which the fault scope matches
        self._host = host
        self.lease_ttl_s = max(1.0, float(lease_ttl_s))
        self.max_leases = max(1, int(max_leases))
        self._lock = threading.Lock()
        self._leases: Dict[int, _Lease] = {}
        self._by_block: Dict[int, Set[int]] = {}
        self._by_session: Dict[int, Set[int]] = {}
        self._ids = itertools.count(1)
        self._m = metrics()
        # the MEM tier (top tier) is the only mappable one: its files
        # sit on /dev/shm, lower tiers are ordinary disk paths
        self._top_alias = store.meta.tiers[0].alias if store.meta.tiers \
            else "MEM"

    # ------------------------------------------------------------- grant
    def open(self, session_id: int, block_id: int) -> dict:
        """Grant a lease: ``{lease_id, path, length, ttl_s}``.

        Raises :class:`ShmLeaseDeniedError` (table full / injected
        fault) or :class:`ShmSegmentUnavailableError` (no mappable
        top-tier segment) — both of which the client treats as "serve
        this read on a lower rung", never as a read failure."""
        if faults.armed() and \
                faults.injector().take_shm_lease_deny(self._host):
            self._m.counter("Worker.ShmLeasesDenied").inc()
            raise ShmLeaseDeniedError(
                f"shm lease for block {block_id} denied (injected fault)")
        meta = self._store.get_block_meta(block_id)
        if meta is None or meta.tier_alias != self._top_alias:
            raise ShmSegmentUnavailableError(
                f"block {block_id} has no mappable {self._top_alias} "
                f"segment (tier: "
                f"{meta.tier_alias if meta else 'not cached'})")
        now = time.monotonic()
        unpins: List[int] = []
        try:
            with self._lock:
                self._reap_locked(now, unpins)
                if len(self._leases) >= self.max_leases:
                    self._m.counter("Worker.ShmLeasesDenied").inc()
                    raise ShmLeaseDeniedError(
                        f"shm lease table full ({self.max_leases} leases)")
                lease = _Lease(next(self._ids), session_id, block_id,
                               now + self.lease_ttl_s)
                self._leases[lease.lease_id] = lease
                self._by_block.setdefault(block_id, set()).add(
                    lease.lease_id)
                self._by_session.setdefault(session_id, set()).add(
                    lease.lease_id)
        finally:
            self._unpin_all(unpins)
        # pin AFTER registry insert: a pin without a lease self-expires,
        # a lease without a pin could let eviction unlink a fresh map
        if not self._store.pin_shm(block_id, self.lease_ttl_s):
            # raced with eviction between meta lookup and pin
            self._drop(lease.lease_id)
            raise ShmSegmentUnavailableError(
                f"block {block_id} evicted during lease grant")
        self._m.counter("Worker.ShmLeasesGranted").inc()
        return {"lease_id": lease.lease_id, "path": meta.path,
                "length": meta.length, "ttl_s": self.lease_ttl_s}

    # ------------------------------------------------------- renew/release
    def renew(self, session_id: int, lease_id: int) -> dict:
        """Extend a lease one TTL. ``{ok: False}`` for an unknown or
        expired lease (worker restart, reclaimed) — the client's cue to
        drop its mapping and re-open or fall back."""
        now = time.monotonic()
        with self._lock:
            lease = self._leases.get(lease_id)
            if lease is None or lease.session_id != session_id or \
                    lease.expires_at <= now:
                return {"ok": False, "ttl_s": 0.0}
            lease.expires_at = now + self.lease_ttl_s
            block_id = lease.block_id
        if not self._store.pin_shm(block_id, self.lease_ttl_s):
            self._drop(lease_id)
            return {"ok": False, "ttl_s": 0.0}
        self._m.counter("Worker.ShmLeasesRenewed").inc()
        return {"ok": True, "ttl_s": self.lease_ttl_s}

    def release(self, session_id: int, lease_id: int) -> bool:
        with self._lock:
            lease = self._leases.get(lease_id)
            if lease is None or lease.session_id != session_id:
                return False
        self._drop(lease_id)
        return True

    def close_session(self, session_id: int) -> None:
        """Release every lease of a disconnecting session (the graceful
        path; TTL expiry covers sessions that never say goodbye)."""
        with self._lock:
            victims = list(self._by_session.get(session_id, ()))
        for lid in victims:
            self._drop(lid)

    # --------------------------------------------------------- reclamation
    def reap_expired(self) -> int:
        """Drop expired leases and their pins; returns the count. Called
        opportunistically on every grant and by tests — the evictor's
        own TTL check on the pin map makes a dedicated reaper thread
        unnecessary."""
        unpins: List[int] = []
        with self._lock:
            n = self._reap_locked(time.monotonic(), unpins)
        self._unpin_all(unpins)
        return n

    def _reap_locked(self, now: float, unpins: List[int]) -> int:
        expired = [lid for lid, lease in self._leases.items()
                   if lease.expires_at <= now]
        for lid in expired:
            self._remove_locked(lid, unpins)
        if expired:
            self._m.counter("Worker.ShmLeasesReclaimed").inc(len(expired))
        return len(expired)

    def _drop(self, lease_id: int) -> None:
        unpins: List[int] = []
        with self._lock:
            self._remove_locked(lease_id, unpins)
        self._unpin_all(unpins)

    def _remove_locked(self, lease_id: int, unpins: List[int]) -> None:
        lease = self._leases.pop(lease_id, None)
        if lease is None:
            return
        sset = self._by_session.get(lease.session_id)
        if sset is not None:
            sset.discard(lease_id)
            if not sset:
                del self._by_session[lease.session_id]
        bset = self._by_block.get(lease.block_id)
        if bset is not None:
            bset.discard(lease_id)
            if not bset:
                del self._by_block[lease.block_id]
                # last lease gone: lift the eviction shield now instead
                # of waiting out the TTL (applied after the lock drops)
                unpins.append(lease.block_id)

    def _unpin_all(self, block_ids: List[int]) -> None:
        for bid in block_ids:
            self._store.unpin_shm(bid)

    # ------------------------------------------------------------- report
    def stats(self) -> dict:
        with self._lock:
            return {"live_leases": len(self._leases),
                    "leased_blocks": len(self._by_block),
                    "sessions": len(self._by_session),
                    "max_leases": self.max_leases,
                    "lease_ttl_s": self.lease_ttl_s}

    def lease_of(self, lease_id: int) -> Optional[_Lease]:
        with self._lock:
            return self._leases.get(lease_id)
