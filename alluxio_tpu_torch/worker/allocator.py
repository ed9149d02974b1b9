"""Block placement allocators (a copy of ``alluxio_tpu/worker/allocator.py``).

Re-design of ``core/server/worker/.../block/allocator/{Allocator.java,
MaxFreeAllocator.java:28,RoundRobinAllocator.java,GreedyAllocator.java}``:
choose a StorageDir for a new block of a given size, optionally constrained
to a tier ("location"). Returns None when nothing fits — the store then
frees space and retries (eviction-on-demand).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

from alluxio_tpu_torch.worker.meta import BlockMetadataManager, StorageDir, StorageTier

ANY_TIER = ""


class Allocator:
    def __init__(self, meta: BlockMetadataManager) -> None:
        self._meta = meta

    def _candidate_tiers(self, tier_alias: str) -> Iterable[StorageTier]:
        if tier_alias == ANY_TIER:
            return self._meta.tiers
        return [self._meta.get_tier(tier_alias)]

    def allocate(self, size: int, tier_alias: str = ANY_TIER) -> Optional[StorageDir]:
        raise NotImplementedError

    @staticmethod
    def create(kind: str, meta: BlockMetadataManager) -> "Allocator":
        k = kind.upper()
        if k == "MAX_FREE":
            return MaxFreeAllocator(meta)
        if k == "ROUND_ROBIN":
            return RoundRobinAllocator(meta)
        if k == "GREEDY":
            return GreedyAllocator(meta)
        raise ValueError(f"unknown allocator {kind}")


class MaxFreeAllocator(Allocator):
    """Dir with the most free space, top tier first
    (reference default, ``MaxFreeAllocator.java:28``)."""

    def allocate(self, size: int, tier_alias: str = ANY_TIER) -> Optional[StorageDir]:
        for tier in self._candidate_tiers(tier_alias):
            best = None
            for d in tier.dirs:
                if d.available_bytes >= size and (
                        best is None or d.available_bytes > best.available_bytes):
                    best = d
            if best is not None:
                return best
        return None


class GreedyAllocator(Allocator):
    """First dir that fits, scanning tiers top-down."""

    def allocate(self, size: int, tier_alias: str = ANY_TIER) -> Optional[StorageDir]:
        for tier in self._candidate_tiers(tier_alias):
            for d in tier.dirs:
                if d.available_bytes >= size:
                    return d
        return None


class RoundRobinAllocator(Allocator):
    """Rotate across dirs within each tier to spread IO."""

    def __init__(self, meta: BlockMetadataManager) -> None:
        super().__init__(meta)
        self._next_idx: Dict[str, int] = {}

    def allocate(self, size: int, tier_alias: str = ANY_TIER) -> Optional[StorageDir]:
        for tier in self._candidate_tiers(tier_alias):
            n = len(tier.dirs)
            if n == 0:
                continue
            start = self._next_idx.get(tier.alias, 0)
            for off in range(n):
                d = tier.dirs[(start + off) % n]
                if d.available_bytes >= size:
                    self._next_idx[tier.alias] = (start + off + 1) % n
                    return d
        return None
