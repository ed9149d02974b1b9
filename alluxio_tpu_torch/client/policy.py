"""Block location policies: which worker serves/stores a block (a copy
of ``alluxio_tpu/client/policy.py``).

Re-design of ``core/client/fs/src/main/java/alluxio/client/block/policy/
{BlockLocationPolicy,LocalFirstPolicy,LocalFirstAvoidEvictionPolicy,
MostAvailableFirstPolicy,RoundRobinPolicy,DeterministicHashPolicy,
SpecificHostPolicy}.java`` — with TPU locality: "local first" means same
host (shm short-circuit), then same ICI slice, then pod, then DCN
(``TieredIdentity`` ordering re-mapped in ``utils/wire.py``).
"""

from __future__ import annotations

import hashlib
import itertools
import random
from typing import List, Optional

from alluxio_tpu_torch.utils.wire import TieredIdentity, WorkerInfo, WorkerNetAddress


class BlockLocationPolicy:
    def pick(self, workers: List[WorkerInfo], *, block_id: int = 0,
             block_size: int = 0) -> Optional[WorkerNetAddress]:
        raise NotImplementedError

    @staticmethod
    def create(kind: str, *, identity: Optional[TieredIdentity] = None,
               **kwargs) -> "BlockLocationPolicy":
        k = kind.upper()
        if k == "LOCAL_FIRST":
            return LocalFirstPolicy(identity or TieredIdentity([]))
        if k == "LOCAL_FIRST_AVOID_EVICTION":
            return LocalFirstAvoidEvictionPolicy(identity or TieredIdentity([]))
        if k == "MOST_AVAILABLE":
            return MostAvailablePolicy()
        if k == "ROUND_ROBIN":
            return RoundRobinPolicy()
        if k == "DETERMINISTIC_HASH":
            return DeterministicHashPolicy(**kwargs)
        if k == "SPECIFIC_HOST":
            return SpecificHostPolicy(**kwargs)
        raise ValueError(f"unknown policy {kind}")


class LocalFirstPolicy(BlockLocationPolicy):
    """Nearest by TieredIdentity; random among equally-near
    (reference: ``LocalFirstPolicy.java``)."""

    def __init__(self, identity: TieredIdentity) -> None:
        self._id = identity
        self._rng = random.Random()

    def pick(self, workers: List[WorkerInfo], *, block_id: int = 0,
             block_size: int = 0) -> Optional[WorkerNetAddress]:
        if not workers:
            return None
        scored = [(self._id.closeness(w.address.tiered_identity), i)
                  for i, w in enumerate(workers)]
        best = min(s for s, _ in scored)
        near = [workers[i] for s, i in scored if s == best]
        return self._rng.choice(near).address


class LocalFirstAvoidEvictionPolicy(BlockLocationPolicy):
    """Local first, but skip workers whose free space < block size
    (reference: ``LocalFirstAvoidEvictionPolicy``)."""

    def __init__(self, identity: TieredIdentity) -> None:
        self._inner = LocalFirstPolicy(identity)

    def pick(self, workers: List[WorkerInfo], *, block_id: int = 0,
             block_size: int = 0) -> Optional[WorkerNetAddress]:
        roomy = [w for w in workers
                 if w.capacity_bytes - w.used_bytes >= block_size]
        return self._inner.pick(roomy or workers, block_id=block_id,
                                block_size=block_size)


class MostAvailablePolicy(BlockLocationPolicy):
    def pick(self, workers: List[WorkerInfo], *, block_id: int = 0,
             block_size: int = 0) -> Optional[WorkerNetAddress]:
        if not workers:
            return None
        return max(workers,
                   key=lambda w: w.capacity_bytes - w.used_bytes).address


class RoundRobinPolicy(BlockLocationPolicy):
    def __init__(self) -> None:
        self._counter = itertools.count()

    def pick(self, workers: List[WorkerInfo], *, block_id: int = 0,
             block_size: int = 0) -> Optional[WorkerNetAddress]:
        if not workers:
            return None
        ordered = sorted(workers, key=lambda w: w.address.key())
        return ordered[next(self._counter) % len(ordered)].address


class DeterministicHashPolicy(BlockLocationPolicy):
    """Hash the block id onto k candidate workers, then choose among them —
    spreads cold UFS reads of one block over exactly k workers cluster-wide
    (reference: ``DeterministicHashPolicy``; SURVEY 2.11 'parallel UFS
    reads')."""

    def __init__(self, shards: int = 1) -> None:
        self._shards = max(1, shards)
        self._rng = random.Random()

    def pick(self, workers: List[WorkerInfo], *, block_id: int = 0,
             block_size: int = 0) -> Optional[WorkerNetAddress]:
        if not workers:
            return None
        ordered = sorted(workers, key=lambda w: w.address.key())
        digest = hashlib.md5(str(block_id).encode()).digest()
        start = int.from_bytes(digest[:8], "big")
        candidates = [ordered[(start + i) % len(ordered)]
                      for i in range(min(self._shards, len(ordered)))]
        return self._rng.choice(candidates).address


class SpecificHostPolicy(BlockLocationPolicy):
    def __init__(self, hostname: str = "") -> None:
        self._host = hostname

    def pick(self, workers: List[WorkerInfo], *, block_id: int = 0,
             block_size: int = 0) -> Optional[WorkerNetAddress]:
        for w in workers:
            if w.address.host == self._host or \
                    w.address.tiered_identity.value("host") == self._host:
                return w.address
        return None
