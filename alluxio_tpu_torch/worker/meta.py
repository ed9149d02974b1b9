"""Worker storage metadata: tiers, dirs, block records.

A copy of ``alluxio_tpu/worker/meta.py``.

Re-design of ``core/server/worker/.../block/meta/{StorageTier.java:48,
StorageDir.java:52,BlockMeta,TempBlockMeta}.java`` +
``BlockMetadataManager.java``. Tier ordering is by *ordinal* (0 fastest);
default aliases MEM (``/dev/shm`` — mmap-able by same-host clients for the
short-circuit zero-copy path) then SSD then HDD. The HBM tier lives
client-side (see ``client/cache/hbm_store.py``): device memory belongs to
the training process, so the worker's job is to stage bytes where the
client can map them without a copy.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass
class BlockMeta:
    block_id: int
    length: int
    dir: "StorageDir"

    @property
    def tier_alias(self) -> str:
        return self.dir.tier.alias

    @property
    def path(self) -> str:
        return self.dir.block_path(self.block_id)


@dataclass
class TempBlockMeta:
    block_id: int
    session_id: int
    dir: "StorageDir"
    bytes_reserved: int  # space accounted during write

    @property
    def path(self) -> str:
        return self.dir.temp_block_path(self.session_id, self.block_id)


class StorageDir:
    def __init__(self, tier: "StorageTier", index: int, path: str,
                 capacity_bytes: int, medium_type: str = "") -> None:
        self.tier = tier
        self.index = index
        self.path = path
        self.capacity_bytes = capacity_bytes
        self.medium_type = medium_type or tier.alias
        self._used = 0
        self._blocks: Dict[int, BlockMeta] = {}
        self._temp: Dict[int, TempBlockMeta] = {}
        self._lock = threading.RLock()
        os.makedirs(path, exist_ok=True)
        os.makedirs(self._tmp_root(), exist_ok=True)

    def _tmp_root(self) -> str:
        return os.path.join(self.path, ".tmp")

    def block_path(self, block_id: int) -> str:
        return os.path.join(self.path, str(block_id))

    def temp_block_path(self, session_id: int, block_id: int) -> str:
        return os.path.join(self._tmp_root(), f"{session_id}_{block_id}")

    # -- accounting ---------------------------------------------------------
    @property
    def used_bytes(self) -> int:
        with self._lock:
            return self._used

    @property
    def available_bytes(self) -> int:
        with self._lock:
            return self.capacity_bytes - self._used

    def reserve(self, n: int) -> bool:
        with self._lock:
            if self._used + n > self.capacity_bytes:
                return False
            self._used += n
            return True

    def release(self, n: int) -> None:
        with self._lock:
            self._used = max(0, self._used - n)

    def force_reserve(self, n: int) -> None:
        """Account bytes that are already on disk even past capacity
        (short-circuit writes can overshoot; truth beats the quota)."""
        with self._lock:
            self._used += n

    # -- block records ------------------------------------------------------
    def add_block(self, meta: BlockMeta) -> None:
        with self._lock:
            self._blocks[meta.block_id] = meta

    def remove_block(self, block_id: int) -> Optional[BlockMeta]:
        with self._lock:
            return self._blocks.pop(block_id, None)

    def get_block(self, block_id: int) -> Optional[BlockMeta]:
        with self._lock:
            return self._blocks.get(block_id)

    def block_ids(self) -> List[int]:
        with self._lock:
            return list(self._blocks.keys())

    def add_temp(self, meta: TempBlockMeta) -> None:
        with self._lock:
            self._temp[meta.block_id] = meta

    def remove_temp(self, block_id: int) -> Optional[TempBlockMeta]:
        with self._lock:
            return self._temp.pop(block_id, None)

    def get_temp(self, block_id: int) -> Optional[TempBlockMeta]:
        with self._lock:
            return self._temp.get(block_id)

    def temp_blocks_of_session(self, session_id: int) -> List[TempBlockMeta]:
        with self._lock:
            return [t for t in self._temp.values()
                    if t.session_id == session_id]


class StorageTier:
    def __init__(self, alias: str, ordinal: int) -> None:
        self.alias = alias
        self.ordinal = ordinal
        self.dirs: List[StorageDir] = []

    def add_dir(self, path: str, capacity_bytes: int,
                medium_type: str = "") -> StorageDir:
        d = StorageDir(self, len(self.dirs), path, capacity_bytes, medium_type)
        self.dirs.append(d)
        return d

    @property
    def capacity_bytes(self) -> int:
        return sum(d.capacity_bytes for d in self.dirs)

    @property
    def used_bytes(self) -> int:
        return sum(d.used_bytes for d in self.dirs)

    @property
    def available_bytes(self) -> int:
        return sum(d.available_bytes for d in self.dirs)


class BlockMetadataManager:
    """All tiers + lookup across them (reference: BlockMetadataManager)."""

    def __init__(self) -> None:
        self.tiers: List[StorageTier] = []
        self._by_alias: Dict[str, StorageTier] = {}

    def add_tier(self, alias: str) -> StorageTier:
        tier = StorageTier(alias, len(self.tiers))
        self.tiers.append(tier)
        self._by_alias[alias] = tier
        return tier

    def get_tier(self, alias: str) -> StorageTier:
        return self._by_alias[alias]

    def has_tier(self, alias: str) -> bool:
        return alias in self._by_alias

    def tier_below(self, alias: str) -> Optional[StorageTier]:
        t = self._by_alias[alias]
        if t.ordinal + 1 < len(self.tiers):
            return self.tiers[t.ordinal + 1]
        return None

    def tier_above(self, alias: str) -> Optional[StorageTier]:
        t = self._by_alias[alias]
        if t.ordinal > 0:
            return self.tiers[t.ordinal - 1]
        return None

    def get_block(self, block_id: int) -> Optional[BlockMeta]:
        for tier in self.tiers:
            for d in tier.dirs:
                meta = d.get_block(block_id)
                if meta is not None:
                    return meta
        return None

    def get_temp(self, block_id: int) -> Optional[TempBlockMeta]:
        for tier in self.tiers:
            for d in tier.dirs:
                meta = d.get_temp(block_id)
                if meta is not None:
                    return meta
        return None

    def blocks_on_tiers(self) -> Dict[str, List[int]]:
        return {tier.alias: [bid for d in tier.dirs for bid in d.block_ids()]
                for tier in self.tiers}

    def capacity_on_tiers(self) -> Dict[str, int]:
        return {t.alias: t.capacity_bytes for t in self.tiers}

    def used_on_tiers(self) -> Dict[str, int]:
        return {t.alias: t.used_bytes for t in self.tiers}
