"""Background tier management: align, promote, watermark restore (a copy
of ``alluxio_tpu/worker/management.py``).

Re-design of ``core/server/worker/.../block/management/
{ManagementTaskCoordinator.java:37,BlockTransferExecutor}.java`` and
``management/tier/{AlignTask.java:53,PromoteTask.java:51,SwapRestoreTask.java}``:

- **Align**: tier ordering should match access order — if a block on a
  lower tier is hotter than the coldest block on the tier above, swap them
  (demote the cold one, promote the hot one).
- **Promote**: warm data moves up while the upper tier is under its
  promote quota.
- **Watermark restore**: when a tier exceeds its high watermark, free down
  to the low watermark (the reference's swap-restore/reserved-space job).

Load-awareness: tasks back off while the store is serving (the reference's
``DefaultStoreLoadTracker``); here a simple read-counter delta check.
"""

from __future__ import annotations

import logging
from typing import List

from alluxio_tpu_torch.heartbeat import HeartbeatExecutor
from alluxio_tpu_torch.metrics import metrics
from alluxio_tpu_torch.worker.tiered_store import TieredBlockStore

LOG = logging.getLogger(__name__)


class StoreLoadTracker:
    """Backs off management work while clients are actively reading."""

    def __init__(self, store: TieredBlockStore) -> None:
        self._store = store
        self._last_access_count = 0

    def is_idle(self) -> bool:
        current = metrics().counter("Worker.BlocksAccessed").count
        idle = current == self._last_access_count
        self._last_access_count = current
        return idle


class AlignTask:
    """Reference: ``management/tier/AlignTask.java:53``."""

    def __init__(self, store: TieredBlockStore, swaps_per_run: int = 16) -> None:
        self._store = store
        self._swaps = swaps_per_run

    def run(self) -> int:
        moved = 0
        meta = self._store.meta
        ann = self._store.annotator
        for upper in meta.tiers[:-1]:
            lower = meta.tiers[upper.ordinal + 1]
            upper_blocks = [b for d in upper.dirs for b in d.block_ids()]
            lower_blocks = [b for d in lower.dirs for b in d.block_ids()]
            if not upper_blocks or not lower_blocks:
                continue
            cold_up = ann.sorted_blocks(upper_blocks)          # coldest first
            hot_down = ann.sorted_blocks(lower_blocks, reverse=True)
            for cold, hot in zip(cold_up, hot_down):
                if moved >= self._swaps:
                    return moved
                cv, hv = ann.value(cold), ann.value(hot)
                if cv is None or hv is None or hv <= cv:
                    break  # ordering aligned
                try:
                    self._store.move_block(cold, lower.alias)
                    self._store.move_block(hot, upper.alias)
                    moved += 2
                except Exception:  # noqa: BLE001 - busy blocks retry next tick
                    LOG.debug("tier-align move skipped", exc_info=True)
                    continue
        return moved


class PromoteTask:
    """Reference: ``management/tier/PromoteTask.java:51``."""

    def __init__(self, store: TieredBlockStore, quota_percent: int = 90,
                 moves_per_run: int = 16) -> None:
        self._store = store
        self._quota = quota_percent
        self._moves = moves_per_run

    def run(self) -> int:
        moved = 0
        meta = self._store.meta
        ann = self._store.annotator
        for upper in meta.tiers[:-1]:
            lower = meta.tiers[upper.ordinal + 1]
            lower_blocks = [b for d in lower.dirs for b in d.block_ids()]
            for hot in ann.sorted_blocks(lower_blocks, reverse=True):
                if moved >= self._moves:
                    return moved
                used_pct = (100 * upper.used_bytes // upper.capacity_bytes
                            if upper.capacity_bytes else 100)
                if used_pct >= self._quota:
                    break
                try:
                    self._store.move_block(hot, upper.alias)
                    moved += 1
                except Exception:  # noqa: BLE001 - busy/full: retry next tick
                    LOG.debug("tier-promote move skipped", exc_info=True)
                    break
        return moved


class WatermarkRestoreTask:
    """Free tiers above their high watermark down to the low watermark."""

    def __init__(self, store: TieredBlockStore, high: float = 0.95,
                 low: float = 0.7) -> None:
        self._store = store
        self._high = high
        self._low = low

    def run(self) -> int:
        freed = 0
        for tier in self._store.meta.tiers:
            cap = tier.capacity_bytes
            if cap and tier.used_bytes > self._high * cap:
                target = int(tier.used_bytes - self._low * cap)
                freed += self._store.free_space(tier.alias, target)
        return freed


class ManagementTaskCoordinator(HeartbeatExecutor):
    """One heartbeat driving the task set, load-aware
    (reference: ``ManagementTaskCoordinator.java:37``)."""

    def __init__(self, store: TieredBlockStore, *, align: bool = True,
                 promote: bool = True, quota_percent: int = 90,
                 high_watermark: float = 0.95, low_watermark: float = 0.7):
        self._tracker = StoreLoadTracker(store)
        self._tasks: List = [WatermarkRestoreTask(store, high_watermark,
                                                  low_watermark)]
        if align:
            self._tasks.append(AlignTask(store))
        if promote:
            self._tasks.append(PromoteTask(store, quota_percent))

    def heartbeat(self) -> None:
        if not self._tracker.is_idle():
            return  # back off under load
        for task in self._tasks:
            try:
                task.run()
            except Exception:  # noqa: BLE001
                LOG.exception("management task %s failed", type(task).__name__)
