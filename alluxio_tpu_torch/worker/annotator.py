"""Eviction-order annotators: LRU and LRFU.

A copy of ``alluxio_tpu/worker/annotator.py``.

Re-design of ``core/server/worker/.../block/annotator/{BlockAnnotator,
LRUAnnotator.java:27,LRFUAnnotator.java:29,DefaultBlockIterator,
SortedBlockSet}.java``: each cached block carries an online-maintained sort
value; eviction iterates blocks in ascending value (coldest first), tier
management iterates descending (hottest first) for promotion.

LRFU follows the reference's CRF recurrence: on access
``crf = 1 + crf * attenuation^(-step * (clock - last_clock))`` with a
logical clock ticked per access.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional


class BlockAnnotator:
    """Tracks per-block sort values; thread-safe."""

    def __init__(self) -> None:
        self._values: Dict[int, float] = {}
        self._lock = threading.Lock()

    def on_access(self, block_id: int) -> None:
        raise NotImplementedError

    def on_commit(self, block_id: int) -> None:
        self.on_access(block_id)

    def on_remove(self, block_id: int) -> None:
        with self._lock:
            self._values.pop(block_id, None)

    def sorted_blocks(self, block_ids: List[int],
                      reverse: bool = False) -> List[int]:
        """Blocks in eviction order (coldest first); unknown ids coldest."""
        with self._lock:
            vals = {bid: self._values.get(bid, float("-inf"))
                    for bid in block_ids}
        return sorted(block_ids, key=lambda b: vals[b], reverse=reverse)

    def value(self, block_id: int) -> Optional[float]:
        with self._lock:
            return self._values.get(block_id)

    @staticmethod
    def create(kind: str, **kwargs) -> "BlockAnnotator":
        k = kind.upper()
        if k == "LRU":
            return LRUAnnotator()
        if k == "LRFU":
            return LRFUAnnotator(**kwargs)
        raise ValueError(f"unknown annotator {kind}")


class LRUAnnotator(BlockAnnotator):
    """Sort value = logical access clock (reference: ``LRUAnnotator.java:27``)."""

    def __init__(self) -> None:
        super().__init__()
        self._clock = 0

    def on_access(self, block_id: int) -> None:
        with self._lock:
            self._clock += 1
            self._values[block_id] = float(self._clock)


class LRFUAnnotator(BlockAnnotator):
    """CRF-decayed frequency+recency (reference: ``LRFUAnnotator.java:29``)."""

    def __init__(self, step_factor: float = 0.25,
                 attenuation_factor: float = 2.0) -> None:
        super().__init__()
        self._step = step_factor
        self._att = attenuation_factor
        self._clock = 0
        self._last_clock: Dict[int, int] = {}

    def on_access(self, block_id: int) -> None:
        with self._lock:
            self._clock += 1
            last_crf = self._values.get(block_id, 0.0)
            last_clock = self._last_clock.get(block_id, self._clock)
            decay = self._att ** (-self._step * (self._clock - last_clock))
            self._values[block_id] = 1.0 + last_crf * decay
            self._last_clock[block_id] = self._clock

    def on_remove(self, block_id: int) -> None:
        super().on_remove(block_id)
        with self._lock:
            self._last_clock.pop(block_id, None)
