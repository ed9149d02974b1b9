"""Prefetch scheduler: lookahead window -> tier-placement plans.

A copy of ``alluxio_tpu/prefetch/scheduler.py`` on the port's metrics
registry (same metric names). Walks the oracle's exact future-access
window in deadline order and decides, per block, where it should be
resident before the consumer arrives: the device tier (an
``hbm_fraction`` slice of the byte budget), DRAM (worker tier), or skip
(budget exhausted — backpressure). Issued and ready-but-unconsumed bytes
count against the budget, so the planner can never run away from a slow
consumer. Every consume is classified — **hit** (resident before the
read), **late** (planned and in flight, but the consumer got there
first), **miss** (never planned) — and late reads record their
block-ready stall so p50/p99 lateness is observable.
"""

from __future__ import annotations

import threading
import time
import weakref
from dataclasses import dataclass
from typing import Dict, List, Optional

from alluxio_tpu_torch.metrics import metrics
from alluxio_tpu_torch.prefetch.oracle import AccessOracle, BlockRef

TIER_HBM = "HBM"
TIER_DRAM = "DRAM"

OUTCOME_HIT = "hit"
OUTCOME_LATE = "late"
OUTCOME_MISS = "miss"
#: consume from a superseded epoch generation: ignored by accounting
OUTCOME_STALE = "stale"


#: live schedulers in this process — the registry gauges below sum over
#: this set, so two services in one process both stay observable
_LIVE_SCHEDULERS: "weakref.WeakSet" = weakref.WeakSet()


def retune_budget(budget_bytes: "Optional[int]") -> int:
    """Apply a byte budget to every live scheduler in this process
    (``None`` restores each scheduler's own configured budget). Returns
    how many schedulers were retuned. The device/DRAM split ratio each
    scheduler was built with is preserved."""
    n = 0
    for s in list(_LIVE_SCHEDULERS):
        s.set_budget(budget_bytes)
        n += 1
    return n


def _register_gauges() -> None:
    """(Re-)register the process-wide prefetch gauges. Idempotent: the
    registered functions read the live set."""
    m = metrics()
    m.register_gauge(
        "Client.PrefetchInflightBytes",
        lambda: float(sum(s.held_bytes(TIER_DRAM) + s.held_bytes(TIER_HBM)
                          for s in list(_LIVE_SCHEDULERS))))
    m.register_gauge(
        "Client.PrefetchReadyBlocks",
        lambda: float(sum(s.ready_count()
                          for s in list(_LIVE_SCHEDULERS))))


@dataclass
class PlacementAction:
    """One planned placement: make ``ref`` resident in ``tier`` before
    the consumer's cursor reaches global sequence ``deadline_seq``."""

    ref: BlockRef
    tier: str
    deadline_seq: int


class PrefetchScheduler:
    """Budgeted placement planning + outcome accounting for one consumer.

    Thread-safe: the agent heartbeat calls :meth:`plan` /
    :meth:`on_loaded` while the loader's producer thread calls
    :meth:`on_consume`.
    """

    def __init__(self, oracle: AccessOracle, *, lookahead_blocks: int,
                 budget_bytes: int, hbm_fraction: float = 0.0,
                 retry_backoff_s: float = 0.5) -> None:
        if not 0.0 <= hbm_fraction <= 1.0:
            raise ValueError(f"hbm_fraction {hbm_fraction} not in [0, 1]")
        self._oracle = oracle
        self._lookahead = max(1, lookahead_blocks)
        self._budget = max(0, budget_bytes)
        self._hbm_budget = int(self._budget * hbm_fraction)
        #: what was configured, kept so set_budget(None) can restore it
        self._configured_budget = self._budget
        self._hbm_fraction = hbm_fraction
        self._retry_backoff_s = retry_backoff_s
        self._lock = threading.Lock()
        # consumer cursor (epoch, position within the host's sequence)
        self._epoch = 0
        self._pos = 0
        self._generation = 0
        #: issued, load not yet observed complete
        self._inflight: Dict[int, PlacementAction] = {}
        #: load complete, not yet consumed
        self._ready: Dict[int, PlacementAction] = {}
        #: bytes held against the budget per tier class
        self._held = {TIER_HBM: 0, TIER_DRAM: 0}
        #: failure cooldowns: block_id -> (consecutive fails, earliest
        #: replan time) — a permanently-failing placement must not be
        #: replanned every tick
        self._retry: Dict[int, tuple] = {}
        # instance-local tallies: the registry counters are process-wide,
        # so stats() must not read them back
        self._n = {"hits": 0, "late": 0, "misses": 0,
                   "late_arrivals": 0}
        m = metrics()
        self._hits = m.counter("Client.PrefetchHits")
        self._late = m.counter("Client.PrefetchLate")
        self._miss = m.counter("Client.PrefetchMisses")
        self._late_arrivals = m.counter("Client.PrefetchLateArrivals")
        self._ready_timer = m.timer("Client.PrefetchBlockReady")
        # weak registration: the registry has no deregistration
        _LIVE_SCHEDULERS.add(self)
        _register_gauges()

    # -- retuning -----------------------------------------------------------
    def set_budget(self, budget_bytes: "Optional[int]") -> None:
        """Live byte-budget retune (``None`` restores the configured
        value). Held bytes are untouched — a shrink simply stops
        admitting new placements until consumes drain below it."""
        with self._lock:
            self._budget = self._configured_budget \
                if budget_bytes is None else max(0, int(budget_bytes))
            self._hbm_budget = int(self._budget * self._hbm_fraction)

    # -- cursor -------------------------------------------------------------
    def begin_epoch(self, epoch: int) -> int:
        """Consumer starts (or restarts) an epoch; cursor rewinds to its
        head. Residency state survives. Returns a generation token: a
        superseded epoch's producer may still be mid-consume when a new
        epoch rewinds the cursor, and its last ``on_consume`` must not
        advance the NEW epoch's cursor — stale tokens are fenced off."""
        with self._lock:
            self._epoch = int(epoch)
            self._pos = 0
            self._generation += 1
            return self._generation

    def cursor(self) -> "tuple[int, int]":
        with self._lock:
            return self._epoch, self._pos

    # -- planning -----------------------------------------------------------
    def plan(self) -> List[PlacementAction]:
        """Next placements in deadline order, newest-deadline last, under
        the byte budget. Empty when the window is fully planned or the
        budget is saturated (backpressure)."""
        out: List[PlacementAction] = []
        now = time.monotonic()
        with self._lock:
            window = self._oracle.window(self._epoch, self._pos,
                                         self._lookahead)
            seen = set()
            for seq, ref in window:
                bid = ref.block_id
                if bid in seen or bid in self._inflight or \
                        bid in self._ready:
                    continue
                seen.add(bid)
                retry = self._retry.get(bid)
                if retry is not None and now < retry[1]:
                    continue  # failure cooldown: skip, plan the rest
                tier = self._admit(ref)
                if tier is None:
                    break  # budget saturated: nearer deadlines first
                action = PlacementAction(ref=ref, tier=tier,
                                         deadline_seq=seq)
                self._inflight[bid] = action
                self._held[tier] += ref.length
                out.append(action)
        return out

    def _admit(self, ref: BlockRef) -> Optional[str]:
        """Tier for ``ref`` under the split budget: the device tier while
        its slice has room, then DRAM, else nothing."""
        if self._held[TIER_HBM] + ref.length <= self._hbm_budget:
            return TIER_HBM
        dram_budget = self._budget - self._hbm_budget
        if self._held[TIER_DRAM] + ref.length <= dram_budget:
            return TIER_DRAM
        return None

    # -- agent callbacks ----------------------------------------------------
    def on_loaded(self, block_id: int) -> None:
        """The agent observed the placement complete (block resident)."""
        with self._lock:
            self._retry.pop(block_id, None)
            action = self._inflight.pop(block_id, None)
            if action is None:
                return
            self._ready[block_id] = action
            if self._oracle.global_seq(self._epoch, self._pos) > \
                    action.deadline_seq:
                # landed after its deadline passed: the consume already
                # went through as late/miss, but keep the arrival visible
                self._n["late_arrivals"] += 1
                self._late_arrivals.inc()

    def on_load_failed(self, block_id: int) -> None:
        """Placement failed: release the budget and back off
        exponentially before replanning the block."""
        with self._lock:
            action = self._inflight.pop(block_id, None)
            if action is not None:
                self._held[action.tier] -= action.ref.length
            fails = self._retry.get(block_id, (0, 0.0))[0] + 1
            backoff = min(30.0,
                          self._retry_backoff_s * (2 ** (fails - 1)))
            self._retry[block_id] = (fails,
                                     time.monotonic() + backoff)

    def on_evicted(self, block_id: int) -> None:
        """Residency lost before consumption: the block is no longer a
        guaranteed hit."""
        with self._lock:
            action = self._ready.pop(block_id, None)
            if action is not None:
                self._held[action.tier] -= action.ref.length

    # -- consumer callbacks -------------------------------------------------
    def on_consume(self, ref: BlockRef, *,
                   resident_hint: bool = False,
                   generation: Optional[int] = None) -> str:
        """Classify one consume and advance the cursor. The placement's
        budget hold is released. A consume carrying a superseded
        generation token is ignored (OUTCOME_STALE) — no cursor movement,
        no counters."""
        with self._lock:
            if generation is not None and \
                    generation != self._generation:
                return OUTCOME_STALE
            bid = ref.block_id
            action = self._ready.pop(bid, None)
            if action is not None:
                self._held[action.tier] -= action.ref.length
                outcome = OUTCOME_HIT
            elif resident_hint:
                # resident through a path the scheduler didn't drive
                # (e.g. device-tier retention from a previous epoch)
                outcome = OUTCOME_HIT
            elif bid in self._inflight:
                outcome = OUTCOME_LATE
                # leave the in-flight hold: on_loaded will move it to
                # ready and a later epoch can still hit it
            else:
                outcome = OUTCOME_MISS
            self._pos += 1
            if self._pos >= self._oracle.epoch_len():
                self._epoch, self._pos = self._epoch + 1, 0
            key = {OUTCOME_HIT: "hits", OUTCOME_LATE: "late",
                   OUTCOME_MISS: "misses"}[outcome]
            self._n[key] += 1
        if outcome == OUTCOME_HIT:
            self._hits.inc()
            self._ready_timer.update(0.0)
        elif outcome == OUTCOME_LATE:
            self._late.inc()
        else:
            self._miss.inc()
        return outcome

    def record_stall(self, seconds: float) -> None:
        """Block-ready stall of a late/miss consume (how long the
        consumer waited for data that should already have been there)."""
        self._ready_timer.update(max(0.0, seconds))

    # -- introspection ------------------------------------------------------
    def held_bytes(self, tier: str) -> int:
        with self._lock:
            return self._held[tier]

    def is_ready(self, block_id: int) -> bool:
        with self._lock:
            return block_id in self._ready

    def ready_count(self) -> int:
        with self._lock:
            return len(self._ready)

    def inflight_count(self) -> int:
        with self._lock:
            return len(self._inflight)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            held = dict(self._held)
            ready, inflight = len(self._ready), len(self._inflight)
            epoch, pos = self._epoch, self._pos
            n = dict(self._n)
        total = n["hits"] + n["late"] + n["misses"]
        return {
            "epoch": epoch, "pos": pos,
            "ready_blocks": ready, "inflight_blocks": inflight,
            "held_hbm_bytes": held[TIER_HBM],
            "held_dram_bytes": held[TIER_DRAM],
            "hits": n["hits"], "late": n["late"],
            "misses": n["misses"],
            "late_arrivals": n["late_arrivals"],
            "hit_rate": (n["hits"] / total) if total else 0.0,
        }
