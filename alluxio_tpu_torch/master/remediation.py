"""Self-healing remediation engine: bounded, audited actions on alerts (a
copy of ``alluxio_tpu/master/remediation.py``).

The health engine (:mod:`alluxio_tpu_torch.master.health`) diagnoses; this
module closes the loop.  It subscribes to the monitor's firing alerts
and executes a small catalog of **bounded** actions:

- **quarantine** — a worker flagged by the heartbeat-staleness or
  read-latency-p99-regression rule stops receiving new block
  placements and prefetch targets (the block master's placement
  listing filters it); released automatically after the alert
  resolves and a probation period passes;
- **hot-block re-replication** — a p99-regressed worker's hottest
  blocks (its top-tier residents) get one extra replica through the
  replication checker / job service, so reads drain away from the
  straggler without waiting for it to die;
- **adaptive retuning** — sustained hedge-win-rate or input-stall
  alerts push new hedge-quantile / stripe-concurrency /
  prefetch-byte-budget values to clients as a config overlay
  piggybacked on the metrics-heartbeat response, reverting when the
  alert clears.

Safety is the design center, not an afterthought: every action obeys a
per-(kind, subject) **cooldown** and a sliding-window **action cap**;
``dry.run`` audits what would happen without doing any of it; and
every action — including every *suppressed* one — lands in a bounded
audit ring, a trace span, and ``Master.Remediation*`` metrics-history
series, so ``fsadmin report health`` can render the full
cause → action → resolution timeline.  With
``atpu.master.remediation.enabled=false`` (the default) the engine is
never constructed and the cluster behaves exactly as before.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

LOG = logging.getLogger(__name__)

ACTION_QUARANTINE = "quarantine"
ACTION_REREPLICATE = "re-replicate"
ACTION_RETUNE = "retune"
ACTION_RELEASE = "release"
ACTION_REVERT = "revert"

#: rules whose worker subject gets quarantined
QUARANTINE_RULES = ("heartbeat-staleness", "read-latency-p99-regression")
#: rules whose worker subject gets its hot blocks re-replicated
REREPLICATE_RULES = ("read-latency-p99-regression",)

#: conf keys the retuning overlay may push (the client clamps again on
#: its side — a wild master cannot push a client off a cliff)
OVERLAY_HEDGE_QUANTILE = "atpu.user.remote.read.hedge.quantile"
OVERLAY_REMOTE_CONCURRENCY = "atpu.user.remote.read.concurrency"
OVERLAY_PREFETCH_BUDGET = "atpu.prefetch.budget.bytes"


@dataclasses.dataclass
class AuditRecord:
    """One row of the cause → action → resolution timeline."""

    id: int
    at: float
    action: str           # quarantine | re-replicate | retune | release | revert
    rule: str             # the alert rule that caused it
    subject: str          # the alert subject it acted on
    outcome: str          # executed | dry-run | suppressed-cap |
    #                       suppressed-cooldown | skipped | failed
    summary: str
    detail: dict = dataclasses.field(default_factory=dict)
    #: when the triggering alert stopped firing (None while it burns)
    resolved_at: Optional[float] = None
    #: when the action was undone (quarantine released / overlay
    #: reverted); one-shot actions (re-replication) never set it
    reverted_at: Optional[float] = None

    def to_wire(self) -> dict:
        return dataclasses.asdict(self)


class _Active:
    """A reversible action currently in force (quarantine / overlay)."""

    __slots__ = ("record", "holders", "probation_since", "worker_id")

    def __init__(self, record: AuditRecord, holders: set,
                 worker_id: Optional[int] = None) -> None:
        self.record = record
        #: (rule, subject) alert keys keeping the action in force
        self.holders = holders
        #: first evaluation that saw every holder resolved
        self.probation_since: Optional[float] = None
        self.worker_id = worker_id


class RemediationEngine:
    """Subscribes to :class:`HealthMonitor` evaluations and acts.

    ``block_master`` is duck-typed (quarantine_worker / release_worker /
    get_worker_infos / get_worker) so benches and unit tests can drive
    the engine against a stub on a fake clock.
    """

    AUDIT_CAPACITY = 256

    def __init__(self, block_master, *, metrics_master=None,
                 dry_run: bool = False,
                 max_actions_per_window: int = 4,
                 window_s: float = 600.0,
                 cooldown_s: float = 300.0,
                 probation_s: float = 60.0,
                 rereplicate_blocks: int = 8,
                 quarantine_max_fraction: float = 0.5,
                 hedge_quantile_base: float = 0.95,
                 remote_concurrency_base: int = 4,
                 prefetch_budget_base: int = 256 << 20,
                 clock: Callable[[], float] = time.time,
                 registry=None) -> None:
        self._bm = block_master
        self._mm = metrics_master
        self.dry_run = bool(dry_run)
        self.max_actions_per_window = max(0, int(max_actions_per_window))
        self.window_s = float(window_s)
        self.cooldown_s = float(cooldown_s)
        self.probation_s = float(probation_s)
        self.rereplicate_blocks = max(1, int(rereplicate_blocks))
        self.quarantine_max_fraction = min(
            1.0, max(0.0, float(quarantine_max_fraction)))
        self._bases = {
            OVERLAY_HEDGE_QUANTILE: float(hedge_quantile_base),
            OVERLAY_REMOTE_CONCURRENCY: int(remote_concurrency_base),
            OVERLAY_PREFETCH_BUDGET: int(prefetch_budget_base),
        }
        self._clock = clock
        self._replication = None
        self._lock = threading.Lock()
        self._audit: deque = deque(maxlen=self.AUDIT_CAPACITY)
        self._next_id = 1
        #: executed/dry-run action timestamps inside the cap window
        self._window: deque = deque()
        #: (kind, subject) -> last attempt ts (cooldown anchor)
        self._last_attempt: Dict[Tuple[str, str], float] = {}
        #: (kind, subject, reason) -> ts of the last suppression we
        #: audited — one audit row per suppression episode, not one per
        #: evaluation tick
        self._suppression_logged: Dict[Tuple[str, str, str], float] = {}
        #: reversible actions in force
        self._active: Dict[Tuple[str, str], _Active] = {}
        #: the pushed overlay, rebuilt on change; heartbeat handlers
        #: read the reference without taking the engine lock
        self._overlay_wire: Dict[str, object] = {}
        self.overlay_version = 0
        #: history sampling is change-driven with a periodic keepalive:
        #: ingesting 4 series on EVERY health tick costs more than the
        #: whole idle remediation pass (measured ~40us vs ~20us) and
        #: would blow the <2% tick budget bench-selfheal gates
        self._history_dirty = True
        self._last_history_sample = float("-inf")
        self.HISTORY_KEEPALIVE_S = 300.0
        if registry is None:
            from alluxio_tpu_torch.metrics import metrics

            registry = metrics()
        self._c_actions = registry.counter("Master.RemediationActions")
        self._c_dry = registry.counter("Master.RemediationDryRun")
        self._c_suppressed = registry.counter(
            "Master.RemediationSuppressed")
        self._c_failed = registry.counter("Master.RemediationFailed")
        registry.register_gauge(
            "Master.RemediationQuarantined",
            lambda: float(sum(1 for k in self._active
                              if k[0] == ACTION_QUARANTINE)))
        registry.register_gauge(
            "Master.RemediationOverlayKeys",
            lambda: float(len(self._overlay_wire)))

    # ----------------------------------------------------------- wiring
    def bind_replication(self, checker) -> None:
        """Late-bound like the replication heartbeat itself: the job
        service boots after the metadata master."""
        self._replication = checker

    def heartbeat_overlay(self) -> Tuple[Dict[str, object], int]:
        """(overlay, version) for the metrics-heartbeat response; lock-
        free — the dict reference is swapped atomically on change."""
        return self._overlay_wire, self.overlay_version

    # ------------------------------------------------------------- tick
    def on_alerts(self, alerts: List, now: Optional[float] = None) -> None:
        """One remediation pass over the monitor's firing alerts —
        registered as a HealthMonitor alert listener, so it runs right
        after every evaluation with that evaluation's timestamp."""
        ts = self._clock() if now is None else now
        if not alerts and not self._active:
            # quiet cluster: keep the tick tax near zero (no span —
            # nothing to trace), but still sweep bookkeeping and emit
            # the keepalive history sample
            with self._lock:
                self._prune_window(ts)
                self._sample_history(ts)
            return
        import contextlib

        from alluxio_tpu_torch.utils.tracing import tracer

        t = tracer()
        span = t.span("atpu.master.remediation.evaluate") if t.enabled \
            else contextlib.nullcontext()
        with span, self._lock:
            self._prune_window(ts)
            firing = {(a.rule, a.subject) for a in alerts}
            for a in alerts:
                self._consider(a, ts)
            self._sweep_resolved(firing, ts)
            self._sample_history(ts)

    # --------------------------------------------------------- decisions
    def _consider(self, alert, now: float) -> None:
        subject = alert.subject
        if alert.rule in QUARANTINE_RULES and \
                subject.startswith("worker-"):
            key = (ACTION_QUARANTINE, subject)
            active = self._active.get(key)
            if active is not None:
                active.holders.add((alert.rule, subject))
                active.probation_since = None
            elif not self._cooling(ACTION_QUARANTINE, alert.rule,
                                   subject, now):
                self._attempt(
                    ACTION_QUARANTINE, alert.rule, subject, now,
                    lambda: self._do_quarantine(subject),
                    f"stop placing new blocks / prefetch targets on "
                    f"{subject}",
                    reversible=True)
        if alert.rule in REREPLICATE_RULES and \
                subject.startswith("worker-") and \
                not self._cooling(ACTION_REREPLICATE, alert.rule,
                                  subject, now):
            self._attempt(
                ACTION_REREPLICATE, alert.rule, subject, now,
                lambda: self._do_rereplicate(subject),
                f"re-replicate the hottest blocks off {subject}")
        retune = self._retune_for(alert.rule)
        if retune:
            key = (ACTION_RETUNE, alert.rule)
            active = self._active.get(key)
            if active is not None:
                active.holders.add((alert.rule, subject))
                active.probation_since = None
            elif not self._cooling(ACTION_RETUNE, alert.rule, subject,
                                   now):
                self._attempt(
                    ACTION_RETUNE, alert.rule, subject, now,
                    lambda: self._do_retune(retune),
                    "push client tuning overlay "
                    + ", ".join(f"{k}={v}" for k, v in retune.items()),
                    reversible=True, active_key=key,
                    detail={"overlay": dict(retune)})

    def _retune_for(self, rule: str) -> Dict[str, object]:
        """The overlay one rule's firing asks for — values derived from
        the master's conf defaults, clamped again client-side."""
        if rule == "hedge-win-rate-spike":
            # hedges keep beating the primary: hedge EARLIER so reads
            # stop waiting out the straggler's tail
            base = self._bases[OVERLAY_HEDGE_QUANTILE]
            return {OVERLAY_HEDGE_QUANTILE:
                    round(max(0.5, base * 0.8), 3)}
        if rule == "input-stall-sustained":
            # loaders starve: widen the pipes and the prefetch horizon
            return {
                OVERLAY_PREFETCH_BUDGET:
                    int(self._bases[OVERLAY_PREFETCH_BUDGET]) * 2,
                OVERLAY_REMOTE_CONCURRENCY:
                    min(16, int(
                        self._bases[OVERLAY_REMOTE_CONCURRENCY]) * 2),
            }
        return {}

    # -------------------------------------------------- attempt pipeline
    def _attempt(self, kind: str, rule: str, subject: str, now: float,
                 execute: Callable[[], dict], summary: str, *,
                 reversible: bool = False,
                 active_key: Optional[Tuple[str, str]] = None,
                 detail: Optional[dict] = None) -> None:
        """Cap -> dry-run -> execute, auditing each gate (the cooldown
        gate runs in :meth:`_cooling` BEFORE the call sites build
        summaries and closures — it is the hot per-tick path while an
        alert burns).  Suppressions are audited once per episode."""
        cd_key = (kind, subject)
        if len(self._window) >= self.max_actions_per_window:
            self._suppress(kind, rule, subject, now, "suppressed-cap",
                           summary, self.window_s)
            return
        self._last_attempt[cd_key] = now
        self._window.append(now)
        if self.dry_run:
            record = self._audit_row(kind, rule, subject, now, "dry-run",
                                     summary, detail or {})
            self._c_dry.inc()
        else:
            # tracer().span, NOT utils.tracing.annotate: annotate also
            # opens a torch.profiler.record_function (its first use
            # imports torch), and a master control loop has no device
            # timeline to stamp
            from alluxio_tpu_torch.utils.tracing import tracer

            try:
                with tracer().span(f"atpu.master.remediation.{kind}"):
                    result = execute()
            except Exception as e:  # noqa: BLE001 - an unhealable
                # subject (worker vanished mid-decision, job service
                # down) must not take the health heartbeat with it
                record = self._audit_row(
                    kind, rule, subject, now, "failed", summary,
                    {**(detail or {}), "error": str(e)})
                self._c_failed.inc()
                LOG.warning("remediation %s on %s failed", kind, subject,
                            exc_info=True)
                return
            outcome = result.pop("outcome", "executed")
            record = self._audit_row(kind, rule, subject, now, outcome,
                                     summary, {**(detail or {}), **result})
            if outcome == "executed":
                self._c_actions.inc()
            elif reversible:
                # a skipped reversible action (healthy-capacity floor,
                # no job service) is NOT in force: tracking it active
                # would later "release" something never applied
                return
        if reversible:
            key = active_key or (kind, subject)
            self._active[key] = _Active(
                record, {(rule, subject)},
                worker_id=record.detail.get("worker_id"))

    def _cooling(self, kind: str, rule: str, subject: str,
                 now: float) -> bool:
        """Cooldown gate, prechecked before any attempt machinery runs
        (the hot per-tick path while an alert burns).  The suppression
        is audited and counted once per episode — one row per denied
        episode reads like a decision; one per tick reads like a log
        flood."""
        last = self._last_attempt.get((kind, subject))
        if last is None or now - last >= self.cooldown_s:
            return False
        self._suppress(kind, rule, subject, now, "suppressed-cooldown",
                       f"{kind} on {subject} held by cooldown "
                       f"({self.cooldown_s:.0f}s)", self.cooldown_s)
        return True

    def _suppress(self, kind: str, rule: str, subject: str, now: float,
                  reason: str, summary: str, episode_s: float) -> None:
        log_key = (kind, subject, reason)
        last = self._suppression_logged.get(log_key)
        if last is not None and now - last < episode_s:
            return  # already audited+counted this suppression episode
        self._c_suppressed.inc()
        self._suppression_logged[log_key] = now
        self._audit_row(kind, rule, subject, now, reason, summary, {})

    def _audit_row(self, kind: str, rule: str, subject: str, now: float,
                   outcome: str, summary: str, detail: dict
                   ) -> AuditRecord:
        record = AuditRecord(id=self._next_id, at=now, action=kind,
                             rule=rule, subject=subject, outcome=outcome,
                             summary=summary, detail=detail)
        self._next_id += 1
        self._audit.append(record)
        self._history_dirty = True
        return record

    # --------------------------------------------------------- execution
    def _worker_id_for(self, source: str) -> Optional[int]:
        lookup = getattr(self._bm, "worker_id_for_source", None)
        if lookup is not None:
            return lookup(source)
        # duck-typed stub without the O(1) index: scan the listing
        for w in self._bm.get_worker_infos(include_quarantined=True):
            if f"worker-{w.address.host}:{w.address.rpc_port}" == source:
                return w.id
        return None

    def _do_quarantine(self, source: str) -> dict:
        wid = self._worker_id_for(source)
        if wid is None:
            raise LookupError(f"no registered worker matches {source}")
        # healthy-capacity floor: a systemic condition that flags the
        # whole fleet (e.g. a switch melting every worker's heartbeats)
        # must not let the engine empty the placement set — that would
        # amplify the outage it is meant to contain
        workers = self._bm.get_worker_infos(include_quarantined=True)
        qw = getattr(self._bm, "quarantined_workers", None)
        quarantined = len(qw()) if qw is not None else sum(
            1 for w in workers
            if getattr(w, "state", "") == "QUARANTINED")
        limit = max(1, int(self.quarantine_max_fraction * len(workers)))
        if quarantined + 1 > limit:
            return {"outcome": "skipped",
                    "reason": f"healthy-capacity floor: {quarantined} of "
                              f"{len(workers)} already quarantined "
                              f"(max {limit})",
                    "worker_id": wid}
        if not self._bm.quarantine_worker(wid):
            raise LookupError(f"worker {wid} vanished before quarantine")
        return {"worker_id": wid}

    def _do_rereplicate(self, source: str) -> dict:
        if self._replication is None:
            return {"outcome": "skipped",
                    "reason": "no job service attached"}
        wid = self._worker_id_for(source)
        info = self._bm.get_worker(wid) if wid is not None else None
        if info is None:
            raise LookupError(f"no registered worker matches {source}")
        # capacity_bytes_on_tiers is reference-swapped (never mutated
        # in place) so reading it is safe; blocks IS mutated in place
        # by worker heartbeats — take the block master's locked copy
        snapshot = getattr(self._bm, "worker_resident_blocks", None)
        blocks = snapshot(wid) if snapshot is not None \
            else dict(info.blocks)
        if blocks is None:
            raise LookupError(f"{source} vanished before re-replication")
        # "hottest" = resident in the worker's fastest tier: the
        # annotator promotes what is actually read, so top-tier
        # residency is the system's own heat signal
        top = next(iter(info.capacity_bytes_on_tiers), None)
        hot = [bid for bid, tier in blocks.items() if tier == top]
        hot = hot[:self.rereplicate_blocks]
        if not hot:
            return {"outcome": "skipped", "reason": "no resident blocks",
                    "worker_id": wid}
        launched = self._replication.request_replication(hot, replicas=1)
        return {"worker_id": wid, "blocks": launched,
                "requested": len(hot)}

    def _do_retune(self, overlay: Dict[str, object]) -> dict:
        merged = dict(self._overlay_wire)
        merged.update(overlay)
        self._overlay_wire = merged
        self.overlay_version += 1
        return {"overlay_version": self.overlay_version}

    # -------------------------------------------------------- resolution
    def _sweep_resolved(self, firing: set, now: float) -> None:
        for key in list(self._active):
            active = self._active[key]
            active.holders &= firing
            if active.holders:
                continue
            if active.probation_since is None:
                active.probation_since = now
                active.record.resolved_at = active.record.resolved_at \
                    or now
            if now - active.probation_since < self.probation_s:
                continue
            kind, subject = key
            try:
                self._undo(kind, subject, active, now)
            except Exception:  # noqa: BLE001 - release must not wedge
                LOG.warning("remediation undo %s on %s failed", kind,
                            subject, exc_info=True)
            del self._active[key]

    def _undo(self, kind: str, subject: str, active: _Active,
              now: float) -> None:
        active.record.reverted_at = now
        if kind == ACTION_QUARANTINE:
            released = False
            if not self.dry_run and active.worker_id is not None:
                released = self._bm.release_worker(active.worker_id)
            self._audit_row(
                ACTION_RELEASE, active.record.rule, subject, now,
                "dry-run" if self.dry_run else "executed",
                f"probation passed: {subject} back in the placement set",
                {"worker_id": active.worker_id, "released": released,
                 "acted_id": active.record.id})
        elif kind == ACTION_RETUNE:
            # drop this action's keys from the pushed overlay
            dropped = list((active.record.detail.get("overlay") or {}))
            merged = {k: v for k, v in self._overlay_wire.items()
                      if k not in dropped}
            self._overlay_wire = merged
            self.overlay_version += 1
            self._audit_row(
                ACTION_REVERT, active.record.rule, subject, now,
                "dry-run" if self.dry_run else "executed",
                "alert cleared: tuning overlay withdrawn "
                + ", ".join(dropped),
                {"overlay_version": self.overlay_version,
                 "acted_id": active.record.id})

    # -------------------------------------------------------- accounting
    def _prune_window(self, now: float) -> None:
        while self._window and now - self._window[0] > self.window_s:
            self._window.popleft()
        if len(self._suppression_logged) > 4 * self.AUDIT_CAPACITY:
            # bounded even if subjects churn forever
            self._suppression_logged.clear()

    def _sample_history(self, now: float) -> None:
        history = getattr(self._mm, "history", None)
        if history is None:
            return
        if not self._history_dirty and \
                now - self._last_history_sample < self.HISTORY_KEEPALIVE_S:
            return
        self._history_dirty = False
        self._last_history_sample = now
        history.ingest("master", {
            "Master.RemediationActions": float(self._c_actions.count),
            "Master.RemediationSuppressed":
                float(self._c_suppressed.count),
            "Master.RemediationQuarantined":
                float(sum(1 for k in self._active
                          if k[0] == ACTION_QUARANTINE)),
            "Master.RemediationOverlayKeys":
                float(len(self._overlay_wire)),
        }, now=now)

    # ------------------------------------------------------------ report
    def report(self) -> dict:
        """Wire view for get_health / /api/v1/master/remediation /
        `fsadmin report health` — the audited timeline plus what is in
        force right now."""
        with self._lock:
            quarantined = [
                {"subject": key[1],
                 "worker_id": active.worker_id,
                 "since": active.record.at,
                 "rule": active.record.rule,
                 "probation_since": active.probation_since}
                for key, active in self._active.items()
                if key[0] == ACTION_QUARANTINE]
            return {
                "enabled": True,
                "dry_run": self.dry_run,
                "actions_in_window": len(self._window),
                "max_actions_per_window": self.max_actions_per_window,
                "window_s": self.window_s,
                "cooldown_s": self.cooldown_s,
                "probation_s": self.probation_s,
                "quarantined": quarantined,
                "overlay": dict(self._overlay_wire),
                "overlay_version": self.overlay_version,
                "audit": [r.to_wire() for r in self._audit],
            }
