"""Continuous health-rule engine ("cluster doctor"): a copy of
``alluxio_tpu/master/health.py`` without ``tenant_overload_rule`` (it
reads the admission controller, which is not ported) and
``quorum_degraded_rule`` (it reads the HA quorum view, which is not
ported either).

Turns the metrics history (:mod:`alluxio_tpu_torch.metrics.history`) into
ranked, firing/resolved alerts: each declarative rule watches a
windowed signal — sustained input-stall fraction, cache hit-ratio
drop, UFS-fetch error rate, hedge-win-rate spike, heartbeat staleness,
async-cache rejections, per-worker read-latency p99 regression — and
produces an :class:`Alert` with severity, evidence window and a
remediation hint.  Firing and resolution are debounced so a single
noisy sample can neither page nor un-page an operator.

The engine is the continuous counterpart of the point-in-time
``fsadmin doctor`` / ``fsadmin report stall`` checks: the subsystems
shipped before it (clairvoyant prefetch, hedged remote reads, striped
UFS fetch) only pay off if their effectiveness is *watched*, not
sampled by hand.
"""

from __future__ import annotations

import dataclasses
import logging
import statistics
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

LOG = logging.getLogger(__name__)

SEVERITIES = ("critical", "warning", "info")

#: sort rank: critical first
_SEV_RANK = {s: i for i, s in enumerate(SEVERITIES)}


@dataclasses.dataclass
class Alert:
    rule: str
    severity: str
    subject: str          # "cluster", a source name, ...
    state: str            # pending | firing | resolved
    value: float
    threshold: float
    since: float          # first continuously-violating evaluation
    window_s: float
    summary: str
    remediation: str
    fired_at: Optional[float] = None
    resolved_at: Optional[float] = None
    evidence: dict = dataclasses.field(default_factory=dict)

    def to_wire(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Violation:
    subject: str
    value: float
    summary: str
    evidence: dict = dataclasses.field(default_factory=dict)


class HealthContext:
    """What a rule may look at: the history store, the latest
    per-source snapshots, and 'now'."""

    def __init__(self, history, store, now: float,
                 expected_workers: Optional[
                     List[Tuple[str, float]]] = None) -> None:
        self.history = history
        self.store = store
        self.now = now
        #: (source, registered_for_s) for every LIVE registered worker
        #: — lets the staleness rule flag a worker whose metrics
        #: source expired from the snapshot store entirely (its
        #: metrics thread died while block heartbeats keep it
        #: registered), instead of silently self-resolving at the TTL
        self.expected_workers = expected_workers or []

    # -------------------------------------------------- history helpers
    def window_points(self, name: str, source: str,
                      window_s: float) -> List[Tuple[float, float]]:
        if self.history is None:
            return []
        return self.history.window(name, source, window_s, now=self.now)

    def window_mean(self, name: str, source: str,
                    window_s: float) -> Optional[float]:
        pts = self.window_points(name, source, window_s)
        if not pts:
            return None
        return sum(v for _, v in pts) / len(pts)

    def window_rate(self, name: str, source: str,
                    window_s: float) -> Optional[float]:
        """Counter increase per second across the window: total
        increase over total elapsed time, summing deltas across reset
        boundaries (a negative delta is a counter reset and contributes
        0).  NOT a mean of per-segment rates — equal weighting would
        let one increment landing in a short inter-heartbeat gap
        inflate the whole window's rate by orders of magnitude."""
        pts = self.window_points(name, source, window_s)
        if len(pts) < 2:
            return None
        span = pts[-1][0] - pts[0][0]
        if span <= 0:
            return None
        increase = 0.0
        prev = pts[0][1]
        for _, v in pts[1:]:
            if v > prev:
                increase += v - prev
            prev = v
        return increase / span

    def sources_for(self, name: str) -> List[str]:
        if self.history is None:
            return []
        return self.history.sources_for(name)

    # ---------------------------------------------------- store helpers
    def per_source(self, name: str) -> Dict[str, float]:
        """Latest value of ``name`` in every source's last snapshot
        (includes timer sub-metrics the Cluster.* aggregation skips)."""
        if self.store is None:
            return {}
        return self.store.per_source(name)

    def source_ages(self) -> Dict[str, float]:
        if self.store is None:
            return {}
        return self.store.sources()


class HealthRule:
    """One declarative rule.  ``probe`` returns the current violations;
    the engine owns the firing/resolved lifecycle."""

    def __init__(self, name: str, *, severity: str, window_s: float,
                 threshold: float, remediation: str, description: str,
                 probe: Callable[[HealthContext], List[Violation]],
                 fire_after_s: Optional[float] = None,
                 resolve_after_s: Optional[float] = None,
                 needs_history: bool = False) -> None:
        assert severity in SEVERITIES, severity
        self.name = name
        self.severity = severity
        self.window_s = window_s
        self.threshold = threshold
        self.remediation = remediation
        self.description = description
        self.probe = probe
        self.fire_after_s = fire_after_s      # None -> engine default
        self.resolve_after_s = resolve_after_s
        #: probe reads the metrics HISTORY (not just the snapshot
        #: store): with history disabled it would silently no-op, so
        #: the monitor must not advertise it as watching
        self.needs_history = needs_history

    def to_wire(self) -> dict:
        return {"name": self.name, "severity": self.severity,
                "window_s": self.window_s, "threshold": self.threshold,
                "description": self.description,
                "remediation": self.remediation}


def _worker_sources(ctx: HealthContext, metric: str) -> List[str]:
    return [s for s in ctx.sources_for(metric) if s.startswith("worker-")]


def default_rules(*, stall_threshold: float = 0.5,
                  stall_window_s: float = 60.0,
                  hit_ratio_floor: float = 0.5,
                  hit_ratio_min_bytes_per_s: float = float(1 << 20),
                  ufs_error_rate_per_s: float = 0.02,
                  hedge_win_ratio: float = 0.5,
                  hedge_min_rate_per_s: float = 0.05,
                  heartbeat_stale_s: float = 60.0,
                  missing_source_grace_s: float = 300.0,
                  async_reject_rate_per_s: float = 0.01,
                  p99_regression_factor: float = 3.0,
                  p99_floor_s: float = 0.001,
                  inode_lock_wait_p99_s: float = 0.05) -> List[HealthRule]:
    """The shipped rule catalog (thresholds are the documented
    defaults; docs/observability.md carries the operator table)."""

    def stall(ctx: HealthContext) -> List[Violation]:
        # per-client first — the subject names the loader to fix, and
        # raw client series tick at heartbeat granularity while the
        # Cluster.* mean is sampled coarser; fall back to the cluster
        # aggregate when no per-client series survived (e.g. the
        # series cap ate them)
        metric = "Client.InputBoundFraction"
        out = []
        for src in ctx.sources_for(metric):
            v = ctx.window_mean(metric, src, stall_window_s)
            if v is not None and v > stall_threshold:
                out.append(Violation(
                    src, v,
                    f"input-bound fraction {v:.2f} sustained over "
                    f"{stall_window_s:.0f}s (threshold {stall_threshold})",
                    {"metric": metric, "window_s": stall_window_s}))
        if out:
            return out
        metric = "Cluster.InputBoundFraction"
        v = ctx.window_mean(metric, "cluster", stall_window_s)
        if v is None or v <= stall_threshold:
            return []
        return [Violation(
            "cluster", v,
            f"input-bound fraction {v:.2f} sustained over "
            f"{stall_window_s:.0f}s (threshold {stall_threshold})",
            {"metric": metric, "window_s": stall_window_s})]

    def hit_ratio(ctx: HealthContext) -> List[Violation]:
        # the buckets Client.BytesRead.* actually records (HBM hits
        # never do a host read, so there is no .hbm byte counter)
        buckets = ("shm", "remote", "ufs", "unknown")
        rates = {}
        for b in buckets:
            r = ctx.window_rate(f"Cluster.BytesRead.{b}", "cluster",
                                stall_window_s)
            if r is not None:
                rates[b] = r
        total = sum(rates.values())
        if total < hit_ratio_min_bytes_per_s:
            return []  # idle cluster: a ratio of nothing is noise
        ratio = 1.0 - rates.get("ufs", 0.0) / total
        if ratio >= hit_ratio_floor:
            return []
        return [Violation(
            "cluster", ratio,
            f"cache hit ratio {ratio:.2f} below {hit_ratio_floor} "
            f"({rates.get('ufs', 0.0):.0f} B/s cold of "
            f"{total:.0f} B/s total)",
            {"metric": "Cluster.BytesRead.*", "rates": rates,
             "window_s": stall_window_s})]

    def ufs_errors(ctx: HealthContext) -> List[Violation]:
        out = []
        metric = "Worker.UfsFetchFailures"
        for src in _worker_sources(ctx, metric):
            r = ctx.window_rate(metric, src, 120.0)
            if r is not None and r > ufs_error_rate_per_s:
                out.append(Violation(
                    src, r,
                    f"UFS fetch failures at {r:.3f}/s on {src}",
                    {"metric": metric, "window_s": 120.0}))
        return out

    def hedge_spike(ctx: HealthContext) -> List[Violation]:
        hedges = ctx.window_rate("Cluster.RemoteReadHedges", "cluster",
                                 stall_window_s)
        wins = ctx.window_rate("Cluster.RemoteReadHedgeWins", "cluster",
                               stall_window_s)
        if not hedges or hedges < hedge_min_rate_per_s:
            return []
        ratio = (wins or 0.0) / hedges
        if ratio <= hedge_win_ratio:
            return []
        return [Violation(
            "cluster", ratio,
            f"hedged remote reads winning {100 * ratio:.0f}% of races "
            f"({hedges:.2f} hedges/s) — a straggling worker is "
            f"consistently losing",
            {"metric": "Cluster.RemoteReadHedge*",
             "hedges_per_s": hedges, "window_s": stall_window_s})]

    def stale_heartbeats(ctx: HealthContext) -> List[Violation]:
        # workers only: clients come and go with their jobs, and a
        # normal client exit must not read as "node dead" for the
        # whole source TTL
        out = []
        ages = ctx.source_ages()
        for src, age in ages.items():
            if src.startswith("worker-") and age > heartbeat_stale_s:
                out.append(Violation(
                    src, age,
                    f"no metrics heartbeat from {src} for {age:.0f}s",
                    {"stale_after_s": heartbeat_stale_s}))
        # a registered worker with NO snapshot at all: its metrics
        # thread died long enough ago that the source TTL'd out of
        # the store (block heartbeats keep it registered, so
        # worker-lost stays quiet) — the alert must not self-resolve
        # just because the evidence expired.  The grace period keeps
        # freshly-registered workers quiet until their first report
        # is overdue.
        for src, registered_for_s in ctx.expected_workers:
            if src in ages or registered_for_s < missing_source_grace_s:
                continue
            out.append(Violation(
                src, registered_for_s,
                f"registered worker {src} has no metrics snapshot "
                f"(last report expired from the store — its metrics "
                f"heartbeat thread is likely dead)",
                {"registered_for_s": registered_for_s,
                 "stale_after_s": heartbeat_stale_s}))
        return out

    def worker_lost(ctx: HealthContext) -> List[Violation]:
        # outlives heartbeat-staleness: once the block master declares
        # the worker lost, its snapshot is cleared (staleness goes
        # quiet) but the death must not silently read as OK — the
        # history end marker keeps this firing until the worker
        # re-registers or the marker ages out with history retention
        if ctx.history is None:
            return []
        out = []
        for src, ended in ctx.history.ended_sources(now=ctx.now).items():
            if not src.startswith("worker-"):
                continue
            age = max(0.0, ctx.now - ended)
            out.append(Violation(
                src, age,
                f"{src} was declared lost {age:.0f}s ago and has not "
                f"re-registered",
                {"ended_at": ended}))
        return out

    def async_rejected(ctx: HealthContext) -> List[Violation]:
        out = []
        metric = "Worker.AsyncCacheRejected"
        for src in _worker_sources(ctx, metric):
            r = ctx.window_rate(metric, src, 120.0)
            if r is not None and r > async_reject_rate_per_s:
                out.append(Violation(
                    src, r,
                    f"async cache-fill requests rejected at {r:.3f}/s "
                    f"on {src} (queue saturated)",
                    {"metric": metric, "window_s": 120.0}))
        return out

    def p99_regression(ctx: HealthContext) -> List[Violation]:
        metric = "Worker.ReadBlockTime.p99"
        per = {s: v for s, v in ctx.per_source(metric).items()
               if s.startswith("worker-")}
        if len(per) < 2:
            return []  # no fleet to regress against
        med = statistics.median(per.values())
        out = []
        for src, v in per.items():
            # the absolute floor gates the OUTLIER, not the median: a
            # fast memory-serving fleet (median far below the floor)
            # must still flag a worker regressing to disk-bound
            # latencies, while sub-floor noise on an idle fleet stays
            # quiet
            if v <= p99_floor_s or v <= med * p99_regression_factor:
                continue
            ratio = v / med if med > 0 else float(p99_regression_factor)
            # value is the regression RATIO — same unit as the
            # factor threshold, or _rank inverts the ordering
            out.append(Violation(
                src, ratio,
                f"warm read p99 {1e3 * v:.1f}ms/MiB on {src} is "
                f"{ratio:.1f}x the fleet median "
                f"({1e3 * med:.1f}ms/MiB)",
                {"metric": metric, "fleet_median_s": med,
                 "p99_s": v}))
        return out

    def metadata_lock_contention(ctx: HealthContext) -> List[Violation]:
        # the master self-samples this series on the health tick
        # (process._sample_metadata_history) — sustained inode-lock
        # acquisition p99 means the striped metadata control plane is
        # convoying (hot directory, coarse-fallback storm, or a slow
        # journal flusher backing up writers)
        metric = "Master.MetadataInodeLockWaitTime.p99"
        v = ctx.window_mean(metric, "master", stall_window_s)
        if v is None or v <= inode_lock_wait_p99_s:
            return []
        return [Violation(
            "master", v,
            f"inode-lock acquisition p99 {1e3 * v:.1f}ms sustained over "
            f"{stall_window_s:.0f}s (threshold "
            f"{1e3 * inode_lock_wait_p99_s:.0f}ms)",
            {"metric": metric, "p99_s": v,
             "threshold_s": inode_lock_wait_p99_s})]

    return [
        HealthRule(
            "metadata-lock-contention", severity="warning",
            window_s=stall_window_s, threshold=inode_lock_wait_p99_s,
            probe=metadata_lock_contention, needs_history=True,
            description="metadata operations queue on inode path locks",
            remediation="find the hot directory (spread writers across "
                        "subtrees), check journal flush latency "
                        "(Master.MetadataJournalFlushTime), and see "
                        "docs/metadata.md for the locking model"),
        HealthRule(
            "input-stall-sustained", severity="critical",
            window_s=stall_window_s, threshold=stall_threshold,
            probe=stall, needs_history=True,
            description="loaders spend most of their wall time waiting "
                        "for input",
            remediation="run `fsadmin report stall` for the tier "
                        "verdict; warm the cache or enable clairvoyant "
                        "prefetch (atpu.prefetch.*)"),
        HealthRule(
            "cache-hit-ratio-drop", severity="warning",
            window_s=stall_window_s, threshold=hit_ratio_floor,
            probe=hit_ratio, needs_history=True,
            description="cold UFS bytes are displacing cached reads",
            remediation="check eviction pressure (worker capacity) and "
                        "prefetch coverage; see docs/ufs_cold_reads.md"),
        HealthRule(
            "ufs-fetch-errors", severity="critical", window_s=120.0,
            threshold=ufs_error_rate_per_s, probe=ufs_errors,
            needs_history=True,
            description="a worker's striped UFS fetches are failing",
            remediation="inspect the worker's log and UFS "
                        "credentials/quotas; stripes retry once then "
                        "fail the read"),
        HealthRule(
            "hedge-win-rate-spike", severity="warning",
            window_s=stall_window_s, threshold=hedge_win_ratio,
            probe=hedge_spike, needs_history=True,
            description="hedged remote reads keep beating the primary "
                        "replica",
            remediation="a worker is straggling: check its host load "
                        "and NIC; see docs/remote_reads.md"),
        HealthRule(
            "heartbeat-staleness", severity="warning",
            window_s=heartbeat_stale_s, threshold=heartbeat_stale_s,
            probe=stale_heartbeats, fire_after_s=0.0,
            description="a node stopped shipping metrics heartbeats",
            remediation="node dead or partitioned: check the process "
                        "and the master address it is configured with"),
        HealthRule(
            "worker-lost", severity="critical", window_s=0.0,
            threshold=0.0, probe=worker_lost, needs_history=True,
            fire_after_s=0.0,
            description="the block master declared a worker lost and "
                        "it has not come back",
            remediation="restart the worker or remove it from the "
                        "fleet; the alert ages out with history "
                        "retention (atpu.master.metrics.history."
                        "retention) or resolves on re-registration"),
        HealthRule(
            "async-cache-rejected", severity="warning", window_s=120.0,
            threshold=async_reject_rate_per_s,
            probe=async_rejected, needs_history=True,
            description="worker async cache-fill queue is saturated",
            remediation="raise atpu.worker.async.cache.queue.max / "
                        ".threads, or slow the prefetch agent"),
        HealthRule(
            "read-latency-p99-regression", severity="warning",
            window_s=0.0, threshold=p99_regression_factor,
            probe=p99_regression,
            description="one worker's read p99 regressed vs the fleet "
                        "median",
            remediation="compare the worker's host (CPU steal, disk, "
                        "GC pauses) against its peers; drain it if it "
                        "cannot keep up"),
    ]


def metastore_compaction_debt_rule(max_runs: int = 24, *,
                                   window_s: float = 60.0) -> HealthRule:
    """Fires while the LSM metastore's sorted-run count stays above the
    configured debt threshold (``Master.MetastoreRuns``, sampled on the
    health tick).  Every point lookup probes each run's bloom filter and
    every listing merges all runs, so an ever-growing run count means
    compaction is losing the race with flushes — reads degrade first,
    then disk fills with un-merged duplicates.  HEAP/SQLITE backends
    report zero runs, keeping the rule inert there."""

    def probe(ctx: HealthContext) -> List[Violation]:
        runs = ctx.window_mean("Master.MetastoreRuns", "master", window_s)
        if runs is None or runs <= float(max_runs):
            return []
        return [Violation(
            "master-metastore", runs,
            f"LSM metastore carries {runs:.0f} sorted runs (threshold "
            f"{max_runs}) — compaction is not keeping up with flushes",
            {"metric": "Master.MetastoreRuns", "window_s": window_s,
             "threshold": max_runs})]

    return HealthRule(
        "metastore-compaction-debt", severity="warning",
        window_s=window_s, threshold=float(max_runs), probe=probe,
        needs_history=True,
        description="the LSM metastore's sorted-run count is sustained "
                    "above the compaction-debt threshold",
        remediation="compaction is starved or wedged: check master CPU "
                    "headroom and the metastore disk, lower "
                    "atpu.master.metastore.lsm.memtable.bytes churn or "
                    "raise atpu.master.metastore.compaction.debt.runs "
                    "if the namespace genuinely grew; see "
                    "`fsadmin report metastore` and docs/metadata.md")


class _Tracked:
    __slots__ = ("alert", "clean_since", "clean_observed_s")

    def __init__(self, alert: Alert, now: float) -> None:
        self.alert = alert
        #: first evaluation that observed the rule clean (None while
        #: violating) — resolution debounces on *observed* clean time,
        #: not wall time since the last violation, so a gap between
        #: evaluations cannot count as a clean streak nobody watched
        self.clean_since: Optional[float] = None
        #: accumulated clean time the evaluator actually watched: the
        #: sum of inter-evaluation gaps with clean observations at both
        #: ends, each capped near the evaluation cadence — a stalled
        #: heartbeat's unobserved span resolves nothing
        self.clean_observed_s: float = 0.0


class HealthMonitor:
    """Evaluates the rule catalog on a heartbeat; owns alert lifecycle.

    pending --(violated >= fire_after)--> firing
    firing --(clean >= resolve_after)--> resolved (kept in a ring)
    pending --(clean once)--> dropped silently
    """

    def __init__(self, metrics_master, *,
                 rules: Optional[List[HealthRule]] = None,
                 fire_after_s: float = 30.0,
                 resolve_after_s: float = 60.0,
                 eval_interval_s: Optional[float] = None,
                 worker_sources_fn: Optional[Callable[
                     [], List[Tuple[str, float]]]] = None,
                 clock: Callable[[], float] = time.time,
                 registry=None) -> None:
        self._mm = metrics_master
        #: returns (source, registered_for_s) for live registered
        #: workers; feeds HealthContext.expected_workers
        self._worker_sources_fn = worker_sources_fn
        self.rules = rules if rules is not None else default_rules()
        self.fire_after_s = fire_after_s
        self.resolve_after_s = resolve_after_s
        self._clock = clock
        #: called after every evaluation with (firing_alerts, now) —
        #: OUTSIDE the monitor lock, so a listener may query the
        #: monitor.  The remediation engine subscribes here.
        self.alert_listeners: List[Callable[[List[Alert], float],
                                            None]] = []
        self._tracked: Dict[Tuple[str, str], _Tracked] = {}
        self._resolved: deque = deque(maxlen=50)
        self._lock = threading.Lock()
        self._eval_gate = threading.Lock()  # query-driven eval rate limit
        self._last_eval: float = 0.0
        #: counted-clean-gap ceiling (see _Tracked.clean_observed_s);
        #: 3x the heartbeat period tolerates jitter, None = uncapped
        #: (callers that drive evaluate() themselves, e.g. tests)
        self._clean_gap_cap_s = 3.0 * eval_interval_s \
            if eval_interval_s else None
        if registry is None:
            from alluxio_tpu_torch.metrics import metrics

            registry = metrics()
        registry.register_gauge("Master.Health.AlertsFiring",
                                lambda: float(len(self.firing())))
        self._eval_timer = registry.timer("Master.Health.EvalTime")

    # ---------------------------------------------------------- evaluate
    def evaluate(self, now: Optional[float] = None) -> List[Alert]:
        """One evaluation pass; returns the currently-firing alerts."""
        from alluxio_tpu_torch.utils.tracing import tracer

        ts = self._clock() if now is None else now
        with tracer().span("atpu.master.health.evaluate"), \
                self._eval_timer.time():
            if self._mm is not None:
                self._mm.drain_history(now=ts)
            expected = None
            if self._worker_sources_fn is not None:
                try:
                    expected = self._worker_sources_fn()
                except Exception:  # noqa: BLE001 - never take the
                    # doctor down over a topology read
                    LOG.debug("worker-topology read failed", exc_info=True)
            ctx = HealthContext(
                getattr(self._mm, "history", None),
                getattr(self._mm, "store", None), ts,
                expected_workers=expected)
            with self._lock:
                for rule in self.rules:
                    try:
                        violations = rule.probe(ctx)
                    except Exception:  # noqa: BLE001 - a broken rule
                        # must not take the doctor down
                        LOG.warning("health rule %s failed",
                                    rule.name, exc_info=True)
                        continue
                    self._apply(rule, violations, ts)
                self._last_eval = ts
                firing = [t.alert for t in self._tracked.values()
                          if t.alert.state == "firing"]
            for listener in self.alert_listeners:
                try:
                    listener(firing, ts)
                except Exception:  # noqa: BLE001 - a broken actor must
                    # not take the doctor down either
                    LOG.warning("health alert listener failed",
                                exc_info=True)
            return firing

    def _apply(self, rule: HealthRule,
               violations: List[Violation], now: float) -> None:
        fire_after = rule.fire_after_s if rule.fire_after_s is not None \
            else self.fire_after_s
        resolve_after = rule.resolve_after_s \
            if rule.resolve_after_s is not None else self.resolve_after_s
        seen = set()
        for v in violations:
            key = (rule.name, v.subject)
            seen.add(key)
            t = self._tracked.get(key)
            if t is None:
                t = self._tracked[key] = _Tracked(Alert(
                    rule=rule.name, severity=rule.severity,
                    subject=v.subject, state="pending", value=v.value,
                    threshold=rule.threshold, since=now,
                    window_s=rule.window_s, summary=v.summary,
                    remediation=rule.remediation,
                    evidence=v.evidence), now)
            t.clean_since = None
            t.alert.value = v.value
            t.alert.summary = v.summary
            t.alert.evidence = v.evidence
            if t.alert.state == "pending" and \
                    now - t.alert.since >= fire_after:
                t.alert.state = "firing"
                t.alert.fired_at = now
        # lifecycle for tracked alerts this rule did NOT re-violate
        for key in [k for k in self._tracked if k[0] == rule.name
                    and k not in seen]:
            t = self._tracked[key]
            if t.alert.state == "pending":
                del self._tracked[key]  # debounce ate the blip
                continue
            if t.clean_since is None:
                t.clean_since = now
                t.clean_observed_s = 0.0
            else:
                # _last_eval still holds the PREVIOUS evaluation's ts
                # (evaluate() stamps it after the rule loop)
                gap = now - self._last_eval
                if self._clean_gap_cap_s is not None:
                    gap = min(gap, self._clean_gap_cap_s)
                t.clean_observed_s += max(0.0, gap)
            if t.clean_observed_s >= resolve_after:
                t.alert.state = "resolved"
                t.alert.resolved_at = now
                self._resolved.append(t.alert)
                del self._tracked[key]

    # ------------------------------------------------------------ report
    def firing(self) -> List[Alert]:
        with self._lock:
            return [t.alert for t in self._tracked.values()
                    if t.alert.state == "firing"]

    @staticmethod
    def _rank(a: Alert) -> tuple:
        sev = _SEV_RANK.get(a.severity, len(SEVERITIES))
        # severity of the violation = how far the value sits from the
        # threshold in WHICHEVER direction the rule fires (hit-ratio
        # violates below its floor: ratio 0.05 must outrank 0.45)
        if not a.threshold:
            over = a.value
        elif a.value > a.threshold:
            over = a.value / a.threshold
        elif a.value > 0:
            over = a.threshold / a.value
        else:
            over = float("inf")
        return (sev, -over, a.rule, a.subject)

    #: query-driven evaluations (get_health RPC, /api/v1/master/health)
    #: within this of the last pass serve the existing lifecycle state:
    #: a dashboard refresh storm must not repeat the O(series) probe
    #: scans per request, and at most this much staleness is invisible
    #: next to fire_after/resolve_after debounce
    QUERY_EVAL_MIN_INTERVAL_S = 1.0

    def fresh_report(self, evaluate: bool = True) -> dict:
        """Evaluate-then-report, shared by the RPC and web surfaces so
        neither serves a stale lifecycle state (rate-limited — the
        periodic heartbeat is the workhorse, queries only top up).
        The gate serializes concurrent queries: one evaluates, the
        rest wait and see the fresh ``_last_eval``."""
        if evaluate:
            with self._eval_gate:
                if self._clock() - self._last_eval >= \
                        self.QUERY_EVAL_MIN_INTERVAL_S:
                    self.evaluate()
        return self.report()

    def report(self) -> dict:
        """Ranked wire view: what `fsadmin report health` and
        /api/v1/master/health serve."""
        with self._lock:
            firing = sorted(
                (t.alert for t in self._tracked.values()
                 if t.alert.state == "firing"), key=self._rank)
            pending = sorted(
                (t.alert for t in self._tracked.values()
                 if t.alert.state == "pending"), key=self._rank)
            resolved = list(self._resolved)[-10:]
            status = "OK"
            if any(a.severity == "warning" for a in firing):
                status = "WARN"
            if any(a.severity == "critical" for a in firing):
                status = "CRITICAL"
            return {
                "status": status,
                "evaluated_at": self._last_eval,
                "alerts": [a.to_wire() for a in firing],
                "pending": [a.to_wire() for a in pending],
                "recently_resolved": [a.to_wire() for a in
                                      reversed(resolved)],
                "rules": [r.to_wire() for r in self.rules],
            }
