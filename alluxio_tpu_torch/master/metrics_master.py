"""MetricsMaster: cluster-wide metric aggregation at the metadata master
(a copy of ``alluxio_tpu/master/metrics_master.py``).

Re-design of ``core/server/master/src/main/java/alluxio/master/metrics/
{DefaultMetricsMaster,MetricsStore}.java`` + ``grpc/metric_master.proto``:
workers and clients ship their metric snapshots on a heartbeat; the master
stores them per source and serves ``Cluster.*`` aggregates (sums across
sources, with the instance prefix rewritten) alongside its own metrics —
what ``fsadmin report metrics`` and the Prometheus endpoint read.

The same heartbeat carries completed SPAN batches (each node drains its
trace ring): they land in a ``TraceStore`` so ``/api/v1/master/trace``
serves stitched cross-process traces — one trace_id across client,
worker and master spans.

Aggregation is additive-only: counters/meters/gauges sum across sources;
timer percentile sub-metrics (non-additive) are skipped, as the reference
aggregates counters and throughput meters, not latency histograms.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from alluxio_tpu_torch.utils.tracing import TraceStore

#: cached ``metrics()`` accessor (same pattern as client/block_streams):
#: the drop paths run under the store lock on the heartbeat path, and
#: must not pay the import machinery there.  The function, not the
#: registry, is cached so ``reset_metrics()`` in tests still applies.
_metrics_fn = None


def _metrics():
    global _metrics_fn
    if _metrics_fn is None:
        from alluxio_tpu_torch.metrics import metrics as _m

        _metrics_fn = _m
    return _metrics_fn()


_NON_ADDITIVE_SUFFIXES = (".p50", ".p95", ".p99", ".mean", ".min", ".max")
#: fraction gauges aggregate as a MEAN across sources — summing 4
#: clients' 0.8 into a "3.2 input-bound" Cluster gauge is nonsense,
#: but dropping them would hide the input doctor's headline number
#: from exactly the distributed deployment it targets
_MEAN_SUFFIXES = ("InputBoundFraction",)
_INSTANCE_PREFIXES = ("Worker.", "Client.", "JobWorker.", "Process.")


class MetricsStore:
    """Per-source metric reports + cluster aggregation."""

    def __init__(self, *, source_ttl_s: float = 300.0,
                 max_sources: int = 4096,
                 blocked_ttl_s: float = 3600.0,
                 clock=time.monotonic) -> None:
        self._reports: Dict[str, Dict[str, float]] = {}
        self._last_seen: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._ttl = source_ttl_s
        self._max_sources = max_sources
        self._clock = clock
        # expiry sweeps are O(sources); amortize them off the per-report
        # hot path (reads force their own sweep, so TTL stays exact
        # where it is observed)
        self._gc_every_s = min(5.0, source_ttl_s / 2.0)
        self._last_gc = float("-inf")
        #: reports refused by the max_sources cap (also counted in the
        #: Master.MetricsReportsDropped counter for the heartbeat path)
        self.dropped_reports = 0
        #: reports refused because their source is blocked (counted
        #: separately — Master.MetricsReportsBlocked — so fsadmin's
        #: "raise the source cap" advice never points at what is
        #: actually a dead worker needing restart)
        self.blocked_reports = 0
        #: sources whose reports are refused until explicitly
        #: unblocked: a worker the block master declared lost may keep
        #: shipping metrics heartbeats (wedged block-sync thread), and
        #: those must not re-admit its snapshot into the Cluster.*
        #: aggregates after clear_source — only re-registration
        #: (unblock_source) readmits it.  Entries age out after
        #: ``blocked_ttl_s`` (mirrors the history end markers aging
        #: out with retention) so churned workers that never return
        #: cannot leak entries forever.
        self._blocked: Dict[str, float] = {}
        self._blocked_ttl = blocked_ttl_s

    def report(self, source: str, metrics: Dict[str, float], *,
               sanitized: bool = False) -> bool:
        """A node's full snapshot replaces its previous one (the reference
        ships complete snapshots, not deltas — idempotent under retry).
        New sources beyond ``max_sources`` are dropped — bounds memory
        against spoofed source-name floods (advisor r2 finding).  Drops
        are counted (``Master.MetricsReportsDropped``) so the cap is
        observable instead of silently eating a fleet expansion.
        Returns False when the report was dropped.  ``sanitized=True``
        promises keys are already str and values float — the heartbeat
        path coerces once and shares the dict with the history offer."""
        now = self._clock()
        if not sanitized:
            metrics = {str(k): float(v)
                       for k, v in (metrics or {}).items()}
        with self._lock:
            blocked_at = self._blocked.get(source)
            if blocked_at is not None:
                if now - blocked_at <= self._blocked_ttl:
                    self.blocked_reports += 1
                    _metrics().counter(
                        "Master.MetricsReportsBlocked").inc()
                    return False
                del self._blocked[source]  # block aged out
            if source not in self._reports and \
                    len(self._reports) >= self._max_sources:
                self._gc(now)
                if len(self._reports) >= self._max_sources:
                    self.dropped_reports += 1
                    _metrics().counter(
                        "Master.MetricsReportsDropped").inc()
                    return False
            self._reports[source] = metrics
            self._last_seen[source] = now
            if now - self._last_gc >= self._gc_every_s:
                self._last_gc = now
                self._gc(now)
        return True

    def clear_source(self, source: str, *, block: bool = False) -> None:
        """Drop ``source``'s snapshot; with ``block=True`` also refuse
        its future reports until :meth:`unblock_source` — the
        worker-lost path uses this so a lost-but-chatty worker (metrics
        heartbeat outliving a wedged block-sync thread) cannot re-admit
        itself into the ``Cluster.*`` aggregates seconds after being
        cleared."""
        with self._lock:
            self._reports.pop(source, None)
            self._last_seen.pop(source, None)
            if block:
                self._blocked[source] = self._clock()

    def unblock_source(self, source: str) -> None:
        """Re-admit a blocked source (worker re-registered)."""
        with self._lock:
            self._blocked.pop(source, None)

    def _gc(self, now: float) -> None:
        dead = [s for s, t in self._last_seen.items()
                if now - t > self._ttl]
        for s in dead:
            self._reports.pop(s, None)
            self._last_seen.pop(s, None)
        if self._blocked:
            # a churned worker that never re-registers (new host:port
            # on reschedule) must not leak its block entry forever
            expired = [s for s, t in self._blocked.items()
                       if now - t > self._blocked_ttl]
            for s in expired:
                del self._blocked[s]

    def cluster_metrics(self) -> Dict[str, float]:
        """``Cluster.<name>`` = sum over sources of additive metrics
        (fraction gauges average instead)."""
        out: Dict[str, float] = {}
        mean_counts: Dict[str, int] = {}
        with self._lock:
            self._gc(self._clock())
            for snap in self._reports.values():
                for name, value in snap.items():
                    if name.endswith(_NON_ADDITIVE_SUFFIXES):
                        continue
                    for p in _INSTANCE_PREFIXES:
                        if name.startswith(p):
                            name = name[len(p):]
                            break
                    else:
                        # every legit heartbeat metric carries an
                        # instance prefix (the registry forces one);
                        # anything else is a spoofed name and must not
                        # launder into a Cluster.* series past the
                        # history's prefix allowlist
                        continue
                    key = f"Cluster.{name}"
                    out[key] = out.get(key, 0.0) + value
                    if name.endswith(_MEAN_SUFFIXES):
                        mean_counts[key] = mean_counts.get(key, 0) + 1
        for key, n in mean_counts.items():
            out[key] = out[key] / n
        return out

    def source_count(self) -> int:
        with self._lock:
            return len(self._reports)

    def sources(self) -> Dict[str, float]:
        """source -> seconds since last report (fsadmin diagnostics)."""
        now = self._clock()
        with self._lock:
            return {s: now - t for s, t in self._last_seen.items()}

    def per_source(self, name: str) -> Dict[str, float]:
        """Latest value of one metric in every source's last snapshot —
        includes the non-additive timer sub-metrics (``.p99`` etc.) the
        ``Cluster.*`` aggregation skips, which is exactly what the
        per-worker-vs-fleet health rules need."""
        with self._lock:
            return {src: snap[name] for src, snap in self._reports.items()
                    if name in snap}


class MetricsMaster:
    """Facade the master process owns (reference: DefaultMetricsMaster).

    When a :class:`~alluxio_tpu_torch.metrics.history.MetricsHistory` is
    attached, every accepted heartbeat snapshot is *offered* to it —
    an O(1) hand-off that keeps the RPC path flat — and
    :meth:`drain_history` (called from the health heartbeat and the
    history query surfaces) folds pending snapshots into the rings and
    samples the ``Cluster.*`` aggregates alongside the per-source
    series."""

    #: minimum spacing of Cluster.* aggregate samples: aggregation is
    #: O(sources x metrics), so it must not run per-heartbeat
    CLUSTER_SAMPLE_INTERVAL_S = 5.0

    def __init__(self, store: Optional[MetricsStore] = None,
                 traces: Optional[TraceStore] = None,
                 history=None) -> None:
        self.store = store or MetricsStore()
        self.traces = traces or TraceStore()
        self.history = history
        #: source -> accumulated flame data shipped by that node's
        #: stack sampler (utils/profiler.py) on the metrics heartbeat
        self.flames: dict = {}
        self._flames_lock = threading.Lock()
        self._last_cluster_sample = 0.0
        #: serializes drain_history: the health heartbeat and the
        #: query surfaces (web/RPC) all drain, and an unsynchronized
        #: check-then-set on the cluster-sample interval would let two
        #: near-simultaneous callers ingest Cluster.* samples
        #: microseconds apart — a poisoned dt for rate derivation
        self._drain_lock = threading.Lock()

    def handle_heartbeat(self, request: dict) -> dict:
        source = str(request.get("source") or "unknown")
        # coerce once: store and history offer share this dict (both
        # treat it read-only), and a non-string metric key reaching
        # the history would crash the drain later, off the RPC path
        snapshot = {str(k): float(v)
                    for k, v in (request.get("metrics") or {}).items()}
        accepted = self.store.report(source, snapshot, sanitized=True)
        if accepted and self.history is not None:
            self.history.offer(source, snapshot)
        spans = request.get("spans")
        if spans and accepted:
            # a refused source (spoofed past the cap, or a blocked
            # lost worker) must not keep washing the bounded trace
            # ring with live-looking spans either
            self.traces.ingest(source, spans)
        flame = request.get("profile")
        if isinstance(flame, dict) and accepted:
            from alluxio_tpu_torch.utils.profiler import merge_flames

            with self._flames_lock:
                # same source cap as the metric store: `accepted`
                # already bounds who gets a flame slot
                self.flames[source] = merge_flames(
                    self.flames.get(source), flame)
        return {}

    def flame_report(self, source: str = "") -> dict:
        """Accumulated flame data (``/api/v1/master/profile``): one
        source's merged stacks, or the per-source sample totals."""
        from alluxio_tpu_torch.utils.profiler import merge_flames, profiler

        # the master is its own source: nothing heartbeats its sampler
        # to itself, so fold the local delta in at query time
        local = profiler().drain() if profiler().running else None
        if local is not None:
            with self._flames_lock:
                self.flames["master"] = merge_flames(
                    self.flames.get("master"), local)
        with self._flames_lock:
            if source:
                return {"source": source,
                        "flame": self.flames.get(source)}
            return {"sources": {
                s: {"samples": f.get("samples", 0),
                    "dropped": f.get("dropped", 0),
                    "stacks": len(f.get("stacks") or ())}
                for s, f in self.flames.items()}}

    def drain_history(self, now: Optional[float] = None) -> int:
        """Fold pending heartbeat snapshots into the history rings and
        (rate-limited) record the ``Cluster.*`` aggregate series under
        the synthetic source ``cluster``.  Never called on the RPC hot
        path."""
        h = self.history
        if h is None:
            return 0
        with self._drain_lock:
            n = h.drain()
            ts = h._clock() if now is None else now
            if ts - self._last_cluster_sample >= \
                    self.CLUSTER_SAMPLE_INTERVAL_S:
                self._last_cluster_sample = ts
                agg = self.store.cluster_metrics()
                if agg:
                    n += h.ingest("cluster", agg, now=ts)
        return n

    def history_report(self, params: Optional[dict] = None) -> dict:
        """One parser + response shape for every history query surface
        (RPC ``get_metrics_history``, ``/api/v1/master/metrics/history``)
        — values may arrive typed (RPC) or as query strings (web).
        Caller checks ``history is not None`` first; how "disabled" is
        reported is the one thing that stays surface-specific."""
        p = params or {}
        self.drain_history()
        h = self.history
        name = str(p.get("name") or "")
        if not name:
            return {"names": h.names(prefix=str(p.get("prefix") or "")),
                    "stats": h.stats()}
        rate = p.get("rate")
        if isinstance(rate, str):
            rate = rate.lower() in ("1", "true", "yes")
        return {"series": h.query(
            name, source=str(p.get("source") or ""),
            resolution=str(p.get("resolution") or "raw"),
            since=float(p.get("since") or 0.0),
            rate=bool(rate),
            limit=int(p.get("limit") or 0)),
            "stats": h.stats()}

    def merged_snapshot(self, own: Dict[str, float]) -> Dict[str, float]:
        merged = dict(own)
        merged.update(self.store.cluster_metrics())
        # lint: allow[metric-unknown] -- synthetic aggregate minted at snapshot-merge time; no single emit site
        merged["Cluster.MetricsSources"] = float(self.store.source_count())
        return merged
