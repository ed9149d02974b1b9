"""History-ingestion overhead bench (a copy of
``alluxio_tpu/stress/health_bench.py``).

Gates the promise the metrics-history design makes: attaching the
history store to the master's metrics heartbeat must cost **<5%** on
the heartbeat-handling hot path, because ``MetricsHistory.offer`` is a
single deque append — the ring/rollup folding happens in ``drain()``
on the health heartbeat, off the RPC path.  The bench measures:

- **hot path**: ``MetricsMaster.handle_heartbeat`` per-call latency,
  history disabled vs enabled, interleaved in alternating batches so
  host-speed drift cancels (the slow-CI discipline from bench-obs);
- **drain throughput**: samples/sec folded into rings + rollups;
- **rule-eval latency**: one full ``HealthMonitor.evaluate`` pass over
  the populated history.

Both masters run on a **fake clock** advanced deterministically per
tick, so retention sweeps, rollup rollover and source GC happen at
exactly the same simulated instants in every run — the CI host's
ms-scale jitter cannot change *what work* either variant does, only
how long it takes, and that is what the alternating batches cancel.
"""

from __future__ import annotations

import statistics
import sys
import time

from alluxio_tpu_torch.stress.base import BenchResult


class _FakeClock:
    """Deliberately NOT utils.clock.ManualClock: the history-enabled
    variant pays one extra clock call per heartbeat (``offer`` stamps
    the sample), so the bench clock must cost what the production
    clock costs (~a C-level ``time.time``).  ManualClock's per-call
    lock is ~5x dearer and bills ~0.7% of phantom "history overhead"
    to the gated delta — measured pushing the 5% gate from ~3.6% to
    ~5.4% on the CI host."""

    def __init__(self) -> None:
        self.now = 1_000_000.0

    def __call__(self) -> float:
        return self.now

    def advance(self, s: float) -> None:
        self.now += s


def _snapshots(sources: int, metrics_per_source: int, ticks: int):
    """Pre-built per-(tick, source) snapshot dicts: dict construction
    happens OUTSIDE the timed region, identically for both variants."""
    out = []
    for t in range(ticks):
        tick = []
        for s in range(sources):
            # lint: allow[metric-unknown] -- synthetic heartbeat payload: the bench floods the history store with fabricated names
            snap = {f"Worker.BenchMetric{m}": float(t * 7 + m)
                    for m in range(metrics_per_source - 2)}
            snap["Worker.ReadBlockTime.p99"] = 0.001 + 0.0001 * s
            snap["Client.InputBoundFraction"] = 0.1
            tick.append((f"worker-host{s}:29999", snap))
        out.append(tick)
    return out


def run(*, sources: int = 64, metrics_per_source: int = 120,
        ticks: int = 40, batches: int = 8, hb_interval_s: float = 5.0,
        max_overhead_pct: float = 5.0) -> BenchResult:
    from alluxio_tpu_torch.master.health import HealthMonitor, default_rules
    from alluxio_tpu_torch.master.metrics_master import MetricsMaster, MetricsStore
    from alluxio_tpu_torch.metrics import metrics as _registry
    from alluxio_tpu_torch.metrics.history import MetricsHistory

    t_start = time.monotonic()
    payload = _snapshots(sources, metrics_per_source, ticks)

    clock_off = _FakeClock()
    clock_on = _FakeClock()
    mm_off = MetricsMaster(store=MetricsStore(clock=clock_off))
    mm_on = MetricsMaster(
        store=MetricsStore(clock=clock_on),
        history=MetricsHistory(clock=clock_on, max_series=16384,
                               pending_max=sources + 8))
    # both variants run the SAME tick back to back, repeatedly: the CI
    # host's per-core speed drifts on second timescales, so only
    # sub-second pairing keeps the drift out of the delta (the
    # bench-obs discipline, one level finer)
    pairs = []
    drain_total = 0.0
    flip = False
    for _ in range(batches):
        for tick in payload:
            # alternate which variant goes first: whoever runs second
            # inherits warm caches from the first, and a fixed order
            # would bill that asymmetry to one side
            first, second = (mm_on, mm_off) if flip else (mm_off, mm_on)
            t0 = time.perf_counter()
            for source, snap in tick:
                first.handle_heartbeat({"source": source,
                                        "metrics": snap})
            t1 = time.perf_counter()
            for source, snap in tick:
                second.handle_heartbeat({"source": source,
                                         "metrics": snap})
            t2 = time.perf_counter()
            pairs.append((t2 - t1, t1 - t0, flip) if flip
                         else (t1 - t0, t2 - t1, flip))
            flip = not flip
            mm_on.drain_history(now=clock_on())
            drain_total += time.perf_counter() - t2
            clock_off.advance(hb_interval_s)
            clock_on.advance(hb_interval_s)
    off_med = statistics.median(p[0] for p in pairs) / sources
    on_med = statistics.median(p[1] for p in pairs) / sources
    # paired per-tick deltas, conditioned on run order: whichever
    # variant runs first right after a drain eats a cold-cache penalty,
    # so the pooled delta distribution is bimodal and its median
    # unstable — the two order-conditional medians see equal-and-
    # opposite bias and their average cancels it
    d_on_cold = statistics.median(
        on - off for off, on, fl in pairs if fl)
    d_off_cold = statistics.median(
        on - off for off, on, fl in pairs if not fl)
    delta = (d_on_cold + d_off_cold) / 2.0
    overhead_pct = 100.0 * delta / (off_med * sources) \
        if off_med > 0 else 0.0
    total_samples = batches * ticks * sources * metrics_per_source
    drain_per_s = total_samples / drain_total if drain_total > 0 else 0.0

    monitor = HealthMonitor(mm_on, rules=default_rules(),
                            clock=clock_on, registry=_registry())
    eval_samples = []
    for _ in range(5):
        t0 = time.perf_counter()
        monitor.evaluate()
        eval_samples.append(time.perf_counter() - t0)
        clock_on.advance(10.0)
    eval_ms = 1e3 * statistics.median(eval_samples)

    ok = overhead_pct <= max_overhead_pct
    if not ok:
        print(f"[health] history ingestion overhead {overhead_pct:.2f}% "
              f"exceeds the {max_overhead_pct}% heartbeat budget",
              file=sys.stderr)
    return BenchResult(
        bench="health-ingest-overhead",
        params={"sources": sources,
                "metrics_per_source": metrics_per_source,
                "ticks": ticks, "batches": batches,
                "hb_interval_s": hb_interval_s,
                "max_overhead_pct": max_overhead_pct},
        metrics={"hb_off_us": round(1e6 * off_med, 3),
                 "hb_on_us": round(1e6 * on_med, 3),
                 "overhead_pct": round(overhead_pct, 3),
                 "overhead_ok": ok,
                 "drain_samples_per_s": round(drain_per_s, 1),
                 "history_series": mm_on.history.series_count(),
                 "rule_eval_ms": round(eval_ms, 3)},
        errors=0 if ok else 1,
        duration_s=time.monotonic() - t_start)
