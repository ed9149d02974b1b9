"""Self-healing remediation bench (a copy of
``alluxio_tpu/stress/selfheal_bench.py``).

Gates the two promises the remediation engine makes:

- **detection → action latency**: on a fake clock ticking the health
  evaluation every ``eval_interval_s``, the simulated time from the
  first straggler sample to the *executed* quarantine action must stay
  within ``fire_after + 2 x eval_interval`` — the engine adds at most
  one tick on top of the health engine's own debounce;
- **tick overhead**: attaching the engine as an alert listener must
  add **<2%** to the health-engine evaluation tick.  Measured by
  instrumenting the listener itself — per-tick engine time over
  per-tick rule-evaluation time — because the added work (~10-20us)
  sits far below this CI host's paired-run jitter (observed IQR
  ~±100us on a 1.1ms tick); A/B pairing would gate noise, not the
  engine.

Everything runs in-process against a stub block master — the bench
measures the engine's control loop, not gRPC.
"""

from __future__ import annotations

import statistics
import sys
import time
from typing import Dict, List

from alluxio_tpu_torch.stress.base import BenchResult


class _FakeClock:
    """Same shape (and cost rationale) as health_bench's fake clock."""

    def __init__(self) -> None:
        self.now = 1_000_000.0

    def __call__(self) -> float:
        return self.now

    def advance(self, s: float) -> None:
        self.now += s


class _Addr:
    def __init__(self, host: str, port: int) -> None:
        self.host = host
        self.rpc_port = port


class _StubWorker:
    def __init__(self, wid: int, host: str, port: int,
                 blocks: Dict[int, str]) -> None:
        self.id = wid
        self.address = _Addr(host, port)
        self.capacity_bytes_on_tiers = {"MEM": 1 << 30}
        self.blocks = dict(blocks)


class _StubBlockMaster:
    """Just enough surface for the engine: listing, lookup,
    quarantine/release."""

    def __init__(self, workers: List[_StubWorker]) -> None:
        self._workers = {w.id: w for w in workers}
        self._by_source = {
            f"worker-{w.address.host}:{w.address.rpc_port}": w.id
            for w in workers}
        self.quarantined: Dict[int, float] = {}

    def get_worker_infos(self, include_lost: bool = False,
                         include_quarantined: bool = True):
        return [w for w in self._workers.values()
                if include_quarantined or w.id not in self.quarantined]

    def get_worker(self, wid: int):
        return self._workers.get(wid)

    def worker_id_for_source(self, source: str):
        # O(1) like the real BlockMaster's index — the bench gates the
        # engine's cost, not a stub's scan
        return self._by_source.get(source)

    def quarantine_worker(self, wid: int) -> bool:
        if wid not in self._workers:
            return False
        self.quarantined[wid] = 1.0
        return True

    def release_worker(self, wid: int) -> bool:
        return self.quarantined.pop(wid, None) is not None

    def quarantined_workers(self):
        return dict(self.quarantined)


def _heartbeat_all(mm, sources: int, straggler_p99: float = 0.0,
                   metrics_per_source: int = 40) -> None:
    """Realistic heartbeat payloads: a live worker ships ~100-150
    metric entries (bench-health models 120); the health tick's cost —
    the denominator of the gated overhead ratio — folds and probes all
    of them, so shipping 2 would deflate it ~20x and gate the engine
    against a toy tick."""
    for s in range(sources):
        p99 = 0.002
        if straggler_p99 and s == 0:
            p99 = straggler_p99
        # lint: allow[metric-unknown] -- synthetic heartbeat payload: the bench models realistic 40-metric reports with fabricated names
        snap = {f"Worker.BenchMetric{m}": float(s * 7 + m)
                for m in range(metrics_per_source - 1)}
        snap["Worker.ReadBlockTime.p99"] = p99
        mm.handle_heartbeat({"source": f"worker-host{s}:29999",
                             "metrics": snap})


def _build(clock, *, sources: int, with_engine: bool,
           fire_after_s: float, eval_interval_s: float):
    from alluxio_tpu_torch.master.health import HealthMonitor, default_rules
    from alluxio_tpu_torch.master.metrics_master import (
        MetricsMaster, MetricsStore,
    )
    from alluxio_tpu_torch.master.remediation import RemediationEngine
    from alluxio_tpu_torch.metrics.history import MetricsHistory

    mm = MetricsMaster(
        store=MetricsStore(clock=clock),
        history=MetricsHistory(clock=clock, max_series=16384,
                               pending_max=sources + 8))
    monitor = HealthMonitor(mm, rules=default_rules(),
                            fire_after_s=fire_after_s,
                            resolve_after_s=fire_after_s,
                            eval_interval_s=eval_interval_s,
                            clock=clock)
    engine = None
    if with_engine:
        workers = [_StubWorker(100 + s, f"host{s}", 29999,
                               {1000 + s: "MEM"})
                   for s in range(sources)]
        # cooldown/eval ratio matches the production defaults (300s /
        # 10s = 30 ticks): the overhead gate measures the engine at
        # its real duty cycle — acting ticks are bounded by cooldown
        # and the window cap, so their amortized cost is part of what
        # the 2% budget covers
        engine = RemediationEngine(
            _StubBlockMaster(workers), metrics_master=mm,
            cooldown_s=30.0 * eval_interval_s, probation_s=0.0,
            window_s=600.0, max_actions_per_window=8, clock=clock)
        monitor.alert_listeners.append(engine.on_alerts)
    return mm, monitor, engine


def run(*, sources: int = 64, ticks: int = 60, batches: int = 6,
        eval_interval_s: float = 5.0, fire_after_s: float = 10.0,
        max_overhead_pct: float = 2.0) -> BenchResult:
    t_start = time.monotonic()

    # ---- phase 1: detection -> action latency on the fake clock ------
    clock = _FakeClock()
    mm, monitor, engine = _build(clock, sources=sources, with_engine=True,
                                 fire_after_s=fire_after_s,
                                 eval_interval_s=eval_interval_s)
    # settle: healthy fleet, no alerts
    for _ in range(3):
        _heartbeat_all(mm, sources)
        monitor.evaluate()
        clock.advance(eval_interval_s)
    t_inject = clock()
    action_at = None
    for _ in range(40):
        _heartbeat_all(mm, sources, straggler_p99=0.5)
        monitor.evaluate()
        executed = [a for a in engine.report()["audit"]
                    if a["action"] == "quarantine"
                    and a["outcome"] == "executed"]
        if executed:
            action_at = executed[0]["at"]
            break
        clock.advance(eval_interval_s)
    detect_to_act_s = (action_at - t_inject) if action_at else float("inf")
    latency_budget_s = fire_after_s + 2 * eval_interval_s
    latency_ok = detect_to_act_s <= latency_budget_s

    # ---- phase 2: engine overhead on the health tick ------------------
    clock2 = _FakeClock()
    mm2, mon2, eng2 = _build(clock2, sources=sources, with_engine=True,
                             fire_after_s=fire_after_s,
                             eval_interval_s=eval_interval_s)
    # instrument the listener: its per-tick time IS the added cost —
    # timing it inline (not A/B) keeps the CI host's run-to-run drift
    # out of the gated ratio
    engine_times: List[float] = []
    inner = eng2.on_alerts

    def timed_listener(alerts, now=None):
        t0 = time.perf_counter()
        inner(alerts, now)
        engine_times.append(time.perf_counter() - t0)

    mon2.alert_listeners[:] = [timed_listener]
    tick_times: List[float] = []
    for b in range(batches):
        for t in range(ticks):
            # one straggler phase per batch so the engine pays its
            # acting cost inside the measured region, not just the
            # no-alert fast path
            p99 = 0.5 if (t % ticks) > ticks // 2 else 0.0
            _heartbeat_all(mm2, sources, straggler_p99=p99)
            t0 = time.perf_counter()
            mon2.evaluate()
            tick_times.append(time.perf_counter() - t0)
            clock2.advance(eval_interval_s)
    # MEANS, not medians: the engine's cost is spiky by design (audit
    # rows and history samples land on state changes), and the budget
    # bounds the total tax on the heartbeat, not the typical tick.
    # Top 1% of engine samples dropped: the engine window is ~2% of
    # the tick, so a host pause (GC, scheduler) landing inside it
    # bills milliseconds of machine noise to microseconds of work —
    # the design spikes (history ingest, ~40-70us, dozens per run)
    # survive a 1% trim
    cut = max(1, len(engine_times) // 100)
    engine_kept = sorted(engine_times)[:-cut]
    engine_mean = sum(engine_kept) / len(engine_kept)
    tick_mean = sum(tick_times) / len(tick_times)
    base_mean = tick_mean - engine_mean
    off_med = statistics.median(
        t - e for t, e in zip(tick_times, engine_times))
    on_med = statistics.median(tick_times)
    overhead_pct = 100.0 * engine_mean / base_mean \
        if base_mean > 0 else 0.0
    overhead_ok = overhead_pct <= max_overhead_pct

    errors = 0
    if not latency_ok:
        errors += 1
        print(f"[selfheal] detection->action {detect_to_act_s:.1f}s "
              f"exceeds the {latency_budget_s:.1f}s budget "
              f"(fire_after + 2 ticks)", file=sys.stderr)
    if not overhead_ok:
        errors += 1
        print(f"[selfheal] remediation adds {overhead_pct:.2f}% to the "
              f"health tick, over the {max_overhead_pct}% budget",
              file=sys.stderr)
    return BenchResult(
        bench="selfheal-remediation",
        params={"sources": sources, "ticks": ticks, "batches": batches,
                "eval_interval_s": eval_interval_s,
                "fire_after_s": fire_after_s,
                "max_overhead_pct": max_overhead_pct},
        metrics={"detect_to_act_s": round(detect_to_act_s, 3),
                 "latency_budget_s": latency_budget_s,
                 "latency_ok": latency_ok,
                 "eval_off_us": round(1e6 * off_med, 3),
                 "eval_on_us": round(1e6 * on_med, 3),
                 "overhead_pct": round(overhead_pct, 3),
                 "overhead_ok": overhead_ok},
        errors=errors,
        duration_s=time.monotonic() - t_start)
