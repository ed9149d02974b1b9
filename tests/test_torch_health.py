"""The port's health rules against the JAX package's, on the CPU.

Both packages' ``MetricsMaster`` (metric store, history) and
``HealthMonitor`` run on the same fake clock over the same seeded fleet:
clients whose input-bound fraction rises and falls, a straggling worker,
failing UFS fetches, rejected async caches, cold bytes displacing warm
ones, winning hedges, a worker whose heartbeats stop, a worker declared
lost, and the master's own lock-wait and run-count samples. At every
evaluation both monitors must return the same firing alerts, and their
reports (pending, firing and resolved alerts, ranked, with every value)
must be equal: every default rule fires and resolves alike. The port's
rule set is JAX's ``default_rules`` plus the compaction-debt rule; the
tenant-overload and quorum-degraded rules wait for admission and HA.
"""

import importlib

import numpy as np
import pytest

pytest.importorskip("torch")

PACKAGES = ("alluxio_tpu", "alluxio_tpu_torch")
JAX, PORT = PACKAGES
SEEDS = tuple(range(6))
EVAL_S = 5.0


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


class _Clock:
    def __init__(self, t: float) -> None:
        self.now = t

    def __call__(self) -> float:
        return self.now


def _build(pkg: str, clock):
    mm_mod = _mod(pkg, "master.metrics_master")
    health = _mod(pkg, "master.health")
    history = _mod(pkg, "metrics.history").MetricsHistory(clock=clock)
    mm = mm_mod.MetricsMaster(store=mm_mod.MetricsStore(clock=clock),
                              history=history)
    rules = health.default_rules(stall_window_s=30.0,
                                 heartbeat_stale_s=20.0,
                                 missing_source_grace_s=40.0)
    rules.append(health.metastore_compaction_debt_rule(4, window_s=30.0))
    expected = {"workers": []}
    monitor = health.HealthMonitor(
        mm, rules=rules, fire_after_s=10.0, resolve_after_s=15.0,
        eval_interval_s=EVAL_S, clock=clock,
        worker_sources_fn=lambda: list(expected["workers"]),
        registry=_mod(pkg, "metrics").metrics())
    return mm, monitor, expected


def _fleet_script(seed: int, ticks: int = 60):
    """Per tick: the heartbeats each live source ships, the master's own
    samples, and the topology events. Every fault switches on and off at
    seeded ticks so each rule fires and then resolves."""
    rng = np.random.default_rng(seed)

    def window():
        a = int(rng.integers(3, ticks // 2))
        return a, a + int(rng.integers(6, ticks // 2))

    stall, straggle, ufs_err, reject, cold, hedge, lock, runs = \
        (window() for _ in range(8))
    silent = window()
    lost_at = int(rng.integers(ticks // 3, ticks - 5))
    counters = {"fail": 0.0, "rej": 0.0, "shm": 0.0, "ufs": 0.0,
                "hedges": 0.0, "wins": 0.0}
    out = []
    for t in range(ticks):
        beats = []
        for w in range(4):
            src = f"worker-h{w}:29999"
            if w == 1 and silent[0] <= t < silent[1]:
                continue  # its metrics thread is wedged
            if w == 2 and t >= lost_at:
                continue
            snap = {"Worker.ReadBlockTime.p99":
                    0.5 if w == 0 and straggle[0] <= t < straggle[1]
                    else 0.002 + 0.0001 * w}
            if w == 0:
                if ufs_err[0] <= t < ufs_err[1]:
                    counters["fail"] += float(rng.integers(20, 40))
                snap["Worker.UfsFetchFailures"] = counters["fail"]
                if reject[0] <= t < reject[1]:
                    counters["rej"] += float(rng.integers(5, 20))
                snap["Worker.AsyncCacheRejected"] = counters["rej"]
            beats.append((src, snap))
        for c in range(2):
            high = stall[0] <= t < stall[1] and c == 0
            frac = 0.9 if high else float(rng.uniform(0.0, 0.3))
            counters["shm"] += float(rng.integers(1 << 22, 1 << 24))
            if cold[0] <= t < cold[1]:
                counters["ufs"] += float(rng.integers(1 << 25, 1 << 26))
            if hedge[0] <= t < hedge[1]:
                counters["hedges"] += 10.0
                counters["wins"] += 9.0
            beats.append((f"client-{c}", {
                "Client.InputBoundFraction": frac,
                "Client.BytesRead.shm": counters["shm"],
                "Client.BytesRead.ufs": counters["ufs"],
                "Client.RemoteReadHedges": counters["hedges"],
                "Client.RemoteReadHedgeWins": counters["wins"]}))
        master = {
            "Master.MetadataInodeLockWaitTime.p99":
                0.2 if lock[0] <= t < lock[1] else 0.001,
            "Master.MetastoreRuns": 9.0 if runs[0] <= t < runs[1] else 1.0}
        out.append((beats, master, t == lost_at))
    return out


def _drive(pkg: str, seed: int):
    clock = _Clock(2_000_000.0)
    mm, monitor, expected = _build(pkg, clock)
    registered = clock.now
    seen = []
    for beats, master, lost in _fleet_script(seed):
        for src, snap in beats:
            mm.handle_heartbeat({"source": src, "metrics": snap})
        mm.history.ingest("master", master)
        if lost:
            src = "worker-h2:29999"
            mm.store.clear_source(src, block=True)
            mm.drain_history()
            mm.history.end_source(src)
        expected["workers"] = [
            (f"worker-h{w}:29999", clock.now - registered)
            for w in range(4) if not (lost is True and w == 2)]
        firing = monitor.evaluate()
        seen.append(sorted((a.rule, a.subject, a.state, a.value)
                           for a in firing))
        seen.append(monitor.report())
        clock.now += EVAL_S
    return seen


@pytest.mark.parametrize("seed", SEEDS)
def test_fleet_script_fires_and_resolves_alike(seed):
    got = {pkg: _drive(pkg, seed) for pkg in PACKAGES}
    assert got[PORT] == got[JAX]
    fired = {a["rule"] for step in got[PORT][1::2]
             for a in step["alerts"]}
    resolved = {a["rule"] for step in got[PORT][1::2]
                for a in step["recently_resolved"]}
    # the script exercises the lifecycle, not just the quiet path
    assert {"input-stall-sustained", "read-latency-p99-regression",
            "worker-lost"} <= fired
    assert resolved


def test_every_default_rule_fires_across_the_seeds():
    """Together the seeds fire every rule the script can provoke."""
    fired = set()
    for seed in SEEDS:
        for step in _drive(PORT, seed)[1::2]:
            fired |= {a["rule"] for a in step["alerts"]}
    names = {r.name for r in _build(PORT, _Clock(0.0))[1].rules}
    assert fired == names


def test_rule_set_is_jax_minus_the_deferred_rules():
    jax_h, port_h = (_mod(pkg, "master.health") for pkg in PACKAGES)
    assert [r.to_wire() for r in port_h.default_rules()] == \
        [r.to_wire() for r in jax_h.default_rules()]
    assert port_h.metastore_compaction_debt_rule(7).to_wire() == \
        jax_h.metastore_compaction_debt_rule(7).to_wire()
    missing = {n for n in dir(jax_h) if not n.startswith("_")} - \
        {n for n in dir(port_h) if not n.startswith("_")}
    assert missing == {"tenant_overload_rule", "quorum_degraded_rule"}
    assert port_h.SEVERITIES == jax_h.SEVERITIES


def test_query_driven_evaluation_is_rate_limited_alike():
    got = {}
    for pkg in PACKAGES:
        clock = _Clock(100.0)
        mm, monitor, _ = _build(pkg, clock)
        mm.handle_heartbeat({"source": "client-0", "metrics": {
            "Client.InputBoundFraction": 0.95}})
        reports = [monitor.fresh_report()]
        clock.now += 0.5  # inside QUERY_EVAL_MIN_INTERVAL_S: no pass
        reports.append(monitor.fresh_report())
        clock.now += 11.0
        reports.append(monitor.fresh_report())
        got[pkg] = [(r["evaluated_at"], r["status"],
                     [a["rule"] for a in r["alerts"]],
                     [a["rule"] for a in r["pending"]]) for r in reports]
    assert got[PORT] == got[JAX]
    assert got[PORT][2][1] == "CRITICAL"
