"""The port's metrics history against the JAX package's, on the CPU.

The same seeded script of heartbeat snapshots (offers, drains, direct
ingests, counter resets, source end and revive markers) goes through
both packages' ``MetricsHistory`` on the same fake clock. Then every
query surface must answer alike: raw, 1m and 10m series, derived rates,
windows, latest values, names, sources, ended sources, the series and
drop counts and the store's stats; the prefix allowlist, the series cap
and the pending-queue bound drop the same samples and ticks. Both
packages fold the same Python floats in the same order, so float
answers are compared for equality.
"""

import importlib

import numpy as np
import pytest

pytest.importorskip("torch")

PACKAGES = ("alluxio_tpu", "alluxio_tpu_torch")
SEEDS = tuple(range(6))

SOURCES = ("worker-h0:29999", "worker-h1:29999", "client-a", "client-b")
NAMES = ("Worker.BytesRead", "Worker.ReadBlockTime.p99",
         "Client.InputBoundFraction", "Client.BytesRead.ufs",
         "Master.Foo", "Cluster.Bar", "Other.Spoofed", "JobWorker.Tasks")


def _history_mod(pkg: str):
    return importlib.import_module(f"{pkg}.metrics.history")


class _Clock:
    def __init__(self, t: float) -> None:
        self.now = t

    def __call__(self) -> float:
        return self.now


def _script(seed: int, steps: int = 240):
    """Seeded steps: (advance_s, kind, args). Counters grow with the odd
    reset; gauges wander; the clock advances irregularly so ticks cross
    rollup buckets and the retention sweep."""
    rng = np.random.default_rng(seed)
    counters = {n: 0.0 for n in NAMES}
    out = []
    for _ in range(steps):
        advance = float(rng.choice([0.5, 1.0, 5.0, 13.0, 61.0]))
        r = float(rng.random())
        if r < 0.05:
            out.append((advance, "end", SOURCES[int(rng.integers(2))]))
            continue
        if r < 0.08:
            out.append((advance, "revive", SOURCES[int(rng.integers(2))]))
            continue
        src = SOURCES[int(rng.integers(len(SOURCES)))]
        snap = {}
        for name in NAMES:
            if rng.random() < 0.4:
                continue
            if name.endswith(("p99", "Fraction")):
                snap[name] = float(rng.random())
            else:
                if rng.random() < 0.03:
                    counters[name] = 0.0  # a counter reset
                counters[name] += float(rng.integers(0, 1 << 20))
                snap[name] = counters[name]
        kind = "offer" if r < 0.8 else "ingest"
        out.append((advance, kind, (src, snap)))
        if rng.random() < 0.3:
            out.append((0.0, "drain", None))
    return out


def _run(pkg: str, seed: int, **kw):
    clock = _Clock(1_000_000.0)
    h = _history_mod(pkg).MetricsHistory(clock=clock, **kw)
    seen = []
    for advance, kind, args in _script(seed):
        clock.now += advance
        if kind == "offer":
            h.offer(*args)
        elif kind == "ingest":
            seen.append(("ingest", h.ingest(*args)))
        elif kind == "drain":
            seen.append(("drain", h.drain()))
        elif kind == "end":
            seen.append(("end", h.end_source(args)))
        else:
            seen.append(("revive", h.revive_source(args)))
    seen.append(("drain", h.drain()))
    return h, clock, seen


def _observe(h, clock) -> dict:
    out = {"names": h.names(), "stats": h.stats(),
           "series": h.series_count(),
           "ended": h.ended_sources()}
    for name in NAMES:
        out[f"sources:{name}"] = h.sources_for(name)
        for res in ("raw", "1m", "10m"):
            for rate in (False, True):
                out[f"q:{name}:{res}:{rate}"] = h.query(
                    name, resolution=res, rate=rate)
        out[f"q:{name}:since"] = h.query(name, since=clock.now - 300.0,
                                         limit=7)
        for src in SOURCES:
            out[f"latest:{name}:{src}"] = h.latest(name, src)
            out[f"window:{name}:{src}"] = h.window(name, src, 120.0)
        out[f"q:{name}:one"] = h.query(name, source=SOURCES[0])
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_seeded_script_queries_equal(seed):
    """Small rings (capacity 16) and a 10-minute retention so the
    script wraps rings, prunes, rolls buckets over and reclaims idle
    series."""
    obs = {}
    for pkg in PACKAGES:
        h, clock, seen = _run(pkg, seed, capacity=16, retention_s=600.0)
        obs[pkg] = (seen, _observe(h, clock))
    assert obs["alluxio_tpu_torch"] == obs["alluxio_tpu"]


@pytest.mark.parametrize("max_series", (3, 9))
def test_allowlist_and_series_cap_drop_alike(max_series):
    obs = {}
    for pkg in PACKAGES:
        h, clock, seen = _run(pkg, 7, max_series=max_series,
                              allow_prefixes=("Worker.", "Client."))
        obs[pkg] = (seen, _observe(h, clock))
        assert h.dropped_samples > 0
        assert h.series_count() <= max_series
    assert obs["alluxio_tpu_torch"] == obs["alluxio_tpu"]


def test_pending_queue_bound_counts_dropped_ticks():
    obs = {}
    for pkg in PACKAGES:
        clock = _Clock(50.0)
        h = _history_mod(pkg).MetricsHistory(clock=clock, pending_max=4)
        for i in range(11):
            clock.now += 1.0
            h.offer("client-a", {"Client.X": float(i)})
        drained = h.drain()
        obs[pkg] = (drained, h.dropped_ticks,
                    h.query("Client.X"), h.stats())
    assert obs["alluxio_tpu_torch"] == obs["alluxio_tpu"]
    assert obs["alluxio_tpu"][1] == 7


def test_end_marker_survives_metrics_and_clears_on_revive():
    """A lost worker's series keep their end marker while its metrics
    keep arriving; only revive_source clears it; a series minted for an
    ended source carries the marker."""
    obs = {}
    for pkg in PACKAGES:
        clock = _Clock(10.0)
        h = _history_mod(pkg).MetricsHistory(clock=clock)
        src = "worker-h9:1"
        h.ingest(src, {"Worker.A": 1.0})
        clock.now += 5.0
        ended = h.end_source(src)
        clock.now += 5.0
        h.ingest(src, {"Worker.A": 2.0, "Worker.B": 3.0})
        before = (h.query("Worker.A"), h.query("Worker.B"),
                  h.ended_sources())
        revived = h.revive_source(src)
        after = (h.query("Worker.A"), h.query("Worker.B"),
                 h.ended_sources())
        clock.now += 4000.0
        aged = h.ended_sources()
        obs[pkg] = (ended, before, revived, after, aged)
    assert obs["alluxio_tpu_torch"] == obs["alluxio_tpu"]
    assert obs["alluxio_tpu"][1][1][0]["ended_at"] == 15.0


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_derive_rate_equal(seed):
    rng = np.random.default_rng(seed)
    ts = np.cumsum(rng.choice([0.0, 0.5, 1.0, 7.0], 60)).tolist()
    vs = np.cumsum(rng.integers(-50, 200, 60)).astype(float).tolist()
    pts = list(zip(ts, vs))
    got = [_history_mod(pkg).derive_rate(pts) for pkg in PACKAGES]
    assert got[1] == got[0]


def test_unknown_resolution_is_refused_alike():
    for pkg in PACKAGES:
        h = _history_mod(pkg).MetricsHistory()
        with pytest.raises(ValueError, match="resolution must be one of"):
            h.query("Client.X", resolution="5m")
    assert _history_mod(PACKAGES[1]).RESOLUTIONS == \
        _history_mod(PACKAGES[0]).RESOLUTIONS
