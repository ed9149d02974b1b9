"""The port's remediation engine against the JAX package's, on the CPU
(the stubs and fake clock of JAX's ``tests/test_remediation.py``).

- A seeded script of firing-alert sets (straggling and silent workers,
  hedge spikes, input stalls; alerts that burn, clear and come back)
  drives both engines against a stub block master and a stub
  replication checker on the same fake clock, each with a fresh metrics
  registry and its own metrics history. After every tick the engines'
  reports (audit rows with kind, rule, subject, outcome and detail, the
  quarantine set, the overlay and its version, the action window) and
  the heartbeat overlays are equal, and so are the stubs' quarantines
  and replication requests and the ``Master.Remediation*`` history
  series — with and without dry run, at the JAX default cap and at a cap
  that suppresses.
- ``FileSystem.apply_conf_overlay`` clamps pushed values, ignores keys
  outside its catalog and malformed values, is idempotent per version,
  and reverts withdrawn keys to the booted values alike in both clients.
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

PACKAGES = ("alluxio_tpu", "alluxio_tpu_torch")
JAX, PORT = PACKAGES
TICK_S = 10.0
RULES = ("read-latency-p99-regression", "heartbeat-staleness",
         "hedge-win-rate-spike", "input-stall-sustained",
         "cache-hit-ratio-drop")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


class _Clock:
    def __init__(self, t: float = 1_000_000.0) -> None:
        self.now = t

    def __call__(self) -> float:
        return self.now


class _Addr:
    def __init__(self, host, port):
        self.host, self.rpc_port = host, port


class _StubBM:
    """Listing, lookup, quarantine and release (JAX's test stub)."""

    def __init__(self, n=4):
        self.workers = {}
        for i in range(n):
            w = SimpleNamespace(
                id=100 + i, address=_Addr(f"h{i}", 29999),
                capacity_bytes_on_tiers={"MEM": 1 << 30, "SSD": 1 << 32},
                blocks={10 * i + j: ("MEM" if j % 3 else "SSD")
                        for j in range(12)})
            self.workers[w.id] = w
        self.quarantined = set()
        self.log = []

    def worker_id_for_source(self, source):
        for w in self.workers.values():
            if f"worker-{w.address.host}:{w.address.rpc_port}" == source:
                return w.id
        return None

    def get_worker_infos(self, include_lost=False,
                         include_quarantined=True):
        return [w for w in self.workers.values()
                if include_quarantined or w.id not in self.quarantined]

    def get_worker(self, wid):
        return self.workers.get(wid)

    def quarantine_worker(self, wid):
        self.log.append(("quarantine", wid))
        if wid not in self.workers:
            return False
        self.quarantined.add(wid)
        return True

    def release_worker(self, wid):
        self.log.append(("release", wid))
        try:
            self.quarantined.remove(wid)
            return True
        except KeyError:
            return False

    def quarantined_workers(self):
        return {w: 0 for w in self.quarantined}


class _StubReplication:
    def __init__(self):
        self.requests = []

    def request_replication(self, block_ids, *, replicas=1):
        self.requests.append((list(block_ids), replicas))
        return list(block_ids)[::2]


def _script(seed: int, ticks: int = 80):
    """Per tick, the set of firing (rule, subject) alerts. Each alert
    burns over seeded spans, so actions fire, hold, hit cooldowns and
    caps, pass probation and undo."""
    rng = np.random.default_rng(seed)
    spans = []
    for _ in range(10):
        rule = RULES[int(rng.integers(len(RULES)))]
        subject = f"worker-h{int(rng.integers(5))}:29999" \
            if rule in RULES[:2] else f"client-{int(rng.integers(2))}"
        a = int(rng.integers(0, ticks - 5))
        spans.append((rule, subject, a, a + int(rng.integers(2, 25))))
    return [[SimpleNamespace(rule=r, subject=s)
             for r, s, a, b in spans if a <= t < b] for t in range(ticks)]


def _drive(pkg: str, seed: int, **kw):
    clock = _Clock()
    bm, repl = _StubBM(), _StubReplication()
    mm_mod = _mod(pkg, "master.metrics_master")
    history = _mod(pkg, "metrics.history").MetricsHistory(clock=clock)
    mm = mm_mod.MetricsMaster(store=mm_mod.MetricsStore(clock=clock),
                              history=history)
    engine = _mod(pkg, "master.remediation").RemediationEngine(
        bm, metrics_master=mm, clock=clock, cooldown_s=60.0,
        probation_s=30.0, window_s=300.0,
        registry=_mod(pkg, "metrics.registry").MetricsRegistry(), **kw)
    engine.bind_replication(repl)
    seen = []
    for alerts in _script(seed):
        engine.on_alerts(alerts, clock.now)
        seen.append((engine.report(), engine.heartbeat_overlay(),
                     sorted(bm.quarantined)))
        clock.now += TICK_S
    series = {name: history.query(name) for name in history.names()}
    return seen, bm.log, repl.requests, series


@pytest.mark.parametrize("dry_run", (False, True), ids=("live", "dry"))
@pytest.mark.parametrize("cap", (4, 2))
@pytest.mark.parametrize("seed", (0, 1, 2))
def test_scripted_alerts_give_the_same_audit(seed, cap, dry_run):
    got = {pkg: _drive(pkg, seed, dry_run=dry_run,
                       max_actions_per_window=cap) for pkg in PACKAGES}
    assert got[PORT] == got[JAX]
    audit = got[PORT][0][-1][0]["audit"]
    outcomes = {a["outcome"] for a in audit}
    assert audit and ("dry-run" in outcomes) == dry_run
    assert {a["action"] for a in audit} & {"quarantine", "retune"}


def test_the_script_reaches_cap_cooldown_and_undo():
    """Across its cases the script exercises every gate: executed and
    suppressed actions, releases and reverts, re-replication."""
    rows = []
    for seed in (0, 1, 2):
        for cap in (4, 2):
            rows += _drive(PORT, seed, max_actions_per_window=cap
                           )[0][-1][0]["audit"]
    kinds = {(a["action"], a["outcome"]) for a in rows}
    for want in (("quarantine", "executed"), ("retune", "executed"),
                 ("release", "executed"), ("revert", "executed"),
                 ("re-replicate", "executed")):
        assert want in kinds
    assert {"suppressed-cap", "suppressed-cooldown"} <= \
        {a["outcome"] for a in rows}


def _client(pkg: str):
    """What ``apply_conf_overlay`` reads of its client: the remote-read
    runtime's conf and the clamp catalog."""
    conf = _mod(pkg, "client.remote_read").RemoteReadConf(
        hedge_quantile=0.9, concurrency=6)
    return SimpleNamespace(
        store=SimpleNamespace(remote_read=SimpleNamespace(conf=conf)),
        _OVERLAY_CLAMPS=_mod(pkg, "client.file_system"
                             ).FileSystem._OVERLAY_CLAMPS)


OVERLAYS = (
    ({"atpu.prefetch.budget.bytes": 512 << 20,
      "atpu.user.remote.read.concurrency": 8}, 1),
    ({"atpu.prefetch.budget.bytes": 512 << 20,
      "atpu.user.remote.read.concurrency": 8}, 1),  # same version: no-op
    ({"atpu.user.remote.read.hedge.quantile": 0.1,
      "atpu.user.remote.read.concurrency": 1000,
      "atpu.prefetch.budget.bytes": 1 << 40,
      "atpu.user.rpc.retry.duration": "1s"}, 2),  # clamped; unknown key
    ({"atpu.user.remote.read.concurrency": "many",
      "atpu.prefetch.budget.bytes": "4"}, 3),  # malformed, below floor
    ({}, 4),  # withdrawn: back to the booted values
)


def test_apply_conf_overlay_clamps_and_reverts_alike(monkeypatch):
    got = {}
    for pkg in PACKAGES:
        budgets = []
        monkeypatch.setattr(_mod(pkg, "prefetch.scheduler"),
                            "retune_budget", budgets.append)
        fs_cls = _mod(pkg, "client.file_system").FileSystem
        counter = _mod(pkg, "metrics").metrics().counter(
            "Client.ConfOverlayApplied")
        client = _client(pkg)
        steps = []
        for overlay, version in OVERLAYS:
            n0 = counter.count
            fs_cls.apply_conf_overlay(client, dict(overlay), version)
            c = client.store.remote_read.conf
            steps.append((c.hedge_quantile, c.concurrency,
                          list(budgets), counter.count - n0,
                          list(client._overlay_active)))
        got[pkg] = steps
    assert got[PORT] == got[JAX]
    assert got[PORT][0][:2] == (0.9, 8)
    assert got[PORT][2][:2] == (0.5, 64)
    assert got[PORT][-1][:3] == (0.9, 6, [512 << 20, 4 << 30, 16 << 20,
                                          None])
    assert fs_cls._OVERLAY_CLAMPS.keys() == \
        _mod(JAX, "client.file_system").FileSystem._OVERLAY_CLAMPS.keys()


def test_overlay_keys_and_rule_catalogs_equal():
    jax_r, port_r = (_mod(pkg, "master.remediation") for pkg in PACKAGES)
    for name in ("ACTION_QUARANTINE", "ACTION_REREPLICATE", "ACTION_RETUNE",
                 "ACTION_RELEASE", "ACTION_REVERT", "QUARANTINE_RULES",
                 "REREPLICATE_RULES", "OVERLAY_HEDGE_QUANTILE",
                 "OVERLAY_REMOTE_CONCURRENCY", "OVERLAY_PREFETCH_BUDGET"):
        assert getattr(port_r, name) == getattr(jax_r, name), name
    assert set(_mod(PORT, "client.file_system").FileSystem._OVERLAY_CLAMPS
               ) == {port_r.OVERLAY_HEDGE_QUANTILE,
                     port_r.OVERLAY_REMOTE_CONCURRENCY,
                     port_r.OVERLAY_PREFETCH_BUDGET}
