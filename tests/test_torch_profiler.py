"""The port's stack sampler against the JAX package's, on the CPU.

- ``merge_flames`` folds the same seeded drained deltas into the same
  running totals in both packages;
- one sample of a thread parked in a known call chain gives a folded
  stack in the flame-graph format (``file:func`` frames joined by ``;``,
  root first), the same in both packages, and ``drain`` resets;
- with ``atpu.profile.enabled`` off nothing starts, so no sampler thread
  exists; switching it on starts one, off again joins it;
- the master's ``flame_report`` over the same heartbeat profiles is the
  same in both packages.
"""

import importlib
import threading

import numpy as np
import pytest
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: F401
    port_lock_order_audit, port_lockaudit_install,
)

pytest.importorskip("torch")

PACKAGES = ("alluxio_tpu", "alluxio_tpu_torch")
JAX, PORT = PACKAGES
THREAD = "atpu-stack-sampler"


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _deltas(seed: int, n: int = 12):
    rng = np.random.default_rng(seed)
    frames = [f"mod{i}.py:fn{i}" for i in range(6)]
    out = []
    for _ in range(n):
        stacks = {}
        for _ in range(int(rng.integers(0, 6))):
            depth = int(rng.integers(1, 5))
            key = ";".join(frames[int(k)] for k in rng.integers(0, 6, depth))
            stacks[key] = stacks.get(key, 0) + int(rng.integers(1, 9))
        d = {"samples": int(rng.integers(0, 50)),
             "dropped": int(rng.integers(0, 3)), "stacks": stacks}
        if rng.random() < 0.7:
            d["interval_ms"] = int(rng.integers(5, 200))
        out.append(d)
    return out


@pytest.mark.parametrize("seed", (0, 1, 2, 3))
def test_merge_flames_equal(seed):
    got = {}
    for pkg in PACKAGES:
        merge = _mod(pkg, "utils.profiler").merge_flames
        total, steps = None, []
        for d in _deltas(seed):
            total = merge(total, d)
            steps.append(total)
        got[pkg] = steps
    assert got[PORT] == got[JAX]


def _parked_in_chain(ready, release):
    def inner_leaf():
        ready.set()
        release.wait(10)

    def outer_caller():
        inner_leaf()

    outer_caller()


def test_one_sample_gives_the_folded_stack():
    got = {}
    for pkg in PACKAGES:
        ready, release = threading.Event(), threading.Event()
        t = threading.Thread(target=_parked_in_chain,
                             args=(ready, release), daemon=True)
        t.start()
        try:
            assert ready.wait(10)
            sampler = _mod(pkg, "utils.profiler").StackSampler(
                interval_ms=5, max_stacks=64, depth=4)
            sampler.sample_once()
            snap = sampler.snapshot()
            drained = sampler.drain()
            empty = sampler.drain()
        finally:
            release.set()
            t.join(10)
        assert not t.is_alive()
        mine = [k for k in snap["stacks"] if "inner_leaf" in k]
        assert len(mine) == 1, snap["stacks"]
        got[pkg] = (mine[0], snap["samples"], snap["interval_ms"],
                    drained["samples"], empty)
    assert got[PORT] == got[JAX]
    # root first, innermost last, the innermost ``depth`` frames kept
    folded = got[PORT][0].split(";")
    assert len(folded) == 4
    assert "test_torch_profiler.py:outer_caller;" \
        "test_torch_profiler.py:inner_leaf;threading.py:wait" in got[PORT][0]
    assert got[PORT][1:] == (1, 5, 1, None)


def test_stack_table_cap_drops_alike():
    got = {}
    for pkg in PACKAGES:
        sampler = _mod(pkg, "utils.profiler").StackSampler(max_stacks=1)
        sampler.sample_once()
        sampler.sample_once()
        snap = sampler.snapshot()
        got[pkg] = (len(snap["stacks"]), snap["samples"],
                    snap["dropped"] > 0)
    assert got[PORT] == got[JAX]
    assert got[PORT][0] == 1


def _sampler_threads():
    return [t for t in threading.enumerate() if t.name == THREAD]


def test_disabled_profiler_starts_no_thread():
    """Each package's process sampler follows ``atpu.profile.enabled``:
    off starts nothing; on starts one thread; off again joins it."""
    before = len(_sampler_threads())
    for pkg in PACKAGES:
        conf_mod = _mod(pkg, "conf")
        prof = _mod(pkg, "utils.profiler")
        conf = conf_mod.Configuration(load_env=False)
        try:
            prof.apply_profile_conf(conf)
            assert not prof.profiler().running
            assert len(_sampler_threads()) == before
            conf.set(conf_mod.Keys.PROFILE_ENABLED, True)
            conf.set(conf_mod.Keys.PROFILE_SAMPLE_INTERVAL_MS, 7)
            prof.apply_profile_conf(conf)
            assert prof.profiler().running
            assert prof.profiler().interval_ms == 7
            assert len(_sampler_threads()) == before + 1
        finally:
            conf.set(conf_mod.Keys.PROFILE_ENABLED, False)
            conf.set(conf_mod.Keys.PROFILE_SAMPLE_INTERVAL_MS, 97)
            prof.apply_profile_conf(conf)
            prof.profiler().drain()
        assert not prof.profiler().running
        assert len(_sampler_threads()) == before


def test_master_flame_report_equal():
    deltas = _deltas(9, 8)
    got = {}
    for pkg in PACKAGES:
        mm = _mod(pkg, "master.metrics_master").MetricsMaster()
        for i, d in enumerate(deltas):
            mm.handle_heartbeat({"source": f"worker-h{i % 2}:1",
                                 "metrics": {"Worker.X": 1.0},
                                 "profile": d})
        mm.handle_heartbeat({"source": "client-a", "metrics": {},
                             "profile": "not a dict"})
        got[pkg] = (mm.flame_report(), mm.flame_report("worker-h1:1"),
                    mm.flame_report("client-a"))
    assert got[PORT] == got[JAX]
    assert set(got[PORT][0]["sources"]) == {"worker-h0:1", "worker-h1:1"}
