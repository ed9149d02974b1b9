"""The port's worker QoS against the JAX package's, on the CPU (the
counterparts of ``TestPriorityExecutor``, ``TestParkedPromotion`` and
``TestWorkerQosPipeline`` in ``tests/test_qos.py``).

Each case drives both packages' ``PriorityExecutor`` (or
``UfsBlockFetcher`` with QoS on) with the same submissions and must see
the same execution order; a seeded submission script of priority
classes, groups and promotions drains in the same order from both, with
QoS on and off.
"""

import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from alluxio_tpu import qos as jax_qos  # noqa: E402
from alluxio_tpu_torch import qos  # noqa: E402

MODULES = {"jax": jax_qos, "port": qos}


def _both(scenario, *args):
    got = {n: scenario(mod, *args) for n, mod in MODULES.items()}
    assert got["port"] == got["jax"]
    return got["port"]


def _until(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.005)
    return cond()


def _plugged(mod, **kw):
    """One-worker executor with its only thread occupied, so everything
    else queues deterministically."""
    ex = mod.PriorityExecutor(1, **kw)
    gate = threading.Event()
    started = threading.Event()

    def blocker():
        started.set()
        gate.wait(5)

    ex.submit(blocker, priority=mod.ON_DEMAND)
    assert started.wait(5)
    return ex, gate


# -- the executor -------------------------------------------------------------
def _overtake(mod):
    ex, gate = _plugged(mod, prioritize=True)
    order = []
    ex.submit(order.append, "pf", priority=mod.PREFETCH)
    ex.submit(order.append, "af", priority=mod.ASYNC_FILL)
    ex.submit(order.append, "od", priority=mod.ON_DEMAND)
    gate.set()
    assert _until(lambda: len(order) == 3)
    ex.shutdown()
    return order


def test_on_demand_overtakes_queued_prefetch():
    assert _both(_overtake) == ["od", "af", "pf"]


def _promote(mod):
    ex, gate = _plugged(mod, prioritize=True)
    order = []
    ex.submit(order.append, "pf-a", priority=mod.PREFETCH, group="a")
    ex.submit(order.append, "pf-b", priority=mod.PREFETCH, group="b")
    moved = ex.promote("b", mod.ON_DEMAND)
    gate.set()
    assert _until(lambda: len(order) == 2)
    ex.shutdown()
    return order, moved, ex.promoted


def test_promote_reorders_queued_group():
    assert _both(_promote) == (["pf-b", "pf-a"], 1, 1)


def _fifo(mod):
    ex, gate = _plugged(mod, prioritize=False)
    order = []
    ex.submit(order.append, "pf", priority=mod.PREFETCH)
    ex.submit(order.append, "od", priority=mod.ON_DEMAND)
    moved = ex.promote("x", mod.ON_DEMAND)
    gate.set()
    assert _until(lambda: len(order) == 2)
    ex.shutdown()
    return order, moved


def test_fifo_when_disabled():
    assert _both(_fifo) == (["pf", "od"], 0)


def _tenant_cap(mod):
    ex = mod.PriorityExecutor(2, prioritize=True, tenant_cap=1)
    release = threading.Event()
    order = []

    def hold(tag):
        order.append(tag)
        release.wait(5)

    ex.submit(hold, "a1", tenant="A")
    assert _until(lambda: order)
    ex.submit(order.append, "a2", tenant="A")  # parked: A at cap
    ex.submit(order.append, "b1", tenant="B")  # a free slot: runs
    assert _until(lambda: len(order) == 2)
    first = list(order)
    deferred = ex.deferred >= 1
    release.set()  # a1 done -> a2 unparked
    assert _until(lambda: len(order) == 3)
    ex.shutdown()
    return first, deferred, order


def test_tenant_cap_parks_and_resumes():
    assert _both(_tenant_cap) == (["a1", "b1"], True, ["a1", "b1", "a2"])


def _after_shutdown(mod):
    ex = mod.PriorityExecutor(1)
    ex.shutdown()
    with pytest.raises(RuntimeError):
        ex.submit(lambda: None)
    return True


def test_submit_after_shutdown_raises():
    assert _both(_after_shutdown)


@pytest.mark.parametrize("prioritize", [False, True])
def test_seeded_submission_script_drains_like_jax(prioritize):
    """60 seeded submissions (class, group) and 10 promotions queued
    behind a plugged worker drain in the same order from both
    packages' executors: FIFO with QoS off, by class then arrival (with
    the promotions) with it on."""
    rng = np.random.default_rng(23)
    classes = [int(c) for c in rng.choice(
        [qos.ON_DEMAND, qos.ASYNC_FILL, qos.PREFETCH], 60)]
    groups = [int(g) for g in rng.integers(0, 12, 60)]
    promotions = [(int(g), int(c)) for g, c in zip(
        rng.integers(0, 12, 10), rng.choice([qos.ON_DEMAND,
                                              qos.ASYNC_FILL], 10))]

    def script(mod):
        ex, gate = _plugged(mod, prioritize=prioritize)
        order = []
        for i, (c, g) in enumerate(zip(classes, groups)):
            ex.submit(order.append, i, priority=c, group=g)
        moved = [ex.promote(g, c) for g, c in promotions]
        queued = ex.queued()
        gate.set()
        assert _until(lambda: len(order) == len(classes))
        assert _until(lambda: ex.queued() == 0)
        ex.shutdown(wait=True)
        return order, moved, queued, ex.promoted

    order, moved, queued, promoted = _both(script)
    assert queued == 60 and sorted(order) == list(range(60))
    if not prioritize:
        assert order == list(range(60)) and promoted == 0
    else:
        assert promoted == sum(moved) > 0


# -- parked promotion ---------------------------------------------------------
def _parked_promotion(mod):
    ex = mod.PriorityExecutor(1, prioritize=True, tenant_cap=1)
    release = threading.Event()
    order = []

    def hold():
        order.append("hold")
        release.wait(5)

    ex.submit(hold, tenant="A", priority=mod.PREFETCH)
    assert _until(lambda: order)
    ex.submit(order.append, "old-pf", tenant="A", priority=mod.PREFETCH,
              group="g1")
    ex.submit(order.append, "joined", tenant="A", priority=mod.PREFETCH,
              group="g2")
    time.sleep(0.05)
    ex.promote("g2", mod.ON_DEMAND)  # the NEWER parked task
    release.set()
    assert _until(lambda: len(order) == 3)
    ex.shutdown()
    return order


def test_promoted_parked_task_uses_next_slot_first():
    assert _both(_parked_promotion) == ["hold", "joined", "old-pf"]


def _ready_counter(mod):
    ex = mod.PriorityExecutor(1, prioritize=True, tenant_cap=1)
    gate = threading.Event()
    ex.submit(lambda: gate.wait(5), tenant="A")
    time.sleep(0.05)
    for i in range(5):
        ex.submit(lambda: None, tenant="A", priority=mod.PREFETCH, group=i)
    ex.promote(3, mod.ON_DEMAND)
    gate.set()
    assert _until(lambda: ex.queued() == 0)
    ex.shutdown()
    return ex.queued()


def test_ready_counter_consistent_after_promote_and_park():
    assert _both(_ready_counter) == 0


# -- the worker's fetch pipeline with QoS on -----------------------------------
def _fetch_modules(name):
    if name == "jax":
        from alluxio_tpu.worker.ufs_fetch import FetchConf, UfsBlockFetcher
        from alluxio_tpu.worker.ufs_io import UfsBlockDescriptor
        return jax_qos, FetchConf, UfsBlockFetcher, UfsBlockDescriptor
    from alluxio_tpu_torch.worker.ufs_fetch import FetchConf, UfsBlockFetcher
    from alluxio_tpu_torch.worker.ufs_io import UfsBlockDescriptor
    return qos, FetchConf, UfsBlockFetcher, UfsBlockDescriptor


def _join_promotes(name):
    mod, FetchConf, Fetcher, Desc = _fetch_modules(name)
    gate = threading.Event()
    started = threading.Event()
    read_order = []

    class GatedUfs:
        def read_range(self, path, offset, length):
            if path == "/blocker":
                started.set()
                gate.wait(5)
            else:
                read_order.append(path)
            return b"\0" * length

    fetcher = Fetcher(None, FetchConf(
        stripe_size=1 << 20, concurrency=1, per_mount_limit=1,
        qos_enabled=True, tenant_limit=0))
    ufs = GatedUfs()

    def d(bid, path):
        return Desc(block_id=bid, ufs_path=path, offset=0, length=4096)

    try:
        blocker = fetcher.fetch(ufs, d(1, "/blocker"), cache=False,
                                priority=mod.ON_DEMAND, tenant="v")
        assert started.wait(5)
        early = fetcher.fetch(ufs, d(2, "/early-prefetch"), cache=False,
                              priority=mod.PREFETCH, tenant="a")
        late = fetcher.fetch(ufs, d(3, "/joined"), cache=False,
                             priority=mod.PREFETCH, tenant="a")
        # an on-demand reader joins block 3: its queued task promotes
        joined = fetcher.fetch(ufs, d(3, "/joined"), cache=False,
                               priority=mod.ON_DEMAND, tenant="v")
        assert joined is late
        gate.set()
        assert blocker.wait_done(5) and late.wait_done(5) \
            and early.wait_done(5)
        return read_order, late.priority, fetcher.qos_stats()["promoted"]
    finally:
        gate.set()
        fetcher.close()


def test_on_demand_join_promotes_queued_prefetch():
    got = {n: _join_promotes(n) for n in MODULES}
    assert got["port"] == got["jax"]
    assert got["port"] == (["/joined", "/early-prefetch"], qos.ON_DEMAND,
                           1.0)


def _victim_latency(name):
    mod, FetchConf, Fetcher, Desc = _fetch_modules(name)

    class SlowUfs:
        def read_range(self, path, offset, length):
            time.sleep(0.05)
            return b"\0" * length

    fetcher = Fetcher(None, FetchConf(
        stripe_size=1 << 20, concurrency=1, per_mount_limit=4,
        qos_enabled=True, tenant_limit=2))
    ufs = SlowUfs()
    try:
        for i in range(30):  # a deep abuser backlog
            fetcher.fetch(ufs, Desc(block_id=100 + i, ufs_path=f"/a{i}",
                                    offset=0, length=4096),
                          cache=False, priority=mod.PREFETCH,
                          tenant="abuser")
        t0 = time.monotonic()
        v = fetcher.fetch(ufs, Desc(block_id=1, ufs_path="/v", offset=0,
                                    length=4096),
                          cache=False, priority=mod.ON_DEMAND,
                          tenant="victim")
        v.result()
        latency = time.monotonic() - t0
        return latency, fetcher.qos_stats()["deferred"] > 0
    finally:
        fetcher.close()


def test_tenant_cap_keeps_slots_for_victim():
    """With the abuser capped below the mount limit, a victim read that
    arrives at a saturated executor rides a free slot instead of queueing
    behind the abuser's backlog (30 reads of 50 ms over two slots), in
    both packages."""
    for name in MODULES:
        latency, deferred = _victim_latency(name)
        assert latency < 0.4 and deferred, (name, latency)
