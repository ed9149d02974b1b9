"""The port's metrics registry against the JAX package's: meters, trace
exemplars and their exposition.

- The same seeded sequence of counter steps, meter marks, timer updates
  (some with a trace-id exemplar) and gauges, on one patched clock, gives
  the same ``snapshot()`` and the same ``to_prometheus()`` text, line for
  line, in both packages; so do ``reset()`` and ``reset_metrics()``.
- A sampled striped read on the port's ``LocalCluster`` leaves a
  ``trace_id`` exemplar on a ``Client.ReadLatency`` bucket, and that id
  names a span the tracer recorded.
"""

import re
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

from alluxio_tpu.metrics import registry as jreg  # noqa: E402
from alluxio_tpu_torch.metrics import registry as treg  # noqa: E402
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: E402,F401
    port_lock_order_audit, port_lockaudit_install,
)


class Clock:
    """One clock for ``time.time`` and ``time.monotonic``."""

    def __init__(self) -> None:
        self.t = 1_700_000_000.0

    def ns(self):
        return SimpleNamespace(time=lambda: self.t,
                               monotonic=lambda: self.t)


def _script(reg, clock: Clock, seed: int) -> None:
    """Seeded counters, meters (marks spread over more than a minute, so
    the window trims), timers across every bucket with exemplars on some
    updates, and gauges (one dead)."""
    rng = np.random.default_rng(seed)
    for step in range(300):
        clock.t += float(rng.exponential(0.7))
        kind = int(rng.integers(5))
        name = ["Client.BytesRead", "Worker.Ops", "Events"][
            int(rng.integers(3))]
        if kind == 0:
            reg.counter(name).inc(int(rng.integers(1, 9)))
        elif kind == 1:
            reg.counter(name).dec(int(rng.integers(1, 3)))
        elif kind == 2:
            reg.meter(name + "Rate").mark(int(rng.integers(1, 5)))
        else:
            seconds = float(10 ** rng.uniform(-3.5, 1.5))
            ex = None if rng.random() < 0.4 \
                else f"{int(rng.integers(1 << 62)):016x}"
            reg.timer(["Client.ReadLatency.le4k", "Worker.Fetch"][
                kind - 3]).update(seconds, exemplar=ex)
    with reg.timer("Scoped").time():
        clock.t += 0.3
    reg.register_gauge("Worker.Capacity", lambda: 12.5)
    reg.register_gauge("Worker.Dead", lambda: 1 / 0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_snapshot_and_exposition_equal_jax(seed, monkeypatch):
    out = {}
    for mod in (jreg, treg):
        clock = Clock()
        monkeypatch.setattr(mod, "time", clock.ns())
        reg = mod.MetricsRegistry("Client")
        _script(reg, clock, seed)
        out[mod] = (reg.snapshot(), reg.to_prometheus(),
                    {n: (t.count, t.exemplars())
                     for n, t in reg._timers.items()},
                    {n: (m.count, m.one_minute_rate)
                     for n, m in reg._meters.items()},
                    {n: c.count for n, c in reg._counters.items()})
    assert out[treg][0] == out[jreg][0]
    assert out[treg][1].splitlines() == out[jreg][1].splitlines()
    assert out[treg][2:] == out[jreg][2:]
    # the script wrote meters, rates and exemplars, and a dead gauge
    # wrote nothing
    text = out[treg][1]
    assert "_rate1m" in text and 'trace_id="' in text
    assert "Worker_Dead" not in text
    assert any(k.endswith(".rate1m") for k in out[treg][0])


def test_reset_and_default_registry_equal_jax():
    for mod in (jreg, treg):
        reg = mod.MetricsRegistry()
        reg.counter("A").inc()
        reg.meter("B").mark()
        reg.timer("C").update(0.1, exemplar="ab")
        reg.register_gauge("D", lambda: 1.0)
        reg.reset()
        assert reg.snapshot() == {} and reg.to_prometheus() == "\n"
        old = mod.metrics()
        mod.reset_metrics()
        try:
            fresh = mod.metrics("Worker")
            assert fresh is not old and fresh.instance == "Worker"
            assert mod.metrics() is fresh
        finally:
            with mod._default_lock:
                mod._default = old


def test_exemplar_lands_on_the_first_bucket_that_holds_it():
    for mod in (jreg, treg):
        t = mod.Timer()
        t.update(0.003, exemplar="a")    # le 0.005
        t.update(0.2, exemplar="b")      # le 0.25
        t.update(60.0, exemplar="c")     # +Inf
        t.update(0.004)                  # no exemplar: keeps "a"
        got = {i: e[0] for i, e in t.exemplars().items()}
        assert got == {0: "a", 5: "b", len(t.HISTOGRAM_BUCKETS): "c"}
        assert t.count == 4


# -- the striped read's exemplar on the port's cluster -------------------------
def test_sampled_striped_read_leaves_a_trace_exemplar(tmp_path):
    from alluxio_tpu_torch.client.file_system import FileSystem
    from alluxio_tpu_torch.client.streams import WriteType
    from alluxio_tpu_torch.conf import Keys
    from alluxio_tpu_torch.metrics import metrics
    from alluxio_tpu_torch.minicluster import LocalCluster
    from alluxio_tpu_torch.utils import tracing

    block = 256 << 10
    payload = np.random.default_rng(3).integers(
        0, 256, size=block, dtype=np.uint8).tobytes()
    t = tracing.tracer()
    was = (t.enabled, t.sample_rate)
    with LocalCluster(str(tmp_path / "c"), num_workers=1, block_size=block,
                      worker_mem_bytes=8 * block) as cluster:
        fs = cluster.file_system()
        fs.write_all("/ex/a", payload, write_type=WriteType.MUST_CACHE)
        conf = cluster.conf.copy()
        conf.set(Keys.USER_SHORT_CIRCUIT_ENABLED, False)
        conf.set(Keys.USER_REMOTE_READ_STRIPE_SIZE, 32 << 10)
        reader = FileSystem(cluster.master.address, conf=conf)
        stripes = metrics().counter("Client.RemoteReadStripes")
        try:
            t.clear()
            t.configure(sample_rate=1.0)
            tracing.set_tracing_enabled(True)
            s0 = stripes.count
            assert bytes(reader.read_all("/ex/a")) == payload
            assert stripes.count - s0 == block // (32 << 10)
            spans = {s["trace_id"] for s in t.snapshot()
                     if s["name"] == "atpu.client.remote_read"}
        finally:
            tracing.set_tracing_enabled(was[0])
            t.configure(sample_rate=was[1])
            reader.close()
            fs.close()
    text = metrics().to_prometheus()
    ids = set(re.findall(
        r'^Client_ReadLatency_\w+_seconds_bucket\{le="[^"]+"\} \d+ '
        r'# \{trace_id="([0-9a-f]+)"\}', text, re.M))
    assert spans and ids & spans
