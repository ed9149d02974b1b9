"""The rest of the port's worker against the JAX package's, on the CPU:
tier management, the metrics sinks, the web endpoint, the pause monitor
and the metrics heartbeat.

- ``AlignTask``, ``PromoteTask``, ``WatermarkRestoreTask`` and the
  load-aware ``ManagementTaskCoordinator`` on a seeded two-tier store
  make the same moves, in the same order, as the JAX tasks.
- The CSV, JSON-lines, console and Graphite sinks write the same lines
  for the same snapshot, and ``SinkManager`` builds the same sinks from
  the same conf.
- The web routes of the port's worker and of a JAX worker return the
  same keys and the same store state; ``/metrics`` is the Prometheus
  exposition.
- ``PauseMonitor`` reads the same pauses from the same sleeps.
- The port's worker, started in a JAX ``LocalCluster`` with the JAX
  master's meta client, ships its metrics heartbeat to the JAX master.
"""

import importlib
import json
import threading
import time
import urllib.request

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from tests.test_torch_worker_store import (  # noqa: E402
    JAX, KB, PORT, make_store, put_block,
)
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: E402,F401
    port_lock_order_audit, port_lockaudit_install,
)

PREFIXES = {"jax": "alluxio_tpu", "port": "alluxio_tpu_torch"}


def _mod(side, name):
    return importlib.import_module(f"{PREFIXES[side]}.{name}")


# -- tier management ----------------------------------------------------------
def _seeded_store(side, root, seed, annotator):
    """MEM (12 KiB) over SSD (64 KiB): 20 blocks of seeded sizes on seeded
    tiers, then 60 seeded accesses."""
    pkg = JAX if side == "jax" else PORT
    store = make_store(pkg, root / side, annotator=annotator,
                       mem_dirs=(12 * KB,), ssd_cap=64 * KB)
    rng = np.random.default_rng(seed)
    for bid in range(1, 21):
        size = int(rng.integers(KB // 2, 2 * KB))
        tier = "MEM" if rng.random() < 0.3 else "SSD"
        put_block(store, bid, bytes([bid]) * size, tier=tier)
    for bid in rng.integers(1, 21, 60):
        store.access_block(int(bid))
    store.events.clear()
    return store


def _report(store):
    return {t: sorted(ids) for t, ids in store.block_report().items()}


@pytest.mark.parametrize("annotator", ["LRU", "LRFU"])
@pytest.mark.parametrize("task", ["align", "promote", "watermark",
                                  "coordinator"])
def test_management_moves_match_jax(tmp_path, task, annotator):
    got = {}
    for side in ("jax", "port"):
        mgmt = _mod(side, "worker.management")
        store = _seeded_store(side, tmp_path, 11, annotator)
        if task == "align":
            result = [mgmt.AlignTask(store).run() for _ in range(3)]
        elif task == "promote":
            result = [mgmt.PromoteTask(store, quota_percent=90).run()
                      for _ in range(2)]
        elif task == "watermark":
            result = [mgmt.WatermarkRestoreTask(store, high=0.5,
                                                low=0.25).run()]
        else:
            coord = mgmt.ManagementTaskCoordinator(
                store, quota_percent=80, high_watermark=0.9,
                low_watermark=0.6)
            coord._tracker.is_idle()  # sync with this process's counter
            coord.heartbeat()  # idle: every task runs
            store.access_block(int(_report(store)["SSD"][0]))
            coord.heartbeat()  # a read since: backs off
            result = None
        got[side] = (result, store.events, _report(store))
    assert got["port"] == got["jax"]
    result, events, report = got["port"]
    assert events, "the seeded store gave the task nothing to move"


def test_align_swaps_out_of_order_blocks(tmp_path):
    """The JAX package's own case: a hotter SSD block swaps with a colder
    MEM block, in both packages."""
    for side, pkg in (("jax", JAX), ("port", PORT)):
        store = make_store(pkg, tmp_path / side, mem_dirs=(KB,),
                           ssd_cap=100 * KB)
        put_block(store, 1, b"a" * KB, tier="MEM")
        put_block(store, 2, b"b" * KB, tier="SSD")
        for _ in range(3):
            store.access_block(2)
        _mod(side, "worker.management").AlignTask(store).run()
        report = store.block_report()
        assert 2 in report["MEM"] and 1 in report["SSD"], side


# -- sinks --------------------------------------------------------------------
def _registry(side):
    r = _mod(side, "metrics.registry").MetricsRegistry("Worker")
    r.counter("Worker.TestOps").inc(7)
    r.counter("Worker.UfsBlocksRead").inc(3)
    r.register_gauge("Worker.TestGauge", lambda: 3.5)
    for s in (0.001, 0.02, 0.3):
        r.timer("Worker.UfsFetchTtfb").update(s)
    return r


def test_timer_recent_is_the_last_samples_sorted():
    """``Timer.recent(n)`` (port only: a turn's own samples) is the last
    ``n`` samples, sorted, and never more than the reservoir holds."""
    timer = _mod("port", "metrics.registry").Timer(reservoir=4)
    for s in (0.5, 0.1, 0.4, 0.3, 0.2):
        timer.update(s)
    assert timer.recent(0) == [] and timer.recent(2) == [0.2, 0.3]
    assert timer.recent(9) == [0.1, 0.2, 0.3, 0.4]
    assert timer.snapshot()["count"] == 5


def test_sinks_write_the_same_lines(tmp_path):
    import io

    got = {}
    for side in ("jax", "port"):
        sinks = _mod(side, "metrics.sinks")
        snap = _registry(side).snapshot()
        root = tmp_path / side
        csv = sinks.CsvSink(str(root / "csv"))
        csv.report(snap)
        csv.report(snap)
        jsonl = sinks.JsonLinesSink(str(root / "m.jsonl"))
        jsonl.report(snap)
        buf = io.StringIO()
        sinks.ConsoleSink(stream=buf).report(snap)
        files = sorted(p.name for p in (root / "csv").iterdir())
        rows = [(root / "csv" / f).read_text().splitlines()[0::2]
                for f in files]
        rec = json.loads((root / "m.jsonl").read_text())
        got[side] = (files, [r[0] for r in rows],
                     [[ln.split(",")[1] for ln in (root / "csv" / f)
                       .read_text().splitlines()[1:]] for f in files],
                     rec["metrics"], buf.getvalue().splitlines()[1:])
    assert got["port"] == got["jax"]
    files, headers, values, metrics, console = got["port"]
    assert headers == ["t,value"] * len(files)
    assert metrics["Worker.TestOps"] == 7 and "Worker.TestOps = 7" in console


def test_graphite_sink_speaks_the_same_protocol():
    import socket

    got = {}
    for side in ("jax", "port"):
        srv = socket.socket()
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        chunks = []

        def accept():
            c, _ = srv.accept()
            with c:
                while chunk := c.recv(4096):
                    chunks.append(chunk)

        t = threading.Thread(target=accept, daemon=True)
        t.start()
        sink = _mod(side, "metrics.sinks").GraphiteSink(
            "127.0.0.1", srv.getsockname()[1], prefix="clusterA")
        try:
            sink.report(_registry(side).snapshot())
            t.join(timeout=10)
        finally:
            sink.close()
            srv.close()
        lines = b"".join(chunks).decode().splitlines()
        got[side] = [ln.rsplit(" ", 1)[0] for ln in lines]
        assert all(int(ln.rsplit(" ", 1)[1]) > 1_500_000_000 for ln in lines)
    assert got["port"] == got["jax"]
    assert "clusterA.Worker.TestOps 7" in got["port"]


def test_sink_manager_from_conf_matches_jax(tmp_path):
    got = {}
    for side in ("jax", "port"):
        conf_mod = _mod(side, "conf")
        sinks = _mod(side, "metrics.sinks")
        reg = _registry(side)
        conf = conf_mod.Configuration(load_env=False)
        Keys = conf_mod.Keys
        conf.set(Keys.METRICS_SINKS, "csv,jsonl,bogus,graphite")
        conf.set(Keys.METRICS_SINK_CSV_DIR, str(tmp_path / side / "csv"))
        conf.set(Keys.METRICS_SINK_JSONL_PATH, str(tmp_path / side / "m.jl"))
        built = []
        for addr in ("", "carbon.internal", ":2003", "carbon:2003"):
            conf.set(Keys.METRICS_SINK_GRAPHITE_ADDRESS, addr)
            mgr = sinks.SinkManager(conf, reg)
            built.append([type(s).__name__ for s in mgr.sinks])
            mgr.close()
        mgr = sinks.SinkManager(conf, reg)
        mgr.heartbeat()
        mgr.close()
        got[side] = (built, (tmp_path / side / "csv" /
                             "Worker.TestOps.csv").exists(),
                     (tmp_path / side / "m.jl").exists())
    assert got["port"] == got["jax"]
    assert got["port"][0][-1] == ["CsvSink", "JsonLinesSink", "GraphiteSink"]


def test_failing_sink_does_not_kill_others(tmp_path):
    sinks = _mod("port", "metrics.sinks")

    class Boom(sinks.ConsoleSink):
        def report(self, snapshot):
            raise RuntimeError("boom")

    mgr = sinks.SinkManager.__new__(sinks.SinkManager)
    mgr._registry = _registry("port")
    path = tmp_path / "ok.jsonl"
    mgr.sinks = [Boom(), sinks.JsonLinesSink(str(path))]
    mgr.heartbeat()
    assert path.exists()


# -- pause monitor ------------------------------------------------------------
def test_pause_monitor_reads_the_same_pauses():
    sleeps = [0.5, 0.6, 1.7, 0.5, 6.2, 2.9, 0.51]
    got = {}
    for side in ("jax", "port"):
        reg = _mod(side, "metrics.registry").MetricsRegistry("Process")
        mon = _mod(side, "utils.pause_monitor").PauseMonitor(metrics=reg)
        pauses = [mon.observe(s) for s in sleeps]
        snap = reg.snapshot()
        got[side] = (pauses, mon.total_pause_s, mon.max_pause_s,
                     snap.get("Process.Pauses"),
                     snap.get("Process.SeverePauses"),
                     snap["Process.MaxPauseSeconds"])
    assert got["port"] == got["jax"]
    mon = _mod("port", "utils.pause_monitor").PauseMonitor(
        interval_s=0.01, metrics=_registry("port")).start()
    time.sleep(0.05)
    mon.stop()
    assert mon._thread is None


# -- the web endpoint ---------------------------------------------------------
def _web_worker(side, root):
    """A worker of ``side`` (its web endpoint on, port 0) holding the same
    seeded blocks over MEM and SSD."""
    from tests.testutils.torch_worker import StandInMaster

    conf_mod = _mod(side, "conf")
    Keys, Templates = conf_mod.Keys, conf_mod.Templates
    conf = conf_mod.Configuration(load_env=False)
    conf.set(Keys.WORKER_WEB_ENABLED, True)
    conf.set(Keys.WORKER_WEB_PORT, 0)
    conf.set(Keys.WORKER_WEB_BIND_HOST, "127.0.0.1")
    for lvl, (alias, cap) in enumerate((("MEM", 64 * KB),
                                        ("SSD", 256 * KB))):
        conf.set(Templates.WORKER_TIER_DIRS_PATH.format(lvl),
                 str(root / alias.lower()))
        conf.set(Templates.WORKER_TIER_DIRS_QUOTA.format(lvl), str(cap))
    worker = _mod(side, "worker.process").BlockWorker(conf, StandInMaster())
    worker.register_with_master() if side == "port" else \
        worker._master_sync.register_with_master()
    rng = np.random.default_rng(9)
    for bid in range(1, 9):
        data = rng.integers(0, 256, int(rng.integers(KB, 8 * KB)),
                            dtype=np.uint8).tobytes()
        put_block(worker.store, bid, data, tier="MEM" if bid % 3 else "SSD")
    worker.maybe_start_web()
    return worker


def _get(port, route):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                timeout=10) as r:
        return r.status, r.headers["Content-Type"], r.read()


def test_web_routes_match_jax(tmp_path):
    workers = {s: _web_worker(s, tmp_path / s) for s in ("jax", "port")}
    try:
        got = {}
        for side, w in workers.items():
            out = {}
            for route in ("/api/v1/worker/info", "/api/v1/worker/capacity",
                          "/api/v1/worker/blocks",
                          "/api/v1/worker/metrics"):
                status, ctype, body = _get(w.web_port, route)
                assert status == 200 and ctype == "application/json"
                out[route] = json.loads(body)
            info = out["/api/v1/worker/info"]
            cap = out["/api/v1/worker/capacity"]
            for t in cap["tiers"]:
                for d in t["dirs"]:
                    d.pop("path")
            status, ctype, prom = _get(w.web_port, "/metrics")
            html = _get(w.web_port, "/")[2]
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(w.web_port, "/api/v1/worker/nope")
            got[side] = (sorted(info), info["worker_id"], info["tiers"],
                         cap, out["/api/v1/worker/blocks"],
                         sorted(out["/api/v1/worker/metrics"]),
                         ctype, prom.startswith(b"# HELP"), html,
                         e.value.code)
        assert got["port"] == got["jax"]
        blocks = got["port"][4]["blocks"]
        assert blocks["MEM"]["count"] + blocks["SSD"]["count"] == 8
        assert sorted(blocks["MEM"]["sample"] + blocks["SSD"]["sample"]) \
            == list(range(1, 9))
    finally:
        for w in workers.values():
            w.stop()
    assert all(w.web_server is None for w in workers.values())


# -- the metrics heartbeat to a JAX master ------------------------------------
def test_port_worker_heartbeats_metrics_to_the_jax_master(tmp_path):
    """The port's worker, started (heartbeats, management, sinks) in a
    JAX cluster with the JAX master's meta client, reports its snapshot
    under its ``worker-host:port`` source; a JSON-lines sink beside it
    writes the same snapshot locally."""
    from alluxio_tpu.minicluster import LocalCluster
    from alluxio_tpu_torch.conf import Keys
    from alluxio_tpu_torch.metrics import metrics
    from alluxio_tpu_torch.utils.tracing import set_tracing_enabled, tracer

    from tests.testutils.torch_worker import PortWorker

    metrics().counter("Worker.UfsBlocksRead").inc(0)
    with LocalCluster(str(tmp_path), num_workers=0) as c:
        pw = PortWorker(c, str(tmp_path), heartbeat_s=0.05,
                        meta_client=c.meta_client(), conf_overrides={
                            Keys.WORKER_METRICS_HEARTBEAT_INTERVAL: "50ms",
                            Keys.METRICS_SINKS: "jsonl",
                            Keys.METRICS_SINK_INTERVAL: "50ms",
                            Keys.METRICS_SINK_JSONL_PATH:
                                str(tmp_path / "sink.jsonl")})
        set_tracing_enabled(True)
        try:
            with tracer().span("test.port_worker_span"):
                pass
            source = f"worker-localhost:{pw.port}"
            store = c.master.metrics_master.store

            def reported():
                with store._lock:
                    return dict(store._reports.get(source) or {})

            deadline = time.monotonic() + 20
            while "Worker.UfsBlocksRead" not in reported() and \
                    time.monotonic() < deadline:
                time.sleep(0.05)
            assert "Worker.UfsBlocksRead" in reported()
            assert any(s.get("name") == "test.port_worker_span" for s in
                       c.meta_client().get_trace(limit=100)["spans"])
            threads = {t.name for t in threading.enumerate()}
            assert {"Worker.ManagementTasks", "Worker.ClientMetrics",
                    "Worker.MetricsSinks"} <= threads
        finally:
            set_tracing_enabled(False)
            pw.stop()
        lines = (tmp_path / "sink.jsonl").read_text().splitlines()
        assert any("Worker.UfsBlocksRead" in json.loads(ln)["metrics"]
                   for ln in lines)
