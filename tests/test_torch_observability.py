"""The port's observability loop end to end, against the JAX package's,
on the CPU: both packages' ``LocalCluster`` (a master and one worker).

At their defaults (history and health on, remediation and the web server
off):

- the same seeded metrics heartbeats give the same ``Cluster.*``
  aggregates in ``get_metrics`` (sums, the input-bound fraction a mean);
- the history holds the same series names, and the same points for each;
- ``get_health`` names the same rules in the same states, and a stalled
  client fires ``input-stall-sustained`` in both;
- a traced remote read stitches the same set of span names in
  ``get_trace``, the port's worker spans inside the read's trace;
- a worker the block master declares lost ends its history series and
  leaves the aggregates, and re-registration revives it.

With remediation and the web server switched on, a stalled client's
alert pushes the retuning overlay, and the client applies it on its next
metrics heartbeat in both; the web routes answer with the same JSON keys
(the quorum view's ``/masters`` among them, with the same row), and the
dashboard shows the same sections.

One difference: the JAX master samples its lock-wait and journal series
with ``Timer.percentile(0.99)`` on a percentile that takes percent, so
its ``.p99`` series holds the reservoir's low end; the port's holds the
99th percentile.
"""

import importlib
import json
import urllib.request

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

PACKAGES = ("alluxio_tpu", "alluxio_tpu_torch")
JAX, PORT = PACKAGES
KB = 1024
BLOCK = 64 * KB
LOOP_CONF = {"atpu.master.remediation.enabled": True,
             "atpu.master.web.enabled": True,
             "atpu.master.web.port": 0,
             "atpu.master.health.fire.after": "0s",
             "atpu.master.remediation.probation": "0s"}
WEB_ROUTES = ("info", "capacity", "metrics", "metrics/history", "health",
              "remediation", "metastore", "mounts", "catalog", "trace",
              "trace/profile", "profile", "logs", "browse", "masters")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _cluster(pkg: str, base: str, conf_overrides=None):
    return _mod(pkg, "minicluster").LocalCluster(
        base, num_workers=1, block_size=BLOCK,
        worker_mem_bytes=4 * 1024 * KB, conf_overrides=conf_overrides)


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    out = {pkg: _cluster(pkg, str(tmp_path_factory.mktemp(pkg)))
           for pkg in PACKAGES}
    for c in out.values():
        c.start()
    try:
        yield out
    finally:
        for c in out.values():
            c.stop()


def _snapshots(seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for i, src in enumerate(("worker-obs0:1", "worker-obs1:1",
                             "client-obs-a", "client-obs-b")):
        snap = {"Worker.ObsBlocksServed": float(rng.integers(0, 1000)),
                "Worker.ObsReadTime.p99": float(rng.random()),
                "Client.InputBoundFraction": float(rng.random()),
                "Client.ObsBytesRead.shm": float(rng.integers(0, 1 << 30)),
                "Spoofed.Name": 1.0}
        out.append((src, snap))
    return out


def test_cluster_aggregates_and_history_alike(clusters):
    got = {}
    for pkg, c in clusters.items():
        meta = c.meta_client()
        for _ in range(3):
            for src, snap in _snapshots(5):
                meta.metrics_heartbeat(src, snap)
        agg = {k: v for k, v in meta.get_metrics().items()
               if k.startswith("Cluster.") and "Obs" in k
               or k in ("Cluster.InputBoundFraction",
                        "Cluster.MetricsSources")}
        names = meta.get_metrics_history()["names"]
        series = {n: [(e["source"], [p[1] for p in e["points"]])
                      for e in meta.get_metrics_history(n)["series"]
                      if e["source"] != "cluster"]
                  for n in names if "Obs" in n or "InputBound" in n}
        got[pkg] = (agg, [n for n in names if "Obs" in n or
                          n.endswith("InputBoundFraction")], series)
    assert got[PORT] == got[JAX]
    agg = got[PORT][0]
    fractions = [s["Client.InputBoundFraction"] for _, s in _snapshots(5)]
    assert agg["Cluster.InputBoundFraction"] == pytest.approx(
        sum(fractions) / len(fractions), rel=1e-12)
    assert "Cluster.ObsReadTime.p99" not in agg


def test_history_series_names_alike(clusters):
    """After the same heartbeats and a metadata sample on the master,
    the history records the same series names (the synthetic sources'
    and the master's own)."""
    got = {}
    for pkg, c in clusters.items():
        meta = c.meta_client()
        for src, snap in _snapshots(6):
            meta.metrics_heartbeat(src, snap)
        c.master._sample_metadata_history()
        got[pkg] = sorted(
            n for n in meta.get_metrics_history()["names"]
            if n.startswith(("Master.Metadata", "Master.Metastore"))
            or "Obs" in n)
    assert got[PORT] == got[JAX]
    assert "Master.MetadataInodeLockWaitTime.p99" in got[PORT]


def test_health_rules_and_states_alike(clusters):
    got = {}
    for pkg, c in clusters.items():
        meta = c.meta_client()
        meta.metrics_heartbeat("client-stalled",
                               {"Client.InputBoundFraction": 0.97})
        report = meta.get_health()
        got[pkg] = (report["status"], [r["name"] for r in report["rules"]],
                    sorted((a["rule"], a["subject"], a["state"])
                           for a in report["alerts"] + report["pending"]))
        meta.metrics_heartbeat("client-stalled",
                               {"Client.InputBoundFraction": 0.0})
    assert got[PORT] == got[JAX]
    assert ("input-stall-sustained", "client-stalled", "pending") in \
        got[PORT][2]


def test_traced_remote_read_stitches_the_same_span_names(clusters):
    got = {}
    for pkg, c in clusters.items():
        keys = _mod(pkg, "conf").Keys
        tracing = _mod(pkg, "utils.tracing")
        conf = c.conf.copy()
        conf.set(keys.USER_SHORT_CIRCUIT_ENABLED, False)
        conf.set(keys.USER_REMOTE_READ_STRIPE_SIZE, 16 * KB)
        fs = _mod(pkg, "client.file_system").FileSystem(c.master.address,
                                                        conf=conf)
        payload = np.random.default_rng(3).integers(
            0, 255, 3 * BLOCK, dtype=np.uint8).tobytes()
        try:
            fs.write_all("/obs/traced", payload,
                         write_type=_mod(pkg, "client.streams"
                                         ).WriteType.MUST_CACHE)
            tracing.tracer().clear()
            tracing.set_tracing_enabled(True)
            with fs.open_file("/obs/traced") as f:
                assert f.pread(BLOCK + 100, 40 * KB) == \
                    payload[BLOCK + 100:BLOCK + 100 + 40 * KB]
        finally:
            tracing.set_tracing_enabled(False)
            fs.close()
        trace = c.meta_client().get_trace(limit=2000)
        tracing.tracer().clear()
        spans = trace["spans"]
        (read,) = [s for s in spans if s["name"] ==
                   "atpu.client.remote_read"]
        same = [s["name"] for s in spans
                if s["trace_id"] == read["trace_id"]]
        got[pkg] = ({s["name"] for s in spans}, sorted(same))
    assert got[PORT][0] == got[JAX][0]
    assert "atpu.BlockWorker.read_block" in got[PORT][0]
    # the port's stripes carry the read's context: its worker spans (one
    # a stripe, and one more for a hedge) join its trace
    port_trace = got[PORT][1]
    assert port_trace.count("atpu.client.remote_read") == 1
    assert port_trace.count("atpu.BlockWorker.read_block") >= 3
    assert set(port_trace) == {"atpu.client.remote_read",
                               "atpu.BlockWorker.read_block"}
    assert got[JAX][1] == ["atpu.client.remote_read"]


def test_lost_worker_ends_its_series_and_revives(clusters):
    got = {}
    for pkg, c in clusters.items():
        bm = c.master.block_master
        meta = c.meta_client()
        (info,) = bm.get_worker_infos()
        src = f"worker-{info.address.host}:{info.address.rpc_port}"
        meta.metrics_heartbeat(src, {"Worker.ObsLost": 3.0})
        hist = c.master.metrics_master.history
        for listener in bm.lost_worker_listeners:
            listener(info)
        ended = src in hist.ended_sources()
        blocked = meta.metrics_heartbeat(src, {"Worker.ObsLost": 4.0})
        sources = c.master.metrics_master.store.sources()
        series = meta.get_metrics_history("Worker.ObsLost")["series"]
        for listener in bm.registered_worker_listeners:
            listener(info)
        revived = src not in hist.ended_sources()
        got[pkg] = (ended, blocked, src in sources,
                    [(e["ended_at"] is not None, len(e["points"]))
                     for e in series], revived)
    assert got[PORT] == got[JAX]
    assert got[PORT][0] and got[PORT][-1] and not got[PORT][2]


def test_metadata_lock_wait_p99_is_the_99th_percentile(clusters):
    """The port samples the timer's 99th percentile; JAX passes 0.99 to
    a percentile that takes percent and records the reservoir's low end
    (the difference this module's docstring states)."""
    got = {}
    for pkg, c in clusters.items():
        timer = _mod(pkg, "metrics").metrics().timer(
            "Master.MetadataInodeLockWaitTime")
        for ms in range(1, 101):
            timer.update(ms / 1000.0)
        c.master._sample_metadata_history()
        got[pkg] = c.master.metrics_master.history.latest(
            "Master.MetadataInodeLockWaitTime.p99", "master")
        assert got[pkg] == timer.percentile(99 if pkg == PORT else 0.99)
    assert got[PORT] > got[JAX]


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    out = {pkg: _cluster(pkg, str(tmp_path_factory.mktemp(f"loop-{pkg}")),
                         dict(LOOP_CONF)) for pkg in PACKAGES}
    for c in out.values():
        c.start()
    try:
        yield out
    finally:
        for c in out.values():
            c.stop()


def test_remediation_overlay_reaches_the_client(loops):
    got = {}
    for pkg, c in loops.items():
        fs = c.file_system()
        counter = _mod(pkg, "metrics").metrics().counter(
            "Client.ConfOverlayApplied")
        try:
            meta = c.meta_client()
            base = fs.store.remote_read.conf.concurrency
            meta.metrics_heartbeat("client-stalled",
                                   {"Client.InputBoundFraction": 0.97})
            c.master.health_monitor.evaluate()
            n0 = counter.count
            fs.send_metrics()
            pushed = (fs._overlay_version,
                      fs.store.remote_read.conf.concurrency,
                      counter.count - n0, sorted(fs._overlay_active))
            meta.metrics_heartbeat("client-stalled",
                                   {"Client.InputBoundFraction": 0.0})
            audit = [(a["action"], a["rule"], a["subject"], a["outcome"])
                     for a in meta.get_health()["remediation"]["audit"]]
            got[pkg] = (base, pushed, audit)
        finally:
            fs.close()
    assert got[PORT] == got[JAX]
    base, pushed, audit = got[PORT]
    assert pushed[:3] == (1, 2 * base, 1)
    assert ("retune", "input-stall-sustained", "client-stalled",
            "executed") in audit


def test_web_routes_answer_with_the_same_keys(loops):
    got = {}
    for pkg, c in loops.items():
        keys = {}
        for route in WEB_ROUTES:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{c.master.web_port}"
                    f"/api/v1/master/{route}", timeout=30) as r:
                keys[route] = sorted(json.loads(r.read()))
        with urllib.request.urlopen(
                f"http://127.0.0.1:{c.master.web_port}/", timeout=30) as r:
            keys["/"] = r.headers["Content-Type"]
        got[pkg] = keys
    assert got[PORT] == got[JAX]


def test_masters_route_and_dashboard_section_alike(loops):
    """The quorum view on the web server: one PRIMARY row, the leader,
    with the same keys in both packages; the dashboard holds the same
    sections, ``Masters`` among them."""
    got = {}
    for pkg, c in loops.items():
        base = f"http://127.0.0.1:{c.master.web_port}"
        with urllib.request.urlopen(f"{base}/api/v1/master/masters",
                                    timeout=30) as r:
            view = json.loads(r.read())
        (row,) = view["masters"]
        assert view["leader"] == row["address"]
        with urllib.request.urlopen(f"{base}/", timeout=30) as r:
            page = r.read().decode()
        got[pkg] = (sorted(row), row["role"], row["lag_entries"],
                    "Masters" in page, "j('/masters')" in page)
    assert got[PORT] == got[JAX]
    assert got[PORT][1:] == ("PRIMARY", 0, True, True)
