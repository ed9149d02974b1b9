"""The port's ``fsadmin``, ``job`` and ``table`` shells against the JAX
package's, on the CPU.

Mirrors JAX's ``tests/test_shell.py`` (its fsadmin and job cases), the
doctor case of ``tests/test_config_distribution.py`` and the fsadmin
cases of ``tests/test_{observability,metrics_history,remediation,
ha_failover}.py``: one seeded operator script runs through each
package's shells against that package's ``LocalCluster`` (one worker,
the job service, the web server, health rules that fire at once), one
package after the other in the same directory, on a metrics registry of
its own; a second script reads the remediation engine's dry run on a
cluster of three workers (the straggler rule compares a worker with the
fleet's median).
Every command's exit code, stdout and stderr must be equal once times,
cluster ids, ports, uptimes and the host's name are masked
(``tests/testutils/torch_shell.py``).

Two kinds of step compare less than the whole output:

- ``report metrics`` and ``metrics`` list the metric names only, and the
  port's list may hold ``PORT_ONLY_METRICS`` besides JAX's: the values
  are timings and counts of a shared in-process registry;
- ``trace`` dumps list which of the traced write's own spans they hold
  (``WRITE_SPANS``), without the random trace ids, the measured
  durations, the thread names and the heartbeats that fall in the
  window.

The job workers' load average, which ``report jobservice`` prints, is
the host's and is masked as well.
"""

import importlib
import re
import time

import numpy as np
import pytest

pytest.importorskip("pyarrow")
pytest.importorskip("torch")
pytest.importorskip("jax")

from tests.testutils import torch_shell as ts  # noqa: E402
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: E402,F401
    port_lock_order_audit, port_lockaudit_install,
)

PORT, JAX = "alluxio_tpu_torch", "alluxio_tpu"

#: gauges only the port's master registers, each stated in the port's
#: ``master/process.py`` docstring (the audit writer's dropped counts)
PORT_ONLY_METRICS = {"Master.AuditLogDropped",
                     "Master.AuditLogDroppedDenied"}
SECRET = "s3cret-token"
#: the load job is the job service's first job, the transform its second
TRANSFORM_JOB = 2


def _files(pkg, cluster, fs):
    import io

    import pyarrow as pa
    import pyarrow.parquet as pq

    fs.write_all("/r/a", b"a" * 3000)
    fs.write_all("/r/b", b"b" * 5000)
    for year in (2019, 2020):
        rng = np.random.default_rng(year)
        t = pa.table({"id": rng.integers(0, 1 << 30, 40, dtype=np.int64),
                      "qty": rng.integers(0, 100, 40, dtype=np.int32)})
        sink = io.BytesIO()
        pq.write_table(t, sink)
        fs.write_all(f"/wh/sales/year={year}/part-000.parquet",
                     sink.getvalue())


def _load_job(pkg, cluster, fs):
    jc = cluster.job_client()
    info = jc.wait_for_job(jc.run({"type": "load", "path": "/r/a"}))
    return info.status


def _worker_sources(cluster):
    return [f"worker-{h.worker.address.host}:{h.worker.address.rpc_port}"
            for h in cluster.workers]


def _straggler(pkg, cluster, fs):
    """One worker's read p99 far over the fleet's median: the remediation
    engine (dry run) audits a quarantine it does not carry out."""
    for src, p99 in zip(_worker_sources(cluster), (0.002, 0.002, 0.5)):
        cluster.master.metrics_master.handle_heartbeat(
            {"source": src, "metrics": {"Worker.ReadBlockTime.p99": p99}})
    cluster.master.health_monitor.evaluate()
    return (sorted(a["outcome"] for a in
                   cluster.master.remediation.report()["audit"]),
            cluster.master.block_master.quarantined_workers() == {},
            len(cluster.block_client().get_worker_infos()))


def _stalled_client(pkg, cluster, fs):
    mc = cluster.meta_client()
    for _ in range(3):
        mc.metrics_heartbeat("client-stalled", {
            "Client.InputBoundFraction": 0.95,
            "Client.InputStallUs.ufs": 9e6,
            "Client.InputStallCount.ufs": 12,
            "Client.InputStallBytes.ufs": 48 << 20,
            "Client.InputStallUs.shm": 5e5,
            "Client.InputStallCount.shm": 40,
            "Client.InputStallBytes.shm": 160 << 20,
            "Client.InputStallSizeUs.ge1m": 9.5e6,
            "Client.InputStallSizeCount.ge1m": 52})
        time.sleep(0.05)
    for i in range(8):
        mc.metrics_heartbeat("client-h", {"Client.InputBoundFraction": i / 10})


def _process_stall(pkg, cluster, fs):
    """A severe stall of the process-wide pause monitor, counted in the
    run's registry (the monitor keeps the registry of the moment it was
    made, which may be another test's)."""
    pm = ts.mod(pkg, "utils.pause_monitor").ensure_process_monitor()
    cluster._saved_pause = (pm.max_pause_s, pm.total_pause_s, pm._m)
    pm._m = ts.mod(pkg, "metrics").metrics()
    pm.observe(8.0)


def _process_unstall(pkg, cluster, fs):
    """The monitor's state put back (its counter went to the run's own
    registry, which goes with the run)."""
    pm = ts.mod(pkg, "utils.pause_monitor").ensure_process_monitor()
    pm.max_pause_s, pm.total_pause_s, pm._m = cluster._saved_pause


def _traced_write(pkg, cluster, fs):
    fs.write_all("/traced/x", b"1")


def _tracing_off(pkg, cluster, fs):
    ts.mod(pkg, "utils.tracing").set_tracing_enabled(False)


def _wait_transform(pkg, cluster, fs):
    """The transform the script started (the job service's second job)
    is applied."""
    tc = ts.mod(pkg, "rpc.table_service").TableMasterClient(
        cluster.master.address)
    deadline = time.monotonic() + 60
    while True:
        st = tc.transform_status(TRANSFORM_JOB)
        if st.get("applied") or st["status"] in ("FAILED", "CANCELED"):
            return st["status"], bool(st.get("applied"))
        assert time.monotonic() < deadline, st
        time.sleep(0.05)


def _tick_management(pkg, cluster, fs):
    """One tick of each worker's management tasks, whose load tracker
    registers ``Worker.BlocksAccessed`` (on its own timer the tick may
    come before or after the metric listing)."""
    for handle in cluster.workers:
        handle.worker._mgmt.heartbeat()


def _log_level(pkg, cluster, fs):
    import logging

    return logging.getLevelName(logging.getLogger("atpu.shell.test").level)


SETUPS = {"files": _files, "load_job": _load_job, "straggler": _straggler,
          "stalled_client": _stalled_client,
          "process_stall": _process_stall,
          "process_unstall": _process_unstall,
          "traced_write": _traced_write, "tracing_off": _tracing_off,
          "wait_transform": _wait_transform, "log_level": _log_level,
          "tick_management": _tick_management}

SCRIPT = [
    ("py", "files"),
    ("fsadmin", ["report"], "cross"),
    ("fsadmin", ["report", "summary"]),
    ("fsadmin", ["report", "capacity"], "cross"),
    ("fsadmin", ["report", "ufs"]),
    ("py", "tick_management"),
    ("fsadmin", ["report", "metrics"], "keys"),
    ("fsadmin", ["report", "metrics", "Worker.UfsFetchFailures"]),
    ("py", "load_job"),
    ("fsadmin", ["report", "jobservice"], "cross"),
    ("job", ["ls"], "cross"),
    ("job", ["stat", "-v", "1"]),
    ("job", ["stat", "99"]),
    ("job", ["leader"]),
    ("job", ["cancel", "1"]),
    ("job", ["frobnicate"]),
    ("py", "stalled_client"),
    ("fsadmin", ["report", "health"], "cross"),
    ("fsadmin", ["report", "stall"], "cross"),
    ("fsadmin", ["report", "history", "Client.InputBoundFraction"]),
    ("fsadmin", ["report", "history"]),
    ("fsadmin", ["report", "history", "--rate"]),
    ("fsadmin", ["report", "history", "Client.InputBoundFraction",
                 "--resolution", "1m"]),
    ("fsadmin", ["report", "qos"]),
    ("fsadmin", ["report", "masters"]),
    ("fsadmin", ["report", "metastore"]),
    ("fsadmin", ["report", "readpath"]),
    ("fsadmin", ["doctor"], "cross"),
    ("py", "process_stall"),
    ("fsadmin", ["doctor"]),
    ("py", "process_unstall"),
    ("fsadmin", ["getConf"]),
    ("fsadmin", ["getConf", "atpu.master.hostname"], "cross"),
    ("fsadmin", ["getConf", "atpu.security.login.token"], "cross"),
    ("fsadmin", ["getConf", "--source", "atpu.user.file.writetype.default"]),
    ("fsadmin", ["pathConf", "add", "--property",
                 "atpu.user.file.writetype.default=THROUGH", "/r"]),
    ("fsadmin", ["pathConf", "list"]),
    ("fsadmin", ["pathConf", "show", "/r/a"]),
    ("fsadmin", ["pathConf", "remove", "/r"]),
    ("fsadmin", ["journal", "checkpoint"]),
    ("fsadmin", ["journal", "quorum"]),
    ("fsadmin", ["journal", "quorum", "--transfer", "m1"]),
    ("fsadmin", ["journal", "dump", "--folder", f"{ts.BASE}/journal",
                 "--end", "5"]),
    ("fsadmin", ["backup", f"{ts.BASE}/backups"]),
    ("fsadmin", ["logLevel", "--logName", "atpu.shell.test", "--level",
                 "ERROR"]),
    ("py", "log_level"),
    ("fsadmin", ["trace", "--on"]),
    ("py", "traced_write"),
    ("fsadmin", ["trace", "--limit", "50", "--prefix", "atpu."], "spans"),
    ("fsadmin", ["trace", "--off"]),
    ("py", "tracing_off"),
    ("fsadmin", ["metrics", "Master.rpc.get_status"], "keys"),
    ("table", ["attachdb", "fs", "/wh", "--db", "wh"]),
    ("table", ["ls"], "cross"),
    ("table", ["ls", "wh"]),
    ("table", ["ls", "wh", "sales"], "cross"),
    ("table", ["sync", "wh"]),
    ("table", ["transform", "wh", "sales"]),
    ("py", "wait_transform"),
    ("table", ["transformStatus", str(TRANSFORM_JOB)]),
    ("table", ["detachdb", "wh"]),
    ("table", ["ls"]),
    ("fsadmin", []),
    ("fsadmin", ["frobnicate"]),
]

#: exit codes the JAX tests assert (parity alone would pass two equal
#: failures); every other shell step must exit 0 in both packages
EXPECT = {
    "fsadmin report metrics Worker.UfsFetchFailures": 2,
    "job stat 99": 1, "job frobnicate": 1,
    "fsadmin report health": 1,
    "fsadmin report history --rate": 2,
    "fsadmin journal quorum": 1,
    "fsadmin journal quorum --transfer m1": 1,
    "fsadmin frobnicate": 1,
}

_SPAN = re.compile(r"(atpu\.[A-Za-z0-9_.]+)")
_LOAD = re.compile(r"(load )\d+\.\d+")
_AGE = re.compile(r"\d+\.\d+s$")


def _keys(text: str, pkg: str) -> tuple:
    names = {line.split()[0] for line in text.splitlines()
             if line.strip() and not line.startswith(" ")}
    return tuple(sorted(names - PORT_ONLY_METRICS)) if pkg == PORT \
        else tuple(sorted(names))


#: the spans of the traced write's own calls; the heartbeats of the
#: worker and the job service land in the window as they please
WRITE_SPANS = {"atpu.FileSystemMaster.create_file",
               "atpu.FileSystemMaster.get_new_block_id",
               "atpu.FileSystemMaster.complete_file",
               "atpu.BlockMaster.commit_block",
               "atpu.BlockWorker.create_local_block",
               "atpu.BlockWorker.complete_local_block"}


def _spans(text: str) -> tuple:
    return tuple(sorted(set(_SPAN.findall(text)) & WRITE_SPANS))


def _conf(base: str) -> dict:
    return {"atpu.user.file.writetype.default": "MUST_CACHE",
            "atpu.security.login.token": SECRET,
            # the JAX cluster keeps the default (/tmp) unless told
            "atpu.master.fastpath.dir": base,
            "atpu.master.backup.directory": f"{base}/backups",
            "atpu.master.web.enabled": True,
            "atpu.master.web.port": 0,
            "atpu.master.health.fire.after": "0s",
            "atpu.master.health.resolve.after": "0s",
            # long enough that a loaded host's pause between the stalled
            # heartbeats and the report cannot age them out
            "atpu.master.health.stall.window": "60s",
            "atpu.master.metrics.history.max.series": 300,
            "atpu.master.health.eval.interval": "10min",
            "atpu.table.transform.manager.job.monitor.interval": "100ms",
            "atpu.worker.block.heartbeat.interval": "50ms"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("shadm") / "c")
    out = {}
    for pkg in ts.PACKAGES:
        got = ts.run_script(pkg, base, SCRIPT, SETUPS, cluster_kwargs={
            "conf_overrides": _conf(base)})
        for i, step in enumerate(SCRIPT):
            sid = ts.step_id(i, step)
            for key in (sid, "cross " + sid):
                if key not in got or step[0] == "py":
                    continue
                code, text, err = got[key]
                if "keys" in step[2:]:
                    text = _keys(text, pkg)
                elif "spans" in step[2:]:
                    text = _spans(text)
                else:
                    text = _LOAD.sub(r"\1<LOAD>", text)
                got[key] = (code, text, err)
        out[pkg] = got
    return out


HEAL_SCRIPT = [
    ("py", "straggler"),
    ("fsadmin", ["report", "health"], "cross"),
    ("fsadmin", ["report", "capacity"]),
]


@pytest.fixture(scope="module")
def heal_runs(tmp_path_factory):
    """JAX's ``test_dry_run_minicluster_audits_only``: three workers,
    remediation on in dry run."""
    base = str(tmp_path_factory.mktemp("shheal") / "c")
    return {pkg: ts.run_script(pkg, base, HEAL_SCRIPT, SETUPS, cluster_kwargs={
        "num_workers": 3, "start_job_service": False,
        "conf_overrides": {
            "atpu.master.fastpath.dir": base,
            "atpu.master.remediation.enabled": True,
            "atpu.master.remediation.dry.run": True,
            "atpu.master.health.fire.after": "0s",
            "atpu.master.health.eval.interval": "10min"}})
        for pkg in ts.PACKAGES}


@pytest.mark.parametrize("sid", [ts.step_id(i, s)
                                 for i, s in enumerate(HEAL_SCRIPT)])
def test_remediation_dry_run_matches_jax(heal_runs, sid):
    assert heal_runs[PORT][sid] == heal_runs[JAX][sid]
    got = heal_runs[PORT][sid]
    if sid.endswith("py straggler"):
        assert "dry-run" in got[0] and got[1:] == (True, 3)
    elif "report health" in sid:
        assert "Self-healing (DRY-RUN)" in got[1]
    if "cross" in sid or "health" in sid:
        assert heal_runs[PORT]["cross " + sid] == got


def _ids(cross: bool = False):
    return [ts.step_id(i, s) for i, s in enumerate(SCRIPT)
            if (s[0] != "py" or s[1] in ("load_job", "log_level",
                                         "wait_transform"))
            and (not cross or "cross" in s[2:])]


def _sid(sid: str) -> str:
    return sid.split(" ", 1)[1]


@pytest.mark.parametrize("sid", _ids())
def test_admin_step_matches_jax(runs, sid):
    port, jax = runs[PORT][sid], runs[JAX][sid]
    if isinstance(jax[1], tuple):  # metric names: show the difference
        assert (set(port[1]) - set(jax[1]), set(jax[1]) - set(port[1])) \
            == (set(), set())
    assert port == jax
    if isinstance(jax, tuple) and not _sid(sid).startswith("py"):
        assert jax[0] == EXPECT.get(_sid(sid), 0), jax


@pytest.mark.parametrize("pkg", ts.PACKAGES)
@pytest.mark.parametrize("sid", _ids(cross=True))
def test_other_shell_against_this_cluster(runs, sid, pkg):
    """The other package's shell, against this package's cluster, prints
    what this package's own shell prints."""
    assert runs[pkg]["cross " + sid] == runs[pkg][sid]


def test_script_did_what_the_jax_tests_check(runs):
    """The JAX tests' own checks, on the port's run."""
    got = {_sid(k): v for k, v in runs[PORT].items()}
    out = {k: v[1] for k, v in got.items() if isinstance(v, tuple)}
    assert "Live Workers: 1" in out["fsadmin report"]
    assert "Total Capacity" in out["fsadmin report"]
    assert "Worker Name" in out["fsadmin report capacity"]
    assert " on /" in out["fsadmin report ufs"]
    assert "Master.rpc.get_status.count" in out["fsadmin report metrics"]
    assert got["py load_job"] == "COMPLETED"
    assert "COMPLETED=" in out["fsadmin report jobservice"]
    assert "job 1 " in out["fsadmin report jobservice"]
    assert "COMPLETED" in out["job stat -v 1"]
    health = out["fsadmin report health"]
    assert "input-stall-sustained" in health and "client-stalled" in health
    assert "clairvoyant" in health
    assert "Verdict: top bottleneck is 'ufs'" in out["fsadmin report stall"]
    assert any(ch in out["fsadmin report history Client.InputBoundFraction"]
               for ch in "▁▂▃▄▅▆▇█")
    doctors = [runs[PORT][k][1] for k in runs[PORT]
               if _sid(k) == "fsadmin doctor"]
    assert "master stalled" not in doctors[0]
    assert "master stalled" in doctors[1]
    assert "configuration check" in doctors[0]
    assert SECRET not in out["fsadmin getConf atpu.security.login.token"]
    assert "******" in out["fsadmin getConf atpu.security.login.token"]
    assert "checkpoint" in out["fsadmin journal checkpoint"].lower()
    assert "EMBEDDED" in got["fsadmin journal quorum"][2]
    assert got["py log_level"] == "ERROR"
    assert out["fsadmin trace --limit 50 --prefix atpu."] == \
        tuple(sorted(WRITE_SPANS))
    assert got["py wait_transform"] == ("COMPLETED", True)
    assert "sales" in out["table ls wh"]


# -- the HA quorum view (test_ha_failover's fsadmin case) ---------------------
def _masters_view(pkg, base):
    """A primary and a standby on one shared journal (a file-lock
    election), each publishing its row; ``fsadmin report masters``
    against the primary: exit code, masked lines and stderr."""
    Keys = ts.mod(pkg, "conf").Keys
    Configuration = ts.mod(pkg, "conf").Configuration
    process = ts.mod(pkg, "master.process")
    ha = ts.mod(pkg, "journal.ha")
    masters = []

    def make(i):
        conf = Configuration(load_env=False)
        conf.set(Keys.HOME, base)
        conf.set(Keys.MASTER_JOURNAL_FOLDER, f"{base}/journal")
        conf.set(Keys.MASTER_RPC_PORT, 0)
        conf.set(Keys.MASTER_SAFEMODE_WAIT, "0s")
        conf.set(Keys.MASTER_FASTPATH_ENABLED, False)
        conf.set(Keys.MASTER_HA_PUBLISH_INTERVAL, "100ms")
        conf.set(Keys.MASTER_STANDBY_TAIL_INTERVAL, "50ms")
        return conf

    import os
    import shutil

    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(f"{base}/underFSStorage")
    with ts.fresh_metrics(pkg):
        try:
            m1 = process.FaultTolerantMasterProcess(
                make(1), root_ufs_uri=f"{base}/underFSStorage")
            masters.append(m1)
            m1.start()
            deadline = time.monotonic() + 30
            while not m1.serving:
                assert time.monotonic() < deadline
                time.sleep(0.05)
            m2 = process.FaultTolerantMasterProcess(
                make(2), root_ufs_uri=f"{base}/underFSStorage")
            masters.append(m2)
            m2.start()
            while len(ha.MasterRegistry(f"{base}/journal").list()) < 2:
                assert time.monotonic() < deadline
                time.sleep(0.05)
            conf = make(0)
            conf.set(Keys.MASTER_HOSTNAME, "localhost")
            conf.set(Keys.MASTER_RPC_PORT, m1.rpc_port)

            class _Cluster:
                pass

            view = _Cluster()
            view.conf, view.job_master = conf, None
            view.master = m1
            code, out, err = ts.run_shell(pkg, view, "fsadmin",
                                          ["report", "masters"], conf=conf)
            ports = [int(m.client_address.rsplit(":", 1)[1])
                     for m in masters] + [m1.rpc_port]
            # the rows sort by address, and each row ends with the age
            # of the master's last contact
            rows = sorted(_AGE.sub("<AGE>", ts.mask(line, ports))
                          for line in out.splitlines())
            return code, rows, err
        finally:
            for m in reversed(masters):
                m.stop()


def test_report_masters_matches_jax(tmp_path):
    got = [_masters_view(pkg, str(tmp_path / "ha")) for pkg in ts.PACKAGES]
    assert got[1] == got[0]
    assert got[0][0] == 0
    text = "\n".join(got[0][1])
    assert "PRIMARY" in text and "STANDBY" in text
    assert "<PORT> *         PRIMARY" in text


def test_port_only_metrics_are_the_ports():
    """The names excused from the key-set comparison are gauges the
    port's master registers and the JAX master does not."""
    src = importlib.import_module(
        "alluxio_tpu_torch.master.process").__doc__
    for name in PORT_ONLY_METRICS:
        assert f"``{name}``" in src
