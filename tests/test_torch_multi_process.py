"""The port's multi-process cluster against the JAX package's, on the CPU.

Each case boots a ``MultiProcessCluster`` of each package (one master on
the LOCAL journal, its workers, each a ``python -m <package>.shell.main
<role>`` child) and holds the two to the same observations:

- the cluster boots, a write through its client reads back the same
  bytes;
- a killed worker is dropped from ``get_worker_infos``, and a worker
  restarted at the same index registers again;
- a load job, submitted to a job master and a job worker that the test
  spawns through ``ManagedProcess``, caches every block of a cold file
  on the out-of-process worker; every role then stops on SIGTERM with
  exit code 0;
- ``_common_env`` is equal for the same base directory and
  ``extra_conf``;
- the port's HA clusters (the HA cases of ``tests/test_multi_process.py``):
  two masters on a shared LOCAL journal, one and three on EMBEDDED
  journals; the primary's process is SIGKILLed and every acknowledged
  directory is still there when another master (or the restarted one)
  serves, which then takes writes;
- a role child of the port has neither ``jax`` nor ``alluxio_tpu`` (nor
  ``torch``) in ``sys.modules``;
- the worker's spans, metrics and stack samples from its own process
  reach the master's trace store, history and profile on its metrics
  heartbeat.

Readiness waits are bounded well below the cluster's default, and every
case stops its children in a ``finally``.
"""

import contextlib
import importlib
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

PACKAGES = ("alluxio_tpu", "alluxio_tpu_torch")
JAX, PORT = PACKAGES
BOOT_S = 60.0
#: a block worker's locality host must be the job worker's host name for
#: the load plan to pair them (both packages name a job worker by it)
HOST_IDENTITY = {"atpu.locality.identity": f"host={socket.gethostname()}"}


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@contextlib.contextmanager
def _running(pkg: str, base: str, workers: int = 1, extra=None):
    """A started cluster of ``pkg``, stopped on the way out."""
    c = _mod(pkg, "minicluster.multi_process").MultiProcessCluster(
        base, num_masters=1, num_workers=workers, extra_conf=extra)
    try:
        c.start_master(0)
        c.wait_for_primary(BOOT_S)
        for i in range(workers):
            c.start_worker(i)
        if workers:
            c.wait_for_workers(workers, BOOT_S)
        yield c
    finally:
        c.stop()


def _client(pkg: str, c, **conf):
    """The package's FileSystem on the cluster, with ``conf`` set."""
    cfg = _mod(pkg, "conf").Configuration(conf, load_env=False)
    return _mod(pkg, "client.file_system").FileSystem(c.master_addresses,
                                                     conf=cfg)


def _workers(pkg: str, c) -> list:
    bc = _mod(pkg, "rpc.clients").BlockMasterClient(c.master_addresses,
                                                    retry_duration_s=5.0)
    return bc.get_worker_infos()


def _wait(predicate, what: str, timeout_s: float = 30.0) -> None:
    deadline = time.monotonic() + timeout_s
    while not predicate():
        assert time.monotonic() < deadline, what
        time.sleep(0.2)


def _payload(n: int) -> bytes:
    return np.random.default_rng(n).integers(0, 256, n,
                                             dtype=np.uint8).tobytes()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_cluster_boots_and_serves(pkg, tmp_path):
    data = _payload(3 << 20)
    with _running(pkg, str(tmp_path)) as c:
        fs = _client(pkg, c)
        try:
            fs.write_all("/mp/hello", data)
            got = fs.read_all("/mp/hello")
        finally:
            fs.close()
        assert all(w.alive for w in c.masters + c.workers)
    assert got == data


OBSERVED = {"atpu.trace.enabled": True, "atpu.profile.enabled": True,
            "atpu.profile.sample.interval.ms": 20,
            "atpu.worker.metrics.heartbeat.interval": "200ms",
            "atpu.master.web.enabled": True}


def _web(port: int, route: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/api/v1/master/{route}",
            timeout=30) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("pkg", PACKAGES)
def test_worker_process_telemetry_reaches_the_master(pkg, tmp_path):
    """A traced remote read (short circuit off) through the worker's own
    process: the worker's read spans arrive in the master's stitched
    trace with the worker as their source, its metric series in the
    history under its source, and its stack samples in the master's
    profile (served by the master's web server)."""
    tracing = _mod(pkg, "utils.tracing")
    data = _payload(1 << 20)
    web = _mod(pkg, "minicluster.multi_process").free_port()
    with _running(pkg, str(tmp_path),
                  extra={**OBSERVED, "atpu.master.web.port": web}) as c:
        meta = _mod(pkg, "rpc.clients").MetaMasterClient(
            c.master_addresses, retry_duration_s=10.0)
        src = f"worker-localhost:{c.worker_ports[0]}"
        fs = _client(pkg, c, **{"atpu.user.short.circuit.enabled": False})
        try:
            fs.write_all("/mp/traced", data)
            tracing.tracer().clear()
            tracing.set_tracing_enabled(True)
            assert fs.read_all("/mp/traced") == data

            def worker_spans():
                return [s for s in meta.get_trace(limit=4000)["spans"]
                        if s.get("source") == src
                        and s["name"] == "atpu.BlockWorker.read_block"]

            _wait(worker_spans, "no worker span reached the master")
            _wait(lambda: _web(web, f"profile?source={src}")["flame"],
                  "no worker stack sample reached the master")
            names = meta.get_metrics_history()["names"]
            series = [e for n in names if n.startswith("Worker.")
                      for e in meta.get_metrics_history(n)["series"]
                      if e["source"] == src]
            flame = _web(web, f"profile?source={src}")["flame"]
        finally:
            tracing.set_tracing_enabled(False)
            tracing.tracer().clear()
            fs.close()
    assert series and all(e["points"] for e in series)
    assert flame["samples"] > 0 and flame["stacks"]


DETECTION = {"atpu.master.worker.timeout": "2s",
             "atpu.master.lost.worker.detection.interval": "500ms"}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_killed_worker_is_dropped_and_a_restart_registers(pkg, tmp_path):
    with _running(pkg, str(tmp_path), extra=DETECTION) as c:
        before = _workers(pkg, c)
        assert len(before) == 1
        c.workers[0].kill()
        assert not c.workers[0].alive
        _wait(lambda: not _workers(pkg, c), "the killed worker stays listed")
        c.start_worker(0)
        c.wait_for_workers(1, BOOT_S)
        after = _workers(pkg, c)
        fs = _client(pkg, c)
        try:
            fs.write_all("/mp/after-restart", b"again")
            assert fs.read_all("/mp/after-restart") == b"again"
        finally:
            fs.close()
    assert [w.address.rpc_port for w in after] == \
        [w.address.rpc_port for w in before] == [c.worker_ports[0]]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_load_job_caches_every_block_on_the_worker(pkg, tmp_path):
    """A job master and a job worker of their own processes load a cold
    (THROUGH) file of four blocks: the job completes and every block is
    located on the out-of-process block worker. Then every role stops on
    SIGTERM and exits 0."""
    mp = _mod(pkg, "minicluster.multi_process")
    data = _payload(4 << 20)
    # the master's root UFS, which the JAX cluster does not make
    os.makedirs(tmp_path / "underFSStorage", exist_ok=True)
    extra = {**HOST_IDENTITY, "atpu.user.block.size.bytes.default": "1MB"}
    with _running(pkg, str(tmp_path), extra=extra) as c:
        jport = mp.free_port()
        env = {**c._common_env(),
               "ATPU_MASTER_RPC_ADDRESSES": c.master_addresses,
               "ATPU_JOB_MASTER_HOSTNAME": "localhost",
               "ATPU_JOB_MASTER_RPC_PORT": str(jport),
               "ATPU_JOB_WORKER_HEARTBEAT_INTERVAL": "100ms"}
        logs = os.path.join(str(tmp_path), "logs")
        roles = [mp.ManagedProcess(role, env, os.path.join(logs, role))
                 for role in ("job-master", "job-worker")]
        try:
            roles[0].start()
            jc = _mod(pkg, "rpc.job_service").JobMasterClient(
                f"localhost:{jport}")
            _wait(lambda: _try(jc.list_plan_types), "no job master",
                  BOOT_S)
            roles[1].start()
            _wait(lambda: jc.list_workers(), "no job worker", BOOT_S)
            fs = _client(pkg, c)
            try:
                fs.write_all("/load/f", data, write_type="THROUGH")

                def located():
                    return [len(b.block_info.locations) for b in
                            fs.fs_master.get_file_block_info_list("/load/f")]

                # THROUGH frees the cached copies on a worker heartbeat
                _wait(lambda: located() == [0, 0, 0, 0],
                      "the THROUGH write stays cached")
                info = jc.wait_for_job(jc.run({"type": "load",
                                               "path": "/load/f"}),
                                       timeout_s=60)
                blocks = fs.fs_master.get_file_block_info_list("/load/f")
                got = fs.read_all("/load/f")
            finally:
                fs.close()
        finally:
            for p in reversed(roles):
                p.stop()
        codes = [p.proc.returncode for p in roles]
        worker_port = c.worker_ports[0]
        c.stop()
        codes += [p.proc.returncode for p in c.workers + c.masters]
    assert info.status == "COMPLETED", info.error_message
    assert [[loc.address.rpc_port for loc in b.block_info.locations]
            for b in blocks] == [[worker_port]] * 4
    assert got == data
    assert codes == [0, 0, 0, 0]


def _try(fn) -> bool:
    try:
        fn()
        return True
    except Exception:  # noqa: BLE001 - not up yet
        return False


@pytest.mark.parametrize("extra", [None, {"atpu.user.shm.enabled": "false",
                                          "atpu.worker.tieredstore.level0."
                                          "dirs.quota": "2304MB"}])
def test_common_env_matches_jax(extra, tmp_path):
    envs = [_mod(pkg, "minicluster.multi_process").MultiProcessCluster(
        str(tmp_path), extra_conf=extra)._common_env() for pkg in PACKAGES]
    assert envs[0] == envs[1]


def test_quota_template_reaches_the_worker_conf(tmp_path, monkeypatch):
    """A MEM tier larger than the cluster's 64 MB ramdisk comes through
    the level-0 quota template in ``extra_conf``: its variable survives
    ``_common_env`` (set before the worker's ramdisk size) and the
    worker's store, built from the environment, has a MEM tier of that
    size."""
    from alluxio_tpu_torch.conf import Configuration
    from alluxio_tpu_torch.minicluster.multi_process import (
        MultiProcessCluster,
    )
    from alluxio_tpu_torch.worker.process import build_store_from_conf

    c = MultiProcessCluster(str(tmp_path), extra_conf={
        "atpu.worker.tieredstore.level0.dirs.quota": "2304MB"})
    for k, v in {**c._common_env(), "ATPU_WORKER_RAMDISK_SIZE": "64MB",
                 "ATPU_WORKER_SHM_DIR": str(tmp_path / "shm"),
                 "ATPU_WORKER_DATA_FOLDER": str(tmp_path / "w")}.items():
        monkeypatch.setenv(k, v)
    store = build_store_from_conf(Configuration())
    assert store.meta.capacity_on_tiers()["MEM"] == 2304 << 20


@pytest.mark.parametrize("kw", [{"num_masters": 2},
                                {"journal_type": "EMBEDDED"},
                                {"num_masters": 3,
                                 "journal_type": "EMBEDDED"}],
                         ids=["two-local", "one-embedded", "three-embedded"])
def test_ha_cluster_survives_the_primary_kill(kw, tmp_path):
    from alluxio_tpu_torch.minicluster.multi_process import (
        MultiProcessCluster,
    )
    from alluxio_tpu_torch.rpc.clients import FsMasterClient

    c = MultiProcessCluster(str(tmp_path), num_workers=0, **kw)
    try:
        c.start(timeout_s=BOOT_S)
        assert c.ha
        # generous: elections on a contended one-core host
        fs = FsMasterClient(c.master_addresses, retry_duration_s=120.0,
                            fastpath_dir=c.base)
        acked = []
        for i in range(5):
            fs.create_directory(f"/pre-{i}")
            acked.append(f"/pre-{i}")
        dead = c.primary_index(BOOT_S)
        c.masters[dead].kill()
        if len(c.master_ports) == 1:
            c.start_master(dead)  # the lone member recovers its journal
        new = c.primary_index(BOOT_S)
        assert new != dead or len(c.master_ports) == 1
        fs.create_directory("/post")
        acked.append("/post")
        survivor = FsMasterClient(f"localhost:{c.master_ports[new]}",
                                  retry_duration_s=30.0, fastpath=False)
        assert [p for p in acked if not survivor.exists(p)] == []
    finally:
        c.stop()
    assert not any(p.alive for p in c.masters)


_REPORT = """
import json, sys
from alluxio_tpu_torch.shell import launch, main

def report(stop_fn, banner):
    stop_fn()
    print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
    return 0

launch._serve_until_signal = report
sys.exit(main.main([sys.argv[1]]))
"""


@pytest.fixture(scope="module")
def port_services(tmp_path_factory):
    """A port cluster (no worker) and a job master process beside it."""
    from alluxio_tpu_torch.minicluster.multi_process import ManagedProcess
    from alluxio_tpu_torch.rpc.job_service import JobMasterClient

    base = str(tmp_path_factory.mktemp("roles"))
    with _running(PORT, base, workers=0) as c:
        jport = _mod(PORT, "minicluster.multi_process").free_port()
        env = {**c._role_env(),
               "ATPU_MASTER_RPC_ADDRESSES": c.master_addresses,
               "ATPU_JOB_MASTER_HOSTNAME": "localhost",
               "ATPU_JOB_MASTER_RPC_PORT": str(jport)}
        jm = ManagedProcess("job-master", env,
                            os.path.join(base, "logs", "job-master"))
        try:
            jm.start()
            jc = JobMasterClient(f"localhost:{jport}")
            _wait(lambda: _try(jc.list_plan_types), "no job master",
                  BOOT_S)
            yield c, env
        finally:
            jm.stop()


@pytest.mark.parametrize("role", ["master", "worker", "job-master",
                                  "job-worker"])
def test_role_child_imports_no_jax_and_no_torch(role, port_services,
                                                tmp_path):
    """Each role child starts (the launcher builds and starts the role),
    then reports the top-level modules it has loaded and stops: none of
    them is ``jax``, ``alluxio_tpu`` or ``torch``."""
    from alluxio_tpu_torch.minicluster.multi_process import (
        _PACKAGE_PARENT, free_port,
    )

    c, env = port_services
    env = {**os.environ, **env, "PYTHONPATH": _PACKAGE_PARENT,
           "ATPU_WORKER_RPC_PORT": str(free_port()),
           "ATPU_JOB_MASTER_RPC_PORT": env["ATPU_JOB_MASTER_RPC_PORT"]}
    if role == "master":
        env.update({"ATPU_MASTER_RPC_PORT": "0",
                    "ATPU_MASTER_JOURNAL_FOLDER": str(tmp_path / "j"),
                    "ATPU_HOME": str(tmp_path)})
    if role == "job-master":
        env["ATPU_JOB_MASTER_RPC_PORT"] = "0"
    if role == "worker":
        env.update({"ATPU_WORKER_DATA_FOLDER": str(tmp_path / "w"),
                    "ATPU_WORKER_SHM_DIR": str(tmp_path / "w" / "shm")})
    out = subprocess.run([sys.executable, "-c", _REPORT, role], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "alluxio_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "alluxio_tpu", "torch"}
