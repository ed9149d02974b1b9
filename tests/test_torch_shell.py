"""The port's command-line dispatch against the JAX package's, on the CPU.

- ``_parse_generic`` turns the same argv into the same configuration and
  the same remaining arguments on both packages, and both refuse the
  same malformed ``host:port``;
- the shells and tools (``fs``, ``fsadmin``, ``job``, ``table``,
  ``validateConf``, ``validateEnv``, ``runOperation``, ``format``)
  dispatch as in JAX: the same arguments print the same and exit alike;
  every JAX command is dispatched, none refused;
- the serving commands as in JAX: ``validateHms`` against the fake
  metastore prints the same and exits alike (a database that is there
  and one that is not), and the ``proxy``, ``logserver`` and ``fuse``
  roles, each launched by each package's shell over its own package's
  cluster and stopped with SIGTERM, print the same banner, serve the
  same answer and exit 0;
- ``stress`` runs the port's stress CLI (its ``ha`` bench included);
  ``journalCrashTest`` SIGKILLs the port's master under load and every
  acknowledged operation survives replay; help and version answer as in
  JAX;
- ``python -m alluxio_tpu_torch.shell.main master`` serves, and stops
  with exit code 0 on SIGTERM.
"""

import importlib
import json
import os
import re
import select
import signal
import subprocess
import sys
import time

import pytest
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: F401
    port_lock_order_audit, port_lockaudit_install,
)

pytest.importorskip("torch")
pytest.importorskip("jax")

PACKAGES = ("alluxio_tpu", "alluxio_tpu_torch")
KEYS = ("atpu.master.hostname", "atpu.master.rpc.port",
        "atpu.job.master.hostname", "atpu.job.master.rpc.port",
        "atpu.user.block.size.bytes.default")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _parse(pkg: str, argv):
    conf = _mod(pkg, "conf").Configuration(load_env=False)
    main = _mod(pkg, "shell.main")
    try:
        rest = main._parse_generic(list(argv), conf)
    except main.GenericOptionError as e:
        return ("error", str(e))
    return rest, {k: conf.get(k) for k in KEYS}


@pytest.mark.parametrize("argv", [
    [],
    ["worker"],
    ["--master", "m1:1234", "worker"],
    ["--master", "m1", "worker"],
    ["--master", ":1234", "master"],
    ["--job-master", "jm:2001", "job-worker"],
    ["--job-master", "jm", "--master", "m:9", "job-worker", "x"],
    ["-D", "atpu.user.block.size.bytes.default=8MB", "master"],
    ["-D", "atpu.master.rpc.port=4242", "--master", "h:17", "master"],
    ["--master"],
    ["master", "-D"],
    ["--master", "m1:port"],
    ["--job-master", "jm:x1", "job-master"],
])
def test_parse_generic_matches_jax(argv):
    assert _parse("alluxio_tpu_torch", argv) == _parse("alluxio_tpu", argv)


def _jax_commands() -> set:
    usage = _mod("alluxio_tpu", "shell.main").USAGE
    block = usage.split("Commands:")[1].split("Generic options:")[0]
    return {line.split()[0] for line in block.splitlines() if line.strip()}


#: the commands the port dispatches, with arguments that need no cluster
DISPATCHED = {
    "fs": ["help"],
    "fsadmin": ["help"],
    "job": ["help"],
    "table": ["help"],
    "validateConf": ["--site", "{site}"],
    "validateEnv": ["--help"],
    "runOperation": ["-op", "ListStatus", "-t", "0"],
    "format": ["bogus"],
}


def test_every_jax_command_is_dispatched_or_refused():
    """Every JAX command is dispatched; the port refuses none."""
    from alluxio_tpu_torch.shell import main

    ported = {"master", "worker", "job-master", "job-worker", "version",
              "stress", "journalCrashTest", *DISPATCHED, *SERVING}
    assert ported == _jax_commands()
    assert not hasattr(main, "_NOT_PORTED")
    usage = [line.split()[0] for line in main.USAGE.split("Commands:")[1]
             .split("Generic options:")[0].splitlines() if line.strip()]
    assert set(usage) == ported
    assert main.USAGE == _mod("alluxio_tpu", "shell.main").USAGE


def _dispatch(pkg, argv, capsys):
    try:
        code = _mod(pkg, "shell.main").main(argv)
    except SystemExit as e:  # argparse's --help
        code = e.code
    out = capsys.readouterr()
    return code, out.out, out.err


@pytest.mark.parametrize("cmd", sorted(DISPATCHED))
def test_ported_command_dispatches_like_jax(cmd, tmp_path, capsys):
    """``shell.main`` routes the command to the port's module: the same
    arguments print the same and exit alike in both packages."""
    site = tmp_path / "site.properties"
    site.write_text("atpu.worker.tieredstroe.levels=2\n"
                    "atpu.master.hostname=h\n")
    argv = ["-D", "atpu.user.rpc.retry.duration=1s", cmd] + [
        a.format(site=site) for a in DISPATCHED[cmd]]
    got = [_dispatch(pkg, argv, capsys) for pkg in PACKAGES]
    assert got[1] == got[0]
    assert "not ported yet" not in got[1][2]
    assert got[1][1] or got[1][2]


#: the serving commands: validateHms and the three serving roles
SERVING = ("validateHms", "proxy", "logserver", "fuse")


@pytest.fixture(scope="module")
def serving_clusters(tmp_path_factory):
    """Each package's LocalCluster, for the roles its shell launches."""
    out = {}
    try:
        for pkg in PACKAGES:
            out[pkg] = _mod(pkg, "minicluster.local_cluster").LocalCluster(
                str(tmp_path_factory.mktemp(pkg.split("_")[-1])),
                num_workers=1).start()
            fs = out[pkg].file_system()
            fs.create_directory("/s3/bucket", recursive=True,
                                allow_exists=True)
            fs.write_all("/s3/bucket/key.bin", b"served through the shell")
        yield out
    finally:
        for c in out.values():
            c.stop()


def _validate_hms(pkg, uri, db, capsys):
    code = _mod(pkg, "shell.main").main(
        ["validateHms", "-m", uri, "-d", db, "-t", "orders", "--no-fs"])
    out = capsys.readouterr()
    return code, out.out, out.err


@pytest.mark.parametrize("db", ["sales_db", "nope"])
def test_validate_hms_dispatches_like_jax(db, capsys):
    from tests.testutils.fake_hms import FakeHmsServer, HmsTable

    with FakeHmsServer() as hms:
        hms.add_table("sales_db", HmsTable(
            "orders", "hdfs://nn/warehouse/orders", cols=[("id", "int")]))
        got = [_validate_hms(pkg, hms.uri, db, capsys) for pkg in PACKAGES]
    assert got[1] == got[0]
    assert got[1][0] == (0 if db == "sales_db" else 1)
    assert "hms.database" in got[1][1]


def _serve_role(pkg, role, cluster, tmp_path):
    """Launch ``role`` through ``pkg``'s shell over ``cluster``, ask it
    one question, stop it: (banner, answer, exit code), ports and paths
    masked."""
    from tests.testutils import torch_serving as sv

    work = tmp_path / f"{role}-{pkg}"
    work.mkdir()
    argv = ["--master", f"localhost:{cluster.master.rpc_port}",
            "-D", "atpu.proxy.web.port=0", "-D", "atpu.logserver.port=0",
            "-D", f"atpu.logserver.logs.dir={work / 'logs'}",
            "-D", f"atpu.fuse.mount.point={work / 'mnt'}",
            "-D", "atpu.fuse.fs.root=/s3", role]
    env = sv.role_env({"ATPU_HOME": str(work)})
    proc, banner = sv.launch(pkg, argv, env, cwd=str(work))
    try:
        if role == "proxy":
            port = int(banner.rsplit(" ", 1)[1])
            answer = sv.comparable(sv.http(port, "GET", "/bucket/key.bin"))
        elif role == "logserver":
            import logging.handlers

            port = int(banner.rsplit(" ", 1)[1])
            h = logging.handlers.SocketHandler("127.0.0.1", port)
            rec = logging.LogRecord("atpu.shell.served", logging.WARNING,
                                    __file__, 1, "to %s", ("the server",),
                                    None)
            h.handle(rec)
            h.close()
            path = work / "logs" / "127.0.0.1.log"
            for _ in range(200):
                if path.exists() and "the server" in path.read_text():
                    break
                time.sleep(0.05)
            answer = re.sub(r"^\S+ \S+ ", "", path.read_text())
        else:
            mnt = str(work / "mnt")
            answer = (sorted(os.listdir(mnt)),
                      open(os.path.join(mnt, "bucket", "key.bin"),
                           "rb").read())
    finally:
        code = sv.stop(proc)
    if role == "fuse":
        assert not os.path.ismount(str(work / "mnt"))
    return (re.sub(r"\d+$", "<PORT>", banner.replace(str(work), "<W>")),
            answer, code)


@pytest.mark.parametrize("role", ["proxy", "logserver", "fuse"])
def test_serving_role_launches_like_jax(role, serving_clusters, tmp_path):
    if role == "fuse":
        if not _mod(PACKAGES[1], "fuse.process").fuse_available():
            pytest.skip("no FUSE in this environment")
    got = [_serve_role(pkg, role, serving_clusters[pkg], tmp_path)
           for pkg in PACKAGES]
    assert got[1] == got[0]
    banner, answer, code = got[1]
    assert code == 0
    if role == "proxy":
        assert banner == "alluxio-tpu proxy serving on port <PORT>"
        assert answer[:2] == (200, b"served through the shell")
    elif role == "logserver":
        assert banner == "alluxio-tpu log server on port <PORT>"
        assert answer == ("WARNING atpu.shell.served [127.0.0.1] "
                          "to the server\n")
    else:
        assert banner == "alluxio-tpu fuse mounted at <W>/mnt"
        assert answer == (["bucket"], b"served through the shell")


def test_stress_dispatches_to_the_cli(capsys):
    """``stress`` runs the port's stress CLI on the arguments after it, as
    the JAX shell runs its own: a toy worker bench prints its one JSON
    line, and the ``ha`` bench reaches its bench function with the
    arguments after it."""
    from alluxio_tpu_torch.shell import main

    assert main.main(["stress", "worker", "--mode", "random", "--threads",
                      "1", "--duration", "0.3", "--shard-mb", "1",
                      "--num-shards", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert row["bench"] == "worker-random" and row["errors"] == 0
    assert row["params"]["master"] == "in-process"
    from alluxio_tpu_torch.stress import base, ha_bench

    got = {}

    def record(**kw):
        got.update(kw)
        return base.BenchResult(bench="ha-failover", params={},
                                metrics={}, errors=0, duration_s=0.0)

    real = ha_bench.run
    ha_bench.run = record
    try:
        assert main.main(["stress", "ha", "--warmup", "0.5"]) == 0
    finally:
        ha_bench.run = real
    assert got == {"masters": 3, "election_timeout_s": 2.0,
                   "warmup_s": 0.5}
    assert json.loads(capsys.readouterr().out)["bench"] == "ha-failover"


def test_journal_crash_test_survives_master_kills(tmp_path, capsys):
    """``journalCrashTest`` through the shell: the port's master in its
    own process, SIGKILLed and restarted under create, create-delete and
    create-rename loops; every acknowledged operation is there after
    replay (exit 0)."""
    from alluxio_tpu_torch.shell import main

    assert main.main(["journalCrashTest", "--total-time", "5",
                      "--max-alive", "2.5"]) == 0
    err = capsys.readouterr().err
    assert "crash #1" in err and "journalCrashTest: PASSED" in err


@pytest.mark.parametrize("pkg", PACKAGES)
def test_help_version_and_unknown_match_jax(pkg, capsys):
    main = _mod(pkg, "shell.main")
    codes = [main.main(["--help"]), main.main(["version"]),
             main.main(["no-such-command"])]
    out = capsys.readouterr()
    assert codes == [0, 0, 1]
    assert out.out.strip().endswith("0.1.0")
    assert "Unknown command: no-such-command" in out.err


def test_master_role_serves_and_stops_on_sigterm(tmp_path):
    env = {**os.environ, "ATPU_MASTER_RPC_PORT": "0",
           "ATPU_HOME": str(tmp_path),
           "ATPU_MASTER_JOURNAL_FOLDER": str(tmp_path / "journal"),
           "ATPU_MASTER_FASTPATH_DIR": str(tmp_path),
           "ATPU_MASTER_SAFEMODE_WAIT": "0s"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "alluxio_tpu_torch.shell.main", "master"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True, cwd=os.path.join(os.path.dirname(__file__), os.pardir))
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 60)
        assert ready, "the master printed no banner in 60 s"
        banner = proc.stdout.readline()
        port = int(re.search(r"serving on port (\d+)", banner).group(1))
        from alluxio_tpu_torch.rpc.clients import MetaMasterClient

        info = MetaMasterClient(f"localhost:{port}",
                                retry_duration_s=5.0).get_master_info()
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    assert info
    assert code == 0
