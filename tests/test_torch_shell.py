"""The port's command-line dispatch against the JAX package's, on the CPU.

- ``_parse_generic`` turns the same argv into the same configuration and
  the same remaining arguments on both packages, and both refuse the
  same malformed ``host:port``;
- the JAX package's commands that the port does not have are refused
  with exit code 1 and the ROADMAP item that brings them (a deliberate
  difference); ``stress`` runs the port's stress CLI (its ``ha`` bench
  included); ``journalCrashTest`` SIGKILLs the port's master under load
  and every acknowledged operation survives replay; help and version
  answer as in JAX;
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

import pytest

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


def test_every_jax_command_is_dispatched_or_refused():
    from alluxio_tpu_torch.shell import main

    ported = {"master", "worker", "job-master", "job-worker", "version",
              "stress", "journalCrashTest"}
    assert ported | set(main._NOT_PORTED) == _jax_commands()
    assert not ported & set(main._NOT_PORTED)


@pytest.mark.parametrize("cmd", sorted(
    importlib.import_module("alluxio_tpu_torch.shell.main")._NOT_PORTED))
def test_unported_command_is_refused(cmd, capsys):
    from alluxio_tpu_torch.shell import main

    assert main.main([cmd, "arg"]) == 1
    err = capsys.readouterr().err
    assert f"{cmd}: not ported yet" in err
    item = re.search(r"ROADMAP item '([^']+)'", err).group(1)
    roadmap = open(os.path.join(os.path.dirname(__file__), os.pardir,
                                "ROADMAP.md")).read()
    assert item in roadmap


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
