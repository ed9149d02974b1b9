"""The port's launchers under ``bin/`` against the JAX package's, on the
CPU.

- ``bin/alluxio-tpu-torch-start.sh local``, then ``bin/alluxio-tpu-torch
  fs mkdir``/``copyFromLocal``/``ls``/``cat`` and
  ``bin/alluxio-tpu-torch-stop.sh all``, and the same session through
  ``bin/alluxio-tpu-start.sh``, ``bin/alluxio-tpu`` and
  ``bin/alluxio-tpu-stop.sh``: what they print is equal once pids,
  ports, dates, the work directory and the launcher's name are masked,
  and no role process is left after either stop. The roles take their
  conf from ``ATPU_*`` variables, which both packages read.
- Both fan-out scripts (``alluxio-tpu[-torch]-{masters,workers}.sh``
  and the mount script's ``workers`` target) against a stub ``ssh`` on
  ``PATH``: the plans are equal apart from the script names.
- Both mount scripts' ``Check`` print the same, from the same variables.
- Deliberate differences, pinned here: the port's scripts keep their
  logs and pid files in directories of their own by default
  (``${TMPDIR:-/tmp}/alluxio-tpu-torch-{logs,pids}``), so the port's
  ``stop.sh all`` leaves the JAX package's roles running; and the port's
  shell and mount script read the site file that ``ATPU_SITE_PROPERTIES``
  names (the JAX ones read the environment only).
"""

import os
import re
import signal
import socket
import subprocess
import sys
import time

import pytest

from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: F401
    port_lock_order_audit, port_lockaudit_install,
)
from tests.testutils import torch_shell as ts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIN = os.path.join(ROOT, "bin")
PORT, JAX = "alluxio_tpu_torch", "alluxio_tpu"
#: each package's launcher, by the prefix of its scripts' names
LAUNCHER = {JAX: "alluxio-tpu", PORT: "alluxio-tpu-torch"}
ROLES = ("master", "worker", "job_master", "job_worker")
BOOT_S = 60.0
STOP_S = 20.0
_PID = re.compile(r"\(pid \d+\)")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _script(pkg: str, suffix: str = "") -> str:
    return os.path.join(BIN, LAUNCHER[pkg] + suffix)


def _run(argv, env, timeout=120) -> subprocess.CompletedProcess:
    return subprocess.run(argv, capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=timeout)


def _alive(pid: int) -> bool:
    """True while ``pid`` runs (an unreaped zombie has exited)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            state = f.read().rsplit(")", 1)[1].split()[0]
    except (OSError, IndexError):
        return False
    return state not in ("Z", "X")


def _pids(pid_dir: str) -> dict:
    out = {}
    for role in ROLES:
        path = os.path.join(pid_dir, f"{role}.pid")
        if os.path.exists(path):
            with open(path) as f:
                out[role] = int(f.read())
    return out


def _kill(pids) -> None:
    for pid in pids:
        if _alive(pid):
            os.kill(pid, signal.SIGKILL)


def _role_env(base: str) -> dict:
    """Both packages' roles read these ``ATPU_*`` variables: every port
    free, every directory under ``base``."""
    env = dict(os.environ)
    env.pop("ATPU_SITE_PROPERTIES", None)
    env.update({
        "PYTHON": sys.executable,
        "ALLUXIO_TPU_LOGS_DIR": os.path.join(base, "logs"),
        "ALLUXIO_TPU_PID_DIR": os.path.join(base, "pids"),
        "ATPU_HOME": base,
        "ATPU_MASTER_HOSTNAME": "localhost",
        "ATPU_MASTER_RPC_PORT": str(_free_port()),
        "ATPU_MASTER_JOURNAL_FOLDER": os.path.join(base, "journal"),
        "ATPU_MASTER_SAFEMODE_WAIT": "0s",
        "ATPU_MASTER_FASTPATH_DIR": base,
        "ATPU_JOB_MASTER_HOSTNAME": "localhost",
        "ATPU_JOB_MASTER_RPC_PORT": str(_free_port()),
        "ATPU_WORKER_HOSTNAME": "localhost",
        "ATPU_WORKER_RPC_PORT": str(_free_port()),
        "ATPU_WORKER_DATA_FOLDER": os.path.join(base, "worker"),
        "ATPU_WORKER_SHM_DIR": os.path.join(base, "shm"),
        "ATPU_WORKER_RAMDISK_SIZE": "64MB",
    })
    return env


def _wait_up(pkg: str, env: dict) -> None:
    """The master answers and the worker has registered."""
    clients = ts.mod(pkg, "rpc.clients")
    address = f"localhost:{env['ATPU_MASTER_RPC_PORT']}"
    blocks = clients.BlockMasterClient(address, fastpath=False,
                                       retry_duration_s=0.5)
    deadline = time.monotonic() + BOOT_S
    while True:
        try:
            if blocks.get_worker_infos():
                return
        except Exception:  # noqa: BLE001 - not serving yet
            pass
        assert time.monotonic() < deadline, f"{pkg}: no worker registered"
        time.sleep(0.1)


def _mask(text: str, pkg: str, base: str, env: dict) -> str:
    text = _PID.sub("(pid <PID>)", text).replace(base, "@BASE@")
    text = ts.mask(text, [env[k] for k in env if k.endswith("_PORT")])
    return text.replace(LAUNCHER[pkg], "@LAUNCHER@")


def _session(pkg: str, base: str) -> list:
    """``start.sh local``, four fs commands and ``stop.sh all`` through
    ``pkg``'s launchers: [(step, exit code, masked stdout)]. Asserts that
    no role outlives the stop."""
    os.makedirs(os.path.join(base, "underFSStorage"))
    with open(os.path.join(base, "hello.txt"), "w") as f:
        f.write("hello launchers\n")
    env = _role_env(base)
    cli = _script(pkg)
    steps = [("start", [_script(pkg, "-start.sh"), "local"]),
             ("mkdir", [cli, "fs", "mkdir", "/d"]),
             ("copyFromLocal",
              [cli, "-D", "atpu.user.file.writetype.default=MUST_CACHE",
               "fs", "copyFromLocal", os.path.join(base, "hello.txt"),
               "/d/hello.txt"]),
             ("ls", [cli, "fs", "ls", "/d"]),
             ("cat", [cli, "fs", "cat", "/d/hello.txt"]),
             ("stop", [_script(pkg, "-stop.sh"), "all"])]
    out, pids = [], {}
    try:
        for name, argv in steps:
            if name == "stop":
                pids = _pids(env["ALLUXIO_TPU_PID_DIR"])
            r = _run(["bash", *argv], env)
            out.append((name, r.returncode,
                        _mask(r.stdout, pkg, base, env)))
            if name == "start":
                pids = _pids(env["ALLUXIO_TPU_PID_DIR"])
                assert sorted(pids) == sorted(ROLES), r.stdout
                _wait_up(pkg, env)
        deadline = time.monotonic() + STOP_S
        while any(_alive(p) for p in pids.values()) and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        left = [r for r, p in pids.items() if _alive(p)]
        assert not left, f"{pkg}: {left} outlived stop.sh all"
        assert _pids(env["ALLUXIO_TPU_PID_DIR"]) == {}
    finally:
        _kill(pids.values())
    return out


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    cache = {}

    def get(pkg: str) -> list:
        if pkg not in cache:
            cache[pkg] = _session(pkg, str(tmp_path_factory.mktemp("launch")))
        return cache[pkg]

    return get


@pytest.mark.parametrize("pkg", ts.PACKAGES)
def test_launcher_session_runs_and_stops(sessions, pkg):
    """Every step of a package's session exits 0, the file reads back,
    and the stop leaves no role (asserted in ``_session``)."""
    out = sessions(pkg)
    assert [code for _, code, _ in out] == [0] * len(out), out
    steps = dict((name, text) for name, _, text in out)
    assert steps["cat"] == "hello launchers\n"
    assert "/d/hello.txt" in steps["ls"]
    assert steps["stop"].count("Stopped") == len(ROLES)


def test_launcher_sessions_match_jax(sessions):
    assert sessions(PORT) == sessions(JAX)


def _ssh_env(tmp_path) -> dict:
    """A stub ``ssh`` first on ``PATH`` that logs its arguments; one host
    file for masters and workers, with a comment, a blank line and a last
    line without a newline."""
    stub = tmp_path / "stub"
    stub.mkdir(parents=True)
    (stub / "ssh").write_text(
        '#!/usr/bin/env bash\nprintf "%s\\n" "$*" >> "$SSH_LOG"\n')
    (stub / "ssh").chmod(0o755)
    hosts = tmp_path / "hosts"
    hosts.write_text("# the hosts\nhost-a\n\nhost-b")
    conf_dir = tmp_path / "conf"
    conf_dir.mkdir()
    (conf_dir / "workers").write_text(hosts.read_text())
    env = dict(os.environ)
    env.update({"PATH": f"{stub}{os.pathsep}{env['PATH']}",
                "SSH_LOG": str(tmp_path / "ssh.log"),
                "ALLUXIO_TPU_MASTERS_FILE": str(hosts),
                "ALLUXIO_TPU_WORKERS_FILE": str(hosts),
                "ATPU_CONF_DIR": str(conf_dir),
                "ALLUXIO_TPU_SSH_OPTS": "-o ConnectTimeout=1"})
    return env


def _fanout_plan(pkg: str, tmp_path, argv) -> tuple:
    """(exit code, stdout lines, ssh calls), sorted (the hosts run at
    once), with the launcher's name masked; and the raw ssh calls."""
    env = _ssh_env(tmp_path)
    r = _run(["bash", *argv], env, timeout=60)
    with open(env["SSH_LOG"]) as f:
        ssh = sorted(f.read().splitlines())
    name = LAUNCHER[pkg]

    def norm(line: str) -> str:
        return line.replace(name + "-", "@LAUNCHER@-")

    return (r.returncode, sorted(map(norm, r.stdout.splitlines())),
            [norm(line) for line in ssh]), ssh


@pytest.mark.parametrize("suffix,args", [
    ("-masters.sh", ["start"]), ("-masters.sh", ["stop"]),
    ("-masters.sh", ["cmd", "uptime"]), ("-workers.sh", ["start"]),
    ("-workers.sh", ["stop"]), ("-workers.sh", ["cmd", "uptime"]),
    ("-mount.sh", ["Check", "workers"]),
], ids=lambda v: v if isinstance(v, str) else "_".join(v))
def test_fanout_plans_match_jax(tmp_path, suffix, args):
    plans, raw = {}, {}
    for pkg in ts.PACKAGES:
        plans[pkg], raw[pkg] = _fanout_plan(
            pkg, tmp_path / pkg, [_script(pkg, suffix), *args])
    code, _, ssh = plans[PORT]
    assert code == 0 and len(ssh) == 2, plans[PORT]
    assert plans[PORT] == plans[JAX]
    if args[0] in ("start", "stop") or suffix == "-mount.sh":
        # the port's hosts run the port's scripts, never the JAX ones
        assert all("bin/alluxio-tpu-torch-" in line for line in raw[PORT])
        assert not any(re.search(r"bin/alluxio-tpu-(start|stop|mount)",
                                 line) for line in raw[PORT])


@pytest.mark.parametrize("tier0", ["absent", "present"])
def test_mount_check_matches_jax(tmp_path, tier0):
    directory = tmp_path / "tier0"
    if tier0 == "present":
        directory.mkdir()
    env = dict(os.environ)
    env.pop("ATPU_SITE_PROPERTIES", None)
    env.update({"PYTHON": sys.executable,
                "ATPU_WORKER_RAMDISK_SIZE": "96MB",
                "ATPU_WORKER_TIEREDSTORE_LEVEL0_DIRS_PATH": str(directory)})
    outs = {}
    for pkg in ts.PACKAGES:
        r = _run(["bash", _script(pkg, "-mount.sh"), "Check"], env)
        assert r.returncode == 0, r.stderr
        # df's numbers move with the host's disk between the two calls
        first, _, rest = r.stdout.partition("\n")
        outs[pkg] = first + "\n" + re.sub(r"\s+\d\S*", " <N>", rest)
    assert outs[PORT] == outs[JAX]
    assert outs[PORT].splitlines()[0] == \
        f"tier0 (MEM): {directory} (want {96 << 20} B)"
    assert ("not present" in outs[PORT]) == (tier0 == "absent")


def test_mount_check_reads_the_site_file_in_the_port_only(tmp_path):
    """A deliberate difference: the port's mount script reads the site
    file that ``ATPU_SITE_PROPERTIES`` names; the JAX one does not."""
    site = tmp_path / "site.properties"
    site.write_text(f"atpu.worker.ramdisk.size=48MB\n"
                    f"atpu.worker.tieredstore.level0.dirs.path="
                    f"{tmp_path / 'tier0'}\n")
    env = dict(os.environ)
    for key in ("ATPU_WORKER_RAMDISK_SIZE",
                "ATPU_WORKER_TIEREDSTORE_LEVEL0_DIRS_PATH"):
        env.pop(key, None)
    env.update({"PYTHON": sys.executable,
                "ATPU_SITE_PROPERTIES": str(site)})
    first = {pkg: _run(["bash", _script(pkg, "-mount.sh"), "Check"],
                       env).stdout.splitlines()[0]
             for pkg in ts.PACKAGES}
    assert first[PORT] == \
        f"tier0 (MEM): {tmp_path / 'tier0'} (want {48 << 20} B)"
    assert first[JAX] == \
        f"tier0 (MEM): /dev/shm/alluxio-tpu (want {1 << 30} B)"


def test_port_pid_directory_is_its_own(tmp_path):
    """The port's start and stop scripts default to pid and log
    directories of their own under ``$TMPDIR``: a master started with
    only a site file (its port from the file) is stopped by the port's
    ``stop.sh all``, while a process named by a JAX-style pid file under
    ``$TMPDIR/alluxio-tpu-pids`` keeps running."""
    base = str(tmp_path)
    port = _free_port()
    site = tmp_path / "site.properties"
    site.write_text(f"atpu.home={base}\n"
                    f"atpu.master.hostname=localhost\n"
                    f"atpu.master.rpc.port={port}\n"
                    f"atpu.master.journal.folder={base}/journal\n"
                    f"atpu.master.fastpath.dir={base}\n"
                    f"atpu.master.safemode.wait=0s\n"
                    f"atpu.job.master.rpc.port={_free_port()}\n")
    os.makedirs(tmp_path / "underFSStorage")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("ATPU_", "ALLUXIO_TPU_"))}
    env.update({"PYTHON": sys.executable, "TMPDIR": base,
                "ATPU_SITE_PROPERTIES": str(site)})
    jax_dir = tmp_path / "alluxio-tpu-pids"
    jax_dir.mkdir()
    bystander = subprocess.Popen(["sleep", "60"])
    (jax_dir / "master.pid").write_text(str(bystander.pid))
    pids = {}
    try:
        r = _run(["bash", _script(PORT, "-start.sh"), "master"], env)
        assert r.returncode == 0, r.stderr
        pid_dir = tmp_path / "alluxio-tpu-torch-pids"
        pids = _pids(str(pid_dir))
        assert list(pids) == ["master"]
        assert (tmp_path / "alluxio-tpu-torch-logs" / "master.out").exists()
        meta = ts.mod(PORT, "rpc.clients").MetaMasterClient(
            f"localhost:{port}", fastpath=False, retry_duration_s=0.5)
        deadline = time.monotonic() + BOOT_S
        while True:
            try:
                meta.get_master_info()
                break
            except Exception:  # noqa: BLE001 - not serving yet
                assert time.monotonic() < deadline, "no master"
                time.sleep(0.1)
        r = _run(["bash", _script(PORT, "-stop.sh"), "all"], env)
        assert r.returncode == 0
        assert f"Stopped master (pid {pids['master']})" in r.stdout
        deadline = time.monotonic() + STOP_S
        while _alive(pids["master"]) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not _alive(pids["master"])
        assert bystander.poll() is None
        assert (jax_dir / "master.pid").exists()
    finally:
        _kill(pids.values())
        bystander.kill()
        bystander.wait()
    for name in ("start.sh", "stop.sh"):
        with open(_script(PORT, "-" + name)) as f:
            lines = [line for line in f if line.startswith("PID_DIR=")]
        assert lines == ['PID_DIR="${ALLUXIO_TPU_PID_DIR:-${TMPDIR:-/tmp}'
                         '/alluxio-tpu-torch-pids}"\n']
