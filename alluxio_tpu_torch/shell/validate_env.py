"""validateEnv / validateHms: task-based pre-flight validation (a copy
of ``alluxio_tpu/shell/validate_env.py``).

Env-adapted analogue of the reference's validation tools
(``integration/tools/validation/.../{PortAvailabilityValidationTask,
RamDiskMountPrivilegeValidationTask,NativeLibValidationTask,
SshValidationTask,ClusterConfConsistencyValidationTask}.java`` and
``integration/tools/hms/.../HmsValidationTool.java:32`` with its
UriCheck/CreateHmsClient/MetastoreValidation/DatabaseValidation/
TableValidation tasks): each check is a named task returning
OK/WARNING/FAILED/SKIPPED plus advice, so an operator can vet a node
(or a metastore) before starting processes — instead of discovering a
bad port/dir/URI at boot.
"""

from __future__ import annotations

import os
import shutil
import socket
import subprocess
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from alluxio_tpu_torch.conf import Configuration, Keys
from alluxio_tpu_torch.conf.property_key import Templates

OK = "OK"
WARNING = "WARNING"
FAILED = "FAILED"
SKIPPED = "SKIPPED"


@dataclass
class TaskResult:
    """Reference ``ValidationTaskResult``: name + state + advice."""

    name: str
    state: str
    message: str = ""
    advice: str = ""


@dataclass
class ValidationTool:
    """A named collection of tasks; ``run_all`` never raises — a task
    blowing up becomes its own FAILED row (the reference wraps each
    task the same way)."""

    name: str
    tasks: List["tuple[str, Callable[[], TaskResult]]"] = \
        field(default_factory=list)

    def add(self, name: str, fn: Callable[[], TaskResult]) -> None:
        self.tasks.append((name, fn))

    def run_all(self) -> List[TaskResult]:
        out = []
        for name, fn in self.tasks:
            try:
                out.append(fn())
            except Exception as e:  # noqa: BLE001 task isolation
                out.append(TaskResult(name, FAILED,
                                      f"{type(e).__name__}: {e}"))
        return out


# -- env tasks --------------------------------------------------------

def _check_port(name: str, host: str, port: int) -> TaskResult:
    """A port is OK if free (process can bind it later) or if something
    already accepts connections on it (assumed to be ours, reported as
    WARNING so the operator decides). A host that is not local at all
    (EADDRNOTAVAIL — e.g. the master hostname checked from a worker
    node) can only be probed by connecting; nothing serving there yet
    is expected pre-start, not a failure."""
    import errno

    try:
        with socket.socket() as s:
            s.bind((host, port))
        return TaskResult(name, OK, f"{host}:{port} free")
    except OSError as e:
        host_is_local = e.errno != errno.EADDRNOTAVAIL
    try:
        with socket.create_connection((host, port), timeout=2):
            return TaskResult(
                name, WARNING, f"{host}:{port} already serving",
                advice="fine if this is the running cluster; otherwise "
                       "another process owns the port")
    except OSError as e:
        if not host_is_local:
            return TaskResult(
                name, SKIPPED,
                f"{host} is not a local address and nothing serves "
                f"{host}:{port} yet — check from that host")
        return TaskResult(name, FAILED,
                          f"{host}:{port} bound but not accepting: {e}",
                          advice="free the port or change the key")


def _check_dir(name: str, path: str, min_free_bytes: int) -> TaskResult:
    if not path:
        return TaskResult(name, SKIPPED, "no path configured")
    try:
        os.makedirs(path, exist_ok=True)
        probe = os.path.join(path, ".atpu-validate")
        with open(probe, "w") as f:
            f.write("ok")
        os.remove(probe)
    except OSError as e:
        return TaskResult(name, FAILED, f"{path}: {e}",
                          advice="fix ownership/permissions (reference "
                                 "RamDiskMountPrivilegeValidationTask)")
    free = shutil.disk_usage(path).free
    if free < min_free_bytes:
        return TaskResult(name, WARNING,
                          f"{path}: only {free >> 20} MiB free",
                          advice="quota exceeds the free space")
    return TaskResult(name, OK, f"{path}: writable, "
                                f"{free >> 20} MiB free")


def _check_native(name: str) -> TaskResult:
    from alluxio_tpu_torch import native

    handle = native.lib()
    if handle is None:
        return TaskResult(name, WARNING,
                          "native framing library unavailable "
                          "(falls back to pure python)",
                          advice="install g++ or ship the prebuilt "
                                 ".so to enable the native scanner")
    return TaskResult(name, OK, "native framing library loads")


def _check_ssh(name: str, conf_dir: str, role_file: str) -> TaskResult:
    path = os.path.join(conf_dir, role_file)
    if not os.path.isfile(path):
        return TaskResult(name, SKIPPED, f"{path} absent")
    with open(path) as f:
        hosts = [ln.strip() for ln in f
                 if ln.strip() and not ln.startswith("#")]
    remote = [h for h in hosts if h not in ("localhost", "127.0.0.1")]
    # concurrent probes: serial 5s timeouts would make a pod-scale
    # role file take minutes
    procs = {h: subprocess.Popen(
        ["ssh", "-o", "BatchMode=yes", "-o", "ConnectTimeout=5",
         h, "true"], stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL) for h in remote}
    bad = [h for h, p in procs.items() if p.wait() != 0]
    if bad:
        return TaskResult(name, FAILED,
                          f"unreachable over ssh: {', '.join(bad)}",
                          advice="set up passwordless ssh (reference "
                                 "SshValidationTask)")
    return TaskResult(
        name, OK,
        f"{len(remote)} remote host(s) reachable"
        + (f", {len(hosts) - len(remote)} local" if len(hosts)
           != len(remote) else ""))


def _master_address(conf: Configuration) -> str:
    host = conf.get(Keys.MASTER_HOSTNAME) or "localhost"
    return f"{host}:{conf.get_int(Keys.MASTER_RPC_PORT)}"


def _check_cluster_conf(name: str, conf: Configuration) -> TaskResult:
    from alluxio_tpu_torch.rpc.clients import MetaMasterClient

    try:
        report = MetaMasterClient(
            _master_address(conf)).get_config_report()
    except Exception as e:  # noqa: BLE001
        return TaskResult(name, SKIPPED,
                          f"master unreachable ({type(e).__name__}) — "
                          "run against a live cluster for the "
                          "consistency report")
    errs = report.get("errors") or []
    warns = report.get("warns") or []
    if errs:
        return TaskResult(name, FAILED, f"{len(errs)} inconsistent "
                          f"key(s): {errs[:3]}")
    if warns:
        return TaskResult(name, WARNING, f"{len(warns)} warning(s)")
    return TaskResult(name, OK, "cluster config consistent")


def env_tool(conf: Configuration,
             conf_dir: Optional[str] = None) -> ValidationTool:
    tool = ValidationTool("validateEnv")
    host = conf.get(Keys.MASTER_HOSTNAME) or "localhost"
    tool.add("master.rpc.port", lambda: _check_port(
        "master.rpc.port", host, conf.get_int(Keys.MASTER_RPC_PORT)))
    tool.add("master.web.port", lambda: _check_port(
        "master.web.port", host, conf.get_int(Keys.MASTER_WEB_PORT)))
    tool.add("worker.rpc.port", lambda: _check_port(
        "worker.rpc.port", "localhost",
        conf.get_int(Keys.WORKER_RPC_PORT)))
    levels = conf.get_int(Keys.WORKER_TIERED_STORE_LEVELS)
    for lvl in range(levels):
        key = Templates.WORKER_TIER_DIRS_PATH.format(lvl)
        paths = conf.get_list(key) or [""]
        for p in paths:
            tool.add(f"tier{lvl}.dir", lambda p=p, lvl=lvl: _check_dir(
                f"tier{lvl}.dir", p.strip(), 64 << 20))
    tool.add("native.lib", lambda: _check_native("native.lib"))
    cdir = conf_dir or os.environ.get("ATPU_CONF_DIR", "conf")
    tool.add("ssh.masters", lambda: _check_ssh(
        "ssh.masters", cdir, "masters"))
    tool.add("ssh.workers", lambda: _check_ssh(
        "ssh.workers", cdir, "workers"))
    tool.add("cluster.conf", lambda: _check_cluster_conf(
        "cluster.conf", conf))
    return tool


# -- hms tasks (reference HmsValidationTool tasks) --------------------

def hms_tool(connection: str, db_name: str = "default",
             tables: str = "", fs=None,
             timeout_s: float = 10.0) -> ValidationTool:
    from alluxio_tpu_torch.table.hive import (
        HiveMetastoreClient, PathTranslator, mount_translations,
        parse_thrift_uri,
    )

    tool = ValidationTool("validateHms")
    state = {}

    def uri_check() -> TaskResult:
        try:
            state["addr"] = parse_thrift_uri(connection)
        except Exception as e:  # noqa: BLE001
            return TaskResult("hms.uri", FAILED, str(e),
                              advice="expected thrift://host:port "
                                     "(reference UriCheckTask)")
        return TaskResult("hms.uri", OK,
                          "thrift://%s:%d" % state["addr"])

    def connect() -> TaskResult:
        if "addr" not in state:
            return TaskResult("hms.connect", SKIPPED, "bad uri")
        host, port = state["addr"]
        try:
            with socket.create_connection((host, port),
                                          timeout=timeout_s):
                pass
        except OSError as e:
            return TaskResult("hms.connect", FAILED, str(e),
                              advice="metastore unreachable; check "
                                     "host/port/firewall (reference "
                                     "CreateHmsClientValidationTask)")
        state["connected"] = True
        return TaskResult("hms.connect", OK, f"{host}:{port} accepts")

    def metastore() -> TaskResult:
        if not state.get("connected"):
            return TaskResult("hms.metastore", SKIPPED,
                              "connect task did not pass")
        host, port = state["addr"]
        with HiveMetastoreClient(host, port,
                                 timeout_s=timeout_s) as cli:
            dbs = cli.get_all_databases()
        state["dbs"] = dbs
        return TaskResult("hms.metastore", OK,
                          f"{len(dbs)} database(s) visible")

    def database() -> TaskResult:
        if "dbs" not in state:
            return TaskResult("hms.database", SKIPPED,
                              "metastore task did not pass")
        if db_name not in state["dbs"]:
            return TaskResult("hms.database", FAILED,
                              f"database {db_name!r} not found "
                              f"(visible: {state['dbs'][:5]})")
        host, port = state["addr"]
        with HiveMetastoreClient(host, port,
                                 timeout_s=timeout_s) as cli:
            state["db"] = cli.get_database(db_name)
        return TaskResult("hms.database", OK, f"{db_name} readable")

    def table_check() -> TaskResult:
        if "db" not in state:
            return TaskResult("hms.tables", SKIPPED,
                              "database task did not pass")
        if not tables:
            return TaskResult("hms.tables", SKIPPED,
                              "no tables given (-t a,b)")
        host, port = state["addr"]
        translator = None
        if fs is not None:
            translator = PathTranslator(mount_translations(fs))
        bad, checked = [], 0
        with HiveMetastoreClient(host, port,
                                 timeout_s=timeout_s) as cli:
            for t in [t.strip() for t in tables.split(",") if t.strip()]:
                checked += 1
                try:
                    tbl = cli.get_table(db_name, t)
                except Exception as e:  # noqa: BLE001
                    bad.append(f"{t}: {type(e).__name__}")
                    continue
                # raw thrift struct: field 7 = StorageDescriptor,
                # whose field 2 = location (hive_metastore.thrift)
                loc = (tbl.get(7) or {}).get(2) or ""
                if translator is not None and loc and \
                        translator.translate(loc) is None:
                    bad.append(f"{t}: location {loc} not under any "
                               f"mount")
        if bad:
            return TaskResult("hms.tables", FAILED, "; ".join(bad),
                              advice="mount the table's UFS location "
                                     "(reference TableValidationTask)")
        return TaskResult("hms.tables", OK, f"{checked} table(s) ok")

    tool.add("hms.uri", uri_check)
    tool.add("hms.connect", connect)
    tool.add("hms.metastore", metastore)
    tool.add("hms.database", database)
    tool.add("hms.tables", table_check)
    return tool


# -- CLI --------------------------------------------------------------

def print_results(tool_name: str, results: List[TaskResult],
                  out=None) -> int:
    import sys

    out = out or sys.stdout
    worst = 0
    for r in results:
        line = f"[{r.state:>7}] {r.name}: {r.message}"
        if r.advice:
            line += f"\n          advice: {r.advice}"
        print(line, file=out)
        worst = max(worst, {OK: 0, SKIPPED: 0,
                            WARNING: 0, FAILED: 1}[r.state])
    n_fail = sum(1 for r in results if r.state == FAILED)
    print(f"{tool_name}: {len(results)} task(s), {n_fail} failed",
          file=out)
    return worst


def main_env(argv=None, conf: Optional[Configuration] = None,
             out=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="alluxio-tpu validateEnv")
    ap.add_argument("--conf-dir", default=None)
    args = ap.parse_args(argv)
    conf = conf or Configuration()
    tool = env_tool(conf, conf_dir=args.conf_dir)
    return print_results(tool.name, tool.run_all(), out=out)


def main_hms(argv=None, conf: Optional[Configuration] = None,
             out=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="alluxio-tpu validateHms")
    ap.add_argument("-m", "--metastore", required=True,
                    help="thrift://host:port")
    ap.add_argument("-d", "--database", default="default")
    ap.add_argument("-t", "--tables", default="",
                    help="comma-separated table names to check")
    ap.add_argument("--no-fs", action="store_true",
                    help="skip mount-table location translation")
    args = ap.parse_args(argv)
    fs = None
    if not args.no_fs:
        try:
            from alluxio_tpu_torch.client.file_system import FileSystem

            c = conf or Configuration()
            fs = FileSystem(_master_address(c), conf=c)
            fs.list_status("/")  # probe: fall back to no-fs when down
        except Exception:  # noqa: BLE001 cluster optional
            fs = None
    tool = hms_tool(args.metastore, db_name=args.database,
                    tables=args.tables, fs=fs)
    try:
        return print_results(tool.name, tool.run_all(), out=out)
    finally:
        if fs is not None:
            fs.close()
