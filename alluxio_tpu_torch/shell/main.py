"""Top-level CLI dispatch: ``python -m alluxio_tpu_torch.shell.main
<command> ...`` (a copy of ``alluxio_tpu/shell/main.py``).

Re-design of ``bin/alluxio`` (the bash dispatcher): routes to the fs,
fsadmin, job and table shells, ``validateConf``, ``validateEnv``,
``validateHms``, ``runOperation``, ``format``, the stress CLI,
``journalCrashTest`` and the role launchers (master, worker, job master,
job worker, proxy, log server, FUSE). Generic options: ``--master
host:port``, ``--job-master host:port``, ``-D key=value`` config
overrides. No command loads torch: an operator's shell builds no CUDA
context.
"""

from __future__ import annotations

import sys
from typing import List

from alluxio_tpu_torch.conf import Configuration, Keys
from alluxio_tpu_torch.shell.command import ShellContext

USAGE = """\
Usage: alluxio-tpu [generic options] <command> [command args]

Commands:
  fs         file system user shell (ls/cat/cp/pin/...)
  fsadmin    administration shell (report/doctor/journal/...)
  job        job service shell (ls/stat/cancel)
  table      table/catalog shell (attachdb/ls/sync/transform)
  stress     stress benchmark suite (worker/master/prefetch/table/write)
  validateConf  sanity-check the effective configuration
  validateEnv   pre-flight node checks (ports/dirs/ssh/native/cluster)
  validateHms   validate a Hive metastore before table attachdb
  runOperation  run one fs operation N times over T threads
  journalCrashTest  crash-kill masters under load, verify replay
  format     format master journal / worker storage
  master     run a master process
  worker     run a worker process
  job-master run a job master process
  job-worker run a job worker process
  proxy      run the REST/S3 proxy process
  logserver  run the centralized log aggregation server
  fuse       mount the namespace via FUSE (POSIX view)
  version    print the version

Generic options:
  --master host:port      metadata master address
  --job-master host:port  job master address
  -D key=value            set a configuration property
"""


class GenericOptionError(Exception):
    """Bad generic option; message is the usage error."""


def _split_host_port(value: str, flag: str,
                     default_port: int) -> "tuple[str, int]":
    host, sep, port = value.rpartition(":")
    if not sep:
        return value, default_port
    if not port.isdigit():
        raise GenericOptionError(
            f"{flag} expects host:port, got {value!r}")
    return host or "localhost", int(port)


def _parse_generic(argv: List[str], conf: Configuration) -> List[str]:
    rest: List[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--master" and i + 1 < len(argv):
            host, port = _split_host_port(
                argv[i + 1], "--master", conf.get_int(Keys.MASTER_RPC_PORT))
            conf.set(Keys.MASTER_HOSTNAME, host)
            conf.set(Keys.MASTER_RPC_PORT, port)
            i += 2
        elif a == "--job-master" and i + 1 < len(argv):
            host, port = _split_host_port(
                argv[i + 1], "--job-master",
                conf.get_int(Keys.JOB_MASTER_RPC_PORT))
            conf.set(Keys.JOB_MASTER_HOSTNAME, host)
            conf.set(Keys.JOB_MASTER_RPC_PORT, port)
            i += 2
        elif a == "-D" and i + 1 < len(argv):
            k, _, v = argv[i + 1].partition("=")
            conf.set(k, v)
            i += 2
        else:
            rest.append(a)
            i += 1
    return rest


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    conf = Configuration()
    try:
        argv = _parse_generic(argv, conf)
    except GenericOptionError as e:
        print(str(e), file=sys.stderr)
        return 1
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(USAGE)
        return 0
    cmd, rest = argv[0], argv[1:]
    ctx = ShellContext(conf)
    if cmd == "fs":
        from alluxio_tpu_torch.shell.fs_shell import FS_SHELL

        return FS_SHELL.run(rest, ctx)
    if cmd == "fsadmin":
        from alluxio_tpu_torch.shell.fsadmin_shell import ADMIN_SHELL

        return ADMIN_SHELL.run(rest, ctx)
    if cmd == "job":
        from alluxio_tpu_torch.shell.job_shell import JOB_SHELL

        return JOB_SHELL.run(rest, ctx)
    if cmd == "table":
        from alluxio_tpu_torch.shell.table_shell import TABLE_SHELL

        return TABLE_SHELL.run(rest, ctx)
    if cmd == "stress":
        from alluxio_tpu_torch.stress.__main__ import main as stress_main

        return stress_main(rest)
    if cmd == "validateConf":
        from alluxio_tpu_torch.shell.validate import main as validate_main

        return validate_main(rest, conf=conf)
    if cmd == "validateEnv":
        from alluxio_tpu_torch.shell.validate_env import main_env

        return main_env(rest, conf=conf)
    if cmd == "validateHms":
        from alluxio_tpu_torch.shell.validate_env import main_hms

        return main_hms(rest, conf=conf)
    if cmd == "runOperation":
        from alluxio_tpu_torch.shell.run_operation import main as runop_main

        return runop_main(rest, conf=conf)
    if cmd == "journalCrashTest":
        from alluxio_tpu_torch.shell.journal_crash import main as crash_main

        return crash_main(rest)
    if cmd == "format":
        from alluxio_tpu_torch.shell.format import main as format_main

        return format_main(rest)
    if cmd == "version":
        import alluxio_tpu_torch

        print(alluxio_tpu_torch.__version__)
        return 0
    if cmd in ("master", "worker", "job-master", "job-worker", "proxy",
               "logserver", "fuse"):
        from alluxio_tpu_torch.shell.launch import launch_process

        return launch_process(cmd, conf)
    print(f"Unknown command: {cmd}", file=sys.stderr)
    print(USAGE, file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
