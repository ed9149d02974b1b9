"""Top-level CLI dispatch: ``python -m alluxio_tpu_torch.shell.main
<command> ...`` (a copy of ``alluxio_tpu/shell/main.py`` for the
commands the port has).

Re-design of ``bin/alluxio`` (the bash dispatcher): routes to the role
launchers, the stress CLI and ``journalCrashTest``. Generic options: ``--master host:port``, ``--job-master
host:port``, ``-D key=value`` config overrides. Every other command of
the JAX package is refused with the ROADMAP item that brings it.
"""

from __future__ import annotations

import sys
from typing import List

from alluxio_tpu_torch.conf import Configuration, Keys

USAGE = """\
Usage: alluxio-tpu [generic options] <command> [command args]

Commands:
  stress     stress benchmark suite (worker/master/prefetch/table/write)
  journalCrashTest  crash-kill masters under load, verify replay
  master     run a master process
  worker     run a worker process
  job-master run a job master process
  job-worker run a job worker process
  version    print the version

Generic options:
  --master host:port      metadata master address
  --job-master host:port  job master address
  -D key=value            set a configuration property
"""

#: the JAX package's other commands, each with the ROADMAP item (its
#: heading in "Open items") that ports it
_NOT_PORTED = {
    **dict.fromkeys(
        ("fs", "fsadmin", "job", "table", "validateConf", "validateEnv",
         "validateHms", "runOperation", "format", "proxy", "logserver",
         "fuse"),
        "Host-only surfaces, last"),
}


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
    cmd = argv[0]
    if cmd == "version":
        import alluxio_tpu_torch

        print(alluxio_tpu_torch.__version__)
        return 0
    if cmd == "stress":
        from alluxio_tpu_torch.stress.__main__ import main as stress_main

        return stress_main(argv[1:])
    if cmd == "journalCrashTest":
        from alluxio_tpu_torch.shell.journal_crash import main as crash_main

        return crash_main(argv[1:])
    if cmd in ("master", "worker", "job-master", "job-worker"):
        from alluxio_tpu_torch.shell.launch import launch_process

        return launch_process(cmd, conf)
    if cmd in _NOT_PORTED:
        print(f"{cmd}: not ported yet; it comes with the ROADMAP item "
              f"'{_NOT_PORTED[cmd]}'", file=sys.stderr)
        return 1
    print(f"Unknown command: {cmd}", file=sys.stderr)
    print(USAGE, file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
