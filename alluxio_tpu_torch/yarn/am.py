"""Application-master loop: turn granted containers into a cluster (a
copy of ``alluxio_tpu/yarn/am.py``).

Env-adapted analogue of the reference's ``ApplicationMaster.java`` and
its command assembly: allocate one master container (optionally
pinned to a host), then the worker fleet with a per-host cap, build
each container's launch command around this repo's own role launcher,
and hand the commands to a ``ContainerLauncher``. The launcher seam is
injectable because real container launch goes through the
NodeManager; tests record commands instead.

Where the port differs: each plan launches a role that serves,
``python -m alluxio_tpu_torch.shell.main master`` (or ``worker``), the
shell's foreground launcher that serves until SIGTERM. The JAX AM
launches ``python -m alluxio_tpu.master.process`` and
``alluxio_tpu.worker.process``, modules with no ``__main__`` block:
each command imports its module and exits 0, so its containers serve
nothing. ``build_command`` keeps JAX's signature and text and takes
the role as a trailing argument.
"""

from __future__ import annotations

import logging
import shlex
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol

from alluxio_tpu_torch.yarn.allocator import (
    ANY_HOST, Container, ContainerAllocator, RmProtocol,
)

logger = logging.getLogger(__name__)

#: the module every plan runs: the shell, whose ``master`` and ``worker``
#: commands launch a role in the foreground
ROLE_MODULE = "alluxio_tpu_torch.shell.main"


@dataclass(frozen=True)
class ClusterSpec:
    """What to stand up (reference ``Client.java`` CLI options)."""

    num_workers: int
    master_host: Optional[str] = None     # None -> ANY_HOST semantics
    max_workers_per_host: int = 1
    master_mem_mb: int = 2048
    worker_mem_mb: int = 4096
    worker_ramdisk_mb: int = 2048
    conf: Dict[str, str] = field(default_factory=dict)


@dataclass(frozen=True)
class LaunchPlan:
    container: Container
    command: str
    env: Dict[str, str]


class ContainerLauncher(Protocol):
    """NodeManager seam: start ``plan.command`` inside the granted
    container. Real deployments shell out through the NM; tests inject
    a recorder."""

    def launch(self, plan: LaunchPlan) -> None: ...


def build_command(module: str, conf: Dict[str, str], *args: str) -> str:
    """The reference's command assembly: one shell-safe command line,
    config passed as ``ATPU_*`` env assignments so the container needs
    no config file (``conf/configuration.py`` env-var surface); ``args``
    follow the module (the role a launcher module runs)."""
    pairs = [f"{_env_key(k)}={shlex.quote(v)}"
             for k, v in sorted(conf.items())]
    return " ".join(["env", *pairs, "python", "-m", module,
                     *(shlex.quote(a) for a in args)])


def _env_key(prop: str) -> str:
    # atpu.master.rpc.port -> ATPU_MASTER_RPC_PORT
    return prop.upper().replace(".", "_")


class SubprocessLauncher:
    """Launch plans as local child processes. This is the AM-side
    fallback when no NodeManager launch gateway is configured: every
    granted container resolves to this host (single-node YARN, or a
    gateway-less smoke deployment). Real multi-host launch goes
    through an NM gateway implementing ``ContainerLauncher``."""

    def __init__(self) -> None:
        import subprocess

        self._subprocess = subprocess
        self.procs: List = []

    def launch(self, plan: LaunchPlan) -> None:
        import os

        self.procs.append(self._subprocess.Popen(
            shlex.split(plan.command),
            env={**os.environ, **plan.env}))

    def wait(self) -> None:
        for p in self.procs:
            p.wait()


class ApplicationMaster:
    """Allocate master + workers, then emit launch plans."""

    def __init__(self, spec: ClusterSpec, rm: RmProtocol,
                 launcher: ContainerLauncher) -> None:
        self._spec = spec
        self._rm = rm
        self._launcher = launcher
        self.master_container: Optional[Container] = None
        self.worker_containers: List[Container] = []

    def run(self) -> List[LaunchPlan]:
        spec = self._spec
        master_alloc = ContainerAllocator(
            "master", 1, 1, self._rm,
            preferred_host=spec.master_host or ANY_HOST,
            memory_mb=spec.master_mem_mb)
        self.master_container = master_alloc.allocate()[0]
        worker_alloc = ContainerAllocator(
            "worker", spec.num_workers, spec.max_workers_per_host,
            self._rm, memory_mb=spec.worker_mem_mb)
        self.worker_containers = worker_alloc.allocate()

        master_host = self.master_container.host
        base_conf = dict(spec.conf)
        base_conf.setdefault("atpu.master.hostname", master_host)

        plans = [LaunchPlan(
            container=self.master_container,
            command=build_command(ROLE_MODULE, base_conf, "master"),
            env={"ATPU_ROLE": "master"})]
        for c in self.worker_containers:
            wconf = dict(base_conf)
            # the worker's real ramdisk key takes a BYTES-typed value
            # (worker/process.py reads atpu.worker.ramdisk.size)
            wconf.setdefault("atpu.worker.ramdisk.size",
                             f"{spec.worker_ramdisk_mb}MB")
            plans.append(LaunchPlan(
                container=c,
                command=build_command(ROLE_MODULE, wconf, "worker"),
                env={"ATPU_ROLE": "worker"}))
        for plan in plans:
            logger.info("launching %s on %s", plan.env["ATPU_ROLE"],
                        plan.container.host)
            self._launcher.launch(plan)
        return plans


def _main(argv=None) -> int:
    """``python -m alluxio_tpu_torch.yarn.am`` — the in-container AM
    entrypoint the submission client's command line points at."""
    import argparse

    from alluxio_tpu_torch.yarn.client import YarnRestClient

    ap = argparse.ArgumentParser(prog="alluxio-tpu-yarn-am")
    ap.add_argument("--rm", required=True)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--master-host", default=None)
    ap.add_argument("--max-workers-per-host", type=int, default=1)
    ap.add_argument("-C", "--conf", action="append", default=[],
                    metavar="key=value")
    args = ap.parse_args(argv)
    conf = dict(kv.split("=", 1) for kv in args.conf)
    spec = ClusterSpec(num_workers=args.workers,
                       master_host=args.master_host,
                       max_workers_per_host=args.max_workers_per_host,
                       conf=conf)
    launcher = SubprocessLauncher()
    ApplicationMaster(spec, YarnRestClient(args.rm), launcher).run()
    launcher.wait()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(_main())
