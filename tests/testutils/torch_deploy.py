"""Shared helpers for the deployment parity tests (the YARN client,
allocator and application master, the Kubernetes dataset operator): a
wire recorder for the in-process fake HTTP servers, a scripted
ResourceManager built on a package's own ``Container``, a launcher that
records plans, and the configuration of a one-host cluster that an
application master launches here.
"""

from __future__ import annotations

import importlib
import io
import json
import os
import socket
import sys
from typing import Dict, List, Sequence

from tests.testutils.torch_ha import free_ports

PACKAGES = ("alluxio_tpu", "alluxio_tpu_torch")
JAX, PORT = PACKAGES
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def record_wire(srv) -> List[tuple]:
    """Record every request ``srv`` (an ``HttpFakeServer``) serves from
    now on as ``(method, path, JSON body or None)``, in arrival order.
    The body is read once here and handed on to the fake's handler."""
    log: List[tuple] = []
    base = srv._server.RequestHandlerClass

    def recorded(method: str):
        def do(self):
            n = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(n) if n else b""
            log.append((method, self.path,
                        json.loads(raw) if raw.strip() else None))
            self.rfile = io.BytesIO(raw)
            return getattr(base, f"do_{method}")(self)
        return do

    srv._server.RequestHandlerClass = type(
        f"Recording{base.__name__}", (base,),
        {f"do_{m}": recorded(m) for m in ("GET", "POST", "PUT", "PATCH",
                                          "DELETE")
         if hasattr(base, f"do_{m}")})
    return log


def masked(wire: List[tuple], pkg: str, endpoint: str) -> List[tuple]:
    """``wire`` with the package's name and the fake's ``endpoint`` in
    bodies (an AM command names its own package's module and the RM it
    was submitted to) replaced by ``<pkg>`` and ``<rm>``."""
    out = []
    for method, path, body in wire:
        if body is not None:
            body = json.loads(json.dumps(body).replace(
                f"{pkg}.", "<pkg>.").replace(endpoint, "<rm>"))
        out.append((method, path, body))
    return out


class ScriptedRm:
    """In-memory ``RmProtocol`` (JAX's test's, on ``pkg``'s
    ``Container``): offers the scripted host lists round by round (no
    script: an honest round-robin over the requested hosts)."""

    def __init__(self, pkg: str, hosts: Sequence[str],
                 rounds: List[List[str]] = None) -> None:
        self._container = mod(pkg, "yarn.allocator").Container
        self.hosts = list(hosts)
        self.rounds = rounds
        self.released: List[str] = []
        self.requests: List[dict] = []
        self._n = 0

    def node_hosts(self):
        return list(self.hosts)

    def request_containers(self, count, hosts, relax_locality, *,
                           memory_mb=1024, vcores=1):
        self.requests.append({"count": count, "hosts": list(hosts),
                              "relax": relax_locality,
                              "memory_mb": memory_mb})
        if self.rounds is not None:
            grant_hosts = self.rounds.pop(0) if self.rounds else []
        else:
            pool = list(hosts) or self.hosts
            grant_hosts = [pool[i % len(pool)] for i in range(count)]
        out = []
        for h in grant_hosts:
            self._n += 1
            out.append(self._container(f"c{self._n}", h))
        return out

    def release(self, cid):
        self.released.append(cid)


class RecordingLauncher:
    def __init__(self):
        self.plans: List = []

    def launch(self, plan):
        self.plans.append(plan)


def listening(port: int) -> bool:
    try:
        socket.create_connection(("127.0.0.1", port), timeout=0.5).close()
        return True
    except OSError:
        return False


def python_on_path(directory: str) -> str:
    """A ``PATH`` whose first directory, ``directory``, holds a ``python``
    that runs this interpreter (an AM's plan runs ``python``). A script,
    not a symlink: a virtual environment's interpreter finds its
    packages only when started by its own path."""
    os.makedirs(directory, exist_ok=True)
    shim = os.path.join(directory, "python")
    with open(shim, "w") as f:
        f.write(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    os.chmod(shim, 0o755)
    return os.pathsep.join([directory, os.environ.get("PATH", "")])


def one_host_conf(base: str) -> Dict[str, str]:
    """The ``-C`` configuration of a master and a worker that an AM
    launches on this host: ports of their own, every directory under
    ``base`` (the fast-path socket's too: keep ``base`` short)."""
    master, job_master, worker = free_ports(3)
    return {
        "atpu.home": base,
        "atpu.master.journal.folder": os.path.join(base, "journal"),
        "atpu.master.rpc.port": str(master),
        "atpu.master.fastpath.dir": base,
        "atpu.master.safemode.wait": "0s",
        "atpu.job.master.rpc.port": str(job_master),
        "atpu.worker.rpc.port": str(worker),
        "atpu.worker.data.folder": os.path.join(base, "worker"),
        "atpu.worker.shm.dir": os.path.join(base, "shm"),
        "atpu.worker.ramdisk.size": "64MB",
    }
