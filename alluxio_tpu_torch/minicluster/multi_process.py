"""Multi-process cluster: each role a real OS process (a copy of
``alluxio_tpu/minicluster/multi_process.py``).

Re-design of ``minicluster/src/main/java/alluxio/multi/process/
MultiProcessCluster.java:94`` (+ ``PortCoordination``): spawns the
master and each worker as a separate ``python -m
alluxio_tpu_torch.shell.main <role>`` subprocess configured through
``ATPU_*`` environment variables, with kill and restart of a process by
index (the crash-recovery analogue of ``LimitedLifeMasterProcess``).
The roles are host processes and import neither torch nor JAX.

Several masters, or an EMBEDDED journal, make an HA cluster: every
master is the HA master (``atpu.master.ha.enabled``), on a shared LOCAL
journal directory (file-lock election) or, EMBEDDED, on a journal of its
own with its own Raft port (a quorum over ``raft_addresses``); workers and
clients get the full master list. Differences from the JAX cluster:

- the masters' fast-path sockets live in the cluster's directory
  (``atpu.master.fastpath.dir``, as ``LocalCluster`` does), and the
  cluster's own clients and workers reach them there: keep that
  directory short (a Unix socket path holds 107 bytes);
- a single master on the LOCAL journal is the plain master, not the HA
  one (the JAX cluster starts every master HA);
- HA masters get the master list too (``atpu.master.rpc.addresses``),
  so a standby names the leader's client address in its redirects and
  the quorum view keys its rows by client address; the JAX cluster
  gives the list to workers only;
- ``wait_for_primary`` asks for the master whose ``get_master_info``
  says PRIMARY: a standby serving reads answers that call too;
- with ``atpu.master.web.enabled`` in ``extra_conf`` and no
  ``atpu.master.web.port``, each master gets a web port of its own
  (``master_web_ports``).

Like the JAX cluster, it spawns no job roles: a caller starts them with
``ManagedProcess`` and ``_common_env()``.
"""

from __future__ import annotations

import ctypes
import os
import signal
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional

from alluxio_tpu_torch.rpc.clients import FsMasterClient, MetaMasterClient
from alluxio_tpu_torch.utils.exceptions import AlluxioTpuError


#: the directory that holds the package: children import it from there,
#: whatever their working directory
_PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _libc_prctl():
    """libc's ``prctl``, resolved here in the parent: the dlopen must
    not run in a forked child, where a loader lock another thread held
    at fork time would never be released. None off Linux."""
    try:
        return ctypes.CDLL(None, use_errno=True).prctl
    except (OSError, AttributeError):
        return None


_PRCTL = _libc_prctl()
#: PR_SET_PDEATHSIG is option 1 of prctl(2)
_PR_SET_PDEATHSIG = 1
_SIGTERM = int(signal.SIGTERM)


def _die_with_parent() -> None:
    """In the child, before exec: ask Linux for SIGTERM when the thread
    that spawned it ends, so no role outlives a parent that was killed
    before it could stop its cluster. Only the prctl call runs here:
    nothing is imported or loaded between fork and exec."""
    _PRCTL(_PR_SET_PDEATHSIG, _SIGTERM)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ManagedProcess:
    """One spawned role process.

    The child gets SIGTERM when the THREAD that started it ends (Linux
    ties ``PR_SET_PDEATHSIG`` to the spawning thread, not the process):
    start roles from a thread that outlives them, such as the main
    thread, never from a short-lived helper thread."""

    def __init__(self, role: str, env: Dict[str, str],
                 log_path: str) -> None:
        self.role = role
        self.env = env
        self.log_path = log_path
        self.proc: Optional[subprocess.Popen] = None

    def start(self) -> None:
        env = {**os.environ, **self.env}
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_PACKAGE_PARENT, env.get("PYTHONPATH")) if p)
        with open(self.log_path, "ab") as log:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "alluxio_tpu_torch.shell.main",
                 self.role],
                env=env, stdout=log, stderr=subprocess.STDOUT,
                preexec_fn=_die_with_parent if _PRCTL is not None
                else None)

    def kill(self, sig: int = signal.SIGKILL) -> None:
        """Hard-kill (crash simulation); ``SIGSTOP`` and ``SIGCONT``
        pause and resume the role instead (a silent, then returning
        process), so the call does not wait for an exit."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.send_signal(sig)
            if sig not in (signal.SIGSTOP, signal.SIGCONT):
                self.proc.wait(timeout=10)

    def stop(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=5)

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


class MultiProcessCluster:
    """N masters + M workers, each a real subprocess. Start, restart and
    stop it from a long-lived thread: a role dies with the thread that
    spawned it (:class:`ManagedProcess`)."""

    def __init__(self, base_dir: str, *, num_masters: int = 1,
                 num_workers: int = 1,
                 journal_type: str = "LOCAL",
                 extra_conf: Optional[Dict[str, str]] = None) -> None:
        """``journal_type``: LOCAL = shared journal dir + flock election
        (masters must share a filesystem); EMBEDDED = per-master journal
        dirs + Raft quorum over the embedded journal ports (true
        multi-host HA; reference: EmbeddedJournalIntegrationTest)."""
        self.base = base_dir
        self.journal_dir = os.path.join(base_dir, "journal")
        self.journal_type = journal_type.upper()
        self.master_ports = [free_port() for _ in range(num_masters)]
        self.raft_ports = [free_port() for _ in range(num_masters)]
        self.worker_ports = [free_port() for _ in range(num_workers)]
        self._extra = dict(extra_conf or {})
        self.master_web_ports: List[int] = []
        if str(self._extra.get("atpu.master.web.enabled")).lower() == "true":
            port = self._extra.get("atpu.master.web.port")
            self.master_web_ports = [int(port)] * num_masters \
                if port is not None else \
                [free_port() for _ in range(num_masters)]
        self.masters: List[ManagedProcess] = []
        self.workers: List[ManagedProcess] = []
        os.makedirs(self.journal_dir, exist_ok=True)
        os.makedirs(os.path.join(base_dir, "logs"), exist_ok=True)
        # the master's root UFS (``atpu.home``/underFSStorage), made as
        # LocalCluster makes it, so a THROUGH write has somewhere to land
        os.makedirs(os.path.join(base_dir, "underFSStorage"), exist_ok=True)

    # -- addresses -----------------------------------------------------------
    @property
    def master_addresses(self) -> str:
        return ",".join(f"localhost:{p}" for p in self.master_ports)

    def _common_env(self) -> Dict[str, str]:
        env = {
            "ATPU_HOME": self.base,
            "ATPU_MASTER_JOURNAL_FOLDER": self.journal_dir,
            "ATPU_MASTER_HOSTNAME": "localhost",
            "ATPU_MASTER_SAFEMODE_WAIT": "0s",
        }
        for k, v in self._extra.items():
            env["ATPU_" + str(k).replace("atpu.", "").replace(".", "_")
                .upper()] = str(v)
        return env

    @property
    def ha(self) -> bool:
        """True when the masters run HA (several, or EMBEDDED)."""
        return len(self.master_ports) > 1 or \
            self.journal_type == "EMBEDDED"

    @property
    def raft_addresses(self) -> str:
        return ",".join(f"127.0.0.1:{p}" for p in self.raft_ports)

    def _role_env(self) -> Dict[str, str]:
        """``_common_env`` plus the fast-path socket's directory."""
        return {**self._common_env(),
                "ATPU_MASTER_FASTPATH_DIR": self.base}

    # -- lifecycle -----------------------------------------------------------
    def start(self, timeout_s: float = 180.0) -> "MultiProcessCluster":
        """Start the master, then the workers, each readiness wait
        bounded by ``timeout_s``; a cluster that does not come up stops
        every process it started before the error propagates."""
        try:
            for i in range(len(self.master_ports)):
                self.start_master(i)
            self.wait_for_primary(timeout_s)
            for i in range(len(self.worker_ports)):
                self.start_worker(i)
            self.wait_for_workers(len(self.worker_ports), timeout_s)
        except BaseException:
            self.stop()
            raise
        return self

    def start_master(self, index: int) -> ManagedProcess:
        env = self._role_env()
        env["ATPU_MASTER_RPC_PORT"] = str(self.master_ports[index])
        if self.master_web_ports:
            env["ATPU_MASTER_WEB_PORT"] = str(self.master_web_ports[index])
        if self.ha:
            env["ATPU_MASTER_HA_ENABLED"] = "true"
            env["ATPU_MASTER_RPC_ADDRESSES"] = self.master_addresses
        if self.journal_type == "EMBEDDED":
            env["ATPU_MASTER_JOURNAL_TYPE"] = "EMBEDDED"
            # each quorum member keeps its OWN journal (no shared fs)
            env["ATPU_MASTER_JOURNAL_FOLDER"] = os.path.join(
                self.base, f"journal-m{index}")
            env["ATPU_MASTER_EMBEDDED_JOURNAL_ADDRESSES"] = \
                self.raft_addresses
            env["ATPU_MASTER_EMBEDDED_JOURNAL_ADDRESS"] = \
                f"127.0.0.1:{self.raft_ports[index]}"
        p = ManagedProcess(
            "master", env,
            os.path.join(self.base, "logs", f"master{index}.out"))
        p.start()
        if index < len(self.masters):
            self.masters[index] = p
        else:
            self.masters.append(p)
        return p

    def start_worker(self, index: int) -> ManagedProcess:
        env = self._role_env()
        wdir = os.path.join(self.base, f"worker{index}")
        env.update({
            # HA: workers address the full master list and fail over
            "ATPU_MASTER_RPC_ADDRESSES": self.master_addresses,
            "ATPU_WORKER_RPC_PORT": str(self.worker_ports[index]),
            "ATPU_WORKER_DATA_FOLDER": wdir,
            "ATPU_WORKER_SHM_DIR": os.path.join(wdir, "shm"),
            "ATPU_WORKER_HOSTNAME": "localhost",
            "ATPU_WORKER_RAMDISK_SIZE": "64MB",
            "ATPU_TIERED_IDENTITY": f"host=localhost-w{index}",
            "ATPU_WORKER_BLOCK_HEARTBEAT_INTERVAL": "200ms",
        })
        p = ManagedProcess(
            "worker", env,
            os.path.join(self.base, "logs", f"worker{index}.out"))
        p.start()
        if index < len(self.workers):
            self.workers[index] = p
        else:
            self.workers.append(p)
        return p

    # -- readiness -----------------------------------------------------------
    def wait_for_primary(self, timeout_s: float = 180.0) -> str:
        """Block until a master serves RPCs as the primary; returns its
        address. A standby that serves reads answers
        ``get_master_info`` too, with the role STANDBY: it is skipped,
        as is a master whose process is gone."""
        deadline = time.monotonic() + timeout_s
        last_err: Optional[Exception] = None
        while time.monotonic() < deadline:
            for i, port in enumerate(self.master_ports):
                if i < len(self.masters) and not self.masters[i].alive:
                    continue
                try:
                    info = MetaMasterClient(
                        f"localhost:{port}", fastpath=False,
                        retry_duration_s=0.2).get_master_info()
                    if info.get("role", "PRIMARY") == "PRIMARY":
                        return f"localhost:{port}"
                except (AlluxioTpuError, Exception) as e:  # noqa: BLE001
                    last_err = e
            time.sleep(0.2)
        raise TimeoutError(f"no primary master within {timeout_s}s: "
                           f"{last_err}")

    def primary_index(self, timeout_s: float = 180.0) -> int:
        """Index of the master currently serving RPCs."""
        addr = self.wait_for_primary(timeout_s)
        return self.master_ports.index(int(addr.rsplit(":", 1)[1]))

    def wait_for_workers(self, count: int, timeout_s: float = 60.0) -> None:
        from alluxio_tpu_torch.rpc.clients import BlockMasterClient

        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                c = BlockMasterClient(self.master_addresses,
                                      retry_duration_s=1.0)
                if len(c.get_worker_infos()) >= count:
                    return
            except Exception:  # noqa: BLE001
                pass
            time.sleep(0.2)
        raise TimeoutError(f"{count} workers not registered in {timeout_s}s")

    # -- clients -------------------------------------------------------------
    def fs_client(self) -> FsMasterClient:
        return FsMasterClient(self.master_addresses, fastpath_dir=self.base)

    def file_system(self, conf=None):
        """A FileSystem client of the cluster. ``conf`` (default: the
        defaults, no environment) is used as given, with the fast-path
        directory set to the cluster's."""
        from alluxio_tpu_torch.client.file_system import FileSystem
        from alluxio_tpu_torch.conf import Configuration, Keys

        conf = conf.copy() if conf is not None \
            else Configuration(load_env=False)
        conf.set(Keys.MASTER_FASTPATH_DIR, self.base)
        return FileSystem(self.master_addresses, conf=conf)

    # -- teardown ------------------------------------------------------------
    def stop(self) -> None:
        for p in self.workers + self.masters:
            p.stop()

    def __enter__(self) -> "MultiProcessCluster":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False
