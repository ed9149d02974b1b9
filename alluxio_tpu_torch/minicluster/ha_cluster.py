"""In-process HA test cluster: N fault-tolerant masters over the
EMBEDDED (Raft) journal + workers, with a chaos-action catalog.

The failover analogue of :mod:`local_cluster`: every master is a
:class:`FaultTolerantMasterProcess` with its own journal folder and a
fixed RPC port, quorum membership rides real gRPC, and workers/clients
get the full ``host:port,host:port,...`` master list so their failover
paths (leader-hint redirects, rotation, standby reads, heartbeat
re-registration) are exercised for real (reference:
``MultiProcessCluster.java:94`` runs the same drills as subprocesses;
in-process keeps the chaos deterministic and fast).

``chaos_actions()`` exposes the cluster to a
:class:`~alluxio_tpu_torch.utils.faults.FaultPlan`: kill/restart a master,
freeze a standby's journal apply, partition a quorum member, fail
journal fsyncs, delay a member's elections.  :class:`WriteLedger`
carries the drill invariants — no acknowledged write lost, no standby
read staler than its advertised ``md_version`` (docs/ha.md).
"""

from __future__ import annotations

import os
import socket
import time
from typing import Dict, List, Optional, Tuple

from alluxio_tpu_torch.conf import Configuration, Keys
from alluxio_tpu_torch.master.process import FaultTolerantMasterProcess
from alluxio_tpu_torch.rpc.clients import (
    BlockMasterClient, FsMasterClient, MetaMasterClient,
)
from alluxio_tpu_torch.rpc.core import RpcServer
from alluxio_tpu_torch.rpc.worker_service import worker_service
from alluxio_tpu_torch.utils import faults
from alluxio_tpu_torch.utils.wire import TieredIdentity, WorkerNetAddress
from alluxio_tpu_torch.worker.process import BlockWorker
from alluxio_tpu_torch.worker.ufs_manager import WorkerUfsManager


def free_ports(n: int) -> List[int]:
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


class WriteLedger:
    """Acked-write ledger for chaos invariants.

    ``record(path, stamp)`` is called ONLY after the cluster
    acknowledged the write (the create returned).  Two checkable
    invariants fall out:

    - **durability**: after any failover, every recorded path must
      still exist (``verify_durable``) — an acked write that vanished
      means the journal acked before quorum/fsync durability;
    - **staleness contract**: a standby response stamped ``v`` must
      contain every recorded path whose ack-time stamp is ``<= v``
      (``staleness_violations``) — i.e. a standby read is never staler
      than the ``md_version`` it advertises.
    """

    def __init__(self) -> None:
        self.entries: List[Tuple[str, Optional[int]]] = []

    def record(self, path: str, stamp: Optional[int] = None) -> None:
        self.entries.append((str(path), stamp))

    def verify_durable(self, fs_client: FsMasterClient) -> List[str]:
        """Paths the cluster acked but can no longer see (empty=pass)."""
        return [p for p, _ in self.entries if not fs_client.exists(p)]

    def staleness_violations(self, visible_paths, stamp: Optional[int]
                             ) -> List[str]:
        """Recorded paths whose ack stamp is <= the response stamp but
        which the stamped response does not contain (empty=pass)."""
        if stamp is None:
            return []
        visible = set(visible_paths)
        return [p for p, s in self.entries
                if s is not None and s <= stamp and p not in visible]


class _WorkerHandle:
    def __init__(self, worker: BlockWorker, server: RpcServer, port: int):
        self.worker = worker
        self.server = server
        self.port = port

    def stop(self) -> None:
        self.worker.stop()
        self.server.stop()


class HaCluster:
    """N-master EMBEDDED-journal HA cluster, in-process."""

    def __init__(self, base_dir: str, *, num_masters: int = 3,
                 num_workers: int = 0,
                 conf_overrides: Optional[Dict] = None,
                 worker_mem_bytes: int = 64 << 20,
                 election_timeout: Tuple[str, str] = ("1s", "2s"),
                 ) -> None:
        # election timeouts default well above the reference 300-600ms:
        # in-process quorums share one GIL with busy test clients, and
        # heartbeats starved past a tight timeout churn elections
        # (observed: term 15 before the drill even started)
        self._base = base_dir
        self.num_masters = num_masters
        self._num_workers = num_workers
        self._worker_mem = worker_mem_bytes
        self.rpc_ports = free_ports(num_masters)
        self.raft_ports = free_ports(num_masters)
        self.rpc_addresses = [f"localhost:{p}" for p in self.rpc_ports]
        self.raft_addresses = [f"127.0.0.1:{p}" for p in self.raft_ports]
        self._election_timeout = election_timeout
        self._overrides = dict(conf_overrides or {})
        self.masters: List[Optional[FaultTolerantMasterProcess]] = \
            [None] * num_masters
        self.workers: List[_WorkerHandle] = []

    # -- assembly ------------------------------------------------------------
    @property
    def master_addresses(self) -> str:
        return ",".join(self.rpc_addresses)

    def _conf_for(self, index: int) -> Configuration:
        c = Configuration(load_env=False)
        base = os.path.join(self._base, f"m{index}")
        c.set(Keys.HOME, base)
        c.set(Keys.MASTER_JOURNAL_FOLDER, os.path.join(base, "journal"))
        c.set(Keys.MASTER_JOURNAL_TYPE, "EMBEDDED")
        c.set(Keys.MASTER_HA_ENABLED, True)
        c.set(Keys.MASTER_RPC_PORT, self.rpc_ports[index])
        c.set(Keys.MASTER_RPC_ADDRESSES, self.master_addresses)
        c.set(Keys.MASTER_EMBEDDED_JOURNAL_ADDRESS,
              self.raft_addresses[index])
        c.set(Keys.MASTER_EMBEDDED_JOURNAL_ADDRESSES,
              ",".join(self.raft_addresses))
        c.set(Keys.MASTER_EMBEDDED_JOURNAL_ELECTION_TIMEOUT_MIN,
              self._election_timeout[0])
        c.set(Keys.MASTER_EMBEDDED_JOURNAL_ELECTION_TIMEOUT_MAX,
              self._election_timeout[1])
        c.set(Keys.MASTER_SAFEMODE_WAIT, "0s")
        c.set(Keys.MASTER_STANDBY_TAIL_INTERVAL, "100ms")
        c.set(Keys.MASTER_HA_PUBLISH_INTERVAL, "200ms")
        # same-host masters would collide on the conventional /tmp
        # fastpath socket; failover behavior under test is the gRPC path
        c.set(Keys.MASTER_FASTPATH_ENABLED, False)
        c.set(Keys.MASTER_WORKER_TIMEOUT, "10000min")
        for k, v in self._overrides.items():
            c.set(k, v)
        return c

    def _start_master(self, index: int) -> FaultTolerantMasterProcess:
        root_ufs = os.path.join(self._base, "underFSStorage")
        os.makedirs(root_ufs, exist_ok=True)
        m = FaultTolerantMasterProcess(self._conf_for(index),
                                       root_ufs_uri=root_ufs)
        m.start()
        self.masters[index] = m
        return m

    def start(self, *, leader_timeout_s: float = 30.0) -> "HaCluster":
        for i in range(self.num_masters):
            self._start_master(i)
        self.await_primary(timeout_s=leader_timeout_s)
        for i in range(self._num_workers):
            self._start_worker(i)
        return self

    def _start_worker(self, index: int) -> _WorkerHandle:
        wconf = self._conf_for(0).copy()
        wdir = os.path.join(self._base, f"worker{index}")
        wconf.set(Keys.WORKER_DATA_FOLDER, wdir)
        wconf.set(Keys.WORKER_SHM_DIR, os.path.join(wdir, "shm"))
        wconf.set(Keys.WORKER_RAMDISK_SIZE, self._worker_mem)
        wconf.set(Keys.WORKER_HOSTNAME, "localhost")
        wconf.set(Keys.WORKER_WEB_PORT, 0)
        wconf.set(Keys.WORKER_BLOCK_HEARTBEAT_INTERVAL, "200ms")
        addrs = self.master_addresses
        bm_client = BlockMasterClient(addrs, conf=wconf)
        fs_client = FsMasterClient(addrs, conf=wconf)
        address = WorkerNetAddress(
            host="localhost", rpc_port=0,
            shm_dir=os.path.join(wdir, "shm"),
            tiered_identity=TieredIdentity.from_spec(
                f"host=localhost-w{index},slice=slice0"))
        worker = BlockWorker(wconf, bm_client, fs_client,
                             ufs_manager=None, address=address,
                             meta_master_client=MetaMasterClient(
                                 addrs, conf=wconf))
        worker.ufs_manager = WorkerUfsManager(fs_client)
        from alluxio_tpu_torch.security.authentication import worker_authenticator

        server = RpcServer(bind_host="127.0.0.1", port=0,
                           authenticator=worker_authenticator(wconf))
        server.add_service(worker_service(worker))
        port = server.start()
        worker.address.rpc_port = port
        worker.address.data_port = port
        # full heartbeats: failover re-registration rides the heartbeat
        # command channel, which is half the point of this cluster
        worker.start()
        handle = _WorkerHandle(worker, server, port)
        self.workers.append(handle)
        return handle

    # -- quorum introspection ------------------------------------------------
    def primary_index(self) -> Optional[int]:
        for i, m in enumerate(self.masters):
            if m is not None and m.serving:
                return i
        return None

    @property
    def primary(self) -> Optional[FaultTolerantMasterProcess]:
        i = self.primary_index()
        return self.masters[i] if i is not None else None

    def standby_indices(self) -> List[int]:
        return [i for i, m in enumerate(self.masters)
                if m is not None and not m.serving]

    def await_primary(self, timeout_s: float = 30.0) -> int:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            i = self.primary_index()
            if i is not None:
                return i
            time.sleep(0.05)
        raise AssertionError(
            f"no primary master within {timeout_s}s "
            f"(roles: {[m and m.serving for m in self.masters]})")

    # -- chaos actions (FaultPlan catalog) -----------------------------------
    def kill_master(self, index: int) -> str:
        m = self.masters[index]
        if m is not None:
            m.stop()
            self.masters[index] = None
        return f"killed m{index}"

    def kill_primary(self) -> str:
        i = self.primary_index()
        if i is None:
            raise AssertionError("no primary to kill")
        return self.kill_master(i)

    def restart_master(self, index: int) -> str:
        if self.masters[index] is not None:
            self.kill_master(index)
        self._start_master(index)
        return f"restarted m{index}"

    def freeze_tailer(self, index: int) -> str:
        """Freeze standby ``index``'s journal apply (Raft apply loop +
        tailer): its served md_version stops advancing."""
        faults.injector().set(
            tailer_freeze_scope=self.raft_addresses[index])
        return f"froze tailer of m{index}"

    def unfreeze_tailer(self) -> str:
        faults.injector().set(tailer_freeze_scope="")
        return "tailer thawed"

    def partition(self, index: int) -> str:
        """Cut quorum traffic to/from member ``index`` (client RPC stays
        reachable — the realistic control-plane partition)."""
        faults.injector().set(partitioned=[self.raft_addresses[index]])
        return f"partitioned m{index}"

    def heal_partition(self) -> str:
        faults.injector().set(partitioned=[])
        return "partition healed"

    def delay_elections(self, index: int) -> str:
        """Member ``index`` sits out elections (still votes)."""
        faults.injector().set(
            election_freeze_scope=self.raft_addresses[index])
        return f"elections delayed on m{index}"

    def release_elections(self) -> str:
        faults.injector().set(election_freeze_scope="")
        return "elections released"

    def fail_fsync(self, count: int = 1) -> str:
        """Arm the next ``count`` journal fsyncs to fail (LOCAL-journal
        flavor crash point; see docs/ha.md)."""
        faults.injector().set(fsync_errors=count)
        return f"armed {count} fsync failures"

    def chaos_actions(self) -> Dict:
        """The action catalog a :class:`FaultPlan` runs against."""
        return {
            "kill_primary": self.kill_primary,
            "kill_master": self.kill_master,
            "restart_master": self.restart_master,
            "freeze_tailer": self.freeze_tailer,
            "unfreeze_tailer": self.unfreeze_tailer,
            "partition": self.partition,
            "heal_partition": self.heal_partition,
            "delay_elections": self.delay_elections,
            "release_elections": self.release_elections,
            "fail_fsync": self.fail_fsync,
        }

    # -- clients -------------------------------------------------------------
    def fs_client(self, **kw) -> FsMasterClient:
        return FsMasterClient(self.master_addresses, **kw)

    def meta_client(self, **kw) -> MetaMasterClient:
        return MetaMasterClient(self.master_addresses, **kw)

    def block_client(self, **kw) -> BlockMasterClient:
        return BlockMasterClient(self.master_addresses, **kw)

    def file_system(self, **conf_overrides):
        from alluxio_tpu_torch.client.file_system import FileSystem

        conf = self._conf_for(0).copy()
        for k, v in conf_overrides.items():
            conf.set(k, v)
        return FileSystem(self.master_addresses, conf=conf)

    # -- lifecycle -----------------------------------------------------------
    def stop(self) -> None:
        faults.injector().reset()
        for w in self.workers:
            w.stop()
        self.workers = []
        for i, m in enumerate(self.masters):
            if m is not None:
                m.stop()
                self.masters[i] = None

    def __enter__(self) -> "HaCluster":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False
