"""Helpers of the HA parity tests (``tests/test_torch_{raft,ha,
ha_failover,backup,journal_migration}.py``): the same quorum scripts run
on the JAX package and on the port.

Each helper takes ``pkg`` (``"alluxio_tpu"`` or ``"alluxio_tpu_torch"``)
and reaches that package's modules by name, so one script drives both.
Waits poll a condition under a deadline; no helper sleeps a fixed time to
let a cluster settle.
"""

from __future__ import annotations

import importlib
import socket
import threading
import time
from typing import Callable, List, Optional

PACKAGES = ("alluxio_tpu", "alluxio_tpu_torch")
#: the JAX Raft tests' timeouts (``tests/test_raft.py``'s ``FAST``)
FAST = dict(election_timeout_ms=(150, 300), heartbeat_interval_ms=30)


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def free_ports(n: int) -> List[int]:
    """``n`` distinct free ports, all bound at once before any is
    released (the JAX tests' allocation: no two draws collide)."""
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def wait_for(pred: Callable[[], bool], timeout: float = 30.0,
             msg: str = "condition") -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def kv_component(pkg: str):
    """A minimal journaled key-value state machine of ``pkg``."""
    fmt = mod(pkg, "journal.format")

    class Kv(fmt.Journaled):
        journal_name = "Kv"

        def __init__(self) -> None:
            self.data = {}
            self.lock = threading.Lock()

        def process_entry(self, entry) -> bool:
            if entry.type == "kv_put":
                with self.lock:
                    self.data[entry.payload["k"]] = entry.payload["v"]
                return True
            return False

        def snapshot(self) -> dict:
            with self.lock:
                return {"data": dict(self.data)}

        def restore(self, snap: dict) -> None:
            with self.lock:
                self.data = dict(snap.get("data", {}))

        def reset_state(self) -> None:
            with self.lock:
                self.data.clear()

    return Kv()


def make_member(pkg: str, folder: str, port: int, ports: List[int],
                **kw):
    """One ``EmbeddedJournalSystem`` of ``pkg`` with a ``Kv`` registered;
    returns (journal, kv)."""
    raft = mod(pkg, "journal.raft")
    opts = dict(FAST)
    opts.update(kw)
    j = raft.EmbeddedJournalSystem(
        folder, address=f"127.0.0.1:{port}",
        addresses=",".join(f"127.0.0.1:{p}" for p in ports), **opts)
    kv = kv_component(pkg)
    j.register(kv)
    return j, kv


def make_quorum(pkg: str, base, ports: List[int], **kw):
    systems, kvs = [], []
    for i, p in enumerate(ports):
        j, kv = make_member(pkg, str(base / f"m{i}"), p, ports, **kw)
        systems.append(j)
        kvs.append(kv)
    return systems, kvs


def leader_of(systems) -> Optional[object]:
    for j in systems:
        if j is not None and j.node.leader_ready():
            return j
    return None


def put(j, k, v) -> None:
    with j.create_context() as ctx:
        ctx.append("kv_put", {"k": k, "v": v})


def with_stable_leader(systems, fn, timeout: float = 45.0):
    """``fn(leader)`` against the current leader, retried when the leader
    steps down mid-use (as the JAX tests' helper of the same name)."""
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        leader = leader_of(systems)
        if leader is not None:
            try:
                return fn(leader)
            except Exception as e:  # noqa: BLE001 - retried
                if type(e).__name__ not in ("JournalClosedError",
                                            "AssertionError"):
                    raise
                last = e
        time.sleep(0.05)
    if isinstance(last, AssertionError):
        raise last
    raise AssertionError(f"no stable leader within {timeout}s "
                         f"(last error: {last!r})")


def stop_all(systems) -> None:
    for j in systems:
        if j is None:
            continue
        try:
            j.stop()
        except Exception:  # noqa: BLE001 - already stopped
            pass


def tree_view(fs_client, root: str = "/") -> list:
    """A canonical listing of the namespace under ``root``: path, folder
    flag, length and block count of every inode (what two masters that
    applied the same journal must agree on)."""
    return sorted((i.path, bool(i.folder), int(i.length),
                   len(i.block_ids))
                  for i in fs_client.list_status(root, recursive=True))
