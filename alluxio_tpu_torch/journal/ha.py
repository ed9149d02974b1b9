"""High availability: primary election, standby tailing, failover (a copy
of ``alluxio_tpu/journal/ha.py``).

Re-designs of the reference HA stack:
- ``PrimarySelector`` SPI (``master/{PrimarySelector,
  ZkPrimarySelector}.java`` + ``journal/raft/RaftPrimarySelector.java``):
  here the in-tree implementation is a **file-lock selector** — an OS
  ``flock`` on ``<journal>/primary.lock`` IS the fence: a deposed primary
  cannot re-acquire while the new one lives, and a crashed one releases
  automatically. Suited to masters sharing a journal directory (same host
  or POSIX-locking shared fs); multi-host quorum = EMBEDDED journal.
- Standby tailing (``UfsJournalCheckpointThread.java:47``): a standby
  replays new segments on an interval and takes periodic checkpoints so
  failover replay is short.
- ``FaultTolerantMasterProcess`` (``master/FaultTolerantAlluxioMaster
  Process.java``): boot as standby, serve when primacy arrives.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from alluxio_tpu_torch.journal.system import LocalJournalSystem
from alluxio_tpu_torch.journal.format import JournalEntry

LOG = logging.getLogger(__name__)


class MasterRegistry:
    """Shared-journal master presence registry: every HA master
    periodically publishes one JSON row (client address, role, term,
    applied sequence) under ``<journal>/masters/``, and anyone sharing
    the folder can list the quorum — the data behind
    ``fsadmin report masters`` and the ``master-quorum-degraded`` health
    rule for the file-lock HA flavor (the EMBEDDED flavor additionally
    merges live Raft quorum state; see ``MasterProcess.masters_report``).

    Rows are atomically replaced (tmp + rename) and carry a wall-clock
    stamp; readers derive ``last_contact_s`` from it.  A stopped master
    removes its row; a crashed one ages out visibly instead."""

    DIR = "masters"

    def __init__(self, journal_folder: str) -> None:
        self._dir = os.path.join(journal_folder, self.DIR)

    def _path_for(self, address: str) -> str:
        return os.path.join(self._dir,
                            address.replace(":", "_").replace("/", "_")
                            + ".json")

    def publish(self, address: str, *, role: str, sequence: int,
                term: int = 0) -> None:
        os.makedirs(self._dir, exist_ok=True)
        row = {"address": address, "role": role, "sequence": int(sequence),
               "term": int(term), "at": time.time()}
        # pid alone is not unique enough: the publish heartbeat and a
        # get_masters RPC (masters_report refreshes our own row) publish
        # concurrently from one process, and a shared tmp name would let
        # one thread os.replace the file out from under the other
        tmp = self._path_for(address) + \
            f".tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(row, f)
        os.replace(tmp, self._path_for(address))

    def withdraw(self, address: str) -> None:
        try:
            os.remove(self._path_for(address))
        except OSError:
            pass

    def list(self) -> List[Dict]:
        """All published rows, stamped with ``last_contact_s`` age."""
        if not os.path.isdir(self._dir):
            return []
        out: List[Dict] = []
        now = time.time()
        for name in sorted(os.listdir(self._dir)):
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(self._dir, name),
                          encoding="utf-8") as f:
                    row = json.load(f)
            except (OSError, ValueError):
                continue  # torn write / concurrent replace: skip this tick
            row["last_contact_s"] = max(0.0, now - float(row.pop("at", now)))
            out.append(row)
        return out


class PrimarySelector:
    """Election SPI (reference: PrimarySelector)."""

    def start(self) -> None: ...

    def stop(self) -> None: ...

    def try_acquire(self) -> bool:
        raise NotImplementedError

    def is_primary(self) -> bool:
        raise NotImplementedError

    def release(self) -> None: ...

    def wait_for_primacy(self, timeout_s: Optional[float] = None,
                         poll_s: float = 0.1) -> bool:
        deadline = None if timeout_s is None else \
            time.monotonic() + timeout_s
        while True:
            if self.try_acquire():
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(poll_s)


class AlwaysPrimarySelector(PrimarySelector):
    """Single-master deployments (no HA)."""

    def try_acquire(self) -> bool:
        return True

    def is_primary(self) -> bool:
        return True


class FileLockPrimarySelector(PrimarySelector):
    """flock-based election over the shared journal directory. The held
    lock doubles as the write fence (reference: the UFS journal fences via
    log rotation; Raft via terms)."""

    LOCK_FILE = "primary.lock"

    def __init__(self, journal_folder: str) -> None:
        self._path = os.path.join(journal_folder, self.LOCK_FILE)
        self._fd: Optional[int] = None
        self._lock = threading.Lock()

    def start(self) -> None:
        os.makedirs(os.path.dirname(self._path), exist_ok=True)

    def try_acquire(self) -> bool:
        import fcntl

        with self._lock:
            if self._fd is not None:
                return True
            fd = os.open(self._path, os.O_CREAT | os.O_RDWR, 0o644)
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                os.close(fd)
                return False
            os.ftruncate(fd, 0)
            os.write(fd, str(os.getpid()).encode())
            self._fd = fd
            return True

    def is_primary(self) -> bool:
        with self._lock:
            return self._fd is not None

    def release(self) -> None:
        import fcntl

        with self._lock:
            if self._fd is None:
                return
            try:
                fcntl.flock(self._fd, fcntl.LOCK_UN)
            finally:
                os.close(self._fd)
                self._fd = None

    stop = release


class JournalTailer:
    """Standby-side catch-up: periodically applies new journal entries and
    takes checkpoints so a later failover replays only a short tail
    (reference: UfsJournalCheckpointThread)."""

    def __init__(self, journal: LocalJournalSystem, *,
                 interval_s: float = 1.0,
                 checkpoint_period_entries: int = 10_000,
                 node: str = "",
                 on_tick: Optional[Callable[[], None]] = None,
                 apply_exclusion: Optional[Callable] = None) -> None:
        """``node``: identity matched against the chaos injector's
        tailer-freeze scope; ``on_tick`` runs after every tail attempt
        (the FT master publishes its registry row on it).
        ``apply_exclusion``: context-manager factory held around each
        catch-up batch — a standby that serves reads installs the inode
        tree's write lock here, excluding served readers from torn
        mid-apply states (the apply path holds no inode-path locks).
        Acquired OUTSIDE the journal lock, preserving the canonical
        tree-lock -> journal-lock order (docs/ha.md)."""
        self._journal = journal
        self._interval = interval_s
        self._ckpt_period = checkpoint_period_entries
        self._applied_at_ckpt = 0
        self._node = node
        self._on_tick = on_tick
        self._apply_exclusion = apply_exclusion
        #: monotonic stamp of the last tick that APPLIED entries (or
        #: found none pending) — `fsadmin report masters` surfaces the
        #: age as tailer lag; a frozen tailer's lag visibly grows
        self.last_caught_up = time.monotonic()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def start(self) -> None:
        self._journal.start()
        self._thread = threading.Thread(target=self._run,
                                        name="journal-tailer", daemon=True)
        self._stop.clear()
        self._thread.start()

    def _run(self) -> None:
        from alluxio_tpu_torch.utils import faults

        while not self._stop.is_set():
            try:
                if faults.armed() and \
                        faults.injector().tailer_frozen(self._node):
                    pass  # chaos: standby falls behind, lag grows
                else:
                    excl = self._apply_exclusion
                    if excl is None:
                        applied = self._journal.catch_up()
                    else:
                        with excl():
                            applied = self._journal.catch_up()
                    self.last_caught_up = time.monotonic()
                    if applied and self._journal.sequence - \
                            self._applied_at_ckpt >= self._ckpt_period:
                        self._journal.checkpoint_standby()
                        self._applied_at_ckpt = self._journal.sequence
            except Exception:  # noqa: BLE001 - keep tailing
                LOG.exception("standby journal tail failed")
            if self._on_tick is not None:
                try:
                    self._on_tick()
                except Exception:  # noqa: BLE001 - publish is best-effort
                    LOG.debug("tailer on_tick failed", exc_info=True)
            self._stop.wait(self._interval)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
