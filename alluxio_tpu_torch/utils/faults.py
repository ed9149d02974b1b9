"""Conf-gated fault injection for chaos and self-healing tests (a copy of
``alluxio_tpu/utils/faults.py``).

One process-wide injector (in-process miniclusters deliberately share
it) holds three faults, each scoped by an optional host/source
substring so a multi-worker cluster can break exactly one node:

- **read-latency inflation** — the worker's warm ``read_block`` path
  sleeps per chunk, inflating ``Worker.ReadBlockTime`` so the
  p99-regression health rule (and the remediation engine behind it)
  can be driven end to end;
- **heartbeat freeze** — the worker's metrics reporter silently skips
  its ticks, driving the heartbeat-staleness rule without killing the
  process;
- **UFS error rate** — a deterministic fraction of UFS stripe reads
  fail with an injected ``IOError`` (counter-based, not random: the
  Nth failure lands at the same read in every run);
- **RPC reject rate** — a deterministic fraction of master RPC
  dispatches is shed with the same typed ``ResourceExhausted`` +
  retry-after the admission controller emits, so admission shedding
  and client-side retry-after honoring can be chaos-tested end to end
  without a real flood.  The scope substring matches the RPC's
  ``service.method`` key (e.g. scope ``create_file`` rejects only
  CreateFile);
- **SHM map error rate** — a deterministic fraction of client-side
  SHM segment maps fail with an injected ``OSError``, drilling the
  same-host zero-copy path's transparent fallback to remote reads;
- **SHM lease deny rate** — a deterministic fraction of worker
  ``shm_open`` grants is denied as if the lease table were full,
  drilling lease-denied fallback without actually filling
  ``atpu.worker.shm.max.leases``;
- **native exec error rate** — a deterministic fraction of native
  fastpath batches fails mid-table (one op is poisoned, so earlier
  ops really write), drilling the byte-identical fallback from
  ``plan_exec.cpp`` to the pure-Python read path.

The HA chaos drill (docs/ha.md) adds four programmatic faults — set by
the minicluster / :class:`FaultPlan`, not by conf, since they only make
sense against an orchestrated multi-master cluster:

- **tailer freeze** — a standby's journal tailer (or Raft apply loop)
  stops applying: its advertised ``md_version`` stops advancing, which
  is exactly what the standby-read staleness invariant must survive;
- **election freeze** — a quorum member skips starting elections while
  frozen, making "who wins the next election" deterministic in drills;
- **partition** — Raft peer calls touching a matching node id are
  dropped with a ``ConnectionError`` (responses ride the same call, so
  one-sided dropping cuts the link both ways);
- **fsync errors** — the next N journal fsyncs raise ``OSError`` at the
  ``LocalJournalSystem._fsync`` choke point: the crash-point drill for
  "latch broken, never ack-then-lose".

``FaultPlan`` sequences such faults (plus cluster actions like
kill/restart-primary) into one deterministic, replayable schedule.

The port wires every hook at the JAX package's place: the UFS stripe
reads (``worker/ufs_fetch.py``), the warm ``read_block`` latency
(``rpc/worker_service.py``), the RPC reject in the server's dispatch
(``rpc/core.py``), the SHM lease deny (``worker/shm_store.py``), the SHM
map error (``client/shm_transport.py``), the fastpath poison
(``client/fastpath.py``), the heartbeat freeze (the worker's metrics
reporter, ``worker/process.py``), the tailer freeze (``journal/ha.py``'s
tailer and ``journal/raft.py``'s apply loop), the election freeze and the
partition (``journal/raft.py``'s timer loop and peer call) and the fsync
errors (``journal/system.py``'s ``_fsync``).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple


class FaultInjector:
    """Mutable fault state; thread-safe (hooks read under no lock —
    torn reads of independent floats are harmless for chaos knobs)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.read_latency_s: float = 0.0
        self.heartbeat_freeze: bool = False
        self.ufs_error_rate: float = 0.0
        self.rpc_reject_rate: float = 0.0
        self.rpc_reject_retry_after_s: float = 0.05
        self.shm_map_error_rate: float = 0.0
        self.shm_lease_deny_rate: float = 0.0
        self.native_exec_error_rate: float = 0.0
        self.scope: str = ""
        #: HA chaos faults (programmatic; see module docstring)
        self.tailer_freeze_scope: str = ""
        self.election_freeze_scope: str = ""
        self.partitioned: "frozenset[str]" = frozenset()
        self.fsync_errors: int = 0
        #: injected-fault tallies, for tests and fsadmin spelunking
        self.injected = {"read_latency": 0, "heartbeat_freeze": 0,
                         "ufs_error": 0, "rpc_reject": 0,
                         "shm_map_error": 0, "shm_lease_deny": 0,
                         "native_exec_error": 0,
                         "tailer_freeze": 0, "election_freeze": 0,
                         "partition_drop": 0, "fsync_error": 0}
        self._ufs_reads = 0
        self._ufs_failed = 0
        self._rpc_calls = 0
        self._rpc_rejected = 0
        self._shm_maps = 0
        self._shm_map_failed = 0
        self._shm_grants = 0
        self._shm_denied = 0
        self._native_execs = 0
        self._native_failed = 0

    # ----------------------------------------------------------- config
    def configure(self, conf) -> None:
        """Arm from ``atpu.debug.fault.*`` (worker boot calls this)."""
        from alluxio_tpu_torch.conf import Keys

        self.set(
            read_latency_s=conf.get_duration_s(
                Keys.DEBUG_FAULT_READ_LATENCY),
            heartbeat_freeze=conf.get_bool(
                Keys.DEBUG_FAULT_HEARTBEAT_FREEZE),
            ufs_error_rate=conf.get_float(Keys.DEBUG_FAULT_UFS_ERROR_RATE),
            rpc_reject_rate=conf.get_float(
                Keys.DEBUG_FAULT_RPC_REJECT_RATE),
            shm_map_error_rate=conf.get_float(
                Keys.DEBUG_FAULT_SHM_MAP_ERROR_RATE),
            shm_lease_deny_rate=conf.get_float(
                Keys.DEBUG_FAULT_SHM_LEASE_DENY_RATE),
            native_exec_error_rate=conf.get_float(
                Keys.DEBUG_FAULT_NATIVE_EXEC_ERROR_RATE),
            scope=str(conf.get(Keys.DEBUG_FAULT_SCOPE) or ""))

    def set(self, *, read_latency_s: Optional[float] = None,
            heartbeat_freeze: Optional[bool] = None,
            ufs_error_rate: Optional[float] = None,
            rpc_reject_rate: Optional[float] = None,
            shm_map_error_rate: Optional[float] = None,
            shm_lease_deny_rate: Optional[float] = None,
            native_exec_error_rate: Optional[float] = None,
            scope: Optional[str] = None,
            tailer_freeze_scope: Optional[str] = None,
            election_freeze_scope: Optional[str] = None,
            partitioned: Optional[Sequence[str]] = None,
            fsync_errors: Optional[int] = None) -> None:
        global _armed
        with self._lock:
            if read_latency_s is not None:
                self.read_latency_s = max(0.0, float(read_latency_s))
            if heartbeat_freeze is not None:
                self.heartbeat_freeze = bool(heartbeat_freeze)
            if ufs_error_rate is not None:
                self.ufs_error_rate = min(1.0, max(
                    0.0, float(ufs_error_rate)))
            if rpc_reject_rate is not None:
                self.rpc_reject_rate = min(1.0, max(
                    0.0, float(rpc_reject_rate)))
            if shm_map_error_rate is not None:
                self.shm_map_error_rate = min(1.0, max(
                    0.0, float(shm_map_error_rate)))
            if shm_lease_deny_rate is not None:
                self.shm_lease_deny_rate = min(1.0, max(
                    0.0, float(shm_lease_deny_rate)))
            if native_exec_error_rate is not None:
                self.native_exec_error_rate = min(1.0, max(
                    0.0, float(native_exec_error_rate)))
            if scope is not None:
                self.scope = str(scope)
            if tailer_freeze_scope is not None:
                self.tailer_freeze_scope = str(tailer_freeze_scope)
            if election_freeze_scope is not None:
                self.election_freeze_scope = str(election_freeze_scope)
            if partitioned is not None:
                self.partitioned = frozenset(
                    str(p) for p in partitioned if str(p))
            if fsync_errors is not None:
                self.fsync_errors = max(0, int(fsync_errors))
            self._rearm_locked()

    def _rearm_locked(self) -> None:
        global _armed
        _armed = bool(self.read_latency_s or self.heartbeat_freeze
                      or self.ufs_error_rate or self.rpc_reject_rate
                      or self.shm_map_error_rate
                      or self.shm_lease_deny_rate
                      or self.native_exec_error_rate
                      or self.tailer_freeze_scope
                      or self.election_freeze_scope
                      or self.partitioned or self.fsync_errors)

    def reset(self) -> None:
        global _armed
        with self._lock:
            self.read_latency_s = 0.0
            self.heartbeat_freeze = False
            self.ufs_error_rate = 0.0
            self.rpc_reject_rate = 0.0
            self.shm_map_error_rate = 0.0
            self.shm_lease_deny_rate = 0.0
            self.native_exec_error_rate = 0.0
            self.scope = ""
            self.tailer_freeze_scope = ""
            self.election_freeze_scope = ""
            self.partitioned = frozenset()
            self.fsync_errors = 0
            self._ufs_reads = 0
            self._ufs_failed = 0
            self._rpc_calls = 0
            self._rpc_rejected = 0
            self._shm_maps = 0
            self._shm_map_failed = 0
            self._shm_grants = 0
            self._shm_denied = 0
            self._native_execs = 0
            self._native_failed = 0
            for k in self.injected:
                self.injected[k] = 0
            _armed = False

    # ------------------------------------------------------------ hooks
    def _in_scope(self, key: str) -> bool:
        return not self.scope or self.scope in key

    def maybe_sleep_read(self, host: str) -> None:
        if self.read_latency_s > 0 and self._in_scope(host):
            self.injected["read_latency"] += 1
            time.sleep(self.read_latency_s)

    def heartbeat_frozen(self, source: str) -> bool:
        if self.heartbeat_freeze and self._in_scope(source):
            self.injected["heartbeat_freeze"] += 1
            return True
        return False

    def take_ufs_error(self, host: str) -> bool:
        """True when this UFS stripe read should fail.  Deterministic:
        fail whenever the failed/total ratio has fallen behind the
        configured rate — rate 0.25 fails exactly reads 1, 5, 9, ..."""
        rate = self.ufs_error_rate
        if rate <= 0 or not self._in_scope(host):
            return False
        with self._lock:
            self._ufs_reads += 1
            if self._ufs_failed < rate * self._ufs_reads:
                self._ufs_failed += 1
                self.injected["ufs_error"] += 1
                return True
        return False

    def tailer_frozen(self, node: str) -> bool:
        """True while ``node`` matches the tailer-freeze scope: the
        standby's tailer (or Raft apply loop) skips applying, so its
        advertised md_version stops advancing — the staleness-contract
        drill."""
        scope = self.tailer_freeze_scope
        if scope and scope in node:
            self.injected["tailer_freeze"] += 1
            return True
        return False

    def election_frozen(self, node: str) -> bool:
        """True while ``node`` matches the election-freeze scope: the
        member sits out elections (still votes), making drill outcomes
        deterministic."""
        scope = self.election_freeze_scope
        if scope and scope in node:
            self.injected["election_freeze"] += 1
            return True
        return False

    def link_blocked(self, a: str, b: str) -> bool:
        """True when either endpoint of a peer call matches a
        partitioned node id.  Checked on the SENDING side only —
        responses ride the same call, so dropping outbound traffic at
        both members cuts the link bidirectionally."""
        part = self.partitioned
        if not part:
            return False
        for p in part:
            if p in a or p in b:
                self.injected["partition_drop"] += 1
                return True
        return False

    def take_fsync_error(self) -> bool:
        """True when this journal fsync should fail (countdown armed by
        ``fsync_errors=N``): the crash-point drill for the journal's
        latch-broken-never-ack-then-lose contract."""
        if self.fsync_errors <= 0:
            return False
        with self._lock:
            if self.fsync_errors <= 0:
                return False
            self.fsync_errors -= 1
            self.injected["fsync_error"] += 1
            self._rearm_locked()
            return True

    def take_shm_map_error(self, host: str) -> bool:
        """True when this client SHM segment map should fail with an
        injected ``OSError`` — same deterministic failed/total pacing
        as the UFS hook, so the Nth map fails at the same read in
        every run."""
        rate = self.shm_map_error_rate
        if rate <= 0 or not self._in_scope(host):
            return False
        with self._lock:
            self._shm_maps += 1
            if self._shm_map_failed < rate * self._shm_maps:
                self._shm_map_failed += 1
                self.injected["shm_map_error"] += 1
                return True
        return False

    def take_shm_lease_deny(self, host: str) -> bool:
        """True when this worker ``shm_open`` grant should be denied as
        if the lease table were full (deterministic failed/total
        pacing)."""
        rate = self.shm_lease_deny_rate
        if rate <= 0 or not self._in_scope(host):
            return False
        with self._lock:
            self._shm_grants += 1
            if self._shm_denied < rate * self._shm_grants:
                self._shm_denied += 1
                self.injected["shm_lease_deny"] += 1
                return True
        return False

    def take_native_exec_error(self, host: str) -> bool:
        """True when this native fastpath batch should fail mid-table
        (one op poisoned before the call, so earlier ops genuinely
        write before the executor rejects). Same deterministic
        failed/total pacing as the UFS hook — rate 0.5 fails exactly
        batches 1, 3, 5, ..."""
        rate = self.native_exec_error_rate
        if rate <= 0 or not self._in_scope(host):
            return False
        with self._lock:
            self._native_execs += 1
            if self._native_failed < rate * self._native_execs:
                self._native_failed += 1
                self.injected["native_exec_error"] += 1
                return True
        return False

    def take_rpc_reject(self, method_key: str) -> float:
        """Retry-after seconds when this RPC dispatch should be shed
        with an injected ``ResourceExhausted``; 0.0 = admit.  Same
        deterministic failed/total pacing as the UFS hook.  The scope
        substring matches ``method_key`` (``service.method``)."""
        rate = self.rpc_reject_rate
        if rate <= 0 or not self._in_scope(method_key):
            return 0.0
        with self._lock:
            self._rpc_calls += 1
            if self._rpc_rejected < rate * self._rpc_calls:
                self._rpc_rejected += 1
                self.injected["rpc_reject"] += 1
                return self.rpc_reject_retry_after_s
        return 0.0


#: fast-path gate the hook sites check before touching the injector
_armed = False
_injector = FaultInjector()


def injector() -> FaultInjector:
    return _injector


def armed() -> bool:
    return _armed


class InjectedFaultError(IOError):
    """Raised by the UFS hook; a distinct type so tests can tell an
    injected failure from a real one."""


class FaultStep:
    """One scheduled chaos action: at ``at_s`` seconds into the plan,
    call the action named ``action`` with ``kwargs``."""

    __slots__ = ("at_s", "action", "kwargs")

    def __init__(self, at_s: float, action: str, **kwargs) -> None:
        self.at_s = float(at_s)
        self.action = str(action)
        self.kwargs = kwargs

    def __repr__(self) -> str:
        return f"FaultStep({self.at_s}, {self.action!r}, {self.kwargs})"


class FaultPlan:
    """A deterministic, replayable chaos schedule.

    The plan is data (ordered :class:`FaultStep`\\ s); the cluster under
    test supplies the ``actions`` catalog (kill_primary, restart_master,
    freeze_tailer, partition, fail_fsync, delay_elections, ...) — the
    HA minicluster exposes exactly that (``HaCluster.chaos_actions``).
    ``run`` executes steps strictly in schedule order, records an
    execution log (step, wall offset, result/error), and never lets one
    failing step silently skip the rest: errors are logged per step and
    re-raised at the end unless ``continue_on_error``.

    Determinism contract: step ORDER and each action's semantics are
    deterministic; wall-clock offsets are best-effort (``run``
    sleeps to each step's ``at_s``).  Invariant checkers run BETWEEN
    steps via the optional ``between`` callback, so every interleaving
    the plan creates is also observed."""

    def __init__(self, steps: Sequence[FaultStep]) -> None:
        self.steps: List[FaultStep] = sorted(
            steps, key=lambda s: s.at_s)

    def run(self, actions: Dict[str, Callable], *,
            between: Optional[Callable[[FaultStep], None]] = None,
            continue_on_error: bool = False,
            sleep: Callable[[float], None] = time.sleep,
            clock: Callable[[], float] = time.monotonic) -> List[dict]:
        unknown = [s.action for s in self.steps if s.action not in actions]
        if unknown:
            raise KeyError(f"fault plan names unknown actions {unknown}; "
                           f"available: {sorted(actions)}")
        t0 = clock()
        log: List[dict] = []
        first_error: Optional[BaseException] = None
        for step in self.steps:
            wait = t0 + step.at_s - clock()
            if wait > 0:
                sleep(wait)
            entry = {"at_s": step.at_s, "action": step.action,
                     "kwargs": dict(step.kwargs),
                     "ran_at_s": clock() - t0}
            try:
                entry["result"] = actions[step.action](**step.kwargs)
                entry["ok"] = True
            except Exception as e:  # noqa: BLE001 - logged + surfaced below
                entry["ok"] = False
                entry["error"] = f"{type(e).__name__}: {e}"
                if first_error is None:
                    first_error = e
                if not continue_on_error:
                    log.append(entry)
                    raise
            log.append(entry)
            if between is not None:
                between(step)
        if first_error is not None and continue_on_error:
            raise first_error
        return log
