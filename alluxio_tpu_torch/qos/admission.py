"""Master RPC admission control: per-principal token buckets wrapped
around the server dispatch (a copy of ``alluxio_tpu/qos/admission.py``).

Overload at the master must be a *bounded, observable* state: over-limit
calls are SHED with a typed ``ResourceExhaustedError`` carrying a
retry-after hint (which ``utils/retry.py`` honors client-side) instead
of queuing in the RPC executor until everything times out.  Principals
come from the existing ``security/`` plumbing — the authenticated user
when the server runs an authenticator, else the ``atpu-user`` metadata
every client attaches.

Conf: ``atpu.master.rpc.admission.*`` (default off; enabling it changes
only what happens to traffic *beyond* a principal's rate).  Worker- and
cluster-critical methods (heartbeats, registration, block commits) are
exempt by default: shedding those would destabilize the cluster faster
than any tenant flood.

Shed calls are audited (``security/audit.py``: principal + command +
``allowed=False``) and counted in ``Master.RpcAdmission*`` metrics; the
controller also samples its counters into the metrics history (source
``master``) so the history RPC shows the flood's shape after the fact.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from alluxio_tpu_torch.qos import TokenBucketSet
from alluxio_tpu_torch.utils.exceptions import ResourceExhaustedError

#: retry-after hints are clamped here: a bucket drained far below zero
#: would otherwise tell a client to go away for minutes, turning one
#: burst into a self-inflicted outage
MAX_RETRY_AFTER_S = 5.0

#: principal used when no identity is attached (NOSASL servers, raw
#: in-process calls): anonymous callers share one bucket — they are
#: indistinguishable, so they must also be un-separable rate-wise
ANONYMOUS = "(anonymous)"

#: cluster-critical methods never shed — the compiled-in floor behind
#: the ``atpu.master.rpc.admission.exempt`` conf default.  The fault-
#: injected reject drill honors this set too (when no controller is
#: configured, ``rpc/core.py``): a rate-1.0 chaos drill must not shed
#: worker registration/heartbeats and destabilize the very cluster it
#: observes.
DEFAULT_EXEMPT = frozenset((
    "register", "heartbeat", "commit_block", "get_worker_id",
    "metrics_heartbeat", "file_system_heartbeat", "worker_heartbeat",
    "register_worker"))


class AdmissionConf:
    """Parsed ``atpu.master.rpc.admission.*`` (one read at boot)."""

    def __init__(self, *, enabled: bool = False, rate: float = 200.0,
                 burst: float = 400.0, max_principals: int = 4096,
                 exempt: tuple = ()) -> None:
        self.enabled = bool(enabled)
        self.rate = max(1e-3, float(rate))
        self.burst = max(1.0, float(burst))
        self.max_principals = max(1, int(max_principals))
        self.exempt = frozenset(exempt)

    @classmethod
    def from_conf(cls, conf) -> "AdmissionConf":
        from alluxio_tpu_torch.conf import Keys

        exempt = tuple(
            m.strip() for m in str(conf.get(
                Keys.MASTER_RPC_ADMISSION_EXEMPT) or "").split(",")
            if m.strip())
        return cls(
            enabled=conf.get_bool(Keys.MASTER_RPC_ADMISSION_ENABLED),
            rate=conf.get_float(Keys.MASTER_RPC_ADMISSION_RATE),
            burst=conf.get_float(Keys.MASTER_RPC_ADMISSION_BURST),
            max_principals=conf.get_int(
                Keys.MASTER_RPC_ADMISSION_MAX_PRINCIPALS),
            exempt=exempt)


class _PrincipalStats:
    __slots__ = ("admitted", "shed", "last_shed_at")

    def __init__(self) -> None:
        self.admitted = 0
        self.shed = 0
        self.last_shed_at = 0.0


class AdmissionController:
    """Per-principal token-bucket gate on the master's RPC dispatch.

    ``check()`` runs on every non-exempt RPC: O(1), one lock hop in the
    bucket plus one in the stats map.  Shedding never allocates beyond
    the bounded principal maps — the whole point is that a flood cannot
    grow server state.
    """

    def __init__(self, conf: AdmissionConf, *, audit_writer=None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.conf = conf
        self._audit = audit_writer
        self._clock = clock
        from collections import OrderedDict

        self._buckets = TokenBucketSet(conf.rate, conf.burst,
                                       max_keys=conf.max_principals,
                                       clock=clock)
        self._stats: "OrderedDict[str, _PrincipalStats]" = OrderedDict()
        self._stats_lock = threading.Lock()
        from alluxio_tpu_torch.metrics import metrics

        m = metrics()
        self._c_admitted = m.counter("Master.RpcAdmissionAdmitted")
        self._c_shed = m.counter("Master.RpcAdmissionShed")
        m.register_gauge("Master.RpcAdmissionPrincipals",
                         lambda: float(len(self._buckets)))
        #: instance totals: the registry counters above are process-
        #: global (an in-process minicluster shares them across
        #: masters), so reports/history sample THESE
        self.admitted_total = 0
        self.shed_total = 0

    # ------------------------------------------------------------- gate
    def _stat(self, principal: str) -> _PrincipalStats:
        s = self._stats.get(principal)
        if s is None:
            if len(self._stats) >= self.conf.max_principals:
                # LRU-evict (insertion-ordered dict, O(1)); the stats
                # and bucket maps drift independently but both stay
                # bounded, which is what matters under a flood
                self._stats.pop(next(iter(self._stats)))
            s = self._stats[principal] = _PrincipalStats()
        else:
            self._stats.move_to_end(principal)
        return s

    def check(self, principal: Optional[str], method: str) -> None:
        """Admit or raise ``ResourceExhaustedError`` (with
        ``retry_after_s``) for one RPC."""
        if method in self.conf.exempt:
            return
        who = principal or ANONYMOUS
        ok, retry_after = self._buckets.try_acquire(who)
        if ok:
            self._c_admitted.inc()
            with self._stats_lock:
                self.admitted_total += 1
                self._stat(who).admitted += 1
            return
        retry_after = min(MAX_RETRY_AFTER_S, retry_after)
        self._c_shed.inc()
        now = self._clock()
        with self._stats_lock:
            self.shed_total += 1
            s = self._stat(who)
            s.shed += 1
            s.last_shed_at = now
        if self._audit is not None:
            from alluxio_tpu_torch.security.audit import AuditContext

            self._audit.append(AuditContext(
                command=method, user=who, allowed=False,
                succeeded=False))
        err = ResourceExhaustedError(
            f"rpc admission: principal {who!r} is over its master RPC "
            f"rate ({self.conf.rate:g}/s, burst {self.conf.burst:g}); "
            f"retry after {retry_after:.3f}s")
        err.retry_after_s = retry_after
        raise err

    # ----------------------------------------------------------- report
    def report(self) -> dict:
        """Wire view for the meta service's ``get_qos``."""
        with self._stats_lock:
            rows = [{"principal": p, "admitted": s.admitted,
                     "shed": s.shed, "last_shed_at": s.last_shed_at}
                    for p, s in self._stats.items()]
        rows.sort(key=lambda r: (-r["shed"], -r["admitted"]))
        return {
            "enabled": self.conf.enabled,
            "rate_per_s": self.conf.rate,
            "burst": self.conf.burst,
            "max_principals": self.conf.max_principals,
            "exempt": sorted(self.conf.exempt),
            "principals": rows[:64],
            "admitted_total": self.admitted_total,
            "shed_total": self.shed_total,
            "bucket_evictions": self._buckets.evictions,
        }

    def shed_counts(self) -> Dict[str, int]:
        """principal -> shed count; the tenant-overload health rule
        diffs successive snapshots of this."""
        with self._stats_lock:
            return {p: s.shed for p, s in self._stats.items() if s.shed}

    def sample_history(self, history, now: Optional[float] = None) -> None:
        """Push the admission counters into the metrics history as
        ``master``-source series (same pattern as the remediation
        engine's ``Master.Remediation*`` samples)."""
        if history is None:
            return
        history.ingest("master", {
            "Master.RpcAdmissionAdmitted": float(self.admitted_total),
            "Master.RpcAdmissionShed": float(self.shed_total),
            "Master.RpcAdmissionPrincipals": float(len(self._buckets)),
        }, **({} if now is None else {"now": now}))
