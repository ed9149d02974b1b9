"""Replication control: keep cached-copy counts within [min, max] (a
copy of ``alluxio_tpu/master/replication.py``).

One difference: a block that no live worker holds, of a persisted file,
is re-replicated from the UFS (the replicate job carries the block's UFS
source, which its plan already takes). The reference launches a
replicate job that fails for want of a cached copy to copy from, and
fails again every heartbeat, so such a block never comes back.

Re-design of ``core/server/master/src/main/java/alluxio/master/file/
replication/ReplicationChecker.java:57`` + ``job/plan/replicate/
DefaultReplicationHandler.java``: a periodic heartbeat walks files with
replication constraints, compares each block's live location count against
``replication_min``/``replication_max``, and launches replicate/evict jobs
through the job service. In-flight jobs are tracked per block so one
deficit never spawns duplicate jobs. This is also the elastic-recovery
loop: when a worker is lost, its blocks' location counts drop and the next
check re-replicates (SURVEY §5.3).

Besides the constraint walk, the checker exposes
:meth:`request_replication` — targeted one-shot replication the
remediation engine uses to fan a straggling worker's hottest blocks out
to healthy peers.

Observability and bounds: launches/failures/deferrals are counted
(``Master.ReplicationJobs{Launched,Failed,Deferred}`` +
``Master.ReplicationJobsInflight`` gauge), launch failures warn rate-limited instead of vanishing at
debug level, ``_inflight`` is capped so a mass worker loss cannot flood
the job master, and only a NOT-FOUND ``get_status`` reaps an in-flight
entry — a transient job-master RPC blip retries next heartbeat instead
of silently dropping deficit tracking.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Set

from alluxio_tpu_torch.job.wire import Status
from alluxio_tpu_torch.master.inode import PersistenceState
from alluxio_tpu_torch.utils.exceptions import (
    BlockDoesNotExistError, InvalidPathError, NotFoundError,
)

LOG = logging.getLogger(__name__)

#: seconds between launch-failure warnings (each carries the count
#: accumulated since the last one)
_WARN_EVERY_S = 60.0


class ReplicationChecker:
    def __init__(self, fs_master, block_master, job_client, *,
                 max_inflight: int = 256,
                 clock=time.monotonic, registry=None) -> None:
        self._fs = fs_master
        self._bm = block_master
        self._jobs = job_client
        self._clock = clock
        self.max_inflight = max(1, int(max_inflight))
        #: block_id -> in-flight job id
        self._inflight: Dict[int, int] = {}
        self._lock = threading.Lock()
        self._failures_since_warn = 0
        self._last_warn = float("-inf")
        if registry is None:
            from alluxio_tpu_torch.metrics import metrics

            registry = metrics()
        self._c_launched = registry.counter(
            "Master.ReplicationJobsLaunched")
        self._c_failed = registry.counter("Master.ReplicationJobsFailed")
        self._c_deferred = registry.counter(
            "Master.ReplicationJobsDeferred")
        registry.register_gauge("Master.ReplicationJobsInflight",
                                lambda: float(len(self._inflight)))

    def heartbeat(self) -> None:
        self._reap_finished()
        for inode in self._fs.files_with_replication_constraints():
            rmin = inode.replication_min
            rmax = inode.replication_max
            for index, bid in enumerate(inode.block_ids):
                if bid in self._inflight:
                    continue
                try:
                    info = self._bm.get_block_info(bid)
                except (BlockDoesNotExistError, NotFoundError):
                    continue  # block gone; skip
                replicas = len(info.locations)
                if rmin > 0 and replicas < rmin:
                    config = {"type": "replicate", "block_id": bid,
                              "replicas": rmin - replicas}
                    if not replicas:
                        ufs = self._ufs_source(inode, index)
                        if ufs is not None:
                            config["ufs"] = ufs
                    self._launch(bid, config)
                elif 0 <= rmax < replicas:
                    self._launch(bid, {"type": "evict", "block_id": bid,
                                       "replicas": replicas - rmax})

    def request_replication(self, block_ids: List[int], *,
                            replicas: int = 1) -> List[int]:
        """Targeted one-shot replication: +``replicas`` copies of each
        block, deduplicated against in-flight jobs and bounded by the
        same cap as the constraint walk.  Returns the block ids whose
        jobs actually launched (the remediation audit records them)."""
        launched = []
        for bid in block_ids:
            if self._launch(bid, {"type": "replicate", "block_id": bid,
                                  "replicas": int(replicas)}):
                launched.append(bid)
        return launched

    def _ufs_source(self, inode, index: int):
        """Where block ``index`` of a persisted file lies in the UFS (the
        replicate plan's ``ufs`` argument), or None."""
        if inode.persistence_state != PersistenceState.PERSISTED:
            return None
        path = self._fs.inode_tree.path_of_id(inode.id)
        if path is None:
            return None
        try:
            res = self._fs.mount_table.resolve(path)
        except (NotFoundError, InvalidPathError):
            return None
        offset = index * inode.block_size_bytes
        return {"ufs_path": res.ufs_path, "offset": offset,
                "length": min(inode.block_size_bytes, inode.length - offset),
                "mount_id": res.mount_id}

    #: placeholder job id while the launch RPC is in flight — keeps the
    #: (bid) slot reserved so the second writer thread (the remediation
    #: engine calls request_replication off the health heartbeat while
    #: the constraint walk runs on its own) cannot double-launch
    _RESERVED = -1

    def _launch(self, bid: int, config: dict) -> bool:
        with self._lock:
            if bid in self._inflight:
                return False
            if len(self._inflight) >= self.max_inflight:
                # bounded: after a mass worker loss the deficit list
                # can be the whole namespace; the rest waits for the
                # next beat
                self._c_deferred.inc()
                return False
            self._inflight[bid] = self._RESERVED
        try:
            # the RPC runs outside the lock: a slow job master must not
            # serialize the other launcher behind it
            job_id = self._jobs.run(config)
        except Exception:  # noqa: BLE001 - job svc may be down
            with self._lock:
                self._inflight.pop(bid, None)
            self._c_failed.inc()
            self._warn_rate_limited(bid, config)
            return False
        with self._lock:
            self._inflight[bid] = job_id
        self._c_launched.inc()
        return True

    def _warn_rate_limited(self, bid: int, config: dict) -> None:
        """Launch failures used to vanish at debug level while the
        deficit silently persisted; warn, but at most once per minute
        with the accumulated count — a dead job master must not spew
        one line per deficient block per heartbeat."""
        self._failures_since_warn += 1
        now = self._clock()
        if now - self._last_warn < _WARN_EVERY_S:
            LOG.debug("replication job for block %s failed to launch",
                      bid, exc_info=True)
            return
        LOG.warning(
            "%d replication job launch(es) failed since the last "
            "warning (latest: %s for block %s) — is the job service "
            "up?  Master.ReplicationJobsFailed carries the total",
            self._failures_since_warn, config.get("type"), bid,
            exc_info=True)
        self._failures_since_warn = 0
        self._last_warn = now

    def _reap_finished(self) -> None:
        done: Set[int] = set()
        with self._lock:
            inflight = [(b, j) for b, j in self._inflight.items()
                        if j != self._RESERVED]  # launch RPC in flight
        for bid, job_id in inflight:
            try:
                info = self._jobs.get_status(job_id)
            except NotFoundError:
                # genuinely evicted from the job master's ring: the job
                # finished long ago — reap
                done.add(bid)
                continue
            # transport blip: the job may well still be running; reaping
            # now would drop the dedupe entry and double-launch on the
            # next beat. Retried next heartbeat; launch failures are
            # already WARN-logged rate-limited.
            # lint: allow[except-swallow] -- deliberate silent retry: transport blip, job likely still running
            except Exception:  # noqa: BLE001
                continue
            if Status.is_finished(info.status):
                done.add(bid)
        with self._lock:
            for bid in done:
                self._inflight.pop(bid, None)
