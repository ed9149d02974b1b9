"""Async-persist scheduling: drain requests into job-service persist jobs
(a copy of ``alluxio_tpu/master/persistence.py``).

Re-design of the PersistenceScheduler/PersistenceChecker heartbeats in
``core/server/master/src/main/java/alluxio/master/file/
DefaultFileSystemMaster.java:3810,4001``: files completed with
ASYNC_THROUGH land in the FSM's persist-request queue; each tick this
scheduler submits a ``persist`` plan per request, then tracks
outstanding jobs — failed jobs are retried, completed ones are dropped
(the plan itself marks the inode persisted).

A failed job is resubmitted after a delay that doubles from
``RETRY_BASE_S`` up to ``RETRY_MAX_S``, ``MAX_ATTEMPTS`` jobs in all, over
about ten minutes (reference: each request's ``ExponentialTimer``,
``alluxio.master.persistence.{initial,max}.interval``). JAX's copy
resubmits at once and gives up after three jobs, so a file whose jobs
fail while a new primary settles (its worker not yet re-registered: no
block location, so no job worker can persist it) was never persisted.

Requests are tracked by INODE ID, not path (reference ``PersistJob``
is fileId-keyed): the path is re-resolved at every submission, so a
file renamed between completion and persist is persisted at its
CURRENT path — a path-keyed queue silently lost durability on rename
and could resurrect the old path in the UFS via the failed job's
parent mkdirs (observed as a ghost ``/cp`` directory after
``mv /cp /moved`` raced the scheduler).
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Tuple

LOG = logging.getLogger(__name__)


class PersistenceScheduler:
    MAX_ATTEMPTS = 16
    RETRY_BASE_S = 1.0
    RETRY_MAX_S = 60.0

    def __init__(self, fs_master, job_client, clock=time.monotonic) -> None:
        self._fsm = fs_master
        self._jobs = job_client
        self._clock = clock
        #: job_id -> (inode_id, attempt)
        self._inflight: Dict[int, Tuple[int, int]] = {}
        #: inode_id -> attempt number for the next submission
        self._pending: Dict[int, int] = {}
        #: inode_id -> no resubmission before this clock reading
        self._not_before: Dict[int, float] = {}

    def heartbeat(self) -> None:
        self._check_inflight()
        inflight = {inode_id for inode_id, _ in self._inflight.values()}
        for inode_id in self._fsm.pop_persist_requests():
            # a request for a file whose job is still running is that
            # job's: a second job would persist the same file twice
            if inode_id not in inflight:
                self._pending.setdefault(inode_id, 1)
        self._submit_pending()

    def _submit_pending(self) -> None:
        now = self._clock()
        for inode_id, attempt in list(self._pending.items()):
            if self._not_before.get(inode_id, now) > now:
                continue
            path = self._fsm.current_path_of(inode_id)
            if path is None:
                # deleted since scheduling: nothing left to persist
                LOG.debug("persist of inode %d dropped: gone", inode_id)
                del self._pending[inode_id]
                self._not_before.pop(inode_id, None)
                continue
            try:
                job_id = self._jobs.run({"type": "persist",
                                         "path": str(path),
                                         "inode_id": inode_id})
            except Exception:  # noqa: BLE001 job master down: stays
                LOG.debug("persist submit failed for %s", path,
                          exc_info=True)
                continue  # pending; next tick re-resolves and retries
            del self._pending[inode_id]
            self._inflight[job_id] = (inode_id, attempt)

    def _check_inflight(self) -> None:
        for job_id in list(self._inflight):
            inode_id, attempt = self._inflight[job_id]
            try:
                info = self._jobs.get_status(job_id)
            except Exception:  # noqa: BLE001 transient: retry next tick
                LOG.debug("persist job %s status probe failed",
                          job_id, exc_info=True)
                continue
            if info.status == "COMPLETED":
                del self._inflight[job_id]
                self._not_before.pop(inode_id, None)
            elif info.status in ("FAILED", "CANCELED"):
                del self._inflight[job_id]
                if attempt < self.MAX_ATTEMPTS:
                    delay = min(self.RETRY_BASE_S * 2 ** (attempt - 1),
                                self.RETRY_MAX_S)
                    LOG.warning("persist of inode %d failed (attempt "
                                "%d): %s — retrying in %.1f s", inode_id,
                                attempt, info.error_message, delay)
                    self._pending[inode_id] = attempt + 1
                    self._not_before[inode_id] = self._clock() + delay
                else:
                    LOG.error("persist of inode %d failed after %d "
                              "attempts: %s", inode_id, attempt,
                              info.error_message)
                    self._not_before.pop(inode_id, None)

    @property
    def inflight_count(self) -> int:
        return len(self._inflight)
