"""Async persist: write a cached file back to its UFS (a copy of
``alluxio_tpu/job/plans/persist.py``).

Re-design of ``job/server/src/main/java/alluxio/job/plan/persist/
PersistDefinition.java``: one task on a worker holding (most of) the file's
blocks; the task drives the worker-side ``persist_file`` (worker streams
blocks to the UFS and returns the fingerprint), then marks the inode
persisted on the master.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, List, Tuple

from alluxio_tpu_torch.job.plan import (
    PlanDefinition, RegisteredJobWorker, RunTaskContext, SelectContext,
)
from alluxio_tpu_torch.utils.exceptions import (
    InvalidArgumentError, UnavailableError,
)


class PersistDefinition(PlanDefinition):
    name = "persist"
    relocatable = True  # any worker can write the UFS copy

    def select_executors(self, config: Dict[str, Any],
                         workers: List[RegisteredJobWorker],
                         ctx: SelectContext) -> List[Tuple[int, Any]]:
        path = config.get("path")
        if not path:
            raise InvalidArgumentError("persist job requires 'path'")
        if not workers:
            raise UnavailableError("no job workers registered")
        info = ctx.fs_master.get_status(path)
        # prefer the job worker co-located with the most cached blocks
        votes: Dict[str, int] = collections.Counter()
        for fbi in ctx.fs_master.get_file_block_info_list(path):
            for loc in fbi.block_info.locations:
                votes[loc.address.tiered_identity.value("host")] += 1
        by_host = {w.hostname: w for w in workers}
        best = None
        for host, _ in votes.most_common():
            if host in by_host:
                best = by_host[host]
                break
        if best is None:
            best = sorted(workers, key=lambda w: w.worker_id)[0]
        return [(best.worker_id, {"path": info.path,
                                  "inode_id": config.get("inode_id",
                                                         0)})]

    def run_task(self, config: Dict[str, Any], task_args: Any,
                 ctx: RunTaskContext) -> Any:
        path = task_args["path"]
        # id-pinned: a rename racing the job must FAIL it (the
        # scheduler re-resolves and retries at the new path), never
        # succeed against whatever file now sits at the old path
        ctx.fs.persist_now(path,
                           expected_id=task_args.get("inode_id", 0))
        return {"persisted": path}

    def join(self, config: Dict[str, Any],
             task_results: List[Any]) -> Any:
        return task_results[0] if task_results else {}
