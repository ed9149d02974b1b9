"""DistributedLoad: replicated cache prefetch — the north-star workload
(a copy of ``alluxio_tpu/job/plans/load.py``).

Re-design of ``job/server/src/main/java/alluxio/job/plan/load/
LoadDefinition.java:52,65,138``: ``select_executors`` picks, per block, up
to ``replication`` job workers whose co-located block worker does NOT hold
the block; ``run_task`` pulls each assigned block into the co-located
worker's tier via the worker's async-cache path and waits for the commit
to land in the block master (read-through caching, §3.5 of SURVEY.md).
Each commit wait is a sample of the ``Job.LoadCommitWait`` timer, which
the reference lacks.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Dict, List, Tuple

from alluxio_tpu_torch.job.plan import (
    PlanDefinition, RegisteredJobWorker, RunTaskContext, SelectContext,
)
from alluxio_tpu_torch.metrics import metrics
from alluxio_tpu_torch.utils.exceptions import (
    InvalidArgumentError, UnavailableError,
)


def _expand_files(ctx: SelectContext, path: str, recursive: bool) -> List:
    info = ctx.fs_master.get_status(path)
    if not info.folder:
        return [info]
    return [i for i in ctx.fs_master.list_status(path, recursive=recursive)
            if not i.folder]


class LoadDefinition(PlanDefinition):
    name = "load"
    relocatable = True  # caching a block is valid on any worker

    def select_executors(self, config: Dict[str, Any],
                         workers: List[RegisteredJobWorker],
                         ctx: SelectContext) -> List[Tuple[int, Any]]:
        path = config.get("path")
        if not path:
            raise InvalidArgumentError("load job requires 'path'")
        replication = int(config.get("replication", 1))
        recursive = bool(config.get("recursive", True))
        if not workers:
            raise UnavailableError("no job workers registered")
        # job workers keyed by the co-located block worker's locality host;
        # a job worker whose block worker is dead cannot cache anything
        live = ctx.live_hosts()
        by_host: Dict[str, RegisteredJobWorker] = {
            w.hostname: w for w in workers if w.hostname in live}
        if not by_host:
            raise UnavailableError(
                "no job worker is co-located with a live block worker")
        assignments: Dict[int, List[dict]] = collections.defaultdict(list)
        # round-robin cursor so load spreads evenly when many hosts qualify
        cursor = 0
        for finfo in _expand_files(ctx, path, recursive):
            fbis = ctx.fs_master.get_file_block_info_list(finfo.path)
            for fbi in fbis:
                blk = fbi.block_info
                have = {loc.address.tiered_identity.value("host")
                        for loc in blk.locations}
                missing = [w for h, w in sorted(by_host.items())
                           if h not in have]
                if not missing:
                    continue
                need = max(0, replication - len(blk.locations))
                chosen = [missing[(cursor + i) % len(missing)]
                          for i in range(min(need, len(missing)))]
                cursor += 1
                for w in chosen:
                    assignments[w.worker_id].append({
                        "path": finfo.path,
                        "block_id": blk.block_id,
                        "offset": fbi.offset,
                        "length": blk.length,
                        "ufs_path": finfo.ufs_path,
                        "mount_id": finfo.mount_id,
                        "persisted": finfo.persisted,
                    })
        return [(wid, blocks) for wid, blocks in assignments.items()]

    def run_task(self, config: Dict[str, Any], task_args: Any,
                 ctx: RunTaskContext) -> Any:
        """Cache every assigned block into the co-located block worker."""
        store = ctx.fs.store
        local = None
        # include_quarantined: co-location lookup wants the LIVE set,
        # not the placement view — a quarantined local worker is still
        # alive and must still be findable (e.g. to evict from it)
        for w in ctx.fs.block_master.get_worker_infos(
                include_quarantined=True):
            if w.address.tiered_identity.value("host") == ctx.hostname:
                local = w
                break
        if local is None:
            raise UnavailableError(
                f"no block worker co-located with job worker {ctx.hostname}")
        client = store.worker_client(local.address)
        loaded = []
        for blk in task_args:
            if blk.get("persisted") and blk.get("ufs_path"):
                client.async_cache(blk["block_id"], blk["ufs_path"],
                                   blk["offset"], blk["length"],
                                   blk.get("mount_id", 0))
                with metrics().timer("Job.LoadCommitWait").time():
                    self._await_commit(ctx.fs.block_master, blk["block_id"],
                                       ctx.hostname)
            else:
                # block only exists in other workers' cache: remote-read it
                # through the local worker (worker-to-worker replication)
                self._replicate_from_peer(ctx, client, blk)
            loaded.append(blk["block_id"])
        return {"loaded_blocks": loaded}

    @staticmethod
    def _await_commit(block_master, block_id: int, hostname: str,
                      timeout_s: float = 60.0) -> None:
        deadline = time.monotonic() + timeout_s
        sleep_s = 0.02
        next_live_check = time.monotonic() + 1.0
        absent_checks = 0
        while time.monotonic() < deadline:
            info = block_master.get_block_info(block_id)
            if any(loc.address.tiered_identity.value("host") == hostname
                   for loc in info.locations):
                return
            if time.monotonic() >= next_live_check:
                # fail FAST when the target worker has left the live
                # set (killed mid-task): burning the full timeout in a
                # 20ms poll loop clogs the executor pool and starves
                # the re-replication the failure is supposed to
                # trigger. HYSTERESIS (3 consecutive absent checks,
                # ~3s): a task-raised error fails the whole plan, so a
                # transient lost-marking (GC pause under a short
                # worker timeout) must get the chance to re-register —
                # only a persistently-absent worker aborts the wait.
                next_live_check = time.monotonic() + 1.0
                # LIVE set incl. quarantined: a worker quarantined
                # mid-load is still registered and still committing —
                # it must not read as "left the cluster"
                live = {w.address.tiered_identity.value("host")
                        for w in block_master.get_worker_infos(
                            include_quarantined=True)}
                absent_checks = 0 if hostname in live \
                    else absent_checks + 1
                if absent_checks >= 3:
                    raise UnavailableError(
                        f"target worker {hostname} left the live set "
                        f"while waiting for block {block_id}")
            time.sleep(sleep_s)
            sleep_s = min(sleep_s * 1.5, 0.25)  # adaptive backoff
        raise UnavailableError(
            f"block {block_id} did not land on {hostname} "
            f"within {timeout_s}s")

    @staticmethod
    def _replicate_from_peer(ctx: RunTaskContext, local_client,
                             blk: dict) -> None:
        info = ctx.fs.block_master.get_block_info(blk["block_id"])
        if not info.locations:
            raise UnavailableError(
                f"block {blk['block_id']} has no cached copy and no "
                "persisted UFS source")
        src = info.locations[0].address
        data = ctx.fs.store.worker_client(src).read_block_bytes(
            blk["block_id"])
        session_id = ctx.fs.store.session_id
        local_client.write_block(blk["block_id"], session_id, data)

    def join(self, config: Dict[str, Any],
             task_results: List[Any]) -> Any:
        blocks = sorted({b for r in task_results
                         for b in (r or {}).get("loaded_blocks", [])})
        return {"loaded_blocks": blocks, "num_blocks": len(blocks)}
