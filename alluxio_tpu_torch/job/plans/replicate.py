"""Block-level replication adjustment plans (a copy of
``alluxio_tpu/job/plans/replicate.py``).

Re-design of ``job/server/src/main/java/alluxio/job/plan/replicate/
{ReplicateDefinition,EvictDefinition,MoveDefinition}.java``: each plan
targets ONE block and adjusts where its cached copies live — replicate
fans a copy out to N more workers, evict drops it from N workers, move
relocates it between workers/tiers. Driven by the master's
ReplicationChecker (reference: ``ReplicationChecker.java:57``).

One difference: replicate spreads its targets. The JAX plan takes the
non-holders in job-worker-id order, so every re-replication after a
worker loss lands on the same lowest-id host; when that host's tier
cannot hold them all it evicts copies it held, which the checker then
sends back to it, without end. The port starts the same ordered list at
the block id modulo its length (the reference's Java plan shuffles the
candidates), so one host takes about its share.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from alluxio_tpu_torch.job.plan import (
    PlanDefinition, RegisteredJobWorker, RunTaskContext, SelectContext,
)
from alluxio_tpu_torch.utils.exceptions import (
    InvalidArgumentError, NotFoundError, UnavailableError,
)


def _local_block_worker(ctx: RunTaskContext):
    # include_quarantined: this resolves the co-located worker to talk
    # TO, not a placement choice — an evict task must still find a
    # quarantined holder, and a replicate target quarantined between
    # select and run is still alive to receive
    for w in ctx.fs.block_master.get_worker_infos(
            include_quarantined=True):
        if w.address.tiered_identity.value("host") == ctx.hostname:
            return w
    raise UnavailableError(
        f"no block worker co-located with job worker {ctx.hostname}")


class ReplicateDefinition(PlanDefinition):
    name = "replicate"
    # receiving a new copy is valid on any non-holder; a holder re-run
    # is a no-op the checker cleans up next tick
    relocatable = True

    def select_executors(self, config: Dict[str, Any],
                         workers: List[RegisteredJobWorker],
                         ctx: SelectContext) -> List[Tuple[int, Any]]:
        block_id = config.get("block_id")
        replicas = int(config.get("replicas", 1))
        if block_id is None:
            raise InvalidArgumentError("replicate job requires 'block_id'")
        info = ctx.block_master.get_block_info(block_id)
        if not info.locations and not config.get("ufs"):
            raise NotFoundError(
                f"block {block_id} has no cached copy to replicate from")
        have = {loc.address.tiered_identity.value("host")
                for loc in info.locations}
        live = ctx.live_hosts()
        missing = [w for w in sorted(workers, key=lambda w: w.worker_id)
                   if w.hostname not in have and w.hostname in live]
        if missing:
            start = block_id % len(missing)
            missing = missing[start:] + missing[:start]
        chosen = missing[:replicas]
        if not chosen:
            return []
        args = {"block_id": block_id, "length": info.length,
                "ufs": config.get("ufs")}
        return [(w.worker_id, args) for w in chosen]

    def run_task(self, config: Dict[str, Any], task_args: Any,
                 ctx: RunTaskContext) -> Any:
        block_id = task_args["block_id"]
        local = _local_block_worker(ctx)
        client = ctx.fs.store.worker_client(local.address)
        ufs = task_args.get("ufs")
        if ufs:
            client.async_cache(block_id, ufs["ufs_path"], ufs["offset"],
                               ufs["length"], ufs.get("mount_id", 0))
            from alluxio_tpu_torch.job.plans.load import LoadDefinition

            LoadDefinition._await_commit(ctx.fs.block_master, block_id,
                                         ctx.hostname)
        else:
            info = ctx.fs.block_master.get_block_info(block_id)
            if not info.locations:
                raise NotFoundError(f"block {block_id} evaporated")
            src = info.locations[0].address
            data = ctx.fs.store.worker_client(src).read_block_bytes(block_id)
            client.write_block(block_id, ctx.fs.store.session_id, data)
        return {"replicated": block_id, "to": ctx.hostname}


class EvictDefinition(PlanDefinition):
    name = "evict"

    def select_executors(self, config: Dict[str, Any],
                         workers: List[RegisteredJobWorker],
                         ctx: SelectContext) -> List[Tuple[int, Any]]:
        block_id = config.get("block_id")
        replicas = int(config.get("replicas", 1))  # how many copies to drop
        if block_id is None:
            raise InvalidArgumentError("evict job requires 'block_id'")
        info = ctx.block_master.get_block_info(block_id)
        have = {loc.address.tiered_identity.value("host")
                for loc in info.locations}
        holders = [w for w in sorted(workers, key=lambda w: w.worker_id)
                   if w.hostname in have]
        args = {"block_id": block_id}
        return [(w.worker_id, args) for w in holders[:replicas]]

    def run_task(self, config: Dict[str, Any], task_args: Any,
                 ctx: RunTaskContext) -> Any:
        block_id = task_args["block_id"]
        local = _local_block_worker(ctx)
        ctx.fs.store.worker_client(local.address).remove_block(block_id)
        return {"evicted": block_id, "from": ctx.hostname}


class MoveDefinition(PlanDefinition):
    name = "move"

    def select_executors(self, config: Dict[str, Any],
                         workers: List[RegisteredJobWorker],
                         ctx: SelectContext) -> List[Tuple[int, Any]]:
        block_id = config.get("block_id")
        dst_host = config.get("destination_host")
        if block_id is None or not dst_host:
            raise InvalidArgumentError(
                "move job requires 'block_id' and 'destination_host'")
        targets = [w for w in workers if w.hostname == dst_host]
        if not targets:
            raise UnavailableError(f"no job worker on host {dst_host}")
        return [(targets[0].worker_id, {"block_id": block_id})]

    def run_task(self, config: Dict[str, Any], task_args: Any,
                 ctx: RunTaskContext) -> Any:
        block_id = task_args["block_id"]
        info = ctx.fs.block_master.get_block_info(block_id)
        sources = [loc.address for loc in info.locations
                   if loc.address.tiered_identity.value("host")
                   != ctx.hostname]
        if not sources:
            return {"moved": block_id, "to": ctx.hostname, "noop": True}
        local = _local_block_worker(ctx)
        client = ctx.fs.store.worker_client(local.address)
        already = any(loc.address.tiered_identity.value("host")
                      == ctx.hostname for loc in info.locations)
        if not already:
            data = ctx.fs.store.worker_client(sources[0]).read_block_bytes(
                block_id)
            client.write_block(block_id, ctx.fs.store.session_id, data)
        for src in sources:
            ctx.fs.store.worker_client(src).remove_block(block_id)
        return {"moved": block_id, "to": ctx.hostname}
