"""BASELINE config #3: distributed prefetch (DistributedLoad) GB/s, and
the clairvoyant prefetch bench (a copy of
``alluxio_tpu/stress/prefetch_bench.py``).

Reference analogue: the job-service DistributedLoad path
(``job/server/src/main/java/alluxio/job/plan/load/LoadDefinition.java:65``)
— files persisted in the UFS but not cached are fanned out across N
workers' caches by load-plan tasks; the metric is aggregate prefetch
GB/s from job submission to every block landing in a worker tier.

The port checks the bytes, which the reference does not, outside the
timed window: after the load every file read back through the cluster
must equal its payload, and every block the clairvoyant bench's consumer
took must equal its file's bytes at that block's offset. It has no
``master`` argument (its bench cluster runs in-process only), and the
clairvoyant bench takes the device (``None`` is the card) and puts its
cluster under ``/dev/shm`` when there is one, as the bench cluster does.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np

from alluxio_tpu_torch.stress.base import BenchResult
from alluxio_tpu_torch.stress.cluster import bench_cluster


def run(*, num_workers: int = 4,
        num_files: int = 8, file_bytes: int = 16 << 20,
        replication: int = 1, block_size: int = 4 << 20,
        base_path: str = "/stress-prefetch",
        pressure: bool = False, kill_worker: bool = False,
        rereplicate_timeout_s: float = 240.0) -> BenchResult:
    """``pressure=True`` sizes worker tiers so eviction must fire
    mid-load (tiers are pre-filled with MUST_CACHE filler the load then
    evicts). ``kill_worker=True`` stops one worker (block + job) while
    the load job runs; the plan must still COMPLETE (task failover) and
    the replication checker must restore the killed worker's copies —
    the failure envelope ``LoadDefinition.java:65``-style fan-out exists
    to survive. Every file read back through the cluster, after the
    measurement, must equal its payload (``read_back_mismatches``).
    With ``kill_worker`` the lost-worker check runs every second, the
    count waits until the master has dropped the killed worker
    (``detection_wait_s``, from the kill), and a copy counts only on a
    live worker: until detection the master still lists the dead
    worker's copies, which the reference's drill counts as replicas."""
    from alluxio_tpu_torch.client.streams import WriteType
    from alluxio_tpu_torch.conf import Keys

    rng = np.random.default_rng(0)
    total = num_files * file_bytes
    per_worker_corpus = -(-total * max(replication, 1) // num_workers)
    mem = (per_worker_corpus + 2 * block_size + (8 << 20)) if pressure \
        else total + (128 << 20)
    overrides = {Keys.WORKER_BLOCK_HEARTBEAT_INTERVAL: "50ms"}
    if pressure:
        # single tier: MEM eviction must DROP blocks, not cascade-demote
        # into the default 64MB SSD tier (which would absorb the whole
        # pressure corpus and prove nothing)
        overrides[Keys.WORKER_TIERED_STORE_LEVELS] = 1
    if kill_worker:
        # the master must notice the kill quickly: lost-worker
        # detection drops its block locations, which is what arms the
        # replication checker
        overrides[Keys.MASTER_WORKER_TIMEOUT] = "2s"
        overrides[Keys.JOB_MASTER_WORKER_TIMEOUT] = "2s"
        overrides[Keys.MASTER_LOST_WORKER_DETECTION_INTERVAL] = "1s"
    with bench_cluster(num_workers=num_workers,
                       block_size=block_size,
                       worker_mem_bytes=mem,
                       start_job_service=True,
                       start_worker_heartbeats=True,
                       conf_overrides=overrides) as (fs, cluster):
        # THROUGH: persisted to the UFS, cached nowhere — the cold corpus
        from alluxio_tpu_torch.stress.cluster import write_cold_corpus

        payload = rng.integers(0, 255, size=file_bytes, dtype=np.uint8
                               ).tobytes()
        write_cold_corpus(fs, cluster.block_client(),
                          {f"{base_path}/f-{i:05d}": payload
                           for i in range(num_files)})
        filler_paths = []
        if pressure:
            # fill ~the whole cluster capacity so the load can only
            # proceed by EVICTING (MUST_CACHE filler; LRU/LRFU decides
            # what goes; the last writes may already evict earlier
            # filler — that's the point)
            filler_each = max(block_size, mem // 2 - (1 << 20))
            fill = rng.integers(0, 255, size=filler_each,
                                dtype=np.uint8).tobytes()
            for w in range(num_workers * 2):
                p = f"{base_path}-fill/f-{w}"
                try:
                    fs.write_all(p, fill,
                                 write_type=WriteType.MUST_CACHE)
                    filler_paths.append(p)
                except Exception:  # noqa: BLE001 tier genuinely full
                    break

        killed_mid_job = False
        filler_prekill: dict = {}
        if kill_worker:
            # snapshot filler residency BEFORE the job: the post-kill
            # eviction accounting compares against this to tell
            # "evicted by pressure" from "lost with the worker" (a
            # snapshot at kill time would miss blocks the job already
            # evicted and under-count)
            for p in filler_paths:
                for fbi in fs.fs_master.get_file_block_info_list(p):
                    hosts = {loc.address.tiered_identity.value("host")
                             for loc in fbi.block_info.locations}
                    filler_prekill[(p, fbi.block_info.block_id)] = hosts

        job_client = cluster.job_client()
        t0 = time.monotonic()
        job_id = job_client.run({"type": "load", "path": base_path,
                                 "replication": replication})
        killed_host = ""
        if kill_worker:
            # arm durable-replication recovery NOW (not at write time:
            # a replication_min on a still-cold corpus would have the
            # 0.1s-tick checker churn failing replicate jobs for the
            # whole cold-wait, and race the measured load)
            for i in range(num_files):
                fs.set_attribute(f"{base_path}/f-{i:05d}",
                                 replication_min=max(replication, 1))
            # gate the kill on the job being observed RUNNING with
            # unfinished tasks — a fixed sleep races a fast load and
            # the drill would pass without exercising failover. 20ms:
            # tasks take at least one 50ms worker heartbeat to be
            # pulled, and get_status serializes the task list.
            gate = time.monotonic() + 10.0
            while time.monotonic() < gate:
                ji = job_client.get_status(job_id)
                unfinished = [t for t in ji.tasks
                              if t.status not in ("COMPLETED", "FAILED",
                                                  "CANCELED")]
                if ji.status == "RUNNING" and unfinished:
                    killed_mid_job = True
                    break
                if ji.status != "RUNNING" and ji.status != "CREATED":
                    break  # job already finished: kill is post-job
                time.sleep(0.02)
            victim = cluster.workers[0]
            killed_host = victim.worker.address.tiered_identity.value(
                "host")
            victim.stop()
            killed_at = time.monotonic()
            cluster.job_workers[0].stop()
        info = job_client.wait_for_job(job_id, timeout_s=300.0)
        wall = time.monotonic() - t0
        if info.status != "COMPLETED":
            raise RuntimeError(
                f"load job {job_id} ended {info.status}: "
                f"{info.error_message}")

        dead = {killed_host} if kill_worker else set()

        def replication_counts():
            blocks = cached = 0
            for i in range(num_files):
                for fbi in fs.fs_master.get_file_block_info_list(
                        f"{base_path}/f-{i:05d}"):
                    blocks += 1
                    hosts = [loc.address.tiered_identity.value("host")
                             for loc in fbi.block_info.locations]
                    if len([h for h in hosts if h not in dead]) \
                            >= replication:
                        cached += 1
            return blocks, cached

        detection_wait = 0.0
        if kill_worker:
            deadline = time.monotonic() + rereplicate_timeout_s
            while killed_host in {
                    w.address.tiered_identity.value("host")
                    for w in cluster.block_client().get_worker_infos()}:
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"the master never dropped the killed worker "
                        f"{killed_host} in {rereplicate_timeout_s:.0f}s")
                time.sleep(0.25)
            detection_wait = time.monotonic() - killed_at
        blocks, cached = replication_counts()
        rerepl_wait = 0.0
        if kill_worker:
            # the killed worker's copies must come back: lost-worker
            # detection drops its locations, the ReplicationChecker
            # re-issues replicate jobs until the target holds again
            t1 = time.monotonic()
            deadline = t1 + rereplicate_timeout_s
            while cached < blocks and time.monotonic() < deadline:
                time.sleep(0.25)
                blocks, cached = replication_counts()
            rerepl_wait = time.monotonic() - t1
            if cached < blocks:
                raise RuntimeError(
                    f"re-replication never converged: {cached}/{blocks} "
                    f"blocks at replication {replication} after "
                    f"{rereplicate_timeout_s:.0f}s")
        evicted_filler = 0
        if pressure:
            for p in filler_paths:
                dropped_by_live = False
                for fbi in fs.fs_master.get_file_block_info_list(p):
                    cur = {loc.address.tiered_identity.value("host")
                           for loc in fbi.block_info.locations}
                    pre = filler_prekill.get(
                        (p, fbi.block_info.block_id))
                    if pre is None:  # no kill: any miss is an eviction
                        if not cur:
                            dropped_by_live = True
                    elif (pre - {killed_host}) - cur:
                        # a host OTHER than the killed one dropped the
                        # block -> genuine pressure eviction, not loss
                        dropped_by_live = True
                if dropped_by_live:
                    evicted_filler += 1
            if not evicted_filler:
                raise RuntimeError(
                    "pressure drill never forced an eviction — tier "
                    "sizing is wrong, the drill proved nothing")
        mismatches = sum(
            fs.read_all(f"{base_path}/f-{i:05d}") != payload
            for i in range(num_files))
        moved = total * replication
        return BenchResult(
            bench="distributed-prefetch",
            params={"num_workers": num_workers, "num_files": num_files,
                    "file_bytes": file_bytes, "replication": replication,
                    "block_size": block_size, "pressure": pressure,
                    "worker_killed": kill_worker},
            metrics={"gb_per_s": round(moved / wall / 1e9, 3),
                     "mb_per_s": round(moved / wall / 1e6, 2),
                     "blocks": blocks, "blocks_at_replication": cached,
                     "evicted_filler_files": evicted_filler,
                     "killed_mid_job": killed_mid_job,
                     "rereplication_wait_s": round(rerepl_wait, 2),
                     "detection_wait_s": round(detection_wait, 2),
                     "read_back_mismatches": mismatches},
            errors=blocks - cached + mismatches, duration_s=wall)


def run_clairvoyant(*, num_workers: int = 1, num_files: int = 4,
                    file_bytes: int = 8 << 20,
                    block_size: int = 1 << 20, epochs: int = 2,
                    seed: int = 42, lookahead_blocks: int = 16,
                    budget_bytes: int = 128 << 20,
                    hbm_fraction: float = 0.0,
                    heartbeat_ms: int = 10,
                    base_path: str = "/stress-clairvoyant",
                    device=None) -> BenchResult:
    """Clairvoyant prefetch bench: a seeded multi-epoch DeviceBlockLoader
    run with the oracle -> scheduler -> agent loop live (heartbeat
    thread, no test ticking). Reports the subsystem's own trajectory
    metrics — prefetch hit-rate and p50/p99 block-ready lateness — plus
    consume throughput. After the run, every block the consumer took
    must equal its file's bytes (``block_mismatches``, counted in
    ``errors``)."""
    import torch

    from alluxio_tpu_torch.client.torch_io import DeviceBlockLoader
    from alluxio_tpu_torch.conf import Keys
    from alluxio_tpu_torch.device import resolve_device
    from alluxio_tpu_torch.metrics import metrics
    from alluxio_tpu_torch.minicluster import LocalCluster
    from alluxio_tpu_torch.prefetch import PrefetchService
    from alluxio_tpu_torch.stress.cluster import write_cold_corpus

    device = resolve_device(device)
    # the report reads process-global counters AND timer percentiles;
    # percentiles cannot be delta'd, so p50/p99 come from this run's
    # samples only: the block-ready timer's newest, counted from here
    ready = metrics().timer("Client.PrefetchBlockReady")
    ready_base = ready.histogram()[2]
    rng = np.random.default_rng(seed)
    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    with tempfile.TemporaryDirectory(prefix="atpu-clairvoyant-",
                                     dir=shm) as base:
        with LocalCluster(
                os.path.join(base, "cluster"), num_workers=num_workers,
                block_size=block_size,
                worker_mem_bytes=num_files * file_bytes + (64 << 20),
                start_worker_heartbeats=True,
                conf_overrides={
                    Keys.WORKER_BLOCK_HEARTBEAT_INTERVAL: "50ms",
                    Keys.MASTER_WORKER_TIMEOUT: "10000min",
                }) as cluster:
            fs = cluster.file_system()
            corpus = {
                f"{base_path}/f-{i:03d}": rng.integers(
                    0, 255, size=file_bytes, dtype=np.uint8).tobytes()
                for i in range(num_files)}
            write_cold_corpus(fs, cluster.block_client(), corpus)
            paths = list(corpus)
            conf = cluster.conf.copy()
            conf.set(Keys.PREFETCH_ENABLED, True)
            conf.set(Keys.PREFETCH_LOOKAHEAD_BLOCKS, lookahead_blocks)
            conf.set(Keys.PREFETCH_BUDGET_BYTES, budget_bytes)
            conf.set(Keys.PREFETCH_HBM_FRACTION, hbm_fraction)
            conf.set(Keys.PREFETCH_HEARTBEAT_INTERVAL,
                     f"{heartbeat_ms}ms")
            svc = PrefetchService.from_conf(conf, fs, paths, seed=seed)
            loader = DeviceBlockLoader(
                fs, paths, device=device, prefetch_service=svc,
                hbm_bytes=(budget_bytes if hbm_fraction > 0 else 0))
            base_stats = svc.stats()
            taken = []  # each epoch's blocks, checked after the run
            try:
                svc.start()
                # warm-up gate: let the agent land the first window so
                # the measurement reflects steady state, not cold boot
                svc.wait_ready(min(lookahead_blocks, len(loader)),
                               timeout_s=60.0)
                consumed_bytes = 0
                wall = 0.0  # consume time only: the inter-epoch gate
                # below must not deflate the reported throughput
                for e in range(epochs):
                    blocks = []
                    t0 = time.monotonic()
                    for arr in loader.epoch():
                        consumed_bytes += int(arr.nbytes)
                        blocks.append(arr)
                    wall += time.monotonic() - t0
                    taken.append(blocks)
                    if e + 1 < epochs:
                        # inter-epoch gate: a real consumer spends step
                        # time between epochs; this bench otherwise
                        # re-reads instantly and races the replan tick
                        svc.wait_ready(min(lookahead_blocks,
                                           len(loader)), timeout_s=60.0)
            finally:
                stall = loader.stall_report()  # input doctor, pre-close
                loader.close()
                svc.close()
            stats = svc.stats()
            samples = ready.recent(ready.histogram()[2] - ready_base)
            mismatches = _check_blocks(torch, device, corpus, taken,
                                       svc.epoch_sequence)
            hits = stats["hits"] - base_stats["hits"]
            late = stats["late"] - base_stats["late"]
            misses = stats["misses"] - base_stats["misses"]
            consumed = hits + late + misses
            stall_metrics = {
                f"stall_{b}_s": v["wait_s"]
                for b, v in stall["buckets"].items()}
            stall_metrics["input_bound_fraction"] = \
                stall["input_bound_fraction"]
            stall_metrics["stall_verdict"] = stall["verdict"]
            return BenchResult(
                bench="clairvoyant-prefetch",
                params={"num_workers": num_workers,
                        "num_files": num_files, "file_bytes": file_bytes,
                        "block_size": block_size, "epochs": epochs,
                        "seed": seed, "lookahead_blocks": lookahead_blocks,
                        "budget_bytes": budget_bytes,
                        "hbm_fraction": hbm_fraction,
                        "heartbeat_ms": heartbeat_ms},
                metrics={"hit_rate": round(hits / consumed, 4)
                         if consumed else 0.0,
                         "hits": hits, "late": late, "misses": misses,
                         "late_arrivals": stats["late_arrivals"] -
                         base_stats["late_arrivals"],
                         "p50_block_ready_ms": round(
                             _percentile(samples, 50) * 1e3, 3),
                         "p99_block_ready_ms": round(
                             _percentile(samples, 99) * 1e3, 3),
                         "gb_per_s": round(
                             consumed_bytes / wall / 1e9, 3),
                         "blocks_per_epoch": len(loader),
                         "blocks_checked": sum(len(b) for b in taken),
                         "block_mismatches": mismatches,
                         **stall_metrics},
                errors=misses + mismatches, duration_s=wall)


def _percentile(sorted_samples, p: float) -> float:
    """The reference timer's percentile over sorted samples."""
    if not sorted_samples:
        return 0.0
    return sorted_samples[min(len(sorted_samples) - 1,
                              int(p / 100.0 * len(sorted_samples)))]


def _check_blocks(torch, device, corpus: dict, taken: list,
                  epoch_sequence) -> int:
    """Blocks of ``taken`` (one list an epoch, in consume order) that
    differ from their file's bytes at the oracle's block for that
    position; each file's payload goes to the device once."""
    files = {path: torch.frombuffer(bytearray(data), dtype=torch.uint8
                                    ).to(device)
             for path, data in corpus.items()}
    bad = 0
    for epoch, blocks in enumerate(taken):
        refs = epoch_sequence(epoch)
        bad += abs(len(refs) - len(blocks))
        for block, ref in zip(blocks, refs):
            want = files[ref.path][ref.offset:ref.offset + ref.length]
            bad += not torch.equal(block.reshape(-1).view(torch.uint8),
                                   want)
    return bad
