"""BASELINE config #5: async write-through under cache-eviction pressure
(a copy of ``alluxio_tpu/stress/write_bench.py`` that gives every file
its own payload and reads every file back).

Reference analogue: ``TieredBlockStore`` eviction-on-allocation with the
LRFU annotator (``worker/block/TieredBlockStore.java:85``,
``annotator/LRFUAnnotator.java:29``). The bench writes an ASYNC_THROUGH
corpus several times larger than the MEM tier of a MEM+SSD worker, so
allocation continuously demotes cold blocks down-tier while the
persistence scheduler drains writes to the UFS in the background. Metrics:
ingest MB/s (client-visible write rate under pressure), time-to-durable
(all files persisted), and where the blocks ended up. Once the files are
durable, each is read back through the cluster and from its UFS file and
held against its own payload (``read_back_mismatches``, counted in
``errors``): an acknowledged write is read back, and a file that resolves
to another file's bytes does not read back equal. The reference writes
one payload to every file; the first file's payload is that one.
"""

from __future__ import annotations

import time
import numpy as np

from alluxio_tpu_torch.stress.base import BenchResult, drive, percentiles
from alluxio_tpu_torch.stress.cluster import bench_cluster


def _read_ufs_file(ufs_path: str) -> bytes:
    path = ufs_path[len("file://"):] if ufs_path.startswith("file://") \
        else ufs_path
    with open(path, "rb") as f:
        return f.read()


def run(*, threads: int = 4,
        num_files: int = 24, file_bytes: int = 8 << 20,
        mem_bytes: int = 64 << 20, block_size: int = 4 << 20,
        persist_timeout_s: float = 120.0,
        base_path: str = "/stress-write") -> BenchResult:
    from alluxio_tpu_torch.client.streams import WriteType
    from alluxio_tpu_torch.conf import Keys, Templates

    rng = np.random.default_rng(0)
    total = num_files * file_bytes
    overrides = {
        Keys.WORKER_TIERED_STORE_LEVELS: 2,
        Keys.WORKER_ANNOTATOR_CLASS: "LRFU",
        # SSD tier big enough for everything MEM spills
        Templates.WORKER_TIER_DIRS_QUOTA.format(1): str(total + (64 << 20)),
    }
    with bench_cluster(num_workers=1, block_size=block_size,
                       worker_mem_bytes=mem_bytes,
                       conf_overrides=overrides,
                       start_job_service=True) as (fs, cluster):
        files_per_thread = num_files // threads
        written = [f"{base_path}/t{t}/f-{i:05d}"
                   for t in range(threads) for i in range(files_per_thread)]
        payloads = {p: rng.integers(0, 255, size=file_bytes, dtype=np.uint8
                                    ).tobytes() for p in written}

        def op(t: int, i: int) -> int:
            path = f"{base_path}/t{t}/f-{i:05d}"
            fs.write_all(path, payloads[path],
                         write_type=WriteType.ASYNC_THROUGH)
            return file_bytes

        res = drive(threads, op, ops_per_thread=files_per_thread)

        # durability: wait for the persistence scheduler to drain
        t0 = time.monotonic()
        deadline = t0 + persist_timeout_s
        pending = set(written)
        while pending and time.monotonic() < deadline:
            pending = {p for p in pending if not fs.get_status(p).persisted}
            if pending:
                time.sleep(0.1)
        persist_wall = time.monotonic() - t0

        # tier occupancy after the dust settles
        store = cluster.workers[0].worker.store
        tier_usage = {t.alias: t.used_bytes for t in store.meta.tiers}

        # every durable file, through the cluster and from its UFS file
        mismatches = 0
        for p in written:
            if p in pending:
                continue
            mismatches += fs.read_all(p) != payloads[p]
            mismatches += _read_ufs_file(fs.get_status(p).ufs_path) \
                != payloads[p]

        return BenchResult(
            bench="write-through-eviction",
            params={"threads": threads, "num_files": num_files,
                    "file_bytes": file_bytes, "mem_bytes": mem_bytes,
                    "block_size": block_size, "annotator": "LRFU",
                    "pressure_x": round(total / mem_bytes, 1)},
            metrics={"ingest_mb_per_s": round(res.mb_per_s, 2),
                     "time_to_durable_s": round(persist_wall, 2),
                     "unpersisted": len(pending),
                     "tier_used_bytes": tier_usage,
                     "read_back_files": len(written) - len(pending),
                     "read_back_mismatches": mismatches,
                     **percentiles(res.latencies_s)},
            errors=res.errors + len(pending) + mismatches,
            duration_s=res.wall_s)
