"""On-device stages for BASELINE configs #2–#5 on PyTorch (a copy of
``alluxio_tpu/stress/tpu_suite.py``), run after the headline (config #1)
on the same live cluster and device.

Each stage emits one structured row with an explicit ``vs_baseline``.
The baselines are self-calibrating against this environment's measured
ceilings, as in the reference:

  #2 random-4k    achieved 4k-record read->batch->device rate vs the raw
                  read + host->device ceiling measured adjacently (target
                  >=0.5x: batching small records costs at most half the
                  raw sequential path)
  #3 prefetch     distributedLoad fan-out into 2 workers then stream to
                  the device vs streaming a pre-warmed set (target
                  >=0.7x: the load job must not leave the tiers colder
                  than a plain warm-up)
  #4 projection   3-of-23-column Parquet read into device arrays vs the
                  full-scan wall time (target: speedup >= 3x, the
                  byte-selectivity bound)
  #5 write-evict  ASYNC_THROUGH ingest under memory pressure with LRFU
                  eviction vs the unpressured cold-write rate of config
                  #1 (target >=0.5x: eviction + UFS write-through may
                  halve ingest but must not collapse it)

Where the reference calls ``jax.device_put`` and ``block_until_ready``,
the port copies the numpy view to ``device`` (``None`` is the card) and
synchronizes a CUDA device. It differs from the reference in three ways:

- ``run_all`` has no fallback: a stage that raises fails the run (the
  reference logs it and goes on), and rows carry no host-fallback label;
- each stage checks what it moved and raises when a check fails: #2's
  device batches against the files' bytes; #3's job status, block count,
  locations, spread over the workers and that the post-load stream reads
  nothing from the UFS; #4's projected columns on the device against the
  table's (after the timed window); #5's errors, durability, spill and
  read-back;
- #3 waits until the freed corpus has left every worker before the load
  is timed: the reference starts the load while the workers may still
  hold blocks the free has not reached, and the load then skips them.

Reference analogues: ``AlluxioFuseFileSystem.java:52-55`` random reads,
``LoadDefinition.java:65`` fan-out, ``AlluxioCatalog.java:55`` +
transform path, ``TieredBlockStore.java:85`` + ``LRFUAnnotator.java:29``.
"""

from __future__ import annotations

import collections
import json
import sys
import time
import warnings
from typing import Callable, Dict, List, Optional

import numpy as np

from alluxio_tpu_torch.device import resolve_device


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


#: merged into every row (and its DEVICE-CONFIG stderr line) — set by
#: ``run_all(row_extra=...)`` so a run's rows are labelled at emit time
_ROW_EXTRA: Dict = {}


def _row(config: str, metric: str, value: float, unit: str,
         vs_baseline: float, **extra) -> Dict:
    row = {"config": config, "metric": metric,
           "value": round(value, 3), "unit": unit,
           "vs_baseline": round(vs_baseline, 3), **extra,
           **_ROW_EXTRA}
    log("DEVICE-CONFIG " + json.dumps(row, sort_keys=True))
    return row


def _put(arr: np.ndarray, device):
    """A copy of ``arr`` on ``device`` (the ``jax.device_put`` of the
    reference). A read-only view (bytes from ``read_all``) is copied, never
    written, so torch's warning about it does not apply."""
    import torch

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(arr).to(device, copy=True)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def config2_random_4k(fs, device=None, *, shard_bytes: int,
                      num_shards: int = 4, reads: int = 4096,
                      batch: int = 256) -> Dict:
    """Random 4k reads from the warm host tier, batched onto the device.
    After the timed loop every device batch, copied back, must equal the
    files' bytes at its offsets."""
    from alluxio_tpu_torch.client.streams import WriteType

    device = resolve_device(device)
    rng = np.random.default_rng(7)
    paths, payloads = [], []
    for i in range(num_shards):
        p = f"/bench/r4k-{i}"
        data = rng.integers(0, 255, size=shard_bytes, dtype=np.uint8)
        fs.write_all(p, data.tobytes(), write_type=WriteType.MUST_CACHE)
        paths.append(p)
        payloads.append(data)
    # ceiling: sequential read of one shard + one host->device copy of it
    t0 = time.monotonic()
    blob = fs.read_all(paths[0])
    _put(np.frombuffer(blob, dtype=np.uint8), device)
    _sync(device)
    ceil_rate = shard_bytes / (time.monotonic() - t0)

    handles = [fs.open_file(p) for p in paths]
    offsets = rng.integers(0, shard_bytes - 4096, size=reads)
    shards = rng.integers(0, num_shards, size=reads)
    t0 = time.monotonic()
    buf = np.empty((batch, 4096), dtype=np.uint8)
    done = 0
    devs = []
    for i in range(reads):
        h = handles[shards[i]]
        h.seek(int(offsets[i]))
        buf[done % batch] = np.frombuffer(h.read(4096), dtype=np.uint8)
        done += 1
        if done % batch == 0:  # batch lands on the device
            devs.append(_put(buf.copy(), device))
    _sync(device)
    dt = time.monotonic() - t0
    for h in handles:
        h.close()
    for b, dev in enumerate(devs):
        got = dev.cpu().numpy()
        for j in range(batch):
            i = b * batch + j
            off = int(offsets[i])
            if not np.array_equal(got[j],
                                  payloads[shards[i]][off:off + 4096]):
                raise RuntimeError(
                    f"config #2: device batch {b} row {j} differs from "
                    f"{paths[shards[i]]} at offset {off}")
    rate = reads * 4096 / dt
    return _row("2-random-4k",
                "random 4k reads batched into device memory", rate / 1e6,
                "MB/s", (rate / ceil_rate) / 0.5,
                ops_per_s=round(reads / dt, 1),
                ceiling_mb_per_s=round(ceil_rate / 1e6, 2),
                achieved_vs_ceiling=round(rate / ceil_rate, 3),
                batches_checked=len(devs))


def config3_prefetch(device=None, *, file_bytes: int, num_files: int = 4,
                     num_workers: int = 2,
                     consumer: Optional[Callable[[list, list], Dict]] = None,
                     conf_overrides: Optional[Dict] = None) -> Dict:
    """DistributedLoad fan-out on its own multi-worker cluster, then
    stream the prefetched set onto the device.

    ``consumer(warm_set, loaded_set)``, when given, is called with both
    device sets (lists of uint8 tensors, one a file) while they are alive;
    its dict goes into the row under ``consumer``. Without one, the warm
    set is dropped before the load, as in the reference.
    ``conf_overrides`` go to the cluster after the stage's own (tracing,
    say)."""
    from alluxio_tpu_torch.client.streams import WriteType
    from alluxio_tpu_torch.conf import Keys
    from alluxio_tpu_torch.job.wire import Status
    from alluxio_tpu_torch.metrics import metrics
    from alluxio_tpu_torch.stress.cluster import bench_cluster, wait_cold

    device = resolve_device(device)
    rng = np.random.default_rng(11)
    total = num_files * file_bytes
    paths = [f"/pf/f-{i}" for i in range(num_files)]
    with bench_cluster(num_workers=num_workers,
                       block_size=4 << 20,
                       worker_mem_bytes=total + (128 << 20),
                       start_job_service=True,
                       start_worker_heartbeats=True,
                       conf_overrides={
                           Keys.WORKER_BLOCK_HEARTBEAT_INTERVAL: "50ms",
                           **(conf_overrides or {}),
                       }) as (fs, cluster):
        for p in paths:
            fs.write_all(p, rng.integers(0, 255, size=file_bytes,
                                         dtype=np.uint8).tobytes(),
                         write_type=WriteType.CACHE_THROUGH)
        # warm reference: cached set streamed to the device
        t0 = time.monotonic()
        ref = [_put(np.frombuffer(fs.read_all(p), dtype=np.uint8), device)
               for p in paths]
        _sync(device)
        ref_rate = total / (time.monotonic() - t0)
        if consumer is None:
            del ref
        # make the corpus cold, fan the load out, re-stream
        block_client = cluster.block_client()
        for p in paths:
            fs.free(p, forced=True)
        wait_cold(fs, block_client, paths)
        job_client = cluster.job_client()
        t0 = time.monotonic()
        job_id = job_client.run({"type": "load", "path": "/pf",
                                 "replication": 1})
        info = job_client.wait_for_job(job_id, timeout_s=300.0)
        t_load = time.monotonic() - t0
        if info.status != Status.COMPLETED:
            raise RuntimeError(f"config #3: load job {info.status}: "
                               f"{info.error_message}")
        blocks = [fbi.block_info for p in paths
                  for fbi in fs.fs_master.get_file_block_info_list(p)]
        if info.result["num_blocks"] != len(blocks):
            raise RuntimeError(
                f"config #3: the load job loaded "
                f"{info.result['num_blocks']} blocks of {len(blocks)}")
        unplaced = [b.block_id for b in blocks if not b.locations]
        if unplaced:
            raise RuntimeError(f"config #3: {len(unplaced)} blocks have no "
                               f"location after the load")
        by_host = collections.Counter(
            loc.address.tiered_identity.value("host")
            for b in blocks for loc in b.locations)
        if len(by_host) < min(num_workers, len(blocks)):
            raise RuntimeError(f"config #3: the load placed blocks on "
                               f"{dict(by_host)} only")
        m = metrics()
        ufs_bytes, ufs_blocks = (m.counter("Client.BytesRead.ufs"),
                                 m.counter("Worker.UfsBlocksRead"))
        ufs0 = (ufs_bytes.count, ufs_blocks.count)
        t0 = time.monotonic()
        out = [_put(np.frombuffer(fs.read_all(p), dtype=np.uint8), device)
               for p in paths]
        _sync(device)
        rate = total / (time.monotonic() - t0)
        ufs_read = (ufs_bytes.count - ufs0[0], ufs_blocks.count - ufs0[1])
        if any(ufs_read):
            raise RuntimeError(
                f"config #3: the post-load stream read {ufs_read[0]} bytes "
                f"and {ufs_read[1]} blocks from the UFS")
        extra = {}
        if consumer is not None:
            extra["consumer"] = consumer(ref, out)
            del ref
        del out
        return _row("3-distributed-prefetch",
                    "post-prefetch stream to device memory", rate / 1e6,
                    "MB/s", (rate / ref_rate) / 0.7,
                    load_seconds=round(t_load, 2),
                    prefetch_mb_per_s=round(total / t_load / 1e6, 2),
                    warm_reference_mb_per_s=round(ref_rate / 1e6, 2),
                    num_blocks=len(blocks),
                    blocks_by_host=dict(sorted(by_host.items())),
                    **extra)


def config4_projection(fs, device=None, *, rows_per_part: int = 30_000,
                       partitions: int = 2) -> Dict:
    """Parquet column projection into device arrays vs full scan: the
    reference's seeded 23-column table (20 float32 columns, an int32
    label, an int64 id, a float32 weight) written once a partition, the
    footers warmed, a full read of every partition through
    ``open_parquet``, then a read of the 3 projected columns with each
    column copied to the device. After the timed window every projected
    column on the device must equal the table's column."""
    import io

    import pyarrow as pa
    import pyarrow.parquet as pq
    import torch

    from alluxio_tpu_torch.table.reader import open_parquet

    device = resolve_device(device)
    rng = np.random.default_rng(13)
    cols = {f"c{i}": rng.standard_normal(rows_per_part).astype(np.float32)
            for i in range(20)}
    cols["label"] = rng.integers(0, 1000, size=rows_per_part,
                                 dtype=np.int32)
    cols["id"] = np.arange(rows_per_part, dtype=np.int64)
    cols["weight"] = rng.standard_normal(rows_per_part).astype(np.float32)
    table = pa.table(cols)
    sink = io.BytesIO()
    pq.write_table(table, sink)
    blob = sink.getvalue()
    paths = []
    for p in range(partitions):
        path = f"/bench/proj-{p}.parquet"
        fs.write_all(path, blob)
        paths.append(path)
    want = ["c0", "label", "weight"]
    # warm footers
    for p in paths:
        open_parquet(fs, p)
    t0 = time.monotonic()
    full = [open_parquet(fs, p).read() for p in paths]
    t_full = time.monotonic() - t0
    n_full = sum(t.nbytes for t in full)
    del full
    t0 = time.monotonic()
    devs = []
    for p in paths:
        t = open_parquet(fs, p).read(columns=want)
        for name in want:
            devs.append(_put(np.ascontiguousarray(t.column(name).to_numpy()),
                             device))
    _sync(device)
    t_proj = time.monotonic() - t0
    expect = [_put(np.ascontiguousarray(table.column(name).to_numpy()),
                   device) for name in want]
    for i, dev in enumerate(devs):
        if not torch.equal(dev, expect[i % len(want)]):
            raise RuntimeError(
                f"config #4: column {want[i % len(want)]} of "
                f"{paths[i // len(want)]} on the device differs from the "
                f"table's")
    speedup = t_full / t_proj if t_proj > 0 else 0.0
    return _row("4-parquet-projection",
                "3-of-23-column projection speedup into device memory",
                speedup, "x", speedup / 3.0,
                full_scan_s=round(t_full, 3),
                projection_s=round(t_proj, 3),
                full_bytes=n_full,
                projected_bytes=sum(d.numel() * d.element_size()
                                    for d in devs),
                file_bytes=partitions * len(blob),
                columns_checked=len(devs))


def config5_write_eviction(*, cold_write_rate: float, **params) -> Dict:
    """ASYNC_THROUGH ingest under memory pressure (at the defaults the
    dataset is 3x the MEM tier, LRFU, SSD spill): the pressured-cluster
    write bench (``stress/write_bench.py``, its ``params`` passed on),
    graded against the unpressured cold-write rate config #1 measured. It
    raises on an error, an unpersisted or wrong file, or a pressured run
    that spilled nothing."""
    from alluxio_tpu_torch.stress import write_bench

    r = write_bench.run(**params)
    if r.errors:
        raise RuntimeError(f"config #5: {r.errors} errors "
                           f"({r.metrics['unpersisted']} unpersisted, "
                           f"{r.metrics['read_back_mismatches']} read back "
                           f"wrong)")
    tiers = r.metrics["tier_used_bytes"]
    if r.params["pressure_x"] > 1 and not tiers.get("SSD"):
        raise RuntimeError(f"config #5: nothing spilled to SSD ({tiers})")
    rate = r.metrics["ingest_mb_per_s"] * 1e6
    return _row("5-write-through-eviction",
                "ASYNC_THROUGH ingest under memory pressure",
                rate / 1e6, "MB/s",
                (rate / cold_write_rate) / 0.5 if cold_write_rate else 0.0,
                unpressured_cold_write_mb_per_s=round(
                    cold_write_rate / 1e6, 2),
                time_to_durable_s=r.metrics.get("time_to_durable_s"),
                tier_used_bytes=tiers,
                unpersisted=r.metrics["unpersisted"],
                read_back_files=r.metrics["read_back_files"])


def run_all(fs, device=None, *, shard_bytes: int, cold_write_rate: float,
            out_path: str = "", row_extra: Optional[Dict] = None
            ) -> List[Dict]:
    """Run configs #2, #3, #4 and #5, in the reference's order; a stage
    that raises fails the run. ``fs`` is the headline cluster's client
    (configs #2 and #4 reuse its warm worker); configs #3 and #5 provision
    their own clusters. ``row_extra`` is merged into every row and its
    stderr line."""
    global _ROW_EXTRA
    device = resolve_device(device)
    stages: List[Callable[[], Dict]] = [
        lambda: config2_random_4k(fs, device,
                                  shard_bytes=min(shard_bytes, 64 << 20)),
        lambda: config3_prefetch(device,
                                 file_bytes=min(shard_bytes, 32 << 20)),
        lambda: config4_projection(fs, device),
        lambda: config5_write_eviction(cold_write_rate=cold_write_rate),
    ]
    _ROW_EXTRA = dict(row_extra or {})
    try:
        rows = [stage() for stage in stages]
    finally:
        _ROW_EXTRA = {}
    if out_path:
        with open(out_path, "w") as f:
            json.dump(rows, f, indent=1, sort_keys=True)
    return rows
