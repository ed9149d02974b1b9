"""StressWorkerBench analogue: warm-cache worker read throughput (a copy
of ``alluxio_tpu/stress/worker_bench.py``).

Modes (reference ``stress/shell/.../cli/worker/StressWorkerBench.java:47``):
  sequential — BASELINE config #1's measurement shape, full-shard streams
  random     — BASELINE config #2: random 4 KiB positioned reads over
               TFRecord-framed ImageNet-style shards (the alluxio-fuse
               random-read analogue, ``fuse/AlluxioFuseFileSystem.java``)

Data is written warm into the worker cache first; reads ride the
short-circuit mmap path when co-located, so this measures the framework's
cache read path, not the UFS.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Optional

import numpy as np

from alluxio_tpu_torch.stress.base import BenchResult, drive, percentiles
from alluxio_tpu_torch.stress.cluster import bench_cluster


def _masked_crc(data: bytes) -> int:
    """TFRecord's masked crc32c framing (crc32 stands in for crc32c —
    the framing layout, not the polynomial, is what the bench needs)."""
    crc = zlib.crc32(data) & 0xFFFFFFFF
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def make_tfrecord_shard(rng: np.random.Generator, shard_bytes: int,
                        record_bytes: int = 12 << 10) -> bytes:
    """A TFRecord-framed shard: [len u64][crc u32][payload][crc u32]*."""
    out = bytearray()
    payload = rng.integers(0, 255, size=record_bytes, dtype=np.uint8
                           ).tobytes()
    header = struct.pack("<QI", record_bytes, _masked_crc(
        struct.pack("<Q", record_bytes)))
    footer = struct.pack("<I", _masked_crc(payload))
    frame = header + payload + footer
    while len(out) + len(frame) <= shard_bytes:
        out.extend(frame)
    out.extend(b"\0" * (shard_bytes - len(out)))
    return bytes(out)


def run(*, mode: str = "random", master: Optional[str] = None,
        threads: int = 8, duration_s: float = 10.0,
        shard_bytes: int = 64 << 20, num_shards: int = 4,
        read_bytes: int = 4 << 10, base_path: str = "/stress-worker",
        _reuse_fs=None) -> BenchResult:
    """``_reuse_fs``: run against an existing cluster through this
    FileSystem client (the distributed stressbench job plan's mode)."""
    if _reuse_fs is not None:
        # live-cluster mode: overwrite stale shards from a previous run
        # and remove them afterwards — bench data must not occupy the
        # production cache or fail the next run with AlreadyExists
        try:
            return _run_against(_reuse_fs, mode=mode, master=master,
                                threads=threads, duration_s=duration_s,
                                shard_bytes=shard_bytes,
                                num_shards=num_shards,
                                read_bytes=read_bytes,
                                base_path=base_path)
        finally:
            try:
                _reuse_fs.delete(base_path, recursive=True)
            except Exception:  # noqa: BLE001 cleanup is best-effort
                pass
    with bench_cluster(master, block_size=min(shard_bytes, 32 << 20),
                       worker_mem_bytes=shard_bytes * num_shards + (256 << 20)
                       ) as (fs, _cluster):
        return _run_against(fs, mode=mode, master=master,
                            threads=threads, duration_s=duration_s,
                            shard_bytes=shard_bytes,
                            num_shards=num_shards, read_bytes=read_bytes,
                            base_path=base_path)


def _run_against(fs, *, mode, master, threads, duration_s, shard_bytes,
                 num_shards, read_bytes, base_path) -> BenchResult:
    from alluxio_tpu_torch.client.streams import WriteType

    rng = np.random.default_rng(0)
    paths: List[str] = []
    for i in range(num_shards):
        p = f"{base_path}/shard-{i:05d}.tfrecord"
        fs.write_all(p, make_tfrecord_shard(rng, shard_bytes),
                     write_type=WriteType.MUST_CACHE, overwrite=True)
        paths.append(p)

    n_offsets = shard_bytes // read_bytes
    # per-thread streams: FileInStream is not thread-safe
    ctxs = [([fs.open_file(p) for p in paths],
             np.random.default_rng(t)) for t in range(threads)]

    if mode == "random":
        def op(t: int, i: int) -> int:
            streams, trng = ctxs[t]
            s = streams[int(trng.integers(len(streams)))]
            off = int(trng.integers(n_offsets)) * read_bytes
            data = s.pread(off, read_bytes)
            return len(data)
    elif mode == "sequential":
        chunk = 4 << 20

        def op(t: int, i: int) -> int:
            streams, _trng = ctxs[t]
            s = streams[(t + i) % len(streams)]
            pos = (i * chunk) % shard_bytes
            data = s.pread(pos, chunk)
            return len(data)
    else:
        raise ValueError(f"unknown mode {mode!r}")

    try:
        res = drive(threads, op, duration_s=duration_s)
    finally:
        for streams, _trng in ctxs:
            for s in streams:
                s.close()
    return BenchResult(
        bench=f"worker-{mode}",
        params={"threads": threads, "duration_s": duration_s,
                "shard_bytes": shard_bytes, "num_shards": num_shards,
                "read_bytes": read_bytes if mode == "random" else 4 << 20,
                "master": master or "in-process"},
        metrics={"ops_per_s": round(res.ops_per_s, 1),
                 "mb_per_s": round(res.mb_per_s, 2),
                 **percentiles(res.latencies_s)},
        errors=res.errors, duration_s=res.wall_s)
