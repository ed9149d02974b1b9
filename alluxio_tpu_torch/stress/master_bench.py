"""StressMasterBench analogue: master metadata op/s (a copy of
``alluxio_tpu/stress/master_bench.py``).

Reference ``stress/shell/.../cli/StressMasterBench.java``: N client
threads hammer one metadata op — CreateFile / GetStatus / ListStatus /
Delete / Rename — against the master for a fixed duration; the summary
reports op/s + latency percentiles. Each thread works under its own
directory (the reference's per-thread ``/stress-master-base/<id>`` dirs)
so Create/Delete don't contend on one parent inode's mutex.
"""

from __future__ import annotations

import itertools
from typing import Optional

from alluxio_tpu_torch.stress.base import (
    BenchResult, RateLimiter, drive, percentiles,
)
from alluxio_tpu_torch.stress.cluster import bench_cluster

OPS = ("CreateFile", "GetStatus", "ListStatus", "ListStatusStream",
       "DeleteFile", "RenameFile")


def _prep(fs, op: str, threads: int, fixed_count: int,
          base_path: str) -> None:
    """Pre-populate fixtures: read ops get ``fixed_count`` files per
    thread dir; delete/rename get a large pool to consume."""
    from alluxio_tpu_torch.client.streams import WriteType

    for t in range(threads):
        fs.create_directory(f"{base_path}/{t}", allow_exists=True,
                            recursive=True)
    if op in ("GetStatus", "ListStatus", "ListStatusStream",
              "DeleteFile", "RenameFile"):
        for t in range(threads):
            for i in range(fixed_count):
                fs.write_all(f"{base_path}/{t}/f-{i:06d}", b"",
                             write_type=WriteType.MUST_CACHE)


def run(*, op: str = "CreateFile", master: Optional[str] = None,
        threads: int = 8, duration_s: float = 10.0,
        fixed_count: int = 200, base_path: str = "/stress-master",
        target_ops_per_s: float = 0.0,
        _reuse_fs=None) -> BenchResult:
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")

    def _run(fs) -> BenchResult:
        from alluxio_tpu_torch.client.streams import WriteType

        _prep(fs, op, threads, fixed_count, base_path)
        counters = [itertools.count() for _ in range(threads)]

        if op == "CreateFile":
            def body(t: int, i: int) -> int:
                fs.write_all(f"{base_path}/{t}/c-{next(counters[t]):09d}",
                             b"", write_type=WriteType.MUST_CACHE)
                return 0
        elif op == "GetStatus":
            def body(t: int, i: int) -> int:
                fs.fs_master.get_status(
                    f"{base_path}/{t}/f-{i % fixed_count:06d}")
                return 0
        elif op == "ListStatus":
            def body(t: int, i: int) -> int:
                fs.fs_master.list_status(f"{base_path}/{t}")
                return 0
        elif op == "ListStatusStream":
            # the partial-response listing RPC (reference streams
            # ListStatus, file_system_master.proto:475-590) — sized for
            # LARGE directories where one-shot listing would build the
            # whole reply in memory
            def body(t: int, i: int) -> int:
                n = 0
                for _st in fs.fs_master.iter_status(f"{base_path}/{t}"):
                    n += 1
                if n < fixed_count:
                    raise RuntimeError(
                        f"stream returned {n} < {fixed_count} entries")
                return n  # drive() sums returns -> real entry counts
        elif op == "DeleteFile":
            def body(t: int, i: int) -> int:
                n = next(counters[t])
                if n >= fixed_count:  # pool drained: recreate then delete
                    fs.write_all(f"{base_path}/{t}/f-{n:09d}", b"",
                                 write_type=WriteType.MUST_CACHE)
                    fs.delete(f"{base_path}/{t}/f-{n:09d}")
                else:
                    fs.delete(f"{base_path}/{t}/f-{n:06d}")
                return 0
        else:  # RenameFile
            def body(t: int, i: int) -> int:
                n = next(counters[t])
                if n < fixed_count:  # drain the pre-created pool first
                    src = f"{base_path}/{t}/f-{n:06d}"
                else:  # pool drained: create-then-rename (distinct prefix)
                    src = f"{base_path}/{t}/s-{n:09d}"
                    fs.write_all(src, b"", write_type=WriteType.MUST_CACHE)
                fs.rename(src, f"{base_path}/{t}/d-{n:09d}")
                return 0

        limiter = RateLimiter(target_ops_per_s) if target_ops_per_s else None
        res = drive(threads, body, duration_s=duration_s,
                    rate_limiter=limiter)
        return BenchResult(
            bench=f"master-{op}",
            params={"threads": threads, "duration_s": duration_s,
                    "fixed_count": fixed_count,
                    "target_ops_per_s": target_ops_per_s,
                    "master": master or "in-process"},
            metrics={"ops_per_s": round(res.ops_per_s, 1),
                     **({"entries_per_s":
                         round(res.bytes / res.wall_s, 1)
                         if res.wall_s > 0 else 0.0}
                        if op == "ListStatusStream" else {}),
                     **percentiles(res.latencies_s)},
            errors=res.errors, duration_s=res.wall_s)

    if _reuse_fs is not None:
        try:  # live cluster: bench fixtures must not outlive the run
            return _run(_reuse_fs)
        finally:
            try:
                _reuse_fs.delete(base_path, recursive=True)
            except Exception:  # noqa: BLE001 cleanup is best-effort
                pass
    # metadata-only: tiny worker, tiny blocks (zero-byte files need no data)
    with bench_cluster(master, block_size=1 << 20,
                       worker_mem_bytes=64 << 20) as (fs, _cluster):
        return _run(fs)


def run_max_throughput(*, op: str = "CreateFile",
                       master: Optional[str] = None, threads: int = 8,
                       duration_s: float = 3.0, fixed_count: int = 200,
                       lower: float = 50.0, upper: float = 50000.0,
                       tolerance: float = 0.05) -> BenchResult:
    """MaxThroughput suite (``cli/suite/MaxThroughput.java``): binary
    search for the highest target op/s the master sustains — a target
    "passes" when achieved >= (1 - tolerance) * target. First an
    unthrottled probe bounds the search; then each iteration runs the
    bench rate-limited at the midpoint."""
    probe = run(op=op, master=master, threads=threads,
                duration_s=duration_s, fixed_count=fixed_count,
                base_path="/stress-maxtp-probe")
    achieved = probe.metrics["ops_per_s"]
    hi = min(upper, achieved * 2.0)
    lo = lower
    best = 0.0
    best_metrics = probe.metrics
    rounds = 0
    while hi - lo > max(1.0, 0.05 * hi) and rounds < 8:
        mid = (lo + hi) / 2.0
        r = run(op=op, master=master, threads=threads,
                duration_s=duration_s, fixed_count=fixed_count,
                base_path=f"/stress-maxtp-{rounds}",
                target_ops_per_s=mid)
        rounds += 1
        if r.metrics["ops_per_s"] >= (1.0 - tolerance) * mid:
            best, best_metrics, lo = mid, r.metrics, mid
        else:
            hi = mid
    return BenchResult(
        bench=f"master-maxthroughput-{op}",
        params={"threads": threads, "duration_s": duration_s,
                "rounds": rounds, "master": master or "in-process"},
        metrics={"max_sustained_ops_per_s": round(best if best else achieved,
                                                  1),
                 "unthrottled_ops_per_s": achieved,
                 **{k: v for k, v in best_metrics.items()
                    if k.endswith("_us")}},
        errors=0, duration_s=rounds * duration_s)
