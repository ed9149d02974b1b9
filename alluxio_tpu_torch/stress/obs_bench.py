"""Observability overhead + fidelity benches (a copy of
``alluxio_tpu/stress/obs_bench.py``).

Three gated rows:

- ``obs-tracing-overhead`` — what the tracing layer costs when it is
  ON: raw span open/close throughput plus the median cached-read
  latency delta (disabled vs enabled) through a live in-process
  cluster, interleaved in alternating batches so host-speed drift
  cancels out. FAILS (``errors=1``) above ``--max-overhead-pct``
  (default 2%) — the budget the "cheap enough to leave compiled in"
  claim makes.
- ``obs-profile-overhead`` — same interleaved-batch shape for the
  thread-stack sampler (``atpu.profile.enabled``), run at an interval
  more aggressive than the shipped default. Same 2% budget.
- ``obs-critical-path`` — fidelity, not overhead: random-4k reads with
  short-circuit OFF (forcing the remote striped-read path) through the
  minicluster, then the critical-path analyzer must attribute
  >= ``--min-attributed-pct`` (default 90%) of end-to-end wall time to
  named phases — the "readpath report explains where the time went"
  acceptance gate.
"""

from __future__ import annotations

import statistics
import sys
import time

from alluxio_tpu_torch.stress.base import BenchResult


def _median_read_s(fs, path: str, n: int) -> float:
    samples = []
    for _ in range(n):
        t0 = time.perf_counter()
        fs.read_all(path)
        samples.append(time.perf_counter() - t0)
    return statistics.median(samples)


def _span_throughput(iterations: int) -> float:
    from alluxio_tpu_torch.utils.tracing import set_tracing_enabled, tracer

    set_tracing_enabled(True)
    t = tracer()
    t.clear()
    t0 = time.perf_counter()
    for _ in range(iterations):
        with t.span("bench.noop"):
            pass
    elapsed = time.perf_counter() - t0
    t.clear()
    set_tracing_enabled(False)
    return iterations / elapsed if elapsed > 0 else 0.0


def run(*, file_mb: int = 4, reads: int = 60, batches: int = 5,
        span_iterations: int = 100_000,
        max_overhead_pct: float = 2.0) -> BenchResult:
    import tempfile

    from alluxio_tpu_torch.minicluster.local_cluster import LocalCluster
    from alluxio_tpu_torch.utils.tracing import set_tracing_enabled, tracer

    t_start = time.monotonic()
    spans_per_s = _span_throughput(span_iterations)
    off_batches, on_batches = [], []
    with tempfile.TemporaryDirectory(prefix="atpu-obs-") as base:
        with LocalCluster(base, num_workers=1,
                          worker_mem_bytes=4 * (file_mb << 20)) as c:
            fs = c.file_system()
            path = "/obs-bench.bin"
            fs.write_all(path, b"\xab" * (file_mb << 20))
            _median_read_s(fs, path, reads)  # warm: cache + codepaths
            # alternate off/on batches: the container's per-core speed
            # drifts mid-run, and a sequential A-then-B layout folds
            # that drift straight into the delta
            for _ in range(batches):
                set_tracing_enabled(False)
                off_batches.append(_median_read_s(fs, path, reads))
                set_tracing_enabled(True)
                on_batches.append(_median_read_s(fs, path, reads))
                tracer().clear()  # bound ring memory between batches
            set_tracing_enabled(False)
    lat_off_s = statistics.median(off_batches)
    lat_on_s = statistics.median(on_batches)
    overhead_pct = (100.0 * (lat_on_s - lat_off_s) / lat_off_s) \
        if lat_off_s > 0 else 0.0
    ok = overhead_pct <= max_overhead_pct
    if not ok:
        print(f"[obs] tracing overhead {overhead_pct:.2f}% exceeds the "
              f"{max_overhead_pct}% budget", file=sys.stderr)
    return BenchResult(
        bench="obs-tracing-overhead",
        params={"file_mb": file_mb, "reads_per_batch": reads,
                "batches": batches, "span_iterations": span_iterations,
                "max_overhead_pct": max_overhead_pct},
        metrics={"spans_per_s": round(spans_per_s, 1),
                 "read_p50_off_ms": round(lat_off_s * 1e3, 4),
                 "read_p50_on_ms": round(lat_on_s * 1e3, 4),
                 "overhead_pct": round(overhead_pct, 3),
                 "overhead_ok": ok},
        errors=0 if ok else 1,
        duration_s=time.monotonic() - t_start)


def run_profile_overhead(*, file_mb: int = 4, reads: int = 60,
                         batches: int = 5, sample_interval_ms: int = 0,
                         max_overhead_pct: float = 2.0) -> BenchResult:
    """``obs-profile-overhead``: enabled-vs-disabled read latency for
    the thread-stack sampler at the shipped default interval
    (``sample_interval_ms=0`` means "whatever the conf default is").
    The cost under test is per-WAKE (GIL handoff against the reading
    thread), so the interval is the lever that must keep this row
    green."""
    import tempfile

    from alluxio_tpu_torch.minicluster.local_cluster import LocalCluster
    from alluxio_tpu_torch.utils.profiler import profiler

    t_start = time.monotonic()
    p = profiler()
    p.stop()
    saved_interval = p.interval_ms
    off_batches, on_batches = [], []
    total_samples = 0
    try:
        with tempfile.TemporaryDirectory(prefix="atpu-obs-prof-") as base:
            with LocalCluster(base, num_workers=1,
                              worker_mem_bytes=4 * (file_mb << 20)) as c:
                fs = c.file_system()
                # AFTER cluster+client construction: their
                # apply_profile_conf calls reset the sampler to the
                # conf default, which is exactly what interval 0 wants
                if sample_interval_ms > 0:
                    p.interval_ms = int(sample_interval_ms)
                used_interval = p.interval_ms
                path = "/obs-prof.bin"
                fs.write_all(path, b"\xcd" * (file_mb << 20))
                _median_read_s(fs, path, reads)  # warm: cache + codepaths
                for _ in range(batches):
                    p.stop()
                    off_batches.append(_median_read_s(fs, path, reads))
                    p.start()
                    on_batches.append(_median_read_s(fs, path, reads))
                    flame = p.drain()  # bound table memory between batches
                    total_samples += (flame or {}).get("samples", 0)
    finally:
        p.stop()
        p.interval_ms = saved_interval
        p.drain()
    lat_off_s = statistics.median(off_batches)
    lat_on_s = statistics.median(on_batches)
    overhead_pct = (100.0 * (lat_on_s - lat_off_s) / lat_off_s) \
        if lat_off_s > 0 else 0.0
    ok = overhead_pct <= max_overhead_pct
    if not ok:
        print(f"[obs] profiler overhead {overhead_pct:.2f}% exceeds the "
              f"{max_overhead_pct}% budget", file=sys.stderr)
    return BenchResult(
        bench="obs-profile-overhead",
        params={"file_mb": file_mb, "reads_per_batch": reads,
                "batches": batches,
                "sample_interval_ms": used_interval,
                "max_overhead_pct": max_overhead_pct},
        metrics={"read_p50_off_ms": round(lat_off_s * 1e3, 4),
                 "read_p50_on_ms": round(lat_on_s * 1e3, 4),
                 "samples": total_samples,
                 "overhead_pct": round(overhead_pct, 3),
                 "overhead_ok": ok},
        errors=0 if ok else 1,
        duration_s=time.monotonic() - t_start)


def run_critical_path(*, file_mb: int = 2, reads: int = 80,
                      read_bytes: int = 4096,
                      min_attributed_pct: float = 90.0) -> BenchResult:
    """``obs-critical-path``: random-4k reads with short-circuit OFF
    (the /dev/shm mmap path emits no remote-read phases — reads must
    cross the worker RPC), every trace sampled, then the critical-path
    profile over the ring must attribute >= ``min_attributed_pct`` of
    root wall time to named phases."""
    import random
    import tempfile

    from alluxio_tpu_torch.client.file_system import FileSystem
    from alluxio_tpu_torch.conf import Keys
    from alluxio_tpu_torch.minicluster.local_cluster import LocalCluster
    from alluxio_tpu_torch.utils.critical_path import profile
    from alluxio_tpu_torch.utils.tracing import (
        set_tracing_enabled, stitch_spans, tracer,
    )

    t_start = time.monotonic()
    rng = random.Random(0xA77)
    prof: dict = {}
    try:
        with tempfile.TemporaryDirectory(prefix="atpu-obs-cp-") as base:
            with LocalCluster(base, num_workers=1,
                              worker_mem_bytes=8 * (file_mb << 20)) as c:
                conf = c.conf.copy()
                conf.set(Keys.USER_SHORT_CIRCUIT_ENABLED, False)
                # stripe below the op size so 4k preads engage the
                # striped scheduler (reads <= stripe_size ride the
                # legacy loop, which opens no client span)
                conf.set(Keys.USER_REMOTE_READ_STRIPE_SIZE,
                         max(512, read_bytes // 4))
                conf.set(Keys.TRACE_SAMPLE_RATE, 1.0)
                conf.set(Keys.TRACE_RING_CAPACITY, 16384)
                fs = FileSystem(c.master.address, conf=conf)
                try:
                    path = "/obs-cp.bin"
                    size = file_mb << 20
                    fs.write_all(path, b"\xee" * size,
                                 write_type="MUST_CACHE")
                    fs.read_all(path)  # warm the worker tier
                    set_tracing_enabled(True)
                    tracer().clear()
                    with fs.open_file(path) as f:
                        for _ in range(reads):
                            off = rng.randrange(0, size - read_bytes)
                            f.pread(off, read_bytes)
                    set_tracing_enabled(False)
                    stitched = stitch_spans(None, limit=16384)
                    prof = profile(stitched["spans"],
                                   root_prefix="atpu.client.remote_read",
                                   max_traces=reads) or {}
                finally:
                    fs.close()
    finally:
        set_tracing_enabled(False)
        tracer().clear()
    analyzed = prof.get("traces_analyzed", 0)
    attributed = float(prof.get("attributed_pct") or 0.0)
    top = (prof.get("phases") or [{}])[0]
    ok = analyzed >= reads // 2 and attributed >= min_attributed_pct
    if not ok:
        print(f"[obs] critical-path attribution {attributed:.1f}% over "
              f"{analyzed} traces misses the {min_attributed_pct}% gate",
              file=sys.stderr)
    return BenchResult(
        bench="obs-critical-path",
        params={"file_mb": file_mb, "reads": reads,
                "read_bytes": read_bytes,
                "min_attributed_pct": min_attributed_pct},
        metrics={"traces_analyzed": analyzed,
                 "wall_ms_p50": prof.get("wall_ms_p50", 0.0),
                 "wall_ms_p99": prof.get("wall_ms_p99", 0.0),
                 "attributed_pct": attributed,
                 "top_segment": str(top.get("key", "")),
                 "top_segment_pct": float(top.get("pct") or 0.0),
                 "attribution_ok": ok},
        errors=0 if ok else 1,
        duration_s=time.monotonic() - t_start)
