"""Stress CLI: ``python -m alluxio_tpu_torch.stress <bench> [options]``
(a copy of ``alluxio_tpu/stress/__main__.py``).

Reference: ``stress/shell/src/main/java/alluxio/stress/cli/*`` — each
bench prints exactly ONE JSON summary line on stdout (diagnostics on
stderr), so callers can pipe results.

Benches:
  worker       worker read throughput (--mode sequential|random) [#1/#2]
  master       master metadata op/s (--op CreateFile|GetStatus|...)
  maxthroughput  binary-search max sustainable master op/s
  prefetch     distributed load across N workers [#3]
  table        Parquet column-projection via the catalog [#4]
  write        async write-through under eviction pressure [#5]
  obs          tracing and profiler overhead, critical-path attribution
  health       metrics-history ingestion overhead
  selfheal     remediation detection->action latency and tick overhead
  qos          two-tenant victim p99 under a flood; admission shedding
  suite        run the whole BASELINE config family
  ha           HA failover drill: MTTR, acknowledged-write loss, standby
               staleness

The table bench runs in-process only (``table --master`` is refused).
"""

from __future__ import annotations

import argparse
import json
import sys


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--master", default=None,
                   help="host:port of a live cluster (default: in-process)")
    p.add_argument("--threads", type=int, default=8)
    p.add_argument("--duration", type=float, default=5.0,
                   metavar="SECONDS")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="alluxio-tpu stress")
    sub = ap.add_subparsers(dest="bench", required=True)

    w = sub.add_parser("worker", help="worker read bench (configs #1/#2)")
    _add_common(w)
    w.add_argument("--mode", choices=("sequential", "random"),
                   default="random")
    w.add_argument("--shard-mb", type=int, default=64)
    w.add_argument("--num-shards", type=int, default=4)
    w.add_argument("--read-bytes", type=int, default=4096)

    m = sub.add_parser("master", help="master metadata op/s")
    _add_common(m)
    from alluxio_tpu_torch.stress.master_bench import OPS

    m.add_argument("--op", choices=OPS, default="CreateFile")
    m.add_argument("--fixed-count", type=int, default=200)
    m.add_argument("--target-ops", type=float, default=0.0)

    x = sub.add_parser("maxthroughput",
                       help="binary-search max sustainable master op/s")
    _add_common(x)
    x.add_argument("--op", choices=OPS, default="CreateFile")
    x.add_argument("--fixed-count", type=int, default=200)

    p = sub.add_parser("prefetch", help="distributed load (config #3)")
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--num-files", type=int, default=8)
    p.add_argument("--file-mb", type=int, default=16)
    p.add_argument("--replication", type=int, default=1)
    p.add_argument("--pressure", action="store_true",
                   help="size tiers so eviction fires mid-load")
    p.add_argument("--kill-worker", action="store_true",
                   help="stop a worker mid-job; plan must survive")
    p.add_argument("--clairvoyant", action="store_true",
                   help="run the oracle->scheduler->agent loop instead: "
                        "seeded multi-epoch DeviceBlockLoader read "
                        "reporting hit-rate + block-ready lateness")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--lookahead", type=int, default=16)
    p.add_argument("--budget-mb", type=int, default=128)
    p.add_argument("--hbm-fraction", type=float, default=0.0)

    t = sub.add_parser("table", help="column projection (config #4)")
    t.add_argument("--master", default=None)
    t.add_argument("--partitions", type=int, default=4)
    t.add_argument("--rows", type=int, default=40_000)
    t.add_argument("--row", choices=["projection", "pushdown"],
                   default="projection",
                   help="pushdown: planned-vs-legacy gated comparison "
                        "(docs/table_reads.md)")
    t.add_argument("--min-speedup", type=float, default=None,
                   help="gate: pushdown row fails below this planned/"
                        "legacy ratio (default 2.0); projection row "
                        "below this full-scan/projection ratio "
                        "(default 4.0)")

    wr = sub.add_parser("write", help="write-through eviction (config #5)")
    wr.add_argument("--threads", type=int, default=4)
    wr.add_argument("--num-files", type=int, default=24)
    wr.add_argument("--file-mb", type=int, default=8)
    wr.add_argument("--mem-mb", type=int, default=64)

    ob = sub.add_parser("obs", help="observability rows: tracing/"
                                    "profiler overhead + critical-path "
                                    "attribution fidelity")
    ob.add_argument("--row", choices=("tracing", "profile",
                                      "critical-path"),
                    default="tracing",
                    help="which obs row: tracing overhead (default), "
                         "stack-sampler overhead, or critical-path "
                         "attribution")
    ob.add_argument("--file-mb", type=int, default=4)
    ob.add_argument("--reads", type=int, default=60,
                    help="reads per alternating batch (tracing/profile) "
                         "or total random preads (critical-path)")
    ob.add_argument("--batches", type=int, default=5)
    ob.add_argument("--span-iterations", type=int, default=100_000)
    ob.add_argument("--sample-interval-ms", type=int, default=0,
                    help="profiler row: stack-sampling interval under "
                         "test (0 = the shipped conf default)")
    ob.add_argument("--read-bytes", type=int, default=4096,
                    help="critical-path row: bytes per random pread")
    ob.add_argument("--max-overhead-pct", type=float, default=2.0,
                    help="fail the overhead rows above this delta")
    ob.add_argument("--min-attributed-pct", type=float, default=90.0,
                    help="fail the critical-path row when named phases "
                         "explain less of root wall time than this")

    sr = sub.add_parser("smallread",
                        help="small-read data plane: batched random-4k "
                             "over real gRPC vs per-op RPCs, and "
                             "same-host SHM zero-copy fidelity "
                             "(buffer identity, no wire phase)")
    sr.add_argument("--row", choices=("batch", "shm", "native"),
                    default="batch",
                    help="which row: read_many coalescing speedup "
                         "(default), SHM zero-copy fidelity, or native "
                         "fastpath batched scatter speedup")
    sr.add_argument("--file-mb", type=int, default=2)
    sr.add_argument("--ops", type=int, default=None,
                    help="random preads measured (default: 400 batch "
                         "row, 200 shm row, 2000 native row)")
    sr.add_argument("--read-bytes", type=int, default=4096)
    sr.add_argument("--min-speedup", type=float, default=3.0,
                    help="batch row: fail below this batched/per-op "
                         "ops/s ratio")

    he = sub.add_parser("health", help="metrics-history ingestion "
                                       "overhead on the heartbeat hot "
                                       "path (fake-clock harness)")
    he.add_argument("--sources", type=int, default=64)
    he.add_argument("--metrics-per-source", type=int, default=120,
                    help="snapshot size per heartbeat (a live worker "
                         "ships ~100-150 entries once timers expand)")
    he.add_argument("--ticks", type=int, default=40)
    he.add_argument("--batches", type=int, default=8)
    he.add_argument("--max-overhead-pct", type=float, default=5.0,
                    help="fail the bench above this heartbeat-handling "
                         "overhead with history enabled")

    sh = sub.add_parser("selfheal",
                        help="remediation engine: detection->action "
                             "latency + health-tick overhead "
                             "(fake-clock harness)")
    sh.add_argument("--sources", type=int, default=64,
                    help="fleet size driving the health tick (matches "
                         "bench-health's model); the engine's cost is "
                         "per-tick constant, the tick scales with this")
    sh.add_argument("--ticks", type=int, default=60)
    sh.add_argument("--batches", type=int, default=6)
    sh.add_argument("--eval-interval", type=float, default=5.0,
                    help="simulated health-eval period (seconds)")
    sh.add_argument("--fire-after", type=float, default=10.0,
                    help="simulated alert fire debounce (seconds)")
    sh.add_argument("--max-overhead-pct", type=float, default=2.0,
                    help="fail the bench above this added health-tick "
                         "overhead with the engine attached")

    uc = sub.add_parser("ufscold", help="striped vs single-stream cold "
                                        "UFS reads (connection-limited "
                                        "UFS model)")
    uc.add_argument("--block-mb", type=int, default=2)
    uc.add_argument("--stripe-kb", type=int, default=512)
    uc.add_argument("--blocks-per-reader", type=int, default=3)
    uc.add_argument("--rtt-ms", type=float, default=25.0,
                    help="modeled per-connection round trip; must dwarf "
                         "the host's thread-wake jitter")
    uc.add_argument("--conn-mbps", type=float, default=4.0,
                    help="modeled per-connection UFS bandwidth")
    uc.add_argument("--concurrency", type=int, default=4,
                    help="stripes in flight per block")
    uc.add_argument("--per-mount-limit", type=int, default=64)
    uc.add_argument("--min-speedup", type=float, default=1.5,
                    help="fail below this striped/single throughput "
                         "ratio at 4 concurrent readers")

    rr = sub.add_parser("remoteread",
                        help="striped vs single-stream warm remote reads "
                             "(bandwidth-limited-per-connection worker "
                             "model) + hedged straggler drill")
    rr.add_argument("--block-mb", type=int, default=4)
    rr.add_argument("--stripe-kb", type=int, default=1024)
    rr.add_argument("--stripes", type=int, default=4,
                    help="concurrent range streams per read")
    rr.add_argument("--rtt-ms", type=float, default=20.0,
                    help="modeled per-stream round trip; must dwarf the "
                         "host's thread-wake jitter")
    rr.add_argument("--conn-mbps", type=float, default=16.0,
                    help="modeled per-connection worker bandwidth")
    rr.add_argument("--blocks", type=int, default=3,
                    help="blocks read per variant")
    rr.add_argument("--hedge-quantile", type=float, default=0.95)
    rr.add_argument("--stall-ms", type=float, default=300.0,
                    help="injected straggler stall before first byte")
    rr.add_argument("--min-speedup", type=float, default=1.5,
                    help="fail below this striped/single throughput ratio")

    qo = sub.add_parser("qos",
                        help="two-tenant QoS: victim read p99 under an "
                             "abusive tenant's flood with/without QoS, "
                             "plus admission-limiter bounded-memory "
                             "shedding (modeled UFS, fake-clock "
                             "limiter)")
    qo.add_argument("--rtt-ms", type=float, default=40.0,
                    help="modeled per-read UFS round trip; must dwarf "
                         "the host's thread-wake jitter")
    qo.add_argument("--block-kb", type=int, default=64)
    qo.add_argument("--victim-reads", type=int, default=12)
    qo.add_argument("--flood-blocks", type=int, default=48,
                    help="abusive-tenant backlog per wave (two waves)")
    qo.add_argument("--per-mount-limit", type=int, default=4)
    qo.add_argument("--tenant-limit", type=int, default=2)
    qo.add_argument("--max-degradation", type=float, default=2.0,
                    help="fail when the victim's flooded p99 exceeds "
                         "this multiple of its solo p99 with QoS on")
    qo.add_argument("--admission-checks", type=int, default=200_000)
    qo.add_argument("--admission-principals", type=int, default=20_000)
    qo.add_argument("--admission-max-principals", type=int, default=512)

    md = sub.add_parser("metadata",
                        help="metadata control-plane gates: striped "
                             "inode locking + journal group commit vs "
                             "the single-lock master (modeled slow "
                             "fsync), and warm client-metadata-cache "
                             "GetStatus vs uncached RPCs")
    md.add_argument("--row", choices=("striped", "journal", "cached",
                                      "hot-dir", "lsm-capacity"),
                    default="striped")
    md.add_argument("--threads", type=int, default=None,
                    help="driver threads (default 8; cached row 4)")
    md.add_argument("--duration", type=float, default=None,
                    metavar="SECONDS",
                    help="per-mode measure window (default 2.0; "
                         "cached row 1.5)")
    md.add_argument("--fsync-ms", type=float, default=3.0,
                    help="modeled journal fsync cost (local-disk/NFS "
                         "class); must dwarf scheduler jitter")
    md.add_argument("--batch-time-ms", type=float, default=2.0,
                    help="group-commit coalescing window under test")
    md.add_argument("--min-speedup", type=float, default=None,
                    help="gate ratio (defaults: striped 3x, journal "
                         "1.5x, cached 10x)")
    md.add_argument("--master", default=None,
                    help="cached row only: attach to a live cluster")
    md.add_argument("--inodes", type=int, default=10_000_000,
                    help="lsm-capacity row: namespace size to build "
                         "under the cap")
    md.add_argument("--cap-mb", type=int, default=2048,
                    help="lsm-capacity row: RLIMIT_AS cap per backend "
                         "subprocess (HEAP must blow it, LSM must fit)")

    ha = sub.add_parser("ha", help="HA failover drill: kill the primary "
                                   "under live load; gates MTTR <= 2 "
                                   "election timeouts, zero acked-write "
                                   "loss, standby staleness contract")
    ha.add_argument("--masters", type=int, default=3)
    ha.add_argument("--election-timeout", type=float, default=2.0,
                    metavar="SECONDS",
                    help="election timeout upper bound (seconds-scale "
                         "on purpose: the in-process quorum shares one "
                         "GIL with the load; the gate must measure "
                         "failover, not scheduler jitter)")
    ha.add_argument("--warmup", type=float, default=2.0,
                    help="seconds of load before the kill")

    sub.add_parser("suite", help="run the whole BASELINE config family")
    rp = sub.add_parser("report",
                        help="render suite JSON to a single-file HTML "
                             "report (graphs + tables)")
    rp.add_argument("--input", default="BENCH_SUITE.json")
    rp.add_argument("--out", default="BENCH_REPORT.html")
    return ap


SUITE = (
    ("worker-sequential", ["worker", "--mode", "sequential",
                           "--threads", "4", "--duration", "5"]),
    ("worker-random-4k", ["worker", "--mode", "random",
                          "--threads", "8", "--duration", "5"]),
    ("master-CreateFile", ["master", "--op", "CreateFile",
                           "--threads", "8", "--duration", "5"]),
    ("master-GetStatus", ["master", "--op", "GetStatus",
                          "--threads", "8", "--duration", "5"]),
    ("master-ListStatus", ["master", "--op", "ListStatus", "--threads",
                           "8", "--duration", "5",
                           "--fixed-count", "100"]),
    ("master-ListStatus-large", ["master", "--op", "ListStatusStream",
                                 "--threads", "2", "--duration", "6",
                                 "--fixed-count", "10000"]),
    ("master-DeleteFile", ["master", "--op", "DeleteFile", "--threads",
                           "8", "--duration", "5",
                           "--fixed-count", "2000"]),
    ("prefetch", ["prefetch", "--num-workers", "4", "--num-files", "8",
                  "--file-mb", "16"]),
    ("prefetch-fault-drill", ["prefetch", "--num-workers", "4",
                              "--num-files", "8", "--file-mb", "8",
                              "--replication", "2", "--pressure",
                              "--kill-worker"]),
    ("prefetch-clairvoyant", ["prefetch", "--clairvoyant",
                              "--num-workers", "1",
                              "--num-files", "4", "--file-mb", "8",
                              "--epochs", "2"]),
    ("table-projection", ["table"]),
    ("table-projection-pushdown", ["table", "--row", "pushdown"]),
    ("write-eviction", ["write"]),
    ("obs-tracing-overhead", ["obs"]),
    ("obs-profile-overhead", ["obs", "--row", "profile"]),
    ("obs-critical-path", ["obs", "--row", "critical-path",
                           "--file-mb", "2", "--reads", "80"]),
    ("smallread-batch", ["smallread", "--row", "batch"]),
    ("smallread-shm-zerocopy", ["smallread", "--row", "shm"]),
    ("smallread-native-fastpath", ["smallread", "--row", "native",
                                   "--min-speedup", "5.0"]),
    ("health-ingest-overhead", ["health"]),
    ("selfheal-remediation", ["selfheal"]),
    ("ufs-cold-read", ["ufscold"]),
    ("remote-warm-read", ["remoteread"]),
    ("qos-two-tenant", ["qos"]),
    ("metadata-striped", ["metadata", "--row", "striped"]),
    ("metadata-cached-getstatus", ["metadata", "--row", "cached"]),
    ("metadata-journal-batch", ["metadata", "--row", "journal"]),
    ("metadata-hot-dir", ["metadata", "--row", "hot-dir"]),
    # scaled down for the suite's per-bench timeout; `make
    # bench-metadata` runs the full 10M-inode row
    ("metadata-lsm-capacity", ["metadata", "--row", "lsm-capacity",
                               "--inodes", "1000000",
                               "--cap-mb", "1024"]),
    ("ha-failover", ["ha"]),
)


#: sentinel bench name for the host-speed stamp row — consumers
#: (bench.py suite counting) must exclude it by THIS constant
HOST_CALIBRATION_BENCH = "host-calibration"


def _host_calibration():
    """A suite run is only comparable to another on a like-for-like
    host: the CI container's per-core speed drifts several-fold between
    sessions (observed: 10M-adds 2126 ms on one allocation vs ~600 ms
    on another — every GIL-bound op/s row scales with it). This row
    stamps each BENCH_SUITE with the host's measured speed so later
    readers can normalize instead of mistaking allocation drift for
    code regressions."""
    import os
    import platform

    from alluxio_tpu_torch.stress.base import BenchResult, host_speed_stamp_ms

    loop_ms = host_speed_stamp_ms()
    cores = os.cpu_count() or 0
    return BenchResult(
        bench=HOST_CALIBRATION_BENCH,
        params={"python": platform.python_version(), "cores": cores},
        metrics={"python_10m_adds_ms": loop_ms,
                 "note": "GIL-bound op/s rows scale ~inversely with "
                         "python_10m_adds_ms; compare suites only "
                         "after normalizing"},
        errors=0, duration_s=round(loop_ms / 1000, 3))


def run_suite() -> list:
    """The five BASELINE configs + master-op samples, each in its OWN
    subprocess: a bench must not inherit the previous one's page-cache
    pressure, lingering cluster threads or fragmented heap (sequential
    in-process runs measured 2-4x slower than isolated ones for the
    later benches). Returns the list of BenchResults."""
    import os
    import subprocess
    import time

    from alluxio_tpu_torch.stress.base import BenchResult

    env = dict(os.environ)
    # the children import the package from where this one did, whatever
    # the working directory
    parent = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (parent, env.get("PYTHONPATH")) if p)
    results = [_host_calibration()]
    print(results[0].json_line(), flush=True)
    for bench_i, (name, argv) in enumerate(SUITE):
        print(f"[suite] running {name} ...", file=sys.stderr, flush=True)
        proc = None
        try:
            if bench_i:
                # let the previous bench's teardown IO (tmpdir deletion,
                # page-cache writeback) drain — it measured 2-3x into
                # the next bench's tail latencies on a 1-core host
                os.sync()
                time.sleep(4)
            proc = subprocess.run(
                [sys.executable, "-m", "alluxio_tpu_torch.stress", *argv],
                capture_output=True, text=True, timeout=600, env=env)
            out_lines = (proc.stdout or "").strip().splitlines()
            if not out_lines:
                raise RuntimeError(
                    f"bench child produced no output (rc="
                    f"{proc.returncode})")
            d = json.loads(out_lines[-1])
            r = BenchResult(bench=d["bench"], params=d["params"],
                            metrics=d["metrics"], errors=d["errors"],
                            duration_s=d["duration_s"])
        except Exception as e:  # noqa: BLE001 — record and continue
            r = BenchResult(bench=name, params={}, metrics={},
                            errors=1, duration_s=0.0)
            # on TimeoutExpired proc was never assigned, but
            # subprocess.run attaches the drained output to the
            # exception itself
            src = proc if proc is not None else e
            tail = getattr(src, "stderr", None) or ""
            if isinstance(tail, bytes):  # TimeoutExpired keeps bytes
                tail = tail.decode(errors="replace")
            tail = tail[-2000:]
            # the child's stderr tail goes IN THE ROW: a bare exception
            # name from the wrapper's own parse (observed:
            # 'IndexError' on empty stdout) is undiagnosable later
            r.metrics["error"] = f"{type(e).__name__}: {e}"
            if tail:
                r.metrics["child_stderr_tail"] = tail
            print(f"[suite] {name} FAILED: {e} {tail}", file=sys.stderr)
        print(r.json_line(), flush=True)
        results.append(r)
    return results


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.bench == "worker":
        from alluxio_tpu_torch.stress.worker_bench import run

        r = run(mode=args.mode, master=args.master, threads=args.threads,
                duration_s=args.duration, shard_bytes=args.shard_mb << 20,
                num_shards=args.num_shards, read_bytes=args.read_bytes)
    elif args.bench == "master":
        from alluxio_tpu_torch.stress.master_bench import run

        r = run(op=args.op, master=args.master, threads=args.threads,
                duration_s=args.duration, fixed_count=args.fixed_count,
                target_ops_per_s=args.target_ops)
    elif args.bench == "maxthroughput":
        from alluxio_tpu_torch.stress.master_bench import run_max_throughput

        r = run_max_throughput(op=args.op, master=args.master,
                               threads=args.threads,
                               duration_s=args.duration,
                               fixed_count=args.fixed_count)
    elif args.bench == "prefetch":
        if args.clairvoyant:
            # flags of the DistributedLoad variant that the clairvoyant
            # run does not model — failing beats silently ignoring them
            if args.pressure or args.kill_worker or \
                    args.replication != 1:
                print("--pressure/--kill-worker/--replication do not "
                      "apply to --clairvoyant", file=sys.stderr)
                return 2
            from alluxio_tpu_torch.stress.prefetch_bench import run_clairvoyant

            r = run_clairvoyant(num_workers=args.num_workers,
                                num_files=args.num_files,
                                file_bytes=args.file_mb << 20,
                                epochs=args.epochs, seed=args.seed,
                                lookahead_blocks=args.lookahead,
                                budget_bytes=args.budget_mb << 20,
                                hbm_fraction=args.hbm_fraction)
        else:
            from alluxio_tpu_torch.stress.prefetch_bench import run

            r = run(num_workers=args.num_workers,
                    num_files=args.num_files,
                    file_bytes=args.file_mb << 20,
                    replication=args.replication, pressure=args.pressure,
                    kill_worker=args.kill_worker)
    elif args.bench == "table":
        if args.master:
            print("table --master: the table bench runs in-process only",
                  file=sys.stderr)
            return 2
        if args.row == "pushdown":
            from alluxio_tpu_torch.stress.table_bench import run_pushdown

            r = run_pushdown(partitions=args.partitions,
                             rows_per_partition=args.rows,
                             min_speedup=args.min_speedup
                             if args.min_speedup is not None else 2.0)
        else:
            from alluxio_tpu_torch.stress.table_bench import run

            r = run(partitions=args.partitions,
                    rows_per_partition=args.rows,
                    min_speedup=args.min_speedup
                    if args.min_speedup is not None else 4.0)
    elif args.bench == "write":
        from alluxio_tpu_torch.stress.write_bench import run

        r = run(threads=args.threads, num_files=args.num_files,
                file_bytes=args.file_mb << 20,
                mem_bytes=args.mem_mb << 20)
    elif args.bench == "obs":
        if args.row == "profile":
            from alluxio_tpu_torch.stress.obs_bench import run_profile_overhead

            r = run_profile_overhead(
                file_mb=args.file_mb, reads=args.reads,
                batches=args.batches,
                sample_interval_ms=args.sample_interval_ms,
                max_overhead_pct=args.max_overhead_pct)
        elif args.row == "critical-path":
            from alluxio_tpu_torch.stress.obs_bench import run_critical_path

            r = run_critical_path(
                file_mb=args.file_mb, reads=args.reads,
                read_bytes=args.read_bytes,
                min_attributed_pct=args.min_attributed_pct)
        else:
            from alluxio_tpu_torch.stress.obs_bench import run

            r = run(file_mb=args.file_mb, reads=args.reads,
                    batches=args.batches,
                    span_iterations=args.span_iterations,
                    max_overhead_pct=args.max_overhead_pct)
    elif args.bench == "smallread":
        if args.row == "shm":
            from alluxio_tpu_torch.stress.smallread_bench import run_shm

            r = run_shm(file_mb=args.file_mb,
                        ops=args.ops if args.ops is not None else 200,
                        read_bytes=args.read_bytes)
        elif args.row == "native":
            from alluxio_tpu_torch.stress.smallread_bench import run_native

            r = run_native(file_mb=args.file_mb,
                           ops=args.ops if args.ops is not None else 2000,
                           read_bytes=args.read_bytes,
                           min_speedup=args.min_speedup)
        else:
            from alluxio_tpu_torch.stress.smallread_bench import run_batch

            r = run_batch(file_mb=args.file_mb,
                          ops=args.ops if args.ops is not None else 400,
                          read_bytes=args.read_bytes,
                          min_speedup=args.min_speedup)
    elif args.bench == "health":
        from alluxio_tpu_torch.stress.health_bench import run

        r = run(sources=args.sources,
                metrics_per_source=args.metrics_per_source,
                ticks=args.ticks, batches=args.batches,
                max_overhead_pct=args.max_overhead_pct)
    elif args.bench == "selfheal":
        from alluxio_tpu_torch.stress.selfheal_bench import run

        r = run(sources=args.sources, ticks=args.ticks,
                batches=args.batches,
                eval_interval_s=args.eval_interval,
                fire_after_s=args.fire_after,
                max_overhead_pct=args.max_overhead_pct)
    elif args.bench == "ufscold":
        from alluxio_tpu_torch.stress.ufs_cold_bench import run

        r = run(block_mb=args.block_mb, stripe_kb=args.stripe_kb,
                blocks_per_reader=args.blocks_per_reader,
                rtt_ms=args.rtt_ms, conn_mbps=args.conn_mbps,
                concurrency=args.concurrency,
                per_mount_limit=args.per_mount_limit,
                min_speedup=args.min_speedup)
    elif args.bench == "remoteread":
        from alluxio_tpu_torch.stress.remote_read_bench import run

        r = run(block_mb=args.block_mb, stripe_kb=args.stripe_kb,
                stripes=args.stripes, rtt_ms=args.rtt_ms,
                conn_mbps=args.conn_mbps, blocks=args.blocks,
                hedge_quantile=args.hedge_quantile,
                stall_ms=args.stall_ms, min_speedup=args.min_speedup)
    elif args.bench == "qos":
        from alluxio_tpu_torch.stress.qos_bench import run

        r = run(rtt_ms=args.rtt_ms, block_kb=args.block_kb,
                victim_reads=args.victim_reads,
                flood_blocks=args.flood_blocks,
                per_mount_limit=args.per_mount_limit,
                tenant_limit=args.tenant_limit,
                max_degradation=args.max_degradation,
                admission_checks=args.admission_checks,
                admission_principals=args.admission_principals,
                admission_max_principals=args.admission_max_principals)
    elif args.bench == "metadata":
        from alluxio_tpu_torch.stress.metadata_bench import run

        kw = {}
        if args.threads is not None:
            kw["threads"] = args.threads
        if args.duration is not None:
            kw["duration_s"] = args.duration
        if args.min_speedup is not None:
            kw["min_speedup"] = args.min_speedup
        if args.row == "cached":
            r = run(row="cached", master=args.master, **kw)
        elif args.row == "lsm-capacity":
            kw.pop("threads", None)
            kw.pop("duration_s", None)
            kw.pop("min_speedup", None)
            r = run(row="lsm-capacity", inodes=args.inodes,
                    cap_mb=args.cap_mb, **kw)
        else:
            r = run(row=args.row, fsync_ms=args.fsync_ms,
                    batch_time_ms=args.batch_time_ms, **kw)
    elif args.bench == "ha":
        from alluxio_tpu_torch.stress.ha_bench import run

        r = run(masters=args.masters,
                election_timeout_s=args.election_timeout,
                warmup_s=args.warmup)
    elif args.bench == "suite":
        results = run_suite()
        return 0 if all(x.errors == 0 for x in results) else 1
    elif args.bench == "report":
        from alluxio_tpu_torch.stress.report import write_report

        return write_report(args.input, args.out)
    else:  # pragma: no cover — argparse guards
        return 2
    print(r.json_line(), flush=True)
    return 0 if r.errors == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
